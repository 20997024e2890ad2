// Native BVH4 builder — the host-side build hot spot (the analog of the
// reference's BVH4 construction, internal/hitable/bvh4.go:517-792, which for
// dragon-class scenes dominates scene setup).
//
// Algorithm mirrors izpi_tpu/accel/bvh_build.py exactly (same LCG split-axis
// stream, same stable median split, same 2-level collapse BFS, same
// conservative f32 rounding) so the two builders are differential-testable
// against each other node-for-node.
//
// Build: g++ -O3 -shared -fPIC -o libizpibvh.so bvh4.cc
// ABI: C, consumed via ctypes (izpi_tpu/accel/native/__init__.py).

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {


// fastrandom defaults (fastrandom.go:7-11).
struct Lcg {
  uint64_t state;
  static constexpr uint64_t kM = 4294967296ULL;
  static constexpr uint64_t kA = 1664525ULL;
  static constexpr uint64_t kC = 1013904223ULL;
  explicit Lcg(uint64_t seed) : state(seed % kM) {}
  double f64() {
    state = (kA * state + kC) % kM;
    return static_cast<double>(state) / static_cast<double>(kM);
  }
};

struct BinNode {
  double bb_min[3];
  double bb_max[3];
  int64_t start = -1;
  int64_t count = 0;
  int64_t left = -1;
  int64_t right = -1;
};

struct Builder {
  const double* bb_min;
  const double* bb_max;
  std::vector<double> centroid;
  std::vector<int64_t> order;
  std::vector<BinNode> nodes;

  void seg_bounds(int64_t lo, int64_t hi, double* mn, double* mx) const {
    for (int a = 0; a < 3; ++a) {
      mn[a] = std::numeric_limits<double>::infinity();
      mx[a] = -std::numeric_limits<double>::infinity();
    }
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t p = order[i];
      for (int a = 0; a < 3; ++a) {
        mn[a] = std::min(mn[a], bb_min[p * 3 + a]);
        mx[a] = std::max(mx[a], bb_max[p * 3 + a]);
      }
    }
  }
};

float conservative_lo(double v) {
  float f = static_cast<float>(v);
  if (static_cast<double>(f) > v) f = std::nextafter(f, -std::numeric_limits<float>::infinity());
  return f;
}

float conservative_hi(double v) {
  float f = static_cast<float>(v);
  if (static_cast<double>(f) < v) f = std::nextafter(f, std::numeric_limits<float>::infinity());
  return f;
}

}  // namespace

extern "C" int64_t izpi_build_bvh4(
    const double* bb_min, const double* bb_max, int64_t n_prims,
    uint64_t seed,
    float* out_bounds,    // capacity max_nodes * 24
    int32_t* out_child,   // capacity max_nodes * 4
    int32_t* out_count,   // capacity max_nodes * 4
    int32_t* prim_order,  // capacity n_prims
    int64_t max_nodes, int64_t leaf_size, int32_t method) {
  // method: 0 = reference-parity median/random-axis split (bvh4.go:596-652);
  //         1 = deterministic binned SAH (mirrors bvh_build._build_binary_sah
  //         so the two builders stay differential-testable).
  if (n_prims <= 0 || leaf_size <= 0) return -1;
  const int64_t kLeafSize = leaf_size;
  constexpr int kBins = 16;

  Builder b;
  b.bb_min = bb_min;
  b.bb_max = bb_max;
  b.centroid.resize(n_prims * 3);
  for (int64_t i = 0; i < n_prims * 3; ++i)
    b.centroid[i] = 0.5 * (bb_min[i] + bb_max[i]);
  b.order.resize(n_prims);
  for (int64_t i = 0; i < n_prims; ++i) b.order[i] = i;

  Lcg rng(seed);

  auto half_area = [](const double* lo, const double* hi) {
    const double dx = std::max(hi[0] - lo[0], 0.0);
    const double dy = std::max(hi[1] - lo[1], 0.0);
    const double dz = std::max(hi[2] - lo[2], 0.0);
    return dx * dy + dy * dz + dz * dx;
  };

  // Binary build with an explicit stack; children created in the same order
  // as the python builder (left then right pushed, LIFO).
  b.nodes.reserve(2 * n_prims / kLeafSize + 4);
  {
    BinNode root;
    b.seg_bounds(0, n_prims, root.bb_min, root.bb_max);
    b.nodes.push_back(root);
  }
  std::vector<std::array<int64_t, 3>> stack;
  stack.push_back({0, 0, n_prims});
  std::vector<int64_t> tmp;
  while (!stack.empty()) {
    auto [ni, lo, hi] = stack.back();
    stack.pop_back();
    const int64_t n = hi - lo;
    if (n <= kLeafSize) {
      b.nodes[ni].start = lo;
      b.nodes[ni].count = n;
      continue;
    }
    int64_t mid = -1;
    if (method == 1) {
      // --- binned SAH over the centroid extent of each axis ---
      double cmin[3], cmax[3];
      for (int a = 0; a < 3; ++a) {
        cmin[a] = std::numeric_limits<double>::infinity();
        cmax[a] = -std::numeric_limits<double>::infinity();
      }
      for (int64_t i = lo; i < hi; ++i) {
        const int64_t p = b.order[i];
        for (int a = 0; a < 3; ++a) {
          cmin[a] = std::min(cmin[a], b.centroid[p * 3 + a]);
          cmax[a] = std::max(cmax[a], b.centroid[p * 3 + a]);
        }
      }
      double best_cost = std::numeric_limits<double>::infinity();
      int best_axis = -1;
      double best_edge = 0.0;
      for (int axis = 0; axis < 3; ++axis) {
        const double extent = cmax[axis] - cmin[axis];
        if (extent <= 0.0) continue;
        const double scale = kBins / extent;
        int64_t counts[kBins] = {0};
        double bl[kBins][3], bh[kBins][3];
        for (int bi = 0; bi < kBins; ++bi)
          for (int a = 0; a < 3; ++a) {
            bl[bi][a] = std::numeric_limits<double>::infinity();
            bh[bi][a] = -std::numeric_limits<double>::infinity();
          }
        for (int64_t i = lo; i < hi; ++i) {
          const int64_t p = b.order[i];
          int bi = static_cast<int>(
              (b.centroid[p * 3 + axis] - cmin[axis]) * scale);
          bi = std::min(bi, kBins - 1);
          ++counts[bi];
          for (int a = 0; a < 3; ++a) {
            bl[bi][a] = std::min(bl[bi][a], bb_min[p * 3 + a]);
            bh[bi][a] = std::max(bh[bi][a], bb_max[p * 3 + a]);
          }
        }
        double llo[kBins][3], lhi[kBins][3], rlo[kBins][3], rhi[kBins][3];
        for (int a = 0; a < 3; ++a) {
          llo[0][a] = bl[0][a];
          lhi[0][a] = bh[0][a];
          rlo[kBins - 1][a] = bl[kBins - 1][a];
          rhi[kBins - 1][a] = bh[kBins - 1][a];
        }
        for (int bi = 1; bi < kBins; ++bi)
          for (int a = 0; a < 3; ++a) {
            llo[bi][a] = std::min(llo[bi - 1][a], bl[bi][a]);
            lhi[bi][a] = std::max(lhi[bi - 1][a], bh[bi][a]);
          }
        for (int bi = kBins - 2; bi >= 0; --bi)
          for (int a = 0; a < 3; ++a) {
            rlo[bi][a] = std::min(rlo[bi + 1][a], bl[bi][a]);
            rhi[bi][a] = std::max(rhi[bi + 1][a], bh[bi][a]);
          }
        int64_t nl = 0;
        for (int bi = 0; bi < kBins - 1; ++bi) {
          nl += counts[bi];
          const int64_t nr = n - nl;
          if (nl == 0 || nr == 0) continue;
          const double cost = half_area(llo[bi], lhi[bi]) * nl
                              + half_area(rlo[bi + 1], rhi[bi + 1]) * nr;
          if (cost < best_cost) {
            best_cost = cost;
            best_axis = axis;
            best_edge = cmin[axis] + (bi + 1) / scale;
          }
        }
      }
      if (best_axis >= 0) {
        // stable partition on centroid < edge (matches numpy concatenate)
        tmp.clear();
        std::vector<int64_t> right;
        for (int64_t i = lo; i < hi; ++i) {
          const int64_t p = b.order[i];
          if (b.centroid[p * 3 + best_axis] < best_edge) tmp.push_back(p);
          else right.push_back(p);
        }
        const int64_t nl = static_cast<int64_t>(tmp.size());
        if (nl > 0 && nl < n) {
          std::copy(tmp.begin(), tmp.end(), b.order.begin() + lo);
          std::copy(right.begin(), right.end(), b.order.begin() + lo + nl);
          mid = lo + nl;
        }
      }
      if (mid < 0) {
        // degenerate binning: median split on the widest centroid axis
        int axis = 0;
        double w = -1.0;
        for (int a = 0; a < 3; ++a)
          if (cmax[a] - cmin[a] > w) { w = cmax[a] - cmin[a]; axis = a; }
        std::stable_sort(
            b.order.begin() + lo, b.order.begin() + hi,
            [&](int64_t x, int64_t y) {
              return b.centroid[x * 3 + axis] < b.centroid[y * 3 + axis];
            });
        mid = lo + n / 2;
      }
    } else {
      const int axis = static_cast<int>(rng.f64() * 3.0) % 3;
      std::stable_sort(
          b.order.begin() + lo, b.order.begin() + hi,
          [&](int64_t x, int64_t y) {
            return b.centroid[x * 3 + axis] < b.centroid[y * 3 + axis];
          });
      mid = lo + n / 2;
    }
    const int64_t li = static_cast<int64_t>(b.nodes.size());
    {
      BinNode ln;
      b.seg_bounds(lo, mid, ln.bb_min, ln.bb_max);
      b.nodes.push_back(ln);
    }
    const int64_t ri = static_cast<int64_t>(b.nodes.size());
    {
      BinNode rn;
      b.seg_bounds(mid, hi, rn.bb_min, rn.bb_max);
      b.nodes.push_back(rn);
    }
    b.nodes[ni].left = li;
    b.nodes[ni].right = ri;
    stack.push_back({li, lo, mid});
    stack.push_back({ri, mid, hi});
  }

  // 2-level collapse, BFS emission (matches bvh_build.py collect_slots).
  auto collect = [&](int64_t bi, int64_t* slots) -> int {
    const BinNode& node = b.nodes[bi];
    if (node.count > 0) {
      slots[0] = bi;
      return 1;
    }
    int n = 0;
    for (int64_t ci : {node.left, node.right}) {
      const BinNode& c = b.nodes[ci];
      if (c.count > 0) {
        slots[n++] = ci;
      } else {
        slots[n++] = c.left;
        slots[n++] = c.right;
      }
    }
    return n;
  };

  std::vector<int64_t> queue;
  queue.push_back(0);
  int64_t emitted = 1;
  if (emitted > max_nodes) return -1;

  const float kMaxF = std::numeric_limits<float>::max();
  for (int64_t qi = 0; qi < static_cast<int64_t>(queue.size()); ++qi) {
    const int64_t bi = queue[qi];
    const int64_t wi = qi;
    float bmin[4][3], bmax[4][3];
    for (int s = 0; s < 4; ++s)
      for (int a = 0; a < 3; ++a) {
        bmin[s][a] = kMaxF;
        bmax[s][a] = -kMaxF;
      }
    int64_t slots[4];
    const int n_slots = collect(bi, slots);
    for (int s = 0; s < 4; ++s) {
      out_child[wi * 4 + s] = -1;
      out_count[wi * 4 + s] = -1;
    }
    for (int s = 0; s < n_slots; ++s) {
      const BinNode& sn = b.nodes[slots[s]];
      for (int a = 0; a < 3; ++a) {
        bmin[s][a] = conservative_lo(sn.bb_min[a]);
        bmax[s][a] = conservative_hi(sn.bb_max[a]);
      }
      if (sn.count > 0) {
        out_child[wi * 4 + s] = static_cast<int32_t>(sn.start);
        out_count[wi * 4 + s] = static_cast<int32_t>(sn.count);
      } else {
        const int64_t nwi = emitted++;
        if (emitted > max_nodes) return -1;
        queue.push_back(slots[s]);
        out_child[wi * 4 + s] = static_cast<int32_t>(nwi);
        out_count[wi * 4 + s] = 0;
      }
    }
    // SoA layout: [minx×4, miny×4, minz×4, maxx×4, maxy×4, maxz×4].
    for (int a = 0; a < 3; ++a)
      for (int s = 0; s < 4; ++s) {
        out_bounds[wi * 24 + a * 4 + s] = bmin[s][a];
        out_bounds[wi * 24 + 12 + a * 4 + s] = bmax[s][a];
      }
  }

  for (int64_t i = 0; i < n_prims; ++i)
    prim_order[i] = static_cast<int32_t>(b.order[i]);
  return emitted;
}
