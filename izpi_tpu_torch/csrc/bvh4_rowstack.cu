// Closest hit through a leaf-64 BVH4: one warp per row of 32 rays, one stack
// per warp, each visited leaf tested one primitive per lane against only the
// rays whose own box test hit it.
//
// Replaces izpi_tpu/ops/bvh_rowkernel.py:126 (_row_kernel, launched by
// build_traverse_fn :396-463), the Pallas kernel that gives each 128-ray row
// of a TPU tile its own exact stack. What it computes is that kernel's
// function: per ray the closest hit in [t_min, t_max] and its block slot
// (block id · 64 + position in the block), -1 on a miss. On the GPU a row is
// a warp of 32 consecutive rays, in the caller's order (sorting them by a
// coherence key first, as the JAX intersector does, cost more than it saved
// on the H100: PERF.md):
//   - a node step pops one node from the warp's stack (shared memory; every
//     lane reads the same entry). Every lane slab-tests the node's four
//     children against its own best t (the reference's tMax shrink,
//     bvh4.go:130), and __ballot_sync gathers each child's lanes into a
//     mask; a child is visited when its mask is not empty;
//   - the visited leaves are tested in slot order. For each ray of a leaf's
//     mask, in lane order, the ray's origin, direction, time and best t are
//     broadcast with __shfl_sync and the 32 lanes test primitives k and
//     k + 32 of the block against it (common.cuh prim_test); two warp
//     min-reductions (__reduce_min_sync) pick the smallest t and, among equal
//     t, the smallest slot, which is what a serial loop with a strict < keeps.
//     A leaf costs ceil(count / 32) tests per lane for each ray that hit its
//     box, not count tests in every lane;
//   - the leaf blocks reach shared memory by cp.async, double-buffered: the
//     next visited leaf of the node step is in flight while the warp tests
//     this one. A block row is 16 words in global memory and 20 in shared
//     memory, so the 128-bit loads of 8 lanes reading 8 rows cover 8
//     disjoint groups of 4 banks (at 16 words they fall on 2 and conflict
//     4-way). The padding is also why this is cp.async and not a 1-D bulk
//     copy (cp.async.bulk), which writes one contiguous run;
//   - the visited internal children are pushed in one fixed order (slot 3
//     first, so slot 0 is popped next): the lanes' entry distances differ,
//     so the row does not sort them.
// Lanes past n keep their best t at t_min, so they never hit and never vote
// for a child, and a lane whose ray holds a NaN never votes (it hits nothing
// either way); no lane leaves the loop early, so every warp-synchronous call
// sees the full mask. The stack needs at most the tree's worst-case
// occupancy, which the attach checks against 64: the warp pushes a subset of
// each node's children, as one ray does.
//
// The leaf test equals bvh_rowkernel.py:187-268 but on two measure-zero
// inputs, where it follows the port's brute force (primitives.prim_t)
// instead: a hit at exactly t_min counts (the Pallas kernel needs t > t_min),
// and a rect with a zero-length edge divides by zero and misses (the Pallas
// kernel divides by 1). The sphere's near/far rule (:254-257) is the same.
//
// The plain version, izpi_tpu_torch/ops/bvh_rowkernel.py closest_rows, walks
// the same rows node for node and tests the same (ray, primitive) pairs, so
// both give the same (t, slot) and the same per-warp counters; the build
// keeps IEEE rounding (-fmad=false) for that.
//
// Tables (izpi_tpu_torch/ops/bvh_rowkernel.py pack_scene):
//   nodes  (Nn, 32) 4-byte words: bounds [minx×4 miny×4 minz×4 maxx×4 maxy×4
//          maxz×4] as f32 | child[4] | count[4] as i32; a leaf's child is its
//          block id;
//   blocks (Nb, 64, 16) f32: g0 g1 g2 g3 | kind | 3 words the kernel does not
//          read.
//
// Bound: a node step is ~100 FP32 operations per lane and a (ray, primitive)
// test ~58; the rays a warp drags through nodes its own rays do not need, and
// the latency of one node pop after another, not bytes, are what the
// warp-wide stack costs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

// The asynchronous 16-byte copy global -> shared, its commit and its wait
// (at most N groups of this thread still in flight). A host build of this
// file defines them first as a plain copy and nothing.
#ifndef IZPI_CP_ASYNC_16
#define IZPI_CP_ASYNC_16(dst, src)                                                      \
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(                     \
                   (unsigned)__cvta_generic_to_shared(dst)),                            \
               "l"(src)                                                                 \
               : "memory")
#define IZPI_CP_ASYNC_COMMIT() asm volatile("cp.async.commit_group;\n" ::: "memory")
#define IZPI_CP_ASYNC_WAIT(n) asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory")
#endif

namespace izpi {

constexpr int kRowStack = 64;         // ops/bvh_rowkernel.py KSTACK, checked at attach
constexpr int kLeafPrims = 64;        // ops/bvh_rowkernel.py LEAF_SIZE
constexpr int kBlockWords = 16;       // a block row in global memory
constexpr int kLeafRowWords = 20;     // the same row in shared memory, padded
constexpr int kRowNodeWords = 32;
constexpr int kWarpsPerBlock = 4;
constexpr int kLeafWords = kLeafPrims * kLeafRowWords;
constexpr int kLeafVec4 = kLeafPrims * kBlockWords / 4;  // a block in global memory
constexpr float kRowInvEps = 1e-30f;  // a zero direction component (bvh_rowkernel.py:156)
constexpr unsigned kFullMask = 0xffffffffu;
constexpr unsigned kNoHit = 0xffffffffu;

// A key whose unsigned order is the float order of t (NaN aside), -0 read as
// +0 so that the two tie as the float comparison says.
__device__ __forceinline__ unsigned order_key(float t) {
  const unsigned u = __float_as_uint(t + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// a[s] for a warp-uniform s, by selects: a dynamic index would put the
// array in local memory.
__device__ __forceinline__ int sel4(const int (&a)[4], int s) {
  return s == 0 ? a[0] : s == 1 ? a[1] : s == 2 ? a[2] : a[3];
}
__device__ __forceinline__ unsigned sel4(const unsigned (&a)[4], int s) {
  return s == 0 ? a[0] : s == 1 ? a[1] : s == 2 ? a[2] : a[3];
}

// The warp copies `count` primitive rows of a leaf block into `dst` (rows of
// kLeafRowWords) and commits them as one group.
__device__ __forceinline__ void copy_leaf(float* dst, const float4* src, int count, int lane) {
  for (int q = lane; q < count * (kBlockWords / 4); q += 32) {
    IZPI_CP_ASYNC_16(dst + (q >> 2) * kLeafRowWords + (q & 3) * 4, src + q);
  }
  IZPI_CP_ASYNC_COMMIT();
}

// Test primitive k of a leaf in shared memory against a ray; on a hit below
// t_best keep it in (key, t, k) when its key is smaller.
__device__ __forceinline__ void test_row(const float* leaf, int k, V3 o, V3 d, float tme,
                                         float t_min, float t_best, unsigned& key, float& t_hit,
                                         int& k_hit) {
  const float4* row = reinterpret_cast<const float4*>(leaf + k * kLeafRowWords);
  float g[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 v = row[q];
    g[4 * q + 0] = v.x;
    g[4 * q + 1] = v.y;
    g[4 * q + 2] = v.z;
    g[4 * q + 3] = v.w;
  }
  float t;
  if (prim_test(g, (int)g[12], o, d, tme, t_min, t_best, t) && t < t_best) {
    const unsigned kt = order_key(t);
    if (kt < key) {
      key = kt;
      t_hit = t;
      k_hit = k;
    }
  }
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    bvh4_rowstack(const int* __restrict__ nodes, const float4* __restrict__ blocks,
                  const float* __restrict__ ray_o, const float* __restrict__ ray_d,
                  const float* __restrict__ ray_time, int n, float t_min, float t_max,
                  float* __restrict__ t_out, int* __restrict__ idx_out,
                  int* __restrict__ counters) {
  __shared__ int s_stack[kWarpsPerBlock][kRowStack];
  __shared__ __align__(16) float s_leaf[kWarpsPerBlock][2][kLeafWords];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int warp = blockIdx.x * kWarpsPerBlock + wib;
  if (warp * 32 >= n) return;  // warp-uniform: the whole row lies past n
  const int i = warp * 32 + lane;
  const bool valid = i < n;

  V3 o = mk(0.0f, 0.0f, 0.0f), d = mk(1.0f, 1.0f, 1.0f);
  float tme = 0.0f;
  if (valid) {
    o = ld3(ray_o + 3 * i);
    d = ld3(ray_d + 3 * i);
    tme = ray_time[i];
  }
  const float od[3] = {o.x, o.y, o.z};
  const float inv[3] = {1.0f / (d.x == 0.0f ? kRowInvEps : d.x),
                        1.0f / (d.y == 0.0f ? kRowInvEps : d.y),
                        1.0f / (d.z == 0.0f ? kRowInvEps : d.z)};
  float t_best = valid ? t_max : t_min;
  int best = -1;
  // A lane with a NaN in its ray votes for no child (csrc/bvh4_traverse.cu):
  // fminf/fmaxf would drop the NaN and make its warp walk the whole tree.
  const bool live = !(isnan(o.x) || isnan(o.y) || isnan(o.z) || isnan(d.x) || isnan(d.y) ||
                      isnan(d.z));

  int* stack = s_stack[wib];
  int sp = 1;  // warp-uniform
  if (lane == 0) stack[0] = 0;
  __syncwarp();
  int pops = 0, leaves = 0, pairs = 0;

  while (sp > 0) {
    const int node = stack[--sp];
    ++pops;
    const float4* nb = reinterpret_cast<const float4*>(nodes + (size_t)node * kRowNodeWords);
    float bnd[24];
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      const float4 v = __ldg(nb + q);
      bnd[4 * q + 0] = v.x;
      bnd[4 * q + 1] = v.y;
      bnd[4 * q + 2] = v.z;
      bnd[4 * q + 3] = v.w;
    }
    const int4 c4 = __ldg(reinterpret_cast<const int4*>(nb + 6));
    const int4 n4 = __ldg(reinterpret_cast<const int4*>(nb + 7));
    const int ch[4] = {c4.x, c4.y, c4.z, c4.w};
    const int cnt[4] = {n4.x, n4.y, n4.z, n4.w};

    // 4-wide slab test against this lane's best t at the pop; each child's
    // lanes as a mask.
    unsigned mask[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      float tn = t_min, tf = t_best;
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        const float t0 = (bnd[ax * 4 + s] - od[ax]) * inv[ax];
        const float t1 = (bnd[12 + ax * 4 + s] - od[ax]) * inv[ax];
        tn = fmaxf(tn, fminf(t0, t1));
        tf = fminf(tf, fmaxf(t0, t1));
      }
      mask[s] = __ballot_sync(kFullMask, live && tf > tn && cnt[s] != -1);
    }

    // The visited leaves in slot order (warp-uniform), 4 bits a slot, the
    // first one's copy started at once.
    int leaf_list = 0, n_leaf = 0;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (mask[s] != 0u && cnt[s] > 0) leaf_list |= s << (4 * n_leaf++);
    }
    if (n_leaf > 0) {
      const int s0 = leaf_list & 15;
      copy_leaf(s_leaf[wib][0], blocks + (size_t)sel4(ch, s0) * kLeafVec4, sel4(cnt, s0), lane);
    }
    for (int j = 0; j < n_leaf; ++j) {
      if (j + 1 < n_leaf) {
        const int s1 = (leaf_list >> (4 * (j + 1))) & 15;
        copy_leaf(s_leaf[wib][(j + 1) & 1], blocks + (size_t)sel4(ch, s1) * kLeafVec4,
                  sel4(cnt, s1), lane);
        IZPI_CP_ASYNC_WAIT(1);
      } else {
        IZPI_CP_ASYNC_WAIT(0);
      }
      __syncwarp();  // every lane's part of leaf j has landed
      const float* leaf = s_leaf[wib][j & 1];
      const int s = (leaf_list >> (4 * j)) & 15;
      const int count = sel4(cnt, s);
      const int block_slot0 = sel4(ch, s) * kLeafPrims;
      unsigned m = sel4(mask, s);
      ++leaves;
      pairs += __popc(m) * count;
      while (m != 0u) {
        const int r = __ffs(m) - 1;
        m &= m - 1u;
        const V3 ro = mk(__shfl_sync(kFullMask, o.x, r), __shfl_sync(kFullMask, o.y, r),
                         __shfl_sync(kFullMask, o.z, r));
        const V3 rd = mk(__shfl_sync(kFullMask, d.x, r), __shfl_sync(kFullMask, d.y, r),
                         __shfl_sync(kFullMask, d.z, r));
        const float rt = __shfl_sync(kFullMask, tme, r);
        const float rb = __shfl_sync(kFullMask, t_best, r);
        unsigned key = kNoHit;
        float t_hit = 0.0f;
        int k_hit = kLeafPrims;
        if (lane < count) test_row(leaf, lane, ro, rd, rt, t_min, rb, key, t_hit, k_hit);
        if (lane + 32 < count) test_row(leaf, lane + 32, ro, rd, rt, t_min, rb, key, t_hit, k_hit);
        const unsigned key_min = __reduce_min_sync(kFullMask, key);
        if (key_min != kNoHit) {  // warp-uniform
          const unsigned k_min =
              __reduce_min_sync(kFullMask, key == key_min ? (unsigned)k_hit : kNoHit);
          const float t_win = __shfl_sync(kFullMask, t_hit, (int)(k_min & 31u));
          if (lane == r) {
            t_best = t_win;
            best = block_slot0 + (int)k_min;
          }
        }
      }
      __syncwarp();  // every lane is done with this buffer before it is refilled
    }

    // Visited internal children, slot 3 first. Every lane has read the popped
    // entry before lane 0 overwrites it.
    __syncwarp();
#pragma unroll
    for (int s = 3; s >= 0; --s) {
      // The attach checks the worst-case stack against kRowStack, so the
      // guard never drops a node.
      if (mask[s] != 0u && cnt[s] == 0 && sp < kRowStack) {
        if (lane == 0) stack[sp] = ch[s];
        ++sp;
      }
    }
    __syncwarp();
  }
  if (valid) {
    t_out[i] = t_best;
    idx_out[i] = best;
  }
  if (counters != nullptr && lane == 0) {
    counters[3 * warp] = pops;
    counters[3 * warp + 1] = leaves;
    counters[3 * warp + 2] = pairs;
  }
}

}  // namespace izpi

extern "C" {

// Launches the row-stack traversal of n rays on `stream`; returns
// cudaGetLastError(). o, d: (n, 3) f32; time: (n,) f32; t: (n,) f32 and idx:
// (n,) i32 (block slots) outputs; counters: null, or (ceil(n/32), 3) i32 for
// per-warp (nodes popped, leaf blocks tested, (ray, primitive) pairs tested).
// t_max must be clamped to T_MAX by the caller.
int izpi_bvh4_rowstack(const int* nodes, const float* blocks, const float* o, const float* d,
                       const float* time, int n, float t_min, float t_max, float* t, int* idx,
                       int* counters, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int warps = (n + 31) / 32;
  const int grid = (warps + izpi::kWarpsPerBlock - 1) / izpi::kWarpsPerBlock;
  izpi::bvh4_rowstack<<<grid, 32 * izpi::kWarpsPerBlock, 0, (cudaStream_t)stream>>>(
      nodes, reinterpret_cast<const float4*>(blocks), o, d, time, n, t_min, t_max, t, idx,
      counters);
  return (int)cudaGetLastError();
}

}  // extern "C"
