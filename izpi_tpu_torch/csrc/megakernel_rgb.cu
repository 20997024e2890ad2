// The RGB render loop in one persistent CUDA kernel.
//
// Replaces izpi_tpu/ops/megakernel.py:628 (build_renderer.<kernel>, the
// Pallas megakernel). A slot serves pixel slot % n_pix and walks its samples
// replica*spp_slot + [0, spp_slot) + offset in order (the mapping of
// megakernel.py:647): a thin-lens camera ray from the Threefry streams, then
// bounces until the path misses, hits a light or reaches the depth cap. A
// bounce finds the closest hit over all primitives, resolves the winner's
// record normal once, and shades Lambertian (NEE mixture pdf), metal (fuzz),
// dielectric (Schlick, Beer–Lambert exit re-trace) and one-sided diffuse
// lights. The DeNAN'd radiance of every finished path is added to the slot's
// own sum in sample order, and the sum and ray count are written once, so
// the output does not depend on which thread ran the slot and needs no
// atomics on floats.
//
// The arithmetic follows izpi_tpu_torch/integrator/path.py (the plain twin,
// itself the JAX oracle's twin) operation for operation, so the build must
// keep IEEE rounding: -fmad=false, no --use_fast_math, precise
// sqrtf/expf/logf/sinf/cosf/powf.
//
// Bound: per-thread instruction issue and the half-rate INT32 pipe — the
// primitive loop (every ray tests every primitive) and the Threefry rounds
// (counted from the SASS of one-unit probes, csrc/sass_probes.cu). The
// scene tables are a few KB, read at warp-uniform addresses, and stay in
// L1.
// Against the one-thread-per-slot kernel this replaces, whose warps idled
// until their longest path ended and whose grid did not fill the card:
//  1. Persistent threads. One grid of (blocks per SM from the occupancy
//     calculator) x (SM count) blocks; each thread takes slots from a global
//     counter (atomicAdd) until the queue drains. The wrapper sizes the
//     slots at >= SLOTS_PER_THREAD per resident thread (replicas split a
//     pixel's samples), so the last slots leave a short tail.
//  2. Path regeneration. One loop, one bounce per trip: a lane whose path
//     ends deposits it and starts its next sample — or its next slot's
//     first — in the same trip, so a warp's lanes stay busy until the queue
//     drains instead of waiting on the warp's longest path.
//  3. Lazy draws (draws.cuh). A scatter draws the two fold-ins and only the
//     counter pairs its material and branch read (1 to 5 of the 6), and a
//     lane's bounce and new-sample draws run in one loop of converged
//     cipher calls, so a warp pays the longest queue, not their sum.
//  4. Registers, measured on the card (PERF.md): the camera is a kernel
//     parameter (constant bank, not 21 registers), and __launch_bounds__
//     asks for kMegaMinBlocks = 5 blocks per SM, 96 registers with no
//     spill, 20 warps per SM instead of 16 (5% faster). Staging the scene
//     tables in shared memory gained 0.3% at that occupancy and was not
//     kept: they are a few KB read at warp-uniform addresses, from L1.
// Scene tables come in by pointer, packed on the host by
// izpi_tpu_torch/ops/megakernel.py (pack_tables). The primitive tests, the
// light list, the camera ray, the slot queue and the table layouts are in
// common.cuh, shared with megakernel_spectral.cu.
//
// The BVH form (megakernel_rgb_bvh) is the same loop with the closest hit
// through a BVH4 (bvh4.cuh, the traversal of bvh4_traverse.cu) in place of
// the scan of every primitive: it renders what the queue pool renders
// through that traversal kernel (izpi_tpu_torch/integrator/wavefront.py),
// the same paths keyed by (pixel, sample), but keeps each path in one
// thread's registers from the camera to the deposit, where the pool reads
// and writes every slot's state through device memory a few hundred times
// an iteration. The primitive tables (prim_f, prim_i) are packed from the
// tree's reordered primitives, so a hit index names the same primitive in
// the tree's table and in the scene's. The loop is a template over its
// closest-hit function, so the brute-force form's code is what it was.
// Bound: latency, not issue (4.45% of its SASS bound before this schedule):
// a warp's lanes pop 2.2 nodes a ray on cornell_box_obj, the longest of
// them 17, so the warp waits on its longest traversal, and each pass of a
// leaf test waits for primitive rows from L2. What the form does about it,
// each kept because it measured faster on the H100 (PERF.md):
//  1. The warp traverses together (bvh4.cuh bvh4_closest_warp): inner passes
//     until every lane holds leaves, then one leaf pass for all of them,
//     each lane keeping its own visits, tests and their order. So every
//     lane calls the closest hit once a trip, at one call site: a
//     refraction into absorbing glass leaves its Beer–Lambert exit re-trace
//     to the lane's next trip, and a lane whose queue has drained stays in
//     the loop, tracing nothing, until its warp is done.
//  2. kBvhMinBlocks = 7 blocks an SM (common.cuh), for the loads' latency.
// Its probe instance (megakernel_rgb_bvh_probe) counts how the warps spend
// the traversal; only the scripts launch it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bvh4.cuh"
#include "common.cuh"

namespace izpi {

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// The closest hit of the brute-force form: every primitive (common.cuh).
struct BruteHit {
  static constexpr bool kWarp = false;  // each lane on its own
  __device__ __forceinline__ int operator()(const Scene& sc, int /*slot*/, V3 o, V3 d,
                                            float tme, float t_min, float t_max,
                                            float& t) const {
    return closest_hit(sc, o, d, tme, t_min, t_max, t);
  }
};

// ---------------------------------------------------------------------------
// The probe
// ---------------------------------------------------------------------------

// The probe instance of the BVH form (izpi_megakernel_rgb_bvh_probe) renders
// what the main instance renders, through the same visits in the same
// order, and adds over the launch how the warps spend the traversal. Each
// lane keeps its counts and adds them to the launch's row once, at its
// exit; the warp's counts are kept by lane 0. Read by ops/megakernel.py
// probe_bvh in this order.
enum ProbeCounter : int {
  kPrCalls = 0,     // warp traversal calls in which a lane traces
  kPrRays,          // lane traversal calls
  kPrVisits,        // nodes popped, over the lanes
  kPrVisitPasses,   // passes of the warp through its visit loop
  kPrTests,         // primitives tested, over the lanes
  kPrTestPasses,    // passes of the warp through its primitive tests
  kPrMaxVisits,     // the most nodes one lane of the warp popped in a call
  kPrCyTraversal,   // clock64 cycles over the lanes: in the closest hit,
  kPrCyRegen,       // in regeneration (take_slot, the deposit, the camera ray),
  kPrCyLoop,        // in the whole loop (the rest is shading and the cipher)
  kProbeCounters
};

// The probe's tally of one traversal call (bvh4.cuh bvh4_closest_warp), which
// every lane of the warp takes: the warp's inner passes, its leaf passes'
// rounds (the most primitives a lane tests in the pass), and the lanes'
// counts, the warp's by lane 0.
struct WarpTally {
  unsigned long long* pc;  // the lane's counters
  bool lead;               // lane 0
  __device__ __forceinline__ explicit WarpTally(unsigned long long* counters)
      : pc(counters), lead((threadIdx.x & 31) == 0) {}
  __device__ __forceinline__ void visit_pass() {
    if (lead) ++pc[kPrVisitPasses];
  }
  __device__ __forceinline__ void test_pass(int held) {
    const int most = __reduce_max_sync(0xffffffffu, held);
    if (lead) pc[kPrTestPasses] += most;
  }
  __device__ __forceinline__ void done(bool active, int visits, int tests) {
    const int most = __reduce_max_sync(0xffffffffu, visits);
    if (lead && most > 0) {
      ++pc[kPrCalls];
      pc[kPrMaxVisits] += most;
    }
    if (active) ++pc[kPrRays];
    pc[kPrVisits] += visits;
    pc[kPrTests] += tests;
  }
};

// A main instance's tally: nothing.
struct NoCount {
  __device__ __forceinline__ explicit NoCount(unsigned long long*) {}
  __device__ __forceinline__ void visit_pass() {}
  __device__ __forceinline__ void test_pass(int) {}
  __device__ __forceinline__ void done(bool, int, int) {}
};

// The BVH form's tables, as its C entry receives them.
struct BvhTables {
  const int* __restrict__ nodes;
  const float* __restrict__ prims;
  int* __restrict__ counts;
};

// The closest hit of the BVH form: the BVH4 traversal (bvh4.cuh
// bvh4_closest_warp) over the tree's node table and its primitive table,
// whose primitives are the scene's in the same (tree) order. Every lane of
// the warp calls it in every trip (kWarp), a lane with no path with slot
// -1, which traces nothing. With `counts`, each slot's nodes popped and
// primitives tested are added to its row: no other thread writes it.
// Tally: NoCount, or the probe's WarpTally.
template <class Tally>
struct BvhHit {
  static constexpr bool kWarp = true;  // the warp's lanes trace together, once a trip
  BvhTables tab;
  __device__ __forceinline__ int operator()(const Scene& /*sc*/, int slot, V3 o, V3 d,
                                            float tme, float t_min, float t_max, float& t,
                                            unsigned long long* pc = nullptr) const {
    int visits = 0, tests = 0;
    Tally tally(pc);
    const int hit = bvh4_closest_warp(tab.nodes, tab.prims, slot >= 0, o, d, tme, t_min,
                                      t_max, t, visits, tests, tally);
    if (tab.counts != nullptr && slot >= 0) {
      tab.counts[2 * slot + 0] += visits;
      tab.counts[2 * slot + 1] += tests;
    }
    return hit;
  }
};

// ---------------------------------------------------------------------------
// The render loop
// ---------------------------------------------------------------------------

// The render loop, over the closest-hit function `closest` (BruteHit or
// BvhHit; in the probe instance, kProbe, a BvhHit whose WarpTally and the
// loop's cycle counts are added to probe_out); everything else is the same
// code in both forms.
template <bool kProbe = false, class Hit>
__device__ __forceinline__ void render_loop(const Hit& closest, const Scene& sc,
                                            const Camera& camera, uint32_t seed0,
                                            uint32_t seed1, uint32_t offset, int nx, int ny,
                                            int spp_slot, int n_slots, int max_depth,
                                            float bg_r, float bg_g, float bg_b, int book,
                                            int* __restrict__ queue,
                                            float* __restrict__ acc_out,
                                            int* __restrict__ cnt_out,
                                            int* __restrict__ draws_out,
                                            unsigned long long* __restrict__ probe_out =
                                                nullptr) {
  // The probe instance's counts (kProbe); the main instances compile them out.
  unsigned long long pc[kProbe ? kProbeCounters : 1] = {};
  long long c_loop = 0, c_regen = 0;
  if constexpr (kProbe) c_loop = clock64();
  // The lane's counts into the launch's row, at its exit.
  const auto flush = [&]() {
    if constexpr (kProbe) {
      pc[kPrCyLoop] += (unsigned long long)(clock64() - c_loop);
      for (int i = 0; i < kProbeCounters; ++i) atomicAdd(probe_out + i, pc[i]);
    }
  };
  // The closest hit of a ray of this slot's path.
  const auto trace = [&](int slot, V3 ro, V3 rd, float tme, float t0, float t1, float& t) {
    if constexpr (kProbe) {
      const long long c0 = clock64();
      const int hit = closest(sc, slot, ro, rd, tme, t0, t1, t, pc);
      pc[kPrCyTraversal] += (unsigned long long)(clock64() - c0);
      return hit;
    } else {
      return closest(sc, slot, ro, rd, tme, t0, t1, t);
    }
  };
  const int n_pix = nx * ny;
  const V3 bg = mk(bg_r, bg_g, bg_b);
  const float cos_scale = book ? 2.0f : 1.0f;

  int slot = take_slot(queue, n_slots, spp_slot, acc_out, cnt_out);
  // Hit::kWarp: the lanes of a warp trace together, once a trip, so a lane
  // whose queue has drained (done) stays in the loop, tracing nothing, until
  // every lane of its warp is done.
  bool done = slot >= n_slots;
  if (!Hit::kWarp && done) {
    flush();
    return;
  }
  int samp = 0;
  Draws<false> dr;
  dr.clear();
  if (!done) {
    dr.new_sample(seed0, seed1, sample_id(slot, 0, n_pix, spp_slot, offset),
                  (uint32_t)(slot % n_pix));
  }
  dr.run(seed0, seed1, 0u, 0u, 0u);

  uint32_t k0 = dr.key0, k1 = dr.key1;  // the path's key
  V3 o = mk(0.0f, 0.0f, 0.0f), d = o;
  float tme = 0.0f;
  if (!done) pixel_ray(camera, dr.cu, slot % n_pix, nx, ny, o, d, tme);
  V3 thru = mk(1.0f, 1.0f, 1.0f);
  V3 rad = mk(0.0f, 0.0f, 0.0f);
  int depth = 0;
  V3 acc = mk(0.0f, 0.0f, 0.0f);  // the slot's sums
  int cnt = 0;
  int next_slot = slot, next_samp = samp;  // the sample after this path
  // Hit::kWarp: the material of the absorbing glass whose exit this trip
  // re-traces, or -1.
  int exit_mat = -1;

  for (;;) {  // one bounce of one path per trip
    if constexpr (Hit::kWarp) {
      if (__all_sync(0xffffffffu, done)) break;
    }
    // A form that traces once a trip (Hit::kWarp) leaves the exit re-trace
    // of a refraction into absorbing glass to the next trip, and finishes
    // that bounce there: lanes that re-trace then traverse together with
    // lanes that trace their next bounce.
    const bool retrace = Hit::kWarp && exit_mat >= 0;
    V3 ro = o;
    float t0 = kTMin, t1 = kTMax;
    if (retrace) {
      ro = o + d * 1e-3f;
      t0 = 0.0f;
      t1 = 1000.0f;
    } else {
      ++cnt;
    }
    float t;
    const int hit = trace(done ? -1 : slot, ro, d, tme, t0, t1, t);
    if (Hit::kWarp && done) continue;
    bool ends;
    if (retrace) {  // Beer–Lambert (dielectric.go:118-153): the bounce's mult
      float path_len = 10.0f;
      if (hit >= 0) path_len = clamp(length((ro + d * t) - o), 0.1f, 100.0f);
      const float* A = sc.mat_f + exit_mat * kMatF + 8;
      thru = thru * mk(expf(-A[0] * path_len), expf(-A[1] * path_len),
                       expf(-A[2] * path_len));
      exit_mat = -1;
      ends = depth >= max_depth;  // the bounce's cap: depth has advanced
      if (ends) rad = rad + thru * mk(0.0f, 0.0f, 1.0f);
    } else {
      V3 p = o, n = d, albedo = bg;
      const float* M = sc.mat_f;
      const int* Mi = sc.mat_i;
      int kind = -1, mat = -1;
      if (hit < 0) {
        rad = rad + thru * bg;
      } else {
        p = o + d * t;
        n = record_normal(sc, hit, o, d, tme, p);
        mat = sc.prim_i[hit * kPrimI + 1];
        M = sc.mat_f + mat * kMatF;
        Mi = sc.mat_i + mat * kMatI;
        kind = Mi[0];
        albedo = ld3(M);
        if (Mi[1] != 0) {  // 3D sine checker (texture/checker.go:26)
          const float sines = sinf(10.0f * p.x) * sinf(10.0f * p.y) * sinf(10.0f * p.z);
          if (!(sines < 0.0f)) albedo = ld3(M + 3);
        }
        // One-sided light keyed on the record normal (diffuselight.go:49-63).
        // thru * 0 is added for every other hit, as the twin does, so a
        // non-finite throughput poisons the sample the same way.
        const bool emits = kind == kDiffuseLight && dot(n, d) < 0.0f;
        rad = rad + thru * (emits ? albedo : mk(0.0f, 0.0f, 0.0f));
      }
      const bool scatters = hit >= 0 && kind != kDiffuseLight;
      // The depth cap: the {Z:1} sentinel after the scatter (colour.go:34-36).
      const bool capped = scatters && depth + 1 >= max_depth;
      ends = !scatters || capped;

      // The next sample, from the next slot once this one is done.
      next_slot = slot;
      next_samp = samp;
      if (ends && ++next_samp == spp_slot) {
        if constexpr (kProbe) c_regen = clock64();
        next_slot = take_slot(queue, n_slots, spp_slot, acc_out, cnt_out);
        next_samp = 0;
        if constexpr (kProbe) pc[kPrCyRegen] += (unsigned long long)(clock64() - c_regen);
      }
      const uint32_t pair_list = kind == kMetal        ? kPairsMetal
                                 : kind == kDielectric ? kPairsDielectric
                                                       : kPairsDiffuse;
      dr.clear();
      if (ends && next_slot < n_slots) {
        dr.new_sample(seed0, seed1, sample_id(next_slot, next_samp, n_pix, spp_slot, offset),
                      (uint32_t)(next_slot % n_pix));
      }
      if (scatters) dr.bounce(k0, k1, (uint32_t)depth, pair_list);
      dr.run(seed0, seed1, k0, k1, (uint32_t)depth);

      if (scatters) {
        const float* us = dr.us;
        V3 d_new, mult;
        if (kind == kMetal) {  // metal.go:34-40
          const float z = 1.0f - 2.0f * us[0];
          const float phib = kTwoPi * us[1];
          const float sb = sqrtf(clamp_min(1.0f - z * z, 0.0f));
          // cbrt as exp(log/3), the form the twin and the JAX package use.
          const float rb = expf(logf(clamp_min(us[2], 1e-30f)) * (1.0f / 3.0f));
          const V3 fuzz_vec = mk(sb * cosf(phib), sb * sinf(phib), z) * rb;
          d_new = reflect(normalize(d), n) + fuzz_vec * M[6];
          mult = albedo;
        } else if (kind == kDielectric) {  // dielectric.go:66-102, raw direction
          const float ref_idx = M[7];
          const V3 reflected = reflect(d, n);
          const float d_dot_n = dot(d, n);
          const bool exiting = d_dot_n > 0.0f;
          const V3 outward = exiting ? -n : n;
          const float ni = exiting ? ref_idx : 1.0f / ref_idx;
          const float dlen = length(d);
          const float cosine = exiting ? ref_idx * d_dot_n / dlen : -d_dot_n / dlen;
          const V3 uv = normalize(d);
          const float dt = dot(uv, outward);
          const float disc = 1.0f - ni * ni * (1.0f - dt * dt);
          const V3 refracted = (uv - outward * dt) * ni - outward * sqrtf(clamp_min(disc, 0.0f));
          float r0 = (1.0f - ref_idx) / (1.0f + ref_idx);
          r0 = r0 * r0;
          const float schlick = r0 + (1.0f - r0) * powf(1.0f - cosine, 5.0f);
          const bool is_refl = us[3] < (disc > 0.0f ? schlick : 1.0f);
          d_new = is_refl ? reflected : refracted;
          mult = mk(1.0f, 1.0f, 1.0f);
          if (Mi[2] != 0 && !is_refl) {  // Beer–Lambert exit re-trace (dielectric.go:118-153)
            if constexpr (Hit::kWarp) {
              exit_mat = mat;  // the next trip's; thru * 1 here keeps thru's bits
            } else {
              const V3 start = p + d_new * 1e-3f;
              float te;
              const int ex = trace(slot, start, d_new, tme, 0.0f, 1000.0f, te);
              float path_len = 10.0f;
              if (ex >= 0) path_len = clamp(length((start + d_new * te) - p), 0.1f, 100.0f);
              mult = mk(expf(-M[8] * path_len), expf(-M[9] * path_len),
                        expf(-M[10] * path_len));
            }
          }
        } else {  // diffuse: mixture of light and cosine pdfs (colour.go:48-57)
          V3 d_diff;
          if (us[4] < 0.5f) {
            d_diff = lights_sample(sc, p, us[5], us[6], us[7], us[8]);
          } else {
            V3 ou, ov, ow;
            onb_from_w(n, ou, ov, ow);
            const float zc = sqrtf(1.0f - us[10]);
            const float phic = kTwoPi * us[9];
            const float rc = cos_scale * sqrtf(us[10]);
            d_diff = ou * (cosf(phic) * rc) + ov * (sinf(phic) * rc) + ow * zc;
          }
          const V3 dd_unit = normalize(d_diff);
          const float cos_lobe = dot(dd_unit, normalize(n));
          const float pdf_cos = cos_lobe > 0.0f ? cos_lobe / kPi : 0.0f;
          const float pdf_val = 0.5f * lights_pdf(sc, p, d_diff) + 0.5f * pdf_cos;
          const float spdf = kind == kLambert ? clamp_min(dot(n, dd_unit), 0.0f) / kPi : 0.0f;
          d_new = d_diff;
          mult = albedo * (spdf / pdf_val);
        }
        thru = thru * mult;
        o = p;
        d = d_new;
        ++depth;
        if (draws_out != nullptr) {  // the slot's own counts: no other thread writes them
          draws_out[2 * slot + 0] += 1;
          draws_out[2 * slot + 1] += pairs_drawn(pair_list, us[4]);
        }
        if (capped && exit_mat < 0) rad = rad + thru * mk(0.0f, 0.0f, 1.0f);
      }
    }
    if (!ends || exit_mat >= 0) continue;

    if constexpr (kProbe) c_regen = clock64();
    // DeNAN per component (vec3.DeNAN, render/rgb.go:36).
    acc = acc + mk(finite_or_zero(rad.x), finite_or_zero(rad.y), finite_or_zero(rad.z));
    if (next_slot != slot) {
      acc_out[3 * slot + 0] = acc.x;
      acc_out[3 * slot + 1] = acc.y;
      acc_out[3 * slot + 2] = acc.z;
      cnt_out[slot] = cnt;
      if (next_slot >= n_slots) {
        if constexpr (kProbe) pc[kPrCyRegen] += (unsigned long long)(clock64() - c_regen);
        done = true;
        if constexpr (Hit::kWarp) continue;
        flush();
        return;
      }
      slot = next_slot;
      acc = mk(0.0f, 0.0f, 0.0f);
      cnt = 0;
    }
    samp = next_samp;
    k0 = dr.key0;
    k1 = dr.key1;
    pixel_ray(camera, dr.cu, slot % n_pix, nx, ny, o, d, tme);
    thru = mk(1.0f, 1.0f, 1.0f);
    rad = mk(0.0f, 0.0f, 0.0f);
    depth = 0;
    if constexpr (kProbe) pc[kPrCyRegen] += (unsigned long long)(clock64() - c_regen);
  }
  flush();
}

__global__ void __launch_bounds__(kMegaThreads, kMegaMinBlocks)
    megakernel_rgb(Scene sc, Camera camera, uint32_t seed0, uint32_t seed1, uint32_t offset,
                   int nx, int ny, int spp_slot, int n_slots, int max_depth, float bg_r,
                   float bg_g, float bg_b, int book, int* __restrict__ queue,
                   float* __restrict__ acc_out, int* __restrict__ cnt_out,
                   int* __restrict__ draws_out) {
  render_loop(BruteHit{}, sc, camera, seed0, seed1, offset, nx, ny, spp_slot, n_slots,
              max_depth, bg_r, bg_g, bg_b, book, queue, acc_out, cnt_out, draws_out);
}

// The BVH form, and its probe instance, whose counts go to probe_out (the
// main kernel takes none), at kBvhMinBlocks blocks an SM.
__global__ void __launch_bounds__(kMegaThreads, kBvhMinBlocks)
    megakernel_rgb_bvh(Scene sc, BvhTables tab, Camera camera, uint32_t seed0,
                       uint32_t seed1, uint32_t offset, int nx, int ny, int spp_slot,
                       int n_slots, int max_depth, float bg_r, float bg_g, float bg_b,
                       int book, int* __restrict__ queue, float* __restrict__ acc_out,
                       int* __restrict__ cnt_out, int* __restrict__ draws_out,
                       unsigned long long* __restrict__ probe_out) {
  render_loop<false>(BvhHit<NoCount>{tab}, sc, camera, seed0, seed1, offset, nx, ny,
                     spp_slot, n_slots, max_depth, bg_r, bg_g, bg_b, book, queue, acc_out,
                     cnt_out, draws_out, probe_out);
}

__global__ void __launch_bounds__(kMegaThreads, kBvhMinBlocks)
    megakernel_rgb_bvh_probe(Scene sc, BvhTables tab, Camera camera, uint32_t seed0,
                             uint32_t seed1, uint32_t offset, int nx, int ny, int spp_slot,
                             int n_slots, int max_depth, float bg_r, float bg_g, float bg_b,
                             int book, int* __restrict__ queue, float* __restrict__ acc_out,
                             int* __restrict__ cnt_out, int* __restrict__ draws_out,
                             unsigned long long* __restrict__ probe_out) {
  render_loop<true>(BvhHit<WarpTally>{tab}, sc, camera, seed0, seed1, offset, nx, ny,
                    spp_slot, n_slots, max_depth, bg_r, bg_g, bg_b, book, queue, acc_out,
                    cnt_out, draws_out, probe_out);
}

}  // namespace izpi

extern "C" {

// The persistent grid of izpi_megakernel_rgb on the current device:
// *blocks blocks of *threads threads. Returns a cudaError_t.
int izpi_megakernel_rgb_grid(int* blocks, int* threads) {
  *threads = izpi::kMegaThreads;
  return izpi::persistent_blocks(izpi::megakernel_rgb, blocks);
}

// Launches the megakernel on `stream` over `blocks` blocks: the caller's
// persistent grid (izpi_megakernel_rgb_grid), no more blocks than the slots
// need; returns a cudaError_t. cam: the camera row's
// floats in host memory; acc: (n_slots, 3) f32, cnt: (n_slots,) i32, queue:
// one i32 set to 0, all allocated by the caller; draws: null, or (n_slots,
// 2) i32 that receives each slot's scatters and bounce pairs drawn.
int izpi_megakernel_rgb(const float* prim_f, const int* prim_i, int n_prims,
                        const float* mat_f, const int* mat_i, const float* light_f,
                        const int* light_i, int n_lights, const float* cam, uint32_t seed0,
                        uint32_t seed1, uint32_t offset, int nx, int ny, int spp_slot,
                        int n_slots, int max_depth, float bg_r, float bg_g, float bg_b,
                        int book, int blocks, int* queue, float* acc, int* cnt,
                        int* draws, void* stream) {
  izpi::Scene sc{prim_f, prim_i, n_prims, mat_f, mat_i, light_f, light_i, n_lights};
  izpi::megakernel_rgb<<<blocks, izpi::kMegaThreads, 0, (cudaStream_t)stream>>>(
      sc, izpi::load_camera(cam), seed0, seed1, offset, nx, ny, spp_slot, n_slots, max_depth,
      bg_r, bg_g, bg_b, book, queue, acc, cnt, draws);
  return (int)cudaGetLastError();
}

// The persistent grid of izpi_megakernel_rgb_bvh on the current device.
int izpi_megakernel_rgb_bvh_grid(int* blocks, int* threads) {
  *threads = izpi::kMegaThreads;
  return izpi::persistent_blocks(izpi::megakernel_rgb_bvh, blocks);
}

typedef decltype(&izpi::megakernel_rgb_bvh) BvhKernel;

static int launch_bvh(BvhKernel kernel, const float* prim_f, const int* prim_i, int n_prims,
                      const float* mat_f, const int* mat_i, const float* light_f,
                      const int* light_i, int n_lights, const int* nodes,
                      const float* bvh_prims, const float* cam, uint32_t seed0, uint32_t seed1,
                      uint32_t offset, int nx, int ny, int spp_slot, int n_slots,
                      int max_depth, float bg_r, float bg_g, float bg_b, int book, int blocks,
                      int* queue, float* acc, int* cnt, int* draws, int* trav,
                      unsigned long long* probe, void* stream) {
  izpi::Scene sc{prim_f, prim_i, n_prims, mat_f, mat_i, light_f, light_i, n_lights};
  izpi::BvhTables tab{nodes, bvh_prims, trav};
  kernel<<<blocks, izpi::kMegaThreads, 0, (cudaStream_t)stream>>>(
      sc, tab, izpi::load_camera(cam), seed0, seed1, offset, nx, ny, spp_slot, n_slots,
      max_depth, bg_r, bg_g, bg_b, book, queue, acc, cnt, draws, probe);
  return (int)cudaGetLastError();
}

// izpi_megakernel_rgb with the closest hit through a BVH4: nodes (Nn, 32)
// i32 and bvh_prims (n_prims, 16) f32 (ops/bvh_kernel.py pack_tables) over
// the primitives of prim_f and prim_i in the same (tree) order; trav: null,
// or (n_slots, 2) i32, zeroed, that receives each slot's nodes popped and
// primitives tested.
int izpi_megakernel_rgb_bvh(const float* prim_f, const int* prim_i, int n_prims,
                            const float* mat_f, const int* mat_i, const float* light_f,
                            const int* light_i, int n_lights, const int* nodes,
                            const float* bvh_prims, const float* cam, uint32_t seed0,
                            uint32_t seed1, uint32_t offset, int nx, int ny, int spp_slot,
                            int n_slots, int max_depth, float bg_r, float bg_g, float bg_b,
                            int book, int blocks, int* queue, float* acc, int* cnt, int* draws,
                            int* trav, void* stream) {
  return launch_bvh(izpi::megakernel_rgb_bvh, prim_f, prim_i, n_prims, mat_f, mat_i, light_f,
                    light_i, n_lights, nodes, bvh_prims, cam, seed0, seed1, offset, nx, ny,
                    spp_slot, n_slots, max_depth, bg_r, bg_g, bg_b, book, blocks, queue, acc,
                    cnt, draws, trav, nullptr, stream);
}

// Its probe instance, launched like it over `blocks` blocks (the main
// kernel's grid), with probe: (kProbeCounters,) u64, zeroed, that receives
// the launch's counts (ProbeCounter).
int izpi_megakernel_rgb_bvh_probe(const float* prim_f, const int* prim_i, int n_prims,
                                  const float* mat_f, const int* mat_i, const float* light_f,
                                  const int* light_i, int n_lights, const int* nodes,
                                  const float* bvh_prims, const float* cam, uint32_t seed0,
                                  uint32_t seed1, uint32_t offset, int nx, int ny, int spp_slot,
                                  int n_slots, int max_depth, float bg_r, float bg_g,
                                  float bg_b, int book, int blocks, int* queue, float* acc,
                                  int* cnt, int* draws, int* trav, unsigned long long* probe,
                                  void* stream) {
  return launch_bvh(izpi::megakernel_rgb_bvh_probe, prim_f, prim_i, n_prims, mat_f, mat_i,
                    light_f, light_i, n_lights, nodes, bvh_prims, cam, seed0, seed1, offset, nx,
                    ny, spp_slot, n_slots, max_depth, bg_r, bg_g, bg_b, book, blocks, queue,
                    acc, cnt, draws, trav, probe, stream);
}

}  // extern "C"
