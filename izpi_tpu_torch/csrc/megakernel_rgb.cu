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
// Bound: per-thread FP32 and INT32 issue — the primitive loop (every ray
// tests every primitive, ~57 FP32 operations each) and the Threefry rounds
// (79 INT32 operations a call, on the half-rate INT32 pipe). The scene
// tables are a few KB, read at warp-uniform addresses, and stay in L1.
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

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace izpi {

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kMegaThreads, kMegaMinBlocks)
    megakernel_rgb(Scene sc, Camera camera, uint32_t seed0, uint32_t seed1, uint32_t offset,
                   int nx, int ny, int spp_slot, int n_slots, int max_depth, float bg_r,
                   float bg_g, float bg_b, int book, int* __restrict__ queue,
                   float* __restrict__ acc_out, int* __restrict__ cnt_out,
                   int* __restrict__ draws_out) {
  const int n_pix = nx * ny;
  const V3 bg = mk(bg_r, bg_g, bg_b);
  const float cos_scale = book ? 2.0f : 1.0f;

  int slot = take_slot(queue, n_slots, spp_slot, acc_out, cnt_out);
  if (slot >= n_slots) return;
  int samp = 0;
  Draws<false> dr;
  dr.clear();
  dr.new_sample(seed0, seed1, sample_id(slot, 0, n_pix, spp_slot, offset),
                (uint32_t)(slot % n_pix));
  dr.run(seed0, seed1, 0u, 0u, 0u);

  uint32_t k0 = dr.key0, k1 = dr.key1;  // the path's key
  V3 o, d;
  float tme;
  pixel_ray(camera, dr.cu, slot % n_pix, nx, ny, o, d, tme);
  V3 thru = mk(1.0f, 1.0f, 1.0f);
  V3 rad = mk(0.0f, 0.0f, 0.0f);
  int depth = 0;
  V3 acc = mk(0.0f, 0.0f, 0.0f);  // the slot's sums
  int cnt = 0;

  for (;;) {  // one bounce of one path per trip
    ++cnt;
    float t;
    const int hit = closest_hit(sc, o, d, tme, kTMin, kTMax, t);
    V3 p = o, n = d, albedo = bg;
    const float* M = sc.mat_f;
    const int* Mi = sc.mat_i;
    int kind = -1;
    if (hit < 0) {
      rad = rad + thru * bg;
    } else {
      p = o + d * t;
      n = record_normal(sc, hit, o, d, tme, p);
      const int mat = sc.prim_i[hit * kPrimI + 1];
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
    const bool ends = !scatters || capped;

    // The next sample, from the next slot once this one is done.
    int next_slot = slot, next_samp = samp;
    if (ends && ++next_samp == spp_slot) {
      next_slot = take_slot(queue, n_slots, spp_slot, acc_out, cnt_out);
      next_samp = 0;
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
          const V3 start = p + d_new * 1e-3f;
          float te;
          const int ex = closest_hit(sc, start, d_new, tme, 0.0f, 1000.0f, te);
          float path_len = 10.0f;
          if (ex >= 0) path_len = clamp(length((start + d_new * te) - p), 0.1f, 100.0f);
          mult = mk(expf(-M[8] * path_len), expf(-M[9] * path_len), expf(-M[10] * path_len));
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
      if (capped) rad = rad + thru * mk(0.0f, 0.0f, 1.0f);
    }
    if (!ends) continue;

    // DeNAN per component (vec3.DeNAN, render/rgb.go:36).
    acc = acc + mk(finite_or_zero(rad.x), finite_or_zero(rad.y), finite_or_zero(rad.z));
    if (next_slot != slot) {
      acc_out[3 * slot + 0] = acc.x;
      acc_out[3 * slot + 1] = acc.y;
      acc_out[3 * slot + 2] = acc.z;
      cnt_out[slot] = cnt;
      if (next_slot >= n_slots) return;
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
  }
}

template <int N>
__global__ void threefry_uniforms(const uint32_t* __restrict__ keys,
                                  const uint32_t* __restrict__ depths, int n, uint32_t salt,
                                  float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float u[N];
  bounce_uniforms<N>(keys[2 * i], keys[2 * i + 1], depths[i], salt, u);
#pragma unroll
  for (int k = 0; k < N; ++k) out[(size_t)i * N + k] = u[k];
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

// out[i, :] = the n_uniforms (1, 5 or 12) uniforms for use `salt` at bounce
// depths[i] of the path keyed keys[i] (uint32 words); returns cudaGetLastError().
int izpi_threefry_uniforms(const uint32_t* keys, const uint32_t* depths, int n,
                           int n_uniforms, uint32_t salt, float* out, void* stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_uniforms == 1) {
    izpi::threefry_uniforms<1><<<blocks, threads, 0, s>>>(keys, depths, n, salt, out);
  } else if (n_uniforms == 5) {
    izpi::threefry_uniforms<5><<<blocks, threads, 0, s>>>(keys, depths, n, salt, out);
  } else if (n_uniforms == 12) {
    izpi::threefry_uniforms<12><<<blocks, threads, 0, s>>>(keys, depths, n, salt, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
