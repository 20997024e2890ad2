// The RGB render loop in one CUDA kernel: one thread per path slot.
//
// Replaces izpi_tpu/ops/megakernel.py:628 (build_renderer.<kernel>, the
// Pallas megakernel). Each slot serves pixel slot % n_pix and walks its
// samples replica*spp_slot + [0, spp_slot) + offset one after another (the
// mapping of megakernel.py:647): a thin-lens camera ray from the Threefry
// streams, then bounces until the path misses, hits a light or reaches the
// depth cap. A bounce finds the closest hit over all primitives, resolves
// the winner's record normal once, and shades Lambertian (NEE mixture pdf),
// metal (fuzz), dielectric (Schlick, Beer–Lambert exit re-trace) and one-sided
// diffuse lights. The DeNAN'd radiance of every finished path is added to
// the slot's own sum, so the kernel writes no pixel twice and needs no
// atomics.
//
// The arithmetic follows izpi_tpu_torch/integrator/path.py (the plain twin,
// itself the JAX oracle's twin) operation for operation, so the build must
// keep IEEE rounding: -fmad=false, no --use_fast_math, precise
// sqrtf/expf/logf/sinf/cosf/powf.
//
// Bound: per-thread FP32 and INT32 issue, through the Threefry rounds (8
// cipher calls per bounce) and the primitive loop. At the slice's sizes the
// scene tables are a few KB and stay in L1, so memory is not the limit.
// Scene tables come in by pointer, packed on the host by
// izpi_tpu_torch/ops/megakernel.py (pack_tables). The primitive tests, the
// light list, the camera ray and the table layouts are in common.cuh,
// shared with megakernel_spectral.cu.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace izpi {

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(128)
    megakernel_rgb(Scene sc, const float* __restrict__ cam, uint32_t seed0, uint32_t seed1,
                   uint32_t offset, int nx, int ny, int spp_slot, int n_slots, int max_depth,
                   float bg_r, float bg_g, float bg_b, int book, float* __restrict__ acc_out,
                   int* __restrict__ cnt_out) {
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= n_slots) return;
  const int n_pix = nx * ny;
  const int pix = slot % n_pix;
  const int replica = slot / n_pix;
  const float px = (float)(pix % nx);
  const float py = (float)(pix / nx);
  const V3 bg = mk(bg_r, bg_g, bg_b);
  const Camera camera = load_camera(cam);
  const float cos_scale = book ? 2.0f : 1.0f;

  V3 acc = mk(0.0f, 0.0f, 0.0f);
  int cnt = 0;
  for (int samp = 0; samp < spp_slot; ++samp) {
    uint32_t k0, k1;
    path_key(seed0, seed1, (uint32_t)(replica * spp_slot + samp) + offset, (uint32_t)pix, k0,
             k1);
    V3 o, d;
    float tme;
    camera_ray(camera, k0, k1, px, py, nx, ny, o, d, tme);

    V3 thru = mk(1.0f, 1.0f, 1.0f);
    V3 rad = mk(0.0f, 0.0f, 0.0f);
    for (int depth = 0;; ++depth) {
      ++cnt;
      float t;
      const int hit = closest_hit(sc, o, d, tme, kTMin, kTMax, t);
      if (hit < 0) {
        rad = rad + thru * bg;
        break;
      }
      const V3 p = o + d * t;
      const V3 n = record_normal(sc, hit, o, d, tme, p);
      const int mat = sc.prim_i[hit * kPrimI + 1];
      const float* M = sc.mat_f + mat * kMatF;
      const int* Mi = sc.mat_i + mat * kMatI;
      const int kind = Mi[0];

      V3 albedo = ld3(M);
      if (Mi[1] != 0) {  // 3D sine checker (texture/checker.go:26)
        const float sines = sinf(10.0f * p.x) * sinf(10.0f * p.y) * sinf(10.0f * p.z);
        if (!(sines < 0.0f)) albedo = ld3(M + 3);
      }
      // One-sided light keyed on the record normal (diffuselight.go:49-63).
      // thru * 0 is added for every other hit, as the twin does, so a
      // non-finite throughput poisons the sample the same way.
      const bool emits = kind == kDiffuseLight && dot(n, d) < 0.0f;
      rad = rad + thru * (emits ? albedo : mk(0.0f, 0.0f, 0.0f));
      if (kind == kDiffuseLight) break;

      float us[12];
      bounce_uniforms<12>(k0, k1, (uint32_t)depth, 0u, us);

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
        V3 ou, ov, ow;
        onb_from_w(n, ou, ov, ow);
        const float zc = sqrtf(1.0f - us[10]);
        const float phic = kTwoPi * us[9];
        const float rc = cos_scale * sqrtf(us[10]);
        const V3 d_cos = ou * (cosf(phic) * rc) + ov * (sinf(phic) * rc) + ow * zc;
        const V3 d_diff = us[4] < 0.5f ? lights_sample(sc, p, us[5], us[6], us[7], us[8]) : d_cos;
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
      if (depth + 1 >= max_depth) {  // depth cap: the {Z:1} sentinel (colour.go:34-36)
        rad = rad + thru * mk(0.0f, 0.0f, 1.0f);
        break;
      }
    }
    // DeNAN per component (vec3.DeNAN, render/rgb.go:36).
    acc = acc + mk(finite_or_zero(rad.x), finite_or_zero(rad.y), finite_or_zero(rad.z));
  }
  acc_out[3 * slot + 0] = acc.x;
  acc_out[3 * slot + 1] = acc.y;
  acc_out[3 * slot + 2] = acc.z;
  cnt_out[slot] = cnt;
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

// Launches the megakernel on `stream`; returns cudaGetLastError().
// acc: (n_slots, 3) f32, cnt: (n_slots,) i32, both allocated by the caller.
int izpi_megakernel_rgb(const float* prim_f, const int* prim_i, int n_prims,
                        const float* mat_f, const int* mat_i, const float* light_f,
                        const int* light_i, int n_lights, const float* cam, uint32_t seed0,
                        uint32_t seed1, uint32_t offset, int nx, int ny, int spp_slot,
                        int n_slots, int max_depth, float bg_r, float bg_g, float bg_b,
                        int book, float* acc, int* cnt, void* stream) {
  izpi::Scene sc{prim_f, prim_i, n_prims, mat_f, mat_i, light_f, light_i, n_lights};
  const int threads = 128;
  const int blocks = (n_slots + threads - 1) / threads;
  izpi::megakernel_rgb<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      sc, cam, seed0, seed1, offset, nx, ny, spp_slot, n_slots, max_depth, bg_r, bg_g, bg_b,
      book, acc, cnt);
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
