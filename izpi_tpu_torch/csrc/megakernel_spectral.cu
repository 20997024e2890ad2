// The spectral render loop in one CUDA kernel: one thread per path slot.
//
// Replaces izpi_tpu/ops/megakernel_spectral.py:267 (build_renderer.<kernel>,
// the Pallas spectral megakernel). Each slot serves pixel slot % n_pix and
// walks its samples replica*spp_slot + [0, spp_slot) + offset one after
// another (megakernel_spectral.py:285). A sample is a thin-lens camera ray,
// then a wavelength λ drawn by CIE-Y sampling from its own Threefry stream
// (LAMBDA_SALT), then bounces with scalar radiance and throughput at λ until
// the path misses, hits a light or a metal (a metal's spectral scatter is the
// reference's non-spectral stub, so the path ends), or reaches the depth
// cap, where it gathers the background SPD. Lambertian albedos and emission
// are read at λ from the scene's 1 nm SPD table or a Gaussian, dielectrics
// refract with η(λ) (dispersion) and absorb by spectral Beer–Lambert over an
// exit re-trace. A finished sample deposits de_nan(xyz(λ)·rad/pdf(λ)) into
// the slot's own sum: no atomics, no pixel written twice.
//
// The arithmetic follows izpi_tpu_torch's plain version (integrator/path.py
// bounce_spectral, integrator/wavefront.py, spectral/cie.py,
// spectral/spd.py, materials/spectral_eval.py) operation for operation,
// not the Pallas kernel's knot arithmetic, so the build keeps IEEE rounding
// (-fmad=false, no fast math). SPD values at λ are looked up at each hit:
// the grid lerp is a pure function of (table, λ), so this gives the bits the
// plain version gives.
//
// Bound: per-thread FP32 and INT32 issue, through the Threefry rounds
// (eight cipher calls per bounce, ten per camera sample) and the primitive
// loop, as for megakernel_rgb.cu. At this size the tables do not bound it: the
// pyramid's SPD table is 5 rows x 371 x 4 B (7.4 KB) in global memory and
// stays cache-resident; the 75-entry CIE tables, indexed divergently by each
// thread's λ, sit in shared memory, loaded once per block, and not in the
// constant bank, which serialises divergent reads.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace izpi {

// Row widths of the spectral tables (ops/megakernel_spectral.py).
constexpr int kSpecF = 4;    // Gaussian peak, center, width | pad
constexpr int kSpecI = 4;    // albedo SPD row, eta SPD row, absorption SPD row | pad
constexpr int kSpdN = 371;   // 1 nm grid over 380..750 nm
constexpr int kNCie = 75;    // 5 nm CIE grid over 380..750 nm
constexpr int kCieRows = 4;  // x̄, ȳ, z̄, inclusive cumsum of ȳ

constexpr uint32_t kLambdaSalt = 0x7A3Bu;
constexpr float kCieYIntegral = 21.3768f;
constexpr float kLamMin = 380.0f;
constexpr float kLamMax = 750.0f;
constexpr float kCieStep = 5.0f;

struct Spectra {
  const float* spec_f;
  const int* spec_i;
  const float* spd;
};

// Row `id` of the (S, 371) SPD table at λ, clamped at the grid's ends
// (spectral/spd.py device_spd_value; the grid step is 1 nm).
__device__ __forceinline__ float spd_value(const float* spd, int id, float lam) {
  const float x = clamp(lam - kLamMin, 0.0f, (float)(kSpdN - 1));
  const int i0 = min(max((int)floorf(x), 0), kSpdN - 2);
  const float t = x - (float)i0;
  const float* row = spd + id * kSpdN;
  return row[i0] * (1.0f - t) + row[i0 + 1] * t;
}

// A 75-entry 5 nm CIE table at λ, clamped (spectral/cie.py
// _interp_fixed_grid).
__device__ __forceinline__ float cie_value(const float* tab, float lam) {
  const float x = clamp((lam - kLamMin) / kCieStep, 0.0f, (float)(kNCie - 1));
  const int i0 = min(max((int)floorf(x), 0), kNCie - 2);
  const float t = x - (float)i0;
  return tab[i0] * (1.0f - t) + tab[i0 + 1] * t;
}

// CIE-Y sampling of λ by CDF inversion (spectral/cie.py sample_wavelength):
// the bin is the first i with cum[i] >= u·I (torch.searchsorted, side
// "left", on the strictly increasing f32 cumsum), λ and ȳ are linear in the
// mass inside it; i == 0 and a target past the end are the reference's edge
// cases.
__device__ __forceinline__ void sample_wavelength(const float* y, const float* cum, float u,
                                                  float& lam, float& pdf) {
  const float target = u * kCieYIntegral;
  int lo = 0, hi = kNCie;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cum[mid] < target) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int i = min(max(lo, 0), kNCie - 1);
  const int im1 = max(i - 1, 0);
  const float prev = i > 0 ? cum[im1] : 0.0f;
  const float t = (target - prev) / fmaxf(y[i], 1e-20f);
  const float w_i = (float)(380 + 5 * i), w_m = (float)(380 + 5 * im1);
  const float lam_interp = w_m + t * (w_i - w_m);
  const float y_interp = y[im1] + t * (y[i] - y[im1]);
  lam = i > 0 ? lam_interp : w_i;
  pdf = (i > 0 ? y_interp : y[i]) / kCieYIntegral;
  if (lo >= kNCie) {
    lam = kLamMax;
    pdf = y[kNCie - 1] / kCieYIntegral;
  }
}

// A material's spectral albedo or emission at λ (materials/spectral_eval.py
// spectral_value): its SPD row, else its Gaussian, else the luminance of its
// RGB texture (megakernel_spectral.eligible admits constant textures only).
__device__ __forceinline__ float spectral_value(const Spectra& sp, const float* M, int mat,
                                                float lam) {
  const float* SF = sp.spec_f + mat * kSpecF;
  const int id = sp.spec_i[mat * kSpecI];
  if (id >= 0) return spd_value(sp.spd, id, lam);
  if (SF[2] > 0.0f) {
    const float ratio = (lam - SF[1]) / SF[2];
    return SF[0] * expf(-(ratio * ratio));
  }
  return 0.299f * M[0] + 0.587f * M[1] + 0.114f * M[2];
}

__global__ void __launch_bounds__(128)
    megakernel_spectral(Scene sc, Spectra sp, const float* __restrict__ cie,
                        const float* __restrict__ cam, uint32_t seed0, uint32_t seed1,
                        uint32_t offset, int nx, int ny, int spp_slot, int n_slots,
                        int max_depth, int bg_spd, int book, float* __restrict__ acc_out,
                        int* __restrict__ cnt_out) {
  __shared__ float s_cie[kCieRows * kNCie];
  for (int k = threadIdx.x; k < kCieRows * kNCie; k += blockDim.x) s_cie[k] = cie[k];
  __syncthreads();
  const float* cie_x = s_cie;
  const float* cie_y = s_cie + kNCie;
  const float* cie_z = s_cie + 2 * kNCie;
  const float* cie_cum = s_cie + 3 * kNCie;

  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= n_slots) return;
  const int n_pix = nx * ny;
  const int pix = slot % n_pix;
  const int replica = slot / n_pix;
  const float px = (float)(pix % nx);
  const float py = (float)(pix / nx);
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
    // λ: one uniform at depth 0 under LAMBDA_SALT (integrator/wavefront.py).
    float ul[1];
    bounce_uniforms<1>(k0, k1, 0u, kLambdaSalt, ul);
    float lam, lam_pdf;
    sample_wavelength(cie_y, cie_cum, ul[0], lam, lam_pdf);
    const float bg_val = spd_value(sp.spd, bg_spd, lam);

    float thru = 1.0f;
    float rad = 0.0f;
    for (int depth = 0;; ++depth) {
      ++cnt;
      float t;
      const int hit = closest_hit(sc, o, d, tme, kTMin, kTMax, t);
      if (hit < 0) {
        rad = rad + thru * bg_val;
        break;
      }
      const V3 p = o + d * t;
      const V3 n = record_normal(sc, hit, o, d, tme, p);
      const int mat = sc.prim_i[hit * kPrimI + 1];
      const float* M = sc.mat_f + mat * kMatF;
      const int* SI = sp.spec_i + mat * kSpecI;
      const int kind = sc.mat_i[mat * kMatI];

      const float spec_val = spectral_value(sp, M, mat, lam);
      // One-sided light keyed on the record normal; thru * 0 is added for
      // every other hit, as the plain version does, so a non-finite
      // throughput poisons the sample the same way.
      const bool emits = kind == kDiffuseLight && dot(n, d) < 0.0f;
      rad = rad + thru * (emits ? spec_val : 0.0f);
      if (kind == kDiffuseLight || kind == kMetal) break;

      float us[12];
      bounce_uniforms<12>(k0, k1, (uint32_t)depth, 0u, us);

      V3 d_new;
      float mult;
      if (kind == kDielectric) {  // dielectric.go:66-102 with η(λ), raw direction
        const float eta = SI[1] >= 0 ? spd_value(sp.spd, SI[1], lam) : M[7];
        const V3 reflected = reflect(d, n);
        const float d_dot_n = dot(d, n);
        const bool exiting = d_dot_n > 0.0f;
        const V3 outward = exiting ? -n : n;
        const float ni = exiting ? eta : 1.0f / eta;
        const float dlen = length(d);
        const float cosine = exiting ? eta * d_dot_n / dlen : -d_dot_n / dlen;
        const V3 uv = normalize(d);
        const float dt = dot(uv, outward);
        const float disc = 1.0f - ni * ni * (1.0f - dt * dt);
        const V3 refracted = (uv - outward * dt) * ni - outward * sqrtf(clamp_min(disc, 0.0f));
        float r0 = (1.0f - eta) / (1.0f + eta);
        r0 = r0 * r0;
        const float schlick = r0 + (1.0f - r0) * powf(1.0f - cosine, 5.0f);
        const bool is_refl = us[3] < (disc > 0.0f ? schlick : 1.0f);
        d_new = is_refl ? reflected : refracted;
        mult = 1.0f;
        if (SI[2] >= 0 && !is_refl) {  // spectral Beer–Lambert exit re-trace
          const V3 start = p + d_new * 1e-3f;
          float te;
          const int ex = closest_hit(sc, start, d_new, tme, 0.0f, 1000.0f, te);
          float path_len = 10.0f;
          if (ex >= 0) path_len = clamp(length((start + d_new * te) - p), 0.1f, 100.0f);
          mult = expf(-spd_value(sp.spd, SI[2], lam) * path_len);
        }
      } else {  // diffuse: mixture of light and cosine pdfs (spectral.go:61-76)
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
        // A zero pdf zeroes the weight (the reference's spectral path NaNs).
        mult = spec_val * (pdf_val > 0.0f ? spdf / pdf_val : 0.0f);
      }
      thru = thru * mult;
      o = p;
      d = d_new;
      if (depth + 1 >= max_depth) {  // depth cap: the background SPD at λ
        rad = rad + thru * bg_val;
        break;
      }
    }
    // XYZ deposit, DeNAN'd per component (integrator/wavefront.py).
    const float w = lam_pdf > 0.0f ? rad / lam_pdf : 0.0f;
    acc = acc + mk(finite_or_zero(cie_value(cie_x, lam) * w),
                   finite_or_zero(cie_value(cie_y, lam) * w),
                   finite_or_zero(cie_value(cie_z, lam) * w));
  }
  acc_out[3 * slot + 0] = acc.x;
  acc_out[3 * slot + 1] = acc.y;
  acc_out[3 * slot + 2] = acc.z;
  cnt_out[slot] = cnt;
}

}  // namespace izpi

extern "C" {

// Launches the spectral megakernel on `stream`; returns cudaGetLastError().
// acc: (n_slots, 3) f32 XYZ sums, cnt: (n_slots,) i32, both allocated by the
// caller.
int izpi_megakernel_spectral(const float* prim_f, const int* prim_i, int n_prims,
                             const float* mat_f, const int* mat_i, const float* light_f,
                             const int* light_i, int n_lights, const float* spec_f,
                             const int* spec_i, const float* spd, const float* cie,
                             const float* cam, uint32_t seed0, uint32_t seed1, uint32_t offset,
                             int nx, int ny, int spp_slot, int n_slots, int max_depth,
                             int bg_spd, int book, float* acc, int* cnt, void* stream) {
  izpi::Scene sc{prim_f, prim_i, n_prims, mat_f, mat_i, light_f, light_i, n_lights};
  izpi::Spectra sp{spec_f, spec_i, spd};
  const int threads = 128;
  const int blocks = (n_slots + threads - 1) / threads;
  izpi::megakernel_spectral<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      sc, sp, cie, cam, seed0, seed1, offset, nx, ny, spp_slot, n_slots, max_depth, bg_spd,
      book, acc, cnt);
  return (int)cudaGetLastError();
}

}  // extern "C"
