// The training step's bounce loop in two kernels: a forward path kernel
// that records each bounce, and a reverse kernel that walks the record
// back.
//
// Replaces izpi_tpu/parallel/dist.py:597 / izpi_tpu/integrator/path.py:
// 699-740 (no pallas_call): the jitted step's `lax.scan` of
// `jax.checkpoint`ed bounces, which XLA fuses into a few device programs
// forward and a few backward. In the port that scan was a CUDA graph of
// ~162,000 small PyTorch kernels a Cornell step (the bounce, its
// checkpoint recompute and its backward, 50 times over). Here it is two
// launches and one call of the gathers' backward (ops/table_grad.py, G).
//
// What it computes. In a scene with no metal and no absorbing dielectric
// (ops/diff_trace.py eligible_diff), no trainable parameter reaches a
// ray's origin or direction: the step differentiates in the texture rows
// the bounces gather (tex_c0, tex_c1), and every sample is detached. The
// estimate of a path is then
//   rad = Σ_k thru_k ⊙ c_k + thru_D ⊙ (0, 0, 1) [if it reaches the cap],
//   thru_{k+1} = thru_k ⊙ mult_k,
// with c_k the background on a miss and the albedo on a light it faces,
// and mult_k = albedo_k · ratio_k on a diffuse bounce, 1 through glass. So
// the gradient needs no geometry adjoint: walking each path backwards
// over one record a bounce gives every gathered row's cotangent,
//   ā_thru_k = ā_rad ⊙ c_k + ā_thru_{k+1} ⊙ mult_k,
//   ā_albedo_k = ā_rad ⊙ thru_k (a light faced),
//              = (ā_thru_{k+1} ⊙ thru_k) · ratio_k (a diffuse bounce),
// in the order of operations PyTorch's autograd takes through
// integrator/path.py bounce_rgb. The record replaces the checkpoint:
// memory grows by one small record a bounce, where JAX keeps the scan's
// carry and recomputes the rest.
//
// izpi_diff_trace_fwd: one thread a path (the step's camera rays, made by
// the cipher entry's new-sample form). The path's bounces run in the
// thread from the camera to the end (a miss, a light, or max_depth
// bounces), with the lazy draws of draws.cuh: a bounce ciphers only the
// pairs its material and branch read. The forward is the differentiable
// bounce's (path.py bounce_rgb, differentiable=True): a non-finite ratio
// weighs 0, a degenerate NEE direction is zeroed before its cosine, and
// the depth cap adds the {Z:1} sentinel. Each live bounce writes one record
// of 20 bytes, planes of (bounce, path): thru_k and ratio_k as a float4,
// and (row << 3) | code as an int, the row being the flat row of the
// stacked [c0; c1] table it gathered (c1's rows after c0's). A path's
// records end at its ray count, written with its radiance.
//
// The closest hit is a template argument, as in megakernel_rgb.cu's
// render_loop: every primitive (common.cuh closest_hit) or the BVH4
// traversal (bvh4.cuh). The one-bounce shading is copied from render_loop,
// not shared through a header: the differentiable bounce's guards and the
// record differ from it, and factoring it would put the RGB megakernel's
// register allocation (96, no spill) and its images at stake.
//
// izpi_diff_trace_bwd: first diff_trace_block_counts, the records of each
// block of kThreads paths; then diff_trace_bwd, one thread a path. Its
// block adds up the records of the blocks before it and scans its own
// paths' counts, which gives each path its first slot off_i, and the last
// block writes the number of records. The thread walks the path's records
// from the last to the first, from ā_thru_D = ā_rad ⊙ (0, 0, 1) when the
// path reached the cap, and writes (row, ā_albedo) for each record k at
// slot off_i + k (row 0 and zeros on a bounce that gathers nothing that
// counts): the slots hold the live records alone, path after path, and G
// sums that many of them in one call, the count read on the device.
//
// Bound. The forward is the RGB megakernel's work (bound by instruction
// throughput: the primitive tests or node visits and the Threefry rounds,
// counted from the SASS probes of sass_probes.cu) plus its records'
// bytes. The reverse is memory-bound: the records read, a (row,
// cotangent) slot written a record, the counts and cotangents of the paths
// beside them.
// Both keep a path in one thread's registers, so the bounce's state never
// goes through device memory but as the record the reverse walk reads.
//
// The arithmetic follows integrator/path.py operation for operation, so
// the build keeps IEEE rounding: -fmad=false, no --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bvh4.cuh"
#include "common.cuh"

namespace izpi {
namespace diff {

constexpr int kThreads = 128;
// A record's code (its low kCodeBits bits; the row above them).
constexpr int kNone = 0;       // a light seen from behind: the path ends
constexpr int kMiss = 1;       // the background: the path ends
constexpr int kEmit = 2;       // a light it faces: the path ends
constexpr int kScatter = 3;    // a diffuse bounce: mult = albedo · ratio
constexpr int kRefract = 4;    // a dielectric: mult = 1
constexpr int kCodeBits = 3;

// The closest hit over every primitive.
struct BruteHit {
  __device__ __forceinline__ int operator()(const Scene& sc, V3 o, V3 d, float tme,
                                            float t_min, float t_max, float& t) const {
    return closest_hit(sc, o, d, tme, t_min, t_max, t);
  }
};

// The closest hit through the BVH4 over the scene's (tree-ordered)
// primitives.
struct BvhHit {
  const int* __restrict__ nodes;
  const float* __restrict__ prims;
  __device__ __forceinline__ int operator()(const Scene& /*sc*/, V3 o, V3 d, float tme,
                                            float t_min, float t_max, float& t) const {
    int visits = 0, tests = 0;
    return bvh4_closest(nodes, prims, o, d, tme, t_min, t_max, t, visits, tests);
  }
};

// The trainable texture rows: row r < n_tex of c0, else row r - n_tex of c1.
struct Tex {
  const float* __restrict__ c0;
  const float* __restrict__ c1;
  int n_tex;
  __device__ __forceinline__ V3 row(int r) const {
    return r < n_tex ? ld3(c0 + 3 * r) : ld3(c1 + 3 * (r - n_tex));
  }
};

template <class Hit>
__device__ __forceinline__ void forward_path(const Hit& closest, const Scene& sc, const Tex& tex,
                                             int i, int n, V3 o, V3 d, float tme, uint32_t k0,
                                             uint32_t k1, int max_depth, V3 bg,
                                             float cos_scale, float* __restrict__ rad_out,
                                             int* __restrict__ cnt_out,
                                             float* __restrict__ rec_f,
                                             int* __restrict__ rec_i) {
  V3 thru = mk(1.0f, 1.0f, 1.0f);
  V3 rad = mk(0.0f, 0.0f, 0.0f);
  int depth = 0;
  bool scatters = false;
  while (depth < max_depth) {
    float t;
    const int hit = closest(sc, o, d, tme, kTMin, kTMax, t);
    int code = kMiss, row = 0;
    float ratio = 0.0f;
    V3 p = o, d_new = d, mult = mk(1.0f, 1.0f, 1.0f);
    scatters = false;
    if (hit < 0) {
      rad = rad + thru * bg;
    } else {
      p = o + d * t;
      const V3 n = record_normal(sc, hit, o, d, tme, p);
      const int mat = sc.prim_i[hit * kPrimI + 1];
      const float* M = sc.mat_f + mat * kMatF;
      const int* Mi = sc.mat_i + mat * kMatI;
      const int kind = Mi[0];
      row = Mi[3];
      if (Mi[1] != 0) {  // 3D sine checker (texture/checker.go:26): c1 unless negative
        const float sines = sinf(10.0f * p.x) * sinf(10.0f * p.y) * sinf(10.0f * p.z);
        if (!(sines < 0.0f)) row += tex.n_tex;
      }
      const V3 albedo = tex.row(row);
      // One-sided light keyed on the record normal (diffuselight.go:49-63);
      // thru * 0 on every other hit, as the plain bounce adds it.
      const bool emits = kind == kDiffuseLight && dot(n, d) < 0.0f;
      rad = rad + thru * (emits ? albedo : mk(0.0f, 0.0f, 0.0f));
      if (kind == kDiffuseLight) {
        code = emits ? kEmit : kNone;
      } else {
        scatters = true;
        Draws<false> dr;
        dr.clear();
        dr.bounce(k0, k1, (uint32_t)depth, kind == kDielectric ? kPairsDielectric : kPairsDiffuse);
        dr.run(0u, 0u, k0, k1, (uint32_t)depth);
        const float* us = dr.us;
        if (kind == kDielectric) {  // dielectric.go:66-102, raw direction, no absorption
          code = kRefract;
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
          const V3 refracted =
              (uv - outward * dt) * ni - outward * sqrtf(clamp_min(disc, 0.0f));
          float r0 = (1.0f - ref_idx) / (1.0f + ref_idx);
          r0 = r0 * r0;
          const float schlick = r0 + (1.0f - r0) * powf(1.0f - cosine, 5.0f);
          const bool is_refl = us[3] < (disc > 0.0f ? schlick : 1.0f);
          d_new = is_refl ? reflected : refracted;
        } else {  // diffuse: mixture of light and cosine pdfs (colour.go:48-57)
          code = kScatter;
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
          // The differentiable bounce's guards (path.py bounce_rgb): a
          // degenerate direction is zeroed before its cosine, and a sample
          // of no finite ratio weighs 0.
          const V3 du = mk(finite_or_zero(dd_unit.x), finite_or_zero(dd_unit.y),
                           finite_or_zero(dd_unit.z));
          const float spdf = kind == kLambert ? clamp_min(dot(n, du), 0.0f) / kPi : 0.0f;
          const bool live = pdf_val > 0.0f;
          const float r = spdf / (live ? pdf_val : 1.0f);
          ratio = live && isfinite(r) ? r : 0.0f;
          d_new = d_diff;
          mult = albedo * ratio;
        }
      }
    }
    const size_t slot = (size_t)depth * n + i;
    float4 rf;
    rf.x = thru.x;
    rf.y = thru.y;
    rf.z = thru.z;
    rf.w = ratio;
    reinterpret_cast<float4*>(rec_f)[slot] = rf;
    rec_i[slot] = ((code == kEmit || code == kScatter ? row : 0) << kCodeBits) | code;
    ++depth;
    if (!scatters) break;
    thru = thru * mult;
    o = p;
    d = d_new;
  }
  // The depth cap: the {Z:1} sentinel (colour.go:34-36).
  if (scatters) rad = rad + thru * mk(0.0f, 0.0f, 1.0f);
  rad_out[3 * i + 0] = rad.x;
  rad_out[3 * i + 1] = rad.y;
  rad_out[3 * i + 2] = rad.z;
  cnt_out[i] = depth;
}

template <class Hit>
__device__ __forceinline__ void forward_thread(const Hit& closest, const Scene& sc, Tex tex,
                                               const float* __restrict__ ray_o,
                                               const float* __restrict__ ray_d,
                                               const float* __restrict__ ray_t,
                                               const long long* __restrict__ keys, int n,
                                               int max_depth, V3 bg, float cos_scale,
                                               float* __restrict__ rad_out,
                                               int* __restrict__ cnt_out,
                                               float* __restrict__ rec_f,
                                               int* __restrict__ rec_i) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  forward_path(closest, sc, tex, i, n, ld3(ray_o + 3 * i), ld3(ray_d + 3 * i), ray_t[i],
               (uint32_t)keys[2 * i], (uint32_t)keys[2 * i + 1], max_depth, bg, cos_scale,
               rad_out, cnt_out, rec_f, rec_i);
}

__global__ void __launch_bounds__(kThreads)
    diff_trace_fwd(Scene sc, Tex tex, const float* __restrict__ ray_o,
                   const float* __restrict__ ray_d, const float* __restrict__ ray_t,
                   const long long* __restrict__ keys, int n, int max_depth, V3 bg,
                   float cos_scale, float* __restrict__ rad_out, int* __restrict__ cnt_out,
                   float* __restrict__ rec_f, int* __restrict__ rec_i) {
  forward_thread(BruteHit{}, sc, tex, ray_o, ray_d, ray_t, keys, n, max_depth, bg, cos_scale,
                 rad_out, cnt_out, rec_f, rec_i);
}

__global__ void __launch_bounds__(kThreads)
    diff_trace_fwd_bvh(Scene sc, BvhHit bvh, Tex tex, const float* __restrict__ ray_o,
                       const float* __restrict__ ray_d, const float* __restrict__ ray_t,
                       const long long* __restrict__ keys, int n, int max_depth, V3 bg,
                       float cos_scale, float* __restrict__ rad_out,
                       int* __restrict__ cnt_out, float* __restrict__ rec_f,
                       int* __restrict__ rec_i) {
  forward_thread(bvh, sc, tex, ray_o, ray_d, ray_t, keys, n, max_depth, bg, cos_scale,
                 rad_out, cnt_out, rec_f, rec_i);
}

// The sum of `v` over the block's kThreads threads, in `part` (shared);
// every thread gets it.
__device__ __forceinline__ int block_sum(int v, int* part) {
  const int t = threadIdx.x;
  part[t] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) part[t] += part[t + s];
    __syncthreads();
  }
  const int sum = part[0];
  __syncthreads();
  return sum;
}

// blk[b]: the records of paths [b·kThreads, (b + 1)·kThreads).
__global__ void __launch_bounds__(kThreads)
    diff_trace_block_counts(const int* __restrict__ cnt, int n, int* __restrict__ blk) {
  __shared__ int part[kThreads];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int sum = block_sum(i < n ? cnt[i] : 0, part);
  if (threadIdx.x == 0) blk[blockIdx.x] = sum;
}

// The reverse walk of path i over its len records; writes its (row,
// cotangent) slots from `base`, one a record.
__device__ __forceinline__ void reverse_path(int i, int n, int len, size_t base, const Tex& tex,
                                             V3 bg, const float* __restrict__ rec_f,
                                             const int* __restrict__ rec_i,
                                             const float* __restrict__ g_rad,
                                             long long* __restrict__ rows_out,
                                             float* __restrict__ g_out) {
  const V3 g = ld3(g_rad + 3 * i);
  const V3 zero = mk(0.0f, 0.0f, 0.0f);
  // ā_thru after the last bounce: the sentinel's, if the path reached the
  // cap (its last bounce scattered).
  V3 a = zero;
  if (len > 0) {
    const int last = rec_i[(size_t)(len - 1) * n + i] & ((1 << kCodeBits) - 1);
    if (last == kScatter || last == kRefract) a = g * mk(0.0f, 0.0f, 1.0f);
  }
  for (int k = len - 1; k >= 0; --k) {
    const size_t slot = (size_t)k * n + i;
    const float4 rf = reinterpret_cast<const float4*>(rec_f)[slot];
    const int word = rec_i[slot];
    const int code = word & ((1 << kCodeBits) - 1);
    const int row = word >> kCodeBits;
    const V3 thru = mk(rf.x, rf.y, rf.z);
    V3 ga = zero;
    if (code == kMiss) {
      a = g * bg;
    } else if (code == kEmit) {
      ga = g * thru;
      a = g * tex.row(row);
    } else if (code == kScatter) {
      ga = (a * thru) * rf.w;
      a = a * (tex.row(row) * rf.w);
    } else if (code == kNone) {
      a = zero;
    }  // kRefract: mult = 1, ā_thru passes through
    const size_t out = base + k;
    rows_out[out] = row;
    g_out[3 * out + 0] = ga.x;
    g_out[3 * out + 1] = ga.y;
    g_out[3 * out + 2] = ga.z;
  }
}

__global__ void __launch_bounds__(kThreads)
    diff_trace_bwd(Tex tex, const float* __restrict__ rec_f, const int* __restrict__ rec_i,
                   const int* __restrict__ cnt, const int* __restrict__ blk,
                   const float* __restrict__ g_rad, int n, V3 bg,
                   long long* __restrict__ rows_out, float* __restrict__ g_out,
                   int* __restrict__ total) {
  __shared__ int part[kThreads];
  const int t = threadIdx.x, b = blockIdx.x;
  const int i = b * kThreads + t;
  // The records of the blocks before this one.
  int before = 0;
  for (int j = t; j < b; j += kThreads) before += blk[j];
  const int base = block_sum(before, part);
  // An inclusive scan of this block's paths' counts.
  const int len = i < n ? cnt[i] : 0;
  part[t] = len;
  __syncthreads();
  for (int s = 1; s < kThreads; s <<= 1) {
    const int v = t >= s ? part[t - s] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  if (b == gridDim.x - 1 && t == kThreads - 1) *total = base + part[t];
  if (i < n) {
    reverse_path(i, n, len, (size_t)(base + part[t] - len), tex, bg, rec_f, rec_i, g_rad,
                 rows_out, g_out);
  }
}

}  // namespace diff
}  // namespace izpi

extern "C" {

// The forward kernel over n paths on `stream`: the scene tables of
// ops/megakernel.py pack_tables with each material's (clamped) albedo
// texture id in mat_i's fourth column; nodes and bvh_prims (ops/bvh_kernel.py
// pack_tables) for the BVH form, or both null for every primitive; c0, c1
// the (n_tex, 3) texture colours; o, d (n, 3), time (n,) f32 and keys (n, 2)
// int64 (32-bit words) of the camera rays. Writes rad (n, 3) f32, cnt (n,)
// i32 (the rays of each path) and the records rec_f (max_depth, n, 4) f32,
// rec_i (max_depth, n) i32 (a path's first cnt rows). Returns a cudaError_t.
int izpi_diff_trace_fwd(const float* prim_f, const int* prim_i, int n_prims, const float* mat_f,
                        const int* mat_i, const float* light_f, const int* light_i,
                        int n_lights, const int* nodes, const float* bvh_prims,
                        const float* c0, const float* c1, int n_tex, const float* o,
                        const float* d, const float* time, const long long* keys, int n,
                        int max_depth, float bg_r, float bg_g, float bg_b, int book,
                        float* rad, int* cnt, float* rec_f, int* rec_i, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  izpi::Scene sc{prim_f, prim_i, n_prims, mat_f, mat_i, light_f, light_i, n_lights};
  izpi::diff::Tex tex{c0, c1, n_tex};
  const izpi::V3 bg = izpi::mk(bg_r, bg_g, bg_b);
  const float cos_scale = book ? 2.0f : 1.0f;
  const int threads = izpi::diff::kThreads;
  const int blocks = (n + threads - 1) / threads;
  if (nodes == nullptr) {
    izpi::diff::diff_trace_fwd<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        sc, tex, o, d, time, keys, n, max_depth, bg, cos_scale, rad, cnt, rec_f, rec_i);
  } else {
    izpi::diff::BvhHit bvh{nodes, bvh_prims};
    izpi::diff::diff_trace_fwd_bvh<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        sc, bvh, tex, o, d, time, keys, n, max_depth, bg, cos_scale, rad, cnt, rec_f, rec_i);
  }
  return (int)cudaGetLastError();
}

// The reverse kernel over n paths on `stream`: the forward's records and
// ray counts, g_rad (n, 3) f32 the radiance's cotangent, c0, c1 as above.
// blk: scratch of izpi_diff_trace_bwd_blocks(n) ints. Writes total (one
// int), the number of records, and rows (max_depth·n,) int64 and g
// (max_depth·n, 3) f32, whose slot off_i + k holds bounce k of path i,
// off_i the records of the paths before i (the slots from total on are
// not written). Returns a cudaError_t.
int izpi_diff_trace_bwd_blocks(int n) {
  return (n + izpi::diff::kThreads - 1) / izpi::diff::kThreads;
}

int izpi_diff_trace_bwd(const float* rec_f, const int* rec_i, const int* cnt, const float* g_rad,
                        const float* c0, const float* c1, int n_tex, int n, int max_depth,
                        float bg_r, float bg_g, float bg_b, int* blk, int* total,
                        long long* rows, float* g, void* stream) {
  if (n <= 0 || max_depth <= 0) return (int)cudaErrorInvalidValue;
  izpi::diff::Tex tex{c0, c1, n_tex};
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = izpi::diff::kThreads;
  const int blocks = izpi_diff_trace_bwd_blocks(n);
  izpi::diff::diff_trace_block_counts<<<blocks, threads, 0, s>>>(cnt, n, blk);
  izpi::diff::diff_trace_bwd<<<blocks, threads, 0, s>>>(
      tex, rec_f, rec_i, cnt, blk, g_rad, n, izpi::mk(bg_r, bg_g, bg_b), rows, g, total);
  return (int)cudaGetLastError();
}

}  // extern "C"
