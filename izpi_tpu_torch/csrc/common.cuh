// Device code shared by the megakernels (megakernel_rgb.cu,
// megakernel_spectral.cu): 3-vector math, the primitive tests and closest
// hit over the packed scene tables, the record normal, the orthonormal basis,
// the light list's sample and pdf, the camera ray, and the persistent grid
// with its slot queue.
//
// Every function follows izpi_tpu_torch's plain PyTorch code operation for
// operation (geometry/primitives.py, core/onb.py, core/sampling.py,
// integrator/lights.py, camera.py), so the build must keep IEEE rounding:
// -fmad=false, no --use_fast_math, precise sqrtf/expf/logf/sinf/cosf/powf.
// The table layouts must match izpi_tpu_torch/ops/megakernel.py
// (pack_tables).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "draws.cuh"

namespace izpi {

// Row widths of the packed scene tables (ops/megakernel.py pack_tables).
constexpr int kPrimF = 24;   // g0 g1 g2 g3 (12) | vn (9) | pad (3)
constexpr int kPrimI = 4;    // kind, mat, flip, has_vn
constexpr int kMatF = 12;    // col0 (3) | col1 (3) | fuzz | ref_idx | absorption (3) | pad
constexpr int kMatI = 4;     // kind, is_checker, has_absorption, pad
constexpr int kLightF = 16;  // l0 l1 l2 normal (12) | area | radius | pad (2)

constexpr int kTriangle = 0, kRect = 1, kSphere = 2;
constexpr int kLambert = 0, kMetal = 1, kDielectric = 2, kDiffuseLight = 3;
constexpr int kLightRect = 0, kLightTriangle = 1, kLightSphere = 2;

constexpr float kTMin = 1e-3f;
constexpr float kTMax = 3.0e38f;
constexpr float kMtEps = 1e-8f;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kPi = 3.141592653589793f;

struct V3 {
  float x, y, z;
};

__host__ __device__ __forceinline__ V3 mk(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
__host__ __device__ __forceinline__ V3 ld3(const float* p) { return mk(p[0], p[1], p[2]); }
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return mk(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return mk(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 operator-(V3 a) { return mk(-a.x, -a.y, -a.z); }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) { return mk(a.x * b.x, a.y * b.y, a.z * b.z); }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return mk(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ V3 operator/(V3 a, float s) { return mk(a.x / s, a.y / s, a.z / s); }
// (x·x' + y·y') + z·z': the twin's order.
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return mk(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ float length(V3 a) { return sqrtf(dot(a, a)); }
__device__ __forceinline__ V3 normalize(V3 a) { return a / length(a); }
// torch.clamp(x, min=lo): NaN stays NaN (fmaxf would drop it).
__device__ __forceinline__ float clamp_min(float x, float lo) { return x != x ? x : fmaxf(x, lo); }
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ V3 reflect(V3 v, V3 n) { return v - n * (2.0f * dot(v, n)); }
__device__ __forceinline__ float finite_or_zero(float x) { return isfinite(x) ? x : 0.0f; }

struct Scene {
  const float* prim_f;
  const int* prim_i;
  int n_prims;
  const float* mat_f;
  const int* mat_i;
  const float* light_f;
  const int* light_i;
  int n_lights;
};

// ---------------------------------------------------------------------------
// Primitive tests (geometry/primitives.py)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void triangle_t(V3 o, V3 d, V3 v0, V3 e1, V3 e2, float t_min,
                                           float t_max, float& t, bool& ok, float& u,
                                           float& v) {
  const V3 h = cross(d, e2);
  const float a = dot(e1, h);
  const bool parallel = fabsf(a) < kMtEps;
  const float f = 1.0f / (parallel ? 1.0f : a);
  const V3 s = o - v0;
  u = f * dot(s, h);
  const V3 q = cross(s, e1);
  v = f * dot(d, q);
  t = f * dot(e2, q);
  ok = !parallel && u >= -kMtEps && u <= 1.0f + kMtEps && v >= -kMtEps &&
       u + v <= 1.0f + kMtEps && t >= t_min && t <= t_max;
}

__device__ __forceinline__ void rect_t(V3 o, V3 d, V3 p0, V3 e1, V3 e2, V3 n, float t_min,
                                       float t_max, float& t, bool& ok) {
  const float denom = dot(d, n);
  const bool degenerate = denom == 0.0f;
  t = dot(p0 - o, n) / (degenerate ? 1.0f : denom);
  const V3 rel = (o + d * t) - p0;
  const float u = dot(rel, e1) / dot(e1, e1);
  const float v = dot(rel, e2) / dot(e2, e2);
  ok = !degenerate && t >= t_min && t <= t_max && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
       v <= 1.0f;
}

__device__ __forceinline__ V3 sphere_center(V3 c0, V3 c1, float st0, float st1, float time) {
  const float denom = st1 - st0;
  float frac = (time - st0) / (denom == 0.0f ? 1.0f : denom);
  if (denom == 0.0f) frac = 0.0f;
  return c0 + (c1 - c0) * frac;
}

__device__ __forceinline__ void sphere_t(V3 o, V3 d, V3 center, float radius, float t_min,
                                         float t_max, float& t, bool& ok, bool& far_ok) {
  const V3 oc = o - center;
  const float a = dot(d, d);
  const float b = dot(oc, d);
  const float c = dot(oc, oc) - radius * radius;
  const float disc = b * b - a * c;
  const bool has = disc > 0.0f;
  const float sq = sqrtf(clamp_min(disc, 0.0f));
  const float a_safe = a == 0.0f ? 1.0f : a;
  const float t_near = (-b - sq) / a_safe;
  const float t_far = (-b + sq) / a_safe;
  const bool near_ok = has && t_near < t_max && t_near > t_min;
  far_ok = has && t_far < t_max && t_far > t_min && !near_ok;
  t = near_ok ? t_near : t_far;
  ok = near_ok || far_ok;
}

// The test of one primitive of `kind` whose geometry g0 g1 g2 g3 is the 12
// floats at g (the head of a packed row), in [t_min, t_max]: true on a hit,
// with its t (primitives.prim_t). A padding primitive never hits.
__device__ __forceinline__ bool prim_test(const float* g, int kind, V3 o, V3 d, float time,
                                          float t_min, float t_max, float& t) {
  bool ok = false;
  t = 0.0f;
  if (kind == kTriangle) {
    float u, v;
    triangle_t(o, d, ld3(g), ld3(g + 3), ld3(g + 6), t_min, t_max, t, ok, u, v);
  } else if (kind == kRect) {
    rect_t(o, d, ld3(g), ld3(g + 3), ld3(g + 6), ld3(g + 9), t_min, t_max, t, ok);
  } else if (kind == kSphere) {
    bool far_ok;
    sphere_t(o, d, sphere_center(ld3(g), ld3(g + 3), g[7], g[8], time), g[6], t_min, t_max,
             t, ok, far_ok);
  }
  return ok;
}

// Closest hit over every primitive; the first primitive wins exact ties
// (hitable_slice.go:30-45). Returns the primitive index or -1.
static __device__ int closest_hit(const Scene& sc, V3 o, V3 d, float time, float t_min,
                           float t_max, float& best_t) {
  best_t = kTMax;
  int best = -1;
  for (int i = 0; i < sc.n_prims; ++i) {
    float t;
    const bool ok =
        prim_test(sc.prim_f + i * kPrimF, sc.prim_i[i * kPrimI], o, d, time, t_min, t_max, t);
    if (ok && t < best_t) {
      best_t = t;
      best = i;
    }
  }
  return best;
}

// The record normal of primitive i at p (primitives.finalize_hit).
static __device__ V3 record_normal(const Scene& sc, int i, V3 o, V3 d, float time, V3 p) {
  const float* g = sc.prim_f + i * kPrimF;
  const int* gi = sc.prim_i + i * kPrimI;
  const int kind = gi[0];
  V3 n = ld3(g + 9);
  if (kind == kTriangle && gi[3] != 0) {
    float t, bu, bv;
    bool ok;
    triangle_t(o, d, ld3(g), ld3(g + 3), ld3(g + 6), -kTMax, kTMax, t, ok, bu, bv);
    float bw = 1.0f - bu - bv;
    const float s = bu + bv + bw;
    if (fabsf(s - 1.0f) > kMtEps) {
      const float s_safe = s == 0.0f ? 1.0f : s;
      bu = bu / s_safe;
      bv = bv / s_safe;
      bw = bw / s_safe;
    }
    const V3 vi = ld3(g + 12) * bw + ld3(g + 15) * bu + ld3(g + 18) * bv;
    n = vi / clamp_min(length(vi), 1e-12f);
  } else if (kind == kSphere) {
    const float radius = g[6];
    const V3 center = sphere_center(ld3(g), ld3(g + 3), g[7], g[8], time);
    float t;
    bool ok, far_root;
    sphere_t(o, d, center, radius, 1e-3f, kTMax, t, ok, far_root);
    const V3 outward = (p - center) / (radius == 0.0f ? 1.0f : radius);
    const V3 flipped = dot(d, outward) >= 0.0f ? -outward : outward;
    // The record normal stays unflipped on the far root (sphere.go:88-99).
    n = far_root ? outward : flipped;
  }
  return gi[2] != 0 ? -n : n;
}

// ---------------------------------------------------------------------------
// Sampling and lights (core/onb.py, core/sampling.py, integrator/lights.py)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void onb_from_w(V3 n, V3& u, V3& v, V3& w) {
  w = normalize(n);
  const V3 a = fabsf(w.x) > 0.9f ? mk(0.0f, 1.0f, 0.0f) : mk(1.0f, 0.0f, 0.0f);
  v = normalize(cross(w, a));
  u = cross(w, v);
}

static __device__ V3 lights_sample(const Scene& sc, V3 o, float u0, float u1, float u2, float u3) {
  const int n_l = sc.n_lights;
  int idx = (int)(u0 * (float)n_l);
  if (idx > n_l - 1) idx = n_l - 1;
  const float* L = sc.light_f + idx * kLightF;
  const int kind = sc.light_i[idx];
  const V3 l0 = ld3(L), l1 = ld3(L + 3), l2 = ld3(L + 6);
  if (kind == kLightRect) return l0 + l1 * u1 + l2 * u2 - o;  // xzrect.go:118-126
  if (kind == kLightTriangle) {  // the reference's lerp-lerp (triangle.go:317-326)
    const V3 p01 = l0 + (l1 - l0) * u1;
    const V3 p02 = l0 + (l2 - l0) * u2;
    return p01 + (p02 - p01) * u3 - o;
  }
  if (kind == kLightSphere) {  // cone sample (sphere.go:139-145)
    const float radius = L[13];
    const V3 to_c = l0 - o;
    const float dist2 = dot(to_c, to_c);
    V3 bu, bv, bw;
    onb_from_w(to_c, bu, bv, bw);
    const float z = 1.0f + u2 * (sqrtf(1.0f - radius * radius / dist2) - 1.0f);
    const float phi = kTwoPi * u1;
    const float s = sqrtf(clamp_min(1.0f - z * z, 0.0f));
    return bu * (cosf(phi) * s) + bv * (sinf(phi) * s) + bw * z;
  }
  return mk(1.0f, 0.0f, 0.0f);
}

// Mean member pdf (lights.pdf_value), with its sphere clamp.
static __device__ float lights_pdf(const Scene& sc, V3 o, V3 v) {
  const float v_len2 = dot(v, v);
  const float v_len = sqrtf(v_len2);
  float total = 0.0f;
  for (int j = 0; j < sc.n_lights; ++j) {
    const float* L = sc.light_f + j * kLightF;
    const int kind = sc.light_i[j];
    const V3 l0 = ld3(L), l1 = ld3(L + 3), l2 = ld3(L + 6), nrm = ld3(L + 9);
    float pdf = 0.0f, t;
    bool ok;
    if (kind == kLightRect || kind == kLightTriangle) {
      if (kind == kLightRect) {
        rect_t(o, v, l0, l1, l2, nrm, 1e-3f, kTMax, t, ok);
      } else {
        float u, w;
        triangle_t(o, v, l0, l1 - l0, l2 - l0, 1e-3f, kTMax, t, ok, u, w);
      }
      const float cosine = fabsf(dot(v, nrm)) / v_len;
      if (ok) pdf = t * t * v_len2 / (cosine * L[12]);
    } else if (kind == kLightSphere) {
      const float radius = L[13];
      bool far_ok;
      sphere_t(o, v, l0, radius, 1e-3f, kTMax, t, ok, far_ok);
      const V3 to_c = l0 - o;
      const float cos_max = sqrtf(clamp_min(1.0f - radius * radius / dot(to_c, to_c), 0.0f));
      if (ok) pdf = 1.0f / (kTwoPi * (1.0f - cos_max));
    }
    total = total + pdf;
  }
  return total / (float)sc.n_lights;
}

// ---------------------------------------------------------------------------
// The camera (camera.py)
// ---------------------------------------------------------------------------

// Camera row: origin, lower_left, horizontal, vertical, u, v (18) | lens_radius,
// time0, time1 (3) | pad (3). The megakernels take it by value, as a kernel
// parameter: it stays in the constant bank, not in 21 registers.
struct Camera {
  V3 o, ll, h, vert, bu, bv;
  float lens, time0, time1;
};

__host__ __device__ __forceinline__ Camera load_camera(const float* cam) {
  Camera c;
  c.o = ld3(cam);
  c.ll = ld3(cam + 3);
  c.h = ld3(cam + 6);
  c.vert = ld3(cam + 9);
  c.bu = ld3(cam + 12);
  c.bv = ld3(cam + 15);
  c.lens = cam[18];
  c.time0 = cam[19];
  c.time1 = cam[20];
  return c;
}

// Thin-lens camera ray through pixel (px, py) from the path's five camera
// uniforms (camera.primary_rays; drawn at depth 0 under CAMERA_SALT).
__device__ __forceinline__ void camera_ray(const Camera& c, const float (&cu)[5], float px,
                                           float py, int nx, int ny, V3& o, V3& d,
                                           float& tme) {
  const float fs = (px + cu[0]) / (float)nx;
  const float ft = (py + cu[1]) / (float)ny;
  const float r = sqrtf(cu[2]);
  const float phi = kTwoPi * cu[3];
  const float rdx = r * cosf(phi) * c.lens;
  const float rdy = r * sinf(phi) * c.lens;
  const V3 lens_off = c.bu * rdx + c.bv * rdy;
  tme = c.time0 + cu[4] * (c.time1 - c.time0);
  o = c.o + lens_off;
  d = c.ll + c.h * fs + c.vert * ft - c.o - lens_off;
}

// The camera ray of a sample of flat pixel `pix` (row-major, nx wide).
__device__ __forceinline__ void pixel_ray(const Camera& c, const float (&cu)[5], int pix,
                                          int nx, int ny, V3& o, V3& d, float& tme) {
  camera_ray(c, cu, (float)(pix % nx), (float)(pix / nx), nx, ny, o, d, tme);
}

// ---------------------------------------------------------------------------
// The persistent grid and its slot queue
// ---------------------------------------------------------------------------

// Threads per block of the megakernels.
constexpr int kMegaThreads = 128;
// The blocks per SM the megakernels' __launch_bounds__ asks ptxas to fit:
// 5 caps them at 96 registers, which both fit with no spill, for 20 warps
// per SM instead of 16 (1 would be no hint).
constexpr int kMegaMinBlocks = 5;
// The RGB megakernel's BVH form (megakernel_rgb.cu) asks for 7: 72
// registers and ~380 bytes a thread spilled, 28 warps an SM to cover the
// traversal's loads, ran 2% faster than 5 (96 registers, ~130 bytes
// spilled) on the H100, and 6 ran 2% slower (PERF.md). 8 ran faster still
// but grows the persistent grid past the next doubling of the slots'
// replicas (card_min_slots), which sums each pixel in another order.
constexpr int kBvhMinBlocks = 7;

// Slot s serves pixel s % n_pix with samples replica·spp_slot + [0, spp_slot)
// + offset, replica = s / n_pix (the mapping of izpi_tpu/ops/megakernel.py:647).
__device__ __forceinline__ uint32_t sample_id(int slot, int samp, int n_pix, int spp_slot,
                                              uint32_t offset) {
  return (uint32_t)((slot / n_pix) * spp_slot + samp) + offset;
}

// The next slot of the queue (>= n_slots once it is drained). With no
// samples per slot a slot's sums are zero, written here.
__device__ __forceinline__ int take_slot(int* queue, int n_slots, int spp_slot,
                                         float* acc_out, int* cnt_out) {
  for (;;) {
    const int s = atomicAdd(queue, 1);
    if (s >= n_slots || spp_slot > 0) return s;
    acc_out[3 * s + 0] = 0.0f;
    acc_out[3 * s + 1] = 0.0f;
    acc_out[3 * s + 2] = 0.0f;
    cnt_out[s] = 0;
  }
}

// The grid that fills the current device with `kernel` at kMegaThreads
// per block: the blocks one SM holds (occupancy) times the SM count.
// Returns a cudaError_t.
template <typename Kernel>
static int persistent_blocks(Kernel kernel, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMegaThreads, 0);
  if (err == cudaSuccess && per_sm * sms < 1) err = cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  return (int)err;
}

}  // namespace izpi
