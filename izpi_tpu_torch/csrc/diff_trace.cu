// The training step's bounce loop in two kernels: a forward path kernel
// that records each bounce, and a reverse kernel that walks the record
// back.
//
// Replaces izpi_tpu/parallel/dist.py:597 / izpi_tpu/integrator/path.py:
// 699-740 (no pallas_call): the jitted step's `lax.scan` of
// `jax.checkpoint`ed bounces, which XLA fuses into a few device programs
// forward and a few backward. In the port that scan was a CUDA graph of
// ~162,000 small PyTorch kernels a Cornell step (the bounce, its
// checkpoint recompute and its backward, 50 times over). Here it is one
// forward launch and a reverse of two launches that also does the work of
// the gathers' backward (ops/table_grad.py, G) for the texture rows.
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
// izpi_diff_trace_fwd: each path (the step's camera rays, made by the
// cipher entry's new-sample form) from the camera to its end (a miss, a
// light, or max_depth bounces), a warp's 32 paths one a lane. The forward
// is the differentiable bounce's (path.py bounce_rgb, differentiable=True):
// a non-finite ratio weighs 0, a degenerate NEE direction is zeroed before
// its cosine, and the depth cap adds the {Z:1} sentinel. Each live bounce
// writes one record of 20 bytes, planes of (bounce, path): thru_k and
// ratio_k as a float4, and (row << 3) | code as an int, the row being the
// flat row of the stacked [c0; c1] table it gathered (c1's rows after
// c0's). A path's records end at its ray count, written with its radiance.
//
// Why a warp's paths share its lanes. At the step's 1 spp the paths end
// at every depth (a Cornell step: 5.26 bounces on average, the longest of
// a warp's 32 paths 19.9, 76 of 65,536 at the cap of 50), so a warp whose
// lanes each trace their own path runs at a quarter of its lanes, and the
// launch ends with a few paths' bounces, each at its full latency: the
// primitive tests in a row, a chain of Threefry calls. In the brute-force
// form (forward_warp) a lane whose path has ended stays in the loop and
// helps: at L live paths each gets 32 / next_pow2(L) lanes, which split
// its closest hit and draw its pairs, while its owner keeps the shading,
// the record and its state, in one thread a path's order of operations.
// The BVH form (forward_path) keeps one thread a path, through the same
// one-bounce helpers: a warp pass a bounce, with or without groups
// splitting the leaves, measured slower there (PERF.md). Both give every
// output the bits of one thread a path.
//
// The one-bounce shading (bounce_hit, bounce_scatter) is copied from
// megakernel_rgb.cu's render_loop, not shared through a header: the
// differentiable bounce's guards and the record differ from it, and
// factoring it would put the RGB megakernel's register allocation (96, no
// spill) and its images at stake.
//
// izpi_diff_trace_bwd, the fused reverse: the walk of R and the sum of G
// in two launches, with no (row, cotangent) slot in device memory. The
// paths come in passes, the training step's sample passes traced in one
// forward launch (pass s: paths [s·N, (s+1)·N)), and each pass gets a
// table of its own, summed under its own exponent: the gradient a launch
// over that pass alone gives, bit for bit. A block takes 256 paths of one
// pass and sorts them by record count (sorted_path), so that a warp's
// lanes hold paths of about one length; a warp walks its lanes' records
// plane by plane, from its longest count down, lane l taking record k
// where k < its count, 8 planes' loads in flight and the texture rows
// staged in shared memory. A path's walk keeps the order of one thread a
// path: from ā_thru_D = ā_rad ⊙ (0, 0, 1) when the path reached the cap,
// each record's albedo cotangent ā_albedo in path.py's order of
// operations.
// - diff_trace_bwd_stat (pass 1) walks, keeps each record's ā_albedo and
//   row in the record's own place in rec_f (a lane writes only what it
//   has read, so no buffer beside the records), and writes its block's
//   largest finite |ā_albedo| and records. It zeroes pass 2's sums.
// - diff_trace_bwd_lane / _block / _global (pass 2) take the fixed point's
//   exponent from the partials of the block's pass, exactly G's
//   (fixed_point.cuh: the largest finite value and n = Σ cnt, every record
//   a slot as G counted R's), and add every kept record's terms, an even
//   run of them a thread (no walk, no tail): into the lanes' own copies of
//   the table in shared memory (up to kLaneElems elements), the block's
//   copy (the warp's same-row sum, up to kSharedElems), or device memory.
//   The last block to finish (an atomic ticket; no grid barrier) writes
//   every pass's table.
// So each pass's gradient is G's on R's slots bit for bit: the same terms,
// and int64 sums that any order and any grouping leave the same.
//
// Bound. The forward is the RGB megakernel's work (bound by instruction
// throughput: the primitive tests or node visits and the Threefry rounds,
// counted from the SASS probes of sass_probes.cu) plus its records'
// bytes. The reverse is memory-bound: the records read once, the counts
// and cotangents of the paths, the texture rows, the table written once.
// What it waits on is latency: a warp's longest walk, a dependent plane at
// a time (PERF.md).
// Both keep a path in one lane's registers, so the bounce's state never
// goes through device memory but as the record the reverse walk reads.
//
// The forward's probe instance (izpi_diff_trace_fwd_probe, ops/diff_trace.py
// probe; never on a main path) writes the same outputs and, a row a warp,
// how the warp spent its launch (ProbeColumn); the main instances compile
// the counts out.
//
// The arithmetic follows integrator/path.py operation for operation, so
// the build keeps IEEE rounding: -fmad=false, no --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bvh4.cuh"
#include "common.cuh"
#include "fixed_point.cuh"

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

constexpr unsigned kFull = 0xffffffffu;

// The probe instance's columns, a row of u64 a warp (ops/diff_trace.py
// PROBE_COLUMNS): the warp's bounce passes; its live lanes' clock64 cycles
// in their bounces, and within them in the closest hit and in the cipher;
// the %globaltimer (ns) at the warp's start and end; its passes by lanes a
// path (1, 2, ..., 32), and their clock64 cycles (ballot to ballot).
enum ProbeColumn : int {
  kPrPasses = 0,
  kPrCyBounce,
  kPrCyHit,
  kPrCyDraws,
  kPrStart,
  kPrEnd,
  kPrPassesG1,                // then G2, G4, G8, G16, G32
  kPrCyPassG1 = kPrPassesG1 + 6,  // then G2, ..., G32
  kProbeColumns = kPrCyPassG1 + 6
};

// The device's wall clock in ns (%globaltimer), for the probe's start and
// end times; on a host build, clock64.
__device__ __forceinline__ unsigned long long wall_ns() {
#ifdef __CUDA_ARCH__
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
#else
  return (unsigned long long)clock64();
#endif
}

// The lexicographic least (t, q) of the aligned group of G lanes that holds
// this lane (G a power of two), in every lane of the group; every lane of
// the warp calls it.
__device__ __forceinline__ void group_min(float& t, int& q, int G) {
  for (int m = 1; m < G; m <<= 1) {
    const float ot = __shfl_xor_sync(kFull, t, m);
    const int oq = __shfl_xor_sync(kFull, q, m);
    if (ot < t || (ot == t && oq < q)) {
      t = ot;
      q = oq;
    }
  }
}

// The closest hit over every primitive.
struct BruteHit {
  // closest_hit taken by the G lanes of an aligned group (lane r of it;
  // `has` false where the group serves no ray): lane r tests primitives r,
  // r + G, ...; the group's lexicographic least (t, index) of the hits
  // below kTMax is the primitive closest_hit's strict < keeps (the first
  // of an exact-t tie). Every lane of the warp calls it; each lane of the
  // group returns the result.
  __device__ __forceinline__ int group(const Scene& sc, bool has, V3 o, V3 d, float tme,
                                       float t_min, float t_max, int G, int r,
                                       float& t_out) const {
    float bt = kTMax;
    int bq = 0x7fffffff;
    if (has) {
      for (int j = r; j < sc.n_prims; j += G) {
        float t;
        const bool ok =
            prim_test(sc.prim_f + j * kPrimF, sc.prim_i[j * kPrimI], o, d, tme, t_min, t_max, t);
        if (ok && t < bt) {
          bt = t;
          bq = j;
        }
      }
    }
    group_min(bt, bq, G);
    t_out = bt;
    return bq == 0x7fffffff ? -1 : bq;
  }
};

// The closest hit through the BVH4 over the scene's (tree-ordered)
// primitives, one lane's.
struct BvhHit {
  const int* __restrict__ nodes;
  const float* __restrict__ prims;
  __device__ __forceinline__ int operator()(V3 o, V3 d, float tme, float t_min, float t_max,
                                            float& t) const {
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

// The launch's inputs and outputs, which every instance takes.
struct FwdArgs {
  const float* __restrict__ ray_o;
  const float* __restrict__ ray_d;
  const float* __restrict__ ray_t;
  const long long* __restrict__ keys;
  int n, max_depth;
  V3 bg;
  float cos_scale;
  float* __restrict__ rad_out;
  int* __restrict__ cnt_out;
  float* __restrict__ rec_f;
  int* __restrict__ rec_i;
  unsigned long long* __restrict__ probe_out;  // kProbe: (warps, kProbeColumns)
};

// The lanes a path gets at L live paths of a warp: 32 / (L rounded up to a
// power of two).
__device__ __forceinline__ int group_lanes(int live) {
  int p = 1;
  while (p < live) p <<= 1;
  return 32 / p;
}

// The lane of the k-th (from 0) set bit of mask.
__device__ __forceinline__ int nth_lane(unsigned mask, int k) {
  int lane = 0;
  for (int w = 16; w > 0; w >>= 1) {
    const int below = __popc(mask & ((1u << w) - 1u));
    if (k >= below) {
      k -= below;
      mask >>= w;
      lane += w;
    }
  }
  return lane;
}

// The bounce pairs in the order a group draws them (draws.cuh): pair 4,
// which picks a diffuse bounce's lobe, the light sample's 5, 0, 1, 2 and
// the cosine lobe's and a dielectric's 3. want: 6, a diffuse bounce's
// (both lobes'), or 1, a dielectric's (the last alone).
__device__ __forceinline__ uint32_t group_pair(int q) { return (0x321054u >> (4 * q)) & 0xFu; }
__device__ __forceinline__ bool group_draws(int want, int q) {
  return want == 6 || (want == 1 && q == 5);
}

// Pair `pair` of the bounce keyed (b0, b1): uniforms pair and pair + 6.
__device__ __forceinline__ void draw_pair(uint32_t b0, uint32_t b1, uint32_t pair, float& u,
                                          float& u6) {
  uint32_t x0 = pair, x1 = pair + 6u;
  threefry2x32(b0, b1, x0, x1);
  u = bits_to_uniform(x0);
  u6 = bits_to_uniform(x1);
}

// One lane's draws for a scattering bounce of the path keyed (k0, k1) at
// `depth` (want: group_draws): the pairs draws.cuh's lazy draws would
// give, the light sample's four as independent chains. us: the uniforms
// of the pairs drawn.
__device__ __forceinline__ void draw_bounce(uint32_t k0, uint32_t k1, int depth, int want,
                                            float (&us)[12]) {
  uint32_t y0 = 0u, y1 = (uint32_t)depth;  // fold_in(path key, depth)
  threefry2x32(k0, k1, y0, y1);
  uint32_t b0 = 0u, b1 = 0u;  // fold_in(., 0): the bounce key
  threefry2x32(y0, y1, b0, b1);
  if (want == 6) draw_pair(b0, b1, 4u, us[4], us[10]);
  if (want == 6 && us[4] < 0.5f) {
#pragma unroll
    for (int q = 1; q < 5; ++q) {
      draw_pair(b0, b1, group_pair(q), us[group_pair(q)], us[group_pair(q) + 6]);
    }
  } else {
    draw_pair(b0, b1, 3u, us[3], us[9]);
  }
}

// A bounce at its closest hit, up to its draws (path.py bounce_rgb,
// differentiable=True): the hit point, record normal, material and texture
// row, and whether it scatters (want: its pairs, group_draws). A miss adds
// the background to rad, a light it faces its radiance.
struct Bounce {
  int code = kMiss, row = 0, kind = kLambert, want = 0;
  bool scat = false;
  V3 p, n, albedo;
  const float* M = nullptr;
};

__device__ __forceinline__ Bounce bounce_hit(const Scene& sc, const Tex& tex, V3 bg, int hit,
                                             float t, V3 o, V3 d, float tme, V3 thru, V3& rad) {
  Bounce b;
  b.p = o;
  if (hit < 0) {
    rad = rad + thru * bg;
    return b;
  }
  b.p = o + d * t;
  b.n = record_normal(sc, hit, o, d, tme, b.p);
  const int mat = sc.prim_i[hit * kPrimI + 1];
  b.M = sc.mat_f + mat * kMatF;
  const int* Mi = sc.mat_i + mat * kMatI;
  b.kind = Mi[0];
  b.row = Mi[3];
  if (Mi[1] != 0) {  // 3D sine checker (texture/checker.go:26): c1 unless negative
    const float sines = sinf(10.0f * b.p.x) * sinf(10.0f * b.p.y) * sinf(10.0f * b.p.z);
    if (!(sines < 0.0f)) b.row += tex.n_tex;
  }
  b.albedo = tex.row(b.row);
  // One-sided light keyed on the record normal (diffuselight.go:49-63);
  // thru * 0 on every other hit, as the plain bounce adds it.
  const bool emits = b.kind == kDiffuseLight && dot(b.n, d) < 0.0f;
  rad = rad + thru * (emits ? b.albedo : mk(0.0f, 0.0f, 0.0f));
  if (b.kind == kDiffuseLight) {
    b.code = emits ? kEmit : kNone;
  } else {
    b.scat = true;
    b.want = b.kind == kDielectric ? 1 : 6;
  }
  return b;
}

// The rest of a scattering bounce b of direction d from its uniforms us:
// its code, its next direction and, for a diffuse bounce, its ratio and
// throughput factor.
__device__ __forceinline__ void bounce_scatter(const Scene& sc, const Bounce& b, V3 d,
                                               const float (&us)[12], float cos_scale, int& code,
                                               float& ratio, V3& d_new, V3& mult) {
  if (b.kind == kDielectric) {  // dielectric.go:66-102, raw direction, no absorption
    code = kRefract;
    const float ref_idx = b.M[7];
    const V3 reflected = reflect(d, b.n);
    const float d_dot_n = dot(d, b.n);
    const bool exiting = d_dot_n > 0.0f;
    const V3 outward = exiting ? -b.n : b.n;
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
    return;
  }
  // diffuse: mixture of light and cosine pdfs (colour.go:48-57)
  code = kScatter;
  V3 d_diff;
  if (us[4] < 0.5f) {
    d_diff = lights_sample(sc, b.p, us[5], us[6], us[7], us[8]);
  } else {
    V3 ou, ov, ow;
    onb_from_w(b.n, ou, ov, ow);
    const float zc = sqrtf(1.0f - us[10]);
    const float phic = kTwoPi * us[9];
    const float rc = cos_scale * sqrtf(us[10]);
    d_diff = ou * (cosf(phic) * rc) + ov * (sinf(phic) * rc) + ow * zc;
  }
  const V3 dd_unit = normalize(d_diff);
  const float cos_lobe = dot(dd_unit, normalize(b.n));
  const float pdf_cos = cos_lobe > 0.0f ? cos_lobe / kPi : 0.0f;
  const float pdf_val = 0.5f * lights_pdf(sc, b.p, d_diff) + 0.5f * pdf_cos;
  // The differentiable bounce's guards (path.py bounce_rgb): a degenerate
  // direction is zeroed before its cosine, and a sample of no finite ratio
  // weighs 0.
  const V3 du =
      mk(finite_or_zero(dd_unit.x), finite_or_zero(dd_unit.y), finite_or_zero(dd_unit.z));
  const float spdf = b.kind == kLambert ? clamp_min(dot(b.n, du), 0.0f) / kPi : 0.0f;
  const bool pos = pdf_val > 0.0f;
  const float r = spdf / (pos ? pdf_val : 1.0f);
  ratio = pos && isfinite(r) ? r : 0.0f;
  d_new = d_diff;
  mult = b.albedo * ratio;
}

// Record `depth` of path i: the throughput before the bounce, its ratio,
// and the row it gathered with its code.
__device__ __forceinline__ void write_record(const FwdArgs& a, int depth, int i, V3 thru,
                                             float ratio, int code, int row) {
  const size_t slot = (size_t)depth * a.n + i;
  float4 rf;
  rf.x = thru.x;
  rf.y = thru.y;
  rf.z = thru.z;
  rf.w = ratio;
  reinterpret_cast<float4*>(a.rec_f)[slot] = rf;
  a.rec_i[slot] = ((code == kEmit || code == kScatter ? row : 0) << kCodeBits) | code;
}

// Path i's radiance and rays at its end, with the depth cap's {Z:1}
// sentinel (colour.go:34-36) if its last bounce scattered.
__device__ __forceinline__ void write_path(const FwdArgs& a, int i, V3 rad, V3 thru,
                                           bool scatters, int depth) {
  if (scatters) rad = rad + thru * mk(0.0f, 0.0f, 1.0f);
  a.rad_out[3 * i + 0] = rad.x;
  a.rad_out[3 * i + 1] = rad.y;
  a.rad_out[3 * i + 2] = rad.z;
  a.cnt_out[i] = depth;
}

// The warp's paths (lane l owns path 32 · warp + l), each from its
// camera ray to its end (a miss, a light, or max_depth bounces), a bounce a
// pass for every live path: the brute-force form. A path's state (ray,
// throughput, radiance, depth) stays in its owner's registers. At L live
// paths each gets a group of G = group_lanes(L) lanes: at G == 1 each live
// lane serves its own path; at G > 1 group g (lanes gG .. gG + G - 1)
// serves the g-th live lane's, whose ray it takes by __shfl_sync. A pass:
// - the closest hit, at one call site for every G (closest.group: one copy
//   of the scan's code): at G > 1 the group splits the primitives;
// - the draws of the owner's material: at G == 1 the owner's
//   (draw_bounce); at G > 1 the group's, the bounce key's two fold-ins in
//   every lane, then the pairs one a lane a round (group_pair), which go
//   back to the owner: Threefry is counter-based, so a pair another lane
//   draws has the bits the owner would draw, and a pair the shading does
//   not read changes nothing;
// - the shading, the record and the path's throughput and radiance: the
//   owner's alone (bounce_hit, bounce_scatter), the operations of one
//   thread a path in its order.
// So every output keeps its bits whatever G. Every collective is reached
// by the whole warp once a pass (G is the same in every lane). kProbe: the
// warp's counts into its row of a.probe_out.
template <bool kProbe>
__device__ __forceinline__ void forward_warp(const BruteHit& closest, const Scene& sc,
                                             const Tex& tex, const FwdArgs& a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = i & 31;
  const bool owns = i < a.n;
  V3 o = mk(0.0f, 0.0f, 0.0f), d = o;
  float tme = 0.0f;
  uint32_t k0 = 0u, k1 = 0u;
  if (owns) {
    o = ld3(a.ray_o + 3 * i);
    d = ld3(a.ray_d + 3 * i);
    tme = a.ray_t[i];
    k0 = (uint32_t)a.keys[2 * i];
    k1 = (uint32_t)a.keys[2 * i + 1];
  }
  V3 thru = mk(1.0f, 1.0f, 1.0f);
  V3 rad = mk(0.0f, 0.0f, 0.0f);
  int depth = 0;
  bool scatters = false;
  bool live = owns && a.max_depth > 0;

  unsigned long long pc[kProbe ? kProbeColumns : 1] = {};
  unsigned long long start = 0;
  long long c_pass = 0;  // the last pass's ballot
  int g_pass = -1;       // and its column
  if constexpr (kProbe) start = wall_ns();

  for (;;) {
    const unsigned ballot = __ballot_sync(kFull, live);
    if constexpr (kProbe) {
      const long long now = clock64();
      if (g_pass >= 0) pc[g_pass] += (unsigned long long)(now - c_pass);
      c_pass = now;
    }
    if (ballot == 0u) break;
    const int G = group_lanes(__popc(ballot));
    const int lg = __ffs(G) - 1;  // G = 1 << lg
    long long c_bounce = 0, c0 = 0;
    if constexpr (kProbe) {
      ++pc[kPrPasses];
      ++pc[kPrPassesG1 + lg];
      g_pass = kPrCyPassG1 + lg;
      c_bounce = clock64();
    }
    // The group this lane serves (G == 1: each live lane its own path), its
    // path's owner, and the first lane of the group that serves this lane's
    // own path.
    const int grp = lane >> lg, r = lane & (G - 1);
    const bool has = G == 1 ? live : grp < __popc(ballot);
    const int src = G == 1 || !has ? lane : nth_lane(ballot, grp);
    const int lead = G == 1 || !live ? lane : __popc(ballot & ((1u << lane) - 1u)) << lg;

    // The closest hit, at one call site whatever G.
    const V3 go = mk(__shfl_sync(kFull, o.x, src), __shfl_sync(kFull, o.y, src),
                     __shfl_sync(kFull, o.z, src));
    const V3 gd = mk(__shfl_sync(kFull, d.x, src), __shfl_sync(kFull, d.y, src),
                     __shfl_sync(kFull, d.z, src));
    const float gt = __shfl_sync(kFull, tme, src);
    float tg;
    const int hg = closest.group(sc, has, go, gd, gt, kTMin, kTMax, G, r, tg);
    const float t = __shfl_sync(kFull, tg, lead);
    const int hit = __shfl_sync(kFull, hg, lead);
    if constexpr (kProbe) pc[kPrCyHit] += live ? (unsigned long long)(clock64() - c_bounce) : 0;

    // The bounce up to its draws (the owner's).
    Bounce b;
    if (live) b = bounce_hit(sc, tex, a.bg, hit, t, o, d, tme, thru, rad);

    // The draws: us holds the uniforms of the pairs the bounce reads.
    if constexpr (kProbe) c0 = clock64();
    float us[12];
    if (G == 1) {
      if (b.scat) draw_bounce(k0, k1, depth, b.want, us);
    } else if (__any_sync(kFull, b.want > 0)) {
      const int g_want = __shfl_sync(kFull, b.want, src);
      const uint32_t gk0 = (uint32_t)__shfl_sync(kFull, (int)k0, src);
      const uint32_t gk1 = (uint32_t)__shfl_sync(kFull, (int)k1, src);
      const int g_depth = __shfl_sync(kFull, depth, src);
      // Lane r draws the group's pairs r, r + G, r + 2G (G >= 2: at most 3).
      float ua[3] = {0.0f, 0.0f, 0.0f}, ub[3] = {0.0f, 0.0f, 0.0f};
      if (has && g_want > 0) {
        uint32_t y0 = 0u, y1 = (uint32_t)g_depth;  // fold_in(path key, depth)
        threefry2x32(gk0, gk1, y0, y1);
        uint32_t b0 = 0u, b1 = 0u;  // fold_in(., 0): the bounce key
        threefry2x32(y0, y1, b0, b1);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const int q = r + (k << lg);
          if (q < 6 && group_draws(g_want, q)) draw_pair(b0, b1, group_pair(q), ua[k], ub[k]);
        }
      }
      // Pair q is lane lead + q % G's round q / G.
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        const int k = q >> lg;
        const float va = k == 0 ? ua[0] : (k == 1 ? ua[1] : ua[2]);
        const float vb = k == 0 ? ub[0] : (k == 1 ? ub[1] : ub[2]);
        const int from = (lead + (q & (G - 1))) & 31;
        const float fa = __shfl_sync(kFull, va, from);
        const float fb = __shfl_sync(kFull, vb, from);
        if (group_draws(b.want, q)) {
          us[group_pair(q)] = fa;
          us[group_pair(q) + 6] = fb;
        }
      }
    }
    if constexpr (kProbe) pc[kPrCyDraws] += live ? (unsigned long long)(clock64() - c0) : 0;

    // The rest of the bounce, its record and the path's next ray (the
    // owner's).
    if (live) {
      int code = b.code;
      float ratio = 0.0f;
      V3 d_new = d, mult = mk(1.0f, 1.0f, 1.0f);
      if (b.scat) bounce_scatter(sc, b, d, us, a.cos_scale, code, ratio, d_new, mult);
      write_record(a, depth, i, thru, ratio, code, b.row);
      ++depth;
      scatters = b.scat;
      if (b.scat) {
        thru = thru * mult;
        o = b.p;
        d = d_new;
      }
      live = b.scat && depth < a.max_depth;
      if constexpr (kProbe) pc[kPrCyBounce] += (unsigned long long)(clock64() - c_bounce);
    }
  }
  if (owns) write_path(a, i, rad, thru, scatters, depth);
  if constexpr (kProbe) {
    if (i - lane < a.n) {  // a warp past the paths has no row
      unsigned long long* row = a.probe_out + (size_t)(i >> 5) * kProbeColumns;
      for (int c = kPrCyBounce; c <= kPrCyDraws; ++c) atomicAdd(row + c, pc[c]);
      if (lane == 0) {
        row[kPrPasses] = pc[kPrPasses];
        for (int g = 0; g < 12; ++g) row[kPrPassesG1 + g] = pc[kPrPassesG1 + g];
        row[kPrStart] = start;
        row[kPrEnd] = wall_ns();
      }
    }
  }
}

// Path i from its camera ray to its end in its own lane: the BVH form,
// whose lanes run apart (a warp pass a bounce measured slower there, with
// or without groups: PERF.md). Its bounce is the brute-force form's
// owner's (bounce_hit, bounce_scatter, write_record, write_path), with
// draws.cuh's lazy draws, a pair at a time: draw_bounce's four independent
// light chains spilled more of its registers beside the traversal's stack
// and ran 5% slower (PERF.md). Returns its rays. kProbe: adds the
// bounces' cycles to the lane's probe counts pc.
template <bool kProbe, class Hit>
__device__ __forceinline__ int forward_path(const Hit& closest, const Scene& sc, const Tex& tex,
                                            const FwdArgs& a, int i, unsigned long long* pc) {
  V3 o = ld3(a.ray_o + 3 * i);
  V3 d = ld3(a.ray_d + 3 * i);
  const float tme = a.ray_t[i];
  const uint32_t k0 = (uint32_t)a.keys[2 * i], k1 = (uint32_t)a.keys[2 * i + 1];
  V3 thru = mk(1.0f, 1.0f, 1.0f);
  V3 rad = mk(0.0f, 0.0f, 0.0f);
  int depth = 0;
  bool scatters = false;
  while (depth < a.max_depth) {
    long long c_bounce = 0, c0 = 0;
    if constexpr (kProbe) c_bounce = clock64();
    float t;
    const int hit = closest(o, d, tme, kTMin, kTMax, t);
    if constexpr (kProbe) pc[kPrCyHit] += (unsigned long long)(clock64() - c_bounce);
    const Bounce b = bounce_hit(sc, tex, a.bg, hit, t, o, d, tme, thru, rad);
    int code = b.code;
    float ratio = 0.0f;
    V3 d_new = d, mult = mk(1.0f, 1.0f, 1.0f);
    if (b.scat) {
      if constexpr (kProbe) c0 = clock64();
      Draws<false> dr;
      dr.clear();
      dr.bounce(k0, k1, (uint32_t)depth, b.want == 1 ? kPairsDielectric : kPairsDiffuse);
      dr.run(0u, 0u, k0, k1, (uint32_t)depth);
      if constexpr (kProbe) pc[kPrCyDraws] += (unsigned long long)(clock64() - c0);
      bounce_scatter(sc, b, d, dr.us, a.cos_scale, code, ratio, d_new, mult);
    }
    write_record(a, depth, i, thru, ratio, code, b.row);
    ++depth;
    if constexpr (kProbe) pc[kPrCyBounce] += (unsigned long long)(clock64() - c_bounce);
    scatters = b.scat;
    if (!scatters) break;
    thru = thru * mult;
    o = b.p;
    d = d_new;
  }
  write_path(a, i, rad, thru, scatters, depth);
  return depth;
}

// The BVH form's thread: path i (a warp's 32 paths, one a thread); the
// probe instance writes the warp's row once every lane is done.
template <bool kProbe, class Hit>
__device__ __forceinline__ void forward_thread(const Hit& closest, const Scene& sc, Tex tex,
                                               const FwdArgs& a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (!kProbe) {
    if (i >= a.n) return;
    forward_path<kProbe>(closest, sc, tex, a, i, nullptr);
  } else {
    // The warp's row: its lanes' cycles, its passes (its longest path) and
    // its start and end, read once every lane is done.
    unsigned long long pc[kProbeColumns] = {};
    const unsigned long long start = wall_ns();
    const int rays = i < a.n ? forward_path<kProbe>(closest, sc, tex, a, i, pc) : 0;
    __syncwarp();
    const int passes = __reduce_max_sync(kFull, rays);
    if (i - (i & 31) >= a.n) return;  // a warp past the paths has no row
    unsigned long long* row = a.probe_out + (size_t)(i >> 5) * kProbeColumns;
    for (int c = kPrCyBounce; c <= kPrCyDraws; ++c) atomicAdd(row + c, pc[c]);
    if ((threadIdx.x & 31) == 0) {
      row[kPrPasses] = (unsigned long long)passes;
      row[kPrStart] = start;
      row[kPrEnd] = wall_ns();
    }
  }
}

__global__ void __launch_bounds__(kThreads) diff_trace_fwd(Scene sc, Tex tex, FwdArgs a) {
  forward_warp<false>(BruteHit{}, sc, tex, a);
}

__global__ void __launch_bounds__(kThreads)
    diff_trace_fwd_bvh(Scene sc, BvhHit bvh, Tex tex, FwdArgs a) {
  forward_thread<false>(bvh, sc, tex, a);
}

__global__ void __launch_bounds__(kThreads) diff_trace_fwd_probe(Scene sc, Tex tex, FwdArgs a) {
  forward_warp<true>(BruteHit{}, sc, tex, a);
}

__global__ void __launch_bounds__(kThreads)
    diff_trace_fwd_bvh_probe(Scene sc, BvhHit bvh, Tex tex, FwdArgs a) {
  forward_thread<true>(bvh, sc, tex, a);
}

// The reverse's block: kRevThreads paths, sorted by their record count
// (sorted_path) before they are walked.
constexpr int kRevThreads = 256;
// The reverse walk's planes in flight: while a warp walks plane k back, its
// loads of plane k - kAhead are issued (a record does not depend on the ā
// chain).
constexpr int kAhead = 8;
// Rows of the stacked [c0; c1] table a block stages in shared memory; a
// larger table is read from device memory.
constexpr int kStageRows = 256;
// Record counts the block's sort tells apart; longer paths share its last
// bin.
constexpr int kLenBins = 64;

// The texture rows as the reverse walk reads them: the stacked [c0; c1]
// rows staged in shared memory, or tex's.
struct RowTable {
  const float* staged;
  Tex tex;
  __device__ __forceinline__ V3 row(int r) const {
    return staged != nullptr ? ld3(staged + 3 * r) : tex.row(r);
  }
};

// c0's and c1's rows staged in s (3·kStageRows floats of shared memory)
// where they fit; every thread of the block calls it.
__device__ __forceinline__ RowTable stage_rows(const Tex& tex, float* s) {
  const int floats = 3 * tex.n_tex;
  if (2 * tex.n_tex > kStageRows) return RowTable{nullptr, tex};
  for (int e = threadIdx.x; e < 2 * floats; e += blockDim.x) {
    s[e] = e < floats ? tex.c0[e] : tex.c1[e - floats];
  }
  __syncthreads();
  return RowTable{s, tex};
}

// The reverse kernels' inputs: the forward's records and ray counts, the
// radiance's cotangent g_rad (n, 3), the background; n paths in passes of
// n_pass (n a multiple of it). rec_f is not __restrict__: pass 1 keeps
// its cotangents in it.
struct RevArgs {
  const float* rec_f;
  const int* __restrict__ rec_i;
  const int* __restrict__ cnt;
  const float* __restrict__ g_rad;
  int n;
  int n_pass;
  V3 bg;
};

// The blocks of a pass: its paths kRevThreads a block, the last block
// partial where kRevThreads does not divide n_pass.
__host__ __device__ __forceinline__ int pass_blocks(int n_pass) {
  return (n_pass + kRevThreads - 1) / kRevThreads;
}

// This block's paths [first, end), all of pass `pass`.
struct BlockPaths {
  int pass, first, end;
};

__device__ __forceinline__ BlockPaths block_paths(const RevArgs& a) {
  const int per = pass_blocks(a.n_pass);
  const int pass = (int)blockIdx.x / per;
  const int first = pass * a.n_pass + ((int)blockIdx.x - pass * per) * kRevThreads;
  const int stop = (pass + 1) * a.n_pass;
  return BlockPaths{pass, first, first + kRevThreads < stop ? first + kRevThreads : stop};
}

// The path this thread walks back, and its record count `len`: the
// block's paths sorted by count, longest first (a counting sort in shared
// memory, bins: 2·kLenBins ints; paths of one count in any order; a rank
// past the block's paths counts 0 records), so that a warp's lanes hold
// paths of about one length and the warp walks few planes its lanes do not
// use. Which lane walks which path changes no bit: a path's walk is its
// own, and the fixed point's sums are taken in any order. Every thread of
// the block calls it.
__device__ __forceinline__ int sorted_path(const RevArgs& a, const BlockPaths& bp, int* bins,
                                           int* order, int& len) {
  const int t = threadIdx.x;
  const int first = bp.first;
  const int own = first + t < bp.end ? a.cnt[first + t] : 0;
  const int bin = own < kLenBins - 1 ? own : kLenBins - 1;
  for (int j = t; j < 2 * kLenBins; j += blockDim.x) bins[j] = 0;
  __syncthreads();
  atomicAdd(bins + bin, 1);
  __syncthreads();
  if (t < kLenBins) {  // the paths in the bins above bin t
    int above = 0;
    for (int j = t + 1; j < kLenBins; ++j) above += bins[j];
    bins[kLenBins + t] = above;
  }
  __syncthreads();
  order[atomicAdd(bins + kLenBins + bin, 1)] = t;
  __syncthreads();
  const int path = first + order[t];
  len = path < bp.end ? a.cnt[path] : 0;
  return path;
}

// One record of a path walked back: ā_thru after the bounce (a) becomes
// ā_thru before it, and the cotangent of the albedo row it gathered is
// returned (zeros where it gathers nothing that counts). `last`: the path's
// last record, where a starts from the sentinel's ā_thru if the path
// reached the cap (its last bounce scattered), else from zeros.
__device__ __forceinline__ V3 reverse_step(float4 rf, int code, int row, V3 g, V3 bg,
                                           const RowTable& rows, bool last, V3& a) {
  const V3 zero = mk(0.0f, 0.0f, 0.0f);
  if (last) a = code == kScatter || code == kRefract ? g * mk(0.0f, 0.0f, 1.0f) : zero;
  const V3 thru = mk(rf.x, rf.y, rf.z);
  V3 ga = zero;
  if (code == kMiss) {
    a = g * bg;
  } else if (code == kEmit) {
    ga = g * thru;
    a = g * rows.row(row);
  } else if (code == kScatter) {
    ga = (a * thru) * rf.w;
    a = a * (rows.row(row) * rf.w);
  } else if (code == kNone) {
    a = zero;
  }  // kRefract: mult = 1, ā_thru passes through
  return ga;
}

// The reverse walk of path i (len records; i >= n: none) in this lane,
// plane by plane with the warp's other lanes: k steps down from the warp's
// longest count, and the lane takes record k where k < len, so the path's
// records go from its last to its first, the order of one thread a path.
// visit(k, live, row, ga) is called by every lane of the warp at each
// plane (live: the lane took record k, of texture row `row` and albedo
// cotangent ga).
template <class Visit>
__device__ __forceinline__ void reverse_walk(const RevArgs& a, const RowTable& rows, int i,
                                             int len, Visit&& visit) {
  const V3 g = i < a.n ? ld3(a.g_rad + 3 * i) : mk(0.0f, 0.0f, 0.0f);
  const int top = __reduce_max_sync(kFull, len);
  const float4* recs = reinterpret_cast<const float4*>(a.rec_f);
  float4 rf[kAhead];
  int word[kAhead];
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    const int k = top - 1 - j;
    rf[j] = float4{0.0f, 0.0f, 0.0f, 0.0f};
    word[j] = 0;
    if (k >= 0 && k < len) {
      rf[j] = recs[(size_t)k * a.n + i];
      word[j] = a.rec_i[(size_t)k * a.n + i];
    }
  }
  V3 ac = mk(0.0f, 0.0f, 0.0f);
  for (int base = top - 1; base >= 0; base -= kAhead) {
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int k = base - j;
      if (k < 0) break;  // the same k in every lane
      const float4 r = rf[j];
      const int w = word[j];
      const int kn = k - kAhead;
      if (kn >= 0 && kn < len) {
        rf[j] = recs[(size_t)kn * a.n + i];
        word[j] = a.rec_i[(size_t)kn * a.n + i];
      }
      const bool live = k < len;
      const int row = w >> kCodeBits;
      V3 ga = mk(0.0f, 0.0f, 0.0f);
      if (live) {
        ga = reverse_step(r, w & ((1 << kCodeBits) - 1), row, g, a.bg, rows, k == len - 1, ac);
      }
      visit(k, live, row, ga);
    }
  }
}

// The fused reverse's scratch in device memory, unzeroed: pass 1 zeroes
// the sums, flags and ticket that pass 2 adds into, and writes its
// blocks' partials, which pass 2 reads whole.
struct GradScratch {
  unsigned long long* acc;  // every pass's table's int64 sums (elems a pass)
  unsigned* flags;          // their NaN and ±Inf flags
  unsigned* part_max;       // a pass-1 block's largest finite |ā_albedo| (its bits)
  int* part_cnt;            // a pass-1 block's records
  int* ticket;              // pass 2's blocks done
};

// all_elems: the elements of every pass's table.
__host__ __device__ __forceinline__ GradScratch grad_scratch(void* p, long long all_elems,
                                                             int blocks) {
  GradScratch gs;
  gs.acc = (unsigned long long*)p;
  gs.flags = (unsigned*)(gs.acc + all_elems);
  gs.part_max = gs.flags + all_elems;
  gs.part_cnt = (int*)(gs.part_max + blocks);
  gs.ticket = gs.part_cnt + blocks;
  return gs;
}

// Where pass 2 adds a block's terms: in its lanes' own copies of the table
// in shared memory (kLaneElems elements or fewer: no atomics, no
// conflicts), in the block's copy (kSharedElems or fewer: the warp's
// same-row sum, then shared atomics), or in device memory.
enum AddPath : int { kAddLane = 0, kAddBlock, kAddGlobal };
constexpr int kLaneElems = 16;
using fixed::kSharedElems;

__host__ __device__ __forceinline__ int add_path(long long elems) {
  return elems <= kLaneElems ? kAddLane : (elems <= kSharedElems ? kAddBlock : kAddGlobal);
}

// The largest m (>= 0) and the sum of c over the block's kRevThreads
// threads, in every thread (wm, wc: shared, a warp's entry each).
__device__ __forceinline__ void block_max_sum(float& m, long long& c, float* wm, long long* wc) {
  const int lane = threadIdx.x & 31;
  for (int o = 16; o > 0; o >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    c += __shfl_sync(kFull, c, lane ^ o);
  }
  if (lane == 0) {
    wm[threadIdx.x >> 5] = m;
    wc[threadIdx.x >> 5] = c;
  }
  __syncthreads();
  m = wm[0];
  c = wc[0];
  for (int w = 1; w < kRevThreads / 32; ++w) {
    m = fmaxf(m, wm[w]);
    c += wc[w];
  }
  __syncthreads();
}

// The exclusive prefix sum of v over the block's kRevThreads threads, and
// their total (ws: shared, a warp's entry each). Every thread calls it.
__device__ __forceinline__ int block_scan(int v, int* ws, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_sync(kFull, x, lane >= o ? lane - o : 0);
    if (lane >= o) x += y;
  }
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  int before = 0;
  total = 0;
  for (int w = 0; w < kRevThreads / 32; ++w) {
    before += w < warp ? ws[w] : 0;
    total += ws[w];
  }
  __syncthreads();
  return before + x - v;
}

// Pass 1: the walk's largest finite |ā_albedo| and its records, a block's
// into its partials; each record's cotangent and row kept for pass 2 in
// the record's place, keep[k·n + i] = (ā_albedo, the row's bits) for
// record k of path i, keep being rec_f: the lane that read the record
// writes it, after reading it; the sums, flags and ticket of pass 2 zeroed
// (all_elems: every pass's table's).
__global__ void __launch_bounds__(kRevThreads)
    diff_trace_bwd_stat(Tex tex, RevArgs ra, GradScratch gs, long long all_elems,
                        float4* keep) {
  __shared__ float staged[3 * kStageRows];
  __shared__ int bins[2 * kLenBins];
  __shared__ int order[kRevThreads];
  __shared__ float wm[kRevThreads / 32];
  __shared__ long long wc[kRevThreads / 32];
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long e = gid; e < all_elems; e += (long long)gridDim.x * blockDim.x) {
    gs.acc[e] = 0ull;
    gs.flags[e] = 0u;
  }
  if (gid == 0) *gs.ticket = 0;
  const RowTable rows = stage_rows(tex, staged);
  const BlockPaths bp = block_paths(ra);
  int len = 0;
  const int i = sorted_path(ra, bp, bins, order, len);
  float m = 0.0f;
  reverse_walk(ra, rows, i, len, [&](int k, bool live, int row, V3 ga) {
    if (live) {
      m = fmaxf(m, fmaxf(fixed::finite_abs(ga.x),
                         fmaxf(fixed::finite_abs(ga.y), fixed::finite_abs(ga.z))));
      keep[(size_t)k * ra.n + i] = float4{ga.x, ga.y, ga.z, __int_as_float(row)};
    }
  });
  long long c = len;
  block_max_sum(m, c, wm, wc);
  if (threadIdx.x == 0) {
    gs.part_max[blockIdx.x] = __float_as_uint(m);
    gs.part_cnt[blockIdx.x] = (int)c;
  }
}

// The fixed point's exponent of pass `pass`, from pass 1's partials of
// its blocks (the largest |ā_albedo| and n = Σ cnt, G's over the slots of
// every record of the pass), in every thread of the block (which all call
// it).
__device__ __forceinline__ int pass_exponent(const RevArgs& ra, const GradScratch& gs, int pass,
                                             float* wm, long long* wc) {
  const int per = pass_blocks(ra.n_pass);
  float m = 0.0f;
  long long n = 0;
  for (int j = threadIdx.x; j < per; j += blockDim.x) {
    m = fmaxf(m, __uint_as_float(gs.part_max[pass * per + j]));
    n += gs.part_cnt[pass * per + j];
  }
  block_max_sum(m, n, wm, wc);
  return fixed::exponent(__float_as_uint(m), n);
}

// Pass 2: the exponent of the block's pass, then the block's records from
// pass 1's keep, path after path, an even run of them a thread (no walk:
// every lane busy to the end), each record's terms added (kPath) into its
// pass's table's sums; the last block to finish turns every pass's sums
// into out (elems f32 a pass, pass after pass).
template <int kPath>
__device__ __forceinline__ void reverse_add(const RevArgs& ra, const GradScratch& gs,
                                            long long elems,
                                            const float4* __restrict__ keep,
                                            float* __restrict__ out) {
  __shared__ int lens[kRevThreads];
  __shared__ int start[kRevThreads];
  __shared__ int ws[kRevThreads / 32];
  __shared__ float wm[kRevThreads / 32];
  __shared__ long long wc[kRevThreads / 32];
  __shared__ unsigned long long part[kPath == kAddGlobal ? 1 : kSharedElems];
  __shared__ int last;
  static_assert(kLaneElems * kRevThreads <= kSharedElems, "a lane's copies fit the block's");
  const int t = threadIdx.x;
  const BlockPaths bp = block_paths(ra);
  const double scale = fixed::scale_of(pass_exponent(ra, gs, bp.pass, wm, wc));
  unsigned long long* const acc_pass = gs.acc + bp.pass * elems;
  unsigned* const flags_pass = gs.flags + bp.pass * elems;
  if constexpr (kPath != kAddGlobal) {
    const long long slots = kPath == kAddLane ? elems * kRevThreads : elems;
    for (long long e = t; e < slots; e += blockDim.x) part[e] = 0ull;
  }
  // The block's paths, and the first record of each.
  const int first = bp.first;
  const int len = first + t < bp.end ? ra.cnt[first + t] : 0;
  int total = 0;
  lens[t] = len;
  start[t] = block_scan(len, ws, total);
  __syncthreads();
  auto add = [&](bool live, int row, V3 ga) {
    const float x[3] = {ga.x, ga.y, ga.z};
    if constexpr (kPath == kAddLane) {
      if (!live) return;
#pragma unroll
      for (int col = 0; col < 3; ++col) {
        unsigned flag = 0u;
        const long long q = fixed::term(x[col], scale, flag);
        if (flag != 0u) atomicOr(flags_pass + 3 * row + col, flag);
        if (q != 0) part[(size_t)(3 * row + col) * kRevThreads + t] += (unsigned long long)q;
      }
    } else {
      unsigned long long* acc = kPath == kAddBlock ? part : acc_pass;
      const unsigned peers = __match_any_sync(kFull, live ? (long long)row : -1ll);
      const bool leader = live && __ffs(peers) - 1 == (t & 31);
#pragma unroll
      for (int col = 0; col < 3; ++col) {
        unsigned flag = 0u;
        const long long q = live ? fixed::term(x[col], scale, flag) : 0;
        if (flag != 0u) atomicOr(flags_pass + 3 * row + col, flag);
        fixed::warp_add(peers, leader, q, leader ? acc + 3 * row + col : acc);
      }
    }
  };
  // Records [r, r_end) of the block, from its path p's record rec.
  const int per = (total + kRevThreads - 1) / kRevThreads;
  int r = t * per;
  const int r_end = r + per < total ? r + per : total;
  int p = 0, rec = 0;
  if (r < r_end) {  // the last path that starts at or before r
    for (int step = kRevThreads / 2; step > 0; step >>= 1) {
      if (start[p + step] <= r) p += step;
    }
    rec = r - start[p];
  }
#pragma unroll 4
  for (int j = 0; j < per; ++j) {
    const bool live = r < r_end;
    int row = 0;
    V3 ga = mk(0.0f, 0.0f, 0.0f);
    if (live) {
      const float4 v = keep[(size_t)rec * ra.n + first + p];
      ga = mk(v.x, v.y, v.z);
      row = __float_as_int(v.w);
      ++r;
      ++rec;
      if (r < r_end) {
        while (rec == lens[p]) {
          ++p;
          rec = 0;
        }
      }
    }
    add(live, row, ga);
  }
  __syncthreads();
  if constexpr (kPath == kAddLane) {
    // Element e's copies (a lane's at e·kRevThreads + t) summed by warp e
    // mod (kRevThreads / 32), each lane over a run of them, then by
    // shuffles.
    const int lane = t & 31;
    for (long long e = t >> 5; e < elems; e += kRevThreads / 32) {
      unsigned long long sum = 0ull;
      for (int j = lane; j < kRevThreads; j += 32) sum += part[e * kRevThreads + j];
      for (int o = 16; o > 0; o >>= 1) {
        sum += (unsigned long long)__shfl_sync(kFull, (long long)sum, lane ^ o);
      }
      if (lane == 0 && sum != 0ull) atomicAdd(acc_pass + e, sum);
    }
  } else if constexpr (kPath == kAddBlock) {
    for (long long e = t; e < elems; e += blockDim.x) {
      if (part[e] != 0ull) atomicAdd(acc_pass + e, part[e]);
    }
  }
  // The last block to finish reads every block's sums, pass after pass.
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(gs.ticket, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int pass = 0; pass < ra.n / ra.n_pass; ++pass) {
    const int k = pass_exponent(ra, gs, pass, wm, wc);
    const long long base = pass * elems;
    for (long long e = base + t; e < base + elems; e += blockDim.x) {
      out[e] = fixed::value(*(volatile unsigned long long*)(gs.acc + e),
                            *(volatile unsigned*)(gs.flags + e), k);
    }
  }
}

__global__ void __launch_bounds__(kRevThreads)
    diff_trace_bwd_lane(RevArgs ra, GradScratch gs, long long elems,
                        const float4* __restrict__ keep, float* __restrict__ out) {
  reverse_add<kAddLane>(ra, gs, elems, keep, out);
}

__global__ void __launch_bounds__(kRevThreads)
    diff_trace_bwd_block(RevArgs ra, GradScratch gs, long long elems,
                         const float4* __restrict__ keep, float* __restrict__ out) {
  reverse_add<kAddBlock>(ra, gs, elems, keep, out);
}

__global__ void __launch_bounds__(kRevThreads)
    diff_trace_bwd_global(RevArgs ra, GradScratch gs, long long elems,
                          const float4* __restrict__ keep, float* __restrict__ out) {
  reverse_add<kAddGlobal>(ra, gs, elems, keep, out);
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
static int launch_fwd(const float* prim_f, const int* prim_i, int n_prims, const float* mat_f,
                      const int* mat_i, const float* light_f, const int* light_i, int n_lights,
                      const int* nodes, const float* bvh_prims, const float* c0,
                      const float* c1, int n_tex, const float* o, const float* d,
                      const float* time, const long long* keys, int n, int max_depth,
                      float bg_r, float bg_g, float bg_b, int book, float* rad, int* cnt,
                      float* rec_f, int* rec_i, unsigned long long* probe, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  izpi::Scene sc{prim_f, prim_i, n_prims, mat_f, mat_i, light_f, light_i, n_lights};
  izpi::diff::Tex tex{c0, c1, n_tex};
  const izpi::diff::FwdArgs a{o, d, time, keys, n, max_depth,
                              izpi::mk(bg_r, bg_g, bg_b), book ? 2.0f : 1.0f,
                              rad, cnt, rec_f, rec_i, probe};
  const int threads = izpi::diff::kThreads;
  const int blocks = (n + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  const izpi::diff::BvhHit bvh{nodes, bvh_prims};
  if (nodes == nullptr && probe == nullptr) {
    izpi::diff::diff_trace_fwd<<<blocks, threads, 0, s>>>(sc, tex, a);
  } else if (nodes == nullptr) {
    izpi::diff::diff_trace_fwd_probe<<<blocks, threads, 0, s>>>(sc, tex, a);
  } else if (probe == nullptr) {
    izpi::diff::diff_trace_fwd_bvh<<<blocks, threads, 0, s>>>(sc, bvh, tex, a);
  } else {
    izpi::diff::diff_trace_fwd_bvh_probe<<<blocks, threads, 0, s>>>(sc, bvh, tex, a);
  }
  return (int)cudaGetLastError();
}

int izpi_diff_trace_fwd(const float* prim_f, const int* prim_i, int n_prims, const float* mat_f,
                        const int* mat_i, const float* light_f, const int* light_i,
                        int n_lights, const int* nodes, const float* bvh_prims,
                        const float* c0, const float* c1, int n_tex, const float* o,
                        const float* d, const float* time, const long long* keys, int n,
                        int max_depth, float bg_r, float bg_g, float bg_b, int book,
                        float* rad, int* cnt, float* rec_f, int* rec_i, void* stream) {
  return launch_fwd(prim_f, prim_i, n_prims, mat_f, mat_i, light_f, light_i, n_lights, nodes,
                    bvh_prims, c0, c1, n_tex, o, d, time, keys, n, max_depth, bg_r, bg_g, bg_b,
                    book, rad, cnt, rec_f, rec_i, nullptr, stream);
}

// Its probe instance, launched like it, with probe: (ceil(n / 32),
// kProbeColumns) u64, zeroed, that receives each warp's row (ProbeColumn).
int izpi_diff_trace_fwd_probe(const float* prim_f, const int* prim_i, int n_prims,
                              const float* mat_f, const int* mat_i, const float* light_f,
                              const int* light_i, int n_lights, const int* nodes,
                              const float* bvh_prims, const float* c0, const float* c1,
                              int n_tex, const float* o, const float* d, const float* time,
                              const long long* keys, int n, int max_depth, float bg_r,
                              float bg_g, float bg_b, int book, float* rad, int* cnt,
                              float* rec_f, int* rec_i, unsigned long long* probe,
                              void* stream) {
  if (probe == nullptr) return (int)cudaErrorInvalidValue;
  return launch_fwd(prim_f, prim_i, n_prims, mat_f, mat_i, light_f, light_i, n_lights, nodes,
                    bvh_prims, c0, c1, n_tex, o, d, time, keys, n, max_depth, bg_r, bg_g, bg_b,
                    book, rad, cnt, rec_f, rec_i, probe, stream);
}

// The fused reverse over n paths on `stream`, in passes of n_pass paths
// (n a multiple of n_pass; pass s: paths [s·n_pass, (s+1)·n_pass)): the
// forward's records and ray counts, g_rad (n, 3) f32 the radiance's
// cotangent, c0, c1 as above. Writes out (n / n_pass, n_rows, 3) f32, each
// pass's gradient of the stacked [c0; c1] table's first n_rows rows
// (n_tex, or 2·n_tex where a texture is a checker): each record of the
// pass's paths its albedo cotangent added at its row in the 64-bit fixed
// point of fixed_point.cuh, whose exponent counts every record of the
// pass. scratch: izpi_diff_trace_bwd_scratch(n, n_pass, n_rows) bytes of
// device memory, not zeroed. Pass 1 keeps each record's cotangent and row
// for pass 2 in its place in rec_f, so the records are overwritten. Two
// launches. Returns a cudaError_t.
long long izpi_diff_trace_bwd_scratch(int n, int n_pass, int n_rows) {
  const long long passes = n / n_pass;
  const long long blocks = passes * izpi::diff::pass_blocks(n_pass);
  return 12LL * 3 * n_rows * passes + 8 * blocks + 4;
}

int izpi_diff_trace_bwd(float* rec_f, const int* rec_i, const int* cnt, const float* g_rad,
                        const float* c0, const float* c1, int n_tex, int n, int n_pass,
                        int max_depth, float bg_r, float bg_g, float bg_b, int n_rows,
                        void* scratch, float* out, void* stream) {
  if (n <= 0 || n_pass <= 0 || n % n_pass != 0 || max_depth <= 0 || n_rows <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  using namespace izpi::diff;
  const Tex tex{c0, c1, n_tex};
  const RevArgs ra{rec_f, rec_i, cnt, g_rad, n, n_pass, izpi::mk(bg_r, bg_g, bg_b)};
  const long long elems = 3LL * n_rows;
  const int blocks = (n / n_pass) * pass_blocks(n_pass);
  const GradScratch gs = grad_scratch(scratch, elems * (n / n_pass), blocks);
  cudaStream_t s = (cudaStream_t)stream;
  float4* kept = reinterpret_cast<float4*>(rec_f);
  diff_trace_bwd_stat<<<blocks, kRevThreads, 0, s>>>(tex, ra, gs, elems * (n / n_pass), kept);
  const int path = add_path(elems);
  if (path == kAddLane) {
    diff_trace_bwd_lane<<<blocks, kRevThreads, 0, s>>>(ra, gs, elems, kept, out);
  } else if (path == kAddBlock) {
    diff_trace_bwd_block<<<blocks, kRevThreads, 0, s>>>(ra, gs, elems, kept, out);
  } else {
    diff_trace_bwd_global<<<blocks, kRevThreads, 0, s>>>(ra, gs, elems, kept, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
