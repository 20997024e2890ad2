// Closest hit through a BVH4: one thread per ray, a 64-entry stack per thread.
//
// Replaces izpi_tpu/ops/bvh_kernel.py:133 (_traverse_kernel, launched by
// build_traverse_fn :429-451), the Pallas union traversal. What it computes is
// that kernel's function: per ray the closest hit (t, primitive index) in
// [t_min, t_max] against a BVH4 over the primitives reordered by its build,
// -1 on a miss. What it does not carry over is how the TPU kernel gets
// there: a tile of 1024 rays sharing one stack, ray sorting, treelets,
// leaf-16 blocks sized for a DMA. A GPU thread keeps its own stack, so each
// ray visits only the nodes its own slab tests let through.
//
// A visit pops one node, slab-tests its four children against the ray's
// shrinking best t (the reference's tMax shrink, bvh4.go:130), tests the
// primitives of the leaf children it hits in slot order with the
// megakernels' primitive test (common.cuh prim_test; a strict < keeps the
// earlier primitive on a tie), then pushes the internal children it hits,
// ordered by entry distance with the sorting network of
// bvh_kernel.py:395-408 so that the nearest is popped next. A zero direction
// component divides as 1e-30 (bvh_kernel.py:168). The plain version,
// izpi_tpu_torch/accel/traverse.py closest_bvh, does the same operations on
// the same nodes, so both give the same (t, index) and visit counts; the
// build keeps IEEE rounding (-fmad=false) for that.
//
// Tables (izpi_tpu_torch/ops/bvh_kernel.py pack_tables):
//   nodes (Nn, 32) 4-byte words: bounds [minx×4 miny×4 minz×4 maxx×4 maxy×4
//         maxz×4] as f32 | child[4] | count[4] as i32 (bvh_build.py:10-14);
//   prims (P, 16) f32: g0 g1 g2 g3 | kind as i32 bits | pad (3).
//
// Bound: per-thread issue and latency. A visit is ~110 FP32 operations (the
// 4-wide slab test and the sort), a triangle test ~58; the tables are read
// through L1/L2 (Cornell's obj tree is 2.5 MB), so device memory is not the
// limit. Divergence between the rays of a warp (different stack depths and
// leaf counts) is the cost this first version accepts: no ray sorting, no
// persistent threads, no shared-memory tiles.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace izpi {

constexpr int kStack = 64;     // accel/traverse.py STACK_DEPTH, checked at build
constexpr int kNodeWords = 32;
constexpr int kPrimWords = 16;
constexpr float kInvEps = 1e-30f;

__device__ __forceinline__ void cmp_exchange(float* key, int* ch, bool* push, int a, int b) {
  if (key[a] < key[b]) {
    const float k = key[a];
    key[a] = key[b];
    key[b] = k;
    const int c = ch[a];
    ch[a] = ch[b];
    ch[b] = c;
    const bool p = push[a];
    push[a] = push[b];
    push[b] = p;
  }
}

__global__ void __launch_bounds__(128)
    bvh4_traverse(const int* __restrict__ nodes, const float* __restrict__ prims,
                  const float* __restrict__ ray_o, const float* __restrict__ ray_d,
                  const float* __restrict__ ray_time, int n, float t_min, float t_max,
                  float* __restrict__ t_out, int* __restrict__ idx_out, int* __restrict__ counts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const V3 o = ld3(ray_o + 3 * i);
  const V3 d = ld3(ray_d + 3 * i);
  const float tme = ray_time[i];
  const float od[3] = {o.x, o.y, o.z};
  const float inv[3] = {1.0f / (d.x == 0.0f ? kInvEps : d.x), 1.0f / (d.y == 0.0f ? kInvEps : d.y),
                        1.0f / (d.z == 0.0f ? kInvEps : d.z)};

  float t_best = t_max;
  int best = -1;
  int visits = 0, tests = 0;
  int stack[kStack];
  int sp = 0;
  stack[sp++] = 0;
  while (sp > 0) {
    const int node = stack[--sp];
    ++visits;
    const float4* nb = reinterpret_cast<const float4*>(nodes + (size_t)node * kNodeWords);
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
    int ch[4] = {c4.x, c4.y, c4.z, c4.w};
    const int cnt[4] = {n4.x, n4.y, n4.z, n4.w};

    // 4-wide slab test against the best t at the pop (traverse.slab_test_4).
    float key[4];
    bool hit[4];
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
      key[s] = tn;
      hit[s] = tf > tn && cnt[s] != -1;
    }

    // Leaf children, in slot order: their contiguous primitives.
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (!(hit[s] && cnt[s] > 0)) continue;
      for (int k = 0; k < cnt[s]; ++k) {
        const int p = ch[s] + k;
        const float* g = prims + (size_t)p * kPrimWords;
        float t;
        const bool ok = prim_test(g, __float_as_int(__ldg(g + 12)), o, d, tme, t_min, t_best, t);
        ++tests;
        if (ok && t < t_best) {
          t_best = t;
          best = p;
        }
      }
    }

    // Internal children: sort by entry distance, farthest pushed first.
    bool push[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) push[s] = hit[s] && cnt[s] == 0;
    cmp_exchange(key, ch, push, 0, 1);
    cmp_exchange(key, ch, push, 2, 3);
    cmp_exchange(key, ch, push, 0, 2);
    cmp_exchange(key, ch, push, 1, 3);
    cmp_exchange(key, ch, push, 1, 2);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      // The build checks the worst-case stack against kStack, so the guard
      // never drops a node.
      if (push[s] && sp < kStack) stack[sp++] = ch[s];
    }
  }
  t_out[i] = t_best;
  idx_out[i] = best;
  if (counts != nullptr) {
    counts[2 * i] = visits;
    counts[2 * i + 1] = tests;
  }
}

}  // namespace izpi

extern "C" {

// Launches the traversal of n rays on `stream`; returns cudaGetLastError().
// o, d: (n, 3) f32; time: (n,) f32; t: (n,) f32 and idx: (n,) i32 outputs;
// counts: null, or (n, 2) i32 for per-ray (nodes popped, primitives tested).
// t_max must be clamped to T_MAX by the caller.
int izpi_bvh4_traverse(const int* nodes, const float* prims, const float* o, const float* d,
                       const float* time, int n, float t_min, float t_max, float* t, int* idx,
                       int* counts, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  izpi::bvh4_traverse<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      nodes, prims, o, d, time, n, t_min, t_max, t, idx, counts);
  return (int)cudaGetLastError();
}

}  // extern "C"
