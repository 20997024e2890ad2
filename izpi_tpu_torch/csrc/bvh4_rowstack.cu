// Closest hit through a leaf-64 BVH4: one warp per row of 32 rays, one stack
// per warp, leaf blocks tested from shared memory.
//
// Replaces izpi_tpu/ops/bvh_rowkernel.py:126 (_row_kernel, launched by
// build_traverse_fn :396-463), the Pallas kernel that gives each 128-ray row
// of a TPU tile its own exact stack. What it computes is that kernel's
// function: per ray the closest hit in [t_min, t_max] and its block slot
// (block id · 64 + position in the block), -1 on a miss. On the GPU a row is
// a warp of 32 consecutive rays (the caller sorts them by a coherence key):
//   - a node step pops one node from the warp's stack (shared memory; every
//     lane reads the same entry). Every lane slab-tests the node's four
//     children against its own best t (the reference's tMax shrink,
//     bvh4.go:130); a child is visited when __any_sync says some lane hits
//     it;
//   - a visited leaf is tested at once, in slot order: the warp copies the
//     block's primitives (16 floats each, 4 KB for a full block) from global
//     into shared memory with coalesced 16-byte loads, then every lane tests
//     every primitive with the megakernels' primitive test (common.cuh
//     prim_test; a strict < keeps the earlier primitive on a tie);
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
// the same rows node for node, so both give the same (t, slot) and the same
// per-warp counters; the build keeps IEEE rounding (-fmad=false) for that.
//
// Tables (izpi_tpu_torch/ops/bvh_rowkernel.py pack_scene):
//   nodes  (Nn, 32) 4-byte words: bounds [minx×4 miny×4 minz×4 maxx×4 maxy×4
//          maxz×4] as f32 | child[4] | count[4] as i32; a leaf's child is its
//          block id;
//   blocks (Nb, 64, 16) f32: g0 g1 g2 g3 | kind | 3 words the kernel does not
//          read.
//
// Bound: a warp's node step is ~100 FP32 operations per lane and a leaf
// ~58 per primitive per lane; every lane tests every primitive of a visited
// block, so the union's extra work, not bytes, is what this design pays for
// a warp-wide stack and coalesced leaf loads. No cp.async/TMA, leaf batching
// or occupancy tuning yet.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace izpi {

constexpr int kRowStack = 64;         // ops/bvh_rowkernel.py KSTACK, checked at attach
constexpr int kLeafPrims = 64;        // ops/bvh_rowkernel.py LEAF_SIZE
constexpr int kBlockWords = 16;
constexpr int kRowNodeWords = 32;
constexpr int kWarpsPerBlock = 4;
constexpr int kLeafVec4 = kLeafPrims * kBlockWords / 4;
constexpr float kRowInvEps = 1e-30f;  // a zero direction component (bvh_rowkernel.py:156)
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    bvh4_rowstack(const int* __restrict__ nodes, const float4* __restrict__ blocks,
                  const float* __restrict__ ray_o, const float* __restrict__ ray_d,
                  const float* __restrict__ ray_time, int n, float t_min, float t_max,
                  float* __restrict__ t_out, int* __restrict__ idx_out,
                  int* __restrict__ counters) {
  __shared__ int s_stack[kWarpsPerBlock][kRowStack];
  __shared__ float4 s_leaf[kWarpsPerBlock][kLeafVec4];
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
  float4* leaf = s_leaf[wib];
  const float* leaf_f = reinterpret_cast<const float*>(leaf);
  int sp = 1;  // warp-uniform
  if (lane == 0) stack[0] = 0;
  __syncwarp();
  int pops = 0, leaves = 0, tests = 0;

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

    // 4-wide slab test against this lane's best t at the pop, then the vote.
    bool visit[4];
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
      visit[s] = __any_sync(kFullMask, live && tf > tn && cnt[s] != -1) != 0;
    }

    // Visited leaves, in slot order: one block each, through shared memory.
    for (int s = 0; s < 4; ++s) {
      if (!(visit[s] && cnt[s] > 0)) continue;
      const int blk = ch[s];
      const int count = cnt[s];
      const float4* src = blocks + (size_t)blk * kLeafVec4;
      __syncwarp();  // every lane is done with the previous block
      for (int q = lane; q < count * (kBlockWords / 4); q += 32) leaf[q] = __ldg(src + q);
      __syncwarp();
      ++leaves;
      tests += count;
      for (int k = 0; k < count; ++k) {
        const float* g = leaf_f + k * kBlockWords;
        float t;
        const bool ok = prim_test(g, (int)g[12], o, d, tme, t_min, t_best, t);
        if (ok && t < t_best) {
          t_best = t;
          best = blk * kLeafPrims + k;
        }
      }
    }

    // Visited internal children, slot 3 first. Every lane has read the popped
    // entry before lane 0 overwrites it.
    __syncwarp();
#pragma unroll
    for (int s = 3; s >= 0; --s) {
      // The attach checks the worst-case stack against kRowStack, so the
      // guard never drops a node.
      if (visit[s] && cnt[s] == 0 && sp < kRowStack) {
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
    counters[3 * warp + 2] = tests;
  }
}

}  // namespace izpi

extern "C" {

// Launches the row-stack traversal of n rays on `stream`; returns
// cudaGetLastError(). o, d: (n, 3) f32; time: (n,) f32; t: (n,) f32 and idx:
// (n,) i32 (block slots) outputs; counters: null, or (ceil(n/32), 3) i32 for
// per-warp (nodes popped, leaf blocks tested, primitives tested per lane).
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
