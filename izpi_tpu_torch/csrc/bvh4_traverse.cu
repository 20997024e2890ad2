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
// The traversal itself, a visit's slab test, leaf tests and near-first
// push, is bvh4_closest in bvh4.cuh, which the RGB megakernel's BVH form
// (megakernel_rgb.cu) runs inside its path loop; the plain version is
// izpi_tpu_torch/accel/traverse.py closest_bvh, node for node.
//
// Bound: per-thread issue and latency. A visit is ~220 instructions in the
// SASS (the node's loads, the 4-wide slab test and the sort; see
// sass_probes.cu), a triangle test ~80; the tables are read through L1/L2
// (Cornell's obj tree is 2.5 MB), so device memory is not the limit. Divergence between the rays of a warp (different stack depths and
// leaf counts) is the cost this first version accepts: no ray sorting, no
// persistent threads, no shared-memory tiles.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bvh4.cuh"

namespace izpi {

__global__ void __launch_bounds__(128)
    bvh4_traverse(const int* __restrict__ nodes, const float* __restrict__ prims,
                  const float* __restrict__ ray_o, const float* __restrict__ ray_d,
                  const float* __restrict__ ray_time, int n, float t_min, float t_max,
                  float* __restrict__ t_out, int* __restrict__ idx_out, int* __restrict__ counts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int visits = 0, tests = 0;
  float t_best;
  const int best = bvh4_closest(nodes, prims, ld3(ray_o + 3 * i), ld3(ray_d + 3 * i),
                                ray_time[i], t_min, t_max, t_best, visits, tests);
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
