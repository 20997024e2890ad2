// The backward of the training step's table gathers: the cotangents of
// gathered rows scatter-added into their table, deterministically.
//
// Replaces no Pallas kernel. On the TPU the backward of the JAX package's
// gathers from the trainable tables (jnp indexing of the tables
// `inject_params` puts in the scene, differentiated by the jitted
// `jax.value_and_grad` of izpi_tpu/parallel/dist.py:597-643) is XLA's
// scatter-add. In the port it is the backward of ops/table_grad.py's
// `TableGather`; PyTorch's own (index_put_ with accumulate: a sort by row
// and a segment sum) took most of the eager step's device time.
//
// out[rows[i], :] += g[i, :] for i < n: out (r, c) f32, g (n, c) f32, rows
// (n,) int64 in [0, r). Where a count is given (device memory), only its
// first *count rows add: a producer that knows how many rows it wrote only
// on the device hands over its buffer and that count, and the host reads
// neither. The fused route's reverse (diff_trace.cu) sums its records'
// cotangents itself, in the same fixed point, and calls G no time.
//
// What bounds it on the H100: bytes (a row id and c cotangents read a
// gathered row, c floats written a table row), a few µs at the step's
// 65,536 rays; what costs in practice is conflicts, since every ray that
// hits a wall adds into the same few rows. Float atomics serialise those
// and sum in an order that changes from run to run. So the sums are taken
// in the 64-bit fixed point of fixed_point.cuh, where every order gives the
// same bits (the fused route's reverse, diff_trace.cu, sums in it too):
// 1. table_grad_absmax: the largest finite |g| (atomicMax on its bits;
//    order-free);
// 2. table_grad_scatter: each value's term (fixed::term). The lanes of a
//    warp that share a row (__match_any_sync) sum theirs by shuffles, and
//    the lowest of them adds the sum with one integer atomic
//    (fixed::warp_add): into the block's copy of the table in shared
//    memory when the table holds at most kSharedElems elements (materials,
//    texture rows, small SPD tables: the conflicts stay on the SM, and each
//    block then adds its non-zero elements once to device memory), else
//    straight into device memory (an image stack, whose texels see few
//    conflicts). A NaN or an infinity sets a flag bit of its element;
// 3. table_grad_finalize: each element back to f32 (fixed::value).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fixed_point.cuh"

namespace izpi {

constexpr int kGradThreads = 256;
using fixed::kSharedElems;
constexpr int kMaxGradBlocks = 1056; // 8 blocks on each of 132 SMs
constexpr int kSharedBatches = 4;    // 32-ray batches a warp, shared path
constexpr unsigned kFull = 0xffffffffu;

__global__ void table_grad_absmax(const float* __restrict__ g, long long n, int c,
                                  const int* __restrict__ rows_count,
                                  unsigned* __restrict__ stat) {
  __shared__ float warp_max[kGradThreads / 32];
  const long long count = fixed::live_rows(n, rows_count) * c;
  float m = 0.0f;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += (long long)gridDim.x * blockDim.x) {
    m = fmaxf(m, fixed::finite_abs(g[i]));
  }
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kGradThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    if (m > 0.0f) atomicMax(stat, __float_as_uint(m));
  }
}

// One warp's 32 rays from `first`: their terms summed over the lanes that
// share a row, added by the lowest such lane to acc[row * c + col] (shared
// or device memory: the caller's `acc`).
__device__ __forceinline__ void scatter_batch(const long long* __restrict__ rows,
                                              const float* __restrict__ g, long long n,
                                              int c, double scale, long long first,
                                              unsigned long long* acc,
                                              unsigned* __restrict__ flags) {
  const int lane = threadIdx.x & 31;
  const long long i = first + lane;
  const bool live = i < n;
  const long long row = live ? rows[i] : -1;
  const unsigned peers = __match_any_sync(kFull, row);
  const bool leader = live && __ffs(peers) - 1 == lane;
  for (int col = 0; col < c; ++col) {
    unsigned flag = 0u;
    const long long q = fixed::term(live ? g[i * c + col] : 0.0f, scale, flag);
    if (flag != 0u) atomicOr(flags + row * c + col, flag);
    fixed::warp_add(peers, leader, q, leader ? acc + row * c + col : acc);
  }
}

__global__ void table_grad_scatter(const long long* __restrict__ rows,
                                   const float* __restrict__ g, long long n,
                                   const int* __restrict__ count, int c,
                                   const unsigned* __restrict__ stat,
                                   unsigned long long* __restrict__ acc,
                                   unsigned* __restrict__ flags) {
  n = fixed::live_rows(n, count);
  const double scale = fixed::scale_of(fixed::exponent(*stat, n));
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long first = warp * 32; first < n; first += warps * 32) {
    scatter_batch(rows, g, n, c, scale, first, acc, flags);
  }
}

__global__ void table_grad_scatter_shared(const long long* __restrict__ rows,
                                          const float* __restrict__ g, long long n,
                                          const int* __restrict__ count, int c,
                                          long long elems,
                                          const unsigned* __restrict__ stat,
                                          unsigned long long* __restrict__ acc,
                                          unsigned* __restrict__ flags) {
  __shared__ unsigned long long part[kSharedElems];
  for (long long e = threadIdx.x; e < elems; e += blockDim.x) part[e] = 0ull;
  __syncthreads();
  n = fixed::live_rows(n, count);
  const double scale = fixed::scale_of(fixed::exponent(*stat, n));
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long first = warp * 32; first < n; first += warps * 32) {
    scatter_batch(rows, g, n, c, scale, first, part, flags);
  }
  __syncthreads();
  for (long long e = threadIdx.x; e < elems; e += blockDim.x) {
    const unsigned long long v = part[e];
    if (v != 0ull) atomicAdd(acc + e, v);
  }
}

__global__ void table_grad_finalize(const unsigned long long* __restrict__ acc,
                                    const unsigned* __restrict__ flags,
                                    const unsigned* __restrict__ stat, long long n,
                                    const int* __restrict__ count, long long elems,
                                    float* __restrict__ out) {
  const int k = fixed::exponent(*stat, fixed::live_rows(n, count));
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < elems;
       e += (long long)gridDim.x * blockDim.x) {
    out[e] = fixed::value(acc[e], flags[e], k);
  }
}

inline int grad_blocks(long long work, long long per_block) {
  const long long b = (work + per_block - 1) / per_block;
  return (int)(b < 1 ? 1 : (b > kMaxGradBlocks ? kMaxGradBlocks : b));
}

}  // namespace izpi

extern "C" {

// The table gradient out (r, c) f32 of n gathered rows: out[rows[i], :] +=
// g[i, :], for i < *count where count (one int in device memory) is not
// null. scratch: zero-filled device memory of izpi_table_grad_scratch
// bytes (the int64 sums, the flags and the largest |g|). The grid is sized
// for n rows. Returns a cudaError_t.
long long izpi_table_grad_scratch(long long r, int c) {
  const long long elems = r * c;
  return 8 * elems + 4 * elems + 4;
}

int izpi_table_grad(const long long* rows, const float* g, long long n, const int* count, int c,
                    long long r, void* scratch, float* out, void* stream) {
  if (n < 0 || c < 1 || r < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long elems = r * c;
  unsigned long long* acc = (unsigned long long*)scratch;
  unsigned* flags = (unsigned*)(acc + elems);
  unsigned* stat = flags + elems;
  using namespace izpi;
  table_grad_absmax<<<grad_blocks(n * c, kGradThreads), kGradThreads, 0, s>>>(g, n, c, count,
                                                                             stat);
  if (elems <= kSharedElems) {
    table_grad_scatter_shared<<<grad_blocks(n, kGradThreads * kSharedBatches), kGradThreads, 0,
                                s>>>(rows, g, n, count, c, elems, stat, acc, flags);
  } else {
    table_grad_scatter<<<grad_blocks(n, kGradThreads), kGradThreads, 0, s>>>(
        rows, g, n, count, c, stat, acc, flags);
  }
  table_grad_finalize<<<grad_blocks(elems, kGradThreads), kGradThreads, 0, s>>>(
      acc, flags, stat, n, count, elems, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
