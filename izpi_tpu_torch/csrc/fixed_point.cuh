// The 64-bit fixed point in which the training step's table gradients are
// summed: G's (table_grad.cu, the backward of every table gather) and the
// fused reverse's (diff_trace.cu izpi_diff_trace_bwd, the fused route's
// texture rows). One header, so that the two give the same bits.
//
// Addition of int64 is associative, so terms summed in any order, by any
// grouping of lanes, blocks and atomics, give the same bits. A sum of n
// terms whose largest finite |value| is m takes each value times 2^k, k the
// largest power that keeps the sum of n such values below 2^62 (exponent),
// rounded to an int64 alone (term). A NaN or an infinity sets a flag bit of
// its element instead, and the element comes back as an IEEE sum would give
// it (value). A row's sum is off by at most n²·m·2^-63 (the rounding of n
// terms at 2^-k), below 5e-10·m at 65,536 rays, where f32 summation is off
// by up to ~n·2^-24 of the row's absolute sum.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace izpi {
namespace fixed {

// A table of at most this many elements is summed in a block's copy in
// shared memory (32 KB of int64), each block then adding its non-zero
// elements once to device memory; a larger one in device memory.
constexpr int kSharedElems = 4096;

// Flag bits of an element that received a NaN, +Inf or -Inf.
constexpr unsigned kNaN = 1u, kPosInf = 2u, kNegInf = 4u;

// |x| where it counts towards the largest finite value, else 0: NaN and
// ±Inf are flags.
__device__ __forceinline__ float finite_abs(float x) {
  const float a = fabsf(x);
  return a <= 3.402823466e38f ? a : 0.0f;
}

// The fixed point's exponent k for n terms whose largest |value| has the
// bits `bits` (a non-negative float's bits order as unsigned integers, so
// atomicMax and max over them are order-free): m < 2^e, so each |q| <
// 2^(e + k) = 2^(62 - ceil(log2 n)).
__device__ __forceinline__ int exponent(unsigned bits, long long n) {
  const float m = __uint_as_float(bits);
  if (!(m > 0.0f)) return 0;
  int e = 0;
  frexpf(m, &e);
  const int lg = n <= 1 ? 0 : 64 - __clzll(n - 1);
  return 62 - e - lg;
}

// The terms' scale 2^k. k lies in [-129, 210] (e in [-148, 128], ceil(log2
// n) in [0, 63]), so 2^k and every x·2^k of a finite f32 x with |x| <= m
// are normal doubles, and x·2^k is exact: ldexp((double)x, k).
__device__ __forceinline__ double scale_of(int k) { return ldexp(1.0, k); }

// The rows that add: n, or the first *count of them where count is given.
__device__ __forceinline__ long long live_rows(long long n, const int* count) {
  if (count == nullptr) return n;
  const long long k = *count;
  return k < 0 ? 0 : (k < n ? k : n);
}

// A value's term at `scale`: round(x·2^k) to the nearest int64 (ties to
// even), or 0 and its flag bit in `flag` (else 0) where x is not finite.
__device__ __forceinline__ long long term(float x, double scale, unsigned& flag) {
  if (isfinite(x)) {
    flag = 0u;
    return __double2ll_rn((double)x * scale);
  }
  flag = isnan(x) ? kNaN : (x > 0.0f ? kPosInf : kNegInf);
  return 0;
}

// The warp's same-row sum and add: the terms q of the lanes in `peers`
// (the lanes of one element, from __match_any_sync) summed by shuffles, and
// the sum added to *at by the group's `leader` (its lowest lane) where it
// is not 0. Every lane of the warp calls it (at: any pointer where the lane
// is no leader).
__device__ __forceinline__ void warp_add(unsigned peers, bool leader, long long q,
                                         unsigned long long* at) {
  long long sum = 0;
  for (int src = 0; src < 32; ++src) {
    const long long v = __shfl_sync(0xffffffffu, q, src);
    if ((peers >> src) & 1u) sum += v;
  }
  if (leader && sum != 0) atomicAdd(at, (unsigned long long)sum);
}

// An element's f32 from its sum acc and its flags: acc·2^-k, or NaN (a NaN,
// or +Inf beside -Inf), or ±Inf.
__device__ __forceinline__ float value(unsigned long long acc, unsigned f, int k) {
  if ((f & kNaN) || (f & (kPosInf | kNegInf)) == (kPosInf | kNegInf)) return nanf("");
  if (f & kPosInf) return INFINITY;
  if (f & kNegInf) return -INFINITY;
  return (float)ldexp((double)(long long)acc, -k);
}

}  // namespace fixed
}  // namespace izpi
