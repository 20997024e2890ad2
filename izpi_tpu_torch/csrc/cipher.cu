// The cipher entry: Threefry-2x32 draws for the queue pool, the training
// step and the media, launched on their own.
//
// Replaces the uses of izpi_tpu/ops/threefry.py:30 (threefry2x32) that the
// JAX package makes outside its megakernels: core/rng.py's path keys
// (fold the sample id, then the flat pixel id; :40-51, :73-83) and bounce
// uniforms (fold the depth, then the salt, then uniforms_n), with the
// camera's and λ's draws of a new sample (camera.py:84-91,
// integrator/wavefront.py LAMBDA_SALT). Every form is bit-identical to
// izpi_tpu_torch/ops/threefry.py: the same device functions
// (threefry.cuh) the megakernels inline.
//
// Two forms, each a persistent grid (the SMs times the blocks of it that
// fit at once, asked once per device) that walks tiles of kTile keys:
// - bounce_tiles<N>: out[i, :] = the N uniforms for use `salt` at bounce
//   depths[i] of the path keyed keys[i]; N of 1, 5 and 12 unrolled, any
//   other count (the media's) at run time (N = 0);
// - new_sample_tiles: a new sample's path key from (base key, pixel id,
//   sample id), and, when asked, its camera's 5 uniforms and λ's one, λ's
//   key reusing the camera's first fold-in as draws.cuh's new_sample does.
//
// What bounds it on the H100: integer operations. A key costs two fold-ins
// and ceil(N/2) pairs, each 20 rounds of add, rotate and xor: ~80 INT32
// instructions a cipher call against ~4 + 4·N bytes of output, far above
// the card's ~2.5 operations a byte. So the design keeps the integer pipe
// fed and spends nothing else: each thread takes kKeysPerThread keys whose
// independent cipher chains ptxas interleaves (ILP for the serial fold-ins),
// the keys and depths are read as int64 straight from the caller's tensors
// (no conversion pass), and each tile's uniforms go through shared memory so
// that the stores to the row-major output are coalesced, 128 bytes a warp
// instruction, where one thread writing its row strides a warp's stores
// over 4·N·32 bytes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace izpi {

constexpr int kCipherThreads = 128;
constexpr int kKeysPerThread = 2;
constexpr int kTile = kCipherThreads * kKeysPerThread;  // keys a block takes at a time
// The run-time form's largest count: its tile (dynamic shared memory, kTile
// rows of the count) stays within the 48 KB a block gets without opting in.
constexpr int kMaxUniforms = 48;

// The uniform pair p of the classic layout of n uniforms under key (f0, f1):
// counters p and p + half give uniforms p and p + half (the latter dropped
// for odd n at p = half - 1).
__device__ __forceinline__ void pair_at(uint32_t f0, uint32_t f1, int p, int half,
                                        float& a, float& b) {
  uint32_t x0 = (uint32_t)p, x1 = (uint32_t)(p + half);
  threefry2x32(f0, f1, x0, x1);
  a = bits_to_uniform(x0);
  b = bits_to_uniform(x1);
}

// The tile's rows `n_rows` × `width` floats, staged row-major in `tile`,
// stored to out[row0 * width ...] with consecutive threads on consecutive
// words.
__device__ __forceinline__ void store_tile(const float* tile, int n_rows, int width,
                                           float* __restrict__ out, int64_t row0) {
  const int count = n_rows * width;
  float* dst = out + row0 * width;
  for (int j = threadIdx.x; j < count; j += kCipherThreads) dst[j] = tile[j];
}

// A tile of kTile rows of N floats in shared memory; N == 0: the dynamic
// shared memory the launch sized to the run-time count.
template <int N>
__device__ __forceinline__ float* tile_memory() {
  __shared__ float tile[kTile * N];
  return tile;
}
template <>
__device__ __forceinline__ float* tile_memory<0>() {
  extern __shared__ float dynamic_tile[];
  return dynamic_tile;
}

__device__ __forceinline__ int tile_rows(int64_t row0, int n) {
  const int64_t left = (int64_t)n - row0;
  return left < kTile ? (int)left : kTile;
}

// N > 0: N uniforms, unrolled; N == 0: n_u uniforms, counted at run time.
template <int N>
__global__ void __launch_bounds__(kCipherThreads)
    bounce_tiles(const int64_t* __restrict__ keys, const int64_t* __restrict__ depths,
                 int n, int n_u, uint32_t salt, float* __restrict__ out) {
  float* tile = tile_memory<N>();
  const int width = N > 0 ? N : n_u;
  const int half = (width + 1) / 2;
  for (int64_t row0 = (int64_t)blockIdx.x * kTile; row0 < n;
       row0 += (int64_t)gridDim.x * kTile) {
    const int rows = tile_rows(row0, n);
    uint32_t f0[kKeysPerThread], f1[kKeysPerThread];
#pragma unroll
    for (int k = 0; k < kKeysPerThread; ++k) {
      const int r = threadIdx.x + k * kCipherThreads;
      const int64_t i = row0 + (r < rows ? r : 0);
      bounce_key((uint32_t)keys[2 * i], (uint32_t)keys[2 * i + 1], (uint32_t)depths[i], salt,
                 f0[k], f1[k]);
    }
    if constexpr (N > 0) {
#pragma unroll
      for (int p = 0; p < (N + 1) / 2; ++p) {
#pragma unroll
        for (int k = 0; k < kKeysPerThread; ++k) {
          float* row = tile + (threadIdx.x + k * kCipherThreads) * N;
          float a, b;
          pair_at(f0[k], f1[k], p, (N + 1) / 2, a, b);
          row[p] = a;
          if (p + (N + 1) / 2 < N) row[p + (N + 1) / 2] = b;
        }
      }
    } else {
      for (int p = 0; p < half; ++p) {
#pragma unroll
        for (int k = 0; k < kKeysPerThread; ++k) {
          float* row = tile + (threadIdx.x + k * kCipherThreads) * width;
          float a, b;
          pair_at(f0[k], f1[k], p, half, a, b);
          row[p] = a;
          if (p + half < width) row[p + half] = b;
        }
      }
    }
    __syncthreads();
    store_tile(tile, rows, width, out, row0);
    __syncthreads();
  }
}

// A new sample's draws: keys_out[i] = fold_in(fold_in(base, sample), pixel)
// as two int64 words; with kCamera the camera's uniforms_n<5> under
// fold_in(fold_in(key, 0), cam_salt); with kLambda λ's uniforms_n<1> under
// fold_in(fold_in(key, 0), lam_salt). sample == null: every sample id is
// sample_const.
template <bool kCamera, bool kLambda>
__global__ void __launch_bounds__(kCipherThreads)
    new_sample_tiles(const int64_t* __restrict__ base, const int64_t* __restrict__ pixel,
                     const int64_t* __restrict__ sample, uint32_t sample_const, int n,
                     uint32_t cam_salt, uint32_t lam_salt, int64_t* __restrict__ keys_out,
                     float* __restrict__ cam_out, float* __restrict__ lam_out) {
  float* tile = tile_memory<kCamera ? 5 : 1>();
  const uint32_t s0 = (uint32_t)base[0], s1 = (uint32_t)base[1];
  for (int64_t row0 = (int64_t)blockIdx.x * kTile; row0 < n;
       row0 += (int64_t)gridDim.x * kTile) {
    const int rows = tile_rows(row0, n);
    uint32_t k0[kKeysPerThread], k1[kKeysPerThread];
#pragma unroll
    for (int k = 0; k < kKeysPerThread; ++k) {
      const int r = threadIdx.x + k * kCipherThreads;
      const int64_t i = row0 + (r < rows ? r : 0);
      uint32_t a0, a1;
      fold_in(s0, s1, sample ? (uint32_t)sample[i] : sample_const, a0, a1);
      fold_in(a0, a1, (uint32_t)pixel[i], k0[k], k1[k]);
      if (r < rows) {
        longlong2 w;
        w.x = (long long)k0[k];
        w.y = (long long)k1[k];
        reinterpret_cast<longlong2*>(keys_out)[i] = w;
      }
    }
    if constexpr (kCamera || kLambda) {
#pragma unroll
      for (int k = 0; k < kKeysPerThread; ++k) {
        const int r = threadIdx.x + k * kCipherThreads;
        uint32_t z0, z1;
        fold_in(k0[k], k1[k], 0u, z0, z1);  // the depth-0 fold both draws share
        if constexpr (kCamera) {
          uint32_t c0, c1;
          fold_in(z0, z1, cam_salt, c0, c1);
          float* row = tile + r * 5;
          pair_at(c0, c1, 0, 3, row[0], row[3]);
          pair_at(c0, c1, 1, 3, row[1], row[4]);
          float pad;
          pair_at(c0, c1, 2, 3, row[2], pad);
        }
        if constexpr (kLambda) {
          uint32_t l0, l1;
          fold_in(z0, z1, lam_salt, l0, l1);
          float u, pad;
          pair_at(l0, l1, 0, 1, u, pad);
          if (r < rows) lam_out[row0 + r] = u;
        }
      }
    }
    if constexpr (kCamera) {
      __syncthreads();
      store_tile(tile, rows, 5, cam_out, row0);
      __syncthreads();
    }
  }
}

// The persistent grid of `kernel` (with `smem` bytes of dynamic shared
// memory) on the current device for n keys: the SMs times its resident
// blocks, no more than the tiles. The occupancy is asked once per slot (a
// kernel and its shared memory) and device, and cached, so a call inside a
// CUDA graph capture makes no query the capture refuses.
constexpr int kSlots = 8 + kMaxUniforms + 1;  // the fixed forms, then the run-time counts

template <class K>
__host__ int cipher_blocks(K kernel, int slot, size_t smem, int n, int* blocks) {
  constexpr int kKinds = kSlots, kDevices = 64;
  static int cached[kKinds][kDevices];  // resident blocks on the device, 0: not asked
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kDevices) return (int)cudaErrorInvalidDevice;
  if (cached[slot][dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kCipherThreads, smem);
    if (err != cudaSuccess) return (int)err;
    cached[slot][dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int tiles = (n + kTile - 1) / kTile;
  *blocks = tiles < cached[slot][dev] ? tiles : cached[slot][dev];
  return (int)cudaSuccess;
}

}  // namespace izpi

extern "C" {

// out[i, :] = the n_uniforms (1..48) uniforms for use `salt` at bounce
// depths[i] of the path keyed keys[i]: keys (n, 2) and depths (n,) int64
// words, out (n, n_uniforms) f32. Returns a cudaError_t.
int izpi_threefry_uniforms(const int64_t* keys, const int64_t* depths, int n,
                           int n_uniforms, uint32_t salt, float* out, void* stream) {
  if (n_uniforms < 1 || n_uniforms > izpi::kMaxUniforms || n < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  int blocks = 0, err = 0;
#define IZPI_BOUNCE(N, SLOT, SMEM)                                                        \
  err = izpi::cipher_blocks(izpi::bounce_tiles<N>, SLOT, SMEM, n, &blocks);               \
  if (err != 0) return err;                                                               \
  izpi::bounce_tiles<N><<<blocks, izpi::kCipherThreads, SMEM, s>>>(keys, depths, n,       \
                                                                   n_uniforms, salt, out);
  if (n_uniforms == 12) {
    IZPI_BOUNCE(12, 0, 0)
  } else if (n_uniforms == 5) {
    IZPI_BOUNCE(5, 1, 0)
  } else if (n_uniforms == 1) {
    IZPI_BOUNCE(1, 2, 0)
  } else {
    const size_t smem = sizeof(float) * izpi::kTile * n_uniforms;
    IZPI_BOUNCE(0, 8 + n_uniforms, smem)
  }
#undef IZPI_BOUNCE
  return (int)cudaGetLastError();
}

// A new sample's draws for n (pixel, sample) pairs under the base key
// base[0..1] (int64 words in device memory): keys_out (n, 2) int64 words;
// cam_out (n, 5) f32 or null; lam_out (n,) f32 or null (only with
// cam_out). sample: (n,) int64 ids, or null for sample_const. Returns a
// cudaError_t.
int izpi_threefry_new_sample(const int64_t* base, const int64_t* pixel, const int64_t* sample,
                             uint32_t sample_const, int n, uint32_t cam_salt,
                             uint32_t lam_salt, int64_t* keys_out, float* cam_out,
                             float* lam_out, void* stream) {
  if (n < 0 || (lam_out && !cam_out)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  int blocks = 0, err = 0;
#define IZPI_NEW(CAM, LAM, SLOT)                                                          \
  err = izpi::cipher_blocks(izpi::new_sample_tiles<CAM, LAM>, SLOT, 0, n, &blocks);       \
  if (err != 0) return err;                                                               \
  izpi::new_sample_tiles<CAM, LAM><<<blocks, izpi::kCipherThreads, 0, s>>>(               \
      base, pixel, sample, sample_const, n, cam_salt, lam_salt, keys_out, cam_out, lam_out);
  if (lam_out) {
    IZPI_NEW(true, true, 4)
  } else if (cam_out) {
    IZPI_NEW(true, false, 5)
  } else {
    IZPI_NEW(false, false, 6)
  }
#undef IZPI_NEW
  return (int)cudaGetLastError();
}

}  // extern "C"
