"""The two traversal kernels, run on the CPU as host C++.

`csrc/bvh4_rowstack.cu` (one warp per row, each leaf tested one primitive
per lane against the rays that hit its box, leaves copied by cp.async) and
`csrc/bvh4_traverse.cu` (one thread per ray) are compiled with g++ behind
stand-ins for CUDA: `threadIdx` and `blockIdx` as thread-locals,
`__shared__` as statics, `atomicAdd` as `__atomic_fetch_add`, the copy
macros as a plain copy, and one `std::thread` per lane, with a
`std::barrier` of 32 per warp behind `__syncwarp`, `__ballot_sync`,
`__shfl_sync` and `__reduce_min_sync` and one of the block behind
`__syncthreads`. Each source is cut before its C entries (the `<<<...>>>`
launches). Fed the tables of `ops.bvh_rowkernel.attach` and
`ops.bvh_kernel.attach` for a Cornell box with a 2,000-triangle blob, and
1,024 camera, incoherent, parked and NaN rays, each kernel returns its
plain version's (t, index) and counters bit for bit:
`bvh_rowkernel.closest_rows`' per-warp counters and
`accel.traverse.closest_bvh`'s per-ray (nodes popped, primitives tested).
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from izpi_tpu_torch import camera
from izpi_tpu_torch.accel import traverse
from izpi_tpu_torch.geometry import primitives, procedural
from izpi_tpu_torch.integrator import path
from izpi_tpu_torch.ops import _build, bvh_kernel, bvh_rowkernel
from izpi_tpu_torch.scene import compiler
from izpi_tpu_torch.scene import types as st
from izpi_tpu_torch.scene.library.cornell import cornell_box

# The CUDA names the two kernels and common.cuh use, for the host.
STAND_IN = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <math.h>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(...)

struct float4 { float x, y, z, w; };
struct int4 { int x, y, z, w; };
struct dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int*) { return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int*, cudaDeviceAttr, int) { return cudaSuccess; }
template <class K>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int*, K, int, size_t) {
  return cudaSuccess;
}

template <class T> inline T __ldg(const T* p) { return *p; }
inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __ffs(unsigned v) { return __builtin_ffs((int)v); }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }

// A warp: 32 lanes as threads. A collective writes the lane's word into one
// of two slot rows (alternating, so that one barrier separates a row's
// writes from its next writes), waits for the warp, then reads the row.
struct Warp {
  std::barrier<> bar{32};
  uint32_t slot[2][32];
};
inline thread_local Warp* tl_warp;
inline thread_local int tl_lane, tl_row;
inline thread_local std::barrier<>* tl_block;

inline const uint32_t* exchange(uint32_t v) {
  Warp& w = *tl_warp;
  const int row = tl_row;
  tl_row ^= 1;
  w.slot[row][tl_lane] = v;
  w.bar.arrive_and_wait();
  return w.slot[row];
}
inline void __syncwarp(unsigned = 0xffffffffu) { tl_warp->bar.arrive_and_wait(); }
inline void __syncthreads() { tl_block->arrive_and_wait(); }
inline unsigned __ballot_sync(unsigned, int pred) {
  const uint32_t* s = exchange(pred != 0);
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= s[i] ? 1u << i : 0u;
  return m;
}
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  const uint32_t* s = exchange(v);
  unsigned m = s[0];
  for (int i = 1; i < 32; ++i) m = s[i] < m ? s[i] : m;
  return m;
}
inline int __shfl_sync(unsigned, int v, int src) {
  return (int)exchange((uint32_t)v)[src];
}
inline float __shfl_sync(unsigned, float v, int src) {
  return __uint_as_float(exchange(__float_as_uint(v))[src]);
}
"""

# Blocks one after another (their __shared__ statics are shared), the lanes
# of a block all at once; the copy macros of bvh4_rowstack.cu as a plain copy
# (the __syncwarp after each wait stands for the wait).
GRID = r"""
#include <memory>
#include <thread>
#include <vector>

#define IZPI_CP_ASYNC_16(dst, src) std::memcpy((dst), (src), 16)
#define IZPI_CP_ASYNC_COMMIT() ((void)0)
#define IZPI_CP_ASYNC_WAIT(n) ((void)0)

#include "kernel_cut.cu"

template <class F>
static void run_grid(int blocks, int threads, F body) {
  blockDim.x = threads;
  gridDim.x = blocks;
  for (int b = 0; b < blocks; ++b) {
    std::barrier<> block_bar(threads);
    std::unique_ptr<Warp[]> warps(new Warp[threads / 32]);
    std::vector<std::thread> lanes;
    for (int t = 0; t < threads; ++t) {
      lanes.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = b;
        tl_warp = &warps[t / 32];
        tl_lane = t & 31;
        tl_row = 0;
        tl_block = &block_bar;
        body();
      });
    }
    for (auto& l : lanes) l.join();
  }
}
"""

ENTRIES = {
    "bvh4_traverse.cu": r"""
extern "C" void run(const int* nodes, const float* prims, const float* o, const float* d,
                    const float* time, int n, float t_min, float t_max, float* t, int* idx,
                    int* counts) {
  run_grid((n + 127) / 128, 128, [&] {
    izpi::bvh4_traverse(nodes, prims, o, d, time, n, t_min, t_max, t, idx, counts);
  });
}
""",
    "bvh4_rowstack.cu": r"""
extern "C" void run(const int* nodes, const float* blocks, const float* o, const float* d,
                    const float* time, int n, float t_min, float t_max, float* t, int* idx,
                    int* counters) {
  const int grid = ((n + 31) / 32 + izpi::kWarpsPerBlock - 1) / izpi::kWarpsPerBlock;
  run_grid(grid, 32 * izpi::kWarpsPerBlock, [&] {
    izpi::bvh4_rowstack(nodes, reinterpret_cast<const float4*>(blocks), o, d, time, n, t_min,
                        t_max, t, idx, counters);
  });
}
""",
}


def _cut(name: str) -> str:
    """A kernel source up to its C entries."""
    text = (_build.CSRC / name).read_text()
    return text[:text.index('extern "C" {')]


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """{source: its host build, a ctypes library with one entry `run`}."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernels as host C++")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    argtypes = {"bvh4_traverse.cu": [p, p, p, p, p, i, f, f, p, p, p],
                "bvh4_rowstack.cu": [p, p, p, p, p, i, f, f, p, p, p]}
    libs = {}
    for name, entry in ENTRIES.items():
        tmp = tmp_path_factory.mktemp(name.split(".")[0])
        (tmp / "cuda_runtime.h").write_text(STAND_IN)
        (tmp / "kernel_cut.cu").write_text(_cut(name))
        (tmp / "runner.cpp").write_text(GRID + entry)
        so = tmp / "libhost.so"
        subprocess.run(["g++", "-O1", "-std=c++20", "-ffp-contract=off",
                        "-shared", "-fPIC", "-pthread", f"-I{tmp}",
                        f"-I{_build.CSRC}", "-o", str(so),
                        str(tmp / "runner.cpp")], check=True)
        libs[name] = ctypes.CDLL(str(so))
        libs[name].run.argtypes = argtypes[name]
    return libs


def _blob_box():
    """The Cornell box with a 2,000-triangle bumpy blob where
    cornell_box_obj puts its mesh, compiled on the CPU."""
    scene = cornell_box()
    tris = procedural.transform_mesh(procedural.bumpy_blob(2000), scale=60.0,
                                     translate=(280.0, 90.0, 390.0))
    scene.world.append(st.TriangleMesh(vertices=tris, material=st.Lambertian(
        albedo=st.ConstantTexture((0.7, 0.7, 0.85)))))
    cs, _ = compiler.compile_scene(scene, "cpu")
    return cs


@pytest.fixture(scope="module")
def scene():
    return _blob_box()


def _rays(cs, n: int, seed: int):
    """n rays: n/2 camera rays, then rays from their hit points in random
    directions (some with a zero component), 16 of them parked outside the
    scene as the pool parks dead slots, and 3 with a NaN."""
    rs = np.random.RandomState(seed)
    half = n // 2
    u = torch.as_tensor(rs.rand(half, 5).astype(np.float32))
    o, d, tme = camera.get_rays(cs.camera, u[:, 0], u[:, 1], u[:, 2:5])
    t, idx = primitives.closest_brute(cs.prims, o, d, tme, path.T_MIN,
                                      primitives.T_MAX)
    start = torch.where((idx >= 0)[:, None], o + t[:, None] * d, o)
    d2 = torch.as_tensor(rs.randn(n - half, 3).astype(np.float32))
    d2[:32, 0] = 0.0
    d2[32:64, 1] = 0.0
    o, d = torch.cat([o, start]), torch.cat([d, d2])
    tme = torch.cat([tme, tme[: n - half]])
    park = torch.as_tensor(rs.choice(n, 16, replace=False))
    o[park] = path.PARK
    d[rs.choice(n, 3, replace=False), 1] = float("nan")
    return o.contiguous(), d.contiguous(), tme.contiguous()


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


@pytest.mark.parametrize("n,t_min,t_max", [
    (1024, path.T_MIN, primitives.T_MAX), (1000, 0.0, 1000.0)])
def test_bvh4_traverse_equals_plain(host, scene, n, t_min, t_max):
    """Every ray's (t, index) and (nodes popped, primitives tested) equal
    the plain version's, a ragged last block among them; a parked ray pops
    the root alone."""
    cs2, inter = bvh_kernel.attach(scene)
    ks = inter.ks
    o, d, tme = (x[:n].contiguous() for x in _rays(cs2, 1024, 11))
    t = torch.empty(n, dtype=torch.float32)
    idx = torch.empty(n, dtype=torch.int32)
    counts = torch.empty((n, 2), dtype=torch.int32)
    host["bvh4_traverse.cu"].run(
        _ptr(ks.nodes), _ptr(ks.prim_table), _ptr(o), _ptr(d), _ptr(tme), n,
        t_min, min(t_max, primitives.T_MAX), _ptr(t), _ptr(idx), _ptr(counts))
    t_p, i_p, c_p = traverse.closest_bvh(ks.prims, ks.tree, o, d, tme, t_min,
                                         t_max, counts=True)
    hit = i_p >= 0
    assert 0.3 < hit.float().mean() < 1.0
    assert torch.equal(idx.long(), i_p)
    assert torch.equal(t.view(torch.int32), t_p.view(torch.int32))
    assert torch.equal(counts.long(), c_p)
    parked = (o == path.PARK).all(dim=1)
    assert parked.any() and (c_p[parked, 0] == 1).all()


@pytest.mark.parametrize("n,t_min,t_max,sort", [
    (1024, path.T_MIN, primitives.T_MAX, True),
    (1000, 0.0, 1000.0, False)], ids=["sorted", "ragged"])
def test_bvh4_rowstack_equals_plain(host, scene, n, t_min, t_max, sort):
    """Every ray's (t, block slot) and every warp's (nodes popped, leaf
    blocks tested, (ray, primitive) pairs tested) equal the plain
    version's: rays sorted by the JAX intersector's coherence key (coherent
    rows), and rays in their order with a ragged last warp."""
    cs2, inter = bvh_rowkernel.attach(scene)
    rs = inter.rs
    o, d, tme = (x[:n] for x in _rays(cs2, 1024, 12))
    if sort:
        order = torch.argsort(bvh_rowkernel.sort_keys(o, d, inter.lo, inter.hi),
                              stable=True)
        o, d, tme = (x[order].contiguous() for x in (o, d, tme))
    t = torch.empty(n, dtype=torch.float32)
    idx = torch.empty(n, dtype=torch.int32)
    counters = torch.empty((-(-n // 32), 3), dtype=torch.int32)
    host["bvh4_rowstack.cu"].run(_ptr(rs.nodes), _ptr(rs.blocks), _ptr(o), _ptr(d),
                      _ptr(tme), n, t_min, min(t_max, primitives.T_MAX), _ptr(t),
                      _ptr(idx), _ptr(counters))
    t_p, i_p, c_p = bvh_rowkernel.closest_rows(rs, o, d, tme, t_min, t_max)
    assert 0.3 < (i_p >= 0).float().mean() < 1.0
    assert torch.equal(idx.long(), i_p)
    assert torch.equal(t.view(torch.int32), t_p.view(torch.int32))
    assert torch.equal(counters.long(), c_p)
    # The warps test fewer pairs than every lane testing every block.
    assert (c_p[:, 2] < 32 * c_p[:, 1] * bvh_rowkernel.LEAF_SIZE).all()
