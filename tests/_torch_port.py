"""Shared helpers for the port's differential tests (tests/test_torch_*.py).

Each test makes its inputs with numpy from a seed, runs them through the JAX
function and its counterpart in `izpi_tpu_torch`, and compares the outputs
as numpy arrays. JAX runs on the CPU (tests/conftest.py).
"""

from __future__ import annotations

import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import pytest

from izpi_tpu_torch.ops import _build
from izpi_tpu_torch.scene import compiler as tcompiler
from izpi_tpu_torch.scene import types as tst
from izpi_tpu_torch.spectral import spd as tspd


def loop_step(cs, meta, settings, intersect, n, spp, route, params, xs, ys,
              target, key):
    """The training step a sample pass at a time, as
    `parallel.dist.build_train_step` ran every route before the fused route
    merged its passes (`renderer.sample_pass` for each sample of the n×n
    frame, the colours added in order), eagerly: (loss, grads, rays)."""
    import torch

    from izpi_tpu_torch.parallel import dist
    from izpi_tpu_torch.render import renderer

    leaves = {k: params[k].detach().requires_grad_(True) for k in dist.PARAMS}
    cs_p = dist.inject_params(cs, leaves)
    acc = rays = None
    for s in range(spp):
        color, nr = renderer.sample_pass(cs_p, meta, settings, intersect, n,
                                         n, xs, ys, key, s,
                                         differentiable=True, route=route)
        acc = color if acc is None else acc + color
        rays = nr if rays is None else rays + nr
    se = torch.sum((acc / spp - target) ** 2)
    n_total = xs.shape[0] * 3
    grads = torch.autograd.grad(se / float(n_total),
                                [leaves[k] for k in dist.PARAMS],
                                allow_unused=True)
    grads = {k: torch.zeros_like(leaves[k]) if g is None else g
             for k, g in zip(dist.PARAMS, grads)}
    return se.detach() / float(n_total), grads, int(rays)


def _leaf(cs, name):
    for part in name.split("."):
        cs = getattr(cs, part)
    return cs


def jax_leaves(cs) -> dict:
    """The leaves of a JAX CompiledScene the port reads, as numpy, keyed
    as in izpi_tpu_torch.scene.compiler.LEAVES."""
    return {name: np.asarray(_leaf(cs, name)) for name in tcompiler.LEAVES}


def port_leaves(cs) -> dict:
    return {name: _leaf(cs, name).cpu().numpy() for name in tcompiler.LEAVES}


def to_port_scene(obj, _memo=None):
    """A JAX-package scene description rebuilt from the port's classes of
    the same names (the two `scene/types.py` match class for class), so
    one scene goes through both compilers. Shared objects stay shared (the
    compilers key materials by identity); SPDs become the port's SPD."""
    memo = {} if _memo is None else _memo
    if id(obj) in memo:
        return memo[id(obj)][0]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = getattr(tst, type(obj).__name__)
        out = cls(**{f.name: to_port_scene(getattr(obj, f.name), memo)
                     for f in dataclasses.fields(obj)})
    elif type(obj).__name__ == "SPD":
        out = tspd.SPD(obj.wavelengths, obj.values)
    elif isinstance(obj, (list, tuple)):
        out = type(obj)(to_port_scene(x, memo) for x in obj)
    else:
        return obj
    memo[id(obj)] = (out, obj)  # holding obj keeps its id unique
    return out


def mixed_scene(st):
    """A scene using every element the slice compiles: triangles with and
    without vertex normals, a moving sphere, metal, an absorbing dielectric,
    a checker texture, a box under Translate/RotateY, a triangle light and a
    sphere light. `st` is either package's scene.types module."""
    checker = st.Lambertian(albedo=st.CheckerTexture(
        st.ConstantTexture((0.1, 0.2, 0.3)), st.ConstantTexture((0.9, 0.8, 0.7))))
    white = st.Lambertian(albedo=st.ConstantTexture((0.73, 0.73, 0.73)))
    metal = st.Metal(albedo=(0.8, 0.6, 0.4), fuzz=0.2)
    glass = st.Dielectric(ref_idx=1.5, absorption=(0.01, 0.02, 0.005))
    light = st.DiffuseLight(emit=st.ConstantTexture((4.0, 4.0, 4.0)))
    world = [
        st.XZRect(-10, 10, -10, 10, 0, checker),
        st.Sphere((0, 1, 0), (0.3, 1, 0), 0, 1, 1.0, metal),
        st.Sphere((-2.2, 1, 0.5), (-2.2, 1, 0.5), 0, 1, 1.0, glass),
        st.Triangle((2, 0, -1), (4, 0, -1), (3, 2, -1), white),
        st.Triangle((2, 0, 1), (4, 0, 1), (3, 2, 1), white,
                    vn0=(0, 0, 1), vn1=(0.2, 0, 1), vn2=(0, 0.3, 1)),
        st.Translate(st.RotateY(st.Box((0, 0, 0), (1, 1.5, 1), white), 20.0),
                     (0.5, 0, 2)),
        st.FlipNormals(st.Triangle((-1, 4, -1), (1, 4, -1), (0, 4, 1), light)),
        st.Sphere((0, 6, 3), (0, 6, 3), 0, 1, 0.5, light),
    ]
    cam = st.Camera(look_from=(0, 3, -9), look_at=(0, 1, 0), vfov=40,
                    aspect=1.0, aperture=0.1, focus_dist=9.0)
    return st.Scene(world=world, camera=cam)


def spectral_mixed_scene(st, spd):
    """A spectral scene using every spectral element the port compiles: a
    spectral checker of a Gaussian and a tabulated spectrum, neutral and
    Gaussian albedos, a dielectric with η(λ) and spectral absorption, a
    triangle mesh with uvs and vertex normals under Translate/RotateY, a
    mesh light with a Gaussian emission and a tabulated background. `st`
    and `spd` are either package's scene.types and spectral.spd modules."""
    lam = tuple(np.arange(380.0, 751.0, 10.0))
    checker = st.Lambertian(spectral_albedo=st.SpectralChecker(
        st.SpectralGaussian(0.8, 520.0, 60.0),
        st.SpectralTabulated(lam, tuple(0.2 + 0.5 * (x - 380.0) / 370.0
                                        for x in lam))))
    white = st.Lambertian(albedo=st.ConstantTexture((0.5, 0.6, 0.7)),
                          spectral_albedo=st.SpectralNeutral(0.7))
    plain = st.Lambertian(albedo=st.ConstantTexture((0.3, 0.6, 0.2)))
    glass = st.Dielectric(
        ref_idx=1.5,
        spectral_ref_idx=st.SpectralTabulated((380.0, 750.0), (1.62, 1.48)),
        spectral_absorption=st.SpectralTabulated((380.0, 550.0, 750.0),
                                                 (0.02, 0.2, 0.05)))
    light = st.DiffuseLight(spectral_emit=st.SpectralGaussian(12.0, 560.0,
                                                              150.0))
    tet = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                    [[0, 0, 0], [0, 1, 0], [0, 0, 1]],
                    [[0, 0, 0], [0, 0, 1], [1, 0, 0]],
                    [[1, 0, 0], [0, 0, 1], [0, 1, 0]]], np.float64) * 1.5
    uvs = np.tile(np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]), (4, 1, 1))
    normals = tet / np.maximum(np.linalg.norm(tet, axis=2, keepdims=True), 1)
    world = [
        st.XZRect(-10, 10, -10, 10, 0, checker),
        st.FlipNormals(st.XYRect(-10, 10, 0, 10, 6, white)),
        st.Sphere((-2.0, 1.0, 0.0), (-2.0, 1.0, 0.0), 0, 1, 1.0, glass),
        st.Translate(st.RotateY(st.TriangleMesh(tet, plain, uvs=uvs,
                                                normals=normals), 30.0),
                     (1.0, 0.0, -0.5)),
        st.TriangleMesh(tet + np.array([0.0, 0.0, 3.0]), glass),
        st.FlipNormals(st.TriangleMesh(
            np.array([[[-1, 5, -1], [1, 5, -1], [0, 5, 1]]], np.float64),
            light)),
    ]
    cam = st.Camera(look_from=(0, 3, -9), look_at=(0, 1, 0), vfov=40,
                    aspect=1.0, aperture=0.1, focus_dist=9.0, exposure=1.3)
    return st.Scene(world=world, camera=cam, spectral=True,
                    spectral_background=spd.SPD(lam, np.full(len(lam), 0.05)))


# Beer–Lambert coefficients (per scene unit) that `with_absorbing_glass`
# gives a glass: the light inside a Cornell sphere (radius 90) keeps
# exp(-0.9), exp(-3.6) and exp(-9) of its red, green and blue.
ABSORPTION = (0.005, 0.02, 0.05)


def with_absorbing_glass(scene, types=tst, absorption=ABSORPTION):
    """`scene` with the glass of each dielectric sphere absorbing
    (Beer–Lambert), so that refraction into it re-traces to the exit: no
    scene of the library sets an absorption. `types` is the scene's types
    module, the JAX package's or the port's."""
    world = [dataclasses.replace(h, material=dataclasses.replace(
                 h.material, absorption=absorption))
             if isinstance(h, types.Sphere)
             and isinstance(h.material, types.Dielectric) else h
             for h in scene.world]
    if all(a is b for a, b in zip(world, scene.world)):
        raise ValueError("the scene holds no dielectric sphere")
    return dataclasses.replace(scene, world=world)


# ---------------------------------------------------------------------------
# CUDA sources as host C++
# ---------------------------------------------------------------------------
# A kernel source is compiled with g++ behind stand-ins for CUDA:
# `threadIdx` and `blockIdx` as thread-locals, `__shared__` as statics,
# atomics as `__atomic_*` builtins, the copy macros as a plain copy, and
# one `std::thread` per lane, with a `std::barrier` of 32 per warp behind
# the warp collectives (`__syncwarp`, `__ballot_sync`, `__shfl_sync`,
# `__match_any_sync`, ...) and one of the block behind `__syncthreads`.
# The source is cut before its C entries (the `<<<...>>>` launches); the
# test's own entry `run` calls the kernels through `run_grid`.

# The CUDA names the kernels use, for the host (`host_kernel`).
CUDA_STAND_IN = r"""
#pragma once
#include <barrier>
#include <chrono>
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
inline void __threadfence() { __atomic_thread_fence(__ATOMIC_SEQ_CST); }
inline unsigned __ballot_sync(unsigned, int pred) {
  const uint32_t* s = exchange(pred != 0);
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= s[i] ? 1u << i : 0u;
  return m;
}
inline long long clock64() {
  return std::chrono::steady_clock::now().time_since_epoch().count();
}
inline int __reduce_max_sync(unsigned, int v) {
  const uint32_t* s = exchange((uint32_t)v);
  int m = (int)s[0];
  for (int i = 1; i < 32; ++i) m = (int)s[i] > m ? (int)s[i] : m;
  return m;
}
inline int __any_sync(unsigned, int pred) { return __ballot_sync(0xffffffffu, pred) != 0; }
inline int __all_sync(unsigned, int pred) { return __ballot_sync(0xffffffffu, pred) == 0xffffffffu; }
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
inline long long __shfl_sync(unsigned, long long v, int src) {
  const uint32_t lo = exchange((uint32_t)(uint64_t)v)[src];
  const uint32_t hi = exchange((uint32_t)((uint64_t)v >> 32))[src];
  return (long long)(((uint64_t)hi << 32) | lo);
}
inline float __shfl_xor_sync(unsigned, float v, int m) {
  return __uint_as_float(exchange(__float_as_uint(v))[tl_lane ^ m]);
}
inline int __shfl_xor_sync(unsigned, int v, int m) {
  return (int)exchange((uint32_t)v)[tl_lane ^ m];
}
inline unsigned __match_any_sync(unsigned, long long v) {
  uint32_t lo[32], hi[32];
  std::memcpy(lo, exchange((uint32_t)(uint64_t)v), sizeof lo);
  std::memcpy(hi, exchange((uint32_t)((uint64_t)v >> 32)), sizeof hi);
  unsigned m = 0;
  for (int i = 0; i < 32; ++i)
    m |= (((uint64_t)hi[i] << 32) | lo[i]) == (uint64_t)v ? 1u << i : 0u;
  return m;
}
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned atomicOr(unsigned* p, unsigned v) {
  return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned atomicMax(unsigned* p, unsigned v) {
  unsigned old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (old < v && !__atomic_compare_exchange_n(p, &old, v, false, __ATOMIC_SEQ_CST,
                                                 __ATOMIC_SEQ_CST)) {
  }
  return old;
}
inline long long __double2ll_rn(double x) { return llrint(x); }
inline int __clzll(long long x) { return __builtin_clzll((unsigned long long)x); }
"""

# Blocks one after another (their __shared__ statics are shared), the lanes
# of a block all at once; the copy macros of bvh4_rowstack.cu as a plain copy
# (the __syncwarp after each wait stands for the wait).
HOST_GRID = r"""
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


def cut_source(name: str) -> str:
    """A kernel source of csrc/ up to its C entries."""
    text = (_build.CSRC / name).read_text()
    return text[:text.index('extern "C" {')]


def host_kernel(tmp, name: str, entry: str, argtypes):
    """The kernel source `name` of csrc/ built as host C++ in the directory
    tmp, with `entry` (C++ that defines `extern "C" void run(...)` over
    `run_grid`) after it: a ctypes library whose `run` takes argtypes.
    Skips the test without g++."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernels as host C++")
    (tmp / "cuda_runtime.h").write_text(CUDA_STAND_IN)
    (tmp / "kernel_cut.cu").write_text(cut_source(name))
    (tmp / "runner.cpp").write_text(HOST_GRID + entry)
    so = tmp / "libhost.so"
    subprocess.run(["g++", "-O1", "-std=c++20", "-ffp-contract=off", "-shared",
                    "-fPIC", "-pthread", f"-I{tmp}", f"-I{_build.CSRC}", "-o",
                    str(so), str(tmp / "runner.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    lib.run.argtypes = argtypes
    return lib
