"""The port's loops (`core/loops.py`), the pool run through them, and the
cipher entry's forms (`csrc/cipher.cu`), on the CPU.

- `chunked_while` and `guarded_fori` against the JAX package's on the same
  counter body and state: equal results and equal trip counts.
- The queue pool with chunks 1, 3 and 8 (the plain loop is chunk 1)
  against the JAX package's `trace_pool` on cornell_box_obj, the spectral
  pyramid and `final` (media): equal rays and iterations across the
  chunks, the pixels of each chunk equal to the plain loop's bit for bit
  and within test_torch_pool.py's tolerances of JAX's (`final` against
  eager JAX, as test_torch_library.py holds it).
- One extra chunk after the pool's end leaves its state bit for bit.
- The exit re-trace of absorbing dielectrics, now run masked on every
  bounce, equals the earlier form that ran it only when some ray applied.
- A pool iteration makes no host sync and no host-to-device copy (the CPU
  stand-in of the card test under `set_sync_debug_mode("error")`).
- The cipher kernels compiled as host C++ (g++, stand-ins for CUDA, a
  `std::thread` per lane and a `std::barrier` per block) give the bits of
  the PyTorch cipher and of the JAX package's `rng.path_keys_perray`.
"""

import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from izpi_tpu.core import loops as jloops
from izpi_tpu.core import rng as jrng
from izpi_tpu.integrator import path as jpath
from izpi_tpu.render import renderer as jrenderer
from izpi_tpu.scene.library import REGISTRY as J_REGISTRY
from izpi_tpu.scene.library.cornell_spectral import (
    cornell_box_spectral as j_cbs)
from izpi_tpu.scene.library.misc import cornell_box_obj as j_obj
from izpi_tpu_torch import camera
from izpi_tpu_torch.core import loops, rng
from izpi_tpu_torch.integrator import path, wavefront
from izpi_tpu_torch.ops import _build, bvh_kernel
from izpi_tpu_torch.ops import threefry as tf
from izpi_tpu_torch.render import renderer
from izpi_tpu_torch.scene.library import get_scene
from izpi_tpu_torch.scene.library.cornell_spectral import (
    cornell_box_pyramid_spectral)
from izpi_tpu_torch.scene.library.misc import cornell_box_obj

# test_torch_pool.py's gate against JAX: rays within 0.5%, ≥ 99% of the
# pixels within PIXEL_ATOL + PIXEL_RTOL·|JAX| in every channel, means
# within 0.5%.
RAYS_RTOL, PIXEL_ATOL, PIXEL_SHARE, MEAN_RTOL = 0.005, 1e-4, 0.99, 0.005
CHUNKS = (1, 3, 8)


# ---- the loops against the JAX package's ----

LIMIT = 13  # the counter body's last live step


def _counter_body(xp, where):
    """A body that is a fixpoint once i reaches LIMIT, and a trip counter
    that is not (it counts every body run)."""
    def body(s):
        i, acc, trips = s
        live = i < LIMIT
        return (i + live.astype(i.dtype) if xp is jnp else i + live.long(),
                acc + where(live, i * i, 0 * i), trips + 1)
    return body


def _jax_state():
    return (jnp.int32(0), jnp.int32(5), jnp.int32(0))


def _torch_state():
    z = torch.zeros((), dtype=torch.int64)
    return (z, z + 5, z)


@pytest.mark.parametrize("chunk", [1, 3, 8, 20])
def test_chunked_while_matches_jax(chunk):
    want = jloops.chunked_while(lambda s: s[0] < LIMIT,
                                _counter_body(jnp, jnp.where), _jax_state(),
                                chunk)
    runner = loops.Eager()
    got = loops.chunked_while(lambda s: s[0] < LIMIT,
                              _counter_body(torch, torch.where),
                              _torch_state(), chunk, runner)
    assert [int(x) for x in got] == [int(x) for x in want]
    assert int(got[0]) == LIMIT
    assert runner.trips == int(got[2]) == -(-LIMIT // chunk) * chunk


@pytest.mark.parametrize("n_iters,chunk", [(20, 8), (10, 3), (13, 4), (7, 1),
                                           (0, 8), (9, 16)])
def test_guarded_fori_matches_jax(n_iters, chunk):
    want = jloops.guarded_fori(n_iters, lambda s: s[0] < LIMIT,
                               _counter_body(jnp, jnp.where), _jax_state(),
                               chunk=chunk)
    runner = loops.Eager()
    got = loops.guarded_fori(n_iters, lambda s: s[0] < LIMIT,
                             _counter_body(torch, torch.where),
                             _torch_state(), chunk=chunk, runner=runner)
    assert [int(x) for x in got] == [int(x) for x in want]
    assert runner.trips == int(got[2]) <= n_iters


def test_trace_guarded_fori_equals_per_bounce_loop(monkeypatch):
    """The lockstep oracle through guarded_fori, at its chunk
    (`path.TRACE_CHUNK`) and at chunks of 8 (the live test once a chunk),
    against the loop that tests after every bounce."""
    cs, meta, intersect = renderer.prepare(get_scene("cornell_box"), "cpu")
    xs = torch.arange(8).repeat(8)
    ys = torch.arange(8).repeat_interleave(8)
    o, d, tme, keys = renderer.camera_rays(cs, rng.render_key(4), xs, ys, 8,
                                           8, 0)
    s = path.RenderSettings(max_depth=11)
    traced = []
    for chunk in (path.TRACE_CHUNK, 8):
        monkeypatch.setattr(path, "TRACE_CHUNK", chunk)
        traced.append(path.trace(cs, meta, s, intersect, o, d, tme, keys))

    thru, rad = torch.ones_like(o), torch.zeros_like(o)
    active = torch.ones(64, dtype=torch.bool)
    want_rays = 0
    for depth in range(s.max_depth):
        if not bool(active.any()):
            break
        o, d, thru, rad, active, nr = path.bounce_rgb(
            cs, meta, s, intersect, o, d, tme, keys,
            torch.full((64,), depth, dtype=torch.int64), thru, rad, active)
        want_rays += int(nr)
    rad = rad + torch.where(active[:, None],
                            thru * torch.tensor([0.0, 0.0, 1.0]), 0.0)
    for got, rays in traced:
        assert int(rays) == want_rays
        assert torch.equal(got, rad)


# ---- the pool through the loops ----

def _assert_close(got, want, rays_got, rays_want, rtol=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert abs(rays_got - rays_want) <= RAYS_RTOL * rays_want
    close = (np.abs(got - want) <= PIXEL_ATOL + rtol * np.abs(want)).all(-1)
    assert close.mean() >= PIXEL_SHARE, close.mean()
    assert abs(got.mean() - want.mean()) <= MEAN_RTOL * abs(want.mean())


def _chunked_pools(ctx, n, spp, depth, pool, spectral, seed):
    """{chunk: (acc, rays, iterations, trips)} of the pool at each chunk."""
    out = {}
    for chunk in CHUNKS:
        stats = {}
        acc, rays, its = wavefront._trace_pool(
            ctx.cs, ctx.meta, path.RenderSettings(max_depth=depth),
            ctx.intersect, n, n, spp, rng.render_key(seed, device="cpu"),
            pool, spectral, ctx.meta.spectral_background_spd or 0, 0, chunk,
            False, stats=stats)
        assert stats["chunk"] == chunk and stats["replays"] == 0
        out[chunk] = (acc, int(rays), its, stats["trips"])
    plain = out[1]
    assert plain[3] == plain[2]  # the plain loop runs no overrun
    for chunk, (acc, rays, its, trips) in out.items():
        assert torch.equal(acc, plain[0])
        assert (rays, its) == plain[1:3]
        assert its <= trips < its + chunk
    return out


def test_pool_chunks_match_jax_cornell_box_obj():
    want = jrenderer.render(j_obj(), 8, 8, 2, settings=jpath.RenderSettings(
        max_depth=8), seed=0, mode="pool")
    ctx = renderer.RenderContext(cornell_box_obj(), device="cpu")
    out = _chunked_pools(ctx, 8, 2, 8, 37, False, 0)
    acc, rays, _, _ = out[1]
    img = (acc.numpy().astype(np.float64) / 2).reshape(8, 8, 3)[::-1]
    _assert_close(img, want.image, rays, want.rays_traced)


def test_pool_chunks_match_jax_spectral():
    want = jrenderer.render(j_cbs(with_prism=True), 8, 8, 2,
                            settings=jpath.RenderSettings(max_depth=8),
                            seed=3, mode="pool")
    ctx = renderer.RenderContext(cornell_box_pyramid_spectral(),
                                 device="cpu")
    out = _chunked_pools(ctx, 8, 2, 8, 29, True, 3)
    acc, rays, _, _ = out[1]
    # `want.xyz` is after firefly rejection; compare its input, the canvas.
    from izpi_tpu_torch.spectral import convert
    xyz = convert.firefly_rejection(
        (acc.numpy().astype(np.float64) / 2).reshape(8, 8, 3)[::-1])
    _assert_close(xyz, want.xyz, rays, want.rays_traced, rtol=1e-5)


@pytest.mark.filterwarnings("ignore::UserWarning")
def test_pool_chunks_match_eager_jax_final():
    """`final` (two media, an image, marble noise) against eager JAX's
    lockstep render of the same keyed paths (test_torch_library.py's
    reference for it: XLA's FMAs turn its last ulps into other paths)."""
    settings = jpath.RenderSettings(max_depth=4)
    jctx = jrenderer.RenderContext(J_REGISTRY["final"](1.0))
    with jax.disable_jit():
        want = jrenderer.render(None, 4, 4, 1, settings=settings, seed=0,
                                mode="simple", context=jctx)
    ctx = renderer.RenderContext(get_scene("final"), device="cpu")
    out = _chunked_pools(ctx, 4, 1, 4, 5, False, 0)
    acc, rays, _, _ = out[1]
    img = acc.numpy().astype(np.float64).reshape(4, 4, 3)[::-1]
    assert rays == want.rays_traced
    np.testing.assert_allclose(img, want.image, rtol=1e-5, atol=1e-6)


def _same_bits(a, b):
    """Equal bit for bit (a NaN equals itself)."""
    if a.dtype.is_floating_point:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _run_to_end(name, n, spp, depth, pool):
    ctx = renderer.RenderContext(get_scene(name), device="cpu")
    body, st = wavefront._pool(
        ctx.cs, ctx.meta, path.RenderSettings(max_depth=depth), ctx.intersect,
        n, n, spp, rng.render_key(2), pool, ctx.meta.spectral,
        ctx.meta.spectral_background_spd or 0, 5)
    st = loops.chunked_while(lambda s: s["active"].any(), body, st, 1)
    return body, st


@pytest.mark.filterwarnings("ignore::UserWarning")
@pytest.mark.parametrize("name", ["cornell_box", "cornell_box_water_spectral",
                                  "final"])
def test_pool_body_is_a_fixpoint_after_the_end(name):
    body, st = _run_to_end(name, 6, 2, 12, 23)
    assert int(st["next"]) == int(st["total"]) and int(st["nrays"]) > 0
    before = {k: v.clone() for k, v in st.items()}
    after = loops.Eager().run(body, st, 8)
    for k, v in before.items():
        assert _same_bits(after[k], v), k


def _parent_exit_retrace(intersect, p, d_in, time, apply):
    """The exit re-trace before it ran masked: only when some ray applies,
    from every ray's own start."""
    start = p + 1e-3 * d_in
    if bool(apply.any()):
        exit_rec = intersect(start, d_in, time, 0.0, 1000.0)
        return exit_rec.p, exit_rec.hit
    return start, torch.zeros_like(apply)


@pytest.mark.parametrize("applies", [False, True])
def test_masked_exit_retrace_equals_conditional_form(monkeypatch, applies):
    """One spectral bounce of camera rays into the water scene: with every
    ray live (some refract into the water: the re-trace applies) or only
    those whose first hit is not an absorbing dielectric (none applies),
    the masked re-trace gives the bounce of the conditional one bit for
    bit."""
    cs, meta, intersect = renderer.prepare(
        get_scene("cornell_box_water_spectral"), "cpu")
    assert meta.has_absorbing_dielectric
    n = 24
    xs = torch.arange(n).repeat(n)
    ys = torch.arange(n).repeat_interleave(n)
    o, d, tme, keys = renderer.camera_rays(cs, rng.render_key(1), xs, ys, n,
                                           n, 0)
    from izpi_tpu_torch.spectral import cie
    lam, _ = cie.sample_wavelength(torch.rand(n * n, generator=torch.Generator()
                                              .manual_seed(0)))
    rec = intersect(o, d, tme, path.T_MIN, 1e30)
    absorbing = (cs.materials.spec_absorb_id[rec.mat_id.clamp(min=0)] >= 0) & (
        rec.hit)
    active = torch.ones(n * n, dtype=torch.bool) if applies else ~absorbing
    assert bool(absorbing.any())
    depth = torch.zeros(n * n, dtype=torch.int64)
    thru = torch.ones(n * n)
    rad = torch.zeros(n * n)

    calls = []

    def counted(*args):
        calls.append(1)
        return intersect(*args)

    def bounce():
        return path.bounce_spectral(cs, meta, path.RenderSettings(max_depth=8),
                                    counted, o, d, tme, lam, keys, depth,
                                    thru, rad, active, 0)

    got = bounce()
    assert len(calls) == 2
    monkeypatch.setattr(path, "_exit_retrace", _parent_exit_retrace)
    calls.clear()
    want = bounce()
    assert len(calls) == (2 if applies else 1)
    for g, w in zip(got, want):
        assert _same_bits(g, w)


class _SyncWatch(TorchDispatchMode):
    """Records the aten ops that would sync a CUDA stream with the host or
    cannot sit in a CUDA graph."""

    FORBIDDEN = {"_local_scalar_dense", "nonzero", "masked_select", "unique",
                 "_unique2", "unique_consecutive", "repeat_interleave",
                 "equal", "is_nonzero", "allclose", "lift_fresh",
                 "lift_fresh_copy"}

    def __init__(self):
        super().__init__()
        self.seen = []
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        boolean_index = name == "index" and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool
            for i in (args[1] if len(args) > 1 else ()) if i is not None)
        if not self.paused and (name in self.FORBIDDEN or boolean_index):
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


@pytest.mark.filterwarnings("ignore::UserWarning")
@pytest.mark.parametrize("name", ["cornell_box", "cornell_box_obj",
                                  "cornell_box_water_spectral", "final",
                                  "pbr_ibl"])
def test_pool_iteration_makes_no_host_sync(monkeypatch, name):
    """One pool iteration (after one warm-up iteration, which makes the
    shared constants) runs no op that reads a device value back, indexes
    by a mask or copies host data to the device. The kernels' CPU stand-ins
    (the plain traversal, which compacts rays, and the PyTorch cipher) are
    not watched: on the card the kernels run there."""
    ctx = renderer.RenderContext(
        cornell_box_obj() if name == "cornell_box_obj" else get_scene(name),
        device="cpu")
    body, st = wavefront._pool(
        ctx.cs, ctx.meta, path.RenderSettings(max_depth=8), ctx.intersect, 4,
        4, 2, rng.render_key(0), 16, ctx.meta.spectral,
        ctx.meta.spectral_background_spd or 0, 0)
    st = body(st)
    watch = _SyncWatch()

    def unwatched(fn):
        def call(*args, **kwargs):
            watch.paused += 1
            try:
                return fn(*args, **kwargs)
            finally:
                watch.paused -= 1
        return call

    def no_host_data(fn):
        def call(data, *args, **kwargs):
            if not watch.paused and not isinstance(data, torch.Tensor):
                raise AssertionError("a pool iteration made a tensor of host "
                                     "data")
            return fn(data, *args, **kwargs)
        return call

    # The kernels' CPU stand-ins (their plain versions) are not watched.
    for mod, attr in ((bvh_kernel, "closest_hit"),
                      (tf, "uniforms_for_keys"), (tf, "new_samples")):
        monkeypatch.setattr(mod, attr, unwatched(getattr(mod, attr)))
    for mod, attr in ((torch, "tensor"), (torch, "as_tensor"),
                      (torch, "from_numpy")):
        monkeypatch.setattr(mod, attr, no_host_data(getattr(mod, attr)))
    original = torch.Tensor.new_tensor
    checked = no_host_data(lambda data, self, *a, **k:
                           original(self, data, *a, **k))
    monkeypatch.setattr(torch.Tensor, "new_tensor",
                        lambda self, data, *a, **k: checked(data, self, *a,
                                                            **k))
    with watch:
        body(st)
    assert watch.seen == []


# ---- the cipher kernels as host C++ ----

STAND_IN = r"""
#pragma once
#include <barrier>
#include <cstdint>
#include <cstring>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)

struct longlong2 { long long x, y; };
struct dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline thread_local std::barrier<>* tl_block;
inline void __syncthreads() { tl_block->arrive_and_wait(); }
inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidDevice = 101 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 2; return cudaSuccess; }
template <class K>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* v, K, int, size_t) {
  *v = 1;
  return cudaSuccess;
}
inline float izpi_host_dynamic[256 * 48];
"""

# Blocks one after another (their __shared__ statics are shared), the
# threads of a block all at once; the grid as the C entries size it
# (cipher_blocks: 2 SMs × 1 block here, so each block walks several tiles).
RUNNER = r"""
#include <thread>
#include <vector>
#include "cipher_cut.cu"

template <class F>
static void run_grid(int blocks, F body) {
  blockDim.x = izpi::kCipherThreads;
  gridDim.x = blocks;
  for (int b = 0; b < blocks; ++b) {
    std::barrier<> bar(izpi::kCipherThreads);
    std::vector<std::thread> lanes;
    for (int t = 0; t < izpi::kCipherThreads; ++t) {
      lanes.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = b;
        tl_block = &bar;
        body();
      });
    }
    for (auto& l : lanes) l.join();
  }
}

extern "C" int uniforms(const int64_t* keys, const int64_t* depths, int n, int n_u,
                        uint32_t salt, float* out) {
  int blocks = 0;
  izpi::cipher_blocks(izpi::bounce_tiles<0>, 0, 0, n, &blocks);
  if (n_u == 12) {
    run_grid(blocks, [&] { izpi::bounce_tiles<12>(keys, depths, n, n_u, salt, out); });
  } else if (n_u == 5) {
    run_grid(blocks, [&] { izpi::bounce_tiles<5>(keys, depths, n, n_u, salt, out); });
  } else if (n_u == 1) {
    run_grid(blocks, [&] { izpi::bounce_tiles<1>(keys, depths, n, n_u, salt, out); });
  } else {
    run_grid(blocks, [&] { izpi::bounce_tiles<0>(keys, depths, n, n_u, salt, out); });
  }
  return blocks;
}

extern "C" int new_sample(const int64_t* base, const int64_t* pixel, const int64_t* sample,
                          uint32_t sample_const, int n, uint32_t cam_salt, uint32_t lam_salt,
                          int64_t* keys, float* cam, float* lam) {
  int blocks = 0;
  izpi::cipher_blocks(izpi::bounce_tiles<0>, 0, 0, n, &blocks);
  run_grid(blocks, [&] {
    if (lam) {
      izpi::new_sample_tiles<true, true>(base, pixel, sample, sample_const, n, cam_salt,
                                         lam_salt, keys, cam, lam);
    } else if (cam) {
      izpi::new_sample_tiles<true, false>(base, pixel, sample, sample_const, n, cam_salt,
                                          lam_salt, keys, cam, lam);
    } else {
      izpi::new_sample_tiles<false, false>(base, pixel, sample, sample_const, n, cam_salt,
                                           lam_salt, keys, cam, lam);
    }
  });
  return blocks;
}
"""


@pytest.fixture(scope="module")
def host_cipher(tmp_path_factory):
    """csrc/cipher.cu up to its C entries, built as host C++."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernels as host C++")
    text = (_build.CSRC / "cipher.cu").read_text()
    text = text[:text.index('extern "C" {')].replace(
        "extern __shared__ float dynamic_tile[];",
        "float* dynamic_tile = izpi_host_dynamic;")
    tmp = tmp_path_factory.mktemp("cipher")
    (tmp / "cuda_runtime.h").write_text(STAND_IN)
    (tmp / "cipher_cut.cu").write_text(text)
    (tmp / "runner.cpp").write_text(RUNNER)
    so = tmp / "libcipher_host.so"
    subprocess.run(["g++", "-O1", "-std=c++20", "-shared", "-fPIC",
                    "-pthread", f"-I{tmp}", f"-I{_build.CSRC}", "-o",
                    str(so), str(tmp / "runner.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    lib.uniforms.argtypes = [p, p, i, i, u, p]
    lib.new_sample.argtypes = [p, p, p, u, i, u, u, p, p, p]
    return lib


def _ptr(a):
    return ctypes.c_void_p(None if a is None else a.ctypes.data)


def _words(rs, shape):
    w = rs.randint(0, 2**32, shape, dtype=np.uint64).astype(np.int64)
    w.reshape(-1)[::7] = 2**32 - 1  # wraparound
    return w


N_HOST = 1000  # four tiles over a grid of two blocks, the last one partial


@pytest.mark.parametrize("n_u,salt", [(12, 0), (5, camera.CAMERA_SALT),
                                      (1, wavefront.LAMBDA_SALT),
                                      (2, path.MEDIA_SALT), (7, 3)])
def test_bounce_form_host_bits(host_cipher, n_u, salt):
    rs = np.random.RandomState(n_u)
    keys, depths = _words(rs, (N_HOST, 2)), _words(rs, N_HOST)
    out = np.full((N_HOST, n_u), np.nan, np.float32)
    blocks = host_cipher.uniforms(_ptr(keys), _ptr(depths), N_HOST, n_u,
                                  salt, _ptr(out))
    assert blocks == 2
    want = tf.uniforms_for_keys_reference(torch.as_tensor(keys),
                                          torch.as_tensor(depths), n_u, salt)
    np.testing.assert_array_equal(out.view(np.uint32),
                                  want.numpy().view(np.uint32))


@pytest.mark.parametrize("form", ["keys", "camera", "lambda", "scalar"])
def test_new_sample_form_host_bits(host_cipher, form):
    """The path keys against `rng.path_keys_perray` (the PyTorch cipher)
    and the JAX package's, and the camera's and λ's uniforms against the
    draws of camera.primary_rays and wavefront.sample_lambda."""
    rs = np.random.RandomState(11)
    base = np.array([rs.randint(0, 2**32), 0xFFFFFFFF], np.int64)
    pixel = rs.randint(0, 1 << 20, N_HOST).astype(np.int64)
    sample = (None if form == "scalar" else
              rs.randint(0, 1 << 31, N_HOST).astype(np.int64))
    keys = np.zeros((N_HOST, 2), np.int64)
    cam = (np.full((N_HOST, 5), np.nan, np.float32)
           if form in ("camera", "lambda") else None)
    lam = np.full(N_HOST, np.nan, np.float32) if form == "lambda" else None
    host_cipher.new_sample(_ptr(base), _ptr(pixel), _ptr(sample), 77, N_HOST,
                           camera.CAMERA_SALT, wavefront.LAMBDA_SALT,
                           _ptr(keys), _ptr(cam), _ptr(lam))
    tb, tp = torch.as_tensor(base), torch.as_tensor(pixel)
    if sample is None:
        want = rng.path_keys(tb, tp, 77)
        want_j = jrng.path_keys(jnp.asarray(base.astype(np.uint32)),
                                jnp.asarray(pixel.astype(np.int32)), 77)
    else:
        want = rng.path_keys_perray(tb, tp, torch.as_tensor(sample))
        want_j = jrng.path_keys_perray(jnp.asarray(base.astype(np.uint32)),
                                       jnp.asarray(pixel.astype(np.int32)),
                                       jnp.asarray(sample.astype(np.int32)))
    np.testing.assert_array_equal(keys, want.numpy())
    np.testing.assert_array_equal(keys, np.asarray(want_j).astype(np.int64))
    zeros = torch.zeros(N_HOST, dtype=torch.int64)
    if cam is not None:
        want_cam = tf.uniforms_for_keys_reference(want, zeros, 5,
                                                  camera.CAMERA_SALT)
        np.testing.assert_array_equal(cam.view(np.uint32),
                                      want_cam.numpy().view(np.uint32))
    if lam is not None:
        want_lam = tf.uniforms_for_keys_reference(want, zeros, 1,
                                                  wavefront.LAMBDA_SALT)
        np.testing.assert_array_equal(lam.view(np.uint32),
                                      want_lam.numpy()[:, 0].view(np.uint32))


def test_new_samples_plain_version_is_the_parent_stream():
    """On the CPU `new_samples` is its plain version: the keys of
    `fold_in ∘ fold_in` and the draws `primary_rays` and `sample_lambda`
    make from them."""
    base = rng.render_key(9)
    pix = torch.arange(50, dtype=torch.int64) * 7
    sid = torch.arange(50, dtype=torch.int64) % 3 + 1
    keys, cam, lam = tf.new_samples(base, pix, sid, camera.CAMERA_SALT,
                                    wavefront.LAMBDA_SALT)
    s0, s1 = tf.fold_in(base[0].expand(50), base[1].expand(50), sid)
    p0, p1 = tf.fold_in(s0, s1, pix)
    assert torch.equal(keys, torch.stack([p0, p1], -1))
    assert torch.equal(cam, rng.bounce_uniforms(keys, 0, 5,
                                                salt=camera.CAMERA_SALT))
    assert torch.equal(lam, rng.bounce_uniforms(
        keys, 0, 1, salt=wavefront.LAMBDA_SALT)[:, 0])
