"""izpi_tpu_torch's queue pool vs the JAX package's, and vs the port's own
megakernel plain versions.

The pools enumerate and key the same (pixel, sample) pairs, so the images
agree path for path up to floating-point order. Against JAX, which runs its
pool compiled (XLA's CPU backend contracts multiply-adds into FMAs, ROADMAP
C) and on its own tree (the median build; the port's is binned SAH, so
exact-t ties may go to another primitive), the bounds are those chip_smoke.py
holds a kernel to against its plain version: ray
counts within 0.5%, at least 99% of the pixels within 1e-4 in every
channel, means within 0.5%. Against the port's megakernel plain versions,
which share every bounce function, ray counts are equal and pixels agree to
1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_port import to_port_scene
from izpi_tpu.core import rng as jrng
from izpi_tpu.geometry import procedural as jproc
from izpi_tpu.integrator import path as jpath
from izpi_tpu.integrator import wavefront as jwavefront
from izpi_tpu.render import renderer as jrenderer
from izpi_tpu.scene import types as jst
from izpi_tpu.scene.library.cornell import cornell_box as j_cornell
from izpi_tpu.scene.library.cornell_spectral import (
    cornell_box_spectral as j_cbs)
from izpi_tpu.scene.library.misc import cornell_box_obj as j_obj
from izpi_tpu_torch.core import rng as trng
from izpi_tpu_torch.integrator import path as tpath
from izpi_tpu_torch.integrator import wavefront as twavefront
from izpi_tpu_torch.ops import bvh_kernel as tbvh_kernel
from izpi_tpu_torch.ops import megakernel as tmega
from izpi_tpu_torch.ops import megakernel_spectral as tmks
from izpi_tpu_torch.render import renderer as trenderer
from izpi_tpu_torch.scene import types as tst
from izpi_tpu_torch.scene.library.cornell import cornell_box as t_cornell
from izpi_tpu_torch.scene.library.cornell_spectral import (
    cornell_box_pyramid_spectral as t_pyramid)
from izpi_tpu_torch.scene.library.misc import cornell_box_obj as t_obj

RAYS_RTOL = 0.005
PIXEL_ATOL = 1e-4
PIXEL_SHARE = 0.99
MEAN_RTOL = 0.005


def _assert_close_images(got, want, rays_got, rays_want, atol=PIXEL_ATOL,
                         rtol=0.0):
    """The image gate: rays within 0.5%, ≥ 99% of the pixels with every
    channel within atol + rtol·|want|, means within 0.5%."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert abs(rays_got - rays_want) <= RAYS_RTOL * rays_want
    close = (np.abs(got - want) <= atol + rtol * np.abs(want)).all(axis=-1)
    assert close.mean() >= PIXEL_SHARE, close.mean()
    assert abs(got.mean() - want.mean()) <= MEAN_RTOL * abs(want.mean())
    assert np.isfinite(got).all()


def _blob_box():
    """The Cornell box with a 2,000-triangle blob where cornell_box_obj
    keeps its 20,000-triangle one."""
    scene = j_cornell()
    tris = jproc.transform_mesh(jproc.bumpy_blob(2000), scale=60.0,
                                translate=(280.0, 90.0, 390.0))
    scene.world.append(jst.TriangleMesh(vertices=tris, material=jst.Lambertian(
        albedo=jst.ConstantTexture((0.7, 0.7, 0.85)))))
    return scene


@pytest.fixture(scope="module")
def blob_contexts():
    jctx = jrenderer.RenderContext(_blob_box(), use_bvh=True)
    tctx = trenderer.RenderContext(to_port_scene(_blob_box()), use_bvh=True,
                                   device="cpu")
    return jctx, tctx


@pytest.mark.parametrize("pool", [64, 512])
def test_pool_matches_jax_with_bvh(blob_contexts, pool):
    """Cornell + a 2k-triangle blob through the BVH on both sides, 16×16 at
    2 spp, depth 8: a pool smaller than the frame (64) and one that holds
    every sample (512)."""
    jctx, tctx = blob_contexts
    settings_j = jpath.RenderSettings(max_depth=8)
    want, w_rays = jax.jit(lambda k: jwavefront.trace_pool(
        jctx.cs, jctx.meta, settings_j, jctx.intersect, 16, 16, 2, k, pool,
        scheduler="queue", loop="while"))(jrng.render_key(0))
    before = tbvh_kernel.launches
    got, g_rays, iters = twavefront.trace_pool(
        tctx.cs, tctx.meta, tpath.RenderSettings(max_depth=8), tctx.intersect,
        16, 16, 2, trng.render_key(0), pool)
    assert tbvh_kernel.launches == before  # the plain traversal on the CPU
    assert iters >= -(-int(g_rays) // pool)
    _assert_close_images(got.numpy() / 2, np.asarray(want) / 2, int(g_rays),
                         int(w_rays))


def test_spectral_pool_matches_jax():
    """The spectral pyramid in mode "pool", 8×8 at 2 spp, depth 8: XYZ
    (after firefly rejection) and ACEScg within 1e-4 + 1e-5·|JAX| (XYZ
    reaches ~320 at the light)."""
    s_j, s_t = jpath.RenderSettings(max_depth=8), tpath.RenderSettings(max_depth=8)
    want = jrenderer.render(j_cbs(with_prism=True), 8, 8, 2, settings=s_j,
                            seed=3, mode="pool")
    got = trenderer.render(t_pyramid(), 8, 8, 2, s_t, seed=3, mode="pool",
                           device="cpu")
    assert got.iterations >= 1
    for g, w in ((got.xyz, want.xyz), (got.image, want.image)):
        assert g.shape == (8, 8, 3)
        _assert_close_images(g, w, got.rays_traced, want.rays_traced,
                             rtol=1e-5)


def test_cornell_box_obj_matches_jax():
    """cornell_box_obj (20,007 primitives, so a BVH on both sides) at 8×8,
    1 spp, depth 4: JAX's default mode takes its queue pool, the port's
    mode "pool" its own (its default takes the RGB megakernel's BVH form,
    tests/test_torch_megakernel_bvh.py)."""
    s_j, s_t = jpath.RenderSettings(max_depth=4), tpath.RenderSettings(max_depth=4)
    want = jrenderer.render(j_obj(), 8, 8, 1, settings=s_j, seed=0)
    ctx = trenderer.RenderContext(t_obj(), device="cpu")
    assert ctx.cs.prims.count == 20_007 and ctx.meta.n_lights == 2
    assert ctx.mega_supported() and ctx.mega_bvh() is ctx.intersect.ks
    got = trenderer.render(None, 8, 8, 1, s_t, seed=0, mode="pool",
                           context=ctx, device="cpu")
    assert got.iterations >= 1
    _assert_close_images(got.image, want.image, got.rays_traced,
                         want.rays_traced)


@pytest.mark.parametrize("pool", [37, 256])
def test_rgb_pool_equals_megakernel_plain_version(pool):
    """Cornell 8×8 at 4 spp, depth 6, brute force: the pool and the
    megakernel's plain version trace the same paths."""
    cs_ctx = trenderer.RenderContext(t_cornell(), device="cpu")
    s = tpath.RenderSettings(max_depth=6)
    key = trng.render_key(5)
    got, g_rays, _ = twavefront.trace_pool(cs_ctx.cs, cs_ctx.meta, s,
                                           cs_ctx.intersect, 8, 8, 4, key, pool)
    want, w_rays = tmega.render_slots_reference(cs_ctx.cs, cs_ctx.meta, s, 8, 8,
                                                4, key)
    assert int(g_rays) == int(w_rays)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_spectral_pool_equals_megakernel_plain_version():
    ctx = trenderer.RenderContext(t_pyramid(), device="cpu")
    s = tpath.RenderSettings(max_depth=6)
    key = trng.render_key(2)
    got, g_rays, _ = twavefront.trace_pool(
        ctx.cs, ctx.meta, s, ctx.intersect, 6, 6, 4, key, 50, spectral=True,
        bg_spd_id=ctx.meta.spectral_background_spd or 0)
    want, w_rays = tmks.render_slots_spectral_reference(ctx.cs, ctx.meta, s, 6,
                                                        6, 4, key)
    assert int(g_rays) == int(w_rays)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-4)


def test_sample_offset_chunks_sum_to_one_pass():
    ctx = trenderer.RenderContext(t_cornell(), device="cpu")
    s = tpath.RenderSettings(max_depth=5)
    key = trng.render_key(7)
    run = lambda spp, off: twavefront.trace_pool(  # noqa: E731
        ctx.cs, ctx.meta, s, ctx.intersect, 6, 6, spp, key, 40,
        sample_offset=off)
    whole, rays, _ = run(3, 0)
    parts = [run(1, off) for off in range(3)]
    assert sum(int(p[1]) for p in parts) == int(rays)
    np.testing.assert_allclose(sum(p[0] for p in parts).numpy(), whole.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_bvh_pool_equals_brute_pool():
    """use_bvh only changes the intersector: the same render through the
    plain BVH traversal and through brute force."""
    s = tpath.RenderSettings(max_depth=6)
    a = trenderer.render(t_cornell(), 8, 8, 2, s, seed=1, mode="pool",
                         use_bvh=True, device="cpu")
    b = trenderer.render(t_cornell(), 8, 8, 2, s, seed=1, mode="pool",
                         use_bvh=False, device="cpu")
    assert a.rays_traced == b.rays_traced and a.iterations == b.iterations
    np.testing.assert_allclose(a.image, b.image, rtol=1e-5, atol=1e-6)


def test_render_context_picks_the_intersector():
    small = trenderer.RenderContext(t_cornell(), device="cpu")
    assert small.intersect.__qualname__.startswith("make_brute_intersector")
    big = trenderer.RenderContext(t_obj(), device="cpu")
    assert big.meta.n_prims > trenderer.BVH_THRESHOLD
    # The kernel's intersector on any device; on the CPU it runs the plain
    # traversal (tests/test_torch_bvh.py).
    assert isinstance(big.intersect, tbvh_kernel.BVHKernelIntersector)
    # The tree reorders the primitives; the multiset stays.
    kinds = torch.sort(big.cs.prims.kind).values
    assert torch.equal(kinds, torch.sort(
        trenderer.RenderContext(t_obj(), use_bvh=False,
                                device="cpu").cs.prims.kind).values)


@pytest.mark.parametrize("extra,bvh", [
    (0, False),   # at the threshold
    (1, True),    # one primitive above it
])
def test_bvh_threshold_is_the_megakernel_cap(extra, bvh):
    """The port's policy (PERF.md, engine policy): brute force up to
    BVH_THRESHOLD primitives, the BVH above. The threshold is its own
    measured constant, at most the megakernels' cap (today equal to it), so
    every scene they take keeps brute force and its primitive order."""
    assert trenderer.BVH_THRESHOLD == 560 <= tmega.MAX_PRIMS
    scene = t_cornell()
    n_base = trenderer.RenderContext(scene, device="cpu").meta.n_prims
    n_tris = trenderer.BVH_THRESHOLD - n_base + extra
    rs = np.random.RandomState(n_tris)
    tris = rs.uniform(100.0, 400.0, (n_tris, 1, 3)) + rs.normal(size=(n_tris, 3, 3))
    scene.world.append(tst.TriangleMesh(vertices=tris, material=tst.Lambertian(
        albedo=tst.ConstantTexture((0.5, 0.5, 0.5)))))
    ctx = trenderer.RenderContext(scene, device="cpu")
    assert ctx.meta.n_prims == trenderer.BVH_THRESHOLD + extra
    assert isinstance(ctx.intersect, tbvh_kernel.BVHKernelIntersector) == bvh
