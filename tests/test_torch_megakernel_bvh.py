"""The RGB megakernel's BVH form (`ops.megakernel.render_slots(...,
bvh=...)`, the entry `izpi_megakernel_rgb_bvh`) on the CPU, where it runs
its plain version: `render_slots_reference` through the plain BVH4
traversal (`accel.traverse.closest_bvh`) over the tree's reordered
primitives.

- Against the JAX package's queue pool through its BVH, on the Cornell box
  with a 2,000-triangle blob at 16×16@2, depth 8: the pools key the same
  (pixel, sample) pairs, so the rays are equal and the pixels pass
  `tests/test_torch_pool.py`'s gate (JAX's pool runs compiled, its tree is
  the median build, and XLA contracts multiply-adds into FMAs). Also with
  the glass sphere absorbing, which drives the Beer–Lambert exit re-trace
  through the tree.
- Against the port's own queue pool on the same context: equal rays,
  pixels within 1e-5 relative.
- Sample-offset chunks sum to one run.
- Routing: `render(mode="wavefront")` takes the BVH form on an RGB scene
  with a BVH4 and the pool on PBR, media, image, noise, spectral and
  row-stack-pair contexts; "mega" takes either form; no kernel counter
  moves on the CPU. `eligible_bvh` rejects each excluded kind.

The kernel itself is held against this plain version on a card in
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_port import to_port_scene, with_absorbing_glass
from test_torch_pool import _assert_close_images, _blob_box
from izpi_tpu.core import rng as jrng
from izpi_tpu.integrator import path as jpath
from izpi_tpu.integrator import wavefront as jwavefront
from izpi_tpu.render import renderer as jrenderer
from izpi_tpu.scene import types as jst
from izpi_tpu_torch import ops
from izpi_tpu_torch.core import rng as trng
from izpi_tpu_torch.integrator import path as tpath
from izpi_tpu_torch.integrator import wavefront as twavefront
from izpi_tpu_torch.ops import bvh_rowkernel, megakernel, megakernel_spectral
from izpi_tpu_torch.render import renderer as trenderer
from izpi_tpu_torch.scene.library.cornell import cornell_box as t_cornell

N, SPP, DEPTH = 16, 2, 8


@pytest.fixture(scope="module")
def blob():
    """The blob box's port context: 2,013 primitives, above BVH_THRESHOLD,
    so a BVH4 over reordered primitives."""
    return trenderer.RenderContext(to_port_scene(_blob_box()), device="cpu")


@pytest.mark.parametrize("absorbing", [False, True])
def test_plain_bvh_form_matches_jax_pool(blob, absorbing):
    """The default route of the port (the BVH form) against the JAX
    package's queue pool through its BVH (the route its renderer takes for
    such a scene), 16×16@2, depth 8; with `absorbing` the glass sphere
    absorbs, and its image differs from the clear glass's."""
    scene = _blob_box()
    if absorbing:
        scene = with_absorbing_glass(scene, jst)
    jctx = jrenderer.RenderContext(scene, use_bvh=True)
    want, w_rays = jax.jit(lambda k: jwavefront.trace_pool(
        jctx.cs, jctx.meta, jpath.RenderSettings(max_depth=DEPTH),
        jctx.intersect, N, N, SPP, k, N * N * SPP, scheduler="queue",
        loop="while"))(jrng.render_key(0))
    ctx = (trenderer.RenderContext(to_port_scene(scene), device="cpu")
           if absorbing else blob)
    assert ctx.mega_bvh() is not None
    got = trenderer.render(None, N, N, SPP, tpath.RenderSettings(
        max_depth=DEPTH), seed=0, context=ctx, device="cpu")
    assert got.iterations is None and got.trips is None
    assert got.rays_traced == int(w_rays)
    img = (np.asarray(want, np.float64) / SPP).reshape(N, N, 3)[::-1]
    _assert_close_images(got.image, img, got.rays_traced, int(w_rays))
    if absorbing:
        assert bool(ctx.cs.materials.has_absorption.any())
        clear = trenderer.render(None, N, N, SPP, tpath.RenderSettings(
            max_depth=DEPTH), seed=0, context=blob, device="cpu")
        assert np.abs(clear.image - got.image).max() > 1e-3


def test_plain_bvh_form_equals_port_pool(blob):
    """The BVH form's plain version and the port's queue pool trace the
    same paths through the same tree: equal rays, pixels within 1e-5
    relative."""
    s = tpath.RenderSettings(max_depth=DEPTH)
    key = trng.render_key(4)
    got, g_rays = megakernel.render_slots(blob.cs, blob.meta, s, N, N, SPP,
                                          key, bvh=blob.mega_bvh())
    want, w_rays, _ = twavefront.trace_pool(blob.cs, blob.meta, s,
                                            blob.intersect, N, N, SPP, key,
                                            N * N * SPP)
    assert int(g_rays) == int(w_rays)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-7)


def test_sample_offset_chunks_sum_to_one_run(blob):
    """Offsets 0 and 2 of a 2-spp run sum to one 4-spp run, the
    checkpoint contract, at 8×8, depth 5."""
    s = tpath.RenderSettings(max_depth=5)
    key = trng.render_key(7)
    run = lambda spp, off: megakernel.render_slots(  # noqa: E731
        blob.cs, blob.meta, s, 8, 8, spp, key, off, bvh=blob.mega_bvh())
    full, n_full = run(4, 0)
    (a0, n0), (a1, n1) = run(2, 0), run(2, 2)
    assert int(n0) + int(n1) == int(n_full)
    np.testing.assert_allclose((a0 + a1).numpy(), full.numpy(), rtol=1e-5,
                               atol=1e-6)


class _Spy:
    """Wrappers of the megakernel's and the pool's entries that record
    which one ran; with run_pool=False the pool's returns an empty frame
    without running (for a meta whose flags its tables do not back)."""

    def __init__(self, monkeypatch, run_pool=True):
        self.calls = []
        slots, pool = megakernel.render_slots, twavefront.trace_pool

        def spy_slots(*args, bvh=None, **kw):
            self.calls.append("bvh" if bvh is not None else "brute")
            return slots(*args, bvh=bvh, **kw)

        def spy_pool(cs, meta, settings, intersect, nx, ny, *args, **kw):
            self.calls.append("pool")
            if run_pool:
                return pool(cs, meta, settings, intersect, nx, ny, *args, **kw)
            if kw.get("stats") is not None:
                kw["stats"].update(trips=1, replays=0, capture_seconds=0.0)
            return (torch.zeros((nx * ny, 3)),
                    torch.zeros((), dtype=torch.int64), 1)

        monkeypatch.setattr(megakernel, "render_slots", spy_slots)
        monkeypatch.setattr(twavefront, "trace_pool", spy_pool)


def test_wavefront_and_mega_take_the_bvh_form(blob, monkeypatch):
    """An RGB scene with a BVH4: "wavefront" and "mega" launch nothing on
    the CPU and run the BVH form's plain version, "pool" the pool, with
    equal rays; a chunked render (progress) runs the BVH form per chunk."""
    spy = _Spy(monkeypatch)
    before = ops.launch_counts()
    s = tpath.RenderSettings(max_depth=3)
    res = {mode: trenderer.render(None, 4, 4, 8, s, seed=2, mode=mode,
                                  context=blob, device="cpu")
           for mode in ("wavefront", "mega", "pool")}
    assert spy.calls == ["bvh", "bvh", "pool"]
    chunked = trenderer.render(None, 4, 4, 8, s, seed=2, context=blob,
                               device="cpu", verbose=True)
    assert spy.calls[3:] == ["bvh"] * 8
    assert ops.launch_counts() == before
    assert res["wavefront"].rays_traced == res["pool"].rays_traced
    assert chunked.rays_traced == res["pool"].rays_traced
    np.testing.assert_array_equal(res["wavefront"].image, res["mega"].image)
    np.testing.assert_allclose(chunked.image, res["pool"].image, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("field,value", [
    ("has_pbr", True), ("n_media", 1), ("has_image", True),
    ("has_noise", True), ("spectral", True)])
def test_wavefront_takes_the_pool_where_the_kernel_does_not_shade(
        blob, monkeypatch, field, value):
    """A BVH context whose meta flags a PBR material, a medium, an image,
    noise or spectral transport: `eligible_bvh` fails and "wavefront"
    sends the scene to the pool, the route the JAX renderer takes; "mega"
    raises."""
    spy = _Spy(monkeypatch, run_pool=False)
    monkeypatch.setattr(blob.meta, field, value)
    assert not megakernel.eligible_bvh(blob.cs, blob.meta, blob.intersect)
    assert blob.mega_bvh() is None and not blob.mega_supported()
    if field == "spectral":
        # The spectral megakernel's rule (at most 560 primitives) fails too.
        assert not megakernel_spectral.eligible(blob.cs, blob.meta)
        return
    trenderer.render(None, 2, 2, 1, tpath.RenderSettings(max_depth=2),
                     context=blob, device="cpu")
    assert spy.calls == ["pool"]
    with pytest.raises(NotImplementedError, match="queue pool"):
        trenderer.render(None, 2, 2, 1, mode="mega", context=blob,
                         device="cpu")


def test_spectral_sampler_and_row_pair_take_the_pool(blob, monkeypatch):
    """The spectral sampler on the RGB BVH scene and a context holding the
    row-stack pair (`bvh_rowkernel.attach`) both take the pool."""
    spy = _Spy(monkeypatch)
    s = tpath.RenderSettings(max_depth=2)
    res = trenderer.render(None, 2, 2, 1, s, context=blob,
                           sampler_type="spectral", device="cpu")
    assert res.xyz is not None and res.iterations >= 1
    ctx = trenderer.RenderContext(to_port_scene(_blob_box()), use_bvh=False,
                                  device="cpu")
    ctx.cs, ctx.intersect = bvh_rowkernel.attach(ctx.cs)
    assert ctx.mega_bvh() is None and not ctx.mega_supported()
    res = trenderer.render(None, 2, 2, 1, s, context=ctx, device="cpu")
    assert res.iterations >= 1
    assert spy.calls == ["pool", "pool"]


def test_eligible_bvh_rejects_each_excluded_kind(blob):
    """`eligible_bvh` holds on the blob box and fails for each kind the
    kernel does not shade, for a scene of no primitives, and for a context
    whose intersector is brute force or not over its own primitives."""
    cs, meta, inter = blob.cs, blob.meta, blob.intersect
    assert megakernel.eligible_bvh(cs, meta, inter)
    assert not megakernel.eligible(cs, meta)  # above the 560 cap
    for field, value in (("spectral", True), ("has_pbr", True),
                         ("n_media", 1), ("has_image", True),
                         ("has_noise", True), ("n_prims", 0)):
        old = getattr(meta, field)
        setattr(meta, field, value)
        try:
            assert not megakernel.eligible_bvh(cs, meta, inter)
        finally:
            setattr(meta, field, old)
    brute = trenderer.RenderContext(t_cornell(), device="cpu")
    assert not megakernel.eligible_bvh(brute.cs, brute.meta, brute.intersect)
    assert brute.mega_bvh() is None and brute.mega_supported()
    other = cs._replace(prims=cs.prims)
    assert not megakernel.eligible_bvh(other, meta, inter)


def test_bvh_form_rejects_a_tree_of_another_scene(blob):
    """The wrapper raises when the tree holds another primitive count than
    the scene, and asks for the BVH form's draw and traversal counts only
    on the card."""
    s = tpath.RenderSettings(max_depth=2)
    small = trenderer.RenderContext(t_cornell(), use_bvh=True, device="cpu")
    with pytest.raises(ValueError, match="primitives"):
        megakernel.render_slots(small.cs, small.meta, s, 2, 2, 1,
                                trng.render_key(0), bvh=blob.mega_bvh())
    with pytest.raises(ValueError, match="draw counts"):
        megakernel.render_slots(blob.cs, blob.meta, s, 2, 2, 1,
                                trng.render_key(0), bvh=blob.mega_bvh(),
                                draws=True)
