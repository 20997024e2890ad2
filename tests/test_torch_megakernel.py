"""izpi_tpu_torch's RGB megakernel vs the JAX package's Pallas megakernel.

On the CPU the wrapper runs its plain twin (`render_slots_reference`); it is
held against `izpi_tpu.ops.megakernel.build_renderer(..., interpret=True)`
on the same tables with the contract of tests/test_megakernel.py:35-37:
equal ray counts and images within 1e-5. The CUDA kernel is held against the
twin in tests/test_torch_cuda.py, which imports no JAX so that it runs on a
machine with a card.
"""

import numpy as np
import pytest
import torch

from _torch_port import jax_leaves
from izpi_tpu.core import rng as jrng
from izpi_tpu.integrator import path as jpath
from izpi_tpu.ops import megakernel as jmega
from izpi_tpu.render import renderer as jrenderer
from izpi_tpu.scene.library.cornell import cornell_box as j_cornell
from izpi_tpu_torch.core import rng as trng
from izpi_tpu_torch.integrator import path as tpath
from izpi_tpu_torch.ops import megakernel as tmega
from izpi_tpu_torch.scene import compiler as tcompiler
from izpi_tpu_torch.scene.library.cornell import cornell_box as t_cornell


@pytest.fixture(scope="module")
def jctx():
    return jrenderer.RenderContext(j_cornell(aspect=1.0))


@pytest.fixture(scope="module")
def port(jctx):
    return tcompiler.from_jax_arrays(jax_leaves(jctx.cs), "cpu")


def test_twin_matches_pallas_megakernel(jctx, port):
    """Cornell 8×8 at 2 spp, depth 4, seed 3; images (sums / spp) within
    1e-5 as in tests/test_megakernel.py:35-37. The sums differ by up to
    2e-5: the Pallas kernel multiplies by reciprocals (`_norm`, `_onb_from_w`,
    the f64-folded 1/|e|² of `_rect_test`) where the twin, like the JAX
    oracle, divides."""
    nx = ny = 8
    spp = 2
    run = jctx.mega_runner(nx, ny, spp, jpath.RenderSettings(max_depth=4),
                           interpret=True)
    want, w_rays = run(jrng.render_key(3), 0)
    cs, meta = port
    got, g_rays = tmega.render_slots(cs, meta, tpath.RenderSettings(max_depth=4),
                                     nx, ny, spp, trng.render_key(3), 0)
    assert int(g_rays) == int(w_rays)
    np.testing.assert_allclose(got.numpy() / spp, np.asarray(want) / spp,
                               atol=1e-5)
    assert got.shape == (nx * ny, 3) and got.dtype == torch.float32


def test_sample_offset_chunks_sum_to_one_run(port):
    """Offsets 0 and 2 of a 2-spp run sum to one 4-spp run — the
    checkpoint/resume contract (tests/test_megakernel.py:87-101)."""
    cs, meta = port
    s = tpath.RenderSettings(max_depth=3)
    key = trng.render_key(7)
    full, n_full = tmega.render_slots(cs, meta, s, 8, 8, 4, key, 0)
    a0, n0 = tmega.render_slots(cs, meta, s, 8, 8, 2, key, 0)
    a1, n1 = tmega.render_slots(cs, meta, s, 8, 8, 2, key, 2)
    np.testing.assert_allclose((a0 + a1).numpy(), full.numpy(), atol=1e-5)
    assert int(n0) + int(n1) == int(n_full)


@pytest.mark.parametrize("n_pix,spp", [(64, 2), (64, 4), (4096, 4), (65536, 1024),
                                       (100, 6), (1, 1)])
def test_replication_matches_jax(n_pix, spp):
    assert tmega.pick_replication(n_pix, spp) == jmega._pick_replication(
        n_pix, spp, min_slots=8192)


def test_eligibility_rule(jctx, port):
    cs, meta = port
    assert tmega.eligible(cs, meta) == jmega.eligible(jctx.cs, jctx.meta) is True
    for field, value in (("spectral", True), ("has_pbr", True), ("n_media", 1),
                         ("has_image", True), ("has_noise", True),
                         ("n_prims", 561), ("n_prims", 0)):
        old = getattr(meta, field)
        setattr(meta, field, value)
        try:
            assert not tmega.eligible(cs, meta)
        finally:
            setattr(meta, field, old)


def test_ineligible_scene_raises(port):
    cs, meta = port
    old = meta.n_prims
    meta.n_prims = tmega.MAX_PRIMS + 1
    try:
        with pytest.raises(NotImplementedError, match="queue pool"):
            tmega.render_slots(cs, meta, tpath.RenderSettings(), 2, 2, 1,
                               trng.render_key(0))
    finally:
        meta.n_prims = old


def test_pack_tables_layout(port):
    cs, meta = port
    t = tmega.pack_tables(cs)
    assert t.prim_f.shape == (meta.n_prims, tmega.PRIM_F)
    assert t.prim_i.dtype == torch.int32 and t.mat_i.dtype == torch.int32
    np.testing.assert_array_equal(t.prim_f[:, 0:3].numpy(), cs.prims.g0.numpy())
    np.testing.assert_array_equal(t.prim_f[:, 12:21].numpy(), cs.prims.vn.numpy())
    np.testing.assert_array_equal(t.prim_i[:, 1].numpy(), cs.prims.mat_id.numpy())
    np.testing.assert_array_equal(t.prim_i[:, 2].numpy(),
                                  cs.prims.flip.int().numpy())
    light = int((cs.materials.kind == 3).nonzero()[0, 0])
    np.testing.assert_array_equal(t.mat_f[light, 0:3].numpy(), [15.0, 15.0, 15.0])
    np.testing.assert_array_equal(t.light_f[:, 12].numpy(),
                                  cs.lights.area.numpy())
    np.testing.assert_array_equal(t.cam[18:21].numpy(), [0.0, 0.0, 1.0])
    assert all(x.is_contiguous() for x in t)


def test_cpu_tensor_runs_the_twin():
    cs, meta = tcompiler.compile_scene(t_cornell(), "cpu")
    before = tmega.launches
    a, n = tmega.render_slots(cs, meta, tpath.RenderSettings(max_depth=2), 4, 4,
                              1, trng.render_key(1))
    b, m = tmega.render_slots_reference(cs, meta,
                                        tpath.RenderSettings(max_depth=2), 4, 4,
                                        1, trng.render_key(1))
    assert tmega.launches == before
    assert torch.equal(a, b) and int(n) == int(m)
