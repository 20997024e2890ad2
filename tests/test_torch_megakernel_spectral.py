"""izpi_tpu_torch's spectral megakernel (its plain version, on the CPU) vs
the JAX package.

On the CPU the wrapper runs `render_slots_spectral_reference`. It is held
against the JAX spectral pool (same Threefry streams, same grid lerps: ray
counts equal, XYZ within 1e-5), against the Pallas spectral kernel in
interpret mode at that test's own 2e-4 (tests/test_megakernel_spectral.py:
the Pallas kernel evaluates SPDs from piecewise-linear knots, not the grid),
and against the independent float64 model of tests/test_exact_path_spectral
at its 1e-3. The CUDA kernel is held against the plain version in
tests/test_torch_cuda.py, which imports no JAX.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_port import jax_leaves, to_port_scene
from izpi_tpu.core import rng as jrng
from izpi_tpu.integrator import path as jpath
from izpi_tpu.ops import megakernel_spectral as jmks
from izpi_tpu.render import renderer as jrenderer
from izpi_tpu.scene.compiler import compile_scene as jcompile
from izpi_tpu.scene.library import REGISTRY as JREGISTRY
from izpi_tpu.scene.library.cornell_spectral import (
    cornell_box_spectral as j_cbs)
from izpi_tpu_torch.core import rng as trng
from izpi_tpu_torch.integrator import path as tpath
from izpi_tpu_torch.ops import megakernel_spectral as tmks
from izpi_tpu_torch.scene import compiler as tcompiler
from izpi_tpu_torch.scene.library.cornell_spectral import (
    cornell_box_pyramid_spectral, cornell_box_spectral)
import test_exact_path_spectral as exact

NX = NY = 12
SPP = 4
DEPTH = 8
SEED = 5


@pytest.fixture(scope="module")
def pyramid():
    """The JAX context of the pyramid and the port's scene on its tables."""
    ctx = jrenderer.RenderContext(j_cbs(aspect=1.0, with_prism=True),
                                  use_bvh=False)
    cs, meta = tcompiler.from_jax_arrays(jax_leaves(ctx.cs), "cpu",
                                         jax_meta=ctx.meta)
    return ctx, cs, meta


@pytest.fixture(scope="module")
def plain(pyramid):
    _, cs, meta = pyramid
    acc, rays = tmks.render_slots_spectral(
        cs, meta, tpath.RenderSettings(max_depth=DEPTH), NX, NY, SPP,
        trng.render_key(SEED))
    assert acc.shape == (NX * NY, 3) and acc.dtype == torch.float32
    return acc.numpy(), int(rays)


def test_plain_matches_jax_pool(pyramid, plain):
    """Pyramid 12×12 at 4 spp, depth 8: the JAX spectral pool draws the same
    samples in another order, so ray counts are equal and XYZ agrees to
    float32 summation order."""
    ctx = pyramid[0]
    pool = ctx.pool_runner(NX, NY, True, ctx.meta.spectral_background_spd,
                           jpath.RenderSettings(max_depth=DEPTH))
    want, w_rays = pool(jrng.render_key(SEED), SPP, NX * NY * SPP, 0)
    got, g_rays = plain
    assert g_rays == int(w_rays)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_plain_matches_pallas_kernel(pyramid, plain):
    ctx = pyramid[0]
    run = jax.jit(jmks.build_renderer(
        ctx.cs, ctx.meta, jpath.RenderSettings(max_depth=DEPTH), NX, NY, SPP,
        interpret=True))
    want, w_rays = run(jrng.render_key(SEED), 0)
    got, g_rays = plain
    assert g_rays == int(w_rays)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("with_sphere", [False, True])
def test_plain_matches_f64_model(with_sphere):
    """The 8×8 scene of tests/test_exact_path_spectral.py (Gaussian floor
    and light, flat background, a dispersive glass sphere), compiled by the
    port, against its independent float64 estimator at that test's 1e-3."""
    cs, meta = tcompiler.compile_scene(
        to_port_scene(exact._scene(with_sphere)), "cpu")
    assert tmks.eligible(cs, meta)
    got, _ = tmks.render_slots_spectral(
        cs, meta, tpath.RenderSettings(max_depth=exact.DEPTH), exact.NX,
        exact.NY, exact.SPP, trng.render_key(exact.SEED))
    want = exact._expected_acc(jrng.render_key(exact.SEED), with_sphere)
    exact._check(got.numpy(), want, f"port plain version (sphere="
                                    f"{with_sphere})")


def test_sample_offset_chunks_sum_to_one_run(pyramid):
    _, cs, meta = pyramid
    s = tpath.RenderSettings(max_depth=4)
    key = trng.render_key(7)
    full, n_full = tmks.render_slots_spectral(cs, meta, s, 6, 6, 4, key, 0)
    a0, n0 = tmks.render_slots_spectral(cs, meta, s, 6, 6, 2, key, 0)
    a1, n1 = tmks.render_slots_spectral(cs, meta, s, 6, 6, 2, key, 2)
    np.testing.assert_allclose((a0 + a1).numpy(), full.numpy(), rtol=1e-6,
                               atol=1e-4)
    assert int(n0) + int(n1) == int(n_full)


# Spectral scenes of both libraries.
ELIGIBILITY_SCENES = sorted(
    name for name in JREGISTRY if "spectral" in name) + [
    "f64_model", "f64_model_sphere"]


def _jax_scene(name):
    if name.startswith("f64_model"):
        return exact._scene(name.endswith("sphere"))
    return JREGISTRY[name](1.0)


@pytest.mark.filterwarnings("ignore::UserWarning")
@pytest.mark.parametrize("name", ELIGIBILITY_SCENES)
def test_eligible_agrees_with_jax(name, monkeypatch):
    """The JAX rule without its MAX_KNOTS budget, a Mosaic unroll limit the
    CUDA kernel does not have. A scene the port cannot compile yet (PBR,
    uplift: ROADMAP A11) is one the JAX kernel does not take either."""
    jscene = _jax_scene(name)
    monkeypatch.setattr(jmks, "MAX_KNOTS", 1 << 30)
    jcs, jmeta = jcompile(jscene)
    try:
        cs, meta = tcompiler.compile_scene(to_port_scene(jscene), "cpu")
    except NotImplementedError as exc:
        assert "ROADMAP A11" in str(exc)
        assert not jmks.eligible(jcs, jmeta)
        return
    assert tmks.eligible(cs, meta) == jmks.eligible(jcs, jmeta)


def test_eligibility_rule():
    cs, meta = tcompiler.compile_scene(cornell_box_pyramid_spectral(), "cpu")
    assert tmks.eligible(cs, meta)
    for field, value in (("spectral", False), ("has_pbr", True), ("n_media", 1),
                         ("has_image", True), ("has_noise", True),
                         ("has_checker", True), ("n_prims", 561),
                         ("n_prims", 0), ("spectral_background_spd", None)):
        old = getattr(meta, field)
        setattr(meta, field, value)
        try:
            assert not tmks.eligible(cs, meta), field
        finally:
            setattr(meta, field, old)
    m = cs.materials
    for col in ("spec_checker", "spec_albedo_uplift"):
        flagged = m._replace(**{col: torch.ones_like(getattr(m, col))})
        assert not tmks.eligible(cs._replace(materials=flagged), meta), col


def test_ineligible_scene_raises():
    cs, meta = tcompiler.compile_scene(cornell_box_spectral(), "cpu")
    meta.spectral_background_spd = None
    with pytest.raises(NotImplementedError, match="queue pool"):
        tmks.render_slots_spectral(cs, meta, tpath.RenderSettings(), 2, 2, 1,
                                   trng.render_key(0))


def test_pack_spectral_tables_layout():
    cs, meta = tcompiler.compile_scene(cornell_box_pyramid_spectral(), "cpu")
    t = tmks.pack_spectral_tables(cs)
    m = cs.materials
    assert t.spec_f.shape == (meta.n_materials, tmks.SPEC_F)
    assert t.spec_i.shape == (meta.n_materials, tmks.SPEC_I)
    assert t.spec_i.dtype == torch.int32 and t.spd.dtype == torch.float32
    np.testing.assert_array_equal(t.spec_f[:, 0:3].numpy(),
                                  m.spec_albedo_gauss.numpy())
    np.testing.assert_array_equal(
        t.spec_i[:, 0:3].numpy(),
        torch.stack([m.spec_albedo_id, m.spec_ref_idx_id, m.spec_absorb_id],
                    1).numpy())
    np.testing.assert_array_equal(t.spd.numpy(), cs.spd_table.numpy())
    assert t.cie.shape == (tmks.CIE_ROWS, 75)
    # The last row is the f32 cumsum the sampler searches.
    assert float(t.cie[3, -1]) == pytest.approx(21.371, abs=1e-3)
    assert all(x.is_contiguous() for x in t[1:])


def test_cpu_tensor_runs_the_plain_version():
    cs, meta = tcompiler.compile_scene(cornell_box_pyramid_spectral(), "cpu")
    s = tpath.RenderSettings(max_depth=3)
    before = tmks.launches
    a, n = tmks.render_slots_spectral(cs, meta, s, 4, 4, 1, trng.render_key(1))
    b, m = tmks.render_slots_spectral_reference(cs, meta, s, 4, 4, 1,
                                                trng.render_key(1))
    assert tmks.launches == before
    assert torch.equal(a, b) and int(n) == int(m)
