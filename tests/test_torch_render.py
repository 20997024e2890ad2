"""izpi_tpu_torch.render vs the JAX package's renderer, plus the port's
import and device rules."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from izpi_tpu.integrator import path as jpath
from izpi_tpu.render import renderer as jrenderer
from izpi_tpu.scene.library.cornell import cornell_box as j_cornell
from izpi_tpu.scene.library.cornell_spectral import (
    cornell_box_spectral as j_cbs)
from izpi_tpu_torch.core import rng as trng
from izpi_tpu_torch.integrator import path as tpath
from izpi_tpu_torch.integrator import wavefront as twavefront
from izpi_tpu_torch.ops import megakernel as tmega
from izpi_tpu_torch.render import renderer as trenderer
from izpi_tpu_torch.scene import types as tst
from izpi_tpu_torch.scene.library.cornell import cornell_box as t_cornell
from izpi_tpu_torch.scene.library.cornell_spectral import (
    cornell_box_spectral as t_cbs)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_image():
    return jrenderer.render(j_cornell(), 8, 8, 2,
                            settings=jpath.RenderSettings(max_depth=4), seed=3,
                            mode="simple")


@pytest.mark.parametrize("mode", ["wavefront", "simple"])
def test_render_matches_jax_simple(jax_image, mode):
    """Cornell 8×8 at 2 spp, depth 4, seed 3: image within 1e-5, equal
    ray counts."""
    got = trenderer.render(t_cornell(), 8, 8, 2, tpath.RenderSettings(max_depth=4),
                           seed=3, mode=mode, device="cpu")
    assert got.image.shape == (8, 8, 3) and got.image.dtype == np.float32
    assert got.rays_traced == jax_image.rays_traced
    np.testing.assert_allclose(got.image, jax_image.image, atol=1e-5)
    assert got.device == "cpu" and got.mrays_per_sec > 0


def test_context_reuse_and_mega_mode():
    ctx = trenderer.RenderContext(t_cornell(), device="cpu")
    assert ctx.mega_supported()
    a = trenderer.render(None, 4, 4, 1, tpath.RenderSettings(max_depth=3),
                         seed=1, mode="mega", context=ctx, device="cpu")
    b = trenderer.render(None, 4, 4, 1, tpath.RenderSettings(max_depth=3),
                         seed=1, mode="wavefront", context=ctx, device="cpu")
    np.testing.assert_array_equal(a.image, b.image)
    assert a.rays_traced == b.rays_traced


def test_port_imports_no_jax():
    """Every izpi_tpu_torch module imports without JAX or izpi_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import izpi_tpu_torch\n"
        "for m in pkgutil.walk_packages(izpi_tpu_torch.__path__, 'izpi_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'izpi_tpu.'))"
        " or m == 'izpi_tpu']\n"
        "assert not bad, bad\n"
        "print(' '.join(m for m in sys.modules if m.startswith('izpi_tpu_torch')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = set(out.stdout.split())
    assert len(loaded) >= 28
    for name in ("spectral.cie", "spectral.spd", "spectral.convert",
                 "materials.spectral_eval", "integrator.wavefront",
                 "ops.megakernel_spectral", "scene.library.cornell_spectral",
                 "accel.bvh_build", "accel.native", "accel.traverse",
                 "ops.bvh_kernel", "geometry.procedural",
                 "scene.library.misc"):
        assert f"izpi_tpu_torch.{name}" in loaded, name


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        trenderer.render(t_cornell(), 4, 4, 1, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        trenderer.RenderContext(t_cornell(), device="cuda")


def test_entry_points_default_to_the_card(monkeypatch):
    """render() and RenderContext() run on "cuda" unless asked for the CPU;
    without a card that raises, and nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="'cuda' requested"):
        trenderer.render(t_cornell(), 4, 4, 1)
    with pytest.raises(RuntimeError, match="'cuda' requested"):
        trenderer.RenderContext(t_cornell())


@pytest.fixture(scope="module")
def jax_spectral():
    return jrenderer.render(j_cbs(), 10, 10, 4,
                            settings=jpath.RenderSettings(max_depth=6), seed=3)


def test_spectral_render_matches_jax(jax_spectral):
    """The spectral Cornell box 10×10 at 4 spp, depth 6, seed 3: the JAX
    renderer runs its spectral pool on the CPU, the port the spectral
    megakernel's plain version; the same samples, summed in another order.
    Equal ray counts; XYZ (after firefly rejection) and ACEScg within 1e-5
    relative, 1e-4 absolute (XYZ reaches ~320 at the light)."""
    got = trenderer.render(t_cbs(), 10, 10, 4, tpath.RenderSettings(max_depth=6),
                           seed=3, device="cpu")
    want = jax_spectral
    assert got.rays_traced == want.rays_traced
    for g, w in ((got.xyz, want.xyz), (got.image, want.image)):
        assert g.shape == (10, 10, 3) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4)
    # ACEScg: the green wall on the image's left, the red one on its right.
    left = got.image[2:8, 0:2].mean(axis=(0, 1))
    right = got.image[2:8, -2:].mean(axis=(0, 1))
    assert left[1] > left[0] and right[0] > right[1]


def _empty_pool(scene, pool_size):
    ctx = trenderer.RenderContext(scene, device="cpu")
    twavefront.trace_pool(ctx.cs, ctx.meta, tpath.RenderSettings(max_depth=2),
                          ctx.intersect, 4, 4, 1, trng.render_key(0), pool_size,
                          spectral=ctx.meta.spectral)


@pytest.mark.parametrize("mode", ["simple", "pool"])
def test_spectral_simple_and_pool_modes_raise(mode):
    """A spectral scene: the lockstep oracle renders RGB scenes only; the
    queue pool, which renders it (tests/test_torch_pool.py), raises on a
    pool without slots."""
    if mode == "simple":
        with pytest.raises(NotImplementedError, match="RGB scenes only"):
            trenderer.render(t_cbs(), 4, 4, 1, mode=mode, device="cpu")
    else:
        with pytest.raises(ValueError, match="pool_size"):
            _empty_pool(t_cbs(), 0)


def test_pool_mode_raises():
    """The queue pool renders any scene (tests/test_torch_pool.py) and
    raises on a pool without slots."""
    with pytest.raises(ValueError, match="pool_size"):
        _empty_pool(t_cornell(), -1)


def test_unknown_mode_and_device_raise():
    with pytest.raises(ValueError, match="mode"):
        trenderer.render(t_cornell(), 4, 4, 1, mode="bogus", device="cpu")
    with pytest.raises(ValueError, match="device"):
        trenderer.render(t_cornell(), 4, 4, 1, device="meta")


def test_ineligible_scene_raises_in_wavefront_mode():
    """A scene the megakernel does not take: "wavefront" renders it through
    the queue pool, as the JAX renderer does, and "mega" raises."""
    white = tst.Lambertian(albedo=tst.ConstantTexture((0.5, 0.5, 0.5)))
    world = [tst.Sphere((i, 0, 0), (i, 0, 0), 0, 1, 0.4, white)
             for i in range(tmega.MAX_PRIMS + 1)]
    scene = tst.Scene(world=world, camera=tst.Camera(look_from=(0, 0, -5),
                                                     look_at=(0, 0, 0)))
    res = trenderer.render(scene, 2, 2, 1, device="cpu")
    assert res.iterations >= 1 and res.rays_traced >= 4
    with pytest.raises(NotImplementedError, match="queue pool"):
        trenderer.render(scene, 2, 2, 1, mode="mega", device="cpu")
