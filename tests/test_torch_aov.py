"""The AOV samplers and the spectral sampler of an RGB scene:
izpi_tpu_torch's render(sampler_type=...) vs the JAX package's
(izpi_tpu/integrator/aov.py, render/renderer.py:72-111,289-304).

Same scene, seed and frame. The AOVs read one first hit a sample: albedo
and normal equal JAX's within 1e-5 (sqrt and division ulps), wireframe's
ink-or-paper choice equal on every pixel. The JAX AOVs run eagerly
(`jax.disable_jit`): compiled, XLA contracts o + t·d into an FMA, and the
mixed scene's checker floor at y = 0 takes its colour from the sign of
that last ulp. The spectral upgrade of the RGB Cornell box runs the JAX
spectral pool (compiled) and the port's (the spectral megakernel takes
spectral scenes only): equal rays, XYZ and ACEScg within 1e-4 + 1e-4·|JAX|
(XYZ reaches ~7 here, and the compiled pool's FMAs move it by up to
4e-5 relative).
"""

import jax
import numpy as np
import pytest

from _torch_port import mixed_scene, to_port_scene
from izpi_tpu.integrator import path as jpath
from izpi_tpu.render import renderer as jrenderer
from izpi_tpu.scene import types as jst
from izpi_tpu.scene.library.cornell import cornell_box as j_cornell
from izpi_tpu_torch.integrator import path as tpath
from izpi_tpu_torch.render import renderer as trenderer

N, SPP, SEED = 8, 2, 4
INK = (0.9, 0.1, 0.2)
BG = (0.2, 0.3, 0.4)


@pytest.fixture(scope="module", params=["cornell", "mixed"])
def scene(request):
    return j_cornell() if request.param == "cornell" else mixed_scene(jst)


@pytest.mark.parametrize("sampler", ["albedo", "normal", "wireframe"])
def test_aov_matches_jax(scene, sampler):
    with jax.disable_jit():
        want = jrenderer.render(scene, N, N, SPP,
                                settings=jpath.RenderSettings(background=BG),
                                seed=SEED, sampler_type=sampler, ink=INK)
    got = trenderer.render(to_port_scene(scene), N, N, SPP,
                           tpath.RenderSettings(background=BG), seed=SEED,
                           sampler_type=sampler, ink=INK, device="cpu")
    assert got.image.shape == (N, N, 3) and got.image.dtype == np.float32
    assert got.rays_traced == want.rays_traced == N * N * SPP
    np.testing.assert_allclose(got.image, want.image, rtol=1e-5, atol=1e-5)
    if sampler == "wireframe":
        # Each pixel averages SPP ink-or-paper samples: the same mixes.
        np.testing.assert_array_equal(
            np.round(got.image, 4), np.round(np.asarray(want.image), 4))
    assert np.ptp(got.image) > 0


def test_aov_through_the_bvh_equals_brute_force():
    """An AOV through the plain BVH4 traversal (use_bvh) equals brute
    force's on the mixed scene: the first hits are the same primitives."""
    scene = to_port_scene(mixed_scene(jst))
    for sampler in ("albedo", "normal", "wireframe"):
        a = trenderer.render(scene, N, N, SPP, seed=SEED, sampler_type=sampler,
                             ink=INK, device="cpu")
        b = trenderer.render(scene, N, N, SPP, seed=SEED, sampler_type=sampler,
                             ink=INK, use_bvh=True, device="cpu")
        np.testing.assert_allclose(b.image, a.image, rtol=1e-6, atol=1e-6)


def test_spectral_sampler_on_an_rgb_scene_matches_jax():
    """The RGB Cornell box under sampler "spectral" (renderer.py:293):
    the spectral pool, 8×8 at 2 spp, depth 4, seed 4."""
    settings = jpath.RenderSettings(max_depth=4)
    want = jrenderer.render(j_cornell(), N, N, SPP, settings=settings,
                            seed=SEED, sampler_type="spectral")
    ctx = trenderer.RenderContext(to_port_scene(j_cornell()), device="cpu")
    assert ctx.mega_supported() and not ctx.mega_supported(spectral=True)
    got = trenderer.render(None, N, N, SPP, tpath.RenderSettings(max_depth=4),
                           seed=SEED, sampler_type="spectral", context=ctx,
                           device="cpu")
    assert got.xyz is not None and got.iterations >= 1
    assert got.rays_traced == want.rays_traced
    for g, w in ((got.xyz, want.xyz), (got.image, want.image)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-4)
    # "mega" refuses it: the spectral megakernel takes spectral scenes only.
    with pytest.raises(NotImplementedError, match="queue pool"):
        trenderer.render(None, N, N, 1, seed=SEED, sampler_type="spectral",
                         mode="mega", context=ctx, device="cpu")


def test_unknown_sampler_raises():
    with pytest.raises(ValueError, match="sampler"):
        trenderer.render(to_port_scene(j_cornell()), 4, 4, 1,
                         sampler_type="bogus", device="cpu")
