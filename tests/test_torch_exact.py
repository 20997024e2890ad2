"""izpi_tpu_torch's RGB engines against the independent float64 models of
tests/test_exact_path.py and tests/test_exact_path_materials.py.

Each model re-implements the reference estimator in scalar float64 and
shares only the Threefry streams with the engines, so it pins every pixel
of a tiny scene at 1 spp. The port's three RGB engines must reproduce it at
the JAX tests' own tolerances (2e-4 for the Lambertian scene, 3e-4 for the
materials): the lockstep oracle (`mode="simple"`), the queue pool
(`mode="pool"`) and the RGB megakernel through its plain version
(`mode="mega"` on the CPU) where the scene is the megakernel's. The scenes
are those of test_exact_path.py:180-196 and test_exact_path_materials.py:444
(metal fuzz), :463 (an absorbing dielectric sphere, also a light by the
reference's IsEmitter quirk) and :549 (a box of constant medium with the
isotropic phase).
"""

import functools

import numpy as np
import pytest

import test_exact_path as ep
import test_exact_path_materials as em
from _torch_port import to_port_scene
from izpi_tpu.core import rng as jrng
from izpi_tpu.scene import types as jst
from izpi_tpu_torch.integrator import path as tpath
from izpi_tpu_torch.render import renderer as trenderer

FLOOR = dict(kind="rect", p0=(-2.0, 0.0, -2.0), e1=(4.0, 0.0, 0.0),
             e2=(0.0, 0.0, 4.0), n=(0.0, 1.0, 0.0))


def _render(scene, mod, mode):
    settings = tpath.RenderSettings(max_depth=mod.DEPTH, background=mod.BG)
    ctx = trenderer.RenderContext(to_port_scene(scene), device="cpu")
    res = trenderer.render(None, mod.NX, mod.NY, mod.SPP, settings,
                           seed=mod.SEED, mode=mode, context=ctx, device="cpu")
    return res.image, ctx.mega_supported()


@functools.cache
def _model_image(case):
    """The f64 model's image of a case (slow: one scalar path per pixel),
    shared by the engines."""
    if case == "lambertian":
        return ep._expected_image(jrng.render_key(ep.SEED))
    return em._expected_image(CASES[case]()[1], jrng.render_key(em.SEED))


@pytest.mark.parametrize("mode", ["simple", "pool", "mega"])
def test_lambertian_scene_matches_f64_model(mode):
    """test_exact_path.py:180-196: a Lambertian floor under a one-sided
    rect light."""
    want = _model_image("lambertian")
    got, eligible = _render(ep._scene(), ep, mode)
    assert eligible
    ep._check(got, want, f"port, mode {mode}")


def _camera():
    return jst.Camera(look_from=em.LOOK_FROM, look_at=em.LOOK_AT, vfov=em.VFOV,
                      aspect=em.NX / em.NY)


def _metal_fuzz():
    alb, fuzz = (0.8, 0.6, 0.4), 0.25
    lt, lp, ll = em._light_objs()
    scene = jst.Scene(world=[jst.XZRect(-2, 2, -2, 2, 0.0,
                                        jst.Metal(albedo=alb, fuzz=fuzz)), lt],
                      camera=_camera())
    model = dict(prims=[dict(FLOOR, mat="m"), lp],
                 mats={"m": dict(kind="metal", albedo=alb, fuzz=fuzz),
                       "light": dict(kind="light")},
                 lights=[ll])
    return scene, model, True


def _absorbing_dielectric():
    absorb, c, r, alb = (0.8, 0.3, 0.1), (0.0, 0.7, 0.0), 0.5, (0.6, 0.5, 0.4)
    lt, lp, ll = em._light_objs()
    scene = jst.Scene(
        world=[jst.XZRect(-2, 2, -2, 2, 0.0,
                          jst.Lambertian(albedo=jst.ConstantTexture(alb))),
               jst.Sphere(c, c, 0.0, 1.0, r,
                          jst.Dielectric(ref_idx=1.5, absorption=absorb)),
               lt],
        camera=_camera())
    model = dict(prims=[dict(FLOOR, mat="floor"),
                        dict(kind="sphere", c=c, r=r, mat="glass"), lp],
                 mats={"floor": dict(kind="lambert", albedo=alb),
                       "glass": dict(kind="dielectric", ref_idx=1.5,
                                     absorption=absorb),
                       "light": dict(kind="light")},
                 lights=[dict(kind="sphere", c=c, r=r), ll])
    return scene, model, True


def _constant_medium():
    alb, iso, dens = (0.6, 0.5, 0.4), (0.9, 0.8, 0.7), 0.35
    lo, hi = (-2.0, 0.2, -2.0), (2.0, 1.8, 2.0)
    lt, lp, ll = em._light_objs()
    scene = jst.Scene(
        world=[jst.XZRect(-2, 2, -2, 2, 0.0,
                          jst.Lambertian(albedo=jst.ConstantTexture(alb))),
               jst.ConstantMedium(
                   boundary=jst.Box(lo, hi, jst.Lambertian(
                       albedo=jst.ConstantTexture((1, 1, 1)))),
                   density=dens,
                   phase=jst.Isotropic(albedo=jst.ConstantTexture(iso))),
               lt],
        camera=_camera())
    model = dict(prims=[dict(FLOOR, mat="floor"), lp],
                 mats={"floor": dict(kind="lambert", albedo=alb),
                       "light": dict(kind="light"),
                       "iso": dict(kind="isotropic", albedo=iso)},
                 lights=[ll],
                 media=[dict(lo=lo, hi=hi, density=dens, mat="iso")])
    return scene, model, False


CASES = {"metal_fuzz": _metal_fuzz,
         "absorbing_dielectric": _absorbing_dielectric,
         "constant_medium": _constant_medium}


@pytest.mark.parametrize("mode", ["simple", "pool", "mega"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_material_scene_matches_f64_model(case, mode):
    scene, _, mega = CASES[case]()
    want = _model_image(case)
    if mode == "mega" and not mega:
        # Media are not the megakernel's: the mode raises, as the JAX
        # renderer's does.
        with pytest.raises(NotImplementedError, match="queue pool"):
            _render(scene, em, mode)
        return
    got, eligible = _render(scene, em, mode)
    assert eligible == mega
    np.testing.assert_allclose(
        got, want, rtol=3e-4, atol=3e-4,
        err_msg=f"port, mode {mode}: diverges from the independent f64 model")
    assert got.mean() > 0.01
