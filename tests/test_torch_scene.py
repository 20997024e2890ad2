"""izpi_tpu_torch's scene compiler vs the JAX package's, leaf for leaf.

Both compilers build the tables in float64 on the host and convert them to
float32 once, so every leaf the port reads must be EQUAL (no tolerance):
RGB scenes, the spectral Cornell box with and without its glass pyramid,
the float64-model scene of tests/test_exact_path_spectral.py and a scene
with every spectral element the port compiles, SPD table included.
"""

import numpy as np
import pytest
import torch

from _torch_port import (jax_leaves, mixed_scene, port_leaves,
                         spectral_mixed_scene, to_port_scene)
from izpi_tpu.scene import compiler as jcompiler
from izpi_tpu.scene import types as jst
from izpi_tpu.scene.library.cornell import cornell_box as j_cornell
from izpi_tpu.scene.library.cornell_spectral import (
    cornell_box_spectral as j_cbs)
from izpi_tpu.spectral import spd as jspd
from izpi_tpu_torch.scene import compiler as tcompiler
from izpi_tpu_torch.scene import types as tst
from izpi_tpu_torch.scene.library.cornell import cornell_box as t_cornell
from izpi_tpu_torch.scene.library.cornell_spectral import (
    cornell_box_pyramid_spectral as t_pyramid, cornell_box_spectral as t_cbs)
from izpi_tpu_torch.spectral import spd as tspd
import test_exact_path_spectral as exact

SCENES = {
    "cornell": (lambda: j_cornell(), lambda: t_cornell()),
    "mixed": (lambda: mixed_scene(jst), lambda: mixed_scene(tst)),
    "spectral": (lambda: j_cbs(), lambda: t_cbs()),
    "pyramid": (lambda: j_cbs(with_prism=True), lambda: t_pyramid()),
    "f64_model": (lambda: exact._scene(True),
                  lambda: to_port_scene(exact._scene(True))),
    "spectral_mixed": (lambda: spectral_mixed_scene(jst, jspd),
                       lambda: spectral_mixed_scene(tst, tspd)),
}


@pytest.fixture(scope="module")
def compiled():
    out = {}
    for name, (jmake, tmake) in SCENES.items():
        jcs, jmeta = jcompiler.compile_scene(jmake())
        tcs, tmeta = tcompiler.compile_scene(tmake(), "cpu")
        out[name] = (jax_leaves(jcs), jmeta, port_leaves(tcs), tmeta)
    return out


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("leaf", tcompiler.LEAVES)
def test_leaf_equal(compiled, scene, leaf):
    want, got = compiled[scene][0][leaf], compiled[scene][2][leaf]
    assert got.shape == want.shape, leaf
    if want.dtype == np.bool_:
        assert got.dtype == np.bool_
    elif np.issubdtype(want.dtype, np.integer):
        assert got.dtype == np.int32
    else:
        assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_meta_matches(compiled, scene):
    _, jmeta, _, tmeta = compiled[scene]
    for f in ("n_prims", "n_materials", "n_lights", "has_absorbing_dielectric",
              "spectral", "exposure", "spectral_background_spd",
              "has_checker", "has_image", "has_noise", "has_pbr", "n_media"):
        assert getattr(tmeta, f) == getattr(jmeta, f), f


def test_cornell_shape():
    cs, meta = tcompiler.compile_scene(t_cornell(), "cpu")
    assert meta.n_prims == 13 and meta.n_lights == 2
    assert cs.device == torch.device("cpu")


def test_pyramid_shape():
    """5 walls and the light (rects) plus the pyramid's 6 triangles; the
    light list holds the area light and, by the dielectric-IsEmitter
    quirk, the 6 glass triangles. SPD rows: the zero row, white, light,
    η(λ) and the background, last."""
    cs, meta = tcompiler.compile_scene(t_pyramid(), "cpu")
    assert meta.n_prims == 12 and meta.n_lights == 7
    assert meta.spectral and meta.spectral_background_spd == 4
    assert tuple(cs.spd_table.shape) == (5, 371)
    assert not cs.spd_table[0].any() and not cs.spd_table[4].any()


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_from_jax_arrays_round_trips(compiled, scene):
    leaves, jmeta, _, _ = compiled[scene]
    cs, meta = tcompiler.from_jax_arrays(leaves, "cpu", jax_meta=jmeta)
    back = port_leaves(cs)
    for k in tcompiler.LEAVES:
        np.testing.assert_array_equal(back[k], leaves[k])
    for f in ("n_prims", "n_lights", "has_absorbing_dielectric", "spectral",
              "exposure", "spectral_background_spd", "has_checker", "has_pbr"):
        assert getattr(meta, f) == getattr(jmeta, f), f


def test_from_jax_arrays_names_missing_leaves(compiled):
    leaves = dict(compiled["cornell"][0])
    del leaves["lights.area"]
    with pytest.raises(KeyError, match="lights.area"):
        tcompiler.from_jax_arrays(leaves, "cpu")


def _unsupported(st):
    """The elements the port compiled only from the slice that ported
    images, noise, media and the uplift (each raised NotImplementedError
    naming ROADMAP A11 until then), built from either package's
    scene.types `st`."""
    white = st.Lambertian(albedo=st.ConstantTexture((0.5, 0.5, 0.5)))
    box = st.Box((0, 0, 0), (1, 1, 1), white)
    img = np.linspace(0.0, 1.0, 12, dtype=np.float32).reshape(2, 2, 3)
    return {
        "image": st.Sphere((0, 0, 0), (0, 0, 0), 0, 1, 1, st.Lambertian(
            albedo=st.ImageTexture(img))),
        "noise": st.Sphere((0, 0, 0), (0, 0, 0), 0, 1, 1, st.Lambertian(
            albedo=st.NoiseTexture(4.0))),
        "medium": st.ConstantMedium(box, 0.01, st.Isotropic(
            albedo=st.ConstantTexture((1, 1, 1)))),
        # PBR with a noise or an image map in a slot.
        "mesh": st.TriangleMesh(np.eye(3)[None], st.PBR(
            roughness=st.NoiseTexture(2.0))),
        "pbr": st.Sphere((0, 0, 0), (0, 0, 0), 0, 1, 1, st.PBR(
            normal_map=st.ImageTexture(img))),
        # RGB-to-spectral uplift of an image.
        "spectral_albedo": st.Sphere((0, 0, 0), (0, 0, 0), 0, 1, 1,
                                     st.Lambertian(spectral_albedo=(
                                         st.SpectralImage(img.astype(
                                             np.float64))))),
    }


def _assert_compiles_as_jax(jscene, tscene):
    jcs, jmeta = jcompiler.compile_scene(jscene)
    tcs, tmeta = tcompiler.compile_scene(tscene, "cpu")
    want, got = jax_leaves(jcs), port_leaves(tcs)
    for leaf in tcompiler.LEAVES:
        assert got[leaf].shape == want[leaf].shape, leaf
        np.testing.assert_array_equal(got[leaf], want[leaf], err_msg=leaf)
    for f in ("has_image", "has_noise", "n_media", "media_is_sphere",
              "has_pbr", "spectral"):
        assert getattr(tmeta, f) == getattr(jmeta, f), f
    return tcs, tmeta


@pytest.mark.parametrize("kind", sorted(_unsupported(tst)))
def test_unsupported_element_raises(kind):
    """Each element that raised until ROADMAP A11 was ported now compiles
    leaf for leaf as the JAX package compiles it."""
    jscene, tscene = j_cornell(), t_cornell()
    jscene.world.append(_unsupported(jst)[kind])
    tscene.world.append(_unsupported(tst)[kind])
    _assert_compiles_as_jax(jscene, tscene)


def test_spectral_scene_raises():
    """A PBR material without a spectral albedo in a spectral scene, which
    raised until ROADMAP A11 was ported: the compile uplifts its RGB albedo
    (compiler.py:784-790), leaf for leaf as the JAX compile does."""
    jscene, tscene = j_cbs(), t_cbs()
    for sc, st in ((jscene, jst), (tscene, tst)):
        sc.world.append(st.Sphere((50, 20, 50), (50, 20, 50), 0, 1, 10,
                                  st.PBR()))
    tcs, tmeta = _assert_compiles_as_jax(jscene, tscene)
    assert tmeta.has_uplift and bool(tcs.materials.spec_albedo_uplift[-1])
