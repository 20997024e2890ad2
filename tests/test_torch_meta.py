"""The placeholder-asset flag: izpi_tpu_torch's `SceneMeta.placeholder_assets`
against the JAX package's, and the NOTE `render()` prints for it.

A scene that stands a procedural placeholder in for a missing file says so
in its compiled meta (`izpi_tpu/scene/compiler.py:83-85,858`), and a render
of it prints the JAX renderer's NOTE to stderr once per context
(`izpi_tpu/render/renderer.py:281-287`): a `.pbtxt` whose texture file is
missing (on a material no object uses) and the dragon scene, whose mesh
is the procedural stand-in.
"""

import warnings

import numpy as np
import pytest

from izpi_tpu.scene import compiler as jcompiler
from izpi_tpu.scene import pbtxt as jpbtxt
from izpi_tpu.scene.library import extracted as jextracted
from izpi_tpu_torch.integrator import path as tpath
from izpi_tpu_torch.render import renderer as trenderer
from izpi_tpu_torch.scene import compiler as tcompiler
from izpi_tpu_torch.scene import pbtxt as tpbtxt
from izpi_tpu_torch.scene.library import extracted as textracted

# tests/test_torch_pbtxt.py's image scene, its image on a material beside
# the one the sphere wears.
_MISSING_TEXTURE = """
camera { lookfrom { z: -5 } lookat { } vfov: 40 aspect: 1 }
objects { spheres { center { } radius: 1 material_name: "plain" } }
materials {
  key: "tex"
  value { name: "tex" type: "PBR"
          pbr { albedo { type: "IMAGE" image { filename: "missing.png" } } } }
}
materials {
  key: "plain"
  value { name: "plain" type: "LAMBERT"
          lambert { albedo { type: "CONSTANT"
                             constant { color { x: 0.5 y: 0.5 z: 0.5 } } } } }
}
"""


def _pbtxt_scenes(tmp_path):
    path = tmp_path / "scene.pbtxt"
    path.write_text(_MISSING_TEXTURE)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return tpbtxt.load_scene(str(path)), jpbtxt.load_scene(str(path))


@pytest.mark.parametrize("which", ["pbtxt", "dragon"])
def test_placeholder_assets_equal_jax(tmp_path, which):
    if which == "pbtxt":
        t_scene, j_scene = _pbtxt_scenes(tmp_path)
        want = ("missing.png",)
    else:
        t_scene = textracted.cornell_box_pbr_stanford_dragon_spectral(n_tris=2000)
        j_scene = jextracted.cornell_box_pbr_stanford_dragon_spectral(n_tris=2000)
        want = None
    _, t_meta = tcompiler.compile_scene(t_scene, "cpu")
    _, j_meta = jcompiler.compile_scene(j_scene)
    assert isinstance(t_meta.placeholder_assets, tuple)
    assert t_meta.placeholder_assets == j_meta.placeholder_assets
    if want is not None:
        assert t_meta.placeholder_assets == want
    else:
        assert len(t_meta.placeholder_assets) == 1
        assert "stand-in" in t_meta.placeholder_assets[0]


def test_note_printed_once_per_context(tmp_path, capsys):
    """Two renders with one context print the NOTE once, word for word the
    JAX renderer's; a new context prints it again; a scene without
    placeholders prints nothing."""
    t_scene, _ = _pbtxt_scenes(tmp_path)
    note = ("NOTE: this render substitutes procedural placeholders for "
            "missing assets:\n  missing.png\n")
    s = tpath.RenderSettings(max_depth=2)
    ctx = trenderer.RenderContext(t_scene, device="cpu")
    for _ in range(2):
        res = trenderer.render(None, 4, 4, 1, s, seed=0, mode="pool",
                               context=ctx, device="cpu")
        assert np.isfinite(res.image).all()
    assert capsys.readouterr().err == note
    trenderer.render(t_scene, 4, 4, 1, s, seed=0, mode="pool", device="cpu")
    assert capsys.readouterr().err == note
    t_scene.placeholder_assets.clear()
    trenderer.render(t_scene, 4, 4, 1, s, seed=0, mode="pool", device="cpu")
    assert capsys.readouterr().err == ""
