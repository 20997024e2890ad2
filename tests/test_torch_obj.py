"""izpi_tpu_torch.geometry.wavefront_obj vs the JAX package's OBJ loader
(izpi_tpu/geometry/wavefront_obj.py), on tests/data/cube.obj and the cases
of tests/test_obj_pbr.py:17-44: the parsed records, the transforms and the
meshes equal (arrays exactly), and a scene that loads an OBJ from
IZPI_ASSET_DIR compiles to the JAX compile's leaves."""

import dataclasses
import os
import shutil

import numpy as np
import pytest

from _torch_port import jax_leaves, port_leaves
from izpi_tpu.geometry import wavefront_obj as jobj
from izpi_tpu.scene import compiler as jcompiler
from izpi_tpu.scene.library import extracted as jextracted
from izpi_tpu.scene.library import misc as jmisc
from izpi_tpu_torch.geometry import wavefront_obj as tobj
from izpi_tpu_torch.scene import compiler as tcompiler
from izpi_tpu_torch.scene.library import extracted as textracted
from izpi_tpu_torch.scene.library import misc as tmisc

DATA = os.path.join(os.path.dirname(__file__), "data")
CUBE = os.path.join(DATA, "cube.obj")


def _records(o):
    return {
        "vertices": np.asarray(o.vertices), "normals": np.asarray(o.normals),
        "uvs": np.asarray(o.uvs), "centre": np.asarray(o.centre),
        "has": (o.has_normals, o.has_uv),
        "groups": [(g.name, g.material, g.faces) for g in o.groups],
        "mtl": {k: dataclasses.asdict(v) for k, v in o.mtl.items()}}


def _assert_same(got, want):
    a, b = _records(got), _records(want)
    for k in ("vertices", "normals", "uvs", "centre"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["has"] == b["has"] and a["groups"] == b["groups"]
    assert a["mtl"] == b["mtl"]


def _meshes_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("vertices", "uvs", "normals"):
            gv, wv = getattr(g, k), getattr(w, k)
            assert (gv is None) == (wv is None), k
            if wv is not None:
                np.testing.assert_array_equal(gv, wv, err_msg=k)
        assert type(g.material).__name__ == type(w.material).__name__


@pytest.mark.parametrize("ignore_materials", [False, True])
def test_cube_parses_as_jax(ignore_materials):
    got = tobj.load_obj(CUBE, ignore_materials=ignore_materials)
    want = jobj.load_obj(CUBE, ignore_materials=ignore_materials)
    _assert_same(got, want)
    assert len(got.vertices) == 8 and len(got.groups) == 3
    assert bool(got.mtl) != ignore_materials
    if got.mtl:
        assert got.mtl["redstuff"].kd == (0.9, 0.1, 0.05)
    # the quad group triangulates 0-1-2 / 0-2-3 (test_obj_pbr.py:25-26)
    _meshes_equal([got.group_to_mesh(2, tobj.MtlMaterial("m").to_material())],
                  [want.group_to_mesh(2, jobj.MtlMaterial("m").to_material())])
    _meshes_equal(got.all_meshes(), want.all_meshes())


@pytest.mark.parametrize("ops", [
    [("scale", (2.0, 2.0, 2.0)), ("translate", (1.0, 0.0, 0.0))],
    [("rotate", (0.0, np.pi / 2, 0.0))],
    [("translate", (50.0, 25.1, 60.0)), ("rotate", (0.3, -1.0, 0.2)),
     ("scale", (90.0, 90.0, 90.0))]], ids=["scale_translate", "rotate_y",
                                         "all"])
def test_transforms_as_jax(ops):
    """test_obj_pbr.py:32-44's transforms, and all three in a row."""
    got, want = tobj.load_obj(CUBE), jobj.load_obj(CUBE)
    for name, arg in ops:
        call = (lambda o: getattr(o, name)(*arg)) if name == "rotate" else (
            lambda o: getattr(o, name)(arg))
        call(got)
        call(want)
    _assert_same(got, want)
    _meshes_equal(got.all_meshes(), want.all_meshes())


def test_parse_text_and_mtl_as_jax():
    text = ("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nusemtl a\nf 1 2 3\n"
            "g second\nusemtl b\nf 1//1 2//1 3//1 4//1\nvn 0 0 1\n"
            "f 1/ 2/ 3/\n# comment\n\n")
    _assert_same(tobj.parse_obj(text), jobj.parse_obj(text))
    mtl = "newmtl a\nKd 0.1 0.2 0.3\nNs 5\nillum 1\nnewmtl b\nd 0.5\n"
    assert ({k: dataclasses.asdict(v) for k, v in tobj.parse_mtl(mtl).items()}
            == {k: dataclasses.asdict(v)
                for k, v in jobj.parse_mtl(mtl).items()})


@pytest.fixture
def asset_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("IZPI_ASSET_DIR", str(tmp_path))
    return tmp_path


def test_cornell_box_obj_loads_pp_obj_as_jax(asset_dir):
    shutil.copy(CUBE, asset_dir / "PP.obj")
    shutil.copy(os.path.join(DATA, "cube.mtl"), asset_dir / "cube.mtl")
    jcs, _ = jcompiler.compile_scene(jmisc.cornell_box_obj())
    tcs, meta = tcompiler.compile_scene(tmisc.cornell_box_obj(), "cpu")
    assert meta.n_prims == 7 + 6  # the box, the sphere, the cube's triangles
    want, got = jax_leaves(jcs), port_leaves(tcs)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_dragon_loads_its_obj_as_jax(asset_dir):
    (asset_dir / "meshes").mkdir()
    shutil.copy(CUBE, asset_dir / "meshes" / "dragon_tri.obj")
    jscene = jextracted.cornell_box_pbr_stanford_dragon_spectral()
    tscene = textracted.cornell_box_pbr_stanford_dragon_spectral()
    assert not tscene.placeholder_assets and not jscene.placeholder_assets
    jcs, _ = jcompiler.compile_scene(jscene)
    tcs, _ = tcompiler.compile_scene(tscene, "cpu")
    want, got = jax_leaves(jcs), port_leaves(tcs)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
