"""izpi_tpu_torch's host-side scene loading vs the JAX package's: the light
source library, the porcelain presets, the `.pbtxt` loader, the extracted
reference scenes and the scene registry.

The port keeps its own copies of the data files; each must be byte for byte
the JAX package's. Every extracted scene must load to the same scene
description (field for field, floats and arrays EQUAL) and then compile to
the JAX compile's tables leaf for leaf, the image scenes' placeholder image
stacks, combined map stacks and RGB-to-spectral uplift flags included. The
dragon is built with a 2,000-triangle stand-in.
"""

import dataclasses
import filecmp
import os

import numpy as np
import pytest

from _torch_port import jax_leaves, port_leaves
from izpi_tpu.geometry import displacement as jdisp
from izpi_tpu.materials import presets as jpresets
from izpi_tpu.scene import compiler as jcompiler
from izpi_tpu.scene import pbtxt as jpbtxt
from izpi_tpu.scene.library import REGISTRY as J_REGISTRY
from izpi_tpu.scene.library import extracted as jextracted
from izpi_tpu.spectral import lightsources as jlights
from izpi_tpu_torch.geometry import displacement as tdisp
from izpi_tpu_torch.materials import presets as tpresets
from izpi_tpu_torch.scene import compiler as tcompiler
from izpi_tpu_torch.scene import pbtxt as tpbtxt
from izpi_tpu_torch.scene.library import REGISTRY as T_REGISTRY
from izpi_tpu_torch.scene.library import extracted as textracted
from izpi_tpu_torch.scene.library import get_scene
from izpi_tpu_torch.spectral import lightsources as tlights

DRAGON = "cornell_box_pbr_stanford_dragon_spectral"
DRAGON_TRIS = 2000
# The extracted scenes with image textures (procedural placeholders): PBR
# maps through the combined stack.
IMAGE_SCENES = ("cornell_box_pb", "cornell_box_pbr_coloured_glass_spectral",
                "cornell_box_pbr_rgb", "cornell_box_pbr_spectral")


def assert_same(got, want, where="scene"):
    """Two scene descriptions, one from each package, field for field: the
    same class names, equal numbers, equal arrays, equal SPDs."""
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__, where
        for f in dataclasses.fields(want):
            assert_same(getattr(got, f.name), getattr(want, f.name),
                        f"{where}.{f.name}")
    elif type(want).__name__ == "SPD":
        assert type(got).__name__ == "SPD", where
        np.testing.assert_array_equal(got.wavelengths, want.wavelengths, where)
        np.testing.assert_array_equal(got.values, want.values, where)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, where)
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}[{k!r}]")
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


def _load(module, name):
    if name == DRAGON:
        return getattr(module, DRAGON)(1.0, n_tris=DRAGON_TRIS)
    return module.CONSTRUCTORS[name](1.0)


# ---- data files ----

DATA_FILES = ([os.path.join("scene", "library", "data", f)
               for f in sorted(os.listdir(jextracted.DATA_DIR))]
              + [os.path.join("spectral", "lightsources_data.json")])


@pytest.mark.parametrize("rel", DATA_FILES)
def test_data_file_is_byte_identical(rel):
    root_j = os.path.dirname(os.path.dirname(jlights.__file__))
    root_t = os.path.dirname(os.path.dirname(tlights.__file__))
    assert filecmp.cmp(os.path.join(root_t, rel), os.path.join(root_j, rel),
                       shallow=False), rel


def test_extracted_names_equal_jax():
    assert textracted.EXTRACTED == jextracted.EXTRACTED
    assert len(textracted.EXTRACTED) == 15
    assert sorted(textracted.CONSTRUCTORS) == sorted(jextracted.CONSTRUCTORS)


# ---- light sources and presets ----

def test_light_source_names_equal_jax():
    names = tlights.list_light_sources()
    assert names == jlights.list_light_sources()
    assert len(names) == 42 and "cie_illuminant_a_2856k" in names


@pytest.mark.parametrize("name", jlights.list_light_sources())
def test_light_source_equals_jax(name):
    """The SPD's knots and its 1 nm device grid, equal."""
    got, want = tlights.get_light_source(name), jlights.get_light_source(name)
    assert_same(got, want, name)
    np.testing.assert_array_equal(got.to_device_grid(), want.to_device_grid())


def test_unknown_light_source_raises():
    with pytest.raises(KeyError, match="list_light_sources"):
        tlights.get_light_source("sodium_vapour_9000k")


def test_presets_equal_jax():
    assert tpresets.list_materials() == jpresets.list_materials()
    for name in jpresets.list_materials():
        assert_same(tpresets.get_material(name), jpresets.get_material(name),
                    name)
        assert (tpresets.MATERIAL_LIBRARY[name]["description"]
                == jpresets.MATERIAL_LIBRARY[name]["description"])
    assert_same(tpresets.create_porcelain_custom(0.25, 0.4, 0.9),
                jpresets.create_porcelain_custom(0.25, 0.4, 0.9))
    with pytest.raises(KeyError):
        tpresets.get_material("bone_china")


# ---- the loader ----

@pytest.mark.parametrize("name", jextracted.EXTRACTED)
def test_parse_tree_equals_jax(name):
    """The tokenizer and parser: the same nested dict for every data file."""
    with open(os.path.join(jextracted.DATA_DIR, name + ".pbtxt")) as f:
        text = f.read()
    assert_same(tpbtxt.parse_pbtxt(text), jpbtxt.parse_pbtxt(text), name)


@pytest.mark.filterwarnings("ignore:texture file")
@pytest.mark.parametrize("name", jextracted.EXTRACTED)
def test_extracted_scene_equals_jax(name):
    got, want = _load(textracted, name), _load(jextracted, name)
    assert_same(got, want, name)


@pytest.mark.filterwarnings("ignore:texture file")
@pytest.mark.parametrize("name", jextracted.EXTRACTED)
def test_extracted_scene_compiles_as_jax(name):
    """Leaf for leaf equal to the JAX compile (the dragon's tangent frames
    and PBR columns, the image scenes' image and combined stacks
    included)."""
    scene = _load(textracted, name)
    tcs, tmeta = tcompiler.compile_scene(scene, "cpu")
    jcs, jmeta = jcompiler.compile_scene(_load(jextracted, name))
    want, got = jax_leaves(jcs), port_leaves(tcs)
    for leaf in tcompiler.LEAVES:
        assert got[leaf].shape == want[leaf].shape, leaf
        np.testing.assert_array_equal(got[leaf], want[leaf], err_msg=leaf)
    for f in ("n_prims", "n_materials", "n_lights", "spectral", "exposure",
              "spectral_background_spd", "has_checker", "has_pbr",
              "has_absorbing_dielectric", "has_image", "has_noise", "n_media"):
        assert getattr(tmeta, f) == getattr(jmeta, f), f
    assert tmeta.has_pbr == (name == DRAGON or name in IMAGE_SCENES)
    assert tmeta.has_image == (name in IMAGE_SCENES)


def test_dragon_stand_in_size():
    """The full-size request is bench.py's dragon: 871,414 triangles asked
    of bumpy_blob give 871,200, plus the walls, the light and the sphere."""
    scene = textracted.cornell_box_pbr_stanford_dragon_spectral()
    mesh = scene.world[-1]
    assert type(mesh).__name__ == "TriangleMesh"
    assert mesh.vertices.shape == (871_200, 3, 3)
    assert type(mesh.material).__name__ == "PBR"
    assert scene.spectral and scene.placeholder_assets[-1].startswith(
        "meshes/dragon_tri.obj")


def test_dragon_obj_asset_raises(tmp_path, monkeypatch):
    """A real dragon mesh under IZPI_ASSET_DIR is loaded, as in the JAX
    package, in place of the stand-in (it raised before the OBJ loader was
    ported); one with no faces adds no mesh."""
    (tmp_path / "meshes").mkdir()
    (tmp_path / "meshes" / "dragon_tri.obj").write_text("v 0 0 0\n")
    monkeypatch.setenv("IZPI_ASSET_DIR", str(tmp_path))
    got = textracted.cornell_box_pbr_stanford_dragon_spectral(n_tris=100)
    want = jextracted.cornell_box_pbr_stanford_dragon_spectral(n_tris=100)
    assert len(got.world) == len(want.world)
    assert not got.placeholder_assets and not want.placeholder_assets
    assert all(type(h).__name__ != "TriangleMesh" or h.vertices.shape[0] < 100
               for h in got.world)


@pytest.mark.parametrize("filename", ["textures/wood_albedo.png",
                                      "textures/rock_normal.jpg", "x"])
def test_placeholder_image_equals_jax(filename):
    np.testing.assert_array_equal(tpbtxt._placeholder_image(filename),
                                  jpbtxt._placeholder_image(filename))


_IMAGE_SCENE = """
camera { lookfrom { z: -5 } lookat { } vfov: 40 aspect: 1 }
objects { spheres { center { } radius: 1 material_name: "tex" } }
materials {
  key: "tex"
  value { name: "tex" type: "PBR"
          pbr { albedo { type: "IMAGE" image { filename: "%s" } } } }
}
"""


def test_existing_image_file_raises(tmp_path):
    """A texture file that exists is read by the port's image reader: a
    PNG that PIL wrote loads to the JAX loader's scene (which reads it
    through PIL), and a file the reader cannot decode raises, naming the
    file, rather than standing a placeholder in."""
    from PIL import Image

    rs = np.random.RandomState(5)
    Image.fromarray(rs.randint(0, 256, (6, 5, 3)).astype(np.uint8)).save(
        tmp_path / "tex.png")
    path = tmp_path / "scene.pbtxt"
    path.write_text(_IMAGE_SCENE % "tex.png")
    got = tpbtxt.load_scene(str(path))
    assert_same(got, jpbtxt.load_scene(str(path)))
    assert got.placeholder_assets == []

    (tmp_path / "bad.png").write_bytes(b"\x89PNG")
    path.write_text(_IMAGE_SCENE % "bad.png")
    with pytest.raises(ValueError, match="bad.png"):
        tpbtxt.load_scene(str(path))


def test_missing_image_file_is_a_placeholder(tmp_path):
    path = tmp_path / "scene.pbtxt"
    path.write_text(_IMAGE_SCENE % "missing.png")
    with pytest.warns(UserWarning, match="placeholder"):
        got = tpbtxt.load_scene(str(path))
    with pytest.warns(UserWarning, match="placeholder"):
        want = jpbtxt.load_scene(str(path))
    assert_same(got, want)
    assert got.placeholder_assets == ["missing.png"]


def test_binary_scene_raises(tmp_path):
    """An empty `.izpi` file decodes (scene.izpi_binary) to the JAX
    loader's empty scene, which the compiler refuses: it has no
    primitives. tests/test_torch_cli.py decodes a scene with content."""
    path = tmp_path / "scene.izpi"
    path.write_bytes(b"")
    got = tpbtxt.load_scene(str(path))
    assert_same(got, jpbtxt.load_scene(str(path)))
    with pytest.raises(ValueError, match="no primitives"):
        tcompiler.compile_scene(got, "cpu")


def test_displacement_equals_jax():
    """The displaced-mesh tessellation the loader runs, on a seeded quad and
    height map."""
    rs = np.random.RandomState(5)
    verts = np.array([[[0, 0, 0], [1, 0, 0], [0, 0, 1]],
                      [[1, 0, 0], [1, 0, 1], [0, 0, 1]]], np.float64)
    uvs = np.array([[[0, 0], [1, 0], [0, 1]], [[1, 0], [1, 1], [0, 1]]],
                   np.float64)
    dmap = rs.rand(16, 16, 3).astype(np.float32)
    got = tdisp.apply_displacement_map(verts, uvs, dmap, 0.0, 0.2)
    want = jdisp.apply_displacement_map(verts, uvs, dmap, 0.0, 0.2)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---- the registry ----

def test_registry_is_a_subset_of_jax():
    assert set(T_REGISTRY) <= set(J_REGISTRY)
    assert set(textracted.CONSTRUCTORS) <= set(T_REGISTRY)
    for name in ("cornell_box", "cornell_box_pyramid_spectral",
                 "cornell_box_obj", DRAGON):
        assert name in T_REGISTRY


def test_get_scene():
    scene = get_scene("cornell_box_spectral", aspect=1.5)
    assert scene.spectral and scene.camera.aspect == 1.5
    assert get_scene("two_perlin_spheres", aspect=1.5).camera.aspect == 1.5
    with pytest.raises(KeyError, match="available"):
        get_scene("no_such_scene")
