"""Scenes extracted from the reference's Go proto literals.

`scripts/extract_go_scenes.py` converts every pure-literal
`&pb_transport.Scene{...}` in internal/scenes/{scenes,pbr,spectral,water}.go
into a .pbtxt under `data/`; this module exposes them as constructors.
Asset files the scene data references (PBR texture sets, the water
displacement map, the Stanford dragon mesh) ship with neither repo, so
missing files resolve to deterministic procedural placeholders
(scene.pbtxt._placeholder_image) and the dragon gets a procedural
~871k-triangle stand-in.

A copy of `izpi_tpu/scene/library/extracted.py` on the port's loader, with
its own copy of `data/` (byte-identical). A `meshes/dragon_tri.obj` under
IZPI_ASSET_DIR is the real dragon, read by `geometry.wavefront_obj`.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from izpi_tpu_torch.materials import presets
from izpi_tpu_torch.scene import pbtxt, types as st

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")

# Every extracted literal scene; the dragon is wrapped below to add its mesh.
EXTRACTED = sorted(
    f[:-len(".pbtxt")] for f in os.listdir(DATA_DIR) if f.endswith(".pbtxt")
)


def load_extracted(name: str, aspect: float = 1.0) -> st.Scene:
    return pbtxt.load_scene(os.path.join(DATA_DIR, name + ".pbtxt"),
                            aspect=aspect)


def _make(name):
    def ctor(aspect: float = 1.0) -> st.Scene:
        return load_extracted(name, aspect)

    ctor.__name__ = name
    ctor.__doc__ = f"Extracted reference scene {name} (data/{name}.pbtxt)."
    return ctor


CONSTRUCTORS = {name: _make(name) for name in EXTRACTED
                if name != "cornell_box_pbr_stanford_dragon_spectral"}


def cornell_box_pbr_stanford_dragon_spectral(
        aspect: float = 1.0, n_tris: Optional[int] = None) -> st.Scene:
    """Reference: internal/scenes/spectral.go:631 — the Cornell walls from
    the extracted literal plus the dragon mesh (scale 90, rotate -60° about
    Y, translate (50, 25.1, 60)) with the porcelain material: a procedural
    stand-in at the same ~871k-triangle scale (`n_tris` triangles asked of
    `bumpy_blob`), or the real mesh from meshes/dragon_tri.obj under
    IZPI_ASSET_DIR."""
    from izpi_tpu_torch.geometry import procedural

    scene = load_extracted("cornell_box_pbr_stanford_dragon_spectral", aspect)
    porcelain = presets.create_porcelain()

    asset_dir = os.environ.get("IZPI_ASSET_DIR", "")
    obj_path = os.path.join(asset_dir, "meshes", "dragon_tri.obj")
    if asset_dir and os.path.exists(obj_path):
        from izpi_tpu_torch.geometry import wavefront_obj

        obj = wavefront_obj.load_obj(obj_path, ignore_materials=True)
        obj.scale((90.0, 90.0, 90.0))
        obj.rotate(0.0, -np.deg2rad(60.0), 0.0)
        obj.translate((50.0, 25.1, 60.0))
        meshes = obj.all_meshes(default_material=porcelain)
        scene.world.extend(meshes)
    else:
        tris = procedural.bumpy_blob(n_tris or 871_414)
        tris = procedural.transform_mesh(
            tris, scale=25.0, rotate_y_deg=-60.0, translate=(50.0, 25.1, 60.0))
        scene.world.append(st.TriangleMesh(vertices=tris, material=porcelain))
        scene.placeholder_assets.append(
            "meshes/dragon_tri.obj (procedural ~871k-tri stand-in; "
            "set IZPI_ASSET_DIR to use the real mesh)")
    return scene


CONSTRUCTORS["cornell_box_pbr_stanford_dragon_spectral"] = (
    cornell_box_pbr_stanford_dragon_spectral)
