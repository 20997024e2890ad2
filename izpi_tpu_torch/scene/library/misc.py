"""The Cornell box with an imported mesh.

Counterpart of `cornell_box_obj` in `izpi_tpu/scene/library/misc.py:97-136`
(the reference's internal/scenes/scenes.go:268 `CornellBoxObj`), value for
value. PP.obj is a user asset that ships with neither repo; without it the
scene holds the JAX package's procedural stand-in, a 20,000-triangle blob at
the same spot. The OBJ loader is not ported, so a PP.obj that
IZPI_ASSET_DIR provides raises (ROADMAP A8) instead of being replaced
quietly.
"""

from __future__ import annotations

import os

from izpi_tpu_torch.geometry import procedural
from izpi_tpu_torch.scene import types as st


def _asset(relpath: str):
    d = os.environ.get("IZPI_ASSET_DIR", "")
    if d:
        p = os.path.join(d, relpath)
        if os.path.exists(p):
            return p
    return None


def cornell_box_obj(aspect: float = 1.0) -> st.Scene:
    """scenes.go:268 CornellBoxObj — the Cornell box with a glass sphere and
    a mesh rendered with a gold-ish Lambertian: 6 rects, the sphere and the
    20,000-triangle stand-in, 20,007 primitives; the light members are the
    ceiling rect and, by the dielectric-IsEmitter quirk, the glass sphere."""
    red = st.Lambertian(albedo=st.ConstantTexture((0.65, 0.05, 0.05)))
    white = st.Lambertian(albedo=st.ConstantTexture((0.73, 0.73, 0.73)))
    green = st.Lambertian(albedo=st.ConstantTexture((0.12, 0.45, 0.15)))
    light = st.DiffuseLight(emit=st.ConstantTexture((15.0, 15.0, 15.0)))
    gold = st.Lambertian(albedo=st.ConstantTexture((0.7, 0.7, 0.85)))
    glass = st.Dielectric(ref_idx=1.5)

    world = [
        st.FlipNormals(st.YZRect(0, 555, 0, 555, 555, green)),
        st.YZRect(0, 555, 0, 555, 0, red),
        st.FlipNormals(st.XZRect(213, 343, 227, 332, 554, light)),
        st.FlipNormals(st.XZRect(0, 555, 0, 555, 555, white)),
        st.XZRect(0, 555, 0, 555, 0, white),
        st.FlipNormals(st.XYRect(0, 555, 0, 555, 555, white)),
        st.Sphere((190, 90, 190), (190, 90, 190), 0, 1, 90, glass),
    ]

    obj_path = _asset("PP.obj")
    if obj_path:
        raise NotImplementedError(
            f"{obj_path}: the OBJ loader (izpi_tpu/geometry/wavefront_obj.py) "
            f"is not ported yet: ROADMAP A8 (the OBJ loader comes with the "
            f"dragon)")
    tris = procedural.bumpy_blob(20_000)
    tris = procedural.transform_mesh(tris, scale=60.0,
                                     translate=(280.0, 90.0, 390.0))
    world.append(st.TriangleMesh(vertices=tris, material=gold))

    camera = st.Camera(look_from=(278.0, 278.0, -800.0),
                       look_at=(278.0, 278.0, 0.0), vfov=40.0, aspect=aspect)
    return st.Scene(world=world, camera=camera)
