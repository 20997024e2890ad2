"""Cornell box scene.

Counterpart of `izpi_tpu/scene/library/cornell.py:13-51`, value for value.
Reference: internal/scenes/scenes.go:119 `CornellBox` — the canonical parity
scene (BASELINE config #1).
"""

from __future__ import annotations

from h100bench.reference.plain.scene import types as st


def cornell_box(aspect: float = 1.0, with_glass_sphere: bool = True) -> st.Scene:
    red = st.Lambertian(albedo=st.ConstantTexture((0.65, 0.05, 0.05)))
    white = st.Lambertian(albedo=st.ConstantTexture((0.73, 0.73, 0.73)))
    green = st.Lambertian(albedo=st.ConstantTexture((0.12, 0.45, 0.15)))
    light = st.DiffuseLight(emit=st.ConstantTexture((15.0, 15.0, 15.0)))
    glass = st.Dielectric(ref_idx=1.5)

    world = [
        st.FlipNormals(st.YZRect(0, 555, 0, 555, 555, green)),
        st.YZRect(0, 555, 0, 555, 0, red),
        st.FlipNormals(st.XZRect(213, 343, 227, 332, 554, light)),
        st.FlipNormals(st.XZRect(0, 555, 0, 555, 555, white)),
        st.XZRect(0, 555, 0, 555, 0, white),
        st.FlipNormals(st.XYRect(0, 555, 0, 555, 555, white)),
    ]
    if with_glass_sphere:
        world.append(
            st.Sphere((190, 90, 190), (190, 90, 190), 0, 1, 90, glass)
        )
    world.append(
        st.Translate(
            st.RotateY(st.Box((0, 0, 0), (165, 330, 165), white), 15.0),
            (265, 0, 295),
        )
    )

    camera = st.Camera(
        look_from=(278.0, 278.0, -800.0),
        look_at=(278.0, 278.0, 0.0),
        vup=(0.0, 1.0, 0.0),
        vfov=40.0,
        aspect=aspect,
        aperture=0.0,
        focus_dist=10.0,
        time0=0.0,
        time1=1.0,
        exposure=1.0,
    )
    return st.Scene(world=world, camera=camera)
