"""Python-constructor scenes the reference builds imperatively
(internal/scenes/scenes.go:89 TextureMappedSphere, :233 Environment,
:268 CornellBoxObj, :342 DisplacementTest) and the PBR-under-a-sky-dome
scene `pbr_ibl`.

Counterpart of `izpi_tpu/scene/library/misc.py`, value for value. Each
scene depends on an asset file that ships with neither repo (earth.png,
decor_shop_4k.hdr, PP.obj, bricks/*); a missing asset resolves to the JAX
package's deterministic procedural stand-in, so the scenes render out of
the box. IZPI_ASSET_DIR names a directory of real files: an image there is
read by `io.output.read_image` (which raises, naming the file, on a format
it cannot decode), a real PP.obj by `geometry.wavefront_obj`.
"""

from __future__ import annotations

import os

import numpy as np

from izpi_tpu_torch.geometry import displacement as disp_mod
from izpi_tpu_torch.geometry import procedural
from izpi_tpu_torch.scene import types as st
from izpi_tpu_torch.scene.pbtxt import _placeholder_image


def _asset(relpath: str):
    d = os.environ.get("IZPI_ASSET_DIR", "")
    if d:
        p = os.path.join(d, relpath)
        if os.path.exists(p):
            return p
    return None


def _read_or_placeholder(relpath: str) -> np.ndarray:
    """The asset's pixels, or the procedural stand-in when it is missing."""
    p = _asset(relpath)
    if p:
        from izpi_tpu_torch.io import output as output_mod

        return output_mod.read_image(p)
    return _placeholder_image(relpath)


def _sky() -> np.ndarray:
    """The sky dome's image: decor_shop_4k.hdr when IZPI_ASSET_DIR has it,
    else `_procedural_sky`."""
    if _asset("decor_shop_4k.hdr"):
        return _read_or_placeholder("decor_shop_4k.hdr")
    return _procedural_sky()


def _procedural_sky(h: int = 256, w: int = 512) -> np.ndarray:
    """HDR-ish sky dome stand-in: blue-to-white gradient plus a sun disk."""
    v, u = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                       indexing="ij")
    zenith = np.array([0.25, 0.45, 0.95])
    horizon = np.array([0.9, 0.95, 1.0])
    t = np.clip((v - 0.5) * 2.0, 0.0, 1.0)[..., None]  # v=1 is up
    sky = horizon * (1 - t) + zenith * t
    # Ground half: warm gray.
    sky = np.where(v[..., None] < 0.5, np.array([0.35, 0.3, 0.25]), sky)
    # Sun disk at u=0.25, v=0.8 — bright enough to drive speculars.
    d2 = (u - 0.25) ** 2 + (v - 0.8) ** 2
    sky = sky + np.exp(-d2 / (2 * 0.01 ** 2))[..., None] * 50.0
    return sky


def texture_mapped_sphere(aspect: float = 1.0) -> st.Scene:
    """scenes.go:89 TextureMappedSphere — one Lambertian image-textured unit
    sphere (earth.png). The Go constructor returns geometry only; the camera
    here frames it like the Shirley-book cover shot."""
    earth = st.ImageTexture(data=_read_or_placeholder("earth.png"))
    world = [
        st.Sphere((0, 0, 0), (0, 0, 0), 0, 1, 1,
                  st.Lambertian(albedo=earth)),
        # A light so the NEE integrator has something to sample.
        st.Sphere((0, 8, 0), (0, 8, 0), 0, 1, 2,
                  st.DiffuseLight(emit=st.ConstantTexture((4, 4, 4)))),
    ]
    camera = st.Camera(look_from=(0.0, 0.0, 4.0), look_at=(0.0, 0.0, 0.0),
                       vfov=40.0, aspect=aspect)
    return st.Scene(world=world, camera=camera)


def environment(aspect: float = 1.0) -> st.Scene:
    """scenes.go:233 Environment — IBL sky dome (flipped emissive sphere,
    hitable/sphere.go:39-48 NewSkyDome) + glass and metal spheres."""
    sky_img = _sky()
    dome = st.FlipNormals(st.Sphere(
        (0, 0, 0), (0, 0, 0), 0, 1, 100,
        st.DiffuseLight(emit=st.ImageTexture(data=sky_img))))
    world = [
        st.Sphere((-9, 0, 3), (-9, 0, 3), 0, 1, 4, st.Dielectric(1.5)),
        st.Sphere((-24, -4, 6), (-24, -4, 6), 0, 1, 3,
                  st.Metal(albedo=(0.5, 1.0, 1.0), fuzz=0.0)),
        dome,
    ]
    camera = st.Camera(look_from=(0.0, 0.0, 10.0), look_at=(-20.0, 0.0, -1.0),
                       vfov=60.0, aspect=aspect)
    return st.Scene(world=world, camera=camera)


def cornell_box_obj(aspect: float = 1.0) -> st.Scene:
    """scenes.go:268 CornellBoxObj — the Cornell box with a glass sphere and
    a mesh rendered with a gold-ish Lambertian: 6 rects, the sphere and the
    20,000-triangle stand-in, 20,007 primitives (or PP.obj's groups, when
    IZPI_ASSET_DIR holds it); the light members are the ceiling rect and,
    by the dielectric-IsEmitter quirk, the glass sphere."""
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
        from izpi_tpu_torch.geometry import wavefront_obj

        obj = wavefront_obj.load_obj(obj_path)
        obj.translate((280.0, 30.0, 390.0))
        obj.scale((14.0, 14.0, 14.0))
        world.extend(obj.all_meshes(default_material=gold))
    else:
        tris = procedural.bumpy_blob(20_000)
        tris = procedural.transform_mesh(tris, scale=60.0,
                                         translate=(280.0, 90.0, 390.0))
        world.append(st.TriangleMesh(vertices=tris, material=gold))

    camera = st.Camera(look_from=(278.0, 278.0, -800.0),
                       look_at=(278.0, 278.0, 0.0), vfov=40.0, aspect=aspect)
    return st.Scene(world=world, camera=camera)


def displacement_test(aspect: float = 1.0) -> st.Scene:
    """scenes.go:342 DisplacementTest — Cornell box whose floor is two
    UV-mapped triangles displaced by a heightmap (range [0, 20])."""
    red = st.Lambertian(albedo=st.ConstantTexture((0.65, 0.05, 0.05)))
    white = st.Lambertian(albedo=st.ConstantTexture((0.73, 0.73, 0.73)))
    green = st.Lambertian(albedo=st.ConstantTexture((0.12, 0.45, 0.15)))
    light = st.DiffuseLight(emit=st.ConstantTexture((15.0, 15.0, 15.0)))
    glass = st.Dielectric(ref_idx=1.5)
    floor_mat = st.Lambertian(albedo=st.ImageTexture(
        data=_read_or_placeholder("bricks/Bricks078_4K_Color.png")))

    # Floor quad with UVs (scenes.go:364-366).
    verts = np.array([
        [[555, 0, 0], [0, 0, 0], [555, 0, 555]],
        [[0, 0, 0], [0, 0, 555], [555, 0, 555]],
    ], np.float64)
    uvs = np.array([
        [[1, 0], [0, 0], [0, 1]],
        [[0, 0], [0, 1], [1, 1]],
    ], np.float64)
    dmap = _read_or_placeholder("bricks/displacement.png")
    floor = disp_mod.displace_mesh(
        st.TriangleMesh(vertices=verts, material=floor_mat, uvs=uvs),
        np.asarray(dmap), 0.0, 20.0)

    world = [
        st.FlipNormals(st.YZRect(0, 555, 0, 555, 555, green)),
        st.YZRect(0, 555, 0, 555, 0, red),
        st.FlipNormals(st.XZRect(213, 343, 227, 332, 554, light)),
        st.FlipNormals(st.XZRect(0, 555, 0, 555, 555, white)),
        st.FlipNormals(st.XYRect(0, 555, 0, 555, 555, white)),
        st.Sphere((190, 130, 190), (190, 130, 190), 0, 1, 90, glass),
        floor,
    ]
    camera = st.Camera(look_from=(278.0, 278.0, -800.0),
                       look_at=(278.0, 278.0, 0.0), vfov=40.0, aspect=aspect)
    return st.Scene(world=world, camera=camera)


def pbr_ibl(aspect: float = 1.0) -> st.Scene:
    """BASELINE config #4: PBR-textured spheres lit by an HDRI sky dome —
    the reference's PBR showcase (internal/scenes/pbr.go PBR boxes) combined
    with the IBL environment (scenes.go:233). Texture maps come from assets
    when IZPI_ASSET_DIR provides them, else deterministic procedural maps."""
    rng = np.random.RandomState(42)

    def tex_map(lo, hi, h=128, w=128, channels=3):
        return st.ImageTexture(
            data=(lo + (hi - lo) * rng.rand(h, w, channels)).astype(
                np.float64))

    sky_img = _sky()
    dome = st.FlipNormals(st.Sphere(
        (0, 0, 0), (0, 0, 0), 0, 1, 100,
        st.DiffuseLight(emit=st.ImageTexture(data=sky_img))))

    world = [dome]
    for i, (x, rough_hi, metal_hi) in enumerate(
            [(-9.0, 0.3, 1.0), (0.0, 0.8, 0.2), (9.0, 0.5, 0.6)]):
        world.append(st.Sphere(
            (x, 0.0, 0.0), (x, 0.0, 0.0), 0, 1, 4,
            st.PBR(albedo=tex_map(0.2, 0.9),
                   roughness=tex_map(0.05, rough_hi),
                   metalness=tex_map(0.0, metal_hi),
                   normal_map=st.ImageTexture(
                       data=np.tile(np.array([0.5, 0.5, 1.0]),
                                    (128, 128, 1)).astype(np.float64)))))
    camera = st.Camera(look_from=(0.0, 4.0, 22.0), look_at=(0.0, 0.0, 0.0),
                       vfov=45.0, aspect=aspect)
    return st.Scene(world=world, camera=camera)
