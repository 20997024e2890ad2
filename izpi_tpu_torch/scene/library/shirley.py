"""Shirley-book scenes.

Reference constructors: internal/scenes/scenes.go — RandomScene, TwoSpheres,
TwoPerlinSpheres, SimpleLight, Final. The reference draws from the global
unseeded rand; here a seeded RandomState makes the scenes deterministic
(same distribution).
"""

from __future__ import annotations

import numpy as np

from izpi_tpu_torch.scene import types as st


def _book_camera(aspect: float, lookfrom=(13.0, 2.0, 3.0),
                 lookat=(0.0, 0.0, 0.0), vfov=20.0, aperture=0.1,
                 focus=10.0) -> st.Camera:
    return st.Camera(look_from=lookfrom, look_at=lookat, vfov=vfov,
                     aspect=aspect, aperture=aperture, focus_dist=focus)


def random_scene(aspect: float = 1.5, seed: int = 42) -> st.Scene:
    """The book-1 cover (scenes.go RandomScene)."""
    rs = np.random.RandomState(seed)
    checker = st.CheckerTexture(
        odd=st.ConstantTexture((0.2, 0.3, 0.1)),
        even=st.ConstantTexture((0.9, 0.9, 0.9)),
    )
    world = [st.Sphere((0, -1000, 0), (0, -1000, 0), 0, 1, 1000,
                       st.Lambertian(albedo=checker))]
    for a in range(-11, 11):
        for b in range(-11, 11):
            choose = rs.rand()
            center = (a + 0.9 * rs.rand(), 0.2, b + 0.9 * rs.rand())
            if np.linalg.norm(np.array(center) - [4, 0.2, 0]) <= 0.9:
                continue
            if choose < 0.8:
                albedo = (rs.rand() * rs.rand(), rs.rand() * rs.rand(),
                          rs.rand() * rs.rand())
                c1 = (center[0], center[1] + 0.5 * rs.rand(), center[2])
                world.append(st.Sphere(center, c1, 0.0, 1.0, 0.2,
                                       st.Lambertian(albedo=st.ConstantTexture(albedo))))
            elif choose < 0.95:
                albedo = (0.5 * (1 - rs.rand()), 0.5 * (1 - rs.rand()),
                          0.5 * (1 - rs.rand()))
                world.append(st.Sphere(center, center, 0.0, 1.0, 0.2,
                                       st.Metal(albedo=albedo,
                                                fuzz=0.2 * rs.rand())))
            else:
                world.append(st.Sphere(center, center, 0.0, 1.0, 0.2,
                                       st.Dielectric(1.5)))
    world.append(st.Sphere((0, 1, 0), (0, 1, 0), 0, 1, 1.0, st.Dielectric(1.5)))
    world.append(st.Sphere((-4, 1, 0), (-4, 1, 0), 0, 1, 1.0,
                           st.Lambertian(albedo=st.ConstantTexture((0.4, 0.2, 0.1)))))
    world.append(st.Sphere((4, 1, 0), (4, 1, 0), 0, 1, 1.0,
                           st.Metal(albedo=(0.7, 0.6, 0.5), fuzz=0.0)))
    return st.Scene(world=world, camera=_book_camera(aspect))


def two_spheres(aspect: float = 1.5) -> st.Scene:
    checker = st.CheckerTexture(
        odd=st.ConstantTexture((0.2, 0.3, 0.1)),
        even=st.ConstantTexture((0.9, 0.9, 0.9)),
    )
    mat = st.Lambertian(albedo=checker)
    world = [
        st.Sphere((0, -10, 0), (0, -10, 0), 0, 1, 10, mat),
        st.Sphere((0, 10, 0), (0, 10, 0), 0, 1, 10, mat),
    ]
    return st.Scene(world=world, camera=_book_camera(aspect, aperture=0.0))


def two_perlin_spheres(aspect: float = 1.5) -> st.Scene:
    per = st.Lambertian(albedo=st.NoiseTexture(scale=4.0))
    world = [
        st.Sphere((0, -1000, 0), (0, -1000, 0), 0, 1, 1000, per),
        st.Sphere((0, 2, 0), (0, 2, 0), 0, 1, 2, per),
    ]
    return st.Scene(world=world, camera=_book_camera(aspect, aperture=0.0))


def simple_light(aspect: float = 1.5) -> st.Scene:
    per = st.Lambertian(albedo=st.NoiseTexture(scale=4.0))
    light = st.DiffuseLight(emit=st.ConstantTexture((4.0, 4.0, 4.0)))
    world = [
        st.Sphere((0, -1000, 0), (0, -1000, 0), 0, 1, 1000, per),
        st.Sphere((0, 2, 0), (0, 2, 0), 0, 1, 2, per),
        st.Sphere((0, 7, 0), (0, 7, 0), 0, 1, 2, light),
        st.XYRect(3, 5, 1, 3, -2, light),
    ]
    cam = st.Camera(look_from=(22, 4, 3), look_at=(0, 2, 0), vfov=20.0,
                    aspect=aspect, focus_dist=10.0)
    return st.Scene(world=world, camera=cam)


def _placeholder_earth(seed: int = 7) -> st.ImageTexture:
    """Procedural stand-in for ../images/earth.png (not shipped with the
    reference either — its Final scene hard-exits without the file)."""
    rs = np.random.RandomState(seed)
    h, w = 64, 128
    yy, xx = np.mgrid[0:h, 0:w]
    land = (np.sin(xx * 0.22 + rs.rand() * 7) * np.sin(yy * 0.31) +
            0.5 * np.sin(xx * 0.07 + yy * 0.13)) > 0.3
    img = np.empty((h, w, 3), np.float32)
    img[..., 0] = np.where(land, 0.25, 0.05)
    img[..., 1] = np.where(land, 0.45, 0.15)
    img[..., 2] = np.where(land, 0.2, 0.5)
    return st.ImageTexture(data=img)


def final(aspect: float = 1.0, seed: int = 11) -> st.Scene:
    """The book-2 final scene (scenes.go Final): ground box grid, area
    light, moving sphere, glass + fuzzy metal, sphere-bounded smoke, global
    thin fog, textured sphere, Perlin sphere, 1000-sphere cluster."""
    rs = np.random.RandomState(seed)
    white = st.Lambertian(albedo=st.ConstantTexture((0.73, 0.73, 0.73)))
    ground = st.Lambertian(albedo=st.ConstantTexture((0.48, 0.83, 0.53)))

    world = []
    nb = 20
    for i in range(nb):
        for j in range(nb):
            w = 100.0
            x0 = -1000.0 + i * w
            z0 = -1000.0 + j * w
            y1 = 100.0 * (rs.rand() + 0.01)
            world.append(st.Box((x0, 0.0, z0), (x0 + w, y1, z0 + w), ground))

    light = st.DiffuseLight(emit=st.ConstantTexture((7.0, 7.0, 7.0)))
    world.append(st.XZRect(123, 423, 147, 412, 554, light))

    center = (400.0, 400.0, 350.0)
    world.append(st.Sphere(center, (430.0, 400.0, 350.0), 0, 1, 50,
                           st.Lambertian(albedo=st.ConstantTexture((0.7, 0.3, 0.1)))))
    world.append(st.Sphere((260, 150, 45), (260, 150, 45), 0, 1, 50,
                           st.Dielectric(1.5)))
    world.append(st.Sphere((0, 150, 145), (0, 150, 145), 0, 1, 50,
                           st.Metal(albedo=(0.8, 0.8, 0.9), fuzz=10.0)))

    boundary = st.Sphere((360, 150, 145), (360, 150, 145), 0, 1, 70,
                         st.Dielectric(1.5))
    world.append(boundary)
    world.append(st.ConstantMedium(
        boundary=boundary, density=0.2,
        phase=st.Isotropic(albedo=st.ConstantTexture((0.2, 0.4, 0.9)))))
    fog_boundary = st.Sphere((0, 0, 0), (0, 0, 0), 0, 1, 5000,
                             st.Dielectric(1.5))
    world.append(st.ConstantMedium(
        boundary=fog_boundary, density=0.0001,
        phase=st.Isotropic(albedo=st.ConstantTexture((1.0, 1.0, 1.0)))))

    world.append(st.Sphere((400, 300, 400), (400, 300, 400), 0, 1, 100,
                           st.Lambertian(albedo=_placeholder_earth())))
    world.append(st.Sphere((220, 280, 300), (220, 280, 300), 0, 1, 80,
                           st.Lambertian(albedo=st.NoiseTexture(scale=0.1))))

    spheres = []
    for _ in range(1000):
        c = tuple(165.0 * rs.rand(3))
        spheres.append(st.Sphere(c, c, 0, 1, 10, white))
    world.append(st.Translate(st.RotateY(st.Group(tuple(spheres)), 15.0),
                              (-100, 270, 395)))

    cam = st.Camera(look_from=(478.0, 278.0, -600.0), look_at=(278, 278, 0),
                    vfov=40.0, aspect=aspect, focus_dist=10.0)
    return st.Scene(world=world, camera=cam)
