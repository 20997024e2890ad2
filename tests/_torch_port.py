"""Shared helpers for the port's differential tests (tests/test_torch_*.py).

Each test makes its inputs with numpy from a seed, runs them through the JAX
function and its counterpart in `izpi_tpu_torch`, and compares the outputs
as numpy arrays. JAX runs on the CPU (tests/conftest.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from izpi_tpu_torch.scene import compiler as tcompiler
from izpi_tpu_torch.scene import types as tst
from izpi_tpu_torch.spectral import spd as tspd


def _leaf(cs, name):
    for part in name.split("."):
        cs = getattr(cs, part)
    return cs


def jax_leaves(cs) -> dict:
    """The leaves of a JAX CompiledScene the port reads, as numpy, keyed
    as in izpi_tpu_torch.scene.compiler.LEAVES."""
    return {name: np.asarray(_leaf(cs, name)) for name in tcompiler.LEAVES}


def port_leaves(cs) -> dict:
    return {name: _leaf(cs, name).cpu().numpy() for name in tcompiler.LEAVES}


def to_port_scene(obj, _memo=None):
    """A JAX-package scene description rebuilt from the port's classes of
    the same names (the two `scene/types.py` match class for class), so
    one scene goes through both compilers. Shared objects stay shared (the
    compilers key materials by identity); SPDs become the port's SPD."""
    memo = {} if _memo is None else _memo
    if id(obj) in memo:
        return memo[id(obj)][0]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = getattr(tst, type(obj).__name__)
        out = cls(**{f.name: to_port_scene(getattr(obj, f.name), memo)
                     for f in dataclasses.fields(obj)})
    elif type(obj).__name__ == "SPD":
        out = tspd.SPD(obj.wavelengths, obj.values)
    elif isinstance(obj, (list, tuple)):
        out = type(obj)(to_port_scene(x, memo) for x in obj)
    else:
        return obj
    memo[id(obj)] = (out, obj)  # holding obj keeps its id unique
    return out


def mixed_scene(st):
    """A scene using every element the slice compiles: triangles with and
    without vertex normals, a moving sphere, metal, an absorbing dielectric,
    a checker texture, a box under Translate/RotateY, a triangle light and a
    sphere light. `st` is either package's scene.types module."""
    checker = st.Lambertian(albedo=st.CheckerTexture(
        st.ConstantTexture((0.1, 0.2, 0.3)), st.ConstantTexture((0.9, 0.8, 0.7))))
    white = st.Lambertian(albedo=st.ConstantTexture((0.73, 0.73, 0.73)))
    metal = st.Metal(albedo=(0.8, 0.6, 0.4), fuzz=0.2)
    glass = st.Dielectric(ref_idx=1.5, absorption=(0.01, 0.02, 0.005))
    light = st.DiffuseLight(emit=st.ConstantTexture((4.0, 4.0, 4.0)))
    world = [
        st.XZRect(-10, 10, -10, 10, 0, checker),
        st.Sphere((0, 1, 0), (0.3, 1, 0), 0, 1, 1.0, metal),
        st.Sphere((-2.2, 1, 0.5), (-2.2, 1, 0.5), 0, 1, 1.0, glass),
        st.Triangle((2, 0, -1), (4, 0, -1), (3, 2, -1), white),
        st.Triangle((2, 0, 1), (4, 0, 1), (3, 2, 1), white,
                    vn0=(0, 0, 1), vn1=(0.2, 0, 1), vn2=(0, 0.3, 1)),
        st.Translate(st.RotateY(st.Box((0, 0, 0), (1, 1.5, 1), white), 20.0),
                     (0.5, 0, 2)),
        st.FlipNormals(st.Triangle((-1, 4, -1), (1, 4, -1), (0, 4, 1), light)),
        st.Sphere((0, 6, 3), (0, 6, 3), 0, 1, 0.5, light),
    ]
    cam = st.Camera(look_from=(0, 3, -9), look_at=(0, 1, 0), vfov=40,
                    aspect=1.0, aperture=0.1, focus_dist=9.0)
    return st.Scene(world=world, camera=cam)


def spectral_mixed_scene(st, spd):
    """A spectral scene using every spectral element the port compiles: a
    spectral checker of a Gaussian and a tabulated spectrum, neutral and
    Gaussian albedos, a dielectric with η(λ) and spectral absorption, a
    triangle mesh with uvs and vertex normals under Translate/RotateY, a
    mesh light with a Gaussian emission and a tabulated background. `st`
    and `spd` are either package's scene.types and spectral.spd modules."""
    lam = tuple(np.arange(380.0, 751.0, 10.0))
    checker = st.Lambertian(spectral_albedo=st.SpectralChecker(
        st.SpectralGaussian(0.8, 520.0, 60.0),
        st.SpectralTabulated(lam, tuple(0.2 + 0.5 * (x - 380.0) / 370.0
                                        for x in lam))))
    white = st.Lambertian(albedo=st.ConstantTexture((0.5, 0.6, 0.7)),
                          spectral_albedo=st.SpectralNeutral(0.7))
    plain = st.Lambertian(albedo=st.ConstantTexture((0.3, 0.6, 0.2)))
    glass = st.Dielectric(
        ref_idx=1.5,
        spectral_ref_idx=st.SpectralTabulated((380.0, 750.0), (1.62, 1.48)),
        spectral_absorption=st.SpectralTabulated((380.0, 550.0, 750.0),
                                                 (0.02, 0.2, 0.05)))
    light = st.DiffuseLight(spectral_emit=st.SpectralGaussian(12.0, 560.0,
                                                              150.0))
    tet = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                    [[0, 0, 0], [0, 1, 0], [0, 0, 1]],
                    [[0, 0, 0], [0, 0, 1], [1, 0, 0]],
                    [[1, 0, 0], [0, 0, 1], [0, 1, 0]]], np.float64) * 1.5
    uvs = np.tile(np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]), (4, 1, 1))
    normals = tet / np.maximum(np.linalg.norm(tet, axis=2, keepdims=True), 1)
    world = [
        st.XZRect(-10, 10, -10, 10, 0, checker),
        st.FlipNormals(st.XYRect(-10, 10, 0, 10, 6, white)),
        st.Sphere((-2.0, 1.0, 0.0), (-2.0, 1.0, 0.0), 0, 1, 1.0, glass),
        st.Translate(st.RotateY(st.TriangleMesh(tet, plain, uvs=uvs,
                                                normals=normals), 30.0),
                     (1.0, 0.0, -0.5)),
        st.TriangleMesh(tet + np.array([0.0, 0.0, 3.0]), glass),
        st.FlipNormals(st.TriangleMesh(
            np.array([[[-1, 5, -1], [1, 5, -1], [0, 5, 1]]], np.float64),
            light)),
    ]
    cam = st.Camera(look_from=(0, 3, -9), look_at=(0, 1, 0), vfov=40,
                    aspect=1.0, aperture=0.1, focus_dist=9.0, exposure=1.3)
    return st.Scene(world=world, camera=cam, spectral=True,
                    spectral_background=spd.SPD(lam, np.full(len(lam), 0.05)))


# Beer–Lambert coefficients (per scene unit) that `with_absorbing_glass`
# gives a glass: the light inside a Cornell sphere (radius 90) keeps
# exp(-0.9), exp(-3.6) and exp(-9) of its red, green and blue.
ABSORPTION = (0.005, 0.02, 0.05)


def with_absorbing_glass(scene, types=tst, absorption=ABSORPTION):
    """`scene` with the glass of each dielectric sphere absorbing
    (Beer–Lambert), so that refraction into it re-traces to the exit: no
    scene of the library sets an absorption. `types` is the scene's types
    module, the JAX package's or the port's."""
    world = [dataclasses.replace(h, material=dataclasses.replace(
                 h.material, absorption=absorption))
             if isinstance(h, types.Sphere)
             and isinstance(h.material, types.Dielectric) else h
             for h in scene.world]
    if all(a is b for a, b in zip(world, scene.world)):
        raise ValueError("the scene holds no dielectric sphere")
    return dataclasses.replace(scene, world=world)
