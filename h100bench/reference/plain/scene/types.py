"""Host-side scene description: the part of the port's scene types
(`izpi_tpu_torch/scene/types.py`, a copy of izpi's constructor vocabulary)
that the benchmark's scenes use. These objects are inert descriptions that
`scene.compiler` flattens into tables; the wrappers (Translate, RotateY,
FlipNormals) are baked into the geometry there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

Vec3 = Tuple[float, float, float]


@dataclass(frozen=True)
class ConstantTexture:
    """Flat RGB color. Reference: texture/constant.go."""

    color: Vec3


@dataclass(frozen=True)
class Lambertian:
    """Cosine-lobe diffuse. Reference: material/lambertian.go."""

    albedo: ConstantTexture


@dataclass(frozen=True)
class Dielectric:
    """Clear glass with Schlick-probabilistic reflect/refract.
    Reference: material/dielectric.go:33-63."""

    ref_idx: float = 1.5


@dataclass(frozen=True)
class DiffuseLight:
    """One-sided emitter. Reference: material/diffuselight.go."""

    emit: ConstantTexture


Material = Union[Lambertian, Dielectric, DiffuseLight]


def is_emitter(mat: Material) -> bool:
    """Reference semantics: DiffuseLight AND Dielectric report IsEmitter()
    (the dielectric hack so glass participates in light-list sampling,
    material/dielectric.go:215)."""
    return isinstance(mat, (DiffuseLight, Dielectric))


@dataclass(frozen=True)
class Sphere:
    """Possibly-moving sphere. Reference: hitable/sphere.go."""

    center0: Vec3
    center1: Vec3
    time0: float
    time1: float
    radius: float
    material: Material


@dataclass(frozen=True)
class XYRect:
    """Axis-aligned rect at z=k, normal +Z. Reference: hitable/xyrect.go."""

    x0: float
    x1: float
    y0: float
    y1: float
    k: float
    material: Material


@dataclass(frozen=True)
class XZRect:
    """Axis-aligned rect at y=k, normal +Y. Reference: hitable/xzrect.go."""

    x0: float
    x1: float
    z0: float
    z1: float
    k: float
    material: Material


@dataclass(frozen=True)
class YZRect:
    """Axis-aligned rect at x=k, normal +X. Reference: hitable/yzrect.go."""

    y0: float
    y1: float
    z0: float
    z1: float
    k: float
    material: Material


@dataclass(frozen=True)
class Box:
    """Six rects with back faces flipped. Reference: hitable/box.go:27-34."""

    p0: Vec3
    p1: Vec3
    material: Material


@dataclass(frozen=True)
class FlipNormals:
    inner: "Hitable"


@dataclass(frozen=True)
class Translate:
    inner: "Hitable"
    offset: Vec3


@dataclass(frozen=True)
class RotateY:
    inner: "Hitable"
    angle_degrees: float


Hitable = Union[Sphere, XYRect, XZRect, YZRect, Box, FlipNormals, Translate,
                RotateY]


@dataclass(frozen=True)
class Camera:
    """Thin-lens camera parameters. Reference: camera/camera.go:28-58."""

    look_from: Vec3
    look_at: Vec3
    vup: Vec3 = (0.0, 1.0, 0.0)
    vfov: float = 40.0
    aspect: float = 1.0
    aperture: float = 0.0
    focus_dist: float = 10.0
    time0: float = 0.0
    time1: float = 1.0
    exposure: float = 1.0


@dataclass
class Scene:
    """World + camera. The lights are every emitter hitable, as
    transport.go:67-72 derives them."""

    world: List[Hitable]
    camera: Camera

    def emitters(self) -> List[Hitable]:
        return [h for h in self.world if hitable_is_emitter(h)]


def hitable_material(h: Hitable) -> Optional[Material]:
    if isinstance(h, (FlipNormals, Translate, RotateY)):
        return hitable_material(h.inner)
    return getattr(h, "material", None)


def hitable_is_emitter(h: Hitable) -> bool:
    m = hitable_material(h)
    return m is not None and is_emitter(m)
