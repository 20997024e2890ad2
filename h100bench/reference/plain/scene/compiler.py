"""Scene compiler: host-side description → flat float32/int32 tensors.

The part of the port's compiler (`izpi_tpu_torch/scene/compiler.py`) that
the benchmark's scenes reach: rects, boxes and spheres, the FlipNormals /
Translate / RotateY wrappers baked into the geometry by `_Transform`, the
Lambertian / Dielectric / DiffuseLight materials with constant textures,
and the light list. `_Builder` emits numpy float64, converted once to
float32 tensors on the given device, the same f64 → f32 path as the port.
The trainable tables the port's training step holds and these scenes leave
at zero (`tex_c1`, the image stack, the SPD table) are kept, so that the
reference has the same six leaves.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from h100bench.reference.plain import camera as camera_mod
from h100bench.reference.plain.geometry import primitives as prim
from h100bench.reference.plain.integrator import lights as lights_mod
from h100bench.reference.plain.materials import tables as mat_tables
from h100bench.reference.plain.scene import types as st
from h100bench.reference.plain.texture import tables as tex_tables

SPD_GRID_N = 371  # the port's SPD table: 380–750 nm on a 1 nm grid


class CompiledScene(NamedTuple):
    """Everything the bounce reads, as tensors on one device."""

    prims: prim.Prims
    materials: mat_tables.Materials
    textures: tex_tables.Textures
    lights: lights_mod.Lights
    camera: camera_mod.CameraArrays
    spd_table: torch.Tensor  # (1, 371) f32 zeros: no spectrum in RGB scenes


@dataclasses.dataclass
class SceneMeta:
    """Static facts about the compiled scene."""

    n_prims: int
    n_materials: int
    n_lights: int


@dataclasses.dataclass
class _Transform:
    """Composed rigid transform: p_world = R @ p + t (compiler.py:92-122)."""

    rot: np.ndarray
    trans: np.ndarray
    flip: bool

    @staticmethod
    def identity() -> "_Transform":
        return _Transform(np.eye(3), np.zeros(3), False)

    def point(self, p) -> np.ndarray:
        return self.rot @ np.asarray(p, dtype=np.float64) + self.trans

    def vector(self, v) -> np.ndarray:
        return self.rot @ np.asarray(v, dtype=np.float64)

    def then_translate(self, offset) -> "_Transform":
        return _Transform(self.rot,
                          self.trans + self.rot @ np.asarray(offset, np.float64),
                          self.flip)

    def then_rotate_y(self, degrees: float) -> "_Transform":
        # Object→world rotation matching rotate_y.go's inverse ray transform
        # (rotate_y.go:96-110).
        rad = math.pi / 180.0 * degrees
        c, s = math.cos(rad), math.sin(rad)
        r = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
        return _Transform(self.rot @ r, self.trans, self.flip)

    def then_flip(self) -> "_Transform":
        return _Transform(self.rot, self.trans, not self.flip)


class _Builder:
    def __init__(self) -> None:
        self.tex_rows: List[np.ndarray] = []  # each constant's colour
        self._tex_cache: Dict[int, int] = {}
        self.mat_rows: List[dict] = []
        self._mat_cache: Dict[int, int] = {}
        self.prim_rows: List[dict] = []
        self.light_rows: List[dict] = []

    def _add_texture(self, t: st.ConstantTexture) -> int:
        """The texture's row, shared by equal constants."""
        if not isinstance(t, st.ConstantTexture):
            raise TypeError(f"unknown texture {t!r}")
        key = hash((type(t).__name__, t))
        if key not in self._tex_cache:
            self._tex_cache[key] = len(self.tex_rows)
            self.tex_rows.append(np.array(t.color, np.float64))
        return self._tex_cache[key]

    def add_material(self, m) -> int:
        key = id(m)
        if key in self._mat_cache:
            return self._mat_cache[key]
        row = dict(kind=mat_tables.MAT_LAMBERT, tex_albedo=-1, fuzz=0.0,
                   ref_idx=1.5, absorption=np.zeros(3))
        if isinstance(m, st.Lambertian):
            row["tex_albedo"] = self._add_texture(m.albedo)
        elif isinstance(m, st.Dielectric):
            row["kind"] = mat_tables.MAT_DIELECTRIC
            row["ref_idx"] = float(m.ref_idx)
        elif isinstance(m, st.DiffuseLight):
            row["kind"] = mat_tables.MAT_DIFFUSE_LIGHT
            row["tex_albedo"] = self._add_texture(m.emit)
        else:
            raise TypeError(f"unknown material {m!r}")
        self._mat_cache[key] = len(self.mat_rows)
        self.mat_rows.append(row)
        return self._mat_cache[key]

    def _push_prim(self, kind, g0, g1, g2, g3, mat_id, flip):
        self.prim_rows.append(dict(
            kind=kind, g0=np.asarray(g0, np.float64),
            g1=np.asarray(g1, np.float64), g2=np.asarray(g2, np.float64),
            g3=np.asarray(g3, np.float64), mat_id=mat_id, flip=bool(flip),
            uv=np.zeros(6), vn=np.zeros(9), has_vn=False, tb=np.zeros(6)))

    def add_rect(self, p0, e1, e2, normal, mat_id, xf: _Transform):
        self._push_prim(prim.KIND_RECT, xf.point(p0), xf.vector(e1),
                        xf.vector(e2), xf.vector(normal), mat_id, xf.flip)

    def add_sphere(self, c0, c1, t0, t1, radius, mat_id, xf: _Transform):
        self._push_prim(prim.KIND_SPHERE, xf.point(c0), xf.point(c1),
                        np.array([radius, t0, t1]), np.zeros(3), mat_id,
                        xf.flip)

    def add_light(self, kind, l0=None, l1=None, l2=None, normal=None,
                  area=0.0, radius=0.0):
        z = np.zeros(3)
        self.light_rows.append(dict(
            kind=kind,
            l0=z if l0 is None else np.asarray(l0, np.float64),
            l1=z if l1 is None else np.asarray(l1, np.float64),
            l2=z if l2 is None else np.asarray(l2, np.float64),
            normal=z if normal is None else np.asarray(normal, np.float64),
            area=float(area), radius=float(radius)))


def _rect_geometry(h):
    """Rect corner, edges, normal and area (xyrect.go / xzrect.go / yzrect.go)."""
    if isinstance(h, st.XYRect):
        p0, e1 = (h.x0, h.y0, h.k), (h.x1 - h.x0, 0.0, 0.0)
        e2, n = (0.0, h.y1 - h.y0, 0.0), (0.0, 0.0, 1.0)
    elif isinstance(h, st.XZRect):
        p0, e1 = (h.x0, h.k, h.z0), (h.x1 - h.x0, 0.0, 0.0)
        e2, n = (0.0, 0.0, h.z1 - h.z0), (0.0, 1.0, 0.0)
    elif isinstance(h, st.YZRect):
        p0, e1 = (h.k, h.y0, h.z0), (0.0, h.y1 - h.y0, 0.0)
        e2, n = (0.0, 0.0, h.z1 - h.z0), (1.0, 0.0, 0.0)
    else:
        raise TypeError(h)
    area = np.linalg.norm(np.cross(e1, e2))
    return np.array(p0), np.array(e1), np.array(e2), np.array(n), float(area)


def _box_sides(b: st.Box):
    """Box = 6 rects, back faces flipped (box.go:27-34)."""
    p0, p1 = b.p0, b.p1
    return [
        (st.XYRect(p0[0], p1[0], p0[1], p1[1], p1[2], b.material), False),
        (st.XYRect(p0[0], p1[0], p0[1], p1[1], p0[2], b.material), True),
        (st.XZRect(p0[0], p1[0], p0[2], p1[2], p1[1], b.material), False),
        (st.XZRect(p0[0], p1[0], p0[2], p1[2], p0[1], b.material), True),
        (st.YZRect(p0[1], p1[1], p0[2], p1[2], p1[0], b.material), False),
        (st.YZRect(p0[1], p1[1], p0[2], p1[2], p0[0], b.material), True),
    ]


def _compile_hitable(b: _Builder, h, xf: _Transform):
    if isinstance(h, st.FlipNormals):
        _compile_hitable(b, h.inner, xf.then_flip())
    elif isinstance(h, st.Translate):
        _compile_hitable(b, h.inner, xf.then_translate(h.offset))
    elif isinstance(h, st.RotateY):
        _compile_hitable(b, h.inner, xf.then_rotate_y(h.angle_degrees))
    elif isinstance(h, (st.XYRect, st.XZRect, st.YZRect)):
        mat_id = b.add_material(h.material)
        p0, e1, e2, n, _ = _rect_geometry(h)
        b.add_rect(p0, e1, e2, n, mat_id, xf)
    elif isinstance(h, st.Box):
        mat_id = b.add_material(h.material)
        for rect, flipped in _box_sides(h):
            p0, e1, e2, n, _ = _rect_geometry(rect)
            b.add_rect(p0, e1, e2, n, mat_id,
                       xf.then_flip() if flipped else xf)
    elif isinstance(h, st.Sphere):
        mat_id = b.add_material(h.material)
        b.add_sphere(h.center0, h.center1, h.time0, h.time1, h.radius, mat_id,
                     xf)
    else:
        raise TypeError(f"unknown hitable {h!r}")


def _compile_light(b: _Builder, h):
    """Light members at the reference's granularity; Translate/RotateY are
    ignored on purpose (translate.go:58-64, rotate_y.go:150-156)."""
    if isinstance(h, (st.FlipNormals, st.Translate, st.RotateY)):
        _compile_light(b, h.inner)
    elif isinstance(h, (st.XYRect, st.XZRect, st.YZRect)):
        p0, e1, e2, n, area = _rect_geometry(h)
        b.add_light(lights_mod.LIGHT_RECT, p0, e1, e2, n, area)
    elif isinstance(h, st.Sphere):
        b.add_light(lights_mod.LIGHT_SPHERE, l0=h.center0, radius=h.radius)
    else:
        # A box: PDF 0 / Random (1,0,0) (box.go:57-63).
        b.add_light(lights_mod.LIGHT_NULL)


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return torch.tensor(a, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.tensor(a.astype(np.int32), device=device)
    return torch.tensor(a.astype(np.float64).astype(np.float32), device=device)


def _group(cls, rows, device):
    return cls(**{f: _to_tensor([r[f] for r in rows], device)
                  for f in cls._fields})


def compile_scene(scene: st.Scene, device) -> Tuple[CompiledScene, SceneMeta]:
    """Compile `scene` into float32/int32 tensors on `device`."""
    b = _Builder()
    for h in scene.world:
        _compile_hitable(b, h, _Transform.identity())
    for h in scene.emitters():
        _compile_light(b, h)
    if not b.light_rows:
        # Keep shapes non-empty; a null member yields pdf 0 everywhere.
        b.add_light(lights_mod.LIGHT_NULL)
    if not b.prim_rows:
        raise ValueError("scene has no primitives")
    if not b.tex_rows:
        b._add_texture(st.ConstantTexture((0.0, 0.0, 0.0)))
    c0 = np.stack(b.tex_rows)
    textures = tex_tables.Textures(
        c0=_to_tensor(c0, device), c1=_to_tensor(np.zeros_like(c0), device),
        images=_to_tensor(np.zeros((1, 1, 1, 3), np.float32), device))
    camera = camera_mod.compile_camera_host(scene.camera)
    cs = CompiledScene(
        prims=_group(prim.Prims, b.prim_rows, device),
        materials=_group(mat_tables.Materials, b.mat_rows, device),
        textures=textures,
        lights=_group(lights_mod.Lights, b.light_rows, device),
        camera=camera_mod.CameraArrays(**{
            k: _to_tensor(np.asarray(v, np.float64), device)
            for k, v in camera.items()}),
        spd_table=_to_tensor(np.zeros((1, SPD_GRID_N), np.float32), device))
    return cs, SceneMeta(n_prims=len(b.prim_rows),
                         n_materials=len(b.mat_rows),
                         n_lights=len(b.light_rows))
