"""Scene compiler: host-side description → flat float32/int32 tensors.

Counterpart of `izpi_tpu/scene/compiler.py` for the slices ported so far:
rects, boxes, spheres (moving ones included), triangles and triangle meshes,
the FlipNormals / Translate / RotateY wrappers baked into geometry by
`_Transform` (triangles carry their UV tangent frame, `Prims.tb`), the
Lambertian / Metal / Dielectric (with absorption) / DiffuseLight / PBR
materials with constant and checker textures and their spectral columns
(tabulated, neutral and Gaussian spectra, the spectral checker, η(λ),
spectral absorption), the scene's SPD table, the spectral background and
the light list. Images are not ported, so there is no combined image-map
stack: every `combo_id` is -1 and PBR takes the generic texture lookups.
`_Builder` emits numpy float64, converted once to float32 tensors on the
given device, the same f64 → f32 path as `compiler.py:646-663`, so both
packages hold equal tables.

Anything else raises NotImplementedError naming the ROADMAP item that ports
it. `from_jax_arrays` takes the JAX package's compiled tables (as numpy) so
tests can render the same tables through both packages.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from izpi_tpu_torch import camera as camera_mod
from izpi_tpu_torch.geometry import primitives as prim
from izpi_tpu_torch.integrator import lights as lights_mod
from izpi_tpu_torch.materials import tables as mat_tables
from izpi_tpu_torch.scene import types as st
from izpi_tpu_torch.spectral import spd as spd_mod
from izpi_tpu_torch.texture import tables as tex_tables

_MEDIA_PBR = "ROADMAP A11 (media, images, noise, uplift and IBL)"


class CompiledScene(NamedTuple):
    """Everything the device needs, as tensors on one device."""

    prims: prim.Prims
    materials: mat_tables.Materials
    textures: tex_tables.Textures
    lights: lights_mod.Lights
    camera: camera_mod.CameraArrays
    spd_table: torch.Tensor  # (S, 371) f32 on the 1 nm grid; row 0 is zeros

    @property
    def device(self) -> torch.device:
        return self.prims.kind.device


@dataclasses.dataclass
class SceneMeta:
    """Static facts about the compiled scene. The port compiles no media,
    image or noise content yet; the fields stay so that the kernels'
    `eligible` read the JAX package's rules unchanged."""

    n_prims: int
    n_materials: int
    n_lights: int
    has_absorbing_dielectric: bool
    spectral: bool = False
    exposure: float = 1.0
    spectral_background_spd: Optional[int] = None  # SPD row, or None
    has_checker: bool = False
    has_image: bool = False
    has_noise: bool = False
    has_pbr: bool = False
    n_media: int = 0
    # Assets replaced by procedural placeholders at load (scene.pbtxt,
    # library.extracted), reported by render() (compiler.py:83-85).
    placeholder_assets: tuple = ()


# The leaves the port reads, by "<group>.<field>" of the JAX CompiledScene
# (or the field's bare name for a leaf that is not in a group).
LEAVES = (
    [f"prims.{f}" for f in prim.Prims._fields]
    + [f"materials.{f}" for f in mat_tables.Materials._fields]
    + [f"textures.{f}" for f in tex_tables.Textures._fields]
    + [f"lights.{f}" for f in lights_mod.Lights._fields]
    + [f"camera.{f}" for f in camera_mod.CameraArrays._fields]
    + ["spd_table"]
)


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
        self.tex_rows: List[tuple] = []
        self._tex_cache: Dict[int, int] = {}
        self.mat_rows: List[dict] = []
        self._mat_cache: Dict[int, int] = {}
        # Primitive blocks: one dict of (k, ...) arrays per push, one row for
        # a single primitive and T rows for a mesh (compiler.py:326-336).
        self.prim_blocks: List[dict] = []
        self.light_rows: List[dict] = []
        self.spds: List[np.ndarray] = [
            np.zeros(spd_mod.DEVICE_GRID_N, np.float32)]
        self.has_absorbing_dielectric = False

    def _add_texture(self, t) -> int:
        if isinstance(t, st.ConstantTexture):
            key = hash((type(t).__name__, t))
            row = (tex_tables.TEX_CONSTANT, np.array(t.color, np.float64),
                   np.zeros(3))
        elif isinstance(t, st.CheckerTexture):
            if not (isinstance(t.odd, st.ConstantTexture)
                    and isinstance(t.even, st.ConstantTexture)):
                raise NotImplementedError(
                    "checker children must be constant textures")
            key = hash((type(t).__name__, (id(t.odd), id(t.even))))
            row = (tex_tables.TEX_CHECKER, np.array(t.odd.color, np.float64),
                   np.array(t.even.color, np.float64))
        elif isinstance(t, (st.ImageTexture, st.NoiseTexture)):
            raise NotImplementedError(
                f"{type(t).__name__} is not ported yet: {_MEDIA_PBR}")
        else:
            raise TypeError(f"unknown texture {t!r}")
        if key in self._tex_cache:
            return self._tex_cache[key]
        self._tex_cache[key] = len(self.tex_rows)
        self.tex_rows.append(row)
        return self._tex_cache[key]

    def add_spd(self, spd: spd_mod.SPD) -> int:
        self.spds.append(spd.to_device_grid())
        return len(self.spds) - 1

    def add_spectral_texture(self, t):
        """(SPD row, Gaussian parameters) of a spectral constant: a Gaussian
        stays parametric (texture/spectral_constant.go:27), a tabulated or
        neutral spectrum becomes an SPD row (compiler.py:247-259)."""
        if t is None:
            return -1, np.zeros(3, np.float64)
        if isinstance(t, st.SpectralGaussian):
            return -1, np.array([t.peak, t.center, t.width], np.float64)
        if isinstance(t, st.SpectralTabulated):
            return (self.add_spd(spd_mod.SPD(np.array(t.wavelengths),
                                             np.array(t.values))),
                    np.zeros(3, np.float64))
        if isinstance(t, st.SpectralNeutral):
            return self.add_spd(spd_mod.SPD.constant(t.value)), np.zeros(3)
        if isinstance(t, st.SpectralImage):
            raise NotImplementedError(
                f"RGB-to-spectral uplift is not ported yet: {_MEDIA_PBR}")
        raise NotImplementedError(
            f"spectral texture {type(t).__name__} not yet compiled")

    def _fill_spectral_albedo(self, row: dict, t) -> None:
        """A spectral albedo or emission into the material row: a constant
        gives one SPD row or Gaussian, a SpectralChecker its two branches
        (compiler.py:226-245)."""
        if t is None:
            return
        if isinstance(t, st.SpectralChecker):
            row["spec_albedo_id"], row["spec_albedo_gauss"] = (
                self.add_spectral_texture(t.odd))
            row["spec_albedo_id2"], row["spec_albedo_gauss2"] = (
                self.add_spectral_texture(t.even))
            row["spec_checker"] = True
            return
        row["spec_albedo_id"], row["spec_albedo_gauss"] = (
            self.add_spectral_texture(t))

    def add_material(self, m) -> int:
        key = id(m)
        if key in self._mat_cache:
            return self._mat_cache[key]
        row = dict(kind=mat_tables.MAT_LAMBERT, tex_albedo=-1, fuzz=0.0,
                   ref_idx=1.5, absorption=np.zeros(3), has_absorption=False,
                   tex_rough=-1, tex_metal=-1, tex_normal=-1, tex_sss=-1,
                   sss_radius=0.0, combo_id=-1, spec_albedo_id=-1,
                   spec_albedo_gauss=np.zeros(3),
                   spec_ref_idx_id=-1, spec_absorb_id=-1, spec_checker=False,
                   spec_albedo_id2=-1, spec_albedo_gauss2=np.zeros(3),
                   spec_albedo_uplift=False)
        if isinstance(m, st.Lambertian):
            if m.albedo is not None:
                row["tex_albedo"] = self._add_texture(m.albedo)
            self._fill_spectral_albedo(row, m.spectral_albedo)
        elif isinstance(m, st.Metal):
            row["kind"] = mat_tables.MAT_METAL
            row["tex_albedo"] = self._add_texture(
                st.ConstantTexture(tuple(float(x) for x in m.albedo)))
            row["fuzz"] = float(m.fuzz)
        elif isinstance(m, st.Dielectric):
            row["kind"] = mat_tables.MAT_DIELECTRIC
            row["ref_idx"] = float(m.ref_idx)
            if m.absorption is not None:
                row["absorption"] = np.array(m.absorption, np.float64)
                row["has_absorption"] = True
                self.has_absorbing_dielectric = True
            row["spec_ref_idx_id"], _ = self.add_spectral_texture(
                m.spectral_ref_idx)
            row["spec_absorb_id"], _ = self.add_spectral_texture(
                m.spectral_absorption)
            if row["spec_absorb_id"] >= 0:
                self.has_absorbing_dielectric = True
        elif isinstance(m, st.DiffuseLight):
            row["kind"] = mat_tables.MAT_DIFFUSE_LIGHT
            if m.emit is not None:
                row["tex_albedo"] = self._add_texture(m.emit)
            self._fill_spectral_albedo(row, m.spectral_emit)
        elif isinstance(m, st.PBR):
            row["kind"] = mat_tables.MAT_PBR
            for slot, tex in (("tex_albedo", m.albedo),
                              ("tex_rough", m.roughness),
                              ("tex_metal", m.metalness),
                              ("tex_normal", m.normal_map),
                              ("tex_sss", m.sss)):
                if tex is not None:
                    row[slot] = self._add_texture(tex)
            row["sss_radius"] = float(m.sss_radius)
            self._fill_spectral_albedo(row, m.spectral_albedo)
        elif isinstance(m, st.Isotropic):
            raise NotImplementedError(
                f"{type(m).__name__} is not ported yet: {_MEDIA_PBR}")
        else:
            raise TypeError(f"unknown material {m!r}")
        self._mat_cache[key] = len(self.mat_rows)
        self.mat_rows.append(row)
        return self._mat_cache[key]

    def _push_prim(self, kind, g0, g1, g2, g3, mat_id, flip, uv=None, vn=None,
                   has_vn=False, tb=None):
        self.prim_blocks.append(dict(
            kind=np.array([kind], np.int32),
            g0=np.asarray(g0, np.float64)[None],
            g1=np.asarray(g1, np.float64)[None],
            g2=np.asarray(g2, np.float64)[None],
            g3=np.asarray(g3, np.float64)[None],
            mat_id=np.array([mat_id], np.int32), flip=np.array([bool(flip)]),
            uv=(np.zeros(6) if uv is None else np.asarray(uv, np.float64))[None],
            vn=(np.zeros(9) if vn is None else np.asarray(vn, np.float64))[None],
            has_vn=np.array([bool(has_vn)]),
            tb=(np.zeros(6) if tb is None else np.asarray(tb, np.float64))[None]))

    def add_rect(self, p0, e1, e2, normal, mat_id, xf: _Transform):
        self._push_prim(prim.KIND_RECT, xf.point(p0), xf.vector(e1),
                        xf.vector(e2), xf.vector(normal), mat_id, xf.flip)

    def add_triangle(self, v0, v1, v2, uv, vn, has_vn, mat_id, xf: _Transform):
        v0w, v1w, v2w = xf.point(v0), xf.point(v1), xf.point(v2)
        e1 = v1w - v0w
        e2 = v2w - v0w
        n = np.cross(e1, e2)
        n_len = np.linalg.norm(n)
        n = n / n_len if n_len > 0 else np.array([0.0, 0.0, 1.0])
        if has_vn:
            vn = np.concatenate([xf.vector(vn[0:3]), xf.vector(vn[3:6]),
                                 xf.vector(vn[6:9])])
        # Tangent/bitangent from UV deltas (triangle.go:75-98), as
        # compiler.py:362-376 computes them.
        du1, dv1 = uv[2] - uv[0], uv[3] - uv[1]
        du2, dv2 = uv[4] - uv[0], uv[5] - uv[1]
        denom = du1 * dv2 - du2 * dv1
        if denom != 0.0:
            f = 1.0 / denom
            tangent = f * (dv2 * e1 - dv1 * e2)
            bitangent = f * (-du2 * e1 + du1 * e2)
            tl = np.linalg.norm(tangent)
            bl = np.linalg.norm(bitangent)
            tangent = tangent / tl if tl > 0 else tangent
            bitangent = bitangent / bl if bl > 0 else bitangent
            tb = np.concatenate([tangent, bitangent])
        else:
            tb = np.zeros(6)
        self._push_prim(prim.KIND_TRIANGLE, v0w, e1, e2, n, mat_id, xf.flip,
                        uv=uv, vn=vn, has_vn=has_vn, tb=tb)

    def add_triangle_mesh(self, vertices, uvs, normals, mat_id,
                          xf: _Transform):
        """A (T, 3, 3) vertex array as T triangles, computed over the whole
        array as `compiler.py:381-425` does, so the rows equal the JAX
        package's bit for bit."""
        v = np.asarray(vertices, np.float64) @ xf.rot.T + xf.trans
        t = v.shape[0]
        v0, e1, e2 = v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
        n = np.cross(e1, e2)
        n_len = np.linalg.norm(n, axis=1, keepdims=True)
        n = np.where(n_len > 0, n / np.where(n_len > 0, n_len, 1.0),
                     np.array([0.0, 0.0, 1.0]))
        uv = (np.asarray(uvs, np.float64).reshape(t, 6) if uvs is not None
              else np.zeros((t, 6)))
        has_vn = normals is not None
        vn = ((np.asarray(normals, np.float64) @ xf.rot.T).reshape(t, 9)
              if has_vn else np.zeros((t, 9)))
        # The UV tangent frame over the whole array (compiler.py:400-413).
        du1, dv1 = uv[:, 2] - uv[:, 0], uv[:, 3] - uv[:, 1]
        du2, dv2 = uv[:, 4] - uv[:, 0], uv[:, 5] - uv[:, 1]
        denom = du1 * dv2 - du2 * dv1
        f = np.where(denom != 0.0, 1.0 / np.where(denom != 0.0, denom, 1.0),
                     0.0)[:, None]
        tangent = f * (dv2[:, None] * e1 - dv1[:, None] * e2)
        bitangent = f * (-du2[:, None] * e1 + du1[:, None] * e2)

        def _norm(x):
            ln = np.linalg.norm(x, axis=1, keepdims=True)
            return np.where(ln > 0, x / np.where(ln > 0, ln, 1.0), x)

        tb = np.concatenate([_norm(tangent), _norm(bitangent)], axis=1)
        tb = np.where((denom != 0.0)[:, None], tb, 0.0)
        self.prim_blocks.append(dict(
            kind=np.full(t, prim.KIND_TRIANGLE, np.int32), g0=v0, g1=e1,
            g2=e2, g3=n, mat_id=np.full(t, mat_id, np.int32),
            flip=np.full(t, bool(xf.flip)), uv=uv, vn=vn,
            has_vn=np.full(t, has_vn), tb=tb))

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
    if isinstance(h, st.Group):
        for child in h.children:
            _compile_hitable(b, child, xf)
    elif isinstance(h, st.FlipNormals):
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
    elif isinstance(h, st.Triangle):
        mat_id = b.add_material(h.material)
        uv = np.array([*h.uv0, *h.uv1, *h.uv2], np.float64)
        has_vn = h.vn0 is not None
        vn = (np.array([*h.vn0, *h.vn1, *h.vn2], np.float64) if has_vn
              else np.zeros(9))
        b.add_triangle(h.v0, h.v1, h.v2, uv, vn, has_vn, mat_id, xf)
    elif isinstance(h, st.TriangleMesh):
        mat_id = b.add_material(h.material)
        b.add_triangle_mesh(h.vertices, h.uvs, h.normals, mat_id, xf)
    elif isinstance(h, st.ConstantMedium):
        raise NotImplementedError(f"media are not ported yet: {_MEDIA_PBR}")
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
    elif isinstance(h, st.Triangle):
        v0, v1, v2 = (np.array(v, np.float64) for v in (h.v0, h.v1, h.v2))
        cr = np.cross(v1 - v0, v2 - v0)
        b.add_light(lights_mod.LIGHT_TRIANGLE, v0, v1, v2,
                    cr / np.linalg.norm(cr), np.linalg.norm(cr) / 2.0)
    elif isinstance(h, st.TriangleMesh):
        # One member per triangle, untransformed (compiler.py:596-602).
        for v in np.asarray(h.vertices, np.float64):
            cr = np.cross(v[1] - v[0], v[2] - v[0])
            b.add_light(lights_mod.LIGHT_TRIANGLE, v[0], v[1], v[2],
                        cr / np.linalg.norm(cr), np.linalg.norm(cr) / 2.0)
    elif isinstance(h, st.Sphere):
        b.add_light(lights_mod.LIGHT_SPHERE, l0=h.center0, radius=h.radius)
    else:
        # Box and anything else: PDF 0 / Random (1,0,0) (box.go:57-63).
        b.add_light(lights_mod.LIGHT_NULL)


def _tables(b: _Builder, scene: st.Scene) -> Dict[str, np.ndarray]:
    """`_Builder` rows as named numpy leaves (f64 for float fields)."""
    out = {f"prims.{f}": np.concatenate([blk[f] for blk in b.prim_blocks])
           for f in prim.Prims._fields}
    for group, rows, fields in (
            ("materials", b.mat_rows, mat_tables.Materials._fields),
            ("lights", b.light_rows, lights_mod.Lights._fields)):
        for f in fields:
            out[f"{group}.{f}"] = np.asarray([r[f] for r in rows])
    out["textures.kind"] = np.asarray([r[0] for r in b.tex_rows])
    out["textures.c0"] = np.stack([r[1] for r in b.tex_rows])
    out["textures.c1"] = np.stack([r[2] for r in b.tex_rows])
    for k, v in camera_mod.compile_camera_host(scene.camera).items():
        out[f"camera.{k}"] = np.asarray(v, np.float64)
    out["spd_table"] = np.stack(b.spds)
    return out


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return torch.tensor(a, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.tensor(a.astype(np.int32), device=device)
    return torch.tensor(a.astype(np.float64).astype(np.float32), device=device)


def _assemble(leaves: Dict[str, np.ndarray], device) -> CompiledScene:
    def group(cls, name):
        return cls(**{f: _to_tensor(leaves[f"{name}.{f}"], device)
                      for f in cls._fields})

    return CompiledScene(
        prims=group(prim.Prims, "prims"),
        materials=group(mat_tables.Materials, "materials"),
        textures=group(tex_tables.Textures, "textures"),
        lights=group(lights_mod.Lights, "lights"),
        camera=group(camera_mod.CameraArrays, "camera"),
        spd_table=_to_tensor(leaves["spd_table"], device),
    )


def _meta(leaves: Dict[str, np.ndarray], **scene_facts) -> SceneMeta:
    """The meta facts the tables show; `scene_facts` adds those they do not
    (spectral, exposure, spectral_background_spd, n_media)."""
    mat_kind = np.asarray(leaves["materials.kind"])
    tex_kind = np.asarray(leaves["textures.kind"])
    return SceneMeta(
        n_prims=int(np.asarray(leaves["prims.kind"]).shape[0]),
        n_materials=int(mat_kind.shape[0]),
        n_lights=int(np.asarray(leaves["lights.kind"]).shape[0]),
        has_absorbing_dielectric=bool(np.any(
            (np.asarray(leaves["materials.has_absorption"])
             | (np.asarray(leaves["materials.spec_absorb_id"]) >= 0))
            & (mat_kind == mat_tables.MAT_DIELECTRIC))),
        has_checker=bool(np.any(tex_kind == tex_tables.TEX_CHECKER)),
        has_image=bool(np.any(tex_kind == tex_tables.TEX_IMAGE)),
        has_noise=bool(np.any(tex_kind == tex_tables.TEX_NOISE)),
        has_pbr=bool(np.any(mat_kind == mat_tables.MAT_PBR)),
        **scene_facts,
    )


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
    if not b.prim_blocks:
        raise ValueError("scene has no primitives")
    if not b.tex_rows:
        b._add_texture(st.ConstantTexture((0.0, 0.0, 0.0)))
    if scene.spectral and any(
            r["kind"] == mat_tables.MAT_PBR and r["spec_albedo_id"] < 0
            and r["spec_albedo_gauss"][2] <= 0 for r in b.mat_rows):
        # compiler.py:784-790 uplifts such an RGB albedo automatically.
        raise NotImplementedError(
            f"a PBR material without a spectral albedo in a spectral scene "
            f"needs the RGB-to-spectral uplift, which is not ported yet: "
            f"{_MEDIA_PBR}")
    # The background SPD is the last row, as in compiler.py:819-821.
    bg_id = (None if scene.spectral_background is None
             else b.add_spd(scene.spectral_background))
    leaves = _tables(b, scene)
    return _assemble(leaves, device), _meta(
        leaves, spectral=bool(scene.spectral),
        exposure=float(scene.camera.exposure), spectral_background_spd=bg_id,
        placeholder_assets=tuple(scene.placeholder_assets))


def from_jax_arrays(leaves: Dict[str, np.ndarray], device,
                    jax_meta=None) -> Tuple[CompiledScene, SceneMeta]:
    """The JAX package's compiled scene, its leaves fetched as numpy and
    keyed as in LEAVES, as the port's compiled scene.

    The tables carry over value for value (the JAX leaves are float32
    already), so both packages render the same scene. The facts the tables
    do not show (spectral, exposure, the background SPD row, the number of
    media, the placeholder assets) come from `jax_meta`, the JAX SceneMeta,
    when it is given."""
    missing = [k for k in LEAVES if k not in leaves]
    if missing:
        raise KeyError(f"missing leaves: {missing}")
    facts = {}
    if jax_meta is not None:
        facts = {f: getattr(jax_meta, f) for f in (
            "spectral", "exposure", "spectral_background_spd", "n_media",
            "placeholder_assets")}
    return _assemble(leaves, device), _meta(leaves, **facts)
