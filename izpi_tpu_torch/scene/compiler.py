"""Scene compiler: host-side description → flat float32/int32 tensors.

Counterpart of `izpi_tpu/scene/compiler.py`: rects, boxes, spheres (moving
ones included), triangles and triangle meshes, the FlipNormals / Translate /
RotateY wrappers baked into geometry by `_Transform` (triangles carry their
UV tangent frame, `Prims.tb`), the Lambertian / Metal / Dielectric (with
absorption) / DiffuseLight / Isotropic / PBR materials with constant,
checker, image and noise textures and their spectral columns (tabulated,
neutral and Gaussian spectra, the spectral checker, η(λ), spectral
absorption, the RGB-to-spectral uplift of an image albedo and of every PBR
albedo of a spectral scene without a spectrum of its own), ConstantMedium
boundaries (a box or sphere under Translate / RotateY) as the `Media`
group, the padded image stack, the combined PBR map stack, the scene's SPD
table, the spectral background and the light list. `_Builder` emits numpy
float64, converted once to float32 tensors on the given device, the same
f64 → f32 path as `compiler.py:646-663`, so both packages hold equal
tables. `from_jax_arrays` takes the JAX package's compiled tables (as
numpy) so tests can render the same tables through both packages.
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
from izpi_tpu_torch.texture import perlin as perlin_mod
from izpi_tpu_torch.texture import tables as tex_tables

# Byte cap of the padded combined map stack (compiler.py:706, where the
# IZPI_COMBO_BYTES_CAP environment variable sets it): materials whose maps
# would pass it are evicted, largest first, to the generic lookups.
COMBO_BYTES_CAP = 1 << 29


class Media(NamedTuple):
    """Participating media (ConstantMedium boundaries), SoA
    (compiler.py:36-50). A boundary is a box or a sphere in object space
    under a baked rigid transform, p_obj = rot_w2o @ (p_world - trans). A
    scene without media holds one dummy row."""

    rot_w2o: torch.Tensor    # (M, 3, 3) f32
    trans: torch.Tensor      # (M, 3) f32
    p0: torch.Tensor         # (M, 3) f32 box min | sphere centre
    p1: torch.Tensor         # (M, 3) f32 box max | (radius, 0, 0)
    is_sphere: torch.Tensor  # (M,) bool
    density: torch.Tensor    # (M,) f32
    mat_id: torch.Tensor     # (M,) int32, the Isotropic phase material


class CompiledScene(NamedTuple):
    """Everything the device needs, as tensors on one device."""

    prims: prim.Prims
    materials: mat_tables.Materials
    textures: tex_tables.Textures
    lights: lights_mod.Lights
    camera: camera_mod.CameraArrays
    spd_table: torch.Tensor  # (S, 371) f32 on the 1 nm grid; row 0 is zeros
    media: Media

    @property
    def device(self) -> torch.device:
        return self.prims.kind.device


@dataclasses.dataclass
class SceneMeta:
    """Static facts about the compiled scene (compiler.py:65-88)."""

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
    # Some material uplifts its RGB albedo to a spectrum (the port's own
    # fact: the spectral bounce evaluates the uplift only then).
    has_uplift: bool = False
    n_media: int = 0
    media_is_sphere: tuple = ()
    # Assets replaced by procedural placeholders at load (scene.pbtxt,
    # library.extracted), reported by render() (compiler.py:83-85).
    placeholder_assets: tuple = ()
    # The process group over which the texture stacks are sharded
    # (parallel.dist.make_sharded_textures; the JAX package's
    # tex_shard_axis), or None for whole stacks.
    tex_shard_group: object = None


# The leaves the port reads, by "<group>.<field>" of the JAX CompiledScene
# (or the field's bare name for a leaf that is not in a group).
LEAVES = (
    [f"prims.{f}" for f in prim.Prims._fields]
    + [f"materials.{f}" for f in mat_tables.Materials._fields]
    + [f"textures.{f}" for f in tex_tables.Textures._fields
       if f not in ("perlin", "img_base", "combo_base")]
    + [f"textures.perlin.{f}" for f in perlin_mod.PerlinTables._fields]
    + [f"lights.{f}" for f in lights_mod.Lights._fields]
    + [f"camera.{f}" for f in camera_mod.CameraArrays._fields]
    + ["spd_table"]
    + [f"media.{f}" for f in Media._fields]
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
        # (kind, c0, c1, noise scale, image id) per texture.
        self.tex_rows: List[tuple] = []
        self._tex_cache: Dict[int, int] = {}
        self.images: List[np.ndarray] = []
        self._img_cache: Dict[int, int] = {}
        self.mat_rows: List[dict] = []
        self._mat_cache: Dict[int, int] = {}
        # Primitive blocks: one dict of (k, ...) arrays per push, one row for
        # a single primitive and T rows for a mesh (compiler.py:326-336).
        self.prim_blocks: List[dict] = []
        self.light_rows: List[dict] = []
        self.spds: List[np.ndarray] = [
            np.zeros(spd_mod.DEVICE_GRID_N, np.float32)]
        self.has_absorbing_dielectric = False
        # One dict of a medium's fields per ConstantMedium (compiler.py:
        # 543-574).
        self.media: List[dict] = []

    def _add_texture(self, t) -> int:
        """The texture's row, shared by equal constants and noises, by
        checkers of the same children and by the same image texture object
        (compiler.py:175-199)."""
        if isinstance(t, st.ImageTexture):
            key = id(t)
        elif isinstance(t, st.CheckerTexture):
            key = hash((type(t).__name__, (id(t.odd), id(t.even))))
        else:
            key = hash((type(t).__name__, t))
        if key in self._tex_cache:
            return self._tex_cache[key]
        z = np.zeros(3)
        if isinstance(t, st.ConstantTexture):
            row = (tex_tables.TEX_CONSTANT, np.array(t.color, np.float64), z,
                   0.0, -1)
        elif isinstance(t, st.CheckerTexture):
            if not (isinstance(t.odd, st.ConstantTexture)
                    and isinstance(t.even, st.ConstantTexture)):
                raise NotImplementedError(
                    "checker children must be constant textures")
            row = (tex_tables.TEX_CHECKER, np.array(t.odd.color, np.float64),
                   np.array(t.even.color, np.float64), 0.0, -1)
        elif isinstance(t, st.ImageTexture):
            row = (tex_tables.TEX_IMAGE, z, z, 0.0, self._add_image(t))
        elif isinstance(t, st.NoiseTexture):
            row = (tex_tables.TEX_NOISE, z, z, float(t.scale), -1)
        else:
            raise TypeError(f"unknown texture {t!r}")
        self._tex_cache[key] = len(self.tex_rows)
        self.tex_rows.append(row)
        return self._tex_cache[key]

    def _add_image(self, t) -> int:
        """An image's row of the stack, one per pixel array, as f32 RGB
        with FlipX/FlipY baked in (texture/image.go:104-133)."""
        key = id(t.data)
        if key in self._img_cache:
            return self._img_cache[key]
        data = np.asarray(t.data, dtype=np.float32)
        if data.ndim == 2:
            data = data[..., None].repeat(3, axis=-1)
        data = data[..., :3]
        if t.flip_y:
            data = data[::-1, :, :]
        if t.flip_x:
            data = data[:, ::-1, :]
        self._img_cache[key] = len(self.images)
        self.images.append(data)
        return self._img_cache[key]

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
        raise NotImplementedError(
            f"spectral texture {type(t).__name__} not yet compiled")

    def _fill_spectral_albedo(self, row: dict, t) -> None:
        """A spectral albedo or emission into the material row: a constant
        gives one SPD row or Gaussian, a SpectralChecker its two branches,
        a SpectralImage an image albedo with the uplift flag
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
        if isinstance(t, st.SpectralImage):
            row["tex_albedo"] = self._add_texture(st.ImageTexture(data=t.data))
            row["spec_albedo_uplift"] = True
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
            row["kind"] = mat_tables.MAT_ISOTROPIC
            if m.albedo is not None:
                row["tex_albedo"] = self._add_texture(m.albedo)
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
        _compile_medium(b, h, xf)
    else:
        raise TypeError(f"unknown hitable {h!r}")


def _compile_medium(b: _Builder, h, xf: _Transform):
    """A ConstantMedium: its boundary, a box or a sphere under any
    Translate / RotateY / FlipNormals wrappers, as a rigid transform and a
    canonical shape (compiler.py:543-574)."""
    mat_id = b.add_material(h.phase)
    inner, bxf = h.boundary, xf
    while isinstance(inner, (st.FlipNormals, st.Translate, st.RotateY)):
        if isinstance(inner, st.Translate):
            bxf = bxf.then_translate(inner.offset)
        elif isinstance(inner, st.RotateY):
            bxf = bxf.then_rotate_y(inner.angle_degrees)
        inner = inner.inner
    if isinstance(inner, st.Box):
        p0, p1 = np.array(inner.p0, np.float64), np.array(inner.p1, np.float64)
    elif isinstance(inner, st.Sphere):
        p0 = np.array(inner.center0, np.float64)
        p1 = np.array([inner.radius, 0.0, 0.0])
    else:
        raise NotImplementedError(
            f"ConstantMedium boundary {type(inner).__name__} unsupported")
    b.media.append(dict(rot_w2o=bxf.rot.T, trans=bxf.trans, p0=p0, p1=p1,
                        is_sphere=isinstance(inner, st.Sphere),
                        density=float(h.density), mat_id=mat_id))


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


def _image_stack(images):
    """The images zero-padded into one (I, maxH, maxW, 3) f32 stack, with
    their widths and heights (compiler.py:669-680); a 1×1 dummy when the
    scene has none."""
    if not images:
        return (np.zeros((1, 1, 1, 3), np.float32), np.ones(1, np.int32),
                np.ones(1, np.int32))
    stack = np.zeros((len(images), max(im.shape[0] for im in images),
                      max(im.shape[1] for im in images), 3), np.float32)
    for i, im in enumerate(images):
        stack[i, :im.shape[0], :im.shape[1]] = im
    return (stack, np.array([im.shape[1] for im in images], np.int32),
            np.array([im.shape[0] for im in images], np.int32))


def _combined_stack(b: _Builder):
    """The per-material combined map stack (compiler.py:682-773): each
    distinct (albedo, normal, rough, metal) image-id tuple of a material
    baked into one (H, W, 8) slab at the largest of its maps' sizes, with
    the reference's nearest-neighbour index math at each texel's centre
    (albedo.rgb, normal.xyz, mean roughness, mean metalness), then slabs
    evicted largest first while the padded stack passes COMBO_BYTES_CAP.
    Returns (stack (Ic, H, W, 8) f32, widths, heights, combo id per
    material row, -1 for none)."""
    def img_id_of(tid):
        if tid < 0 or tid >= len(b.tex_rows):
            return None
        kind, _, _, _, img_id = b.tex_rows[tid]
        return int(img_id) if kind == tex_tables.TEX_IMAGE else None

    combo_ids, combos, combo_by_key = [], [], {}
    for r in b.mat_rows:
        key = (img_id_of(r["tex_albedo"]), img_id_of(r["tex_normal"]),
               img_id_of(r["tex_rough"]), img_id_of(r["tex_metal"]))
        if all(iid is None for iid in key):
            combo_ids.append(-1)
            continue
        if key in combo_by_key:
            combo_ids.append(combo_by_key[key])
            continue
        imgs = [None if iid is None else b.images[iid] for iid in key]
        ch = max(im.shape[0] for im in imgs if im is not None)
        cw = max(im.shape[1] for im in imgs if im is not None)
        jj, ii = np.meshgrid(np.arange(ch), np.arange(cw), indexing="ij")
        u_c = (ii + 0.5) / cw
        omv_c = (jj + 0.5) / ch          # 1 - v at the texel centre

        def samp(im):
            hm, wm = im.shape[:2]
            i2 = np.clip((u_c * wm).astype(np.int64), 0, wm - 1)
            j2 = np.clip((omv_c * (hm - 0.001)).astype(np.int64), 0, hm - 1)
            return np.asarray(im, np.float32)[j2, i2]

        out = np.zeros((ch, cw, 8), np.float32)
        if imgs[0] is not None:
            out[..., 0:3] = samp(imgs[0])
        if imgs[1] is not None:
            out[..., 3:6] = samp(imgs[1])
        for slot, im in ((6, imgs[2]), (7, imgs[3])):
            if im is not None:
                s3 = samp(im)
                out[..., slot] = (s3[..., 0] + s3[..., 1] + s3[..., 2]) / 3.0
        combo_by_key[key] = len(combos)
        combo_ids.append(len(combos))
        combos.append(out)
    while combos:
        c_h = max(c.shape[0] for c in combos)
        c_w = max(c.shape[1] for c in combos)
        if len(combos) * c_h * c_w * 8 * 4 <= COMBO_BYTES_CAP:
            break
        biggest = max(range(len(combos)),
                      key=lambda i: combos[i].shape[0] * combos[i].shape[1])
        combos.pop(biggest)
        combo_ids = [-1 if c == biggest else (c - 1 if c > biggest else c)
                     for c in combo_ids]
    if not combos:
        return (np.zeros((0, 1, 1, 8), np.float32), np.zeros(0, np.int32),
                np.zeros(0, np.int32), combo_ids)
    cstack = np.zeros((len(combos), max(c.shape[0] for c in combos),
                       max(c.shape[1] for c in combos), 8), np.float32)
    for i, c in enumerate(combos):
        cstack[i, :c.shape[0], :c.shape[1]] = c
    return (cstack, np.array([c.shape[1] for c in combos], np.int32),
            np.array([c.shape[0] for c in combos], np.int32), combo_ids)


def _media_leaves(b: _Builder) -> Dict[str, np.ndarray]:
    """The Media group; one dummy row when the scene has no medium
    (compiler.py:823-837)."""
    rows = b.media or [dict(rot_w2o=np.eye(3), trans=np.zeros(3),
                            p0=np.zeros(3), p1=np.ones(3), is_sphere=False,
                            density=1.0, mat_id=0)]
    return {f"media.{f}": np.asarray([r[f] for r in rows])
            for f in Media._fields}


def _tables(b: _Builder, scene: st.Scene) -> Dict[str, np.ndarray]:
    """`_Builder` rows as named numpy leaves (f64 for float fields)."""
    out = {f"prims.{f}": np.concatenate([blk[f] for blk in b.prim_blocks])
           for f in prim.Prims._fields}
    images, img_w, img_h = _image_stack(b.images)
    combined, combo_w, combo_h, combo_ids = _combined_stack(b)
    for r, cid in zip(b.mat_rows, combo_ids):
        r["combo_id"] = cid
    if scene.spectral:
        # Spectral scenes uplift PBR RGB albedos without a spectrum of
        # their own (compiler.py:784-790, transport.go:241-248).
        for r in b.mat_rows:
            if (r["kind"] == mat_tables.MAT_PBR and r["spec_albedo_id"] < 0
                    and r["spec_albedo_gauss"][2] <= 0):
                r["spec_albedo_uplift"] = True
    for group, rows, fields in (
            ("materials", b.mat_rows, mat_tables.Materials._fields),
            ("lights", b.light_rows, lights_mod.Lights._fields)):
        for f in fields:
            out[f"{group}.{f}"] = np.asarray([r[f] for r in rows])
    out["textures.kind"] = np.asarray([r[0] for r in b.tex_rows])
    out["textures.c0"] = np.stack([r[1] for r in b.tex_rows])
    out["textures.c1"] = np.stack([r[2] for r in b.tex_rows])
    out["textures.scale"] = np.asarray([r[3] for r in b.tex_rows], np.float64)
    out["textures.img_id"] = np.asarray([r[4] for r in b.tex_rows], np.int32)
    out.update({"textures.images": images, "textures.img_w": img_w,
                "textures.img_h": img_h, "textures.combined": combined,
                "textures.combo_w": combo_w, "textures.combo_h": combo_h})
    for f, t in perlin_mod.build_tables(seed=0)._asdict().items():
        out[f"textures.perlin.{f}"] = t.numpy()
    for k, v in camera_mod.compile_camera_host(scene.camera).items():
        out[f"camera.{k}"] = np.asarray(v, np.float64)
    out["spd_table"] = np.stack(b.spds)
    out.update(_media_leaves(b))
    return out


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return torch.tensor(a, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.tensor(a.astype(np.int32), device=device)
    return torch.tensor(a.astype(np.float64).astype(np.float32), device=device)


def _assemble(leaves: Dict[str, np.ndarray], device) -> CompiledScene:
    def group(cls, name, **given):
        return cls(**{f: given[f] if f in given
                      else _to_tensor(leaves[f"{name}.{f}"], device)
                      for f in cls._fields})

    return CompiledScene(
        prims=group(prim.Prims, "prims"),
        materials=group(mat_tables.Materials, "materials"),
        textures=group(tex_tables.Textures, "textures", perlin=group(
            perlin_mod.PerlinTables, "textures.perlin"), img_base=None,
            combo_base=None),
        lights=group(lights_mod.Lights, "lights"),
        camera=group(camera_mod.CameraArrays, "camera"),
        spd_table=_to_tensor(leaves["spd_table"], device),
        media=group(Media, "media"),
    )


def _meta(leaves: Dict[str, np.ndarray], **scene_facts) -> SceneMeta:
    """The meta facts the tables show; `scene_facts` adds those they do not
    (spectral, exposure, spectral_background_spd, n_media,
    media_is_sphere)."""
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
        has_uplift=bool(np.any(leaves["materials.spec_albedo_uplift"])),
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
    # The background SPD is the last row, as in compiler.py:819-821.
    bg_id = (None if scene.spectral_background is None
             else b.add_spd(scene.spectral_background))
    leaves = _tables(b, scene)
    return _assemble(leaves, device), _meta(
        leaves, spectral=bool(scene.spectral),
        exposure=float(scene.camera.exposure), spectral_background_spd=bg_id,
        n_media=len(b.media),
        media_is_sphere=tuple(m["is_sphere"] for m in b.media),
        placeholder_assets=tuple(scene.placeholder_assets))


def from_jax_arrays(leaves: Dict[str, np.ndarray], device,
                    jax_meta=None) -> Tuple[CompiledScene, SceneMeta]:
    """The JAX package's compiled scene, its leaves fetched as numpy and
    keyed as in LEAVES, as the port's compiled scene.

    The tables carry over value for value (the JAX leaves are float32
    already), so both packages render the same scene. The facts the tables
    do not show (spectral, exposure, the background SPD row, the number of
    media and their shapes, the placeholder assets) come from `jax_meta`,
    the JAX SceneMeta, when it is given."""
    missing = [k for k in LEAVES if k not in leaves]
    if missing:
        raise KeyError(f"missing leaves: {missing}")
    facts = {}
    if jax_meta is not None:
        facts = {f: getattr(jax_meta, f) for f in (
            "spectral", "exposure", "spectral_background_spd", "n_media",
            "media_is_sphere", "placeholder_assets")}
    return _assemble(leaves, device), _meta(leaves, **facts)
