"""Wavefront OBJ/MTL importer.

Parity with internal/wavefront/wavefront.go: v/vn/vt/f/g/o/usemtl/mtllib
directives, triangle and quad faces (quad → 0-1-2, 0-2-3, wavefront.go:393),
per-group materials, object-space Translate/Scale/Rotate (Z-Y-X intrinsic,
wavefront.go:419-474), and the .mtl subset Kd/Ka/Ks/Ns/Ni/d/illum
(wavefront.go:528-625). Groups become SoA TriangleMesh objects instead of
one Triangle hitable per face.

A copy of `izpi_tpu/geometry/wavefront_obj.py` (numpy only) on the port's
scene types.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from izpi_tpu_torch.scene import types as st


@dataclasses.dataclass
class MtlMaterial:
    """Raw .mtl record (wavefront.go Material struct)."""

    name: str
    kd: Tuple[float, float, float] = (0.8, 0.8, 0.8)
    ka: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    ks: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    ns: float = 0.0
    ni: float = 1.0
    d: float = 1.0
    illum: int = 2

    def to_material(self) -> st.Material:
        """Default conversion: Lambertian over Kd (the reference builds
        materials per scene; groups usually get a custom material)."""
        return st.Lambertian(albedo=st.ConstantTexture(self.kd))


@dataclasses.dataclass
class ObjGroup:
    name: str
    material: str
    # faces: list of lists of (v_idx, vt_idx, vn_idx), 1-based, 0 = absent
    faces: List[List[Tuple[int, int, int]]] = dataclasses.field(
        default_factory=list)


class WavefrontObj:
    def __init__(self) -> None:
        self.vertices: List[Tuple[float, float, float]] = []
        self.normals: List[Tuple[float, float, float]] = []
        self.uvs: List[Tuple[float, float]] = []
        self.groups: List[ObjGroup] = []
        self.mtl: Dict[str, MtlMaterial] = {}
        self.centre = np.zeros(3)
        self.has_normals = False
        self.has_uv = False

    # -- transforms (object space, wavefront.go:419-474) --

    def translate(self, offset):
        off = np.asarray(offset, np.float64)
        self.centre = self.centre + off
        self.vertices = [tuple(np.asarray(v) + off) for v in self.vertices]

    def scale(self, s):
        s = np.asarray(s, np.float64)
        c = self.centre
        self.vertices = [tuple((np.asarray(v) - c) * s + c)
                         for v in self.vertices]

    def rotate(self, alpha: float, beta: float, gamma: float):
        """Z-Y-X intrinsic rotations about the object centre, radians
        (wavefront.go:440-474)."""
        ca, sa = math.cos(alpha), math.sin(alpha)
        cb, sb = math.cos(beta), math.sin(beta)
        cg, sg = math.cos(gamma), math.sin(gamma)
        rz = np.array([[cg, -sg, 0], [sg, cg, 0], [0, 0, 1]])
        ry = np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]])
        rx = np.array([[1, 0, 0], [0, ca, -sa], [0, sa, ca]])
        m = rx @ ry @ rz
        c = self.centre
        self.vertices = [tuple(m @ (np.asarray(v) - c) + c)
                         for v in self.vertices]
        # Normals rotate too (directions).
        self.normals = [tuple(m @ np.asarray(n)) for n in self.normals]

    # -- group → SoA --

    def group_to_mesh(self, index: int, material: st.Material,
                      ignore_normals: bool = False,
                      ignore_uv: bool = False) -> st.TriangleMesh:
        g = self.groups[index]
        verts, uvs, vns = [], [], []
        use_uv = self.has_uv and not ignore_uv
        use_vn = self.has_normals and not ignore_normals

        def emit(tri_idx):
            v = [np.asarray(self.vertices[i[0] - 1]) for i in tri_idx]
            verts.append(v)
            if use_uv:
                uvs.append([np.asarray(self.uvs[i[1] - 1]) if i[1] > 0
                            else np.zeros(2) for i in tri_idx])
            if use_vn:
                vns.append([np.asarray(self.normals[i[2] - 1]) if i[2] > 0
                            else np.zeros(3) for i in tri_idx])

        for face in g.faces:
            if len(face) == 3:
                emit(face)
            elif len(face) == 4:
                # Quad split 0-1-2 / 0-2-3 (wavefront.go:393-416). Note the
                # reference drops UVs for quads without UV data only.
                emit([face[0], face[1], face[2]])
                emit([face[0], face[2], face[3]])
            # >4-gons unsupported, like the reference (wavefront.go:414).

        return st.TriangleMesh(
            vertices=np.asarray(verts, np.float64),
            material=material,
            uvs=np.asarray(uvs, np.float64) if use_uv and uvs else None,
            normals=np.asarray(vns, np.float64) if use_vn and vns else None,
        )

    def all_meshes(self, material_for: Optional[dict] = None,
                   default_material: Optional[st.Material] = None
                   ) -> List[st.TriangleMesh]:
        out = []
        for i, g in enumerate(self.groups):
            mat = None
            if material_for and g.material in material_for:
                mat = material_for[g.material]
            elif g.material in self.mtl:
                mat = self.mtl[g.material].to_material()
            elif default_material is not None:
                mat = default_material
            else:
                mat = st.Lambertian(
                    albedo=st.ConstantTexture((0.8, 0.8, 0.8)))
            out.append(self.group_to_mesh(i, mat))
        return out


def _parse_face_vertex(tok: str) -> Tuple[int, int, int]:
    parts = tok.split("/")
    v = int(parts[0]) if parts[0] else 0
    vt = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    vn = int(parts[2]) if len(parts) > 2 and parts[2] else 0
    return (v, vt, vn)


def load_obj(path: str, ignore_materials: bool = False) -> WavefrontObj:
    with open(path, "r") as f:
        return parse_obj(f.read(), os.path.dirname(path) or ".",
                         ignore_materials=ignore_materials)


def parse_obj(text: str, container_dir: str = ".",
              ignore_materials: bool = False) -> WavefrontObj:
    o = WavefrontObj()
    current: Optional[ObjGroup] = None
    active_material = ""

    for line in text.splitlines():
        s = line.strip()
        if not s or s.startswith("#"):
            continue
        tok = s.split()
        tag = tok[0]
        if tag == "o" and len(tok) == 2:
            pass  # object name, informational (wavefront.go:141)
        elif tag == "v":
            o.vertices.append(tuple(float(x) for x in tok[1:4]))
        elif tag == "vn":
            o.has_normals = True
            o.normals.append(tuple(float(x) for x in tok[1:4]))
        elif tag == "vt":
            o.has_uv = True
            o.uvs.append(tuple(float(x) for x in tok[1:3]))
        elif tag == "f":
            if current is None:
                current = ObjGroup(name="default", material=active_material)
            current.faces.append([_parse_face_vertex(t) for t in tok[1:]])
        elif tag == "mtllib" and not ignore_materials:
            mtl_path = os.path.join(container_dir, tok[1])
            if os.path.exists(mtl_path):
                with open(mtl_path) as mf:
                    o.mtl.update(parse_mtl(mf.read()))
        elif tag == "usemtl":
            active_material = tok[1]
            if current is not None:
                current.material = active_material
        elif tag == "g":
            if current is not None:
                o.groups.append(current)
            current = ObjGroup(name=tok[1] if len(tok) > 1 else "default",
                               material=active_material)
    if current is not None:
        o.groups.append(current)
    return o


def parse_mtl(text: str) -> Dict[str, MtlMaterial]:
    """Parse the .mtl subset the reference supports (wavefront.go:528-625)."""
    out: Dict[str, MtlMaterial] = {}
    cur: Optional[MtlMaterial] = None
    for line in text.splitlines():
        s = line.strip()
        if not s or s.startswith("#"):
            continue
        tok = s.split()
        tag = tok[0].lower()
        if tag == "newmtl":
            cur = MtlMaterial(name=tok[1])
            out[cur.name] = cur
        elif cur is None:
            continue
        elif tag == "kd":
            cur.kd = tuple(float(x) for x in tok[1:4])
        elif tag == "ka":
            cur.ka = tuple(float(x) for x in tok[1:4])
        elif tag == "ks":
            cur.ks = tuple(float(x) for x in tok[1:4])
        elif tag == "ns":
            cur.ns = float(tok[1])
        elif tag == "ni":
            cur.ni = float(tok[1])
        elif tag == "d":
            cur.d = float(tok[1])
        elif tag == "illum":
            cur.illum = int(tok[1])
    return out
