"""Protobuf text-format scene loader (.pbtxt).

The reference's scene interchange format is the transport proto
(internal/proto/transport/transport.proto); scenes ship as text protos
(`.pbtxt`) or binary (`.izpi`). This module parses the text format with a
schema-free recursive parser (field { … } blocks, repeated fields → lists)
and converts the resulting tree into an izpi_tpu Scene — the front half of
the reference's `transport.ToScene` pipeline (transport.go:53), with our
compiler as the back half.

Schema facts mirrored from transport.proto: Scene{name, version,
colour_representation, camera, materials (map), objects{triangles,spheres},
spectral_background, image_textures}; material/texture oneofs resolved by
key presence.

A copy of `izpi_tpu/scene/pbtxt.py` on the port's scene types and spectral
modules (numpy only). It parses everything the JAX loader parses, missing
texture files becoming the same procedural placeholders, reads an image
file that exists through `io.output.read_image` (which raises, naming the
file, on a format it cannot decode) and a binary `.izpi` scene through
`scene.izpi_binary`.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from izpi_tpu_torch.scene import types as st
from izpi_tpu_torch.spectral import lightsources, spd as spd_mod

# ---------------------------------------------------------------------------
# Generic text-format parser
# ---------------------------------------------------------------------------

_TOKEN = re.compile(r"""
    \s*(?:
      (?P<comment>\#[^\n]*)
    | (?P<brace_open>\{)
    | (?P<brace_close>\})
    | (?P<colon>:)
    | (?P<string>"(?:[^"\\]|\\.)*")
    | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
    | (?P<number>-?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?)
    | (?P<bracket_open>\[)
    | (?P<bracket_close>\])
    | (?P<comma>,)
    )""", re.X)


def _tokenize(text: str):
    pos = 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if not m:
            if text[pos:].strip() == "":
                return
            raise ValueError(f"pbtxt parse error at {text[pos:pos+40]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "comment":
            continue
        yield kind, m.group(kind)


class _Parser:
    def __init__(self, text: str):
        self.toks = list(_tokenize(text))
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def parse_message(self, until_brace: bool) -> Dict[str, Any]:
        msg: Dict[str, Any] = {}
        while True:
            kind, val = self.peek()
            if kind is None:
                if until_brace:
                    raise ValueError("unexpected EOF in message")
                return msg
            if kind == "brace_close":
                self.next()
                return msg
            if kind != "name":
                raise ValueError(f"expected field name, got {kind} {val}")
            self.next()
            field = val
            kind2, _ = self.peek()
            if kind2 == "colon":
                self.next()
                value = self.parse_value()
            elif kind2 == "brace_open":
                self.next()
                value = self.parse_message(until_brace=True)
            else:
                raise ValueError(f"expected ':' or '{{' after {field}")
            if field in msg:
                if not isinstance(msg[field], list) or (
                        isinstance(value, list)):
                    msg[field] = [msg[field]]
                msg[field].append(value)
            else:
                msg[field] = value

    def parse_value(self):
        kind, val = self.next()
        if kind == "string":
            return val[1:-1].encode().decode("unicode_escape")
        if kind == "number":
            f = float(val)
            return f
        if kind == "name":
            if val == "true":
                return True
            if val == "false":
                return False
            return val  # enum identifier
        if kind == "brace_open":
            return self.parse_message(until_brace=True)
        if kind == "bracket_open":
            out = []
            while True:
                k, _ = self.peek()
                if k == "bracket_close":
                    self.next()
                    return out
                if k == "comma":
                    self.next()
                    continue
                out.append(self.parse_value())
        raise ValueError(f"unexpected value token {kind} {val}")


def parse_pbtxt(text: str) -> Dict[str, Any]:
    return _Parser(text).parse_message(until_brace=False)


def _as_list(v) -> list:
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


# ---------------------------------------------------------------------------
# Tree → Scene conversion
# ---------------------------------------------------------------------------


def _vec3(msg: Optional[dict], default=(0.0, 0.0, 0.0)) -> Tuple[float, ...]:
    if not msg:
        return default
    return (float(msg.get("x", 0.0)), float(msg.get("y", 0.0)),
            float(msg.get("z", 0.0)))


def _vec2(msg: Optional[dict]) -> Tuple[float, float]:
    if not msg:
        return (0.0, 0.0)
    return (float(msg.get("u", 0.0)), float(msg.get("v", 0.0)))


def _spectral_constant(msg: dict) -> st.SpectralTexture:
    """SpectralConstantTexture oneof (transport.proto:122-158)."""
    if "gaussian" in msg:
        g = msg["gaussian"]
        return st.SpectralGaussian(
            peak=float(g.get("peak_value", 0.0)),
            center=float(g.get("center_wavelength", 0.0)),
            width=float(g.get("width", 1.0)),
        )
    if "tabulated" in msg:
        t = msg["tabulated"]
        wl = [float(x) for x in _as_list(t.get("wavelengths"))]
        vals = [float(x) for x in _as_list(t.get("values"))]
        if len(wl) != len(vals):
            # Some reference scene data ships ragged tables (e.g. water.go's
            # white_light: 38 wavelengths, 39 values); truncate to the pair.
            import warnings

            warnings.warn(f"tabulated SPD length mismatch ({len(wl)} "
                          f"wavelengths vs {len(vals)} values); truncating")
            n = min(len(wl), len(vals))
            wl, vals = wl[:n], vals[:n]
        return st.SpectralTabulated(wavelengths=tuple(wl),
                                    values=tuple(vals))
    if "neutral" in msg:
        return st.SpectralNeutral(
            value=float(msg["neutral"].get("reflectance", 0.0)))
    if "from_light_source_library" in msg:
        name = msg["from_light_source_library"]["light_source_name"]
        s = lightsources.get_light_source(name)
        return st.SpectralTabulated(wavelengths=tuple(s.wavelengths),
                                    values=tuple(s.values))
    raise ValueError(f"empty spectral constant: {msg}")


def _placeholder_image(filename: str) -> np.ndarray:
    """Deterministic procedural stand-in for a missing texture file.

    The reference's built-in scenes reference user-supplied asset files
    (textures/rusty-metal_albedo.png, water_128b.png, …) that ship with
    neither repo; the Go binary would simply fail to load them. We degrade
    gracefully instead so every library scene renders out of the box. The
    pattern is name-aware (normal maps get a flat +Z normal, roughness/
    metalness get mid-gray, heightmaps get waves) and seeded by the filename
    so renders stay deterministic.
    """
    name = os.path.basename(filename).lower()
    n = 128
    yy, xx = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n),
                         indexing="ij")
    if "normal" in name:
        img = np.empty((n, n, 3), np.float64)
        img[..., 0] = 0.5
        img[..., 1] = 0.5
        img[..., 2] = 1.0
        return img
    if "rough" in name:
        return np.full((n, n, 3), 0.5, np.float64)
    if "metal" in name:
        return np.full((n, n, 3), 0.3, np.float64)
    if "water" in name or "height" in name or "displace" in name:
        h = 0.5 + 0.25 * np.sin(xx * 8 * np.pi) * np.cos(yy * 6 * np.pi)
        h += 0.1 * np.sin((xx + yy) * 14 * np.pi)
        return np.repeat(np.clip(h, 0, 1)[..., None], 3, axis=2)
    # albedo / generic: two-tone checker tinted by a filename hash.
    seed = sum(ord(c) for c in name) % 7
    base = np.array([[0.6, 0.45, 0.35], [0.3, 0.5, 0.6], [0.5, 0.5, 0.5],
                     [0.55, 0.35, 0.3], [0.35, 0.55, 0.4], [0.45, 0.4, 0.55],
                     [0.6, 0.55, 0.4]][seed])
    check = ((xx * 8).astype(int) + (yy * 8).astype(int)) % 2
    img = np.where(check[..., None] == 0, base, base * 0.55)
    return img


class _SceneBuilder:
    def __init__(self, container_dir: str):
        self.container_dir = container_dir
        self._image_cache: Dict[str, st.ImageTexture] = {}
        self.placeholder_assets: List[str] = []

    def texture(self, msg: Optional[dict]) -> Optional[st.Texture]:
        """Texture oneof (transport.proto:87-118)."""
        if not msg:
            return None
        if "constant" in msg:
            return st.ConstantTexture(_vec3(msg["constant"].get("value")))
        if "checker" in msg:
            c = msg["checker"]
            return st.CheckerTexture(odd=self.texture(c.get("odd")),
                                     even=self.texture(c.get("even")))
        if "image" in msg:
            return self.image_texture(msg["image"]["filename"])
        if "noise" in msg:
            return st.NoiseTexture(scale=float(msg["noise"].get("scale", 1.0)))
        return None

    def image_texture(self, filename: str) -> st.ImageTexture:
        if filename not in self._image_cache:
            path = filename
            if not os.path.isabs(path):
                path = os.path.join(self.container_dir, filename)
            if os.path.exists(path):
                from izpi_tpu_torch.io import output as output_mod

                data = output_mod.read_image(path)
            else:
                import warnings

                warnings.warn(
                    f"texture file {filename!r} not found; using a "
                    "deterministic procedural placeholder")
                self.placeholder_assets.append(filename)
                data = _placeholder_image(filename)
            self._image_cache[filename] = st.ImageTexture(data=data)
        return self._image_cache[filename]

    def material(self, msg: dict) -> st.Material:
        """Material oneof (transport.proto:163-227), mirroring the per-type
        converters of transport.go:211-478."""
        if "lambert" in msg:
            m = msg["lambert"]
            if "spectral_albedo" in m:
                return st.Lambertian(
                    spectral_albedo=_spectral_constant(m["spectral_albedo"]))
            return st.Lambertian(albedo=self.texture(m.get("albedo")))
        if "metal" in msg:
            m = msg["metal"]
            return st.Metal(albedo=_vec3(m.get("albedo")),
                            fuzz=float(m.get("fuzz", 0.0)))
        if "dielectric" in msg:
            m = msg["dielectric"]
            kwargs: dict = {}
            if "spectral_refidx" in m:
                kwargs["spectral_ref_idx"] = _spectral_constant(
                    m["spectral_refidx"])
            else:
                kwargs["ref_idx"] = float(m.get("refidx", 1.5))
            if "absorption_coeff" in m:
                kwargs["absorption"] = _vec3(m["absorption_coeff"])
            if "spectral_absorption_coeff" in m:
                kwargs["spectral_absorption"] = _spectral_constant(
                    m["spectral_absorption_coeff"])
            return st.Dielectric(**kwargs)
        if "diffuselight" in msg:
            m = msg["diffuselight"]
            if "spectral_emit" in m:
                return st.DiffuseLight(
                    spectral_emit=_spectral_constant(m["spectral_emit"]))
            return st.DiffuseLight(emit=self.texture(m.get("emit")))
        if "isotropic" in msg:
            m = msg["isotropic"]
            return st.Isotropic(albedo=self.texture(m.get("albedo")))
        if "pbr" in msg:
            m = msg["pbr"]
            return st.PBR(
                albedo=self.texture(m.get("albedo")),
                roughness=self.texture(m.get("roughness")),
                metalness=self.texture(m.get("metalness")),
                normal_map=self.texture(m.get("normal_map")),
                sss=self.texture(m.get("sss")),
                sss_radius=float(m.get("sss_radius", 0.0)),
            )
        raise ValueError(f"material with no properties: {msg.get('name')}")


def scene_from_tree(tree: Dict[str, Any], aspect: Optional[float] = None,
                    container_dir: str = ".") -> st.Scene:
    b = _SceneBuilder(container_dir)

    cam_msg = tree.get("camera", {})
    camera = st.Camera(
        look_from=_vec3(cam_msg.get("lookfrom")),
        look_at=_vec3(cam_msg.get("lookat")),
        vup=_vec3(cam_msg.get("vup"), default=(0.0, 1.0, 0.0)),
        vfov=float(cam_msg.get("vfov", 40.0)),
        aspect=float(aspect if aspect is not None
                     else cam_msg.get("aspect", 1.0)),
        aperture=float(cam_msg.get("aperture", 0.0)),
        focus_dist=float(cam_msg.get("focusdist", 10.0)),
        time0=float(cam_msg.get("time0", 0.0)),
        time1=float(cam_msg.get("time1", 1.0)),
        exposure=float(cam_msg.get("exposure", 1.0)),
    )

    # materials: map<string, Material> appears as repeated {key, value}.
    # The reference keys converted materials by the Material's Name field,
    # not the map key (transport.go:123 iterates values; lookups at :601 use
    # triangle.GetMaterialName() against material.GetName()).
    # Register under both so scenes where the two disagree still resolve
    # (e.g. CornellBoxSpectral's map key "Rusty Metal" with a different
    # Name field); name wins on conflict like the reference.
    materials: Dict[str, st.Material] = {}
    for entry in _as_list(tree.get("materials")):
        mat = b.material(entry["value"])
        if entry.get("key"):
            materials[entry["key"]] = mat
        name = entry.get("value", {}).get("name")
        if name:
            materials[name] = mat

    spectral = tree.get("colour_representation") == "SPECTRAL"

    def lookup_material(name: str) -> st.Material:
        """Resolve a material reference; undefined names get a neutral
        Lambertian with a warning (the Go ToScene hard-errors at
        transport.go:601-603, but reference scene data itself contains
        dangling references, e.g. CornellBoxSpectral's "Rusty Metal")."""
        if name not in materials:
            import warnings

            warnings.warn(f"material {name!r} not defined in scene; "
                          "substituting a neutral Lambertian")
            if spectral:
                materials[name] = st.Lambertian(
                    spectral_albedo=st.SpectralNeutral(value=0.5))
            else:
                materials[name] = st.Lambertian(
                    albedo=st.ConstantTexture((0.5, 0.5, 0.5)))
        return materials[name]

    world: List[st.Hitable] = []
    objs = tree.get("objects", {})
    tris_v, tris_uv, tris_vn = {}, {}, {}
    for tri in _as_list(objs.get("triangles")):
        mat_name = tri.get("material_name", "")
        has_vn = "normal0" in tri
        v = (_vec3(tri.get("vertex0")), _vec3(tri.get("vertex1")),
             _vec3(tri.get("vertex2")))
        uv = (_vec2(tri.get("uv0")), _vec2(tri.get("uv1")),
              _vec2(tri.get("uv2")))
        vn = ((_vec3(tri.get("normal0")), _vec3(tri.get("normal1")),
               _vec3(tri.get("normal2"))) if has_vn else None)
        # DisplaceOperator (transport.proto:246-252): group displaced
        # triangles by their map/min/max so tessellation runs per batch.
        disp = None
        if tri.get("operator") == "DISPLACE" and "displace" in tri:
            dmsg = tri["displace"]
            disp = (dmsg.get("displacement_map", ""),
                    float(dmsg.get("min", 0.0)), float(dmsg.get("max", 0.0)))
        key = (mat_name, has_vn, disp)
        tris_v.setdefault(key, []).append(v)
        tris_uv.setdefault(key, []).append(uv)
        tris_vn.setdefault(key, []).append(vn)

    for (mat_name, has_vn, disp), verts in tris_v.items():
        mat = lookup_material(mat_name)
        mesh = st.TriangleMesh(
            vertices=np.asarray(verts, np.float64),
            material=mat,
            uvs=np.asarray(tris_uv[(mat_name, has_vn, disp)], np.float64),
            normals=(np.asarray(tris_vn[(mat_name, has_vn, disp)],
                                np.float64) if has_vn else None),
        )
        if disp is not None:
            from izpi_tpu_torch.geometry import displacement as disp_mod

            dmap = b.image_texture(disp[0]).data
            mesh = disp_mod.displace_mesh(mesh, np.asarray(dmap), disp[1],
                                          disp[2])
        world.append(mesh)

    for sph in _as_list(objs.get("spheres")):
        c = _vec3(sph.get("center"))
        world.append(st.Sphere(c, c, 0.0, 1.0,
                               float(sph.get("radius", 1.0)),
                               lookup_material(sph.get("material_name", ""))))

    background = None
    if "spectral_background" in tree:
        t = tree["spectral_background"]
        background = spd_mod.SPD(
            np.asarray([float(x) for x in _as_list(t.get("wavelengths"))]),
            np.asarray([float(x) for x in _as_list(t.get("values"))]),
        )

    return st.Scene(world=world, camera=camera, spectral=spectral,
                    spectral_background=background,
                    placeholder_assets=list(b.placeholder_assets))


def load_scene(path: str, aspect: Optional[float] = None) -> st.Scene:
    container = os.path.dirname(path) or "."
    if path.endswith(".izpi"):
        from izpi_tpu_torch.scene import izpi_binary

        tree = izpi_binary.load_tree(path)
    else:
        with open(path) as f:
            tree = parse_pbtxt(f.read())
    return scene_from_tree(tree, aspect=aspect, container_dir=container)
