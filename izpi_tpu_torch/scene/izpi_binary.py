"""Binary `.izpi` scene decoder (protobuf wire format).

A copy of `izpi_tpu/scene/izpi_binary.py` (struct only). It decodes the
transport proto's binary encoding into the dict tree the pbtxt parser
produces (`scene.pbtxt`), so both formats share one scene converter. The
schema tables encode the message and field-number layout of
internal/proto/transport/transport.proto, the interchange contract, as
data.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

# kind ∈ {"msg:<Name>", "map:<Name>", "str", "bytes", "f32", "f64",
#          "varint", "bool", "enum:<Name>", "rf32" (repeated packed f32)}
SCHEMA: Dict[str, Dict[int, Tuple[str, str]]] = {
    "Vec3": {1: ("x", "f32"), 2: ("y", "f32"), 3: ("z", "f32")},
    "Vec2": {1: ("u", "f32"), 2: ("v", "f32")},
    "Camera": {
        1: ("lookfrom", "msg:Vec3"), 2: ("lookat", "msg:Vec3"),
        3: ("vup", "msg:Vec3"), 4: ("vfov", "f32"), 5: ("aspect", "f32"),
        6: ("aperture", "f32"), 7: ("focusdist", "f32"), 8: ("time0", "f32"),
        9: ("time1", "f32"), 10: ("exposure", "f32"),
    },
    "Texture": {
        1: ("name", "str"), 2: ("type", "enum:TextureType"),
        3: ("constant", "msg:ConstantTexture"),
        4: ("checker", "msg:CheckerTexture"),
        5: ("image", "msg:ImageTexture"),
        6: ("noise", "msg:NoiseTexture"),
        7: ("spectral_constant", "msg:SpectralConstantTexture"),
        8: ("spectral_checker", "msg:SpectralCheckerTexture"),
    },
    "ConstantTexture": {1: ("value", "msg:Vec3")},
    "CheckerTexture": {1: ("odd", "msg:Texture"), 2: ("even", "msg:Texture")},
    "ImageTexture": {1: ("filename", "str")},
    "NoiseTexture": {1: ("scale", "f32")},
    "SpectralConstantTexture": {
        1: ("gaussian", "msg:GaussianSpectralConstant"),
        2: ("tabulated", "msg:TabulatedSpectralConstant"),
        3: ("neutral", "msg:NeutralSpectralConstant"),
        4: ("from_light_source_library", "msg:FromLightSourceLibrary"),
    },
    "GaussianSpectralConstant": {
        1: ("peak_value", "f32"), 2: ("center_wavelength", "f32"),
        3: ("width", "f32"),
    },
    "TabulatedSpectralConstant": {
        1: ("wavelengths", "rf32"), 2: ("values", "rf32"),
    },
    "NeutralSpectralConstant": {1: ("reflectance", "f32")},
    "FromLightSourceLibrary": {1: ("light_source_name", "str")},
    "SpectralCheckerTexture": {
        1: ("odd", "msg:SpectralConstantTexture"),
        2: ("even", "msg:SpectralConstantTexture"),
    },
    "Material": {
        1: ("name", "str"), 2: ("type", "enum:MaterialType"),
        3: ("dielectric", "msg:DielectricMaterial"),
        4: ("diffuselight", "msg:DiffuseLightMaterial"),
        5: ("isotropic", "msg:IsotropicMaterial"),
        6: ("lambert", "msg:LambertMaterial"),
        7: ("metal", "msg:MetalMaterial"),
        8: ("pbr", "msg:PBRMaterial"),
    },
    "LambertMaterial": {
        1: ("albedo", "msg:Texture"),
        2: ("spectral_albedo", "msg:SpectralConstantTexture"),
    },
    "DielectricMaterial": {
        1: ("refidx", "f32"),
        2: ("spectral_refidx", "msg:SpectralConstantTexture"),
        3: ("compute_beer_lambert_attenuation", "bool"),
        4: ("absorption_coeff", "msg:Vec3"),
        5: ("spectral_absorption_coeff", "msg:SpectralConstantTexture"),
    },
    "DiffuseLightMaterial": {
        1: ("emit", "msg:Texture"),
        2: ("spectral_emit", "msg:SpectralConstantTexture"),
    },
    "IsotropicMaterial": {
        1: ("albedo", "msg:Texture"),
        2: ("spectral_albedo", "msg:SpectralConstantTexture"),
    },
    "MetalMaterial": {1: ("albedo", "msg:Vec3"), 2: ("fuzz", "f32")},
    "PBRMaterial": {
        1: ("albedo", "msg:Texture"), 2: ("roughness", "msg:Texture"),
        3: ("metalness", "msg:Texture"), 4: ("normal_map", "msg:Texture"),
        5: ("sss", "msg:Texture"), 6: ("sss_radius", "f32"),
    },
    "DisplaceOperator": {
        1: ("min", "f64"), 2: ("max", "f64"),
        3: ("displacement_map", "str"),
    },
    "Triangle": {
        1: ("vertex0", "msg:Vec3"), 2: ("vertex1", "msg:Vec3"),
        3: ("vertex2", "msg:Vec3"),
        4: ("uv0", "msg:Vec2"), 5: ("uv1", "msg:Vec2"), 6: ("uv2", "msg:Vec2"),
        7: ("normal0", "msg:Vec3"), 8: ("normal1", "msg:Vec3"),
        9: ("normal2", "msg:Vec3"),
        10: ("material_name", "str"),
        11: ("operator", "enum:GeometryOperator"),
        12: ("displace", "msg:DisplaceOperator"),
    },
    "Sphere": {
        1: ("center", "msg:Vec3"), 2: ("radius", "f32"),
        3: ("material_name", "str"),
    },
    "SceneObjects": {
        1: ("triangles", "msg:Triangle"), 2: ("spheres", "msg:Sphere"),
    },
    "ImageTextureMetadata": {
        1: ("filename", "str"), 2: ("width", "varint"),
        3: ("height", "varint"), 4: ("channels", "varint"),
        5: ("pixel_format", "enum:TexturePixelFormat"),
    },
    "MaterialsEntry": {1: ("key", "str"), 2: ("value", "msg:Material")},
    "ImageTexturesEntry": {
        1: ("key", "str"), 2: ("value", "msg:ImageTextureMetadata")},
    "Scene": {
        1: ("name", "str"), 2: ("version", "str"),
        3: ("colour_representation", "enum:ColourRepresentation"),
        4: ("camera", "msg:Camera"),
        5: ("materials", "msg:MaterialsEntry"),
        6: ("image_textures", "msg:ImageTexturesEntry"),
        7: ("displacement_maps", "msg:ImageTexturesEntry"),
        8: ("objects", "msg:SceneObjects"),
        9: ("stream_triangles", "bool"),
        10: ("total_triangles", "varint"),
        11: ("spectral_background", "msg:TabulatedSpectralConstant"),
    },
}

ENUMS = {
    "ColourRepresentation": {0: "COLOUR_REPRESENTATION_UNSPECIFIED",
                             1: "RGB", 2: "SPECTRAL"},
    "MaterialType": {0: "MATERIAL_TYPE_UNSPECIFIED", 1: "DIELECTRIC",
                     2: "DIFFUSE_LIGHT", 3: "ISOTROPIC", 4: "LAMBERT",
                     5: "METAL", 6: "PBR"},
    "TextureType": {0: "TEXTURE_TYPE_UNSPECIFIED", 1: "CONSTANT",
                    2: "CHECKER", 3: "IMAGE", 4: "NOISE",
                    5: "SPECTRAL_CONSTANT", 6: "SPECTRAL_CHECKER"},
    "GeometryOperator": {0: "GEOMETRY_OPERATOR_UNSPECIFIED", 1: "DISPLACE"},
    "TexturePixelFormat": {0: "TEXTURE_PIXEL_FORMAT_UNSPECIFIED",
                           1: "FLOAT64"},
}

# Fields that are repeated (everything else follows last-wins proto3 rules;
# the pbtxt tree convention turns repeats into lists automatically).
REPEATED = {("SceneObjects", "triangles"), ("SceneObjects", "spheres"),
            ("Scene", "materials"), ("Scene", "image_textures"),
            ("Scene", "displacement_maps"),
            ("TabulatedSpectralConstant", "wavelengths"),
            ("TabulatedSpectralConstant", "values")}


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def decode_message(buf: bytes, msg_name: str) -> Dict[str, Any]:
    schema = SCHEMA[msg_name]
    out: Dict[str, Any] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field_no = tag >> 3
        wire = tag & 7
        spec = schema.get(field_no)
        # Read the payload per wire type.
        if wire == 0:
            raw, pos = _read_varint(buf, pos)
        elif wire == 1:
            raw = buf[pos:pos + 8]
            pos += 8
        elif wire == 5:
            raw = buf[pos:pos + 4]
            pos += 4
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            raw = buf[pos:pos + ln]
            pos += ln
        else:
            raise ValueError(f"unsupported wire type {wire} in {msg_name}")
        if spec is None:
            continue  # unknown field: skip
        name, kind = spec

        if kind.startswith("msg:"):
            value: Any = decode_message(raw, kind[4:])
        elif kind == "str":
            value = raw.decode("utf-8")
        elif kind == "bytes":
            value = raw
        elif kind == "f32":
            value = struct.unpack("<f", raw)[0] if wire == 5 else float(raw)
        elif kind == "f64":
            value = struct.unpack("<d", raw)[0] if wire == 1 else float(raw)
        elif kind == "rf32":
            if wire == 2:  # packed
                value = list(struct.unpack(f"<{len(raw)//4}f", raw))
            else:
                value = [struct.unpack("<f", raw)[0]]
        elif kind == "bool":
            value = bool(raw)
        elif kind == "varint":
            value = int(raw)
        elif kind.startswith("enum:"):
            value = ENUMS[kind[5:]].get(int(raw), int(raw))
        else:
            raise ValueError(f"unknown kind {kind}")

        if (msg_name, name) in REPEATED or isinstance(value, list):
            if kind == "rf32":
                out.setdefault(name, []).extend(value)
            else:
                out.setdefault(name, []).append(value)
        else:
            out[name] = value
    return out


def load_tree(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return decode_message(f.read(), "Scene")
