"""Built-in material presets.

A copy of `izpi_tpu/materials/presets.py` on the port's scene types. Parity
with internal/materials/materials.go: the porcelain family — PBR with a
tabulated spectral reflectance (high, slightly warm: 0.78@380nm rising to
0.93@600-750nm, materials.go:25-50), white RGB fallback, configurable
roughness and subsurface scattering.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from izpi_tpu_torch.scene import types as st
from izpi_tpu_torch.spectral import cie

# materials.go:25-50 — typical porcelain/ceramic reflectance on the CIE grid.
PORCELAIN_REFLECTANCE = np.array([
    0.78, 0.79, 0.80, 0.81, 0.82, 0.82, 0.83, 0.83, 0.84, 0.84,
    0.85, 0.85, 0.86, 0.86, 0.87, 0.87, 0.88, 0.88, 0.88, 0.88,
    0.88, 0.89, 0.89, 0.89,
    0.89, 0.89, 0.90, 0.90, 0.90, 0.90, 0.90, 0.90, 0.91, 0.91,
    0.91, 0.91, 0.91, 0.91, 0.91, 0.92, 0.92, 0.92, 0.92, 0.92,
    0.92, 0.92, 0.92, 0.93, 0.93, 0.93, 0.93, 0.93, 0.93, 0.93,
    0.93, 0.93, 0.93, 0.93, 0.93, 0.93, 0.93, 0.93, 0.93, 0.93,
    0.93, 0.93, 0.93, 0.93, 0.93, 0.93, 0.93, 0.93, 0.93, 0.93,
    0.93,
])


def create_porcelain_custom(roughness: float, sss_strength: float,
                            sss_radius: float) -> st.PBR:
    """materials.go:104 CreatePorcelainCustom."""
    spectral_albedo = st.SpectralTabulated(
        wavelengths=tuple(float(w) for w in cie.CIE_WAVELENGTHS),
        values=tuple(float(v) for v in PORCELAIN_REFLECTANCE),
    )
    return st.PBR(
        albedo=st.ConstantTexture((0.90, 0.90, 0.90)),
        roughness=st.ConstantTexture((roughness,) * 3),
        metalness=st.ConstantTexture((0.0, 0.0, 0.0)),
        sss=st.ConstantTexture((sss_strength,) * 3),
        sss_radius=sss_radius,
        spectral_albedo=spectral_albedo,
    )


def create_porcelain() -> st.PBR:
    return create_porcelain_custom(0.15, 0.05, 0.1)


def create_porcelain_matte() -> st.PBR:
    return create_porcelain_custom(0.4, 0.05, 0.1)


def create_porcelain_glossy() -> st.PBR:
    return create_porcelain_custom(0.05, 0.05, 0.1)


MATERIAL_LIBRARY: Dict[str, dict] = {
    "porcelain": {
        "description": "High-quality porcelain with spectral reflectance "
                       "(semi-glossy white with warm tone)",
        "create": create_porcelain,
    },
    "porcelain_matte": {
        "description": "Matte porcelain with higher roughness",
        "create": create_porcelain_matte,
    },
    "porcelain_glossy": {
        "description": "Glossy porcelain with very low roughness",
        "create": create_porcelain_glossy,
    },
}


def get_material(name: str) -> st.Material:
    if name not in MATERIAL_LIBRARY:
        raise KeyError(f"unknown material {name!r}; see list_materials()")
    return MATERIAL_LIBRARY[name]["create"]()


def list_materials() -> List[str]:
    return sorted(MATERIAL_LIBRARY)
