"""Measured/standard light-source SPD library (42 entries).

A copy of `izpi_tpu/spectral/lightsources.py` on the port's `spectral.spd`,
with its own copy of `lightsources_data.json` (byte-identical; the tests
hold both equal). Parity with internal/lightsources/lightsources.go: 39
tabulated SPDs on the CIE 5 nm grid — the Royer (2019) measured-LED dataset
subset (doi:10.6084/m9.figshare.7704566.v1), the CIE F1–F12 fluorescent
series, HPS lamps, measured incandescents and a 650 nm laser — plus three
blackbody-synthesized sources (incandescent_2800k, halogen_3200k,
cie_illuminant_a_2856k; lightsources.go:217-223).
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, List

import numpy as np

from izpi_tpu_torch.spectral import spd as spd_mod

_DATA_PATH = os.path.join(os.path.dirname(__file__), "lightsources_data.json")

_BLACKBODY = {
    "incandescent_2800k": 2800.0,
    "halogen_3200k": 3200.0,
    "cie_illuminant_a_2856k": 2856.0,
}


@functools.lru_cache(maxsize=1)
def _library() -> Dict[str, spd_mod.SPD]:
    with open(_DATA_PATH) as f:
        raw = json.load(f)
    out: Dict[str, spd_mod.SPD] = {}
    for name, entry in raw.items():
        if "wavelengths" in entry:
            out[name] = spd_mod.SPD(np.array(entry["wavelengths"]),
                                    np.array(entry["values"]))
        else:
            out[name] = spd_mod.SPD.cie_grid(np.array(entry["values"]))
    for name, temp in _BLACKBODY.items():
        out[name] = spd_mod.blackbody(temp)
    return out


def get_light_source(name: str) -> spd_mod.SPD:
    """GetLightSource (lightsources.go:468); raises KeyError if unknown."""
    lib = _library()
    if name not in lib:
        raise KeyError(
            f"unknown light source {name!r}; see list_light_sources()")
    return lib[name]


def list_light_sources() -> List[str]:
    """ListLightSources (lightsources.go:474)."""
    return sorted(_library())
