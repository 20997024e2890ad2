"""Post-processing filter pipeline.

A copy of `izpi_tpu/io/postprocess.py` (numpy only). Reference:
internal/postprocess — `Filter.Apply(image, scene)` chained by Pipeline
(pipeline.go:10-32); Gamma is gamma-2 (sqrt, gamma.go:25-40), Clamp
clips to [min,max] (clamp.go:28), ColourGrading applies a .cube 3D LUT with
trilinear interpolation (colourgrading.go:17-55). The reference's PNG path
runs Gamma + Clamp(1.0) (leader.go:178-183); EXR paths are written linear.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


class Gamma:
    """Gamma-2 correction: out = sqrt(in) (gamma.go:25-40)."""

    def apply(self, image: np.ndarray) -> np.ndarray:
        return np.sqrt(np.maximum(image, 0.0))


class Clamp:
    """Clamp to [min, max] (clamp.go:28)."""

    def __init__(self, min_value: float = 0.0, max_value: float = 1.0):
        self.min_value = min_value
        self.max_value = max_value

    def apply(self, image: np.ndarray) -> np.ndarray:
        return np.clip(image, self.min_value, self.max_value)


class ColourGrading:
    """3D LUT (.cube) color grade, trilinear (colourgrading.go:17-55)."""

    def __init__(self, lut: np.ndarray, domain_min=(0, 0, 0),
                 domain_max=(1, 1, 1)):
        self.lut = np.asarray(lut, np.float64)  # (N, N, N, 3), indexed [b][g][r]
        self.domain_min = np.asarray(domain_min, np.float64)
        self.domain_max = np.asarray(domain_max, np.float64)

    @staticmethod
    def from_cube_file(path: str) -> "ColourGrading":
        size = 0
        dmin = np.zeros(3)
        dmax = np.ones(3)
        rows = []
        with open(path) as f:
            for line in f:
                s = line.strip()
                if not s or s.startswith("#"):
                    continue
                tok = s.split()
                key = tok[0].upper()
                if key == "LUT_3D_SIZE":
                    size = int(tok[1])
                elif key == "DOMAIN_MIN":
                    dmin = np.array([float(x) for x in tok[1:4]])
                elif key == "DOMAIN_MAX":
                    dmax = np.array([float(x) for x in tok[1:4]])
                elif key in ("TITLE", "LUT_1D_SIZE"):
                    continue
                else:
                    rows.append([float(x) for x in tok[:3]])
        lut = np.asarray(rows).reshape(size, size, size, 3)  # [b][g][r]
        return ColourGrading(lut, dmin, dmax)

    def apply(self, image: np.ndarray) -> np.ndarray:
        n = self.lut.shape[0]
        x = (np.clip(image, self.domain_min, self.domain_max)
             - self.domain_min) / (self.domain_max - self.domain_min)
        x = x * (n - 1)
        i0 = np.clip(np.floor(x).astype(np.int64), 0, n - 2)
        f = x - i0
        r0, g0, b0 = i0[..., 0], i0[..., 1], i0[..., 2]
        fr, fg, fb = f[..., 0:1], f[..., 1:2], f[..., 2:3]
        out = np.zeros_like(image, dtype=np.float64)
        for db in (0, 1):
            for dg in (0, 1):
                for dr in (0, 1):
                    w = ((fr if dr else 1 - fr)
                         * (fg if dg else 1 - fg)
                         * (fb if db else 1 - fb))
                    out += w * self.lut[b0 + db, g0 + dg, r0 + dr]
        return out


class Pipeline:
    """Ordered filter chain (pipeline.go:10-32)."""

    def __init__(self, filters: Sequence):
        self.filters: List = list(filters)

    def apply(self, image: np.ndarray) -> np.ndarray:
        out = np.asarray(image, np.float64)
        for f in self.filters:
            out = f.apply(out)
        return out
