"""XYZ→ACEScg conversion and firefly rejection (host-side, numpy).

Counterpart of `izpi_tpu/spectral/convert.py:20-56`, kept on the host as
the JAX renderer keeps it (renderer.py:426-440). References: internal/
spectral/rgb_image.go (AP1/D60 matrix, exposure) and internal/spectral/
firefly_rejection.go (3×3 neighbourhood, mean+2.5σ clamp on Y preserving
chromaticity).
"""

from __future__ import annotations

import numpy as np

# XYZ → ACEScg (AP1, D60). rgb_image.go:13-17.
XYZ_TO_ACESCG = np.array([
    [1.6410234, -0.3248033, -0.2364247],
    [-0.6636629, 1.6153316, 0.0167563],
    [0.0117219, -0.0082845, 0.9883949],
])


def xyz_to_acescg(xyz: np.ndarray, exposure: float = 1.0) -> np.ndarray:
    """(H,W,3) XYZ → linear ACEScg RGB with exposure (rgb_image.go:28-67)."""
    return (xyz * exposure) @ XYZ_TO_ACESCG.T


def firefly_rejection(xyz: np.ndarray, k_threshold: float = 2.5,
                      min_neighbors: int = 3) -> np.ndarray:
    """Outlier clamp on an (H,W,3) XYZ image.

    Per pixel: the 8 neighbours' Y values, positive ones only (out of
    bounds excluded); with at least 3 of them and Y > mean + 2.5·stddev,
    the XYZ triplet is scaled down to the threshold, which keeps its
    chromaticity (firefly_rejection.go:25-110)."""
    h, w, _ = xyz.shape
    y = xyz[..., 1]
    ypad = np.pad(y, 1, constant_values=0.0)

    shifts = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            shifts.append(ypad[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w])
    neigh = np.stack(shifts)              # (8, H, W)
    pos = neigh > 0

    cnt = pos.sum(axis=0)
    cnt_safe = np.maximum(cnt, 1)
    mean = (neigh * pos).sum(axis=0) / cnt_safe
    var = (((neigh - mean) ** 2) * pos).sum(axis=0) / cnt_safe
    std = np.sqrt(var)
    threshold = mean + k_threshold * std

    apply = (y > 0) & (cnt >= min_neighbors) & (y > threshold) & (threshold > 0)
    ratio = np.where(apply, threshold / np.maximum(y, 1e-30), 1.0)
    return xyz * ratio[..., None]
