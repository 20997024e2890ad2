"""Spectral power distributions.

Counterpart of `izpi_tpu/spectral/spd.py`. On the host, an exact float64
`SPD` with the reference's interpolation (internal/spectral/spectral.go:
151-182), used at scene compile time. On the device, every tabulated
spectrum of a scene is resampled onto one 1 nm grid over 380–750 nm (371
samples) and stacked into an (S, 371) float32 table; `device_spd_value`
evaluates rows of it at per-ray wavelengths with one gather and a lerp.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from izpi_tpu_torch.ops import table_grad
from izpi_tpu_torch.spectral import cie

DEVICE_GRID_MIN = 380.0
DEVICE_GRID_MAX = 750.0
DEVICE_GRID_STEP = 1.0
DEVICE_GRID_N = 371

DEVICE_GRID = np.arange(DEVICE_GRID_MIN, DEVICE_GRID_MAX + 0.5, DEVICE_GRID_STEP)


class SPD:
    """Host-side spectral power distribution (float64, exact): arbitrary
    wavelength nodes, linear interpolation, endpoint clamping."""

    def __init__(self, wavelengths, values):
        self.wavelengths = np.asarray(wavelengths, dtype=np.float64)
        self.values = np.asarray(values, dtype=np.float64)
        if self.wavelengths.shape != self.values.shape:
            raise ValueError("wavelengths and values differ in shape")

    @staticmethod
    def cie_grid(values) -> "SPD":
        values = np.asarray(values, dtype=np.float64)
        if values.shape != (cie.N_CIE,):
            raise ValueError(f"expected {cie.N_CIE} values on the CIE grid")
        return SPD(cie.CIE_WAVELENGTHS, values)

    @staticmethod
    def constant(value: float) -> "SPD":
        return SPD.cie_grid(np.full(cie.N_CIE, float(value)))

    def value(self, lam) -> np.ndarray:
        """np.interp is the reference's clamp-then-lerp."""
        return np.interp(lam, self.wavelengths, self.values)

    def to_device_grid(self) -> np.ndarray:
        """Resample to the 1 nm device grid (371,), float32."""
        return np.interp(DEVICE_GRID, self.wavelengths, self.values).astype(
            np.float32)

    def scaled(self, s: float) -> "SPD":
        return SPD(self.wavelengths, self.values * s)


def blackbody(temperature: float) -> SPD:
    """Planck's-law SPD on the CIE grid, peak-normalized to 1
    (spectral.NewBlackbodySPD, spectral.go:275-319: same constants, same
    >700 exponent guard, same max-normalization)."""
    h = 6.62607015e-34
    c = 2.99792458e8
    k = 1.380649e-23
    c1 = 2.0 * h * c * c
    c2 = (h * c) / k

    values = np.zeros(cie.N_CIE)
    for i, lam_nm in enumerate(cie.CIE_WAVELENGTHS):
        lam_m = lam_nm * 1e-9
        exponent = c2 / (lam_m * temperature)
        if exponent > 700:
            values[i] = 0.0
        else:
            values[i] = c1 / (lam_m**5 * (math.exp(exponent) - 1.0))
    m = values.max()
    if m > 0:
        values /= m
    return SPD.cie_grid(values)


def device_spd_value(table: torch.Tensor, spd_id, lam):
    """Rows `spd_id` (...,) of the (S, 371) table at wavelengths lam (...,),
    clamped at the grid's ends like the reference. Returns float32 (...,)."""
    x = (lam.float() - DEVICE_GRID_MIN) / DEVICE_GRID_STEP
    x = torch.clamp(x, 0.0, DEVICE_GRID_N - 1.0)
    i0 = torch.clamp(torch.floor(x).long(), 0, DEVICE_GRID_N - 2)
    t = x - i0.float()
    sid = spd_id.long()
    v0 = table_grad.gather(table, sid, i0)
    v1 = table_grad.gather(table, sid, i0 + 1)
    return v0 * (1.0 - t) + v1 * t
