"""White balance: white points + Bradford chromatic adaptation.

Parity with internal/spectral/whitebalance.go: white point integration of an
SPD against the CIE matching functions with Y-normalization (:17-48),
blackbody-temperature white points (:50-55), the Bradford adaptation matrix
pipeline M_inv·S·M (:75-146, same matrix literals), and the adapted XYZ→sRGB
matrix with the D65 shortcut (:151-180). All host-side numpy float64.

Counterpart of `izpi_tpu/spectral/whitebalance.py`, value for value; the CIE
lookup of a white point goes through the port's `spectral.cie` on a CPU
tensor.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from izpi_tpu_torch.spectral import cie, spd as spd_mod

D65 = np.array([0.95047, 1.00000, 1.08883])

SRGB_D65_MATRIX = np.array([
    [3.2404542, -1.5371385, -0.4985314],
    [-0.9692660, 1.8760108, 0.0415560],
    [0.0556434, -0.2040259, 1.0572252],
])

BRADFORD = np.array([
    [0.8951000, 0.2664000, -0.1614000],
    [-0.7502000, 1.7135000, 0.0367000],
    [0.0389000, -0.0685000, 1.0296000],
])

BRADFORD_INV = np.array([
    [0.9869929, -0.1470543, 0.1599627],
    [0.4323053, 0.5183603, 0.0492912],
    [-0.0085287, 0.0400428, 0.9684867],
])


def white_point_from_spd(spd: spd_mod.SPD) -> np.ndarray:
    """Σ SPD(λᵢ)·(x̄,ȳ,z̄)(λᵢ) over the SPD's own nodes, Y-normalized
    (whitebalance.go:17-48)."""
    x, y, z = (c.numpy().astype(np.float64) for c in cie.get_cie_values(
        torch.as_tensor(spd.wavelengths, dtype=torch.float32)))
    sx = float(np.sum(spd.values * x))
    sy = float(np.sum(spd.values * y))
    sz = float(np.sum(spd.values * z))
    if sy > 0:
        return np.array([sx / sy, 1.0, sz / sy])
    return np.array([sx, sy, sz])


def white_point_from_temperature(temperature: float) -> np.ndarray:
    return white_point_from_spd(spd_mod.blackbody(temperature))


def chromatic_adaptation_matrix(source_white, target_white) -> np.ndarray:
    """Bradford: M⁻¹ · diag(dst_cone/src_cone) · M (whitebalance.go:104-146)."""
    src = BRADFORD @ np.asarray(source_white, np.float64)
    dst = BRADFORD @ np.asarray(target_white, np.float64)
    scale = np.where(src != 0.0, dst / np.where(src == 0.0, 1.0, src), 1.0)
    return BRADFORD_INV @ np.diag(scale) @ BRADFORD


def adapted_xyz_to_rgb_matrix(white_point) -> np.ndarray:
    """sRGB matrix pre-multiplied by source→D65 adaptation, with the
    near-D65 shortcut (whitebalance.go:151-180)."""
    wp = np.asarray(white_point, np.float64)
    if np.all(np.abs(wp - D65) < 1e-4):
        return SRGB_D65_MATRIX.copy()
    return SRGB_D65_MATRIX @ chromatic_adaptation_matrix(wp, D65)


@dataclasses.dataclass
class WhiteBalanceConfig:
    matrix: np.ndarray
    white_point: np.ndarray
    description: str

    @staticmethod
    def from_temperature(temperature: float) -> "WhiteBalanceConfig":
        if not 1000.0 <= temperature <= 25000.0:
            raise ValueError(
                f"temperature {temperature} K out of valid range (1000-25000)")
        wp = white_point_from_temperature(temperature)
        return WhiteBalanceConfig(adapted_xyz_to_rgb_matrix(wp), wp,
                                  f"{temperature:.0f}K blackbody")

    @staticmethod
    def from_spd(spd: spd_mod.SPD, description: str) -> "WhiteBalanceConfig":
        wp = white_point_from_spd(spd)
        return WhiteBalanceConfig(adapted_xyz_to_rgb_matrix(wp), wp,
                                  description)

    @staticmethod
    def default() -> "WhiteBalanceConfig":
        return WhiteBalanceConfig(SRGB_D65_MATRIX.copy(), D65.copy(),
                                  "D65 (default)")

    def apply(self, xyz: np.ndarray) -> np.ndarray:
        return np.asarray(xyz, np.float64) @ self.matrix.T
