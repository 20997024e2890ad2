"""Per-ray spectral material evaluation.

Counterpart of `izpi_tpu/materials/spectral_eval.py:23-42`. Tabulated
spectra live in the scene's SPD table (1 nm grid), Gaussian responses stay
parametric, and a material with neither falls back to the luminance of its
RGB texture (the PBR fallback rule, material/pbr.go:285-293).
"""

from __future__ import annotations

import torch

from izpi_tpu_torch.spectral import spd as spd_mod

# NTSC/Rec.601 luma, the reference's RGB→spectral fallback (pbr.go:293).
LUMA = (0.299, 0.587, 0.114)


def luminance(rgb):
    return (LUMA[0] * rgb[..., 0] + LUMA[1] * rgb[..., 1]
            + LUMA[2] * rgb[..., 2])


def spectral_value(spd_table, spd_id, gauss, lam, fallback):
    """A material's spectral response at per-ray wavelengths.

    spd_id: (N,) int (−1 = no tabulated SPD); gauss: (N, 3) (peak, center,
    width; width <= 0 = unused); lam: (N,); fallback: (N,) value when
    neither is present. Gaussian: peak·exp(−((λ−center)/width)²)
    (spectral_constant.go:75-79), the ratio squared by one multiply."""
    tab = spd_mod.device_spd_value(spd_table, torch.clamp(spd_id, min=0), lam)
    peak, center, width = gauss[..., 0], gauss[..., 1], gauss[..., 2]
    w_safe = torch.where(width == 0.0, torch.ones_like(width), width)
    ratio = (lam - center) / w_safe
    gauss_val = peak * torch.exp(-(ratio * ratio))
    return torch.where(spd_id >= 0, tab,
                       torch.where(width > 0.0, gauss_val, fallback))
