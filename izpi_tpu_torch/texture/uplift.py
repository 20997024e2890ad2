"""RGB → spectral uplift.

Counterpart of `izpi_tpu/texture/uplift.py:22-56`, the reference's
SpectralImage transform (texture/spectral_image.go:100-190): per-channel
Gaussian lobes with hard wavelength gates (R: 580-750 @650/60, G: 480-620
@550/60, B: 380-520 @450/60), neutral-colour preservation (|r-g|, |g-b|,
|r-b| < 0.15 → keep max(rgb)), bright-pixel preservation (max > 0.7 →
≥ 0.8·max), clamped to [0, 1].

The reference precomputes the value at the 75 CIE bucket wavelengths and
interpolates linearly between buckets (spectral_image.go:193+);
`eval_bucketed` evaluates the formula at the two neighbouring 5 nm nodes and
lerps, as the JAX package does.
"""

from __future__ import annotations

import torch

from izpi_tpu_torch.spectral import cie


def rgb_to_spectral_value(rgb, lam):
    """The uplift formula at exact wavelengths. rgb (..., 3), lam (...,)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    zero = torch.zeros_like(lam)

    def lobe(channel, center, lo, hi):
        falloff = torch.exp(-((lam - center) ** 2) / (2.0 * 60.0 * 60.0))
        return torch.where((lam >= lo) & (lam <= hi), channel * falloff, zero)

    out = zero + lobe(r, 650.0, 580.0, 750.0)
    out = out + lobe(g, 550.0, 480.0, 620.0)
    out = out + lobe(b, 450.0, 380.0, 520.0)

    max_rgb = torch.maximum(r, torch.maximum(g, b))
    neutral = ((torch.abs(r - g) < 0.15) & (torch.abs(g - b) < 0.15)
               & (torch.abs(r - b) < 0.15))
    out = torch.where(neutral, torch.maximum(out, max_rgb), out)
    bright = (max_rgb > 0.7) & (out < max_rgb * 0.8)
    out = torch.where(bright, torch.maximum(out, max_rgb * 0.8), out)
    return torch.clamp(out, 0.0, 1.0)


def eval_bucketed(rgb, lam):
    """The reference's bucketed SpectralImage: the formula at the two
    neighbouring 5 nm CIE nodes, lerped."""
    x = (lam.float() - cie.WAVELENGTH_MIN) / cie.CIE_STEP
    x = torch.clamp(x, 0.0, cie.N_CIE - 1.0)
    i0 = torch.clamp(torch.floor(x).to(torch.int32), 0, cie.N_CIE - 2)
    t = x - i0.float()
    lam0 = cie.WAVELENGTH_MIN + i0.float() * cie.CIE_STEP
    lam1 = lam0 + cie.CIE_STEP
    v0 = rgb_to_spectral_value(rgb, lam0)
    v1 = rgb_to_spectral_value(rgb, lam1)
    return v0 * (1.0 - t) + v1 * t
