"""CIE 1931 colorimetry: the tables, CIE-Y wavelength sampling and the
colour-matching functions at per-ray wavelengths.

Counterpart of `izpi_tpu/spectral/cie.py:17-128` on tensors. The tables and
constants are copied verbatim (the reference's 5 nm CIE 1931 2° data,
internal/spectral/spectral.go:16-76, and its literal `CIE_Y_INTEGRAL`), and
the arithmetic divides where the JAX package divides (`/ CIE_STEP`,
`/ CIE_Y_INTEGRAL`), so both packages draw the same λ bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

WAVELENGTH_MIN = 380.0
WAVELENGTH_MAX = 750.0
N_CIE = 75
CIE_STEP = 5.0

CIE_WAVELENGTHS = np.arange(380.0, 751.0, 5.0)  # (75,)

CIE_X = np.array([
    0.0014, 0.0022, 0.0042, 0.0076, 0.0143, 0.0232, 0.0435, 0.0776, 0.1344, 0.2148,
    0.2839, 0.3285, 0.3483, 0.3481, 0.3362, 0.3187, 0.2908, 0.2511, 0.1954, 0.1421,
    0.0956, 0.0580, 0.0320, 0.0147, 0.0049, 0.0024, 0.0093, 0.0291, 0.0633, 0.1096,
    0.1655, 0.2257, 0.2904, 0.3597, 0.4334, 0.5121, 0.5945, 0.6784, 0.7621, 0.8425,
    0.9163, 0.9786, 1.0263, 1.0567, 1.0622, 1.0456, 1.0026, 0.9384, 0.8544, 0.7514,
    0.6424, 0.5419, 0.4479, 0.3608, 0.2835, 0.2187, 0.1649, 0.1212, 0.0874, 0.0636,
    0.0468, 0.0329, 0.0227, 0.0158, 0.0114, 0.0081, 0.0058, 0.0041, 0.0029, 0.0021,
    0.0015, 0.0011, 0.0008, 0.0006, 0.0004,
])

CIE_Y = np.array([
    0.0000, 0.0001, 0.0001, 0.0002, 0.0004, 0.0006, 0.0012, 0.0022, 0.0040, 0.0073,
    0.0116, 0.0168, 0.0230, 0.0298, 0.0380, 0.0480, 0.0600, 0.0739, 0.0910, 0.1126,
    0.1390, 0.1693, 0.2080, 0.2586, 0.3230, 0.4073, 0.5030, 0.6082, 0.7100, 0.7932,
    0.8620, 0.9149, 0.9540, 0.9803, 0.9950, 1.0000, 0.9950, 0.9786, 0.9520, 0.9154,
    0.8700, 0.8163, 0.7570, 0.6949, 0.6310, 0.5668, 0.5030, 0.4412, 0.3810, 0.3210,
    0.2650, 0.2170, 0.1750, 0.1382, 0.1070, 0.0816, 0.0610, 0.0446, 0.0320, 0.0232,
    0.0170, 0.0119, 0.0082, 0.0057, 0.0041, 0.0029, 0.0021, 0.0015, 0.0010, 0.0007,
    0.0005, 0.0004, 0.0003, 0.0002, 0.0001,
])

CIE_Z = np.array([
    0.0065, 0.0105, 0.0201, 0.0362, 0.0679, 0.1102, 0.2074, 0.3713, 0.6456, 1.0391,
    1.3856, 1.6230, 1.7471, 1.7826, 1.7721, 1.7441, 1.6692, 1.5281, 1.2876, 1.0419,
    0.8130, 0.6162, 0.4652, 0.3533, 0.2720, 0.2123, 0.1582, 0.1117, 0.0782, 0.0573,
    0.0422, 0.0298, 0.0203, 0.0134, 0.0087, 0.0057, 0.0039, 0.0027, 0.0021, 0.0018,
    0.0017, 0.0014, 0.0011, 0.0010, 0.0009, 0.0008, 0.0006, 0.0003, 0.0002, 0.0000,
    0.0000, 0.0000, 0.0000, 0.0000, 0.0000, 0.0000, 0.0000, 0.0000, 0.0000, 0.0000,
    0.0000, 0.0000, 0.0000, 0.0000, 0.0000, 0.0000, 0.0000, 0.0000, 0.0000, 0.0000,
    0.0000, 0.0000, 0.0000, 0.0000, 0.0000,
])

# The reference's literal (spectral.go:64), close to but not sum(CIE_Y): it
# normalizes every estimator, so it is kept.
CIE_Y_INTEGRAL = 21.3768

# Inclusive prefix sum of CIE_Y (float64; the sampler reads it as float32).
_CIE_Y_CUMSUM = np.cumsum(CIE_Y)
# The tables the device functions read, by id (`_f32`).
_TABLES = {id(t): t for t in (CIE_X, CIE_Y, CIE_Z, CIE_WAVELENGTHS,
                               _CIE_Y_CUMSUM)}


@functools.lru_cache(maxsize=None)
def _device_table(table_id: int, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(_TABLES[table_id], np.float32),
                           device=device)


def _f32(table, like: torch.Tensor) -> torch.Tensor:
    """The module table `table` as float32 on `like`'s device, copied there
    once: a pool iteration makes no host-to-device copy."""
    return _device_table(id(table), like.device)


def _interp_fixed_grid(table, lam):
    """Linear interpolation of a 75-entry 5 nm table, clamped at the ends
    (spectral.go:227-254)."""
    lam = lam.float()
    tab = _f32(table, lam)
    x = (lam - WAVELENGTH_MIN) / CIE_STEP
    x = torch.clamp(x, 0.0, N_CIE - 1.0)
    i0 = torch.clamp(torch.floor(x).long(), 0, N_CIE - 2)
    t = x - i0.float()
    return tab[i0] * (1.0 - t) + tab[i0 + 1] * t


def get_cie_values(lam):
    """x̄(λ), ȳ(λ), z̄(λ) by linear interpolation (GetCIEValues,
    spectral.go:227). lam (...,) -> three (...,) tensors."""
    return (_interp_fixed_grid(CIE_X, lam), _interp_fixed_grid(CIE_Y, lam),
            _interp_fixed_grid(CIE_Z, lam))


def sample_wavelength(u):
    """CIE-Y importance sampling of λ by CDF inversion (SampleWavelength,
    spectral.go:184-224). Returns (lambda, pdf), both float32.

    The bin is the first i with cum[i] >= u·CIE_Y_INTEGRAL over the f32
    inclusive cumsum (searchsorted, side="left"); inside it λ and ȳ are
    linear in the CDF mass. i == 0 gives (380, ȳ[0]/I) and a target past
    the end gives (750, ȳ[74]/I), as in the reference."""
    u = u.float()
    cum = _f32(_CIE_Y_CUMSUM, u)
    y = _f32(CIE_Y, u)
    w = _f32(CIE_WAVELENGTHS, u)

    target = u * CIE_Y_INTEGRAL
    i = torch.searchsorted(cum, target.contiguous(), side="left")

    in_range = i < N_CIE
    i_safe = torch.clamp(i, 0, N_CIE - 1)
    im1 = torch.clamp(i_safe - 1, min=0)
    prev = torch.where(i_safe > 0, cum[im1], torch.zeros_like(target))
    t = (target - prev) / torch.clamp(y[i_safe], min=1e-20)

    i_gt0 = i_safe > 0
    lam_interp = w[im1] + t * (w[i_safe] - w[im1])
    y_interp = y[im1] + t * (y[i_safe] - y[im1])

    lam = torch.where(i_gt0, lam_interp, w[i_safe])
    pdf = torch.where(i_gt0, y_interp, y[i_safe]) / CIE_Y_INTEGRAL

    lam = torch.where(in_range, lam, torch.full_like(lam, WAVELENGTH_MAX))
    pdf = torch.where(in_range, pdf, y[N_CIE - 1] / CIE_Y_INTEGRAL)
    return lam, pdf
