"""The spectral pieces of the wavefront scheduler.

Counterpart of the parts of `izpi_tpu/integrator/wavefront.py` that the
spectral megakernel's plain version shares with the JAX pool: the λ stream
(`LAMBDA_SALT`, :48; the draw of `_make_ray_fns`, :147-150), the spectral
depth cap (:176-178) and the XYZ deposit (:185-195). The pool schedulers
themselves are not ported yet (ROADMAP A6).

Spectral transport follows render/spectral.go:71-106: λ importance-sampled
by CIE-Y per sample, scalar radiance along the path, and a deposit of
radiance·(x̄,ȳ,z̄)(λ)/pdf(λ). The deposit is DeNAN'd, the JAX package's
deliberate deviation from the reference, whose spectral canvas takes NaNs.
"""

from __future__ import annotations

import torch

from izpi_tpu_torch.core import rng
from izpi_tpu_torch.core import vecmath as vm
from izpi_tpu_torch.spectral import cie

LAMBDA_SALT = 0x7A3B  # salt of the λ draw at depth 0


def sample_lambda(keys):
    """(λ, pdf(λ)) per path keyed `keys` (N, 2): one uniform at depth 0
    under LAMBDA_SALT, then CIE-Y sampling."""
    u = rng.bounce_uniforms(keys, 0, 1, salt=LAMBDA_SALT)[:, 0]
    return cie.sample_wavelength(u)


def cap_spectral(rad, thru, bg_val, capped):
    """At the depth cap a spectral path gathers the background SPD at its
    λ (spectral.go:48-52)."""
    return rad + torch.where(capped, thru * bg_val, torch.zeros_like(rad))


def xyz_contribution(rad, lam, lam_pdf):
    """The (N, 3) XYZ deposit of finished paths: de_nan(xyz(λ)·rad/pdf(λ)),
    with a zero weight where pdf(λ) = 0 (u drew exactly 0 and landed on
    ȳ[0] = 0, which the reference divides into Inf)."""
    x, y, z = cie.get_cie_values(lam)
    xyz = torch.stack([x, y, z], dim=-1)
    w = torch.where(lam_pdf > 0.0, rad / lam_pdf, torch.zeros_like(rad))
    return vm.de_nan(xyz * w[:, None])
