"""The queue pool: a fixed pool of path slots, RGB and spectral.

Counterpart of `izpi_tpu/integrator/wavefront.py`: `trace_pool` (:87),
`_make_ray_fns` (:133), `_bounce_step` (:159) and `_trace_pool_queue`
(:275), with the λ stream (`LAMBDA_SALT`, :48), the spectral depth cap
(:176-178) and the XYZ deposit (:185-195) that the spectral megakernel's
plain version shares. Each iteration advances every live path one bounce
through the scene's intersector, deposits the radiance of finished paths
into the pixel accumulator (`index_add_`), and refills freed slots with the
next global sample ids, ranked by a cumsum over the free slots. The
enumeration and keying of (pixel, sample) pairs are the JAX pool's, so the
two agree up to floating-point accumulation order.

Not carried over: the slot-pinned scheduler (:202; the queue is the JAX
package's default and the only scheduler here), `_run_scheduler`'s guarded
and chunked loops (:60-84, which exist for XLA's while-loop syncs: the loop
here is a plain `while active.any()`), and the `IZPI_POOL_*` environment
switches.

Spectral transport follows render/spectral.go:71-106: λ importance-sampled
by CIE-Y per sample, scalar radiance along the path, and a deposit of
radiance·(x̄,ȳ,z̄)(λ)/pdf(λ). The deposit is DeNAN'd, the JAX package's
deliberate deviation from the reference, whose spectral canvas takes NaNs.
"""

from __future__ import annotations

import torch

from izpi_tpu_torch import camera as camera_mod
from izpi_tpu_torch.core import rng
from izpi_tpu_torch.core import vecmath as vm
from izpi_tpu_torch.integrator import path as path_mod
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


def _make_rays(cs, base_key, nx: int, ny: int, spectral: bool,
               sample_offset: int):
    """Sample → ray generation (`_make_ray_fns`): keys and camera rays for
    (pixel, sample) pairs, the streams of the lockstep renderer's
    sample_pass, and λ for a spectral render."""

    def gen(pix, samp):
        keys = rng.path_keys_perray(base_key, pix, samp + sample_offset)
        o, d, tme = camera_mod.primary_rays(cs.camera, keys, pix % nx,
                                            pix // nx, nx, ny)
        if spectral:
            lam, lam_pdf = sample_lambda(keys)
        else:
            lam, lam_pdf = torch.zeros_like(tme), torch.ones_like(tme)
        return o, d, tme, keys, lam, lam_pdf

    return gen


def _bounce_step(cs, meta, settings, intersect, st, spectral: bool,
                 bg_spd_id: int):
    """Advance the pool one bounce; returns (state updates, died mask,
    per-path deposit)."""
    if spectral:
        o, d, thru, rad, active, nrays, bg_val = path_mod.bounce_spectral(
            cs, meta, settings, intersect, st["o"], st["d"], st["time"],
            st["lam"], st["keys"], st["depth"], st["thru"], st["rad"],
            st["active"], bg_spd_id)
    else:
        o, d, thru, rad, active, nrays = path_mod.bounce_rgb(
            cs, meta, settings, intersect, st["o"], st["d"], st["time"],
            st["keys"], st["depth"], st["thru"], st["rad"], st["active"])
    depth = st["depth"] + 1
    capped = active & (depth >= settings.max_depth)
    if spectral:
        rad = cap_spectral(rad, thru, bg_val, capped)
    else:
        # Depth cap: the next Sample call would return {Z:1} (colour.go:34-36).
        sentinel = o.new_tensor([0.0, 0.0, 1.0])
        rad = rad + torch.where(capped[:, None], thru * sentinel,
                                torch.zeros_like(rad))
    active = active & ~capped
    died = st["active"] & ~active
    contrib = (xyz_contribution(rad, st["lam"], st["lam_pdf"]) if spectral
               else vm.de_nan(rad))
    return (dict(o=o, d=d, thru=thru, rad=rad, active=active, depth=depth,
                 nrays=nrays), died, contrib)


def trace_pool(cs, meta, settings, intersect, nx: int, ny: int, spp: int,
               base_key, pool_size: int, spectral: bool = False,
               bg_spd_id: int = 0, sample_offset: int = 0):
    """Render nx×ny@spp, samples [sample_offset, sample_offset + spp), with
    a queue pool of `pool_size` slots (`_trace_pool_queue`).

    Returns (acc (nx·ny, 3) f32 summed radiance — RGB, or CIE XYZ in
    spectral mode; divide by spp for the image —, rays traced as a 0-dim
    int64 tensor, pool iterations). Each iteration calls `intersect` once
    for the bounce, and once more for the exit re-trace when a live ray
    refracted into an absorbing dielectric."""
    if pool_size < 1:
        raise ValueError(f"pool_size must be positive, got {pool_size}")
    dev = cs.device
    n_pix = nx * ny
    total = n_pix * spp
    n = pool_size
    gen = _make_rays(cs, base_key, nx, ny, spectral, sample_offset)

    def sample_to_ray(sample_ids, issued):
        """Rays of the global sample ids; a slot not issued draws sample 0
        of pixel 0, which the caller discards."""
        sid = torch.where(issued, sample_ids, torch.zeros_like(sample_ids))
        pix = sid % n_pix
        return (*gen(pix, sid // n_pix), pix)

    ids = torch.arange(n, dtype=torch.int64, device=dev)
    issued = ids < total
    o, d, tme, keys, lam, lam_pdf, pix = sample_to_ray(ids, issued)
    rad = torch.zeros_like(tme) if spectral else torch.zeros_like(o)
    st = dict(o=o, d=d, time=tme, keys=keys, pix=pix, lam=lam, lam_pdf=lam_pdf,
              depth=torch.zeros_like(ids), thru=torch.ones_like(rad), rad=rad,
              active=issued)
    next_sample = torch.full((), min(n, total), dtype=torch.int64, device=dev)
    acc = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    nrays = torch.zeros((), dtype=torch.int64, device=dev)
    iterations = 0
    while bool(st["active"].any()):
        iterations += 1
        upd, died, contrib = _bounce_step(cs, meta, settings, intersect, st,
                                          spectral, bg_spd_id)
        acc.index_add_(0, st["pix"], torch.where(died[:, None], contrib,
                                                 torch.zeros_like(contrib)))
        nrays = nrays + upd["nrays"]

        free = ~upd["active"]
        new_ids = next_sample + torch.cumsum(free.long(), 0) - 1
        issue = free & (new_ids < total)
        o_n, d_n, t_n, k_n, lam_n, pdf_n, pix_n = sample_to_ray(new_ids, issue)
        sel = issue[:, None]
        sel_r = issue if spectral else sel
        st = dict(
            o=torch.where(sel, o_n, upd["o"]),
            d=torch.where(sel, d_n, upd["d"]),
            time=torch.where(issue, t_n, st["time"]),
            keys=torch.where(sel, k_n, st["keys"]),
            pix=torch.where(issue, pix_n, st["pix"]),
            lam=torch.where(issue, lam_n, st["lam"]),
            lam_pdf=torch.where(issue, pdf_n, st["lam_pdf"]),
            depth=torch.where(issue, torch.zeros_like(upd["depth"]),
                              upd["depth"]),
            thru=torch.where(sel_r, torch.ones_like(upd["thru"]), upd["thru"]),
            rad=torch.where(sel_r, torch.zeros_like(upd["rad"]), upd["rad"]),
            active=upd["active"] | issue)
        next_sample = next_sample + issue.sum()
    return acc, nrays, iterations
