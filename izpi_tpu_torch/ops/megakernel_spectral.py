"""The spectral megakernel: the whole spectral render loop in one CUDA kernel.

Counterpart of `izpi_tpu/ops/megakernel_spectral.py`. Its kernel
(`build_renderer.<kernel>`, megakernel_spectral.py:267) is replaced by
`csrc/megakernel_spectral.cu`: the RGB megakernel's persistent design
(`ops.megakernel`: persistent threads over a slot queue on a grid that
fills the card, path regeneration, lazy draws) with λ transport. Each
camera sample draws λ by CIE-Y sampling from its own Threefry stream
(`LAMBDA_SALT`, reusing the camera draw's first fold-in), carries scalar
radiance and throughput at λ, reads η(λ), spectral absorption and the
albedo spectra from the scene's 1 nm SPD table, and deposits XYZ. The
kernel is bound by per-thread FP32/INT32 issue (the cipher rounds and the
primitive loop); at these sizes the tables stay cache-resident and do not
bound it.

Slots are pinned to pixels with the RGB megakernel's replicas and sample
mapping (replica·spp_slot + samp + offset, megakernel_spectral.py:285), on
the card's layout (`megakernel.card_layout`) on a CUDA device and the
JAX rule's on the CPU.

This module holds:
- `eligible`, the JAX package's rule (megakernel_spectral.py:89-112)
  without its `MAX_KNOTS` budget;
- `pack_spectral_tables`, the RGB tables plus the spectral ones;
- `render_slots_spectral`, the wrapper: a CUDA tensor launches the kernel
  (or the call raises), a CPU tensor runs the plain version;
- `render_slots_spectral_reference`, the plain version, built from
  `integrator.path.bounce_spectral` and the λ pieces of
  `integrator.wavefront`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from izpi_tpu_torch import camera as camera_mod
from izpi_tpu_torch.core import rng
from izpi_tpu_torch.integrator import path as path_mod
from izpi_tpu_torch.integrator import wavefront
from izpi_tpu_torch.ops import megakernel
from izpi_tpu_torch.ops import threefry as tf
from izpi_tpu_torch.spectral import cie
from izpi_tpu_torch.spectral import spd as spd_mod

# Row widths of the spectral material tables; csrc/megakernel_spectral.cu
# reads the same.
SPEC_F, SPEC_I = 4, 4
# Rows of the CIE table: x̄, ȳ, z̄ and the f32 inclusive cumsum of ȳ.
CIE_ROWS = 4
# The kernel's C entry; "<ENTRY>_grid" reports its persistent grid.
ENTRY = "izpi_megakernel_spectral"

# Launches of the CUDA spectral megakernel made by `render_slots_spectral`.
launches = 0


def eligible(cs, meta) -> bool:
    """The scenes the kernel covers (megakernel_spectral.py:89-112):
    spectral, no PBR, media, image, noise or checker texture, no spectral
    checker or uplift, 1..560 primitives and a spectral background.

    The JAX rule also caps the SPDs' piecewise-linear knots (`MAX_KNOTS`):
    that is an unroll budget of the TPU kernel, which bakes the knots into
    its code. The CUDA kernel reads the 1 nm table from memory, so the cap
    is not carried over."""
    if not meta.spectral or meta.has_pbr or meta.n_media > 0:
        return False
    if meta.has_image or meta.has_noise or meta.has_checker:
        return False
    if not 0 < meta.n_prims <= megakernel.MAX_PRIMS:
        return False
    m = cs.materials
    if bool(m.spec_checker.any()) or bool(m.spec_albedo_uplift.any()):
        return False
    return meta.spectral_background_spd is not None


class SpectralTables(NamedTuple):
    """The compiled spectral scene as the kernel reads it."""

    rgb: megakernel.SceneTables  # geometry, materials, lights, camera
    spec_f: torch.Tensor  # (M, SPEC_F) f32: Gaussian peak, center, width | pad
    spec_i: torch.Tensor  # (M, SPEC_I) i32: albedo SPD, η SPD, absorption SPD | pad
    spd: torch.Tensor     # (S, 371) f32, the scene's SPD table
    cie: torch.Tensor     # (CIE_ROWS, 75) f32


def cie_table(device) -> torch.Tensor:
    """x̄, ȳ, z̄ and the inclusive cumsum of ȳ, as the float32 values
    `spectral.cie` computes with."""
    rows = np.stack([cie.CIE_X, cie.CIE_Y, cie.CIE_Z, cie._CIE_Y_CUMSUM])
    return torch.as_tensor(rows.astype(np.float32), device=device).contiguous()


def pack_spectral_tables(cs) -> SpectralTables:
    """Pack the compiled scene into contiguous tables on its device (the
    camera row, `megakernel.pack_tables`'s, in host memory)."""
    m = cs.materials
    spec_f = torch.cat([m.spec_albedo_gauss.float(),
                        torch.zeros_like(m.fuzz)[:, None]], dim=1)
    spec_i = torch.stack([m.spec_albedo_id, m.spec_ref_idx_id,
                          m.spec_absorb_id, torch.zeros_like(m.kind)], dim=1)
    return SpectralTables(megakernel.pack_tables(cs), spec_f.contiguous(),
                          spec_i.int().contiguous(),
                          cs.spd_table.float().contiguous(),
                          cie_table(cs.device))


def render_slots_spectral_reference(cs, meta, settings, nx: int, ny: int,
                                    spp: int, key, offset: int = 0,
                                    min_slots: int = megakernel.MIN_SLOTS):
    """Plain version of the CUDA kernel, on the layout `pick_replication`
    gives for `min_slots` (the card's is `megakernel.card_min_slots`).
    Returns (acc (nx·ny, 3) f32 XYZ summed over the spp samples, rays
    traced as a 0-dim int64 tensor)."""
    dev = cs.device
    n_pix = nx * ny
    repl, spp_slot, n_slots = megakernel.slot_layout(n_pix, spp, min_slots)
    slot = torch.arange(n_slots, device=dev)
    pix = slot % n_pix
    replica = slot // n_pix
    key = torch.as_tensor(megakernel._key_words(key), dtype=torch.int64,
                          device=dev)
    bg_id = int(meta.spectral_background_spd or 0)

    def make_ray(samp):
        sid = (replica * spp_slot + samp + offset) & tf.MASK
        keys = rng.path_keys_perray(key, pix, sid)
        o, d, tme = camera_mod.primary_rays(cs.camera, keys, pix % nx,
                                            pix // nx, nx, ny)
        lam, lam_pdf = wavefront.sample_lambda(keys)
        return o, d, tme, keys, lam, lam_pdf

    samp = torch.zeros(n_slots, dtype=torch.int64, device=dev)
    o, d, tme, keys, lam, lam_pdf = make_ray(samp)
    depth = torch.zeros_like(samp)
    thru = torch.ones_like(tme)
    rad = torch.zeros_like(tme)
    acc = torch.zeros_like(o)
    live = torch.full((n_slots,), spp_slot > 0, dtype=torch.bool, device=dev)
    nrays = torch.zeros((), dtype=torch.int64, device=dev)
    zero = torch.zeros((), device=dev)
    intersect = path_mod.make_brute_intersector(cs)
    while bool(live.any()):
        o, d, thru, rad, active, nr, bg_val = path_mod.bounce_spectral(
            cs, meta, settings, intersect, o, d, tme, lam, keys, depth, thru,
            rad, live, bg_id)
        nrays = nrays + nr
        depth = depth + 1
        capped = active & (depth >= settings.max_depth)
        rad = wavefront.cap_spectral(rad, thru, bg_val, capped)
        active = active & ~capped
        # Deposit the XYZ of finished paths, refill their slots.
        died = live & ~active
        acc = acc + torch.where(died[:, None],
                                wavefront.xyz_contribution(rad, lam, lam_pdf),
                                zero)
        samp = torch.where(died, samp + 1, samp)
        issue = died & (samp < spp_slot)
        o_n, d_n, t_n, k_n, lam_n, pdf_n = make_ray(samp)
        o = torch.where(issue[:, None], o_n, o)
        d = torch.where(issue[:, None], d_n, d)
        tme = torch.where(issue, t_n, tme)
        keys = torch.where(issue[:, None], k_n, keys)
        lam = torch.where(issue, lam_n, lam)
        lam_pdf = torch.where(issue, pdf_n, lam_pdf)
        depth = torch.where(issue, torch.zeros_like(depth), depth)
        thru = torch.where(issue, torch.ones_like(thru), thru)
        rad = torch.where(issue, torch.zeros_like(rad), rad)
        live = active | issue
    return acc.reshape(repl, n_pix, 3).sum(dim=0), nrays


def render_slots_spectral(cs, meta, settings, nx: int, ny: int, spp: int,
                          key, offset: int = 0,
                          tables: SpectralTables | None = None,
                          draws: bool = False):
    """Render nx×ny at spp samples per pixel, samples [offset, offset+spp).

    Returns (acc (nx·ny, 3) f32 summed XYZ — divide by spp for the canvas —
    and rays traced, a 0-dim int64 tensor). With `draws` (on the card only)
    a third item: the int64 (scatters, bounce pairs drawn) of the launch.

    On a CUDA device this launches `izpi_megakernel_spectral` on the card's
    layout; any failure to build or launch raises. On the CPU it runs
    `render_slots_spectral_reference` on the JAX rule's layout."""
    if not eligible(cs, meta):
        raise NotImplementedError(
            "scene not eligible for the spectral megakernel; render it "
            "through the queue pool (render(mode='pool'), "
            "integrator.wavefront)")
    dev = cs.device
    if dev.type == "cpu":
        if draws:
            raise ValueError("draw counts come from the CUDA kernel")
        return render_slots_spectral_reference(cs, meta, settings, nx, ny, spp,
                                               key, offset)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not (nx > 0 and ny > 0 and spp >= 0):
        raise ValueError("nx, ny must be positive and spp non-negative")
    if tables is None:
        tables = pack_spectral_tables(cs)
    n_m = meta.n_materials
    n_spd = int(cs.spd_table.shape[0])
    bg_id = int(meta.spectral_background_spd)
    if not 0 <= bg_id < n_spd:
        raise ValueError(f"background SPD row {bg_id} outside the table")
    rgb = tables.rgb
    megakernel.check_tables(dev, megakernel.table_specs(rgb, meta) + [
        ("spec_f", tables.spec_f, (n_m, SPEC_F), torch.float32),
        ("spec_i", tables.spec_i, (n_m, SPEC_I), torch.int32),
        ("spd", tables.spd, (n_spd, spd_mod.DEVICE_GRID_N), torch.float32),
        ("cie", tables.cie, (CIE_ROWS, cie.N_CIE), torch.float32)])
    ids = tables.spec_i[:, :3]
    if bool(((ids < -1) | (ids >= n_spd)).any()):
        raise ValueError("a material's SPD row lies outside the table")

    from izpi_tpu_torch.ops import _build

    lib = _build.load()
    n_pix = nx * ny
    repl, spp_slot, n_slots, blocks = megakernel.card_layout(ENTRY, dev,
                                                             n_pix, spp)
    seed0, seed1 = megakernel._key_words(key)
    queue, acc, cnt, counts = megakernel.launch_buffers(n_slots, draws, dev)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.izpi_megakernel_spectral(
            ptr(rgb.prim_f), ptr(rgb.prim_i), meta.n_prims,
            ptr(rgb.mat_f), ptr(rgb.mat_i),
            ptr(rgb.light_f), ptr(rgb.light_i), meta.n_lights,
            ptr(tables.spec_f), ptr(tables.spec_i), ptr(tables.spd),
            ptr(tables.cie), megakernel.host_camera(rgb.cam),
            seed0, seed1, offset & tf.MASK, nx, ny, spp_slot, n_slots,
            int(settings.max_depth), bg_id,
            int(bool(settings.exact_book_cosine)), blocks, ptr(queue),
            ptr(acc), ptr(cnt), ptr(counts) if draws else None,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"izpi_megakernel_spectral launch failed: CUDA "
                           f"error {err}")
    global launches
    launches += 1
    return megakernel.launch_result(acc, cnt, counts, repl, n_pix, draws)
