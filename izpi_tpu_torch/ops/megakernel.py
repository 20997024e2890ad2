"""The RGB megakernel: the whole render loop in one CUDA kernel.

Counterpart of `izpi_tpu/ops/megakernel.py`. Its kernel (`build_renderer.
<kernel>`, megakernel.py:628) is replaced by `csrc/megakernel_rgb.cu`, one
thread per path slot, with the Threefry cipher inlined from
`csrc/threefry.cuh`. The kernel is bound by per-thread FP32/INT32 issue
through the Threefry rounds and the primitive loop; at the slice's sizes the
scene tables (a few KB) stay cache-resident, so memory is not the limit.

Slots are pinned to pixels: slot s serves pixel s mod n_pix, and replicas
(`pick_replication`) split a pixel's samples on small frames. Slot s walks
samples replica·spp_slot + [0, spp_slot) + offset in turn (the mapping of
megakernel.py:647, not the XLA pool's samp·r + replica), so a render split
into sample-offset chunks sums to the single-pass render.

This module holds:
- `eligible`, the JAX package's rule (megakernel.py:74-81);
- `pack_tables`, the scene tables as contiguous f32/i32 tensors whose row
  layouts `csrc/megakernel_rgb.cu` reads;
- `render_slots`, the wrapper: a CUDA tensor launches the kernel (or the
  call raises), a CPU tensor runs the plain twin;
- `render_slots_reference`, the plain twin: vectorised over slots, built
  from `integrator.path.bounce_rgb` and `geometry.primitives.intersect_brute`,
  with the same replica mapping and slot-pinned refill.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from izpi_tpu_torch import camera as camera_mod
from izpi_tpu_torch.core import rng
from izpi_tpu_torch.core import vecmath as vm
from izpi_tpu_torch.integrator import path as path_mod
from izpi_tpu_torch.ops import threefry as tf
from izpi_tpu_torch.texture import tables as tex_tables

# Largest scene the megakernel takes (the JAX package's unroll budget,
# megakernel.py:53; the CUDA kernel reads primitives from memory, so the cap
# only keeps the eligibility rule identical).
MAX_PRIMS = 560
# Slots wanted in flight before replicas stop doubling (megakernel.py:606).
# The value was chosen for the TPU's lanes; retuning it for the H100's 132
# SMs is later work.
MIN_SLOTS = 8192

# Row widths of the packed tables; csrc/megakernel_rgb.cu reads the same.
PRIM_F, PRIM_I, MAT_F, MAT_I, LIGHT_F, CAM_F = 24, 4, 12, 4, 16, 24

# Launches of the CUDA megakernel made by `render_slots`.
launches = 0


def eligible(cs, meta) -> bool:
    """The JAX package's rule: RGB, no media/PBR/image/noise, 1..560 prims."""
    if meta.spectral or meta.has_pbr or meta.n_media > 0:
        return False
    if meta.has_image or meta.has_noise:
        return False
    return 0 < meta.n_prims <= MAX_PRIMS


def pick_replication(n_pix: int, spp: int, min_slots: int = MIN_SLOTS) -> int:
    """Replicas per pixel (slots working one pixel on disjoint sample
    ranges) to keep enough slots in flight on small frames."""
    r = 1
    while r < spp and n_pix * r < min_slots and spp % (r * 2) == 0:
        r *= 2
    return r


class SceneTables(NamedTuple):
    """The compiled scene as the kernel reads it (rows documented in
    csrc/megakernel_rgb.cu)."""

    prim_f: torch.Tensor   # (P, PRIM_F) f32
    prim_i: torch.Tensor   # (P, PRIM_I) i32
    mat_f: torch.Tensor    # (M, MAT_F) f32
    mat_i: torch.Tensor    # (M, MAT_I) i32
    light_f: torch.Tensor  # (L, LIGHT_F) f32
    light_i: torch.Tensor  # (L,) i32
    cam: torch.Tensor      # (CAM_F,) f32


def pack_tables(cs) -> SceneTables:
    """Pack the compiled scene into contiguous tables on its device. Each
    material's albedo texture is resolved here (constant or checker), with
    the JAX evaluator's reading of a negative texture id as texture 0."""
    dev = cs.device
    p, m, tx, li, c = cs.prims, cs.materials, cs.textures, cs.lights, cs.camera

    def rows(width, *cols):
        flat = [col.reshape(col.shape[0], -1).float() for col in cols]
        used = sum(f.shape[1] for f in flat)
        pad = torch.zeros((flat[0].shape[0], width - used), device=dev)
        return torch.cat(flat + [pad], dim=1).contiguous()

    tid = torch.clamp(m.tex_albedo.long(), min=0)
    prim_f = rows(PRIM_F, p.g0, p.g1, p.g2, p.g3, p.vn)
    prim_i = torch.stack([p.kind, p.mat_id, p.flip.int(), p.has_vn.int()], 1)
    mat_f = rows(MAT_F, tx.c0[tid], tx.c1[tid], m.fuzz, m.ref_idx, m.absorption)
    mat_i = torch.stack([m.kind, (tx.kind[tid] == tex_tables.TEX_CHECKER).int(),
                         m.has_absorption.int(), torch.zeros_like(m.kind)], 1)
    light_f = rows(LIGHT_F, li.l0, li.l1, li.l2, li.normal, li.area, li.radius)
    cam = rows(CAM_F, *(x.reshape(1, -1) for x in c))[0]
    return SceneTables(prim_f, prim_i.int().contiguous(), mat_f,
                       mat_i.int().contiguous(), light_f,
                       li.kind.int().contiguous(), cam.contiguous())


def table_specs(tables: SceneTables, meta):
    """(name, tensor, shape, dtype) of each table, as the kernels read them."""
    n_p, n_m, n_l = meta.n_prims, meta.n_materials, meta.n_lights
    return [(name, getattr(tables, name), shape, dtype) for name, shape, dtype in (
        ("prim_f", (n_p, PRIM_F), torch.float32),
        ("prim_i", (n_p, PRIM_I), torch.int32),
        ("mat_f", (n_m, MAT_F), torch.float32),
        ("mat_i", (n_m, MAT_I), torch.int32),
        ("light_f", (n_l, LIGHT_F), torch.float32),
        ("light_i", (n_l,), torch.int32),
        ("cam", (CAM_F,), torch.float32))]


def _key_words(key):
    words = [int(w) & tf.MASK for w in key.reshape(-1).tolist()]
    if len(words) != 2:
        raise ValueError("key must hold two words")
    return words


def render_slots_reference(cs, meta, settings, nx: int, ny: int, spp: int,
                           key, offset: int = 0):
    """Plain twin of the CUDA kernel. Returns (acc (nx·ny, 3) f32 radiance
    summed over the spp samples, rays traced as a 0-dim int64 tensor)."""
    dev = cs.device
    n_pix = nx * ny
    repl = pick_replication(n_pix, spp)
    spp_slot = spp // repl
    n_slots = n_pix * repl
    slot = torch.arange(n_slots, device=dev)
    pix = slot % n_pix
    replica = slot // n_pix
    key = torch.as_tensor(_key_words(key), dtype=torch.int64, device=dev)

    def make_ray(samp):
        sid = (replica * spp_slot + samp + offset) & tf.MASK
        keys = rng.path_keys_perray(key, pix, sid)
        o, d, tme = camera_mod.primary_rays(cs.camera, keys, pix % nx,
                                            pix // nx, nx, ny)
        return o, d, tme, keys

    samp = torch.zeros(n_slots, dtype=torch.int64, device=dev)
    o, d, tme, keys = make_ray(samp)
    depth = torch.zeros_like(samp)
    thru = torch.ones_like(o)
    rad = torch.zeros_like(o)
    acc = torch.zeros_like(o)
    live = torch.full((n_slots,), spp_slot > 0, dtype=torch.bool, device=dev)
    nrays = torch.zeros((), dtype=torch.int64, device=dev)
    sentinel = o.new_tensor([0.0, 0.0, 1.0])
    zero = torch.zeros((), device=dev)
    while bool(live.any()):
        o, d, thru, rad, active, nr = path_mod.bounce_rgb(
            cs, meta, settings, o, d, tme, keys, depth, thru, rad, live)
        nrays = nrays + nr
        depth = depth + 1
        capped = active & (depth >= settings.max_depth)
        rad = rad + torch.where(capped[:, None], thru * sentinel, zero)
        active = active & ~capped
        # Deposit the DeNAN'd radiance of finished paths, refill their slots.
        died = live & ~active
        acc = acc + torch.where(died[:, None], vm.de_nan(rad), zero)
        samp = torch.where(died, samp + 1, samp)
        issue = died & (samp < spp_slot)
        o_n, d_n, t_n, k_n = make_ray(samp)
        o = torch.where(issue[:, None], o_n, o)
        d = torch.where(issue[:, None], d_n, d)
        tme = torch.where(issue, t_n, tme)
        keys = torch.where(issue[:, None], k_n, keys)
        depth = torch.where(issue, torch.zeros_like(depth), depth)
        thru = torch.where(issue[:, None], torch.ones_like(thru), thru)
        rad = torch.where(issue[:, None], torch.zeros_like(rad), rad)
        live = active | issue
    return acc.reshape(repl, n_pix, 3).sum(dim=0), nrays


def check_tables(dev: torch.device, specs) -> None:
    """Raise unless every (name, tensor, shape, dtype) of `specs` is a
    contiguous tensor of that shape and type on the CUDA device `dev`."""
    for name, t, shape, dtype in specs:
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be on a CUDA device, not {t.device}")
        if (t.dtype != dtype or tuple(t.shape) != tuple(shape)
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                             f"shape {tuple(shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the scene on {dev}")


def render_slots(cs, meta, settings, nx: int, ny: int, spp: int, key,
                 offset: int = 0, tables: SceneTables | None = None):
    """Render nx×ny at spp samples per pixel, samples [offset, offset+spp).

    Returns (acc (nx·ny, 3) f32 summed radiance — divide by spp for the
    image — and rays traced, a 0-dim int64 tensor; int64 because a 256²
    frame at 1024 spp and depth up to 50 can pass 2³¹ rays).

    On a CUDA device this launches `izpi_megakernel_rgb`; any failure to
    build or launch raises. On the CPU it runs `render_slots_reference`."""
    if not eligible(cs, meta):
        raise NotImplementedError(
            "scene not eligible for the megakernel; the queue pool that "
            "renders it is ROADMAP A6")
    dev = cs.device
    if dev.type == "cpu":
        return render_slots_reference(cs, meta, settings, nx, ny, spp, key,
                                      offset)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not (nx > 0 and ny > 0 and spp >= 0):
        raise ValueError("nx, ny must be positive and spp non-negative")
    if tables is None:
        tables = pack_tables(cs)
    check_tables(dev, table_specs(tables, meta))

    from izpi_tpu_torch.ops import _build

    lib = _build.load()
    n_p, n_l = meta.n_prims, meta.n_lights
    n_pix = nx * ny
    repl = pick_replication(n_pix, spp)
    spp_slot = spp // repl
    n_slots = n_pix * repl
    seed0, seed1 = _key_words(key)
    bg = [float(x) for x in settings.background]
    acc = torch.empty((n_slots, 3), dtype=torch.float32, device=dev)
    cnt = torch.empty((n_slots,), dtype=torch.int32, device=dev)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.izpi_megakernel_rgb(
            ptr(tables.prim_f), ptr(tables.prim_i), n_p,
            ptr(tables.mat_f), ptr(tables.mat_i),
            ptr(tables.light_f), ptr(tables.light_i), n_l, ptr(tables.cam),
            seed0, seed1, offset & tf.MASK, nx, ny, spp_slot, n_slots,
            int(settings.max_depth), bg[0], bg[1], bg[2],
            int(bool(settings.exact_book_cosine)), ptr(acc), ptr(cnt),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"izpi_megakernel_rgb launch failed: CUDA error {err}")
    global launches
    launches += 1
    return (acc.reshape(repl, n_pix, 3).sum(dim=0),
            cnt.sum(dtype=torch.int64))
