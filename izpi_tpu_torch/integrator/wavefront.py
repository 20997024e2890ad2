"""The queue pool: a fixed pool of path slots, RGB and spectral.

Counterpart of `izpi_tpu/integrator/wavefront.py`: `trace_pool` (:87),
`_make_ray_fns` (:133), `_bounce_step` (:159) and `_trace_pool_queue`
(:275), with the λ stream (`LAMBDA_SALT`, :48), the spectral depth cap
(:176-178) and the XYZ deposit (:185-195) that the spectral megakernel's
plain version shares. Each iteration advances every live path one bounce
through the scene's intersector, deposits the radiance of finished paths
into the pixel accumulator (`deposit`: a segment sum over the slots sorted
by pixel, so that the image repeats bit for bit on the card, where a plain
`index_add_` runs as float atomics), and refills freed slots with the
next global sample ids, ranked by a cumsum over the free slots. The
enumeration and keying of (pixel, sample) pairs are the JAX pool's, so the
two agree up to floating-point accumulation order.

The loop is `_run_scheduler`'s chunked while (:60-84) in its GPU form:
`core.loops.chunked_while` tests the pool's end once per chunk of
iterations, and on the card replays one iteration captured as a CUDA graph
(`trace_pool`). Each iteration is a fixpoint once no slot is live, and
syncs with the host nowhere: the sample offset, the sample count and the
iteration count are device scalars, and the exit re-trace of absorbing
dielectrics runs masked. Not carried over: the slot-pinned scheduler
(:202; the queue is the JAX package's default and the only scheduler
here), the guarded fori form (it exists for `lax.cond`'s state copies) and
the `IZPI_POOL_*` environment switches.

Spectral transport follows render/spectral.go:71-106: λ importance-sampled
by CIE-Y per sample, scalar radiance along the path, and a deposit of
radiance·(x̄,ȳ,z̄)(λ)/pdf(λ). The deposit is DeNAN'd, the JAX package's
deliberate deviation from the reference, whose spectral canvas takes NaNs.
"""

from __future__ import annotations

from typing import Optional

import torch

from izpi_tpu_torch import camera as camera_mod
from izpi_tpu_torch.core import loops, rng
from izpi_tpu_torch.core import vecmath as vm
from izpi_tpu_torch.integrator import path as path_mod
from izpi_tpu_torch.ops import threefry as tf
from izpi_tpu_torch.spectral import cie

LAMBDA_SALT = 0x7A3B  # salt of the λ draw at depth 0
MAX_CHUNK = 8  # the most pool iterations between two tests of its end


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


def _make_rays(cs, nx: int, ny: int, spectral: bool):
    """Sample → ray generation (`_make_ray_fns`): keys and camera rays for
    (pixel, sample) pairs under a base key, the streams of the lockstep
    renderer's sample_pass, and λ for a spectral render. The path keys, the
    camera's uniforms and λ's come from one call of the cipher entry
    (`ops.threefry.new_samples`: one launch on the card)."""

    def gen(base_key, pix, samp):
        keys, cam_u, lam_u = tf.new_samples(
            base_key, pix, samp, camera_mod.CAMERA_SALT,
            LAMBDA_SALT if spectral else None)
        o, d, tme = camera_mod.rays_from_uniforms(cs.camera, cam_u, pix % nx,
                                                  pix // nx, nx, ny)
        if spectral:
            lam, lam_pdf = cie.sample_wavelength(lam_u)
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
    # Only a live path deepens: a bounce of dead slots changes nothing.
    depth = torch.where(st["active"], st["depth"] + 1, st["depth"])
    capped = active & (depth >= settings.max_depth)
    if spectral:
        rad = cap_spectral(rad, thru, bg_val, capped)
    else:
        # Depth cap: the next Sample call would return {Z:1} (colour.go:34-36).
        sentinel = vm.const((0.0, 0.0, 1.0), o)
        rad = rad + torch.where(capped[:, None], thru * sentinel,
                                torch.zeros_like(rad))
    active = active & ~capped
    died = st["active"] & ~active
    contrib = (xyz_contribution(rad, st["lam"], st["lam_pdf"]) if spectral
               else vm.de_nan(rad))
    return (dict(o=o, d=d, thru=thru, rad=rad, active=active, depth=depth,
                 nrays=nrays), died, contrib)


def deposit(acc, pix, contrib):
    """Add each slot's deposit `contrib` (N, 3) to row pix[slot] of `acc`
    (a float32 (n_pix, 3) accumulator) in an order that the slots fix, so
    that two renders give the same bits: the slots sorted by pixel (a
    stable sort), each pixel's run summed in slot order by one thread
    (`torch.segment_reduce`, whose kernel loops over a segment), and the
    sums added to the rows. `index_add_` would add them with float atomics
    in the order the card schedules them. No host sync: the runs' offsets
    come from a search of the sorted pixels."""
    keys, order = torch.sort(pix.to(torch.int32), stable=True)
    offsets = torch.searchsorted(keys, torch.arange(
        acc.shape[0] + 1, dtype=torch.int32, device=pix.device))
    acc.add_(torch.segment_reduce(contrib[order], "sum", offsets=offsets,
                                  axis=0, unsafe=True, initial=0.0))


def pool_chunk(total: int, pool_size: int) -> int:
    """Pool iterations between two tests of the pool's end on the card.

    Each test reads the live flags back (a sync, and the device waits
    while the host enqueues the next chunk); a chunk that runs on past the
    end runs full iterations on a dead pool, which deposit and count
    nothing. A pool that cycles g = ceil(total / pool) generations of
    samples runs several iterations a generation (cornell_obj 256²@128:
    210 iterations for 32), so chunk = clamp(g // 4, 1, MAX_CHUNK) keeps
    the expected overrun, (chunk - 1) / 2 iterations, to a few percent of
    the iterations, and a pool of one or a few generations (the dragon,
    `final`) tests after every iteration (PERF.md, the pool's loop)."""
    generations = -(-total // pool_size)
    return max(1, min(MAX_CHUNK, generations // 4))


def trace_pool(cs, meta, settings, intersect, nx: int, ny: int, spp: int,
               base_key, pool_size: int, spectral: bool = False,
               bg_spd_id: int = 0, sample_offset: int = 0,
               graphs: Optional[dict] = None, stats: Optional[dict] = None):
    """Render nx×ny@spp, samples [sample_offset, sample_offset + spp), with
    a queue pool of `pool_size` slots (`_trace_pool_queue`).

    Returns (acc (nx·ny, 3) f32 summed radiance — RGB, or CIE XYZ in
    spectral mode; divide by spp for the image —, rays traced as a 0-dim
    int64 tensor, pool iterations: those that began with a live slot).
    Each iteration calls `intersect` once for the bounce, and once more for
    the exit re-trace in a scene with an absorbing dielectric.

    The iterations run through `core.loops.chunked_while`, the end tested
    every `pool_chunk` iterations. On the card one iteration is captured as
    a CUDA graph and replayed (`core.loops.Graphed`); `graphs`, a dict the
    caller keeps (`RenderContext.graphs`), holds that one graph for the
    next render of the same pool size, frame, scene, intersector and
    settings, whose base key, sample offset and sample count go in as
    device scalars; a render with another key replaces it. `stats`, if
    given, receives the loop's chunk, trips (bodies run: the iterations
    and the chunks' overrun), replays, capture seconds, and for a graph
    the launches of one body by counter (`per_body`) and the bytes its
    capture reserved (`graph_bytes`)."""
    if pool_size < 1:
        raise ValueError(f"pool_size must be positive, got {pool_size}")
    return _trace_pool(cs, meta, settings, intersect, nx, ny, spp, base_key,
                       pool_size, spectral, bg_spd_id, sample_offset,
                       pool_chunk(nx * ny * spp, pool_size),
                       cs.device.type == "cuda", graphs, stats)


def _pool(cs, meta, settings, intersect, nx: int, ny: int, spp: int,
          base_key, pool_size: int, spectral: bool, bg_spd_id: int,
          sample_offset: int):
    """(body, state) of the queue pool: the state after its first issue
    (a dict of tensors; the base key, the sample offset, the sample count,
    the next sample, the rays and the iterations on the device, so that a
    captured body reads each call's own) and the body that advances it one
    iteration."""
    dev = cs.device
    n_pix = nx * ny
    total = n_pix * spp
    n = pool_size
    gen = _make_rays(cs, nx, ny, spectral)

    def sample_to_ray(st, sample_ids, issued):
        """Rays of the global sample ids; a slot not issued draws sample 0
        of pixel 0, which the caller discards."""
        sid = torch.where(issued, sample_ids, torch.zeros_like(sample_ids))
        pix = sid % n_pix
        return (*gen(st["key"], pix, sid // n_pix + st["offset"]), pix)

    def scalar(v):
        return torch.full((), v, dtype=torch.int64, device=dev)

    ids = torch.arange(n, dtype=torch.int64, device=dev)
    st = dict(key=base_key.clone(), offset=scalar(sample_offset),
              total=scalar(total))
    issued = ids < total
    o, d, tme, keys, lam, lam_pdf, pix = sample_to_ray(st, ids, issued)
    rad = torch.zeros_like(tme) if spectral else torch.zeros_like(o)
    st.update(o=o, d=d, time=tme, keys=keys, pix=pix, lam=lam,
              lam_pdf=lam_pdf, depth=torch.zeros_like(ids),
              thru=torch.ones_like(rad), rad=rad, active=issued,
              next=scalar(min(n, total)),
              acc=torch.zeros((n_pix, 3), dtype=torch.float32, device=dev),
              nrays=scalar(0), iterations=scalar(0))

    def body(st):
        """One pool iteration; a fixpoint once no slot is live (nothing is
        deposited, counted or issued)."""
        iterations = st["iterations"] + st["active"].any()
        upd, died, contrib = _bounce_step(cs, meta, settings, intersect, st,
                                          spectral, bg_spd_id)
        acc = st["acc"]
        deposit(acc, st["pix"], torch.where(died[:, None], contrib,
                                            torch.zeros_like(contrib)))
        free = ~upd["active"]
        new_ids = st["next"] + torch.cumsum(free.long(), 0) - 1
        issue = free & (new_ids < st["total"])
        o_n, d_n, t_n, k_n, lam_n, pdf_n, pix_n = sample_to_ray(st, new_ids,
                                                                issue)
        sel = issue[:, None]
        sel_r = issue if spectral else sel
        return dict(
            key=st["key"], offset=st["offset"], total=st["total"],
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
            active=upd["active"] | issue,
            next=st["next"] + issue.sum(),
            acc=acc, nrays=st["nrays"] + upd["nrays"], iterations=iterations)

    return body, st


def _trace_pool(cs, meta, settings, intersect, nx: int, ny: int, spp: int,
                base_key, pool_size: int, spectral: bool, bg_spd_id: int,
                sample_offset: int, chunk: int, capture: bool,
                graphs: Optional[dict] = None, stats: Optional[dict] = None):
    """`trace_pool` with its loop's chunk and capture given. chunk=1 with
    capture=False is the plain version of the loop: the same body, the end
    tested after every iteration, no graph (the loop before CUDA graphs).
    A pool whose iteration syncs with the host (the all-reduces of
    `parallel.dist`'s sharded pools go through gloo) runs with
    capture=False, its chunks uncaptured."""
    body, st = _pool(cs, meta, settings, intersect, nx, ny, spp, base_key,
                     pool_size, spectral, bg_spd_id, sample_offset)
    if capture:
        key = (id(cs), id(meta), id(intersect), settings, nx, ny, pool_size,
               spectral, bg_spd_id)
        kept = graphs.get(key) if graphs is not None else None
        runner = kept[0] if kept else loops.Graphed()
        if graphs is not None and not kept:
            # One graph a dict: the one it replaces frees its memory. The
            # objects ride along so that their ids stay theirs.
            graphs.clear()
            graphs[key] = (runner, (cs, meta, intersect))
    else:
        runner = loops.Eager()
    before = (runner.trips, runner.replays, runner.capture_seconds)
    st = loops.chunked_while(lambda s: s["active"].any(), body, st, chunk,
                             runner)
    if stats is not None:
        stats.update(chunk=chunk, trips=runner.trips - before[0],
                     replays=runner.replays - before[1],
                     capture_seconds=runner.capture_seconds - before[2])
        if capture:
            stats.update(per_body=dict(runner.deltas),
                         graph_bytes=runner.capture_bytes)
    return st["acc"], st["nrays"], int(st["iterations"])
