"""The per-row-stack BVH4 traversal: closest hits of a ray batch, one warp
per row of 32 rays.

Counterpart of `izpi_tpu/ops/bvh_rowkernel.py`. Its Pallas kernel
(`_row_kernel`, :126, launched by `build_traverse_fn` :396-463) gives each
128-ray row of a TPU tile one exact stack and tests leaf blocks of 64
primitives. On the GPU a row is a warp: `csrc/bvh4_rowstack.cu` runs one
warp per 32 consecutive rays with a stack shared by the warp, visits a node
when any lane's slab test hits it, and tests a visited leaf block, copied
into shared memory, one primitive per lane against each ray whose own slab
test hit it. The rays go to the kernel in the order the caller gives them:
the JAX intersector sorts each batch by a coherence key first (`sort_keys`,
:466), and on the H100 the sort cost more than it saved (PERF.md: the
sorted warps do less work in all but their longest warps, which set the
launch's time, and the sort, gather and scatter back cost more than the
kernel).

This module holds:
- `pack_scene` (:74), the node and leaf-block tables of a leaf-64 BVH4 over
  reordered primitives;
- `closest_hit_rows`, the wrapper: rays on a CUDA device launch the kernel
  (or the call raises), rays on the CPU run the plain version,
  `closest_rows`, which walks the same union traversal in PyTorch;
- `RowBVHIntersector` (:482), the block-slot map and
  `primitives.finalize_hit`; `sort_keys`, the JAX intersector's coherence
  key, which the measurement scripts sort with;
- `attach` (:534) and `from_jax_rowscene`.

Not carried over: what exists only for the TPU — the all-zero resident
block and the leaf queue with its ring overflow (`QCAP`, :277), the DMA
cover of `NODE_STEPS`, ids packed into f32 node rows, and the per-ray
`tcap` that no caller passes.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from izpi_tpu_torch.accel import bvh_build, traverse
from izpi_tpu_torch.geometry import primitives as prim

LEAF_SIZE = 64   # primitives per leaf block (bvh_rowkernel.py:58)
KSTACK = 64      # the warp's stack depth, checked at attach (bvh_rowkernel.py:51)
WARP = 32        # rays per row
NODE_WORDS, BLOCK_WORDS = 32, 16  # row widths csrc/bvh4_rowstack.cu reads
# The visit order of a node's internal children: pushed slot 3 first, so
# slot 0 is popped next. The lanes' entry distances differ, so the row
# keeps one fixed order where the per-ray traversal sorts.
PUSH_ORDER = (3, 2, 1, 0)

# Launches of the CUDA row-stack kernel made by `closest_hit_rows`.
launches = 0


class RowScene(NamedTuple):
    """A leaf-64 BVH4 over reordered primitives, packed, on one device."""

    nodes: torch.Tensor     # (Nn, NODE_WORDS) i32: bounds bits | child | count;
                            #   a leaf's child is its block id
    blocks: torch.Tensor    # (Nb, LEAF_SIZE, BLOCK_WORDS) f32: g0 g1 g2 g3 |
                            #   kind | pad | block id (prim 0) | has a
                            #   non-triangle (prim 0); zeros past the count
    blockmap: torch.Tensor  # (Nb·LEAF_SIZE,) i32: block slot -> prim index, -1 pad


def pack_scene(prims: prim.Prims, bvh: bvh_build.BVH4Arrays,
               device) -> RowScene:
    """The tables of a BVH built over REORDERED primitives: each leaf's
    contiguous run becomes one block of LEAF_SIZE rows, and the leaf's child
    becomes its block id. Blocks are numbered as `bvh_rowkernel.py:89`
    numbers them, in (node, slot) order, and hold the JAX package's block
    rows value for value (its (Nb·8, 128) `pblocks` is this table
    reshaped)."""
    fields = np.concatenate(
        [bvh_build._host(f).astype(np.float32)
         for f in (prims.g0, prims.g1, prims.g2, prims.g3)]
        + [bvh_build._host(prims.kind).astype(np.float32)[:, None]], axis=1)
    child = np.array(bvh.child, np.int32)
    count = np.array(bvh.count, np.int32)
    leaf_nodes, leaf_slots = np.nonzero(count > 0)
    n_blocks = max(len(leaf_nodes), 1)
    starts = child[leaf_nodes, leaf_slots].astype(np.int64)
    cnts = count[leaf_nodes, leaf_slots]
    k = np.arange(LEAF_SIZE)
    valid = k[None, :] < cnts[:, None]
    pidx = np.where(valid, starts[:, None] + k[None, :], 0)

    rows = np.zeros((n_blocks, LEAF_SIZE, BLOCK_WORDS), np.float32)
    blockmap = np.full((n_blocks, LEAF_SIZE), -1, np.int32)
    if len(leaf_nodes):
        rows[:len(starts), :, :13] = np.where(valid[:, :, None],
                                              fields[pidx], 0.0)
        ids = np.arange(len(starts))
        rows[ids, 0, 14] = ids
        non_tri = valid & (fields[pidx, 12] != float(prim.KIND_TRIANGLE))
        rows[ids, 0, 15] = non_tri.any(axis=1)
        blockmap[:len(starts)] = np.where(valid, pidx, -1)
        child[leaf_nodes, leaf_slots] = ids
    nodes = np.concatenate([np.asarray(bvh.bounds, np.float32).view(np.int32),
                            child, count], axis=1)
    return RowScene(
        nodes=torch.as_tensor(nodes, device=device),
        blocks=torch.as_tensor(rows, device=device),
        blockmap=torch.as_tensor(blockmap.reshape(-1), device=device))


def from_jax_rowscene(rs, device="cpu") -> RowScene:
    """A JAX `izpi_tpu.ops.bvh_rowkernel.RowScene` (its `ntab`, `pblocks`
    and `blockmap` as numpy) as the port's tables: the node rows' f32 ids
    become int32, the block rows are the same numbers."""
    ntab = np.asarray(rs.ntab, np.float32)
    nodes = np.concatenate([ntab[:, :24].view(np.int32),
                            ntab[:, 24:32].astype(np.int32)], axis=1)
    blocks = np.asarray(rs.pblocks, np.float32).reshape(
        -1, LEAF_SIZE, BLOCK_WORDS)
    return RowScene(torch.as_tensor(nodes, device=device),
                    torch.as_tensor(blocks.copy(), device=device),
                    torch.as_tensor(np.array(rs.blockmap, np.int32),
                                    device=device))


def per_ray_tree(rs: RowScene) -> traverse.BVH4Device:
    """The same leaf-64 tree as the per-ray traversal reads it
    (`accel.traverse.closest_bvh`, one ray at a time, near child first):
    each leaf's child is its block's first primitive again. Over the
    reordered primitives of `attach`, its per-ray counts are the work each
    ray alone needs on this tree."""
    child, count = rs.nodes[:, 24:28], rs.nodes[:, 28:32]
    first = rs.blockmap[(torch.where(count > 0, child, 0) * LEAF_SIZE).long()]
    return traverse.BVH4Device(bounds=rs.nodes[:, :24].view(torch.float32),
                               child=torch.where(count > 0, first, child),
                               count=count)


def closest_rows(rs: RowScene, o, d, time, t_min: float, t_max: float):
    """The plain version of the kernel: the same union traversal in
    PyTorch. Rays form rows of WARP in batch order (the last padded with
    rays that never hit); each row has one stack. A step pops one node of
    every row with a non-empty stack, slab-tests its four children against
    each ray's best t at the pop, visits a child when any ray of the row
    without a NaN hits it, tests each visited leaf's block, in slot order,
    against the rays whose own slab test hit it (the first minimum t wins,
    as a strict `<` keeps the earlier slot on an exact tie), and pushes the
    visited internal children in PUSH_ORDER.

    Returns (t (N,), block slot (N,) int64, -1 on a miss, per-row counters
    (ceil(N/WARP), 3) int64: nodes popped, leaf blocks tested, (ray,
    primitive) pairs tested by the row)."""
    n, dev = o.shape[0], o.device
    rows_n = -(-n // WARP)
    pad = rows_n * WARP - n
    valid = torch.arange(rows_n * WARP, device=dev) < n
    o_p = torch.cat([o, o.new_zeros((pad, 3))]).reshape(rows_n, WARP, 3)
    d_p = torch.cat([d, d.new_ones((pad, 3))]).reshape(rows_n, WARP, 3)
    tm_p = torch.cat([time, time.new_zeros((pad,))]).reshape(rows_n, WARP)
    inv = traverse.inv_dir(d_p)
    live = ~(torch.isnan(o_p).any(dim=2) | torch.isnan(d_p).any(dim=2))
    t_best = torch.full((rows_n * WARP,), min(float(t_max), prim.T_MAX),
                        dtype=o.dtype, device=dev)
    t_best[~valid] = float(t_min)  # padding rays never hit
    t_best = t_best.reshape(rows_n, WARP)
    idx_best = torch.full((rows_n, WARP), -1, dtype=torch.int64, device=dev)

    bounds = rs.nodes[:, :24].view(torch.float32)
    child = rs.nodes[:, 24:28].long()
    count = rs.nodes[:, 28:32].long()
    stack = torch.zeros((rows_n, KSTACK), dtype=torch.int64, device=dev)
    sp = torch.ones(rows_n, dtype=torch.int64, device=dev)  # the root, node 0
    counters = torch.zeros((rows_n, 3), dtype=torch.int64, device=dev)
    slot_k = torch.arange(LEAF_SIZE, device=dev)
    while True:
        rows = torch.nonzero(sp > 0).squeeze(1)
        if rows.numel() == 0:
            break
        sp_r = sp[rows] - 1
        node = stack[rows, sp_r]
        counters[rows, 0] += 1
        lo = bounds[node, 0:12].reshape(-1, 1, 3, 4)
        hi = bounds[node, 12:24].reshape(-1, 1, 3, 4)
        t0 = (lo - o_p[rows][..., None]) * inv[rows][..., None]
        t1 = (hi - o_p[rows][..., None]) * inv[rows][..., None]
        tn = torch.full_like(t0[:, :, 0], float(t_min))
        tf = t_best[rows][..., None].expand_as(tn)
        for ax in range(3):
            tn = torch.fmax(tn, torch.fmin(t0[:, :, ax], t1[:, :, ax]))
            tf = torch.fmin(tf, torch.fmax(t0[:, :, ax], t1[:, :, ax]))
        ch, cn = child[node], count[node]
        lane_hit = ((tf > tn) & (cn[:, None, :] != -1)
                    & live[rows][..., None])  # (R, WARP, 4)
        visit = lane_hit.any(dim=1)           # (R, 4)

        for s in range(4):
            m = torch.nonzero(visit[:, s] & (cn[:, s] > 0)).squeeze(1)
            if m.numel() == 0:
                continue
            r, blk, cnt = rows[m], ch[m, s], cn[m, s]
            want = lane_hit[m, :, s]                          # (M, 32)
            counters[r, 1] += 1
            counters[r, 2] += want.sum(dim=1) * cnt
            g = rs.blocks[blk][:, None]                       # (M, 1, 64, 16)
            tb = t_best[r]                                    # (M, 32)
            t, ok = prim.prim_t(
                g[..., 12].long(), g[..., 0:3], g[..., 3:6], g[..., 6:9],
                g[..., 9:12], o_p[r][:, :, None, :], d_p[r][:, :, None, :],
                tm_p[r][:, :, None], t_min, tb[..., None])
            ok = (ok & want[..., None] & (slot_k < cnt[:, None])[:, None, :]
                  & (t < tb[..., None]))
            t_c, arg = torch.min(torch.where(ok, t, torch.full_like(
                t, float("inf"))), dim=2)                      # the first minimum
            better = t_c < tb
            t_best[r] = torch.where(better, t_c, tb)
            idx_best[r] = torch.where(better, blk[:, None] * LEAF_SIZE + arg,
                                      idx_best[r])

        for s in PUSH_ORDER:
            push = visit[:, s] & (cn[:, s] == 0)
            m = torch.nonzero(push).squeeze(1)
            stack[rows[m], sp_r[m]] = ch[m, s]
            sp_r = sp_r + push.long()
        sp[rows] = sp_r
    return (t_best.reshape(-1)[:n], idx_best.reshape(-1)[:n], counters)


def _check(name, t, shape, dtype, dev):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, the rays on {dev}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")


def closest_hit_rows(rs: RowScene, o, d, time, t_min: float, t_max: float,
                     counters: bool = False):
    """(t (N,), block slot (N,) int64, -1 on a miss) of the closest hits of
    rays o, d (N, 3), time (N,) in [t_min, min(t_max, T_MAX)]; with
    counters=True also the per-row (nodes popped, leaf blocks tested, (ray,
    primitive) pairs tested) (ceil(N/32), 3) int64.

    On a CUDA device this launches `izpi_bvh4_rowstack`; any failure to
    build or launch raises. On the CPU it runs `closest_rows`."""
    dev = o.device
    if dev.type == "cpu":
        t, idx, cnt = closest_rows(rs, o, d, time, t_min, t_max)
        return (t, idx, cnt) if counters else (t, idx)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n = o.shape[0]
    _check("o", o, (n, 3), torch.float32, dev)
    _check("d", d, (n, 3), torch.float32, dev)
    _check("time", time, (n,), torch.float32, dev)
    _check("nodes", rs.nodes, (rs.nodes.shape[0], NODE_WORDS), torch.int32, dev)
    _check("blocks", rs.blocks, (rs.blocks.shape[0], LEAF_SIZE, BLOCK_WORDS),
           torch.float32, dev)

    from izpi_tpu_torch.ops import _build

    lib = _build.load()
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    cnt = (torch.empty((-(-n // WARP), 3), dtype=torch.int32, device=dev)
           if counters else None)
    ptr = lambda x: ctypes.c_void_p(None if x is None else x.data_ptr())  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.izpi_bvh4_rowstack(
            ptr(rs.nodes), ptr(rs.blocks), ptr(o), ptr(d), ptr(time), n,
            float(t_min), min(float(t_max), prim.T_MAX), ptr(t), ptr(idx),
            ptr(cnt), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"izpi_bvh4_rowstack launch failed: CUDA error {err}")
    global launches
    launches += 1
    if counters:
        return t, idx.long(), cnt.long()
    return t, idx.long()


def _morton4(x, y, z):
    """Interleave 3×4-bit ints (0..15) into a 12-bit Morton code, bit b of
    an axis at 3b + axis (`izpi_tpu/ops/bvh_kernel.py:537`)."""
    def spread3(v):
        return (v & 1) | ((v & 2) << 2) | ((v & 4) << 4) | ((v & 8) << 6)
    return spread3(x) | (spread3(y) << 1) | (spread3(z) << 2)


def sort_keys(o, d, lo, hi):
    """The coherence key of `bvh_rowkernel.py:466`: a 12-bit Morton code of
    the origin's cell in the scene box (the subtree a row descends) above a
    12-bit Morton code of the unit direction (similar frusta)."""
    span = torch.clamp(hi - lo, min=1e-6)
    cell = torch.clamp(((o - lo[None, :]) / span[None, :] * 16.0)
                       .to(torch.int32), 0, 15)
    m_o = _morton4(cell[:, 0], cell[:, 1], cell[:, 2])
    norm = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])
    dn = d / torch.clamp(norm, min=1e-12)[:, None]
    dc = torch.clamp(((dn + 1.0) * 8.0).to(torch.int32), 0, 15)
    m_d = _morton4(dc[:, 0], dc[:, 1], dc[:, 2])
    return (m_o << 12) | m_d


class RowBVHIntersector:
    """Intersector over a reordered compiled scene through the row-stack
    traversal, rays in the caller's order; block slots map to primitives
    through `blockmap`, and `primitives.finalize_hit` builds the record.
    `lo` and `hi` are the scene's box, `sort_keys`' frame. A differentiable
    bounce gets the winner's gradient of t (`primitives.differentiable_t`)."""

    def __init__(self, cs, rs: RowScene, scene_lo, scene_hi):
        self.cs = cs
        self.rs = rs
        self.lo = torch.as_tensor(np.array(scene_lo, np.float32),
                                  device=cs.device)
        self.hi = torch.as_tensor(np.array(scene_hi, np.float32),
                                  device=cs.device)

    def __call__(self, o, d, time, t_min, t_max) -> prim.Hit:
        t, idx = closest_hit_rows(self.rs, o.detach().contiguous(),
                                  d.detach().contiguous(), time.contiguous(),
                                  t_min, t_max)
        idx = torch.where(idx >= 0,
                          self.rs.blockmap[torch.clamp(idx, min=0)].long(),
                          torch.full_like(idx, -1))
        hit = idx >= 0
        if prim.tracks(o, d):
            # As `bvh_kernel.BVHKernelIntersector`: the winner's gradient.
            t = prim.differentiable_t(self.cs.prims, o, d, time, t, idx, hit,
                                      t_min, t_max)
        return prim.finalize_hit(self.cs.prims, o, d, time, t, idx, hit)


def attach(cs):
    """Build a leaf-64 SAH BVH4 over a compiled scene (the native build),
    raise unless every primitive is covered once and the worst-case stack
    fits KSTACK, reorder the primitives and pack the tables on the scene's
    device. Returns (cs_reordered, RowBVHIntersector)."""
    arrays = bvh_build.build_bvh4(cs.prims, leaf_size=LEAF_SIZE)
    errors = bvh_build.validate(arrays, cs.prims.count, stack_depth=KSTACK)
    if errors:
        raise ValueError(f"BVH4 validation failed: {errors[:5]}")
    cs2 = cs._replace(prims=traverse.reorder_prims(cs.prims,
                                                   arrays.prim_order))
    rs = pack_scene(cs2.prims, arrays, cs.device)
    bb_min, bb_max = bvh_build.prim_bounds(cs2.prims)
    return cs2, RowBVHIntersector(cs2, rs, bb_min.min(axis=0),
                                  bb_max.max(axis=0))
