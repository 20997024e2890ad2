"""BVH4 traversal in PyTorch: the plain version of the CUDA traversal kernel.

Counterpart of `izpi_tpu/accel/traverse.py`: `reorder_prims`,
`slab_test_4` and `intersect_bvh`; its `attach` is `ops.bvh_kernel.attach`,
whose intersector runs `closest_bvh` on the CPU. The reference traverses with a
per-ray stack and a 4-wide slab test (bvh4.go:49-163, RayAABB4_SIMD); here
every ray of the batch that still has a stack pops one node per step, its
four children are slab-tested at once, the leaves among them are tested
against the ray's shrinking best t (bvh4.go:130), and the internal
children it hits are pushed near-first. Rays whose stacks are empty drop out
of the step, so a step costs what its live rays need.

`closest_bvh` follows `csrc/bvh4_traverse.cu` operation for operation and
node for node, so the two return the same (t, index) and the same per-ray
visit counts:
- a zero direction component divides as 1e-30, the TPU kernel's rule
  (`izpi_tpu/ops/bvh_kernel.py:168`); a raw 1/d would give 0·inf = NaN for
  a ray running along a box face;
- min and max are `torch.fmin`/`fmax`, the C `fminf`/`fmaxf`;
- internal children are ordered by their entry distance with the 4-input
  sorting network of `bvh_kernel.py:395-408`, farthest pushed first;
- leaf primitives are tested in slot order, the earlier primitive keeping
  an exact tie (a strict `<`).
Any leaf size is taken, not only 4. `from_jax_bvh` carries a JAX
`BVH4Arrays` over, so the two packages can traverse one tree.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from izpi_tpu_torch.accel import bvh_build
from izpi_tpu_torch.geometry import primitives as prim

STACK_DEPTH = 64  # bvh4.go:58; the kernel's per-thread stack
INV_EPS = 1e-30   # stand-in for a zero direction component (bvh_kernel.py:168)
# The near-first sorting network over the 4 child slots (bvh_kernel.py:407).
SORT_NETWORK = ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2))


class BVH4Device(NamedTuple):
    bounds: torch.Tensor  # (Nn, 24) f32
    child: torch.Tensor   # (Nn, 4) i32
    count: torch.Tensor   # (Nn, 4) i32


def upload(bvh: bvh_build.BVH4Arrays, device) -> BVH4Device:
    return BVH4Device(
        bounds=torch.as_tensor(np.asarray(bvh.bounds, np.float32), device=device),
        child=torch.as_tensor(np.asarray(bvh.child, np.int32), device=device),
        count=torch.as_tensor(np.asarray(bvh.count, np.int32), device=device))


def from_jax_bvh(arrays, device="cpu") -> BVH4Device:
    """A JAX `izpi_tpu.accel.bvh_build.BVH4Arrays` (or its fields as numpy)
    as the port's device tree; the layouts are the same."""
    return upload(bvh_build.BVH4Arrays(*(np.asarray(a) for a in arrays)),
                  device)


def reorder_prims(prims: prim.Prims, order) -> prim.Prims:
    """Apply the BVH's primitive reordering so leaves are contiguous runs
    (bvh4.go:586-590)."""
    idx = torch.as_tensor(np.asarray(order), dtype=torch.int64,
                          device=prims.kind.device)
    return prim.Prims(*[f[idx] for f in prims])


def inv_dir(d):
    """1/d per component, a zero component read as INV_EPS."""
    return 1.0 / torch.where(d == 0.0, torch.full_like(d, INV_EPS), d)


def slab_test_4(bounds_row, o, inv_d, t_min, t_max):
    """N rays × their 4 child AABBs (the RayAABB4 kernel of
    bvh4_simd_*.go). bounds_row: (N, 24); o, inv_d: (N, 3); t_min a scalar;
    t_max (N,). Returns (hit (N, 4) bool, entry distance tn (N, 4)): the
    axes in order x, y, z, tn = fmax(tn, fmin(t0, t1)) from t_min and
    tf = fmin(tf, fmax(t0, t1)) from t_max, hit = tf > tn."""
    lo = bounds_row[:, 0:12].reshape(-1, 3, 4)
    hi = bounds_row[:, 12:24].reshape(-1, 3, 4)
    t0 = (lo - o[:, :, None]) * inv_d[:, :, None]
    t1 = (hi - o[:, :, None]) * inv_d[:, :, None]
    tn = torch.full_like(t0[:, 0], t_min)
    tf = t_max[:, None].expand_as(tn)
    for ax in range(3):
        tn = torch.fmax(tn, torch.fmin(t0[:, ax], t1[:, ax]))
        tf = torch.fmin(tf, torch.fmax(t0[:, ax], t1[:, ax]))
    return tf > tn, tn


def closest_bvh(prims: prim.Prims, bvh: BVH4Device, o, d, time, t_min,
                t_max, counts: bool = False):
    """Closest hit of N rays through the BVH4 over `prims` (reordered by
    its build), in [t_min, min(t_max, T_MAX)]. Returns (t (N,) — t_max
    clamped on a miss —, prim index (N,) int64, -1 on a miss) and, with
    counts=True, the per-ray (nodes popped, primitives tested) (N, 2)
    int64."""
    n, dev = o.shape[0], o.device
    inv = inv_dir(d)
    t_best = torch.full((n,), min(float(t_max), prim.T_MAX), dtype=o.dtype,
                        device=dev)
    idx_best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int64, device=dev)
    sp = torch.ones(n, dtype=torch.int64, device=dev)  # the root, node 0
    visits = torch.zeros((n, 2), dtype=torch.int64, device=dev)
    leaf_k = torch.arange(max(int(bvh.count.max()), 1), device=dev)
    while True:
        rows = torch.nonzero(sp > 0).squeeze(1)
        if rows.numel() == 0:
            break
        sp_r = sp[rows] - 1
        node = stack[rows, sp_r].long()
        hit, tn = slab_test_4(bvh.bounds[node], o[rows], inv[rows], t_min,
                              t_best[rows])
        child = bvh.child[node].long()
        cnt = bvh.count[node].long()
        hit = hit & (cnt != -1)
        visits[rows, 0] += 1

        # Leaves, in slot order, against the best t at the pop.
        valid = (hit & (cnt > 0))[:, :, None] & (leaf_k < cnt[:, :, None])
        valid = valid.reshape(rows.numel(), -1)
        lrow = torch.nonzero(valid.any(dim=1)).squeeze(1)
        if lrow.numel():
            r = rows[lrow]
            ok_k = valid[lrow]
            pidx = torch.where(ok_k, (child[lrow, :, None] + leaf_k)
                               .reshape(lrow.numel(), -1), 0)
            tb = t_best[r]
            t, ok = prim.prim_t(
                prims.kind[pidx], prims.g0[pidx], prims.g1[pidx],
                prims.g2[pidx], prims.g3[pidx], o[r][:, None, :],
                d[r][:, None, :], time[r][:, None], t_min, tb[:, None])
            cand = torch.where(ok_k & ok & (t < tb[:, None]), t,
                               torch.full_like(t, float("inf")))
            t_c, arg = torch.min(cand, dim=1)  # the first minimum
            better = t_c < tb
            t_best[r] = torch.where(better, t_c, tb)
            idx_best[r] = torch.where(
                better, pidx.gather(1, arg[:, None])[:, 0], idx_best[r])
            visits[r, 1] += ok_k.sum(dim=1)

        # Internal children: farthest pushed first, nearest on top.
        key = [tn[:, s] for s in range(4)]
        ch = [child[:, s] for s in range(4)]
        push = [hit[:, s] & (cnt[:, s] == 0) for s in range(4)]
        for a, b in SORT_NETWORK:
            swap = key[a] < key[b]
            key[a], key[b] = (torch.where(swap, key[b], key[a]),
                              torch.where(swap, key[a], key[b]))
            ch[a], ch[b] = (torch.where(swap, ch[b], ch[a]),
                            torch.where(swap, ch[a], ch[b]))
            push[a], push[b] = (torch.where(swap, push[b], push[a]),
                                torch.where(swap, push[a], push[b]))
        for s in range(4):
            m = torch.nonzero(push[s]).squeeze(1)
            stack[rows[m], sp_r[m]] = ch[s][m]
            sp_r = sp_r + push[s].long()
        sp[rows] = sp_r
    if counts:
        return t_best, idx_best, visits
    return t_best, idx_best


def intersect_bvh(prims: prim.Prims, bvh: BVH4Device, o, d, time, t_min,
                  t_max) -> prim.Hit:
    """Closest hit with its shading record. o, d: (N, 3); time: (N,)."""
    t, idx = closest_bvh(prims, bvh, o, d, time, t_min, t_max)
    return prim.finalize_hit(prims, o, d, time, t, idx, idx >= 0)


def check(arrays: bvh_build.BVH4Arrays, p_count: int) -> None:
    """Raise unless the tree covers each of the p_count primitives once and
    its worst-case stack fits STACK_DEPTH (the reference's construction-time
    self-check, bvh4.go:535-545)."""
    errors = bvh_build.validate(arrays, p_count, stack_depth=STACK_DEPTH)
    if errors:
        raise ValueError(f"BVH4 validation failed: {errors[:5]}")


def build(prims: prim.Prims) -> bvh_build.BVH4Arrays:
    """The port's tree over `prims`: the native binned-SAH build at
    `bvh_build.LEAF_SIZE` (4), checked by `check`."""
    arrays = bvh_build.build_bvh4(prims)
    check(arrays, prims.count)
    return arrays
