"""The BVH4 traversal kernel: closest hits of a ray batch through a BVH4.

Counterpart of `izpi_tpu/ops/bvh_kernel.py`. Its Pallas kernel
(`_traverse_kernel`, :133, launched by `build_traverse_fn` :429-451) is
replaced by `csrc/bvh4_traverse.cu`, one thread per ray with its own stack,
on the port's tree (`accel.traverse.build`: native binned SAH at leaf 4).
The TPU kernel's union-traversal machinery is not carried over: ray
sorting, treelets, the re-bin and itinerary schedulers, two-pass and
multi-root starts exist because a TPU tile of 1024 rays shares one stack,
and a GPU thread does not.

This module holds:
- `pack_tables`, the node and primitive tables as `csrc/bvh4_traverse.cu`
  reads them (the counterpart of `pack_scene`, :81);
- `closest_hit`, the wrapper: rays on a CUDA device launch the kernel (or
  the call raises), rays on the CPU run the plain version,
  `accel.traverse.closest_bvh`;
- `BVHKernelIntersector` (:724), which hands the (t, index) pairs to
  `primitives.finalize_hit`;
- `attach` (:1211).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from izpi_tpu_torch.accel import traverse
from izpi_tpu_torch.geometry import primitives as prim

NODE_WORDS, PRIM_WORDS = 32, 16  # row widths csrc/bvh4_traverse.cu reads

# Launches of the CUDA traversal kernel made by `closest_hit`.
launches = 0


class KernelScene(NamedTuple):
    """A BVH4 over reordered primitives, plain and packed, on one device."""

    prims: prim.Prims           # the reordered primitives (plain version)
    tree: traverse.BVH4Device   # the node arrays (plain version)
    nodes: torch.Tensor         # (Nn, NODE_WORDS) i32: bounds bits | child | count
    prim_table: torch.Tensor    # (P, PRIM_WORDS) f32: g0 g1 g2 g3 | kind bits | pad


def pack_tables(prims: prim.Prims, tree: traverse.BVH4Device) -> KernelScene:
    """Pack the tree and its (reordered) primitives as the kernel reads
    them: one 128-byte row per node, one 64-byte row per primitive."""
    nodes = torch.cat([tree.bounds.view(torch.int32), tree.child, tree.count],
                      dim=1).contiguous()
    # Filled as 32-bit words, so every float keeps its bits.
    words = torch.zeros((prims.kind.shape[0], PRIM_WORDS), dtype=torch.int32,
                        device=prims.kind.device)
    words[:, 0:12] = torch.cat([prims.g0, prims.g1, prims.g2, prims.g3],
                               dim=1).view(torch.int32)
    words[:, 12] = prims.kind.to(torch.int32)
    return KernelScene(prims, tree, nodes, words.view(torch.float32))


def _check(name, t, shape, dtype, dev):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, the rays on {dev}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")


def closest_hit(ks: KernelScene, o, d, time, t_min: float, t_max: float,
                counts: bool = False):
    """(t (N,), prim index (N,) int64, -1 on a miss) of the closest hits of
    rays o, d (N, 3), time (N,) in [t_min, min(t_max, T_MAX)], indices into
    the reordered primitives; with counts=True also the per-ray (nodes
    popped, primitives tested) (N, 2) int64.

    On a CUDA device this launches `izpi_bvh4_traverse`; any failure to
    build or launch raises. On the CPU it runs `traverse.closest_bvh`."""
    dev = o.device
    if dev.type == "cpu":
        return traverse.closest_bvh(ks.prims, ks.tree, o, d, time, t_min,
                                    t_max, counts=counts)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n = o.shape[0]
    _check("o", o, (n, 3), torch.float32, dev)
    _check("d", d, (n, 3), torch.float32, dev)
    _check("time", time, (n,), torch.float32, dev)
    _check("nodes", ks.nodes, (ks.nodes.shape[0], NODE_WORDS), torch.int32, dev)
    _check("prim_table", ks.prim_table, (ks.prim_table.shape[0], PRIM_WORDS),
           torch.float32, dev)

    from izpi_tpu_torch.ops import _build

    lib = _build.load()
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    cnt = torch.empty((n, 2), dtype=torch.int32, device=dev) if counts else None
    ptr = lambda x: ctypes.c_void_p(None if x is None else x.data_ptr())  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.izpi_bvh4_traverse(
            ptr(ks.nodes), ptr(ks.prim_table), ptr(o), ptr(d), ptr(time), n,
            float(t_min), min(float(t_max), prim.T_MAX), ptr(t), ptr(idx),
            ptr(cnt), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"izpi_bvh4_traverse launch failed: CUDA error {err}")
    global launches
    launches += 1
    if counts:
        return t, idx.long(), cnt.long()
    return t, idx.long()


class BVHKernelIntersector:
    """Intersector over a reordered compiled scene: `closest_hit` for the
    (t, index) pairs, then `primitives.finalize_hit` for the record."""

    def __init__(self, cs, ks: KernelScene):
        self.cs = cs
        self.ks = ks

    def __call__(self, o, d, time, t_min, t_max) -> prim.Hit:
        t, idx = closest_hit(self.ks, o.contiguous(), d.contiguous(),
                             time.contiguous(), t_min, t_max)
        return prim.finalize_hit(self.cs.prims, o, d, time, t, idx, idx >= 0)


def attach(cs):
    """Build the port's BVH4 over a compiled scene (`traverse.build`, which
    raises on a tree too deep for the kernel's stack), reorder its
    primitives and pack the tables on the scene's device. Returns
    (cs_reordered, BVHKernelIntersector)."""
    arrays = traverse.build(cs.prims)
    cs2 = cs._replace(prims=traverse.reorder_prims(cs.prims,
                                                   arrays.prim_order))
    ks = pack_tables(cs2.prims, traverse.upload(arrays, cs.device))
    return cs2, BVHKernelIntersector(cs2, ks)
