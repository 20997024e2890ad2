"""Host-side BVH4 construction.

Counterpart of `izpi_tpu/accel/bvh_build.py`. The tree is the reference's
build pipeline (internal/hitable/bvh4.go:517-792): a binary BVH (binned SAH,
or a median split on a seeded random axis) with leaves of at most
`leaf_size` primitives, collapsed two levels at a time into 4-wide nodes,
primitives reordered so every leaf is one contiguous run, and float32 bounds
rounded conservatively outward (nextafter, bvh4.go:494-514). The port builds
it with the native builder (`izpi_tpu_torch.accel.native`, the same C++ as
the JAX package's), and a failed native build raises. The output is the flat
SoA node layout the traversals consume:

  bounds: (Nn, 24) f32 — [minx×4, miny×4, minz×4, maxx×4, maxy×4, maxz×4]
          (the 96-byte SoA node of bvh4.go:23-39)
  child:  (Nn, 4) i32 — internal: child node index; leaf: first-primitive
          index into the REORDERED primitive arrays; empty: -1
  count:  (Nn, 4) i32 — 0: internal, >0: leaf primitive count, -1: empty

Conservative bounds never change hit results (only culling quality), so the
per-primitive AABB padding follows the reference loosely: triangles use the
relative epsilon of triangle.go:100-113; rects/spheres a small absolute pad.
`prim_bounds` reads the port's `Prims` (tensors on any device) through host
numpy.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np

from izpi_tpu_torch.accel import native
from izpi_tpu_torch.geometry import primitives as prim

LEAF_SIZE = 4

class BVH4Arrays(NamedTuple):
    bounds: np.ndarray      # (Nn, 24) f32
    child: np.ndarray       # (Nn, 4) i32
    count: np.ndarray       # (Nn, 4) i32
    prim_order: np.ndarray  # (P,) i32 — new_prims[i] = old_prims[prim_order[i]]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def prim_bounds(prims) -> Tuple[np.ndarray, np.ndarray]:
    """Per-primitive conservative AABBs from the compiled SoA (tensors or
    arrays), on host. Returns (bb_min (P,3), bb_max (P,3)) float64."""
    kind = _host(prims.kind)
    g0 = _host(prims.g0).astype(np.float64)
    g1 = _host(prims.g1).astype(np.float64)
    g2 = _host(prims.g2).astype(np.float64)

    p_count = kind.shape[0]
    bb_min = np.zeros((p_count, 3))
    bb_max = np.zeros((p_count, 3))

    tri = kind == prim.KIND_TRIANGLE
    if tri.any():
        v0 = g0[tri]
        v1 = v0 + g1[tri]
        v2 = v0 + g2[tri]
        mn = np.minimum(np.minimum(v0, v1), v2)
        mx = np.maximum(np.maximum(v0, v1), v2)
        # triangle.go:100-113: ε = max(maxDim·1e-4, 1e-6)
        max_dim = (mx - mn).max(axis=1, keepdims=True)
        eps = np.maximum(max_dim * 1e-4, 1e-6)
        bb_min[tri] = mn - eps
        bb_max[tri] = mx + eps

    rect = kind == prim.KIND_RECT
    if rect.any():
        p0 = g0[rect]
        corners = np.stack([p0, p0 + g1[rect], p0 + g2[rect],
                            p0 + g1[rect] + g2[rect]], axis=1)
        bb_min[rect] = corners.min(axis=1) - 1e-3
        bb_max[rect] = corners.max(axis=1) + 1e-3

    sph = kind == prim.KIND_SPHERE
    if sph.any():
        r = g2[sph][:, 0:1]
        c0, c1 = g0[sph], g1[sph]
        bb_min[sph] = np.minimum(c0, c1) - r
        bb_max[sph] = np.maximum(c0, c1) + r

    return bb_min, bb_max


def build_bvh4(prims, leaf_size: int = LEAF_SIZE,
               method: str = "sah") -> BVH4Arrays:
    """The native BVH4 over a compiled primitive SoA. method: "sah"
    (binned SAH, the port's tree) or "median" (the reference's median split
    on a random axis, drawn from an LCG seeded with 1)."""
    bb_min, bb_max = prim_bounds(prims)
    return BVH4Arrays(*native.build(bb_min, bb_max, leaf_size=leaf_size,
                                    method=method))


def max_stack_occupancy(bvh: BVH4Arrays) -> int:
    """Worst-case traversal stack occupancy (entries simultaneously live)
    for the pop-one / push-all-hit-internal-children traversal of
    accel.traverse. Visiting a child while r of its siblings are still
    stacked costs r + occupancy(child); the adversarial pop order visits
    the deepest child with the most siblings remaining, so
    g(n) = max(k, max_i ((k-1-i) + g_desc[i])) with g_desc the children's
    occupancies sorted descending and k the internal-child count. The
    result bounds what the device can ever need."""
    n_nodes = bvh.child.shape[0]
    g = np.zeros(n_nodes, np.int64)
    # Children always have larger node indices than their parent (the build
    # emits BFS order), so a reverse sweep is a valid post-order.
    for ni in range(n_nodes - 1, -1, -1):
        kids = [int(bvh.child[ni, s]) for s in range(4)
                if bvh.count[ni, s] == 0]
        if not kids:
            g[ni] = 1
            continue
        desc = sorted((int(g[c]) for c in kids), reverse=True)
        k = len(desc)
        g[ni] = max(k, max((k - 1 - i) + gi for i, gi in enumerate(desc)))
    return int(g[0]) if n_nodes else 0


def validate(bvh: BVH4Arrays, p_count: int,
             stack_depth: Optional[int] = None) -> list:
    """Structural integrity check mirroring BVH4.validate (bvh4.go:399-466):
    every primitive covered exactly once by the leaves, child indices sane,
    and (when stack_depth is given) the worst-case traversal stack fits —
    a pathological tree raises at build instead of silently losing hits."""
    errors = []
    covered = np.zeros(p_count, np.int32)
    n_nodes = bvh.child.shape[0]
    for ni in range(n_nodes):
        for s in range(4):
            cnt = bvh.count[ni, s]
            ch = bvh.child[ni, s]
            if cnt == -1:
                continue
            if cnt == 0:
                if not (ni < ch < n_nodes):
                    errors.append(f"node {ni} slot {s}: bad child {ch}")
            else:
                if ch < 0 or ch + cnt > p_count:
                    errors.append(f"node {ni} slot {s}: bad leaf run {ch}+{cnt}")
                else:
                    covered[ch: ch + cnt] += 1
    bad = np.nonzero(covered != 1)[0]
    if bad.size:
        errors.append(f"{bad.size} prims not covered exactly once")
    if stack_depth is not None and not errors:
        occ = max_stack_occupancy(bvh)
        if occ > stack_depth:
            errors.append(
                f"worst-case traversal stack {occ} exceeds device stack "
                f"depth {stack_depth}")
    return errors
