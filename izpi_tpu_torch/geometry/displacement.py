"""Displacement mapping: adaptive tessellation + vertex displacement.

A copy of `izpi_tpu/geometry/displacement.py` on the port's scene types
(numpy only), so the pbtxt loader tessellates displaced meshes as the JAX
package does.

Parity with internal/displacement/displacement.go, vectorized over the whole
triangle queue per pass instead of per-triangle recursion:

- 1→4 midpoint split (displacement.go:36-99); every input triangle is split
  at least once (the loop tessellates before testing, :198-216),
- stop when all UV edge deltas ≤ 4 texels AND the blue-channel displacement
  variation × |max-min| ≤ threshold 2.0 (:105-141, 174-183),
- displace vertices along the face normal by min + (max-min)·map.z — the
  reference routes this through a TBN multiply of (0,0,z), which reduces to
  z·normal (:219-275),
- displacement map sampled nearest-neighbor with the ImageTxt index math
  (texture/image.go:73-101), blue channel.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

TESSELLATION_FACTOR = 4.0
ADAPTIVE_THRESHOLD = 2.0
MAX_PASSES = 12  # safety valve; the reference loops until convergence


def _sample_map(dmap: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Blue channel, nearest-neighbor, V-flipped (image.go:73-101)."""
    h, w = dmap.shape[:2]
    i = np.clip((u * w).astype(np.int64), 0, w - 1)
    j = np.clip(((1.0 - v) * (h - 0.001)).astype(np.int64), 0, h - 1)
    if dmap.ndim == 3:
        return dmap[j, i, 2]
    return dmap[j, i]


def _tessellate(v: np.ndarray, uv: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Split (T,3,3)/(T,3,2) into 4T children, reference ordering
    (displacement.go:36-99)."""
    v0, v1, v2 = v[:, 0], v[:, 1], v[:, 2]
    a = (v0 + v1) / 2.0
    b = (v1 + v2) / 2.0
    c = (v2 + v0) / 2.0
    t0, t1, t2 = uv[:, 0], uv[:, 1], uv[:, 2]
    ta = (t0 + t1) / 2.0
    tb = (t1 + t2) / 2.0
    tc = (t2 + t0) / 2.0

    out_v = np.concatenate([
        np.stack([v0, a, c], axis=1),
        np.stack([a, b, c], axis=1),
        np.stack([a, v1, b], axis=1),
        np.stack([c, b, v2], axis=1),
    ])
    out_uv = np.concatenate([
        np.stack([t0, ta, tc], axis=1),
        np.stack([ta, tb, tc], axis=1),
        np.stack([ta, t1, tb], axis=1),
        np.stack([tc, tb, t2], axis=1),
    ])
    return out_v, out_uv


def _done_mask(uv: np.ndarray, dmap: np.ndarray, max_du: float,
               max_dv: float, dmin: float, dmax: float,
               threshold: float) -> np.ndarray:
    du = np.abs(uv[:, [1, 2, 0], 0] - uv[:, [0, 1, 2], 0])
    dv = np.abs(uv[:, [1, 2, 0], 1] - uv[:, [0, 1, 2], 1])
    uv_ok = (du <= max_du).all(axis=1) & (dv <= max_dv).all(axis=1)

    d = _sample_map(dmap, uv[:, :, 0].ravel(), uv[:, :, 1].ravel())
    d = d.reshape(-1, 3)
    variation = d.max(axis=1) - d.min(axis=1)
    adaptive_ok = variation * abs(dmax - dmin) <= threshold
    return uv_ok & adaptive_ok


def apply_displacement_map(vertices: np.ndarray, uvs: np.ndarray,
                           dmap: np.ndarray, dmin: float, dmax: float
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Tessellate-and-displace. vertices (T,3,3), uvs (T,3,2), dmap (H,W,3)
    float. Returns (new_vertices, new_uvs)."""
    res_v, res_u = dmap.shape[0], dmap.shape[1]
    max_du = TESSELLATION_FACTOR / max(res_u - 1, 1)
    max_dv = TESSELLATION_FACTOR / max(res_v - 1, 1)

    pending_v, pending_uv = np.asarray(vertices, np.float64), \
        np.asarray(uvs, np.float64)
    done_v = []
    done_uv = []
    for _ in range(MAX_PASSES):
        if pending_v.shape[0] == 0:
            break
        pending_v, pending_uv = _tessellate(pending_v, pending_uv)
        done = _done_mask(pending_uv, dmap, max_du, max_dv, dmin, dmax,
                          ADAPTIVE_THRESHOLD)
        done_v.append(pending_v[done])
        done_uv.append(pending_uv[done])
        pending_v = pending_v[~done]
        pending_uv = pending_uv[~done]
    if pending_v.shape[0]:
        done_v.append(pending_v)
        done_uv.append(pending_uv)

    v = np.concatenate(done_v)
    uv = np.concatenate(done_uv)

    # Displace along the face normal (displacement.go:219-275).
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    n = np.cross(e1, e2)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.where(norm == 0.0, 1.0, norm)

    out = v.copy()
    for k in range(3):
        z = _sample_map(dmap, uv[:, k, 0], uv[:, k, 1])
        offset = (dmin + (dmax - dmin) * z)[:, None] * n
        out[:, k] = v[:, k] + offset
    return out, uv


def displace_mesh(mesh, dmap: np.ndarray, dmin: float, dmax: float):
    """Apply to a scene TriangleMesh, returning a new TriangleMesh (vertex
    normals are dropped — the reference emits plain UV triangles,
    displacement.go:270-272)."""
    from izpi_tpu_torch.scene import types as st

    uvs = mesh.uvs if mesh.uvs is not None else np.zeros(
        (mesh.vertices.shape[0], 3, 2))
    v, uv = apply_displacement_map(mesh.vertices, uvs, dmap, dmin, dmax)
    return st.TriangleMesh(vertices=v, material=mesh.material, uvs=uv)
