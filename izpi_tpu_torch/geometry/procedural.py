"""Procedural stand-in meshes for scenes whose assets ship with neither the
reference nor this repo (the Stanford dragon OBJ of
internal/scenes/spectral.go:631, the PP.obj of scenes.go:268).

Counterpart of `izpi_tpu/geometry/procedural.py`, copied function for
function (numpy only), so both packages build the same vertices.

The stand-ins are deterministic closed surfaces with a triangle count the
caller picks — the dragon substitute defaults to the real dragon_tri.obj's
~871k faces so BVH-build and traversal benchmarks exercise the same scale.
"""

from __future__ import annotations

import numpy as np


def bumpy_blob(n_tris: int, seed: int = 7) -> np.ndarray:
    """A multi-frequency displaced sphere ("rock"/dragon-body stand-in).

    Returns (T, 3, 3) float64 triangle vertices on the unit scale
    (radius ≈ 1, centered at the origin). T is the largest 2·lat·lon ≤
    n_tris with lat≈lon.
    """
    lat = max(2, int(np.sqrt(n_tris / 2.0)))
    lon = max(3, n_tris // (2 * lat))
    rng = np.random.RandomState(seed)
    # Random spherical-harmonic-ish lobes: sum of k cos(a·θ + b)cos(c·φ + d).
    k = 6
    amp = rng.uniform(0.03, 0.12, k) / np.arange(1, k + 1) ** 0.5
    fth = rng.randint(1, 7, k)
    fph = rng.randint(1, 7, k)
    pth = rng.uniform(0, 2 * np.pi, k)
    pph = rng.uniform(0, 2 * np.pi, k)

    iv = np.arange(lat + 1, dtype=np.float64) / lat       # θ ∈ [0, π]
    jv = np.arange(lon + 1, dtype=np.float64) / lon       # φ ∈ [0, 2π)
    theta = iv * np.pi
    phi = jv * 2 * np.pi
    th, ph = np.meshgrid(theta, phi, indexing="ij")       # (lat+1, lon+1)

    r = np.ones_like(th)
    for i in range(k):
        r += amp[i] * np.cos(fth[i] * th + pth[i]) * np.cos(
            fph[i] * ph + pph[i])
    # Elongate: dragons are longer than tall.
    x = r * np.sin(th) * np.cos(ph) * 1.6
    y = r * np.cos(th) * 0.8
    z = r * np.sin(th) * np.sin(ph)
    grid = np.stack([x, y, z], axis=-1)                   # (lat+1, lon+1, 3)

    a = grid[:-1, :-1]
    b = grid[1:, :-1]
    c = grid[1:, 1:]
    d = grid[:-1, 1:]
    t1 = np.stack([a, b, c], axis=2).reshape(-1, 3, 3)
    t2 = np.stack([a, c, d], axis=2).reshape(-1, 3, 3)
    return np.concatenate([t1, t2], axis=0)


def transform_mesh(tris: np.ndarray, scale=1.0, rotate_y_deg: float = 0.0,
                   translate=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Scale → rotate about Y → translate, matching the reference OBJ
    pipeline order (spectral.go:644-647)."""
    v = np.asarray(tris, np.float64) * np.asarray(scale, np.float64)
    ang = np.deg2rad(rotate_y_deg)
    ca, sa = np.cos(ang), np.sin(ang)
    x = v[..., 0] * ca + v[..., 2] * sa
    z = -v[..., 0] * sa + v[..., 2] * ca
    v = np.stack([x, v[..., 1], z], axis=-1)
    return v + np.asarray(translate, np.float64)


def box_mesh(p0, p1) -> np.ndarray:
    """12 triangles forming an axis-aligned box (outward normals)."""
    x0, y0, z0 = p0
    x1, y1, z1 = p1
    corners = np.array([
        [x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
        [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1],
    ], np.float64)
    quads = [
        (4, 5, 6, 7),  # +z
        (1, 0, 3, 2),  # -z
        (5, 1, 2, 6),  # +x
        (0, 4, 7, 3),  # -x
        (7, 6, 2, 3),  # +y
        (0, 1, 5, 4),  # -y
    ]
    tris = []
    for (i, j, k, l) in quads:
        tris.append(corners[[i, j, k]])
        tris.append(corners[[i, k, l]])
    return np.stack(tris, axis=0)
