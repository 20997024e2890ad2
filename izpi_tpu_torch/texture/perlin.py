"""Classic gradient Perlin noise + turbulence, batched.

Counterpart of `izpi_tpu/texture/perlin.py:18-88` (reference:
internal/perlin/perlin.go): the permutation tables and random unit gradient
vectors built once per scene from a seeded numpy RandomState (the same draws
as the JAX package's, so the tables are equal bit for bit), trilinear
Hermite interpolation, and `turb` as the sum of 7 octaves of noise.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class PerlinTables(NamedTuple):
    ranvec: torch.Tensor  # (256, 3) f32 unit vectors
    perm_x: torch.Tensor  # (256,) int32
    perm_y: torch.Tensor  # (256,) int32
    perm_z: torch.Tensor  # (256,) int32


def build_tables(seed: int = 0, device="cpu") -> PerlinTables:
    """The tables of perlin.go perlinGenerate: components in [-1, 1)
    normalized, then three shuffled permutations of 0..255."""
    rng = np.random.RandomState(seed)
    v = 2.0 * rng.rand(256, 3) - 1.0
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    perms = []
    for _ in range(3):
        p = np.arange(256)
        rng.shuffle(p)
        perms.append(torch.tensor(p.astype(np.int32), device=device))
    return PerlinTables(
        ranvec=torch.tensor(v.astype(np.float32), device=device),
        perm_x=perms[0], perm_y=perms[1], perm_z=perms[2])


def noise(tables: PerlinTables, p):
    """Gradient noise at points p (..., 3) -> (...,) in [-1, 1]."""
    fl = torch.floor(p)
    f = p - fl
    u, v, w = f[..., 0], f[..., 1], f[..., 2]
    idx = fl.to(torch.int64)
    i, j, k = idx[..., 0], idx[..., 1], idx[..., 2]

    uu = u * u * (3.0 - 2.0 * u)
    vv = v * v * (3.0 - 2.0 * v)
    ww = w * w * (3.0 - 2.0 * w)

    acc = torch.zeros_like(u)
    for di in range(2):
        for dj in range(2):
            for dk in range(2):
                h = (tables.perm_x[(i + di) & 255] ^ tables.perm_y[(j + dj) & 255]
                     ^ tables.perm_z[(k + dk) & 255])
                g = tables.ranvec[h.long()]
                dot = (g[..., 0] * (u - di) + g[..., 1] * (v - dj)
                       + g[..., 2] * (w - dk))
                acc = acc + ((uu if di else 1.0 - uu) * (vv if dj else 1.0 - vv)
                             * (ww if dk else 1.0 - ww) * dot)
    return acc


def turb(tables: PerlinTables, p, depth: int = 7):
    """Turbulence: |Σ 0.5^i · noise(2^i p)|, the abs applied to the sum as
    in the reference (perlin.go:50-64)."""
    acc = torch.zeros_like(p[..., 0])
    weight = 1.0
    q = p
    for _ in range(depth):
        acc = acc + weight * noise(tables, q)
        weight *= 0.5
        q = q * 2.0
    return torch.abs(acc)
