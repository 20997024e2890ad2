"""Batched 3-vector math over (..., 3) tensors.

Counterpart of `izpi_tpu/core/vecmath.py` (reference: internal/vec3/vec3.go).
Dot products are written out as `(x·x' + y·y') + z·z'`, the order XLA's
three-element reduction takes, so both packages round alike.
"""

from __future__ import annotations

import functools

import torch

EPS = 1e-12


@functools.lru_cache(maxsize=None)
def _const(values, device, dtype):
    return torch.tensor(values, dtype=dtype, device=device)


def const(values, like):
    """A tensor of the constants `values` (a tuple) on `like`'s device and
    dtype, made once and then shared: a host-to-device copy in a pool
    iteration would sync with the host and could not sit in a CUDA graph.
    Callers must not write to it."""
    return _const(tuple(values), like.device, like.dtype)


def dot(a, b):
    """Batched dot product. Reference: vec3.Dot (vec3.go:113)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    """Batched cross product. Reference: vec3.Cross (vec3.go:118)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def squared_length(v):
    return dot(v, v)


def length(v):
    return torch.sqrt(squared_length(v))


def normalize(v):
    """UnitVector: division by the length, no epsilon guard (vec3.go:131).
    NaNs are zeroed at the sample level by `de_nan`, as in the reference."""
    return v / length(v)[..., None]


def safe_normalize(v):
    return v / torch.clamp(length(v), min=EPS)[..., None]


def de_nan(v):
    """Replace NaN/±Inf components with 0. Reference: vec3.DeNAN (vec3.go:141)."""
    return torch.where(torch.isfinite(v), v, torch.zeros_like(v))


def reflect(v, n):
    """Mirror reflection. Reference: material.reflect (material/material.go:20)."""
    return v - (2.0 * dot(v, n))[..., None] * n


def refract(v, n, ni_over_nt):
    """Snell refraction with total-internal-reflection flag
    (material/material.go:25). Returns (refracted_dir, ok_mask);
    refracted_dir is garbage where ok is False."""
    uv = normalize(v)
    dt = dot(uv, n)
    discriminant = 1.0 - ni_over_nt * ni_over_nt * (1.0 - dt * dt)
    ok = discriminant > 0
    safe_disc = torch.clamp(discriminant, min=0.0)
    refracted = (ni_over_nt[..., None] * (uv - n * dt[..., None])
                 - n * torch.sqrt(safe_disc)[..., None])
    return refracted, ok


def schlick(cosine, ref_idx):
    """Schlick Fresnel approximation (material/material.go:39)."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * torch.pow(1.0 - cosine, 5.0)
