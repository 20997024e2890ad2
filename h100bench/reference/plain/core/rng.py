"""Stateless RNG plumbing.

Counterpart of the port's `core/rng.py`: each path's key is folded with
the bounce depth and a per-use salt, and the bounce's uniforms drawn from
it by the plain Threefry-2x32 of `ops.threefry` on any device. Keys are
(..., 2) int64 tensors holding uint32 words.
"""

from __future__ import annotations

import torch

from h100bench.reference.plain.ops import threefry as tf


def bounce_uniforms_perray(keys, depths, n: int, salt: int = 0) -> torch.Tensor:
    """n U[0,1) per ray for per-ray depths: fold the depth, fold the salt,
    draw n words. keys: (N, 2); depths: (N,). Returns (N, n) float32."""
    return tf.uniforms_for_keys(keys, depths.to(torch.int64), n, salt)
