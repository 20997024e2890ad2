"""Stateless RNG plumbing.

Counterpart of `izpi_tpu/core/rng.py:30-94`, without JAX. One base key per
render, folded with the sample index and then the flat pixel index to key
every (pixel, sample) path, then with the bounce depth and a per-use salt.
The cipher is `izpi_tpu_torch.ops.threefry`, bit-identical to the JAX
package's: the device cipher on a CUDA tensor, the PyTorch cipher on a CPU
tensor. Keys are (..., 2) int64 tensors holding uint32 words.
"""

from __future__ import annotations

import torch

from izpi_tpu_torch.ops import threefry as tf


def render_key(seed: int, device="cpu") -> torch.Tensor:
    """(2,) base key with the words of jax.random.PRNGKey(seed):
    (seed >> 32, seed & 0xFFFFFFFF), for a non-negative seed."""
    if seed < 0:
        raise ValueError("seed must be non-negative")
    return torch.tensor([(seed >> 32) & tf.MASK, seed & tf.MASK],
                        dtype=torch.int64, device=device)


def path_keys(base_key, pixel_ids, sample_id) -> torch.Tensor:
    """Per-path keys: fold the sample index, then the flat pixel index.
    pixel_ids: (N,); sample_id: one int. Returns (N, 2).

    On a CUDA tensor one launch of the device cipher (`ops.threefry.
    new_samples`), on a CPU tensor the PyTorch cipher."""
    return tf.new_samples(base_key, pixel_ids.to(torch.int64),
                          int(sample_id))[0]


def path_keys_perray(base_key, pixel_ids, sample_ids) -> torch.Tensor:
    """path_keys with per-ray sample indices (pool scheduling)."""
    return tf.new_samples(base_key, pixel_ids.to(torch.int64),
                          sample_ids.to(torch.int64))[0]


def bounce_uniforms_perray(keys, depths, n: int, salt: int = 0) -> torch.Tensor:
    """n U[0,1) per ray for per-ray depths: fold the depth, fold the salt,
    draw n words. keys: (N, 2); depths: (N,). Returns (N, n) float32.

    Dispatch by device (`ops.threefry.uniforms_for_keys`): on a CUDA tensor
    one launch of the device cipher, bit-identical to the PyTorch cipher
    that runs on a CPU tensor (the PyTorch cipher would take some 400 small
    launches per draw)."""
    return tf.uniforms_for_keys(keys, depths.to(torch.int64), n, salt)


def bounce_uniforms(keys, depth: int, n: int, salt: int = 0) -> torch.Tensor:
    """bounce_uniforms_perray with one depth for every ray."""
    depths = torch.full(keys.shape[:-1], int(depth), dtype=torch.int64,
                        device=keys.device)
    return bounce_uniforms_perray(keys, depths, n, salt=salt)
