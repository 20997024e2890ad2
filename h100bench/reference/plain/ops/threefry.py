"""Threefry-2x32 on int64 tensors, and the device cipher's wrapper.

Counterpart of `izpi_tpu/ops/threefry.py:26-101`. The port reproduces the
JAX package's streams bit for bit: that is what lets every port module be
compared with its JAX counterpart path for path.

PyTorch has no full uint32 arithmetic on the CPU (`add` is not implemented
for UInt32), so a 32-bit word rides in an int64 tensor with a value in
[0, 2**32) and is masked with 0xFFFFFFFF after every add and left shift.

`csrc/threefry.cuh` is the same cipher as CUDA device functions, inlined
into the megakernels. The cipher entry (`csrc/cipher.cu`) launches it on
its own for the draws outside the megakernels: `uniforms_for_keys` (a
bounce's, the media's) and `new_samples` (a new sample's path key, camera
and λ). On a CPU tensor each wrapper runs its plain version, the PyTorch
cipher of this file, which a run on the card holds the kernels against bit
for bit; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

MASK = 0xFFFFFFFF
MAX_UNIFORMS = 48  # the run-time form's largest count (csrc/cipher.cu)
_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA



def _rotl(x, r: int):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The 20-round Threefry-2x32 block cipher on int64-carried words.

    All four arguments broadcast together; returns (y0, y1)."""
    k0, k1, x0, x1 = torch.broadcast_tensors(k0, k1, x0, x1)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for r in range(20):
        x0 = (x0 + x1) & MASK
        x1 = _rotl(x1, _ROT[r % 8]) ^ x0
        if r % 4 == 3:
            j = r // 4 + 1  # key-schedule injection 1..5
            x0 = (x0 + ks[j % 3]) & MASK
            x1 = (x1 + ks[(j + 1) % 3] + j) & MASK
    return x0, x1


def fold_in(k0, k1, data):
    """jax.random.fold_in on raw (k0, k1) words: the cipher of the counter
    pair (0, data)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=k0.device) & MASK
    return threefry2x32(k0, k1, torch.zeros_like(data), data)


def bits_to_uniform(bits):
    """Word → float32 in [0, 1), exactly like jax.random.uniform: keep 23
    mantissa bits, OR in the exponent of 1.0, reinterpret, subtract 1. The
    value fits in int32, whose bits `.view` reinterprets."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniforms_n(k0, k1, n: int):
    """n U[0,1) variates per key, in the classic (non-partitionable)
    jax.random counter layout: the counters [0..n-1], zero-padded to even
    length, are split in half and the halves run through the cipher
    pairwise. For odd n the last word (the pad's) is dropped.
    Returns a list of n tensors shaped like k0."""
    half = (n + 1) // 2
    out = [None] * (2 * half)
    for i in range(half):
        c0 = torch.full_like(k0, i)
        c1 = torch.full_like(k0, i + half)
        y0, y1 = threefry2x32(k0, k1, c0, c1)
        out[i] = bits_to_uniform(y0)
        out[i + half] = bits_to_uniform(y1)
    return out[:n]


def uniforms_for_keys_reference(keys, depths, n: int, salt: int):
    """Plain version of `uniforms_for_keys`: fold the depth, fold the salt,
    draw n uniforms (`core.rng.bounce_uniforms_perray`). Returns (N, n)."""
    d0, d1 = fold_in(keys[:, 0], keys[:, 1], depths)
    f0, f1 = fold_in(d0, d1, torch.full_like(d0, salt))
    return torch.stack(uniforms_n(f0, f1, n), dim=-1)


def path_keys_reference(base_key, pixel_ids, sample_ids):
    """Plain version of the path keys: fold the sample index (an int or an
    (N,) tensor), then the flat pixel index (core/rng.py:40-51, 73-83).
    Returns (N, 2)."""
    k0, k1 = base_key[0], base_key[1]
    pixel_ids = pixel_ids.to(torch.int64)
    if isinstance(sample_ids, torch.Tensor) and sample_ids.ndim:
        s0, s1 = fold_in(k0.expand(sample_ids.shape), k1.expand(sample_ids.shape),
                         sample_ids.to(torch.int64))
    else:
        s0, s1 = fold_in(k0, k1, sample_ids)
        s0, s1 = s0.expand(pixel_ids.shape), s1.expand(pixel_ids.shape)
    p0, p1 = fold_in(s0, s1, pixel_ids)
    return torch.stack([p0, p1], dim=-1)


def new_samples_reference(base_key, pixel_ids, sample_ids,
                          camera_salt: Optional[int] = None,
                          lambda_salt: Optional[int] = None):
    """Plain version of `new_samples`: the path keys, then the camera's 5
    uniforms and λ's one at depth 0 under their salts
    (`uniforms_for_keys_reference`)."""
    keys = path_keys_reference(base_key, pixel_ids, sample_ids)
    zeros = torch.zeros(keys.shape[:1], dtype=torch.int64, device=keys.device)
    cam = (None if camera_salt is None else
           uniforms_for_keys_reference(keys, zeros, 5, camera_salt))
    lam = (None if lambda_salt is None else
           uniforms_for_keys_reference(keys, zeros, 1, lambda_salt)[:, 0])
    return keys, cam, lam


def new_samples(base_key, pixel_ids, sample_ids, camera_salt=None,
                lambda_salt=None):
    """The plain cipher on any device: `new_samples_reference`."""
    return new_samples_reference(base_key, pixel_ids, sample_ids,
                                 camera_salt, lambda_salt)


def uniforms_for_keys(keys, depths, n: int, salt: int):
    """The plain cipher on any device: `uniforms_for_keys_reference`."""
    return uniforms_for_keys_reference(keys, depths, n, salt)
