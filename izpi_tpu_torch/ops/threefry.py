"""Threefry-2x32 on int64 tensors, and the device cipher's wrapper.

Counterpart of `izpi_tpu/ops/threefry.py:26-101`. The port reproduces the
JAX package's streams bit for bit: that is what lets every port module be
compared with its JAX counterpart path for path.

PyTorch has no full uint32 arithmetic on the CPU (`add` is not implemented
for UInt32), so a 32-bit word rides in an int64 tensor with a value in
[0, 2**32) and is masked with 0xFFFFFFFF after every add and left shift.

`csrc/threefry.cuh` is the same cipher as CUDA device functions, inlined
into the megakernel. `uniforms_for_keys` launches it on its own (the
`izpi_threefry_uniforms` entry) so a run on the card can hold the device
cipher against this file bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

MASK = 0xFFFFFFFF
_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA

# Launches of the `izpi_threefry_uniforms` kernel made by `uniforms_for_keys`.
launches = 0


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


def _as_int32_words(words):
    """int64 words in [0, 2**32) → int32 tensor with the same 32 bits."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def uniforms_for_keys(keys, depths, n: int, salt: int):
    """(N, n) uniforms for (N, 2) int64 keys and (N,) depths.

    On a CUDA tensor this launches the device cipher (`izpi_threefry_uniforms`
    in csrc/megakernel_rgb.cu: n of 1, 5 and 12, the λ, camera and bounce
    draws, unrolled, any other n ≥ 1, the media's, at run time); on a CPU
    tensor it runs `uniforms_for_keys_reference`."""
    if keys.device.type == "cpu":
        return uniforms_for_keys_reference(keys, depths, n, salt)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    if n < 1:
        raise ValueError(f"the device cipher draws at least 1 uniform, not {n}")
    if keys.ndim != 2 or keys.shape[1] != 2 or depths.shape != keys.shape[:1]:
        raise ValueError("keys must be (N, 2) and depths (N,)")
    from izpi_tpu_torch.ops import _build

    lib = _build.load()
    k32 = _as_int32_words(keys).contiguous()
    d32 = _as_int32_words(depths.to(torch.int64) & MASK).contiguous()
    out = torch.empty((keys.shape[0], n), dtype=torch.float32,
                      device=keys.device)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = lib.izpi_threefry_uniforms(
            ctypes.c_void_p(k32.data_ptr()), ctypes.c_void_p(d32.data_ptr()),
            keys.shape[0], n, ctypes.c_uint32(salt & MASK),
            ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"izpi_threefry_uniforms launch failed: CUDA error "
                           f"{err}")
    global launches
    launches += 1
    return out
