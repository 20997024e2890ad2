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

import ctypes
from typing import Optional

import torch

MASK = 0xFFFFFFFF
MAX_UNIFORMS = 48  # the run-time form's largest count (csrc/cipher.cu)
_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA

# Launches of the cipher entry's kernels (`izpi_threefry_uniforms`,
# `izpi_threefry_new_sample`) made by `uniforms_for_keys` and `new_samples`,
# and of them the new-sample form's.
launches = 0
sample_launches = 0


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


def _launch_checks(name, tensors, dev):
    for label, t, dtype, shape in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: {label} is on {t.device}, not {dev}")
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {label} must be {dtype} of shape "
                             f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def uniforms_for_keys(keys, depths, n: int, salt: int):
    """(N, n) uniforms for (N, 2) int64 keys and (N,) int64 depths.

    On a CUDA tensor this launches the device cipher (`izpi_threefry_uniforms`
    in csrc/cipher.cu: n of 1, 5 and 12, the λ, camera and bounce draws,
    unrolled, any other n up to 48, the media's, at run time), which reads
    the int64 words as they are; on a CPU tensor it runs
    `uniforms_for_keys_reference`."""
    if keys.device.type == "cpu":
        return uniforms_for_keys_reference(keys, depths, n, salt)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    if not 1 <= n <= MAX_UNIFORMS:
        raise ValueError(f"the device cipher draws 1 to {MAX_UNIFORMS} "
                         f"uniforms, not {n}")
    dev = keys.device
    keys, depths = keys.contiguous(), depths.contiguous()
    _launch_checks("uniforms_for_keys", (
        ("keys", keys, torch.int64, (keys.shape[0], 2)),
        ("depths", depths, torch.int64, keys.shape[:1])), dev)
    from izpi_tpu_torch.ops import _build

    lib = _build.load()
    out = torch.empty((keys.shape[0], n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.izpi_threefry_uniforms(
            _ptr(keys), _ptr(depths), keys.shape[0], n,
            ctypes.c_uint32(salt & MASK), _ptr(out), _stream(dev))
    if err != 0:
        raise RuntimeError(f"izpi_threefry_uniforms launch failed: CUDA error "
                           f"{err}")
    global launches
    launches += 1
    return out


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


def new_samples(base_key, pixel_ids, sample_ids,
                camera_salt: Optional[int] = None,
                lambda_salt: Optional[int] = None):
    """A new sample's draws for (pixel, sample) pairs: (keys (N, 2) int64,
    the camera's 5 uniforms (N, 5) f32 or None, λ's uniform (N,) f32 or
    None). base_key: the (2,) int64 render key; pixel_ids: (N,) int64;
    sample_ids: (N,) int64 or one int for every pair. λ needs the camera.

    On a CUDA tensor this is one launch of the device cipher
    (`izpi_threefry_new_sample` in csrc/cipher.cu), which reads the base key
    from device memory, so it can sit in a captured CUDA graph; on a CPU
    tensor it runs `new_samples_reference`."""
    if lambda_salt is not None and camera_salt is None:
        raise ValueError("λ's draw comes with the camera's")
    dev = pixel_ids.device
    if dev.type == "cpu":
        return new_samples_reference(base_key, pixel_ids, sample_ids,
                                     camera_salt, lambda_salt)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n = pixel_ids.shape[0]
    pixel_ids = pixel_ids.contiguous()
    per_ray = isinstance(sample_ids, torch.Tensor)
    checks = [("base_key", base_key, torch.int64, (2,)),
              ("pixel_ids", pixel_ids, torch.int64, (n,))]
    if per_ray:
        sample_ids = sample_ids.contiguous()
        checks.append(("sample_ids", sample_ids, torch.int64, (n,)))
    _launch_checks("new_samples", checks, dev)
    if not base_key.is_contiguous():
        raise ValueError("new_samples: base_key must be contiguous")
    from izpi_tpu_torch.ops import _build

    lib = _build.load()
    keys = torch.empty((n, 2), dtype=torch.int64, device=dev)
    cam = (None if camera_salt is None else
           torch.empty((n, 5), dtype=torch.float32, device=dev))
    lam = (None if lambda_salt is None else
           torch.empty((n,), dtype=torch.float32, device=dev))
    with torch.cuda.device(dev):
        err = lib.izpi_threefry_new_sample(
            _ptr(base_key), _ptr(pixel_ids),
            _ptr(sample_ids if per_ray else None),
            ctypes.c_uint32(0 if per_ray else int(sample_ids) & MASK), n,
            ctypes.c_uint32((camera_salt or 0) & MASK),
            ctypes.c_uint32((lambda_salt or 0) & MASK), _ptr(keys), _ptr(cam),
            _ptr(lam), _stream(dev))
    if err != 0:
        raise RuntimeError(f"izpi_threefry_new_sample launch failed: CUDA "
                           f"error {err}")
    global launches, sample_launches
    launches += 1
    sample_launches += 1
    return keys, cam, lam
