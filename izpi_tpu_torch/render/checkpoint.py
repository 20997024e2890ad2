"""Render checkpoint and resume.

Counterpart of `izpi_tpu/render/checkpoint.py`. The reference has no
checkpointing (a crashed render restarts from zero). The whole state of a
render is its per-pixel accumulator and the count of completed samples, so
a checkpoint is one `.npz` a chunk; resume checks a fingerprint of the
configuration and continues at the next sample. The (pixel, sample) keying
of the sample streams makes the result equal to an uninterrupted render up
to the order of floating-point sums.

The file holds, and `load` checks:
- `acc`: (nx·ny, 3) float64, the sum of every completed sample's colour
  (RGB, or CIE XYZ for a spectral render), rows in the renderer's pixel
  order (y up). float64, the renderer's host accumulator: the float32 sum
  of each chunk is added in float64, so a render split into chunks, or
  resumed, sums as one pass does to float32 resolution;
- `samples_done`: int64, the samples per pixel in `acc`;
- `rays`: int64, the rays those samples traced;
- `fingerprint`: uint8 bytes of `config_fingerprint`'s 16 hex digits.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional, Tuple

import numpy as np


def config_fingerprint(nx: int, ny: int, spp: int, seed: int, meta,
                       settings, sampler: str = "colour") -> str:
    """16 hex digits naming a render's configuration: frame, samples, seed,
    the scene's counts and sampler, and the integrator settings."""
    payload = repr((nx, ny, spp, seed, meta.n_prims, meta.n_materials,
                    meta.n_lights, meta.spectral, sampler,
                    settings)).encode()
    return hashlib.sha256(payload).hexdigest()[:16]


def save(path: str, acc: np.ndarray, samples_done: int, rays: int,
         fingerprint: str) -> None:
    """Write the checkpoint atomically (a temporary file, then a rename)."""
    acc = np.asarray(acc)
    if acc.dtype != np.float64 or acc.ndim != 2 or acc.shape[1] != 3:
        raise ValueError(f"acc must be (n, 3) float64, got {acc.dtype} "
                         f"{acc.shape}")
    tmp = path + ".tmp.npz"
    np.savez(tmp, acc=acc, samples_done=np.int64(samples_done),
             rays=np.int64(rays),
             fingerprint=np.frombuffer(fingerprint.encode(), np.uint8))
    os.replace(tmp, path)


def load(path: str, fingerprint: str
         ) -> Optional[Tuple[np.ndarray, int, int]]:
    """(acc, samples_done, rays), or None when the file is absent or was
    written for another configuration. A file that is not in the format
    above raises."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        fp = z["fingerprint"].tobytes().decode()
        if fp != fingerprint:
            return None
        acc = z["acc"]
        if acc.dtype != np.float64:
            raise ValueError(f"{path}: acc is {acc.dtype}, not float64")
        return acc.copy(), int(z["samples_done"]), int(z["rays"])
