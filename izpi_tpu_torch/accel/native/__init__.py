"""The native BVH4 builder (`bvh4.cc`), built with g++ at first use.

Counterpart of `izpi_tpu/accel/native/__init__.py`, over a verbatim copy of
its `bvh4.cc`. The library lands in `build/izpi_tpu_torch/` at the
repository root (git-ignored), named by a hash of the source and the flags,
as `ops/_build.py` names the CUDA library. A failed build or a failed call
raises: the port has no silent numpy fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "bvh4.cc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "izpi_tpu_torch"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libizpibvh_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile bvh4.cc unless a library of this hash exists; returns its
    path. Raises when g++ fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *GXX_FLAGS, "-o", tmp, str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads a torn file
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    fn = lib.izpi_build_bvh4
    fn.restype = ctypes.c_int64
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
    ]
    return lib


def build(bb_min: np.ndarray, bb_max: np.ndarray, leaf_size: int = 4,
          method: str = "sah", seed: int = 1):
    """Native build over per-primitive bounds (P, 3) f64. Returns (bounds,
    child, count, prim_order) numpy arrays; raises on a failure. `seed`
    drives only the median build's random split axis."""
    if method not in ("median", "sah"):
        raise ValueError(f"unknown build method {method!r}")
    bb_min = np.ascontiguousarray(bb_min, np.float64)
    bb_max = np.ascontiguousarray(bb_max, np.float64)
    n = bb_min.shape[0]
    if bb_min.shape != (n, 3) or bb_max.shape != (n, 3):
        raise ValueError("bounds must be (P, 3) arrays of one shape")
    max_nodes = max(4, n)
    bounds = np.zeros((max_nodes, 24), np.float32)
    child = np.zeros((max_nodes, 4), np.int32)
    count = np.zeros((max_nodes, 4), np.int32)
    order = np.zeros(n, np.int32)
    n_nodes = load().izpi_build_bvh4(
        bb_min.ctypes.data, bb_max.ctypes.data, n, seed,
        bounds.ctypes.data, child.ctypes.data, count.ctypes.data,
        order.ctypes.data, max_nodes, leaf_size, 1 if method == "sah" else 0)
    if n_nodes < 0:
        raise RuntimeError(f"native BVH4 build failed for {n} primitives at "
                           f"leaf size {leaf_size}")
    return (bounds[:n_nodes].copy(), child[:n_nodes].copy(),
            count[:n_nodes].copy(), order)
