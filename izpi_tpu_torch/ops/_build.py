"""Build the CUDA sources in `csrc/` at first use and load them with ctypes.

One `nvcc` process per source, all started together, compiles each into an
object for sm_90a with a plain C interface (no PyTorch headers, so a build
takes seconds), with IEEE rounding kept (`-fmad=false`, no fast math) so
the kernels round like their plain PyTorch versions; one more links them
into a shared library. The library lands in `build/izpi_tpu_torch/` at the
repository root (git-ignored), named by a hash of the sources and flags, so
an edit rebuilds and an unchanged tree reuses the last build. A failed
build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "izpi_tpu_torch"
SOURCES = ("megakernel_rgb.cu", "megakernel_spectral.cu", "bvh4_traverse.cu",
           "bvh4_rowstack.cu")
HEADERS = ("threefry.cuh", "draws.cuh", "common.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
              "--ptxas-options=-v")

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int
_c_uint32 = ctypes.c_uint32
_c_float = ctypes.c_float
_SIGNATURES = {
    "izpi_megakernel_rgb": [
        _c_void_p, _c_void_p, _c_int,          # prim_f, prim_i, n_prims
        _c_void_p, _c_void_p,                  # mat_f, mat_i
        _c_void_p, _c_void_p, _c_int,          # light_f, light_i, n_lights
        _c_void_p,                             # cam (host floats)
        _c_uint32, _c_uint32, _c_uint32,       # seed0, seed1, offset
        _c_int, _c_int, _c_int, _c_int, _c_int,  # nx, ny, spp_slot, n_slots, max_depth
        _c_float, _c_float, _c_float, _c_int,  # background, book
        _c_int, _c_void_p, _c_void_p, _c_void_p,  # blocks, queue, acc, cnt
        _c_void_p, _c_void_p,                  # draws (or null), stream
    ],
    "izpi_megakernel_rgb_grid": [_c_void_p, _c_void_p],  # blocks, threads
    "izpi_megakernel_spectral": [
        _c_void_p, _c_void_p, _c_int,          # prim_f, prim_i, n_prims
        _c_void_p, _c_void_p,                  # mat_f, mat_i
        _c_void_p, _c_void_p, _c_int,          # light_f, light_i, n_lights
        _c_void_p, _c_void_p, _c_void_p,       # spec_f, spec_i, spd
        _c_void_p, _c_void_p,                  # cie, cam (host floats)
        _c_uint32, _c_uint32, _c_uint32,       # seed0, seed1, offset
        _c_int, _c_int, _c_int, _c_int, _c_int,  # nx, ny, spp_slot, n_slots, max_depth
        _c_int, _c_int,                        # bg_spd, book
        _c_int, _c_void_p, _c_void_p, _c_void_p,  # blocks, queue, acc, cnt
        _c_void_p, _c_void_p,                  # draws (or null), stream
    ],
    "izpi_megakernel_spectral_grid": [_c_void_p, _c_void_p],
    "izpi_threefry_uniforms": [
        _c_void_p, _c_void_p, _c_int, _c_int, _c_uint32, _c_void_p, _c_void_p,
    ],
    "izpi_bvh4_traverse": [
        _c_void_p, _c_void_p,                  # nodes, prims
        _c_void_p, _c_void_p, _c_void_p,       # o, d, time
        _c_int, _c_float, _c_float,            # n, t_min, t_max
        _c_void_p, _c_void_p, _c_void_p,       # t, idx, counts (or null)
        _c_void_p,                             # stream
    ],
    "izpi_bvh4_rowstack": [
        _c_void_p, _c_void_p,                  # nodes, blocks
        _c_void_p, _c_void_p, _c_void_p,       # o, d, time
        _c_int, _c_float, _c_float,            # n, t_min, t_max
        _c_void_p, _c_void_p, _c_void_p,       # t, idx, counters (or null)
        _c_void_p,                             # stream
    ],
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the port's "
                           "kernels are built with nvcc")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libizpi_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library of this hash exists; returns its
    path. The compilers' output (ptxas register and spill counts) is kept
    beside it as `<name>.log`."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{s}.o") for s in SOURCES]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", obj]
                for s, obj in zip(SOURCES, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        logs = [p.communicate()[0] for p in procs]
        failed = [(c, log) for c, p, log in zip(cmds, procs, logs)
                  if p.returncode != 0]
        so = str(Path(tmp) / "lib.so")
        if not failed:
            link_cmd = [nvcc, *ARCH, "-shared", "-o", so, *objs]
            link = subprocess.run(link_cmd, capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
            if link.returncode != 0:
                failed = [(link_cmd, logs[-1])]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{' '.join(c)}\n{log}" for c, log in failed))
        out.with_suffix(".log").write_text("".join(logs))
        os.replace(so, out)  # atomic: a concurrent build never loads a torn file
    return out


def ptxas_usage(log: str) -> dict:
    """{kernel: (registers, spill store bytes, spill load bytes)} of each
    megakernel's entry in a build log (ptxas -v output)."""
    usage, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            entry = next((k for k in ("megakernel_rgb", "megakernel_spectral")
                          if k in m.group(1)), None)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and entry:
            usage.setdefault(entry, [0, int(m.group(1)), int(m.group(2))])
        m = re.search(r"Used (\d+) registers", line)
        if m and entry in usage:
            usage[entry][0] = int(m.group(1))
            entry = None
    return {k: tuple(v) for k, v in usage.items()}


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The built library with its entry points' argument types set: every
    pointer and the stream as c_void_p, so ctypes does not cut them to 32
    bits."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
