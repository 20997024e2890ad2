"""The hand-written CUDA kernels' wrappers and their plain versions.

Each wrapper module keeps a plain integer `launches`, which its wrapper
adds one to where it launches its kernel (`threefry` also counts its
new-sample form's share apart, in `sample_launches`). `LAUNCH_COUNTED`
names those counters; `launch_counts` and `add_launch_counts` read and
advance them together (a CUDA graph replay launches what its capture
recorded: `core.loops.Graphed`).
"""

from __future__ import annotations

import importlib

LAUNCH_COUNTED = (("bvh_kernel", "launches"), ("bvh_rowkernel", "launches"),
                  ("megakernel", "launches"),
                  ("megakernel_spectral", "launches"),
                  ("threefry", "launches"), ("threefry", "sample_launches"))


def _module(name: str):
    return importlib.import_module(f"{__name__}.{name}")


def launch_counts() -> dict:
    """{(module, counter): count} of every counter of LAUNCH_COUNTED."""
    return {(m, a): getattr(_module(m), a) for m, a in LAUNCH_COUNTED}


def add_launch_counts(delta: dict, times: int = 1) -> None:
    """Add times × delta[(module, counter)] to each counter."""
    for (m, a), n in delta.items():
        mod = _module(m)
        setattr(mod, a, getattr(mod, a) + times * n)
