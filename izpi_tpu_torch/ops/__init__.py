"""The hand-written CUDA kernels' wrappers and their plain versions.

Each wrapper module keeps a plain integer `launches`, which its wrapper
adds one to where it launches its kernel (`megakernel` counts its BVH
form's launches apart, in `bvh_launches`; `diff_trace` its two kernels', in
`fwd_launches` and `bwd_launches`). `KERNEL_COUNTERS` names each
kernel's counter; `threefry` also counts its new-sample form's share of
its launches in `sample_launches`, and `diff_trace` the sample passes its
forward launches carried in `fwd_passes` (passes a launch: `fwd_passes /
fwd_launches`). `LAUNCH_COUNTED` holds them all;
`launch_counts` and `add_launch_counts` read and advance them together (a
CUDA graph replay launches what its capture recorded: `core.loops.Graphed`).
"""

from __future__ import annotations

import importlib

# {kernel: (module, counter)}: one counter a kernel.
KERNEL_COUNTERS = {"bvh_kernel": ("bvh_kernel", "launches"),
                   "bvh_rowkernel": ("bvh_rowkernel", "launches"),
                   "megakernel": ("megakernel", "launches"),
                   "megakernel_bvh": ("megakernel", "bvh_launches"),
                   "megakernel_spectral": ("megakernel_spectral", "launches"),
                   "threefry": ("threefry", "launches"),
                   "table_grad": ("table_grad", "launches"),
                   "diff_trace_fwd": ("diff_trace", "fwd_launches"),
                   "diff_trace_bwd": ("diff_trace", "bwd_launches")}
LAUNCH_COUNTED = (*KERNEL_COUNTERS.values(), ("threefry", "sample_launches"),
                  ("diff_trace", "fwd_passes"))


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


def kernel_launches() -> dict:
    """{kernel: launches} of every counter of KERNEL_COUNTERS."""
    return {k: getattr(_module(m), a) for k, (m, a) in KERNEL_COUNTERS.items()}


def zero_launch_counts() -> None:
    """Set every counter of LAUNCH_COUNTED to 0."""
    for m, a in LAUNCH_COUNTED:
        setattr(_module(m), a, 0)
