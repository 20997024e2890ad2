"""Timing on the card for the scripts that measure the port (`chip_smoke.py`,
`measure_port.py`). Nothing on a render path imports this module.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def event_timed(module, name: str):
    """Within the block, each call of `module.<name>` runs between a pair of
    CUDA events; yields the list the (start, end) pairs go into, which
    `event_ms` reads after the block."""
    original = getattr(module, name)
    events = []

    def wrapped(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = original(*args, **kwargs)
        end.record()
        events.append((start, end))
        return out

    setattr(module, name, wrapped)
    try:
        yield events
    finally:
        setattr(module, name, original)


def event_ms(events) -> float:
    """Milliseconds summed over the (start, end) pairs of `event_timed`."""
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events)


def device_profile(fn):
    """Run fn() under torch.profiler. Returns (wall seconds, device-busy
    seconds, rows): busy is the sum of the CUDA kernels' and copies' self
    device time, rows are (self device µs, name, count) of every device op,
    the largest first."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        # Device-side events only: a CPU op's self device time repeats the
        # time of the kernels it launched.
        if e.device_type != DeviceType.CUDA:
            continue
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = getattr(e, "self_cuda_time_total", 0)
        if dt:
            rows.append((dt, e.key, e.count))
    rows.sort(reverse=True)
    return wall, sum(dt for dt, _, _ in rows) / 1e6, rows
