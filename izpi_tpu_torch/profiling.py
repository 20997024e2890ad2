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


def cuda_ms(fn, reps: int, warm_up: bool = True):
    """(the last run's output, mean milliseconds of fn() on the card over
    reps runs between two CUDA events), after one untimed run when
    warm_up."""
    if warm_up:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card, its launches captured reps
    times in one CUDA graph and the graph replayed between two CUDA events,
    so that the host's cost of launching them is not timed. fn must launch
    on the current stream and sync with nothing; it runs once first."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# Kernels launched at each end of a profile (`torch.cuda._sleep`, whose
# kernel is `spin_kernel`), so that what a trace loses at its ends is
# padding; they are left out of the rows.
PAD_KERNELS = 4096
PAD_NAME = "spin_kernel"
# Seconds the host waits inside the profile before its first launch and
# after its last sync. Both the wait and the padding double on each retry.
SETTLE_S = 0.25
TRIES = 3


def device_profile(fn):
    """Run fn() under torch.profiler. Returns (wall seconds, device-busy
    seconds, rows): busy is the sum of the CUDA kernels' and copies' self
    device time, rows are (self device µs, name, count) of every device op,
    the largest first. wall covers fn() alone.

    A trace can lose device records at its ends: on an H100 a trace lost
    its first few kernels, more of them the more traces the process had
    taken, and once every padding kernel at one end; why is not known. So
    the host waits SETTLE_S before the first launch and after the last
    sync, PAD_KERNELS tiny kernels run before fn() and after it, and the
    rows leave them out. If no padding kernel is left at an end, fn()'s
    records may be cut too: the profile is taken again with twice the wait
    and the padding, and after TRIES such traces this raises."""
    def pad(n):
        for _ in range(n):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()

    for attempt in range(TRIES):
        settle, n_pad = SETTLE_S * 2 ** attempt, PAD_KERNELS * 2 ** attempt
        torch.cuda.synchronize()
        # Device activity only: the rows are device records, and the host
        # ops' records (several a launch) made a trace of an eager pool or
        # training step take minutes to read back.
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(settle)
            pad(n_pad)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            pad(n_pad)
            time.sleep(settle)
        device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        pads = [e.time_range.start for e in device if PAD_NAME in e.name]
        run = [e.time_range.start for e in device if PAD_NAME not in e.name]
        kept = ([sum(p < min(run) for p in pads),
                 sum(p > max(run) for p in pads)] if run else [n_pad] * 2)
        lost = [end for end, k in zip(("start", "end"), kept) if not k]
        if kept != [n_pad] * 2:
            print(f"device_profile: the trace kept {kept[0]} of {n_pad} "
                  f"padding kernels at its start, {kept[1]} at its end",
                  flush=True)
        if not lost:
            break
        # The runtime's launch records, where the trace holds them.
        launches = [e.time_range.start for e in prof.events()
                    if e.device_type == DeviceType.CPU
                    and e.name.startswith("cudaLaunchKernel")]
        lead = (min(pads + run) - min(launches)) if launches else float("nan")
        print(f"device_profile: the trace lost every padding kernel at its "
              f"{' and '.join(lost)} ({len(run)} other device records, the "
              f"first device record {lead:.1f} us after the first launch, "
              f"{settle} s wait); try {attempt + 1} of {TRIES}", flush=True)
    else:
        raise RuntimeError(f"the trace lost every padding kernel at one end "
                           f"in {TRIES} tries")
    rows = []
    for e in prof.key_averages():
        # Device-side events only: a CPU op's self device time repeats the
        # time of the kernels it launched.
        if e.device_type != DeviceType.CUDA or PAD_NAME in e.key:
            continue
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = getattr(e, "self_cuda_time_total", 0)
        if dt:
            rows.append((dt, e.key, e.count))
    rows.sort(reverse=True)
    return wall, sum(dt for dt, _, _ in rows) / 1e6, rows
