"""Measurement of the port: the spans that the render and the training step
mark on a recording torch.profiler's host timeline (`span`), and timing on
the card for the scripts that measure the port (`chip_smoke.py`,
`measure_port.py`).

A span is `torch.profiler.record_function("izpi: <name>")`, so it lands in
the profiler's trace, and in any `export_chrome_trace`, beside the CUPTI
device records (whose timestamps have lain up to 4.6 ms off the host's on
an H100; the benchmark's `h100bench/spans.py` puts them on the host's
clock). While no profiler records, `span` returns one shared no-op context
manager after a single check of PyTorch's profiler state: the render and
step paths pay that check and nothing more.
"""

from __future__ import annotations

import contextlib

import torch
from torch._C._autograd import _profiler_enabled

PREFIX = "izpi: "
# What `span` returns while no profiler records.
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that marks `name` (as "izpi: <name>") on the host's
    timeline of a recording torch.profiler; spans nest by the host thread's
    order. When no profiler records, the shared no-op."""
    if not _profiler_enabled():
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


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


def device_rows(records):
    """(device µs, name, count) of device records [(start µs, end µs, name)]
    (the benchmark's `h100bench.harness.device_intervals`), summed by name,
    the largest first."""
    by_name = {}
    for start, end, name in records:
        us, count = by_name.get(name, (0.0, 0))
        by_name[name] = (us + end - start, count + 1)
    return sorted(((us, name, count) for name, (us, count)
                   in by_name.items()), reverse=True)
