"""The program's spans in a traced slice, and the device's idle time
charged to them.

The port marks its layers on the host's timeline of a recording
torch.profiler as `record_function` ranges named "izpi: <span>"
(`izpi_tpu_torch.profiling.span`); they come with the slice's host
operations (`harness.Trace.host`). Between the slice's first and last
device record, each idle microsecond (no device record running) goes to
the innermost program span open at that moment, the covering span with the
latest start, or to `OUTSIDE` where none is open: the benchmark loop's own
time. A parent span's share is thus its self time's. A program without the
spans gives nothing to read.

The device records are first put on the host's clock (`on_host_clock`): on
an H100 the profiler's device records have lain from 0 to 4.6 ms before the
host operations that launched them, in one trace by an amount that drifted
from 4.6 to 1.2 ms over 0.8 s, while the host's runtime calls agreed with
its operations.
"""

from __future__ import annotations

from typing import Dict, Optional

PREFIX = "izpi: "
OUTSIDE = "outside"


def program_spans(host):
    """[(start µs, end µs, span name without the prefix)] of the host
    operations that are the program's spans."""
    return [(s, e, name[len(PREFIX):]) for s, e, name in host
            if name.startswith(PREFIX)]


# A copy between host and device memory runs inside the host operation
# that waits for it: one to or from pageable memory inside `.to()`'s or
# `.cpu()`'s `aten::_to_copy`, `item()`'s read into pinned memory inside
# `aten::_local_scalar_dense`.
ANCHORS = {"(Pageable -> Device)": "aten::_to_copy",
           "(Device -> Pageable)": "aten::_to_copy",
           "(Device -> Pinned)": "aten::_local_scalar_dense"}
# µs from such a copy's end to its operation's end: 9-24 in the traces of
# an H100's host (~200 after `.cpu()`'s copy of an image, whose host then
# copies the staged bytes).
ANCHOR_LAG_US = 100.0
# The offsets considered, and how fast one may drift: on an H100 it reached
# 4.5 ms in one trace and drifted 4,200 ppm in it (to 1.6 ms over 0.7 s).
MAX_OFFSET_US = 20_000.0
MAX_DRIFT = 0.01
# The most a copy kept for the line lies above it, and the least time its
# copies span for the line to slope: over less, drift moves the offset
# less than the copies' lags scatter.
RESIDUAL_US = 50.0
MIN_SPAN_US = 10_000.0


def _anchors(tr):
    """[(start µs, end µs, [(start µs, end µs) of the host operations that
    may have waited for it])] of the slice's copies between host and
    device memory."""
    windows = {op: [(s, e) for s, e, name in tr.host if name == op]
               for op in set(ANCHORS.values())}
    out = []
    for rs, re_, name in tr.intervals:
        op = next((op for kind, op in ANCHORS.items()
                   if name.startswith("Memcpy") and name.endswith(kind)),
                  None)
        if op is not None:
            out.append((rs, re_, [(ws, we) for ws, we in windows[op]
                                  if we - ws >= re_ - rs]))
    return out


def _matched(tr):
    """[(copy's start µs, its operation's end − its end µs)]: the longest
    chain of the slice's copies between host and device memory, in time
    order, each matched to a host operation that may have waited for it
    (within MAX_OFFSET_US), whose offsets move from one copy to the next by
    at most ANCHOR_LAG_US + MAX_DRIFT × the time between them; of chains as
    long, the one that starts nearest 0. A copy the chain skips waited in
    no such operation, or its host worked on after it."""
    points = sorted((rs, we - re_) for rs, re_, windows in _anchors(tr)
                    for _, we in windows
                    if abs(we - re_) <= MAX_OFFSET_US)
    # Per point: (chain length, −|its first offset|, previous point).
    best = []
    for i, (t, y) in enumerate(points):
        here = (1, -abs(y), None)
        for k in range(i):
            tk, yk = points[k]
            if tk < t and abs(y - yk) <= (ANCHOR_LAG_US
                                          + MAX_DRIFT * (t - tk)):
                here = max(here, (best[k][0] + 1, best[k][1], k))
        best.append(here)
    if not best:
        return []
    i = max(range(len(best)), key=lambda i: best[i][:2])
    chain = []
    while i is not None:
        chain.append(points[i])
        i = best[i][2]
    return chain[::-1]


def _line(points):
    """(a, b) of the least-squares line y = a + b·x through the points."""
    n = len(points)
    mx = sum(x for x, _ in points) / n
    my = sum(y for _, y in points) / n
    sxx = sum((x - mx) ** 2 for x, _ in points)
    b = (sum((x - mx) * (y - my) for x, y in points) / sxx) if sxx else 0.0
    return my - b * mx, b


def on_host_clock(tr):
    """The slice's device records [(start µs, end µs, name)] moved onto its
    host operations' clock. The offset can drift through a slice, so it is
    a line in time: fitted to the copies `_matched` keeps (operation's end
    − copy's end against the copy's time), the copies more than
    RESIDUAL_US above it (a host that worked on after its copy) dropped,
    the line fitted again and lowered until no kept copy ends after its
    operation. With fewer than three copies, or copies less than
    MIN_SPAN_US apart, the offset is constant, and without any 0."""
    points = _matched(tr)
    a, b = 0.0, 0.0
    for _ in range(2):
        if len(points) < 3 or points[-1][0] - points[0][0] < MIN_SPAN_US:
            break
        a, b = _line(points)
        points = [(x, y) for x, y in points if y - (a + b * x) <= RESIDUAL_US]
    if points:
        # Lowered to the copies' ends: each kept copy then ends before its
        # operation does, the nearest one as it does.
        a = min(y - b * x for x, y in points)
    return [(s + a + b * s, e + a + b * e, name)
            for s, e, name in tr.intervals]


def idle_gaps(intervals):
    """[(start µs, end µs)] in which no device record runs, between the
    first record's start and the last one's end."""
    gaps = []
    end = None
    for s, e, *_ in sorted(intervals):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def idle_by_span(tr) -> Optional[Dict[str, float]]:
    """Idle seconds of the slice `tr` by the span they fall in (`OUTSIDE`
    for none), summing to the slice's idle time between its first and last
    device record; None when the slice holds no program span."""
    spans = sorted(program_spans(tr.host))
    if not spans:
        return None
    gaps = idle_gaps(on_host_clock(tr))
    cuts = sorted({t for gap in gaps for t in gap}
                  | {t for s, e, _ in spans for t in (s, e)})
    out: Dict[str, float] = {}
    open_spans, nxt, gi = [], 0, 0
    for a, b in zip(cuts, cuts[1:]):
        while gi < len(gaps) and gaps[gi][1] <= a:
            gi += 1
        if gi == len(gaps):
            break
        while nxt < len(spans) and spans[nxt][0] <= a:
            open_spans.append(spans[nxt])
            nxt += 1
        if gaps[gi][0] > a:
            continue  # the device is busy over [a, b)
        # Every cut is a span's end or a gap's, so a span open at a and
        # ending after it covers [a, b).
        open_spans = [sp for sp in open_spans if sp[1] > a]
        name = (max(open_spans, key=lambda sp: (sp[0], -sp[1]))[2]
                if open_spans else OUTSIDE)
        out[name] = out.get(name, 0.0) + (b - a) / 1e6
    return out


def idle_ms(tr, names, per: str) -> Optional[float]:
    """Milliseconds of idle time under the spans `names` over the slice's
    count `per` (`images`, `steps`); None without program spans or that
    count."""
    split = idle_by_span(tr)
    count = tr.counters.get(per)
    if split is None or not count:
        return None
    return 1e3 * sum(split.get(name, 0.0) for name in names) / count
