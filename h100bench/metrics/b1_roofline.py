"""B1's share of its roofline: the least time the work its inputs need
could take on this card (`counts/b1.py`, the peaks in `peaks.json`, the
SM count and clock read in this run) over its device time in the traced
slice, in %."""

from h100bench import harness

KERNEL = "megakernel_rgb"


def read(tr):
    calls = tr.kernel_calls((KERNEL,))
    if not calls or not tr.counters.get("rays"):
        return None
    got = harness.count_module("b1").bound(tr.counters, tr.facts,
                                          harness.peaks())
    if got is None:
        return None
    return 100.0 * got[0] / sum(calls)
