"""Idle device milliseconds a step while the host was in the step's own
code, a capture, the copies into the graph's static buffers or the
graph's launch (`step`, `graph.capture`, `graph.copy_in`,
`graph.replay`; `spans.idle_by_span`)."""

from h100bench import spans

SPANS = ("step", "graph.capture", "graph.copy_in", "graph.replay")


def read(tr):
    return spans.idle_ms(tr, SPANS, "steps")
