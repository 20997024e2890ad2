"""Idle device milliseconds a step while the host cloned the graph's
outputs (`graph.clone_out`) or read the step's rays back
(`step.rays_read`) (`spans.idle_by_span`)."""

from h100bench import spans

SPANS = ("graph.clone_out", "step.rays_read")


def read(tr):
    return spans.idle_ms(tr, SPANS, "steps")
