"""Idle device milliseconds an image while the host read the image's sum
and rays back (`render.readback`) or added it into the float64
accumulator and the canvas (`render.accumulate`) (`spans.idle_by_span`)."""

from h100bench import spans

SPANS = ("render.readback", "render.accumulate")


def read(tr):
    return spans.idle_ms(tr, SPANS, "images")
