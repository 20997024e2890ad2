"""Idle device milliseconds an image while the host was in `render()`'s
own code, its set-up (`render.prepare`) or the megakernel's wrapper
(`megakernel.launch`): the time the host takes to put an image's work on
the card (`spans.idle_by_span`)."""

from h100bench import spans

SPANS = ("render", "render.prepare", "megakernel.launch")


def read(tr):
    return spans.idle_ms(tr, SPANS, "images")
