"""The share of the traced slice in which no operation ran on the card:
100 x (1 - the union of the device records' intervals / the slice's host
seconds)."""


def read(tr):
    if tr.window_s <= 0 or not tr.intervals:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
