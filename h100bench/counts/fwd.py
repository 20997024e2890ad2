"""F, the training step's forward kernel (`diff_trace_fwd`), brute force:
the work its inputs need (`h100bench/work.py`): every ray traced tested
against each of the scene's primitives and the keyed streams of every
scattering bounce (the new sample's draws are the cipher entry's, outside
F), each path's camera ray and key read once (44 bytes) and its colour
written once (12), the scene's primitives read once a launch."""

from h100bench import work


def bound(counters: dict, facts: dict, peaks: dict):
    """(seconds, which bound) of the traced steps together."""
    rays, paths = counters["rays"], counters["paths"]
    flops = work.brute_flops(rays, counters["prim_kinds"])
    int_ops = work.cipher_ops(rays, paths, new_samples=False)
    nbytes = paths * (44 + 12) + counters["passes"] * (
        counters["prims"] * work.PRIM_BYTES)
    return work.bound_seconds(flops, int_ops, nbytes, facts, peaks)
