"""B1, the RGB megakernel's brute-force form (`megakernel_rgb`): the work a
final render's inputs need (`h100bench/work.py`): every ray traced tested
against each of the scene's primitives, the keyed streams from the new
sample on, the scene's primitives read once and the image written once,
a launch an image."""

from h100bench import work


def bound(counters: dict, facts: dict, peaks: dict):
    """(seconds, which bound) of the traced images together."""
    rays, paths, images = (counters["rays"], counters["paths"],
                           counters["images"])
    flops = work.brute_flops(rays, counters["prim_kinds"])
    int_ops = work.cipher_ops(rays, paths, new_samples=True)
    nbytes = images * (counters["prims"] * work.PRIM_BYTES
                       + counters["nx"] * counters["ny"] * 3 * 4)
    return work.bound_seconds(flops, int_ops, nbytes, facts, peaks)
