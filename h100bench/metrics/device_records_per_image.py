"""Device records (kernels, copies, sets) a traced image: the work the
megakernel wrappers put around each launch."""


def read(tr):
    images = tr.counters.get("images")
    if not images or not tr.intervals:
        return None
    return len(tr.intervals) / images
