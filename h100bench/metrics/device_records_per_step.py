"""Device records (kernels, copies, sets) a replay of the training step's
CUDA graph, with the optimizer's update that follows it."""


def read(tr):
    replays = tr.counters.get("replays")
    if not replays or not tr.intervals:
        return None
    return len(tr.intervals) / replays
