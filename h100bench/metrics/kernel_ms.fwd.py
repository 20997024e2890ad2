"""Milliseconds a launch of F, the training step's forward kernel
(`diff_trace_fwd`, or its BVH form `diff_trace_fwd_bvh`), by its device
records."""

KERNELS = ("diff_trace_fwd", "diff_trace_fwd_bvh")


def read(tr):
    calls = tr.kernel_calls(KERNELS)
    if not calls:
        return None
    return 1e3 * sum(calls) / len(calls)
