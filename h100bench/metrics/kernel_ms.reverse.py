"""Milliseconds a call of the training step's reverse: its walk
(`diff_trace_bwd_stat`) and its sum (`diff_trace_bwd_lane`, `_block` or
`_global`), by their device records, over the walk's launches."""

WALK = "diff_trace_bwd_stat"
SUMS = ("diff_trace_bwd_lane", "diff_trace_bwd_block", "diff_trace_bwd_global")


def read(tr):
    walks = tr.kernel_calls((WALK,))
    sums = tr.kernel_calls(SUMS)
    if not walks:
        return None
    return 1e3 * (sum(walks) + sum(sums)) / len(walks)
