"""Milliseconds a launch of B1, the RGB megakernel's brute-force form
(`megakernel_rgb`), by its device records."""

KERNEL = "megakernel_rgb"


def read(tr):
    calls = tr.kernel_calls((KERNEL,))
    if not calls:
        return None
    return 1e3 * sum(calls) / len(calls)
