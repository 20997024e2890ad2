"""The work a render's inputs need, whatever implements it: the arithmetic
the per-kernel counts (`counts/<kernel>.py`) share.

- A primitive test is the closest-hit test of one ray against one
  primitive, in the fp32 operations of its formula (a multiply and an add
  are two; comparisons are not counted): a parallelogram's plane hit and
  its two parametric coordinates, a sphere's quadratic and its root, a
  triangle's Möller–Trumbore test.
- A Threefry-2x32 call is 20 rounds of an add, a rotate and a xor, five key
  injections of three adds, the two key adds before the rounds and the two
  xors of the key schedule's parity word: 79 integer operations.
- A path's keyed streams need, at the least, the new sample's 7 calls (the
  sample and pixel folds, the camera draw's depth and salt folds and its 3
  calls for 5 uniforms), and every scattering bounce 3 (its depth and salt
  folds and one call of draws). A path that ends at a light or a miss draws
  nothing there, so of its rays all but one scatter at most; rays − paths
  bounds the scattering bounces from below.
"""

from __future__ import annotations

FLOPS_PER_TEST = {"rect": 35, "sphere": 26, "triangle": 45}
THREEFRY_OPS = 20 * 3 + 5 * 3 + 2 + 2
NEW_SAMPLE_CALLS = 7
SCATTER_CALLS = 3
# Bytes of one primitive's row that a test reads: kind, 4 xyz vectors and
# the material id.
PRIM_BYTES = 4 + 4 * 12 + 4


def brute_flops(rays: int, kinds: dict) -> float:
    """fp32 operations of testing every ray against every primitive."""
    return float(rays) * sum(FLOPS_PER_TEST[k] * n for k, n in kinds.items())


def cipher_ops(rays: int, paths: int, new_samples: bool) -> float:
    calls = SCATTER_CALLS * max(rays - paths, 0)
    if new_samples:
        calls += NEW_SAMPLE_CALLS * paths
    return float(calls) * THREEFRY_OPS


def bound_seconds(flops: float, int_ops: float, nbytes: float, facts: dict,
                  peaks: dict):
    """The least time the card could take, the largest of the three, and
    which bounds it; None without the SM clock."""
    if not facts.get("sm_clock_mhz") or not facts.get("sm_count"):
        return None
    int_rate = (facts["sm_count"] * facts["sm_clock_mhz"] * 1e6
                * peaks["int32_ops_per_sm_per_clock"])
    terms = {"fp32": flops / peaks["fp32_flops_per_s"],
             "int32": int_ops / int_rate,
             "bytes": nbytes / peaks["hbm_bytes_per_s"]}
    which = max(terms, key=terms.get)
    return terms[which], which
