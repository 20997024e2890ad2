"""The control and the planted faults that the check must refuse
(`calibrate.py` reads them on the card; `tests/` at a small size).

- The control: the plain reference computed in bfloat16, the precision
  below the configuration's float32 (no matrix product here, so no TF32
  step), put in the program's place.
- The faults, planted in the timed path: a render with half of each
  pixel's samples (the mean taken over the rest); every image with its
  rows off by one (an answer altered where it is produced); a training
  step that leaves the parameters as they were; a step over half of the
  pixels, the mean taken over the rest.
"""

from __future__ import annotations

import numpy as np
import torch

CONTROL_DTYPE = torch.bfloat16


def half_samples(render, st):
    """Each image from half of its samples."""
    def broken(seed, spp=None):
        return render(seed, max(1, (spp or st.spp) // 2))
    return broken


def rows_off_by_one(render, st):
    """Each image's rows moved down by one (the last row dropped)."""
    def broken(seed, spp=None):
        res = render(seed, spp)
        res.image = np.ascontiguousarray(np.roll(res.image, 1, axis=0))
        return res
    return broken


def unchanged(step, st):
    """A step whose update leaves every parameter as it was."""
    def broken(params, xs, ys, target, key):
        loss, grads = step(params, xs, ys, target, key)
        return loss, {k: torch.zeros_like(g) for k, g in grads.items()}
    return broken


def half_batch(step, st):
    """A step over the first half of the pixels, the mean taken over
    them."""
    def broken(params, xs, ys, target, key):
        h = xs.shape[0] // 2
        return step(params, xs[:h], ys[:h], target[:h], key)
    return broken


FAULTS = {"render_loop": {"half_samples": half_samples,
                          "rows_off_by_one": rows_off_by_one},
          "train_loop": {"unchanged": unchanged, "half_batch": half_batch}}
