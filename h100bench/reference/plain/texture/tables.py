"""Flat texture table and its RGB evaluation: the constant textures of the
port's `texture/tables.py`. `c1` (a checker's second colour) and `images`
(the image stack) are trainable leaves of the port's training step that the
benchmark's scenes leave at zero; they are kept so that the reference has
the same leaves.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from h100bench.reference.plain.ops import table_grad


class Textures(NamedTuple):
    c0: torch.Tensor      # (T, 3) f32 constant colour
    c1: torch.Tensor      # (T, 3) f32 zeros
    images: torch.Tensor  # (1, 1, 1, 3) f32 zeros


def eval_rgb(tex: Textures, tex_id):
    """The colour of each texture `tex_id` (N,) (a negative id reads
    texture 0, as in the port). Returns (N, 3)."""
    tid = torch.clamp(tex_id, min=0).long()
    return table_grad.gather(tex.c0, tid)
