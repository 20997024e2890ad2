"""Flat material parameter table.

Counterpart of the port's `materials/tables.py`, the columns the RGB
bounce reads. Materials are rows of a parameter table; the integrator
gathers a ray's row and evaluates every lobe with tagged selects
(`integrator.path`).

Kinds: 0 LAMBERT, 1 METAL, 2 DIELECTRIC, 3 DIFFUSE_LIGHT.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

MAT_LAMBERT = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_DIFFUSE_LIGHT = 3


class Materials(NamedTuple):
    kind: torch.Tensor            # (M,) int32
    tex_albedo: torch.Tensor      # (M,) int32 — albedo or emission texture id
    fuzz: torch.Tensor            # (M,) f32 metal fuzz (metal.go:22)
    ref_idx: torch.Tensor         # (M,) f32 dielectric η (dielectric.go:33)
    absorption: torch.Tensor      # (M, 3) f32 Beer–Lambert α (dielectric.go:48)
