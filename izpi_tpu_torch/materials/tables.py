"""Flat material parameter table.

Counterpart of `izpi_tpu/materials/tables.py`. Materials are rows of a
parameter table; the integrator gathers a ray's row and evaluates every lobe
with tagged selects (`izpi_tpu_torch.integrator.path`).

Kinds: 0 LAMBERT, 1 METAL, 2 DIELECTRIC, 3 DIFFUSE_LIGHT, 4 ISOTROPIC, 5 PBR.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

MAT_LAMBERT = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_DIFFUSE_LIGHT = 3
MAT_ISOTROPIC = 4
MAT_PBR = 5


class Materials(NamedTuple):
    kind: torch.Tensor            # (M,) int32
    tex_albedo: torch.Tensor      # (M,) int32 — albedo or emission texture id
    fuzz: torch.Tensor            # (M,) f32 metal fuzz (metal.go:22)
    ref_idx: torch.Tensor         # (M,) f32 dielectric η (dielectric.go:33)
    absorption: torch.Tensor      # (M, 3) f32 Beer–Lambert α (dielectric.go:48)
    has_absorption: torch.Tensor  # (M,) bool
    # PBR texture slots (pbr.go:20-31); -1 = absent.
    tex_rough: torch.Tensor       # (M,) int32
    tex_metal: torch.Tensor       # (M,) int32
    tex_normal: torch.Tensor      # (M,) int32
    tex_sss: torch.Tensor         # (M,) int32
    sss_radius: torch.Tensor      # (M,) f32
    # Spectral columns (-1 = absent): rows of the scene's SPD table, or
    # Gaussian parameters.
    spec_albedo_id: torch.Tensor      # (M,) int32 albedo/emission SPD id
    spec_albedo_gauss: torch.Tensor   # (M, 3) f32 (peak, center, width); width <= 0: unused
    spec_ref_idx_id: torch.Tensor     # (M,) int32 η(λ) SPD id (dispersion)
    spec_absorb_id: torch.Tensor      # (M,) int32 absorption SPD id
    # Spectral checker (texture/spectral_checker.go): the second branch.
    spec_checker: torch.Tensor        # (M,) bool
    spec_albedo_id2: torch.Tensor     # (M,) int32
    spec_albedo_gauss2: torch.Tensor  # (M, 3) f32
    # RGB→spectral uplift of the albedo texture (texture.uplift).
    spec_albedo_uplift: torch.Tensor  # (M,) bool
    # Row of the combined image-map stack (-1 = none: PBR takes the generic
    # texture lookups).
    combo_id: torch.Tensor            # (M,) int32

    @property
    def count(self) -> int:
        return self.kind.shape[0]
