"""Batched directional sampling primitives.

Counterpart of `izpi_tpu/core/sampling.py`, formula for formula, including
the book's `2*sqrt(r2)` cosine-sampling factor (vec3.go:119, compat flag
`exact_book_cosine`). Every function consumes pre-drawn uniforms.
"""

from __future__ import annotations

import math

import torch

from h100bench.reference.plain.core import onb as onb_mod
from h100bench.reference.plain.core import vecmath as vm

TWO_PI = 2.0 * math.pi


def random_cosine_direction(u1, u2, exact_book_cosine: bool = True):
    """Reference: vec3.RandomCosineDirection (vec3.go:119-128)."""
    scale = 2.0 if exact_book_cosine else 1.0
    z = torch.sqrt(1.0 - u2)
    phi = TWO_PI * u1
    r = scale * torch.sqrt(u2)
    return torch.stack([torch.cos(phi) * r, torch.sin(phi) * r, z], dim=-1)


def random_to_sphere(radius, distance_squared, u1, u2):
    """Cone sampling toward a sphere (vec3.go:130-139)."""
    z = 1.0 + u2 * (torch.sqrt(1.0 - radius * radius / distance_squared) - 1.0)
    phi = TWO_PI * u1
    s = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([torch.cos(phi) * s, torch.sin(phi) * s, z], dim=-1)


def random_in_unit_disc(u1, u2):
    """Uniform in the unit disc by the polar transform (the reference
    rejection-samples, camera/camera.go:90-97)."""
    r = torch.sqrt(u1)
    phi = TWO_PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def random_in_unit_sphere(u1, u2, u3):
    """Uniform in the unit ball (metal fuzz). The radius is cbrt(u3) spelled
    exp(log(max(u3, 1e-30))/3): the JAX package and the CUDA kernel use the
    same form, and the streams stay comparable only if all three do."""
    z = 1.0 - 2.0 * u1
    phi = TWO_PI * u2
    s = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    d = torch.stack([s * torch.cos(phi), s * torch.sin(phi), z], dim=-1)
    r = torch.exp(torch.log(torch.clamp(u3, min=1e-30)) * (1.0 / 3.0))
    return d * r[..., None]


def cosine_pdf_value(normal, direction):
    """max(cos, 0)/π of the normalized direction against the lobe axis
    (pdf/cosine.go:28)."""
    cosine = vm.dot(vm.normalize(direction), vm.normalize(normal))
    return torch.where(cosine > 0, cosine / math.pi, torch.zeros_like(cosine))


def cosine_pdf_generate(normal, u1, u2, exact_book_cosine: bool = True):
    """Sample the cosine lobe around `normal` (pdf/cosine.go:37)."""
    u, v, w = onb_mod.build_from_w(normal)
    return onb_mod.local(u, v, w,
                         random_cosine_direction(u1, u2, exact_book_cosine))
