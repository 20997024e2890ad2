"""Light-list sampling and PDF evaluation (the NEE half of the mixture PDF).

Counterpart of `izpi_tpu/integrator/lights.py:58-170`; see its docstring for
the reference semantics kept bug for bug (dielectrics in the light list,
untransformed geometry of wrapped lights, the triangle's lerp-lerp sample,
box emitters as null members). The one documented deviation is kept too:
the sphere pdf clamps `1 - r²/d²` at 0, so origins inside a light sphere get
the hemisphere pdf 1/2π where the reference returns NaN.

Member kinds: 0 RECT (parallelogram), 1 TRIANGLE, 2 SPHERE, 3 NULL.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from h100bench.reference.plain.core import onb as onb_mod
from h100bench.reference.plain.core import sampling
from h100bench.reference.plain.core import vecmath as vm
from h100bench.reference.plain.geometry import primitives as prim

LIGHT_RECT = 0
LIGHT_TRIANGLE = 1
LIGHT_SPHERE = 2
LIGHT_NULL = 3


class Lights(NamedTuple):
    kind: torch.Tensor    # (L,) int32
    l0: torch.Tensor      # (L, 3) rect corner / tri v0 / sphere center0
    l1: torch.Tensor      # (L, 3) rect e1 / tri v1
    l2: torch.Tensor      # (L, 3) rect e2 / tri v2
    normal: torch.Tensor  # (L, 3) rect/tri unit normal
    area: torch.Tensor    # (L,)
    radius: torch.Tensor  # (L,) sphere radius


def pdf_value(lights: Lights, o, v):
    """Mean member PDF for directions v from origins o. o, v: (N, 3);
    returns (N,). Dense (N, L) evaluation."""
    n_l = lights.kind.shape[0]
    ob = o[:, None, :]
    vb = v[:, None, :]
    kind = lights.kind[None, :]
    zero = torch.zeros((), dtype=o.dtype, device=o.device)

    # Rect member: t²|v|² / (cos·area), cos = |dot(v, n)|/|v| (xzrect.go:106-116).
    t_r, ok_r, _, _ = prim.rect_t(ob, vb, lights.l0[None], lights.l1[None],
                                  lights.l2[None], lights.normal[None], 1e-3,
                                  prim.T_MAX)
    v_len2 = vm.squared_length(vb)
    v_len = torch.sqrt(v_len2)
    cos_r = torch.abs(vm.dot(vb, lights.normal[None])) / v_len
    pdf_rect = torch.where(ok_r, t_r * t_r * v_len2 / (cos_r * lights.area[None]),
                           zero)

    # Triangle member: the same with the triangle's area (triangle.go:266-276).
    e1 = lights.l1 - lights.l0
    e2 = lights.l2 - lights.l0
    t_t, ok_t, _, _ = prim.triangle_t(ob, vb, lights.l0[None], e1[None],
                                      e2[None], 1e-3, prim.T_MAX)
    cos_t = torch.abs(vm.dot(vb, lights.normal[None])) / v_len
    pdf_tri = torch.where(ok_t, t_t * t_t * v_len2 / (cos_t * lights.area[None]),
                          zero)

    # Sphere member: solid-angle cone (sphere.go:129-137), clamped (see the
    # module docstring).
    _, ok_s, _ = prim.sphere_t(ob, vb, lights.l0[None], lights.radius[None],
                               1e-3, prim.T_MAX)
    dist2 = vm.squared_length(lights.l0[None] - ob)
    r = lights.radius[None]
    cos_theta_max = torch.sqrt(torch.clamp(1.0 - r * r / dist2, min=0.0))
    solid_angle = (2.0 * math.pi) * (1.0 - cos_theta_max)
    pdf_sph = torch.where(ok_s, 1.0 / solid_angle, zero)

    per = torch.where(kind == LIGHT_RECT, pdf_rect,
                      torch.where(kind == LIGHT_TRIANGLE, pdf_tri,
                                  torch.where(kind == LIGHT_SPHERE, pdf_sph,
                                              zero)))
    total = per[:, 0]
    for j in range(1, n_l):
        total = total + per[:, j]
    return total / n_l


def sample(lights: Lights, o, uniforms):
    """A direction toward the light list from each origin. o: (N, 3);
    uniforms: (N, 4): u0 picks the member (hitable_slice.go:108), u1..u3
    sample it. Rect/tri directions are point − origin, unnormalized."""
    n_l = lights.kind.shape[0]
    idx = torch.clamp((uniforms[:, 0] * n_l).to(torch.int64), max=n_l - 1)
    kind = lights.kind[idx]
    l0, l1, l2 = lights.l0[idx], lights.l1[idx], lights.l2[idx]
    radius = lights.radius[idx]
    u1 = uniforms[:, 1:2]
    u2 = uniforms[:, 2:3]
    u3 = uniforms[:, 3:4]

    # Rect: uniform point on the parallelogram (xzrect.go:118-126).
    rect_dir = l0 + u1 * l1 + u2 * l2 - o
    # Triangle: the reference's lerp-lerp (triangle.go:317-326), kept.
    p01 = l0 + u1 * (l1 - l0)
    p02 = l0 + u2 * (l2 - l0)
    tri_dir = p01 + u3 * (p02 - p01) - o
    # Sphere: cone sample about the center direction (sphere.go:139-145).
    to_center = l0 - o
    dist2 = vm.squared_length(to_center)
    bu, bv, bw = onb_mod.build_from_w(to_center)
    local = sampling.random_to_sphere(radius, dist2, uniforms[:, 1],
                                      uniforms[:, 2])
    sph_dir = onb_mod.local(bu, bv, bw, local)

    null_dir = vm.const((1.0, 0.0, 0.0), o)
    return torch.where(
        (kind == LIGHT_RECT)[:, None], rect_dir,
        torch.where((kind == LIGHT_TRIANGLE)[:, None], tri_dir,
                    torch.where((kind == LIGHT_SPHERE)[:, None], sph_dir,
                                null_dir)))
