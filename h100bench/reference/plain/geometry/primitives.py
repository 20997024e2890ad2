"""Primitive SoA and batched intersection.

Counterpart of `izpi_tpu/geometry/primitives.py:87-258`. Every primitive
lives in one flat struct-of-arrays; intersection is a data-parallel pass
over (ray, primitive) pairs with integer-tagged selects.

Primitive kinds:
  0 TRIANGLE  g0=v0, g1=edge1, g2=edge2, g3=geometric normal
  1 RECT      g0=corner, g1=edge1, g2=edge2, g3=unit normal (a parallelogram)
  2 SPHERE    g0=center0, g1=center1, g2=(radius, time0, time1)
  3 NONE      padding, never hits

Reference semantics kept (load-bearing for parity): Möller–Trumbore with
ε=1e-8 and its -ε..1+ε barycentric tolerance (triangle.go:193-231); the
sphere's far-root record normal left unflipped (sphere.go:70-100); the
closest hit keeps the first primitive on exact ties (hitable_slice.go:30-45).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from h100bench.reference.plain.core import vecmath as vm

KIND_TRIANGLE = 0
KIND_RECT = 1
KIND_SPHERE = 2
KIND_NONE = 3

MT_EPS = 1e-8   # Möller–Trumbore epsilon (triangle.go:196)
T_MAX = 3.0e38  # stand-in for math.MaxFloat64 in f32


class Prims(NamedTuple):
    """Flat primitive SoA. All tensors share leading dim P."""

    kind: torch.Tensor    # (P,) int32
    g0: torch.Tensor      # (P, 3) f32
    g1: torch.Tensor      # (P, 3) f32
    g2: torch.Tensor      # (P, 3) f32
    g3: torch.Tensor      # (P, 3) f32
    mat_id: torch.Tensor  # (P,) int32
    flip: torch.Tensor    # (P,) bool — FlipNormals (flip_normals.go:27)
    uv: torch.Tensor      # (P, 6) f32 — (u0,v0,u1,v1,u2,v2) for triangles
    vn: torch.Tensor      # (P, 9) f32 — per-vertex normals for triangles
    has_vn: torch.Tensor  # (P,) bool
    tb: torch.Tensor      # (P, 6) f32 — tangent(3) + bitangent(3) for normal maps


class Hit(NamedTuple):
    """Batched hit record (reference: internal/hitrecord/hitrecord.go)."""

    t: torch.Tensor         # (N,)
    u: torch.Tensor         # (N,)
    v: torch.Tensor         # (N,)
    p: torch.Tensor         # (N, 3)
    normal: torch.Tensor    # (N, 3)
    prim_idx: torch.Tensor  # (N,) int64, -1 on miss
    mat_id: torch.Tensor    # (N,) int64, -1 on miss
    hit: torch.Tensor       # (N,) bool


def _where(m, a, b):
    return torch.where(m, a, b)


def triangle_t(o, d, v0, e1, e2, t_min, t_max):
    """Möller–Trumbore t-only test. Returns (t, hit_mask, bary_u, bary_v)."""
    h = vm.cross(d, e2)
    a = vm.dot(e1, h)
    parallel = torch.abs(a) < MT_EPS
    f = 1.0 / _where(parallel, torch.ones_like(a), a)
    s = o - v0
    u = f * vm.dot(s, h)
    q = vm.cross(s, e1)
    v = f * vm.dot(d, q)
    t = f * vm.dot(e2, q)
    ok = ((~parallel)
          & (u >= -MT_EPS) & (u <= 1.0 + MT_EPS)
          & (v >= -MT_EPS) & (u + v <= 1.0 + MT_EPS)
          & (t >= t_min) & (t <= t_max))
    return t, ok, u, v


def rect_t(o, d, p0, e1, e2, n, t_min, t_max):
    """Parallelogram test: plane hit then parametric inside test.
    Returns (t, hit_mask, param_u, param_v)."""
    denom = vm.dot(d, n)
    degenerate = denom == 0.0
    t = vm.dot(p0 - o, n) / _where(degenerate, torch.ones_like(denom), denom)
    p = o + t[..., None] * d
    rel = p - p0
    ee1 = vm.squared_length(e1)
    ee2 = vm.squared_length(e2)
    u = vm.dot(rel, e1) / ee1
    v = vm.dot(rel, e2) / ee2
    ok = ((~degenerate)
          & (t >= t_min) & (t <= t_max)
          & (u >= 0.0) & (u <= 1.0)
          & (v >= 0.0) & (v <= 1.0))
    return t, ok, u, v


def sphere_center(c0, c1, s_time0, s_time1, time):
    """center0 + ((time-t0)/(t1-t0))·(center1-center0)  (sphere.go:125)."""
    denom = s_time1 - s_time0
    zero = denom == 0.0
    frac = (time - s_time0) / _where(zero, torch.ones_like(denom), denom)
    frac = _where(zero, torch.zeros_like(frac), frac)
    return c0 + frac[..., None] * (c1 - c0)


def sphere_t(o, d, center, radius, t_min, t_max):
    """Sphere quadratic with the reference's root selection (sphere.go:70-100).
    Returns (t, hit_mask, is_far_root)."""
    oc = o - center
    a = vm.dot(d, d)
    b = vm.dot(oc, d)
    c = vm.dot(oc, oc) - radius * radius
    disc = b * b - a * c
    has = disc > 0.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    a_safe = _where(a == 0.0, torch.ones_like(a), a)
    t_near = (-b - sq) / a_safe
    t_far = (-b + sq) / a_safe
    near_ok = has & (t_near < t_max) & (t_near > t_min)
    far_ok = has & (t_far < t_max) & (t_far > t_min) & ~near_ok
    t = _where(near_ok, t_near, t_far)
    return t, near_ok | far_ok, far_ok


def sphere_uv(p_unit):
    """Polar UV from a unit point on the sphere (sphere.go:29-36)."""
    phi = torch.atan2(p_unit[..., 2], p_unit[..., 0])
    theta = torch.asin(torch.clamp(p_unit[..., 1], -1.0, 1.0))
    u = 1.0 - (phi + math.pi) / (2.0 * math.pi)
    v = (theta + math.pi / 2.0) / math.pi
    return u, v


def prim_t(kind, g0, g1, g2, g3, o, d, time, t_min, t_max):
    """t-test for mixed-kind primitive tensors (shapes broadcast; `time` is
    per ray). Returns (t, hit_mask)."""
    t_tri, ok_tri, _, _ = triangle_t(o, d, g0, g1, g2, t_min, t_max)
    t_rect, ok_rect, _, _ = rect_t(o, d, g0, g1, g2, g3, t_min, t_max)
    center = sphere_center(g0, g1, g2[..., 1], g2[..., 2], time)
    t_sph, ok_sph, _ = sphere_t(o, d, center, g2[..., 0], t_min, t_max)

    is_tri = kind == KIND_TRIANGLE
    is_rect = kind == KIND_RECT
    is_sph = kind == KIND_SPHERE
    t = _where(is_tri, t_tri, _where(is_rect, t_rect, t_sph))
    ok = (is_tri & ok_tri) | (is_rect & ok_rect) | (is_sph & ok_sph)
    return t, ok


def tracks(*xs) -> bool:
    """Whether autograd records operations on any of the tensors xs."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def own(x, mask, track: bool = True):
    """x where `mask` (N,) holds and x detached elsewhere, when `track`.

    The double where of a differentiable branch: a branch that a ray does
    not take still computes on its values (a sphere test on a triangle's
    row, a refraction through η = 0), and the 0 that `torch.where` sends
    back into that branch turns into NaN wherever the branch holds an Inf
    (0·Inf). Feeding each branch only its own rays' gradient keeps every
    gradient finite; no forward value changes."""
    if not track:
        return x
    m = mask if x.dim() == mask.dim() else mask[..., None]
    return torch.where(m, x, x.detach())


def differentiable_t(prims: Prims, o, d, time, t, idx, hit, t_min, t_max):
    """t from an intersector that autograd cannot see through (a traversal
    kernel, or the brute-force pass under no_grad), with the gradient of
    the winning primitive's t recomputed from (o, d). The forward value
    stays the given t; the gradient is the brute-force one, since the
    choice of the winner is piecewise constant. Each kind's test sees only
    the rays that hit that kind (`own`), and a miss takes no gradient."""
    i = torch.clamp(idx, min=0)
    kind = prims.kind[i]
    g0, g1, g2, g3 = prims.g0[i], prims.g1[i], prims.g2[i], prims.g3[i]
    is_tri = hit & (kind == KIND_TRIANGLE)
    is_rect = hit & (kind == KIND_RECT)
    is_sph = hit & (kind == KIND_SPHERE)
    t_tri, _, _, _ = triangle_t(own(o, is_tri), own(d, is_tri), g0, g1, g2,
                                t_min, t_max)
    t_rect, _, _, _ = rect_t(own(o, is_rect), own(d, is_rect), g0, g1, g2,
                             g3, t_min, t_max)
    center = sphere_center(g0, g1, g2[..., 1], g2[..., 2], time)
    t_sph, _, _ = sphere_t(own(o, is_sph), own(d, is_sph), center,
                           g2[..., 0], t_min, t_max)
    t_d = _where(is_tri, t_tri, _where(is_rect, t_rect, t_sph))
    t = t.detach()
    grad_t = t_d - t_d.detach()
    return torch.where(hit & torch.isfinite(grad_t), t + grad_t, t)


def finalize_hit(prims: Prims, o, d, time, t, idx, hit) -> Hit:
    """The full shading record of the winning primitive per ray. When
    autograd tracks the rays, each kind's record sees only the rays that
    hit that kind (`own`)."""
    track = tracks(o, d, t)
    i = torch.clamp(idx, min=0)
    g0, g1, g2, g3 = prims.g0[i], prims.g1[i], prims.g2[i], prims.g3[i]
    uv6, vn9 = prims.uv[i], prims.vn[i]
    kind = prims.kind[i]
    has_vn = prims.has_vn[i]
    flip = prims.flip[i]
    mat_id = _where(hit, prims.mat_id[i].long(), torch.full_like(idx, -1))
    is_tri = kind == KIND_TRIANGLE
    is_rect = kind == KIND_RECT

    # A miss's point lies at T_MAX along the ray: it takes no gradient.
    p = own(o + t[..., None] * d, hit, track)

    # Triangle record (recompute barycentrics at the known t).
    own_tri = hit & is_tri
    _, _, bu, bv = triangle_t(own(o, own_tri, track), own(d, own_tri, track),
                              g0, g1, g2, -T_MAX, T_MAX)
    bw = 1.0 - bu - bv
    s = bu + bv + bw
    renorm = torch.abs(s - 1.0) > MT_EPS
    s_safe = _where(s == 0.0, torch.ones_like(s), s)
    bu = _where(renorm, bu / s_safe, bu)
    bv = _where(renorm, bv / s_safe, bv)
    bw = _where(renorm, bw / s_safe, bw)
    tri_u = bw * uv6[..., 0] + bu * uv6[..., 2] + bv * uv6[..., 4]
    tri_v = bw * uv6[..., 1] + bu * uv6[..., 3] + bv * uv6[..., 5]
    vn_interp = (bw[..., None] * vn9[..., 0:3] + bu[..., None] * vn9[..., 3:6]
                 + bv[..., None] * vn9[..., 6:9])
    # A safe argument for the untaken branch: normalizing a primitive's
    # zero vertex normals would send a gradient 0·NaN back through sqrt(0).
    unit_z = vm.const((0.0, 0.0, 1.0), vn_interp)
    tri_n = _where(has_vn[..., None],
                   vm.safe_normalize(_where(has_vn[..., None], vn_interp,
                                            unit_z)),
                   g3)

    # Rect record.
    own_rect = hit & is_rect
    _, _, ru, rv = rect_t(own(o, own_rect, track), own(d, own_rect, track),
                          g0, g1, g2, g3, -T_MAX, T_MAX)

    # Sphere record: UV from the flipped normal; the record normal stays
    # unflipped on the far root (sphere.go:88-99 quirk).
    own_sph = hit & (kind == KIND_SPHERE)
    p_s, d_s = own(p, own_sph, track), own(d, own_sph, track)
    radius = g2[..., 0]
    center = sphere_center(g0, g1, g2[..., 1], g2[..., 2], time)
    _, _, far_root = sphere_t(o.detach(), d.detach(), center, radius, 1e-3,
                              T_MAX)
    r_safe = _where(radius == 0.0, torch.ones_like(radius), radius)
    outward = (p_s - center) / r_safe[..., None]
    flip_n = vm.dot(d_s, outward) >= 0.0
    flipped = _where(flip_n[..., None], -outward, outward)
    sph_u, sph_v = sphere_uv(flipped)
    sph_n = _where(far_root[..., None], outward, flipped)

    u = _where(is_tri, tri_u, _where(is_rect, ru, sph_u))
    v = _where(is_tri, tri_v, _where(is_rect, rv, sph_v))
    n = _where(is_tri[..., None], tri_n,
               _where(is_rect[..., None], g3, sph_n))
    n = _where(flip[..., None], -n, n)
    return Hit(t=t, u=u, v=v, p=p, normal=n, prim_idx=idx, mat_id=mat_id,
               hit=hit)
