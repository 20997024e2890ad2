"""AOV samplers: albedo, normal, wireframe.

Counterpart of `izpi_tpu/integrator/aov.py` (reference:
internal/sampler/albedo.go, normal.go, wireframe.go): first-hit queries
over a ray batch. Wireframe follows the HitEdge protocol (hitable/*.go
HitEdge and segment.Belongs, segment/segment.go:13-31): a hit whose point
lies within an angular tolerance of 0.005 of a primitive's edge paints ink,
any other hit or a miss paints paper.
"""

from __future__ import annotations

import math

import torch

from izpi_tpu_torch.core import vecmath as vm
from izpi_tpu_torch.geometry import primitives as prim
from izpi_tpu_torch.integrator import path as path_mod
from izpi_tpu_torch.materials import tables as mt


def _segment_belongs(a, b, c):
    """Point c near segment ab (segment.go:13-31): |unit(ab)×unit(ac)| <
    0.005 and the projection of ac onto ab within [0, |ab|²]."""
    ab = b - a
    ac = c - a
    cr = vm.cross(vm.normalize(ab), vm.normalize(ac))
    colinear = vm.length(cr) < 0.005
    kac = vm.dot(ab, ac)
    kab = vm.dot(ab, ab)
    return colinear & (kac >= 0) & (kac <= kab)


def sample_albedo(cs, meta, intersect, o, d, time):
    """First-hit albedo (albedo.go:31-36). Dielectrics report (1, 1, 1)
    (dielectric.go:224); misses are black."""
    rec = intersect(o, d, time, path_mod.T_MIN, prim.T_MAX)
    mat = path_mod._gather_mat(cs, rec.mat_id)
    albedo = path_mod._eval_tex(cs, meta, mat["tex_albedo"], rec.u, rec.v,
                                rec.p)
    albedo = torch.where((mat["kind"] == mt.MAT_DIELECTRIC)[:, None],
                         torch.ones_like(albedo), albedo)
    return torch.where(rec.hit[:, None], albedo, torch.zeros_like(albedo))


def sample_normal(cs, meta, intersect, o, d, time):
    """First-hit record normal (normal.go:28-33), with the PBR triangle
    normal-map step the reference applies inside triangle.Hit."""
    rec = intersect(o, d, time, path_mod.T_MIN, prim.T_MAX)
    n = rec.normal
    if meta.has_pbr:
        mat = path_mod._gather_mat(cs, rec.mat_id)
        nm_rgb = path_mod._eval_tex(cs, meta, mat["tex_normal"], rec.u, rec.v,
                                    rec.p)
        n, _, _ = path_mod._pbr_normals(cs, mat, rec, nm_rgb)
    return torch.where(rec.hit[:, None], n, torch.zeros_like(n))


def sample_wireframe(cs, meta, intersect, o, d, time, ink, paper):
    """Edge AOV (wireframe.go:34-40 and each hitable's HitEdge)."""
    rec = intersect(o, d, time, path_mod.T_MIN, prim.T_MAX)
    pidx = torch.clamp(rec.prim_idx, min=0)
    kind = cs.prims.kind[pidx]
    g0, g1, g2 = cs.prims.g0[pidx], cs.prims.g1[pidx], cs.prims.g2[pidx]
    c = rec.p

    # Triangle edges (triangle.go HitEdge): v0-v1, v1-v2, v2-v0.
    v0, v1, v2 = g0, g0 + g1, g0 + g2
    tri_edge = (_segment_belongs(v0, v1, c) | _segment_belongs(v1, v2, c)
                | _segment_belongs(v2, v0, c))

    # Rect edges (xzrect.go HitEdge): the four sides.
    r00, r10, r11, r01 = g0, g0 + g1, g0 + g1 + g2, g0 + g2
    rect_edge = (_segment_belongs(r00, r10, c) | _segment_belongs(r10, r11, c)
                 | _segment_belongs(r11, r01, c)
                 | _segment_belongs(r01, r00, c))

    # Sphere silhouette (sphere.go HitEdge): the angle between (p - o) and
    # (p - center) within π/2 + 0.1.
    center = prim.sphere_center(g0, g1, g2[:, 1], g2[:, 2], time)
    a = rec.p - o
    b = rec.p - center
    denom = vm.length(a) * vm.length(b)
    cosang = vm.dot(a, b) / torch.where(denom == 0.0, torch.ones_like(denom),
                                        denom)
    theta = torch.arccos(torch.clamp(cosang, -1.0, 1.0))
    sph_edge = torch.abs(theta) <= (math.pi / 2.0 + 0.1)

    edge = torch.where(kind == prim.KIND_TRIANGLE, tri_edge,
                       torch.where(kind == prim.KIND_RECT, rect_edge,
                                   sph_edge))
    ink_v = o.new_tensor(ink)
    paper_v = o.new_tensor(paper)
    return torch.where((rec.hit & edge)[:, None], ink_v[None, :],
                       paper_v[None, :])
