"""Path-tracing estimator core: the part of the port's plain RGB bounce
(`izpi_tpu_torch/integrator/path.py` `bounce_rgb`) that the benchmark's
scenes reach: Lambertian, metal, dielectric and diffuse-light materials
with constant textures, no media, no PBR and no absorbing glass
(`h100bench.reference.tracer` drives the bounces). The bounce takes the
scene's intersector, `intersect(o, d, time, t_min, t_max) -> Hit`.

Estimator identity with the reference (colour.go:44-57):
    L = Σ_k T_k·emitted_k (+ T·background on miss, + T·(0,0,1) at depth cap)
    T_{k+1} = T_k · attenuation · ScatteringPDF / pdfValue   (diffuse)
    T_{k+1} = T_k · attenuation                              (specular)
A zero pdf divides into Inf/NaN that the caller's per-sample DeNAN zeroes,
as the Go chain does (vec3.DeNAN at render/rgb.go:36). Quirks kept: the
depth-cap sentinel {Z:1}, the book's 2·sqrt(r2) cosine factor, one-sided
lights keyed on the record normal and unnormalized scattered directions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from h100bench.reference.plain.core import rng, sampling
from h100bench.reference.plain.core import vecmath as vm
from h100bench.reference.plain.geometry import primitives as prim
from h100bench.reference.plain.integrator import lights as lights_mod
from h100bench.reference.plain.materials import tables as mt
from h100bench.reference.plain.ops import table_grad
from h100bench.reference.plain.texture import tables as tex_tables

T_MIN = 1e-3  # world-hit epsilon (colour.go:40)
PARK = 3e30   # dead-slot origin: far outside every scene, so it misses


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static integrator configuration (render.New, renderer.go:73)."""

    max_depth: int = 50
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    exact_book_cosine: bool = True


def _gather_mat(cs, mat_id):
    """The rows `mat_id` (-1 reads row 0) of every material column (a
    trainable column through `table_grad.gather`)."""
    safe = torch.clamp(mat_id, min=0)
    return {f: table_grad.gather(getattr(cs.materials, f), safe)
            for f in mt.Materials._fields}


def _dielectric_scatter(o_dir, normal, ref_idx, u_reflect):
    """Schlick-probabilistic reflect/refract on the RAW incoming direction
    (dielectric.go:66-102). Returns (new_dir, is_reflected)."""
    reflected = vm.reflect(o_dir, normal)
    d_dot_n = vm.dot(o_dir, normal)
    exiting = d_dot_n > 0.0
    outward = torch.where(exiting[..., None], -normal, normal)
    ni_over_nt = torch.where(exiting, ref_idx, 1.0 / ref_idx)
    dlen = vm.length(o_dir)
    cosine = torch.where(exiting, ref_idx * d_dot_n / dlen, -d_dot_n / dlen)
    refracted, can_refract = vm.refract(o_dir, outward, ni_over_nt)
    reflect_prob = torch.where(can_refract, vm.schlick(cosine, ref_idx),
                               torch.ones_like(cosine))
    is_reflected = u_reflect < reflect_prob
    new_dir = torch.where(is_reflected[..., None], reflected, refracted)
    return new_dir, is_reflected


def bounce_rgb(cs, meta, settings, intersect, o, d, time, keys, depth, thru,
               rad, active, differentiable: bool = False,
               record: Optional[dict] = None):
    """Advance every live RGB path one bounce (per-ray depth (N,)).
    Returns (o, d, thru, rad, active, n_rays_this_bounce).

    differentiable=True detaches the NEE mixture's direction and pdf and
    zeroes a sample whose ratio is not finite instead of carrying the Inf.
    It also keeps every gradient finite: each lobe sees only its own rays'
    gradient (`primitives.own`, as the intersectors' records do), a
    degenerate NEE direction is zeroed before its cosine, and the ratio
    divides by a safe pdf where the pdf is 0. No forward value changes.

    `record`, a dict, receives the bounce's hit record ("rec"), material
    rows ("mat"), whether each hit faces its normal ("facing") and the
    diffuse lobe's ratio ("ratio")."""
    bg = vm.const(settings.background, o)
    zero = torch.zeros((), dtype=o.dtype, device=o.device)

    # Dead slots keep their last ray; the intersector sees them parked
    # outside the scene, so they miss. Every output of theirs is masked by
    # `active` below, so a bounce of dead paths changes nothing.
    o_live = torch.where(active[:, None], o, torch.full_like(o, PARK))
    rec = intersect(o_live, d, time, T_MIN, prim.T_MAX)
    nrays = active.sum()

    miss = active & ~rec.hit
    rad = rad + torch.where(miss[:, None], thru * bg[None, :], zero)
    active = active & rec.hit

    mat = _gather_mat(cs, rec.mat_id)
    kind = mat["kind"]
    albedo = tex_tables.eval_rgb(cs.textures, mat["tex_albedo"])
    facing = vm.dot(rec.normal, d) < 0.0
    is_light = kind == mt.MAT_DIFFUSE_LIGHT
    emitted = torch.where((is_light & facing)[:, None], albedo, zero)
    rad = rad + torch.where(active[:, None], thru * emitted, zero)
    active = active & ~is_light

    us = rng.bounce_uniforms_perray(keys, depth, 12)

    is_metal = kind == mt.MAT_METAL
    is_diel = kind == mt.MAT_DIELECTRIC

    # Each lobe computes on every ray; a differentiable bounce feeds each
    # only its own rays' gradient (`primitives.own`).
    def own(x, mask):
        return prim.own(x, mask, differentiable)

    # ---- metal (metal.go:34-40): unit-direction mirror + fuzz ----
    refl_unit = vm.reflect(vm.normalize(own(d, is_metal)),
                           own(rec.normal, is_metal))
    fuzz_vec = sampling.random_in_unit_sphere(us[:, 0], us[:, 1], us[:, 2])
    d_metal = refl_unit + mat["fuzz"][:, None] * fuzz_vec

    # ---- dielectric ----
    d_diel, is_refl = _dielectric_scatter(own(d, is_diel),
                                          own(rec.normal, is_diel),
                                          mat["ref_idx"], us[:, 3])
    diel_att = torch.ones_like(o)
    cos_axis = spdf_axis = rec.normal
    diffuse_like = kind == mt.MAT_LAMBERT

    # ---- diffuse: mixture of light PDF and cosine PDF (colour.go:48-57) ----
    choose_light = us[:, 4] < 0.5  # mixture.go:27
    d_light = lights_mod.sample(cs.lights, rec.p, us[:, 5:9])
    d_cos = sampling.cosine_pdf_generate(cos_axis, us[:, 9], us[:, 10],
                                         settings.exact_book_cosine)
    d_diff = torch.where(choose_light[:, None], d_light, d_cos)
    pdf_val = (0.5 * lights_mod.pdf_value(cs.lights, rec.p, d_diff)
               + 0.5 * sampling.cosine_pdf_value(cos_axis, d_diff))
    if differentiable:
        d_diff, pdf_val = d_diff.detach(), pdf_val.detach()
    d_unit = vm.normalize(d_diff)
    if differentiable:
        # A degenerate direction normalizes to NaN, and its product with the
        # axis would send the axis 0·NaN; its sample weighs 0 below anyway.
        d_unit = torch.where(torch.isfinite(d_unit), d_unit, zero)

    cos_out = vm.dot(spdf_axis, d_unit)
    spdf_cos = torch.clamp(cos_out, min=0.0) / math.pi
    spdf = torch.where(diffuse_like, spdf_cos, zero)
    if differentiable:
        # A single Inf would poison every gradient: a dead sample weighs 0.
        live = pdf_val > 0.0
        ratio = spdf / torch.where(live, pdf_val, torch.ones_like(pdf_val))
        ratio = torch.where(live & torch.isfinite(ratio), ratio, zero)
    else:
        ratio = spdf / pdf_val
    diff_mult = albedo * ratio[:, None]

    # ---- combine ----
    d_new = torch.where(is_metal[:, None], d_metal,
                        torch.where(is_diel[:, None], d_diel, d_diff))
    mult = torch.where(is_metal[:, None], albedo,
                       torch.where(is_diel[:, None], diel_att, diff_mult))

    if record is not None:
        record.update(rec=rec, mat=mat, facing=facing, ratio=ratio)
    thru = torch.where(active[:, None], thru * mult, thru)
    o = torch.where(active[:, None], rec.p, o)
    d = torch.where(active[:, None], d_new, d)
    return o, d, thru, rad, active, nrays
