"""Path-tracing estimator core + the lockstep reference integrator.

Counterpart of `izpi_tpu/integrator/path.py`: `RenderSettings`, `bounce_rgb`
(:405-541) and `bounce_spectral` (:544-682) without the media and PBR
branches, `_dielectric_scatter` (:147) and `trace` (:685), the lockstep
oracle.

Estimator identity with the reference (colour.go:44-57):
    L = Σ_k T_k·emitted_k (+ T·background on miss, + T·(0,0,1) at depth cap)
    T_{k+1} = T_k · attenuation · ScatteringPDF / pdfValue   (diffuse)
    T_{k+1} = T_k · attenuation                              (specular)
A zero pdf divides into Inf/NaN that the caller's per-sample DeNAN zeroes,
as the Go chain does (vec3.DeNAN at render/rgb.go:36). Quirks kept: the
depth-cap sentinel {Z:1}, the book's 2·sqrt(r2) cosine factor, one-sided
lights keyed on the record normal, unnormalized scattered directions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from izpi_tpu_torch.core import rng, sampling
from izpi_tpu_torch.core import vecmath as vm
from izpi_tpu_torch.geometry import primitives as prim
from izpi_tpu_torch.integrator import lights as lights_mod
from izpi_tpu_torch.materials import spectral_eval
from izpi_tpu_torch.materials import tables as mt
from izpi_tpu_torch.spectral import spd as spd_mod
from izpi_tpu_torch.texture import tables as tex_tables

T_MIN = 1e-3  # world-hit epsilon (colour.go:40)
PARK = 3e30   # dead-slot origin: far outside every scene, so it misses


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static integrator configuration (render.New, renderer.go:73)."""

    max_depth: int = 50
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    exact_book_cosine: bool = True


def intersect_scene(cs, o, d, time, t_min, t_max) -> prim.Hit:
    """Closest hit against the compiled scene's primitives (brute force)."""
    return prim.intersect_brute(cs.prims, o, d, time, t_min, t_max)


def _gather_mat(cs, mat_id):
    """The rows `mat_id` (-1 reads row 0) of every material column."""
    safe = torch.clamp(mat_id, min=0)
    return {f: getattr(cs.materials, f)[safe]
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


def bounce_rgb(cs, meta, settings, o, d, time, keys, depth, thru, rad, active):
    """Advance every live RGB path one bounce (per-ray depth (N,)).
    Returns (o, d, thru, rad, active, n_rays_this_bounce)."""
    bg = o.new_tensor(settings.background)
    zero = torch.zeros((), dtype=o.dtype, device=o.device)

    # Dead slots keep their last ray; park them outside the scene so they
    # miss. Every output of theirs is masked by `active` below.
    o = torch.where(active[:, None], o, torch.full_like(o, PARK))
    rec = intersect_scene(cs, o, d, time, T_MIN, prim.T_MAX)
    nrays = active.sum()

    miss = active & ~rec.hit
    rad = rad + torch.where(miss[:, None], thru * bg[None, :], zero)
    active = active & rec.hit

    mat = _gather_mat(cs, rec.mat_id)
    kind = mat["kind"]
    albedo = tex_tables.eval_rgb(cs.textures, mat["tex_albedo"], rec.p,
                                 has_checker=meta.has_checker)
    facing = vm.dot(rec.normal, d) < 0.0
    is_light = kind == mt.MAT_DIFFUSE_LIGHT
    emitted = torch.where((is_light & facing)[:, None], albedo, zero)
    rad = rad + torch.where(active[:, None], thru * emitted, zero)
    active = active & ~is_light

    us = rng.bounce_uniforms_perray(keys, depth, 12)

    is_metal = kind == mt.MAT_METAL
    is_diel = kind == mt.MAT_DIELECTRIC

    # ---- metal (metal.go:34-40): unit-direction mirror + fuzz ----
    refl_unit = vm.reflect(vm.normalize(d), rec.normal)
    fuzz_vec = sampling.random_in_unit_sphere(us[:, 0], us[:, 1], us[:, 2])
    d_metal = refl_unit + mat["fuzz"][:, None] * fuzz_vec

    # ---- dielectric ----
    d_diel, is_refl = _dielectric_scatter(d, rec.normal, mat["ref_idx"],
                                          us[:, 3])
    diel_att = torch.ones_like(o)
    if meta.has_absorbing_dielectric:
        # Beer–Lambert with exit re-trace (dielectric.go:118-153), only for
        # rays that refracted into an absorbing dielectric.
        apply = active & is_diel & mat["has_absorption"] & ~is_refl
        start = rec.p + 1e-3 * d_diel
        if bool(apply.any()):
            exit_rec = intersect_scene(cs, start, d_diel, time, 0.0, 1000.0)
            exit_p, exit_hit = exit_rec.p, exit_rec.hit
        else:
            exit_p, exit_hit = start, torch.zeros_like(apply)
        path_len = vm.length(exit_p - rec.p)
        path_len = torch.clamp(path_len, 0.1, 100.0)
        path_len = torch.where(exit_hit, path_len,
                               torch.full_like(path_len, 10.0))
        absorbed = torch.exp(-mat["absorption"] * path_len[:, None])
        diel_att = torch.where(apply[:, None], absorbed, diel_att)

    # ---- diffuse: mixture of light PDF and cosine PDF (colour.go:48-57) ----
    choose_light = us[:, 4] < 0.5  # mixture.go:27
    d_light = lights_mod.sample(cs.lights, rec.p, us[:, 5:9])
    d_cos = sampling.cosine_pdf_generate(rec.normal, us[:, 9], us[:, 10],
                                         settings.exact_book_cosine)
    d_diff = torch.where(choose_light[:, None], d_light, d_cos)
    pdf_val = (0.5 * lights_mod.pdf_value(cs.lights, rec.p, d_diff)
               + 0.5 * sampling.cosine_pdf_value(rec.normal, d_diff))

    cos_out = vm.dot(rec.normal, vm.normalize(d_diff))
    spdf_cos = torch.clamp(cos_out, min=0.0) / math.pi
    spdf = torch.where(kind == mt.MAT_LAMBERT, spdf_cos, zero)
    diff_mult = albedo * (spdf / pdf_val)[:, None]

    # ---- combine ----
    d_new = torch.where(is_metal[:, None], d_metal,
                        torch.where(is_diel[:, None], d_diel, d_diff))
    mult = torch.where(is_metal[:, None], albedo,
                       torch.where(is_diel[:, None], diel_att, diff_mult))

    thru = torch.where(active[:, None], thru * mult, thru)
    o = torch.where(active[:, None], rec.p, o)
    d = torch.where(active[:, None], d_new, d)
    return o, d, thru, rad, active, nrays


def bounce_spectral(cs, meta, settings, o, d, time, lam, keys, depth, thru,
                    rad, active, bg_spd_id: int):
    """Advance every live spectral path one bounce (sampler/spectral.go:
    47-80). thru and rad are scalars per ray (N,) at the ray's wavelength
    lam (N,). Returns (o, d, thru, rad, active, n_rays_this_bounce, bg_val),
    bg_val being the background SPD at lam, which the scheduler adds at the
    depth cap.

    As in the JAX package: η(λ) gives dispersion, spectral absorption is
    Beer–Lambert over an exit re-trace, a metal terminates (its
    SpectralScatter is the non-spectral stub), lights are one-sided, a zero
    mixture pdf zeroes the diffuse weight, and `thru * 0` is added on every
    active non-emitting hit so a non-finite throughput poisons the sample."""
    zero = torch.zeros((), dtype=o.dtype, device=o.device)

    o = torch.where(active[:, None], o, torch.full_like(o, PARK))
    rec = intersect_scene(cs, o, d, time, T_MIN, prim.T_MAX)
    nrays = active.sum()

    bg_val = spd_mod.device_spd_value(
        cs.spd_table, torch.full_like(rec.mat_id, bg_spd_id), lam)
    miss = active & ~rec.hit
    rad = rad + torch.where(miss, thru * bg_val, zero)
    active = active & rec.hit

    mat = _gather_mat(cs, rec.mat_id)
    kind = mat["kind"]
    rgb = tex_tables.eval_rgb(cs.textures, mat["tex_albedo"], rec.p,
                              has_checker=meta.has_checker)
    luma = spectral_eval.luminance(rgb)
    spec_a = spectral_eval.spectral_value(
        cs.spd_table, mat["spec_albedo_id"], mat["spec_albedo_gauss"], lam,
        luma)
    # Spectral checker: the 3D sine pattern picks the odd or even branch
    # (spectral_checker.go:33-40).
    spec_b = spectral_eval.spectral_value(
        cs.spd_table, mat["spec_albedo_id2"], mat["spec_albedo_gauss2"], lam,
        luma)
    sines = (torch.sin(10.0 * rec.p[:, 0]) * torch.sin(10.0 * rec.p[:, 1])
             * torch.sin(10.0 * rec.p[:, 2]))
    spec_val = torch.where(mat["spec_checker"] & (sines >= 0.0), spec_b,
                           spec_a)

    facing = vm.dot(rec.normal, d) < 0.0
    is_light = kind == mt.MAT_DIFFUSE_LIGHT
    emitted = torch.where(is_light & facing, spec_val, zero)
    rad = rad + torch.where(active, thru * emitted, zero)
    is_metal = kind == mt.MAT_METAL
    active = active & ~is_light & ~is_metal

    us = rng.bounce_uniforms_perray(keys, depth, 12)

    # Dielectric with η(λ): dispersion (dielectric.go:186).
    eta = torch.where(
        mat["spec_ref_idx_id"] >= 0,
        spd_mod.device_spd_value(cs.spd_table,
                                 torch.clamp(mat["spec_ref_idx_id"], min=0),
                                 lam),
        mat["ref_idx"])
    is_diel = kind == mt.MAT_DIELECTRIC
    d_diel, is_refl = _dielectric_scatter(d, rec.normal, eta, us[:, 3])
    diel_att = torch.ones_like(thru)
    if meta.has_absorbing_dielectric:
        # Spectral Beer–Lambert over the exit re-trace (dielectric.go:
        # 104-115, 190-199), only for rays that refracted into an absorbing
        # dielectric.
        apply = active & is_diel & (mat["spec_absorb_id"] >= 0) & ~is_refl
        start = rec.p + 1e-3 * d_diel
        if bool(apply.any()):
            exit_rec = intersect_scene(cs, start, d_diel, time, 0.0, 1000.0)
            exit_p, exit_hit = exit_rec.p, exit_rec.hit
        else:
            exit_p, exit_hit = start, torch.zeros_like(apply)
        path_len = torch.clamp(vm.length(exit_p - rec.p), 0.1, 100.0)
        path_len = torch.where(exit_hit, path_len,
                               torch.full_like(path_len, 10.0))
        alpha = spd_mod.device_spd_value(
            cs.spd_table, torch.clamp(mat["spec_absorb_id"], min=0), lam)
        diel_att = torch.where(apply, torch.exp(-alpha * path_len), diel_att)

    # Diffuse: the NEE mixture at λ (spectral.go:61-76).
    choose_light = us[:, 4] < 0.5
    d_light = lights_mod.sample(cs.lights, rec.p, us[:, 5:9])
    d_cos = sampling.cosine_pdf_generate(rec.normal, us[:, 9], us[:, 10],
                                         settings.exact_book_cosine)
    d_diff = torch.where(choose_light[:, None], d_light, d_cos)
    pdf_val = (0.5 * lights_mod.pdf_value(cs.lights, rec.p, d_diff)
               + 0.5 * sampling.cosine_pdf_value(rec.normal, d_diff))
    cos_out = vm.dot(rec.normal, vm.normalize(d_diff))
    spdf_cos = torch.clamp(cos_out, min=0.0) / math.pi
    spdf = torch.where(kind == mt.MAT_LAMBERT, spdf_cos, zero)
    # A zero pdf divides to NaN in the reference's spectral sampler, which
    # has no per-sample DeNAN; the JAX package zeroes the weight instead.
    diff_mult = spec_val * torch.where(pdf_val > 0.0, spdf / pdf_val, zero)

    d_new = torch.where(is_diel[:, None], d_diel, d_diff)
    mult = torch.where(is_diel, diel_att, diff_mult)

    thru = torch.where(active, thru * mult, thru)
    o = torch.where(active[:, None], rec.p, o)
    d = torch.where(active[:, None], d_new, d)
    return o, d, thru, rad, active, nrays, bg_val


def trace(cs, meta, settings: RenderSettings, o, d, time, keys):
    """Trace a ray batch to completion (lockstep; the correctness oracle).

    o, d: (N,3); time: (N,); keys: (N,2) per-path keys. Returns (color (N,3),
    NOT DeNAN'd — the caller applies it per render/rgb.go:36 — and the total
    ray count as a 0-dim int64 tensor)."""
    n = o.shape[0]
    thru = torch.ones_like(o)
    rad = torch.zeros_like(o)
    active = torch.ones(n, dtype=torch.bool, device=o.device)
    nrays = torch.zeros((), dtype=torch.int64, device=o.device)
    for depth in range(settings.max_depth):
        if not bool(active.any()):
            break
        depth_vec = torch.full((n,), depth, dtype=torch.int64, device=o.device)
        o, d, thru, rad, active, nr = bounce_rgb(
            cs, meta, settings, o, d, time, keys, depth_vec, thru, rad, active)
        nrays = nrays + nr
    # Depth cap: the next Sample call would return {Z:1} (colour.go:34-36).
    sentinel = o.new_tensor([0.0, 0.0, 1.0])
    rad = rad + torch.where(active[:, None], thru * sentinel[None, :],
                            torch.zeros((), dtype=o.dtype, device=o.device))
    return rad, nrays
