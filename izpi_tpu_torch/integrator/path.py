"""Path-tracing estimator core + the lockstep reference integrator.

Counterpart of `izpi_tpu/integrator/path.py`: `RenderSettings`,
`make_brute_intersector` (:64), `bounce_rgb` (:405-541) and
`bounce_spectral` (:544-682) with the participating media (`_apply_media`,
:167), image and noise textures (`_eval_tex`, :251), the isotropic phase
material, the RGB-to-spectral uplift and image emission (the sky dome),
`_dielectric_scatter` (:147), the PBR helpers `_eval_pbr_texs` (:264, the
combined map stack and the generic four-lookup path), `_pbr_normals` (:336)
and `_pbr_lobes` (:384), and `trace` (:685), the lockstep oracle, with the
JAX package's `differentiable=True` (see `trace`). Each takes the scene's
intersector, `intersect(o, d, time, t_min, t_max) -> Hit`, as the JAX
functions do: brute force (`make_brute_intersector`), the plain
BVH4 traversal (`accel.traverse`) or the CUDA traversal kernel
(`ops.bvh_kernel`).

Estimator identity with the reference (colour.go:44-57):
    L = Σ_k T_k·emitted_k (+ T·background on miss, + T·(0,0,1) at depth cap)
    T_{k+1} = T_k · attenuation · ScatteringPDF / pdfValue   (diffuse)
    T_{k+1} = T_k · attenuation                              (specular)
A zero pdf divides into Inf/NaN that the caller's per-sample DeNAN zeroes,
as the Go chain does (vec3.DeNAN at render/rgb.go:36). Quirks kept: the
depth-cap sentinel {Z:1}, the book's 2·sqrt(r2) cosine factor, one-sided
lights keyed on the record normal, unnormalized scattered directions,
isotropic's ScatteringPDF() == 0 (isotropic.go:54: a medium hit scatters
along the NEE mixture's direction with weight 0), and PBR's double normal
mapping (the triangle TBN map of triangle.go:234-248, then the ad-hoc
tangent frame of pbr.go:65-91 again with z left unremapped),
fresnel = 0.04+0.96(1-cosθ)^5 + 0.5·metalness with P(spec) =
fresnel·(1-rough) (pbr.go:123-137), the cosine mixture PDF on the
PBR-mapped normal but ScatteringPDF on the record normal (pbr.go:150,249),
and the spectral specular lobe's ×1.5 albedo boost (pbr.go:253-259).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch
import torch.utils.checkpoint

from izpi_tpu_torch.core import loops, rng, sampling
from izpi_tpu_torch.core import vecmath as vm
from izpi_tpu_torch.geometry import primitives as prim
from izpi_tpu_torch.integrator import lights as lights_mod
from izpi_tpu_torch.materials import spectral_eval
from izpi_tpu_torch.materials import tables as mt
from izpi_tpu_torch.ops import table_grad
from izpi_tpu_torch.spectral import spd as spd_mod
from izpi_tpu_torch.texture import tables as tex_tables
from izpi_tpu_torch.texture import uplift as uplift_mod

T_MIN = 1e-3  # world-hit epsilon (colour.go:40)
PARK = 3e30   # dead-slot origin: far outside every scene, so it misses
# Salt of the media's free-flight draws (izpi_tpu/integrator/path.py:181).
MEDIA_SALT = 0x4D45
# Bounces of `trace` between two tests of its live flags. Uncaptured, a
# bounce is host-bound, so a test's sync waits for little, while a chunk's
# overrun runs whole bounces of dead paths: 8 against 1 measured 0.986x
# and 1.048x the seconds (PERF.md, `measure_port.py --trace-loop`).
TRACE_CHUNK = 1


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static integrator configuration (render.New, renderer.go:73)."""

    max_depth: int = 50
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    exact_book_cosine: bool = True


IntersectFn = Callable[..., prim.Hit]


def make_brute_intersector(cs) -> IntersectFn:
    """Closest hit against every primitive of the compiled scene."""

    def intersect(o, d, time, t_min, t_max):
        return prim.intersect_brute(cs.prims, o, d, time, t_min, t_max)

    intersect.brute_cs = cs  # the scene it scans (ops.diff_trace reads it)
    return intersect


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


def _rot(rot, x):
    """rot @ x per row, the 3×3 product written out: (N, 3) -> (N, 3)."""
    return torch.stack([x[:, 0] * rot[i, 0] + x[:, 1] * rot[i, 1]
                        + x[:, 2] * rot[i, 2] for i in range(3)], dim=-1)


def _apply_media(cs, meta, rec, o, d, keys, depth):
    """Stochastic participating-media hits (constant_medium.go:36-66).

    For each medium: the boundary's entry/exit span along the ray, an
    exponential free-flight distance -ln(U)/ρ, and, when it lands inside
    the span before the closest surface, the medium takes the closest hit
    with the arbitrary record normal (1, 0, 0) and its Isotropic phase
    material. As in the JAX package, the span is min(exit, closest), not
    the reference's `rec2t = tMax` clamp (constant_medium.go:46-48, an
    inverted comparison that extends every medium behind its boundary)."""
    md = cs.media
    u_med = rng.bounce_uniforms_perray(keys, depth, meta.n_media,
                                       salt=MEDIA_SALT)
    d_len = vm.length(d)
    cur_t = torch.where(rec.hit, rec.t, torch.full_like(rec.t, prim.T_MAX))
    t, hit, mat_id, normal = rec.t, rec.hit, rec.mat_id, rec.normal
    p, u, v, prim_idx = rec.p, rec.u, rec.v, rec.prim_idx
    zero = torch.zeros((), dtype=o.dtype, device=o.device)
    x_axis = vm.const((1.0, 0.0, 0.0), o)
    for m in range(meta.n_media):
        rot = md.rot_w2o[m]
        o_obj = _rot(rot, o - md.trans[m][None, :])
        d_obj = _rot(rot, d)
        if meta.media_is_sphere[m]:
            oc = o_obj - md.p0[m][None, :]
            radius = md.p1[m][0]
            a = vm.dot(d_obj, d_obj)
            bq = vm.dot(oc, d_obj)
            c = vm.dot(oc, oc) - radius * radius
            disc = bq * bq - a * c
            ok = disc > 0.0
            sq = torch.sqrt(torch.clamp(disc, min=0.0))
            a_safe = torch.where(a == 0.0, torch.ones_like(a), a)
            t1 = (-bq - sq) / a_safe
            t2 = (-bq + sq) / a_safe
        else:
            inv = 1.0 / d_obj
            ta = (md.p0[m][None, :] - o_obj) * inv
            tb = (md.p1[m][None, :] - o_obj) * inv
            t1 = torch.amax(torch.minimum(ta, tb), dim=-1)
            t2 = torch.amin(torch.maximum(ta, tb), dim=-1)
            ok = t2 > t1
        rec1t = torch.maximum(t1, torch.full_like(t1, T_MIN))
        rec2t = torch.minimum(t2, cur_t)
        ok = ok & (rec1t < rec2t)
        rec1t = torch.maximum(rec1t, zero)
        dist_inside = (rec2t - rec1t) * d_len
        hit_dist = -(1.0 / md.density[m]) * torch.log(
            torch.clamp(u_med[:, m], min=1e-12))
        t_med = rec1t + hit_dist / d_len
        better = ok & (hit_dist < dist_inside) & (t_med < cur_t)

        t = torch.where(better, t_med, t)
        cur_t = torch.minimum(cur_t, torch.where(better, t_med, cur_t))
        hit = hit | better
        mat_id = torch.where(better, md.mat_id[m].to(mat_id.dtype), mat_id)
        normal = torch.where(better[:, None], x_axis, normal)
        p = torch.where(better[:, None], o + t_med[:, None] * d, p)
        u = torch.where(better, zero, u)
        v = torch.where(better, zero, v)
        prim_idx = torch.where(better, torch.full_like(prim_idx, -1), prim_idx)
    return prim.Hit(t=t, u=u, v=v, p=p, normal=normal, prim_idx=prim_idx,
                    mat_id=mat_id, hit=hit)


def _eval_tex(cs, meta, tex_id, u, v, p):
    return tex_tables.eval_rgb(cs.textures, tex_id, u, v, p,
                               has_checker=meta.has_checker,
                               has_image=meta.has_image,
                               has_noise=meta.has_noise,
                               shard_group=meta.tex_shard_group)


def _mean3(rgb):
    return (rgb[..., 0] + rgb[..., 1] + rgb[..., 2]) / 3.0


def _eval_pbr_texs(cs, meta, mat, rec, differentiable: bool = False):
    """The four per-bounce material texture lookups (albedo, normal map,
    roughness, metalness). Returns (albedo (N, 3), normal_rgb (N, 3), rough
    (N,), metal (N,)), roughness and metalness mean3'd (pbr.go:109-116; the
    combined stack stores the per-texel mean, the same value).

    A scene whose compile baked a combined map stack reads each material's
    image maps from its row there, one gather per ray, and its other slots
    from the generic evaluator without images (path.py:293-333); a scene
    without one, or a differentiable bounce, evaluates the four slots over
    4N ids (path.py:284-291): the image stack is a trainable parameter, and
    the combined stack baked from it carries no gradient. A stack sharded
    over `meta.tex_shard_group` is read through `tex_tables.sharded_rows`."""
    n = rec.p.shape[0]
    tex = cs.textures
    if differentiable or tex.combined.shape[0] == 0:
        tids = torch.cat([mat["tex_albedo"], mat["tex_normal"],
                          mat["tex_rough"], mat["tex_metal"]])
        tex4 = _eval_tex(cs, meta, tids, rec.u.repeat(4), rec.v.repeat(4),
                         rec.p.repeat(4, 1)).reshape(4, n, 3)
        return tex4[0], tex4[1], _mean3(tex4[2]), _mean3(tex4[3])

    combo = mat["combo_id"]
    valid = combo >= 0
    safe = torch.clamp(combo, min=0).long()
    w, h = tex.combo_w[safe], tex.combo_h[safe]
    i = tex_tables.texel_index(rec.u * w.float(), w)
    j = tex_tables.texel_index((1.0 - rec.v) * (h.float() - 0.001), h)
    if meta.tex_shard_group is None:
        row = tex.combined[safe, j.long(), i.long()]  # (N, 8): one gather
    else:
        # The rank's slice of a sharded stack, merged by one all-reduce
        # (path.py:306-311).
        row = tex_tables.sharded_rows(
            tex.combined, tex.combo_base, torch.where(valid, safe, -1),
            lambda loc: tex.combined[loc, j.long(), i.long()],
            meta.tex_shard_group)

    def gen(tid):
        return tex_tables.eval_rgb(tex, tid, rec.u, rec.v, rec.p,
                                   has_checker=meta.has_checker,
                                   has_image=False, has_noise=meta.has_noise)

    def is_img(tid):
        return valid & (tid >= 0) & (
            tex.kind[torch.clamp(tid, min=0)] == tex_tables.TEX_IMAGE)

    albedo = torch.where(is_img(mat["tex_albedo"])[:, None], row[:, 0:3],
                         gen(mat["tex_albedo"]))
    nm_rgb = torch.where(is_img(mat["tex_normal"])[:, None], row[:, 3:6],
                         gen(mat["tex_normal"]))
    rough = torch.where(is_img(mat["tex_rough"]), row[:, 6],
                        _mean3(gen(mat["tex_rough"])))
    metal = torch.where(is_img(mat["tex_metal"]), row[:, 7],
                        _mean3(gen(mat["tex_metal"])))
    return albedo, nm_rgb, rough, metal


def _pbr_normals(cs, mat, rec, nm_rgb):
    """The two normals PBR uses: rec_n, the record normal after the
    triangle-TBN normal-map step of triangle.Hit (triangles only), and
    pbr_n, rec_n pushed through the ad-hoc tangent frame again
    (pbr.go:65-91; z is not remapped there). Returns (rec_n, pbr_n,
    is_pbr)."""
    is_pbr = mat["kind"] == mt.MAT_PBR
    has_nm = mat["tex_normal"] >= 0

    pidx = torch.clamp(rec.prim_idx, min=0)
    prim_kind = cs.prims.kind[pidx]
    tb = cs.prims.tb[pidx]
    tangent = tb[:, 0:3]
    bitangent = tb[:, 3:6]

    # Triangle TBN map: all three components remapped (triangle.go:240-248).
    t_n = 2.0 * nm_rgb - 1.0
    mapped = vm.safe_normalize(tangent * t_n[:, 0:1] + bitangent * t_n[:, 1:2]
                               + rec.normal * t_n[:, 2:3])
    use_tbn = is_pbr & has_nm & (prim_kind == prim.KIND_TRIANGLE)
    rec_n = torch.where(use_tbn[:, None], mapped, rec.normal)

    # Ad-hoc frame (pbr.go:73-91): t = n×(0,1,0) (or n×(1,0,0) when
    # degenerate), b = n×t; z component NOT remapped.
    up = vm.const((0.0, 1.0, 0.0), rec_n).expand_as(rec_n)
    right = vm.const((1.0, 0.0, 0.0), rec_n).expand_as(rec_n)
    t_ad = vm.cross(rec_n, up)
    degenerate = vm.dot(t_ad, t_ad) < 0.001
    t_ad = torch.where(degenerate[:, None], vm.cross(rec_n, right), t_ad)
    t_ad = vm.safe_normalize(t_ad)
    b_ad = vm.safe_normalize(vm.cross(rec_n, t_ad))
    t_n2 = torch.stack([2.0 * nm_rgb[:, 0] - 1.0, 2.0 * nm_rgb[:, 1] - 1.0,
                        nm_rgb[:, 2]], dim=-1)
    pbr_mapped = vm.safe_normalize(t_ad * t_n2[:, 0:1] + b_ad * t_n2[:, 1:2]
                                   + rec_n * t_n2[:, 2:3])
    pbr_n = torch.where((is_pbr & has_nm)[:, None], pbr_mapped, rec_n)
    return rec_n, pbr_n, is_pbr


def _pbr_lobes(mat, d, pbr_n, us, rough_val, metal_val):
    """PBR's stochastic lobe choice (pbr.go:94-145) from the mean3'd
    roughness and metalness of `_eval_pbr_texs`. Returns
    (is_specular_choice, specular_dir)."""
    rough = torch.where(mat["tex_rough"] >= 0, rough_val,
                        torch.full_like(rough_val, 0.5))
    metal = torch.where(mat["tex_metal"] >= 0, metal_val,
                        torch.zeros_like(metal_val))

    d_unit = vm.normalize(d)
    cos_theta = torch.abs(vm.dot(d_unit, pbr_n))
    fresnel = 0.04 + 0.96 * torch.pow(1.0 - cos_theta, 5.0) + metal * 0.5
    p_spec = fresnel * (1.0 - rough)
    choose_spec = us[:, 11] < p_spec

    rf = torch.clamp(rough * 0.3, min=0.01)
    rand_dir = sampling.random_in_unit_sphere(us[:, 0], us[:, 1], us[:, 2])
    spec_dir = vm.normalize(vm.reflect(d_unit, pbr_n) + rf[:, None] * rand_dir)
    return choose_spec, spec_dir


def _pbr_axes(cs, mat, rec, d, us, nm_rgb, rough_val, metal_val):
    """The PBR pieces both bounces share: (cosine-lobe axis, ScatteringPDF
    axis, diffuse-like mask, specular-choice mask, specular direction). The
    lobe axis is the PBR-mapped normal, the ScatteringPDF axis the record
    normal after the triangle TBN map (pbr.go:150,249)."""
    rec_n, pbr_n, is_pbr = _pbr_normals(cs, mat, rec, nm_rgb)
    choose_spec, d_spec = _pbr_lobes(mat, d, pbr_n, us, rough_val, metal_val)
    cos_axis = torch.where(is_pbr[:, None], pbr_n, rec.normal)
    spdf_axis = torch.where(is_pbr[:, None], rec_n, rec.normal)
    diffuse_like = (mat["kind"] == mt.MAT_LAMBERT) | is_pbr
    return cos_axis, spdf_axis, diffuse_like, is_pbr & choose_spec, d_spec


def _exit_retrace(intersect, p, d_in, time, apply):
    """The exit re-trace of Beer–Lambert absorption (dielectric.go:118-153):
    where each ray that refracted into an absorbing dielectric (`apply`)
    leaves it, from p + 1e-3·d_in along d_in within t ≤ 1000. Returns
    (exit point, exit hit); only `apply`'s rows mean anything.

    Every bounce of a scene with an absorbing dielectric runs it, masked:
    the other rays start parked outside the scene (as dead pool slots do)
    and miss. The JAX package skips the call when no ray applies (its
    `lax.cond`, path.py:470), which the rows read do not see; testing that
    on the host would sync each bounce."""
    start = torch.where(apply[:, None], p + 1e-3 * d_in,
                        torch.full_like(p, PARK))
    exit_rec = intersect(start, d_in, time, 0.0, 1000.0)
    return exit_rec.p, exit_rec.hit & apply


def bounce_rgb(cs, meta, settings, intersect, o, d, time, keys, depth, thru,
               rad, active, differentiable: bool = False,
               record: Optional[dict] = None):
    """Advance every live RGB path one bounce (per-ray depth (N,)).
    Returns (o, d, thru, rad, active, n_rays_this_bounce).

    differentiable=True (path.py:501-523) detaches the NEE mixture's
    direction and pdf, zeroes a sample whose ratio is not finite instead
    of carrying the Inf, and reads PBR maps through the generic lookups.
    It also keeps every gradient finite where the JAX package's is NaN (a
    branch a ray does not take sends 0·Inf or 0/0 back): each lobe and
    the absorption path length see only their own rays' gradient
    (`primitives.own`, as the intersectors' records do), a degenerate NEE
    direction is zeroed before its cosine, and the ratio divides by a safe
    pdf where the pdf is 0. No forward value changes.

    `record`, a dict, receives the bounce's hit record ("rec"), material
    rows ("mat"), whether each hit faces its normal ("facing") and the
    diffuse lobe's ratio ("ratio"): what `ops.diff_trace`'s plain forward
    records."""
    bg = vm.const(settings.background, o)
    zero = torch.zeros((), dtype=o.dtype, device=o.device)

    # Dead slots keep their last ray; the intersector sees them parked
    # outside the scene, so they miss. Every output of theirs is masked by
    # `active` below, so a bounce of dead paths changes nothing.
    o_live = torch.where(active[:, None], o, torch.full_like(o, PARK))
    rec = intersect(o_live, d, time, T_MIN, prim.T_MAX)
    if meta.n_media > 0:
        rec = _apply_media(cs, meta, rec, o_live, d, keys, depth)
    nrays = active.sum()

    miss = active & ~rec.hit
    rad = rad + torch.where(miss[:, None], thru * bg[None, :], zero)
    active = active & rec.hit

    mat = _gather_mat(cs, rec.mat_id)
    kind = mat["kind"]
    if meta.has_pbr:
        albedo, nm_rgb, rough_val, metal_val = _eval_pbr_texs(
            cs, meta, mat, rec, differentiable)
    else:
        albedo = _eval_tex(cs, meta, mat["tex_albedo"], rec.u, rec.v, rec.p)
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
    if meta.has_absorbing_dielectric:
        # Beer–Lambert with exit re-trace (dielectric.go:118-153), only for
        # rays that refracted into an absorbing dielectric.
        apply = active & is_diel & mat["has_absorption"] & ~is_refl
        exit_p, exit_hit = _exit_retrace(intersect, rec.p, d_diel, time, apply)
        # (A zero length's sqrt sends back 0/0 even from an untaken ray.)
        path_len = vm.length(own(exit_p - rec.p, apply & exit_hit))
        path_len = torch.clamp(path_len, 0.1, 100.0)
        path_len = torch.where(exit_hit, path_len,
                               torch.full_like(path_len, 10.0))
        absorbed = torch.exp(-mat["absorption"] * path_len[:, None])
        diel_att = torch.where(apply[:, None], absorbed, diel_att)

    # ---- PBR: only in scenes that hold it ----
    if meta.has_pbr:
        cos_axis, spdf_axis, diffuse_like, is_pbr_spec, d_pbr_spec = _pbr_axes(
            cs, mat, rec, d, us, nm_rgb, rough_val, metal_val)
    else:
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
    if meta.has_pbr:
        # The PBR specular lobe scatters with the albedo as its weight.
        d_diff = torch.where(is_pbr_spec[:, None], d_pbr_spec, d_diff)
        diff_mult = torch.where(is_pbr_spec[:, None], albedo, diff_mult)

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


def bounce_spectral(cs, meta, settings, intersect, o, d, time, lam, keys,
                    depth, thru, rad, active, bg_spd_id: int):
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

    o_live = torch.where(active[:, None], o, torch.full_like(o, PARK))
    rec = intersect(o_live, d, time, T_MIN, prim.T_MAX)
    if meta.n_media > 0:
        rec = _apply_media(cs, meta, rec, o_live, d, keys, depth)
    nrays = active.sum()

    bg_val = spd_mod.device_spd_value(
        cs.spd_table, torch.full_like(rec.mat_id, bg_spd_id), lam)
    miss = active & ~rec.hit
    rad = rad + torch.where(miss, thru * bg_val, zero)
    active = active & rec.hit

    mat = _gather_mat(cs, rec.mat_id)
    kind = mat["kind"]
    if meta.has_pbr:
        rgb, nm_rgb, rough_val, metal_val = _eval_pbr_texs(cs, meta, mat, rec)
    else:
        rgb = _eval_tex(cs, meta, mat["tex_albedo"], rec.u, rec.v, rec.p)
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
    if meta.has_uplift:
        # RGB→spectral uplift (SpectralImage semantics) of the RGB texture.
        spec_val = torch.where(mat["spec_albedo_uplift"],
                               uplift_mod.eval_bucketed(rgb, lam), spec_val)

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
        exit_p, exit_hit = _exit_retrace(intersect, rec.p, d_diel, time, apply)
        path_len = torch.clamp(vm.length(exit_p - rec.p), 0.1, 100.0)
        path_len = torch.where(exit_hit, path_len,
                               torch.full_like(path_len, 10.0))
        alpha = spd_mod.device_spd_value(
            cs.spd_table, torch.clamp(mat["spec_absorb_id"], min=0), lam)
        diel_att = torch.where(apply, torch.exp(-alpha * path_len), diel_att)

    if meta.has_pbr:
        cos_axis, spdf_axis, diffuse_like, is_pbr_spec, d_pbr_spec = _pbr_axes(
            cs, mat, rec, d, us, nm_rgb, rough_val, metal_val)
    else:
        cos_axis = spdf_axis = rec.normal
        diffuse_like = kind == mt.MAT_LAMBERT

    # Diffuse: the NEE mixture at λ (spectral.go:61-76).
    choose_light = us[:, 4] < 0.5
    d_light = lights_mod.sample(cs.lights, rec.p, us[:, 5:9])
    d_cos = sampling.cosine_pdf_generate(cos_axis, us[:, 9], us[:, 10],
                                         settings.exact_book_cosine)
    d_diff = torch.where(choose_light[:, None], d_light, d_cos)
    pdf_val = (0.5 * lights_mod.pdf_value(cs.lights, rec.p, d_diff)
               + 0.5 * sampling.cosine_pdf_value(cos_axis, d_diff))
    cos_out = vm.dot(spdf_axis, vm.normalize(d_diff))
    spdf_cos = torch.clamp(cos_out, min=0.0) / math.pi
    spdf = torch.where(diffuse_like, spdf_cos, zero)
    # A zero pdf divides to NaN in the reference's spectral sampler, which
    # has no per-sample DeNAN; the JAX package zeroes the weight instead.
    diff_mult = spec_val * torch.where(pdf_val > 0.0, spdf / pdf_val, zero)
    if meta.has_pbr:
        # Spectral PBR specular gets the ×1.5 albedo boost (pbr.go:253-259).
        d_diff = torch.where(is_pbr_spec[:, None], d_pbr_spec, d_diff)
        diff_mult = torch.where(is_pbr_spec, spec_val * 1.5, diff_mult)

    d_new = torch.where(is_diel[:, None], d_diel, d_diff)
    mult = torch.where(is_diel, diel_att, diff_mult)

    thru = torch.where(active, thru * mult, thru)
    o = torch.where(active[:, None], rec.p, o)
    d = torch.where(active[:, None], d_new, d)
    return o, d, thru, rad, active, nrays, bg_val


def trace(cs, meta, settings: RenderSettings, intersect, o, d, time, keys,
          differentiable: bool = False, early_exit: Optional[bool] = None,
          route=None):
    """Trace a ray batch to completion (lockstep; the correctness oracle).

    o, d: (N,3); time: (N,); keys: (N,2) per-path keys. Returns (color (N,3),
    NOT DeNAN'd — the caller applies it per render/rgb.go:36 — and the total
    ray count as a 0-dim int64 tensor).

    With early_exit (the default unless differentiable) the bounces run
    through `core.loops.guarded_fori` (path.py:742-748), TRACE_CHUNK
    bounces between two tests of the live flags and never more than
    max_depth bounces. Without it they run exactly max_depth bounces and
    nothing reads the device (path.py:731-740, JAX's fixed-length scan):
    what the training step's CUDA graph captures. A bounce of dead paths
    changes nothing, so the estimate, the rays and the gradient do not
    depend on where the loop ends.

    differentiable=True (path.py:699-740) makes the estimate differentiable
    in the scene's material, texture and light tensors, with the sampling
    detached (`bounce_rgb`). Each bounce then runs under
    `torch.utils.checkpoint` (the JAX package's `jax.checkpoint` in its
    scan), so the backward pass keeps only the carried state of each
    bounce and recomputes the rest: memory grows by one bounce's state per
    bounce. The uniforms are keyed, so the recompute draws the same
    numbers; it launches the cipher entry and a traversal kernel again.

    `route` picks how a differentiable trace runs, as its caller decided
    it on the host (`parallel.dist.build_train_step` decides it once, with
    `diff_trace.prepare`, and passes it on): an `ops.diff_trace.DiffScene`,
    the fused route, two kernels and one call of the gathers' backward
    (`ops.diff_trace.DiffTrace`: the same rays and estimate, its gradient
    walked back over a record of each bounce); None or "checkpoint", the
    checkpointed bounces above. The fused route ignores early_exit: each
    path ends in its thread."""
    if differentiable and route is not None and route != "checkpoint":
        from izpi_tpu_torch.ops import diff_trace

        if not isinstance(route, diff_trace.DiffScene):
            raise ValueError(f"unknown route {route!r}")
        return diff_trace.trace(route, cs, meta, settings, intersect, o, d,
                                time, keys)
    if early_exit is None:
        early_exit = not differentiable
    n = o.shape[0]
    thru = torch.ones_like(o)
    rad = torch.zeros_like(o)
    active = torch.ones(n, dtype=torch.bool, device=o.device)
    nrays = torch.zeros((), dtype=torch.int64, device=o.device)

    def bounce(o, d, thru, rad, active, depth_vec):
        return bounce_rgb(cs, meta, settings, intersect, o, d, time, keys,
                          depth_vec, thru, rad, active, differentiable)

    def body(st):
        depth, o, d, thru, rad, active, nrays = st
        args = (o, d, thru, rad, active, depth.expand(n))
        if differentiable:
            out = torch.utils.checkpoint.checkpoint(
                bounce, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            out = bounce(*args)
        o, d, thru, rad, active, nr = out
        return depth + 1, o, d, thru, rad, active, nrays + nr

    state = (torch.zeros((), dtype=torch.int64, device=o.device), o, d, thru,
             rad, active, nrays)
    if early_exit:
        state = loops.guarded_fori(settings.max_depth, lambda st: st[5].any(),
                                   body, state, TRACE_CHUNK)
    else:
        for _ in range(settings.max_depth):
            state = body(state)
    _, o, d, thru, rad, active, nrays = state
    # Depth cap: the next Sample call would return {Z:1} (colour.go:34-36).
    sentinel = vm.const((0.0, 0.0, 1.0), o)
    rad = rad + torch.where(active[:, None], thru * sentinel[None, :],
                            torch.zeros((), dtype=o.dtype, device=o.device))
    return rad, nrays
