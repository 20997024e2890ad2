#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (izpi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from izpi_tpu_torch/csrc (one nvcc process
per source, all at once, sm_90a) and then, in phases, each reporting on a
line of its own:
  1. the card: `nvidia-smi --query-gpu=name,power.limit` (fails without CUDA);
  2. the build, and its seconds;
  3. cipher: the device Threefry (`izpi_threefry_uniforms`) on 1M random
     keys equals the PyTorch twin bit for bit, for the bounce, camera and λ
     draws;
  4. kernel vs twin, both on the card, the twin on the card's layout
     (`megakernel.card_min_slots`: SLOTS_PER_THREAD slots per resident
     thread of the persistent grid), within stated tolerances:
     - the RGB megakernel: Cornell 64×64 at 4 spp, depth 8, seed 3; 64×64
       at 64 spp, depth 8, seed 5 (every thread of the grid serves several
       slots, and the slots are no multiple of the grid); 128×128 at 128
       spp, depth 8, seed 7 (likewise, and every slot serves two samples,
       as the main paths' slots serve 64); and the RGB main path's frame,
       256×256 at depth 50, seed 0, for samples [0, 2) and [1022, 1024);
     - the spectral megakernel: the spectral pyramid at the same three
       small layouts, and the spectral main path's frame, 500×500 at depth
       50, seed 0, for samples [0, 2) and [254, 256);
     each kernel and its twin timed at its main path's frame at 2 spp, with
     the kernel's draw counts (its counter buffer) and its bound there;
  5. RGB main path: `render(cornell_box(), 256, 256, 1024, max_depth=50,
     seed=0, mode="wavefront", device="cuda")`, one warm-up and one timed
     run, the launch inside the timed run between CUDA events (the
     kernel's time of record); the RGB megakernel's launch counter must
     read 2, the two runs must agree bit for bit, the image must be finite,
     green on the left, red on the right, with the ceiling light at 15;
     then one more launch of the same render with the draw counter buffer,
     which must repeat the image and rays, for the bound;
  6. spectral main path: `render(cornell_box_pyramid_spectral(), 500, 500,
     256, max_depth=50, seed=0, mode="wavefront", device="cuda")`, likewise;
     the spectral megakernel's counter must read 2, the runs must agree, XYZ
     and ACEScg must be finite, green on the left and red on the right, and
     the light patch's Y must be 15·21.3768;
  7. the BVH4 traversal kernel against its plain version
     (`accel.traverse.closest_bvh`), both on the card, at two scales: the
     tree of `cornell_box_obj` (20,007 primitives) and the dragon stand-in
     (`bumpy_blob(871_414)` as the dragon scene places it, 871,200
     triangles); 262,144 rays each, half camera rays and half incoherent
     rays from their hit points (directions from a seeded
     torch.Generator); equal hit masks, t within 1e-6 relative, equal
     primitives but on exact-t ties (at most 1e-5 of the rays); build
     seconds, nodes, kernel and plain times and the bound;
  8. the queue pool through the kernel against the queue pool through the
     plain traversal, both on the card: `cornell_box_obj` 32×32 at 4 spp,
     depth 50, within phase 4's tolerances;
  9. BVH main path: `render(cornell_box_obj(), 256, 256, 128,
     max_depth=50, seed=0, mode="wavefront", device="cuda")` through the
     queue pool, one warm-up and one timed run; the traversal kernel's
     counter must equal the pool iterations and the megakernels' must not
     move; the image must be finite, green on the left, red on the right,
     with the ceiling light at 15; the kernel's share of `render()` (CUDA
     events) and, for a 16-spp render of the same frame, the device's idle
     share under torch.profiler;
 10. the row-stack traversal kernel (`ops.bvh_rowkernel`, one warp per 32
     rays) against its plain version (`bvh_rowkernel.closest_rows`), both
     on the card, on the leaf-64 trees of `cornell_box_obj`, of the dragon
     stand-in (phase 7's rays) and of the dragon scene its main path runs
     (262,144 rays on phase 7's recipe from the dragon's camera), the rays
     sorted as its intersector sorts them: equal hit masks, t within 1e-6
     relative, equal block slots but on exact-t ties (at most 1e-5 of the
     rays), equal per-warp counters; and against the BVH4 traversal
     kernel's hits on the same rays (equal hit masks, t within 1e-6
     relative); build seconds, nodes and blocks, the kernel's time on
     sorted and on unsorted rays, the plain time, the bound (from the work
     each ray alone needs on the tree: the per-ray traversal's counts) and
     the warp's own work beside it;
 11. the dragon (`cornell_box_pbr_stanford_dragon_spectral()`: the
     871,200-triangle stand-in, the walls, the light and a glass sphere,
     porcelain PBR) through the queue pool at 32×32, 4 spp, depth 16, once
     with the row-stack pair (`bvh_rowkernel.attach`) and once with the
     BVH4 kernel, both on the card, within phase 4's ray and XYZ
     tolerances;
 12. the dragon main path: `render(dragon, 256, 256, 8, max_depth=16,
     seed=0, mode="wavefront", device="cuda")`, a warm-up and a timed run
     through the BVH4 kernel (the default intersector), then a warm-up and a
     timed run through the row-stack pair in a RenderContext; each
     traversal kernel's counter must equal the pool iterations of its run
     and nothing else may launch; XYZ and ACEScg finite, the red wall (x =
     100, on the image's left: the camera's horizontal axis points to -x)
     red and the green wall (x = 0, right) green, the mesh region not
     black (mean Y above 1e-3); the two renders agree within phase 4's tolerances; rays,
     seconds, Mrays/s, iterations, each kernel's share of `render()` (CUDA
     events) and the device's idle share of a 2-spp render under
     torch.profiler. The mesh region is the pixels whose centre's camera
     ray first hits the porcelain; the stand-in's triangles face inward, so
     only its rim and what the glass sphere throws on it are lit.
The build line is followed by the ptxas registers and spills of every
kernel (a megakernel that spills fails the run) and each megakernel's
persistent grid (blocks × threads) and slots. The line before the last is a
JSON object describing the kernels, each with its time, its plain version's
time and its bound (the least time the card could take for the work this
run's rays needed); the last is {"ok": true, "device": {...}}. Any failure
raises and exits non-zero. Imports nothing of JAX.
"""

from __future__ import annotations

import functools
import json
import subprocess
import time

import numpy as np
import torch

from izpi_tpu_torch import camera, profiling
from izpi_tpu_torch.accel import traverse
from izpi_tpu_torch.core import rng
from izpi_tpu_torch.geometry import primitives, procedural
from izpi_tpu_torch.integrator import path, wavefront
from izpi_tpu_torch.materials import tables as mat_tables
from izpi_tpu_torch.ops import (_build, bvh_kernel, bvh_rowkernel, megakernel,
                                megakernel_spectral, threefry)
from izpi_tpu_torch.render import renderer
from izpi_tpu_torch.scene import compiler
from izpi_tpu_torch.scene import types as scene_types
from izpi_tpu_torch.scene.library.cornell import cornell_box
from izpi_tpu_torch.scene.library.cornell_spectral import (
    cornell_box_pyramid_spectral)
from izpi_tpu_torch.scene.library.extracted import (
    cornell_box_pbr_stanford_dragon_spectral)
from izpi_tpu_torch.scene.library.misc import cornell_box_obj
from izpi_tpu_torch.spectral import cie, convert

# Phase 4 tolerances. A tolerance at all because libdevice transcendentals
# and torch's reciprocal-multiply for division by a Python scalar on the card
# round differently in the last ulp from the kernel, which can flip a rare
# branch of a path.
RAYS_RTOL = 0.005      # ray counts within 0.5%
PIXEL_ATOL = 1e-4      # a pixel agrees when every channel is within this
PIXEL_SHARE = 0.99     # share of pixels that must agree
MEAN_RTOL = 0.005      # image means within 0.5%
# The spectral kernel's XYZ reaches ~321 at the light, where an f32 ulp is
# ~3e-5, so its pixels agree when every channel is within
# XYZ_ATOL + XYZ_RTOL·|plain|.
XYZ_ATOL = 1e-4
XYZ_RTOL = 1e-5

# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): 67 TFLOP/s
# of FP32 counts an FMA as two operations; the kernels are built with
# -fmad=false, so they issue separate multiplies and adds at half that rate.
# INT32 runs on 64 lanes per SM of 132, at the 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12 / 2
INT32_OPS_PER_S = 64 * 132 * 1.98e9

# Operations per thread, counted from the CUDA sources (common.cuh,
# threefry.cuh and the kernels): FP32 adds, multiplies, divisions, square
# roots, comparisons, selects and libdevice calls count one each; INT32
# adds, xors, funnel-shift rotates, shifts and compares likewise.
CIPHER_INT = 79          # one threefry2x32: 4 + 20 rounds x 3 + 5 injections x 3
UNIFORM_INT, UNIFORM_FP = 2, 1   # bits_to_uniform: shift, or | subtract
PRIM_FP = {0: 58, 1: 56, 2: 56}  # closest-hit test per triangle, rect, sphere
PRIM_INT = 6             # loop, index and kind dispatch per primitive
SCATTER_FP = 80          # the cheapest scattering bounce (a dielectric), NEE left out
CAMERA_FP = 46           # thin-lens ray from 5 uniforms
CAMERA_CIPHER = 7        # path key (2 fold-ins), camera key (2), 3 pairs
SPECTRAL_SAMPLE_FP = 20 + 11 + 51   # λ sampling, background SPD, XYZ deposit
SPECTRAL_SAMPLE_INT = 30            # λ sampling's binary search
RGB_SAMPLE_FP = 9        # RGB deposit: DeNAN and add, three channels
# Phase 4's layouts at which every thread of the persistent grid serves
# several slots, and at which besides every slot serves several samples:
# (n, spp, depth, seed, offset).
MULTI_SLOT = (64, 64, 8, 5, 0)
MULTI_SAMPLE = (128, 128, 8, 7, 0)
# The traversal kernel (csrc/bvh4_traverse.cu), per node popped: 4 children ×
# 3 axes × (2 subtractions, 2 multiplications, fminf, fmaxf, fmaxf, fminf),
# 4 hit comparisons and the 5 compares of the sorting network; per ray the 3
# guarded reciprocals of the direction. A leaf primitive costs PRIM_FP of
# its kind; the counter does not tell kinds apart, so the bound takes the
# cheapest.
VISIT_FP = 4 * 3 * 8 + 4 + 5
RAY_FP = 3 * 3
# The row-stack kernel (csrc/bvh4_rowstack.cu), per node a ray needs: the
# same slab test and 4 hit comparisons, no sort. Its bound counts the nodes
# and primitives each ray alone needs on the leaf-64 tree (the per-ray
# traversal over the same tables, walked in chunks of PER_RAY_CHUNK rays),
# not the union its warp walks.
ROW_VISIT_FP = 4 * 3 * 8 + 4
PER_RAY_CHUNK = 1 << 16
# Phase 7: traversal rays per scale (the main path's pool size), and the
# share of them allowed to pick another primitive at an exactly equal t.
TRAVERSE_RAYS = 1 << 18
T_RTOL = 1e-6
# Phase 12: the dragon main path, bench.py's `dragon` (bench.py:41-42).
DRAGON_SIZE, DRAGON_SPP, DRAGON_DEPTH = 256, 8, 16
TIE_SHARE = 1e-5


def bound_ms(rays: int, samples: int, prim_kinds, spectral: bool,
             out_bytes: int, table_bytes: int, draws=None):
    """The least milliseconds the card could take for a megakernel launch
    that traced `rays` rays over `samples` camera samples, and what bounds
    it ("bytes" or "operations").

    Counts only work every ray must do: each ray tests every primitive;
    every scatter shades at least as a dielectric does; every sample draws
    its camera ray (7 cipher calls, 5 uniforms). `draws` is the kernel's
    (scatters, bounce pairs) from its counter buffer: each scatter ciphers
    its two fold-ins and the pairs its material and branch read (two
    uniforms a pair), and a spectral sample's λ two calls more (its key
    reuses the camera's first fold-in) and one uniform. Without `draws`,
    the parent kernel's eager count, kept for continuity: every ray but a
    sample's last scatters, drawing 12 uniforms in 8 calls, and λ costs 3
    calls. The diffuse bounces' light sampling and pdf are left out, so the
    true bound is higher. Bytes: the tables read once and the outputs
    written once."""
    if draws is None:
        scatter = rays - samples
        cipher = 8 * scatter + (CAMERA_CIPHER + 3 * spectral) * samples
        uniforms = 12 * scatter
    else:
        scatter, pairs = draws
        cipher = 2 * scatter + pairs + (CAMERA_CIPHER + 2 * spectral) * samples
        uniforms = 2 * pairs
    uniforms += (5 + spectral) * samples
    prim_fp = sum(PRIM_FP[int(k)] for k in prim_kinds)
    n_prims = len(prim_kinds)
    fp = (rays * prim_fp + scatter * SCATTER_FP + uniforms * UNIFORM_FP
          + samples * CAMERA_FP)
    int_ops = (rays * PRIM_INT * n_prims + cipher * CIPHER_INT
               + uniforms * UNIFORM_INT)
    if spectral:
        fp += samples * SPECTRAL_SAMPLE_FP
        int_ops += samples * SPECTRAL_SAMPLE_INT
    else:
        fp += samples * RGB_SAMPLE_FP
    t_ops = max(fp / FP32_OPS_PER_S, int_ops / INT32_OPS_PER_S)
    t_bytes = (out_bytes + table_bytes) / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def launch_bound(label: str, rays: int, samples: int, draws, prim_kinds,
                 spectral: bool, lay: dict, table_bytes: int, card: str):
    """`bound_ms` of one megakernel launch from its draw counts (scatters,
    bounce pairs), with the parent kernel's eager count beside it; the
    outputs are the layout's per-slot sums and ray counts. Prints both and
    returns a dict of the numbers."""
    scatters, pairs = (int(x) for x in draws)
    out_bytes = lay["slots"] * 16
    bound, by = bound_ms(rays, samples, prim_kinds, spectral, out_bytes,
                         table_bytes, (scatters, pairs))
    eager, eager_by = bound_ms(rays, samples, prim_kinds, spectral, out_bytes,
                               table_bytes)
    print(f"bound: {label}: {rays} rays, {samples} samples, {scatters} "
          f"scatters drawing {pairs} pairs ({pairs / max(scatters, 1):.4f} a "
          f"scatter): {bound:.4f} ms by {by}; by the eager count (8 calls a "
          f"scatter, rays - samples scatters) {eager:.4f} ms by {eager_by} "
          f"({card})", flush=True)
    return dict(bound_ms=bound, bound_by=by, bound_ms_eager=eager,
                scatters=scatters, pairs=pairs)


def tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def card_layout(mod, n: int, spp: int) -> dict:
    """The persistent grid of megakernel module `mod` on the card and the
    card's layout of an n×n frame at spp: blocks, threads, replicas,
    samples per slot, slots, slots per resident thread."""
    dev = torch.device("cuda")
    blocks, threads = megakernel.card_grid(mod.ENTRY, dev)
    repl, spp_slot, n_slots = megakernel.slot_layout(
        n * n, spp, megakernel.card_min_slots(mod.ENTRY, dev))
    return dict(blocks=blocks, threads=threads, replicas=repl,
                spp_slot=spp_slot, slots=n_slots,
                slots_per_thread=n_slots / (blocks * threads))


def canvas(acc, n: int, spp: int) -> np.ndarray:
    """The (n, n, 3) f32 canvas `renderer.render` makes of a wrapper's sums
    (float64 division, rows flipped)."""
    acc64 = np.zeros((n * n, 3), np.float64)
    acc64 += acc.cpu().numpy()
    return (acc64 / spp).reshape(n, n, 3)[::-1].astype(np.float32)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card over reps runs, after one
    warm-up run (`profiling.cuda_ms`)."""
    return profiling.cuda_ms(fn, reps)[1]


def compare(cs, meta, tables, n: int, spp: int, depth: int, seed: int,
            offset: int) -> float:
    """Render n x n at spp samples from `offset` through the CUDA megakernel
    and through its plain twin, both on the card; print the deviations and
    raise unless they are within the tolerances above. Returns the largest
    absolute pixel error."""
    s = path.RenderSettings(max_depth=depth)
    key = rng.render_key(seed, device="cuda")
    acc_k, rays_k = megakernel.render_slots(cs, meta, s, n, n, spp, key, offset,
                                            tables=tables)
    acc_p, rays_p = megakernel.render_slots_reference(
        cs, meta, s, n, n, spp, key, offset,
        min_slots=megakernel.card_min_slots(megakernel.ENTRY, cs.device))
    torch.cuda.synchronize()
    img_k, img_p = acc_k / spp, acc_p / spp
    rays_k, rays_p = int(rays_k), int(rays_p)
    pix_err = (img_k - img_p).abs().amax(dim=1)
    max_abs_err = float(pix_err.max())
    share = float((pix_err <= PIXEL_ATOL).float().mean())
    mean_k, mean_p = float(img_k.mean()), float(img_p.mean())
    rays_rel = abs(rays_k - rays_p) / rays_p
    mean_rel = abs(mean_k - mean_p) / mean_p
    lay = card_layout(megakernel, n, spp)
    print(f"kernel-vs-twin: cornell {n}x{n}@{spp} depth {depth} seed {seed} "
          f"offset {offset} ({lay['slots']} slots of {lay['spp_slot']} "
          f"samples, {lay['slots_per_thread']:.3f} per resident thread): rays "
          f"{rays_k} vs {rays_p} (rel "
          f"{rays_rel:.2e}, tol {RAYS_RTOL}); pixels within {PIXEL_ATOL}: "
          f"{share:.6f} (tol {PIXEL_SHARE}); max abs err {max_abs_err:.3e}; "
          f"mean {mean_k:.7f} vs {mean_p:.7f} (rel {mean_rel:.2e}, tol "
          f"{MEAN_RTOL})", flush=True)
    if not (bool(torch.isfinite(img_k).all()) and rays_rel <= RAYS_RTOL
            and share >= PIXEL_SHARE and mean_rel <= MEAN_RTOL):
        raise AssertionError(f"CUDA megakernel disagrees with its plain twin "
                             f"at {n}x{n}@{spp} depth {depth} offset {offset}")
    return max_abs_err


def compare_xyz(label: str, acc_a, rays_a: int, acc_b, rays_b: int,
                spp: int) -> float:
    """Two spectral XYZ accumulators of one render, `b` the reference:
    print the deviations and raise unless the rays, pixels and mean Y are
    within the tolerances above. Returns the largest absolute XYZ error."""
    xyz_a, xyz_b = acc_a / spp, acc_b / spp
    diff = (xyz_a - xyz_b).abs()
    max_abs_err = float(diff.max())
    max_rel_err = float((diff / xyz_b.abs().clamp(min=1e-6)).max())
    share = float((diff <= XYZ_ATOL + XYZ_RTOL * xyz_b.abs()).all(dim=1)
                  .float().mean())
    mean_a, mean_b = float(xyz_a[:, 1].mean()), float(xyz_b[:, 1].mean())
    rays_rel = abs(rays_a - rays_b) / rays_b
    mean_rel = abs(mean_a - mean_b) / mean_b
    print(f"{label}: rays {rays_a} vs {rays_b} (rel {rays_rel:.2e}, tol "
          f"{RAYS_RTOL}); pixels with XYZ within {XYZ_ATOL} + {XYZ_RTOL}|b|: "
          f"{share:.6f} (tol {PIXEL_SHARE}); max abs err {max_abs_err:.3e}; "
          f"max rel err {max_rel_err:.3e}; mean Y {mean_a:.6f} vs "
          f"{mean_b:.6f} (rel {mean_rel:.2e}, tol {MEAN_RTOL})", flush=True)
    if not (bool(torch.isfinite(xyz_a).all()) and rays_rel <= RAYS_RTOL
            and share >= PIXEL_SHARE and mean_rel <= MEAN_RTOL):
        raise AssertionError(f"{label}: the two renders disagree")
    return max_abs_err


def compare_spectral(cs, meta, tables, n: int, spp: int, depth: int, seed: int,
                     offset: int):
    """The spectral pyramid n x n at spp samples from `offset` through the
    CUDA spectral megakernel (a) and through its plain version (b), both on
    the card, held to `compare_xyz`. Returns the largest absolute XYZ
    error."""
    s = path.RenderSettings(max_depth=depth)
    key = rng.render_key(seed, device="cuda")
    acc_k, rays_k = megakernel_spectral.render_slots_spectral(
        cs, meta, s, n, n, spp, key, offset, tables=tables)
    acc_p, rays_p = megakernel_spectral.render_slots_spectral_reference(
        cs, meta, s, n, n, spp, key, offset,
        min_slots=megakernel.card_min_slots(megakernel_spectral.ENTRY,
                                            cs.device))
    torch.cuda.synchronize()
    lay = card_layout(megakernel_spectral, n, spp)
    err = compare_xyz(f"kernel-vs-twin: spectral pyramid {n}x{n}@{spp} depth "
                      f"{depth} seed {seed} offset {offset} ({lay['slots']} "
                      f"slots of {lay['spp_slot']} samples, "
                      f"{lay['slots_per_thread']:.3f} per resident thread)",
                      acc_k, int(rays_k), acc_p, int(rays_p), spp)
    return err


def traversal_bound_ms(fp: int, n_rays: int, table_bytes: int):
    """The least milliseconds the card could take for a traversal of n_rays
    that needs `fp` FP32 operations (counted from the kernel's counter
    buffer) over the FP32 peak, against the tables read once, 28 bytes in
    and 8 out per ray over HBM bandwidth. Returns (ms, "operations" or
    "bytes")."""
    t_ops = (fp + n_rays * RAY_FP) / FP32_OPS_PER_S
    t_bytes = (table_bytes + n_rays * (28 + 8)) / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def compare_rowstack(label: str, cs2, inter, attach_s: float, rays, ks3,
                     card: str):
    """The row-stack kernel of `attach`'s pair (cs2, inter) against its
    plain version on `rays` sorted as `RowBVHIntersector` sorts them, both
    on the card, and against the BVH4 kernel's hits (tree `ks3`) on the
    same rays: print the deviations, the times and the bound; raise unless
    hit masks are equal, t is within T_RTOL, block slots differ only on
    exact-t ties (at most TIE_SHARE of the rays) and the per-warp counters
    are equal. Returns a dict of the numbers."""
    rs = inter.rs
    o, d, tme = rays
    n = o.shape[0]
    order = torch.argsort(bvh_rowkernel.sort_keys(o, d, inter.lo, inter.hi),
                          stable=True)
    o_s, d_s, t_s = (x[order].contiguous() for x in (o, d, tme))
    t_k, i_k, c_k = bvh_rowkernel.closest_hit_rows(
        rs, o_s, d_s, t_s, path.T_MIN, primitives.T_MAX, counters=True)
    (t_p, i_p, c_p), plain_ms = profiling.cuda_ms(
        lambda: bvh_rowkernel.closest_rows(rs, o_s, d_s, t_s, path.T_MIN,
                                           primitives.T_MAX), 1, warm_up=False)
    hit = i_p >= 0
    same_mask = torch.equal(i_k >= 0, hit)
    err = (t_k[hit] - t_p[hit]).abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    max_rel = float((err / t_p[hit].abs()).max()) if err.numel() else 0.0
    differ = hit & (i_k != i_p)
    ties = int((differ & (t_k == t_p)).sum())
    wrong = int((differ & (t_k != t_p)).sum())
    same_counters = torch.equal(c_k, c_p)
    # The BVH4 kernel on the same rays, in their sorted order.
    t3, i3 = bvh_kernel.closest_hit(ks3, o_s, d_s, t_s, path.T_MIN,
                                    primitives.T_MAX)
    same_mask3 = torch.equal(i3 >= 0, i_k >= 0)
    hit3 = i3 >= 0
    rel3 = (float(((t_k[hit3] - t3[hit3]).abs() / t3[hit3].abs()).max())
            if bool(hit3.any()) else 0.0)
    ms = cuda_ms(lambda: bvh_rowkernel.closest_hit_rows(
        rs, o_s, d_s, t_s, path.T_MIN, primitives.T_MAX), 20)
    ms_unsorted = cuda_ms(lambda: bvh_rowkernel.closest_hit_rows(
        rs, o, d, tme, path.T_MIN, primitives.T_MAX), 20)
    # The bound: the work each ray alone needs on this leaf-64 tree, the
    # node pops and primitive tests of the per-ray traversal (near child
    # first) over the same tables, in chunks of rays.
    tree = bvh_rowkernel.per_ray_tree(rs)
    visits = tests = 0
    for lo in range(0, n, PER_RAY_CHUNK):
        sl = slice(lo, lo + PER_RAY_CHUNK)
        _, i_r, c_r = traverse.closest_bvh(cs2.prims, tree, o_s[sl], d_s[sl],
                                           t_s[sl], path.T_MIN,
                                           primitives.T_MAX, counts=True)
        same_mask = same_mask and torch.equal(i_r >= 0, hit[sl])
        visits += int(c_r[:, 0].sum())
        tests += int(c_r[:, 1].sum())
    table_bytes = tensor_bytes([rs.nodes, rs.blocks])
    bound, bound_by = traversal_bound_ms(
        visits * ROW_VISIT_FP + tests * min(PRIM_FP.values()), n, table_bytes)
    # Beside it, the warp's own work: 32 lanes x (its node pops and the
    # primitives of every block it visits). Not a bound: kernel 3 does the
    # per-ray work in less time than this.
    pops, _, prims = (int(x) for x in c_k.sum(dim=0))
    warp_bound, _ = traversal_bound_ms(
        32 * (pops * ROW_VISIT_FP + prims * min(PRIM_FP.values())), n,
        table_bytes)
    mean_c = [round(float(x), 3) for x in c_k.double().mean(dim=0)]
    print(f"row-stack {label}: leaf-64 tree {rs.nodes.shape[0]} nodes, "
          f"{rs.blocks.shape[0]} blocks, attach {attach_s:.3f} s; {n} rays "
          f"sorted, hits {float(hit.float().mean()):.4f}; hit masks equal "
          f"{same_mask}; t max abs err {max_abs:.3e}, max rel {max_rel:.3e} "
          f"(tol {T_RTOL}); slots differing on exact-t ties {ties} (allowed "
          f"{TIE_SHARE * n:.2f}), otherwise {wrong}; per-warp counters equal "
          f"{same_counters}; mean per warp: nodes popped, blocks, prims per "
          f"lane {mean_c}, max {c_k.max(dim=0).values.tolist()}; per ray "
          f"alone: nodes {visits / n:.3f}, prims {tests / n:.3f}; vs the "
          f"BVH4 kernel: hit masks equal {same_mask3}, t max rel {rel3:.3e}; "
          f"kernel {ms:.4f} ms sorted, {ms_unsorted:.4f} ms unsorted, plain "
          f"{plain_ms:.2f} ms, bound {bound:.4f} ms by {bound_by} (the "
          f"warp's own work {warp_bound:.4f} ms) ({card})", flush=True)
    if not (same_mask and max_rel <= T_RTOL and wrong == 0
            and ties <= TIE_SHARE * n and same_counters and same_mask3
            and rel3 <= T_RTOL):
        raise AssertionError(f"row-stack kernel disagrees with its plain "
                             f"version or the BVH4 kernel on {label}")
    return dict(max_abs_err=max_abs, ms=ms, ms_unsorted=ms_unsorted,
                plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                warp_work_ms=warp_bound, attach_s=attach_s,
                nodes=rs.nodes.shape[0], blocks=rs.blocks.shape[0],
                mean_counters=mean_c,
                per_ray_nodes_prims=[visits / n, tests / n])


def dragon_stand_in() -> scene_types.Scene:
    """The dragon scene's procedural mesh, `bumpy_blob(871_414)` placed as
    izpi_tpu/scene/library/extracted.py:73-75 places it (871,200
    triangles), seen by a camera 60 units in front of its centre, which it
    fills."""
    tris = procedural.transform_mesh(procedural.bumpy_blob(871_414),
                                     scale=25.0, rotate_y_deg=-60.0,
                                     translate=(50.0, 25.1, 60.0))
    white = scene_types.Lambertian(
        albedo=scene_types.ConstantTexture((0.5, 0.5, 0.5)))
    mesh = scene_types.TriangleMesh(vertices=tris, material=white)
    return scene_types.Scene(world=[mesh], camera=scene_types.Camera(
        look_from=(50.0, 35.0, 0.0), look_at=(50.0, 25.1, 60.0), vfov=40.0))


def traversal_rays(ks, cam, n: int, seed: int):
    """n rays for the tree `ks`: n/2 camera rays through a square frame
    (jittered from a seeded generator), and n/2 from where those rays hit
    (their origin where they miss) in directions drawn from the same
    generator. The hit points come from the plain traversal."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    half = n // 2
    u = torch.rand((half, 5), generator=gen, device="cuda")
    o, d, tme = camera.get_rays(cam, u[:, 0], u[:, 1], u[:, 2:5])
    t, idx = traverse.closest_bvh(ks.prims, ks.tree, o, d, tme, path.T_MIN,
                                  primitives.T_MAX)
    start = torch.where((idx >= 0)[:, None], o + t[:, None] * d, o)
    d2 = torch.randn((half, 3), generator=gen, device="cuda")
    return (torch.cat([o, start]).contiguous(), torch.cat([d, d2]).contiguous(),
            torch.cat([tme, tme]).contiguous())


def compare_traversal(label: str, ks, rays, card: str):
    """The traversal kernel against its plain version on `rays`, both on
    the card: print the deviations, the times and the bound; raise unless
    the hit masks are equal, t is within T_RTOL and the primitives differ
    only on exact-t ties, on at most TIE_SHARE of the rays. Returns a dict
    of the numbers."""
    o, d, tme = rays
    n = o.shape[0]
    t_k, i_k, counts = bvh_kernel.closest_hit(ks, o, d, tme, path.T_MIN,
                                             primitives.T_MAX, counts=True)
    t_p, i_p, counts_p = traverse.closest_bvh(ks.prims, ks.tree, o, d, tme,
                                              path.T_MIN, primitives.T_MAX,
                                              counts=True)
    torch.cuda.synchronize()
    hit = i_p >= 0
    same_mask = torch.equal(i_k >= 0, hit)
    err = (t_k[hit] - t_p[hit]).abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    max_rel = float((err / t_p[hit].abs()).max()) if err.numel() else 0.0
    differ = hit & (i_k != i_p)
    ties = int((differ & (t_k == t_p)).sum())
    wrong = int((differ & (t_k != t_p)).sum())
    same_counts = torch.equal(counts, counts_p)
    ms = cuda_ms(lambda: bvh_kernel.closest_hit(ks, o, d, tme, path.T_MIN,
                                                primitives.T_MAX), 20)
    plain_ms = cuda_ms(lambda: traverse.closest_bvh(
        ks.prims, ks.tree, o, d, tme, path.T_MIN, primitives.T_MAX), 1)
    table_bytes = tensor_bytes([ks.nodes, ks.prim_table])
    visits, tests = (int(x) for x in counts.sum(dim=0))
    bound, bound_by = traversal_bound_ms(
        visits * VISIT_FP + tests * min(PRIM_FP.values()), n, table_bytes)
    mean_counts = [round(float(x), 3) for x in counts.double().mean(dim=0)]
    print(f"traversal {label}: {n} rays, hits {float(hit.float().mean()):.4f}; "
          f"hit masks equal {same_mask}; t max abs err {max_abs:.3e}, max rel "
          f"{max_rel:.3e} (tol {T_RTOL}); primitives differing on exact-t ties "
          f"{ties} (allowed {TIE_SHARE * n:.2f}), otherwise {wrong}; node/prim "
          f"counts equal to the plain version's {same_counts}; mean nodes "
          f"popped, prims tested per ray {mean_counts}, max "
          f"{counts.max(dim=0).values.tolist()}; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.2f} ms, bound {bound:.4f} ms by {bound_by} ({card})",
          flush=True)
    if not (same_mask and max_rel <= T_RTOL and wrong == 0
            and ties <= TIE_SHARE * n):
        raise AssertionError(f"traversal kernel disagrees with its plain "
                             f"version on {label}")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by)


def mesh_pixels(ctx, n: int) -> np.ndarray:
    """(n, n) bool, image rows top first: the pixels whose centre's camera
    ray first hits a PBR material (the renderer's film convention, v up)."""
    c = (torch.arange(n, device=ctx.device, dtype=torch.float32) + 0.5) / n
    s = c.repeat(n)
    t = 1.0 - c.repeat_interleave(n)
    o, d, tme = camera.get_rays(ctx.cs.camera, s, t,
                                torch.zeros((n * n, 3), device=ctx.device))
    hit = ctx.intersect(o, d, tme, path.T_MIN, primitives.T_MAX)
    kind = ctx.cs.materials.kind[torch.clamp(hit.mat_id, min=0)]
    return (hit.hit & (kind == mat_tables.MAT_PBR)).reshape(n, n).cpu().numpy()


def row_stack_phases(bctx, dctx, rays7, card: str):
    """Phases 10-12 (the module docstring). Returns (phase 10's numbers
    by tree, phase 12's numbers by traversal kernel)."""
    # 10. The row-stack kernel against its plain version and the BVH4 kernel,
    # on phase 7's scenes and rays, then on the dragon scene's own tree.
    rows10 = {}
    for label, ctx in (("cornell_box_obj", bctx), ("dragon stand-in", dctx)):
        t0 = time.perf_counter()
        cs2, inter = bvh_rowkernel.attach(ctx.cs)
        torch.cuda.synchronize()
        rows10[label] = compare_rowstack(label, cs2, inter,
                                         time.perf_counter() - t0,
                                         rays7[label], ctx.intersect.ks, card)
        del cs2, inter
    torch.cuda.empty_cache()

    # Two contexts of the dragon scene: the default (the BVH4 kernel, above
    # BVH_THRESHOLD) and brute force replaced by the row-stack pair, as a
    # user selects it.
    dev = bctx.device
    dragon = cornell_box_pbr_stanford_dragon_spectral()
    d3ctx = renderer.RenderContext(dragon, device=dev)
    d4ctx = renderer.RenderContext(dragon, use_bvh=False, device=dev)
    t0 = time.perf_counter()
    d4ctx.cs, d4ctx.intersect = bvh_rowkernel.attach(d4ctx.cs)
    torch.cuda.synchronize()
    d4_attach = time.perf_counter() - t0
    print(f"dragon: {d3ctx.meta.n_prims} prims, has_pbr {d3ctx.meta.has_pbr}, "
          f"megakernel-eligible {d3ctx.mega_supported()}; BVH4 context "
          f"(compile and leaf-4 build) {d3ctx.build_seconds:.3f} s; row-stack "
          f"context: compile {d4ctx.build_seconds:.3f} s, leaf-64 attach "
          f"{d4_attach:.3f} s", flush=True)
    # 10, the main path's tree: the dragon's rects, sphere and triangles in
    # mixed blocks, on phase 7's ray recipe from the dragon's camera.
    rows10["dragon"] = compare_rowstack(
        "dragon", d4ctx.cs, d4ctx.intersect, d4_attach,
        traversal_rays(d3ctx.intersect.ks, d3ctx.cs.camera, TRAVERSE_RAYS, 10),
        d3ctx.intersect.ks, card)
    torch.cuda.empty_cache()

    # 11. The dragon's pool through the row-stack pair against the pool
    # through the BVH4 kernel.
    s11 = path.RenderSettings(max_depth=DRAGON_DEPTH)
    key11 = rng.render_key(0, device=dev)
    bg11 = d3ctx.meta.spectral_background_spd or 0
    before = bvh_rowkernel.launches
    acc4, rays4, it4 = wavefront.trace_pool(
        d4ctx.cs, d4ctx.meta, s11, d4ctx.intersect, 32, 32, 4, key11, 4096,
        spectral=True, bg_spd_id=bg11)
    launched4 = bvh_rowkernel.launches - before
    acc3, rays3, it3 = wavefront.trace_pool(
        d3ctx.cs, d3ctx.meta, s11, d3ctx.intersect, 32, 32, 4, key11, 4096,
        spectral=True, bg_spd_id=bg11)
    torch.cuda.synchronize()
    print(f"pool: dragon 32x32@4 depth 16 (pool 4096, sorted): row-stack "
          f"{it4} iterations ({launched4} launches), BVH4 kernel {it3}",
          flush=True)
    compare_xyz("pool: dragon row-stack vs BVH4 kernel", acc4, int(rays4), acc3,
                int(rays3), 4)
    if launched4 != it4:
        raise AssertionError(f"{launched4} row-stack launches in {it4} pool "
                             f"iterations")

    # 12. The dragon main path through each traversal kernel, through the
    # entry points a user calls.
    s12 = path.RenderSettings(max_depth=DRAGON_DEPTH)
    counters = (bvh_kernel, bvh_rowkernel, megakernel, megakernel_spectral,
                threefry)

    def zero_counts():
        for mod in counters:
            mod.launches = 0

    def dragon_render(ctx, spp):
        return renderer.render(None, DRAGON_SIZE, DRAGON_SIZE, spp, s12,
                               seed=0, mode="wavefront", context=ctx,
                               device=dev)

    mesh = mesh_pixels(d3ctx, DRAGON_SIZE)
    if mesh.sum() < 16:
        raise AssertionError(f"the dragon's mesh covers {mesh.sum()} pixels")
    dragon_runs, dres = {}, {}
    for name, ctx, mod, fn in (
            ("bvh4_traverse", d3ctx, bvh_kernel, "closest_hit"),
            ("bvh4_rowstack", d4ctx, bvh_rowkernel, "closest_hit_rows")):
        zero_counts()
        warm = dragon_render(ctx, DRAGON_SPP)
        moved = {m.__name__.rsplit(".", 1)[1]: m.launches for m in counters}
        if mod.launches != warm.iterations or sum(moved.values()) != (
                mod.launches + threefry.launches):
            raise AssertionError(f"dragon warm-up through {name}: launches "
                                 f"{moved} in {warm.iterations} iterations")
        zero_counts()
        with profiling.event_timed(mod, fn) as times:
            res12 = dragon_render(ctx, DRAGON_SPP)
        kernel_ms = profiling.event_ms(times)
        moved = {m.__name__.rsplit(".", 1)[1]: m.launches for m in counters}
        print(f"dragon main path through {name}: {DRAGON_SIZE}x{DRAGON_SIZE}@"
              f"{DRAGON_SPP} depth {DRAGON_DEPTH} seed 0 on "
              f"{res12.device}: {res12.rays_traced} rays in {res12.seconds:.4f} "
              f"s = {res12.mrays_per_sec:.3f} Mrays/s in {res12.iterations} "
              f"pool iterations (warm-up {warm.seconds:.4f} s, "
              f"{warm.rays_traced} rays; {card}); launches {moved}; {name} "
              f"{kernel_ms:.3f} ms = {kernel_ms / 1e3 / res12.seconds:.2%} of "
              f"render() (CUDA events)", flush=True)
        if (mod.launches != res12.iterations or sum(moved.values())
                != mod.launches + threefry.launches):
            raise AssertionError(f"the dragon main path through {name} "
                                 f"launched {moved} in {res12.iterations} "
                                 f"iterations")
        if res12.rays_traced != warm.rays_traced:
            raise AssertionError(f"two dragon renders through {name} differ")
        xyz, img = res12.xyz, res12.image
        for label, arr in (("xyz", xyz), ("image", img)):
            if (arr.shape != (DRAGON_SIZE, DRAGON_SIZE, 3)
                    or not np.isfinite(arr).all()):
                raise AssertionError(f"dragon {label} is not finite "
                                     f"({DRAGON_SIZE}, {DRAGON_SIZE}, 3)")
        # The camera's horizontal axis points to -x: the red wall (x = 100)
        # is on the image's left, the green one (x = 0) on its right; the
        # walls' middle band, as fractions of the frame.
        q = DRAGON_SIZE / 256
        rows, c0, c1 = slice(int(64 * q), int(192 * q)), int(8 * q), int(40 * q)
        dleft = img[rows, c0:c1].mean(axis=(0, 1))
        dright = img[rows, -c1:-c0].mean(axis=(0, 1))
        mesh_y = float(xyz[mesh, 1].mean())
        print(f"dragon main path through {name}: ACEScg left wall "
              f"{np.round(dleft, 4).tolist()}, right wall "
              f"{np.round(dright, 4).tolist()}; mesh region ({int(mesh.sum())} "
              f"pixels) mean Y {mesh_y:.5f}, lit (Y > 1e-3) "
              f"{float((xyz[mesh, 1] > 1e-3).mean()):.2%}; image mean Y "
              f"{float(xyz[..., 1].mean()):.5f}", flush=True)
        if not (dleft[0] > dleft[1] and dright[1] > dright[0]):
            raise AssertionError("dragon walls: expected red on the left, "
                                 "green on the right")
        if not mesh_y > 1e-3:
            raise AssertionError(f"dragon mesh region is black (Y {mesh_y})")
        wall12, busy12, _ = profiling.device_profile(
            lambda: dragon_render(ctx, 2))
        print(f"dragon main path through {name}, {DRAGON_SIZE}x{DRAGON_SIZE}@2 "
              f"under "
              f"torch.profiler: wall {wall12:.4f} s, device busy "
              f"{busy12:.4f} s, idle share {1 - busy12 / wall12:.2%}",
              flush=True)
        dres[name] = res12
        dragon_runs[name] = {
            "launches": moved[mod.__name__.rsplit(".", 1)[1]],
            "rays": res12.rays_traced,
            "seconds": res12.seconds, "mrays_per_sec": res12.mrays_per_sec,
            "iterations": res12.iterations,
            "kernel_share": kernel_ms / 1e3 / res12.seconds,
            "profiled_idle_share_2spp": 1 - busy12 / wall12}
    compare_xyz("dragon main path: row-stack vs BVH4 kernel (XYZ after "
                "firefly rejection)",
                torch.as_tensor(dres["bvh4_rowstack"].xyz.reshape(-1, 3)),
                dres["bvh4_rowstack"].rays_traced,
                torch.as_tensor(dres["bvh4_traverse"].xyz.reshape(-1, 3)),
                dres["bvh4_traverse"].rays_traced, 1)
    return rows10, dragon_runs


def main() -> None:
    # 1. The card.
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)

    # 2. Build.
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    print(f"build: {lib_path.name} (nvcc, or an earlier build of the same "
          f"sources) in {time.perf_counter() - t0:.2f} s", flush=True)
    log = lib_path.with_suffix(".log")
    log_text = log.read_text() if log.exists() else ""
    for line in log_text.splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            print(f"ptxas: {line.strip()}", flush=True)
    usage = _build.ptxas_usage(log_text)
    for name in ("megakernel_rgb", "megakernel_spectral"):
        if name not in usage:
            raise AssertionError(f"no ptxas report of {name} in {log}")
        if usage[name][1] or usage[name][2]:
            raise AssertionError(f"{name} spills registers: {usage[name]}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grids = {}
    for name, mod in (("megakernel_rgb", megakernel),
                      ("megakernel_spectral", megakernel_spectral)):
        regs, spill_st, spill_ld = usage[name]
        blocks, threads = megakernel.card_grid(mod.ENTRY, torch.device("cuda"))
        grids[name] = dict(registers=regs, spill_bytes=spill_st + spill_ld,
                           blocks=blocks, threads=threads,
                           blocks_per_sm=blocks / sms)
        print(f"grid: {name}: {regs} registers, spill stores {spill_st} B, "
              f"loads {spill_ld} B; persistent grid {blocks} blocks x "
              f"{threads} threads ({blocks / sms:g} per SM of {sms}; "
              f"{blocks * threads} resident threads)", flush=True)

    # 3. Cipher, bit for bit.
    rs = np.random.RandomState(0)
    n_keys = 1 << 20
    keys = torch.as_tensor(rs.randint(0, 2**32, (n_keys, 2), dtype=np.uint64)
                           .astype(np.int64), device="cuda")
    depths = torch.as_tensor(rs.randint(0, 64, n_keys).astype(np.int64),
                             device="cuda")
    cipher = {}
    for n, salt in ((12, 0), (5, camera.CAMERA_SALT), (1, wavefront.LAMBDA_SALT)):
        got = threefry.uniforms_for_keys(keys, depths, n, salt)
        want = threefry.uniforms_for_keys_reference(keys, depths, n, salt)
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        print(f"cipher: n={n} salt={salt:#x} keys={n_keys} bit-identical={same}",
              flush=True)
        if not same:
            raise AssertionError("device Threefry differs from the torch twin")
    cipher["ms"] = cuda_ms(lambda: threefry.uniforms_for_keys(keys, depths, 12, 0), 20)
    cipher["plain_ms"] = cuda_ms(
        lambda: threefry.uniforms_for_keys_reference(keys, depths, 12, 0), 3)
    cipher["bound_ms"] = 1e3 * max(
        n_keys * (8 * CIPHER_INT + 12 * UNIFORM_INT) / INT32_OPS_PER_S,
        n_keys * (8 + 4 + 12 * 4) / HBM_BYTES_PER_S)
    print(f"cipher: 12 uniforms x {n_keys} keys: kernel {cipher['ms']:.4f} ms, "
          f"plain {cipher['plain_ms']:.4f} ms, bound {cipher['bound_ms']:.4f} ms "
          f"({card})", flush=True)

    # 4. Kernel vs twin on the card, the twin on the card's layout: at
    # 64x64@4 depth 8, at the multi-slot and multi-sample layouts and at the
    # main path's frame, 256x256 depth 50, for two sample chunks, the main
    # path's first and its last.
    cs, meta = compiler.compile_scene(cornell_box(), "cuda")
    tables = megakernel.pack_tables(cs)
    errs = []
    for nx, spp, depth, seed, offset in ((64, 4, 8, 3, 0), MULTI_SLOT,
                                         MULTI_SAMPLE, (256, 2, 50, 0, 0),
                                         (256, 2, 50, 0, 1022)):
        errs.append(compare(cs, meta, tables, nx, spp, depth, seed, offset))
    for mod in (megakernel, megakernel_spectral):
        for name, layout, spp_slot in (("multi-slot", MULTI_SLOT, 1),
                                       ("multi-sample", MULTI_SAMPLE, 2)):
            lay = card_layout(mod, layout[0], layout[1])
            resident = lay["blocks"] * lay["threads"]
            if not (lay["slots"] > resident and lay["slots"] % resident
                    and lay["spp_slot"] >= spp_slot):
                raise AssertionError(
                    f"{mod.__name__}: {lay['slots']} slots of "
                    f"{lay['spp_slot']} samples at the {name} layout on "
                    f"{resident} threads")
    max_abs_err = max(errs)
    timed = {}
    for nx, spp, depth in ((64, 4, 8), (256, 2, 50)):
        s = path.RenderSettings(max_depth=depth)
        key = rng.render_key(0, device="cuda")
        timed[nx] = (
            cuda_ms(lambda: megakernel.render_slots(
                cs, meta, s, nx, nx, spp, key, tables=tables), 10),
            cuda_ms(lambda: megakernel.render_slots_reference(
                cs, meta, s, nx, nx, spp, key,
                min_slots=megakernel.card_min_slots(megakernel.ENTRY,
                                                    cs.device)), 2))
        print(f"kernel-vs-twin: time at {nx}x{nx}@{spp} depth {depth}: kernel "
              f"{timed[nx][0]:.4f} ms, plain twin {timed[nx][1]:.4f} ms ({card})",
              flush=True)
    mk_ms_2, plain_ms = timed[256]
    s = path.RenderSettings(max_depth=50)
    _, rgb_rays, rgb_draws = megakernel.render_slots(
        cs, meta, s, 256, 256, 2, rng.render_key(0, device="cuda"),
        tables=tables, draws=True)
    rgb_bound_2 = launch_bound("megakernel_rgb at 256x256@2 depth 50",
                               int(rgb_rays), 256 * 256 * 2, rgb_draws,
                               cs.prims.kind.tolist(), False,
                               card_layout(megakernel, 256, 2),
                               tensor_bytes(tables), card)

    # 4, spectral. The spectral megakernel against its plain version at
    # the RGB kernel's layouts: 64x64@4 depth 8, the multi-slot and
    # multi-sample layouts, and the spectral main path's frame, 500x500
    # depth 50, for its first and its last sample chunk.
    scs, smeta = compiler.compile_scene(cornell_box_pyramid_spectral(), "cuda")
    stables = megakernel_spectral.pack_spectral_tables(scs)
    serrs = []
    for nx, spp, depth, seed, offset in ((64, 4, 8, 3, 0), MULTI_SLOT,
                                         MULTI_SAMPLE, (500, 2, 50, 0, 0),
                                         (500, 2, 50, 0, 254)):
        serrs.append(compare_spectral(scs, smeta, stables, nx, spp, depth, seed,
                                      offset))
    s = path.RenderSettings(max_depth=50)
    key = rng.render_key(0, device="cuda")
    spec_min = megakernel.card_min_slots(megakernel_spectral.ENTRY,
                                         scs.device)
    spec_ms_2 = cuda_ms(lambda: megakernel_spectral.render_slots_spectral(
        scs, smeta, s, 500, 500, 2, key, tables=stables), 10)
    spec_plain_ms = cuda_ms(
        lambda: megakernel_spectral.render_slots_spectral_reference(
            scs, smeta, s, 500, 500, 2, key, min_slots=spec_min), 2)
    print(f"kernel-vs-twin: time at 500x500@2 depth 50: spectral kernel "
          f"{spec_ms_2:.4f} ms, plain version {spec_plain_ms:.4f} ms "
          f"({card})", flush=True)
    _, spec_rays, spec_draws = megakernel_spectral.render_slots_spectral(
        scs, smeta, s, 500, 500, 2, key, tables=stables, draws=True)
    stable_bytes = tensor_bytes(stables.rgb) + tensor_bytes(stables[1:])
    spec_bound_2 = launch_bound(
        "megakernel_spectral at 500x500@2 depth 50", int(spec_rays),
        500 * 500 * 2, spec_draws, scs.prims.kind.tolist(), True,
        card_layout(megakernel_spectral, 500, 2), stable_bytes,
        card)

    # 5. The main path, through the entry points a user calls; the timed
    # run's launch between CUDA events.
    settings = path.RenderSettings(max_depth=50)
    ctx = renderer.RenderContext(cornell_box(), device="cuda")
    megakernel.launches = 0
    threefry.launches = 0
    warm = renderer.render(None, 256, 256, 1024, settings, seed=0,
                           mode="wavefront", context=ctx, device="cuda")
    with profiling.event_timed(megakernel, "render_slots") as times:
        res = renderer.render(None, 256, 256, 1024, settings, seed=0,
                              mode="wavefront", context=ctx, device="cuda")
    mk_ms = profiling.event_ms(times)
    launches = megakernel.launches
    img = res.image
    lay = card_layout(megakernel, 256, 1024)
    print(f"main path: cornell 256x256@1024 depth 50 seed 0 on {res.device}: "
          f"{res.rays_traced} rays in {res.seconds:.4f} s = "
          f"{res.mrays_per_sec:.2f} Mrays/s (warm-up run {warm.seconds:.4f} s; "
          f"{card}); megakernel launches {launches}; the timed launch "
          f"{mk_ms:.4f} ms (CUDA events, {len(times)} call) = "
          f"{mk_ms / 1e3 / res.seconds:.2%} of render(); grid {lay['blocks']} x "
          f"{lay['threads']}, {lay['replicas']} replicas, {lay['slots']} slots "
          f"of {lay['spp_slot']} samples, {lay['slots_per_thread']:.3f} per "
          f"resident thread", flush=True)
    if launches != 2 or len(times) != 1:
        raise AssertionError(f"the main path launched the megakernel "
                             f"{launches} times, expected 2")
    if res.rays_traced != warm.rays_traced or not np.array_equal(img, warm.image):
        raise AssertionError("two runs of the same render differ")
    if img.shape != (256, 256, 3) or not np.isfinite(img).all():
        raise AssertionError("main-path image is not finite (256, 256, 3)")
    left = img[64:192, 4:24].mean(axis=(0, 1))
    right = img[64:192, -24:-4].mean(axis=(0, 1))
    light = float(np.percentile(img[:64].max(axis=2), 99.5))
    print(f"main path: left wall rgb {np.round(left, 4).tolist()}, right wall "
          f"rgb {np.round(right, 4).tolist()}, light patch {light:.4f}, "
          f"image mean {float(img.mean()):.5f}", flush=True)
    if not (left[1] > left[0] and right[0] > right[1]):
        raise AssertionError("walls: expected green on the left, red on the right")
    if abs(light - 15.0) > 0.5:
        raise AssertionError(f"ceiling light patch {light}, expected ~15")
    # One more launch of the same render with the draw counter buffer: it
    # repeats the image and rays, and its counts give the bound.
    acc_d, rays_d, draws_d = megakernel.render_slots(
        ctx.cs, ctx.meta, settings, 256, 256, 1024,
        rng.render_key(0, device="cuda"), tables=ctx.tables(), draws=True)
    if int(rays_d) != res.rays_traced or not np.array_equal(
            canvas(acc_d, 256, 1024), img):
        raise AssertionError("the launch with draw counts differs from the "
                             "main path's")
    main_bound = launch_bound(
        "megakernel_rgb per launch on the main path", res.rays_traced,
        256 * 256 * 1024, draws_d, cs.prims.kind.tolist(), False, lay,
        tensor_bytes(ctx.tables()), card)
    print(f"main path: megakernel_rgb {mk_ms:.4f} ms per launch at "
          f"{main_bound['bound_ms'] / mk_ms:.2%} of its bound "
          f"({main_bound['bound_ms_eager'] / mk_ms:.2%} of the eager count's) "
          f"({card})", flush=True)

    # 6. The spectral main path, through the same entry points.
    sctx = renderer.RenderContext(cornell_box_pyramid_spectral(), device="cuda")
    megakernel.launches = 0
    megakernel_spectral.launches = 0
    threefry.launches = 0
    swarm = renderer.render(None, 500, 500, 256, settings, seed=0,
                            mode="wavefront", context=sctx, device="cuda")
    with profiling.event_timed(megakernel_spectral,
                               "render_slots_spectral") as stimes:
        sres = renderer.render(None, 500, 500, 256, settings, seed=0,
                               mode="wavefront", context=sctx, device="cuda")
    spec_ms = profiling.event_ms(stimes)
    spec_launches = megakernel_spectral.launches
    slay = card_layout(megakernel_spectral, 500, 256)
    print(f"spectral main path: pyramid 500x500@256 depth 50 seed 0 on "
          f"{sres.device}: {sres.rays_traced} rays in {sres.seconds:.4f} s = "
          f"{sres.mrays_per_sec:.2f} Mrays/s (warm-up run {swarm.seconds:.4f} s; "
          f"{card}); spectral megakernel launches {spec_launches}; the timed "
          f"launch {spec_ms:.4f} ms (CUDA events, {len(stimes)} call) = "
          f"{spec_ms / 1e3 / sres.seconds:.2%} of render(); grid "
          f"{slay['blocks']} x {slay['threads']}, {slay['replicas']} replicas, "
          f"{slay['slots']} slots of {slay['spp_slot']} samples, "
          f"{slay['slots_per_thread']:.3f} per resident thread", flush=True)
    if spec_launches != 2 or len(stimes) != 1:
        raise AssertionError(f"the spectral main path launched the spectral "
                             f"megakernel {spec_launches} times, expected 2")
    if (sres.rays_traced != swarm.rays_traced
            or not np.array_equal(sres.image, swarm.image)
            or not np.array_equal(sres.xyz, swarm.xyz)):
        raise AssertionError("two runs of the same spectral render differ")
    for name, arr in (("xyz", sres.xyz), ("image", sres.image)):
        if arr.shape != (500, 500, 3) or not np.isfinite(arr).all():
            raise AssertionError(f"spectral {name} is not finite (500, 500, 3)")
    simg = sres.image
    sleft = simg[125:375, 100].mean(axis=0)
    sright = simg[125:375, -100].mean(axis=0)
    light_y = float(np.percentile(sres.xyz[:125, :, 1], 99.5))
    want_y = 15.0 * cie.CIE_Y_INTEGRAL
    print(f"spectral main path: ACEScg left wall (x=100) "
          f"{np.round(sleft, 4).tolist()}, right wall (x=400) "
          f"{np.round(sright, 4).tolist()}; light patch Y {light_y:.4f} "
          f"(expected {want_y:.4f}); mean Y {float(sres.xyz[..., 1].mean()):.5f}",
          flush=True)
    if not (sleft[1] > sleft[0] and sright[0] > sright[1]):
        raise AssertionError("spectral walls: expected green on the left, red "
                             "on the right")
    if abs(light_y - want_y) > 0.005 * want_y:
        raise AssertionError(f"spectral light patch Y {light_y}, expected "
                             f"{want_y} within 0.5%")
    st = sctx.tables()
    sacc_d, srays_d, sdraws_d = megakernel_spectral.render_slots_spectral(
        sctx.cs, sctx.meta, settings, 500, 500, 256,
        rng.render_key(0, device="cuda"), tables=st, draws=True)
    if int(srays_d) != sres.rays_traced or not np.array_equal(
            convert.firefly_rejection(canvas(sacc_d, 500, 256).astype(
                np.float64)).astype(np.float32), sres.xyz):
        raise AssertionError("the spectral launch with draw counts differs "
                             "from the main path's")
    smain_bound = launch_bound(
        "megakernel_spectral per launch on the main path", sres.rays_traced,
        500 * 500 * 256, sdraws_d, scs.prims.kind.tolist(), True, slay,
        tensor_bytes(st.rgb) + tensor_bytes(st[1:]), card)
    print(f"spectral main path: megakernel_spectral {spec_ms:.4f} ms per launch "
          f"at {smain_bound['bound_ms'] / spec_ms:.2%} of its bound "
          f"({smain_bound['bound_ms_eager'] / spec_ms:.2%} of the eager "
          f"count's) ({card})", flush=True)

    # 7. The traversal kernel against its plain version, at two scales,
    # each scene compiled and its tree built and packed by RenderContext.
    # The first is the main path's context.
    bctx = renderer.RenderContext(cornell_box_obj(), device="cuda")
    dctx = renderer.RenderContext(dragon_stand_in(), device="cuda")
    found, rays7 = {}, {}
    for label, ctx, seed in (("cornell_box_obj", bctx, 7),
                             ("dragon stand-in", dctx, 8)):
        ks = ctx.intersect.ks
        print(f"traversal build: {label}, {ctx.meta.n_prims} prims, "
              f"{ks.nodes.shape[0]} nodes (SAH, leaf 4); compile and build "
              f"{ctx.build_seconds:.3f} s", flush=True)
        rays7[label] = traversal_rays(ks, ctx.cs.camera, TRAVERSE_RAYS, seed)
        found[label] = compare_traversal(label, ks, rays7[label], card)
    trav, dtrav = found["cornell_box_obj"], found["dragon stand-in"]

    # 8. The pool through the kernel against the pool through the plain
    # traversal, on the same tree.
    plain_inter = functools.partial(traverse.intersect_bvh, bctx.cs.prims,
                                    bctx.intersect.ks.tree)
    s8 = path.RenderSettings(max_depth=50)
    key8 = rng.render_key(0, device="cuda")
    pool8 = min(32 * 32 * 4, renderer.POOL_MAX)
    before = bvh_kernel.launches
    acc_k, rays_k, it_k = wavefront.trace_pool(
        bctx.cs, bctx.meta, s8, bctx.intersect, 32, 32, 4, key8, pool8)
    launched = bvh_kernel.launches - before
    acc_p, rays_p, it_p = wavefront.trace_pool(
        bctx.cs, bctx.meta, s8, plain_inter, 32, 32, 4, key8, pool8)
    torch.cuda.synchronize()
    img_k, img_p = acc_k / 4, acc_p / 4
    rays_k, rays_p = int(rays_k), int(rays_p)
    pix_err = (img_k - img_p).abs().amax(dim=1)
    share = float((pix_err <= PIXEL_ATOL).float().mean())
    rays_rel = abs(rays_k - rays_p) / rays_p
    mean_rel = abs(float(img_k.mean()) / float(img_p.mean()) - 1)
    print(f"pool: cornell_box_obj 32x32@4 depth 50 (pool {pool8}): kernel "
          f"rays {rays_k} in {it_k} iterations ({launched} kernel launches), "
          f"plain traversal rays {rays_p} in {it_p}; rel {rays_rel:.2e} (tol "
          f"{RAYS_RTOL}); pixels within {PIXEL_ATOL}: {share:.6f} (tol "
          f"{PIXEL_SHARE}); max abs err {float(pix_err.max()):.3e}; mean rel "
          f"{mean_rel:.2e} (tol {MEAN_RTOL})", flush=True)
    if not (bool(torch.isfinite(img_k).all()) and rays_rel <= RAYS_RTOL
            and share >= PIXEL_SHARE and mean_rel <= MEAN_RTOL
            and launched == it_k):
        raise AssertionError("the pool through the traversal kernel disagrees "
                             "with the pool through the plain traversal")

    # 9. The BVH main path, through the entry points a user calls.
    megakernel.launches = megakernel_spectral.launches = 0
    bvh_kernel.launches = threefry.launches = 0
    warm = renderer.render(None, 256, 256, 128, settings, seed=0,
                           mode="wavefront", context=bctx, device="cuda")
    if bvh_kernel.launches != warm.iterations:
        raise AssertionError(f"warm-up: {bvh_kernel.launches} traversal "
                             f"launches for {warm.iterations} pool iterations")
    megakernel.launches = megakernel_spectral.launches = 0
    bvh_kernel.launches = threefry.launches = 0
    with profiling.event_timed(bvh_kernel, "closest_hit") as times:
        ores = renderer.render(None, 256, 256, 128, settings, seed=0,
                               mode="wavefront", context=bctx, device="cuda")
    kernel_s = profiling.event_ms(times) / 1e3
    bvh_launches, cipher_launches = bvh_kernel.launches, threefry.launches
    mega_moved = megakernel.launches + megakernel_spectral.launches
    oimg = ores.image
    print(f"BVH main path: cornell_box_obj 256x256@128 depth 50 seed 0 on "
          f"{ores.device}: {ores.rays_traced} rays in {ores.seconds:.4f} s = "
          f"{ores.mrays_per_sec:.3f} Mrays/s in {ores.iterations} pool "
          f"iterations (warm-up run {warm.seconds:.4f} s, {warm.rays_traced} "
          f"rays; {card}); traversal launches {bvh_launches}, cipher launches "
          f"{cipher_launches}, megakernel launches {mega_moved}; traversal "
          f"kernel {kernel_s:.4f} s = {kernel_s / ores.seconds:.2%} of "
          f"render() (CUDA events)", flush=True)
    if bvh_launches != ores.iterations or mega_moved != 0:
        raise AssertionError(f"the BVH main path launched the traversal "
                             f"kernel {bvh_launches} times in "
                             f"{ores.iterations} pool iterations, and the "
                             f"megakernels {mega_moved} times")
    if oimg.shape != (256, 256, 3) or not np.isfinite(oimg).all():
        raise AssertionError("BVH main-path image is not finite (256, 256, 3)")
    oleft = oimg[64:192, 4:24].mean(axis=(0, 1))
    oright = oimg[64:192, -24:-4].mean(axis=(0, 1))
    olight = float(np.percentile(oimg[:64].max(axis=2), 99.5))
    print(f"BVH main path: left wall rgb {np.round(oleft, 4).tolist()}, right "
          f"wall rgb {np.round(oright, 4).tolist()}, light patch {olight:.4f}, "
          f"image mean {float(oimg.mean()):.5f}", flush=True)
    if not (oleft[1] > oleft[0] and oright[0] > oright[1]):
        raise AssertionError("walls: expected green on the left, red on the right")
    if abs(olight - 15.0) > 0.5:
        raise AssertionError(f"ceiling light patch {olight}, expected ~15")
    wall, busy, top = profiling.device_profile(lambda: renderer.render(
        None, 256, 256, 16, settings, seed=0, mode="wavefront", context=bctx,
        device="cuda"))
    print(f"BVH main path profile: cornell_box_obj 256x256@16 depth 50 under "
          f"torch.profiler: wall {wall:.4f} s, device busy {busy:.4f} s, idle "
          f"share {1 - busy / wall:.2%}", flush=True)
    for dt, name, count in top[:6]:
        print(f"  {dt / 1e3:10.3f} ms  x{count}  {name[:90]}", flush=True)

    rows10, dragon_runs = row_stack_phases(bctx, dctx, rays7, card)
    del dctx, rays7
    drow = rows10["dragon"]

    print(json.dumps({
        "kernels": [{
            "name": "megakernel_rgb",
            "route": "cuda",
            "source": "izpi_tpu_torch/csrc/megakernel_rgb.cu",
            "replaces": "izpi_tpu/ops/megakernel.py:628",
            "launches": launches,
            "max_abs_err": max_abs_err,
            "ms": mk_ms,
            "plain_ms": plain_ms,
            "bound_ms": main_bound["bound_ms"],
            "bound_by": main_bound["bound_by"],
            "library_ms": None,
            "bound_ms_eager": main_bound["bound_ms_eager"],
            "pairs_per_scatter": main_bound["pairs"] / main_bound["scatters"],
            "ms_at_2": mk_ms_2,
            "bound_ms_at_2": rgb_bound_2["bound_ms"],
            "layout": lay,
            **grids["megakernel_rgb"],
        }, {
            "name": "megakernel_spectral",
            "route": "cuda",
            "source": "izpi_tpu_torch/csrc/megakernel_spectral.cu",
            "replaces": "izpi_tpu/ops/megakernel_spectral.py:267",
            "launches": spec_launches,
            "max_abs_err": max(serrs),
            "ms": spec_ms,
            "plain_ms": spec_plain_ms,
            "bound_ms": smain_bound["bound_ms"],
            "bound_by": smain_bound["bound_by"],
            "library_ms": None,
            "bound_ms_eager": smain_bound["bound_ms_eager"],
            "pairs_per_scatter": smain_bound["pairs"] / smain_bound["scatters"],
            "ms_at_2": spec_ms_2,
            "bound_ms_at_2": spec_bound_2["bound_ms"],
            "layout": slay,
            **grids["megakernel_spectral"],
        }, {
            "name": "bvh4_traverse",
            "route": "cuda",
            "source": "izpi_tpu_torch/csrc/bvh4_traverse.cu",
            "replaces": "izpi_tpu/ops/bvh_kernel.py:133",
            "launches": bvh_launches,
            "max_abs_err": max(trav["max_abs_err"], dtrav["max_abs_err"]),
            "ms": trav["ms"],
            "plain_ms": trav["plain_ms"],
            "bound_ms": trav["bound_ms"],
            "bound_by": trav["bound_by"],
            "library_ms": None,
        }, {
            "name": "bvh4_rowstack",
            "route": "cuda",
            "source": "izpi_tpu_torch/csrc/bvh4_rowstack.cu",
            "replaces": "izpi_tpu/ops/bvh_rowkernel.py:126",
            "launches": dragon_runs["bvh4_rowstack"]["launches"],
            "max_abs_err": max(r["max_abs_err"] for r in rows10.values()),
            "ms": drow["ms"],
            "plain_ms": drow["plain_ms"],
            "bound_ms": drow["bound_ms"],
            "bound_by": drow["bound_by"],
            "library_ms": None,
        }],
        "device_functions": [{
            "name": "threefry2x32",
            "source": "izpi_tpu_torch/csrc/threefry.cuh",
            "replaces": "izpi_tpu/ops/threefry.py:30",
            "inlined_in": ["megakernel_rgb", "megakernel_spectral"],
            "bvh_main_path_launches": cipher_launches,
            "bit_identical": True,
            "ms": cipher["ms"],
            "plain_ms": cipher["plain_ms"],
            "bound_ms": cipher["bound_ms"],
            "bound_by": "operations",
        }],
        "shapes": {
            "megakernel_rgb": "ms, bound_ms: per launch on its main path, "
                              "cornell 256x256@1024 depth 50 (CUDA events "
                              "around the timed render()'s launch); "
                              "plain_ms, ms_at_2, bound_ms_at_2: the main "
                              "path's frame at 2 spp (the plain version "
                              "would take hours at 1024)",
            "megakernel_spectral": "ms, bound_ms: per launch on its main "
                                   "path, the spectral pyramid 500x500@256 "
                                   "depth 50; plain_ms, ms_at_2, "
                                   "bound_ms_at_2: 500x500@2 depth 50",
            "cipher_ms": f"12 uniforms x {n_keys} keys",
            "bvh4_traverse": f"{TRAVERSE_RAYS} rays (half camera, half "
                             f"incoherent) on cornell_box_obj's tree",
            "bvh4_rowstack": f"{TRAVERSE_RAYS} rays on phase 7's recipe, "
                             f"sorted, on the dragon scene's leaf-64 tree "
                             f"(its main path's)"},
        "library_ms": "null: no PyTorch call computes a path tracer's render "
                      "loop or a BVH traversal",
        "bvh4_traverse_dragon": dtrav,
        "bvh4_rowstack_phase10": rows10,
        "main_path": {"rays": res.rays_traced, "seconds": res.seconds,
                      "mrays_per_sec": res.mrays_per_sec},
        "spectral_main_path": {"rays": sres.rays_traced,
                               "seconds": sres.seconds,
                               "mrays_per_sec": sres.mrays_per_sec},
        "bvh_main_path": {"rays": ores.rays_traced, "seconds": ores.seconds,
                          "mrays_per_sec": ores.mrays_per_sec,
                          "iterations": ores.iterations,
                          "kernel_share": kernel_s / ores.seconds,
                          "profiled_idle_share_16spp": 1 - busy / wall},
        "dragon_main_path": dragon_runs,
        "card": card,
    }), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
