#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (izpi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from izpi_tpu_torch/csrc (one nvcc call,
sm_90a) and then, in phases, each reporting on a line of its own:
  1. the card: `nvidia-smi --query-gpu=name,power.limit` (fails without CUDA);
  2. the build, and its seconds;
  3. cipher: the device Threefry (`izpi_threefry_uniforms`) on 1M random
     keys equals the PyTorch twin bit for bit, for the bounce, camera and λ
     draws;
  4. kernel vs twin, both on the card, within stated tolerances:
     - the RGB megakernel: Cornell 64×64 at 4 spp, depth 8, seed 3 (two
       replicas per pixel), and the RGB main path's layout, 256×256 at depth
       50, seed 0 (one slot per pixel), for samples [0, 2) and [1022, 1024);
     - the spectral megakernel: the spectral pyramid 64×64 at 4 spp, depth
       8, seed 3, and the spectral main path's layout, 500×500 at depth 50,
       seed 0, for samples [0, 2) and [254, 256);
     each kernel and its twin timed at its main path's layout;
  5. RGB main path: `render(cornell_box(), 256, 256, 1024, max_depth=50,
     seed=0, mode="wavefront", device="cuda")`, one warm-up and one timed
     run; the RGB megakernel's launch counter must read 2, the image must be
     finite, green on the left, red on the right, with the ceiling light at
     15;
  6. spectral main path: `render(cornell_box_pyramid_spectral(), 500, 500,
     256, max_depth=50, seed=0, mode="wavefront", device="cuda")`, one
     warm-up and one timed run; the spectral megakernel's counter must read
     2, the runs must agree, XYZ and ACEScg must be finite, green on the left
     and red on the right, and the light patch's Y must be 15·21.3768.
The line before the last is a JSON object describing the kernels, each with
its time, its plain version's time and its bound (the least time the card
could take for the work this run's rays needed); the last is {"ok": true,
"device": {...}}. Any failure raises and exits non-zero. Imports nothing of
JAX.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from izpi_tpu_torch import camera
from izpi_tpu_torch.core import rng
from izpi_tpu_torch.integrator import path, wavefront
from izpi_tpu_torch.ops import _build, megakernel, megakernel_spectral, threefry
from izpi_tpu_torch.render import renderer
from izpi_tpu_torch.scene import compiler
from izpi_tpu_torch.scene.library.cornell import cornell_box
from izpi_tpu_torch.scene.library.cornell_spectral import (
    cornell_box_pyramid_spectral)
from izpi_tpu_torch.spectral import cie

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
SPECTRAL_SAMPLE_FP = 20 + 11 + 51   # λ sampling, background SPD, XYZ deposit
SPECTRAL_SAMPLE_INT = 30            # λ sampling's binary search
RGB_SAMPLE_FP = 9        # RGB deposit: DeNAN and add, three channels


def bound_ms(rays: int, samples: int, prim_kinds, spectral: bool,
             out_bytes: int, table_bytes: int):
    """The least milliseconds the card could take for a megakernel launch
    that traced `rays` rays over `samples` camera samples, and what bounds
    it ("bytes" or "operations").

    Counts only work every ray must do: each ray tests every primitive;
    every ray but a sample's last scatters, which draws 12 uniforms (8
    cipher calls) and shades at least as a dielectric does; every sample
    draws its camera ray (7 cipher calls, 5 uniforms), and a spectral one
    its λ (3 more calls, 1 uniform). The diffuse bounces' light sampling
    and pdf are left out, so the true bound is higher. Bytes: the tables
    read once and the outputs written once."""
    scatter = rays - samples
    prim_fp = sum(PRIM_FP[int(k)] for k in prim_kinds)
    n_prims = len(prim_kinds)
    fp = (rays * prim_fp + scatter * (SCATTER_FP + 12 * UNIFORM_FP)
          + samples * (CAMERA_FP + 5 * UNIFORM_FP))
    int_ops = (rays * PRIM_INT * n_prims
               + scatter * (8 * CIPHER_INT + 12 * UNIFORM_INT)
               + samples * (7 * CIPHER_INT + 5 * UNIFORM_INT))
    if spectral:
        fp += samples * (SPECTRAL_SAMPLE_FP + UNIFORM_FP)
        int_ops += samples * (3 * CIPHER_INT + UNIFORM_INT + SPECTRAL_SAMPLE_INT)
    else:
        fp += samples * RGB_SAMPLE_FP
    t_ops = max(fp / FP32_OPS_PER_S, int_ops / INT32_OPS_PER_S)
    t_bytes = (out_bytes + table_bytes) / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card over reps runs, after one
    warm-up run, timed with CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    acc_p, rays_p = megakernel.render_slots_reference(cs, meta, s, n, n, spp,
                                                      key, offset)
    torch.cuda.synchronize()
    img_k, img_p = acc_k / spp, acc_p / spp
    rays_k, rays_p = int(rays_k), int(rays_p)
    pix_err = (img_k - img_p).abs().amax(dim=1)
    max_abs_err = float(pix_err.max())
    share = float((pix_err <= PIXEL_ATOL).float().mean())
    mean_k, mean_p = float(img_k.mean()), float(img_p.mean())
    rays_rel = abs(rays_k - rays_p) / rays_p
    mean_rel = abs(mean_k - mean_p) / mean_p
    slots = n * n * megakernel.pick_replication(n * n, spp)
    print(f"kernel-vs-twin: cornell {n}x{n}@{spp} depth {depth} seed {seed} "
          f"offset {offset} ({slots} slots): rays {rays_k} vs {rays_p} (rel "
          f"{rays_rel:.2e}, tol {RAYS_RTOL}); pixels within {PIXEL_ATOL}: "
          f"{share:.6f} (tol {PIXEL_SHARE}); max abs err {max_abs_err:.3e}; "
          f"mean {mean_k:.7f} vs {mean_p:.7f} (rel {mean_rel:.2e}, tol "
          f"{MEAN_RTOL})", flush=True)
    if not (bool(torch.isfinite(img_k).all()) and rays_rel <= RAYS_RTOL
            and share >= PIXEL_SHARE and mean_rel <= MEAN_RTOL):
        raise AssertionError(f"CUDA megakernel disagrees with its plain twin "
                             f"at {n}x{n}@{spp} depth {depth} offset {offset}")
    return max_abs_err


def compare_spectral(cs, meta, tables, n: int, spp: int, depth: int, seed: int,
                     offset: int):
    """The spectral pyramid n x n at spp samples from `offset` through the
    CUDA spectral megakernel and through its plain version, both on the
    card; print the deviations and raise unless they are within the
    tolerances above. Returns (largest absolute XYZ error, kernel rays)."""
    s = path.RenderSettings(max_depth=depth)
    key = rng.render_key(seed, device="cuda")
    acc_k, rays_k = megakernel_spectral.render_slots_spectral(
        cs, meta, s, n, n, spp, key, offset, tables=tables)
    acc_p, rays_p = megakernel_spectral.render_slots_spectral_reference(
        cs, meta, s, n, n, spp, key, offset)
    torch.cuda.synchronize()
    xyz_k, xyz_p = acc_k / spp, acc_p / spp
    rays_k, rays_p = int(rays_k), int(rays_p)
    diff = (xyz_k - xyz_p).abs()
    max_abs_err = float(diff.max())
    max_rel_err = float((diff / xyz_p.abs().clamp(min=1e-6)).max())
    share = float((diff <= XYZ_ATOL + XYZ_RTOL * xyz_p.abs()).all(dim=1)
                  .float().mean())
    mean_k, mean_p = float(xyz_k[:, 1].mean()), float(xyz_p[:, 1].mean())
    rays_rel = abs(rays_k - rays_p) / rays_p
    mean_rel = abs(mean_k - mean_p) / mean_p
    slots = n * n * megakernel.pick_replication(n * n, spp)
    print(f"kernel-vs-twin: spectral pyramid {n}x{n}@{spp} depth {depth} seed "
          f"{seed} offset {offset} ({slots} slots): rays {rays_k} vs {rays_p} "
          f"(rel {rays_rel:.2e}, tol {RAYS_RTOL}); pixels with XYZ within "
          f"{XYZ_ATOL} + {XYZ_RTOL}|plain|: {share:.6f} (tol {PIXEL_SHARE}); max "
          f"abs err {max_abs_err:.3e}; max rel err {max_rel_err:.3e}; mean Y "
          f"{mean_k:.6f} vs {mean_p:.6f} (rel {mean_rel:.2e}, tol {MEAN_RTOL})",
          flush=True)
    if not (bool(torch.isfinite(xyz_k).all()) and rays_rel <= RAYS_RTOL
            and share >= PIXEL_SHARE and mean_rel <= MEAN_RTOL):
        raise AssertionError(f"CUDA spectral megakernel disagrees with its "
                             f"plain version at {n}x{n}@{spp} depth {depth} "
                             f"offset {offset}")
    return max_abs_err, rays_k


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
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                print(f"ptxas: {line.strip()}", flush=True)

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

    # 4. Kernel vs twin on the card: at 64x64@4 depth 8 (two replicas per
    # pixel, 8192 slots) and at the main path's layout, 256x256 depth 50 (one
    # slot per pixel, 65,536 slots, no replicas) for two sample chunks, the
    # main path's first and its last.
    cs, meta = compiler.compile_scene(cornell_box(), "cuda")
    tables = megakernel.pack_tables(cs)
    errs = []
    for nx, spp, depth, seed, offset in ((64, 4, 8, 3, 0), (256, 2, 50, 0, 0),
                                         (256, 2, 50, 0, 1022)):
        errs.append(compare(cs, meta, tables, nx, spp, depth, seed, offset))
    max_abs_err = max(errs)
    timed = {}
    for nx, spp, depth in ((64, 4, 8), (256, 2, 50)):
        s = path.RenderSettings(max_depth=depth)
        key = rng.render_key(0, device="cuda")
        timed[nx] = (
            cuda_ms(lambda: megakernel.render_slots(
                cs, meta, s, nx, nx, spp, key, tables=tables), 10),
            cuda_ms(lambda: megakernel.render_slots_reference(
                cs, meta, s, nx, nx, spp, key), 2))
        print(f"kernel-vs-twin: time at {nx}x{nx}@{spp} depth {depth}: kernel "
              f"{timed[nx][0]:.4f} ms, plain twin {timed[nx][1]:.4f} ms ({card})",
              flush=True)
    mk_ms, plain_ms = timed[256]
    s = path.RenderSettings(max_depth=50)
    _, rgb_rays = megakernel.render_slots(cs, meta, s, 256, 256, 2,
                                          rng.render_key(0, device="cuda"),
                                          tables=tables)
    rgb_bound, rgb_bound_by = bound_ms(
        int(rgb_rays), 256 * 256 * 2, cs.prims.kind.tolist(), False,
        256 * 256 * 16, tensor_bytes(tables))
    print(f"bound: megakernel_rgb at 256x256@2 depth 50 ({int(rgb_rays)} rays): "
          f"{rgb_bound:.4f} ms by {rgb_bound_by} ({card})", flush=True)

    # 4, spectral. The spectral megakernel against its plain version: at
    # 64x64@4 depth 8 (two replicas per pixel) and at the spectral main
    # path's layout, 500x500 depth 50 (one slot per pixel, 250,000 slots),
    # for its first and its last sample chunk.
    scs, smeta = compiler.compile_scene(cornell_box_pyramid_spectral(), "cuda")
    stables = megakernel_spectral.pack_spectral_tables(scs)
    serrs = []
    for nx, spp, depth, seed, offset in ((64, 4, 8, 3, 0), (500, 2, 50, 0, 0),
                                         (500, 2, 50, 0, 254)):
        err, rays = compare_spectral(scs, smeta, stables, nx, spp, depth, seed,
                                     offset)
        serrs.append(err)
        if (nx, offset) == (500, 0):
            spec_rays = rays
    s = path.RenderSettings(max_depth=50)
    key = rng.render_key(0, device="cuda")
    spec_ms = cuda_ms(lambda: megakernel_spectral.render_slots_spectral(
        scs, smeta, s, 500, 500, 2, key, tables=stables), 10)
    spec_plain_ms = cuda_ms(
        lambda: megakernel_spectral.render_slots_spectral_reference(
            scs, smeta, s, 500, 500, 2, key), 2)
    spec_bound, spec_bound_by = bound_ms(
        spec_rays, 500 * 500 * 2, scs.prims.kind.tolist(), True,
        500 * 500 * 16, tensor_bytes(stables.rgb) + tensor_bytes(stables[1:]))
    print(f"kernel-vs-twin: time at 500x500@2 depth 50: spectral kernel "
          f"{spec_ms:.4f} ms, plain version {spec_plain_ms:.4f} ms, bound "
          f"{spec_bound:.4f} ms by {spec_bound_by} ({spec_rays} rays; {card})",
          flush=True)

    # 5. The main path, through the entry points a user calls.
    settings = path.RenderSettings(max_depth=50)
    ctx = renderer.RenderContext(cornell_box(), device="cuda")
    megakernel.launches = 0
    threefry.launches = 0
    warm = renderer.render(None, 256, 256, 1024, settings, seed=0,
                           mode="wavefront", context=ctx, device="cuda")
    res = renderer.render(None, 256, 256, 1024, settings, seed=0,
                          mode="wavefront", context=ctx, device="cuda")
    launches = megakernel.launches
    img = res.image
    print(f"main path: cornell 256x256@1024 depth 50 seed 0 on {res.device}: "
          f"{res.rays_traced} rays in {res.seconds:.4f} s = "
          f"{res.mrays_per_sec:.2f} Mrays/s (warm-up run {warm.seconds:.4f} s; "
          f"{card}); megakernel launches {launches}", flush=True)
    if launches != 2:
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
    main_bound, main_bound_by = bound_ms(
        res.rays_traced, 256 * 256 * 1024, cs.prims.kind.tolist(), False,
        256 * 256 * 16, tensor_bytes(ctx.tables()))
    print(f"main path: megakernel_rgb bound per launch {main_bound:.4f} ms by "
          f"{main_bound_by} against {res.seconds * 1e3:.4f} ms of render() "
          f"({card})", flush=True)

    # 6. The spectral main path, through the same entry points.
    sctx = renderer.RenderContext(cornell_box_pyramid_spectral(), device="cuda")
    megakernel.launches = 0
    megakernel_spectral.launches = 0
    threefry.launches = 0
    swarm = renderer.render(None, 500, 500, 256, settings, seed=0,
                            mode="wavefront", context=sctx, device="cuda")
    sres = renderer.render(None, 500, 500, 256, settings, seed=0,
                           mode="wavefront", context=sctx, device="cuda")
    spec_launches = megakernel_spectral.launches
    print(f"spectral main path: pyramid 500x500@256 depth 50 seed 0 on "
          f"{sres.device}: {sres.rays_traced} rays in {sres.seconds:.4f} s = "
          f"{sres.mrays_per_sec:.2f} Mrays/s (warm-up run {swarm.seconds:.4f} s; "
          f"{card}); spectral megakernel launches {spec_launches}", flush=True)
    if spec_launches != 2:
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
    smain_bound, smain_bound_by = bound_ms(
        sres.rays_traced, 500 * 500 * 256, scs.prims.kind.tolist(), True,
        500 * 500 * 16, tensor_bytes(st.rgb) + tensor_bytes(st[1:]))
    print(f"spectral main path: megakernel_spectral bound per launch "
          f"{smain_bound:.4f} ms by {smain_bound_by} against "
          f"{sres.seconds * 1e3:.4f} ms of render() ({card})", flush=True)

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
            "bound_ms": rgb_bound,
            "bound_by": rgb_bound_by,
            "library_ms": None,
        }, {
            "name": "megakernel_spectral",
            "route": "cuda",
            "source": "izpi_tpu_torch/csrc/megakernel_spectral.cu",
            "replaces": "izpi_tpu/ops/megakernel_spectral.py:267",
            "launches": spec_launches,
            "max_abs_err": max(serrs),
            "ms": spec_ms,
            "plain_ms": spec_plain_ms,
            "bound_ms": spec_bound,
            "bound_by": spec_bound_by,
            "library_ms": None,
        }],
        "device_functions": [{
            "name": "threefry2x32",
            "source": "izpi_tpu_torch/csrc/threefry.cuh",
            "replaces": "izpi_tpu/ops/threefry.py:30",
            "inlined_in": ["megakernel_rgb", "megakernel_spectral"],
            "bit_identical": True,
            "ms": cipher["ms"],
            "plain_ms": cipher["plain_ms"],
            "bound_ms": cipher["bound_ms"],
            "bound_by": "operations",
        }],
        "shapes": {
            "megakernel_rgb": "cornell 256x256@2 depth 50 (its main path's slots)",
            "megakernel_spectral": "spectral pyramid 500x500@2 depth 50 (its "
                                   "main path's slots)",
            "cipher_ms": f"12 uniforms x {n_keys} keys"},
        "library_ms": "null: no PyTorch call computes a path tracer's render "
                      "loop",
        "main_path": {"rays": res.rays_traced, "seconds": res.seconds,
                      "mrays_per_sec": res.mrays_per_sec},
        "spectral_main_path": {"rays": sres.rays_traced,
                               "seconds": sres.seconds,
                               "mrays_per_sec": sres.mrays_per_sec},
        "card": card,
    }), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
