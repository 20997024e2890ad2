#!/usr/bin/env python3
"""Repeat measurement of the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 measure_port.py [--scene cornell|pyramid|obj] [--size N] [--spp S]
                            [--runs 7] [--seeds 0 1]
    python3 measure_port.py --policy [--size 64] [--spp 4] [--runs 2]
    python3 measure_port.py --build [--runs 2]

Renders one main path of chip_smoke.py, `max_depth=50`, on one warm
`RenderContext`, after one warm-up render: Cornell 256×256 at 1024 spp
through the RGB megakernel (`--scene cornell`, the default), the spectral
Cornell pyramid 500×500 at 256 spp through the spectral megakernel
(`--scene pyramid`), or `cornell_box_obj` 256×256 at 128 spp through the
queue pool and the BVH4 traversal kernel (`--scene obj`); `--size` and
`--spp` change the frame and the samples per pixel. It prints:
  - the card's name, power limit, SM clock, power draw and temperature
    (nvidia-smi) before and after;
  - per seed, the Mrays/s of each timed `render()` (host clock around the
    call) with their median and quartiles, and the median seconds (and
    the pool iterations of `--scene obj`);
  - the CUDA-event milliseconds of the kernel's wrapper alone: for a
    megakernel, `render_slots` or `render_slots_spectral` (kernel plus the
    replica and ray-count sums) called on its own; for `--scene obj`, the
    traversal kernel's `bvh_kernel.closest_hit` summed over the launches of
    one `render()`; and its share of the median `render()` seconds;
  - one `render()` under `torch.profiler`: wall seconds, device-busy
    seconds (the sum of the CUDA kernels' and copies' self device time),
    the device's idle share of the wall time, the count of device events
    (per pool iteration for `--scene obj`), and the largest device ops.

`--policy` measures the intersector choice of `RenderContext` (brute force
below `renderer.BVH_THRESHOLD` primitives, the BVH above): the Cornell box
plus a `bumpy_blob` of 100, 500, 2,000 and 20,000 triangles where
cornell_box_obj puts its mesh, rendered in mode "pool" at 64×64 and 4 spp
(`--size`, `--spp`; the pool holds every sample), depth 50, seed 0, once
with `use_bvh=False` (brute force, 512 primitives per pass) and once with
`use_bvh=True` (the traversal kernel), `--runs` timed renders each after a
small warm-up.

`--build` times a build of the kernels from nothing, `--runs` times each
way, alternating: `ops._build.build()` (one nvcc per source, all started
together, then a link) and one nvcc call that compiles and links every
source. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from izpi_tpu_torch import profiling
from izpi_tpu_torch.core import rng
from izpi_tpu_torch.geometry import procedural
from izpi_tpu_torch.integrator import path
from izpi_tpu_torch.ops import _build, bvh_kernel, megakernel, megakernel_spectral
from izpi_tpu_torch.render import renderer
from izpi_tpu_torch.scene import types as scene_types
from izpi_tpu_torch.scene.library.cornell import cornell_box
from izpi_tpu_torch.scene.library.cornell_spectral import (
    cornell_box_pyramid_spectral)
from izpi_tpu_torch.scene.library.misc import cornell_box_obj

# scene -> (constructor, nx = ny, spp, the megakernel wrapper it runs, or
# None for the queue pool and its traversal kernel)
SCENES = {
    "cornell": (cornell_box, 256, 1024, megakernel.render_slots),
    "pyramid": (cornell_box_pyramid_spectral, 500, 256,
                megakernel_spectral.render_slots_spectral),
    "obj": (cornell_box_obj, 256, 128, None),
}
POLICY_TRIS = (100, 500, 2000, 20_000)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def blob_box(n_tris: int) -> scene_types.Scene:
    """The Cornell box with a bumpy_blob of n_tris triangles where
    cornell_box_obj puts its 20,000-triangle one."""
    scene = cornell_box()
    tris = procedural.transform_mesh(procedural.bumpy_blob(n_tris), scale=60.0,
                                     translate=(280.0, 90.0, 390.0))
    scene.world.append(scene_types.TriangleMesh(
        vertices=tris, material=scene_types.Lambertian(
            albedo=scene_types.ConstantTexture((0.7, 0.7, 0.85)))))
    return scene


def policy(n: int, spp: int, runs: int) -> None:
    settings = path.RenderSettings(max_depth=50)
    print(f"engine policy: blob boxes in mode pool at {n}x{n}@{spp} depth 50 "
          f"seed 0 (pool {n * n * spp}); BVH_THRESHOLD "
          f"{renderer.BVH_THRESHOLD}", flush=True)
    for n_tris in POLICY_TRIS:
        scene = blob_box(n_tris)
        rays = {}
        for use_bvh in (False, True):
            ctx = renderer.RenderContext(scene, use_bvh=use_bvh, device="cuda")
            renderer.render(None, 8, 8, 1, settings, seed=1, mode="pool",
                            context=ctx, device="cuda")
            secs = []
            for _ in range(runs):
                res = renderer.render(None, n, n, spp, settings, seed=0,
                                      mode="pool", context=ctx, device="cuda")
                secs.append(res.seconds)
            rays[use_bvh] = res.rays_traced
            med = statistics.median(secs)
            print(f"policy: {ctx.meta.n_prims} prims, "
                  f"{'bvh kernel' if use_bvh else 'brute force'}: rays "
                  f"{res.rays_traced} in {res.iterations} iterations; seconds "
                  f"{[round(x, 4) for x in secs]}, median {med:.4f} = "
                  f"{res.rays_traced / med / 1e6:.3f} Mrays/s; set-up "
                  f"{ctx.build_seconds:.3f} s", flush=True)
            del ctx
            torch.cuda.empty_cache()
        print(f"policy: {n_tris} triangles: rays brute {rays[False]}, bvh "
              f"{rays[True]}", flush=True)


def build_times(runs: int) -> None:
    nvcc = _build._nvcc()
    sources = [str(_build.CSRC / name) for name in _build.SOURCES]
    build_dir = _build.BUILD_DIR
    build_dir.mkdir(parents=True, exist_ok=True)
    for run in range(runs):
        with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
            _build.BUILD_DIR = Path(tmp) / "parallel"
            t0 = time.perf_counter()
            try:
                _build.build()
            finally:
                _build.BUILD_DIR = build_dir
            parallel = time.perf_counter() - t0
            t0 = time.perf_counter()
            subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", "-o",
                            str(Path(tmp) / "one_call.so"), *sources],
                           check=True, capture_output=True)
            one_call = time.perf_counter() - t0
        print(f"build run {run}: {len(sources)} sources; one nvcc per source "
              f"at once plus a link {parallel:.2f} s, one nvcc call "
              f"{one_call:.2f} s", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", choices=sorted(SCENES), default="cornell")
    ap.add_argument("--size", type=int, help="frame width and height")
    ap.add_argument("--spp", type=int, help="samples per pixel")
    ap.add_argument("--runs", type=int, help="timed renders per seed "
                    "(default 7, 2 with --policy or --build)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--policy", action="store_true",
                    help="time brute force against the BVH in the pool")
    ap.add_argument("--build", action="store_true",
                    help="time the kernels' build: per source at once against "
                         "one nvcc call")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("measure_port: torch.cuda.is_available() is False")
    if args.build:
        print(f"smi: {smi()}", flush=True)
        build_times(args.runs or 2)
        return
    if args.policy:
        print(f"smi before: {smi()}", flush=True)
        policy(args.size or 64, args.spp or 4, args.runs or 2)
        print(f"smi after: {smi()}", flush=True)
        return

    runs = args.runs or 7
    make_scene, n, spp, slots = SCENES[args.scene]
    n, spp = args.size or n, args.spp or spp
    print(f"scene {args.scene}: {n}x{n}@{spp} depth 50", flush=True)
    print(f"smi before: {smi()}", flush=True)
    settings = path.RenderSettings(max_depth=50)
    ctx = renderer.RenderContext(make_scene(), device="cuda")
    print(f"scene compile: {ctx.build_seconds:.4f} s", flush=True)
    renderer.render(None, n, n, spp, settings, seed=args.seeds[0],
                    context=ctx, device="cuda")
    median_s = None
    for seed in args.seeds:
        secs, mrays = [], []
        for _ in range(runs):
            res = renderer.render(None, n, n, spp, settings, seed=seed,
                                  context=ctx, device="cuda")
            secs.append(res.seconds)
            mrays.append(res.mrays_per_sec)
        q1, med, q3 = np.percentile(mrays, [25, 50, 75])
        median_s = median_s or statistics.median(secs)
        print(f"seed {seed}: rays {res.rays_traced}; Mrays/s "
              f"{[round(x, 2) for x in mrays]}; median {med:.2f}, quartiles "
              f"{q1:.2f}-{q3:.2f} (IQR {(q3 - q1) / med:.2%}); seconds median "
              f"{statistics.median(secs):.4f}; pool iterations "
              f"{res.iterations}", flush=True)
    print(f"smi after: {smi()}", flush=True)

    if slots is None:
        with profiling.event_timed(bvh_kernel, "closest_hit") as events:
            renderer.render(None, n, n, spp, settings, seed=args.seeds[0],
                            context=ctx, device="cuda")
        ms, calls = profiling.event_ms(events), len(events)
        print(f"bvh_kernel.closest_hit (CUDA events): {ms:.3f} ms over {calls} "
              f"launches in one render(), {ms / 1e3 / median_s:.2%} of the "
              f"median render() seconds of seed {args.seeds[0]}", flush=True)
    else:
        key = rng.render_key(args.seeds[0], device="cuda")
        tables = ctx.tables()
        reps = 5
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            slots(ctx.cs, ctx.meta, settings, n, n, spp, key, tables=tables)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / reps
        print(f"{slots.__name__} (CUDA events): {ms:.3f} ms per call, "
              f"{ms / 1e3 / median_s:.2%} of the median render() seconds of "
              f"seed {args.seeds[0]}", flush=True)

    def profiled():
        nonlocal res
        res = renderer.render(None, n, n, spp, settings, seed=args.seeds[0],
                              context=ctx, device="cuda")

    wall, busy, rows = profiling.device_profile(profiled)
    events = sum(count for _, _, count in rows)
    per_iter = (f", {events / res.iterations:.1f} per pool iteration"
                if res.iterations else "")
    print(f"profiled render(): wall {wall:.4f} s, device busy {busy:.4f} s, "
          f"idle share {1 - busy / wall:.2%}; {events} device events "
          f"(kernels and copies){per_iter}", flush=True)
    for dt, name, count in rows[:8]:
        print(f"  {dt / 1e3:10.3f} ms  x{count}  {name[:90]}", flush=True)


if __name__ == "__main__":
    main()
