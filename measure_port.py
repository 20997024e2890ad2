#!/usr/bin/env python3
"""Repeat measurement of the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 measure_port.py [--scene cornell|pyramid|obj|dragon] [--row]
                            [--size N] [--spp S] [--runs 7] [--seeds 0 1]
    python3 measure_port.py --policy [--size 64] [--spp 4] [--runs 2]
    python3 measure_port.py --build [--runs 2]
    python3 measure_port.py --scene cornell|pyramid --parent DIR [--runs 3]

Renders one main path of chip_smoke.py on one warm `RenderContext`, after
one warm-up render: Cornell 256×256 at 1024 spp, `max_depth=50`, through
the RGB megakernel (`--scene cornell`, the default), the spectral Cornell
pyramid 500×500 at 256 spp, depth 50, through the spectral megakernel
(`--scene pyramid`), `cornell_box_obj` 256×256 at 128 spp, depth 50,
through the queue pool and the BVH4 traversal kernel (`--scene obj`), or
the PBR dragon (`cornell_box_pbr_stanford_dragon_spectral()`, the
871,200-triangle stand-in) 256×256 at 8 spp, depth 16, through the
spectral queue pool (`--scene dragon`, bench.py's `dragon`). A pool scene
takes the BVH4 traversal kernel, or with `--row` the row-stack traversal
kernel: the pair of `ops.bvh_rowkernel.attach` in a context built with
`use_bvh=False`. `--size` and `--spp` change the frame and the samples per
pixel. It prints:
  - the card's name, power limit, SM clock, power draw and temperature
    (nvidia-smi) before and after;
  - per seed, the Mrays/s of each timed `render()` (host clock around the
    call) with their median and quartiles, and the median seconds (and
    the pool iterations of a pool scene);
  - the CUDA-event milliseconds of the kernel's wrapper alone: for a
    megakernel, `render_slots` or `render_slots_spectral` (kernel plus the
    replica and ray-count sums) called on its own, and its launch inside
    one `render()` with the persistent grid and slots; for a pool scene, the
    traversal kernel's wrapper (`bvh_kernel.closest_hit` or
    `bvh_rowkernel.closest_hit_rows`) summed over the launches of one
    `render()`, whose count must equal the pool iterations; and its share
    of the median `render()` seconds;
  - one `render()` under `torch.profiler`: wall seconds, device-busy
    seconds (the sum of the CUDA kernels' and copies' self device time),
    the device's idle share of the wall time, the count of device events
    (per pool iteration for a pool scene), and the largest device ops.

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
source.

`--parent DIR` holds a megakernel scene's main path (cornell or pyramid)
against another tree of the repository, DIR (the parent commit's `git
archive`, unpacked), on the same card: four subprocesses in turns — DIR,
this tree, this tree, DIR — each rendering the main path through the
public entry points (`RenderContext`, `render`, the wrapper timed by
`profiling.event_timed`), one warm-up and `--runs` timed renders (default
3). Each prints its median render seconds and its median milliseconds per
launch (CUDA events around the launch in `render()`); then the two trees'
rays must be equal and every pixel of the image (Cornell) or of the XYZ
canvas (the pyramid) within 1e-4 + 1e-5·|DIR's|.

A megakernel scene also prints each megakernel's registers and spills from
the ptxas log of the build. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from izpi_tpu_torch import profiling
from izpi_tpu_torch.core import rng
from izpi_tpu_torch.geometry import procedural
from izpi_tpu_torch.integrator import path
from izpi_tpu_torch.ops import (_build, bvh_kernel, bvh_rowkernel, megakernel,
                                megakernel_spectral)
from izpi_tpu_torch.render import renderer
from izpi_tpu_torch.scene import types as scene_types
from izpi_tpu_torch.scene.library.cornell import cornell_box
from izpi_tpu_torch.scene.library.cornell_spectral import (
    cornell_box_pyramid_spectral)
from izpi_tpu_torch.scene.library.extracted import (
    cornell_box_pbr_stanford_dragon_spectral)
from izpi_tpu_torch.scene.library.misc import cornell_box_obj

# scene -> (constructor, nx = ny, spp, max_depth, the megakernel wrapper it
# runs, or None for the queue pool and its traversal kernel)
SCENES = {
    "cornell": (cornell_box, 256, 1024, 50, megakernel.render_slots),
    "pyramid": (cornell_box_pyramid_spectral, 500, 256, 50,
                megakernel_spectral.render_slots_spectral),
    "obj": (cornell_box_obj, 256, 128, 50, None),
    "dragon": (cornell_box_pbr_stanford_dragon_spectral, 256, 8, 16, None),
}
POLICY_TRIS = (100, 500, 2000, 20_000)
# --parent: the image tolerance against the other tree, |a - b| <= ATOL +
# RTOL·|b| for every pixel (the replicas of the persistent layout sum each
# pixel's samples in another order).
PARENT_ATOL, PARENT_RTOL = 1e-4, 1e-5

# One turn of --parent, run in a subprocess from a tree's root with only the
# entry points both trees have: argv = scene, n, spp, depth, runs, out.npz.
# Prints one JSON line: rays, render seconds and ms per launch of each
# timed run.
TURN = r"""
import json, sys
import numpy as np, torch
from izpi_tpu_torch import profiling
from izpi_tpu_torch.integrator import path
from izpi_tpu_torch.ops import megakernel, megakernel_spectral
from izpi_tpu_torch.render import renderer
from izpi_tpu_torch.scene.library.cornell import cornell_box
from izpi_tpu_torch.scene.library.cornell_spectral import (
    cornell_box_pyramid_spectral)
scene, n, spp, depth, runs, out = sys.argv[1:7]
n, spp, depth, runs = int(n), int(spp), int(depth), int(runs)
spectral = scene == "pyramid"
make = cornell_box_pyramid_spectral if spectral else cornell_box
mod, fn = ((megakernel_spectral, "render_slots_spectral") if spectral
           else (megakernel, "render_slots"))
ctx = renderer.RenderContext(make(), device="cuda")
settings = path.RenderSettings(max_depth=depth)
renderer.render(None, n, n, spp, settings, seed=0, context=ctx, device="cuda")
seconds, ms = [], []
for _ in range(runs):
    with profiling.event_timed(mod, fn) as events:
        res = renderer.render(None, n, n, spp, settings, seed=0, context=ctx,
                              device="cuda")
    seconds.append(res.seconds)
    ms.append(profiling.event_ms(events) / len(events))
np.savez(out, image=res.image, xyz=res.xyz if spectral else res.image)
print(json.dumps({"rays": res.rays_traced, "seconds": seconds, "ms": ms}))
"""


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


def parent_turns(scene: str, parent: Path, runs: int) -> None:
    """--parent: the main path of `scene` from `parent` and from this tree,
    in turns parent, this, this, parent (the module docstring)."""
    _, n, spp, depth, slots = SCENES[scene]
    if slots is None:
        raise SystemExit("measure_port: --parent takes a megakernel scene "
                         "(cornell, pyramid)")
    here = Path(__file__).resolve().parent
    trees = {"parent": parent.resolve(), "this": here}
    got = {"parent": [], "this": []}
    with tempfile.TemporaryDirectory() as tmp:
        for turn, name in enumerate(("parent", "this", "this", "parent")):
            out = Path(tmp) / f"{name}{turn}.npz"
            run = subprocess.run(
                [sys.executable, "-c", TURN, scene, str(n), str(spp), str(depth),
                 str(runs), str(out)],
                cwd=trees[name], capture_output=True, text=True,
                env={**os.environ, "PYTHONPATH": str(trees[name])})
            if run.returncode != 0:
                raise SystemExit(f"measure_port: the {name} tree's turn failed:"
                                 f"\n{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
            r = json.loads(run.stdout.strip().splitlines()[-1])
            print(f"turn {turn} ({name}, {trees[name]}): {scene} {n}x{n}@{spp} "
                  f"depth {depth}: rays {r['rays']}; render() seconds "
                  f"{[round(x, 4) for x in r['seconds']]}, median "
                  f"{statistics.median(r['seconds']):.4f}; ms per launch "
                  f"{[round(x, 3) for x in r['ms']]}, median "
                  f"{statistics.median(r['ms']):.3f}", flush=True)
            with np.load(out) as z:
                got[name].append((r, z["xyz"].astype(np.float64)))
    (pr, pa), (tr, ta) = got["parent"][0], got["this"][0]
    med = {k: statistics.median(x for r, _ in v for x in r["ms"])
           for k, v in got.items()}
    secs = {k: statistics.median(x for r, _ in v for x in r["seconds"])
            for k, v in got.items()}
    diff = np.abs(ta - pa)
    ok = diff <= PARENT_ATOL + PARENT_RTOL * np.abs(pa)
    repeat = all(r["rays"] == v[0][0]["rays"] and np.array_equal(a, v[0][1])
                 for v in got.values() for r, a in v)
    label = "XYZ" if scene == "pyramid" else "image"
    print(f"parent vs this tree: rays {pr['rays']} vs {tr['rays']} (equal "
          f"{pr['rays'] == tr['rays']}); {label} pixels within {PARENT_ATOL} + "
          f"{PARENT_RTOL}|parent|: {ok.all(axis=2).mean():.6f} (all: "
          f"{bool(ok.all())}), max abs err {diff.max():.3e}; each tree's turns "
          f"repeat bit for bit {repeat}; median ms per launch {med['parent']:.3f} "
          f"-> {med['this']:.3f} ({med['parent'] / med['this']:.3f}x); median "
          f"render() seconds {secs['parent']:.4f} -> {secs['this']:.4f} "
          f"({smi()})", flush=True)
    if pr["rays"] != tr["rays"] or not ok.all() or not repeat:
        raise SystemExit("measure_port: this tree's main path differs from "
                         "the parent's")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", choices=sorted(SCENES), default="cornell")
    ap.add_argument("--row", action="store_true",
                    help="a pool scene through the row-stack traversal kernel")
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
    ap.add_argument("--parent", type=Path,
                    help="another tree of the repository to hold a megakernel "
                         "scene's main path against, in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("measure_port: torch.cuda.is_available() is False")
    if args.parent:
        print(f"smi before: {smi()}", flush=True)
        parent_turns(args.scene, args.parent, args.runs or 3)
        return
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
    make_scene, n, spp, depth, slots = SCENES[args.scene]
    if args.row and slots is not None:
        raise SystemExit("measure_port: --row needs a pool scene (obj, dragon)")
    n, spp = args.size or n, args.spp or spp
    print(f"scene {args.scene}: {n}x{n}@{spp} depth {depth}"
          f"{' through the row-stack kernel' if args.row else ''}", flush=True)
    print(f"smi before: {smi()}", flush=True)
    settings = path.RenderSettings(max_depth=depth)
    ctx = renderer.RenderContext(make_scene(), use_bvh=False if args.row else None,
                                 device="cuda")
    print(f"scene compile and BVH build: {ctx.build_seconds:.4f} s", flush=True)
    if args.row:
        t0 = time.perf_counter()
        ctx.cs, ctx.intersect = bvh_rowkernel.attach(ctx.cs)
        torch.cuda.synchronize()
        print(f"row-stack attach (leaf-64 tree and tables): "
              f"{time.perf_counter() - t0:.4f} s, "
              f"{ctx.intersect.rs.nodes.shape[0]} nodes, "
              f"{ctx.intersect.rs.blocks.shape[0]} blocks", flush=True)
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
        module, fn = ((bvh_rowkernel, "closest_hit_rows") if args.row
                      else (bvh_kernel, "closest_hit"))
        before = module.launches
        with profiling.event_timed(module, fn) as events:
            timed = renderer.render(None, n, n, spp, settings,
                                    seed=args.seeds[0], context=ctx,
                                    device="cuda")
        ms, calls = profiling.event_ms(events), len(events)
        if module.launches - before != timed.iterations:
            raise SystemExit(f"measure_port: {module.launches - before} "
                             f"launches in {timed.iterations} iterations")
        print(f"{module.__name__.rsplit('.', 1)[1]}.{fn} (CUDA events): "
              f"{ms:.3f} ms over {calls} launches in one render() of "
              f"{timed.iterations} pool iterations, {ms / calls:.4f} ms per "
              f"launch, {ms / 1e3 / median_s:.2%} of the median render() "
              f"seconds of seed {args.seeds[0]}", flush=True)
    else:
        key = rng.render_key(args.seeds[0], device="cuda")
        tables = ctx.tables()
        _, ms = profiling.cuda_ms(lambda: slots(
            ctx.cs, ctx.meta, settings, n, n, spp, key, tables=tables), 5,
            warm_up=False)
        module = megakernel_spectral if ctx.meta.spectral else megakernel
        with profiling.event_timed(module, slots.__name__) as events:
            renderer.render(None, n, n, spp, settings, seed=args.seeds[0],
                            context=ctx, device="cuda")
        in_render = profiling.event_ms(events)
        blocks, threads = megakernel.card_grid(module.ENTRY, ctx.cs.device)
        repl, spp_slot, n_slots = megakernel.slot_layout(
            n * n, spp, megakernel.card_min_slots(module.ENTRY, ctx.cs.device))
        log = _build.build().with_suffix(".log")
        print(f"build: registers and spill bytes (stores, loads) "
              f"{_build.ptxas_usage(log.read_text())}", flush=True)
        print(f"{slots.__name__} (CUDA events): {ms:.3f} ms per call, "
              f"{ms / 1e3 / median_s:.2%} of the median render() seconds of "
              f"seed {args.seeds[0]}; its launch inside one render() "
              f"{in_render:.3f} ms; grid {blocks} x {threads}, {repl} "
              f"replicas, {n_slots} slots of {spp_slot} samples, "
              f"{n_slots / (blocks * threads):.3f} per resident thread",
              flush=True)

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
