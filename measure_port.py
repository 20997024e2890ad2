#!/usr/bin/env python3
"""Repeat measurement of the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 measure_port.py [--scene cornell|pyramid|obj|dragon|shirley|
                             pbr_ibl|final] [--row] [--mode pool]
                            [--size N] [--spp S] [--runs 7] [--seeds 0 1]
    python3 measure_port.py --policy [--size 64] [--spp 4] [--runs 2]
    python3 measure_port.py --build [--runs 2]
    python3 measure_port.py --scene cornell|pyramid|obj|dragon|shirley|
                            pbr_ibl|final [--row] [--mode pool]
                            --parent DIR [--runs 3]
    python3 measure_port.py --scene pbr_ibl|final|... --vs-cpu 16@2 64@8
                            [--seeds 0 1]
    python3 measure_port.py --cipher [--parent DIR] [--runs 3]
    python3 measure_port.py --trace-loop [--scene obj|cornell|pbr_ibl|final]
                            [--size 128] [--spp 4] [--runs 2]
    python3 measure_port.py --deposit [--runs 3]
    python3 measure_port.py --step [--scene cornell|obj] [--parent DIR]
                            [--rounds 1] [--runs 20] [--spp 1]
    python3 measure_port.py --reverse [--scene cornell|obj] [--parent DIR]
                            [--rounds 1] [--runs 20]

Renders one main path of chip_smoke.py on one warm `RenderContext`, after
one warm-up render: Cornell 256×256 at 1024 spp, `max_depth=50`, through
the RGB megakernel (`--scene cornell`, the default), the spectral Cornell
pyramid 500×500 at 256 spp, depth 50, through the spectral megakernel
(`--scene pyramid`), `cornell_box_obj` 256×256 at 128 spp, depth 50,
through the RGB megakernel's BVH form (`--scene obj`; with `--mode pool`
through the queue pool and the BVH4 traversal kernel), or
the PBR dragon (`cornell_box_pbr_stanford_dragon_spectral()`, the
871,200-triangle stand-in) 256×256 at 8 spp, depth 16, through the
spectral queue pool (`--scene dragon`, bench.py's `dragon`). Three more
scenes come from chip_smoke.py's phases 13-15: Shirley's `random_scene`
256×256 at 128 spp, depth 50, under the sky (0.7, 0.8, 1.0), through the
RGB megakernel (`--scene shirley`, bench.py's `shirley`); `pbr_ibl`
256×256 at 256 spp, depth 16, through the queue pool with brute force
(`--scene pbr_ibl`, bench.py's `pbr_ibl`); and the book-2 final scene
256×256 at 16 spp, depth 50, through the pool and the BVH4 kernel
(`--scene final`). A pool scene
takes the BVH4 traversal kernel, or with `--row` the row-stack traversal
kernel: the pair of `ops.bvh_rowkernel.attach` in a context built with
`use_bvh=False`, and then also times its intersector calls and kernel
launches with the batches in the pool's order and sorted first by the JAX
intersector's coherence key (the sort, gather and scatter back timed with
the call), in turns. `--size` and `--spp` change the frame and the samples
per pixel. It prints:
  - the card's name, power limit, SM clock, power draw and temperature
    (nvidia-smi) before and after;
  - per seed, the Mrays/s of each timed `render()` (host clock around the
    call) with their median and quartiles, and the median seconds (and
    the pool iterations of a pool scene);
  - the CUDA-event milliseconds of the kernel's wrapper alone: for a
    megakernel, `render_slots` or `render_slots_spectral` (kernel plus the
    replica and ray-count sums) called on its own, and its launch inside
    one `render()` with the persistent grid and slots; for a pool scene,
    whose `render()` replays its iterations from a CUDA graph (launches the
    host does not see), the traversal kernel's wrapper
    (`bvh_kernel.closest_hit` or `bvh_rowkernel.closest_hit_rows`) per
    launch over the same render through the plain loop (the same body, no
    graph), the launches of one `render()`, which must equal its pool
    bodies run (`RenderResult.trips`), and the kernel's share of the
    median `render()` seconds;
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
small warm-up. Then Shirley's `random_scene` (485 spheres, below the
threshold) at its main path's frame (256×256 at 128 spp, depth 50, under
the sky) through the RGB megakernel's brute force (the default) and
through its BVH form (`use_bvh=True`), in turns after a warm-up round:
each one's rays, seconds and median, their ratio and the largest pixel
difference (the BVH context's primitives are in tree order, so exact-t
ties may pick another primitive).

`--build` times a build of the kernels from nothing, `--runs` times each
way, alternating: `ops._build.build()` (one nvcc per source, all started
together, then a link) and one nvcc call that compiles and links every
source.

`--parent DIR` holds a scene's main path against another tree of the
repository, DIR (the parent commit's `git archive`, unpacked), on the same
card: four subprocesses in turns — DIR, this tree, this tree, DIR — each
rendering the main path through the public entry points (`RenderContext`,
`render`, the kernel's wrapper timed by `profiling.event_timed`: a
megakernel's, or for a pool render the traversal kernel's, with `--row`
the row-stack pair's), one warm-up and `--runs` timed renders (default 3).
Each prints its median render seconds, its median milliseconds per launch
(CUDA events around each launch in `render()`, whose count must equal the
pool's bodies run; a tree that replays its pool from a CUDA graph makes no
launch the host sees, and prints nan) and its kernels' ptxas registers, spills and shared
memory; then the two trees' rays must be equal and every pixel of the image
(or of the XYZ canvas: the pyramid, the dragon) within 1e-4 + 1e-5·|DIR's|,
this tree's turns must repeat bit for bit, and DIR's too where DIR renders
through a megakernel (a tree whose pool sums its deposits with float
atomics repeats within the tolerance). Through the RGB megakernel's BVH
form (`--scene obj`) each turn also launches the frame once more with its
traversal counts and prints them (nodes popped, primitives tested, and a
ray), and the two trees' counts side by side; where the tree has the
form's probe instance (`megakernel.probe_bvh`), the turn prints its
figures (the lanes' use of the warps' visit and test passes, nodes a call
a lane against the warp's most, the shares of the lanes' cycles), and its
render, rays and counts must equal the main instance's.

`--step` times the training step (`parallel.dist.build_train_step`,
`--spp` samples a pixel, 1 by default, seed 0, from tex_c0 at 0.7 of its
values against a grey target) on `--scene` cornell (brute force, the
default) or obj (`cornell_box_obj` through the BVH4 kernel) at 256×256,
depth 50, on the route `build_train_step` picks (the fused one,
`ops.diff_trace`, for both; a tree without routes runs the checkpointed
bounces): one call to warm up (on this tree, the warm-up and the capture
of its CUDA graph) and `--runs` timed calls (host clock to a CUDA sync),
in this tree, or with `--parent DIR` in `--rounds` rounds of four
subprocesses in turns — DIR, this tree, this tree, DIR. Each turn prints
its calls' ms, their median, the first call's, the launches of its last
call and the sample passes its forward launches carried
(`diff_trace.fwd_passes`, where the tree counts them); on the fused route
also the forward kernel alone at the step's camera rays, launched as the
tree's step launches it (one launch of every pass's paths in a tree with
`renderer.sample_passes`, else a launch a pass): a step's launches' ms
over a CUDA graph of 20 steps (`profiling.graph_ms`: the wrapper's host
cost untimed), a digest of each pass's outputs (radiance, ray counts,
each path's records up to its count; its slice of a merged launch, or
its own launch), its kernels' ptxas registers, spills and stack frames,
and where the tree has it, its probe instance's figures
(`diff_trace.probe` on the step's first launch, whose outputs must equal
the kernel's); and the reverse from F's records to the table gradient,
at depth 50 and 8, a step's calls over a CUDA graph of 20 (each step's
records first copied back from a clone, the copies' time taken off),
with a digest of each pass's table: a tree whose `diff_trace.reverse` returns slots
runs R and then G (`table_grad`), and R alone is timed too; a tree
whose `reverse` returns the gradient runs that call, one for all the
passes where the tree merges them. Each tree's step ms (the median of
its turns' medians), forward kernel ms and reverse ms are printed with
the range of its turns' figures, and with
`--parent`, each pair's ratio of DIR's to this tree's, the pairs this
tree wins and DIR's interquartile distance (with more than one round).
The trees' rays must be equal, their losses within 1e-4 relative and
every gradient within 1e-5 + 1e-3·|DIR's| (a new summation order), and
each tree's turns must repeat bit for bit, the forward kernel's and the
reverse's digests too; where both trees take the fused route, the loss,
every gradient, the forward kernel's outputs and the reverse's table
gradients, pass by pass, must also equal DIR's bit for bit (F's and R's
arithmetic is one thread a path's, whatever the schedule, and G's fixed
point sums in any order to the same bits).

`--reverse` times the training step's reverse alone (`diff_trace.reverse`
from F's records to the texture table's gradient; R and then G in a tree
whose `reverse` returns slots) on `--scene` cornell or obj at 256×256,
depth 50 and 8, the step's cotangent of F's radiance against a grey
target (each call's records first copied back from a clone, the
copies' time taken off or left out): its ms a call over a CUDA graph of
20 calls, and from torch.profiler over `--runs` calls each device
kernel's µs a call, with the records and the warp planes (each warp's longest path, summed); in
this tree, or with `--parent DIR` in `--rounds` rounds of turns DIR,
this tree, this tree, DIR.

`--vs-cpu N@S ...` renders a pool scene (`--scene`) at N×N and S spp, at
its main path's depth, on the card and on the CPU (`device="cpu"`, the
same code and the plain traversal), for each seed of `--seeds`: the rays
of each and their relative gap, the share of pixels within 1e-4 +
1e-5·|CPU| (and of pixels equal), the pixels each lights and the channel
means. A gap that comes from the two devices' last-ulp libm and division
differences turning single paths into others changes sign from seed to
seed and shrinks relative to the rays as the frame grows; a fault keeps
its sign and its relative size.

`--cipher` times the cipher entry `izpi_threefry_uniforms` alone (CUDA
events around one replay of a CUDA graph of `--runs` × 100 launches through
the library's C entry, on random key words: int64 words where the tree's
entry has the new-sample form, int32 words in an older tree) at 262,144 keys (the `cornell_box_obj` pool's
batch) and at 1,048,576, for each count the pool draws, 12, 5 and 1
uniforms (the unrolled template forms), beside 11, 6 and 2 uniforms (the
run-time-count form at the same cipher calls a key: two fold-ins and 6, 3
or 1 pairs), and prints each pair's ratio; with `--parent DIR` in four
subprocesses in turns, DIR, this tree, this tree, DIR, whose outputs must
be equal bit for bit (DIR's entry must take every count).

`--deposit` times the queue pool's deposit alone (`wavefront.deposit`: a
stable sort of the slots by pixel and a segment sum, whose order the slots
fix) against `index_add_`'s float atomics, at the 262,144-slot pool over a
256×256 frame, each over a CUDA graph of 100 calls, `--runs` turns.

`--mode pool` renders through the queue pool where the default route
takes a megakernel (cornell_box_obj's default is the RGB megakernel's BVH
form), here and in `--parent`'s turns.

`--trace-loop` times the lockstep oracle (`render(mode="simple")`,
`integrator.path.trace`, its bounces through `core.loops.guarded_fori`
uncaptured) on `--scene` (an RGB scene; `obj` by default) at `--size`
(128) and `--spp` (4), at its main path's depth, with `path.TRACE_CHUNK`
bounces between two tests of the live flags at 8 and at 1 (the early-exit
loop: one test, a sync, a bounce), in turns 8, 1, 1, 8, `--runs` times
(default 2) after a warm-up of each: each turn's seconds and rays, each
chunk's median, and their ratio. The rays must be equal.

A megakernel scene also prints each megakernel's registers and spills from
the ptxas log of the build. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import functools
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

from h100bench import harness
from izpi_tpu_torch import profiling
from izpi_tpu_torch.core import rng
from izpi_tpu_torch.geometry import procedural
from izpi_tpu_torch.integrator import path, wavefront
from izpi_tpu_torch.ops import (_build, bvh_kernel, bvh_rowkernel, megakernel,
                                megakernel_spectral, threefry)
from izpi_tpu_torch.render import renderer
from izpi_tpu_torch.scene import types as scene_types
from izpi_tpu_torch.scene.library.cornell import cornell_box
from izpi_tpu_torch.scene.library.cornell_spectral import (
    cornell_box_pyramid_spectral)
from izpi_tpu_torch.scene.library.extracted import (
    cornell_box_pbr_stanford_dragon_spectral)
from izpi_tpu_torch.scene.library.misc import cornell_box_obj, pbr_ibl
from izpi_tpu_torch.scene.library.shirley import final, random_scene

# scene -> (constructor, nx = ny, spp, max_depth, the megakernel wrapper it
# runs, or None for the queue pool and its traversal kernel)
SCENES = {
    "cornell": (cornell_box, 256, 1024, 50, megakernel.render_slots),
    "pyramid": (cornell_box_pyramid_spectral, 500, 256, 50,
                megakernel_spectral.render_slots_spectral),
    "obj": (cornell_box_obj, 256, 128, 50, None),
    "dragon": (cornell_box_pbr_stanford_dragon_spectral, 256, 8, 16, None),
    "shirley": (lambda: random_scene(aspect=1.0), 256, 128, 50,
                megakernel.render_slots),
    "pbr_ibl": (pbr_ibl, 256, 256, 16, None),
    "final": (final, 256, 16, 50, None),
}
# The renderer's background by scene (bench.py:39-40); black otherwise.
BACKGROUND = {"shirley": (0.7, 0.8, 1.0)}
# The scenes --parent takes.
PARENT_SCENES = ("cornell", "pyramid", "obj", "dragon", "shirley", "pbr_ibl",
                 "final")
POLICY_TRIS = (100, 500, 2000, 20_000)
# --cipher: (keys, uniforms) shapes, the cornell_box_obj pool's batch and 4x
# it; each count the pool draws beside a count of the same cipher calls
# that the run-time-count form draws.
CIPHER_PAIRS = ((12, 11), (5, 6), (1, 2))
CIPHER_SHAPES = [(keys, n) for keys in (1 << 18, 1 << 20)
                 for pair in CIPHER_PAIRS for n in pair]
# --vs-cpu: a pixel agrees when every channel is within ATOL + RTOL·|CPU|.
VS_CPU_ATOL, VS_CPU_RTOL = 1e-4, 1e-5
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
from izpi_tpu_torch.ops import (_build, bvh_kernel, bvh_rowkernel, megakernel,
                                megakernel_spectral)
from izpi_tpu_torch.render import renderer
from izpi_tpu_torch.scene.library.cornell import cornell_box
from izpi_tpu_torch.scene.library.cornell_spectral import (
    cornell_box_pyramid_spectral)
from izpi_tpu_torch.scene.library.extracted import (
    cornell_box_pbr_stanford_dragon_spectral)
from izpi_tpu_torch.scene.library.misc import cornell_box_obj, pbr_ibl
from izpi_tpu_torch.scene.library.shirley import final, random_scene
scene, n, spp, depth, runs, row, mode, out = sys.argv[1:9]
n, spp, depth, runs, row = int(n), int(spp), int(depth), int(runs), row == "1"
make = {"cornell": cornell_box, "pyramid": cornell_box_pyramid_spectral,
        "obj": cornell_box_obj,
        "dragon": cornell_box_pbr_stanford_dragon_spectral,
        "shirley": lambda: random_scene(aspect=1.0), "pbr_ibl": pbr_ibl,
        "final": final}[scene]
ctx = renderer.RenderContext(make(), use_bvh=False if row else None,
                             device="cuda")
if row:
    ctx.cs, ctx.intersect = bvh_rowkernel.attach(ctx.cs)
bg = (0.7, 0.8, 1.0) if scene == "shirley" else (0.0, 0.0, 0.0)
settings = path.RenderSettings(max_depth=depth, background=bg)
warm = renderer.render(None, n, n, spp, settings, seed=0, mode=mode,
                       context=ctx, device="cuda")
# The kernel whose launches a render makes: a megakernel's (either RGB
# form counts under the module's counters), else the pool's traversal
# kernel, once a pool body (a pool by brute force has none).
if warm.iterations is None:
    mod, fn = ((megakernel_spectral, "render_slots_spectral")
               if ctx.meta.spectral else (megakernel, "render_slots"))
elif row or hasattr(ctx.intersect, "ks"):
    mod, fn = ((bvh_rowkernel, "closest_hit_rows") if row
               else (bvh_kernel, "closest_hit"))
else:
    mod, fn = None, None


def launches():
    if mod is None:
        return 0
    return mod.launches + getattr(mod, "bvh_launches", 0)


seconds, ms, events = [], [], []
for _ in range(runs):
    before = launches()
    if mod is None:
        res = renderer.render(None, n, n, spp, settings, seed=0, mode=mode,
                              context=ctx, device="cuda")
    else:
        with profiling.event_timed(mod, fn) as events:
            res = renderer.render(None, n, n, spp, settings, seed=0,
                                  mode=mode, context=ctx, device="cuda")
    # A pool launches once a body run (trips, where the tree counts them:
    # its iterations and the loop's overrun), a megakernel render once.
    bodies = getattr(res, "trips", None) or res.iterations or 1
    if mod is not None and launches() - before != bodies:
        raise SystemExit(f"{launches() - before} launches of {fn} in "
                         f"{bodies} pool bodies")
    seconds.append(res.seconds)
    # A pool replayed from a CUDA graph makes no launch the host sees.
    ms.append(profiling.event_ms(events) / len(events) if events
              else float("nan"))
# The RGB megakernel's BVH form: one more launch of the frame with its
# traversal counts (nodes popped, primitives tested; summed, whatever shape
# the tree's wrapper returns them in), and where the tree has it, its probe
# instance on the same frame, which must render the same bits and counts.
extra = {}
if ctx.mega_bvh() is not None and warm.iterations is None:
    from izpi_tpu_torch.core import rng
    frame = (ctx.cs, ctx.meta, settings, n, n, spp,
             rng.render_key(0, device="cuda"))
    kw = dict(tables=ctx.tables(), bvh=ctx.mega_bvh())
    main = megakernel.render_slots(*frame, draws=True, **kw)
    extra["traversal"] = [int(x) for x in main[3].reshape(-1, 2).sum(dim=0)]
    if hasattr(megakernel, "probe_bvh"):
        probed, summary = megakernel.probe_bvh(*frame, **kw)
        extra["probe"] = summary
        extra["probe_same"] = bool(
            torch.equal(probed[0].view(torch.int32), main[0].view(torch.int32))
            and int(probed[1]) == int(main[1])
            and torch.equal(probed[3], main[3]))
usage = _build.ptxas_usage(_build.build().with_suffix(".log").read_text())
np.savez(out, image=res.image, xyz=res.xyz if ctx.meta.spectral else res.image)
print(json.dumps({"rays": res.rays_traced, "seconds": seconds, "ms": ms,
                  "launches": len(events), "usage": usage,
                  "engine": "pool" if res.iterations is not None else fn,
                  "iterations": res.iterations, **extra}))
"""

# One turn of --cipher, run like TURN: argv = shapes (JSON), reps, out.npz.
# Prints one JSON line: the mean ms per launch at each shape.
CIPHER_TURN = r"""
import json, sys
import numpy as np, torch
from izpi_tpu_torch.ops import _build
shapes, reps, out = json.loads(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
lib = _build.load()
# A tree whose entry has the new-sample form reads int64 words; an older
# one reads int32 words. The same random words go to both.
wide = hasattr(lib, "izpi_threefry_new_sample")
rs = np.random.RandomState(3)
ms, bits = [], {}
for n_keys, n_u in shapes:
    words = rs.randint(-2**31, 2**31, (n_keys, 3), dtype=np.int64)
    words = (words & 0xFFFFFFFF) if wide else words.astype(np.int32)
    words = torch.as_tensor(words, device="cuda")
    k, d = words[:, :2].contiguous(), words[:, 2].contiguous()
    o = torch.empty((n_keys, n_u), dtype=torch.float32, device="cuda")

    def launch():
        err = lib.izpi_threefry_uniforms(
            k.data_ptr(), d.data_ptr(), n_keys, n_u, 0, o.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise SystemExit(f"izpi_threefry_uniforms: CUDA error {err}")

    # reps launches captured in one CUDA graph and timed as one replay, so
    # that the host's launch cost is not timed.
    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            launch()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms.append(start.elapsed_time(end) / reps)
    bits[f"{n_keys}x{n_u}"] = o.view(torch.int32).cpu().numpy()
np.savez(out, **bits)
print(json.dumps({"ms": ms}))
"""


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def trace_loop(scene: str, n: int, spp: int, runs: int) -> None:
    make_scene, _, _, depth, _ = SCENES[scene]
    settings = path.RenderSettings(max_depth=depth)
    ctx = renderer.RenderContext(make_scene(), device="cuda")
    print(f"trace loop: {scene} in mode simple at {n}x{n}@{spp} depth {depth} "
          f"seed 0 ({smi()})", flush=True)
    secs, rays = {8: [], 1: []}, {}
    for turn in range(runs + 1):
        for chunk in (8, 1, 1, 8):
            path.TRACE_CHUNK = chunk
            res = renderer.render(None, n, n, spp, settings, seed=0,
                                  mode="simple", context=ctx, device="cuda")
            rays.setdefault(chunk, res.rays_traced)
            if res.rays_traced != rays[chunk]:
                raise AssertionError("two renders at one chunk differ")
            if turn:  # the first round warms up
                secs[chunk].append(res.seconds)
    path.TRACE_CHUNK = 8
    med = {c: statistics.median(v) for c, v in secs.items()}
    for c in (8, 1):
        print(f"trace loop: {scene} chunk {c}: rays {rays[c]}; seconds "
              f"{[round(x, 4) for x in secs[c]]}, median {med[c]:.4f} = "
              f"{rays[c] / med[c] / 1e6:.3f} Mrays/s", flush=True)
    print(f"trace loop: {scene}: chunk 8 / chunk 1 median seconds "
          f"{med[8] / med[1]:.3f} ({smi()})", flush=True)
    if rays[8] != rays[1]:
        raise AssertionError(f"chunks 8 and 1 trace {rays[8]} and {rays[1]} "
                             f"rays")


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
    # The megakernels on random_scene (485 spheres, below BVH_THRESHOLD) at
    # its main path's frame: the RGB megakernel's brute force (the default)
    # against its BVH form (use_bvh=True), in turns.
    make, n_s, spp_s, depth_s, _ = SCENES["shirley"]
    sky = path.RenderSettings(max_depth=depth_s,
                              background=BACKGROUND["shirley"])
    ctxs = {use_bvh: renderer.RenderContext(make(), use_bvh=use_bvh,
                                            device="cuda")
            for use_bvh in (False, True)}
    secs, res = {False: [], True: []}, {}
    for turn in range(runs + 1):
        for use_bvh in ((False, True) if turn % 2 else (True, False)):
            r = renderer.render(None, n_s, n_s, spp_s, sky, seed=0,
                                context=ctxs[use_bvh], device="cuda")
            if turn:  # the first round warms up
                secs[use_bvh].append(r.seconds)
            res[use_bvh] = r
    diff = np.abs(res[True].image - res[False].image).max()
    for use_bvh, name in ((False, "brute force (RGB megakernel)"),
                          (True, "BVH form")):
        med = statistics.median(secs[use_bvh])
        print(f"policy: random_scene {n_s}x{n_s}@{spp_s} depth {depth_s}, "
              f"{ctxs[use_bvh].meta.n_prims} prims, {name}: rays "
              f"{res[use_bvh].rays_traced}; seconds "
              f"{[round(x, 4) for x in secs[use_bvh]]}, median {med:.4f} = "
              f"{res[use_bvh].rays_traced / med / 1e6:.3f} Mrays/s", flush=True)
    print(f"policy: random_scene: BVH form / brute force median seconds "
          f"{statistics.median(secs[True]) / statistics.median(secs[False]):.3f}"
          f"; largest pixel difference {diff:.3e} ({smi()})", flush=True)


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


class SortedRows:
    """The row-stack intersector `inter` with each batch sorted by
    `bvh_rowkernel.sort_keys` first (a stable sort, as the JAX intersector
    sorts), gathered packed, traversed and its records scattered back to ray
    order."""

    def __init__(self, inter):
        self.inter = inter

    def __call__(self, o, d, time, t_min, t_max):
        order = torch.argsort(bvh_rowkernel.sort_keys(o, d, self.inter.lo,
                                                      self.inter.hi),
                              stable=True)
        packed = torch.cat([o, d, time[:, None]], dim=1)[order]
        hit = self.inter(packed[:, 0:3], packed[:, 3:6], packed[:, 6], t_min,
                         t_max)
        back = torch.empty_like(order)
        back[order] = torch.arange(order.shape[0], device=order.device)
        return type(hit)(*(f[back] for f in hit))


def row_sort(ctx, n: int, spp: int, settings, seed: int, runs: int) -> None:
    """--row: the intersector's calls and the kernel's launches in `runs`
    renders with the batches in the pool's order (`RowBVHIntersector`) and
    sorted (`SortedRows`: the sort, gather and scatter back included), in
    turns; each render's rays must be the same (the sort does not change a
    hit)."""
    unsorted = ctx.intersect
    got = {"sorted": [], "unsorted": []}
    try:
        for turn in range(2 * runs):
            name = ("sorted", "unsorted")[(turn + turn // 2) % 2]
            inter = SortedRows(unsorted) if name == "sorted" else unsorted
            calls = []

            def timed_call(*args, inter=inter, calls=calls):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = inter(*args)
                end.record()
                calls.append((start, end))
                return out

            ctx.intersect = timed_call
            with profiling.event_timed(bvh_rowkernel,
                                       "closest_hit_rows") as launches:
                res = renderer.render(None, n, n, spp, settings, seed=seed,
                                      context=ctx, device="cuda")
            got[name].append((res.rays_traced, res.seconds,
                              profiling.event_ms(calls) / len(calls),
                              profiling.event_ms(launches) / len(launches)))
    finally:
        ctx.intersect = unsorted
    rays = {r for v in got.values() for r, *_ in v}
    for name, v in got.items():
        print(f"row-stack intersector, batches {name}: render() seconds "
              f"{[round(x[1], 4) for x in v]}; ms per intersector call "
              f"{[round(x[2], 4) for x in v]}, median "
              f"{statistics.median(x[2] for x in v):.4f}; ms per kernel "
              f"launch {[round(x[3], 4) for x in v]}, median "
              f"{statistics.median(x[3] for x in v):.4f}", flush=True)
    if len(rays) != 1:
        raise SystemExit(f"measure_port: sorted and unsorted renders traced "
                         f"{sorted(rays)} rays")


STEP_TURN = r"""
import json, sys, time
import numpy as np, torch
from izpi_tpu_torch import ops
from izpi_tpu_torch.core import rng
from izpi_tpu_torch.integrator import path
from izpi_tpu_torch.parallel import dist
from izpi_tpu_torch.render import renderer
from izpi_tpu_torch.scene.library.cornell import cornell_box
from izpi_tpu_torch.scene.library.misc import cornell_box_obj
scene, n, depth, runs, out, spp = sys.argv[1:7]
n, depth, runs, spp = int(n), int(depth), int(runs), int(spp)
ctx = renderer.RenderContext(
    cornell_box() if scene == "cornell" else cornell_box_obj(), device="cuda")
step = dist.build_train_step(ctx.cs, ctx.meta,
                             path.RenderSettings(max_depth=depth),
                             ctx.intersect, n, n, spp=spp)
params = dist.extract_params(ctx.cs)
with torch.no_grad():
    params["tex_c0"] *= 0.7
ys = torch.arange(n, device="cuda").repeat_interleave(n)
xs = torch.arange(n, device="cuda").repeat(n)
target = torch.full((n * n, 3), 0.25, device="cuda")
key = rng.render_key(0, device="cuda")
seconds = []
for _ in range(runs + 1):
    ops.zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = step(params, xs, ys, target, key)
    torch.cuda.synchronize()
    seconds.append(time.perf_counter() - t0)
launches = ops.kernel_launches()
route = getattr(step, "route", "checkpoint")
fused = {}
if not isinstance(route, str):
    from izpi_tpu_torch.ops import diff_trace
    fused["passes"] = getattr(diff_trace, "fwd_passes", None)
np.savez(out, loss=loss.cpu().numpy(),
         **{k: g.cpu().numpy() for k, g in grads.items()})
if not isinstance(route, str):
    # F alone on what the step launches, a step's launches over a CUDA
    # graph of 20 steps: one launch of every pass's camera rays in a tree
    # that merges the passes (`renderer.sample_passes`), else a launch a
    # pass; the digest of each pass's outputs (a path's records up to its
    # count), from its slice of the merged launch or from its own launch;
    # and where the tree has it, its probe instance on the step's first
    # launch.
    import hashlib
    from izpi_tpu_torch import profiling

    def digest(out):
        rad, cnt, rec_f, rec_i = out
        live = torch.arange(rec_i.shape[0], device="cuda")[:, None] < cnt[None, :]
        h = hashlib.sha256()
        for t in (rad, cnt, torch.where(live[..., None], rec_f, 0.0),
                  torch.where(live, rec_i, 0)):
            h.update(t.contiguous().view(torch.int32).cpu().numpy().tobytes())
        return h.hexdigest()

    def passes_of(out):
        rad, cnt, rec_f, rec_i = out
        m = n * n
        return [(rad[k * m:(k + 1) * m], cnt[k * m:(k + 1) * m],
                 rec_f[:, k * m:(k + 1) * m], rec_i[:, k * m:(k + 1) * m])
                for k in range(cnt.shape[0] // m)]

    cs_p = dist.inject_params(ctx.cs, {k: v.detach() for k, v in params.items()})
    per_pass = [tuple(x.contiguous() for x in renderer.camera_rays(
        cs_p, key, xs, ys, n, n, k)) for k in range(spp)]
    merged = hasattr(renderer, "sample_passes")
    launched = ([tuple(torch.cat(x).contiguous() for x in zip(*per_pass))]
                if merged else per_pass)
    fused["fwd_launches_step"] = len(launched)
    s = path.RenderSettings(max_depth=depth)

    def fwd_at(rays, d_set=s):
        if merged:
            return diff_trace.forward(route, cs_p, ctx.meta, d_set,
                                      ctx.intersect, *rays, len(per_pass))
        return diff_trace.forward(route, cs_p, ctx.meta, d_set, ctx.intersect,
                                  *rays)

    def fwd():
        return [fwd_at(rays) for rays in launched]

    fused["fwd_digest"] = [digest(p) for o in fwd() for p in passes_of(o)]
    fused["fwd_ms"] = profiling.graph_ms(fwd, 20)
    # The reverse to the table gradient, a step's calls over a CUDA graph
    # of 20 steps, at depth 50 and 8, on the step's cotangent of F's
    # radiance against the target, with the digest of each pass's table
    # from the first calls; each timed step first copies the records back
    # from a clone (a tree's reverse may keep its cotangents in them), and
    # a graph of the copies alone is timed and taken off: a
    # tree whose `reverse` returns (rows, g, count) slots runs it
    # and then G (`table_grad`), and its slots alone are timed as "R"; a
    # tree whose `reverse` returns the gradient runs that one call (a call
    # of all the passes, a table each, where the tree merges them).
    from izpi_tpu_torch.core import vecmath as vm
    from izpi_tpu_torch.ops import table_grad
    n_rows = route.n_tex * (2 if route.checker else 1)
    c0, c1 = cs_p.textures.c0, cs_p.textures.c1
    for d_rev in (depth, 8):
        s_rev = path.RenderSettings(max_depth=d_rev)
        calls = []
        for rays in launched:
            rad, cnt, rec_f, rec_i = fwd_at(rays, s_rev)
            g_rad = torch.where(
                torch.isfinite(rad),
                2.0 * (vm.de_nan(rad) - target.repeat(cnt.shape[0] // (n * n), 1))
                / float(n * n * 3 * spp), torch.zeros((), device="cuda"))
            calls.append((rec_f, rec_i, cnt, g_rad.contiguous()))
        pristine = [c[0].clone() for c in calls]

        def restore():
            for c, p in zip(calls, pristine):
                c[0].copy_(p)

        def bwd(rec_f, rec_i, cnt, g_rad):
            if merged:
                return diff_trace.reverse(route, rec_f, rec_i, cnt, g_rad, c0,
                                          c1, s_rev, len(per_pass))
            return diff_trace.reverse(route, rec_f, rec_i, cnt, g_rad, c0, c1,
                                      s_rev)

        def tables_of(outs):
            tables = []
            for o in outs:
                if isinstance(o, tuple):
                    rows, g, count = o
                    tables.append(table_grad.table_grad(rows, g, (n_rows, 3),
                                                        count=count))
                else:
                    tables.extend(o.reshape(-1, n_rows, 3).unbind(0))
            return tables

        first = [bwd(*c) for c in calls]
        slots = isinstance(first[0], tuple)

        def rev():
            restore()
            return tables_of([bwd(*c) for c in calls])

        def r_only():
            restore()
            return [bwd(*c) for c in calls]

        copy_ms = profiling.graph_ms(restore, 20)

        tag = "" if d_rev == depth else f"_d{d_rev}"
        fused["rev_slots" + tag] = slots
        fused["rev_digest" + tag] = [hashlib.sha256(
            t.contiguous().view(torch.int32).cpu().numpy().tobytes()).hexdigest()
            for t in tables_of(first)]
        fused["rev_ms" + tag] = profiling.graph_ms(rev, 20) - copy_ms
        if slots:
            fused["r_ms" + tag] = profiling.graph_ms(r_only, 20) - copy_ms
        del calls, pristine
    if hasattr(diff_trace, "probe"):
        probed, summary = diff_trace.probe(route, cs_p, ctx.meta, s,
                                           *launched[0])
        fused["probe"] = summary
        fused["probe_same"] = [digest(p) for p in passes_of(probed)] == (
            fused["fwd_digest"][:len(passes_of(probed))])
from izpi_tpu_torch.ops import _build
usage = _build.ptxas_usage(_build.build().with_suffix(".log").read_text())
fused["usage"] = {k: list(v) for k, v in usage.items()
                  if k.startswith("diff_trace")}
print(json.dumps({"seconds": seconds, "rays": step.rays,
                  "loss": float(loss), "launches": launches,
                  "runner": type(getattr(step, "runner", None)).__name__,
                  "route": route if isinstance(route, str) else "fused",
                  **fused}))
"""
# Step turns' tolerances (tests/test_torch_grad.py's).
STEP_LOSS_RTOL, STEP_GRAD_ATOL, STEP_GRAD_RTOL = 1e-4, 1e-5, 1e-3


def step_turns(scene: str, parent, runs: int, rounds: int, spp: int) -> None:
    """--step: the training step on `scene` at 256x256, spp samples a
    pixel, depth 50, in this tree, or in `rounds` rounds of turns parent,
    this, this, parent (the module docstring)."""
    here = Path(__file__).resolve().parent
    order = (("parent", "this", "this", "parent") * rounds if parent
             else ("this",))
    trees = {"parent": parent.resolve() if parent else None, "this": here}
    got = {name: [] for name in set(order)}
    with tempfile.TemporaryDirectory() as tmp:
        for turn, name in enumerate(order):
            out = Path(tmp) / f"{name}{turn}.npz"
            r = run_turn(STEP_TURN, trees[name],
                         [scene, "256", "50", str(runs), str(out), str(spp)])
            with np.load(out) as z:
                arrays = {k: z[k] for k in z.files}
            r["step_ms"] = statistics.median(r["seconds"][1:]) * 1e3
            got[name].append((r, arrays))
            print(f"step turn {turn} ({name}, {trees[name]}): {scene} "
                  f"256x256@{spp} depth 50, runner {r['runner']}, route "
                  f"{r['route']}: first call "
                  f"{r['seconds'][0]:.4f} s, then ms "
                  f"{[round(x * 1e3, 4) for x in r['seconds'][1:]]}, median "
                  f"{r['step_ms']:.4f} ms; rays {r['rays']}, loss "
                  f"{r['loss']:.7f}; launches of the last call "
                  f"{r['launches']}, the sample passes its forward launches "
                  f"carried {r.get('passes')}", flush=True)
            if "fwd_ms" in r:
                print(f"step turn {turn} ({name}): diff_trace_fwd "
                      f"{r['fwd_ms']:.4f} ms a step's {r['fwd_launches_step']}"
                      f" launches (a CUDA graph of 20 steps), each pass's "
                      f"outputs {[d[:12] for d in r['fwd_digest']]}; ptxas "
                      f"(registers, spill stores, loads, smem, stack frame) "
                      f"{r['usage']}", flush=True)
            if "rev_ms" in r:
                print(f"step turn {turn} ({name}): the reverse to the table "
                      f"gradient ({'R then G' if r['rev_slots'] else 'fused'}"
                      f") {r['rev_ms']:.4f} ms a step (a CUDA graph of 20)"
                      + (f", R alone {r['r_ms']:.4f}" if "r_ms" in r else "")
                      + f", each pass's table gradient "
                      f"{[d[:12] for d in r['rev_digest']]}; at depth "
                      f"8 {r['rev_ms_d8']:.4f} ms"
                      + (f", R alone {r['r_ms_d8']:.4f}" if "r_ms_d8" in r
                         else ""),
                      flush=True)
            if "probe" in r:
                print(f"step turn {turn} ({name}): diff_trace_fwd "
                      f"{step_probe_line(r['probe'])}; the probe's outputs "
                      f"equal the kernel's: {r['probe_same']}", flush=True)
    keys = dict.fromkeys(order)
    summary = {"step_ms": "step", "fwd_ms": "diff_trace_fwd, a step's",
               "rev_ms": "the reverse to the table gradient, a step's",
               "r_ms": "R alone",
               "rev_ms_d8": "the reverse at depth 8",
               "r_ms_d8": "R alone at depth 8"}
    for key, label in summary.items():
        if not all(key in r for v in got.values() for r, _ in v):
            continue
        figs = {name: [r[key] for r, _ in got[name]] for name in keys}
        line = "; ".join(
            f"{name} {statistics.median(v):.4f} (range {min(v):.4f}-"
            f"{max(v):.4f}, {len(v)} turns)" for name, v in figs.items())
        if parent:
            # A round's two pairs: turns (parent, this) and (this, parent).
            ratios = [x / y for x, y in zip(figs["parent"], figs["this"])]
            wins = sum(x > y for x, y in zip(figs["parent"], figs["this"]))
            q = (statistics.quantiles(figs["parent"], n=4)
                 if rounds > 1 else [0.0, 0.0, 0.0])
            line += (f"; parent / this by pair "
                     f"{[round(x, 4) for x in ratios]}, median "
                     f"{statistics.median(ratios):.4f}x, this tree faster "
                     f"in {wins} of {len(ratios)} pairs; the parent's "
                     f"interquartile distance {q[2] - q[0]:.4f}")
        print(f"step: {label} median ms {line}", flush=True)
    repeat = {name: all(r["rays"] == v[0][0]["rays"] and all(
        np.array_equal(a[k], v[0][1][k]) for k in a)
        and r.get("fwd_digest") == v[0][0].get("fwd_digest")
        and r.get("rev_digest") == v[0][0].get("rev_digest") for r, a in v)
        for name, v in got.items()}
    probes = all(r.get("probe_same", True) for v in got.values() for r, _ in v)
    ok = True
    if parent:
        (pr, pa), (tr, ta) = got["parent"][0], got["this"][0]
        err = max(float(np.abs(ta[k] - pa[k]).max()) for k in pa
                  if k != "loss")
        ok = pr["rays"] == tr["rays"] and abs(tr["loss"] - pr["loss"]) <= (
            STEP_LOSS_RTOL * abs(pr["loss"])) and all(
            bool(np.all(np.abs(ta[k] - pa[k])
                        <= STEP_GRAD_ATOL + STEP_GRAD_RTOL * np.abs(pa[k])))
            for k in pa if k != "loss")
        bits = all(np.array_equal(ta[k], pa[k]) for k in pa)
        fwd_bits = pr.get("fwd_digest") == tr.get("fwd_digest")
        rev_bits = all(pr.get(k) == tr.get(k)
                       for k in ("rev_digest", "rev_digest_d8"))
        print(f"step: parent vs this tree: rays {pr['rays']} vs {tr['rays']}, "
              f"loss {pr['loss']:.7f} vs {tr['loss']:.7f}, largest gradient "
              f"difference {err:.3e}, within the tolerances {ok}, loss and "
              f"gradients bit for bit {bits}, the forward kernel's outputs "
              f"bit for bit {fwd_bits} (pass by pass: a merged launch's "
              f"slice against a launch of its own), the reverse's table "
              f"gradients (depth 50 and 8, pass by pass) bit for bit "
              f"{rev_bits}", flush=True)
        if pr["route"] == tr["route"] == "fused":
            ok = ok and bits and fwd_bits and rev_bits
    print(f"step: each tree's turns repeat bit for bit {repeat} ({smi()})",
          flush=True)
    if not ok or not repeat["this"] or not probes:
        raise SystemExit("measure_port: the step differs from the parent's, "
                         "this tree's turns differ, or a probe differs from "
                         "its main instance")


REVERSE_TURN = r"""
import json, sys
import torch
from izpi_tpu_torch import profiling
from izpi_tpu_torch.core import rng
from izpi_tpu_torch.core import vecmath as vm
from izpi_tpu_torch.integrator import path
from izpi_tpu_torch.ops import diff_trace, table_grad
from izpi_tpu_torch.parallel import dist
from izpi_tpu_torch.render import renderer
from izpi_tpu_torch.scene.library.cornell import cornell_box
from izpi_tpu_torch.scene.library.misc import cornell_box_obj
scene, n, calls = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
sys.path.append(sys.argv[4])  # the measuring tree, for h100bench
from h100bench import harness
ctx = renderer.RenderContext(
    cornell_box() if scene == "cornell" else cornell_box_obj(), device="cuda")
route = diff_trace.prepare(ctx.cs, ctx.meta, ctx.intersect)
params = dist.extract_params(ctx.cs)
with torch.no_grad():
    params["tex_c0"] *= 0.7
cs_p = dist.inject_params(ctx.cs, {k: v.detach() for k, v in params.items()})
ys = torch.arange(n, device="cuda").repeat_interleave(n)
xs = torch.arange(n, device="cuda").repeat(n)
rays = tuple(x.contiguous() for x in renderer.camera_rays(
    cs_p, rng.render_key(0, device="cuda"), xs, ys, n, n, 0))
target = torch.full((n * n, 3), 0.25, device="cuda")
n_rows = route.n_tex * (2 if route.checker else 1)
c0, c1 = cs_p.textures.c0, cs_p.textures.c1
out = {}
for depth in (50, 8):
    s = path.RenderSettings(max_depth=depth)
    rad, cnt, rec_f, rec_i = diff_trace.forward(route, cs_p, ctx.meta, s,
                                                ctx.intersect, *rays)
    g_rad = torch.where(torch.isfinite(rad), 2.0 * (vm.de_nan(rad) - target)
                        / float(n * n * 3), torch.zeros((), device="cuda"))
    g_rad = g_rad.contiguous()
    pristine = rec_f.clone()

    def rev():
        rec_f.copy_(pristine)  # a tree's reverse may keep its cotangents there
        o = diff_trace.reverse(route, rec_f, rec_i, cnt, g_rad, c0, c1, s)
        if isinstance(o, tuple):
            return table_grad.table_grad(o[0], o[1], (n_rows, 3), count=o[2])
        return o

    ms = profiling.graph_ms(rev, 20) - profiling.graph_ms(
        lambda: rec_f.copy_(pristine), 20)
    _, recs, _ = harness.device_intervals(
        torch, lambda: [rev() for _ in range(calls)])
    recs = [r for r in recs if "Memcpy" not in r[2]]
    busy = harness.union_seconds(recs)
    rows = {}
    for start, end, name in recs:
        us, count = rows.get(name, (0.0, 0))
        rows[name] = (us + end - start, count + 1)
    rows = sorted(((us, name, count) for name, (us, count) in rows.items()),
                  reverse=True)
    longest = torch.nn.functional.pad(cnt, (0, (-cnt.shape[0]) % 32)).view(
        -1, 32).amax(1).double()
    out[depth] = dict(ms=ms, busy_us=busy * 1e6 / calls,
                      records=int(cnt.sum()),
                      warp_planes=int(longest.sum()),
                      kernels=[(name[:70], dt / calls, c / calls)
                               for dt, name, c in rows])
print(json.dumps(out))
"""


def reverse_turns(scene: str, parent, rounds: int, runs: int) -> None:
    """--reverse: the step's reverse alone (R then G in a tree whose
    `diff_trace.reverse` returns slots) at 256x256, depth 50 and 8, in this
    tree or in rounds of turns parent, this, this, parent: its ms over a
    CUDA graph of 20 calls and, from torch.profiler over `runs` calls, each
    device kernel's µs a call."""
    here = Path(__file__).resolve().parent
    order = (("parent", "this", "this", "parent") * rounds if parent
             else ("this",))
    trees = {"parent": parent.resolve() if parent else None, "this": here}
    got = {name: [] for name in set(order)}
    for turn, name in enumerate(order):
        r = run_turn(REVERSE_TURN, trees[name],
                     [scene, "256", str(runs), str(here)])
        got[name].append(r)
        for depth, v in r.items():
            ks = "; ".join(f"{k} {us:.2f} us x{c:g}" for k, us, c in
                           v["kernels"])
            print(f"reverse turn {turn} ({name}, {trees[name]}): {scene} "
                  f"depth {depth}: {v['ms']:.4f} ms a call (a CUDA graph of "
                  f"20), busy {v['busy_us']:.2f} us a call under the "
                  f"profiler, {v['records']} records, {v['warp_planes']} "
                  f"warp planes (a warp's longest path, summed); {ks}",
                  flush=True)
    for depth in ("50", "8"):
        line = "; ".join(
            f"{name} {statistics.median(r[depth]['ms'] for r in v):.4f}"
            for name, v in got.items())
        print(f"reverse: {scene} depth {depth}: median ms {line} ({smi()})",
              flush=True)


def step_probe_line(p: dict) -> str:
    """The forward kernel's probe (`diff_trace.probe`'s dict) on one line."""
    groups = ", ".join(f"{g}: {v:.4f}" for g, v in p["passes_by_group"].items())
    if "cycles_per_pass_by_group" in p:
        groups += "; cycles a pass " + ", ".join(
            f"{g}: {v:.0f}" for g, v in p["cycles_per_pass_by_group"].items())
    return (f"probe: lane use {p['lane_use']:.4f} ({p['bounces']} bounces in "
            f"{p['passes']} warp passes; a warp's longest path "
            f"{p['longest_mean']:.4f} bounces on average); cycles a bounce "
            f"{p['cycles_per_bounce']:.1f}: closest hit {p['share_hit']:.2%}, "
            f"cipher {p['share_draws']:.2%}, the rest {p['share_rest']:.2%}; "
            f"span {p['span_us']:.2f} us, the warps' ends at "
            f"{p['end_p50']:.4f} (median), {p['end_p90']:.4f} (90%) of it, "
            f"tail share {p['tail_share']:.2%}, last start at "
            f"{p['start_spread']:.4f}; passes by lanes a path {{{groups}}}")


def run_turn(script: str, tree: Path, args) -> dict:
    """Run a turn script from `tree`'s root with only its package on the
    path; returns the JSON of its last line."""
    run = subprocess.run([sys.executable, "-c", script, *args], cwd=tree,
                         capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(tree)})
    if run.returncode != 0:
        raise SystemExit(f"measure_port: the turn in {tree} failed:\n"
                         f"{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def parent_turns(scene: str, row: bool, parent: Path, runs: int,
                 mode: str = "wavefront") -> None:
    """--parent: the main path of `scene` from `parent` and from this tree,
    in turns parent, this, this, parent (the module docstring)."""
    _, n, spp, depth, slots = SCENES[scene]
    here = Path(__file__).resolve().parent
    trees = {"parent": parent.resolve(), "this": here}
    got = {"parent": [], "this": []}
    with tempfile.TemporaryDirectory() as tmp:
        for turn, name in enumerate(("parent", "this", "this", "parent")):
            out = Path(tmp) / f"{name}{turn}.npz"
            r = run_turn(TURN, trees[name], [scene, str(n), str(spp), str(depth),
                                             str(runs), str(int(row)), mode,
                                             str(out)])
            print(f"turn {turn} ({name}, {trees[name]}): {scene}"
                  f"{' --row' if row else ''} mode {mode}, engine "
                  f"{r['engine']} (pool iterations {r['iterations']}), "
                  f"{n}x{n}@{spp} depth {depth}: rays {r['rays']}; render() "
                  f"seconds {[round(x, 4) for x in r['seconds']]}, median "
                  f"{statistics.median(r['seconds']):.4f}; ms per launch "
                  f"{[round(x, 4) for x in r['ms']]} ({r['launches']} launches "
                  f"a render), median {statistics.median(r['ms']):.4f}; ptxas "
                  f"{r['usage']}", flush=True)
            if "traversal" in r:
                print(f"turn {turn} ({name}): traversal of the frame (one "
                      f"more launch): {r['traversal'][0]} nodes popped, "
                      f"{r['traversal'][1]} primitives tested "
                      f"({r['traversal'][0] / r['rays']:.4f} and "
                      f"{r['traversal'][1] / r['rays']:.4f} a ray)", flush=True)
            if "probe" in r:
                print(f"turn {turn} ({name}): {probe_line(r['probe'])}; the "
                      f"probe's render, rays and counts equal the main "
                      f"instance's: {r['probe_same']}", flush=True)
            with np.load(out) as z:
                got[name].append((r, z["xyz"].astype(np.float64)))
    (pr, pa), (tr, ta) = got["parent"][0], got["this"][0]
    med = {k: statistics.median(x for r, _ in v for x in r["ms"])
           for k, v in got.items()}
    secs = {k: statistics.median(x for r, _ in v for x in r["seconds"])
            for k, v in got.items()}
    diff = np.abs(ta - pa)
    ok = diff <= PARENT_ATOL + PARENT_RTOL * np.abs(pa)
    bits = {k: all(r["rays"] == v[0][0]["rays"] and np.array_equal(a, v[0][1])
                   for r, a in v) for k, v in got.items()}
    within = {k: all(r["rays"] == v[0][0]["rays"] and bool(
        (np.abs(a - v[0][1]) <= PARENT_ATOL + PARENT_RTOL
         * np.abs(v[0][1])).all()) for r, a in v) for k, v in got.items()}
    label = "XYZ" if scene in ("pyramid", "dragon") else "image"
    print(f"parent vs this tree: rays {pr['rays']} vs {tr['rays']} (equal "
          f"{pr['rays'] == tr['rays']}); {label} pixels within {PARENT_ATOL} + "
          f"{PARENT_RTOL}|parent|: {ok.all(axis=2).mean():.6f} (all: "
          f"{bool(ok.all())}), max abs err {diff.max():.3e}, bit for bit "
          f"{bool(np.array_equal(ta, pa))}; each tree's turns repeat bit for "
          f"bit {bits}, within the tolerance {within}; median ms per launch "
          f"{med['parent']:.4f} -> {med['this']:.4f} "
          f"({med['parent'] / med['this']:.3f}x); median render() seconds "
          f"{secs['parent']:.4f} -> {secs['this']:.4f} "
          f"({secs['parent'] / secs['this']:.3f}x) ({smi()})", flush=True)
    # A megakernel's turns repeat bit for bit, and this tree's pool too
    # (its deposit is a segment sum in an order the slots fix); the
    # parent's pool summed its deposits with float atomics, whose order
    # changes from run to run, so its turns repeat within the tolerance.
    repeat = bits["this"] and (within["parent"] if slots is None
                               else bits["parent"])
    if "traversal" in pr and "traversal" in tr:
        print(f"parent vs this tree: traversal counts {pr['traversal']} vs "
              f"{tr['traversal']} (equal {pr['traversal'] == tr['traversal']})",
              flush=True)
    probes = all(r.get("probe_same", True) for v in got.values() for r, _ in v)
    if pr["rays"] != tr["rays"] or not ok.all() or not repeat or not probes:
        raise SystemExit("measure_port: this tree's main path differs from "
                         "the parent's, or a probe from its main instance")


def probe_line(p: dict) -> str:
    """The BVH form's probe (`megakernel.probe_bvh`'s dict) on one line."""
    return (f"probe: lane use {p['use_visits']:.4f} of the visit passes "
            f"({p['visits']} nodes popped in {p['visit_passes']} warp passes), "
            f"{p['use_tests']:.4f} of the test passes ({p['tests']} primitives "
            f"tested in {p['test_passes']}); nodes popped a traversal call "
            f"{p['nodes_mean']:.4f} a lane against the warp's most "
            f"{p['nodes_warp_max']:.4f} ({p['rays']} lane calls in "
            f"{p['calls']} warp calls); cycles: traversal "
            f"{p['share_traversal']:.2%}, shading and cipher "
            f"{p['share_shading']:.2%}, regeneration "
            f"{p['share_regeneration']:.2%}")


def cipher_turns(parent, runs: int) -> None:
    """--cipher: the cipher entry alone at CIPHER_SHAPES, in this tree, or
    in turns parent, this, this, parent (the module docstring)."""
    here = Path(__file__).resolve().parent
    order = (("parent", "this", "this", "parent") if parent else ("this",))
    trees = {"parent": parent.resolve() if parent else None, "this": here}
    got = {name: [] for name in set(order)}
    with tempfile.TemporaryDirectory() as tmp:
        for turn, name in enumerate(order):
            out = Path(tmp) / f"{name}{turn}.npz"
            r = run_turn(CIPHER_TURN, trees[name],
                         [json.dumps(CIPHER_SHAPES), str(100 * runs), str(out)])
            with np.load(out) as z:
                bits = {k: z[k] for k in z.files}
            got[name].append((r["ms"], bits))
            print(f"cipher turn {turn} ({name}, {trees[name]}): " + "; ".join(
                f"{k} x {u}: {ms:.5f} ms" for (k, u), ms in
                zip(CIPHER_SHAPES, r["ms"])), flush=True)
    first = got[order[0]][0][1]
    same = all(np.array_equal(bits[k], first[k]) for v in got.values()
               for _, bits in v for k in first)
    med = {name: {shape: statistics.median(ms[i] for ms, _ in v)
                  for i, shape in enumerate(CIPHER_SHAPES)}
           for name, v in got.items()}
    for k, u in CIPHER_SHAPES:
        versus = (f"; parent {med['parent'][k, u]:.5f} ms, this / parent "
                  f"{med['this'][k, u] / med['parent'][k, u]:.3f}"
                  if parent else "")
        print(f"cipher: {k} keys x {u} uniforms: this tree "
              f"{med['this'][k, u]:.5f} ms per launch (median of its turns)"
              f"{versus}", flush=True)
    for k in sorted({k for k, _ in CIPHER_SHAPES}):
        for unrolled, run_time in CIPHER_PAIRS:
            a, b = med["this"][k, unrolled], med["this"][k, run_time]
            print(f"cipher: {k} keys, this tree: {run_time} uniforms "
                  f"(run-time count) {b:.5f} ms / {unrolled} uniforms "
                  f"(unrolled) {a:.5f} ms = {b / a:.3f}", flush=True)
    print(f"cipher: outputs equal bit for bit across turns {same} ({smi()})",
          flush=True)
    if not same:
        raise SystemExit("measure_port: the cipher turns' outputs differ")


def deposit_forms(runs: int) -> None:
    """--deposit: the pool's deposit alone at the 262,144-slot pool's batch
    over a 256x256 frame (slots' pixels from consecutive sample ids, 30% of
    them older; 20% of the slots deposit), each form timed over a CUDA
    graph of 100 calls, `runs` times in turns: `wavefront.deposit` (a
    stable sort of the slots by pixel and a segment sum) against
    `index_add_`'s float atomics."""
    dev = torch.device("cuda")
    n, n_pix = renderer.POOL_MAX, 256 * 256
    gen = torch.Generator(device=dev).manual_seed(0)
    old = torch.rand(n, device=dev, generator=gen) < 0.3
    sid = torch.arange(n, device=dev) + old * torch.randint(
        0, 4 * n, (n,), device=dev, generator=gen)
    pix = sid % n_pix
    contrib = torch.rand((n, 3), device=dev, generator=gen) * (
        torch.rand((n, 1), device=dev, generator=gen) < 0.2)
    acc = torch.zeros((n_pix, 3), device=dev)
    forms = {"wavefront.deposit": lambda: wavefront.deposit(acc, pix, contrib),
             "index_add_": lambda: acc.index_add_(0, pix, contrib)}
    for turn in range(runs):
        for name, fn in forms.items():
            print(f"deposit turn {turn}: {name}: "
                  f"{profiling.graph_ms(fn, 100):.4f} ms a call ({n} slots, "
                  f"{n_pix} pixels; {smi()})", flush=True)


def vs_cpu(scene: str, frames, seeds) -> None:
    """--vs-cpu: `scene` at each N@S of `frames` and each seed, on the card
    and on the CPU (the module docstring)."""
    make_scene, _, _, depth, slots = SCENES[scene]
    if slots is not None:
        raise SystemExit("measure_port: --vs-cpu takes a pool scene")
    settings = path.RenderSettings(
        max_depth=depth, background=BACKGROUND.get(scene, (0.0, 0.0, 0.0)))
    ctxs = {d: renderer.RenderContext(make_scene(), device=d)
            for d in ("cuda", "cpu")}
    for frame in frames:
        n, spp = (int(x) for x in frame.split("@"))
        gaps = []
        for seed in seeds:
            out = {d: renderer.render(None, n, n, spp, settings, seed=seed,
                                      context=ctx, device=d)
                   for d, ctx in ctxs.items()}
            a, b = out["cuda"].image, out["cpu"].image
            ra, rb = out["cuda"].rays_traced, out["cpu"].rays_traced
            gaps.append((ra - rb) / rb)
            close = (np.abs(a - b) <= VS_CPU_ATOL + VS_CPU_RTOL * np.abs(b)
                     ).all(axis=2).mean()
            equal = (a == b).all(axis=2).mean()
            lit = [int((img.max(axis=2) > 0).sum()) for img in (a, b)]
            means = [np.round(img.mean(axis=(0, 1)), 7).tolist()
                     for img in (a, b)]
            print(f"vs-cpu: {scene} {n}x{n}@{spp} depth {depth} seed {seed}: "
                  f"rays card {ra}, cpu {rb}, gap {ra - rb} ({gaps[-1]:+.3%}); "
                  f"pixels within {VS_CPU_ATOL} + {VS_CPU_RTOL}|cpu| "
                  f"{close:.6f}, equal {equal:.6f}; lit pixels {lit[0]} vs "
                  f"{lit[1]}; means {means[0]} vs {means[1]}", flush=True)
        print(f"vs-cpu: {scene} {n}x{n}@{spp}: rays gap over {len(seeds)} "
              f"seeds: mean {statistics.mean(gaps):+.3%}, mean |gap| "
              f"{statistics.mean(abs(g) for g in gaps):.3%}, max |gap| "
              f"{max(abs(g) for g in gaps):.3%}, positive "
              f"{sum(g > 0 for g in gaps)}, negative "
              f"{sum(g < 0 for g in gaps)} ({smi()})", flush=True)


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
                    help="another tree of the repository to hold a main path "
                         "against, in turns")
    ap.add_argument("--vs-cpu", nargs="+", metavar="N@S",
                    help="a pool scene on the card against the CPU at these "
                         "frames and samples")
    ap.add_argument("--cipher", action="store_true",
                    help="time the cipher entry alone (against --parent)")
    ap.add_argument("--trace-loop", action="store_true",
                    help="time the lockstep oracle's bounces at chunks 8 "
                         "and 1")
    ap.add_argument("--deposit", action="store_true",
                    help="time the pool's deposit against index_add_")
    ap.add_argument("--step", action="store_true",
                    help="time the training step (against --parent)")
    ap.add_argument("--reverse", action="store_true",
                    help="time the step's reverse alone (against --parent)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="--step with --parent: rounds of four turns")
    ap.add_argument("--mode", default="wavefront",
                    choices=["wavefront", "pool"],
                    help="render()'s mode: the default route, or the queue "
                         "pool")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("measure_port: torch.cuda.is_available() is False")
    if args.row and SCENES[args.scene][4] is not None:
        raise SystemExit("measure_port: --row needs a pool scene")
    if args.trace_loop:
        scene = "obj" if "--scene" not in sys.argv else args.scene
        if scene in ("pyramid", "dragon"):
            raise SystemExit("measure_port: --trace-loop needs an RGB scene")
        trace_loop(scene, args.size or 128, args.spp or 4, args.runs or 2)
        return
    if args.cipher:
        print(f"smi before: {smi()}", flush=True)
        cipher_turns(args.parent, args.runs or 3)
        return
    if args.deposit:
        deposit_forms(args.runs or 3)
        return
    if args.reverse:
        reverse_turns(args.scene, args.parent, args.rounds, args.runs or 20)
        return
    if args.step:
        if args.scene not in ("cornell", "obj"):
            raise SystemExit("measure_port: --step takes cornell or obj")
        print(f"smi before: {smi()}", flush=True)
        step_turns(args.scene, args.parent, args.runs or 20, args.rounds,
                   args.spp or 1)
        return
    if args.vs_cpu:
        vs_cpu(args.scene, args.vs_cpu, args.seeds)
        return
    if args.parent and args.scene not in PARENT_SCENES:
        raise SystemExit(f"measure_port: --parent takes {PARENT_SCENES}")
    if args.parent:
        print(f"smi before: {smi()}", flush=True)
        parent_turns(args.scene, args.row, args.parent, args.runs or 3,
                     args.mode)
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
    n, spp = args.size or n, args.spp or spp
    print(f"scene {args.scene}: {n}x{n}@{spp} depth {depth}"
          f"{' through the row-stack kernel' if args.row else ''}", flush=True)
    print(f"smi before: {smi()}", flush=True)
    settings = path.RenderSettings(
        max_depth=depth, background=BACKGROUND.get(args.scene, (0.0, 0.0, 0.0)))
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
    if args.mode == "wavefront" and ctx.mega_bvh() is not None:
        # cornell_box_obj's default route: the RGB megakernel's BVH form.
        slots = functools.partial(megakernel.render_slots,
                                  bvh=ctx.mega_bvh())
    renderer.render(None, n, n, spp, settings, seed=args.seeds[0],
                    mode=args.mode, context=ctx, device="cuda")
    median_s = None
    for seed in args.seeds:
        secs, mrays = [], []
        for _ in range(runs):
            res = renderer.render(None, n, n, spp, settings, seed=seed,
                                  mode=args.mode, context=ctx, device="cuda")
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

    brute = slots is None and not args.row and not isinstance(
        ctx.intersect, bvh_kernel.BVHKernelIntersector)
    if brute:
        # A small pool scene (pbr_ibl) intersects by brute force: its only
        # kernel is the cipher entry.
        threefry.launches = 0
        timed = renderer.render(None, n, n, spp, settings, seed=args.seeds[0],
                                mode=args.mode, context=ctx, device="cuda")
        print(f"brute force ({ctx.meta.n_prims} prims): no traversal kernel; "
              f"the cipher entry launched {threefry.launches} times in one "
              f"render() of {timed.iterations} pool iterations", flush=True)
    elif slots is None:
        module, fn = ((bvh_rowkernel, "closest_hit_rows") if args.row
                      else (bvh_kernel, "closest_hit"))
        before = module.launches
        timed = renderer.render(None, n, n, spp, settings, seed=args.seeds[0],
                                mode=args.mode, context=ctx, device="cuda")
        if module.launches - before != timed.trips:
            raise SystemExit(f"measure_port: {module.launches - before} "
                             f"launches in {timed.trips} pool bodies")
        # The render replays its pool from a CUDA graph, whose launches the
        # host does not see: the kernel is timed on the same paths through
        # the plain loop (the same body, no graph).
        with profiling.event_timed(module, fn) as events:
            wavefront._trace_pool(
                ctx.cs, ctx.meta, settings, ctx.intersect, n, n, spp,
                rng.render_key(args.seeds[0], device="cuda"),
                min(n * n * spp, renderer.POOL_MAX), bool(ctx.meta.spectral),
                ctx.meta.spectral_background_spd or 0, 0, 1, False)
        ms, calls = profiling.event_ms(events), len(events)
        per_launch = ms / calls
        print(f"{module.__name__.rsplit('.', 1)[1]}.{fn} (CUDA events, over "
              f"the plain loop's {calls} launches): {per_launch:.4f} ms per "
              f"launch; x the {timed.trips} launches of one render() "
              f"({timed.iterations} pool iterations, {timed.replays} graph "
              f"replays) = {per_launch * timed.trips / 1e3 / median_s:.2%} of "
              f"the median render() seconds of seed {args.seeds[0]}",
              flush=True)
        if args.row:
            row_sort(ctx, n, spp, settings, args.seeds[0], runs)
    else:
        key = rng.render_key(args.seeds[0], device="cuda")
        tables = ctx.tables()
        _, ms = profiling.cuda_ms(lambda: slots(
            ctx.cs, ctx.meta, settings, n, n, spp, key, tables=tables), 5,
            warm_up=False)
        module = megakernel_spectral if ctx.meta.spectral else megakernel
        name = ("render_slots_spectral" if ctx.meta.spectral
                else "render_slots")
        with profiling.event_timed(module, name) as events:
            renderer.render(None, n, n, spp, settings, seed=args.seeds[0],
                            mode=args.mode, context=ctx, device="cuda")
        in_render = profiling.event_ms(events)
        entry = (megakernel.ENTRY_BVH if isinstance(slots, functools.partial)
                 else module.ENTRY)
        blocks, threads = megakernel.card_grid(entry, ctx.cs.device)
        repl, spp_slot, n_slots = megakernel.slot_layout(
            n * n, spp, megakernel.card_min_slots(entry, ctx.cs.device))
        log = _build.build().with_suffix(".log")
        print(f"build: registers and spill bytes (stores, loads) "
              f"{_build.ptxas_usage(log.read_text())}", flush=True)
        print(f"{entry} via {name} (CUDA events): {ms:.3f} ms per call, "
              f"{ms / 1e3 / median_s:.2%} of the median render() seconds of "
              f"seed {args.seeds[0]}; its launch inside one render() "
              f"{in_render:.3f} ms; grid {blocks} x {threads}, {repl} "
              f"replicas, {n_slots} slots of {spp_slot} samples, "
              f"{n_slots / (blocks * threads):.3f} per resident thread",
              flush=True)

    def profiled():
        nonlocal res
        res = renderer.render(None, n, n, spp, settings, seed=args.seeds[0],
                              mode=args.mode, context=ctx, device="cuda")

    wall, records, _ = harness.device_intervals(torch, profiled)
    busy = harness.union_seconds(records)
    rows = profiling.device_rows(records)
    events = len(records)
    per_iter = (f", {events / res.iterations:.1f} per pool iteration"
                if res.iterations else "")
    print(f"profiled render(): wall {wall:.4f} s, device busy {busy:.4f} s, "
          f"idle share {1 - busy / wall:.2%}; {events} device events "
          f"(kernels and copies){per_iter}", flush=True)
    for dt, name, count in rows[:8]:
        print(f"  {dt / 1e3:10.3f} ms  x{count}  {name[:90]}", flush=True)


if __name__ == "__main__":
    main()
