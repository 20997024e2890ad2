#!/usr/bin/env python3
"""Repeat measurement of the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 measure_port.py [--scene cornell|pyramid] [--size N] [--spp S]
                            [--runs 7] [--seeds 0 1]

Renders one main path of chip_smoke.py, `max_depth=50`, on one warm
`RenderContext`, after one warm-up render: Cornell 256×256 at 1024 spp
through the RGB megakernel (`--scene cornell`, the default) or the spectral
Cornell pyramid 500×500 at 256 spp through the spectral megakernel
(`--scene pyramid`); `--size` and `--spp` change the frame and the samples
per pixel. It prints:
  - the card's name, power limit, SM clock, power draw and temperature
    (nvidia-smi) before and after;
  - per seed, the Mrays/s of each timed `render()` (host clock around the
    call) with their median and quartiles, and the median seconds;
  - the CUDA-event milliseconds of the megakernel's wrapper alone
    (`render_slots` or `render_slots_spectral`: kernel plus the replica and
    ray-count sums), and its share of the median `render()` seconds;
  - one `render()` under `torch.profiler`: wall seconds, device-busy
    seconds (the sum of the CUDA kernels' and copies' self device time),
    the device's idle share of the wall time, and the largest device ops.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from izpi_tpu_torch.core import rng
from izpi_tpu_torch.integrator import path
from izpi_tpu_torch.ops import megakernel, megakernel_spectral
from izpi_tpu_torch.render import renderer
from izpi_tpu_torch.scene.library.cornell import cornell_box
from izpi_tpu_torch.scene.library.cornell_spectral import (
    cornell_box_pyramid_spectral)

# scene -> (constructor, nx = ny, spp, the megakernel wrapper it runs)
SCENES = {
    "cornell": (cornell_box, 256, 1024, megakernel.render_slots),
    "pyramid": (cornell_box_pyramid_spectral, 500, 256,
                megakernel_spectral.render_slots_spectral),
}


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", choices=sorted(SCENES), default="cornell")
    ap.add_argument("--size", type=int, help="frame width and height")
    ap.add_argument("--spp", type=int, help="samples per pixel")
    ap.add_argument("--runs", type=int, default=7, help="timed renders per seed")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("measure_port: torch.cuda.is_available() is False")

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
        for _ in range(args.runs):
            res = renderer.render(None, n, n, spp, settings, seed=seed,
                                  context=ctx, device="cuda")
            secs.append(res.seconds)
            mrays.append(res.mrays_per_sec)
        q1, med, q3 = np.percentile(mrays, [25, 50, 75])
        median_s = median_s or statistics.median(secs)
        print(f"seed {seed}: rays {res.rays_traced}; Mrays/s "
              f"{[round(x, 2) for x in mrays]}; median {med:.2f}, quartiles "
              f"{q1:.2f}-{q3:.2f} (IQR {(q3 - q1) / med:.2%}); seconds median "
              f"{statistics.median(secs):.4f}", flush=True)
    print(f"smi after: {smi()}", flush=True)

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
          f"{ms / 1e3 / median_s:.2%} of the median render() seconds of seed "
          f"{args.seeds[0]}", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        renderer.render(None, n, n, spp, settings, seed=args.seeds[0],
                        context=ctx, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = getattr(e, "self_cuda_time_total", 0)
        if dt:
            rows.append((dt, e.key, e.count))
    rows.sort(reverse=True)
    busy = sum(dt for dt, _, _ in rows) / 1e6
    print(f"profiled render(): wall {wall:.4f} s, device busy {busy:.4f} s, "
          f"idle share {1 - busy / wall:.2%}", flush=True)
    for dt, name, count in rows[:8]:
        print(f"  {dt / 1e3:10.3f} ms  x{count}  {name[:90]}", flush=True)


if __name__ == "__main__":
    main()
