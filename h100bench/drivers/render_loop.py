"""A closed loop of final renders from one client: back-to-back
`render.renderer.render` calls on a warm `RenderContext`, on the default
route, each image at the configuration's size and a new seed drawn from the
run's seed. An image's time is the call into `render()` to its return
(which syncs: the image comes back to the host).

The check: after the window, images drawn from the run's seed, and of each
a sample of pixels drawn from it, against the plain reference's values of
those pixels (all of each pixel's samples, every bounce), and the rays a
sample the window's images traced against the reference's on its paths.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from h100bench import harness
from h100bench.reference import tracer


class State:
    pass


def setup(cell, seed: int, device="cuda", fault=None) -> State:
    """The program's scene compiled on `device` and one image rendered at
    the cell's size (every kernel loaded, the layout and tables built)."""
    from izpi_tpu_torch.integrator.path import RenderSettings
    from izpi_tpu_torch.render import renderer
    from izpi_tpu_torch.scene.library import get_scene

    cfg = cell.config
    st = State()
    st.cell, st.device = cell, torch.device(device)
    st.nx, st.ny, st.spp = cfg["nx"], cfg["ny"], cfg["spp"]
    st.settings = RenderSettings(max_depth=cfg["max_depth"])
    st.renderer = renderer
    st.rng = random.Random(seed)
    st.check_rng = random.Random(seed ^ 0x5A5A5A5A)
    st.ctx = renderer.RenderContext(get_scene(cfg["scene"]), device=device)
    harness.mark("scene compiled")
    st.render = render_fn(st)
    if fault is not None:
        st.render = fault(st.render, st)
    st.images, st.seeds, st.rays, st.times = [], [], [], []
    one(st, keep=False)
    harness.mark("one image rendered")
    return st


def render_fn(st: State):
    """seed -> the program's RenderResult of one image of the cell."""
    def render(seed, spp=None):
        return st.renderer.render(None, st.nx, st.ny, spp or st.spp,
                                  st.settings, seed=seed, context=st.ctx,
                                  device=st.device)
    return render


def one(st: State, keep: bool = True) -> float:
    """Render one image with a new seed; returns its seconds."""
    seed = st.rng.getrandbits(63)
    t0 = time.perf_counter()
    res = st.render(seed)
    dt = time.perf_counter() - t0
    if keep:
        st.images.append(res.image)
        st.seeds.append(seed)
        st.rays.append(res.rays_traced)
        st.times.append(dt)
    return dt


def window(st: State, seconds: float) -> dict:
    """Images back to back until `seconds` have passed; the window ends
    when its last image returns."""
    t0 = time.perf_counter()
    end = t0 + seconds
    while time.perf_counter() < end:
        one(st)
    wall = time.perf_counter() - t0
    samples = len(st.images) * st.nx * st.ny * st.spp
    return {"attempted": len(st.images), "failed": 0, "wall": wall,
            "metrics": {
                "render_msamples_per_s": samples / wall / 1e6,
                "render_p95_ms": harness.percentile(st.times, 95) * 1e3}}


def traced(st: State, items: int):
    """A function that renders `items` more images (not kept), and the
    counters the per-layer metrics read after it ran."""
    counters = {"images": items, "rays": 0,
                "samples": items * st.nx * st.ny * st.spp,
                "nx": st.nx, "ny": st.ny, "spp": st.spp,
                "paths": items * st.nx * st.ny * st.spp,
                "prims": st.ctx.meta.n_prims,
                "prim_kinds": harness.prim_kinds(st.ctx.cs)}

    def fn():
        for _ in range(items):
            with torch.profiler.record_function("h100bench: render()"):
                counters["rays"] += st.render(
                    st.rng.getrandbits(63)).rays_traced

    return fn, counters


def free(st: State) -> None:
    """Drop the program's state, keeping what the check reads."""
    st.ctx = None
    st.renderer = None
    if st.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def check(st: State, limits: dict, control=None) -> dict:
    """The numbers compared, over images drawn from the run's seed:
    `pixel_gap`, the sum of |program − reference| over the sampled pixels
    (all of each pixel's samples) and channels, over the sum of
    |reference|; `rays_gap`, |the window's rays a sample − the reference's
    rays a path on paths drawn at random from the image| over the
    reference's. `control`, a dtype, puts the reference computed in it in
    the program's place, on the same pixels and paths."""
    cfg = st.cell.config
    spec, depth = cfg["reference_scene"], cfg["max_depth"]
    n_img = min(limits["check_images"], len(st.images))
    picks = sorted(st.check_rng.sample(range(len(st.images)), n_img))
    base = tracer.compiled(spec, st.device)
    low = None if control is None else tracer.compiled(spec, st.device,
                                                      control)
    diff = norm = 0.0
    ref_rays = got_rays = paths = 0
    for i in picks:
        seed = st.seeds[i]
        pixels = tracer.sample_pixels(st.check_rng, st.nx, st.ny,
                                      limits["check_pixels"])
        ref, _ = tracer.render_pixels(spec, st.nx, st.ny, st.spp, depth,
                                      seed, pixels, st.device,
                                      compiled_scene=base)
        n = limits["check_paths"]
        pid = [st.check_rng.randrange(st.nx * st.ny) for _ in range(n)]
        sid = [st.check_rng.randrange(st.spp) for _ in range(n)]
        _, r = tracer.render_paths(spec, st.nx, st.ny, depth, seed, pid, sid,
                                   st.device, compiled_scene=base)
        ref_rays += int(r.sum())
        paths += n
        if control is None:
            got = tracer.fetch(st.images[i], pixels, st.nx, st.ny)
        else:
            got, _ = tracer.render_pixels(spec, st.nx, st.ny, st.spp, depth,
                                          seed, pixels, st.device, control,
                                          compiled_scene=low)
            got = got.cpu().numpy()
            _, r = tracer.render_paths(spec, st.nx, st.ny, depth, seed, pid,
                                       sid, st.device, control,
                                       compiled_scene=low)
            got_rays += int(r.sum())
        ref = ref.cpu().numpy()
        diff += float(np.abs(got - ref).sum())
        norm += float(np.abs(ref).sum())
    ref_rate = ref_rays / paths
    got_rate = (sum(st.rays) / (len(st.rays) * st.nx * st.ny * st.spp)
                if control is None else got_rays / paths)
    return {"pixel_gap": diff / norm,
            "rays_gap": abs(got_rate - ref_rate) / ref_rate}
