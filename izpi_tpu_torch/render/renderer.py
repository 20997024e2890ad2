"""Render entry point: pixels → paths → accumulated image.

Counterpart of `izpi_tpu/render/renderer.py`. Pixel convention
(render/rgb.go:30-40): film coords u=(x+ξ)/nx, v=(y+ξ)/ny with v up; the
canvas is row-flipped so image[0] is the top row. Every per-sample colour
is DeNAN'd before accumulation (rgb.go:36).

Samplers (sampler/sampler.go:13-28, renderer.py:289-304): "colour" (RGB
transport; a spectral scene upgrades itself to "spectral", as the
reference's leader.go:78-81 does), "spectral" (λ transport, also of an RGB
scene, whose materials then take their spectra from their RGB values), and
the first-hit AOVs "albedo", "normal" and "wireframe" (`integrator.aov`:
jittered camera rays, one intersection each, averaged over spp).

Modes of the colour and spectral samplers:
- "wavefront" (the default): a megakernel when one takes the scene, else
  the queue pool (`integrator.wavefront.trace_pool`) of
  `min(nx·ny·spp, 1<<18)` slots (renderer.py:298-311). An RGB render whose
  context traverses a BVH4 (`ops.bvh_kernel`) and whose materials the RGB
  megakernel shades goes to the megakernel's BVH form
  (`ops.megakernel.eligible_bvh`); the JAX renderer sends such a scene to
  its pool, and this route is the port's own. Otherwise the megakernels'
  rule is the JAX package's (`ops.megakernel.eligible` /
  `megakernel_spectral.eligible`).
- "mega": a megakernel, which must take the scene: the BVH form where
  `eligible_bvh` holds, else the brute-force one. On a CUDA device it
  launches the CUDA kernel, on the CPU its plain version. An RGB render
  goes to `ops.megakernel.render_slots`, a spectral one to
  `ops.megakernel_spectral.render_slots_spectral`.
- "pool": the queue pool on any scene.
- "simple": the lockstep oracle (`integrator.path.trace`) of RGB renders,
  one batch of rows per sample (`row_chunk` rows, renderer.py:446-484); a
  spectral render goes to the queue pool, as in the JAX renderer
  (renderer.py:293,306).
The megakernel and the pool render the samples in chunks when asked to
report progress (`verbose`), write a preview or checkpoint
(renderer.py:351-438): each chunk renders samples [off, off + n) and adds
its sum to a float64 host accumulator, so a chunked render equals one pass
up to float32 rounding. A checkpoint (`render.checkpoint`) holds that
accumulator; a render given the path of one written for its configuration
resumes at its next sample. Unlike the JAX renderer, a megakernel that
fails raises: it does not fall back to the pool (renderer.py:313-349).
A spectral canvas (XYZ) goes through firefly rejection and XYZ→ACEScg
with the camera's exposure (renderer.py:426-440). A scene that stands in
procedural placeholders for missing assets says so on stderr, once per
`RenderContext` (renderer.py:281-287).

The intersector is picked once per `RenderContext` (`prepare`,
renderer.py:128-169): a scene of more than BVH_THRESHOLD primitives (or
`use_bvh=True`) gets a BVH4 over reordered primitives, traversed by the
CUDA kernel (`ops.bvh_kernel`) on the card and by its plain version
(`accel.traverse`) on the CPU, or inside the RGB megakernel's BVH form;
any other scene brute force. The row-stack
traversal (`ops.bvh_rowkernel`) is never picked here: a caller selects it
by putting the pair `bvh_rowkernel.attach(context.cs)` returns into the
`cs` and `intersect` of a context built with `use_bvh=False`, as with the
JAX package's `RenderContext`, or by handing the pair to
`wavefront.trace_pool`. Nothing falls
back to another mode, intersector or device: a failed build or launch
raises. Entry points run on the card ("cuda") unless the caller asks for
the CPU.
"""

from __future__ import annotations

import dataclasses
import functools
import sys
import time as time_mod
from typing import Optional, Tuple

import numpy as np
import torch

from izpi_tpu_torch import camera as camera_mod
from izpi_tpu_torch import profiling
from izpi_tpu_torch.core import rng
from izpi_tpu_torch.core import vecmath as vm
from izpi_tpu_torch.integrator import aov as aov_mod
from izpi_tpu_torch.integrator import path as path_mod
from izpi_tpu_torch.integrator import wavefront
from izpi_tpu_torch.ops import (bvh_kernel, diff_trace, megakernel,
                                megakernel_spectral, threefry)
from izpi_tpu_torch.render import checkpoint as ckpt_mod
from izpi_tpu_torch.scene import types as st
from izpi_tpu_torch.scene.compiler import compile_scene
from izpi_tpu_torch.spectral import convert

# Scenes above this many primitives get a BVH4 (renderer.py:125, where it is
# 16384, a TPU choice). On the card the queue pool with the traversal kernel
# is 1.7-2.5x faster than with brute force at 2k triangles and 17-19x at 20k;
# at 100-500 the two are within the runs' spread (PERF.md, engine policy,
# `measure_port.py --policy`). 560 is the brute-force megakernels' cap, so
# no scene they take is reordered; an RGB scene above it whose materials
# the RGB megakernel shades takes its BVH form (`megakernel.eligible_bvh`).
BVH_THRESHOLD = 560
POOL_MAX = 1 << 18  # the largest default pool (renderer.py:311)
AOV_SAMPLERS = ("albedo", "normal", "wireframe")
SAMPLERS = ("colour", "spectral") + AOV_SAMPLERS


@dataclasses.dataclass
class RenderResult:
    image: np.ndarray  # (ny, nx, 3) float32, linear (ACEScg if spectral)
    rays_traced: int
    seconds: float
    device: str = "cpu"  # where the render ran: "cpu" or the CUDA card's name
    xyz: Optional[np.ndarray] = None  # CIE XYZ canvas after firefly rejection (spectral)
    iterations: Optional[int] = None  # queue-pool iterations (pool renders)
    # The pool's loop (pool renders): bodies run (the iterations and the
    # chunks' overrun), of them replayed from a CUDA graph, and the host
    # seconds of the graph's capture (within the render's).
    trips: Optional[int] = None
    replays: Optional[int] = None
    capture_seconds: Optional[float] = None
    # Wall seconds by phase (renderer.py:420-435): the scene's compile and
    # BVH build, the first chunk (with any kernel build), the render, and
    # a spectral render's post-pass.
    phases: Optional[dict] = None

    @property
    def mrays_per_sec(self) -> float:
        return self.rays_traced / max(self.seconds, 1e-9) / 1e6


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but "
                               f"torch.cuda.is_available() is False")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cpu' or 'cuda'")
    return dev


def prepare(scene: st.Scene, device, use_bvh: Optional[bool] = None):
    """Compile a scene on `device` and pick its intersector. Returns (cs,
    meta, intersect); with a BVH, cs holds the primitives in tree order."""
    cs, meta = compile_scene(scene, device)
    if use_bvh is None:
        use_bvh = meta.n_prims > BVH_THRESHOLD
    if not use_bvh:
        return cs, meta, path_mod.make_brute_intersector(cs)
    cs, intersect = bvh_kernel.attach(cs)
    return cs, meta, intersect


class RenderContext:
    """A compiled scene and its intersector on one device ("cuda" unless the
    caller asks for "cpu"), plus the megakernel's packed tables (built once,
    on first use; the BVH form's tree tables are the intersector's, packed
    once by `bvh_kernel.attach`) and the queue pool's CUDA graph
    (`graphs`, captured on first use and replayed by later renders of the
    same pool size, frame and sampler; one of another replaces it).
    `build_seconds` covers the compile and the BVH build."""

    def __init__(self, scene: st.Scene, use_bvh: Optional[bool] = None, *,
                 device="cuda"):
        self.device = _device(device)
        t0 = time_mod.perf_counter()
        self.cs, self.meta, self.intersect = prepare(scene, self.device,
                                                     use_bvh)
        self.build_seconds = time_mod.perf_counter() - t0
        self._tables = None
        self._warned_assets = False
        self.graphs = {}

    def mega_supported(self, spectral: Optional[bool] = None) -> bool:
        """Whether a megakernel renders this scene under the colour
        (spectral=False) or spectral sampler; by default the scene's own.
        The spectral megakernel takes spectral scenes only, so an RGB
        scene's spectral render goes to the pool (renderer.py:293-304)."""
        if self.meta.spectral if spectral is None else spectral:
            return megakernel_spectral.eligible(self.cs, self.meta)
        return (self.mega_bvh() is not None
                or megakernel.eligible(self.cs, self.meta))

    def mega_bvh(self):
        """The BVH4 tables (`bvh_kernel.KernelScene`, packed once by
        `bvh_kernel.attach`) the RGB megakernel's BVH form renders this
        scene through, or None where it does not take the scene."""
        if megakernel.eligible_bvh(self.cs, self.meta, self.intersect):
            return self.intersect.ks
        return None

    def tables(self):
        """The scene tables of the megakernel that renders it: RGB
        `SceneTables` or `SpectralTables`."""
        if self._tables is None:
            self._tables = (megakernel_spectral.pack_spectral_tables(self.cs)
                            if self.meta.spectral
                            else megakernel.pack_tables(self.cs))
        return self._tables


def camera_rays(cs, base_key, xs, ys, nx: int, ny: int, sample_id: int):
    """Sample `sample_id`'s camera rays through pixels (xs, ys): (o, d,
    time, path keys). The keys and the camera's uniforms come from one call
    of the cipher entry (`ops.threefry.new_samples`)."""
    keys, cam_u, _ = threefry.new_samples(
        base_key, (ys * nx + xs).to(torch.int64), int(sample_id),
        camera_mod.CAMERA_SALT)
    return (*camera_mod.rays_from_uniforms(cs.camera, cam_u, xs, ys, nx, ny),
            keys)


def sample_pass(cs, meta, settings, intersect, nx: int, ny: int, xs, ys,
                base_key, sample_id: int, differentiable: bool = False,
                route=None):
    """One sample for a batch of pixels (xs, ys: (N,) pixel coords).
    Returns (colour (N, 3) DeNAN'd, rays as a 0-dim int64 tensor).
    differentiable=True traces the differentiable estimate
    (`integrator.path.trace`, through `route`), the training step's
    (renderer.py:55-69)."""
    o, d, tme, keys = camera_rays(cs, base_key, xs, ys, nx, ny, sample_id)
    color, nrays = path_mod.trace(cs, meta, settings, intersect, o, d, tme,
                                  keys, differentiable=differentiable,
                                  route=route)
    return vm.de_nan(color), nrays


def sample_rays(cs, base_key, xs, ys, nx: int, ny: int, spp: int):
    """Samples 0, ..., spp - 1's camera rays through pixels (xs, ys: (N,)),
    sample after sample: (o, d, time, path keys) of spp·N paths, sample
    s's those `camera_rays(..., s)` gives, from one call of the cipher
    entry (a sample id a path; one sample's rays are `camera_rays`', with
    no copy of the pixels)."""
    if spp == 1:
        return camera_rays(cs, base_key, xs, ys, nx, ny, 0)
    n = xs.shape[0]
    pixel = (ys * nx + xs).to(torch.int64)
    sample = torch.arange(spp, dtype=torch.int64,
                          device=pixel.device).repeat_interleave(n)
    keys, cam_u, _ = threefry.new_samples(base_key, pixel.repeat(spp), sample,
                                          camera_mod.CAMERA_SALT)
    return (*camera_mod.rays_from_uniforms(cs.camera, cam_u, xs.repeat(spp),
                                           ys.repeat(spp), nx, ny), keys)


def sample_passes(cs, meta, settings, intersect, nx: int, ny: int, xs, ys,
                  base_key, spp: int, route):
    """Samples 0, ..., spp - 1 for a batch of pixels (xs, ys: (N,)) as one
    differentiable pass of spp·N paths on the fused route (`route`, an
    `ops.diff_trace.DiffScene`), sample after sample: one call of the
    cipher entry for every path's key and camera uniforms (`sample_rays`),
    one launch of the forward kernel, and in the backward one call of the
    reverse. Returns (colours (spp, N, 3) DeNAN'd, sample s's the colour
    `sample_pass(..., s, differentiable=True, route=route)` gives, bit for
    bit; rays as a 0-dim int64 tensor, the passes' together)."""
    o, d, tme, keys = sample_rays(cs, base_key, xs, ys, nx, ny, spp)
    color, nrays = diff_trace.trace(route, cs, meta, settings, intersect, o, d,
                                    tme, keys, passes=spp)
    return vm.de_nan(color).view(spp, xs.shape[0], 3), nrays


def render(scene: Optional[st.Scene], nx: int, ny: int, spp: int,
           settings: Optional[path_mod.RenderSettings] = None,
           seed: int = 0, mode: str = "wavefront",
           context: Optional[RenderContext] = None, *,
           use_bvh: Optional[bool] = None, device="cuda",
           sampler_type: str = "colour",
           ink: Tuple[float, float, float] = (0.0, 0.0, 0.0),
           row_chunk: Optional[int] = None,
           checkpoint_path: Optional[str] = None,
           checkpoint_interval: int = 0,
           preview_path: Optional[str] = None,
           verbose: bool = False) -> RenderResult:
    """Render `scene` (or `context`'s scene) at nx×ny with spp samples per
    pixel on `device`: "cuda[:i]" (the default) or "cpu". A spectral
    render's `image` is ACEScg and its `xyz` the XYZ canvas after firefly
    rejection; `seconds` covers the render, not that post-pass.

    sampler_type is one of SAMPLERS; ink is the wireframe's ink colour (its
    paper is the background). row_chunk bounds the rows of one batch in
    mode "simple". checkpoint_path with checkpoint_interval > 0 writes the
    accumulator every checkpoint_interval samples and resumes from a
    matching file; preview_path writes a PNG of the image so far after
    each chunk; verbose prints progress and the phases.

    Under a recording torch.profiler the call is the span "render"
    (`profiling.span`): "render.prepare" up to the first chunk, then a
    chunk's "megakernel.launch" (on the RGB megakernels' route),
    "render.readback" and "render.accumulate", and the canvas's
    "render.accumulate"."""
    settings = settings or path_mod.RenderSettings()
    if mode not in ("wavefront", "mega", "pool", "simple"):
        raise ValueError(f"unknown mode {mode!r}")
    if sampler_type not in SAMPLERS:
        raise ValueError(f"unknown sampler {sampler_type!r}: one of "
                         f"{SAMPLERS}")
    with profiling.span("render"):
        with profiling.span("render.prepare"):
            dev = _device(device)
            if context is None:
                context = RenderContext(scene, use_bvh, device=dev)
            elif context.device.type != dev.type:
                raise ValueError(f"context is on {context.device}, not {dev}")
            meta = context.meta
            dev = context.device
            name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else "cpu")
            base_key = rng.render_key(seed, device=dev)
            if meta.placeholder_assets and not context._warned_assets:
                print("NOTE: this render substitutes procedural placeholders "
                      "for missing assets:\n  "
                      + "\n  ".join(meta.placeholder_assets), file=sys.stderr)
                context._warned_assets = True
            spectral = meta.spectral or sampler_type == "spectral"
            lockstep = sampler_type in AOV_SAMPLERS or (mode == "simple"
                                                        and not spectral)
            if not lockstep:
                run, pool_loop = _chunk_runner(context, settings, nx, ny,
                                               base_key, spectral, mode)

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        if sampler_type in AOV_SAMPLERS:
            return _render_aov(context, settings, nx, ny, spp, base_key,
                               sampler_type, ink, name, sync)
        if lockstep:
            return _render_simple(context, settings, nx, ny, spp, base_key,
                                  name, sync, row_chunk, verbose)
        fingerprint = None
        if checkpoint_path:
            fingerprint = ckpt_mod.config_fingerprint(
                nx, ny, spp, seed, meta, settings,
                "spectral" if spectral else "colour")
        chunk = checkpoint_interval if checkpoint_interval > 0 else spp
        # Previews and progress need chunks (the reference's live display
        # and its progress bar, renderer.go:110-121).
        if preview_path and chunk == spp and spp > 1:
            chunk = max(1, spp // 8)
        if verbose and chunk == spp and spp >= 8:
            chunk = max(1, spp // 8)
        # float64 host accumulator (renderer.py:369-374): each chunk's
        # float32 sum is added in float64, so chunks sum as one pass does.
        acc_total = np.zeros((nx * ny, 3), np.float64)
        rays = 0
        start = 0
        iterations = None
        if checkpoint_path:
            resumed = ckpt_mod.load(checkpoint_path, fingerprint)
            if resumed is not None:
                acc_total, start, rays = resumed
                if verbose:
                    print(f"resumed at sample {start}/{spp}")

        sync()
        t0 = time_mod.perf_counter()
        first_chunk = None
        for off in range(start, spp, chunk):
            n = min(chunk, spp - off)
            tc = time_mod.perf_counter()
            acc, nrays, its = run(n, off)
            with profiling.span("render.readback"):
                acc = acc.cpu().numpy()
                nrays = int(nrays)
            with profiling.span("render.accumulate"):
                acc_total += acc
            rays += nrays
            if its is not None:
                iterations = (iterations or 0) + its
            if first_chunk is None:
                first_chunk = time_mod.perf_counter() - tc
            done = off + n
            if checkpoint_path:
                ckpt_mod.save(checkpoint_path, acc_total, done, rays,
                              fingerprint)
            if preview_path:
                from izpi_tpu_torch.io import output as output_mod

                snap = (acc_total / done).reshape(ny, nx, 3)[::-1]
                if spectral:
                    snap = convert.xyz_to_acescg(snap, meta.exposure)
                output_mod.write_png(preview_path, snap)
            if verbose:
                elapsed = time_mod.perf_counter() - t0
                eta = elapsed / max(done - start, 1) * (spp - done)
                print(f"samples {done}/{spp} | {rays / 1e6:.1f}M rays | "
                      f"{rays / max(elapsed, 1e-9) / 1e6:.1f} Mrays/s | "
                      f"eta {eta:.0f}s", flush=True)
        sync()
        seconds = time_mod.perf_counter() - t0
        phases = {"scene_build": context.build_seconds,
                  "first_chunk": first_chunk or 0.0, "render": seconds}
        with profiling.span("render.accumulate"):
            canvas = np.ascontiguousarray((acc_total / spp).reshape(
                ny, nx, 3)[::-1].astype(np.float32))
        if not spectral:
            if verbose:
                print(f"phases: {phases}")
            return RenderResult(image=canvas, rays_traced=rays,
                                seconds=seconds, device=name,
                                iterations=iterations, phases=phases,
                                **pool_loop)
        # The spectral post-pass (leader.go:216-219): firefly rejection on
        # XYZ, then XYZ→ACEScg with exposure.
        tp = time_mod.perf_counter()
        xyz = convert.firefly_rejection(canvas.astype(np.float64))
        image = convert.xyz_to_acescg(xyz, meta.exposure).astype(np.float32)
        phases["postprocess"] = time_mod.perf_counter() - tp
        if verbose:
            print(f"phases: {phases}")
        return RenderResult(image=image, rays_traced=rays, seconds=seconds,
                            device=name, xyz=xyz.astype(np.float32),
                            iterations=iterations, phases=phases, **pool_loop)


def _chunk_runner(context, settings, nx, ny, base_key, spectral, mode):
    """The route of a colour or spectral render: (run(n, off) -> (acc, rays,
    pool iterations or None) of samples [off, off + n), the pool's loop
    counters that run adds to, or {} for a megakernel)."""
    cs, meta, dev = context.cs, context.meta, context.device
    if mode == "mega" or (mode == "wavefront"
                          and context.mega_supported(spectral)):
        tables = context.tables() if dev.type == "cuda" else None
        if spectral:
            slots = megakernel_spectral.render_slots_spectral
        else:
            slots = functools.partial(megakernel.render_slots,
                                      bvh=context.mega_bvh())

        def run(n, off):
            acc, nrays = slots(cs, meta, settings, nx, ny, n, base_key, off,
                               tables=tables)
            return acc, nrays, None
        return run, {}
    loop = dict(trips=0, replays=0, capture_seconds=0.0)

    def run(n, off):
        pool = min(nx * ny * n, POOL_MAX)
        stats = {}
        out = wavefront.trace_pool(
            cs, meta, settings, context.intersect, nx, ny, n, base_key,
            pool, spectral=spectral,
            bg_spd_id=meta.spectral_background_spd or 0,
            sample_offset=off, graphs=context.graphs, stats=stats)
        for k in loop:
            loop[k] += stats[k]
        return out
    return run, loop


def _pixels(nx: int, y0: int, n_rows: int, dev):
    """(xs, ys) of rows y0 .. y0 + n_rows - 1, row by row."""
    ys = y0 + torch.arange(n_rows, device=dev).repeat_interleave(nx)
    xs = torch.arange(nx, device=dev).repeat(n_rows)
    return xs, ys


def _render_aov(context, settings, nx, ny, spp, base_key, sampler_type, ink,
                name, sync) -> RenderResult:
    """First-hit AOV render (renderer.py:72-111): jittered camera rays, one
    intersection each, averaged over spp; rays_traced counts one a sample."""
    cs, meta, dev = context.cs, context.meta, context.device
    sync()
    t0 = time_mod.perf_counter()
    xs, ys = _pixels(nx, 0, ny, dev)
    acc = torch.zeros((nx * ny, 3), dtype=torch.float32, device=dev)
    for s in range(spp):
        o, d, tme, _ = camera_rays(cs, base_key, xs, ys, nx, ny, s)
        if sampler_type == "albedo":
            c = aov_mod.sample_albedo(cs, meta, context.intersect, o, d, tme)
        elif sampler_type == "normal":
            c = aov_mod.sample_normal(cs, meta, context.intersect, o, d, tme)
        else:
            c = aov_mod.sample_wireframe(cs, meta, context.intersect, o, d,
                                         tme, ink, settings.background)
        acc = acc + vm.de_nan(c)
    block = (acc / spp).reshape(ny, nx, 3).cpu().numpy()
    seconds = time_mod.perf_counter() - t0
    return RenderResult(image=np.ascontiguousarray(block[::-1]),
                        rays_traced=nx * ny * spp, seconds=seconds,
                        device=name)


def _render_simple(context, settings, nx, ny, spp, base_key, name, sync,
                   row_chunk, verbose) -> RenderResult:
    """The lockstep oracle over batches of `row_chunk` rows (by default as
    many as make 2^20 pixels, renderer.py:446-484), spp samples each."""
    cs, meta, dev = context.cs, context.meta, context.device
    if row_chunk is None:
        row_chunk = max(1, min(ny, (1 << 20) // nx))
    sync()
    t0 = time_mod.perf_counter()
    image = np.zeros((ny, nx, 3), np.float32)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    for y0 in range(0, ny, row_chunk):
        n_rows = min(row_chunk, ny - y0)
        xs, ys = _pixels(nx, y0, n_rows, dev)
        acc = torch.zeros((nx * n_rows, 3), dtype=torch.float32, device=dev)
        for s in range(spp):
            color, nr = sample_pass(cs, meta, settings, context.intersect, nx,
                                    ny, xs, ys, base_key, s)
            acc = acc + color
            rays = rays + nr
        block = (acc / spp).reshape(n_rows, nx, 3).cpu().numpy()
        # v-up → row flip (rgb.go:40: canvas.Set(x, ny-y)).
        image[ny - y0 - n_rows: ny - y0] = block[::-1]
        if verbose:
            print(f"rows {y0}..{y0 + n_rows} done")
    seconds = time_mod.perf_counter() - t0
    return RenderResult(image=image, rays_traced=int(rays), seconds=seconds,
                        device=name)
