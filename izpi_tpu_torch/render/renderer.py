"""Render entry point: pixels → paths → accumulated image.

Counterpart of `izpi_tpu/render/renderer.py` for the colour sampler of RGB
and spectral scenes. Pixel convention (render/rgb.go:30-40): film coords
u=(x+ξ)/nx, v=(y+ξ)/ny with v up; the canvas is row-flipped so image[0] is
the top row. Every per-sample colour is DeNAN'd before accumulation
(rgb.go:36).

Modes:
- "wavefront" (the default): the megakernel when the scene is eligible
  (`ops.megakernel.eligible` / `megakernel_spectral.eligible`), else the
  queue pool (`integrator.wavefront.trace_pool`) of
  `min(nx·ny·spp, 1<<18)` slots (renderer.py:298-311).
- "mega": the megakernel, which must take the scene. On a CUDA device it
  launches the CUDA kernel, on the CPU its plain version. An RGB scene
  goes to `ops.megakernel.render_slots`, a spectral one to
  `ops.megakernel_spectral.render_slots_spectral`.
- "pool": the queue pool on any scene.
- "simple": the lockstep oracle (`integrator.path.trace`) of RGB scenes,
  one batch of every pixel per sample.
A spectral canvas (XYZ) goes through firefly rejection and XYZ→ACEScg
with the camera's exposure (renderer.py:426-440).

The intersector is picked once per `RenderContext` (`prepare`,
renderer.py:128-169): a scene of more than BVH_THRESHOLD primitives (or
`use_bvh=True`) gets a BVH4 over reordered primitives, traversed by the
CUDA kernel (`ops.bvh_kernel`) on the card and by its plain version
(`accel.traverse`) on the CPU; any other scene brute force. Nothing falls
back to another mode, intersector or device: a failed build or launch
raises. Entry points run on the card ("cuda") unless the caller asks for
the CPU.
"""

from __future__ import annotations

import dataclasses
import time as time_mod
from typing import Optional

import numpy as np
import torch

from izpi_tpu_torch import camera as camera_mod
from izpi_tpu_torch.core import rng
from izpi_tpu_torch.core import vecmath as vm
from izpi_tpu_torch.integrator import path as path_mod
from izpi_tpu_torch.integrator import wavefront
from izpi_tpu_torch.ops import bvh_kernel, megakernel, megakernel_spectral
from izpi_tpu_torch.scene import types as st
from izpi_tpu_torch.scene.compiler import compile_scene
from izpi_tpu_torch.spectral import convert

# Scenes above this many primitives get a BVH4 (renderer.py:125, where it is
# 16384, a TPU choice). On the card the queue pool with the traversal kernel
# is 1.7-2.5x faster than with brute force at 2k triangles and 17-19x at 20k;
# at 100-500 the two are within the runs' spread (PERF.md, engine policy,
# `measure_port.py --policy`). 560 is the megakernels' cap today, so no
# scene they take is reordered; it stays 560 if that cap moves.
BVH_THRESHOLD = 560
POOL_MAX = 1 << 18  # the largest default pool (renderer.py:311)


@dataclasses.dataclass
class RenderResult:
    image: np.ndarray  # (ny, nx, 3) float32, linear (ACEScg if spectral)
    rays_traced: int
    seconds: float
    device: str = "cpu"  # where the render ran: "cpu" or the CUDA card's name
    xyz: Optional[np.ndarray] = None  # CIE XYZ canvas after firefly rejection (spectral)
    iterations: Optional[int] = None  # queue-pool iterations (pool renders)

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
    on first use). `build_seconds` covers the compile and the BVH build."""

    def __init__(self, scene: st.Scene, use_bvh: Optional[bool] = None, *,
                 device="cuda"):
        self.device = _device(device)
        t0 = time_mod.perf_counter()
        self.cs, self.meta, self.intersect = prepare(scene, self.device,
                                                     use_bvh)
        self.build_seconds = time_mod.perf_counter() - t0
        self._tables = None

    def mega_supported(self) -> bool:
        if self.meta.spectral:
            return megakernel_spectral.eligible(self.cs, self.meta)
        return megakernel.eligible(self.cs, self.meta)

    def tables(self):
        """The scene tables of the megakernel that renders it: RGB
        `SceneTables` or `SpectralTables`."""
        if self._tables is None:
            self._tables = (megakernel_spectral.pack_spectral_tables(self.cs)
                            if self.meta.spectral
                            else megakernel.pack_tables(self.cs))
        return self._tables


def sample_pass(cs, meta, settings, intersect, nx: int, ny: int, xs, ys,
                base_key, sample_id: int):
    """One sample for a batch of pixels (xs, ys: (N,) pixel coords).
    Returns (colour (N, 3) DeNAN'd, rays as a 0-dim int64 tensor)."""
    keys = rng.path_keys(base_key, ys * nx + xs, sample_id)
    o, d, tme = camera_mod.primary_rays(cs.camera, keys, xs, ys, nx, ny)
    color, nrays = path_mod.trace(cs, meta, settings, intersect, o, d, tme,
                                  keys)
    return vm.de_nan(color), nrays


def render(scene: Optional[st.Scene], nx: int, ny: int, spp: int,
           settings: Optional[path_mod.RenderSettings] = None,
           seed: int = 0, mode: str = "wavefront",
           context: Optional[RenderContext] = None, *,
           use_bvh: Optional[bool] = None, device="cuda") -> RenderResult:
    """Render `scene` (or `context`'s scene) at nx×ny with spp samples per
    pixel on `device`: "cuda[:i]" (the default) or "cpu". A spectral scene's
    `image` is ACEScg and its `xyz` the XYZ canvas after firefly
    rejection; `seconds` covers the render, not that post-pass."""
    settings = settings or path_mod.RenderSettings()
    if mode not in ("wavefront", "mega", "pool", "simple"):
        raise ValueError(f"unknown mode {mode!r}")
    dev = _device(device)
    if context is None:
        context = RenderContext(scene, use_bvh, device=dev)
    elif context.device.type != dev.type:
        raise ValueError(f"context is on {context.device}, not {dev}")
    cs, meta = context.cs, context.meta
    dev = context.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    base_key = rng.render_key(seed, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if mode == "simple":
        if meta.spectral:
            raise NotImplementedError(
                "mode 'simple' renders RGB scenes only; a spectral scene "
                "renders through the megakernel or the queue pool")
        return _render_simple(context, settings, nx, ny, spp, base_key, name,
                              sync)

    use_mega = mode == "mega" or (mode == "wavefront"
                                  and context.mega_supported())
    iterations = None
    sync()
    t0 = time_mod.perf_counter()
    if use_mega:
        slots = (megakernel_spectral.render_slots_spectral if meta.spectral
                 else megakernel.render_slots)
        acc, nrays = slots(
            cs, meta, settings, nx, ny, spp, base_key, 0,
            tables=context.tables() if dev.type == "cuda" else None)
    else:
        pool = min(nx * ny * spp, POOL_MAX)
        acc, nrays, iterations = wavefront.trace_pool(
            cs, meta, settings, context.intersect, nx, ny, spp, base_key, pool,
            spectral=meta.spectral,
            bg_spd_id=meta.spectral_background_spd or 0)
    # float64 host accumulator, as the JAX renderer keeps
    # (renderer.py:369-374), so later chunked renders sum alike.
    acc_total = np.zeros((nx * ny, 3), np.float64)
    acc_total += acc.cpu().numpy()
    rays = int(nrays)
    seconds = time_mod.perf_counter() - t0
    canvas = (acc_total / spp).reshape(ny, nx, 3)[::-1].astype(np.float32)
    if not meta.spectral:
        return RenderResult(image=np.ascontiguousarray(canvas),
                            rays_traced=rays, seconds=seconds, device=name,
                            iterations=iterations)
    # The spectral post-pass (leader.go:216-219): firefly rejection on XYZ,
    # then XYZ→ACEScg with exposure.
    xyz = convert.firefly_rejection(canvas.astype(np.float64))
    image = convert.xyz_to_acescg(xyz, meta.exposure).astype(np.float32)
    return RenderResult(image=image, rays_traced=rays, seconds=seconds,
                        device=name, xyz=xyz.astype(np.float32),
                        iterations=iterations)


def _render_simple(context, settings, nx, ny, spp, base_key, name, sync):
    cs, meta, dev = context.cs, context.meta, context.device
    sync()
    t0 = time_mod.perf_counter()
    ys = torch.arange(ny, device=dev).repeat_interleave(nx)
    xs = torch.arange(nx, device=dev).repeat(ny)
    acc = torch.zeros((nx * ny, 3), dtype=torch.float32, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    for s in range(spp):
        color, nr = sample_pass(cs, meta, settings, context.intersect, nx, ny,
                                xs, ys, base_key, s)
        acc = acc + color
        rays = rays + nr
    block = (acc / spp).reshape(ny, nx, 3).cpu().numpy()
    seconds = time_mod.perf_counter() - t0
    # v-up → row flip (rgb.go:40: canvas.Set(x, ny-y)).
    return RenderResult(image=np.ascontiguousarray(block[::-1]),
                        rays_traced=int(rays), seconds=seconds, device=name)
