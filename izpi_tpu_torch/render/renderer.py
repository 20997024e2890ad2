"""Render entry point: pixels → paths → accumulated image.

Counterpart of `izpi_tpu/render/renderer.py` for the colour sampler of RGB
and spectral scenes. Pixel convention (render/rgb.go:30-40): film coords
u=(x+ξ)/nx, v=(y+ξ)/ny with v up; the canvas is row-flipped so image[0] is
the top row. Every per-sample colour is DeNAN'd before accumulation
(rgb.go:36).

Modes:
- "wavefront" (the default) and "mega": the megakernel, the CUDA kernel on
  a CUDA device and its plain version on the CPU. An RGB scene goes to
  `ops.megakernel.render_slots`; a spectral scene (`meta.spectral`) to
  `ops.megakernel_spectral.render_slots_spectral`, whose XYZ canvas then
  goes through firefly rejection and XYZ→ACEScg with the camera's exposure
  (renderer.py:426-440). A scene the megakernel does not take raises.
- "simple": the lockstep oracle (`integrator.path.trace`) of RGB scenes,
  one batch of every pixel per sample.
- "pool": the XLA-style queue pool is not ported; it raises, as "simple"
  does on a spectral scene (the JAX package renders spectral scenes only
  through the pool or the megakernel).
Nothing falls back to another mode or another device. Entry points run on
the card ("cuda") unless the caller asks for the CPU.
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
from izpi_tpu_torch.ops import megakernel, megakernel_spectral
from izpi_tpu_torch.scene import types as st
from izpi_tpu_torch.scene.compiler import compile_scene
from izpi_tpu_torch.spectral import convert

_POOL = ("the queue pool (izpi_tpu/integrator/wavefront.py:275) is not "
         "ported yet: ROADMAP A6")


@dataclasses.dataclass
class RenderResult:
    image: np.ndarray  # (ny, nx, 3) float32, linear (ACEScg if spectral)
    rays_traced: int
    seconds: float
    device: str = "cpu"  # where the render ran: "cpu" or the CUDA card's name
    xyz: Optional[np.ndarray] = None  # CIE XYZ canvas after firefly rejection (spectral)

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


class RenderContext:
    """A compiled scene on one device ("cuda" unless the caller asks for
    "cpu"), plus the megakernel's packed tables (built once, on first use)."""

    def __init__(self, scene: st.Scene, *, device="cuda"):
        self.device = _device(device)
        t0 = time_mod.perf_counter()
        self.cs, self.meta = compile_scene(scene, self.device)
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


def sample_pass(cs, meta, settings, nx: int, ny: int, xs, ys, base_key,
                sample_id: int):
    """One sample for a batch of pixels (xs, ys: (N,) pixel coords).
    Returns (colour (N, 3) DeNAN'd, rays as a 0-dim int64 tensor)."""
    keys = rng.path_keys(base_key, ys * nx + xs, sample_id)
    o, d, tme = camera_mod.primary_rays(cs.camera, keys, xs, ys, nx, ny)
    color, nrays = path_mod.trace(cs, meta, settings, o, d, tme, keys)
    return vm.de_nan(color), nrays


def render(scene: Optional[st.Scene], nx: int, ny: int, spp: int,
           settings: Optional[path_mod.RenderSettings] = None,
           seed: int = 0, mode: str = "wavefront",
           context: Optional[RenderContext] = None, *,
           device="cuda") -> RenderResult:
    """Render `scene` (or `context`'s scene) at nx×ny with spp samples per
    pixel on `device`: "cuda[:i]" (the default) or "cpu". A spectral scene's
    `image` is ACEScg and its `xyz` the XYZ canvas after firefly
    rejection; `seconds` covers the render, not that post-pass."""
    settings = settings or path_mod.RenderSettings()
    dev = _device(device)
    if context is None:
        context = RenderContext(scene, device=dev)
    elif context.device.type != dev.type:
        raise ValueError(f"context is on {context.device}, not {dev}")
    cs, meta = context.cs, context.meta
    dev = context.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    base_key = rng.render_key(seed, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if mode in ("wavefront", "mega"):
        if not context.mega_supported():
            raise NotImplementedError(
                f"scene not eligible for the megakernel and {_POOL}")
        slots = (megakernel_spectral.render_slots_spectral if meta.spectral
                 else megakernel.render_slots)
        sync()
        t0 = time_mod.perf_counter()
        acc, nrays = slots(
            cs, meta, settings, nx, ny, spp, base_key, 0,
            tables=context.tables() if dev.type == "cuda" else None)
        # float64 host accumulator, as the JAX renderer keeps
        # (renderer.py:369-374), so later chunked renders sum alike.
        acc_total = np.zeros((nx * ny, 3), np.float64)
        acc_total += acc.cpu().numpy()
        rays = int(nrays)
        seconds = time_mod.perf_counter() - t0
        canvas = (acc_total / spp).reshape(ny, nx, 3)[::-1].astype(np.float32)
        if not meta.spectral:
            return RenderResult(image=np.ascontiguousarray(canvas),
                                rays_traced=rays, seconds=seconds, device=name)
        # The spectral post-pass (leader.go:216-219): firefly rejection on
        # XYZ, then XYZ→ACEScg with exposure.
        xyz = convert.firefly_rejection(canvas.astype(np.float64))
        image = convert.xyz_to_acescg(xyz, meta.exposure).astype(np.float32)
        return RenderResult(image=image, rays_traced=rays, seconds=seconds,
                            device=name, xyz=xyz.astype(np.float32))
    if mode == "pool":
        raise NotImplementedError(_POOL)
    if mode != "simple":
        raise ValueError(f"unknown mode {mode!r}")
    if meta.spectral:
        raise NotImplementedError(
            f"mode 'simple' renders RGB scenes only; a spectral scene renders "
            f"through the megakernel, or {_POOL}")

    sync()
    t0 = time_mod.perf_counter()
    ys = torch.arange(ny, device=dev).repeat_interleave(nx)
    xs = torch.arange(nx, device=dev).repeat(ny)
    acc = torch.zeros((nx * ny, 3), dtype=torch.float32, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    for s in range(spp):
        color, nr = sample_pass(cs, meta, settings, nx, ny, xs, ys, base_key, s)
        acc = acc + color
        rays = rays + nr
    block = (acc / spp).reshape(ny, nx, 3).cpu().numpy()
    seconds = time_mod.perf_counter() - t0
    # v-up → row flip (rgb.go:40: canvas.Set(x, ny-y)).
    return RenderResult(image=np.ascontiguousarray(block[::-1]),
                        rays_traced=int(rays), seconds=seconds, device=name)
