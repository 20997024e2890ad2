"""Entry points: the forward sample pass, one differentiable step, and the
multi-device dry run.

Counterpart of `__graft_entry__.py`: `entry()` (:44-57) returns the forward
sample pass on the Cornell box at 64², depth 8, with its arguments;
`train_step_demo()` runs part 3 of `dryrun_multichip` (:124-141), the
differentiable step with its loss and gradients, on one device; and
`dryrun_multichip(n)` (:59-142) spawns n ranks and runs the four parts on
them. Each runs on "cuda" unless the caller asks for "cpu".
"""

from __future__ import annotations

import numpy as np
import torch

from izpi_tpu_torch.core import rng
from izpi_tpu_torch.integrator import path as path_mod
from izpi_tpu_torch.parallel import dist
from izpi_tpu_torch.render import renderer
from izpi_tpu_torch.scene.compiler import compile_scene
from izpi_tpu_torch.scene.library.cornell import cornell_box


def _compiled(nx: int, ny: int, max_depth: int, device):
    cs, meta = compile_scene(cornell_box(aspect=nx / ny), device)
    intersect = path_mod.make_brute_intersector(cs)
    return cs, meta, path_mod.RenderSettings(max_depth=max_depth), intersect


def _pixels(nx: int, ny: int, device):
    ys = torch.arange(ny, device=device).repeat_interleave(nx)
    xs = torch.arange(nx, device=device).repeat(ny)
    return xs, ys


def entry(device="cuda"):
    """(fn, args): fn(cs, xs, ys, key) -> (colour (4096, 3), rays), one
    sample of every pixel of the Cornell box at 64², depth 8, seed 0."""
    dev = renderer._device(device)
    nx = ny = 64
    cs, meta, settings, intersect = _compiled(nx, ny, 8, dev)

    def fn(cs, xs, ys, key):
        return renderer.sample_pass(cs, meta, settings, intersect, nx, ny,
                                    xs, ys, key, 0)

    xs, ys = _pixels(nx, ny, dev)
    return fn, (cs, xs, ys, rng.render_key(0, device=dev))


def train_step_demo(device="cuda", n: int = 16, max_depth: int = 3):
    """One differentiable step on the Cornell box at n², against a black
    target: returns (loss, grads) after checking that both are finite. On
    the card the step is `build_train_step`'s captured one: its first call
    warms up, captures the CUDA graph and replays it."""
    dev = renderer._device(device)
    cs, meta, settings, intersect = _compiled(n, n, max_depth, dev)
    step = dist.build_train_step(cs, meta, settings, intersect, n, n, spp=1)
    xs, ys = _pixels(n, n, dev)
    target = torch.zeros((n * n, 3), dtype=torch.float32, device=dev)
    loss, grads = step(dist.extract_params(cs), xs, ys, target,
                       rng.render_key(0, device=dev))
    if not bool(torch.isfinite(loss)):
        raise FloatingPointError(f"loss is {float(loss)}")
    for k, g in grads.items():
        if not bool(torch.isfinite(g).all()):
            raise FloatingPointError(f"gradient of {k} is not finite")
    return loss, grads


def _dryrun_rank(rank: int, n: int, device) -> dict:
    """One rank of `dryrun_multichip`: its four parts, each checked, with
    the kernel launches each made on this rank (the counters set to 0 just
    before the part and read just after)."""
    from izpi_tpu_torch.ops import bvh_kernel, megakernel, threefry
    from izpi_tpu_torch.scene.library.cornell_spectral import (
        cornell_box_spectral)

    dev = dist.rank_device(device)
    nx = ny = 16
    out = {}
    counters = {"bvh4_traverse": bvh_kernel, "megakernel_rgb": megakernel,
                "izpi_threefry_uniforms": threefry}

    def counted(label, fn):
        for mod in counters.values():
            mod.launches = 0
        acc, rays = fn()
        out[label] = {"rays": int(rays), "launches": {
            k: mod.launches for k, mod in counters.items()}}
        return acc.cpu().numpy(), int(rays)

    # 1. The RGB pool, sample-sharded, through the BVH4 kernel on the card
    # (its plain version on the CPU).
    cs, meta, settings, _ = _compiled(nx, ny, 3, dev)
    cs_b, bvh_intersect = bvh_kernel.attach(cs)
    run = dist.build_pool_renderer(cs_b, meta, settings, bvh_intersect, nx,
                                   ny, spp_local=1)
    acc, rays = counted("pool_bvh", lambda: run(rng.render_key(0, dev)))
    assert np.isfinite(acc).all() and rays > 0 and acc.max() > 0.0

    # 1b. The RGB megakernel, sample-sharded.
    mega = dist.build_mega_renderer(cs, meta, settings, 8, 8, 1)
    acc, rays = counted("megakernel", lambda: mega(rng.render_key(2, dev)))
    assert np.isfinite(acc).all() and rays > 0 and acc.max() > 0.0

    # 2. The spectral pool (λ transport, XYZ deposits).
    scs, smeta = compile_scene(cornell_box_spectral(), dev)
    srun = dist.build_pool_renderer(scs, smeta, settings,
                                    path_mod.make_brute_intersector(scs), nx,
                                    ny, spp_local=1, spectral=True)
    acc, rays = counted("spectral_pool", lambda: srun(rng.render_key(1, dev)))
    assert np.isfinite(acc).all() and rays > 0 and acc[:, 1].max() > 0.0

    # 3. The differentiable step: pixels sharded, loss and gradients
    # all-reduced.
    cs2, meta2, settings2, intersect2 = _compiled(nx, ny, 3, dev)
    step = dist.build_train_step(cs2, meta2, settings2, intersect2, nx, ny,
                                 spp=1, group=torch.distributed.group.WORLD)
    xs, ys = _pixels(nx, ny, dev)
    target = torch.zeros((nx * ny, 3), dtype=torch.float32, device=dev)

    def train():
        loss, grads = step(dist.extract_params(cs2), xs, ys, target,
                           rng.render_key(0, device=dev))
        out["loss"] = float(loss)
        out["grads_finite"] = all(bool(torch.isfinite(g).all())
                                  for g in grads.values())
        out["grad_params"] = sum(g.numel() for g in grads.values())
        return loss, step.rays

    counted("train_step", train)
    assert np.isfinite(out["loss"]) and out["grads_finite"]
    return out


def dryrun_multichip(n_devices: int, device="cuda", timeout_s: float = 600.0
                     ) -> list:
    """The multi-device path on n ranks (`parallel.dist.spawn`, one process
    a rank; gloo on the CPU or where ranks share a card, NCCL with a card
    a rank): the RGB queue pool through the BVH4 kernel, the RGB megakernel
    and the spectral pool, each sample-sharded, and the training step with
    its gradient all-reduce, at 16² (the megakernel 8²), depth 3, one
    sample a rank. Every rank checks its results; a failure raises. Prints
    rank 0's summary and returns every rank's (rays and kernel launches by
    part, the loss)."""
    out = dist.spawn(_dryrun_rank, n_devices, args=(str(device),),
                     device=device, timeout_s=timeout_s)
    r0 = out[0]
    print(f"dryrun_multichip({n_devices}): pool+bvh-kernel rays="
          f"{r0['pool_bvh']['rays']}, megakernel rays="
          f"{r0['megakernel']['rays']}, spectral rays="
          f"{r0['spectral_pool']['rays']}, loss={r0['loss']:.6f}, "
          f"{r0['grad_params']} grad params OK")
    return out
