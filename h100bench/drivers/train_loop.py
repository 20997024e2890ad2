"""A closed loop of inverse-rendering steps: the step that
`parallel.dist.build_train_step` returns (its default runner: one CUDA
graph, the fused route where the scene takes it) at the traffic's frame and
samples a pixel, then `torch.optim.Adam` on the six parameters. As the
traffic's source sets it, the parameters start from the scene's own with
one texture row perturbed (`perturb`), that row is clamped after each
update, and the loss is the mean squared error against a render of the
unperturbed scene, which the benchmark's reference renders at
`target_spp` from the run's seed in set-up. Each step renders with a new
key drawn from the run's seed, and ends in the step's own sync (its host
read of the rays).

Set-up builds the one step object and optimizer, and drives them through
the traffic's first steps (the first captures the graph); the window goes
on with that same object. The check: the plain reference runs those first
steps from its own compile of the scene, with the same target and keys,
and the losses, the first gradient as Adam holds it after one step, and
each leaf's change after the first steps are compared; and every loss of
the window and every parameter after it must be finite.
"""

from __future__ import annotations

import random
import time

import torch

from h100bench import harness
from h100bench.reference import tracer

BETA1 = 0.9  # torch.optim.Adam's default, which both sides use
TARGET_SALT = 0x7A26E7


class State:
    pass


def pixels(nx: int, ny: int, device):
    """(xs, ys) of every pixel in row order (flat id y·nx + x)."""
    pid = torch.arange(nx * ny, device=device)
    return pid % nx, pid // nx


def target_image(cell, seed: int, device) -> torch.Tensor:
    """(nx·ny, 3) float32, pixels in row order: the reference's render of
    the unperturbed scene at the traffic's `target_spp`, keyed by a seed
    drawn from the run's."""
    cfg, tr = cell.config, cell.traffic
    nx, ny = tr["nx"], tr["ny"]
    key = random.Random(seed ^ TARGET_SALT).getrandbits(63)
    img, _ = tracer.render_pixels(cfg["reference_scene"], nx, ny,
                                  tr["target_spp"], cfg["max_depth"], key,
                                  torch.arange(nx * ny), device)
    return img.float()


def setup(cell, seed: int, device="cuda", fault=None) -> State:
    from izpi_tpu_torch.integrator.path import RenderSettings
    from izpi_tpu_torch.parallel import dist
    from izpi_tpu_torch.render import renderer
    from izpi_tpu_torch.scene.library import get_scene

    cfg, tr = cell.config, cell.traffic
    st = State()
    st.cell, st.device = cell, torch.device(device)
    st.nx, st.ny, st.spp = tr["nx"], tr["ny"], tr["spp"]
    st.rng = random.Random(seed)
    st.target = target_image(cell, seed, st.device)
    harness.mark(f"target rendered by the reference at {tr['target_spp']} "
                 f"samples a pixel")
    if st.device.type == "cuda":
        # The run's memory peak is the program's, not the target render's.
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    st.ctx = renderer.RenderContext(get_scene(cfg["scene"]), device=device)
    harness.mark("scene compiled")
    st.step = dist.build_train_step(
        st.ctx.cs, st.ctx.meta, RenderSettings(max_depth=cfg["max_depth"]),
        st.ctx.intersect, st.nx, st.ny, spp=st.spp)
    st.params = dist.extract_params(st.ctx.cs)
    st.rows = tracer.perturb(st.params, tr["perturb"])
    st.start = {k: v.detach().clone() for k, v in st.params.items()}
    st.opt = torch.optim.Adam(list(st.params.values()), lr=tr["lr"])
    st.xs, st.ys = pixels(st.nx, st.ny, st.device)
    st.key_of = lambda s: renderer.rng.render_key(s, device=st.device)
    # The step's call (a fault planted in a test wraps it).
    st.call = st.step if fault is None else fault(st.step, st)
    st.seeds, st.losses, st.rays, st.loss_log = [], [], [], []
    for i in range(tr["first_steps"]):
        loss = one(st, marks=i == 0)
        st.losses.append(float(loss))
        harness.mark(f"step {i + 1} of the first {tr['first_steps']}")
        if i == 0:
            st.first_grad = {
                k: (st.opt.state[p]["exp_avg"] / (1.0 - BETA1)).clone()
                for k, p in st.params.items()}
    st.delta = {k: (p.detach() - st.start[k]).clone()
                for k, p in st.params.items()}
    st.first_seeds = list(st.seeds)
    if st.device.type == "cuda":
        torch.cuda.synchronize()
    return st


def one(st: State, marks: bool = False):
    """One step: the loss and gradients at a new key, then Adam and the
    perturbed row's clamp. `marks` times the two halves on standard
    error."""
    seed = st.rng.getrandbits(63)
    with torch.profiler.record_function("h100bench: the step's call"):
        loss, grads = st.call(st.params, st.xs, st.ys, st.target,
                              st.key_of(seed))
    if marks:
        sync(st)
        harness.mark("the first step's call")
    with torch.profiler.record_function("h100bench: Adam"):
        for k, p in st.params.items():
            p.grad = grads[k]
        st.opt.step()
        tracer.clamp_rows(st.params, st.cell.traffic["perturb"], st.rows)
    if marks:
        sync(st)
        harness.mark("the first Adam update")
    st.seeds.append(seed)
    st.rays.append(st.step.rays)
    st.loss_log.append(loss)
    return loss


def sync(st: State) -> None:
    if st.device.type == "cuda":
        torch.cuda.synchronize()


def window(st: State, seconds: float) -> dict:
    """Steps back to back until `seconds` have passed; the window ends
    when its last step's work has finished on the device."""
    n0 = len(st.seeds)
    t0 = time.perf_counter()
    end = t0 + seconds
    while time.perf_counter() < end:
        one(st)
    sync(st)
    wall = time.perf_counter() - t0
    steps = len(st.seeds) - n0
    return {"attempted": steps, "failed": 0, "wall": wall,
            "metrics": {"train_step_ms": wall / steps * 1e3}}


def traced(st: State, items: int):
    """A function that runs `items` more steps, and the counters the
    per-layer metrics read after it ran."""
    counters = {"steps": items, "rays": 0, "nx": st.nx, "ny": st.ny,
                "spp": st.spp, "passes": items * st.spp,
                "paths": items * st.nx * st.ny * st.spp,
                "prims": st.ctx.meta.n_prims,
                "prim_kinds": harness.prim_kinds(st.ctx.cs)}

    def fn():
        replays = st.step.runner.replays
        for _ in range(items):
            one(st)
            counters["rays"] += st.step.rays
        counters["replays"] = st.step.runner.replays - replays

    return fn, counters


def free(st: State) -> None:
    """Count the non-finite losses of every step and the non-finite
    parameters after the last, then drop the program's state."""
    bad = (~torch.isfinite(torch.stack(st.loss_log))).sum()
    for p in st.params.values():
        bad = bad + (~torch.isfinite(p.detach())).sum()
    st.nonfinite = int(bad)
    st.ctx = st.step = st.call = st.opt = st.params = st.loss_log = None
    if st.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def reference_run(st: State, dtype=torch.float32):
    cfg, tr = st.cell.config, st.cell.traffic
    return tracer.adam_steps(cfg["reference_scene"], st.nx, st.ny, st.spp,
                             cfg["max_depth"], tr["perturb"], tr["lr"],
                             st.target, st.first_seeds, st.device, dtype)


def check(st: State, limits: dict, control=None) -> dict:
    """The numbers compared, against the reference's run of the first
    steps: `loss_gap`, the largest |program − reference| / reference of a
    step's loss; `grad_gap` and `delta_gap`, by the worst leaf, |the
    program's norm − the reference's| over the larger of the reference's
    norm of that leaf and of the median leaf, for the first gradient and
    for the change after the first steps; leaves whose reference gradient
    is under a thousandth of the median leaf's (the median over leaves
    with a gradient) are left out of those two; `nonfinite`, the window's
    non-finite losses and parameters. `control`, a dtype, puts the
    reference's run computed in it in the program's place."""
    losses, first, delta = reference_run(st)
    if control is None:
        got_losses, got_first, got_delta = st.losses, st.first_grad, st.delta
    else:
        got_losses, got_first, got_delta = reference_run(st, control)
    return dict(compare(losses, first, delta, got_losses, got_first,
                        got_delta), nonfinite=st.nonfinite)


def compare(losses, first, delta, got_losses, got_first, got_delta) -> dict:
    norm = {k: float(torch.linalg.vector_norm(g.double()))
            for k, g in first.items()}
    moving = sorted(v for v in norm.values() if v > 0.0)
    median = moving[len(moving) // 2] if moving else 0.0
    counted = [k for k, v in norm.items() if v >= 1e-3 * median and v > 0]

    def gap(ref, got):
        out = 0.0
        ref_med = sorted(float(torch.linalg.vector_norm(ref[k].double()))
                         for k in counted)[len(counted) // 2]
        for k in counted:
            r = float(torch.linalg.vector_norm(ref[k].double()))
            g = float(torch.linalg.vector_norm(got[k].double().to(
                ref[k].device)))
            out = max(out, abs(g - r) / max(r, ref_med))
        return out

    loss_gap = max(abs(g - r) / abs(r) for g, r in zip(got_losses, losses))
    return {"loss_gap": loss_gap, "grad_gap": gap(first, got_first),
            "delta_gap": gap(delta, got_delta)}
