"""Entry points: the forward sample pass and one differentiable step.

Counterpart of `__graft_entry__.py`: `entry()` (:44-57) returns the forward
sample pass on the Cornell box at 64², depth 8, with its arguments, and
`train_step_demo()` runs part 3 of `dryrun_multichip` (:124-141), the
differentiable step with its loss and gradients, on one device. Parts 1,
1b and 2 of the dryrun (the pool, the megakernel and the spectral pool
sharded over a mesh) and the gradient all-reduce are ROADMAP A15's. Both
run on "cuda" unless the caller asks for "cpu".
"""

from __future__ import annotations

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
    target: returns (loss, grads) after checking that both are finite."""
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
