"""The differentiable render step: the framework's training step.

Counterpart of the last part of `izpi_tpu/parallel/dist.py` (:572-643):
`extract_params`, `inject_params` and `build_train_step`, on torch
autograd. One device for now: the JAX step shards the pixels over a mesh
axis with `shard_map` and all-reduces the loss (and so the gradients) with
a psum; that, and the rest of `dist.py` (sample- and primitive-sharded
rendering, multi-host), is ROADMAP A15's.

The parameters are the scene's material, texture and light tensors (the
JAX package's BASELINE contract: "differentiable w.r.t.
material/texture/light parameters"). Sampling is detached
(`integrator.path.bounce_rgb`). No kernel has a backward pass, and none
needs one: the cipher entry draws keyed uniforms, which carry no gradient,
and a traversal kernel picks the winning primitive, whose t then gets its
gradient from PyTorch ops (`geometry.primitives.differentiable_t`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from izpi_tpu_torch.render import renderer

# The parameter names, as the JAX package's `extract_params` keys them.
PARAMS = ("tex_c0", "tex_c1", "tex_images", "mat_absorption", "mat_fuzz",
          "spd_table")


def _leaf(x) -> torch.Tensor:
    return x.detach().clone().requires_grad_(True)


def extract_params(cs) -> Dict[str, torch.Tensor]:
    """The scene's trainable tensors as fresh leaves that require grad
    (copies: the compiled scene itself stays out of autograd)."""
    return {
        "tex_c0": _leaf(cs.textures.c0),
        "tex_c1": _leaf(cs.textures.c1),
        "tex_images": _leaf(cs.textures.images),
        "mat_absorption": _leaf(cs.materials.absorption),
        "mat_fuzz": _leaf(cs.materials.fuzz),
        "spd_table": _leaf(cs.spd_table),
    }


def inject_params(cs, params):
    """The compiled scene with `params` in place of its own tensors."""
    textures = cs.textures._replace(c0=params["tex_c0"], c1=params["tex_c1"],
                                    images=params["tex_images"])
    materials = cs.materials._replace(absorption=params["mat_absorption"],
                                      fuzz=params["mat_fuzz"])
    return cs._replace(textures=textures, materials=materials,
                       spd_table=params["spd_table"])


def params_from_jax(leaves: Dict[str, np.ndarray], device
                    ) -> Dict[str, torch.Tensor]:
    """The JAX package's `extract_params(cs)`, its leaves fetched as numpy,
    as the port's parameters on `device` (leaves that require grad), so
    that both packages compute one loss from the same parameters."""
    missing = [k for k in PARAMS if k not in leaves]
    extra = [k for k in leaves if k not in PARAMS]
    if missing or extra:
        raise KeyError(f"expected the parameters {PARAMS}; missing "
                       f"{missing}, unknown {extra}")
    return {k: torch.tensor(np.asarray(leaves[k], np.float32), device=device,
                            requires_grad=True) for k in PARAMS}


def build_train_step(cs, meta, settings, intersect, nx: int, ny: int,
                     spp: int = 1):
    """Returns step(params, xs, ys, target, key) -> (loss, grads).

    The pixels xs, ys (N,) render `spp` samples each through the
    differentiable `renderer.sample_pass` on the scene with `params`
    injected; the loss is the mean squared error against `target` (N, 3)
    over every pixel and channel, and grads holds d loss / d param for each
    of `PARAMS` (zeros for a parameter the render does not reach). The
    step runs on the device of `cs`. `step.rays` holds the rays its last
    call traced (the forward pass's, not the backward's recompute)."""
    if spp < 1:
        raise ValueError(f"spp must be positive, got {spp}")

    def step(params, xs, ys, target, key):
        leaves = {k: (params[k] if params[k].requires_grad
                      else params[k].detach().requires_grad_(True))
                  for k in PARAMS}
        cs_p = inject_params(cs, leaves)
        acc = None
        rays = 0
        for s in range(spp):
            color, nr = renderer.sample_pass(cs_p, meta, settings, intersect,
                                             nx, ny, xs, ys, key, s,
                                             differentiable=True)
            acc = color if acc is None else acc + color
            rays += int(nr)
        color = acc / spp
        loss = torch.sum((color - target) ** 2) / float(xs.shape[0] * 3)
        grads = torch.autograd.grad(loss, [leaves[k] for k in PARAMS],
                                    allow_unused=True)
        step.rays = rays
        return loss.detach(), {
            k: torch.zeros_like(leaves[k]) if g is None else g
            for k, g in zip(PARAMS, grads)}

    step.rays = 0
    return step
