"""The plain reference the benchmark judges the port by: a frozen copy of
the part of the port's plain versions that its scenes reach
(`reference/plain/`: the scene, the scene compile, the camera, the
Threefry streams and the RGB estimator),
driven here over blocks of (pixel, sample) paths, each bounce over the
paths still live. It imports nothing of `izpi_tpu_torch`, takes nothing
that the program made (it compiles its own scene and draws its own
streams) and no JAX.

The closest hit tests every primitive (`BruteHit`); of hits at one t the
lowest primitive index wins, as in the port's brute force. A
`dtype` below float32 (the control) casts the scene's tables and each
bounce's carried state to it.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from h100bench.reference.plain import camera as camera_mod
from h100bench.reference.plain.core import vecmath as vm
from h100bench.reference.plain.geometry import primitives as prim
from h100bench.reference.plain.integrator import path as path_mod
from h100bench.reference.plain.ops import threefry as tf
from h100bench.reference.plain.scene.compiler import compile_scene

# Rays of one block of the brute-force hit, and primitives of one chunk.
RAY_BLOCK = 1 << 16
PRIM_CHUNK = 1024


def scene(spec: str):
    """The reference's scene named "module:function" under
    `h100bench.reference.plain.scene.library`."""
    mod, fn = spec.split(":")
    lib = importlib.import_module(
        f"h100bench.reference.plain.scene.library.{mod}")
    return getattr(lib, fn)()


def compiled(spec: str, device, dtype=torch.float32):
    """(cs, meta) of the reference's own compile of `spec`, its float
    tables in `dtype`."""
    cs, meta = compile_scene(scene(spec), device)
    if dtype != torch.float32:
        cs = cast_floats(cs, dtype)
    return cs, meta


def cast_floats(x, dtype):
    """A compiled scene (nested named tuples of tensors) with every float32
    tensor in `dtype`."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype) if x.dtype == torch.float32 else x
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(cast_floats(v, dtype) for v in x))
    return x


def _closest(kind, g, o, d, time, t_min, t_max):
    """(t, local index or -1) of the closest of the primitives `kind`, `g`
    (chunks of PRIM_CHUNK; the first of equal t wins)."""
    n = o.shape[0]
    best_t = torch.full((n,), prim.T_MAX, dtype=o.dtype, device=o.device)
    best_i = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    o_b, d_b, time_b = o[:, None, :], d[:, None, :], time[:, None]
    for lo in range(0, kind.shape[0], PRIM_CHUNK):
        sl = slice(lo, lo + PRIM_CHUNK)
        g0, g1, g2, g3 = (x[None, sl] for x in g)
        t, ok = prim.prim_t(kind[None, sl], g0, g1, g2, g3, o_b, d_b,
                            time_b, t_min, t_max)
        t = torch.where(ok, t, torch.full_like(t, prim.T_MAX))
        t_c, arg = torch.min(t, dim=1)
        better = t_c < best_t
        best_t = torch.where(better, t_c, best_t)
        best_i = torch.where(better, arg + lo, best_i)
    return best_t, best_i


class BruteHit:
    """The closest hit of rays against every primitive (`intersect(o, d,
    time, t_min, t_max) -> Hit`), in blocks of rays. Of hits at one t the
    lowest primitive index wins, as in the port's brute force."""

    def __init__(self, cs):
        p = cs.prims
        self.prims = p
        self.geometry = (p.g0, p.g1, p.g2, p.g3)

    def __call__(self, o, d, time, t_min, t_max):
        ts, ids = [], []
        with torch.no_grad():
            for lo in range(0, o.shape[0], RAY_BLOCK):
                sl = slice(lo, lo + RAY_BLOCK)
                best_t, best_i = _closest(self.prims.kind, self.geometry,
                                          o[sl].detach(), d[sl].detach(),
                                          time[sl], t_min, t_max)
                ts.append(best_t)
                ids.append(best_i)
        t, idx = torch.cat(ts), torch.cat(ids)
        hit = idx >= 0
        if prim.tracks(o, d):
            t = prim.differentiable_t(self.prims, o, d, time, t, idx, hit,
                                      t_min, t_max)
        return prim.finalize_hit(self.prims, o, d, time, t, idx, hit)


def render_key(seed: int, device) -> torch.Tensor:
    """The base key of a render seeded `seed` (the words of
    jax.random.PRNGKey(seed))."""
    return torch.tensor([(seed >> 32) & tf.MASK, seed & tf.MASK],
                        dtype=torch.int64, device=device)


def sample_colors(cs, meta, intersect, settings, nx, ny, xs, ys, samples,
                  key, differentiable=False, dtype=torch.float32):
    """Each path's DeNAN'd colour and rays traced, for paths through
    pixels (xs, ys) (N,) at sample indices `samples` (N,) of the render
    keyed `key`."""
    keys, cam_u, _ = tf.new_samples(key, ys * nx + xs, samples,
                                    camera_mod.CAMERA_SALT)
    o, d, tme = camera_mod.rays_from_uniforms(cs.camera, cam_u, xs, ys, nx,
                                              ny)
    color, rays = trace(cs, meta, settings, intersect, o.to(dtype),
                        d.to(dtype), tme.to(dtype), keys, differentiable,
                        dtype)
    return vm.de_nan(color), rays


def trace(cs, meta, settings, intersect, o, d, time, keys, differentiable,
          dtype):
    """Trace paths to completion, bounce by bounce over the paths still
    live (`plain.integrator.path.bounce_rgb`), the carried state cast to
    `dtype` after each bounce. Returns (colour (N, 3) float32, not DeNAN'd,
    and each path's rays traced (N,)). A path live after max_depth bounces
    adds the depth cap's sentinel (0, 0, 1)·throughput (colour.go:34-36)."""
    n = o.shape[0]
    thru = torch.ones_like(o)
    rad = torch.zeros_like(o)
    idx = torch.arange(n, device=o.device)
    rays = torch.zeros(n, dtype=torch.int64, device=o.device)
    out = []
    for depth in range(settings.max_depth):
        m = idx.shape[0]
        o, d, thru, rad, active, nr = path_mod.bounce_rgb(
            cs, meta, settings, intersect, o, d, time[idx], keys[idx],
            torch.full((m,), depth, dtype=torch.int64, device=o.device),
            thru.to(dtype), rad.to(dtype), torch.ones(m, dtype=torch.bool,
                                                      device=o.device),
            differentiable)
        o, d, thru, rad = (x.to(dtype) for x in (o, d, thru, rad))
        rays[idx] += 1
        out.append((idx[~active], rad[~active]))
        idx, o, d, thru, rad = (x[active] for x in (idx, o, d, thru, rad))
        if idx.shape[0] == 0:
            break
    sentinel = torch.tensor((0.0, 0.0, 1.0), dtype=dtype, device=o.device)
    out.append((idx, rad + thru * sentinel[None, :]))
    color = torch.zeros((n, 3), dtype=dtype, device=o.device)
    color = color.index_put((torch.cat([i for i, _ in out]),),
                            torch.cat([r for _, r in out]))
    return color.float(), rays


def render_paths(spec: str, nx: int, ny: int, max_depth: int, seed: int,
                 pixels, samples, device, dtype=torch.float32,
                 block_paths: int = 1 << 20, compiled_scene=None):
    """The reference's paths (flat pixel id y·nx + x, sample index) of the
    render (nx, ny, seed) at depth `max_depth`: each path's DeNAN'd colour
    (N, 3) and each path's rays traced (N,)."""
    cs, meta = compiled_scene or compiled(spec, device, dtype)
    intersect = BruteHit(cs)
    settings = path_mod.RenderSettings(max_depth=max_depth)
    key = render_key(seed, device)
    pixels = torch.as_tensor(pixels, dtype=torch.int64, device=device)
    samples = torch.as_tensor(samples, dtype=torch.int64, device=device)
    colors, rays = [], []
    with torch.no_grad():
        for lo in range(0, pixels.shape[0], block_paths):
            pid = pixels[lo:lo + block_paths]
            c, r = sample_colors(cs, meta, intersect, settings, nx, ny,
                                 pid % nx, pid // nx,
                                 samples[lo:lo + block_paths], key,
                                 dtype=dtype)
            colors.append(c)
            rays.append(r)
    return torch.cat(colors), torch.cat(rays)


def render_pixels(spec: str, nx: int, ny: int, spp: int, max_depth: int,
                  seed: int, pixels, device, dtype=torch.float32,
                  compiled_scene=None):
    """The reference's value of `pixels` (flat ids y·nx + x, (P,)) of the
    render (nx, ny, spp, seed): (P, 3) float64 means of each pixel's spp
    DeNAN'd samples, and the rays those paths traced."""
    pixels = torch.as_tensor(pixels, dtype=torch.int64)
    n_pix = pixels.shape[0]
    c, r = render_paths(spec, nx, ny, max_depth, seed, pixels.repeat(spp),
                        torch.arange(spp).repeat_interleave(n_pix), device,
                        dtype, compiled_scene=compiled_scene)
    return c.double().reshape(spp, n_pix, 3).sum(0) / spp, int(r.sum())


PARAMS = ("tex_c0", "tex_c1", "tex_images", "mat_absorption", "mat_fuzz",
          "spd_table")


def scene_params(cs) -> dict:
    """The scene's trainable tables under the training step's names."""
    return {"tex_c0": cs.textures.c0, "tex_c1": cs.textures.c1,
            "tex_images": cs.textures.images,
            "mat_absorption": cs.materials.absorption,
            "mat_fuzz": cs.materials.fuzz, "spd_table": cs.spd_table}


def with_params(cs, params):
    textures = cs.textures._replace(c0=params["tex_c0"], c1=params["tex_c1"],
                                    images=params["tex_images"])
    materials = cs.materials._replace(absorption=params["mat_absorption"],
                                      fuzz=params["mat_fuzz"])
    return cs._replace(textures=textures, materials=materials,
                       spd_table=params["spd_table"])


def loss_and_grads(cs, meta, intersect, settings, nx, ny, spp, params,
                   target, key, dtype=torch.float32,
                   block_pixels: int = 1 << 18):
    """The training step's loss (the mean squared error of the spp-sample
    mean image against `target` (nx·ny, 3), pixels in row order) and its
    gradient in each of `params`, summed over blocks of pixels."""
    dev = target.device
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    n = nx * ny
    se_total = 0.0
    for p0 in range(0, n, block_pixels):
        pid = torch.arange(p0, min(n, p0 + block_pixels), device=dev)
        m = pid.shape[0]
        cs_p = with_params(cs, leaves)
        samples = torch.arange(spp, device=dev).repeat_interleave(m)
        c, _ = sample_colors(cs_p, meta, intersect, settings, nx, ny,
                             (pid % nx).repeat(spp), (pid // nx).repeat(spp),
                             samples, key, differentiable=True, dtype=dtype)
        c = c.reshape(spp, m, 3)
        acc = c[0]
        for s in range(1, spp):
            acc = acc + c[s]
        se = torch.sum((acc / spp - target[p0:p0 + m]) ** 2)
        got = torch.autograd.grad(se / float(n * 3), list(leaves.values()),
                                  allow_unused=True)
        for k, g in zip(leaves, got):
            if g is not None:
                grads[k] += g
        se_total += float(se.detach())
    return se_total / float(n * 3), grads


def perturb(params: dict, spec: dict) -> torch.Tensor:
    """Set the rows of `params[spec["leaf"]]` that equal `spec["from"]` to
    `spec["to"]`, in place; returns their indices. Equal within 1%, so
    that a table rounded to bfloat16 (the control) finds the same rows."""
    leaf = params[spec["leaf"]]
    was = torch.tensor(spec["from"], dtype=leaf.dtype, device=leaf.device)
    rows = torch.nonzero(torch.isclose(leaf, was, rtol=1e-2, atol=1e-3)
                         .all(-1)).reshape(-1)
    if rows.numel() == 0:
        raise ValueError(f"no row of {spec['leaf']} equals {spec['from']}")
    with torch.no_grad():
        leaf[rows] = torch.tensor(spec["to"], dtype=leaf.dtype,
                                  device=leaf.device)
    return rows


def clamp_rows(params: dict, spec: dict, rows: torch.Tensor) -> None:
    """Clamp the perturbed rows to `spec["clamp"]` (lo, hi), in place."""
    leaf = params[spec["leaf"]]
    with torch.no_grad():
        leaf[rows] = leaf[rows].clamp(*spec["clamp"])


def adam_steps(spec: str, nx: int, ny: int, spp: int, max_depth: int,
               start: dict, lr: float, target, seeds, device,
               dtype=torch.float32, compiled_scene=None):
    """The reference's run of the training loop: the scene's parameters
    perturbed as `start` says (`perturb`), then one step a seed in `seeds`
    (the loss and gradients at the render keyed by the seed, then
    torch.optim.Adam at `lr` and the perturbed rows' clamp). Returns
    (losses, the first step's gradients, every leaf's change after the
    last step)."""
    cs, meta = compiled_scene or compiled(spec, device, dtype)
    intersect = BruteHit(cs)
    settings = path_mod.RenderSettings(max_depth=max_depth)
    params = {k: v.detach().clone().float()
              for k, v in scene_params(cs).items()}
    rows = perturb(params, start)
    begin = {k: v.clone() for k, v in params.items()}
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    opt = torch.optim.Adam(list(leaves.values()), lr=lr)
    losses, first = [], None
    for seed in seeds:
        run = {k: v.detach().to(dtype) for k, v in leaves.items()}
        loss, grads = loss_and_grads(cs, meta, intersect, settings, nx, ny,
                                     spp, run, target, render_key(seed,
                                                                  device),
                                     dtype)
        losses.append(loss)
        if first is None:
            first = {k: g.float().clone() for k, g in grads.items()}
        for k, leaf in leaves.items():
            leaf.grad = grads[k].float()
        opt.step()
        clamp_rows(leaves, start, rows)
    delta = {k: (leaves[k].detach() - begin[k]) for k in leaves}
    return losses, first, delta


def sample_pixels(rng, nx: int, ny: int, count: int):
    """`count` distinct flat pixel ids drawn with `rng` (random.Random)."""
    return sorted(rng.sample(range(nx * ny), min(count, nx * ny)))


def fetch(image, pixels, nx: int, ny: int):
    """The rows of `pixels` (flat ids y·nx + x) from an (ny, nx, 3) image
    whose row 0 is the top (y = ny - 1), as `render()` returns it."""
    pix = np.asarray(pixels)
    return image[ny - 1 - pix // nx, pix % nx].astype(np.float64)
