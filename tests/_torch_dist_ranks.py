"""Rank bodies of tests/test_torch_dist.py, run by `parallel.dist.spawn` on
the CPU (gloo). A module of its own so that the ranks import torch and
izpi_tpu_torch only, not JAX.

`checks` runs every port-side case of the file in one spawn, so the ranks
pay for torch's import once; each rank returns what its cases gave, as
numpy."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed

from izpi_tpu_torch.core import rng
from izpi_tpu_torch.integrator import path
from izpi_tpu_torch.ops import megakernel
from izpi_tpu_torch.parallel import dist
from izpi_tpu_torch.render import renderer
from izpi_tpu_torch.scene import compiler
from izpi_tpu_torch.scene.library.cornell import cornell_box
from izpi_tpu_torch.scene.library.cornell_spectral import cornell_box_spectral
from izpi_tpu_torch.scene.library.extracted import (
    cornell_box_pbr_stanford_dragon_spectral)
from izpi_tpu_torch.scene.library.misc import pbr_ibl

# The frames of tests/test_parallel.py's cases: (nx, ny, spp, depth, seed).
SAMPLE_RGB = (16, 16, 8, 4, 11)
SAMPLE_SPECTRAL = (8, 8, 8, 4, 3)
PRIM_RENDER = (8, 8, 2, 3, 0)
PRIM_BVH_RENDER = (6, 6, 1, 3, 0)
DRAGON_TRIS = 4000
TRAIN = (8, 3, 0)  # pixels a side, depth, seed
CPU = "cpu"


def rays_for_intersector(n=256, seed=4):
    """tests/test_parallel.py:125-129's rays."""
    rs = np.random.RandomState(seed)
    o = (278 + rs.randn(n, 3) * 200).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    return o, d, np.zeros(n, np.float32)


def train_target(n):
    return (np.random.RandomState(1).rand(n * n, 3) * 0.3).astype(np.float32)


def pixels(n):
    return np.tile(np.arange(n), n), np.repeat(np.arange(n), n)


def _np(x):
    return x.detach().cpu().numpy()


def _image(res):
    return None if res is None else {"image": res.image, "xyz": res.xyz,
                                     "rays": res.rays_traced,
                                     "phases": res.phases}


def _prim_render(scene, frame, **kw):
    nx, ny, spp, depth, seed = frame
    return _image(dist.render_distributed(
        scene, nx, ny, spp, settings=path.RenderSettings(max_depth=depth),
        seed=seed, shard_prims=True, device=CPU, **kw))


def _shards(local):
    return {"prims": [_np(f) for f in local.prims], "gmap": _np(local.gmap),
            "bounds": _np(local.bounds), "child": _np(local.child),
            "count": _np(local.count)}


def checks(rank: int, n: int, train_params) -> dict:
    out = {}
    world = torch.distributed.group.WORLD

    # Sample sharding (test_parallel.py:17-43).
    nx, ny, spp, depth, seed = SAMPLE_RGB
    out["sample_rgb"] = _image(dist.render_distributed(
        cornell_box(), nx, ny, spp, settings=path.RenderSettings(
            max_depth=depth), seed=seed, device=CPU))
    nx, ny, spp, depth, seed = SAMPLE_SPECTRAL
    out["sample_spectral"] = _image(dist.render_distributed(
        cornell_box_spectral(), nx, ny, spp, settings=path.RenderSettings(
            max_depth=depth), seed=seed, device=CPU))

    # The primitive-sharded intersector, brute and through each shard's
    # BVH4 (test_parallel.py:112-157), and its shards.
    cs, meta = compiler.compile_scene(cornell_box(), CPU)
    o, d, tm = (torch.as_tensor(a) for a in rays_for_intersector())
    for use_bvh in (False, True):
        local, intersect = dist.make_sharded_intersector(cs, use_bvh=use_bvh)
        rec = intersect(o, d, tm, 1e-3, 3.0e38)
        out[f"intersect_bvh{int(use_bvh)}"] = {
            "shards": _shards(local),
            "rec": {k: _np(v) for k, v in rec._asdict().items()}}

    # Primitive-sharded renders (test_parallel.py:160-228), the shards of
    # the BVH case and the texture shards.
    out["prim_brute"] = _prim_render(cornell_box(), PRIM_RENDER)
    out["prim_pbr"] = _prim_render(pbr_ibl(), PRIM_RENDER)
    out["prim_tex"] = _prim_render(pbr_ibl(), PRIM_RENDER,
                                   shard_textures=True)
    dragon = cornell_box_pbr_stanford_dragon_spectral(n_tris=DRAGON_TRIS)
    out["prim_bvh"] = _prim_render(dragon, PRIM_BVH_RENDER)
    dcs, _ = compiler.compile_scene(dragon, CPU)
    out["dragon_shards"] = _shards(dist.make_sharded_intersector(dcs)[0])
    pcs, _ = compiler.compile_scene(pbr_ibl(), CPU)
    tex, _ = dist.make_sharded_textures(dist.strip_replicated_geometry(pcs))
    out["tex_shards"] = {k: _np(v) for k, v in tex._asdict().items()}

    # The sharded training step (dist.py:597-643), from JAX's parameters.
    size, depth, seed = TRAIN
    tcs, tmeta = compiler.compile_scene(cornell_box(), CPU)
    step = dist.build_train_step(
        tcs, tmeta, path.RenderSettings(max_depth=depth),
        path.make_brute_intersector(tcs), size, size, group=world)
    xs, ys = (torch.as_tensor(a) for a in pixels(size))
    loss, grads = step(dist.params_from_jax(train_params, CPU), xs, ys,
                       torch.as_tensor(train_target(size)),
                       rng.render_key(seed))
    out["train"] = {"loss": float(loss), "rays": step.rays,
                    "grads": {k: _np(g) for k, g in grads.items()}}

    # The pixel-sharded lockstep sampler (against JAX's, and on a split
    # with unequal shares against one process's) and the sample-sharded
    # megakernel against one launch.
    settings = path.RenderSettings(max_depth=3)
    intersect = path.make_brute_intersector(cs)
    xs, ys = (torch.as_tensor(a) for a in pixels(6))
    key = rng.render_key(5)
    sampler = dist.build_sharded_sampler(cs, meta, settings, intersect, 6, 6)
    for label, n_pix in (("sampler_36", 36), ("sampler", 34)):
        # 34 pixels: no multiple of the rank count
        color, rays = sampler(xs[:n_pix], ys[:n_pix], key, 2)
        out[label] = {"color": _np(color), "rays": int(rays)}
    acc, rays = dist.build_mega_renderer(cs, meta, settings, 8, 8, 2)(
        rng.render_key(2))
    out["mega"] = {"acc": _np(acc), "rays": int(rays)}

    out["scaling"] = dist.scaling_efficiency(
        cornell_box(), 8, 8, 8, device_counts=[1, 2],
        settings=path.RenderSettings(max_depth=3), device=CPU)
    return out


def single_sampler_and_mega():
    """The one-process counterparts of `checks`' sampler and megakernel
    cases: sample_pass over all pixels, and one render_slots call."""
    cs, meta = compiler.compile_scene(cornell_box(), CPU)
    settings = path.RenderSettings(max_depth=3)
    intersect = path.make_brute_intersector(cs)
    xs, ys = (torch.as_tensor(a)[:-2] for a in pixels(6))
    key = rng.render_key(5)
    acc, rays = 0, 0
    for s in range(2):
        c, nr = renderer.sample_pass(cs, meta, settings, intersect, 6, 6, xs,
                                     ys, key, s)
        acc, rays = acc + c, rays + int(nr)
    macc, mrays = megakernel.render_slots(cs, meta, settings, 8, 8, 8,
                                          rng.render_key(2))
    return {"color": _np(acc / 2), "rays": rays, "mega_acc": _np(macc),
            "mega_rays": int(mrays)}


def raises(rank: int, n: int):
    if rank == 1:
        raise ValueError("rank 1 fails")
    torch.distributed.barrier()


def hangs(rank: int, n: int):
    if rank == 0:
        import time

        time.sleep(60)
