"""Scale-out over torch.distributed, and the differentiable render step.

Counterpart of `izpi_tpu/parallel/dist.py`. The JAX package shards work
over the axis of a device mesh with `shard_map`; here a process group of n
ranks, one process per device, takes the mesh's place:

| JAX                                  | here                                  |
|--------------------------------------|---------------------------------------|
| `Mesh` of n devices (`make_mesh`)     | a process group (`make_group`); functions take `group=` where JAX takes `mesh=` |
| `shard_map(..., in_specs=P(TILE_AXIS))` | every rank runs the body on its own shard, split on the host by rank |
| `psum`, `pmin`, `pmax`                | `all_reduce` with SUM, MIN, MAX        |
| `jax.distributed.initialize`         | `init_process_group` over a TCP rendezvous (`initialize_multihost`) |
| `jax.lax.axis_index`                 | `torch.distributed.get_rank(group)`   |

A group of None means the default (world) group, except in
`build_train_step`, where None keeps the single-device step. Every rank of
a group makes the same calls in the same order: rays are replicated or the
loops are equal on every rank, so each collective finds its peers. The
collectives are `all_reduce` and `broadcast` only, the two that the gloo
backend runs on CUDA tensors; gloo serves the CPU and ranks that share a
card, NCCL ranks with a card each (`cluster_layout`: NCCL refuses two
ranks on one card). A failed rendezvous or collective raises on every rank (the
group's timeout bounds a wait on a peer that is gone); nothing carries on
alone or falls back to another device.

- `render_distributed` shards samples: every rank runs the queue pool
  (`integrator.wavefront.trace_pool`) over the whole frame on its own
  sample range (offset rank·spp_local), then one all-reduce sums the
  canvases and one the ray counters. `build_mega_renderer` does the same
  with the RGB megakernel.
- `shard_prims=True` shards primitives instead: each rank holds one slice
  of the primitives with its own BVH4 (`make_sharded_intersector`),
  traversed by the CUDA kernel on the card; the rays are replicated, and
  the closest hit reduces over the group in every bounce. With
  `shard_textures=True` the image stacks are sharded too
  (`make_sharded_textures`).
- `build_train_step(..., group=...)` shards pixels and all-reduces the
  loss and the gradients.
- `spawn` runs a function on n local ranks, each in a process of its own.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import socket
import tempfile
import time as time_mod
import traceback
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from izpi_tpu_torch import profiling
from izpi_tpu_torch.accel import bvh_build, traverse
from izpi_tpu_torch.core import loops, rng
from izpi_tpu_torch.geometry import primitives as prim
from izpi_tpu_torch.integrator import path as path_mod
from izpi_tpu_torch.integrator import wavefront
from izpi_tpu_torch.ops import bvh_kernel, diff_trace, megakernel
from izpi_tpu_torch.render import renderer
from izpi_tpu_torch.scene import types as st
from izpi_tpu_torch.scene.compiler import compile_scene
from izpi_tpu_torch.spectral import convert

SUM, MIN = dist.ReduceOp.SUM, dist.ReduceOp.MIN
TIMEOUT_S = 600.0  # a group's wait on a peer before its collective raises
BVH_MIN_PRIMS = 1024  # below this many primitives in all, shards go brute
NO_RANK = 1 << 30  # a rank that holds no tied hit (dist.py:502)
_LOCAL_RANK = 0  # this rank's index among its host's (`cluster_layout`)


# ---------------------------------------------------------------------------
# Process groups
# ---------------------------------------------------------------------------


def cluster_layout(store, rank: int, world: int, device,
                   host: Optional[str] = None):
    """(this rank's index among the ranks of its host, the cluster's
    backend): every rank posts its host's name and CUDA card count to the
    rendezvous store and reads every other rank's. The backend is "nccl"
    when every host has a card for each of its ranks (local rank r on card
    r), else "gloo" on every rank: on the CPU, and where ranks of one host
    share a card (NCCL refuses two ranks on one card). The count is of each
    host's ranks, not the world's: two hosts of one card each run NCCL. A
    rank that never posts makes the read raise at the store's timeout."""
    host = socket.gethostname() if host is None else host
    cards = (torch.cuda.device_count() if torch.device(device).type == "cuda"
             else 0)
    store.set(f"izpi_host/{rank}", f"{cards} {host}")
    posts = [store.get(f"izpi_host/{r}").decode().split(" ", 1)
             for r in range(world)]
    hosts = [h for _, h in posts]
    nccl = all(hosts.count(h) <= int(c) for c, h in posts)
    return hosts[:rank].count(host), "nccl" if nccl else "gloo"


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device="cuda", timeout_s: float = TIMEOUT_S) -> int:
    """Join (or form) a cluster of `num_processes` ranks, this one
    `process_id` (rank 0 is the leader): the counterpart of
    jax.distributed.initialize (dist.py:56-72). `coordinator` is the
    leader's "host:port" (a TCP rendezvous); without it the rendezvous
    comes from the environment as torchrun sets it (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK). The backend is `cluster_layout`'s;
    under NCCL local rank r takes card r. Returns the world size; a failed
    rendezvous raises."""
    global _LOCAL_RANK
    dev = renderer._device(device)
    if coordinator:
        init_method = f"tcp://{coordinator}"
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and "
                             "process_id")
    else:
        init_method = "env://"
        num_processes = (int(os.environ["WORLD_SIZE"])
                         if num_processes is None else num_processes)
        process_id = (int(os.environ["RANK"]) if process_id is None
                      else process_id)
    timeout = datetime.timedelta(seconds=timeout_s)
    store, _, _ = next(dist.rendezvous(init_method, process_id,
                                       num_processes, timeout=timeout))
    store.set_timeout(timeout)
    _LOCAL_RANK, backend = cluster_layout(store, process_id, num_processes,
                                          dev)
    device_id = None
    if backend == "nccl":
        device_id = torch.device("cuda", _LOCAL_RANK)
        torch.cuda.set_device(device_id)
    dist.init_process_group(
        backend, store=dist.PrefixStore("default_pg", store),
        world_size=num_processes, rank=process_id, timeout=timeout,
        device_id=device_id)
    return dist.get_world_size()


def make_group(n_ranks: Optional[int] = None):
    """The first `n_ranks` ranks as a group (all of them: None): the
    counterpart of make_mesh(n_devices). Every rank must call it; a rank
    outside the group takes no part in what runs on it."""
    world = dist.get_world_size()
    if n_ranks is None or n_ranks == world:
        return dist.group.WORLD
    if not 1 <= n_ranks <= world:
        raise ValueError(f"n_ranks must be in [1, {world}], got {n_ranks}")
    return dist.new_group(list(range(n_ranks)))


def _group(group):
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_multihost, "
                           "or run the function under dist.spawn")
    return dist.group.WORLD if group is None else group


def rank_and_world(group=None):
    """(this rank's index in `group`, -1 outside it; the group's size)."""
    group = _group(group)
    return dist.get_rank(group), dist.get_world_size(group)


def rank_device(device="cuda") -> torch.device:
    """The device this rank renders on: the CPU, or CUDA card
    (local rank mod the card count) for "cuda"; no card raises."""
    dev = renderer._device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _LOCAL_RANK % torch.cuda.device_count())
    return dev


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    dist.all_reduce(x, op=op, group=group)
    return x


def _to_device(tree, device):
    """A compiled scene's NamedTuples of tensors, moved to `device`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_to_device(x, device) for x in tree])
    return tree


# ---------------------------------------------------------------------------
# Sample-sharded rendering
# ---------------------------------------------------------------------------


def build_sharded_sampler(cs, meta, settings, intersect, nx: int, ny: int,
                          group=None):
    """Returns run(xs, ys, key, n_spp) -> (colour (N, 3), rays) with the
    pixels sharded over the group and the scene replicated (dist.py:83-113):
    each rank renders its contiguous share of the N pixels
    (`torch.tensor_split`'s, so N need not divide; JAX pads them, `_pad_to`,
    :75), the lockstep oracle's `sample_pass` n_spp times, and an
    all-reduce of the zero-filled canvas hands every rank the whole (N, 3)
    mean colour; the rays are all-reduced too."""
    group = _group(group)
    rank, n = rank_and_world(group)

    def run(xs, ys, key, n_spp: int):
        mine = torch.tensor_split(torch.arange(xs.shape[0]), n)[rank]
        lo, hi = (int(mine[0]), int(mine[-1]) + 1) if len(mine) else (0, 0)
        acc = torch.zeros((hi - lo, 3), dtype=torch.float32, device=xs.device)
        rays = torch.zeros((), dtype=torch.int64, device=xs.device)
        for s in range(n_spp if hi > lo else 0):
            color, nr = renderer.sample_pass(cs, meta, settings, intersect,
                                             nx, ny, xs[lo:hi], ys[lo:hi],
                                             key, s)
            acc = acc + color
            rays = rays + nr
        out = torch.zeros((xs.shape[0], 3), dtype=torch.float32,
                          device=xs.device)
        out[lo:hi] = acc / n_spp
        _all_reduce(out, SUM, group)
        return out, _all_reduce(rays.reshape(1), SUM, group)[0]

    return run


def build_pool_renderer(cs, meta, settings, intersect, nx: int, ny: int,
                        spp_local: int, spectral: bool = False,
                        pool_size: int = renderer.POOL_MAX, group=None):
    """The sample-sharded renderer (dist.py:116-153): every rank runs the
    queue pool over the whole frame on samples [rank·spp_local,
    (rank+1)·spp_local), then the canvases and ray counters all-reduce.

    Returns run(key) -> (acc (n_pix, 3) summed radiance, RGB or XYZ, the
    same on every rank; rays, an int64 0-dim tensor); divide acc by
    n_ranks·spp_local for the image. `run.iterations` holds this rank's
    pool iterations of its last call."""
    group = _group(group)
    rank, _ = rank_and_world(group)
    bg_spd_id = meta.spectral_background_spd or 0
    # The pool of `render()` (the JAX package's distributed pool has
    # 1 << 16 slots): one rank renders as one process does.
    pool = min(pool_size, nx * ny * spp_local)

    graphs = {}  # the pool's CUDA graph, captured by the first call

    def run(key):
        acc, nrays, its = wavefront.trace_pool(
            cs, meta, settings, intersect, nx, ny, spp_local, key, pool,
            spectral=spectral, bg_spd_id=bg_spd_id,
            sample_offset=rank * spp_local, graphs=graphs)
        run.iterations = its
        # One canvas all-reduce replaces the reference's row streaming
        # (render/remote.go:46-89); the counter's is RenderEnd's stats.
        _all_reduce(acc, SUM, group)
        return acc, _all_reduce(nrays.reshape(1), SUM, group)[0]

    run.iterations = 0
    return run


def build_mega_renderer(cs, meta, settings, nx: int, ny: int,
                        spp_local: int, group=None):
    """The RGB megakernel sample-sharded (__graft_entry__.py:89-113): every
    rank launches `megakernel.render_slots` on samples [rank·spp_local,
    (rank+1)·spp_local) (on the card, or its plain version on the CPU),
    then the canvases and ray counters all-reduce; the offset chunks sum to
    the single launch's render. Returns run(key) -> (acc, rays) as
    `build_pool_renderer`'s."""
    group = _group(group)
    rank, _ = rank_and_world(group)
    tables = megakernel.pack_tables(cs) if cs.device.type == "cuda" else None

    def run(key):
        acc, nrays = megakernel.render_slots(
            cs, meta, settings, nx, ny, spp_local, key,
            offset=rank * spp_local, tables=tables)
        _all_reduce(acc, SUM, group)
        return acc, _all_reduce(nrays.reshape(1), SUM, group)[0]

    return run


def _result(acc, rays: int, seconds: float, phases: dict, nx: int, ny: int,
            spp: int, spectral: bool, meta, dev, iterations=None):
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    canvas = (acc.cpu().numpy().astype(np.float64) / spp).reshape(
        ny, nx, 3)[::-1].astype(np.float32)
    if not spectral:
        return renderer.RenderResult(
            image=np.ascontiguousarray(canvas), rays_traced=rays,
            seconds=seconds, device=name, iterations=iterations,
            phases=phases)
    tp = time_mod.perf_counter()
    xyz = convert.firefly_rejection(canvas.astype(np.float64))
    image = convert.xyz_to_acescg(xyz, meta.exposure).astype(np.float32)
    phases["postprocess"] = time_mod.perf_counter() - tp
    return renderer.RenderResult(
        image=image, rays_traced=rays, seconds=seconds, device=name,
        xyz=xyz.astype(np.float32), iterations=iterations, phases=phases)


def render_distributed(scene: Optional[st.Scene], nx: int, ny: int,
                       spp: int, group=None,
                       settings: Optional[path_mod.RenderSettings] = None,
                       seed: int = 0, sampler_type: str = "colour",
                       context: Optional[renderer.RenderContext] = None,
                       shard_prims: bool = False,
                       shard_textures: bool = False, warmup: bool = False,
                       device="cuda") -> Optional[renderer.RenderResult]:
    """The whole image rendered by every rank of `group` (dist.py:233-292);
    every rank of the group calls it with the same arguments.

    Samples are sharded over the ranks: spp rounds up to a multiple of the
    rank count (the extra samples only cut variance). With shard_prims the
    primitives are sharded instead and every rank renders all spp samples
    (`build_pool_renderer_prim_sharded`); the scene is then compiled on
    the CPU, and only each rank's slice and the replicated tables go to
    its device. Rank 0 of the group gets the RenderResult (a spectral
    render's post-pass runs there); the other ranks, and ranks outside the
    group, get None. `phases` holds "render_incl_compile" (the run, with
    any first build of a kernel) or, after a warm-up run (for
    benchmarking; it doubles the work), "render"."""
    if sampler_type not in ("colour", "spectral"):
        raise ValueError(f"render_distributed renders the colour and "
                         f"spectral samplers, not {sampler_type!r}")
    group = _group(group)
    rank, n = rank_and_world(group)
    if rank < 0:
        return None
    settings = settings or path_mod.RenderSettings()
    dev = rank_device(device)
    if shard_prims:
        if context is None:
            cs, meta = compile_scene(scene, "cpu")
        else:
            cs, meta = context.cs, context.meta
    else:
        context = context or renderer.RenderContext(scene, device=dev)
        cs, meta = context.cs, context.meta
        if cs.device != dev:
            raise ValueError(f"context is on {cs.device}, this rank on {dev}")
    spectral = meta.spectral or sampler_type == "spectral"
    if shard_prims:
        spp_eff = spp
        run = build_pool_renderer_prim_sharded(
            cs, meta, settings, nx, ny, spp, spectral=spectral,
            shard_textures=shard_textures, group=group, device=dev)
    else:
        spp_eff = -(-spp // n) * n
        run = build_pool_renderer(cs, meta, settings, context.intersect, nx,
                                  ny, spp_eff // n, spectral=spectral,
                                  group=group)
    key = rng.render_key(seed, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if warmup:
        run(key)
        sync()
    t0 = time_mod.perf_counter()
    acc, rays = run(key)
    rays = int(rays)  # waits for the device
    seconds = time_mod.perf_counter() - t0
    if rank != 0:
        return None
    phases = {"render" if warmup else "render_incl_compile": seconds}
    return _result(acc, rays, seconds, phases, nx, ny, spp_eff, spectral,
                   meta, dev, iterations=run.iterations)


# ---------------------------------------------------------------------------
# Primitive and texture sharding
# ---------------------------------------------------------------------------


class PrimShards(NamedTuple):
    """One rank's slice of the primitives (dist.py:295-319): in tree order
    under a BVH, with the map from local to global (the compiled scene's)
    primitive index, and the slice's own BVH4 (one always-miss node under
    brute force). Unlike the JAX shards, none is padded to a common size."""

    prims: prim.Prims
    gmap: torch.Tensor    # (P_r,) int64; -1 marks the padding row of an empty slice
    bounds: torch.Tensor  # (Nn_r, 24) f32
    child: torch.Tensor   # (Nn_r, 4) i32
    count: torch.Tensor   # (Nn_r, 4) i32


class TexShards(NamedTuple):
    """One rank's slice of the image and combined map stacks
    (dist.py:322-350): rows [base, base + rows) of the stacks padded to
    equal slices, and the two bases as 0-dim int32 tensors."""

    images: torch.Tensor    # (I_s, H, W, 3)
    combined: torch.Tensor  # (C_s, h, w, 8)
    img_base: torch.Tensor
    combo_base: torch.Tensor


def _host_prims(prims: prim.Prims) -> prim.Prims:
    return prim.Prims(*[f.detach().cpu().numpy() for f in prims])


def _empty_node():
    """A single always-miss node: brute force never reads it."""
    return (np.zeros((1, 24), np.float32), np.zeros((1, 4), np.int32),
            np.full((1, 4), -1, np.int32))


def _prim_shard(host: prim.Prims, rank: int, n: int, use_bvh: bool):
    """Rank `rank`'s slice of n of the host primitives, with its BVH4
    (dist.py:428-468): contiguous runs of ceil(P / n), each tree built by
    the native binned-SAH build and validated against the kernel's stack.
    A slice with no primitive holds one KIND_NONE row (gmap -1)."""
    p_total = host.count
    per = -(-p_total // n)
    lo, hi = rank * per, min((rank + 1) * per, p_total)
    loc = prim.Prims(*[f[lo:hi] for f in host])
    gidx = np.arange(lo, max(hi, lo), dtype=np.int64)
    nodes = _empty_node()
    if use_bvh and loc.count > 0:
        arrays = bvh_build.build_bvh4(loc, method="sah")
        errors = bvh_build.validate(arrays, loc.count,
                                    stack_depth=traverse.STACK_DEPTH)
        if errors:
            raise ValueError(f"shard {rank} BVH4 validation failed: "
                             f"{errors[:3]}")
        order = np.asarray(arrays.prim_order)
        loc = prim.Prims(*[f[order] for f in loc])
        gidx = gidx[order]
        nodes = (arrays.bounds, arrays.child, arrays.count)
    if loc.count == 0:
        fills = dict(kind=prim.KIND_NONE, mat_id=-1)
        loc = prim.Prims(*[np.full((1,) + f.shape[1:], fills.get(name, 0),
                                   f.dtype)
                           for name, f in zip(prim.Prims._fields, loc)])
        gidx = np.full(1, -1, np.int64)
    return loc, gidx, nodes


def _shards_on(loc, gidx, nodes, device) -> PrimShards:
    bounds, child, count = nodes
    return PrimShards(
        prims=prim.Prims(*[torch.as_tensor(np.array(f), device=device)
                           for f in loc]),
        gmap=torch.as_tensor(np.array(gidx, np.int64), device=device),
        bounds=torch.as_tensor(np.array(bounds, np.float32), device=device),
        child=torch.as_tensor(np.array(child, np.int32), device=device),
        count=torch.as_tensor(np.array(count, np.int32), device=device))


def prim_shards_from_jax(shards, n: int, device="cpu") -> list:
    """The JAX package's PrimShards (its leaves as numpy or JAX arrays,
    each with the leading n-device axis of equal chunks) as the port's
    PrimShards of each rank: the padding that shard_map needs (primitive
    rows with gmap -1, node rows with every count -1) dropped, one row of
    each kept."""
    gmap = np.asarray(shards.gmap)
    fields = [np.asarray(f) for f in shards.prims]
    bounds, child, count = (np.asarray(shards.bounds),
                            np.asarray(shards.child), np.asarray(shards.count))
    per, nn = gmap.shape[0] // n, bounds.shape[0] // n
    out = []
    for r in range(n):
        g = gmap[r * per:(r + 1) * per]
        keep = max(int(np.sum(g >= 0)), 1)
        cnt = count[r * nn:(r + 1) * nn]
        used = np.nonzero(~np.all(cnt == -1, axis=1))[0]
        n_nodes = int(used[-1]) + 1 if used.size else 1
        out.append(_shards_on(
            [f[r * per:r * per + keep] for f in fields], g[:keep],
            (bounds[r * nn:r * nn + n_nodes], child[r * nn:r * nn + n_nodes],
             cnt[:n_nodes]), device))
    return out


def strip_replicated_geometry(cs):
    """The replicated compiled scene under primitive sharding
    (dist.py:215-230): the geometry lives in the shards, so its replicated
    copy shrinks to one zero row, but for `kind` and `tb` (the tangent
    frames), which PBR's shading gathers by global primitive index."""
    p = cs.prims
    keep = ("kind", "tb")
    return cs._replace(prims=prim.Prims(*[
        f if name in keep else torch.zeros_like(f[:1])
        for name, f in zip(prim.Prims._fields, p)]))


def sharded_intersector(local: PrimShards, use_bvh: bool, group=None):
    """The closest hit over primitives sharded across the group
    (dist.py:486-522), as an intersector `intersect(o, d, time, t_min,
    t_max) -> Hit` of replicated rays; every rank calls it with the same
    rays.

    Each rank intersects its own slice: through its BVH4 (the CUDA kernel
    on the card, `accel.traverse.closest_bvh` on the CPU) or brute force.
    The winner follows the JAX package: the least t over the ranks (a MIN),
    ties to the lowest rank (a second MIN), the winner's record summed from
    the others' zeros, and whether any rank hit (JAX's MAX of the hit
    flags, folded into the first MIN as -hit). The float fields go in one
    all-reduce and the integer ones (the global primitive index through
    `gmap`, the material) in another, as integers, which a float would
    round above 2^24. Four collectives a call; the record carries no
    gradient."""
    group = _group(group)
    me, _ = rank_and_world(group)
    ks = (bvh_kernel.pack_tables(local.prims, traverse.BVH4Device(
        local.bounds, local.child, local.count)) if use_bvh else None)

    def intersect(o, d, time, t_min, t_max) -> prim.Hit:
        o, d, time = o.detach(), d.detach(), time.detach()
        if use_bvh:
            t, idx = bvh_kernel.closest_hit(ks, o.contiguous(),
                                            d.contiguous(),
                                            time.contiguous(), t_min, t_max)
            rec = prim.finalize_hit(local.prims, o, d, time, t, idx,
                                    idx >= 0)
        else:
            rec = prim.intersect_brute(local.prims, o, d, time, t_min, t_max)
        key = torch.where(rec.hit, rec.t, torch.full_like(rec.t, prim.T_MAX))
        # MIN of (t, -hit): the closest t and, in its second column, -1
        # wherever some rank hit (the JAX package's pmin and pmax).
        mins = _all_reduce(torch.stack([key, -rec.hit.to(key.dtype)], 1),
                           MIN, group)
        t_global, any_hit = mins[:, 0], mins[:, 1] < 0
        tied = rec.hit & (key == t_global)
        owner = _all_reduce(
            torch.where(tied, me, NO_RANK).to(torch.int32), MIN, group)
        win = tied & (owner == me)
        floats = torch.cat([rec.t[:, None], rec.u[:, None], rec.v[:, None],
                            rec.p, rec.normal], 1)
        floats = _all_reduce(
            torch.where(win[:, None], floats, torch.zeros_like(floats)), SUM,
            group)
        gidx = local.gmap[torch.clamp(rec.prim_idx, min=0)]
        ints = torch.stack([gidx, rec.mat_id.long()], 1)
        ints = _all_reduce(
            torch.where(win[:, None], ints, torch.zeros_like(ints)), SUM,
            group)
        miss = torch.full_like(ints[:, 0], -1)
        return prim.Hit(
            t=floats[:, 0], u=floats[:, 1], v=floats[:, 2],
            p=floats[:, 3:6], normal=floats[:, 6:9],
            prim_idx=torch.where(any_hit, ints[:, 0], miss),
            mat_id=torch.where(any_hit, ints[:, 1], miss), hit=any_hit)

    return intersect


def make_sharded_intersector(cs, group=None, use_bvh: Optional[bool] = None,
                             device=None):
    """This rank's slice of the compiled scene's primitives and the
    intersector over all slices (dist.py:397-524). Each rank of the group
    holds ceil(P / n) primitives (the last fewer), with a BVH4 of its own
    when the scene has at least BVH_MIN_PRIMS primitives (or
    use_bvh=True), else brute force. The slice goes to `device` (by default
    the scene's). Returns (PrimShards, intersect)."""
    group = _group(group)
    rank, n = rank_and_world(group)
    host = _host_prims(cs.prims)
    if use_bvh is None:
        use_bvh = host.count >= BVH_MIN_PRIMS
    local = _shards_on(*_prim_shard(host, rank, n, use_bvh),
                       device if device is not None else cs.device)
    return local, sharded_intersector(local, use_bvh, group)


def _stack_slice(stack: np.ndarray, rank: int, n: int):
    """Rank `rank`'s rows of `stack` split in n equal slices of at least
    one row (zero-padded at the end), and the slice's first global row."""
    per = max(-(-stack.shape[0] // n), 1)
    rows = stack[rank * per:(rank + 1) * per]
    pad = per - rows.shape[0]
    if pad:
        rows = np.concatenate([rows, np.zeros((pad,) + stack.shape[1:],
                                              stack.dtype)])
    return rows, rank * per


def make_sharded_textures(cs, group=None, device=None):
    """This rank's slice of the image and combined map stacks, and the
    replicated scene with 1-row (image) and 0-row (combined) stand-ins for
    them (dist.py:353-384). Install the slice with `apply_texture_shard`
    and set `meta.tex_shard_group` to the group, and the lookups read their
    rows across the ranks (`texture.tables.sharded_rows`). An empty
    combined stack stays empty on every rank."""
    group = _group(group)
    rank, n = rank_and_world(group)
    device = device if device is not None else cs.device
    tex = cs.textures
    images, img_base = _stack_slice(tex.images.cpu().numpy(), rank, n)
    combined = tex.combined.cpu().numpy()
    if combined.shape[0]:
        combined, combo_base = _stack_slice(combined, rank, n)
    else:
        combo_base = 0

    def on(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=device)

    local = TexShards(images=on(images), combined=on(combined),
                      img_base=on(img_base, torch.int32),
                      combo_base=on(combo_base, torch.int32))
    dev = tex.images.device
    cs_rep = cs._replace(textures=tex._replace(
        images=torch.zeros((1, 1, 1, 3), dtype=torch.float32, device=dev),
        combined=torch.zeros((0, 1, 1, 8), dtype=torch.float32, device=dev)))
    return local, cs_rep


def tex_shards_from_jax(shards, n: int, device="cpu") -> list:
    """The JAX package's TexShards (leaves with the leading n-device axis:
    n equal row chunks of each stack, n bases) as the port's TexShards of
    each rank."""
    images, combined = np.asarray(shards.images), np.asarray(shards.combined)
    img_base = np.asarray(shards.img_base)
    combo_base = np.asarray(shards.combo_base)
    pi, pc = images.shape[0] // n, combined.shape[0] // n

    def on(x, dtype=None):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    return [TexShards(images=on(images[r * pi:(r + 1) * pi]),
                      combined=on(combined[r * pc:(r + 1) * pc]),
                      img_base=on(img_base[r], torch.int32),
                      combo_base=on(combo_base[r], torch.int32))
            for r in range(n)]


def apply_texture_shard(cs_rep, local: TexShards):
    """The replicated scene with this rank's texture slice installed
    (dist.py:387-394)."""
    return cs_rep._replace(textures=cs_rep.textures._replace(
        images=local.images, combined=local.combined,
        img_base=local.img_base, combo_base=local.combo_base))


def build_pool_renderer_prim_sharded(cs, meta, settings, nx: int, ny: int,
                                     spp: int, spectral: bool = False,
                                     pool_size: int = renderer.POOL_MAX,
                                     use_bvh: Optional[bool] = None,
                                     shard_textures: bool = False,
                                     group=None, device=None):
    """The primitive-sharded renderer (dist.py:156-212), for scenes too
    large for one device: each rank holds its slice of the primitives
    (`make_sharded_intersector`) and, with shard_textures, of the image
    stacks, on `device` (by default the scene's); the rest of the scene is
    replicated there (`strip_replicated_geometry`). Rays are replicated:
    every rank runs the same pool over all spp samples, whose closest hits
    reduce over the group in every bounce, so every rank takes the same
    branches and iterations. Returns run(key) -> (acc, rays), the same on
    every rank; divide acc by spp."""
    group = _group(group)
    device = device if device is not None else cs.device
    local, intersect = make_sharded_intersector(cs, group, use_bvh=use_bvh,
                                                device=device)
    cs_rep = strip_replicated_geometry(cs)
    if shard_textures:
        tex_local, cs_rep = make_sharded_textures(cs_rep, group,
                                                  device=device)
        meta = dataclasses.replace(meta, tex_shard_group=group)
    cs_rep = _to_device(cs_rep, device)
    if shard_textures:
        cs_rep = apply_texture_shard(cs_rep, tex_local)
    bg_spd_id = meta.spectral_background_spd or 0
    pool = min(pool_size, nx * ny * spp)

    def run(key):
        # The all-reduces in each iteration go through the host (gloo), so
        # the pool runs its chunks uncaptured; every rank takes the same
        # chunk decisions.
        acc, nrays, its = wavefront._trace_pool(
            cs_rep, meta, settings, intersect, nx, ny, spp, key, pool,
            spectral, bg_spd_id, 0, wavefront.pool_chunk(nx * ny * spp, pool),
            False)
        run.iterations = its
        return acc, nrays

    run.iterations = 0
    run.shards = local
    return run


def scaling_efficiency(scene: st.Scene, nx: int, ny: int, spp: int,
                       device_counts=None, seed: int = 0,
                       settings: Optional[path_mod.RenderSettings] = None,
                       mode: str = "strong", device="cuda"):
    """Rays/s at 1..n ranks through `render_distributed` (dist.py:527-563),
    each after a warm-up run: {n: {"mrays": .., "efficiency": ..}} on rank
    0, None on the others. Every rank calls it. mode "strong" divides a
    fixed frame (nx·ny·spp) over the ranks, "weak" grows spp with them.
    Ranks that share one card (or the CPU's cores) measure nothing about
    scaling: there the numbers say only that the path runs."""
    world = dist.get_world_size()
    if device_counts is None:
        device_counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= world]
    dev = rank_device(device)
    context = renderer.RenderContext(scene, device=dev)
    out, base = {}, None
    for c in device_counts:
        group = make_group(c)
        res = render_distributed(None, nx, ny, spp * c if mode == "weak"
                                 else spp, group=group, settings=settings,
                                 seed=seed, context=context, warmup=True,
                                 device=dev)
        if res is None:
            continue
        m = res.mrays_per_sec
        base = m if base is None else base
        out[c] = {"mrays": m, "efficiency": m / (base * c)}
    return out if dist.get_rank() == 0 else None


# ---------------------------------------------------------------------------
# Local ranks
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, n, port, device, timeout_s, args, out):
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    try:
        initialize_multihost(f"127.0.0.1:{port}", n, rank, device=device,
                             timeout_s=timeout_s)
        result = (True, fn(rank, n, *args))
        dist.barrier()
        dist.destroy_process_group()
    except Exception:  # reported to the parent, which raises
        result = (False, traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(result, f)
    if not result[0]:
        os._exit(1)


def spawn(fn, n: int, args: tuple = (), device="cuda",
          timeout_s: float = TIMEOUT_S):
    """Run fn(rank, n, *args) on n local ranks, each a process of its own
    started by `spawn` (forking a process that holds CUDA breaks), in one
    process group over 127.0.0.1 (NCCL when the host has a card for each
    rank, else gloo: `cluster_layout`).
    fn must be importable by name, and its result picklable. Returns the
    results by rank.

    The CUDA kernels are built here first, once, on a CUDA device. A rank
    that raises or dies, or a spawn that runs past timeout_s, ends every
    rank and raises with each failed rank's traceback."""
    import multiprocessing

    dev = renderer._device(device)
    if dev.type == "cuda":
        from izpi_tpu_torch.ops import _build

        _build.build()
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    with tempfile.TemporaryDirectory(prefix="izpi_spawn_") as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(n)]
        procs = [ctx.Process(target=_rank_main, args=(
            fn, r, n, port, str(device), timeout_s, args, outs[r]))
            for r in range(n)]
        for p in procs:
            p.start()
        deadline = time_mod.monotonic() + timeout_s
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time_mod.monotonic() > deadline:
                    raise TimeoutError(
                        f"spawn of {n} ranks ran past {timeout_s} s")
                time_mod.sleep(0.02)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(10)
        results, errors = [], []
        for r, (p, out) in enumerate(zip(procs, outs)):
            ok, value = False, f"rank {r} exited with {p.exitcode}"
            if os.path.exists(out):
                with open(out, "rb") as f:
                    ok, value = pickle.load(f)
            if ok and p.exitcode == 0:
                results.append(value)
            else:
                errors.append(f"rank {r} (exit {p.exitcode}):\n{value}")
        if errors:
            raise RuntimeError("distributed run failed:\n" + "\n".join(errors))
    return results


# ---------------------------------------------------------------------------
# The differentiable render step (the framework's training step)
# ---------------------------------------------------------------------------

# The parameter names, as the JAX package's `extract_params` keys them. The
# parameters are the scene's material, texture and light tensors (the JAX
# package's BASELINE contract: "differentiable w.r.t. material/texture/light
# parameters"). Sampling is detached (`integrator.path.bounce_rgb`). On
# the checkpointed route no kernel has a backward pass, and none needs one:
# the cipher entry draws keyed uniforms, which carry no gradient, and a
# traversal kernel picks the winning primitive, whose t then gets its
# gradient from PyTorch ops (`geometry.primitives.differentiable_t`). The
# fused route's reverse kernel (`ops.diff_trace`) is the backward of its
# forward kernel.
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
                     spp: int = 1, group=None, runner=None, route=None):
    """Returns step(params, xs, ys, target, key) -> (loss, grads).

    The pixels xs, ys (N,) render `spp` samples each on the scene with
    `params` injected: on the fused route as one pass of spp·N paths
    (`renderer.sample_passes`), on the checkpointed route through the
    differentiable `renderer.sample_pass` a sample, the two with the same
    colours, rays and gradients bit for bit; the loss is the mean squared
    error against `target` (N, 3) over every pixel and channel, and grads
    holds d loss / d param for each of `PARAMS` (zeros for a parameter the
    render does not reach). The
    step runs on the device of `cs`. `step.rays` holds the rays its last
    call traced (the forward pass's, not the backward's recompute), read
    once from the device a call.

    `route` is `path.trace`'s, decided here, on the host, once: by
    default the fused route (`ops.diff_trace`: one launch of the forward
    kernel and one call of the reverse, which does G's work, a step, for
    all its sample passes) where `diff_trace.eligible_diff` holds, else
    "checkpoint", which runs its sample passes one after another (merged,
    they would keep spp times the checkpoints); pass "checkpoint"
    to force the checkpointed bounces. `step.route` holds it (a
    `diff_trace.DiffScene`, or "checkpoint").

    `runner` (`core.loops`) runs the whole step: the sample passes (on the
    checkpointed route each of their `max_depth` checkpointed bounces,
    `path.trace`'s fixed trip), the loss and `torch.autograd.grad`, all on
    the device, no host read among them. By default, on a CUDA device and without a group, a
    `loops.Graphed` (`step.runner`): the first call warms up and captures
    the step as one CUDA graph on static copies of its arguments (params,
    xs, ys, target and the key), every call copies its arguments in and
    replays it, and loss and grads are clones of the graph's outputs; a
    call of other shapes captures again, and a failed capture raises.
    Otherwise, and with `runner=loops.Eager()`, the step runs as calls.
    Without a group the call is the span "step" (`profiling.span`), and
    the read of the rays inside it "step.rays_read".

    With a process group (`dist.group.WORLD` for all ranks; None keeps one
    device), every rank passes the whole xs, ys and target and renders its
    share of the pixels (dist.py:597-643); the squared errors and the rays
    are all-reduced, and so are the gradients after `autograd.grad` of the
    rank's share of the loss, which sums them as JAX's value_and_grad of a
    psum'd loss does. loss, grads and rays are then the same on every
    rank. Its all-reduces go through the host (gloo), so a sharded step
    runs eagerly."""
    if spp < 1:
        raise ValueError(f"spp must be positive, got {spp}")
    if group is not None:
        rank, n = rank_and_world(group)
        if runner is not None and not isinstance(runner, loops.Eager):
            raise ValueError("a sharded step runs eagerly: its all-reduces "
                             "go through the host")
    if runner is None:
        runner = (loops.Graphed() if group is None and cs.device.type == "cuda"
                  else loops.Eager())
    if route is None:
        route = diff_trace.prepare(cs, meta, intersect) or "checkpoint"

    def local(params, xs, ys, target, key, n_total):
        """The rank's squared error, its gradients of se / n_total and its
        rays (a 0-dim device tensor)."""
        leaves = {k: (params[k] if params[k].requires_grad
                      else params[k].detach().requires_grad_(True))
                  for k in PARAMS}
        cs_p = inject_params(cs, leaves)
        if isinstance(route, diff_trace.DiffScene):
            colours, rays = renderer.sample_passes(
                cs_p, meta, settings, intersect, nx, ny, xs, ys, key, spp,
                route)
            acc, *rest = colours.unbind(0)
            for color in rest:
                acc = acc + color
        else:
            acc = rays = None
            for s in range(spp):
                color, nr = renderer.sample_pass(
                    cs_p, meta, settings, intersect, nx, ny, xs, ys, key, s,
                    differentiable=True, route=route)
                acc = color if acc is None else acc + color
                rays = nr if rays is None else rays + nr
        color = acc / spp
        se = torch.sum((color - target) ** 2)
        grads = torch.autograd.grad(se / float(n_total),
                                    [leaves[k] for k in PARAMS],
                                    allow_unused=True)
        grads = [torch.zeros_like(leaves[k]) if g is None else g
                 for k, g in zip(PARAMS, grads)]
        return se.detach(), grads, rays

    def whole(params, xs, ys, target, key):
        se, grads, rays = local(params, xs, ys, target, key, xs.shape[0] * 3)
        return se / float(xs.shape[0] * 3), grads, rays

    def step(params, xs, ys, target, key):
        if group is None:
            with profiling.span("step"):
                loss, grads, rays = runner.call(whole, params, xs, ys, target,
                                                key)
                with profiling.span("step.rays_read"):
                    step.rays = int(rays)
                return loss, dict(zip(PARAMS, grads))
        n_total = xs.shape[0] * 3
        xs, ys, target = (torch.tensor_split(x, n)[rank]
                          for x in (xs, ys, target))
        se, grads, rays = runner.call(local, params, xs, ys, target, key,
                                      n_total)
        # One all-reduce for the loss and the rays (float64 holds the count
        # exactly), one for every gradient.
        tot = _all_reduce(torch.stack([se.double(), rays.double()]), SUM,
                          group)
        flat = _all_reduce(torch.cat([g.reshape(-1) for g in grads]), SUM,
                           group)
        grads = [x.reshape(g.shape) for x, g in zip(
            torch.split(flat, [g.numel() for g in grads]), grads)]
        step.rays = int(tot[1])
        return tot[0].float() / float(n_total), dict(zip(PARAMS, grads))

    step.rays = 0
    step.runner = runner
    step.route = route
    return step
