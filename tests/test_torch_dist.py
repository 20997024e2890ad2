"""izpi_tpu_torch.parallel.dist vs the JAX package's izpi_tpu.parallel.dist.

The JAX side runs in this process on the conftest's virtual CPU devices
(`make_mesh(4)`); the port side in four ranks that `dist.spawn` starts on
the CPU (gloo), all of the port's cases in one spawn (`_torch_dist_ranks.
checks`), so the ranks import torch once. Every spawn and every collective
has a timeout that fails the test. The cases are tests/test_parallel.py's,
with its tolerances:
- sample sharding: rays equal, pixels within atol/rtol 1e-4 (RGB) and
  1e-3 (spectral ACEScg);
- primitive sharding: each rank's shards equal JAX's leaf for leaf (JAX's
  padding dropped, `prim_shards_from_jax`, `tex_shards_from_jax`); the
  sharded intersector's hits equal the replicated brute force (t within
  1e-6 relative, normals within 1e-5 relative and 1e-6); the renders'
  rays equal JAX's replicated renders' (which JAX's own prim-sharded
  renders are held to), pixels within rtol 1e-4 and atol 1e-5 (the BVH
  case 1e-3 and 1e-4);
- the training step: loss within rtol 1e-5 of JAX's on the same mesh
  size, each gradient within 1e-4·max|g|.
"""

import concurrent.futures
import datetime
import os
import re
import socket
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_ranks as ranks
from izpi_tpu.core import rng as jrng
from izpi_tpu.geometry import primitives as jprim
from izpi_tpu.integrator import path as jpath
from izpi_tpu.parallel import dist as jdist
from izpi_tpu.render import renderer as jrenderer
from izpi_tpu.scene import compiler as jcompiler
from izpi_tpu.scene.library.cornell import cornell_box as j_cornell
from izpi_tpu.scene.library.cornell_spectral import (
    cornell_box_spectral as j_cbs)
from izpi_tpu.scene.library.extracted import (
    cornell_box_pbr_stanford_dragon_spectral as j_dragon)
from izpi_tpu.scene.library.misc import pbr_ibl as j_pbr_ibl
from izpi_tpu_torch import entry as tentry
from izpi_tpu_torch.parallel import dist as tdist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RANKS = 4
SPAWN_TIMEOUT_S = 180.0
PIX_TOL = dict(atol=1e-4, rtol=1e-4)   # test_parallel.py:26
PRIM_TOL = dict(rtol=1e-4, atol=1e-5)  # test_parallel.py:173
BVH_TOL = dict(rtol=1e-3, atol=1e-4)   # test_parallel.py:208
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4  # of the gradient's largest magnitude


def _settings(depth):
    return jpath.RenderSettings(max_depth=depth)


def _jax_render(scene, frame, mesh, **kw):
    nx, ny, spp, depth, seed = frame
    return jdist.render_distributed(scene, nx, ny, spp, mesh=mesh,
                                    settings=_settings(depth), seed=seed,
                                    **kw)


def _jax_train():
    """JAX's sharded step on make_mesh(4): (params, loss, grads) as numpy."""
    size, depth, seed = ranks.TRAIN
    cs, meta = jcompiler.compile_scene(j_cornell())
    step = jdist.build_train_step(cs, meta, _settings(depth),
                                  jpath.make_brute_intersector(cs), size,
                                  size, jdist.make_mesh(N_RANKS))
    params = jdist.extract_params(cs)
    xs, ys = (jnp.asarray(a, jnp.int32) for a in ranks.pixels(size))
    loss, grads = step(params, xs, ys, jnp.asarray(ranks.train_target(size)),
                       jrng.render_key(seed))
    return ({k: np.asarray(v) for k, v in params.items()}, float(loss),
            {k: np.asarray(v) for k, v in grads.items()})


@pytest.fixture(scope="module")
def jax_train():
    return _jax_train()


@pytest.fixture(scope="module")
def port(jax_train):
    """Every rank's results of `_torch_dist_ranks.checks`."""
    return tdist.spawn(ranks.checks, N_RANKS, args=(jax_train[0],),
                       device="cpu", timeout_s=SPAWN_TIMEOUT_S)


@pytest.fixture(scope="module")
def mesh():
    return jdist.make_mesh(N_RANKS)


@pytest.fixture(scope="module")
def jax_sample_rgb(mesh):
    return _jax_render(j_cornell(), ranks.SAMPLE_RGB, mesh)


def test_sample_sharded_rgb_matches_jax(port, jax_sample_rgb):
    want = jax_sample_rgb
    got = port[0]["sample_rgb"]
    assert got["rays"] == want.rays_traced
    np.testing.assert_allclose(got["image"], want.image, **PIX_TOL)
    assert set(got["phases"]) == set(want.phases) == {"render_incl_compile"}
    assert all(r["sample_rgb"] is None for r in port[1:])


def test_sample_sharded_spectral_matches_jax(port, mesh):
    want = _jax_render(j_cbs(), ranks.SAMPLE_SPECTRAL, mesh)
    got = port[0]["sample_spectral"]
    assert got["xyz"] is not None and got["rays"] == want.rays_traced
    np.testing.assert_allclose(got["image"], want.image, atol=1e-3,
                               rtol=1e-3)


def _assert_shards_equal(got: dict, want: tdist.PrimShards):
    for name, g, w in zip(want.prims._fields, got["prims"], want.prims):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
    for name in ("gmap", "bounds", "child", "count"):
        np.testing.assert_array_equal(got[name],
                                      getattr(want, name).numpy(),
                                      err_msg=name)


@pytest.mark.parametrize("use_bvh", [False, True])
def test_prim_sharded_intersector_matches_replicated(port, mesh, use_bvh):
    """Shards leaf for leaf as JAX's, and the reduced closest hit equal to
    the replicated brute force (test_parallel.py:112-157)."""
    cs, _ = jcompiler.compile_scene(j_cornell())
    shard_args, _ = jdist.make_sharded_intersector(cs, mesh, use_bvh=use_bvh)
    want_shards = tdist.prim_shards_from_jax(shard_args, N_RANKS)
    o, d, tm = (jnp.asarray(a) for a in ranks.rays_for_intersector())
    want = jprim.intersect_brute(cs.prims, o, d, tm, 1e-3, jprim.T_MAX)
    h = np.asarray(want.hit)
    for rank, res in enumerate(port):
        got = res[f"intersect_bvh{int(use_bvh)}"]
        _assert_shards_equal(got["shards"], want_shards[rank])
        rec = got["rec"]
        np.testing.assert_array_equal(rec["hit"], h)
        np.testing.assert_allclose(rec["t"][h], np.asarray(want.t)[h],
                                   rtol=1e-6)
        for k in ("mat_id", "prim_idx"):
            np.testing.assert_array_equal(rec[k][h],
                                          np.asarray(getattr(want, k))[h])
        np.testing.assert_allclose(rec["normal"][h],
                                   np.asarray(want.normal)[h], rtol=1e-5,
                                   atol=1e-6)


@pytest.fixture(scope="module")
def jax_replicated():
    """JAX's replicated renders on one device, which test_parallel.py:160-
    228 holds JAX's prim-sharded renders to."""
    mesh1 = jdist.make_mesh(1)
    pbr = _jax_render(j_pbr_ibl(), ranks.PRIM_RENDER, mesh1)
    return {"prim_brute": _jax_render(j_cornell(), ranks.PRIM_RENDER, mesh1),
            "prim_pbr": pbr, "prim_tex": pbr,
            "prim_bvh": _jax_render(
                j_dragon(aspect=1.0, n_tris=ranks.DRAGON_TRIS),
                ranks.PRIM_BVH_RENDER, mesh1)}


@pytest.mark.parametrize("case,tol", [
    ("prim_brute", PRIM_TOL), ("prim_pbr", PRIM_TOL), ("prim_tex", PRIM_TOL),
    ("prim_bvh", BVH_TOL)], ids=["brute", "pbr", "textures", "bvh"])
def test_prim_sharded_render_matches_jax(port, jax_replicated, case, tol):
    """render_distributed(shard_prims=True) on four ranks (with the image
    stacks sharded too in the textures case, each shard's own BVH4 in the
    bvh case) against JAX's replicated render, with test_parallel.py's
    tolerances."""
    want = jax_replicated[case]
    got = port[0][case]
    assert got["rays"] == want.rays_traced
    np.testing.assert_allclose(got["image"], want.image, **tol)


def test_dragon_and_texture_shards_equal_jax(port, mesh):
    dcs, _ = jcompiler.compile_scene(j_dragon(aspect=1.0,
                                              n_tris=ranks.DRAGON_TRIS))
    shard_args, _ = jdist.make_sharded_intersector(dcs, mesh)
    for rank, want in enumerate(tdist.prim_shards_from_jax(shard_args,
                                                           N_RANKS)):
        assert want.bounds.shape[0] > 1  # a tree of its own, no padding
        _assert_shards_equal(port[rank]["dragon_shards"], want)
    pcs, _ = jcompiler.compile_scene(j_pbr_ibl())
    tex, _ = jdist.make_sharded_textures(jdist.strip_replicated_geometry(pcs),
                                         mesh)
    for rank, want in enumerate(tdist.tex_shards_from_jax(tex, N_RANKS)):
        for k, w in want._asdict().items():
            np.testing.assert_array_equal(port[rank]["tex_shards"][k],
                                          w.numpy(), err_msg=k)


def test_sharded_train_step_matches_jax(port, jax_train):
    _, want_loss, want_grads = jax_train
    for res in port:
        got = res["train"]
        np.testing.assert_allclose(got["loss"], want_loss, rtol=LOSS_RTOL)
        for k in tdist.PARAMS:
            g, w = got["grads"][k], want_grads[k]
            assert g.shape == w.shape and np.isfinite(g).all(), k
            np.testing.assert_allclose(
                g, w, rtol=0, atol=GRAD_REL * max(np.abs(w).max(), 1e-30),
                err_msg=k)
    # loss, gradients and rays are the same on every rank
    for res in port[1:]:
        assert res["train"]["rays"] == port[0]["train"]["rays"]
        for k in tdist.PARAMS:
            np.testing.assert_array_equal(res["train"]["grads"][k],
                                          port[0]["train"]["grads"][k])


def test_sampler_megakernel_and_scaling_harness(port, mesh):
    """The pixel-sharded sampler equals JAX's on the 36 pixels of a 6² frame
    (rays equal, colours within 1e-4; JAX's shard_map refuses 34 pixels on
    four devices) and one process's on 34 of them (a split with unequal
    shares); the sample-sharded megakernel (its plain version) equals one
    launch; the scaling harness runs."""
    cs, meta = jcompiler.compile_scene(j_cornell())
    xs, ys = (jnp.asarray(a, jnp.int32) for a in ranks.pixels(6))
    color, rays = jdist.build_sharded_sampler(
        cs, meta, _settings(3), jpath.make_brute_intersector(cs), 6, 6,
        mesh)(xs, ys, jrng.render_key(5), 2)
    want = ranks.single_sampler_and_mega()
    for res in port:
        assert res["sampler_36"]["rays"] == int(rays)
        np.testing.assert_allclose(res["sampler_36"]["color"],
                                   np.asarray(color), rtol=0, atol=1e-4)
        assert res["sampler"]["rays"] == want["rays"]
        np.testing.assert_allclose(res["sampler"]["color"], want["color"],
                                   rtol=0, atol=0)
        assert res["mega"]["rays"] == want["mega_rays"]
        np.testing.assert_allclose(res["mega"]["acc"], want["mega_acc"],
                                   **PIX_TOL)
    out = port[0]["scaling"]
    assert set(out) == {1, 2} and out[1]["efficiency"] == 1.0
    assert out[2]["mrays"] > 0
    assert all(r["scaling"] is None for r in port[1:])


def _dryrun_path(pixel: int, eager: bool, n=16, depth=3, seed=0):
    """One pixel's colour in part 3 of the dry run (the Cornell box at n²,
    one sample), from the JAX package's forward pass, compiled or eager."""
    cs, meta = jcompiler.compile_scene(j_cornell(aspect=1.0))
    intersect = jpath.make_brute_intersector(cs)
    xs, ys = (jnp.asarray([v], jnp.int32) for v in (pixel % n, pixel // n))

    def colour(cs):
        return jrenderer.sample_pass(cs, meta, _settings(depth), intersect,
                                     n, n, xs, ys, jrng.render_key(seed),
                                     0)[0]

    if eager:
        with jax.disable_jit():
            return np.asarray(colour(cs), np.float64)[0]
    return np.asarray(jax.jit(colour)(cs), np.float64)[0]


def test_dryrun_multichip_on_the_cpu(monkeypatch):
    """entry.dryrun_multichip(4) on four CPU ranks against the JAX
    package's __graft_entry__.dryrun_multichip(4) on make_mesh(4), run
    meanwhile in this process: the rays of part 1 (the pool through the
    BVH4 kernel), 1b (the megakernel) and 2 (the spectral pool) equal JAX's
    on every rank, and both count the same gradient parameters. Part 3's
    loss is JAX's within rtol 1e-5 but for one of its 256 paths, whose
    third bounce XLA's fused multiply-adds turn elsewhere: pixel 75 is
    (0, 0, 1.0) compiled and (0, 0, 1.46) eager, as in the port, which
    moves the loss by 1.6e-3 relative. The test takes that path's share
    from JAX, compiled and eager, and holds the port's loss to JAX's loss
    with the eager share in place of the compiled one."""
    import __graft_entry__ as graft

    said, losses = [], []
    monkeypatch.setattr(graft, "print", said.append, raising=False)
    build = jdist.build_train_step

    def recording(*args, **kwargs):
        step = build(*args, **kwargs)

        def run(*a):
            loss, grads = step(*a)
            losses.append(float(loss))
            return loss, grads

        return run

    monkeypatch.setattr(jdist, "build_train_step", recording)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ported = pool.submit(tentry.dryrun_multichip, N_RANKS, device="cpu",
                             timeout_s=SPAWN_TIMEOUT_S)
        graft.dryrun_multichip(N_RANKS)
        compiled, eager = (_dryrun_path(75, e) for e in (False, True))
        out = ported.result(timeout=SPAWN_TIMEOUT_S)
    m = re.search(r"pool\+bvh-kernel rays=(\d+), megakernel rays=(\d+), "
                  r"spectral rays=(\d+), loss=\S+, (\d+) grad params",
                  said[0])
    want = [int(v) for v in m.groups()]
    np.testing.assert_allclose(compiled, [0.0, 0.0, 1.0], atol=1e-6)
    np.testing.assert_allclose(eager, [0.0, 0.0, 1.46], atol=1e-6)
    want_loss = losses[0] + float(np.sum(eager ** 2 - compiled ** 2)) / 768
    assert len(out) == N_RANKS and len(losses) == 1
    for r in out:
        assert [r[part]["rays"] for part in (
            "pool_bvh", "megakernel", "spectral_pool")] == want[:3]
        np.testing.assert_allclose(r["loss"], want_loss, rtol=LOSS_RTOL)
        assert r["grad_params"] == want[3]


def test_a_failed_rank_or_a_hang_raises():
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        tdist.spawn(ranks.raises, 2, device="cpu", timeout_s=60)
    with pytest.raises(TimeoutError, match="ran past"):
        tdist.spawn(ranks.hangs, 2, device="cpu", timeout_s=4)


def test_entry_points_raise_without_a_card(monkeypatch):
    """No fallback: the distributed entry points run on "cuda" unless asked
    for the CPU, and without a card they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="'cuda' requested"):
        tdist.spawn(ranks.raises, 2)
    with pytest.raises(RuntimeError, match="'cuda' requested"):
        tdist.initialize_multihost("127.0.0.1:1", 2, 0)
    with pytest.raises(RuntimeError, match="'cuda' requested"):
        tentry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="no process group"):
        tdist.render_distributed(None, 4, 4, 1, device="cpu")
    assert _layouts(["a"] * 4, "cpu") == [(r, "gloo") for r in range(4)]


def _layouts(hosts, device):
    """`cluster_layout` of ranks on the named hosts, one thread a rank, over
    one store: [(local rank, backend)] by rank."""
    store = torch.distributed.HashStore()
    store.set_timeout(datetime.timedelta(seconds=30))
    out = [None] * len(hosts)

    def join(rank):
        out[rank] = tdist.cluster_layout(store, rank, len(hosts), device,
                                         hosts[rank])

    threads = [threading.Thread(target=join, args=(r,))
               for r in range(len(hosts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    return out


@pytest.mark.parametrize("hosts,cards,want", [
    (["a", "b"], 1, "nccl"),           # two hosts, a card each
    (["a"] * 8 + ["b"] * 8 + ["c"] * 8 + ["d"] * 8, 8, "nccl"),
    (["a", "a"], 1, "gloo"),           # two ranks share one card
    (["a", "a", "a", "b"], 2, "gloo"),  # three ranks on a host of two cards
], ids=["2x1", "4x8", "1x2-on-1", "3+1-on-2"])
def test_backend_follows_the_ranks_on_each_host(monkeypatch, hosts, cards,
                                                want):
    """The backend comes from the ranks on each host, not the world size:
    NCCL wherever every host has a card for each of its ranks (local rank r
    on card r), else gloo, the same on every rank of the cluster."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    layout = _layouts(hosts, "cuda")
    assert layout == [(hosts[:r].count(h), want) for r, h in enumerate(hosts)]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_leader_and_worker_match_one_process(tmp_path, jax_sample_rgb):
    """A two-process cluster over 127.0.0.1 through the command line
    (`--role leader` and `--role worker --process-id 1`, which join through
    `initialize_multihost`): the leader's image equals JAX's four-device
    render of the same frame (test_multihost.py:29), the worker writes
    nothing, and the summary names the backend."""
    nx, ny, spp, depth, seed = ranks.SAMPLE_RGB
    common = [sys.executable, "-m", "izpi_tpu_torch", "--device", "cpu",
              "--scene", "cornell_box", "-x", str(nx), "-y", str(ny),
              "--samples", str(spp), "--max-depth", str(depth), "--seed",
              str(seed), "--sampler", "colour", "--output-mode", "pfm",
              "--coordinator", f"127.0.0.1:{_free_port()}",
              "--num-processes", "2"]
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")}
    procs = [subprocess.Popen(
        common + flags + ["--output-file", str(tmp_path / f"{name}.pfm")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
        for name, flags in (("leader", ["--role", "leader"]),
                            ("worker", ["--role", "worker", "--process-id",
                                        "1"]))]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    assert "on cpu x 2 ranks (gloo)" in logs[0]
    assert not (tmp_path / "worker.pfm").exists()
    from izpi_tpu_torch.io import output

    got = output.read_image(str(tmp_path / "leader.pfm"))
    np.testing.assert_allclose(got, jax_sample_rgb.image, **PIX_TOL)
