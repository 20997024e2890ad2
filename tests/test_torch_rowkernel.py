"""izpi_tpu_torch's row-stack traversal (`ops.bvh_rowkernel`) vs the JAX
package's `izpi_tpu.ops.bvh_rowkernel`, brute force and the Pallas kernel.

The packing: both packages build the same leaf-64 SAH tree, reorder the
primitives the same way and number the leaf blocks in (node, slot) order
(`np.nonzero` of the count table); a leaf's child then holds its block id in
both, an internal child its node id. The JAX node row carries these ids and
counts as exact f32 in lanes 24..31, the port's as int32, so the port's
`nodes` equal JAX's `ntab[:, :32]` with those lanes cast; the block rows
((Nb, 64, 16) against (Nb·8, 128)) and `blockmap` are equal as they are.

The plain version walks each row of 32 rays with one stack: its answer is
the closest hit, so it equals brute force on hit masks and primitives, and
t to 1e-6 relative (the same primitive tests in another order of visits).
The Pallas kernel runs once, in interpret mode (tens of seconds here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_leaves
from izpi_tpu import camera as jcamera
from izpi_tpu.accel import bvh_build as jbvh
from izpi_tpu.geometry import primitives as jprim
from izpi_tpu.ops import bvh_kernel as jbvh_kernel
from izpi_tpu.ops import bvh_rowkernel as jrow
from izpi_tpu.scene import compiler as jcompiler
from izpi_tpu.scene import types as jst
from izpi_tpu.scene.library.cornell import cornell_box as j_cornell
from izpi_tpu_torch import camera as tcamera
from izpi_tpu_torch.accel import bvh_build as tbvh
from izpi_tpu_torch.accel import traverse
from izpi_tpu_torch.geometry import primitives as tprim
from izpi_tpu_torch.integrator import path as tpath
from izpi_tpu_torch.ops import bvh_rowkernel as trow
from izpi_tpu_torch.render import renderer as trenderer
from izpi_tpu_torch.scene import compiler as tcompiler
from izpi_tpu_torch.scene.library.cornell import cornell_box as t_cornell
from test_torch_bvh import _chain_tree


def _soup_scene():
    """The 300-triangle soup of tests/test_bvh_rowkernel.py:74, RandomState(3)."""
    rs = np.random.RandomState(3)
    mat = jst.Lambertian(albedo=jst.ConstantTexture((0.5, 0.5, 0.5)))
    tris = []
    for _ in range(300):
        v0 = rs.rand(3) * 10.0
        tris.append(jst.Triangle(v0=tuple(v0), v1=tuple(v0 + rs.rand(3)),
                                 v2=tuple(v0 + rs.rand(3)), material=mat))
    return jst.Scene(world=tris, camera=jst.Camera(look_from=(5, 5, -15),
                                                   look_at=(5, 5, 5)))


SCENES = {"cornell": j_cornell, "soup": _soup_scene}


@pytest.fixture(scope="module", params=sorted(SCENES))
def attached(request):
    """(name, JAX compiled scene, the port's from its leaves, the port's
    reordered scene and row-stack intersector)."""
    jcs, _ = jcompiler.compile_scene(SCENES[request.param]())
    tcs, _ = tcompiler.from_jax_arrays(jax_leaves(jcs), "cpu")
    cs2, inter = trow.attach(tcs)
    return request.param, jcs, tcs, cs2, inter


def _rays(name, cs, n, seed):
    """n // 2 camera rays and n - n // 2 rays from inside the scene in
    random directions, a quarter of them with a zero direction component."""
    rs = np.random.RandomState(seed)
    half = n // 2
    s, t = rs.rand(half).astype(np.float32), rs.rand(half).astype(np.float32)
    u = rs.rand(half, 3).astype(np.float32)
    o1, d1, tm1 = (x.numpy() for x in tcamera.get_rays(
        cs.camera, torch.as_tensor(s), torch.as_tensor(t), torch.as_tensor(u)))
    scale, shift = (555.0, 0.0) if name == "cornell" else (12.0, -1.0)
    o2 = (rs.rand(n - half, 3) * scale + shift).astype(np.float32)
    d2 = rs.randn(n - half, 3).astype(np.float32)
    q = (n - half) // 8
    d2[:q, 0] = 0.0
    d2[q:2 * q, 1] = 0.0
    tm2 = np.zeros(n - half, np.float32)
    return tuple(torch.as_tensor(np.concatenate(p))
                 for p in ((o1, o2), (d1, d2), (tm1, tm2)))


def _assert_equals_brute(cs, hit, o, d, tm):
    want = tprim.intersect_brute(cs.prims, o, d, tm, 1e-3, tprim.T_MAX)
    assert 0.1 < want.hit.float().mean() < 1.0
    np.testing.assert_array_equal(hit.hit.numpy(), want.hit.numpy())
    m = want.hit.numpy()
    np.testing.assert_array_equal(hit.prim_idx.numpy()[m],
                                  want.prim_idx.numpy()[m])
    np.testing.assert_allclose(hit.t.numpy()[m], want.t.numpy()[m], rtol=1e-6,
                               atol=0)
    for f in ("p", "normal", "u", "v", "mat_id"):
        np.testing.assert_array_equal(getattr(hit, f).numpy()[m],
                                      getattr(want, f).numpy()[m], f)


def test_tree_equals_jax(attached):
    """The leaf-64 SAH tree and the reordering, node for node."""
    _, jcs, tcs, cs2, _ = attached
    want = jbvh.build_bvh4(jcs.prims, 1, leaf_size=64, method="sah")
    got = tbvh.build_bvh4(tcs.prims, leaf_size=trow.LEAF_SIZE)
    for f in ("bounds", "child", "count", "prim_order"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_array_equal(
        cs2.prims.g0.numpy(), np.asarray(jcs.prims.g0)[want.prim_order])


def test_pack_scene_equals_jax(attached):
    """The port's tables against JAX's `pack_scene` on the same tree (see
    the module docstring for the block ids)."""
    _, jcs, _, _, inter = attached
    arrays = jbvh.build_bvh4(jcs.prims, 1, leaf_size=64, method="sah")
    order = np.asarray(arrays.prim_order)
    host = jprim.Prims(*[np.asarray(f)[order] for f in jcs.prims])
    jrs = jrow.pack_scene(host, arrays)
    ntab = np.asarray(jrs.ntab)
    got = inter.rs
    np.testing.assert_array_equal(got.nodes[:, :24].numpy(),
                                  ntab[:, :24].view(np.int32))
    np.testing.assert_array_equal(got.nodes[:, 24:].numpy().astype(np.float32),
                                  ntab[:, 24:32])
    assert not ntab[:, 32:].any()
    np.testing.assert_array_equal(got.blocks.numpy().reshape(-1, 128),
                                  np.asarray(jrs.pblocks))
    np.testing.assert_array_equal(got.blockmap.numpy(), np.asarray(jrs.blockmap))
    # A leaf's child is its block id, numbered in (node, slot) order.
    leaves = np.nonzero(np.asarray(arrays.count) > 0)
    np.testing.assert_array_equal(got.nodes[:, 24:28].numpy()[leaves],
                                  np.arange(len(leaves[0])))
    # from_jax_rowscene carries JAX's tables over unchanged.
    back = trow.from_jax_rowscene(jrs)
    for a, b in zip(back, got):
        assert torch.equal(a, b)


def test_sort_keys_equal_jax():
    rs = np.random.RandomState(4)
    o = (rs.rand(4096, 3) * 600.0 - 20.0).astype(np.float32)
    d = rs.randn(4096, 3).astype(np.float32)
    d[:256] = 0.0  # a zero direction: the 1e-12 norm floor
    lo, hi = np.array([0, 0, 0], np.float32), np.array([555, 555, 300], np.float32)
    want = np.asarray(jrow.sort_keys(*(jnp.asarray(x) for x in (o, d, lo, hi))))
    got = trow.sort_keys(*(torch.as_tensor(x) for x in (o, d, lo, hi)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 500
    c = np.arange(16)
    x, y, z = (a.ravel() for a in np.meshgrid(c, c, c, indexing="ij"))
    np.testing.assert_array_equal(
        trow._morton4(*(torch.as_tensor(a) for a in (x, y, z))).numpy(),
        np.asarray(jbvh_kernel._morton4(*(jnp.asarray(a) for a in (x, y, z)))))


@pytest.mark.parametrize("n,seed", [(1024, 0), (1000, 1), (2048, 2)],
                         ids=["rows", "ragged", "sorted"])
def test_plain_equals_brute(attached, n, seed):
    """Camera and incoherent rays (a zero direction component among them):
    whole rows, a ragged last row, and a batch of 2,048 rays, from which
    size on the JAX intersector sorts (the port's hands the kernel its rays
    in their order)."""
    name, _, _, cs2, inter = attached
    o, d, tm = _rays(name, cs2, n, seed)
    before = trow.launches
    _assert_equals_brute(cs2, inter(o, d, tm, 1e-3, tprim.T_MAX), o, d, tm)
    assert trow.launches == before  # the plain version on the CPU


def test_plain_rows_and_counters(attached):
    """The per-row counters (node pops, leaf blocks, (ray, primitive) pairs
    tested by the row: each visited block's primitives times the rays whose
    own box test hit it) and the padding of a ragged row: 100 rays answer as
    the first 100 of 128 do, and padding never hits."""
    name, _, _, cs2, inter = attached
    o, d, tm = _rays(name, cs2, 128, 3)
    t_a, i_a, c_a = trow.closest_rows(inter.rs, o, d, tm, 1e-3, tprim.T_MAX)
    t_b, i_b, c_b = trow.closest_rows(inter.rs, o[:100], d[:100], tm[:100],
                                      1e-3, tprim.T_MAX)
    assert c_a.shape == (4, 3) and c_b.shape == (4, 3)
    assert torch.equal(i_a[:100], i_b) and torch.equal(t_a[:100], t_b)
    assert (c_a[:, 0] >= 1).all() and (c_a[:, 1] >= 1).all()
    assert (c_a[:, 2] >= c_a[:, 1]).all()
    assert (c_a[:, 2] <= c_a[:, 1] * trow.LEAF_SIZE * trow.WARP).all()
    assert torch.equal(c_a[:3], c_b[:3])  # the whole rows walk alike
    # the wrapper on CPU tensors is the plain version
    t_w, i_w, c_w = trow.closest_hit_rows(inter.rs, o, d, tm, 1e-3,
                                          tprim.T_MAX, counters=True)
    assert torch.equal(t_w, t_a) and torch.equal(i_w, i_a)
    assert torch.equal(c_w, c_a)


def test_union_visits_at_least_what_one_ray_needs():
    """A row's traversal is the union of its rays': sorted rays share
    nodes, so a row of 32 copies of one ray pops and visits what that ray
    alone does and tests 32 times its (ray, primitive) pairs, and 32
    scattered rays pop more."""
    jcs, _ = jcompiler.compile_scene(_soup_scene())
    tcs, _ = tcompiler.from_jax_arrays(jax_leaves(jcs), "cpu")
    cs2, inter = trow.attach(tcs)
    o, d, tm = _rays("soup", cs2, 64, 6)
    one = trow.closest_rows(inter.rs, o[40:41], d[40:41], tm[40:41], 1e-3,
                            tprim.T_MAX)
    same = trow.closest_rows(inter.rs, o[40:41].repeat(32, 1),
                             d[40:41].repeat(32, 1), tm[40:41].repeat(32),
                             1e-3, tprim.T_MAX)
    spread = trow.closest_rows(inter.rs, o[32:], d[32:], tm[32:], 1e-3,
                               tprim.T_MAX)
    assert torch.equal(one[2][:, :2], same[2][:, :2])
    assert same[2][0, 2] == trow.WARP * one[2][0, 2]
    assert spread[2][0, 0] > one[2][0, 0]
    assert spread[2][0, 2] >= spread[2][0, 1] > 0


def test_per_ray_tree_equals_brute(attached):
    """The row-stack tables read as a per-ray tree (what the kernel's bound
    counts): the per-ray traversal over it finds brute force's hits, and
    tests only primitives of the leaf-64 blocks it visits."""
    name, _, _, cs2, inter = attached
    o, d, tm = _rays(name, cs2, 1024, 10)
    tree = trow.per_ray_tree(inter.rs)
    assert torch.equal(tree.count, inter.rs.nodes[:, 28:32])
    t, idx, counts = traverse.closest_bvh(cs2.prims, tree, o, d, tm, 1e-3,
                                          tprim.T_MAX, counts=True)
    _assert_equals_brute(cs2, tprim.finalize_hit(cs2.prims, o, d, tm, t, idx,
                                                 idx >= 0), o, d, tm)
    assert (counts[:, 0] >= 1).all()
    assert (counts[:, 1] <= counts[:, 0] * 4 * trow.LEAF_SIZE).all()
    assert 0 < counts[:, 1].float().mean() < cs2.prims.count



def test_nan_lanes_vote_for_no_child(attached):
    """A lane whose ray holds a NaN votes for no child (the Pallas kernel's
    min/max carry the NaN into its slab tests) and misses: a row of 31
    copies of one ray and one NaN lane walks what 32 copies walk and tests
    31/32 of their pairs, and a row of NaN lanes pops only the root."""
    name, _, _, cs2, inter = attached
    o, d, tm = _rays(name, cs2, 64, 9)
    hit_rays = torch.nonzero(tprim.intersect_brute(
        cs2.prims, o, d, tm, 1e-3, tprim.T_MAX).hit).squeeze(1)
    k = int(hit_rays[-1])
    o32, d32, tm32 = (x[k:k + 1].repeat(32, *([1] * (x.dim() - 1)))
                      for x in (o, d, tm))
    same = trow.closest_rows(inter.rs, o32, d32, tm32, 1e-3, tprim.T_MAX)
    d_nan = d32.clone()
    d_nan[7, 2] = float("nan")
    mixed = trow.closest_rows(inter.rs, o32, d_nan, tm32, 1e-3, tprim.T_MAX)
    assert torch.equal(mixed[2][:, :2], same[2][:, :2])
    assert mixed[2][0, 2] * trow.WARP == same[2][0, 2] * (trow.WARP - 1)
    assert mixed[1][7] == -1 and (mixed[1][torch.arange(32) != 7] >= 0).all()
    all_nan = trow.closest_rows(inter.rs, o32, torch.full_like(d32, float("nan")),
                                tm32, 1e-3, tprim.T_MAX)
    assert (all_nan[1] == -1).all()
    assert all_nan[2].tolist() == [[1, 0, 0]]

def test_wrapper_rejects_other_devices(attached):
    _, _, _, cs2, inter = attached
    o = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        trow.closest_hit_rows(inter.rs, o, o, torch.zeros(4, device="meta"),
                              1e-3, tprim.T_MAX)


def test_too_deep_tree_raises(monkeypatch):
    """The warp's stack holds KSTACK nodes: a tree whose worst case needs
    more raises at attach instead of dropping nodes."""
    arrays, p = _chain_tree(80)
    rs = np.random.RandomState(7)
    scene = jst.Scene(world=[jst.TriangleMesh(
        vertices=rs.rand(p, 3, 3), material=jst.Lambertian(
            albedo=jst.ConstantTexture((0.5, 0.5, 0.5))))],
        camera=jst.Camera(look_from=(0, 0, -5), look_at=(0, 0, 0)))
    jcs, _ = jcompiler.compile_scene(scene)
    tcs, _ = tcompiler.from_jax_arrays(jax_leaves(jcs), "cpu")
    monkeypatch.setattr(tbvh, "build_bvh4", lambda prims, leaf_size: arrays)
    with pytest.raises(ValueError, match="exceeds device stack depth 64"):
        trow.attach(tcs)


def test_render_through_the_row_pair():
    """A user selects the row-stack intersector by putting `attach`'s pair
    into a brute-force RenderContext: the render equals the brute-force
    one (Cornell 8×8 at 2 spp, depth 6, in the pool)."""
    s = tpath.RenderSettings(max_depth=6)
    brute = trenderer.render(t_cornell(), 8, 8, 2, s, seed=4, mode="pool",
                             use_bvh=False, device="cpu")
    ctx = trenderer.RenderContext(t_cornell(), use_bvh=False, device="cpu")
    ctx.cs, ctx.intersect = trow.attach(ctx.cs)
    rows = trenderer.render(None, 8, 8, 2, s, seed=4, mode="pool", context=ctx,
                            device="cpu")
    assert rows.rays_traced == brute.rays_traced
    assert rows.iterations == brute.iterations
    np.testing.assert_allclose(rows.image, brute.image, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def pallas_hits():
    """The one interpret-mode run of the Pallas kernel: JAX's row-stack
    intersector on Cornell (its own tree), 1,024 camera and incoherent
    rays, unsorted (below the JAX intersector's SORT_MIN)."""
    jcs, _ = jcompiler.compile_scene(j_cornell())
    jcs2, jinter = jrow.attach(jcs, seed=1, interpret=True)
    tcs, _ = tcompiler.from_jax_arrays(jax_leaves(jcs), "cpu")
    tcs2, _ = tcompiler.from_jax_arrays(jax_leaves(jcs2), "cpu")
    o, d, tm = _rays("cornell", tcs2, 1024, 8)
    want = jinter(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                  jnp.asarray(tm.numpy()), 1e-3, jprim.T_MAX)
    return jinter, tcs, tcs2, (o, d, tm), want


def test_plain_equals_pallas_kernel(pallas_hits):
    """The port's plain version on JAX's exact tables (from_jax_rowscene)
    and on its own (the same tree and order, built from the unreordered
    scene), against the Pallas kernel: equal hit masks and primitives, t
    within 1e-5 relative, as tests/test_bvh_rowkernel.py allows: the
    interpret-mode kernel is compiled by XLA, whose CPU code contracts
    multiply-adds (one t of 889 differs by 2.3e-6 relative)."""
    jinter, tcs, tcs2, (o, d, tm), want = pallas_hits
    lo, hi = np.asarray(jinter.lo), np.asarray(jinter.hi)
    inter = trow.RowBVHIntersector(tcs2, trow.from_jax_rowscene(jinter.rs),
                                   lo, hi)
    _, own = trow.attach(tcs)
    m = np.asarray(want.hit)
    assert m.mean() > 0.3
    for got in (inter(o, d, tm, 1e-3, tprim.T_MAX),
                own(o, d, tm, 1e-3, tprim.T_MAX)):
        np.testing.assert_array_equal(got.hit.numpy(), m)
        np.testing.assert_array_equal(got.prim_idx.numpy()[m],
                                      np.asarray(want.prim_idx)[m])
        np.testing.assert_allclose(got.t.numpy()[m], np.asarray(want.t)[m],
                                   rtol=1e-5, atol=0)
