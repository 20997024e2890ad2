"""izpi_tpu_torch's BVH4 build, plain traversal and traversal-kernel wrapper
vs the JAX package, brute force and the Pallas kernel.

The port's native build equals JAX's numpy builder node for node. The
traversal runs on JAX's own tree (`traverse.from_jax_bvh`) and on the
port's, against JAX's jnp traversal, the Pallas kernel in interpret mode
and the port's brute force, on random, axis-parallel and interior rays.
Scenes are small: a few thousand primitives at most, except for the one
compile of `cornell_box_obj`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_leaves, mixed_scene, port_leaves
from izpi_tpu.accel import bvh_build as jbvh
from izpi_tpu.accel import traverse as jtraverse
from izpi_tpu.geometry import primitives as jprim
from izpi_tpu.geometry import procedural as jproc
from izpi_tpu.ops import bvh_kernel as jbvh_kernel
from izpi_tpu.scene import compiler as jcompiler
from izpi_tpu.scene import types as jst
from izpi_tpu.scene.library.misc import cornell_box_obj as j_obj
from izpi_tpu_torch.accel import bvh_build as tbvh
from izpi_tpu_torch.accel import native as tnative
from izpi_tpu_torch.accel import traverse as ttraverse
from izpi_tpu_torch.geometry import primitives as tprim
from izpi_tpu_torch.geometry import procedural as tproc
from izpi_tpu_torch.ops import bvh_kernel as tbvh_kernel
from izpi_tpu_torch.scene import compiler as tcompiler
from izpi_tpu_torch.scene.library import misc as tmisc


def _soup(st, n_tris: int, seed: int, spread: float = 10.0):
    rs = np.random.RandomState(seed)
    verts = ((rs.rand(n_tris, 1, 3) - 0.5) * 2 * spread
             + rs.randn(n_tris, 3, 3) * 0.5)
    mesh = st.TriangleMesh(vertices=verts, material=st.Lambertian(
        albedo=st.ConstantTexture((0.5, 0.5, 0.5))))
    return st.Scene(world=[mesh], camera=st.Camera(look_from=(0, 0, -30),
                                                   look_at=(0, 0, 0)))


def _blob(st, n_tris: int):
    tris = jproc.transform_mesh(jproc.bumpy_blob(n_tris), scale=4.0)
    return st.Scene(world=[st.TriangleMesh(vertices=tris, material=st.Lambertian(
        albedo=st.ConstantTexture((0.7, 0.7, 0.85))))],
        camera=st.Camera(look_from=(0, 0, -30), look_at=(0, 0, 0)))


SCENES = {
    "soup": lambda st: _soup(st, 600, seed=4),
    "mixed": mixed_scene,  # triangles, rects, moving spheres, a box
    "blob": lambda st: _blob(st, 1000),  # the procedural mesh of the main path
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def compiled(request):
    """(name, JAX compiled scene, the port's from the same leaves)."""
    jcs, _ = jcompiler.compile_scene(SCENES[request.param](jst))
    tcs, _ = tcompiler.from_jax_arrays(jax_leaves(jcs), "cpu")
    return request.param, jcs, tcs


def _assert_same_tree(a, b):
    for f in ("bounds", "child", "count", "prim_order"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)


def test_procedural_equals_jax():
    np.testing.assert_array_equal(tproc.bumpy_blob(2000), jproc.bumpy_blob(2000))
    np.testing.assert_array_equal(tproc.bumpy_blob(500, seed=3),
                                  jproc.bumpy_blob(500, seed=3))
    tris = jproc.bumpy_blob(300)
    np.testing.assert_array_equal(
        tproc.transform_mesh(tris, 60.0, -60.0, (280.0, 90.0, 390.0)),
        jproc.transform_mesh(tris, 60.0, -60.0, (280.0, 90.0, 390.0)))
    np.testing.assert_array_equal(tproc.box_mesh((0, 1, 2), (3, 5, 7)),
                                  jproc.box_mesh((0, 1, 2), (3, 5, 7)))


def test_prim_bounds_equal_jax(compiled):
    _, jcs, tcs = compiled
    for a, b in zip(tbvh.prim_bounds(tcs.prims), jbvh.prim_bounds(jcs.prims)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method", ["median", "sah"])
@pytest.mark.parametrize("leaf", [4, 16])
def test_native_build_equals_numpy(compiled, method, leaf):
    """The port's native build against the JAX package's numpy builder."""
    _, jcs, tcs = compiled
    bb_min, bb_max = jbvh.prim_bounds(jcs.prims)
    want = jbvh.build_bvh4_from_bounds(bb_min, bb_max, 1, use_native=False,
                                       leaf_size=leaf, method=method)
    got = tbvh.build_bvh4(tcs.prims, leaf_size=leaf, method=method)
    _assert_same_tree(got, want)


def test_validate_and_stack_occupancy_equal_jax(compiled):
    _, jcs, tcs = compiled
    for leaf in (4, 16):
        arrays = tbvh.build_bvh4(tcs.prims, leaf_size=leaf)
        assert (tbvh.max_stack_occupancy(arrays)
                == jbvh.max_stack_occupancy(jbvh.BVH4Arrays(*arrays)))
        for depth in (None, 2):
            assert (tbvh.validate(arrays, tcs.prims.count, stack_depth=depth)
                    == jbvh.validate(jbvh.BVH4Arrays(*arrays), jcs.prims.count,
                                     stack_depth=depth))
    assert tbvh.validate(arrays, tcs.prims.count, stack_depth=64) == []


def _chain_tree(depth: int):
    """A pathological BVH4: a spine of `depth` nodes, each with a node of
    one leaf and the next spine node as internal children, ending in a node
    of one leaf; depth + 1 primitives. Its worst-case stack is depth + 1."""
    n_nodes = 2 * depth + 1
    bounds = np.zeros((n_nodes, 24), np.float32)
    child = np.full((n_nodes, 4), -1, np.int32)
    count = np.full((n_nodes, 4), -1, np.int32)
    prim = 0
    for i in range(depth):
        spine, leafy = i, depth + 1 + i
        nxt = i + 1 if i + 1 < depth else depth
        child[spine, :2], count[spine, :2] = (leafy, nxt), (0, 0)
        child[leafy, 0], count[leafy, 0] = prim, 1
        prim += 1
    child[depth, 0], count[depth, 0] = prim, 1
    prim += 1
    order = np.arange(prim, dtype=np.int32)
    return tbvh.BVH4Arrays(bounds, child, count, order), prim


def test_pathological_tree_raises():
    arrays, p = _chain_tree(80)
    occ = tbvh.max_stack_occupancy(arrays)
    assert occ == jbvh.max_stack_occupancy(jbvh.BVH4Arrays(*arrays)) > 64
    assert tbvh.validate(arrays, p) == []
    with pytest.raises(ValueError, match="stack"):
        ttraverse.check(arrays, p)
    shallow, p = _chain_tree(20)
    ttraverse.check(shallow, p)


def test_failed_native_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "bvh4.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.build_library()


def _random_rays(n, seed, lo, hi):
    rs = np.random.RandomState(seed)
    o = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    tme = rs.rand(n).astype(np.float32)
    return o, d, tme


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_plain_traversal_equals_jax_on_jax_tree(compiled):
    """JAX's median tree (its traverse.attach), carried over with
    from_jax_bvh: both traversals find the same primitive, and t within
    1e-6 relative — JAX runs its traversal loop compiled, where XLA's CPU
    backend contracts multiply-adds into FMAs (the mixed scene's rects and
    spheres move by an ulp)."""
    name, jcs, _ = compiled
    arrays = jbvh.build_bvh4(jcs.prims, 1)
    jcs2 = jcs._replace(prims=jtraverse.reorder_prims(jcs.prims,
                                                      arrays.prim_order))
    tcs2, _ = tcompiler.from_jax_arrays(jax_leaves(jcs2), "cpu")
    lo, hi = (-12.0, 12.0) if name == "soup" else (-4.0, 6.0)
    o, d, tme = _random_rays(512, 3, lo, hi)
    want = jtraverse.intersect_bvh(jcs2.prims, jtraverse.upload(arrays),
                                   *(jnp.asarray(x) for x in (o, d, tme)),
                                   1e-3, jprim.T_MAX)
    got = ttraverse.intersect_bvh(tcs2.prims, ttraverse.from_jax_bvh(arrays),
                                  _t(o), _t(d), _t(tme), 1e-3, tprim.T_MAX)
    hit = np.asarray(want.hit)
    assert 0.1 < hit.mean()
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit],
                               rtol=1e-6)
    np.testing.assert_array_equal(got.prim_idx.numpy(),
                                  np.asarray(want.prim_idx))


def _axis_rays(n, seed, lo, hi):
    """Rays with one or two direction components exactly zero: along the
    faces of boxes, where a raw 1/d would give 0·inf = NaN."""
    o, d, tme = _random_rays(n, seed, lo, hi)
    d[0::3, 0] = 0.0
    d[1::3, 1] = 0.0
    d[2::3, 2] = 0.0
    d[0::7, 1] = 0.0
    return o, d, tme


@pytest.mark.parametrize("rays", ["axis", "inside", "tmax"])
def test_plain_traversal_equals_brute(compiled, rays):
    """On the port's own tree: equal hits, equal t, equal primitives but
    for exact-t ties; axis-parallel rays from bounding-box faces, rays
    starting inside boxes, and a t_max of 1000 (the exit re-trace)."""
    name, _, tcs = compiled
    cs2, inter = tbvh_kernel.attach(tcs)
    tree = inter.ks.tree
    bounds = tree.bounds.numpy()
    lo, hi = (-12.0, 12.0) if name == "soup" else (-4.0, 6.0)
    t_max = tprim.T_MAX
    if rays == "axis":
        o, d, tme = _axis_rays(768, 5, lo, hi)
        # Start a third of them on a face of some node's box.
        rs = np.random.RandomState(6)
        pick = rs.randint(0, bounds.shape[0], 256)
        o[:256, 0] = bounds[pick, 0]
        o[:256, 1] = bounds[pick, 16]
    elif rays == "inside":
        o, d, tme = _random_rays(768, 7, lo, hi)
        centre = 0.5 * (bounds[:, 0:12:4] + bounds[:, 12:24:4])
        o[:] = centre[np.random.RandomState(8).randint(0, len(centre), 768)]
    else:
        # Short directions: hits lie at t of a few hundred to a few
        # thousand, so t_max = 1000 cuts some of them.
        o, d, tme = _random_rays(768, 9, lo, hi)
        d = d * np.float32(0.01)
        t_max = 1000.0
    o, d, tme = _t(o), _t(d), _t(tme)
    t_b, i_b = ttraverse.closest_bvh(cs2.prims, tree, o, d, tme, 1e-3, t_max)
    t_w, i_w = tprim.closest_brute(cs2.prims, o, d, tme, 1e-3, t_max)
    hit = (i_w >= 0).numpy()
    assert hit.mean() > 0.05
    np.testing.assert_array_equal((i_b >= 0).numpy(), hit)
    np.testing.assert_array_equal(t_b.numpy()[hit], t_w.numpy()[hit])
    assert torch.isfinite(t_b).all()
    ties = (i_b != i_w).numpy() & hit
    assert ties.sum() <= 2  # only exact-t ties may pick another primitive


def test_plain_traversal_equals_pallas_kernel():
    """A 2k-triangle blob, 256 rays: the port's hits, mapped to original
    primitive ids, against the Pallas kernel in interpret mode on its own
    leaf-16 tree; t within 1e-6 relative."""
    jcs, _ = jcompiler.compile_scene(_blob(jst, 2000))
    jcs2, inter = jbvh_kernel.attach(jcs, seed=1, interpret=True)
    j_order = jbvh.build_bvh4(jcs.prims, 1, leaf_size=jbvh_kernel.KERNEL_LEAF,
                              method="sah").prim_order
    tcs, _ = tcompiler.from_jax_arrays(jax_leaves(jcs), "cpu")
    arrays = ttraverse.build(tcs.prims)
    _, intersect = tbvh_kernel.attach(tcs)
    o, d, tme = _random_rays(256, 11, -6.0, 6.0)
    want = inter(*(jnp.asarray(x) for x in (o, d, tme)), 1e-3, jprim.T_MAX)
    got = intersect(_t(o), _t(d), _t(tme), 1e-3, tprim.T_MAX)
    hit = np.asarray(want.hit)
    assert hit.mean() > 0.2
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit],
                               rtol=1e-6)
    got_ids = arrays.prim_order[got.prim_idx.numpy()[hit]]
    want_ids = np.asarray(j_order)[np.asarray(want.prim_idx)[hit]]
    np.testing.assert_array_equal(got_ids, want_ids)


def test_kernel_wrapper_on_cpu_runs_plain_version(compiled):
    _, _, tcs = compiled
    cs2, ks_inter = tbvh_kernel.attach(tcs)
    o, d, tme = (_t(x) for x in _random_rays(256, 13, -6.0, 6.0))
    before = tbvh_kernel.launches
    a = ks_inter(o, d, tme, 1e-3, tprim.T_MAX)
    b = ttraverse.intersect_bvh(cs2.prims, ks_inter.ks.tree, o, d, tme, 1e-3,
                                tprim.T_MAX)
    assert tbvh_kernel.launches == before
    for f in ("t", "prim_idx", "hit", "p", "normal", "mat_id"):
        torch.testing.assert_close(getattr(a, f), getattr(b, f), rtol=0, atol=0)
    t, idx, counts = tbvh_kernel.closest_hit(ks_inter.ks, o, d, tme, 1e-3,
                                            tprim.T_MAX, counts=True)
    assert counts.shape == (256, 2) and bool((counts[:, 0] >= 1).all())
    assert torch.equal(idx, a.prim_idx)


def test_packed_tables_hold_the_tree(compiled):
    _, _, tcs = compiled
    cs2, inter = tbvh_kernel.attach(tcs)
    ks = inter.ks
    assert ks.nodes.dtype == torch.int32 and ks.nodes.shape[1] == 32
    torch.testing.assert_close(ks.nodes[:, :24].view(torch.float32),
                               ks.tree.bounds, rtol=0, atol=0)
    assert torch.equal(ks.nodes[:, 24:28], ks.tree.child)
    assert torch.equal(ks.nodes[:, 28:32], ks.tree.count)
    words = ks.prim_table.view(torch.int32)
    assert torch.equal(words[:, 12], cs2.prims.kind.int())
    torch.testing.assert_close(ks.prim_table[:, 3:6], cs2.prims.g1,
                               rtol=0, atol=0)


def test_kernel_wrapper_rejects_other_devices(compiled):
    _, _, tcs = compiled
    _, inter = tbvh_kernel.attach(tcs)
    o = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="device"):
        tbvh_kernel.closest_hit(inter.ks, o, o, o[:, 0], 1e-3, 1.0)


def test_brute_chunks_equal_dense_pass():
    """1,500 primitives: the 512-primitive chunks give what one dense
    (N, P) pass gives, first primitive on ties included."""
    jcs, _ = jcompiler.compile_scene(_soup(jst, 1500, seed=21, spread=4.0))
    tcs, _ = tcompiler.from_jax_arrays(jax_leaves(jcs), "cpu")
    o, d, tme = (_t(x) for x in _random_rays(512, 17, -6.0, 6.0))
    # Duplicate a primitive so exact ties happen.
    prims = tcs.prims
    dup = tprim.Prims(*[torch.cat([f, f[:700]]) for f in prims])
    for p in (prims, dup):
        t_c, i_c = tprim.closest_brute(p, o, d, tme, 1e-3, tprim.T_MAX)
        t_d, i_d = tprim.closest_brute(p, o, d, tme, 1e-3, tprim.T_MAX,
                                       chunk=p.count)
        assert torch.equal(t_c, t_d) and torch.equal(i_c, i_d)
        assert bool((i_c < prims.count).all())  # ties keep the first copy
    assert (i_c >= 0).float().mean() > 0.2


def test_cornell_box_obj_compiles_as_jax():
    jcs, _ = jcompiler.compile_scene(j_obj())
    tcs, meta = tcompiler.compile_scene(tmisc.cornell_box_obj(), "cpu")
    assert meta.n_prims == 20_007 and meta.n_lights == 2
    want, got = jax_leaves(jcs), port_leaves(tcs)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_cornell_box_obj_with_pp_obj_raises(tmp_path, monkeypatch):
    (tmp_path / "PP.obj").write_text("v 0 0 0\n")
    monkeypatch.setenv("IZPI_ASSET_DIR", str(tmp_path))
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        tmisc.cornell_box_obj()


def test_failed_nvcc_build_raises(tmp_path, monkeypatch):
    """A compiler that fails on one source: the build raises with its
    output, loads nothing and leaves no library behind."""
    from izpi_tpu_torch.ops import _build

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\ncase \"$*\" in *bvh4_traverse*) "
                    "echo 'error: fake failure' >&2; exit 2;; esac\n"
                    "for a; do [ \"$prev\" = -o ] && : > \"$a\"; prev=$a; done\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc failed(.|\n)*bvh4_traverse"
                                            "(.|\n)*fake failure"):
        _build.build()
    assert not list((tmp_path / "build").glob("*.so"))
