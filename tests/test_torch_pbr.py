"""izpi_tpu_torch's PBR material vs the JAX package's: the compile of its
columns, the three PBR helpers of `integrator.path`, one RGB and one
spectral bounce, the RGB oracle on the two PBR scenes of
tests/test_exact_path_materials.py, and the spectral pool on the dragon
(its porcelain) at a 2,000-triangle stand-in.

The JAX helpers and bounces run eagerly (XLA's compiled CPU code contracts
multiply-adds into FMAs, ROADMAP C); masks are equal and floats agree to
1e-6 (helpers) or 1e-5 (bounces, renders), the room for last-ulp
differences between torch's and XLA's CPU pow/sqrt/sin/cos.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_exact_path_materials as exact
from _torch_port import jax_leaves, port_leaves, to_port_scene
from izpi_tpu import camera as jcamera
from izpi_tpu.geometry import primitives as jprim
from izpi_tpu.integrator import path as jpath
from izpi_tpu.render import renderer as jrenderer
from izpi_tpu.scene import compiler as jcompiler
from izpi_tpu.scene import types as jst
from izpi_tpu.scene.library.extracted import (
    cornell_box_pbr_stanford_dragon_spectral as j_dragon)
from izpi_tpu_torch.geometry import primitives as tprim
from izpi_tpu_torch.integrator import path as tpath
from izpi_tpu_torch.render import renderer as trenderer
from izpi_tpu_torch.scene import compiler as tcompiler
from izpi_tpu_torch.scene.library.extracted import (
    cornell_box_pbr_stanford_dragon_spectral as t_dragon)

RTOL = 1e-5
DRAGON_TRIS = 2000


def _t(a):
    return torch.as_tensor(np.array(a))


def pbr_scene(st):
    """Every PBR case the port compiles: a rect and a uv-mapped triangle
    with a constant normal map (the double normal mapping), a checker
    roughness on a sphere, metalness without a roughness slot, the
    porcelain-like defaults (no slot at all) on a mesh, and a Lambertian
    beside them; a ceiling light. `st` is either package's scene.types."""
    nm = st.ConstantTexture((0.6, 0.45, 0.9))
    full = st.PBR(albedo=st.ConstantTexture((0.7, 0.5, 0.3)),
                  roughness=st.ConstantTexture((0.4, 0.4, 0.4)),
                  metalness=st.ConstantTexture((0.2, 0.2, 0.2)),
                  normal_map=nm)
    checker = st.PBR(albedo=st.ConstantTexture((0.3, 0.6, 0.8)),
                     roughness=st.CheckerTexture(
                         st.ConstantTexture((0.05, 0.05, 0.05)),
                         st.ConstantTexture((0.9, 0.8, 0.7))))
    metal_only = st.PBR(albedo=st.ConstantTexture((0.9, 0.9, 0.9)),
                        metalness=st.ConstantTexture((0.8, 0.9, 1.0)))
    bare = st.PBR(albedo=st.ConstantTexture((0.8, 0.75, 0.7)), sss_radius=0.3)
    lambert = st.Lambertian(albedo=st.ConstantTexture((0.5, 0.5, 0.5)))
    tet = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                    [[0, 0, 0], [0, 1, 0], [0, 0, 1]],
                    [[0, 0, 0], [0, 0, 1], [1, 0, 0]],
                    [[1, 0, 0], [0, 0, 1], [0, 1, 0]]], np.float64)
    world = [
        st.XZRect(-4, 4, -4, 4, 0.0, full),
        st.Triangle((-3, 0.5, 1), (-1, 0.5, 1), (-3, 2.5, 1), full,
                    uv0=(0, 0), uv1=(1, 0), uv2=(0, 1)),
        st.Sphere((1.5, 1, 0), (1.5, 1, 0), 0, 1, 0.8, checker),
        st.Sphere((-1.5, 0.7, -1.5), (-1.5, 0.7, -1.5), 0, 1, 0.7, metal_only),
        st.Translate(st.TriangleMesh(tet * 1.2, bare), (0.5, 0.0, 1.5)),
        st.Sphere((0, 0.5, -2.5), (0, 0.5, -2.5), 0, 1, 0.5, lambert),
        st.FlipNormals(st.XZRect(-1, 1, -1, 1, 5.0, st.DiffuseLight(
            emit=st.ConstantTexture((8.0, 8.0, 8.0))))),
    ]
    cam = st.Camera(look_from=(0, 4, -8), look_at=(0, 0.5, 0), vfov=50,
                    aspect=1.0)
    return st.Scene(world=world, camera=cam)


@pytest.fixture(scope="module")
def scenes():
    """(JAX cs, meta, the port's cs, meta) of the PBR scene, RGB."""
    jcs, jmeta = jcompiler.compile_scene(pbr_scene(jst))
    tcs, tmeta = tcompiler.compile_scene(to_port_scene(pbr_scene(jst)), "cpu")
    return jcs, jmeta, tcs, tmeta


def test_pbr_scene_compiles_as_jax(scenes):
    """The tangent frames and the PBR columns, leaf for leaf (EQUAL)."""
    jcs, jmeta, tcs, tmeta = scenes
    want, got = jax_leaves(jcs), port_leaves(tcs)
    for leaf in tcompiler.LEAVES:
        np.testing.assert_array_equal(got[leaf], want[leaf], err_msg=leaf)
    assert tmeta.has_pbr and jmeta.has_pbr and tmeta.has_checker
    # Only the uv-mapped triangle has a tangent frame (the mesh has no uvs).
    assert (got["prims.tb"] != 0).any(axis=1).sum() == 1
    assert (got["materials.combo_id"] == -1).all()


def _records(jcs, tcs, n, seed):
    """Half camera rays, half from inside the scene, through both
    packages' brute force: (JAX ray, JAX hit, port ray, port hit)."""
    rs = np.random.RandomState(seed)
    s, t, u = (rs.rand(n).astype(np.float32), rs.rand(n).astype(np.float32),
               rs.rand(n, 3).astype(np.float32))
    o, d, tme = (np.array(x) for x in jcamera.get_rays(
        jcs.camera, jnp.asarray(s), jnp.asarray(t), jnp.asarray(u)))
    o[: n // 2] = rs.uniform(-3, 3, (n // 2, 3)) + np.array([0, 2.5, 0])
    d[: n // 2] = rs.normal(size=(n // 2, 3))
    jrec = jprim.intersect_brute(jcs.prims, jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(tme), 1e-3, jprim.T_MAX)
    trec = tprim.intersect_brute(tcs.prims, _t(o), _t(d), _t(tme), 1e-3,
                                 tprim.T_MAX)
    np.testing.assert_array_equal(trec.prim_idx.numpy(),
                                  np.asarray(jrec.prim_idx))
    return (o, d, tme), jrec, trec


def test_pbr_helpers_equal_jax(scenes):
    """_eval_pbr_texs, _pbr_normals and _pbr_lobes on 1,024 seeded hit
    records (every PBR case of the scene, a normal-mapped triangle among
    them), the JAX records given to both (the packages' sphere hits differ
    in the last ulp): masks equal, vectors and scalars within 1e-6."""
    jcs, jmeta, tcs, tmeta = scenes
    (o, d, _), jrec, _ = _records(jcs, tcs, 1024, 11)
    trec = tprim.Hit(*(_t(x).long() if x.dtype == np.int32 else _t(x)
                       for x in (np.asarray(f) for f in jrec)))
    us = np.random.RandomState(12).rand(1024, 12).astype(np.float32)
    is_tri_pbr = ((np.asarray(jrec.prim_idx) == 1) & np.asarray(jrec.hit))
    assert is_tri_pbr.sum() > 10

    with jax.disable_jit():
        jmat = jpath._gather_mat(jcs, jrec.mat_id)
        j_texs = jpath._eval_pbr_texs(jcs, jmeta, jmat, jrec)
        j_norm = jpath._pbr_normals(jcs, jmeta, jmat, jrec, jnp.asarray(d),
                                    j_texs[1])
        j_lobes = jpath._pbr_lobes(jcs, jmeta, jmat, jrec, jnp.asarray(d),
                                   j_norm[1], jnp.asarray(us), j_texs[2],
                                   j_texs[3])
    tmat = tpath._gather_mat(tcs, trec.mat_id)
    t_texs = tpath._eval_pbr_texs(tcs, tmeta, tmat, trec)
    t_norm = tpath._pbr_normals(tcs, tmat, trec, t_texs[1])
    t_lobes = tpath._pbr_lobes(tmat, _t(d), t_norm[1], _t(us), t_texs[2],
                               t_texs[3])
    # JAX's _pbr_lobes also returns the roughness and metalness it used;
    # the port returns only the lobe choice and direction that depend on them.
    for name, got, want in (("texs", t_texs, j_texs), ("normals", t_norm, j_norm),
                            ("lobes", t_lobes, j_lobes[:2])):
        assert len(got) == len(want), name
        for i, (g, w) in enumerate(zip(got, want)):
            w = np.asarray(w)
            if w.dtype == np.bool_:
                np.testing.assert_array_equal(g.numpy(), w, f"{name}[{i}]")
            else:
                np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6,
                                           err_msg=f"{name}[{i}]")
    # The triangle's TBN step moved its record normal; the lobe choice
    # took both branches.
    rec_n = t_norm[0].numpy()
    assert (np.abs(rec_n - trec.normal.numpy())[is_tri_pbr] > 1e-3).any()
    assert 0 < t_lobes[0].numpy().mean() < 1


def _bounce_state(n, seed, spectral):
    rs = np.random.RandomState(seed)
    keys = rs.randint(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32)
    depth = rs.randint(0, 4, n).astype(np.int32)
    shape = (n,) if spectral else (n, 3)
    thru = rs.uniform(0.2, 1.0, shape).astype(np.float32)
    rad = rs.uniform(0.0, 0.1, shape).astype(np.float32)
    active = rs.rand(n) < 0.9
    lam = rs.uniform(380.0, 750.0, n).astype(np.float32)
    return keys, depth, thru, rad, active, lam


def _compare_bounce(got, want, active):
    w_o, w_d, w_thru, w_rad, w_active, w_n = (np.asarray(x) for x in want[:6])
    g_o, g_d, g_thru, g_rad, g_active, g_n = got[:6]
    np.testing.assert_array_equal(g_active.numpy(), w_active)
    assert int(g_n) == int(w_n) == int(active.sum())
    assert 0 < w_active.sum() < active.sum()
    live = w_active
    np.testing.assert_allclose(g_o.numpy()[live], w_o[live], rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(g_d.numpy()[live], w_d[live], rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(g_thru.numpy(), w_thru, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(g_rad.numpy(), w_rad, rtol=RTOL, atol=1e-6)


def test_bounce_rgb_pbr_one_step(scenes):
    """One RGB bounce of 512 paths through the PBR scene (JAX eager)."""
    jcs, jmeta, tcs, tmeta = scenes
    (o, d, tme), _, _ = _records(jcs, tcs, 512, 13)
    keys, depth, thru, rad, active, _ = _bounce_state(512, 14, False)
    args = (o, d, tme, keys, depth, thru, rad, active)
    with jax.disable_jit():
        want = jpath.bounce_rgb(jcs, jmeta, jpath.RenderSettings(max_depth=4),
                                jpath.make_brute_intersector(jcs),
                                *(jnp.asarray(x) for x in args))
    got = tpath.bounce_rgb(
        tcs, tmeta, tpath.RenderSettings(max_depth=4),
        tpath.make_brute_intersector(tcs), _t(o), _t(d), _t(tme),
        _t(keys.astype(np.int64)), _t(depth), _t(thru), _t(rad), _t(active))
    _compare_bounce(got, want, active)


@pytest.fixture(scope="module")
def dragon():
    """The dragon at a 2,000-triangle stand-in: (JAX cs, meta, port cs,
    meta), brute force on both sides."""
    jcs, jmeta = jcompiler.compile_scene(j_dragon(n_tris=DRAGON_TRIS))
    tcs, tmeta = tcompiler.compile_scene(t_dragon(n_tris=DRAGON_TRIS), "cpu")
    return jcs, jmeta, tcs, tmeta


def test_bounce_spectral_pbr_one_step(dragon):
    """One spectral bounce of 512 paths in the dragon's box, half of them
    from inside it: the porcelain's ×1.5 specular lobe and the diffuse
    lobe, the glass sphere and the walls (JAX eager)."""
    jcs, jmeta, tcs, tmeta = dragon
    rs = np.random.RandomState(15)
    n = 512
    s, t, u = (rs.rand(n).astype(np.float32), rs.rand(n).astype(np.float32),
               rs.rand(n, 3).astype(np.float32))
    o, d, tme = (np.array(x) for x in jcamera.get_rays(
        jcs.camera, jnp.asarray(s), jnp.asarray(t), jnp.asarray(u)))
    o[: n // 2] = rs.uniform(5.0, 95.0, (n // 2, 3))
    d[: n // 2] = rs.normal(size=(n // 2, 3))
    keys, depth, thru, rad, active, lam = _bounce_state(n, 16, True)
    bg = jmeta.spectral_background_spd or 0
    args = (o, d, tme, lam, keys, depth, thru, rad, active)
    with jax.disable_jit():
        want = jpath.bounce_spectral(
            jcs, jmeta, jpath.RenderSettings(max_depth=4),
            jpath.make_brute_intersector(jcs),
            *(jnp.asarray(x) for x in args), bg)
    got = tpath.bounce_spectral(
        tcs, tmeta, tpath.RenderSettings(max_depth=4),
        tpath.make_brute_intersector(tcs), _t(o), _t(d), _t(tme), _t(lam),
        _t(keys.astype(np.int64)), _t(depth), _t(thru), _t(rad), _t(active),
        bg)
    _compare_bounce(got, want, active)
    mesh = np.asarray(jcs.materials.kind)[np.asarray(
        jprim.intersect_brute(jcs.prims, jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(tme), 1e-3, jprim.T_MAX).mat_id)] == 5
    assert mesh.sum() > 20  # the porcelain is hit


def _exact_pbr_scene(triangle: bool):
    """The scenes of test_exact_path_materials.py:491 (a PBR rect under the
    ad-hoc frame) and :514 (a uv-mapped PBR triangle, the double normal
    map), built as those tests build them."""
    lt, _, _ = exact._light_objs()
    mat = jst.PBR(albedo=jst.ConstantTexture((0.7, 0.5, 0.3)),
                  roughness=jst.ConstantTexture((0.4, 0.4, 0.4)),
                  metalness=jst.ConstantTexture((0.2, 0.2, 0.2)),
                  normal_map=jst.ConstantTexture((0.6, 0.45, 0.9)))
    shape = (jst.Triangle(v0=(-2.0, 0.0, -2.0), v1=(2.0, 0.0, -2.0),
                          v2=(-2.0, 0.0, 2.0), material=mat, uv0=(0.0, 0.0),
                          uv1=(1.0, 0.0), uv2=(0.0, 1.0))
             if triangle else jst.XZRect(-2, 2, -2, 2, 0.0, mat))
    return jst.Scene(world=[shape, lt], camera=jst.Camera(
        look_from=exact.LOOK_FROM, look_at=exact.LOOK_AT, vfov=exact.VFOV,
        aspect=exact.NX / exact.NY))


@pytest.mark.parametrize("triangle", [False, True], ids=["rect", "triangle"])
def test_rgb_oracle_matches_jax_on_exact_pbr_scenes(triangle):
    """The lockstep oracle (`mode="simple"`) at the exact tests' 8×8, 1 spp,
    depth 4, seed 23 and background: equal ray counts, pixels within
    1e-5."""
    s_j = jpath.RenderSettings(max_depth=exact.DEPTH, background=exact.BG)
    s_t = tpath.RenderSettings(max_depth=exact.DEPTH, background=exact.BG)
    scene = _exact_pbr_scene(triangle)
    want = jrenderer.render(scene, exact.NX, exact.NY, exact.SPP, settings=s_j,
                            seed=exact.SEED, mode="simple")
    got = trenderer.render(to_port_scene(scene), exact.NX, exact.NY, exact.SPP,
                           s_t, seed=exact.SEED, mode="simple", device="cpu")
    assert got.rays_traced == want.rays_traced
    np.testing.assert_allclose(got.image, want.image, rtol=RTOL, atol=1e-5)
    assert got.image.mean() > 0.01


def test_dragon_spectral_pool_matches_jax():
    """The dragon (2,000-triangle stand-in) through the spectral queue pool,
    8×8 at 2 spp, depth 4, seed 0, brute force on both sides: equal ray
    counts; XYZ (after firefly rejection) and ACEScg on at least 99% of the
    pixels within 1e-4 + 1e-5·|JAX| and means within 0.5% (the JAX pool
    runs compiled, so a rare path may flip)."""
    s_j, s_t = jpath.RenderSettings(max_depth=4), tpath.RenderSettings(max_depth=4)
    want = jrenderer.render(j_dragon(n_tris=DRAGON_TRIS), 8, 8, 2, settings=s_j,
                            seed=0, mode="pool", use_bvh=False)
    ctx = trenderer.RenderContext(t_dragon(n_tris=DRAGON_TRIS), use_bvh=False,
                                  device="cpu")
    assert ctx.meta.has_pbr and not ctx.mega_supported()
    got = trenderer.render(None, 8, 8, 2, s_t, seed=0, mode="pool", context=ctx,
                           device="cpu")
    assert got.rays_traced == want.rays_traced
    for g, w in ((got.xyz, want.xyz), (got.image, want.image)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        close = (np.abs(g - w) <= 1e-4 + 1e-5 * np.abs(w)).all(axis=-1)
        assert close.mean() >= 0.99, close.mean()
        assert abs(g.mean() - w.mean()) <= 0.005 * abs(w.mean())
        assert np.isfinite(g).all()
