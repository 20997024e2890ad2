"""izpi_tpu_torch's camera, intersection and RGB bounce vs the JAX package.

Same rays, same keys, same tables (the JAX compile's leaves, carried over
with `from_jax_arrays`). Masks and primitive ids must be equal; float
outputs agree to rtol 1e-5, the room for last-ulp differences between
torch's and XLA's CPU sqrt/sin/cos/exp/log/pow. The JAX functions run
eagerly, op by op, except where a test says otherwise: compiled, XLA fuses
multiply-adds into FMAs, which round differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_leaves, mixed_scene
from izpi_tpu import camera as jcamera
from izpi_tpu.core import rng as jrng
from izpi_tpu.geometry import primitives as jprim
from izpi_tpu.integrator import path as jpath
from izpi_tpu.render import renderer as jrenderer
from izpi_tpu.scene import compiler as jcompiler
from izpi_tpu.scene import types as jst
from izpi_tpu.scene.library.cornell import cornell_box as j_cornell
from izpi_tpu_torch import camera as tcamera
from izpi_tpu_torch.core import rng as trng
from izpi_tpu_torch.geometry import primitives as tprim
from izpi_tpu_torch.integrator import path as tpath
from izpi_tpu_torch.render import renderer as trenderer
from izpi_tpu_torch.scene import compiler as tcompiler

RTOL = 1e-5


@pytest.fixture(scope="module", params=["cornell", "mixed"])
def scenes(request):
    scene = j_cornell() if request.param == "cornell" else mixed_scene(jst)
    jcs, jmeta = jcompiler.compile_scene(scene)
    tcs, tmeta = tcompiler.from_jax_arrays(jax_leaves(jcs), "cpu")
    return request.param, jcs, jmeta, tcs, tmeta


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _camera_rays(jcs, n, seed):
    rs = np.random.RandomState(seed)
    s = rs.rand(n).astype(np.float32)
    t = rs.rand(n).astype(np.float32)
    u = rs.rand(n, 3).astype(np.float32)
    return s, t, u


def _rays(name, n, seed):
    """Origins inside the scene and random directions."""
    rs = np.random.RandomState(seed)
    if name == "cornell":
        o = rs.uniform(20, 535, (n, 3))
    else:
        o = rs.uniform(-4, 4, (n, 3)) + np.array([0, 4, 0])
    d = rs.normal(size=(n, 3))
    tme = rs.rand(n)
    return (o.astype(np.float32), d.astype(np.float32), tme.astype(np.float32))


def test_get_rays(scenes):
    _, jcs, _, tcs, _ = scenes
    s, t, u = _camera_rays(jcs, 512, 1)
    want = jcamera.get_rays(jcs.camera, jnp.asarray(s), jnp.asarray(t),
                            jnp.asarray(u))
    got = tcamera.get_rays(tcs.camera, _t(s), _t(t), _t(u))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=1e-5)


def test_compile_camera_equals_jax(scenes):
    name, jcs, _, _, _ = scenes
    scene = j_cornell() if name == "cornell" else mixed_scene(jst)
    tcam = tcamera.compile_camera(scene.camera, "cpu")
    for f in tcamera.CameraArrays._fields:
        np.testing.assert_array_equal(getattr(tcam, f).numpy(),
                                      np.asarray(getattr(jcs.camera, f)))


def test_intersect_brute_and_finalize(scenes):
    name, jcs, _, tcs, _ = scenes
    o, d, tme = _rays(name, 1024, 2)
    want = jprim.intersect_brute(jcs.prims, jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(tme), 1e-3, jprim.T_MAX)
    got = tprim.intersect_brute(tcs.prims, _t(o), _t(d), _t(tme), 1e-3,
                                tprim.T_MAX)
    hit = np.asarray(want.hit)
    assert hit.mean() > 0.3
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_array_equal(got.prim_idx.numpy(), np.asarray(want.prim_idx))
    np.testing.assert_array_equal(got.mat_id.numpy(), np.asarray(want.mat_id))
    for f in ("t", "p", "normal", "u", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy()[hit],
                                   np.asarray(getattr(want, f))[hit],
                                   rtol=RTOL, atol=1e-5, err_msg=f)


def _bounce_inputs(name, jcs, n, seed):
    rs = np.random.RandomState(seed)
    s, t, u = _camera_rays(jcs, n, seed)
    o, d, tme = (np.array(x) for x in jcamera.get_rays(
        jcs.camera, jnp.asarray(s), jnp.asarray(t), jnp.asarray(u)))
    # Half the batch starts inside the scene, in random directions.
    o2, d2, _ = _rays(name, n // 2, seed + 1)
    o[: n // 2], d[: n // 2] = o2, d2
    keys = rs.randint(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32)
    depth = rs.randint(0, 4, n).astype(np.int32)
    thru = rs.uniform(0.2, 1.0, (n, 3)).astype(np.float32)
    rad = rs.uniform(0.0, 0.1, (n, 3)).astype(np.float32)
    active = rs.rand(n) < 0.9
    return o, d, tme, keys, depth, thru, rad, active


def test_bounce_rgb_one_step(scenes):
    name, jcs, jmeta, tcs, tmeta = scenes
    settings_j = jpath.RenderSettings(max_depth=4)
    settings_t = tpath.RenderSettings(max_depth=4)
    o, d, tme, keys, depth, thru, rad, active = _bounce_inputs(name, jcs, 256, 3)
    want = jpath.bounce_rgb(
        jcs, jmeta, settings_j, jpath.make_brute_intersector(jcs),
        *(jnp.asarray(x) for x in (o, d, tme, keys, depth, thru, rad, active)))
    got = tpath.bounce_rgb(
        tcs, tmeta, settings_t, tpath.make_brute_intersector(tcs), _t(o),
        _t(d), _t(tme),
        _t(keys.astype(np.int64)), _t(depth), _t(thru), _t(rad), _t(active))
    w_o, w_d, w_thru, w_rad, w_active, w_n = (np.asarray(x) for x in want)
    g_o, g_d, g_thru, g_rad, g_active, g_n = got
    np.testing.assert_array_equal(g_active.numpy(), w_active)
    assert int(g_n) == int(w_n) == int(active.sum())
    live = w_active
    np.testing.assert_allclose(g_o.numpy()[live], w_o[live], rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(g_d.numpy()[live], w_d[live], rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(g_thru.numpy(), w_thru, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(g_rad.numpy(), w_rad, rtol=RTOL, atol=1e-6)


def test_trace_camera_batch():
    """Cornell, an 8×8 camera batch traced to completion (depth 4), one
    sample, against the JAX package's compiled `trace`.

    Compiled, XLA's CPU backend contracts multiply-adds into FMAs; eager
    ops (and the port) round each product. On Cornell's 8×8 batch no path
    flips, so the images agree to 1e-5. On the mixed scene the contraction
    flips 2 of the 64 paths, so that scene is compared bounce by bounce with
    the JAX ops run eagerly (test_bounce_rgb_one_step)."""
    jcs, jmeta = jcompiler.compile_scene(j_cornell())
    tcs, tmeta = tcompiler.from_jax_arrays(jax_leaves(jcs), "cpu")
    nx = ny = 8
    ys = np.repeat(np.arange(ny, dtype=np.int32), nx)
    xs = np.tile(np.arange(nx, dtype=np.int32), ny)
    want, w_rays = jax.jit(lambda x, y, k: jrenderer.sample_pass(
        jcs, jmeta, jpath.RenderSettings(max_depth=4),
        jpath.make_brute_intersector(jcs), nx, ny, x, y, k, 1))(
            jnp.asarray(xs), jnp.asarray(ys), jrng.render_key(3))
    got, g_rays = trenderer.sample_pass(
        tcs, tmeta, tpath.RenderSettings(max_depth=4),
        tpath.make_brute_intersector(tcs), nx, ny,
        _t(xs).long(), _t(ys).long(), trng.render_key(3), 1)
    assert int(g_rays) == int(w_rays)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-5)


@pytest.fixture(scope="module", params=["pyramid", "spectral_mixed"])
def spectral_scenes(request):
    from _torch_port import spectral_mixed_scene
    from izpi_tpu.scene.library.cornell_spectral import cornell_box_spectral
    from izpi_tpu.spectral import spd as jspd

    scene = (cornell_box_spectral(with_prism=True)
             if request.param == "pyramid"
             else spectral_mixed_scene(jst, jspd))
    jcs, jmeta = jcompiler.compile_scene(scene)
    tcs, tmeta = tcompiler.from_jax_arrays(jax_leaves(jcs), "cpu",
                                           jax_meta=jmeta)
    return request.param, jcs, jmeta, tcs, tmeta


def _spectral_bounce_inputs(name, jcs, n, seed):
    """Camera rays, half of them replaced by rays from inside the scene
    (the pyramid's box is 100 wide), random wavelengths and path state."""
    rs = np.random.RandomState(seed)
    s, t, u = _camera_rays(jcs, n, seed)
    o, d, tme = (np.array(x) for x in jcamera.get_rays(
        jcs.camera, jnp.asarray(s), jnp.asarray(t), jnp.asarray(u)))
    if name == "pyramid":
        o[: n // 2] = rs.uniform(5.0, 95.0, (n // 2, 3))
    else:
        o[: n // 2] = rs.uniform(-4, 4, (n // 2, 3)) + np.array([0, 2.5, 0])
    d[: n // 2] = rs.normal(size=(n // 2, 3))
    lam = rs.uniform(380.0, 750.0, n).astype(np.float32)
    keys = rs.randint(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32)
    depth = rs.randint(0, 4, n).astype(np.int32)
    thru = rs.uniform(0.2, 1.0, n).astype(np.float32)
    rad = rs.uniform(0.0, 0.1, n).astype(np.float32)
    active = rs.rand(n) < 0.9
    return (o.astype(np.float32), d.astype(np.float32), tme, lam, keys, depth,
            thru, rad, active)


def test_bounce_spectral_one_step(spectral_scenes):
    """One bounce of 512 paths: the same hits, the same survivors and the
    same ray count; positions, directions, throughput, radiance and the
    background value within 1e-6 (JAX run eagerly)."""
    name, jcs, jmeta, tcs, tmeta = spectral_scenes
    bg = jmeta.spectral_background_spd
    args = _spectral_bounce_inputs(name, jcs, 512, 4)
    with jax.disable_jit():
        want = jpath.bounce_spectral(
            jcs, jmeta, jpath.RenderSettings(max_depth=4),
            jpath.make_brute_intersector(jcs),
            *(jnp.asarray(x) for x in args), bg)
    o, d, tme, lam, keys, depth, thru, rad, active = args
    got = tpath.bounce_spectral(
        tcs, tmeta, tpath.RenderSettings(max_depth=4),
        tpath.make_brute_intersector(tcs), _t(o), _t(d), _t(tme),
        _t(lam), _t(keys.astype(np.int64)), _t(depth), _t(thru), _t(rad),
        _t(active), bg)
    w_o, w_d, w_thru, w_rad, w_active, w_n, w_bg = (np.asarray(x)
                                                     for x in want)
    g_o, g_d, g_thru, g_rad, g_active, g_n, g_bg = got
    np.testing.assert_array_equal(g_active.numpy(), w_active)
    assert int(g_n) == int(w_n) == int(active.sum())
    assert 0 < w_active.sum() < active.sum()  # some paths end, some go on
    live = w_active
    np.testing.assert_allclose(g_o.numpy()[live], w_o[live], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(g_d.numpy()[live], w_d[live], rtol=1e-6,
                               atol=1e-6)
    for g, w in ((g_thru, w_thru), (g_rad, w_rad), (g_bg, w_bg)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)
