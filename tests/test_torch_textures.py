"""izpi_tpu_torch's texture, noise, uplift, white-balance and media modules
vs the JAX package's, on inputs made with numpy from a seed.

The JAX functions run eagerly where exactness matters (XLA's compiled CPU
code contracts multiply-adds into FMAs, ROADMAP C). Tolerances: the Perlin
tables, `noise` and `turb` are equal bit for bit; image lookups (integer
index math) are equal; `eval_rgb` agrees to 1e-6 (one ulp of torch's and
XLA's CPU `sin`); the uplift to 1e-6 (`exp`); the white balance to 1e-12
(float64 on both sides); the media's hit masks, materials and primitives
are equal and their t, points and normals agree to 1e-5 relative (their
spans go through `sqrt`, `log` and divisions). The media tests port
tests/test_media_aov.py:27,37 and the uplift pins
tests/test_presets_uplift.py:19-44.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import to_port_scene
from izpi_tpu.geometry import primitives as jprim
from izpi_tpu.integrator import path as jpath
from izpi_tpu.scene import compiler as jcompiler
from izpi_tpu.scene import types as jst
from izpi_tpu.scene.library import shirley as jshirley
from izpi_tpu.spectral import spd as jspd
from izpi_tpu.spectral import whitebalance as jwb
from izpi_tpu.texture import perlin as jperlin
from izpi_tpu.texture import tables as jtables
from izpi_tpu.texture import uplift as juplift
from izpi_tpu_torch.core import rng as trng
from izpi_tpu_torch.geometry import primitives as tprim
from izpi_tpu_torch.integrator import path as tpath
from izpi_tpu_torch.render import renderer as trenderer
from izpi_tpu_torch.scene import compiler as tcompiler
from izpi_tpu_torch.spectral import spd as tspd
from izpi_tpu_torch.spectral import whitebalance as twb
from izpi_tpu_torch.texture import perlin as tperlin
from izpi_tpu_torch.texture import tables as ttables
from izpi_tpu_torch.texture import uplift as tuplift


def _t(a):
    return torch.as_tensor(np.array(a))


def test_perlin_tables_equal_jax():
    for got, want in zip(tperlin.build_tables(seed=0),
                         jperlin.build_tables(seed=0)):
        assert got.dtype == (torch.float32 if want.dtype == jnp.float32
                             else torch.int32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("scale", [1.0, 40.0, 3000.0])
def test_noise_and_turb_equal_eager_jax(scale):
    """Points of magnitude `scale` (final's ground reaches ~1,000, and turb
    samples at up to 64× the point): bit for bit."""
    p = (np.random.RandomState(1).randn(2048, 3) * scale).astype(np.float32)
    jt, tt = jperlin.build_tables(0), tperlin.build_tables(0)
    with jax.disable_jit():
        want_n = np.asarray(jperlin.noise(jt, jnp.asarray(p)))
        want_t = np.asarray(jperlin.turb(jt, jnp.asarray(p), 7))
    np.testing.assert_array_equal(tperlin.noise(tt, _t(p)).numpy(), want_n)
    np.testing.assert_array_equal(tperlin.turb(tt, _t(p), 7).numpy(), want_t)
    assert np.abs(want_n).max() <= 1.0 and want_t.std() > 0.05


def _image_table(st, seed):
    """Textures of every kind: two constants, a checker, two images of
    different sizes (one grey, one flipped in x and y) and a noise."""
    rs = np.random.RandomState(seed)
    red = st.ConstantTexture((0.9, 0.1, 0.1))
    checker = st.CheckerTexture(st.ConstantTexture((0.2, 0.3, 0.1)),
                                st.ConstantTexture((0.9, 0.9, 0.9)))
    img_a = st.ImageTexture(data=rs.rand(24, 40, 3))
    img_b = st.ImageTexture(data=rs.rand(13, 7), flip_x=True, flip_y=True)
    noise = st.NoiseTexture(scale=4.0)
    mats = [st.Lambertian(albedo=t) for t in (red, checker, img_a, img_b,
                                              noise)]
    world = [st.Sphere((3.0 * i, 0, 0), (3.0 * i, 0, 0), 0, 1, 1, m)
             for i, m in enumerate(mats)]
    world.append(st.XZRect(-1, 1, -1, 1, 5, st.DiffuseLight(
        emit=st.ConstantTexture((4, 4, 4)))))
    return st.Scene(world=world, camera=st.Camera(look_from=(0, 0, -9),
                                                  look_at=(0, 0, 0)))


@pytest.fixture(scope="module")
def textured():
    scene = _image_table(jst, 3)
    jcs, jmeta = jcompiler.compile_scene(scene)
    tcs, tmeta = tcompiler.compile_scene(to_port_scene(scene), "cpu")
    return jcs, jmeta, tcs, tmeta


def _tex_inputs(n, n_tex, seed):
    rs = np.random.RandomState(seed)
    tid = rs.randint(-1, n_tex, n).astype(np.int32)
    u = rs.uniform(-0.1, 1.1, n).astype(np.float32)
    v = rs.uniform(-0.1, 1.1, n).astype(np.float32)
    p = (rs.randn(n, 3) * 3.0).astype(np.float32)
    return tid, u, v, p


def test_image_lookup_equals_jax(textured):
    """Nearest texel with the V flip and truncation toward zero, u and v
    past both edges, NaN and infinities among them (XLA sends NaN to 0 and
    saturates): equal."""
    jcs, _, tcs, _ = textured
    _, u, v, _ = _tex_inputs(4096, 1, 5)
    u[:4] = [np.nan, np.inf, -np.inf, 1e30]
    v[4:8] = [np.nan, np.inf, -np.inf, -1e30]
    img = np.random.RandomState(6).randint(0, 2, 4096).astype(np.int32)
    jt = jcs.textures
    want = np.asarray(jtables.image_lookup(jt.images, jt.img_w, jt.img_h,
                                           jnp.asarray(img), jnp.asarray(u),
                                           jnp.asarray(v)))
    tt = tcs.textures
    got = ttables.image_lookup(tt.images, tt.img_w, tt.img_h, _t(img).long(),
                               _t(u), _t(v))
    np.testing.assert_array_equal(got.numpy(), want)
    assert tuple(tt.img_w.tolist()) == (40, 7)


@pytest.mark.parametrize("flags", [(True, True, True), (True, False, False),
                                   (False, True, False), (False, False, True)],
                         ids=["all", "checker", "image", "noise"])
def test_eval_rgb_matches_eager_jax(textured, flags):
    jcs, _, tcs, _ = textured
    tid, u, v, p = _tex_inputs(2048, int(tcs.textures.kind.shape[0]), 7)
    kw = dict(zip(("has_checker", "has_image", "has_noise"), flags))
    with jax.disable_jit():
        want = np.asarray(jtables.eval_rgb(
            jcs.textures, jnp.asarray(tid), jnp.asarray(u), jnp.asarray(v),
            jnp.asarray(p), **kw))
    got = ttables.eval_rgb(tcs.textures, _t(tid), _t(u), _t(v), _t(p), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    if all(flags):
        assert len(np.unique(want.round(6), axis=0)) > 100


def test_uplift_matches_eager_jax():
    rs = np.random.RandomState(8)
    rgb = rs.rand(4096, 3).astype(np.float32)
    rgb[:512] = rgb[:512, :1]  # neutral colours
    lam = rs.uniform(360.0, 770.0, 4096).astype(np.float32)
    lam[:75] = np.arange(380.0, 751.0, 5.0)  # the bucket nodes
    with jax.disable_jit():
        want_f = np.asarray(juplift.rgb_to_spectral_value(jnp.asarray(rgb),
                                                          jnp.asarray(lam)))
        want_b = np.asarray(juplift.eval_bucketed(jnp.asarray(rgb),
                                                  jnp.asarray(lam)))
    np.testing.assert_allclose(
        tuplift.rgb_to_spectral_value(_t(rgb), _t(lam)).numpy(), want_f,
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tuplift.eval_bucketed(_t(rgb), _t(lam)).numpy(),
                               want_b, rtol=1e-6, atol=1e-6)


# tests/test_presets_uplift.py:19-44, on the port.

def test_uplift_neutral_preserved():
    rgb = torch.tensor([[0.8, 0.8, 0.8]])
    for lam in (400.0, 550.0, 700.0):
        v = float(tuplift.rgb_to_spectral_value(rgb, torch.tensor([lam]))[0])
        assert v >= 0.8 - 1e-6  # neutral keeps max(rgb)


def test_uplift_red_channel_gating():
    rgb = torch.tensor([[1.0, 0.0, 0.0]])
    at_650 = float(tuplift.rgb_to_spectral_value(rgb, torch.tensor([650.0]))[0])
    at_450 = float(tuplift.rgb_to_spectral_value(rgb, torch.tensor([450.0]))[0])
    assert at_650 > 0.95  # peak + bright-pixel floor
    # No red lobe below 520 nm, but the bright-pixel floor keeps 0.8·max.
    assert abs(at_450 - 0.8) < 1e-6


def test_uplift_bucketed_matches_formula_at_nodes():
    rgb = torch.tensor([[0.3, 0.6, 0.1]]).repeat(3, 1)
    lam = torch.tensor([450.0, 550.0, 650.0])  # exact 5 nm nodes
    np.testing.assert_allclose(
        tuplift.rgb_to_spectral_value(rgb, lam).numpy(),
        tuplift.eval_bucketed(rgb, lam).numpy(), atol=1e-6)


@pytest.mark.parametrize("source", ["default", "3200K", "6500K", "spd"])
def test_white_balance_equals_jax(source):
    if source == "default":
        want, got = jwb.WhiteBalanceConfig.default(), twb.WhiteBalanceConfig.default()
    elif source == "spd":
        lam, vals = np.arange(380.0, 751.0, 10.0), np.linspace(0.2, 1.0, 38)
        want = jwb.WhiteBalanceConfig.from_spd(jspd.SPD(lam, vals), "ramp")
        got = twb.WhiteBalanceConfig.from_spd(tspd.SPD(lam, vals), "ramp")
    else:
        temp = float(source[:-1])
        want = jwb.WhiteBalanceConfig.from_temperature(temp)
        got = twb.WhiteBalanceConfig.from_temperature(temp)
    assert got.description == want.description
    np.testing.assert_allclose(got.white_point, want.white_point, rtol=1e-12)
    np.testing.assert_allclose(got.matrix, want.matrix, rtol=1e-12, atol=1e-12)
    xyz = np.random.RandomState(9).rand(16, 3)
    np.testing.assert_allclose(got.apply(xyz), want.apply(xyz), rtol=1e-12)
    with pytest.raises(ValueError):
        twb.WhiteBalanceConfig.from_temperature(500.0)


# ---- participating media ----

def _media_scene(st):
    """final's two sphere media (a smoke ball and the radius-5000 fog) plus
    a box of smoke under Translate/RotateY around a floor and a sphere."""
    white = st.Lambertian(albedo=st.ConstantTexture((0.73, 0.73, 0.73)))
    ball = st.Sphere((1, 1, 0), (1, 1, 0), 0, 1, 0.8, st.Dielectric(1.5))
    fog = st.Sphere((0, 0, 0), (0, 0, 0), 0, 1, 5000, st.Dielectric(1.5))
    box = st.Translate(st.RotateY(st.Box((0, 0, 0), (1.5, 2, 1), white), 25.0),
                       (-2.5, 0, -0.5))
    world = [
        st.XZRect(-5, 5, -5, 5, 0, white), ball,
        st.ConstantMedium(boundary=ball, density=1.5, phase=st.Isotropic(
            albedo=st.ConstantTexture((0.2, 0.4, 0.9)))),
        st.ConstantMedium(boundary=fog, density=0.01, phase=st.Isotropic(
            albedo=st.ConstantTexture((1, 1, 1)))),
        st.ConstantMedium(boundary=box, density=0.8, phase=st.Isotropic(
            albedo=st.ConstantTexture((0.9, 0.9, 0.9)))),
        st.FlipNormals(st.XZRect(-1, 1, -1, 1, 4, st.DiffuseLight(
            emit=st.ConstantTexture((8, 8, 8))))),
    ]
    return st.Scene(world=world, camera=st.Camera(
        look_from=(0, 2, -9), look_at=(0, 1, 0), vfov=45))


def test_apply_media_matches_eager_jax():
    scene = _media_scene(jst)
    jcs, jmeta = jcompiler.compile_scene(scene)
    tcs, tmeta = tcompiler.compile_scene(to_port_scene(scene), "cpu")
    assert tmeta.n_media == 3 and tmeta.media_is_sphere == (True, True, False)
    rs = np.random.RandomState(10)
    n = 2048
    o = rs.uniform(-4, 4, (n, 3)).astype(np.float32) + np.float32([0, 1.5, 0])
    o[: n // 4] = np.float32([0, 2, -9])
    d = rs.normal(size=(n, 3)).astype(np.float32)
    keys = rs.randint(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32)
    depth = rs.randint(0, 5, n).astype(np.int32)
    tme = np.zeros(n, np.float32)
    # The surface hits, given to both.
    base = jprim.intersect_brute(jcs.prims, jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(tme), 1e-3, jprim.T_MAX)
    with jax.disable_jit():
        want = jpath._apply_media(jcs, jmeta, base, jnp.asarray(o),
                                  jnp.asarray(d), jnp.asarray(tme),
                                  jnp.asarray(keys), jnp.asarray(depth))
    trec = tprim.Hit(*(_t(x).long() if x.dtype == np.int32 else _t(x)
                       for x in (np.asarray(f) for f in base)))
    got = tpath._apply_media(tcs, tmeta, trec, _t(o), _t(d),
                             _t(keys.astype(np.int64)), _t(depth))
    for f in ("hit", "mat_id", "prim_idx"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    for f in ("t", "p", "normal", "u", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)
    med = np.asarray(want.mat_id) >= 0
    med &= np.isin(np.asarray(want.mat_id), np.asarray(jcs.media.mat_id))
    assert 0.05 < med.mean() < 0.95  # media took some of the hits


def _smoke_scene(st, density=0.1):
    """tests/test_media_aov.py's smoke box over a floor under a light."""
    white = st.Lambertian(albedo=st.ConstantTexture((0.73, 0.73, 0.73)))
    smoke = st.ConstantMedium(
        boundary=st.Box((-2, 0, -2), (2, 4, 2), white), density=density,
        phase=st.Isotropic(albedo=st.ConstantTexture((0.9, 0.9, 0.9))))
    light = st.FlipNormals(st.XZRect(-1, 1, -1, 1, 8.0, st.DiffuseLight(
        emit=st.ConstantTexture((10, 10, 10)))))
    floor = st.XZRect(-10, 10, -10, 10, 0.0, white)
    return st.Scene(world=[smoke, light, floor], camera=st.Camera(
        look_from=(0, 3, -9), look_at=(0, 2, 0), vfov=45))


def test_medium_occludes_statistically():
    from izpi_tpu_torch.scene import types as tst

    s = tpath.RenderSettings(max_depth=6)
    thin = trenderer.render(_smoke_scene(tst, 0.01), 24, 24, 8, s, seed=5,
                            device="cpu")
    thick = trenderer.render(_smoke_scene(tst, 5.0), 24, 24, 8, s, seed=5,
                             device="cpu")
    assert np.isfinite(thin.image).all() and np.isfinite(thick.image).all()
    # Dense smoke scatters into the zero-contribution isotropic phase (the
    # reference's RGB behaviour): a darker image than thin smoke.
    assert thick.image.mean() < thin.image.mean()


def test_medium_free_flight_distribution():
    """A ray through a 4-deep box medium: P(scatter) = 1 - exp(-ρ·L)."""
    from izpi_tpu_torch.scene import types as tst

    cs, meta = tcompiler.compile_scene(_smoke_scene(tst, 0.5), "cpu")
    n = 4096
    o = torch.tensor([[0.0, 2.0, -10.0]]).repeat(n, 1)
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(n, 1)
    t = torch.zeros(n)
    keys = trng.path_keys(trng.render_key(0), torch.arange(n), 0)
    base = tprim.intersect_brute(cs.prims, o, d, t, 1e-3, tprim.T_MAX)
    rec = tpath._apply_media(cs, meta, base, o, d, keys,
                             torch.zeros(n, dtype=torch.int64))
    frac = float(((rec.mat_id == int(cs.media.mat_id[0])) & rec.hit)
                 .float().mean())
    expected = 1.0 - np.exp(-0.5 * 4.0)  # the box spans z in [-2, 2]
    assert abs(frac - expected) < 0.05, (frac, expected)


def test_final_media_leaves_equal_jax():
    """The book-2 final scene's media group: the smoke ball and the fog,
    both spheres, their Isotropic materials (kind 4) in the table."""
    jcs, jmeta = jcompiler.compile_scene(jshirley.final())
    from izpi_tpu_torch.scene.library import shirley as tshirley

    tcs, tmeta = tcompiler.compile_scene(tshirley.final(), "cpu")
    assert tmeta.media_is_sphere == jmeta.media_is_sphere == (True, True)
    for f in tcompiler.Media._fields:
        np.testing.assert_array_equal(getattr(tcs.media, f).numpy(),
                                      np.asarray(getattr(jcs.media, f)), f)
    kinds = tcs.materials.kind[tcs.media.mat_id.long()]
    assert kinds.tolist() == [4, 4]
