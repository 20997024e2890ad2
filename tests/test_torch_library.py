"""The scenes this slice adds to izpi_tpu_torch's registry (Shirley's five,
`texture_mapped_sphere`, `environment`, `pbr_ibl` and `displacement_test`)
vs the JAX package's: the registry, the compile leaf for leaf, the weights
carried across by `from_jax_arrays`, the combined stack's eviction, one RGB
and one spectral bounce with media, images, noise, the combined stack and
the uplift, a small render of each scene, and the asset reader's raise.

Renders are 16×16 at 1 spp, depth 3, seed 0 (the Shirley scenes under
bench.py's sky, (0.7, 0.8, 1.0)), held to the port's render tolerance: ray
counts within 0.5%, at least 99% of the pixels with every channel within
1e-4 + 1e-5·|JAX|, means within 0.5%. The JAX side is its compiled queue
pool with brute force (with its BVH for `displacement_test`, above its
threshold); the port's is `render()`'s default: the RGB megakernel's plain
version for `random_scene` and `two_spheres`, the queue pool for the rest,
through the plain BVH4 traversal for `final` and `displacement_test`.
`two_perlin_spheres` and `final` are held to eager JAX's lockstep oracle
instead (brute force, the same gate): XLA's compiled CPU code contracts
multiply-adds into FMAs (ROADMAP C), and these two scenes turn its
last-ulp differences into other paths. The marble texture multiplies a
hit point's error by ~10·Σ 2^i·0.5^i·|∇noise|, and `final`'s fog and
its light's grazing pdfs do the rest: against the compiled pool 13%
(`two_perlin_spheres`) and 3.5% (`final`) of the pixels differ, with ray
counts 0.7% and 0.2% apart; against eager JAX the rays are equal and every
`final` pixel agrees. The bounces run eagerly and agree as in
tests/test_torch_pbr.py (masks equal, floats within 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_leaves, port_leaves
from izpi_tpu import camera as jcamera
from izpi_tpu.core import rng as jrng
from izpi_tpu.geometry import primitives as jprim
from izpi_tpu.integrator import path as jpath
from izpi_tpu.integrator import wavefront as jwavefront
from izpi_tpu.ops import megakernel as jmega
from izpi_tpu.render import renderer as jrenderer
from izpi_tpu.scene import compiler as jcompiler
from izpi_tpu.scene import types as jst
from izpi_tpu.scene.library import REGISTRY as J_REGISTRY
from izpi_tpu_torch.core import rng as trng
from izpi_tpu_torch.integrator import path as tpath
from izpi_tpu_torch.integrator import wavefront as twavefront
from izpi_tpu_torch.ops import megakernel as tmega
from izpi_tpu_torch.render import renderer as trenderer
from izpi_tpu_torch.scene import compiler as tcompiler
from izpi_tpu_torch.scene import types as tst
from izpi_tpu_torch.scene.library import REGISTRY as T_REGISTRY
from izpi_tpu_torch.scene.library import misc as tmisc

NEW_SCENES = ("random_scene", "two_spheres", "two_perlin_spheres",
              "simple_light", "final", "texture_mapped_sphere", "environment",
              "pbr_ibl", "displacement_test")
SKY = (0.7, 0.8, 1.0)  # bench.py's background for Shirley's scenes
EAGER = ("two_perlin_spheres", "final")  # held to eager JAX (the docstring)
N, SPP, DEPTH = 16, 1, 3
RAYS_RTOL, PIXEL_ATOL, PIXEL_RTOL = 0.005, 1e-4, 1e-5
PIXEL_SHARE, MEAN_RTOL = 0.99, 0.005


def _t(a):
    return torch.as_tensor(np.array(a))


def _background(name):
    return SKY if name in ("random_scene", "two_spheres",
                           "two_perlin_spheres") else (0.0, 0.0, 0.0)


def test_registry_equals_jax():
    assert sorted(T_REGISTRY) == sorted(J_REGISTRY)
    assert len(T_REGISTRY) == 28


@pytest.mark.parametrize("name", NEW_SCENES)
def test_new_scene_compiles_as_jax(name):
    """Every leaf equal to the JAX compile: the image stack, the combined
    stack and its ids, the noise scales and Perlin tables, the media; and
    the meta facts."""
    tcs, tmeta = tcompiler.compile_scene(T_REGISTRY[name](1.0), "cpu")
    jcs, jmeta = jcompiler.compile_scene(J_REGISTRY[name](1.0))
    want, got = jax_leaves(jcs), port_leaves(tcs)
    for leaf in tcompiler.LEAVES:
        assert got[leaf].shape == want[leaf].shape, leaf
        np.testing.assert_array_equal(got[leaf], want[leaf], err_msg=leaf)
    for f in ("n_prims", "n_materials", "n_lights", "spectral", "exposure",
              "has_checker", "has_image", "has_noise", "has_pbr", "n_media",
              "media_is_sphere", "has_absorbing_dielectric",
              "placeholder_assets"):
        assert getattr(tmeta, f) == getattr(jmeta, f), f
    assert tmega.eligible(tcs, tmeta) == jmega.eligible(jcs, jmeta)


def test_from_jax_arrays_carries_every_leaf():
    """`final` (media, an image, noise, a moving sphere) and `pbr_ibl` (the
    combined stack) compiled by JAX, carried over: the port's leaves and
    meta, and a render of the carried scene equal to one of the port's
    own compile (the queue pool, brute force)."""
    s = tpath.RenderSettings(max_depth=3)
    for name in ("final", "pbr_ibl"):
        jcs, jmeta = jcompiler.compile_scene(J_REGISTRY[name](1.0))
        cs, meta = tcompiler.from_jax_arrays(jax_leaves(jcs), "cpu", jmeta)
        own_cs, own_meta = tcompiler.compile_scene(T_REGISTRY[name](1.0), "cpu")
        got, want = port_leaves(cs), port_leaves(own_cs)
        for leaf in tcompiler.LEAVES:
            np.testing.assert_array_equal(got[leaf], want[leaf], err_msg=leaf)
        assert meta == own_meta
        a, b = (twavefront.trace_pool(c, m, s, tpath.make_brute_intersector(c),
                                      4, 4, 1, trng.render_key(2), 16)
                for c, m in ((cs, meta), (own_cs, own_meta)))
        np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
        assert int(a[1]) == int(b[1]) > 16


@pytest.mark.parametrize("cap,evicted", [(2 * 256 * 512 * 32, 1), (1, 4)])
def test_combo_cap_evicts_as_jax(monkeypatch, cap, evicted):
    """Caps below pbr_ibl's padded stack (four slabs padded to the dome's
    256×512): slabs are evicted largest first, the dome's, and then, under a
    cap nothing fits, every one, to the combo ids of the JAX compile under
    IZPI_COMBO_BYTES_CAP."""
    monkeypatch.setattr(tcompiler, "COMBO_BYTES_CAP", cap)
    monkeypatch.setenv("IZPI_COMBO_BYTES_CAP", str(cap))
    tcs, _ = tcompiler.compile_scene(T_REGISTRY["pbr_ibl"](1.0), "cpu")
    jcs, _ = jcompiler.compile_scene(J_REGISTRY["pbr_ibl"](1.0))
    want, got = jax_leaves(jcs), port_leaves(tcs)
    for leaf in ("materials.combo_id", "textures.combined",
                 "textures.combo_w", "textures.combo_h"):
        assert got[leaf].shape == want[leaf].shape, leaf
        np.testing.assert_array_equal(got[leaf], want[leaf], err_msg=leaf)
    assert (got["materials.combo_id"] == -1).sum() == evicted


def _jax_reference(name):
    """The JAX render of `name` at the module's size (see the docstring)."""
    settings = jpath.RenderSettings(max_depth=DEPTH,
                                    background=_background(name))
    ctx = jrenderer.RenderContext(J_REGISTRY[name](1.0))
    if ctx.meta.n_prims <= jrenderer.BVH_THRESHOLD:
        ctx.intersect = jpath.make_brute_intersector(ctx.cs)
    if name in EAGER:
        with jax.disable_jit():
            res = jrenderer.render(None, N, N, SPP, settings=settings, seed=0,
                                   mode="simple", context=ctx)
        return res.image, res.rays_traced
    acc, rays = jax.jit(lambda k: jwavefront.trace_pool(
        ctx.cs, ctx.meta, settings, ctx.intersect, N, N, SPP, k, N * N * SPP,
        scheduler="queue", loop="while"))(jrng.render_key(0))
    img = (np.asarray(acc, np.float64) / SPP).reshape(N, N, 3)[::-1]
    return img, int(rays)


@pytest.mark.filterwarnings("ignore::UserWarning")
@pytest.mark.parametrize("name", NEW_SCENES)
def test_new_scene_renders_as_jax(name):
    want, w_rays = _jax_reference(name)
    ctx = trenderer.RenderContext(T_REGISTRY[name](1.0), device="cpu")
    assert ctx.mega_supported() == (name in ("random_scene", "two_spheres"))
    got = trenderer.render(None, N, N, SPP, tpath.RenderSettings(
        max_depth=DEPTH, background=_background(name)), seed=0, context=ctx,
        device="cpu")
    g, w = got.image.astype(np.float64), np.asarray(want, np.float64)
    assert np.isfinite(g).all() and g.mean() > 1e-3
    assert abs(got.rays_traced - w_rays) <= RAYS_RTOL * w_rays
    close = (np.abs(g - w) <= PIXEL_ATOL + PIXEL_RTOL * np.abs(w)).all(-1)
    assert close.mean() >= PIXEL_SHARE, close.mean()
    assert abs(g.mean() - w.mean()) <= MEAN_RTOL * abs(w.mean())


def _rays(jcs, n, seed, box):
    """Half camera rays, half from random points of `box` (lo, hi) in
    random directions."""
    rs = np.random.RandomState(seed)
    s, t = rs.rand(n).astype(np.float32), rs.rand(n).astype(np.float32)
    u = rs.rand(n, 3).astype(np.float32)
    o, d, tme = (np.array(x) for x in jcamera.get_rays(
        jcs.camera, jnp.asarray(s), jnp.asarray(t), jnp.asarray(u)))
    o[: n // 2] = rs.uniform(box[0], box[1], (n // 2, 3))
    d[: n // 2] = rs.normal(size=(n // 2, 3))
    return o.astype(np.float32), d.astype(np.float32), tme


def _state(n, seed, spectral):
    rs = np.random.RandomState(seed)
    keys = rs.randint(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32)
    depth = rs.randint(0, 4, n).astype(np.int32)
    shape = (n,) if spectral else (n, 3)
    thru = rs.uniform(0.2, 1.0, shape).astype(np.float32)
    rad = rs.uniform(0.0, 0.1, shape).astype(np.float32)
    active = rs.rand(n) < 0.9
    lam = rs.uniform(380.0, 750.0, n).astype(np.float32)
    return keys, depth, thru, rad, active, lam


class _Given:
    """An intersector that returns a fixed JAX hit record (as the port's
    tensors when `port`): both bounces start from the same surface hits,
    since the packages' sphere hits may differ in the last ulp."""

    def __init__(self, rec, port):
        self.rec = rec if not port else jprim.Hit(*(
            _t(x).long() if np.asarray(x).dtype == np.int32 else _t(x)
            for x in rec))

    def __call__(self, o, d, time, t_min, t_max):
        return self.rec


def _compare(got, want, active, media):
    w_o, w_d, w_thru, w_rad, w_active, w_n = (np.asarray(x) for x in want[:6])
    g_o, g_d, g_thru, g_rad, g_active, g_n = got[:6]
    np.testing.assert_array_equal(g_active.numpy(), w_active)
    assert int(g_n) == int(w_n) == int(active.sum())
    live = w_active
    np.testing.assert_allclose(g_o.numpy()[live], w_o[live], rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(g_d.numpy()[live], w_d[live], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(g_thru.numpy(), w_thru, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g_rad.numpy(), w_rad, rtol=1e-5, atol=1e-6)
    assert 0 < live.sum() < active.sum()


@pytest.mark.parametrize("name,box", [
    ("media", ((-4.0, 0.2, -3.0), (4.0, 4.0, 3.5))),
    ("pbr_ibl", ((-14.0, -5.0, -6.0), (14.0, 5.0, 6.0)))])
def test_bounce_rgb_matches_eager_jax(name, box):
    """One RGB bounce of 256 paths: a smoke ball, an image albedo, marble
    noise on PBR (`_media_scene`); `pbr_ibl`'s combined map stack and its
    image-lit dome (every NEE origin inside the dome's light sphere)."""
    if name == "media":
        jcs, jmeta = jcompiler.compile_scene(_media_scene(jst, None))
        tcs, tmeta = tcompiler.compile_scene(_media_scene(tst, None), "cpu")
    else:
        jcs, jmeta = jcompiler.compile_scene(J_REGISTRY[name](1.0))
        tcs, tmeta = tcompiler.compile_scene(T_REGISTRY[name](1.0), "cpu")
    n = N * N  # the renders' batch: eager JAX compiles each op once per shape
    o, d, tme = _rays(jcs, n, 21, box)
    keys, depth, thru, rad, active, _ = _state(n, 22, False)
    jrec = jprim.intersect_brute(jcs.prims, jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(tme), tpath.T_MIN, jprim.T_MAX)
    s_j = jpath.RenderSettings(max_depth=4)
    args = (o, d, tme, keys, depth, thru, rad, active)
    with jax.disable_jit():
        want = jpath.bounce_rgb(jcs, jmeta, s_j, _Given(jrec, False),
                                *(jnp.asarray(x) for x in args))
    got = tpath.bounce_rgb(tcs, tmeta, tpath.RenderSettings(max_depth=4),
                           _Given(jrec, True), _t(o), _t(d), _t(tme),
                           _t(keys.astype(np.int64)), _t(depth), _t(thru),
                           _t(rad), _t(active))
    _compare(got, want, active, tmeta.n_media)
    kinds = np.asarray(jcs.materials.kind)[np.asarray(jrec.mat_id)]
    assert (kinds == 5).sum() > 10  # PBR (the noise, or the maps)
    if name == "pbr_ibl":
        assert (kinds == 3).sum() > 10  # the dome


def _media_scene(st, spd):
    """A box with an image-albedo floor, a marble PBR sphere, a smoke ball
    in a glass sphere and a light. With `spd` (either package's
    spectral.spd) it is spectral: the floor a SpectralImage and the marble
    PBR without a spectrum, both uplifted from RGB, a Gaussian light and a
    tabulated background."""
    rs = np.random.RandomState(4)
    lam = tuple(np.arange(380.0, 751.0, 10.0))
    img = rs.rand(32, 48, 3)
    white = st.Lambertian(albedo=st.ConstantTexture((0.7, 0.7, 0.7)),
                          spectral_albedo=st.SpectralNeutral(0.7))
    painted = st.Lambertian(
        spectral_albedo=st.SpectralImage(data=img) if spd else None,
        albedo=None if spd else st.ImageTexture(data=img))
    marble = st.PBR(albedo=st.NoiseTexture(scale=2.0),
                    roughness=st.ConstantTexture((0.3, 0.3, 0.3)))
    ball = st.Sphere((1, 1.2, 0), (1, 1.2, 0), 0, 1, 0.9, st.Dielectric(1.5))
    light = (st.DiffuseLight(spectral_emit=st.SpectralGaussian(10.0, 560.0,
                                                               120.0))
             if spd else st.DiffuseLight(emit=st.ConstantTexture((8, 8, 8))))
    world = [
        st.XZRect(-5, 5, -5, 5, 0, painted), st.XYRect(-5, 5, 0, 6, 4, white),
        st.Sphere((-1.5, 1, 0), (-1.5, 1, 0), 0, 1, 1, marble), ball,
        st.ConstantMedium(boundary=ball, density=1.2, phase=st.Isotropic(
            albedo=st.ConstantTexture((0.8, 0.8, 0.8)))),
        st.FlipNormals(st.XZRect(-1, 1, -1, 1, 5, light)),
    ]
    cam = st.Camera(look_from=(0, 2.5, -8), look_at=(0, 1, 0), vfov=45)
    if not spd:
        return st.Scene(world=world, camera=cam)
    return st.Scene(world=world, camera=cam, spectral=True,
                    spectral_background=spd.SPD(np.array(lam), 0.05 + 0.1 * (
                        np.sin(np.array(lam) / 40.0) ** 2)))


@pytest.mark.filterwarnings("ignore:texture file")
@pytest.mark.parametrize("which", ["media_noise_image", "pbr_images"])
def test_bounce_spectral_matches_eager_jax(which):
    """One spectral bounce of 256 paths: a medium, noise and image
    albedos uplifted from RGB, and (`cornell_box_pbr_spectral`) PBR maps
    through the combined stack, uplifted automatically."""
    from izpi_tpu.spectral import spd as jspd
    from izpi_tpu_torch.spectral import spd as tspd

    if which == "pbr_images":
        jscene = J_REGISTRY["cornell_box_pbr_spectral"](1.0)
        tscene = T_REGISTRY["cornell_box_pbr_spectral"](1.0)
        box = ((1.0, 1.0, 1.0), (99.0, 99.0, 99.0))
    else:
        jscene, tscene = _media_scene(jst, jspd), _media_scene(tst, tspd)
        box = ((-4.0, 0.2, -3.0), (4.0, 4.0, 3.5))
    jcs, jmeta = jcompiler.compile_scene(jscene)
    tcs, tmeta = tcompiler.compile_scene(tscene, "cpu")
    assert tmeta.has_uplift and bool(tcs.materials.spec_albedo_uplift.any())
    n = N * N  # the renders' batch: eager JAX compiles each op once per shape
    o, d, tme = _rays(jcs, n, 23, box)
    keys, depth, thru, rad, active, lam = _state(n, 24, True)
    jrec = jprim.intersect_brute(jcs.prims, jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(tme), tpath.T_MIN, jprim.T_MAX)
    bg = jmeta.spectral_background_spd or 0
    args = (o, d, tme, lam, keys, depth, thru, rad, active)
    with jax.disable_jit():
        want = jpath.bounce_spectral(
            jcs, jmeta, jpath.RenderSettings(max_depth=4), _Given(jrec, False),
            *(jnp.asarray(x) for x in args), bg)
    got = tpath.bounce_spectral(
        tcs, tmeta, tpath.RenderSettings(max_depth=4), _Given(jrec, True),
        _t(o), _t(d), _t(tme), _t(lam), _t(keys.astype(np.int64)), _t(depth),
        _t(thru), _t(rad), _t(active), bg)
    _compare(got, want, active, tmeta.n_media)


def test_mega_mode_raises_on_a_pool_scene():
    """A scene with media, images or noise is not the megakernel's: the
    default mode takes the pool, mode="mega" raises."""
    ctx = trenderer.RenderContext(T_REGISTRY["simple_light"](1.0),
                                  device="cpu")
    assert not ctx.mega_supported()
    with pytest.raises(NotImplementedError, match="queue pool"):
        trenderer.render(None, 4, 4, 1, tpath.RenderSettings(max_depth=2),
                         mode="mega", context=ctx, device="cpu")


def test_misc_image_asset_raises_naming_a13(tmp_path, monkeypatch):
    """A real earth.png under IZPI_ASSET_DIR is read by the port's image
    reader and compiles to the JAX scene's leaves (the JAX package reads
    it through PIL); a file the reader cannot decode raises, naming the
    file, rather than standing the placeholder in."""
    from PIL import Image

    rs = np.random.RandomState(9)
    Image.fromarray(rs.randint(0, 256, (8, 16, 3)).astype(np.uint8)).save(
        tmp_path / "earth.png")
    monkeypatch.setenv("IZPI_ASSET_DIR", str(tmp_path))
    jcs, _ = jcompiler.compile_scene(J_REGISTRY["texture_mapped_sphere"](1.0))
    tcs, _ = tcompiler.compile_scene(tmisc.texture_mapped_sphere(), "cpu")
    got, want = port_leaves(tcs), jax_leaves(jcs)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    (tmp_path / "earth.png").write_bytes(b"\x89PNG\r\n")
    with pytest.raises(ValueError, match="earth.png"):
        tmisc.texture_mapped_sphere()
    (tmp_path / "decor_shop_4k.hdr").write_bytes(b"#?RADIANCE\n")
    with pytest.raises(ValueError, match="decor_shop_4k.hdr"):
        tmisc.pbr_ibl()
