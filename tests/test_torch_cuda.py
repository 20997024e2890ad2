"""izpi_tpu_torch's CUDA kernels vs their plain PyTorch versions, on a card.

These tests need an NVIDIA GPU (the `cuda` marker) and skip without one.
The file imports no JAX, so it runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest` skips tests/conftest.py, which sets JAX up for the other
test files.) The kernels build into build/izpi_tpu_torch/ at first use.
"""

import functools

import numpy as np
import pytest
import torch

from _torch_port import loop_step, with_absorbing_glass
from izpi_tpu_torch import camera, profiling
from izpi_tpu_torch.accel import traverse
from izpi_tpu_torch.core import loops, rng
from izpi_tpu_torch.geometry import primitives
from izpi_tpu_torch.integrator import path, wavefront
from izpi_tpu_torch.ops import _build, bvh_kernel, bvh_rowkernel, diff_trace
from izpi_tpu_torch.ops import megakernel, megakernel_spectral, table_grad
from izpi_tpu_torch.ops import threefry
from izpi_tpu_torch.render import renderer
from izpi_tpu_torch.scene import compiler
from izpi_tpu_torch.scene.library.cornell import cornell_box
from izpi_tpu_torch.scene.library.cornell_spectral import (
    cornell_box_pyramid_spectral)
from izpi_tpu_torch.scene.library.extracted import (
    cornell_box_pbr_stanford_dragon_spectral)
from izpi_tpu_torch.scene.library import get_scene
from izpi_tpu_torch.scene.library.misc import cornell_box_obj

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _keys(n, seed):
    rs = np.random.RandomState(seed)
    words = rs.randint(0, 2**32, (n, 2), dtype=np.uint64)
    words[::7] = 2**32 - 1  # wraparound
    return torch.as_tensor(words.astype(np.int64))


@pytest.mark.parametrize("n,salt", [(12, 0), (5, camera.CAMERA_SALT),
                                    (1, wavefront.LAMBDA_SALT),
                                    (2, path.MEDIA_SALT), (3, path.MEDIA_SALT)])
def test_device_cipher_bit_identical(n, salt):
    keys = _keys(1 << 14, 1)
    depths = torch.as_tensor(np.random.RandomState(2).randint(0, 2**32, 1 << 14,
                                                              dtype=np.uint64)
                             .astype(np.int64))
    before = threefry.launches
    got = threefry.uniforms_for_keys(keys.cuda(), depths.cuda(), n, salt).cpu()
    assert threefry.launches == before + 1
    want = threefry.uniforms_for_keys_reference(keys, depths, n, salt)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.numpy().view(np.uint32))


def _check_card_layout(mod, dev, n, spp):
    """The layouts of the cases below at which every thread of the
    persistent grid serves several slots (64×64@64), and besides every slot
    several samples (128×128@128: 64 replicas of two samples, as the main
    paths' slots serve 64)."""
    blocks, threads = megakernel.card_grid(mod.ENTRY, dev)
    _, spp_slot, n_slots = megakernel.slot_layout(
        n * n, spp, megakernel.card_min_slots(mod.ENTRY, dev))
    resident = blocks * threads
    if n >= 64 and spp >= 64:
        assert n_slots > resident and n_slots % resident != 0
    if n == 128:
        assert spp_slot > 1


@pytest.mark.parametrize("n,spp,depth,seed,offset", [
    (16, 4, 8, 3, 0),       # four replicas per pixel (1024 slots)
    (64, 64, 8, 5, 0),      # every thread several slots, a ragged last round
    (128, 128, 8, 7, 0),    # ... and every slot two samples
    (256, 2, 50, 0, 0),     # the main path's frame: two replicas per pixel
    (256, 2, 50, 0, 1022),  # ... and its last sample chunk
])
def test_kernel_matches_twin_on_card(n, spp, depth, seed, offset):
    """Cornell n×n at spp samples from `offset`, the plain twin on the
    card's layout. Ray counts within 0.5% and 99% of the pixels within
    1e-4: on the card torch divides by a Python scalar as a multiplication
    by its reciprocal (x / π, x / n_lights) where the kernel divides, and a
    last-ulp difference may flip a rare branch."""
    cs, meta = compiler.compile_scene(cornell_box(), "cuda")
    s = path.RenderSettings(max_depth=depth)
    key = rng.render_key(seed, device="cuda")
    _check_card_layout(megakernel, cs.device, n, spp)
    before = megakernel.launches
    got, g_rays = megakernel.render_slots(cs, meta, s, n, n, spp, key, offset)
    assert megakernel.launches == before + 1
    want, w_rays = megakernel.render_slots_reference(
        cs, meta, s, n, n, spp, key, offset,
        min_slots=megakernel.card_min_slots(megakernel.ENTRY, cs.device))
    torch.cuda.synchronize()
    assert abs(int(g_rays) - int(w_rays)) <= 0.005 * int(w_rays)
    close = ((got - want).abs().amax(dim=1) / spp) <= 1e-4
    assert close.float().mean().item() >= 0.99
    assert torch.isfinite(got).all()


def test_cuda_render_matches_cpu_render():
    """The CUDA kernel against the plain twin on the CPU, with the bounds of
    the kernel-vs-twin test above."""
    s = path.RenderSettings(max_depth=4)
    on_card = renderer.render(cornell_box(), 8, 8, 2, s, seed=3, device="cuda")
    on_cpu = renderer.render(cornell_box(), 8, 8, 2, s, seed=3, device="cpu")
    assert on_card.device == torch.cuda.get_device_name(0)
    assert abs(on_card.rays_traced - on_cpu.rays_traced) <= 0.005 * on_cpu.rays_traced
    close = np.abs(on_card.image - on_cpu.image).max(axis=2) <= 1e-4
    assert close.mean() >= 0.99


def test_wrapper_rejects_tables_on_another_device():
    cs, meta = compiler.compile_scene(cornell_box(), "cuda")
    cpu_tables = megakernel.pack_tables(compiler.compile_scene(cornell_box(),
                                                               "cpu")[0])
    with pytest.raises(ValueError, match="CUDA"):
        megakernel.render_slots(cs, meta, path.RenderSettings(), 4, 4, 1,
                                rng.render_key(0), tables=cpu_tables)


@pytest.mark.parametrize("n,spp,depth,seed,offset", [
    (16, 4, 50, 3, 0),      # four replicas per pixel (1024 slots)
    (64, 64, 8, 5, 0),      # every thread several slots, a ragged last round
    (128, 128, 8, 7, 0),    # ... and every slot two samples
    (500, 2, 50, 0, 0),     # the spectral main path's frame: two replicas
    (500, 2, 50, 0, 254),   # ... and its last sample chunk
])
def test_spectral_kernel_matches_plain_on_card(n, spp, depth, seed, offset):
    """The spectral pyramid n×n at spp samples from `offset`. Ray counts
    within 0.5%, 99% of the pixels with every XYZ channel within
    1e-4 + 1e-5·|plain| (XYZ reaches ~321 at the light, where an f32 ulp is
    ~3e-5) and mean Y within 0.5%: torch on the card divides by a Python
    scalar as a multiplication by its reciprocal where the kernel divides,
    which may flip a rare path."""
    cs, meta = compiler.compile_scene(cornell_box_pyramid_spectral(), "cuda")
    s = path.RenderSettings(max_depth=depth)
    key = rng.render_key(seed, device="cuda")
    _check_card_layout(megakernel_spectral, cs.device, n, spp)
    before = megakernel_spectral.launches
    got, g_rays = megakernel_spectral.render_slots_spectral(
        cs, meta, s, n, n, spp, key, offset)
    assert megakernel_spectral.launches == before + 1
    want, w_rays = megakernel_spectral.render_slots_spectral_reference(
        cs, meta, s, n, n, spp, key, offset,
        min_slots=megakernel.card_min_slots(megakernel_spectral.ENTRY,
                                            cs.device))
    torch.cuda.synchronize()
    assert abs(int(g_rays) - int(w_rays)) <= 0.005 * int(w_rays)
    close = ((got - want).abs() <= 1e-4 * spp + 1e-5 * want.abs()).all(dim=1)
    assert close.float().mean().item() >= 0.99
    assert abs(float(got[:, 1].mean()) / float(want[:, 1].mean()) - 1) <= 0.005
    assert torch.isfinite(got).all()


def _megakernel_case(spectral):
    """(module, wrapper, its plain version, scene) of one megakernel."""
    if spectral:
        return (megakernel_spectral, "render_slots_spectral",
                "render_slots_spectral_reference",
                cornell_box_pyramid_spectral())
    return megakernel, "render_slots", "render_slots_reference", cornell_box()


@pytest.mark.parametrize("spectral", [False, True])
def test_persistent_launches_are_deterministic(spectral):
    """256×256 at 64 spp, depth 16 (16 replicas, 1,048,576 slots of four
    samples: every thread takes several slots, in an order the scheduler
    picks): two launches give bit-identical sums and equal ray counts, the
    launch counter moves by one per call, and a third launch with the draw
    counter buffer changes neither and counts one to five pairs a
    scatter."""
    mod, name, _, scene = _megakernel_case(spectral)
    cs, meta = compiler.compile_scene(scene, "cuda")
    s = path.RenderSettings(max_depth=16)
    key = rng.render_key(9, device="cuda")
    outs = []
    for draws in (False, False, True):
        before = mod.launches
        outs.append(getattr(mod, name)(cs, meta, s, 256, 256, 64, key, 5,
                                       draws=draws))
        assert mod.launches == before + 1
    torch.cuda.synchronize()
    (a0, r0), (a1, r1), (a2, r2, (scatters, pairs)) = outs
    assert torch.equal(a0.view(torch.int32), a1.view(torch.int32))
    assert torch.equal(a0.view(torch.int32), a2.view(torch.int32))
    assert int(r0) == int(r1) == int(r2)
    assert 0 < int(scatters) < int(r0)
    assert int(scatters) <= int(pairs) <= 5 * int(scatters)


class _RefusingLibrary:
    """The built library, but its megakernel entries report a refused launch
    (cudaErrorLaunchOutOfResources) without launching."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        if name in ("izpi_megakernel_rgb", "izpi_megakernel_spectral",
                    "izpi_megakernel_rgb_bvh"):
            return lambda *args: 701
        return getattr(self._lib, name)


@pytest.mark.parametrize("spectral", [False, True])
def test_refused_launch_raises(spectral, monkeypatch):
    """A launch the runtime refuses raises, counts no launch and falls back
    to nothing: the plain version is not called."""
    mod, name, ref_name, scene = _megakernel_case(spectral)
    cs, meta = compiler.compile_scene(scene, "cuda")
    lib = _build.load()
    monkeypatch.setattr(_build, "load", lambda: _RefusingLibrary(lib))

    def no_fallback(*args, **kwargs):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(mod, ref_name, no_fallback)
    before = mod.launches
    with pytest.raises(RuntimeError, match="launch failed: CUDA error 701"):
        getattr(mod, name)(cs, meta, path.RenderSettings(max_depth=4), 8, 8, 2,
                           rng.render_key(0, device="cuda"))
    assert mod.launches == before


def test_cuda_spectral_render_matches_cpu_render():
    """The spectral pyramid through the CUDA kernel against the plain
    version on the CPU, with the bounds of the test above."""
    s = path.RenderSettings(max_depth=8)
    scene = cornell_box_pyramid_spectral()
    on_card = renderer.render(scene, 12, 12, 4, s, seed=3, device="cuda")
    on_cpu = renderer.render(scene, 12, 12, 4, s, seed=3, device="cpu")
    assert on_card.device == torch.cuda.get_device_name(0)
    assert abs(on_card.rays_traced - on_cpu.rays_traced) <= 0.005 * on_cpu.rays_traced
    close = (np.abs(on_card.xyz - on_cpu.xyz)
             <= 1e-4 + 1e-5 * np.abs(on_cpu.xyz)).all(axis=2)
    assert close.mean() >= 0.99
    assert np.isfinite(on_card.image).all()


@pytest.fixture(scope="module")
def obj_context():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return renderer.RenderContext(cornell_box_obj(), device="cuda")


@pytest.mark.parametrize("t_min,t_max", [(path.T_MIN, primitives.T_MAX),
                                         (0.0, 1000.0)])
def test_bvh_kernel_matches_plain_on_card(obj_context, t_min, t_max):
    """cornell_box_obj's tree, 4,096 rays: 2,048 camera rays and 2,048
    from their hit points in seeded random directions, some with a zero
    direction component. The kernel and its plain version visit the same
    nodes: equal hit masks, t and per-ray counts; primitives differ only on
    exact-t ties."""
    ks = obj_context.intersect.ks
    gen = torch.Generator(device="cuda").manual_seed(3)
    u = torch.rand((2048, 5), generator=gen, device="cuda")
    o, d, tme = camera.get_rays(obj_context.cs.camera, u[:, 0], u[:, 1], u[:, 2:5])
    t, idx = traverse.closest_bvh(ks.prims, ks.tree, o, d, tme, path.T_MIN,
                                  primitives.T_MAX)
    start = torch.where((idx >= 0)[:, None], o + t[:, None] * d, o)
    d2 = torch.randn((2048, 3), generator=gen, device="cuda")
    d2[:256, 0] = 0.0
    d2[256:512, 1] = 0.0
    o, d = torch.cat([o, start]).contiguous(), torch.cat([d, d2]).contiguous()
    tme = torch.cat([tme, tme]).contiguous()
    before = bvh_kernel.launches
    t_k, i_k, c_k = bvh_kernel.closest_hit(ks, o, d, tme, t_min, t_max,
                                           counts=True)
    assert bvh_kernel.launches == before + 1
    t_p, i_p, c_p = traverse.closest_bvh(ks.prims, ks.tree, o, d, tme, t_min,
                                         t_max, counts=True)
    hit = i_p >= 0
    assert 0.3 < hit.float().mean().item()
    assert torch.equal(i_k >= 0, hit)
    torch.testing.assert_close(t_k[hit], t_p[hit], rtol=1e-6, atol=0)
    assert torch.equal(c_k, c_p)
    assert int((hit & (i_k != i_p) & (t_k != t_p)).sum()) == 0


@pytest.mark.parametrize("n", [1, 37, 4096])
def test_bvh_kernel_small_and_parked_batches_on_card(obj_context, n):
    """Every batch size: one ray, a ragged warp, and 4,096 rays of which
    every third is parked outside the scene as the queue pool parks dead
    slots (one visit each) and the rest camera rays; hit masks and per-ray
    counts equal the plain version's (t within 1e-6 relative, primitives
    but on exact-t ties)."""
    ks = obj_context.intersect.ks
    gen = torch.Generator(device="cuda").manual_seed(n)
    u = torch.rand((n, 5), generator=gen, device="cuda")
    o, d, tme = camera.get_rays(obj_context.cs.camera, u[:, 0], u[:, 1],
                                u[:, 2:5])
    o = o.clone()
    o[::3] = path.PARK
    o, d, tme = o.contiguous(), d.contiguous(), tme.contiguous()
    t_k, i_k, c_k = bvh_kernel.closest_hit(ks, o, d, tme, path.T_MIN,
                                           primitives.T_MAX, counts=True)
    t_p, i_p, c_p = traverse.closest_bvh(ks.prims, ks.tree, o, d, tme,
                                         path.T_MIN, primitives.T_MAX,
                                         counts=True)
    hit = i_p >= 0
    assert torch.equal(i_k >= 0, hit) and torch.equal(c_k, c_p)
    torch.testing.assert_close(t_k[hit], t_p[hit], rtol=1e-6, atol=0)
    assert int((hit & (i_k != i_p) & (t_k != t_p)).sum()) == 0
    assert (c_k[::3, 0] == 1).all()


@pytest.mark.parametrize("mode", ["pool", "wavefront"])
def test_cuda_obj_render_matches_cpu_render(obj_context, mode):
    """cornell_box_obj 16x16 at 2 spp, on the card against the CPU, with
    the bounds of the kernel-vs-twin tests above: through the queue pool
    (mode "pool": on the card through the traversal kernel, one launch per
    pool body run; on the CPU through the plain traversal), and through
    the default route, the RGB megakernel's BVH form (one launch a render;
    its plain version on the CPU)."""
    s = path.RenderSettings(max_depth=8)
    before = bvh_kernel.launches, megakernel.bvh_launches
    on_card = renderer.render(None, 16, 16, 2, s, seed=3, mode=mode,
                              context=obj_context, device="cuda")
    on_cpu = renderer.render(cornell_box_obj(), 16, 16, 2, s, seed=3,
                             mode=mode, device="cpu")
    if mode == "pool":
        # One launch a pool body run: the iterations and any chunk's overrun.
        assert (bvh_kernel.launches - before[0],
                megakernel.bvh_launches - before[1]) == (on_card.trips, 0)
        assert 1 <= on_card.iterations <= on_card.trips
    else:
        assert (bvh_kernel.launches - before[0],
                megakernel.bvh_launches - before[1]) == (0, 1)
        assert on_card.iterations is None and on_card.trips is None
    assert abs(on_card.rays_traced - on_cpu.rays_traced) <= 0.005 * on_cpu.rays_traced
    close = np.abs(on_card.image - on_cpu.image).max(axis=2) <= 1e-4
    assert close.mean() >= 0.99
    assert np.isfinite(on_card.image).all()


def _card_rays(cs, n_half, seed):
    """n_half camera rays and n_half from their hit points (brute force) in
    seeded random directions, some with a zero direction component."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.rand((n_half, 5), generator=gen, device="cuda")
    o, d, tme = camera.get_rays(cs.camera, u[:, 0], u[:, 1], u[:, 2:5])
    t, idx = primitives.closest_brute(cs.prims, o, d, tme, path.T_MIN,
                                      primitives.T_MAX)
    start = torch.where((idx >= 0)[:, None], o + t[:, None] * d, o)
    d2 = torch.randn((n_half, 3), generator=gen, device="cuda")
    d2[: n_half // 8, 0] = 0.0
    d2[n_half // 8: n_half // 4, 1] = 0.0
    return (torch.cat([o, start]).contiguous(), torch.cat([d, d2]).contiguous(),
            torch.cat([tme, tme]).contiguous())


@pytest.mark.parametrize("t_min,t_max", [(path.T_MIN, primitives.T_MAX),
                                         (0.0, 1000.0)])
def test_rowstack_kernel_matches_plain_on_card(obj_context, t_min, t_max):
    """cornell_box_obj's leaf-64 tree, 4,096 rays (2,048 camera rays and
    2,048 incoherent ones, 4,096 = 128 warps) plus a ragged batch of 4,000:
    the kernel and its plain version walk the same rows, so hit masks,
    per-warp counters and block slots are equal and t is within 1e-6
    relative."""
    cs2, inter = bvh_rowkernel.attach(obj_context.cs)
    o, d, tme = _card_rays(cs2, 2048, 5)
    for n in (4096, 4000):
        before = bvh_rowkernel.launches
        t_k, i_k, c_k = bvh_rowkernel.closest_hit_rows(
            inter.rs, o[:n], d[:n], tme[:n], t_min, t_max, counters=True)
        assert bvh_rowkernel.launches == before + 1
        t_p, i_p, c_p = bvh_rowkernel.closest_rows(inter.rs, o[:n], d[:n],
                                                   tme[:n], t_min, t_max)
        hit = i_p >= 0
        assert 0.3 < hit.float().mean().item()
        assert torch.equal(i_k >= 0, hit)
        torch.testing.assert_close(t_k[hit], t_p[hit], rtol=1e-6, atol=0)
        assert torch.equal(c_k, c_p)
        assert int((hit & (i_k != i_p) & (t_k != t_p)).sum()) == 0


def test_cuda_dragon_render_matches_cpu_render():
    """The dragon at 2,000 stand-in triangles, 8x8 at 2 spp, depth 8,
    through the row-stack pair (a pool of 128 slots; one launch per pool
    iteration run) on the card and through
    its plain version on the CPU, with the bounds of the kernel-vs-twin
    tests above."""
    scene = cornell_box_pbr_stanford_dragon_spectral(n_tris=2000)
    s = path.RenderSettings(max_depth=8)
    out = {}
    for device in ("cuda", "cpu"):
        ctx = renderer.RenderContext(scene, use_bvh=False, device=device)
        ctx.cs, ctx.intersect = bvh_rowkernel.attach(ctx.cs)
        before = bvh_rowkernel.launches
        out[device] = renderer.render(None, 8, 8, 2, s, seed=3, context=ctx,
                                      device=device)
        launched = bvh_rowkernel.launches - before
        assert launched == (out[device].trips if device == "cuda" else 0)
    on_card, on_cpu = out["cuda"], out["cpu"]
    assert abs(on_card.rays_traced - on_cpu.rays_traced) <= 0.005 * on_cpu.rays_traced
    close = (np.abs(on_card.xyz - on_cpu.xyz)
             <= 1e-4 + 1e-5 * np.abs(on_cpu.xyz)).all(axis=2)
    assert close.mean() >= 0.99
    assert np.isfinite(on_card.image).all()


@pytest.mark.parametrize("name,depth,n,spp,seed", [
    ("pbr_ibl", 16, 16, 2, 4), ("two_perlin_spheres", 8, 16, 2, 4),
    ("final", 50, 64, 4, 0)])
def test_cuda_texture_scene_render_matches_cpu_render(name, depth, n, spp,
                                                      seed):
    """The pool on a scene with image maps and the dome (pbr_ibl), on one
    with Perlin noise, and on the book-2 final scene (media, an image,
    noise, a moving sphere), on the card and on the CPU, with the bounds
    above. Last-ulp differences between the two devices' libm and division
    turn a few of final's paths into others, so its rays' gap is noise that
    shrinks as the frame grows (at 16x16@2 it reached 0.51%; `measure_port.py
    --scene final --vs-cpu` measures it by seed and frame): it renders at
    64x64@4."""
    scene = get_scene(name)
    s = path.RenderSettings(max_depth=depth)
    out = {d: renderer.render(scene, n, n, spp, s, seed=seed, device=d)
           for d in ("cuda", "cpu")}
    on_card, on_cpu = out["cuda"], out["cpu"]
    assert abs(on_card.rays_traced - on_cpu.rays_traced) <= 0.005 * on_cpu.rays_traced
    close = (np.abs(on_card.image - on_cpu.image)
             <= 1e-4 + 1e-5 * np.abs(on_cpu.image)).all(axis=2)
    assert close.mean() >= 0.99
    assert np.isfinite(on_card.image).all()


def test_final_pool_through_kernel_matches_plain_traversal():
    """The book-2 final scene through the pool on the card, 16x16 at 2 spp,
    depth 50: the BVH4 kernel against the plain traversal on the same tree,
    both on the card, so the paths agree one for one: equal rays, every
    pixel within 1e-4 + 1e-5·|plain|."""
    ctx = renderer.RenderContext(get_scene("final"), device="cuda")
    plain = functools.partial(traverse.intersect_bvh, ctx.cs.prims,
                              ctx.intersect.ks.tree)
    s = path.RenderSettings(max_depth=50)
    key = rng.render_key(4, device="cuda")
    before = bvh_kernel.launches
    stats = {}
    got, g_rays, iters = wavefront.trace_pool(ctx.cs, ctx.meta, s,
                                              ctx.intersect, 16, 16, 2, key, 512,
                                              stats=stats)
    assert bvh_kernel.launches - before == stats["trips"] >= iters
    # The plain traversal compacts its rays (a host sync), so it runs in
    # the plain loop, which captures nothing.
    want, w_rays, _ = wavefront._trace_pool(ctx.cs, ctx.meta, s, plain, 16,
                                            16, 2, key, 512, False, 0, 0, 1,
                                            False)
    assert int(g_rays) == int(w_rays)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


# Training-step tolerances, tests/test_torch_grad.py's: loss within
# LOSS_RTOL, each gradient entry within GRAD_ATOL + GRAD_RTOL·|reference|.
LOSS_RTOL, GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-5, 1e-3


def _train_step(scene, n, depth, device, use_bvh=None, intersect=None,
                runner=None, route=None):
    """(loss, grads, rays, cipher launches, traversal launches, context) of
    one differentiable step, 1 spp, seed 0, against the render at 0.7×
    tex_c0 of a grey target (on the card: its first call, the warm-up and
    a replay of the captured graph, unless `runner` says otherwise), on
    `route` (`build_train_step`'s)."""
    from izpi_tpu_torch.parallel import dist

    ctx = renderer.RenderContext(scene, use_bvh=use_bvh, device=device)
    step = dist.build_train_step(ctx.cs, ctx.meta,
                                 path.RenderSettings(max_depth=depth),
                                 intersect or ctx.intersect, n, n,
                                 runner=runner, route=route)
    params = dist.extract_params(ctx.cs)
    with torch.no_grad():
        params["tex_c0"] *= 0.7
    ys = torch.arange(n, device=device).repeat_interleave(n)
    xs = torch.arange(n, device=device).repeat(n)
    target = torch.full((n * n, 3), 0.25, device=device)
    c0, b0 = threefry.launches, bvh_kernel.launches
    loss, grads = step(params, xs, ys, target, rng.render_key(0, device=device))
    return (float(loss), {k: g.cpu().numpy() for k, g in grads.items()},
            step.rays, threefry.launches - c0, bvh_kernel.launches - b0, ctx)


def _assert_step_close(got, want):
    assert got[2] == want[2]
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
    for k, w in want[1].items():
        assert np.isfinite(got[1][k]).all(), k
        np.testing.assert_allclose(got[1][k], w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)


@pytest.mark.parametrize("route", ["checkpoint", None])
def test_training_step_on_card_matches_cpu(route):
    """Phase 16 at 16², depth 8: the Cornell box's step on the card equals
    the step on the CPU, on each route: the checkpointed bounces, their
    draws through the cipher entry (forward and the backward's recompute),
    and the fused route (the default: `ops.diff_trace`'s two kernels, the
    cipher entry only for the camera)."""
    f0, b0 = diff_trace.fwd_launches, diff_trace.bwd_launches
    card = _train_step(cornell_box(), 16, 8, "cuda", route=route)
    cpu = _train_step(cornell_box(), 16, 8, "cpu", route=route)
    _assert_step_close(card, cpu)
    assert cpu[3] == 0
    if route == "checkpoint":
        assert card[3] > 1 + 8   # camera, bounces, recompute
        assert diff_trace.fwd_launches == f0
    else:
        assert card[3] == 2      # the camera's, warm-up and replay
        assert diff_trace.fwd_launches == f0 + 2
        assert diff_trace.bwd_launches == b0 + 2


@pytest.mark.parametrize("route", ["checkpoint", None])
def test_training_step_through_bvh_kernel_matches_plain_traversal(route):
    """Phase 17 at 16², depth 8: cornell_box_obj's step through the BVH4
    kernel (captured) equals the same step through the plain traversal on
    the card (eager: the plain traversal syncs, so it cannot be captured;
    rays and loss equal, gradients within the tolerances above: the plain
    traversal's winners' t may differ in the last ulp). On the checkpointed
    bounces the kernel ran forward and in the recompute; on the fused route
    (the default) the forward kernel's BVH form traverses, and the BVH4
    kernel runs no time."""
    f0 = diff_trace.fwd_launches
    kern = _train_step(cornell_box_obj(), 16, 8, "cuda", route=route)
    ctx = kern[5]
    plain = functools.partial(traverse.intersect_bvh, ctx.cs.prims,
                              ctx.intersect.ks.tree)
    b0 = bvh_kernel.launches
    ref = _train_step(cornell_box_obj(), 16, 8, "cuda", intersect=plain,
                      runner=loops.Eager())
    if route == "checkpoint":
        assert kern[4] >= 2 and kern[4] % 2 == 0
    else:
        assert kern[4] == 0 and diff_trace.fwd_launches >= f0 + 2
    _assert_step_close(kern, ref)
    assert ref[4] == bvh_kernel.launches - b0 == 0


def test_cli_on_card_writes_a_readable_file(tmp_path):
    """Phase 18 at 32²@8: the CLI's default scene and sampler on --device
    cuda (the spectral megakernel) writes a PNG and an EXR that read back;
    the PNG is the EXR's image after gamma 2 and clamp within one 8-bit
    step."""
    from izpi_tpu_torch import cli
    from izpi_tpu_torch.io import output

    args = ["-x", "32", "-y", "32", "--samples", "8", "--max-depth", "8",
            "--device", "cuda"]
    before = megakernel_spectral.launches
    assert cli.main(args + ["--output-file", str(tmp_path / "a.png")]) == 0
    assert cli.main(args + ["--output-mode", "exr", "--output-file",
                            str(tmp_path / "b.exr")]) == 0
    assert megakernel_spectral.launches == before + 2
    png = output.read_image(str(tmp_path / "a.png"))
    exr = output.read_image(str(tmp_path / "b.exr"))
    want = np.clip(np.sqrt(np.maximum(exr, 0.0)), 0.0, 1.0)
    assert np.abs(png - want).max() <= 1.0 / 255 + 1e-6


def _ws1_render(rank, n, size, spp, depth):
    """One rank of a world-size-1 group: cornell_box_obj through
    render_distributed (the pool and the BVH4 kernel)."""
    from izpi_tpu_torch.parallel import dist

    b0 = bvh_kernel.launches
    res = dist.render_distributed(cornell_box_obj(), size, size, spp,
                                  settings=path.RenderSettings(
                                      max_depth=depth), seed=0)
    return (res.image, res.rays_traced, bvh_kernel.launches - b0,
            __import__("torch").distributed.get_backend())


def test_world_size_1_nccl_render_matches_one_process():
    """D1 with NCCL at world size 1 (32²@4, depth 8): the rank renders as
    one process's pool does (mode "pool"; the default route of one process
    is the megakernel's BVH form, which D1 does not take), rays equal,
    every pixel within 1e-5·|b| + 1e-6, through the BVH4 kernel."""
    from izpi_tpu_torch.parallel import dist

    image, rays, launches, backend = dist.spawn(
        _ws1_render, 1, args=(32, 4, 8), timeout_s=300)[0]
    one = renderer.render(cornell_box_obj(), 32, 32, 4,
                          path.RenderSettings(max_depth=8), seed=0,
                          mode="pool", device="cuda")
    assert backend == "nccl" and launches > 0 and rays == one.rays_traced
    np.testing.assert_allclose(image, one.image, rtol=1e-5, atol=1e-6)


def _sharded_hits(rank, n, o, d, tm):
    """One rank of four gloo ranks on the card: cornell_box_obj's
    primitives sharded, each shard through its BVH4 and the kernel."""
    from izpi_tpu_torch.parallel import dist

    cs, _ = compiler.compile_scene(cornell_box_obj(), "cpu")
    local, intersect = dist.make_sharded_intersector(cs, device="cuda")
    b0 = bvh_kernel.launches
    rec = intersect(*(torch.as_tensor(a, device="cuda") for a in (o, d, tm)),
                    path.T_MIN, primitives.T_MAX)
    return ({k: v.cpu().numpy() for k, v in rec._asdict().items()},
            bvh_kernel.launches - b0, local.bounds.shape[0])


def test_prim_sharded_bvh_kernel_matches_replicated():
    """Four gloo ranks sharing the card, each holding a quarter of
    cornell_box_obj's 20,007 primitives with its own BVH4 through the
    kernel: the reduced closest hits equal the replicated kernel's on 4096
    rays from the camera and from inside the box (equal hit masks,
    materials and global primitives but on exact-t ties, t within 1e-6
    relative)."""
    from izpi_tpu_torch.parallel import dist

    rs = np.random.RandomState(3)
    o = np.concatenate([np.tile([[278.0, 278.0, -800.0]], (2048, 1)),
                        rs.uniform(50, 500, (2048, 3))]).astype(np.float32)
    d = np.concatenate([rs.normal([0, 0, 1], 0.25, (2048, 3)),
                        rs.normal(0, 1, (2048, 3))]).astype(np.float32)
    tm = np.zeros(4096, np.float32)
    out = dist.spawn(_sharded_hits, 4, args=(o, d, tm), timeout_s=300)
    cs, _ = compiler.compile_scene(cornell_box_obj(), "cpu")
    arrays = traverse.build(cs.prims)
    cs2 = cs._replace(prims=traverse.reorder_prims(cs.prims,
                                                   arrays.prim_order))
    ks = bvh_kernel.pack_tables(
        primitives.Prims(*[f.cuda() for f in cs2.prims]),
        traverse.upload(arrays, "cuda"))
    t, idx = bvh_kernel.closest_hit(ks, *(torch.as_tensor(a, device="cuda")
                                          for a in (o, d, tm)),
                                    path.T_MIN, primitives.T_MAX)
    t, idx = t.cpu().numpy(), idx.cpu().numpy()
    hit = idx >= 0
    gidx = np.where(hit, np.asarray(arrays.prim_order)[np.maximum(idx, 0)],
                    -1)
    mat = np.where(hit, cs.prims.mat_id.numpy()[np.maximum(gidx, 0)], -1)
    for rec, launches, nodes in out:
        assert launches == 1 and nodes > 1
        np.testing.assert_array_equal(rec["hit"], hit)
        np.testing.assert_allclose(rec["t"][hit], t[hit], rtol=1e-6)
        np.testing.assert_array_equal(rec["mat_id"], mat)
        assert (rec["prim_idx"] != gidx).mean() <= 1e-3  # exact-t ties
    assert hit.mean() > 0.5


# ---- the pool's loop on the card: chunks replayed from a CUDA graph ----

# The graphed pool against the plain loop: the same paths, deposited by
# `index_add_`'s atomics in another order.
GRAPH_ATOL, GRAPH_RTOL = 1e-6, 1e-5


def _plain_pool(ctx, s, n, spp, key, pool, spectral=False):
    """The plain version of the pool's loop: the same body, the end tested
    after every iteration, no graph."""
    return wavefront._trace_pool(ctx.cs, ctx.meta, s, ctx.intersect, n, n,
                                 spp, key, pool, spectral,
                                 ctx.meta.spectral_background_spd or 0, 0, 1,
                                 False)


def test_graphed_pool_matches_plain_loop(obj_context):
    """cornell_box_obj 32x32 at 4 spp, depth 50, a pool of a quarter of the
    samples: through `trace_pool` (its chunk, captured) and at a chunk of
    3, captured, against the plain loop: rays and iterations equal, every
    pixel within 1e-6 + 1e-5·|plain|, one traversal launch a body run."""
    s = path.RenderSettings(max_depth=50)
    key = rng.render_key(0, device="cuda")
    want, w_rays, w_its = _plain_pool(obj_context, s, 32, 4, key, 1024)
    for chunk in (None, 3):
        stats, before = {}, bvh_kernel.launches
        if chunk is None:
            got, rays, its = wavefront.trace_pool(
                obj_context.cs, obj_context.meta, s, obj_context.intersect,
                32, 32, 4, key, 1024, stats=stats)
        else:
            got, rays, its = wavefront._trace_pool(
                obj_context.cs, obj_context.meta, s, obj_context.intersect,
                32, 32, 4, key, 1024, False, 0, 0, chunk, True, stats=stats)
        assert stats["replays"] == stats["trips"] - 1  # one warm-up body
        assert bvh_kernel.launches - before == stats["trips"]
        assert its <= stats["trips"] < its + stats["chunk"]
        assert (int(rays), its) == (int(w_rays), w_its)
        torch.testing.assert_close(got, want, atol=GRAPH_ATOL, rtol=GRAPH_RTOL)


def test_second_render_replays_without_capture():
    """A second render on the same context, with another seed, replays the
    graph the first captured: no capture, every body a replay, and the
    image of the plain loop at that seed (the key is a device scalar in the
    graph)."""
    ctx = renderer.RenderContext(cornell_box_obj(), device="cuda")
    s = path.RenderSettings(max_depth=8)
    first = renderer.render(None, 16, 16, 4, s, seed=0, mode="pool",
                            context=ctx, device="cuda")
    assert first.capture_seconds > 0 and len(ctx.graphs) == 1
    assert first.replays == first.trips - 1
    graph = next(iter(ctx.graphs.values()))[0].graph
    before = bvh_kernel.launches
    second = renderer.render(None, 16, 16, 4, s, seed=1, mode="pool",
                             context=ctx, device="cuda")
    assert second.capture_seconds == 0 and second.replays == second.trips
    assert bvh_kernel.launches - before == second.trips
    assert len(ctx.graphs) == 1
    assert next(iter(ctx.graphs.values()))[0].graph is graph
    want, rays, its = _plain_pool(ctx, s, 16, 4, rng.render_key(1, "cuda"),
                                  1024)
    assert (second.rays_traced, second.iterations) == (int(rays), its)
    img = (want.cpu().numpy().astype(np.float64) / 4).reshape(16, 16, 3)[::-1]
    np.testing.assert_allclose(second.image, img, atol=GRAPH_ATOL,
                               rtol=GRAPH_RTOL)


def test_render_of_another_frame_replaces_the_kept_graph():
    """A context keeps one graph: a render of another frame captures anew
    and its graph takes the first's place, and a render of the first frame
    after it captures again."""
    ctx = renderer.RenderContext(cornell_box_obj(), device="cuda")
    s = path.RenderSettings(max_depth=8)
    graphs = []
    for n in (16, 24, 16):
        res = renderer.render(None, n, n, 4, s, seed=0, mode="pool",
                              context=ctx, device="cuda")
        assert res.capture_seconds > 0 and len(ctx.graphs) == 1
        runner = next(iter(ctx.graphs.values()))[0]
        assert runner.capture_bytes > 0
        graphs.append(runner)
    assert graphs[0] is not graphs[1] and graphs[1] is not graphs[2]


def test_kept_graph_reads_each_calls_key(obj_context):
    """A kept graph replayed with another base key, sample offset and
    sample count (both keys alive, so the second cannot take the first's
    memory) renders what the plain loop renders with them."""
    s = path.RenderSettings(max_depth=8)
    graphs = {}
    keys = [rng.render_key(seed, device="cuda") for seed in (5, 6)]
    wavefront.trace_pool(obj_context.cs, obj_context.meta, s,
                         obj_context.intersect, 16, 16, 4, keys[0], 256,
                         graphs=graphs)
    stats = {}
    got, rays, its = wavefront.trace_pool(
        obj_context.cs, obj_context.meta, s, obj_context.intersect, 16, 16, 2,
        keys[1], 256, sample_offset=3, graphs=graphs, stats=stats)
    assert stats["capture_seconds"] == 0 and stats["replays"] == stats["trips"]
    want, w_rays, w_its = wavefront._trace_pool(
        obj_context.cs, obj_context.meta, s, obj_context.intersect, 16, 16, 2,
        keys[1], 256, False, 0, 3, 1, False)
    assert (int(rays), its) == (int(w_rays), w_its)
    torch.testing.assert_close(got, want, atol=GRAPH_ATOL, rtol=GRAPH_RTOL)


@pytest.mark.parametrize("name", ["cornell_box_obj", "final", "pbr_ibl",
                                  "cornell_box_water_spectral"])
def test_pool_iteration_makes_no_host_sync(name):
    """One pool iteration, eagerly and replayed from its CUDA graph, under
    `torch.cuda.set_sync_debug_mode("error")`: nothing in it syncs with the
    host."""
    scene = cornell_box_obj() if name == "cornell_box_obj" else get_scene(name)
    ctx = renderer.RenderContext(scene, device="cuda")
    body, st = wavefront._pool(
        ctx.cs, ctx.meta, path.RenderSettings(max_depth=16), ctx.intersect,
        16, 16, 2, rng.render_key(0, device="cuda"), 128, ctx.meta.spectral,
        ctx.meta.spectral_background_spd or 0, 0)
    runner = loops.Graphed()
    st = runner.run(body, st, 2)  # the warm-up body, the capture, a replay
    spare = {k: v.clone() for k, v in st.items()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        body(spare)
        runner.run(body, st, 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert runner.replays == 2


def test_new_sample_form_bit_identical():
    """The cipher entry's new-sample form on 1M (pixel, sample) pairs: path
    keys, camera and λ uniforms equal to the PyTorch cipher's bit for bit,
    per-ray and one-sample ids, one launch a call."""
    rs = np.random.RandomState(5)
    n = 1 << 20
    base = rng.render_key(2**40 + 17, device="cuda")
    pix = torch.as_tensor(rs.randint(0, 1 << 22, n).astype(np.int64),
                          device="cuda")
    sid = torch.as_tensor(rs.randint(0, 2**32, n, dtype=np.uint64)
                          .astype(np.int64), device="cuda")
    for samples in (sid, 1023):
        for salts in ((), (camera.CAMERA_SALT,),
                      (camera.CAMERA_SALT, wavefront.LAMBDA_SALT)):
            before = threefry.launches
            got = threefry.new_samples(base, pix, samples, *salts)
            assert threefry.launches == before + 1
            want = threefry.new_samples_reference(base, pix, samples, *salts)
            for g, w in zip(got, want):
                assert (g is None) == (w is None)
                if g is not None:
                    assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def test_path_keys_one_launch_no_torch_cipher(monkeypatch):
    """On the card `rng.path_keys_perray` and `rng.path_keys` are one launch
    of the cipher entry each, and run no op of the PyTorch cipher."""
    calls = []
    cipher = threefry.threefry2x32

    def counted(*args):
        calls.append(1)
        return cipher(*args)

    pix = torch.arange(4096, device="cuda") * 3
    sid = torch.arange(4096, device="cuda") % 7
    base = rng.render_key(3, device="cuda")
    want = (threefry.path_keys_reference(base, pix, sid),
            threefry.path_keys_reference(base, pix, 5))
    monkeypatch.setattr(threefry, "threefry2x32", counted)
    before = threefry.launches
    got = (rng.path_keys_perray(base, pix, sid), rng.path_keys(base, pix, 5))
    assert threefry.launches == before + 2 and calls == []
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---- the RGB megakernel's BVH form ----


@pytest.fixture(scope="module")
def absorbing_obj_context():
    """cornell_box_obj with its glass sphere absorbing: refraction into it
    runs the Beer–Lambert exit re-trace through the tree."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return renderer.RenderContext(with_absorbing_glass(cornell_box_obj()),
                                  device="cuda")


@pytest.mark.parametrize("scene", ["obj", "obj_absorbing"])
@pytest.mark.parametrize("n,spp,depth,seed", [
    (16, 2, 8, 3),     # the CPU tests' frame
    (64, 64, 8, 5),    # every thread several slots, a ragged last round
])
def test_bvh_form_matches_plain_on_card(request, n, spp, depth, seed, scene):
    """cornell_box_obj (and with its glass absorbing) through
    `izpi_megakernel_rgb_bvh` against its plain version
    (`render_slots_reference` through the plain BVH4 traversal) on the
    card's layout, both on the card: equal rays, 99% of the pixels within
    1e-4 (the kernel-vs-twin bounds), one launch, and the launch's
    traversal counts (nodes popped, primitives tested) at least one node a
    ray."""
    obj_context = request.getfixturevalue(
        "absorbing_obj_context" if scene == "obj_absorbing" else "obj_context")
    ks = obj_context.mega_bvh()
    assert ks is obj_context.intersect.ks
    s = path.RenderSettings(max_depth=depth)
    key = rng.render_key(seed, device="cuda")
    before = megakernel.bvh_launches, megakernel.launches, bvh_kernel.launches
    got, g_rays, _, trav = megakernel.render_slots(
        obj_context.cs, obj_context.meta, s, n, n, spp, key, bvh=ks,
        draws=True)
    assert (megakernel.bvh_launches - before[0], megakernel.launches
            - before[1], bvh_kernel.launches - before[2]) == (1, 0, 0)
    want, w_rays = megakernel.render_slots_reference(
        obj_context.cs, obj_context.meta, s, n, n, spp, key,
        min_slots=megakernel.card_min_slots(megakernel.ENTRY_BVH,
                                            obj_context.device),
        intersect=megakernel.bvh_plain_intersector(ks))
    torch.cuda.synchronize()
    assert int(g_rays) == int(w_rays)
    close = ((got - want).abs().amax(dim=1) / spp) <= 1e-4
    assert close.float().mean().item() >= 0.99
    assert torch.isfinite(got).all()
    nodes, tests = (int(x) for x in trav.sum(dim=0))
    assert int(g_rays) <= nodes and 0 < tests


@pytest.mark.parametrize("scene", ["obj", "obj_absorbing"])
def test_bvh_form_traversal_counts_equal_plain(request, scene):
    """Each slot's (nodes popped, primitives tested) of the BVH form at
    64×64@2, depth 8, equals its plain version's on the card's layout (the
    plain traversal counted per slot): the warp's schedule changes when a
    lane traverses, not what it visits; with absorbing glass the exit
    re-traces are counted too. The probe instance renders the same bits,
    rays and counts."""
    ctx = request.getfixturevalue(
        "absorbing_obj_context" if scene == "obj_absorbing" else "obj_context")
    ks = ctx.mega_bvh()
    s = path.RenderSettings(max_depth=8)
    key = rng.render_key(4, device="cuda")
    got, g_rays, _, trav = megakernel.render_slots(
        ctx.cs, ctx.meta, s, 64, 64, 2, key, bvh=ks, draws=True)
    counts = torch.zeros_like(trav)
    _, w_rays = megakernel.render_slots_reference(
        ctx.cs, ctx.meta, s, 64, 64, 2, key,
        min_slots=megakernel.card_min_slots(megakernel.ENTRY_BVH,
                                            ctx.device),
        intersect=megakernel.bvh_plain_intersector(ks, counts))
    (p_acc, p_rays, _, p_trav), probe = megakernel.probe_bvh(
        ctx.cs, ctx.meta, s, 64, 64, 2, key, bvh=ks)
    torch.cuda.synchronize()
    assert int(g_rays) == int(w_rays) == int(p_rays)
    assert torch.equal(trav, counts) and torch.equal(p_trav, trav)
    assert torch.equal(p_acc.view(torch.int32), got.view(torch.int32))
    assert 0 < probe["use_visits"] <= 1 and 0 < probe["use_tests"] <= 1
    assert probe["visits"] == int(trav[:, 0].sum())


def test_bvh_form_launches_are_deterministic(obj_context):
    """Two launches of the BVH form (64×64@16, depth 16) give the same bits
    and rays; one with the draw and traversal counter buffers changes
    neither."""
    s = path.RenderSettings(max_depth=16)
    key = rng.render_key(2, device="cuda")
    ks = obj_context.mega_bvh()
    outs = [megakernel.render_slots(obj_context.cs, obj_context.meta, s, 64,
                                    64, 16, key, bvh=ks, draws=t)
            for t in (False, False, True)]
    torch.cuda.synchronize()
    for acc, rays, *_ in outs[1:]:
        assert torch.equal(acc.view(torch.int32), outs[0][0].view(torch.int32))
        assert int(rays) == int(outs[0][1])


def test_brute_form_unchanged_by_the_bvh_form():
    """The Cornell box keeps the brute-force kernel on the default route
    (13 primitives, no BVH), and on a context with a BVH (use_bvh=True,
    the same primitives in tree order) the brute-force kernel and the BVH
    form render the same bits: the two share every line of the loop but
    the closest hit."""
    s = path.RenderSettings(max_depth=8)
    before = megakernel.launches, megakernel.bvh_launches
    renderer.render(cornell_box(), 16, 16, 2, s, seed=3, device="cuda")
    assert (megakernel.launches - before[0],
            megakernel.bvh_launches - before[1]) == (1, 0)
    ctx = renderer.RenderContext(cornell_box(), use_bvh=True, device="cuda")
    key = rng.render_key(3, device="cuda")
    brute, b_rays = megakernel.render_slots(ctx.cs, ctx.meta, s, 16, 16, 2,
                                            key, tables=ctx.tables())
    bvh, v_rays = megakernel.render_slots(ctx.cs, ctx.meta, s, 16, 16, 2,
                                          key, tables=ctx.tables(),
                                          bvh=ctx.mega_bvh())
    assert int(b_rays) == int(v_rays)
    assert torch.equal(brute.view(torch.int32), bvh.view(torch.int32))


def test_graphed_pool_repeats_bit_for_bit():
    """The pool's deposit is a segment sum in an order the slots fix, not
    float atomics: `final` 32×32@4 (depth 50: media, an image, noise)
    rendered twice through the graphed pool gives the same bits."""
    ctx = renderer.RenderContext(get_scene("final"), device="cuda")
    s = path.RenderSettings(max_depth=50)
    runs = [renderer.render(None, 32, 32, 4, s, seed=0, mode="pool",
                            context=ctx, device="cuda") for _ in range(2)]
    assert runs[1].capture_seconds == 0 and runs[1].replays == runs[1].trips
    assert runs[0].rays_traced == runs[1].rays_traced
    assert np.array_equal(runs[0].image.view(np.int32),
                          runs[1].image.view(np.int32))


def test_bvh_form_refused_launch_raises(obj_context, monkeypatch):
    """A BVH-form launch the runtime refuses raises and counts no launch;
    neither the plain version nor the pool runs in its place."""
    lib = _build.load()
    monkeypatch.setattr(_build, "load", lambda: _RefusingLibrary(lib))

    def no_fallback(*args, **kwargs):
        raise AssertionError("fell back")

    monkeypatch.setattr(megakernel, "render_slots_reference", no_fallback)
    monkeypatch.setattr(wavefront, "trace_pool", no_fallback)
    before = megakernel.bvh_launches
    with pytest.raises(RuntimeError, match="izpi_megakernel_rgb_bvh launch "
                                           "failed: CUDA error 701"):
        renderer.render(None, 8, 8, 2, path.RenderSettings(max_depth=4),
                        context=obj_context, device="cuda")
    assert megakernel.bvh_launches == before


def _step_and_inputs(ctx, n, depth, runner=None, intersect=None,
                     route=None, spp=1):
    """A training step on the card context's scene (spp samples a pixel, 1
    by default, seed 0, 0.7× tex_c0 against a grey target) and its
    arguments."""
    from izpi_tpu_torch.parallel import dist

    step = dist.build_train_step(ctx.cs, ctx.meta,
                                 path.RenderSettings(max_depth=depth),
                                 intersect or ctx.intersect, n, n, spp=spp,
                                 runner=runner, route=route)
    params = dist.extract_params(ctx.cs)
    with torch.no_grad():
        params["tex_c0"] *= 0.7
    ys = torch.arange(n, device="cuda").repeat_interleave(n)
    xs = torch.arange(n, device="cuda").repeat(n)
    target = torch.full((n * n, 3), 0.25, device="cuda")
    return step, (params, xs, ys, target, rng.render_key(0, device="cuda"))


@pytest.mark.parametrize("route", ["checkpoint", None])
@pytest.mark.parametrize("name,n", [("cornell_box", 32),
                                    ("cornell_box_obj", 16)])
def test_captured_step_matches_eager_step(name, n, route):
    """Depth 8: the step as one CUDA graph (the default on the card)
    against the same step run eagerly: rays equal, loss and gradients
    within the tolerances above (the same kernels; only the order of
    PyTorch's own float reductions may differ). On the checkpointed
    bounces a replay launches the cipher entry 9 times forward and 8 in
    the recompute, the BVH4 kernel 8 + 8 on cornell_box_obj, and the
    gathers' backward kernel; on the fused route (the default) the cipher
    entry once (the camera), the forward and reverse kernels once each
    (the reverse sums the table gradient itself), G and the BVH4 kernel no
    time."""
    ctx = renderer.RenderContext(
        cornell_box() if name == "cornell_box" else cornell_box_obj(),
        device="cuda")
    graphed, args = _step_and_inputs(ctx, n, 8, route=route)
    eager, _ = _step_and_inputs(ctx, n, 8, runner=loops.Eager(), route=route)
    assert isinstance(graphed.runner, loops.Graphed)
    tg0, b0 = table_grad.launches, diff_trace.bwd_launches
    loss_e, grads_e = eager(*args)
    if route == "checkpoint":
        assert table_grad.launches > tg0
    else:
        assert table_grad.launches == tg0 and diff_trace.bwd_launches == b0 + 1
    loss_g, grads_g = graphed(*args)
    runner = graphed.runner
    assert runner.capture_seconds > 0 and runner.capture_bytes > 0
    assert runner.replays == 1 and runner.trips == 2
    assert graphed.rays == eager.rays > n * n
    np.testing.assert_allclose(float(loss_g), float(loss_e), rtol=LOSS_RTOL)
    for k, w in grads_e.items():
        assert torch.isfinite(grads_g[k]).all(), k
        np.testing.assert_allclose(grads_g[k].cpu().numpy(), w.cpu().numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)
    deltas = {(m, a): v for (m, a), v in runner.deltas.items()}
    if route == "checkpoint":
        assert deltas[("threefry", "launches")] == 9 + 8
        assert deltas[("bvh_kernel", "launches")] == (
            16 if name == "cornell_box_obj" else 0)
        assert deltas[("table_grad", "launches")] >= 2
        assert deltas[("diff_trace", "fwd_launches")] == 0
        assert deltas[("diff_trace", "fwd_passes")] == 0
    else:
        assert deltas[("threefry", "launches")] == 1
        assert deltas[("bvh_kernel", "launches")] == 0
        assert deltas[("table_grad", "launches")] == 0
        assert deltas[("diff_trace", "fwd_launches")] == 1
        assert deltas[("diff_trace", "bwd_launches")] == 1
        assert deltas[("diff_trace", "fwd_passes")] == 1


def test_captured_step_replays_bit_for_bit():
    """Two replays of the captured step give the same bits; a third, with
    other parameters, writes nothing the caller already holds (the loss
    and gradients returned are clones)."""
    ctx = renderer.RenderContext(cornell_box(), device="cuda")
    step, (params, xs, ys, target, key) = _step_and_inputs(ctx, 32, 8)
    loss1, grads1 = step(params, xs, ys, target, key)
    loss2, grads2 = step(params, xs, ys, target, key)
    assert torch.equal(loss1, loss2)
    for k in grads1:
        assert torch.equal(grads1[k], grads2[k]), k
    kept = (loss1.clone(), {k: g.clone() for k, g in grads1.items()})
    other = {k: p.detach() * 0.5 for k, p in params.items()}
    loss3, grads3 = step(other, xs, ys, target, key)
    assert not torch.equal(loss3, loss1)
    assert torch.equal(loss1, kept[0])
    for k in grads1:
        assert torch.equal(grads1[k], kept[1][k]), k
    assert step.runner.replays == 3 and step.runner.trips == 4


def test_captured_step_reads_each_calls_key():
    """A replay with another key (both keys alive) gives what the eager
    step gives with it: the key is one of the graph's static inputs."""
    ctx = renderer.RenderContext(cornell_box(), device="cuda")
    step, (params, xs, ys, target, key) = _step_and_inputs(ctx, 16, 8)
    eager, _ = _step_and_inputs(ctx, 16, 8, runner=loops.Eager())
    step(params, xs, ys, target, key)
    other = rng.render_key(7, device="cuda")
    loss, _ = step(params, xs, ys, target, other)
    want, _ = eager(params, xs, ys, target, other)
    assert step.rays == eager.rays
    np.testing.assert_allclose(float(loss), float(want), rtol=LOSS_RTOL)


# Table shapes of the step's gathers (Cornell's materials and texture
# rows, a spectral scene's SPD table, an image stack) at the step's 65,536
# rays: (table shape, index tensors).
TABLE_GRAD_CASES = [((9,), 1), ((9, 3), 1), ((8, 3), 1), ((6, 371), 2),
                    ((2, 512, 512, 3), 3)]


@pytest.mark.parametrize("shape,n_index", TABLE_GRAD_CASES)
def test_table_grad_kernel_matches_plain_on_card(shape, n_index):
    """`izpi_table_grad` against the float64 sum (the fixed point's bound,
    csrc/table_grad.cu) and its plain version (`index_put_`, within the
    f32 recursive-summation bound γ_count·Σ|g| of each element); two
    launches, and the rows in another order, give the same bits."""
    rs = np.random.RandomState(len(shape))
    n = 65536
    index = [torch.as_tensor(np.where(rs.rand(n) < 0.7,
                                      rs.randint(0, min(d, 3), n),
                                      rs.randint(0, d, n))).cuda()
             for d in shape[:n_index]]
    c = int(np.prod(shape[n_index:]))
    g = torch.as_tensor(rs.randn(n, c).astype(np.float32)).cuda()
    rows = table_grad.flat_rows(shape, index).reshape(-1).contiguous()
    before = table_grad.launches
    got = table_grad.table_grad(rows, g, shape)
    again = table_grad.table_grad(rows, g, shape)
    perm = torch.as_tensor(rs.permutation(n)).cuda()
    permuted = table_grad.table_grad(rows[perm].contiguous(),
                                     g[perm].contiguous(), shape)
    assert table_grad.launches == before + 3
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert torch.equal(got.view(torch.int32), permuted.view(torch.int32))
    plain = table_grad.table_grad_reference(rows, g, shape)
    r = int(np.prod(shape)) // c

    def summed(x):
        out = torch.zeros((r, c), dtype=x.dtype, device="cuda")
        return out.index_put_((rows,), x, accumulate=True).reshape(shape)

    exact = summed(g.double())
    abs_sum = summed(g.abs().double())
    count = summed(torch.ones_like(g, dtype=torch.float64))
    bound = n * n * float(g.abs().max()) * 2.0 ** -63 + exact.abs() * 2.0 ** -24
    assert ((got.double() - exact).abs() <= bound).all()
    gamma = count * 2.0 ** -24 / (1 - count * 2.0 ** -24)
    assert ((got.double() - plain.double()).abs()
            <= bound + gamma * abs_sum).all()


@pytest.mark.parametrize("shape,n_index", [((8, 3), 1), ((2, 512, 512, 3), 3)])
def test_table_grad_counted_rows_on_card(shape, n_index):
    """With its row count in device memory (`reverse_reference`'s slots on
    the card: a buffer sized for every slot and the rows it wrote),
    `izpi_table_grad` adds the first count rows alone, on both paths: the
    same bits as the kernel given those rows alone, with rows out of range
    and NaN cotangents past the count, and inside a CUDA graph whose count
    changes between replays."""
    rs = np.random.RandomState(3)
    n, live = 65536, 20011
    index = [torch.as_tensor(rs.randint(0, d, n)).cuda()
             for d in shape[:n_index]]
    c = int(np.prod(shape[n_index:]))
    g = torch.as_tensor(rs.randn(n, c).astype(np.float32)).cuda()
    rows = table_grad.flat_rows(shape, index).reshape(-1).contiguous()
    rows[live:] = -7
    g[live:] = float("nan")
    count = torch.tensor([live], dtype=torch.int32, device="cuda")
    got = table_grad.table_grad(rows, g, shape, count=count)
    alone = table_grad.table_grad(rows[:live].contiguous(),
                                  g[:live].contiguous(), shape)
    assert torch.equal(got.view(torch.int32), alone.view(torch.int32))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = table_grad.table_grad(rows, g, shape, count=count)
    count.fill_(live // 2)
    graph.replay()
    half = table_grad.table_grad(rows[:live // 2].contiguous(),
                                 g[:live // 2].contiguous(), shape)
    assert torch.equal(out.view(torch.int32), half.view(torch.int32))


def test_capture_survives_the_collector():
    """A CUDA graph in a reference cycle that turns into garbage during a
    capture must not be freed there, where its destruction is a call the
    capture forbids and fails the capture: `Graphed` keeps Python's cyclic
    collector off while it captures (here run at every allocation)."""
    import gc

    class Holder:
        pass

    graphs = [torch.cuda.CUDAGraph()]
    x = torch.zeros(1, device="cuda")
    with torch.cuda.graph(graphs[0]):
        x += 1

    def fn(t):
        if torch.cuda.is_current_stream_capturing() and graphs:
            holder = Holder()
            holder.self = holder
            holder.graph = graphs.pop()
            del holder
            for _ in range(100):
                [[]]
        return t * 2

    runner = loops.Graphed()
    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        out = runner.call(fn, torch.ones(4, device="cuda"))
    finally:
        gc.set_threshold(*threshold)
    gc.collect()
    assert not graphs and runner.replays == 1
    assert torch.equal(out, torch.full((4,), 2.0, device="cuda"))


def test_failed_capture_raises():
    """A step whose forward syncs with the host (the plain traversal
    compacts its rays) cannot be captured: the first call raises, and
    nothing runs the step eagerly in its place."""
    ctx = renderer.RenderContext(cornell_box_obj(), device="cuda")
    plain = functools.partial(traverse.intersect_bvh, ctx.cs.prims,
                              ctx.intersect.ks.tree)
    step, args = _step_and_inputs(ctx, 8, 4, intersect=plain)
    with pytest.raises(RuntimeError):
        step(*args)
    assert step.runner.graph is None and step.runner.replays == 0
    assert step.rays == 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("name", ["cornell_box", "cornell_box_obj"])
def test_diff_trace_kernels_match_plain_on_card(name):
    """The fused route's kernels against their plain versions, both on the
    card, at the step's camera rays (64², depth 16, seed 0): the forward
    kernel (brute force, or its BVH form on cornell_box_obj) within chip
    phase 4's tolerances (rays within RAYS_RTOL, 99% of the paths'
    radiance within 1e-4, the mean within 0.5%: libdevice and torch's
    division by a scalar round the last ulp otherwise, which can turn a
    rare path), and on the paths whose records take the same branches the
    records within rtol 1e-4; the fused reverse on the plain forward's
    records bit for bit G on the plain version's slots (the same terms,
    summed in an order that changes no bit)."""
    n = 64
    ctx, scene, s, _, want = _fwd_vs_plain(name, n, 16)
    _reverse_vs_g(scene, ctx, s, want)


def _reverse_vs_g(scene, ctx, s, want):
    """The fused reverse (`diff_trace.reverse`, one launch counted) at a
    random cotangent of the radiance, on the plain forward's records
    `want` (which it overwrites), against G (`table_grad`) on
    `reverse_reference`'s slots and count, bit for bit."""
    b0, g0 = diff_trace.bwd_launches, table_grad.launches
    g_rad = torch.randn((want[1].shape[0], 3), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(1))
    c0, c1 = ctx.cs.textures.c0, ctx.cs.textures.c1
    rows, g, count = diff_trace.reverse_reference(
        want[2], want[3], want[1], g_rad, c0, c1, s, scene.checker)
    got = diff_trace.reverse(scene, want[2], want[3], want[1], g_rad, c0, c1,
                             s)[0]
    assert diff_trace.bwd_launches == b0 + 1
    assert int(count) == int(want[1].sum())
    n_rows = scene.n_tex * (2 if scene.checker else 1)
    via_g = table_grad.table_grad(rows, g, (n_rows, 3), count=count)
    assert table_grad.launches == g0 + 1
    assert torch.equal(got.view(torch.int32), via_g.view(torch.int32))
    assert float(got.abs().max()) > 0


def _fwd_vs_plain(name, n, depth):
    """The forward kernel against its plain version on the card at the
    step's camera rays (n², depth, seed 0) within chip phase 4's tolerances
    (rays within 0.5%, 99% of the paths' radiance within 1e-4, the mean
    within 0.5%: libdevice and torch's division by a scalar round the last
    ulp otherwise, which can turn a rare path), and on the paths whose
    records take the same branches (99% of them) the records within rtol
    1e-4. Returns (context, DiffScene, settings, rays, plain outputs)."""
    ctx = renderer.RenderContext(
        cornell_box() if name == "cornell_box" else cornell_box_obj(),
        device="cuda")
    scene = diff_trace.prepare(ctx.cs, ctx.meta, ctx.intersect)
    assert scene is not None and (scene.bvh is not None) == (
        name == "cornell_box_obj")
    s = path.RenderSettings(max_depth=depth)
    ys = torch.arange(n, device="cuda").repeat_interleave(n)
    xs = torch.arange(n, device="cuda").repeat(n)
    rays = tuple(x.contiguous() for x in renderer.camera_rays(
        ctx.cs, rng.render_key(0, device="cuda"), xs, ys, n, n, 0))
    f0 = diff_trace.fwd_launches
    got = diff_trace.forward(scene, ctx.cs, ctx.meta, s, ctx.intersect, *rays)
    want = diff_trace.forward_reference(ctx.cs, ctx.meta, s, ctx.intersect,
                                        *rays)
    assert diff_trace.fwd_launches == f0 + 1
    rays_g, rays_w = int(got[1].sum()), int(want[1].sum())
    assert abs(rays_g - rays_w) <= 0.005 * rays_w
    err = (got[0] - want[0]).abs().amax(dim=1)
    assert float((err <= 1e-4).float().mean()) >= 0.99
    assert abs(float(got[0].mean()) / float(want[0].mean()) - 1) <= 0.005
    live = torch.arange(depth, device="cuda")[:, None] < want[1][None, :]
    same = (got[1] == want[1]) & ((got[3] == want[3]) | ~live).all(0)
    assert float(same.float().mean()) >= 0.99
    keep = live & same[None, :]
    torch.testing.assert_close(got[2][keep], want[2][keep], rtol=1e-4,
                               atol=1e-6)
    return ctx, scene, s, rays, want


def test_diff_trace_fwd_full_step_frame_on_card():
    """The forward kernel at the Cornell step's own frame (256², depth 50,
    seed 0), where a warp's last paths, the 76 that reach the cap among
    them, run with up to 32 lanes each: against its plain version within
    `_fwd_vs_plain`'s tolerances; its probe instance's outputs equal the
    kernel's bit for bit, each warp's passes are its longest path, and
    passes ran at every group size, 1 to 32 lanes a path; the fused
    reverse on the plain records equals G on the plain slots bit for
    bit."""
    ctx, scene, s, rays, want = _fwd_vs_plain("cornell_box", 256, 50)
    got = diff_trace.forward(scene, ctx.cs, ctx.meta, s, ctx.intersect, *rays)
    probed, summary = diff_trace.probe(scene, ctx.cs, ctx.meta, s, *rays)
    live = torch.arange(50, device="cuda")[:, None] < got[1][None, :]
    assert torch.equal(probed[0].view(torch.int32), got[0].view(torch.int32))
    assert torch.equal(probed[1], got[1])
    assert torch.equal(probed[2][live].view(torch.int32),
                       got[2][live].view(torch.int32))
    assert torch.equal(probed[3][live], got[3][live])
    assert int((want[1] == 50).sum()) > 0
    assert summary["passes_equal_longest"]
    assert all(v > 0 for v in summary["passes_by_group"].values())
    _reverse_vs_g(scene, ctx, s, want)


@pytest.mark.parametrize("name,n", [("cornell_box", 32),
                                    ("cornell_box_obj", 16)])
def test_fused_step_matches_checkpointed_step_on_card(name, n):
    """Depth 8, 2 samples a pixel: the fused captured step (the default:
    its passes in one launch of the forward kernel and one call of the
    reverse) against the checkpointed captured step (a pass at a time) on
    the card: equal rays and loss, every gradient within G's tolerances
    (rtol 1e-5, atol 1e-6·max|g| of its table: the two sum the rows'
    cotangents in another order); two replays of the fused step bit for
    bit."""
    ctx = renderer.RenderContext(
        cornell_box() if name == "cornell_box" else cornell_box_obj(),
        device="cuda")
    fused, args = _step_and_inputs(ctx, n, 8, spp=2)
    ckpt, _ = _step_and_inputs(ctx, n, 8, route="checkpoint", spp=2)
    assert isinstance(fused.route, diff_trace.DiffScene)
    assert ckpt.route == "checkpoint"
    loss_f, grads_f = fused(*args)
    again, grads_a = fused(*args)
    loss_c, grads_c = ckpt(*args)
    assert torch.equal(loss_f, again)
    for k in grads_f:
        assert torch.equal(grads_f[k], grads_a[k]), k
    assert fused.rays == ckpt.rays
    assert float(loss_f) == float(loss_c)
    for k, w in grads_c.items():
        assert torch.isfinite(grads_f[k]).all(), k
        w = w.cpu().numpy()
        np.testing.assert_allclose(
            grads_f[k].cpu().numpy(), w, rtol=1e-5,
            atol=1e-6 * max(float(np.abs(w).max()), 1e-30), err_msg=k)


@pytest.mark.parametrize("name,n", [("cornell_box", 64),
                                    ("cornell_box_obj", 32)])
def test_merged_step_equals_per_sample_loop_on_card(name, n):
    """Depth 50, 4 samples a pixel: the captured fused step (its four
    sample passes as one pass: a replay launches the new-sample cipher,
    the forward kernel and the reverse once each, the forward's launch
    carrying the 4 passes) against the same step run eagerly a sample pass
    at a time (a forward launch and a reverse call a pass): the loss, the
    rays and every gradient bit for bit, on the brute-force form and the
    BVH form."""
    ctx = renderer.RenderContext(
        cornell_box() if name == "cornell_box" else cornell_box_obj(),
        device="cuda")
    step, args = _step_and_inputs(ctx, n, 50, spp=4)
    assert isinstance(step.runner, loops.Graphed)
    assert isinstance(step.route, diff_trace.DiffScene)
    loss, grads = step(*args)
    again, grads_a = step(*args)
    deltas = step.runner.deltas
    assert deltas[("diff_trace", "fwd_launches")] == 1
    assert deltas[("diff_trace", "bwd_launches")] == 1
    assert deltas[("diff_trace", "fwd_passes")] == 4
    assert deltas[("threefry", "launches")] == 1
    assert deltas[("table_grad", "launches")] == 0
    f0, b0 = diff_trace.fwd_launches, diff_trace.bwd_launches
    p0 = diff_trace.fwd_passes
    want_loss, want_grads, want_rays = loop_step(
        ctx.cs, ctx.meta, path.RenderSettings(max_depth=50), ctx.intersect, n,
        4, step.route, *args)
    assert diff_trace.fwd_launches - f0 == diff_trace.bwd_launches - b0 == 4
    assert diff_trace.fwd_passes - p0 == 4
    assert step.rays == want_rays > 4 * n * n
    for got_loss, got in ((loss, grads), (again, grads_a)):
        assert torch.equal(got_loss.view(torch.int32),
                           want_loss.view(torch.int32))
        for k, w in want_grads.items():
            assert torch.equal(got[k].view(torch.int32),
                               w.view(torch.int32)), k
    assert float(grads["tex_c0"].abs().max()) > 0


def _spans_named(host, name):
    """(start µs, end µs) of the program's span `name` among a trace's host
    operations, by start."""
    return sorted((s, e) for s, e, n in host if n == profiling.PREFIX + name)


def _traced_on_host_clock(fn):
    """fn() traced by the benchmark's reader, between two device writes 5 ms
    before and after it (so the slice keeps every span of fn whatever the
    clocks' offset); (fn's device records on the host's clock, host
    operations)."""
    import time

    from h100bench import harness, spans

    mark = torch.zeros(1, device="cuda")

    def bracketed():
        mark.add_(1)
        time.sleep(0.005)
        fn()
        time.sleep(0.005)
        mark.add_(1)

    _, records, host = harness.device_intervals(torch, bracketed)
    return spans.on_host_clock(harness.Trace(records, 0.0, {}, {}, host)), host


def test_spans_and_device_records_on_one_clock():
    """The program's spans and the device records of one trace, put on one
    clock by the benchmark's reader (`h100bench.spans.on_host_clock`: the
    copies between host and device memory inside the host operations that
    wait for them; the profiler's device records have lain up to 4.6 ms
    off the host's): in a trace of two images each `megakernel_rgb`
    record starts after its image's `megakernel.launch` starts and ends
    before its `render.readback` ends; in a trace of three replays of the
    captured step each `diff_trace_fwd` record lies between its step's
    `graph.replay` start and its `step.rays_read` end. The step's first
    call, which captures, shows one `graph.capture` (traced on the host
    alone); the replays show none."""
    from h100bench import harness

    ctx = renderer.RenderContext(cornell_box(), device="cuda")
    settings = path.RenderSettings(max_depth=8)

    def two_images():
        for seed in (1, 2):
            renderer.render(None, 64, 64, 4, settings, seed=seed,
                            context=ctx, device="cuda")

    two_images()
    records, host = _traced_on_host_clock(two_images)
    kernels = sorted(r for r in records
                     if harness.kernel_name(r[2]) == "megakernel_rgb")
    launches = _spans_named(host, "megakernel.launch")
    reads = _spans_named(host, "render.readback")
    assert len(kernels) == len(launches) == len(reads) == 2
    for (k0, k1, _), (l0, _), (_, r1) in zip(kernels, launches, reads):
        assert l0 <= k0 and k1 <= r1

    step, args = _step_and_inputs(ctx, 32, 8)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(*args)
    assert [e.name for e in prof.events()].count(
        profiling.PREFIX + "graph.capture") == 1
    records, host = _traced_on_host_clock(
        lambda: [step(*args) for _ in range(3)])
    assert not _spans_named(host, "graph.capture")
    fwd = sorted(r for r in records
                 if harness.kernel_name(r[2]) == "diff_trace_fwd")
    replays = _spans_named(host, "graph.replay")
    rays = _spans_named(host, "step.rays_read")
    assert len(fwd) == len(replays) == len(rays) == 3
    for (f0, f1, _), (p0, _), (_, q1) in zip(fwd, replays, rays):
        assert p0 <= f0 and f1 <= q1
    assert step.runner.replays == 4
