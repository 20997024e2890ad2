"""izpi_tpu_torch's CUDA kernels vs their plain PyTorch versions, on a card.

These tests need an NVIDIA GPU (the `cuda` marker) and skip without one.
The file imports no JAX, so it runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest` skips tests/conftest.py, which sets JAX up for the other
test files.) The kernels build into build/izpi_tpu_torch/ at first use.
"""

import numpy as np
import pytest
import torch

from izpi_tpu_torch import camera
from izpi_tpu_torch.accel import traverse
from izpi_tpu_torch.core import rng
from izpi_tpu_torch.geometry import primitives
from izpi_tpu_torch.integrator import path, wavefront
from izpi_tpu_torch.ops import _build, bvh_kernel, bvh_rowkernel, megakernel
from izpi_tpu_torch.ops import megakernel_spectral, threefry
from izpi_tpu_torch.render import renderer
from izpi_tpu_torch.scene import compiler
from izpi_tpu_torch.scene.library.cornell import cornell_box
from izpi_tpu_torch.scene.library.cornell_spectral import (
    cornell_box_pyramid_spectral)
from izpi_tpu_torch.scene.library.extracted import (
    cornell_box_pbr_stanford_dragon_spectral)
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
                                    (1, wavefront.LAMBDA_SALT)])
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
        if name in ("izpi_megakernel_rgb", "izpi_megakernel_spectral"):
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


def test_cuda_obj_render_matches_cpu_render(obj_context):
    """cornell_box_obj 16x16 at 2 spp through the queue pool: on the card
    through the traversal kernel (one launch per pool iteration), on the
    CPU through the plain traversal, with the bounds of the kernel-vs-twin
    tests above."""
    s = path.RenderSettings(max_depth=8)
    before = bvh_kernel.launches
    on_card = renderer.render(None, 16, 16, 2, s, seed=3, context=obj_context,
                              device="cuda")
    assert bvh_kernel.launches - before == on_card.iterations
    on_cpu = renderer.render(cornell_box_obj(), 16, 16, 2, s, seed=3,
                             device="cpu")
    assert on_card.iterations >= 1
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
    through the row-stack pair (a pool of 128 slots, below SORT_MIN, so the
    rays go unsorted; one launch per pool iteration) on the card and through
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
        assert launched == (out[device].iterations if device == "cuda" else 0)
    on_card, on_cpu = out["cuda"], out["cpu"]
    assert abs(on_card.rays_traced - on_cpu.rays_traced) <= 0.005 * on_cpu.rays_traced
    close = (np.abs(on_card.xyz - on_cpu.xyz)
             <= 1e-4 + 1e-5 * np.abs(on_cpu.xyz)).all(axis=2)
    assert close.mean() >= 0.99
    assert np.isfinite(on_card.image).all()
