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
from izpi_tpu_torch.ops import bvh_kernel, megakernel, megakernel_spectral
from izpi_tpu_torch.ops import threefry
from izpi_tpu_torch.render import renderer
from izpi_tpu_torch.scene import compiler
from izpi_tpu_torch.scene.library.cornell import cornell_box
from izpi_tpu_torch.scene.library.cornell_spectral import (
    cornell_box_pyramid_spectral)
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


@pytest.mark.parametrize("n,spp,depth,seed,offset", [
    (16, 4, 8, 3, 0),       # four replicas per pixel (1024 slots)
    (256, 2, 50, 0, 0),     # the main path's layout: one slot per pixel
    (256, 2, 50, 0, 1022),  # ... and its last sample chunk
])
def test_kernel_matches_twin_on_card(n, spp, depth, seed, offset):
    """Cornell n×n at spp samples from `offset`. Ray counts within 0.5% and
    99% of the pixels within 1e-4: on the card torch divides by a Python
    scalar as a multiplication by its reciprocal (x / π, x / n_lights) where
    the kernel divides, and a last-ulp difference may flip a rare branch."""
    cs, meta = compiler.compile_scene(cornell_box(), "cuda")
    s = path.RenderSettings(max_depth=depth)
    key = rng.render_key(seed, device="cuda")
    before = megakernel.launches
    got, g_rays = megakernel.render_slots(cs, meta, s, n, n, spp, key, offset)
    assert megakernel.launches == before + 1
    want, w_rays = megakernel.render_slots_reference(cs, meta, s, n, n, spp, key,
                                                     offset)
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
    (500, 2, 50, 0, 0),     # the spectral main path's layout: a slot per pixel
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
    before = megakernel_spectral.launches
    got, g_rays = megakernel_spectral.render_slots_spectral(
        cs, meta, s, n, n, spp, key, offset)
    assert megakernel_spectral.launches == before + 1
    want, w_rays = megakernel_spectral.render_slots_spectral_reference(
        cs, meta, s, n, n, spp, key, offset)
    torch.cuda.synchronize()
    assert abs(int(g_rays) - int(w_rays)) <= 0.005 * int(w_rays)
    close = ((got - want).abs() <= 1e-4 * spp + 1e-5 * want.abs()).all(dim=1)
    assert close.float().mean().item() >= 0.99
    assert abs(float(got[:, 1].mean()) / float(want[:, 1].mean()) - 1) <= 0.005
    assert torch.isfinite(got).all()


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
