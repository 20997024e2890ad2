"""The RGB megakernel's BVH form, run on the CPU as host C++.

`csrc/megakernel_rgb.cu` is compiled with g++ behind the stand-ins of
`_torch_port.host_kernel`: one `std::thread` per lane, a `std::barrier` of
32 per warp behind the warp collectives, `atomicAdd` as
`__atomic_fetch_add`. One warp serves every slot of the persistent loop, so
each lane renders several slots and regenerates its paths, and lanes whose
queue has drained wait in the loop for the warp's last path. On a Cornell
box with a ~500-triangle blob where `cornell_box_obj` puts its mesh (and
the same box with its glass absorbing, the only case that takes the
Beer–Lambert exit re-trace), 8×8 at 2 spp, depth 8, the kernel is held to
its plain version, `megakernel.render_slots_reference` through the plain
traversal on the same layout: rays equal, each slot's (nodes popped,
primitives tested) equal, and the image within chip phase 4's tolerances.
The probe instance renders the same and counts a lane use in (0, 1].
"""

import ctypes

import numpy as np
import pytest
import torch

from _torch_port import host_kernel, with_absorbing_glass
from izpi_tpu_torch.core import rng
from izpi_tpu_torch.geometry import procedural
from izpi_tpu_torch.integrator import path
from izpi_tpu_torch.ops import bvh_kernel, megakernel
from izpi_tpu_torch.scene import compiler
from izpi_tpu_torch.scene import types as st
from izpi_tpu_torch.scene.library.cornell import cornell_box

N, SPP, DEPTH = 8, 2, 8
# Slots of the layout: 64 pixels × 2 replicas of one sample each, four a
# lane of the one warp.
MIN_SLOTS = 128
THREADS = 32
# Chip phase 4's tolerances: a pixel agrees within PIXEL_ATOL, and
# PIXEL_SHARE of them must.
PIXEL_ATOL, PIXEL_SHARE = 1e-4, 0.99

# The host entry: the BVH form (which 0) or its probe instance (which 1)
# over one block of `threads` lanes.
ENTRY = r"""
extern "C" void run(int which, const float* prim_f, const int* prim_i, int n_prims,
                    const float* mat_f, const int* mat_i, const float* light_f,
                    const int* light_i, int n_lights, const int* nodes, const float* bvh_prims,
                    const float* cam, uint32_t seed0, uint32_t seed1, int nx, int ny,
                    int spp_slot, int n_slots, int max_depth, int threads, int* queue,
                    float* acc, int* cnt, int* trav, unsigned long long* probe) {
  const izpi::Scene sc{prim_f, prim_i, n_prims, mat_f, mat_i, light_f, light_i, n_lights};
  const izpi::BvhTables tab{nodes, bvh_prims, trav};
  const izpi::Camera camera = izpi::load_camera(cam);
  const auto kernel = which ? izpi::megakernel_rgb_bvh_probe : izpi::megakernel_rgb_bvh;
  run_grid(1, threads, [&] {
    kernel(sc, tab, camera, seed0, seed1, 0u, nx, ny, spp_slot, n_slots, max_depth, 0.0f,
           0.0f, 0.0f, 1, queue, acc, cnt, nullptr, which ? probe : nullptr);
  });
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    argtypes = [i, p, p, i, p, p, p, p, i, p, p, p, u, u, i, i, i, i, i, i,
                p, p, p, p, p]
    return host_kernel(tmp_path_factory.mktemp("bvh_form"), "megakernel_rgb.cu",
                       ENTRY, argtypes)


def _scene(absorbing: bool):
    """The Cornell box with a 480-triangle bumpy blob, its primitives in
    tree order: (cs, meta, the tree's KernelScene)."""
    scene = cornell_box()
    tris = procedural.transform_mesh(procedural.bumpy_blob(480), scale=60.0,
                                     translate=(280.0, 90.0, 390.0))
    scene.world.append(st.TriangleMesh(vertices=tris, material=st.Lambertian(
        albedo=st.ConstantTexture((0.7, 0.7, 0.85)))))
    if absorbing:
        scene = with_absorbing_glass(scene)
    cs, meta = compiler.compile_scene(scene, "cpu")
    cs2, inter = bvh_kernel.attach(cs)
    return cs2, meta, inter.ks


@pytest.fixture(scope="module", params=["obj", "obj_absorbing"])
def scene(request):
    return _scene(request.param == "obj_absorbing")


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def _kernel(host, scene, seed: int, which: int = 0):
    """(acc summed over replicas (64, 3), rays, per-slot traversal counts
    (slots, 2), probe counters) of one host launch."""
    cs, meta, ks = scene
    tables = megakernel.pack_tables(cs)
    repl, spp_slot, n_slots = megakernel.slot_layout(N * N, SPP, MIN_SLOTS)
    seed0, seed1 = megakernel._key_words(rng.render_key(seed))
    queue = torch.zeros(1, dtype=torch.int32)
    acc = torch.empty((n_slots, 3), dtype=torch.float32)
    cnt = torch.empty(n_slots, dtype=torch.int32)
    trav = torch.zeros((n_slots, 2), dtype=torch.int32)
    probe = torch.zeros(len(megakernel.PROBE_COUNTERS), dtype=torch.int64)
    host.run(which, _ptr(tables.prim_f), _ptr(tables.prim_i),
             meta.n_prims, _ptr(tables.mat_f), _ptr(tables.mat_i),
             _ptr(tables.light_f), _ptr(tables.light_i), meta.n_lights,
             _ptr(ks.nodes), _ptr(ks.prim_table), _ptr(tables.cam), seed0,
             seed1, N, N, spp_slot, n_slots, DEPTH, THREADS, _ptr(queue),
             _ptr(acc), _ptr(cnt), _ptr(trav), _ptr(probe))
    acc = acc.reshape(repl, N * N, 3).sum(dim=0)
    return acc, int(cnt.sum()), trav.long(), probe.tolist()


def _plain(scene, seed: int):
    """The plain version's (acc, rays, per-slot traversal counts)."""
    cs, meta, ks = scene
    _, _, n_slots = megakernel.slot_layout(N * N, SPP, MIN_SLOTS)
    counts = torch.zeros((n_slots, 2), dtype=torch.int64)
    acc, rays = megakernel.render_slots_reference(
        cs, meta, path.RenderSettings(max_depth=DEPTH), N, N, SPP,
        rng.render_key(seed), min_slots=MIN_SLOTS,
        intersect=megakernel.bvh_plain_intersector(ks, counts))
    return acc, int(rays), counts


@pytest.mark.parametrize("seed", [np.random.RandomState(15).randint(1 << 16)])
def test_bvh_form_equals_plain(host, scene, seed):
    """Rays and every slot's traversal counts equal the plain version's;
    the pixels within chip phase 4's tolerances."""
    acc, rays, trav, _ = _kernel(host, scene, seed)
    acc_p, rays_p, trav_p = _plain(scene, seed)
    assert rays == rays_p
    assert torch.equal(trav, trav_p)
    assert (trav[:, 0] > 0).all() and trav[:, 1].sum() > 0
    close = ((acc - acc_p).abs().amax(dim=1) / SPP) <= PIXEL_ATOL
    assert close.float().mean().item() >= PIXEL_SHARE
    assert torch.isfinite(acc).all() and acc.sum() > 0


def _probe_summary(raw):
    """megakernel.probe_bvh's derived figures from the raw counters."""
    c = dict(zip(megakernel.PROBE_COUNTERS, raw))
    return dict(c, use_visits=c["visits"] / (32 * c["visit_passes"]),
                use_tests=c["tests"] / (32 * c["test_passes"]))


@pytest.mark.parametrize("seed", [np.random.RandomState(16).randint(1 << 16)])
def test_probe_renders_the_main_instance(host, scene, seed):
    """The probe instance renders the main instance's bits, rays and
    per-slot counts; its lane use of the visit and test passes lies in
    (0, 1], its traversal calls are the rays and, with absorbing glass, the
    exit re-traces besides, and its cycle counts are positive."""
    acc, rays, trav, _ = _kernel(host, scene, seed)
    acc_p, rays_p, trav_p, raw = _kernel(host, scene, seed, 1)
    assert torch.equal(acc_p.view(torch.int32), acc.view(torch.int32))
    assert rays_p == rays and torch.equal(trav_p, trav)
    c = _probe_summary(raw)
    assert 0 < c["use_visits"] <= 1 and 0 < c["use_tests"] <= 1
    assert c["visits"] == int(trav[:, 0].sum())
    assert c["tests"] == int(trav[:, 1].sum())
    assert c["max_visits"] >= c["visits"] / max(c["calls"], 1)
    absorbing = scene[1].has_absorbing_dielectric
    assert c["rays"] > rays if absorbing else c["rays"] == rays
    assert (c["cycles_loop"] >= c["cycles_traversal"] + c["cycles_regeneration"]
            and min(c["cycles_traversal"], c["cycles_regeneration"]) > 0)
