"""The two traversal kernels, run on the CPU as host C++.

`csrc/bvh4_rowstack.cu` (one warp per row, each leaf tested one primitive
per lane against the rays that hit its box, leaves copied by cp.async) and
`csrc/bvh4_traverse.cu` (one thread per ray) are compiled with g++ behind
stand-ins for CUDA: `threadIdx` and `blockIdx` as thread-locals,
`__shared__` as statics, `atomicAdd` as `__atomic_fetch_add`, the copy
macros as a plain copy, and one `std::thread` per lane, with a
`std::barrier` of 32 per warp behind `__syncwarp`, `__ballot_sync`,
`__shfl_sync` and `__reduce_min_sync` and one of the block behind
`__syncthreads`. Each source is cut before its C entries (the `<<<...>>>`
launches). Fed the tables of `ops.bvh_rowkernel.attach` and
`ops.bvh_kernel.attach` for a Cornell box with a 2,000-triangle blob, and
1,024 camera, incoherent, parked and NaN rays, each kernel returns its
plain version's (t, index) and counters bit for bit:
`bvh_rowkernel.closest_rows`' per-warp counters and
`accel.traverse.closest_bvh`'s per-ray (nodes popped, primitives tested).
"""

import ctypes

import numpy as np
import pytest
import torch

from _torch_port import host_kernel
from izpi_tpu_torch import camera
from izpi_tpu_torch.accel import traverse
from izpi_tpu_torch.geometry import primitives, procedural
from izpi_tpu_torch.integrator import path
from izpi_tpu_torch.ops import bvh_kernel, bvh_rowkernel
from izpi_tpu_torch.scene import compiler
from izpi_tpu_torch.scene import types as st
from izpi_tpu_torch.scene.library.cornell import cornell_box

ENTRIES = {
    "bvh4_traverse.cu": r"""
extern "C" void run(const int* nodes, const float* prims, const float* o, const float* d,
                    const float* time, int n, float t_min, float t_max, float* t, int* idx,
                    int* counts) {
  run_grid((n + 127) / 128, 128, [&] {
    izpi::bvh4_traverse(nodes, prims, o, d, time, n, t_min, t_max, t, idx, counts);
  });
}
""",
    "bvh4_rowstack.cu": r"""
extern "C" void run(const int* nodes, const float* blocks, const float* o, const float* d,
                    const float* time, int n, float t_min, float t_max, float* t, int* idx,
                    int* counters) {
  const int grid = ((n + 31) / 32 + izpi::kWarpsPerBlock - 1) / izpi::kWarpsPerBlock;
  run_grid(grid, 32 * izpi::kWarpsPerBlock, [&] {
    izpi::bvh4_rowstack(nodes, reinterpret_cast<const float4*>(blocks), o, d, time, n, t_min,
                        t_max, t, idx, counters);
  });
}
""",
}


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """{source: its host build, a ctypes library with one entry `run`}."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    argtypes = [p, p, p, p, p, i, f, f, p, p, p]
    return {name: host_kernel(tmp_path_factory.mktemp(name.split(".")[0]),
                              name, entry, argtypes)
            for name, entry in ENTRIES.items()}


def _blob_box():
    """The Cornell box with a 2,000-triangle bumpy blob where
    cornell_box_obj puts its mesh, compiled on the CPU."""
    scene = cornell_box()
    tris = procedural.transform_mesh(procedural.bumpy_blob(2000), scale=60.0,
                                     translate=(280.0, 90.0, 390.0))
    scene.world.append(st.TriangleMesh(vertices=tris, material=st.Lambertian(
        albedo=st.ConstantTexture((0.7, 0.7, 0.85)))))
    cs, _ = compiler.compile_scene(scene, "cpu")
    return cs


@pytest.fixture(scope="module")
def scene():
    return _blob_box()


def _rays(cs, n: int, seed: int):
    """n rays: n/2 camera rays, then rays from their hit points in random
    directions (some with a zero component), 16 of them parked outside the
    scene as the pool parks dead slots, and 3 with a NaN."""
    rs = np.random.RandomState(seed)
    half = n // 2
    u = torch.as_tensor(rs.rand(half, 5).astype(np.float32))
    o, d, tme = camera.get_rays(cs.camera, u[:, 0], u[:, 1], u[:, 2:5])
    t, idx = primitives.closest_brute(cs.prims, o, d, tme, path.T_MIN,
                                      primitives.T_MAX)
    start = torch.where((idx >= 0)[:, None], o + t[:, None] * d, o)
    d2 = torch.as_tensor(rs.randn(n - half, 3).astype(np.float32))
    d2[:32, 0] = 0.0
    d2[32:64, 1] = 0.0
    o, d = torch.cat([o, start]), torch.cat([d, d2])
    tme = torch.cat([tme, tme[: n - half]])
    park = torch.as_tensor(rs.choice(n, 16, replace=False))
    o[park] = path.PARK
    d[rs.choice(n, 3, replace=False), 1] = float("nan")
    return o.contiguous(), d.contiguous(), tme.contiguous()


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


@pytest.mark.parametrize("n,t_min,t_max", [
    (1024, path.T_MIN, primitives.T_MAX), (1000, 0.0, 1000.0)])
def test_bvh4_traverse_equals_plain(host, scene, n, t_min, t_max):
    """Every ray's (t, index) and (nodes popped, primitives tested) equal
    the plain version's, a ragged last block among them; a parked ray pops
    the root alone."""
    cs2, inter = bvh_kernel.attach(scene)
    ks = inter.ks
    o, d, tme = (x[:n].contiguous() for x in _rays(cs2, 1024, 11))
    t = torch.empty(n, dtype=torch.float32)
    idx = torch.empty(n, dtype=torch.int32)
    counts = torch.empty((n, 2), dtype=torch.int32)
    host["bvh4_traverse.cu"].run(
        _ptr(ks.nodes), _ptr(ks.prim_table), _ptr(o), _ptr(d), _ptr(tme), n,
        t_min, min(t_max, primitives.T_MAX), _ptr(t), _ptr(idx), _ptr(counts))
    t_p, i_p, c_p = traverse.closest_bvh(ks.prims, ks.tree, o, d, tme, t_min,
                                         t_max, counts=True)
    hit = i_p >= 0
    assert 0.3 < hit.float().mean() < 1.0
    assert torch.equal(idx.long(), i_p)
    assert torch.equal(t.view(torch.int32), t_p.view(torch.int32))
    assert torch.equal(counts.long(), c_p)
    parked = (o == path.PARK).all(dim=1)
    assert parked.any() and (c_p[parked, 0] == 1).all()


@pytest.mark.parametrize("n,t_min,t_max,sort", [
    (1024, path.T_MIN, primitives.T_MAX, True),
    (1000, 0.0, 1000.0, False)], ids=["sorted", "ragged"])
def test_bvh4_rowstack_equals_plain(host, scene, n, t_min, t_max, sort):
    """Every ray's (t, block slot) and every warp's (nodes popped, leaf
    blocks tested, (ray, primitive) pairs tested) equal the plain
    version's: rays sorted by the JAX intersector's coherence key (coherent
    rows), and rays in their order with a ragged last warp."""
    cs2, inter = bvh_rowkernel.attach(scene)
    rs = inter.rs
    o, d, tme = (x[:n] for x in _rays(cs2, 1024, 12))
    if sort:
        order = torch.argsort(bvh_rowkernel.sort_keys(o, d, inter.lo, inter.hi),
                              stable=True)
        o, d, tme = (x[order].contiguous() for x in (o, d, tme))
    t = torch.empty(n, dtype=torch.float32)
    idx = torch.empty(n, dtype=torch.int32)
    counters = torch.empty((-(-n // 32), 3), dtype=torch.int32)
    host["bvh4_rowstack.cu"].run(_ptr(rs.nodes), _ptr(rs.blocks), _ptr(o), _ptr(d),
                      _ptr(tme), n, t_min, min(t_max, primitives.T_MAX), _ptr(t),
                      _ptr(idx), _ptr(counters))
    t_p, i_p, c_p = bvh_rowkernel.closest_rows(rs, o, d, tme, t_min, t_max)
    assert 0.3 < (i_p >= 0).float().mean() < 1.0
    assert torch.equal(idx.long(), i_p)
    assert torch.equal(t.view(torch.int32), t_p.view(torch.int32))
    assert torch.equal(counters.long(), c_p)
    # The warps test fewer pairs than every lane testing every block.
    assert (c_p[:, 2] < 32 * c_p[:, 1] * bvh_rowkernel.LEAF_SIZE).all()
