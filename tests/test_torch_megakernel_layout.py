"""The persistent megakernels' layout and lazy draws, on the CPU.

- The lazy draws of `csrc/draws.cuh` (with `csrc/threefry.cuh`), compiled
  as host C++ with g++ behind stand-ins for the CUDA qualifiers, give the
  bits of `ops/threefry.py`: every counter pair of the 12 bounce uniforms,
  each material's pairs and branch, and a new sample's path key, camera
  uniforms and λ uniform.
- `pick_replication` with the card's `min_slots` gives the layout the CUDA
  wrappers launch, and the default stays the JAX rule.
- The plain versions on a card-style layout (replicas splitting each
  pixel's samples) give the default layout's images within 1e-5 (and 1e-5
  relative: spectral XYZ reaches ~321, where an f32 ulp is ~3e-5) and its
  ray counts exactly: the same samples and paths, summed in another order.
"""

import subprocess

import numpy as np
import pytest
import torch

from izpi_tpu.ops import megakernel as jmega
from izpi_tpu_torch import camera
from izpi_tpu_torch.core import rng
from izpi_tpu_torch.integrator import path, wavefront
from izpi_tpu_torch.ops import _build, megakernel, megakernel_spectral
from izpi_tpu_torch.ops import threefry as tf
from izpi_tpu_torch.scene import compiler
from izpi_tpu_torch.scene.library.cornell import cornell_box
from izpi_tpu_torch.scene.library.cornell_spectral import (
    cornell_box_pyramid_spectral)

# Host stand-ins for the CUDA qualifiers and intrinsics draws.cuh uses, and
# C entries over its functions.
HOST_SOURCE = r"""
#include <cmath>
#include <cstdint>
#include <cstring>
#define __device__
#define __host__
#define __forceinline__ inline
static inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
#include "draws.cuh"

template <bool kLambda>
static void run_draws(const uint32_t* keys, const uint32_t* depths, const uint32_t* lists,
                      uint32_t seed0, uint32_t seed1, const int64_t* sids,
                      const uint32_t* pix, int n, float* us, float* cu, float* ul,
                      uint32_t* key, int* n_pairs, int* passes) {
  for (int j = 0; j < n; ++j) {
    izpi::Draws<kLambda> dr;
    for (float& u : dr.us) u = NAN;
    dr.clear();
    const uint32_t k0 = keys[2 * j], k1 = keys[2 * j + 1];
    if (sids[j] >= 0) dr.new_sample(seed0, seed1, (uint32_t)sids[j], pix[j]);
    if (lists[j] != 0u) dr.bounce(k0, k1, depths[j], lists[j]);
    passes[j] = 0;
    while (dr.step != izpi::kDrawDone) {
      dr.advance(seed0, seed1, k0, k1, depths[j]);
      ++passes[j];
    }
    for (int i = 0; i < 12; ++i) us[12 * j + i] = dr.us[i];
    if (sids[j] >= 0) {
      for (int i = 0; i < 5; ++i) cu[5 * j + i] = dr.cu[i];
      ul[j] = kLambda ? dr.ul : NAN;
      key[2 * j] = dr.key0;
      key[2 * j + 1] = dr.key1;
    }
    n_pairs[j] = lists[j] != 0u ? izpi::pairs_drawn(lists[j], dr.us[4]) : 0;
  }
}

extern "C" {
// out[j, :] = the 12 uniforms for use `salt` at depth depths[j] of the path
// keyed keys[j], pair by pair.
void pairs12(const uint32_t* keys, const uint32_t* depths, int n, uint32_t salt,
             float* out) {
  for (int j = 0; j < n; ++j) {
    uint32_t f0, f1;
    izpi::bounce_key(keys[2 * j], keys[2 * j + 1], depths[j], salt, f0, f1);
    for (int i = 0; i < 6; ++i)
      izpi::uniform_pair<12>(f0, f1, i, out[12 * j + i], out[12 * j + i + 6]);
  }
}

// One trip's draws per j: a new sample sids[j] of pixel pix[j] (sids[j] < 0:
// none), then a bounce with pair list lists[j] (0: none). Uniforms not drawn
// stay NaN; n_pairs counts the bounce's pairs by pairs_drawn.
void draws(int lambda, const uint32_t* keys, const uint32_t* depths, const uint32_t* lists,
           uint32_t seed0, uint32_t seed1, const int64_t* sids, const uint32_t* pix, int n,
           float* us, float* cu, float* ul, uint32_t* key, int* n_pairs, int* passes) {
  if (lambda) {
    run_draws<true>(keys, depths, lists, seed0, seed1, sids, pix, n, us, cu, ul, key,
                    n_pairs, passes);
  } else {
    run_draws<false>(keys, depths, lists, seed0, seed1, sids, pix, n, us, cu, ul, key,
                     n_pairs, passes);
  }
}
}
"""

METAL, DIELECTRIC, DIFFUSE = 0xFFFFF210, 0xFFFFFFF3, 0xFFFFFFF4
N_KEYS = 2048


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The host build of draws.cuh: a ctypes library."""
    import ctypes

    tmp = tmp_path_factory.mktemp("draws")
    (tmp / "draws_host.cpp").write_text(HOST_SOURCE)
    so = tmp / "libdraws_host.so"
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC",
                    f"-I{_build.CSRC}", "-o", str(so),
                    str(tmp / "draws_host.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    lib.pairs12.argtypes = [p, p, i, u, p]
    lib.draws.argtypes = [i, p, p, p, u, u, p, p, i] + [p] * 6
    return lib


def _ptr(a):
    """The address of numpy array `a`, which the caller keeps alive."""
    return a.ctypes.data


def _keys(seed, n=N_KEYS):
    rs = np.random.RandomState(seed)
    words = rs.randint(0, 2**32, (n, 2), dtype=np.uint64)
    words[::5] = 2**32 - 1 - rs.randint(0, 64, (words[::5].shape[0], 2))
    depths = rs.randint(0, 64, n).astype(np.uint64)
    depths[::7] = 2**32 - 1  # wraparound of the depth counter
    return words.astype(np.uint32), depths.astype(np.uint32)


def _reference(keys, depths, n, salt):
    """(N, n) uniforms of ops/threefry.py, as uint32 bits."""
    got = tf.uniforms_for_keys_reference(torch.as_tensor(keys.astype(np.int64)),
                                         torch.as_tensor(depths.astype(np.int64)),
                                         n, salt)
    return got.numpy().view(np.uint32)


@pytest.mark.parametrize("salt", [0, camera.CAMERA_SALT, 0xFFFFFFFF])
def test_every_pair_matches_the_twelve_uniforms(host, salt):
    keys, depths = _keys(1)
    out = np.empty((N_KEYS, 12), np.float32)
    host.pairs12(_ptr(keys), _ptr(depths), N_KEYS, salt & tf.MASK, _ptr(out))
    np.testing.assert_array_equal(out.view(np.uint32),
                                  _reference(keys, depths, 12, salt))


def _draws(host, lists, sids=None, pix=None, lam=False, seed=(0, 0)):
    n = lists.shape[0]
    lists = lists.astype(np.uint32)
    keys, depths = _keys(2, n)
    sids = np.full(n, -1, np.int64) if sids is None else sids
    pix = np.zeros(n, np.uint32) if pix is None else pix
    us = np.empty((n, 12), np.float32)
    cu = np.full((n, 5), np.nan, np.float32)
    ul = np.full(n, np.nan, np.float32)
    key = np.zeros((n, 2), np.uint32)
    n_pairs = np.empty(n, np.int32)
    passes = np.empty(n, np.int32)
    host.draws(int(lam), _ptr(keys), _ptr(depths), _ptr(lists),
               seed[0], seed[1], _ptr(sids), _ptr(pix), n, _ptr(us), _ptr(cu),
               _ptr(ul), _ptr(key), _ptr(n_pairs), _ptr(passes))
    return keys, depths, dict(us=us, cu=cu, ul=ul, key=key, n_pairs=n_pairs,
                              passes=passes)


def _read_by(lists, u4):
    """The uniform indices each material and branch reads (draws.cuh)."""
    light = [4, 10, 5, 11, 0, 6, 1, 7, 2, 8]
    cosine = [4, 10, 3, 9]
    return [[0, 6, 1, 7, 2, 8] if lst == METAL else [3, 9] if lst == DIELECTRIC
            else light if u < 0.5 else cosine for lst, u in zip(lists, u4)]


def test_bounce_draws_only_the_pairs_read(host):
    """Metal draws pairs 0-2, a dielectric pair 3, a diffuse scatter pair 4
    and then pairs 5, 0, 1, 2 (light sample, us[4] < 0.5) or pair 3 (cosine
    lobe): those uniforms carry the eager draw's bits, the others are never
    set, and a trip takes the two fold-ins plus one pass per pair."""
    lists = np.resize(np.array([METAL, DIELECTRIC, DIFFUSE], np.uint32), N_KEYS)
    keys, depths, got = _draws(host, lists)
    want = _reference(keys, depths, 12, 0)
    u4 = want[:, 4].view(np.float32)
    both = 0
    for j, read in enumerate(_read_by(lists, u4)):
        np.testing.assert_array_equal(got["us"][j, read].view(np.uint32),
                                      want[j, read])
        unread = np.setdiff1d(np.arange(12), read)
        assert np.isnan(got["us"][j, unread]).all()
        assert got["n_pairs"][j] == len(read) // 2
        assert got["passes"][j] == 2 + len(read) // 2
        both += lists[j] == DIFFUSE
    diffuse = lists == DIFFUSE
    assert 0.4 < (u4[diffuse] < 0.5).mean() < 0.6  # both lobes are drawn
    assert both > 600


@pytest.mark.parametrize("lam", [False, True])
def test_new_sample_draws_key_camera_and_lambda(host, lam):
    """After a bounce's pairs (or alone), a new sample's draws: its path key
    (core/rng.path_keys_perray), its five camera uniforms (CAMERA_SALT) and,
    for the spectral kernel, its λ uniform (LAMBDA_SALT), bit for bit, in 7
    passes (9 with λ, whose key reuses the camera's first fold-in)."""
    rs = np.random.RandomState(3)
    n = 512
    sids = rs.randint(0, 2**32, n, dtype=np.uint64).astype(np.int64)
    sids[::9] = 2**32 - 1
    pix = rs.randint(0, 1 << 20, n).astype(np.uint32)
    lists = np.resize(np.array([0, METAL, DIFFUSE], np.uint32), n)
    seed = (0x12345678, 0x9ABCDEF0)
    keys, depths, got = _draws(host, lists, sids, pix, lam, seed)
    base = torch.tensor(seed, dtype=torch.int64)
    new_keys = rng.path_keys_perray(base, torch.as_tensor(pix.astype(np.int64)),
                                    torch.as_tensor(sids))
    np.testing.assert_array_equal(got["key"], new_keys.numpy().astype(np.uint32))
    zeros = np.zeros(n, np.uint32)
    nk = new_keys.numpy().astype(np.uint32)
    np.testing.assert_array_equal(got["cu"].view(np.uint32),
                                  _reference(nk, zeros, 5, camera.CAMERA_SALT))
    if lam:
        np.testing.assert_array_equal(
            got["ul"].view(np.uint32),
            _reference(nk, zeros, 1, wavefront.LAMBDA_SALT)[:, 0])
    else:
        assert np.isnan(got["ul"]).all()
    bounce = np.where(lists == 0, 0, 2 + got["n_pairs"])
    assert (got["passes"] == bounce + (9 if lam else 7)).all()
    want = _reference(keys, depths, 12, 0)
    for j, read in enumerate(_read_by(lists, want[:, 4].view(np.float32))):
        if lists[j]:
            np.testing.assert_array_equal(got["us"][j, read].view(np.uint32),
                                          want[j, read])


# A persistent grid like the H100's at 72 registers: 7 blocks of 128 on
# each of 132 SMs.
CARD_GRID = (7 * 132, 128)


@pytest.mark.parametrize("mod", [megakernel, megakernel_spectral],
                         ids=["rgb", "spectral"])
def test_card_layout(mod, monkeypatch):
    """The wrappers' layout on the card: SLOTS_PER_THREAD slots per resident
    thread of the persistent grid asked of pick_replication, which the JAX
    rule given the same min_slots repeats. Cornell 256²@1024: 16 replicas,
    1,048,576 slots of 64 samples; the pyramid 500²@256: 4 replicas,
    1,000,000 slots of 64 samples."""
    asked = []
    monkeypatch.setattr(megakernel, "persistent_grid",
                        lambda entry, index: asked.append(entry) or CARD_GRID)
    dev = torch.device("cuda", 0)
    min_slots = megakernel.card_min_slots(mod.ENTRY, dev)
    assert min_slots == megakernel.SLOTS_PER_THREAD * CARD_GRID[0] * CARD_GRID[1]
    for n_pix, spp, want in ((256 * 256, 1024, (16, 64, 1 << 20)),
                             (500 * 500, 256, (4, 64, 1_000_000)),
                             (64 * 64, 64, (64, 1, 262_144)),
                             (128 * 128, 128, (64, 2, 1 << 20))):
        repl, spp_slot, n_slots = megakernel.slot_layout(n_pix, spp, min_slots)
        assert (repl, spp_slot, n_slots) == want
        # The wrapper launches this layout on the grid, no more blocks than
        # the slots need.
        assert megakernel.card_layout(mod.ENTRY, dev, n_pix, spp) == (
            *want, min(CARD_GRID[0], -(-n_slots // CARD_GRID[1])))
        assert repl == jmega._pick_replication(n_pix, spp, min_slots=min_slots)
        assert n_slots >= min(min_slots, n_pix * spp)
    # The default is the JAX rule's 8192 (tests/test_torch_megakernel.py).
    assert megakernel.slot_layout(256 * 256, 1024, megakernel.MIN_SLOTS)[0] == 1
    assert megakernel.card_layout(mod.ENTRY, dev, 4, 1)[3] == 1
    assert set(asked) == {mod.ENTRY}


@pytest.mark.parametrize("spectral", [False, True])
def test_plain_layouts_agree(spectral):
    """6×6 at 8 spp, depth 5, seed 4, samples from offset 3: one slot per
    pixel, two replicas and eight (the JAX rule's, and the card's shape)
    give ray counts equal and images within 1e-5 + 1e-5·|image|."""
    scene = cornell_box_pyramid_spectral() if spectral else cornell_box()
    cs, meta = compiler.compile_scene(scene, "cpu")
    ref = (megakernel_spectral.render_slots_spectral_reference if spectral
           else megakernel.render_slots_reference)
    s = path.RenderSettings(max_depth=5)
    out = {}
    for min_slots in (1, 72, megakernel.MIN_SLOTS):
        acc, rays = ref(cs, meta, s, 6, 6, 8, rng.render_key(4), 3,
                        min_slots=min_slots)
        out[megakernel.pick_replication(36, 8, min_slots)] = acc, int(rays)
    assert sorted(out) == [1, 2, 8]
    acc8, rays8 = out[8]
    for acc, rays in out.values():
        assert rays == rays8
        np.testing.assert_allclose(acc.numpy() / 8, acc8.numpy() / 8,
                                   rtol=1e-5, atol=1e-5)


def test_camera_row_stays_on_the_host():
    """The camera row the kernels take by value is packed into host memory,
    so a launch reads no device memory for it; `host_camera` gives its
    floats and refuses a row of another type or shape."""
    cs, _ = compiler.compile_scene(cornell_box(), "cpu")
    cam = megakernel.pack_tables(cs).cam
    assert cam.device.type == "cpu" and cam.dtype == torch.float32
    floats = megakernel.host_camera(cam)
    np.testing.assert_array_equal(np.asarray(floats, np.float32), cam.numpy())
    for bad in (cam.double(), cam[:-1]):
        with pytest.raises(ValueError, match="host float32"):
            megakernel.host_camera(bad)
