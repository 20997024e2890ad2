"""izpi_tpu_torch's Threefry and RNG vs the JAX package: bit-identical.

Everything here is compared with assert_array_equal (no tolerance): the port
reproduces the JAX package's sample streams bit for bit, which is what lets
the image tests compare path for path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from izpi_tpu.core import rng as jrng
from izpi_tpu.ops import threefry as jtf
from izpi_tpu_torch.core import rng as trng
from izpi_tpu_torch.ops import threefry as ttf

M = 0xFFFFFFFF


def _words(seed, n):
    """n uint32 words, a quarter of them within 64 of 2**32 (wraparound)."""
    rs = np.random.RandomState(seed)
    w = rs.randint(0, 2**32, size=n, dtype=np.uint64)
    w[::4] = 2**32 - 1 - rs.randint(0, 64, size=w[::4].shape[0])
    return w.astype(np.uint32)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.uint32).astype(np.int64))


def _np(t):
    return t.numpy().astype(np.uint32)


def test_cipher_bit_identical():
    k0, k1, x0, x1 = (_words(s, 512) for s in range(4))
    want = jtf.threefry2x32(jnp.asarray(k0), jnp.asarray(k1), jnp.asarray(x0),
                            jnp.asarray(x1))
    got = ttf.threefry2x32(_t(k0), _t(k1), _t(x0), _t(x1))
    np.testing.assert_array_equal(_np(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))


def test_cipher_matches_jax_random_primitive():
    from jax._src import prng as jax_prng

    x = _words(9, 10)
    got = ttf.threefry2x32(torch.tensor(0xDEADBEEF), torch.tensor(0xCAFEBABE),
                           _t(x[:5]), _t(x[5:]))
    want = np.asarray(jax_prng.threefry_2x32(
        (jnp.uint32(0xDEADBEEF), jnp.uint32(0xCAFEBABE)), jnp.asarray(x)))
    np.testing.assert_array_equal(_np(got[0]), want[:5])
    np.testing.assert_array_equal(_np(got[1]), want[5:])


def test_fold_in_bit_identical():
    k0, k1, d = (_words(s, 256) for s in (10, 11, 12))
    want = jtf.fold_in(jnp.asarray(k0), jnp.asarray(k1), jnp.asarray(d))
    got = ttf.fold_in(_t(k0), _t(k1), _t(d))
    np.testing.assert_array_equal(_np(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))


def test_fold_in_matches_jax_random():
    key = jax.random.PRNGKey(1234)
    raw = np.asarray(jax.random.key_data(key)).astype(np.int64)
    for d in [0, 1, 17, 65535, 2**31 - 1]:
        want = np.asarray(jax.random.key_data(jax.random.fold_in(key, d)))
        g0, g1 = ttf.fold_in(torch.tensor(raw[0]), torch.tensor(raw[1]), d)
        assert (int(g0), int(g1)) == (int(want[0]), int(want[1]))


def test_bits_to_uniform_bit_identical():
    bits = np.concatenate([_words(13, 500), np.uint32([0, 1, 511, 512, M])])
    want = np.asarray(jtf.bits_to_uniform(jnp.asarray(bits)))
    got = ttf.bits_to_uniform(_t(bits)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.dtype == np.float32 and got.min() >= 0.0 and got.max() < 1.0


@pytest.mark.parametrize("n", [2, 4, 5, 12])
def test_uniforms_n_bit_identical(n):
    k0, k1 = _words(20 + n, 300), _words(40 + n, 300)
    want = jtf.uniforms_n(jnp.asarray(k0), jnp.asarray(k1), n)
    got = ttf.uniforms_n(_t(k0), _t(k1), n)
    assert len(got) == n
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w).view(np.uint32))


@pytest.mark.parametrize("n", [5, 12])
def test_uniforms_use_classic_counter_layout(n):
    """Counters [0..n-1] zero-padded to even length, halves paired through
    jax's own cipher primitive; for odd n the pad's word is dropped."""
    from jax._src import prng as jax_prng

    raw = np.asarray(jax.random.PRNGKey(77)).astype(np.uint32)
    half = (n + 1) // 2
    bits = jax_prng.threefry_2x32((jnp.uint32(raw[0]), jnp.uint32(raw[1])),
                                  jnp.arange(2 * half, dtype=jnp.uint32))
    want = np.asarray(jtf.bits_to_uniform(bits))[:n]
    got = ttf.uniforms_n(_t(raw[0:1]), _t(raw[1:2]), n)
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 3, 2**31 - 1])
def test_render_key(seed):
    want = np.asarray(jrng.render_key(seed))
    got = trng.render_key(seed)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(_np(got), want)


def test_path_keys_perray_bit_identical():
    key = jrng.render_key(5)
    pix = np.random.RandomState(1).randint(0, 1 << 20, 400).astype(np.int32)
    samp = _words(2, 400)
    want = np.asarray(jrng.path_keys_perray(key, jnp.asarray(pix),
                                            jnp.asarray(samp)))
    got = trng.path_keys_perray(trng.render_key(5), torch.as_tensor(pix),
                                _t(samp))
    np.testing.assert_array_equal(_np(got), want)


def test_path_keys_matches_perray():
    key = jrng.render_key(9)
    pix = np.arange(100, dtype=np.int32)
    want = np.asarray(jrng.path_keys(key, jnp.asarray(pix), 7))
    got = trng.path_keys(trng.render_key(9), torch.as_tensor(pix), 7)
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("n,salt", [(12, 0), (5, 0x5EED), (1, 0x7A3B)])
def test_bounce_uniforms_perray_bit_identical(n, salt):
    keys = np.stack([_words(3, 300), _words(4, 300)], axis=-1)
    depths = np.random.RandomState(5).randint(0, 50, 300).astype(np.int32)
    want = np.asarray(jrng.bounce_uniforms_perray(
        jnp.asarray(keys), jnp.asarray(depths), n, salt=salt))
    got = trng.bounce_uniforms_perray(_t(keys), torch.as_tensor(depths), n,
                                      salt=salt)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


def test_uniforms_for_keys_on_cpu_runs_plain_version():
    keys = _t(np.stack([_words(6, 64), _words(7, 64)], axis=-1))
    depths = torch.arange(64)
    before = ttf.launches
    got = ttf.uniforms_for_keys(keys, depths, 12, 0)
    assert ttf.launches == before
    np.testing.assert_array_equal(
        got.numpy(), trng.bounce_uniforms_perray(keys, depths, 12).numpy())
