"""izpi_tpu_torch's spectral modules vs the JAX package's.

λ sampling must be bit-identical: it picks each path's wavelength, and
the two packages are compared path for path. The colour-matching lerps,
SPD lookups and material spectra agree to one f32 ulp (torch's and XLA's
CPU `exp` may differ in the last bit); the host-side numpy post-pass is
copied, so it agrees exactly. JAX runs eagerly, op by op: compiled, XLA
contracts multiply-adds into FMAs, which round differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from izpi_tpu.materials import spectral_eval as jeval
from izpi_tpu.scene.compiler import compile_scene as jcompile
from izpi_tpu.scene.library.cornell_spectral import cornell_box_spectral
from izpi_tpu.spectral import cie as jcie
from izpi_tpu.spectral import convert as jconvert
from izpi_tpu.spectral import spd as jspd
from izpi_tpu_torch.materials import spectral_eval as teval
from izpi_tpu_torch.spectral import cie as tcie
from izpi_tpu_torch.spectral import convert as tconvert
from izpi_tpu_torch.spectral import spd as tspd

def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _assert_within_ulp(got, want, ulps=1):
    """|got - want| within `ulps` f32 ulps of want. Below the smallest
    normal float the bound is that float: XLA's CPU flushes subnormal
    results to zero, torch keeps them (a Gaussian's far tail)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tiny = np.finfo(np.float32).tiny
    tol = np.maximum(ulps * np.spacing(np.abs(want)), tiny)
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


def _lattice_u():
    """u values the RNG can draw (multiples of 2^-23): 4096 random ones, 0,
    the largest, and the lattice points on both sides of every bin edge
    cum[i] / CIE_Y_INTEGRAL."""
    rs = np.random.RandomState(0)
    step = 2.0 ** -23
    edges = (jcie._CIE_Y_CUMSUM.astype(np.float32)
             / np.float32(jcie.CIE_Y_INTEGRAL)).astype(np.float64)
    k = np.floor(edges / step)
    ks = np.concatenate([rs.randint(0, 2**23, 4096), [0, 2**23 - 1],
                         k - 1, k, k + 1, k + 2])
    ks = np.clip(ks, 0, 2**23 - 1)
    return (ks * step).astype(np.float32)


def test_sample_wavelength_bit_identical():
    u = _lattice_u()
    with jax.disable_jit():
        lam_j, pdf_j = jcie.sample_wavelength(jnp.asarray(u))
    lam_t, pdf_t = tcie.sample_wavelength(torch.as_tensor(u))
    assert lam_t.dtype == torch.float32 and pdf_t.dtype == torch.float32
    np.testing.assert_array_equal(_bits(lam_t.numpy()), _bits(lam_j))
    np.testing.assert_array_equal(_bits(pdf_t.numpy()), _bits(pdf_j))
    # The edge cases are reached: u = 0 and a target past the last bin,
    # whose f32 cumsum ends at 21.371 < CIE_Y_INTEGRAL.
    assert lam_t[torch.as_tensor(u == 0)].eq(380.0).all()
    assert bool((lam_t == 750.0).any())


def test_tables_copied_verbatim():
    for name in ("CIE_X", "CIE_Y", "CIE_Z", "CIE_WAVELENGTHS", "_CIE_Y_CUMSUM"):
        np.testing.assert_array_equal(getattr(tcie, name), getattr(jcie, name))
    assert tcie.CIE_Y_INTEGRAL == jcie.CIE_Y_INTEGRAL == 21.3768
    np.testing.assert_array_equal(tspd.DEVICE_GRID, jspd.DEVICE_GRID)


@pytest.mark.parametrize("lo,hi", [(380.0, 750.0), (300.0, 800.0)])
def test_get_cie_values_within_an_ulp(lo, hi):
    lam = np.random.RandomState(1).uniform(lo, hi, 2048).astype(np.float32)
    with jax.disable_jit():
        want = jcie.get_cie_values(jnp.asarray(lam))
    got = tcie.get_cie_values(torch.as_tensor(lam))
    for g, w in zip(got, want):
        _assert_within_ulp(g.numpy(), w)


@pytest.fixture(scope="module")
def spd_table():
    cs, _ = jcompile(cornell_box_spectral(with_prism=True))
    return np.asarray(cs.spd_table)


def test_device_spd_value_within_an_ulp(spd_table):
    rs = np.random.RandomState(2)
    ids = rs.randint(0, spd_table.shape[0], 4096).astype(np.int32)
    lam = rs.uniform(370.0, 760.0, 4096).astype(np.float32)
    with jax.disable_jit():
        want = jspd.device_spd_value(jnp.asarray(spd_table), jnp.asarray(ids),
                                     jnp.asarray(lam))
    got = tspd.device_spd_value(torch.tensor(spd_table),
                                torch.as_tensor(ids), torch.as_tensor(lam))
    _assert_within_ulp(got.numpy(), want)


@pytest.mark.parametrize("peak,ulps", [("one", 1), ("random", 2)])
def test_spectral_value_within_an_ulp(spd_table, peak, ulps):
    """Rows with an SPD, a Gaussian or neither (the luma fallback). torch's
    and XLA's CPU `exp` differ by one ulp on ~9% of inputs: with a peak of 1
    the Gaussian is that exp, within one ulp; a random peak's product may
    round that ulp into a second."""
    rs = np.random.RandomState(3)
    n = 3000
    kind = np.arange(n) % 3
    ids = np.where(kind == 0, rs.randint(0, spd_table.shape[0], n), -1)
    peaks = rs.uniform(0.1, 2.0, n) if peak == "random" else np.ones(n)
    gauss = np.stack([peaks, rs.uniform(400, 700, n),
                      np.where(kind == 1, rs.uniform(5, 120, n), 0.0)], 1)
    lam = rs.uniform(380.0, 750.0, n)
    rgb = rs.uniform(0.0, 1.0, (n, 3))
    args = [ids.astype(np.int32), gauss.astype(np.float32),
            lam.astype(np.float32), rgb.astype(np.float32)]
    with jax.disable_jit():
        j = [jnp.asarray(a) for a in args]
        luma_j = jeval.luminance(j[3])
        want = jeval.spectral_value(jnp.asarray(spd_table), j[0], j[1], j[2],
                                    luma_j)
    t = [torch.as_tensor(a) for a in args]
    luma_t = teval.luminance(t[3])
    got = teval.spectral_value(torch.tensor(spd_table), t[0], t[1], t[2],
                               luma_t)
    np.testing.assert_array_equal(_bits(luma_t.numpy()), _bits(luma_j))
    exact = kind != 1
    np.testing.assert_array_equal(_bits(got.numpy()[exact]),
                                  _bits(np.asarray(want)[exact]))
    _assert_within_ulp(got.numpy(), want, ulps)


def test_firefly_rejection_and_acescg_exact():
    rs = np.random.RandomState(4)
    xyz = rs.exponential(1.0, (12, 10, 3))
    xyz[3, 4] *= 400.0  # a firefly
    xyz[0, 0] = 0.0
    want = jconvert.firefly_rejection(xyz)
    got = tconvert.firefly_rejection(xyz)
    np.testing.assert_array_equal(got, want)
    assert got[3, 4, 1] < xyz[3, 4, 1]
    np.testing.assert_array_equal(tconvert.xyz_to_acescg(got, 1.7),
                                  jconvert.xyz_to_acescg(want, 1.7))


def test_host_spd_class_matches():
    w = np.arange(380.0, 751.0, 10.0)
    v = np.sin(w / 50.0) + 2.0
    lam = np.linspace(350.0, 780.0, 99)
    t, j = tspd.SPD(w, v), jspd.SPD(w, v)
    np.testing.assert_array_equal(t.value(lam), j.value(lam))
    np.testing.assert_array_equal(t.to_device_grid(), j.to_device_grid())
    np.testing.assert_array_equal(t.scaled(0.5).values, j.scaled(0.5).values)
    np.testing.assert_array_equal(tspd.SPD.constant(0.73).to_device_grid(),
                                  jspd.SPD.constant(0.73).to_device_grid())
    np.testing.assert_array_equal(tspd.blackbody(6500.0).values,
                                  jspd.blackbody(6500.0).values)
