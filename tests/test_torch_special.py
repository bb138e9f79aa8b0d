"""The port's special-function helpers (A15: atlasqtl_tpu_torch/ops/special.py
log1pexp, probit_tail_stats, mills_ratios_from_stats, probit_logit_fast,
mills_fast, owens_t; ops/updates.py beta_mean, m2_beta) on the cases of
tests/test_special.py, each against its JAX counterpart on the same seeded
inputs in float64 and float32 (and, where test_special.py does, against
SciPy).

Tolerances.  float64: the port's function equals JAX's to 1e-12 relative
(plus 1e-300 absolute for values that underflow alike), the same formula
in another library.  float32: 4 ulps relative, plus 4e-6 absolute for the
Horner fits near their zero crossings and 1e-6 for the sums; infinities
and their signs equal.  beta_mean and m2_beta: bit for bit in both dtypes
(one product and one sum per element).
"""
import numpy as np
import pytest
import scipy.special as sps
import scipy.stats as sst
import torch
import jax.numpy as jnp

from atlasqtl_tpu.ops import special as jsp
from atlasqtl_tpu.ops import updates as jupd

from atlasqtl_tpu_torch.ops import special as sp
from atlasqtl_tpu_torch.ops import updates as upd

DTYPES = [(torch.float64, jnp.float64, np.float64),
          (torch.float32, jnp.float32, np.float32)]


def _close(got, ref, dtype, atol32=4e-6):
    """got (torch) against ref (JAX or NumPy) under the module's rule."""
    got = got.numpy().astype(np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    inf = np.isinf(ref)
    np.testing.assert_array_equal(np.isinf(got), inf)
    np.testing.assert_array_equal(got[inf], ref[inf])
    if dtype == torch.float64:
        np.testing.assert_allclose(got[~inf], ref[~inf], rtol=1e-12,
                                   atol=1e-300)
    else:
        np.testing.assert_allclose(got[~inf], ref[~inf],
                                   rtol=4 * np.finfo(np.float32).eps,
                                   atol=atol32)


@pytest.mark.parametrize("tdt,jdt,ndt", DTYPES)
def test_log1pexp(tdt, jdt, ndt):
    x = np.array([-800.0, -30.0, -1.0, 0.0, 1.0, 30.0, 800.0])
    if ndt == np.float32:
        x = np.array([-80.0, -30.0, -1.0, 0.0, 1.0, 30.0, 80.0])
    got = sp.log1pexp(torch.as_tensor(x, dtype=tdt))
    assert got.dtype == tdt
    _close(got, jsp.log1pexp(jnp.asarray(x, jdt)), tdt, atol32=1e-6)
    if tdt == torch.float64:   # test_special.py's own check
        np.testing.assert_allclose(got.numpy(), np.logaddexp(x, 0.0),
                                   rtol=1e-14)


@pytest.mark.parametrize("tdt,jdt,ndt", DTYPES)
def test_owens_t(tdt, jdt, ndt):
    rng = np.random.default_rng(0)
    h = np.concatenate([[0.1, 0.5, 1.0, 2.0, 4.0], rng.uniform(0, 5, 20)])
    a = np.concatenate([[0.05, 0.3, 0.7, 0.9, 1.0], rng.uniform(0, 1, 20)])
    got = sp.owens_t(torch.as_tensor(h, dtype=tdt),
                     torch.as_tensor(a, dtype=tdt))
    assert got.dtype == tdt
    _close(got, jsp.owens_t(jnp.asarray(h, jdt), jnp.asarray(a, jdt)), tdt,
           atol32=1e-6)
    if tdt == torch.float64:
        np.testing.assert_allclose(got.numpy(), sps.owens_t(h, a),
                                   atol=1e-12)


@pytest.mark.parametrize("tdt,jdt,ndt", DTYPES)
def test_probit_tail_stats(tdt, jdt, ndt):
    """(e, g, d) and the Mills ratios from them against JAX's at the
    pre-saturation range and at the saturated tails (d = -inf, +inf), and
    in float64 against SciPy as test_special.py holds JAX's."""
    u = np.concatenate([np.linspace(-12.5, 12.5, 2001), [-40.0, 40.0]])
    ut, uj = torch.as_tensor(u, dtype=tdt), jnp.asarray(u, jdt)
    got, ref = sp.probit_tail_stats(ut), jsp.probit_tail_stats(uj)
    for a, r in zip(got, ref):
        assert a.dtype == tdt
        _close(a, r, tdt)
    mills = sp.mills_ratios_from_stats(ut, *got[:2])
    for a, r in zip(mills, jsp.mills_ratios_from_stats(uj, *ref[:2])):
        _close(a, r, tdt)
    if tdt == torch.float32:
        assert got[2][-2] == -np.inf and got[2][-1] == np.inf
        np.testing.assert_allclose(np.asarray([m[-2:] for m in mills]),
                                   [[40.02497, 0.0], [0.0, -40.02497]],
                                   atol=1e-3)
    else:
        c = slice(0, 2001)
        np.testing.assert_allclose(got[2][c].numpy(),
                                   sps.log_ndtr(u[c]) - sps.log_ndtr(-u[c]),
                                   atol=4e-7, rtol=4e-7)
        pdf = sst.norm.pdf(u[c])
        np.testing.assert_allclose(
            mills[0][c].numpy(), np.maximum(pdf / sst.norm.cdf(u[c]), -u[c]),
            atol=2e-6, rtol=2e-6)
        np.testing.assert_allclose(
            mills[1][c].numpy(),
            np.minimum(-pdf / sst.norm.cdf(-u[c]), -u[c]),
            atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("tdt,jdt,ndt", DTYPES)
def test_probit_logit_fast_and_mills_fast(tdt, jdt, ndt):
    """The polynomial-only paths against JAX's across both fit branches
    and the clamp at |u| = 40, and against SciPy in float64 on exact-f32
    inputs at test_special.py's bounds."""
    u = np.concatenate([np.linspace(-36, 36, 50001),
                        np.linspace(-8, 8, 50001), [-50.0, 0.0, 50.0]])
    u = u.astype(np.float32).astype(ndt)
    ut, uj = torch.as_tensor(u, dtype=tdt), jnp.asarray(u, jdt)
    d = sp.probit_logit_fast(ut)
    assert d.dtype == tdt
    _close(d, jsp.probit_logit_fast(uj), tdt, atol32=2e-5)
    for a, r in zip(sp.mills_fast(ut), jsp.mills_fast(uj)):
        assert a.dtype == tdt
        _close(a, r, tdt)
    assert abs(float(d[-2])) < 1e-6 and d[-3] < -700 and d[-1] > 700
    if tdt == torch.float64:
        c = slice(0, -3)
        d_ref = sps.log_ndtr(u[c]) - sps.log_ndtr(-u[c])
        m = np.abs(u[c]) <= 6.5
        np.testing.assert_allclose(d[c].numpy()[m], d_ref[m], atol=3e-6)
        np.testing.assert_allclose(d[c].numpy()[~m], d_ref[~m], atol=2e-5)


@pytest.mark.parametrize("tdt,jdt,ndt", DTYPES)
def test_beta_moments(tdt, jdt, ndt):
    """beta_mean and m2_beta against JAX's with a (q,) and a (p, q) slab
    variance, bit for bit."""
    rng = np.random.default_rng(6)
    gam = rng.uniform(size=(7, 5)).astype(ndt)
    mu = rng.normal(size=(7, 5)).astype(ndt)
    t = lambda a: torch.as_tensor(a, dtype=tdt)
    j = lambda a: jnp.asarray(a, jdt)
    np.testing.assert_array_equal(upd.beta_mean(t(gam), t(mu)).numpy(),
                                  np.asarray(jupd.beta_mean(j(gam), j(mu))))
    for s2 in (rng.uniform(0.1, 1.0, 5), rng.uniform(0.1, 1.0, (7, 5))):
        s2 = s2.astype(ndt)
        got = upd.m2_beta(t(gam), t(mu), t(s2))
        assert got.dtype == tdt
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jupd.m2_beta(j(gam), j(mu), j(s2))))
