"""The port's device-side random init (atlasqtl_tpu_torch/models/
global_local.py:auto_init_device) drawn with a CPU generator: the moment
tests of tests/test_dev_init.py at (n, p, q) = (120, 256, 2048) in float64,
the fields, shapes and dtypes of build_state's state (complete data, impute
and exact missing), and C4: its tau equals the host init's (np.nanvar over
the true rows) to 1e-12 at n % 8 != 0 with NaN in Y, where the JAX
package's device init (the padded rows, NaN zeroed) differs.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from scipy.special import digamma, ndtr

from atlasqtl_tpu.types import Config as JConfig
from atlasqtl_tpu.models import global_local as jgl

from atlasqtl_tpu_torch.types import Config
from atlasqtl_tpu_torch.models import global_local as gl
from atlasqtl_tpu_torch.inference import elicitation as elic


@pytest.fixture(scope="module")
def draws():
    n, p, q = 120, 256, 2048
    rng = np.random.default_rng(7)
    x = rng.binomial(2, 0.3, size=(n, p)).astype(np.float64)
    x = x[:, x.std(0) > 0][:, :p]
    p = x.shape[1]
    y = rng.normal(size=(n, q))
    cfg = Config(dtype=torch.float64, shr_fac_inv=float(q))
    data = gl.build_data(x, y, cfg, "cpu")
    dev = gl.auto_init_device(0, data, (5.0, 25.0), float(q), cfg)
    host = elic.auto_set_init(y, p, (5.0, 25.0), float(q), user_seed=1)
    n0, t02 = elic.get_n0_t02(1, p, (5.0, 25.0))
    return data, dev, host, p, q, float(n0[0]), float(t02)


def test_gam_mean_matches(draws):
    data, dev, host, p, q, n0, t02 = draws
    g_dev = dev.gam[:p, :q].numpy()
    # both are Phi(n0 + (s02 + t02) Z): sample means (SE ~ 1e-4) against
    # each other and against E = Phi(n0 / sqrt(1 + (s02 + t02)^2))
    assert abs(g_dev.mean() - host.gam_vb.mean()) < 2e-3
    assert abs(g_dev.mean() - ndtr(n0 / np.sqrt(1 + (1e-4 + t02) ** 2))) \
        < 2e-3
    assert (dev.gam[p:] == 0).all() and (dev.mu_beta[p:] == 0).all()


def test_sig2_beta_distribution_matches(draws):
    data, dev, host, p, q, n0, t02 = draws
    s_dev = dev.sig2_beta[:q].numpy()
    # 1/sig2_beta = g2 sig2_inv tau, g2 ~ Gamma(2, 1): E[log sig2_beta] =
    # -psi(2) - log(sig2_inv tau), Var = psi'(2) ~ 0.645
    tau = float(host.tau_vb[0])
    theory = -float(digamma(2.0)) - np.log(1e-2 * tau)
    assert abs(np.log(s_dev).mean() - theory) < 0.1
    assert abs(np.log(s_dev).mean() - np.log(host.sig2_beta_vb).mean()) < 0.15
    assert abs(np.log(s_dev).var() - 0.6449) < 0.1


def test_tau_matches_host(draws):
    data, dev, host, p, q, n0, t02 = draws
    np.testing.assert_allclose(dev.tau[:q].numpy(), host.tau_vb, rtol=1e-12)


def test_zeta_moments(draws):
    data, dev, host, p, q, n0, t02 = draws
    z = dev.zeta[:q].numpy()
    assert abs(z.mean() - n0) < 4 * np.sqrt(t02 / q)
    assert abs(z.var(ddof=1) / t02 - 1.0) < 0.15


def test_theta_scale_consistent(draws):
    data, dev, host, p, q, n0, t02 = draws
    th = dev.theta[:p].numpy()
    s0 = float(dev.sig02_inv)
    # theta ~ N(0, 1/(sig02_inv shr_fac_inv)) given the drawn sig02_inv,
    # sig02_inv ~ Gamma(max(p, q)) (mean max(p, q), sd its square root)
    assert abs(th.var(ddof=1) * s0 * q - 1.0) < 0.5
    assert abs(s0 - q) < 5 * np.sqrt(q)


def test_fitted_and_column_sums_follow_the_draw(draws):
    data, dev, host, p, q, n0, t02 = draws
    beta = dev.gam * dev.mu_beta
    np.testing.assert_allclose(dev.fitted.numpy(), (data.x @ beta).numpy(),
                               atol=1e-10)
    np.testing.assert_allclose(dev.beta.numpy(), beta.numpy(), atol=0)
    np.testing.assert_allclose(dev.gam_colsum.numpy(),
                               dev.gam.sum(0).numpy(), rtol=1e-12)


def test_generator_seeds_the_draw():
    """The same seed draws the same state; another seed another; an explicit
    generator is used as given."""
    rng = np.random.default_rng(2)
    x, y = rng.normal(size=(40, 30)), rng.normal(size=(40, 16))
    cfg = Config(dtype=torch.float64, shr_fac_inv=16.0)
    data = gl.build_data(x, y, cfg, "cpu")
    draw = lambda s, **k: gl.auto_init_device(s, data, (2.0, 4.0), 16.0, cfg,
                                              **k)
    assert torch.equal(draw(5).gam, draw(5).gam)
    assert not torch.equal(draw(5).gam, draw(6).gam)
    g = torch.Generator().manual_seed(5)
    assert torch.equal(draw(None, generator=g).mu_beta, draw(5).mu_beta)


def _c4_problem(missing):
    rng = np.random.default_rng(11)
    n, p, q = 101, 40, 60          # n % 8 != 0
    x = rng.normal(size=(n, p))
    y = rng.normal(size=(n, q)) * rng.uniform(0.5, 2.0, q)
    y[rng.uniform(size=y.shape) < 0.2] = np.nan
    return x, y


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("missing", [None, "exact", "impute"])
def test_fields_shapes_dtypes_equal_build_state(missing, dtype):
    x, y = _c4_problem(missing)
    if missing is None:
        y = np.nan_to_num(y)
    cfg = Config(dtype=dtype, shr_fac_inv=60.0, missing=missing or "exact",
                 block_size=16)
    data = gl.build_data(x, y, cfg, "cpu")
    dev = gl.auto_init_device(1, data, (2.0, 4.0), 60.0, cfg)
    ref = gl.build_state(elic.auto_set_init(y, 40, (2.0, 4.0), 60.0, 1),
                         data, cfg)
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(dev, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            assert a.shape == b.shape and a.dtype == b.dtype, f.name
            assert torch.isfinite(b).all(), f.name


@pytest.mark.parametrize("missing", ["exact", "impute"])
def test_c4_tau_takes_the_host_rule(missing):
    """C4: at n % 8 != 0 with NaN in Y the port's device-drawn tau equals
    auto_set_init's to 1e-12; the JAX package's device init, which takes
    the variance over the padded rows with NaN cells zeroed, does not."""
    x, y = _c4_problem(missing)
    q = y.shape[1]
    cfg = Config(dtype=torch.float64, shr_fac_inv=float(q), missing=missing)
    data = gl.build_data(x, y, cfg, "cpu")
    dev = gl.auto_init_device(3, data, (2.0, 4.0), float(q), cfg)
    host = elic.auto_set_init(y, x.shape[1], (2.0, 4.0), float(q), 1)
    np.testing.assert_allclose(dev.tau[:q].numpy(), host.tau_vb, rtol=1e-12)
    jcfg = JConfig(dtype=jnp.float64, shr_fac_inv=float(q), missing=missing)
    jdev = jgl.auto_init_device(3, jgl.build_data(x, y, jcfg), (2.0, 4.0),
                                float(q), jcfg)
    assert abs(float(jdev.tau[0]) / host.tau_vb[0] - 1.0) > 1e-3
