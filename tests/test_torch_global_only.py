"""model="global" (atlasqtl_tpu_torch/models/global_only.py) held against
the JAX package: one iteration (1e-12 relative, 1e-10 absolute) and the
ELBO (1e-10 relative) in float64 from an identical state handed over by
convert.py (complete data, impute, exact missing; annealed and not), and the model="global" fits of tests/test_e2e.py, end to
end, with test_e2e.py's checks (convergence, a monotone ELBO, the
hotspots) and the port's outputs within tests/test_torch_model.py's
tolerances of the JAX fit.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import atlasqtl_tpu as aq
from atlasqtl_tpu.types import Config as JConfig
from atlasqtl_tpu.models import global_local as jgl
from atlasqtl_tpu.models import global_only as jgo
from atlasqtl_tpu.inference import elicitation as jelic
from atlasqtl_tpu.io.prepare import prepare_data
from atlasqtl_tpu.ops.sweep import block_gram as j_block_gram

import atlasqtl_tpu_torch as at
from atlasqtl_tpu_torch import convert
from atlasqtl_tpu_torch.models import global_only as tgo
from atlasqtl_tpu_torch.ops.sweep import block_gram as t_block_gram

from conftest import simulate_fixture

OUTPUTS = ("gam_vb", "beta_vb", "theta_vb", "zeta_vb")


def _arrays(obj):
    return {f.name: None if getattr(obj, f.name) is None
            else np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("annealed", [False, True])
@pytest.mark.parametrize("missing", [None, "exact", "impute"])
def test_one_iteration_and_elbo_f64(missing, annealed):
    y, x, _ = simulate_fixture(missing_frac=0.2 if missing else 0.0, seed=5)
    dat = prepare_data(y, x, 0.1, 1000)
    p, q = dat.x.shape[1], dat.y.shape[1]
    kw = dict(block_size=32, shr_fac_inv=float(q), missing=missing or "exact")
    jcfg = JConfig(dtype=jnp.float64, **kw)
    data = jgl.build_data(dat.x, dat.y, jcfg)
    hyper = jgl.build_hyper(jelic.auto_set_hyper(dat.y, p, (4, 16)),
                            data.y.shape[1], jcfg)
    state = jgl.build_state(jelic.auto_set_init(dat.y, p, (4, 16), float(q),
                                                7), data, jcfg)
    tdata = convert.data_from_numpy(_arrays(data), device="cpu")
    thyper = convert.hyper_from_numpy(_arrays(hyper), device="cpu")
    tstate = convert.state_from_numpy(_arrays(state), device="cpu")
    exact = data.x_norm_sq is not None
    jg = jnp.zeros((1, 1, 1)) if exact else j_block_gram(data.x, 32)
    tg = None if exact else t_block_gram(tdata.x, 32)
    c = 0.4 if annealed else 1.0
    j1 = jgo.cavi_iteration(data, hyper, state, jg, c, c, cfg=jcfg,
                            annealed=annealed)
    tcfg = at.Config(dtype=torch.float64, **kw)
    t1 = tgo.cavi_iteration(tdata, thyper, tstate, tg, c, c, cfg=tcfg,
                            annealed=annealed)
    for f in dataclasses.fields(t1):
        a, b = getattr(t1, f.name), getattr(j1, f.name)
        assert (a is None) == (b is None), f.name
        if b is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=1e-12, atol=1e-10,
                                       err_msg=f.name)
    lj = float(jgo.compute_elbo(data, hyper, j1, cfg=jcfg))
    lt = float(tgo.compute_elbo(tdata, thyper, t1, cfg=tcfg))
    np.testing.assert_allclose(lt, lj, rtol=1e-10)


def _monotone(hist):
    lbs = np.array([lb for _, lb in hist])
    return np.all(np.diff(lbs) >= -1e-6 * np.abs(lbs[:-1]))


def _pair(y, x, **kw):
    port = at.atlasqtl(y, x, p0=(5, 25), dtype=torch.float64, verbose=0,
                       device="cpu", model="global", **kw)
    ref = aq.atlasqtl(y, x, p0=(5, 25), dtype=jnp.float64, verbose=0,
                      model="global", **kw)
    assert port.converged == ref.converged and port.it == ref.it
    for name in OUTPUTS:
        np.testing.assert_allclose(getattr(port, name), getattr(ref, name),
                                   rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(port.lb_opt, ref.lb_opt, rtol=1e-9)
    return port


def test_global_only_model(fixture_small):
    """test_e2e.py::test_global_only_model on the port."""
    y, x, p_act = fixture_small
    res = _pair(y, x, user_seed=123)
    assert res.converged and _monotone(res.elbo_history)
    hot = res.hotspot_sizes()
    assert (hot[:p_act] > 10).all()
    assert hot[p_act:].max() <= 2


def test_global_only_no_annealing(fixture_small):
    y, x, _ = fixture_small
    res = _pair(y, x, anneal=None, user_seed=2)
    assert res.converged and _monotone(res.elbo_history)


def test_global_model_impute_mode():
    """test_e2e.py::test_global_model_impute_mode on the port: impute and
    exact, each against JAX, and the two modes' PIPs close."""
    y, x, _ = simulate_fixture(missing_frac=0.15, seed=5)
    res = _pair(y, x, user_seed=11, maxit=600, missing="impute")
    assert res.converged and _monotone(res.elbo_history)
    res_e = _pair(y, x, user_seed=11, maxit=600, missing="exact")
    assert np.abs(res.gam_vb - res_e.gam_vb).mean() < 0.03
