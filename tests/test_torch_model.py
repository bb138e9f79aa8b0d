"""The port's CAVI iteration, ELBO, driver and entry point held against the
JAX package: one iteration + ELBO in float64 from an identical state handed
over by convert.py; three float32 iterations through the fused sweep (the
JAX kernel in interpret mode, the port's plain version); the float64
end-to-end fit; and the committed golden file.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import atlasqtl_tpu as aq
from atlasqtl_tpu.types import Config as JConfig
from atlasqtl_tpu.models import global_local as jgl
from atlasqtl_tpu.inference import elicitation as jelic
from atlasqtl_tpu.io.prepare import prepare_data
from atlasqtl_tpu.ops.sweep import block_gram as j_block_gram

import atlasqtl_tpu_torch as at
from atlasqtl_tpu_torch import convert
from atlasqtl_tpu_torch.models import global_local as tgl
from atlasqtl_tpu_torch.ops.sweep import block_gram as t_block_gram
from atlasqtl_tpu_torch.ops import sweep_fused as tsf

from conftest import simulate_fixture

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


def _arrays(obj):
    return {f.name: None if getattr(obj, f.name) is None
            else np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _jax_problem(dtype, block, q_pad_to, n=100, p=75, q=20, seed=123):
    y, x, _ = simulate_fixture(n=n, p=p, p_act=8, q=q, seed=seed)
    dat = prepare_data(y, x, 0.1, 1000)
    p_eff, q_eff = dat.x.shape[1], dat.y.shape[1]
    cfg = dict(block_size=block, shr_fac_inv=float(q_eff))
    jcfg = JConfig(dtype=dtype, **cfg)
    data = jgl.build_data(dat.x, dat.y, jcfg, q_pad_to=q_pad_to)
    hyper = jgl.build_hyper(jelic.auto_set_hyper(dat.y, p_eff, (4, 16)),
                            data.y.shape[1], jcfg)
    state = jgl.build_state(jelic.auto_set_init(dat.y, p_eff, (4, 16),
                                                float(q_eff), 7), data, jcfg)
    tdt = torch.float64 if dtype == jnp.float64 else torch.float32
    port = (convert.data_from_numpy(_arrays(data), device="cpu"),
            convert.hyper_from_numpy(_arrays(hyper), device="cpu"),
            convert.state_from_numpy(_arrays(state), device="cpu"))
    return (data, hyper, state, jcfg), port, cfg, tdt


@pytest.mark.parametrize("annealed", [False, True])
def test_one_iteration_and_elbo_f64(annealed):
    (data, hyper, state, jcfg), (tdata, thyper, tstate), cfg, tdt = \
        _jax_problem(jnp.float64, 128, 8)
    c = 0.4 if annealed else 1.0
    j1 = jgl.cavi_iteration(data, hyper, state, j_block_gram(data.x, 80), c,
                            c, cfg=jcfg, annealed=annealed)
    tcfg = at.Config(dtype=tdt, **cfg)
    t1 = tgl.cavi_iteration(tdata, thyper, tstate,
                            t_block_gram(tdata.x, 80), c, c, cfg=tcfg,
                            annealed=annealed)
    for f in dataclasses.fields(t1):
        a, b = getattr(t1, f.name), getattr(j1, f.name)
        if b is None:
            continue
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-10, err_msg=f.name)
    lj = float(jgl.compute_elbo(data, hyper, j1, cfg=jcfg))
    lt = float(tgl.compute_elbo(tdata, thyper, t1, cfg=tcfg))
    np.testing.assert_allclose(lt, lj, rtol=1e-10)


def test_three_fused_iterations_f32():
    """Lite, lite, full — the driver's schedule — through the JAX fused
    kernel (interpret mode) and the port's plain fused sweep; tolerances of
    tests/test_pallas.py:66-71 (block 32 keeps the interpret trace small)."""
    (data, hyper, state, jcfg), (tdata, thyper, tstate), cfg, tdt = \
        _jax_problem(jnp.float32, 32, 128, n=120, p=256, q=48, seed=3)
    jcfg = dataclasses.replace(jcfg, sweep="fused")
    tcfg = at.Config(dtype=tdt, sweep="fused", **cfg)
    jg, tg = j_block_gram(data.x, 32), t_block_gram(tdata.x, 32)
    for k in range(3):
        lite = k < 2
        state = jgl.cavi_iteration(data, hyper, state, jg, 1.0, 1.0,
                                   cfg=jcfg, annealed=False, lite=lite)
        t_prev = tstate
        tstate = tgl.cavi_iteration(tdata, thyper, tstate, tg, 1.0, 1.0,
                                    cfg=tcfg, annealed=False, lite=lite)
        if lite:  # the lite carry returns the stale gam/mu unchanged
            assert tstate.gam is t_prev.gam and tstate.mu_beta is t_prev.mu_beta
    assert tsf.sweep_fused.launches == 0  # CPU: the plain version
    for name, atol in (("gam", 5e-5), ("mu_beta", 5e-5), ("theta", 5e-5),
                       ("fitted", 5e-3)):
        np.testing.assert_allclose(getattr(tstate, name).numpy(),
                                   np.asarray(getattr(state, name)),
                                   atol=atol, err_msg=name)
    p_true, q_true = 256, 48
    assert torch.all(tstate.gam[p_true:] == 0) and torch.all(
        tstate.gam[:, q_true:] == 0)


def _fit_port():
    y, x, _ = simulate_fixture()
    return at.atlasqtl(y, x, p0=(5, 25), dtype=torch.float64, verbose=0,
                       user_seed=123, device="cpu")


def test_end_to_end_fit_matches_jax_f64():
    y, x, _ = simulate_fixture()
    ref = aq.atlasqtl(y, x, p0=(5, 25), dtype=jnp.float64, verbose=0,
                      user_seed=123)
    res = _fit_port()
    assert res.converged == ref.converged and res.it == ref.it
    for name in ("gam_vb", "beta_vb", "theta_vb", "zeta_vb"):
        np.testing.assert_allclose(getattr(res, name), getattr(ref, name),
                                   rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(res.lb_opt, ref.lb_opt, rtol=1e-9)


def test_end_to_end_fit_matches_golden():
    """tests/test_golden.py's tolerances on the committed float64 golden."""
    res = _fit_port()
    g = np.load(os.path.join(GOLD, "golden_complete.npz"))
    assert res.converged
    np.testing.assert_allclose(res.gam_vb, g["gam_vb"], atol=1e-2)
    for name in ("beta_vb", "theta_vb", "zeta_vb"):
        np.testing.assert_allclose(getattr(res, name), g[name], atol=1e-3)
    np.testing.assert_allclose(res.lb_opt, float(g["lb_opt"]), rtol=1e-6,
                               atol=1e-4)


def test_maxit_within_the_ladder_is_not_an_error():
    """maxit exhausted by the annealing rungs: no ELBO evaluation ran, so
    the -inf sentinel is returned as a non-converged fit, never raised
    (the reference's driver.py:251 guard)."""
    y, x, _ = simulate_fixture()
    res = at.atlasqtl(y, x, p0=(5, 25), dtype=torch.float64, verbose=0,
                      user_seed=1, maxit=3, device="cpu")
    assert not res.converged and res.it == 9 and res.lb_opt == -np.inf
