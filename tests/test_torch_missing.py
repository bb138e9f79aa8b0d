"""The port's missing-data path (NaN in Y) held against the JAX package:
the missing-data updates and Z moments, the float64 exact-missing engines
(pair Grams, blocked sweep, per-coordinate scan), the plain version of the
B2 kernel (ops/sweep_missing_fused.py) against the JAX kernel in interpret
mode and against the JAX blocked sweep, one exact and one impute iteration
plus ELBO, and whole fits in both modes.

Tolerances: rtol 1e-10 for the float64 updates and atol 1e-10 for whole
float64 sweeps (same formulas, library rounding only; plus rtol 1e-14 for
the state of one iteration, whose slab variance reaches 2e5 on padded
predictors, where x_norm_sq is 0); the B2 plain version
in float32 at tests/test_pallas.py:272-278's (gam atol 5e-5; mu, Fm, z_row,
z_col atol 5e-4: f32 rounding and the interpolated Mills tiles); one
float64 iteration atol 1e-10, ELBO rtol 1e-10; whole fits the same `it`,
atol 1e-6, lb_opt rtol 1e-9; the golden at tests/test_golden.py's.
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
from atlasqtl_tpu.ops import sweep as jsw, updates as jup
from atlasqtl_tpu.ops.sweep_missing_fused import sweep_missing_fused_driver

import atlasqtl_tpu_torch as at
from atlasqtl_tpu_torch import convert
from atlasqtl_tpu_torch.models import global_local as tgl
from atlasqtl_tpu_torch.ops import sweep as tsw, updates as tup
from atlasqtl_tpu_torch.ops import sweep_missing_fused as tsm

from conftest import simulate_fixture

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
OUT = ("gam", "mu", "fitted", "z_row", "z_col")


def _t(a):
    return torch.from_numpy(np.array(a))


def _arrays(obj):
    return {f.name: None if getattr(obj, f.name) is None
            else np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _jax_problem(dtype, missing="exact", n=100, p=75, q=20, seed=5,
                 mis_block=8, block=128, q_pad_to=8, frac=0.2):
    y, x, _ = simulate_fixture(n=n, p=p, p_act=8, q=q, seed=seed,
                               missing_frac=frac)
    dat = prepare_data(y, x, 0.1, 1000)
    p_eff, q_eff = dat.x.shape[1], dat.y.shape[1]
    cfg = dict(block_size=block, shr_fac_inv=float(q_eff), missing=missing,
               mis_block=mis_block)
    jcfg = JConfig(dtype=dtype, **cfg)
    data = jgl.build_data(dat.x, dat.y, jcfg, q_pad_to=q_pad_to)
    hyper = jgl.build_hyper(jelic.auto_set_hyper(dat.y, p_eff, (4, 16)),
                            data.y.shape[1], jcfg)
    state = jgl.build_state(jelic.auto_set_init(dat.y, p_eff, (4, 16),
                                                float(q_eff), 7), data, jcfg)
    return data, hyper, state, jcfg, cfg


def _consts(data, state, c, dt, rng_seed=3):
    rng = np.random.default_rng(rng_seed)
    tau = rng.uniform(0.5, 2.0, data.y.shape[1]).astype(dt)
    sig2_inv = dt(0.7)
    s2 = np.asarray(jup.sig2_beta_update(data.n, sig2_inv, jnp.asarray(tau),
                                         data.x_norm_sq, c), dt)
    return dict(sig2_beta=s2, tau=tau, log_tau=np.log(tau) - dt(0.1),
                log_sig2_inv=dt(-0.45), theta=np.asarray(state.theta),
                zeta=np.asarray(state.zeta), c=dt(c)), sig2_inv


def test_missing_updates_and_z_moments_f64():
    rng = np.random.default_rng(0)
    p, q = 48, 37
    xns = rng.uniform(20, 120, (p, q))
    tau = rng.uniform(0.5, 2.0, q)
    for c in (1.0, 0.4):
        np.testing.assert_allclose(
            tup.sig2_beta_update(_t(117.0), _t(0.8), _t(tau), _t(xns),
                                 _t(c)).numpy(),
            np.asarray(jup.sig2_beta_update(117.0, 0.8, jnp.asarray(tau),
                                            jnp.asarray(xns), c)),
            rtol=1e-10)
        v = lambda lo, hi: rng.uniform(lo, hi, q)
        args = (117.0, v(100, 300), v(-50, 50), v(0, 90), v(0.5, 2),
                v(0, 9), v(0, 5), 0.8, c)
        kw = dict(x_norm_sq_m2b=v(0, 500), x_norm_sq_beta2=v(0, 300))
        np.testing.assert_allclose(
            tup.kappa_update(*map(_t, args),
                             **{k: _t(a) for k, a in kw.items()}).numpy(),
            np.asarray(jup.kappa_update(*map(jnp.asarray, args),
                                        **{k: jnp.asarray(a)
                                           for k, a in kw.items()})),
            rtol=1e-10)
        gam = rng.uniform(0, 1, (p, q))
        theta, zeta = rng.normal(0, 1, p), rng.normal(-2, 1, q)
        pm = (np.arange(p) < 45).astype(float)
        qm = (np.arange(q) < 33).astype(float)
        for block in (None, 16):
            got = tup.z_moments(_t(gam), _t(theta), _t(zeta), _t(pm), _t(qm),
                                c, block_size=block)
            ref = jup.z_moments(jnp.asarray(gam), jnp.asarray(theta),
                                jnp.asarray(zeta), jnp.asarray(pm),
                                jnp.asarray(qm), c, block_size=block)
            for a, b in zip(got, ref):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("engine,c", [("blocked", 1.0), ("blocked", 0.5),
                                      ("scan", 1.0), ("scan", 0.5)])
def test_missing_sweeps_f64(engine, c):
    """The pair Grams, the blocked sweep (mis_block 8) and the
    per-coordinate scan against JAX's, atol 1e-10."""
    data, _, state, _, _ = _jax_problem(jnp.float64, n=90, p=150, q=24,
                                        seed=9, block=64)
    consts, _ = _consts(data, state, c, np.float64)
    jc = jsw.SweepConsts(**{k: jnp.asarray(v) for k, v in consts.items()})
    tc = tsw.SweepConsts(**{k: _t(v) for k, v in consts.items()})
    d = {k: _t(v) for k, v in _arrays(data).items() if v is not None}
    g, m, f = _t(state.gam), _t(state.mu_beta), _t(state.fitted)
    if engine == "blocked":
        pg = tsw.mis_pair_gram(d["x"], d["mis_pat"], 8)
        np.testing.assert_allclose(pg.numpy(), np.asarray(data.mis_pair_gram),
                                   rtol=0, atol=1e-10)
        ref = jsw.sweep_missing_blocked(
            data.x, data.cp_x_y, data.x_norm_sq, data.mis_pat,
            data.mis_pair_gram, state.gam, state.mu_beta, state.fitted, jc, 8,
            p_mask=data.p_mask, q_mask=data.q_mask)
        got = tsw.sweep_missing_blocked(
            d["x"], d["cp_x_y"], d["x_norm_sq"], d["mis_pat"], pg, g, m, f,
            tc, 8, d["p_mask"], d["q_mask"])
    else:
        ref = jsw.sweep_missing(data.x, data.cp_x_y, data.x_norm_sq,
                                data.mis_pat, state.gam, state.mu_beta,
                                state.fitted, jc)
        got = tsw.sweep_missing(d["x"], d["cp_x_y"], d["x_norm_sq"],
                                d["mis_pat"], g, m, f, tc)
    for name, a, b in zip(OUT, got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-10, err_msg=name)


def _port_b2(data, state, consts, sig2_inv):
    tc = tsw.SweepConsts(**{k: _t(v) for k, v in consts.items()})
    d = {k: _t(v) for k, v in _arrays(data).items() if v is not None}
    return tsm.sweep_missing_fused_driver(
        d["x"], d["cp_x_y"], d["x_norm_sq"], d["mis_pat"], _t(state.gam),
        _t(state.mu_beta), _t(state.fitted), tc, _t(sig2_inv), 128,
        d["p_mask"], d["q_mask"])


def _check_b2(got, ref, msk):
    assert tsm.sweep_missing_fused.launches == 0  # CPU: the plain version
    for name, a, r in zip(OUT, got, ref):
        r = np.asarray(r, np.float64)
        if name in ("gam", "mu"):
            r = r * msk
        atol = 5e-5 if name == "gam" else 5e-4
        np.testing.assert_allclose(a.numpy().astype(np.float64), r,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("c", [1.0, 0.5])
def test_b2_plain_matches_jax_kernel(c):
    """tests/test_pallas.py:test_missing_fused_matches_blocked's problem
    (n=80, p=250, q=40 padded to 256, 20% missing) through the JAX kernel
    in interpret mode at one static layout (sub 8, wgroup 4)."""
    data, _, state, _, _ = _jax_problem(jnp.float32, n=80, p=250, q=40,
                                        seed=7, mis_block=16, q_pad_to=256)
    consts, sig2_inv = _consts(data, state, c, np.float32)
    jc = jsw.SweepConsts(**{k: jnp.asarray(v) for k, v in consts.items()})
    ref = sweep_missing_fused_driver(
        data.x, data.cp_x_y, data.x_norm_sq, data.mis_pat, state.gam,
        state.mu_beta, state.fitted, jc, jnp.asarray(sig2_inv), 128,
        p_mask=data.p_mask, q_mask=data.q_mask, q_tile=256, sub=8, wgroup=4,
        qchunk=256)
    msk = np.asarray(data.p_mask)[:, None] * np.asarray(data.q_mask)[None, :]
    _check_b2(_port_b2(data, state, consts, sig2_inv), ref, msk)


@pytest.mark.parametrize("c", [1.0, 0.5])
def test_b2_plain_matches_jax_blocked_ragged_n(c):
    """n = 100 (padded to 104 rows, mask 0 there), p = 200 (padded to 256,
    x_norm_sq 0 there), q = 30 (padded to 32, observed there)."""
    data, _, state, _, _ = _jax_problem(jnp.float32, n=100, p=200, q=30,
                                        seed=4)
    assert data.x.shape == (104, 256) and data.y.shape[1] == 32
    consts, sig2_inv = _consts(data, state, c, np.float32)
    jc = jsw.SweepConsts(**{k: jnp.asarray(v) for k, v in consts.items()})
    ref = jsw.sweep_missing_blocked(
        data.x, data.cp_x_y, data.x_norm_sq, data.mis_pat,
        data.mis_pair_gram, state.gam, state.mu_beta, state.fitted, jc, 8,
        p_mask=data.p_mask, q_mask=data.q_mask)
    msk = np.asarray(data.p_mask)[:, None] * np.asarray(data.q_mask)[None, :]
    _check_b2(_port_b2(data, state, consts, sig2_inv), ref, msk)


@pytest.mark.parametrize("missing,annealed,mis_block", [
    ("exact", False, 8), ("exact", True, 8), ("exact", True, 1),
    ("impute", False, 8), ("impute", True, 8)])
def test_one_missing_iteration_and_elbo_f64(missing, annealed, mis_block):
    """mis_block 8: the blocked engine; 1: the per-coordinate scan (no pair
    Grams, Z summed after the sweep)."""
    data, hyper, state, jcfg, cfg = _jax_problem(jnp.float64, missing,
                                                 mis_block=mis_block)
    assert (data.mis_pair_gram is None) == (missing == "impute"
                                            or mis_block == 1)
    assert (data.x_norm_sq is not None) == (missing == "exact")
    c = 0.4 if annealed else 1.0
    jgram = (jsw.block_gram(data.x, 80) if missing == "impute"
             else jnp.zeros((1, 1, 1)))
    j1 = jgl.cavi_iteration(data, hyper, state, jgram, c, c, cfg=jcfg,
                            annealed=annealed)
    tdata = convert.data_from_numpy(_arrays(data), device="cpu")
    tcfg = at.Config(dtype=torch.float64, **cfg)
    tgram = (tsw.block_gram(tdata.x, 80) if missing == "impute" else None)
    thyper = convert.hyper_from_numpy(_arrays(hyper), device="cpu")
    tstate = convert.state_from_numpy(_arrays(state), device="cpu")
    t1 = tgl.cavi_iteration(tdata, thyper, tstate, tgram, c, c, cfg=tcfg,
                            annealed=annealed)
    for f in dataclasses.fields(t1):
        a, b = getattr(t1, f.name), getattr(j1, f.name)
        assert (a is None) == (b is None), f.name
        if b is not None:  # rtol: sig2_beta reaches 2e5 on padded rows
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-14,
                                       atol=1e-10, err_msg=f.name)
    lj = float(jgl.compute_elbo(data, hyper, j1, cfg=jcfg))
    lt = float(tgl.compute_elbo(tdata, thyper, t1, cfg=tcfg))
    np.testing.assert_allclose(lt, lj, rtol=1e-10)


def _fit_port(missing):
    y, x, _ = simulate_fixture(missing_frac=0.2, seed=5)
    return at.atlasqtl(y, x, p0=(5, 25), dtype=torch.float64, verbose=0,
                       user_seed=11, maxit=600, device="cpu", missing=missing)


@pytest.mark.parametrize("missing", ["exact", "impute"])
def test_missing_fit_matches_jax_f64(missing):
    y, x, _ = simulate_fixture(missing_frac=0.2, seed=5)
    ref = aq.atlasqtl(y, x, p0=(5, 25), dtype=jnp.float64, verbose=0,
                      user_seed=11, maxit=600, missing=missing)
    res = _fit_port(missing)
    assert res.converged and ref.converged and res.it == ref.it
    for name in ("gam_vb", "beta_vb", "theta_vb", "zeta_vb"):
        np.testing.assert_allclose(getattr(res, name), getattr(ref, name),
                                   rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(res.lb_opt, ref.lb_opt, rtol=1e-9)


def test_missing_fit_matches_golden():
    """tests/test_golden.py's tolerances on the committed float64 golden of
    the exact-missing fit."""
    res = _fit_port("exact")
    g = np.load(os.path.join(GOLD, "golden_missing.npz"))
    assert res.converged
    np.testing.assert_allclose(res.gam_vb, g["gam_vb"], atol=1e-2)
    for name in ("beta_vb", "theta_vb", "zeta_vb"):
        np.testing.assert_allclose(getattr(res, name), g[name], atol=1e-3)
    np.testing.assert_allclose(res.lb_opt, float(g["lb_opt"]), rtol=1e-6,
                               atol=1e-4)


def test_fused_engine_on_the_cpu_runs_the_plain_b2():
    """sweep="fused" sends an exact-missing iteration through B2's plain
    version on the CPU (no precomputed pair Grams); in float64 it agrees
    with the blocked engine to the interpolated tiles' accuracy."""
    data, hyper, state, _, cfg = _jax_problem(jnp.float64)
    tdata = convert.data_from_numpy(_arrays(data), device="cpu")
    th = convert.hyper_from_numpy(_arrays(hyper), device="cpu")
    ts = convert.state_from_numpy(_arrays(state), device="cpu")
    blocked = tgl.cavi_iteration(tdata, th, ts, None, 1.0, 1.0,
                                 cfg=at.Config(dtype=torch.float64, **cfg),
                                 annealed=False)
    fused_cfg = at.Config(dtype=torch.float64, sweep="fused", **cfg)
    fdata = tgl.build_data(*_prepared(), fused_cfg, "cpu")
    assert fdata.mis_pair_gram is None and fdata.x_norm_sq is not None
    fused = tgl.cavi_iteration(tdata, th, ts, None, 1.0, 1.0, cfg=fused_cfg,
                               annealed=False)
    assert tsm.sweep_missing_fused.launches == 0
    for name in ("gam", "mu_beta", "fitted", "theta", "zeta", "tau"):
        np.testing.assert_allclose(getattr(fused, name).numpy(),
                                   getattr(blocked, name).numpy(),
                                   atol=1e-5, err_msg=name)


def _prepared():
    y, x, _ = simulate_fixture(n=100, p=75, p_act=8, q=20, seed=5,
                               missing_frac=0.2)
    dat = prepare_data(y, x, 0.1, 1000)
    return dat.x, dat.y
