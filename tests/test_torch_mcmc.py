"""The port's cross-check samplers (atlasqtl_tpu_torch/mcmc) held against
the JAX package's (atlasqtl_tpu/mcmc), float64 on the CPU.

Each JAX sampler runs once per test session with its key schedule
replayed beside it (tests/_jax_mcmc.py), and the port runs from those
recorded draws through mcmc/draws.py:ArrayDraws: the chains are compared
exactly, not statistically.

The fixture is conftest.simulate_fixture at (60, 30, 12), block 16, so
that p and q are both padded; a variant has 10% NaN in Y (impute's Data:
the samplers read no mis_pat).
"""
import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from filelock import FileLock

from atlasqtl_tpu.types import Config as JConfig
from atlasqtl_tpu.models import global_local as jgl
from atlasqtl_tpu.inference import elicitation as jelic
from atlasqtl_tpu.io.prepare import prepare_data
from atlasqtl_tpu.ops.sweep import block_gram as j_block_gram
from atlasqtl_tpu.mcmc import gibbs as jgibbs
from atlasqtl_tpu.mcmc import nuts as jnuts
from atlasqtl_tpu.mcmc import smc as jsmc

import atlasqtl_tpu_torch as at
from atlasqtl_tpu_torch import convert
from atlasqtl_tpu_torch.mcmc import gibbs as tgibbs
from atlasqtl_tpu_torch.mcmc import nuts as tnuts
from atlasqtl_tpu_torch.mcmc import smc as tsmc
from atlasqtl_tpu_torch.mcmc.draws import (ArrayDraws, RecordingDraws,
                                           TorchDraws)
from atlasqtl_tpu_torch.ops.sweep import block_gram as t_block_gram

from conftest import simulate_fixture
import _jax_mcmc as J

N, P, Q, P_ACT, BLOCK, P0 = 60, 30, 12, 5, 16, (4, 12)
STATE_TOL = dict(rtol=1e-10, atol=1e-12)
FIELDS = [f.name for f in dataclasses.fields(tgibbs.GibbsState)]
VARIANTS = dict(complete=0.0, impute=0.1)


def _arrays(obj):
    return {f.name: None if getattr(obj, f.name) is None
            else np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _problem(missing_frac, seed=3):
    """The JAX package's (data, hyper, cfg) and the port's, from the same
    arrays (convert.py)."""
    y, x, _ = simulate_fixture(n=N, p=P, p_act=P_ACT, q=Q, seed=seed,
                               missing_frac=missing_frac)
    dat = prepare_data(y, x, 0.1, 1000)
    p_eff, q_eff = dat.x.shape[1], dat.y.shape[1]
    kw = dict(block_size=BLOCK, shr_fac_inv=float(q_eff), missing="impute")
    jcfg = JConfig(dtype=jnp.float64, **kw)
    data = jgl.build_data(dat.x, dat.y, jcfg)
    hyper = jgl.build_hyper(jelic.auto_set_hyper(dat.y, p_eff, P0),
                            data.y.shape[1], jcfg)
    tcfg = at.Config(dtype=torch.float64, **kw)
    tdata = convert.data_from_numpy(_arrays(data), device="cpu")
    thyper = convert.hyper_from_numpy(_arrays(hyper), device="cpu")
    return (data, hyper, jcfg), (tdata, thyper, tcfg)


def _jax_state(state):
    return {k: np.asarray(getattr(state, k)) for k in FIELDS}


def _held(got, ref, label, **tol):
    for k in ref:
        np.testing.assert_allclose(np.asarray(got[k]), ref[k], **tol,
                                   err_msg=f"{label}: {k}")


def _port_state(state):
    return {k: getattr(state, k).numpy() for k in FIELDS}


# ------------------------------------------------ the JAX runs, once each

def _shared(tmp_path_factory, name, compute):
    """compute() once per test session: under xdist the workers that take
    tests of this module share one result, made by the first of them under
    a file lock (the JAX side compiles for tens of seconds)."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent   # the session's, shared by the xdist workers
    path = root / f"torch_mcmc_{name}.pkl"
    with FileLock(str(path) + ".lock"):
        if not path.exists():
            with open(path, "wb") as fh:
                pickle.dump(compute(), fh)
    with open(path, "rb") as fh:
        return pickle.load(fh)


@pytest.fixture(scope="module")
def problems():
    return {v: _problem(f) for v, f in VARIANTS.items()}


def _jax_sweeps(problems):
    out = {}
    for variant, ((data, hyper, cfg), _) in problems.items():
        gram = j_block_gram(data.x, BLOCK)
        for temper in (1.0, 0.5):
            state = jgibbs.init_state(jax.random.key(11, impl="rbg"), data,
                                      cfg)
            rec, states = J.Recorder(), []
            for _ in range(3):
                new = jgibbs.gibbs_sweep(state, data, hyper, gram, cfg=cfg,
                                         temper=temper)
                rec.add(J.sweep_draws(state.key, data, hyper, new.gam,
                                      temper, BLOCK))
                states.append(_jax_state(new))
                state = new
            out[variant, temper] = rec, states
    return out


@pytest.fixture(scope="module")
def jax_side(problems, tmp_path_factory):
    return _shared(tmp_path_factory, "jax", lambda: (_jax_sweeps(problems),
                                                     _jax_runs(problems)))


@pytest.fixture(scope="module")
def jax_sweeps(jax_side):
    """Per variant and temper: the JAX chain's states after each of 3
    chained gibbs_sweeps from its start, with their replayed draws."""
    return jax_side[0]


def _jax_runs(problems):
    out = {}
    for variant, ((data, hyper, cfg), _) in problems.items():
        out["gibbs", variant] = J.run_recorded(
            "gibbs", data, hyper, cfg, BLOCK, n_samples=4, n_burnin=3,
            seed=5, thin=2)
    (data, hyper, cfg), _ = problems["complete"]
    out["nuts"] = J.run_recorded("nuts", data, hyper, cfg, BLOCK,
                                 n_samples=3, n_burnin=3, seed=4)
    out["smc"] = J.run_recorded("smc", data, hyper, cfg, BLOCK,
                                n_particles=4, anneal=(1, 2, 3),
                                n_mutations=1, n_final=3, seed=6)
    return out


@pytest.fixture(scope="module")
def jax_runs(jax_side):
    """JAX's run_gibbs (both variants), run_nuts and run_smc, each with its
    draws recorded by replaying its key schedule."""
    return jax_side[1]


# ------------------------------------------------ Gibbs

@pytest.mark.parametrize("temper", [1.0, 0.5])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_gibbs_sweeps_match_jax(problems, jax_sweeps, variant, temper):
    """Three chained gibbs_sweeps from JAX's start, fed JAX's draws, equal
    JAX's states field by field after every sweep."""
    _, (data, hyper, cfg) = problems[variant]
    rec, states = jax_sweeps[variant, temper]
    draws = rec.draws()
    gram = t_block_gram(data.x, BLOCK)
    state = tgibbs.init_state(data, cfg)
    for s, ref in enumerate(states):
        state = tgibbs.gibbs_sweep(state, data, hyper, gram, draws, cfg=cfg,
                                   temper=temper)
        _held(_port_state(state), ref, f"sweep {s}", **STATE_TOL)
    assert all(draws.used[k] == len(v) for k, v in rec.sites.items())
    # the chain moved: some gam set, every field finite
    assert states[-1]["gam"].sum() > 0


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_run_gibbs_matches_jax(problems, jax_runs, variant):
    """run_gibbs (burn-in 3, 4 samples, thin 2) from JAX's recorded draws
    gives JAX's four summaries."""
    _, (data, hyper, cfg) = problems[variant]
    rec, ref = jax_runs["gibbs", variant]
    got = tgibbs.run_gibbs(data, hyper, cfg, n_samples=4, n_burnin=3,
                           thin=2, draws=rec.draws())
    for g, r, name in zip(got, ref, ("pip", "beta", "theta", "zeta")):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=1e-10, atol=1e-12,
                                   err_msg=name)


def test_state_handed_over_mid_chain_continues(problems, jax_sweeps):
    """convert.gibbs_state_from_numpy: JAX's state after its first sweep,
    handed to the port, continues as JAX's chain under its draws."""
    _, (data, hyper, cfg) = problems["complete"]
    rec, states = jax_sweeps["complete", 1.0]
    one = {site: arrays[len(arrays) // 3:] for site, arrays in
           rec.sites.items()}
    draws = ArrayDraws(one, "cpu", torch.float64)
    state = convert.gibbs_state_from_numpy(dict(states[0], key=None),
                                           device="cpu")
    assert isinstance(state, tgibbs.GibbsState)
    gram = t_block_gram(data.x, BLOCK)
    for ref in states[1:]:
        state = tgibbs.gibbs_sweep(state, data, hyper, gram, draws, cfg=cfg)
        _held(_port_state(state), ref, "handed over", **STATE_TOL)


def test_particle_axis_is_the_single_chains(problems):
    """A gibbs_sweep of a batch of 3 particles equals each particle's own
    sweep with its slice of the same draws."""
    _, (data, hyper, cfg) = problems["complete"]
    gram = t_block_gram(data.x, BLOCK)
    batch = tgibbs.init_state(data, cfg, 3)
    rec = RecordingDraws(TorchDraws.seeded(1, "cpu", torch.float64))
    for _ in range(2):
        batch = tgibbs.gibbs_sweep(batch, data, hyper, gram, rec, cfg=cfg,
                                   temper=0.7)
    for j in range(3):
        draws = ArrayDraws({k: [a[j] for a in v] for k, v in
                            rec.sites.items()}, "cpu", torch.float64)
        one = tgibbs.init_state(data, cfg)
        for _ in range(2):
            one = tgibbs.gibbs_sweep(one, data, hyper, gram, draws, cfg=cfg,
                                     temper=0.7)
        _held(_port_state(one), {k: getattr(batch, k)[j].numpy()
                                 for k in FIELDS}, f"particle {j}",
              rtol=1e-12, atol=1e-13)


def test_torch_draws_seed_the_chain(problems):
    """With the port's own draws the same seed gives the same chain and
    another seed another; a short chain separates the planted actives
    (tests/test_mcmc_sharded.py:63)."""
    _, (data, hyper, cfg) = problems["complete"]
    a = tgibbs.run_gibbs(data, hyper, cfg, n_samples=20, n_burnin=10, seed=2)
    b = tgibbs.run_gibbs(data, hyper, cfg, n_samples=20, n_burnin=10, seed=2)
    c = tgibbs.run_gibbs(data, hyper, cfg, n_samples=20, n_burnin=10, seed=3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    p_eff, q_eff = int(data.p_true), int(data.q_true)
    pip = a[0][:p_eff, :q_eff]
    assert pip[:P_ACT].mean() > pip[P_ACT:].mean() + 0.3
    assert all(np.isfinite(x).all() for x in a)


def test_array_draws_check_shape_and_count():
    d = ArrayDraws({"z": [np.zeros((2, 3))]}, "cpu")
    with pytest.raises(ValueError, match="shape"):
        d.uniform("z", (3, 2), 0.0, 1.0)
    d = ArrayDraws({"z": [np.zeros((2, 3))]}, "cpu")
    d.uniform("z", (2, 3), 0.0, 1.0)
    with pytest.raises(IndexError, match="no draw 1"):
        d.uniform("z", (2, 3), 0.0, 1.0)


# ------------------------------------------------ NUTS

def _stats(rng, p=32, q=16):
    """Random NUTS statistics of both packages."""
    a = dict(zrow=rng.normal(size=p) * 5, zcol=rng.normal(size=q) * 3,
             p_mask=(np.arange(p) < 30).astype(float),
             q_mask=(np.arange(q) < 12).astype(float), p_true=30.0,
             q_true=12.0, n0=rng.normal(size=q) - 1.0, t0=0.7,
             shr_sqrt=np.sqrt(12.0))
    return (jnuts.NutsStats(**{k: jnp.asarray(v) for k, v in a.items()}),
            tnuts.NutsStats(**{k: torch.as_tensor(v, dtype=torch.float64)
                               for k, v in a.items()}))


@pytest.mark.parametrize("seed", [0, 1])
def test_potential_and_grad_match_jax(seed):
    rng = np.random.default_rng(seed)
    js, ts = _stats(rng)
    w = rng.normal(size=2 * 32 + 1 + 16)
    ju, jg = jax.value_and_grad(jnuts.potential)(jnp.asarray(w), js)
    tu, tg = tnuts._potential_and_grad(torch.as_tensor(w), ts)
    np.testing.assert_allclose(float(tu), float(ju), rtol=1e-12)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-12,
                               atol=1e-12 * np.abs(np.asarray(jg)).max())
    np.testing.assert_allclose(
        np.concatenate([t.numpy() for t in tnuts.theta_zeta_from_w(
            torch.as_tensor(w), ts)]),
        np.concatenate([np.asarray(t) for t in jnuts.theta_zeta_from_w(
            jnp.asarray(w), js)]), rtol=1e-13, atol=1e-15)


@pytest.mark.parametrize("eps", [0.05, 0.3])
def test_nuts_step_matches_jax(eps):
    """One NUTS transition from the same rng seed takes the same tree: the
    same w' and acceptance statistic, and the rng in the same state."""
    rng = np.random.default_rng(7)
    js, ts = _stats(rng)
    w = rng.normal(size=2 * 32 + 1 + 16) * 0.3
    r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
    jw, ja = jnuts.nuts_step(r1, jnp.asarray(w), eps, js)
    tw, ta = tnuts.nuts_step(r2, torch.as_tensor(w), eps, ts)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(ta, ja, rtol=1e-10)
    assert r1.uniform() == r2.uniform()


def test_dual_averaging_matches_jax():
    ja, ta = jnuts.DualAveraging(0.1), tnuts.DualAveraging(0.1)
    for alpha in np.random.default_rng(0).uniform(size=30):
        assert ta.update(alpha) == ja.update(alpha)
        assert ta.eps_final == ja.eps_final


def test_run_nuts_matches_jax(problems, jax_runs):
    """run_nuts (3 + 3 iterations) from JAX's recorded Gibbs draws and the
    same tree seed gives JAX's summaries."""
    _, (data, hyper, cfg) = problems["complete"]
    rec, ref = jax_runs["nuts"]
    got = tnuts.run_nuts(data, hyper, cfg, n_samples=3, n_burnin=3, seed=4,
                         draws=rec.draws())
    for g, r, name in zip(got, ref, ("pip", "beta", "theta", "zeta")):
        np.testing.assert_allclose(g, r, rtol=1e-9, atol=1e-11,
                                   err_msg=name)


# ------------------------------------------------ SMC

def test_log_likelihood_matches_jax(problems, jax_sweeps):
    (jdata, _, jcfg), (data, _, cfg) = problems["impute"]
    for ref in jax_sweeps["impute", 1.0][1]:
        jst = jgibbs.GibbsState(**{k: jnp.asarray(v) for k, v in
                                   ref.items()}, key=None)
        st = convert.gibbs_state_from_numpy(ref, device="cpu")
        np.testing.assert_allclose(
            float(tsmc.log_likelihood(st, data, cfg=cfg)),
            float(jsmc.log_likelihood(jst, jdata, cfg=jcfg)), rtol=1e-12)


@pytest.mark.parametrize("u", [0.0, 0.37, 1.0 - 1e-16])
def test_systematic_resample_matches_jax(u):
    """Systematic resampling picks JAX's indices; where a position passes
    the last cumulative weight by rounding (u near 1), JAX's gather clamps
    the index to the last particle, and so does the port (these weights
    sum to 1 - 1.1e-16)."""
    log_w = jnp.asarray(np.random.default_rng(1).normal(size=8) * 3)
    w = jax.nn.softmax(log_w)
    positions = (u + jnp.arange(8)) / 8
    ref = np.asarray(jnp.arange(8)[jnp.searchsorted(jnp.cumsum(w),
                                                    positions)])
    got = tsmc._systematic_resample(
        ArrayDraws({"resample": [np.float64(u)]}, "cpu"),
        torch.as_tensor(np.array(log_w)), 8)
    np.testing.assert_array_equal(got.numpy(), ref)
    if u > 0.5:
        assert int(jnp.searchsorted(jnp.cumsum(w), positions)[-1]) == 8
        assert got[-1] == 7


def test_run_smc_matches_jax(problems, jax_runs):
    """run_smc (4 particles, anneal (1, 2, 3), 1 mutation, 3 final sweeps)
    from the draws JAX's vmapped sweeps made gives JAX's summaries and log
    evidence."""
    _, (data, hyper, cfg) = problems["complete"]
    rec, ref = jax_runs["smc"]
    assert "resample" in rec.sites     # the ladder resampled at least once
    got = tsmc.run_smc(data, hyper, cfg, n_particles=4, anneal=(1, 2, 3),
                       n_mutations=1, n_final=3, draws=rec.draws())
    for g, r, name in zip(got[:4], ref[:4], ("pip", "beta", "theta",
                                             "zeta")):
        np.testing.assert_allclose(g, r, rtol=1e-9, atol=1e-11,
                                   err_msg=name)
    np.testing.assert_allclose(got[4], ref[4], rtol=1e-9)
