"""Annealing replicas in the port (inference/driver.py:
_anneal_replicas_batched, models/global_local.py:cavi_iteration_replicas)
held against the JAX package and against the port's own single-replica
iterations; the replica axis of the plain versions of B1 and B2; the launch
plans of both kernels for m replicas.

Tolerances: the batched ladder atol 1e-12 against JAX's vmapped one
(float64, tests/test_e2e.py:158-200's); the whole replica fit atol 1e-6
(tests/test_torch_model.py's end-to-end); the port's batched rungs against
its own single-replica rungs, and the batched plain sweeps against one
call per replica: bit for bit (the same operations on the same operands).
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import atlasqtl_tpu as aq
from atlasqtl_tpu.types import Config as JConfig
from atlasqtl_tpu.models import global_local as jgl
from atlasqtl_tpu.inference import elicitation as jelic
from atlasqtl_tpu.inference.driver import _anneal_replicas_batched as j_rep
from atlasqtl_tpu.io.prepare import prepare_data
from atlasqtl_tpu.ops.annealing import annealing_ladder
from atlasqtl_tpu.ops.sweep import block_gram as j_block_gram

import atlasqtl_tpu_torch as at
from atlasqtl_tpu_torch import convert
from atlasqtl_tpu_torch.inference.driver import _anneal_replicas_batched
from atlasqtl_tpu_torch.models import global_local as tgl
from atlasqtl_tpu_torch.ops import sweep_fused as tsf
from atlasqtl_tpu_torch.ops import sweep_missing_fused as tsm
from atlasqtl_tpu_torch.ops.sweep import block_gram as t_block_gram

from conftest import simulate_fixture


def _arrays(obj):
    return {f.name: None if getattr(obj, f.name) is None
            else np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _problem(dtype, block=16, missing="exact", frac=0.0, seeds=(0, 1, 2),
             p=75, q=20):
    """tests/test_e2e.py:158-200's problem (its fixture, block 16, three
    host-drawn replica states) in both packages."""
    y, x, _ = simulate_fixture(p=p, q=q, missing_frac=frac, seed=123)
    dat = prepare_data(y, x, 0.1, 100)
    p_eff, q_eff = dat.x.shape[1], dat.y.shape[1]
    kw = dict(block_size=block, shr_fac_inv=float(q_eff), missing=missing)
    jcfg = JConfig(dtype=dtype, **kw)
    data = jgl.build_data(dat.x, dat.y, jcfg, q_pad_to=8)
    hyper = jgl.build_hyper(jelic.auto_set_hyper(dat.y, p_eff, (5, 25)),
                            data.y.shape[1], jcfg)
    states = [jgl.build_state(jelic.auto_set_init(dat.y, p_eff, (5, 25),
                                                  float(q_eff), s), data,
                              jcfg) for s in seeds]
    tdt = torch.float64 if dtype == jnp.float64 else torch.float32
    port = (convert.data_from_numpy(_arrays(data), device="cpu"),
            convert.hyper_from_numpy(_arrays(hyper), device="cpu"),
            [convert.state_from_numpy(_arrays(s), device="cpu")
             for s in states])
    return (data, hyper, states, jcfg), port, kw, tdt


def _same(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert (x is None) == (y is None), f.name
        if x is not None:
            assert torch.equal(x, y), f.name


@pytest.mark.parametrize("missing,frac", [("exact", 0.0), ("exact", 0.15),
                                          ("impute", 0.15)])
def test_batched_ladder_matches_jax_f64(missing, frac):
    """The port's batched ladder picks the replica JAX's vmapped ladder
    picks, with its state at 1e-12; and it equals the port's own
    single-replica rungs (all lite, the last full) bit for bit."""
    (data, hyper, states, jcfg), (tdata, thyper, tstates), kw, tdt = \
        _problem(jnp.float64, missing=missing, frac=frac)
    ladder = annealing_ladder(np.array([1.0, 2.0, 5.0]))
    jgram = (j_block_gram(data.x, 16) if data.x_norm_sq is None
             else jnp.zeros((1, 1, 1)))
    ref, it_j = j_rep(jgl, data, hyper, states, jgram, ladder, jcfg, None, 0)
    tcfg = at.Config(dtype=tdt, **kw)
    tgram = (t_block_gram(tdata.x, 16) if tdata.x_norm_sq is None
             else None)
    got, it_t = _anneal_replicas_batched(tgl, tdata, thyper, tstates, tgram,
                                         ladder, tcfg, 0)
    assert it_t == it_j == len(ladder) - 1
    for name in ("gam", "mu_beta", "theta", "zeta", "fitted", "lam2_inv",
                 "sig02_inv", "tau"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=0,
                                   atol=1e-12, err_msg=name)

    # the port's single-replica rungs, and its selection by float64 ELBO
    best, best_lb = None, -np.inf
    for st in tstates:
        for k, c in enumerate(ladder[:-1]):
            st = tgl.cavi_iteration(tdata, thyper, st, tgram, c, c,
                                    cfg=tcfg, annealed=True,
                                    lite=k + 1 < len(ladder) - 1)
        lb = float(tgl.compute_elbo(tdata, thyper, st, cfg=tcfg))
        if lb > best_lb:
            best, best_lb = st, lb
    _same(got, best)


@pytest.mark.parametrize("annealed,lite", [(True, True), (True, False),
                                           (False, True)])
def test_fused_rung_f32_runs_the_batched_plain_b1(annealed, lite):
    """A float32 rung with sweep="fused" on the CPU: one call of the plain
    B1 with a replica axis (sweep_fused counts no launch on the CPU); each
    replica's state equals its own single-replica iteration bit for bit,
    complete data and impute."""
    for missing, frac in (("exact", 0.0), ("impute", 0.15)):
        _, (tdata, thyper, tstates), kw, tdt = _problem(
            jnp.float32, block=32, missing=missing, frac=frac, p=96, q=24)
        tcfg = at.Config(dtype=tdt, sweep="fused", **kw)
        assert tgl._engine(tcfg, tdata) == "b1"
        gram = t_block_gram(tdata.x, 32)
        c = 0.5 if annealed else 1.0
        got = tgl.cavi_iteration_replicas(tdata, thyper, tstates, gram, c, c,
                                          cfg=tcfg, annealed=annealed,
                                          lite=lite)
        assert tsf.sweep_fused.launches == 0
        for st, g in zip(tstates, got):
            _same(g, tgl.cavi_iteration(tdata, thyper, st, gram, c, c,
                                        cfg=tcfg, annealed=annealed,
                                        lite=lite))


def test_exact_missing_rung_f32_runs_the_batched_plain_b2():
    _, (tdata, thyper, tstates), kw, tdt = _problem(
        jnp.float32, block=32, frac=0.15, p=96, q=24)
    tcfg = at.Config(dtype=tdt, sweep="fused", **kw)
    assert tgl._engine(tcfg, tdata) == "b2"
    got = tgl.cavi_iteration_replicas(tdata, thyper, tstates, None, 0.5, 0.5,
                                      cfg=tcfg, annealed=True)
    assert tsm.sweep_missing_fused.launches == 0
    for st, g in zip(tstates, got):
        _same(g, tgl.cavi_iteration(tdata, thyper, st, None, 0.5, 0.5,
                                    cfg=tcfg, annealed=True))


@pytest.mark.parametrize("kernel", ["b1", "b2"])
def test_batched_plain_sweeps_equal_per_replica_calls(kernel):
    """The plain versions' replica axis: stacked operands (X^T Y per
    replica for B1, as impute mode gives it) against one call per
    replica, bit for bit."""
    g = torch.Generator().manual_seed(0)
    n, p, q, B, R, m = 24, 32, 12, 16, 6, 3
    rnd = lambda *s: torch.randn(*s, generator=g)
    x = rnd(n, p)
    pm, qm = torch.ones(p), torch.ones(q)
    if kernel == "b1":
        gram = t_block_gram(x, B).reshape(p, B)
        shared = dict(x=x, gram_flat=gram, p_mask=pm, q_mask=qm,
                      c=torch.tensor(0.5))
        per = dict(cp_x_y=rnd(m, p, q), l_aug=rnd(m, p, R) * 0.1,
                   n_stack=rnd(m, 3, R, q) * 0.1, beta=rnd(m, p, q) * 0.1,
                   fitted=rnd(m, n, q), theta=rnd(m, p), zeta=rnd(m, q),
                   sig2_beta=rnd(m, q).abs() + 0.5,
                   tau=rnd(m, q).abs() + 0.5, kz=rnd(m).abs() + 10.0)
        order = ("x", "cp_x_y", "gram_flat", "l_aug", "n_stack", "beta",
                 "fitted", "theta", "p_mask", "zeta", "q_mask", "sig2_beta",
                 "tau", "c", "kz")
        fn = lambda **a: tsf.sweep_fused(**a, block_size=B, c_one=False)
    else:
        mask = (torch.rand(n, q, generator=g) > 0.2).float()
        shared = dict(x=x, cp_x_y=rnd(p, q), x_norm_sq=(x * x).T @ mask,
                      mis_pat=mask, p_mask=pm, q_mask=qm,
                      c=torch.tensor(0.5))
        per = dict(l_aug=rnd(m, p, R) * 0.1, n_stack=rnd(m, 3, R, q) * 0.1,
                   gam=torch.rand(m, p, q, generator=g), mu=rnd(m, p, q),
                   fitted=rnd(m, n, q), theta=rnd(m, p), zeta=rnd(m, q),
                   tau=rnd(m, q).abs() + 0.5, kz=rnd(m).abs() + 10.0,
                   sig2_inv=rnd(m).abs() + 0.5)
        order = ("x", "cp_x_y", "x_norm_sq", "mis_pat", "l_aug", "n_stack",
                 "gam", "mu", "fitted", "theta", "p_mask", "zeta", "q_mask",
                 "tau", "c", "kz", "sig2_inv")
        fn = lambda **a: tsm.sweep_missing_fused(**a, block_size=B)
    args = lambda r: {k: (per[k] if r is None else per[k][r])
                      if k in per else shared[k] for k in order}
    flat = lambda o: [t for v in o for t in (v if isinstance(v, tuple)
                                             else (v,))]
    batched = flat(fn(**args(None)))
    for r in range(m):
        for a, b in zip(batched, flat(fn(**args(r)))):
            assert torch.equal(a[r], b)


@pytest.mark.parametrize("model", ["global_local", "global"])
def test_replica_fit_matches_jax_f64(model):
    """The global-only model has no replica form of its iteration: its
    replicas are stepped one after another."""
    y, x, p_act = simulate_fixture()
    kw = dict(p0=(5, 25), verbose=0, user_seed=123, anneal_replicas=3,
              model=model)
    ref = aq.atlasqtl(y, x, dtype=jnp.float64, **kw)
    res = at.atlasqtl(y, x, dtype=torch.float64, device="cpu", **kw)
    assert res.converged and res.it == ref.it
    for name in ("gam_vb", "beta_vb", "theta_vb", "zeta_vb"):
        np.testing.assert_allclose(getattr(res, name), getattr(ref, name),
                                   rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(res.lb_opt, ref.lb_opt, rtol=1e-9)
    assert (res.hotspot_sizes()[:p_act] > 10).all()


def test_replica_fit_device_loop_equals_host_loop():
    """The converged phase after the replica ladder, in the device loop's
    control flow (on the CPU) and in the host loop: the same fit."""
    y, x, _ = simulate_fixture(missing_frac=0.15, seed=5)
    kw = dict(p0=(5, 25), verbose=0, user_seed=11, anneal_replicas=2,
              dtype=torch.float64, device="cpu", maxit=300)
    on = at.atlasqtl(y, x, device_loop="on", **kw)
    off = at.atlasqtl(y, x, device_loop="off", **kw)
    assert on.it == off.it and on.converged == off.converged
    np.testing.assert_allclose(on.gam_vb, off.gam_vb, rtol=0, atol=1e-12)
    np.testing.assert_allclose(on.lb_opt, off.lb_opt, rtol=1e-12)


def test_replicas_need_an_annealing_schedule():
    y, x, _ = simulate_fixture()
    with pytest.raises(ValueError, match="annealing schedule"):
        at.atlasqtl(y, x, p0=(5, 25), anneal=None, anneal_replicas=2,
                    verbose=0, device="cpu")


@pytest.mark.parametrize("n,q,m,width,waves", [
    (300, 504, 1, 32, 1), (300, 504, 4, 32, 1), (300, 504, 9, 40, 1),
    (1000, 10000, 1, 40, 2), (1000, 10000, 2, 32, 5),
    (1000, 10000, 4, 32, 10)])
def test_fused_plan_counts_every_replica(n, q, m, width, waves):
    """B1's width fills the waves of all m x slices CTAs: at q = 504, four
    replicas' 64 CTAs of 32 columns take one wave, nine replicas' take it
    in 40 (117 CTAs, where 32 columns would take two waves); at the eQTL q
    two replicas take 5 waves of 32 columns or 4 of 40 (the narrower wins
    the tie)."""
    plan = tsf.fused_launch_plan(n, q, 128, 42, m=m)
    assert (plan["slice_width"], plan["waves"]) == (width, waves)
    assert plan["grid"] == -(-q // width)
    if m == 1:
        assert plan == tsf.fused_launch_plan(n, q, 128, 42)


@pytest.mark.parametrize("n,q,m,cluster", [
    (300, 504, 1, 4), (300, 504, 2, 4), (300, 504, 4, 2), (300, 504, 8, 1),
    (1000, 10000, 1, 3), (1000, 10000, 2, 3)])
def test_missing_plan_counts_every_replica(n, q, m, cluster):
    """B2's cluster grows only while m replicas' slices x (cluster + 1)
    CTAs fit one per SM; the smallest cluster that holds Fm stays."""
    plan = tsm.missing_launch_plan(n, q, 128, 42, m)
    assert plan["cluster"] == cluster
    assert plan["grid"] == -(-q // tsm.MIS_QS) * cluster
    if m == 1:
        assert plan == tsm.missing_launch_plan(n, q, 128, 42)
