"""The PyTorch port's special functions, closed-form updates, horseshoe
updates, interpolation operands and float64 sweep, each held against its
JAX counterpart on identical float64 inputs (float32 for the fast paths).

Tolerances: rtol 1e-10 in float64 (both sides evaluate the same formulas;
only the libraries' rounding differs); atol 1e-6 plus two f32 ulps of the
value for the float32 fast paths; atol 1e-10 for a whole float64 sweep.  One
exception: the annealed df > 1 local-scale update for L in (2.5, 5], just
below its branch switch, sums two cancelling Kummer terms, and both packages
are only ~1e-8 accurate there (test_annealed_update_vs_mpmath), so that band
is held at 2e-8.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from atlasqtl_tpu.ops import special as jsp, updates as jup, horseshoe as jhs
from atlasqtl_tpu.ops import interp as jin, sweep as jsw
from atlasqtl_tpu.types import Config as JConfig
from atlasqtl_tpu.models import global_local as jgl
from atlasqtl_tpu.inference import elicitation as jelic
from atlasqtl_tpu.io.prepare import prepare_data

from atlasqtl_tpu_torch.ops import special as tsp, updates as tup
from atlasqtl_tpu_torch.ops import horseshoe as ths, interp as tin
from atlasqtl_tpu_torch.ops import sweep as tsw

from conftest import simulate_fixture

U = np.linspace(-40.0, 40.0, 4001)
L = np.logspace(-6, 4, 801)
RTOL = 1e-10


def t64(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def close(a, b, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=atol)


def test_log_ndtr_both_and_mills_f64():
    jp, j1p = jsp.log_ndtr_both(jnp.asarray(U))
    tp, t1p = tsp.log_ndtr_both(t64(U))
    # log Phi(u) -> 0 from below as u grows; where the libraries take
    # log(1 - eps) their values are quantized at 1e-16 absolute
    close(tp, jp, atol=1e-15)
    close(t1p, j1p, atol=1e-15)
    # the Mills ratios amplify log-Phi's last-bit differences by ~u^2 in
    # the tails: hold them on identical log-Phi inputs
    for y in (0, 1):
        close(tsp.inv_mills_ratio(y, t64(U), t64(j1p), t64(jp)),
              jsp.inv_mills_ratio(y, jnp.asarray(U), j1p, jp), atol=1e-300)


def test_float32_fast_paths():
    u32 = U.astype(np.float32)
    jp, j1p = jsp.log_ndtr_both(jnp.asarray(u32))
    tp, t1p = tsp.log_ndtr_both(torch.as_tensor(u32))
    assert tp.dtype == torch.float32
    close(tp, jp, rtol=2.4e-7, atol=1e-6)
    close(t1p, j1p, rtol=2.4e-7, atol=1e-6)
    z = np.abs(u32) * np.float32(0.7071067811865476)
    close(tsp._erfcx_nr(torch.as_tensor(z)), jsp._erfcx_nr(jnp.asarray(z)),
          rtol=0, atol=1e-6)


def test_q_approx_and_gamma_ratios():
    close(tsp.q_approx(t64(L)), jsp.q_approx(jnp.asarray(L)))
    for c in (0.1, 0.5, 0.9):
        close(tsp.upper_gamma_ratio(t64(c), t64(L)),
              jsp.upper_gamma_ratio(c, jnp.asarray(L)))
    a = np.array([0.1, 0.5, 1.5])[:, None]
    x = np.logspace(-3, 2, 60)[None, :]
    close(tsp.upper_gamma(t64(a), t64(x)),
          jsp.upper_gamma(jnp.asarray(a), jnp.asarray(x)))
    xs = np.linspace(0.0, 5.0, 101)
    for a_, b_ in ((1.2, 2.7), (2.5, 0.4), (3.0, 1.5)):
        close(tsp.hyperg_1f1(a_, b_, t64(xs)),
              jsp.hyperg_1f1(a_, b_, jnp.asarray(xs)))


@pytest.mark.parametrize("df", [1, 3, 5, 7])
def test_horseshoe_updates(df):
    lt, qt = ths.lam2_inv_exact(t64(L), df)
    lj, qj = jhs.lam2_inv_exact(jnp.asarray(L), df)
    close(lt, lj)
    close(qt, qj)
    for c in (0.3, 0.7):
        lv = c * L / df
        got = ths.lam2_inv_annealed(t64(lv), t64(c), df).numpy()
        ref = np.asarray(jhs.lam2_inv_annealed(jnp.asarray(lv), c, df))
        # df > 1 just below the L = 5 switch: two cancelling Kummer terms
        band = (df > 1) & (lv > 2.5) & (lv <= 5.0)
        close(got[~band], ref[~band])
        close(got[band], ref[band], rtol=2e-8)


@pytest.mark.parametrize("df", [3, 7])
def test_annealed_update_vs_mpmath(df):
    """Both packages against the exact Kummer-U ratio (mpmath, 40 digits)
    just below the L = 5 switch of the df > 1 annealed update."""
    mp = pytest.importorskip("mpmath")
    mp.mp.dps = 40
    c, lv = 0.7, np.array([4.2, 4.6, 4.9])
    a1 = c * (df - 1) / 2
    ref = np.array([float(mp.gamma(a1 + 2) * mp.hyperu(a1 + 2, 3 - c, v)
                          / (df * mp.gamma(a1 + 1) * mp.hyperu(a1 + 1, 2 - c,
                                                               v)))
                    for v in lv])
    close(ths.lam2_inv_annealed(t64(lv), t64(c), df), ref, rtol=2e-8)
    close(jhs.lam2_inv_annealed(jnp.asarray(lv), c, df), ref, rtol=2e-8)


def test_closed_form_updates():
    rng = np.random.default_rng(0)
    q = 37
    v = lambda lo, hi: rng.uniform(lo, hi, q)
    a = dict(n=117.0, s2i=rng.uniform(0.1, 3.0), c=rng.uniform(0.2, 1.0),
             tau=v(0.5, 2), gcs=v(0, 40), m2b=v(0, 9), b2=v(0, 5),
             yf=v(-50, 50), ff=v(0, 90), ynsq=v(100, 300), eta=v(0.1, 2),
             kappa=v(0.5, 2), shape=v(0.5, 40), rate=v(0.5, 9), s02=v(0.1, 3),
             zr=v(-9, 9), sl=v(0.1, 3), s2t=v(0.1, 1), zsum=rng.uniform(-5, 5),
             n0=v(-2, 0), s2z=rng.uniform(0.1, 1), t02i=rng.uniform(0.5, 3),
             qm=(rng.uniform(size=q) > 0.2).astype(float))
    calls = [
        lambda m, f: m.nu_update(f(1e-2), f(a["gcs"].sum()), f(a["c"])),
        lambda m, f: m.rho_update(f(1.0), f(a["m2b"]), f(a["tau"]),
                                  f(a["qm"]), f(a["c"])),
        lambda m, f: m.eta_update(f(np.full(q, a["n"])), f(a["eta"]),
                                  f(a["gcs"]), f(a["c"])),
        lambda m, f: m.kappa_update(f(a["n"]), f(a["ynsq"]), f(a["yf"]),
                                    f(a["ff"]), f(a["kappa"]), f(a["m2b"]),
                                    f(a["b2"]), f(a["s2i"]), f(a["c"])),
        lambda m, f: m.log_gamma_mean(f(a["shape"]), f(a["rate"])),
        lambda m, f: m.sig2_c0_update(f(75.0), f(a["s02"]), f(a["c"])),
        lambda m, f: m.theta_update(f(a["zr"]), f(0.0), f(a["sl"]),
                                    f(a["s2t"]), f(a["zsum"]), f(a["c"])),
        lambda m, f: m.zeta_update(f(a["zr"]), f(a["zsum"]), f(a["n0"]),
                                   f(a["s2z"]), f(a["t02i"]), f(a["c"])),
    ]
    j64 = lambda v_: jnp.asarray(v_, jnp.float64)
    for call in calls:
        close(call(tup, t64), call(jup, j64))
    close(tup.sig2_beta_update(t64(a["n"]), t64(a["s2i"]), t64(a["tau"]),
                               c=t64(a["c"])),
          jup.sig2_beta_update(a["n"], a["s2i"], j64(a["tau"]), None,
                               a["c"]))


@pytest.mark.parametrize("c", [1.0, 0.35])
def test_tail_interp_operands_f64(c):
    rng = np.random.default_rng(4)
    # padded predictors carry theta = 0 and mask 0, as build_state pads them
    theta = np.concatenate([rng.normal(0, 1.5, 86), [-6.0, 6.0], [0.0] * 4])
    zeta = rng.normal(-2.5, 1.0, 40)
    cst = rng.normal(0.0, 2.0, 40)
    p_mask = (np.arange(92) < 88).astype(float)
    jl, jn, jk = jin.tail_interp_operands(jnp.asarray(theta), jnp.asarray(zeta),
                                          jnp.asarray(cst), c,
                                          jnp.asarray(p_mask))
    tl, tn, tk = tin.tail_interp_operands(t64(theta), t64(zeta), t64(cst),
                                          c, t64(p_mask))
    # the basis rows sum to 1: small entries carry O(1e-16) absolute noise
    close(tl, jl, atol=1e-15)
    close(tn, jn, atol=1e-15)
    close(tk, jk)


@pytest.mark.parametrize("c", [1.0, 0.5])
def test_sweep_complete_f64(c):
    y, x, _ = simulate_fixture(n=90, p=150, p_act=8, q=24, seed=9)
    dat = prepare_data(y, x, 0.1, 1000)
    p, q = dat.x.shape[1], dat.y.shape[1]
    cfg = JConfig(dtype=jnp.float64, block_size=64, shr_fac_inv=float(q))
    data = jgl.build_data(dat.x, dat.y, cfg)
    state = jgl.build_state(jelic.auto_set_init(dat.y, p, (4, 16), float(q),
                                                3), data, cfg)
    rng = np.random.default_rng(2)
    tau = rng.uniform(0.5, 2.0, data.y.shape[1])
    consts = dict(sig2_beta=rng.uniform(0.005, 0.02, tau.size), tau=tau,
                  log_tau=np.log(tau), log_sig2_inv=-0.4,
                  theta=np.asarray(state.theta), zeta=np.asarray(state.zeta),
                  c=c)
    jc = jsw.SweepConsts(**{k: jnp.asarray(v) for k, v in consts.items()})
    tc = tsw.SweepConsts(**{k: t64(v) for k, v in consts.items()})
    jg = jsw.block_gram(data.x, 64)
    tg = tsw.block_gram(t64(data.x), 64)
    close(tg, jg, rtol=0, atol=1e-10)
    ref = jsw.sweep_complete(data.x, data.cp_x_y, jg, state.gam,
                             state.mu_beta, state.fitted, jc, 64,
                             p_mask=data.p_mask, q_mask=data.q_mask)
    got = tsw.sweep_complete(t64(data.x), t64(data.cp_x_y), tg,
                             t64(state.gam), t64(state.mu_beta),
                             t64(state.fitted), tc, 64, t64(data.p_mask),
                             t64(data.q_mask))
    for name, a, b in zip(("gam", "mu", "fitted", "z_row", "z_col"), got,
                          ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-10, err_msg=name)
