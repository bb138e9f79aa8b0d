"""The port's blocked sweep with the inner Gauss-Seidel kernel
(ops/sweep_pallas.py, the route of Config(sweep="pallas") and
Config(use_pallas=True)).  On the CPU the wrapper runs the plain version
(ops/sweep.py:_inner_gs), held here against the JAX Pallas kernel in
interpret mode; the CUDA kernel itself is held against the plain version on
the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: one block, float32, gam 2e-6 and mu/delta 2e-5 (those of
tests/test_pallas.py:40-42; the JAX kernel defers the pushes of 32-row
sub-blocks to one product, so its sums run in another order); float64
1e-10.  Three float32 CAVI iterations: gam and theta 5e-5, F 5e-3
(tests/test_pallas.py:66-71); one float64 iteration and a short float64
fit: 1e-10 and 1e-6 with the same iteration count.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from atlasqtl_tpu.types import Config as JConfig
from atlasqtl_tpu.models import global_local as jgl
from atlasqtl_tpu.inference import elicitation as jelic
from atlasqtl_tpu.inference.driver import fit_global_local as j_fit
from atlasqtl_tpu.io.prepare import prepare_data
from atlasqtl_tpu.ops.sweep import block_gram as j_block_gram
from atlasqtl_tpu.ops.sweep_pallas import inner_gs_pallas as j_inner

import atlasqtl_tpu_torch as at
from atlasqtl_tpu_torch import convert
from atlasqtl_tpu_torch.inference.driver import fit_global_local as t_fit
from atlasqtl_tpu_torch.models import global_local as tgl
from atlasqtl_tpu_torch.ops import sweep_pallas as tsp
from atlasqtl_tpu_torch.ops.sweep import block_gram as t_block_gram

from conftest import simulate_fixture


def _block_inputs(B, q, dtype, seed=1):
    """One block's operands as numpy arrays (tests/test_pallas.py:18-35)."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(B, B))
    out = dict(r0=rng.normal(size=(B, q)), g=g @ g.T / B,
               cp=rng.normal(size=(B, q)), gam=rng.uniform(.1, .9, (B, q)),
               mu=rng.normal(size=(B, q)),
               logp=np.log(rng.uniform(.1, .9, (B, q))),
               log1p=np.log(rng.uniform(.1, .9, (B, q))),
               s2=rng.uniform(.01, .1, q), tau=rng.uniform(.5, 2, q),
               logtau=rng.normal(size=q))
    return {k: v.astype(dtype) for k, v in out.items()}


ORDER = ("r0", "g", "cp", "gam", "mu", "logp", "log1p", "s2", "tau", "logtau")


@pytest.mark.parametrize("B,q,q_tile,dtype,tols", [
    (128, 512, 512, np.float32, (2e-6, 2e-5)),
    (128, 512, 256, np.float32, (2e-6, 2e-5)),
    (128, 512, 128, np.float32, (2e-6, 2e-5)),
    (80, 256, 256, np.float32, (2e-6, 2e-5)),   # no JAX sub-blocking
    (128, 256, 256, np.float64, (1e-10, 1e-10)),
])
def test_inner_matches_jax_kernel(B, q, q_tile, dtype, tols):
    a = _block_inputs(B, q, dtype)
    c, lsi = 0.8, 0.3
    ref = j_inner(*[jnp.asarray(a[k]) for k in ORDER], c, lsi, q_tile=q_tile)
    launches = tsp.inner_gs_pallas.launches
    got = tsp.inner_gs_pallas(*[torch.from_numpy(a[k]) for k in ORDER], c,
                              lsi)
    assert tsp.inner_gs_pallas.launches == launches  # CPU: the plain version
    for name, u, v, tol in zip(("gam", "mu", "delta"), got, ref,
                               (tols[0], tols[1], tols[1])):
        assert u.dtype == torch.from_numpy(a["r0"]).dtype
        np.testing.assert_allclose(u.numpy(), np.asarray(v), rtol=0,
                                   atol=tol, err_msg=name)


def _arrays(obj):
    return {f.name: None if getattr(obj, f.name) is None
            else np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _problem(dtype, n, p, q, seed, q_pad_to, block=128):
    """A JAX data/hyper/state triple and the same handed to the port."""
    y, x, _ = simulate_fixture(n=n, p=p, p_act=8, q=q, seed=seed)
    dat = prepare_data(y, x, 0.1, 1000)
    p_eff, q_eff = dat.x.shape[1], dat.y.shape[1]
    kw = dict(block_size=block, shr_fac_inv=float(q_eff))
    jcfg = JConfig(dtype=dtype, use_pallas=True, **kw)
    data = jgl.build_data(dat.x, dat.y, jcfg, q_pad_to=q_pad_to)
    hyper = jgl.build_hyper(jelic.auto_set_hyper(dat.y, p_eff, (4, 16)),
                            data.y.shape[1], jcfg)
    state = jgl.build_state(jelic.auto_set_init(dat.y, p_eff, (4, 16),
                                                float(q_eff), 7), data, jcfg)
    tdt = torch.float64 if dtype == jnp.float64 else torch.float32
    tcfg = at.Config(dtype=tdt, use_pallas=True, **kw)
    port = tuple(f(_arrays(o), device="cpu") for f, o in (
        (convert.data_from_numpy, data), (convert.hyper_from_numpy, hyper),
        (convert.state_from_numpy, state)))
    return (data, hyper, state, jcfg), port, tcfg


@pytest.mark.parametrize("dtype,iters,atol", [(jnp.float32, 3, None),
                                              (jnp.float64, 1, 1e-10)])
def test_iterations_match_jax_use_pallas(dtype, iters, atol):
    """cavi_iteration through the B3 route on both sides: JAX's Pallas
    kernel (interpret mode) and the port's plain version."""
    (data, hyper, state, jcfg), (tdata, thyper, tstate), tcfg = _problem(
        dtype, 120, 256, 48, 2, 128)
    assert jgl._select_sweep(jcfg, data) == "pallas"
    assert tgl._select_sweep(tcfg, tdata) == "pallas"
    jg, tg = j_block_gram(data.x, 128), t_block_gram(tdata.x, 128)
    tsp.inner_gs_pallas.launches = 0
    for _ in range(iters):
        state = jgl.cavi_iteration(data, hyper, state, jg, 1.0, 1.0,
                                   cfg=jcfg, annealed=False)
        tstate = tgl.cavi_iteration(tdata, thyper, tstate, tg, 1.0, 1.0,
                                    cfg=tcfg, annealed=False)
    assert tsp.inner_gs_pallas.launches == 0  # CPU: the plain version
    tols = (dict(gam=5e-5, theta=5e-5, fitted=5e-3) if atol is None else
            dict(gam=atol, mu_beta=atol, theta=atol, zeta=atol, fitted=atol,
                 tau=atol))
    for name, tol in tols.items():
        np.testing.assert_allclose(getattr(tstate, name).numpy(),
                                   np.asarray(getattr(state, name)), rtol=0,
                                   atol=tol, err_msg=name)


def test_short_fit_matches_jax_f64():
    """fit_global_local through the B3 route, float64, n=100, p=75, q=20."""
    (data, hyper, state, jcfg), (tdata, thyper, tstate), tcfg = _problem(
        jnp.float64, 100, 75, 20, 123, 8)
    jcfg = dataclasses.replace(jcfg, maxit=30)
    tcfg = dataclasses.replace(tcfg, maxit=30)
    ref = j_fit(data, hyper, state, jcfg, anneal=(1, 2, 5), verbose=0)
    res = t_fit(tdata, thyper, tstate, tcfg, anneal=(1, 2, 5), verbose=0)
    assert res.it == ref.it and res.converged == ref.converged
    for name in ("gam", "mu_beta", "theta", "zeta"):
        np.testing.assert_allclose(getattr(res.state, name).numpy(),
                                   np.asarray(getattr(ref.state, name)),
                                   rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(res.lb_opt, ref.lb_opt, rtol=1e-9)


class _FakeData:
    def __init__(self, x):
        self.x, self.y = x, x


@pytest.mark.parametrize("sweep", ["auto", "fused", "pallas", "xla"])
def test_select_sweep_matches_jax(sweep):
    """On the CPU the port picks JAX's engine for every (sweep, use_pallas,
    dtype) combination."""
    for use_pallas in (False, True):
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.float64, torch.float64)):
            j = jgl._select_sweep(JConfig(dtype=jdt, sweep=sweep,
                                          use_pallas=use_pallas),
                                  _FakeData(np.zeros((8, 256), np.float32)))
            t = tgl._select_sweep(at.Config(dtype=tdt, sweep=sweep,
                                            use_pallas=use_pallas),
                                  _FakeData(torch.zeros(8, 256)))
            assert t == j, (sweep, use_pallas, tdt)


def test_wrapper_rejects_other_devices():
    x = torch.zeros((8, 8), device="meta")
    with pytest.raises(ValueError, match="device"):
        tsp.inner_gs_pallas(x, x, x, x, x, x, x, x[0], x[0], x[0], 1.0, 0.0)
