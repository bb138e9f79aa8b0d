"""The port's fused sweep (ops/sweep_fused.py).  On the CPU the wrapper runs
the kernel's plain PyTorch version, held here against the JAX fused kernel in
interpret mode (n % 8 == 0) and against the JAX XLA sweep (n % 8 != 0, where
the JAX kernel's n_pad - 1 Gram diagonal is wrong and the port uses the true
one).  The CUDA kernel itself is held against the plain version on the card
by chip_smoke.py.

Tolerances (float32, one sweep): gam, mu, beta atol 1e-5; fitted, z_row,
z_col and the column statistics: max abs error <= 1e-4 * max |reference|
(the interpolated Mills tiles and the sums' order differ at f32 rounding).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from atlasqtl_tpu.types import Config as JConfig
from atlasqtl_tpu.models import global_local as jgl
from atlasqtl_tpu.inference import elicitation as jelic
from atlasqtl_tpu.io.prepare import prepare_data
from atlasqtl_tpu.ops import sweep as jsw
from atlasqtl_tpu.ops.sweep_fused import sweep_complete_fused as j_fused
from atlasqtl_tpu.ops.updates import sig2_beta_update

from atlasqtl_tpu_torch.ops import sweep as tsw
from atlasqtl_tpu_torch.ops import sweep_fused as tsf

from conftest import simulate_fixture

NAMES = ("beta", "gam", "mu", "fitted", "z_row", "z_col", "gcol", "m2gcol",
         "b2col")


def _problem(n, q, c, block, seed=3):
    """A JAX float32 data/state pair plus the sweep constants, q padded to
    128 as the JAX kernel's tiling needs."""
    y, x, _ = simulate_fixture(n=n, p=256, p_act=8, q=q, seed=seed)
    dat = prepare_data(y, x, 0.1, 1000)
    p_eff, q_eff = dat.x.shape[1], dat.y.shape[1]
    cfg = JConfig(dtype=jnp.float32, block_size=128, shr_fac_inv=float(q_eff))
    data = jgl.build_data(dat.x, dat.y, cfg, q_pad_to=128)
    state = jgl.build_state(
        jelic.auto_set_init(dat.y, p_eff, (4, 16), float(q_eff), 7), data,
        cfg)
    rng = np.random.default_rng(1)
    tau = jnp.asarray(rng.uniform(0.5, 2.0, data.y.shape[1]), jnp.float32)
    cc = jnp.asarray(c, jnp.float32)
    s2 = sig2_beta_update(data.n, jnp.asarray(0.7, jnp.float32), tau, None,
                          cc)
    consts = jsw.SweepConsts(sig2_beta=s2, tau=tau, log_tau=jnp.log(tau),
                             log_sig2_inv=jnp.asarray(-0.3, jnp.float32),
                             theta=state.theta, zeta=state.zeta, c=cc)
    return data, state, jsw.block_gram(data.x, block), consts


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_sweep(data, state, gram, consts, emit, annealed):
    tconsts = tsw.SweepConsts(*[_t(v) for v in consts])
    return tsf.sweep_complete_fused(
        _t(data.x), _t(data.cp_x_y), _t(gram), _t(state.gam * state.mu_beta),
        _t(state.fitted), tconsts, gram.shape[1], p_mask=_t(data.p_mask),
        q_mask=_t(data.q_mask), emit_gam_mu=emit, annealed=annealed)


def _check(got, ref):
    flat = lambda o: list(o[:6]) + list(o[6])
    for name, a, r in zip(NAMES, flat(got), flat(ref)):
        if r is None:
            assert a is None, name
            continue
        a = np.asarray(a, np.float64)
        r = np.asarray(r, np.float64)
        assert a.shape == r.shape, name
        err = np.abs(a - r).max()
        if name in ("beta", "gam", "mu"):
            assert err <= 1e-5, (name, err)
        else:
            assert err <= 1e-4 * np.abs(r).max(), (name, err)


@pytest.mark.parametrize("annealed,emit", [(False, True), (False, False),
                                           (True, True), (True, False)])
def test_plain_matches_jax_fused_kernel(annealed, emit):
    """Predictor blocks of 32 (8 blocks of p = 256) keep the interpret-mode
    trace of the JAX kernel small; block 128 is covered by the ragged-n test
    and tests/test_torch_model.py."""
    data, state, gram, consts = _problem(120, 128, 0.5 if annealed else 1.0,
                                         32)
    ref = j_fused(data.x, data.cp_x_y, gram, state.gam * state.mu_beta,
                  state.fitted, consts, 32, p_mask=data.p_mask,
                  q_mask=data.q_mask, q_tile=128, sub=32, qchunk=128,
                  emit_gam_mu=emit, annealed=annealed)
    got = _port_sweep(data, state, gram, consts, emit, annealed)
    assert tsf.sweep_fused.launches == 0  # CPU: the plain version
    _check(got, ref)


@pytest.mark.parametrize("annealed", [False, True])
def test_plain_matches_xla_sweep_ragged_n(annealed):
    """n = 100 is padded to 104 rows: the true Gram diagonal is 99, not
    n_pad - 1 = 103 as the JAX kernel assumes (atlasqtl_tpu/ops/
    sweep_fused.py:504), so the reference here is the JAX XLA sweep."""
    data, state, gram, consts = _problem(100, 48, 0.5 if annealed else 1.0,
                                         128)
    assert data.x.shape[0] == 104
    g, m, f, zr, zc = jsw.sweep_complete(
        data.x, data.cp_x_y, gram, state.gam, state.mu_beta, state.fitted,
        consts, 128, p_mask=data.p_mask, q_mask=data.q_mask)
    msk = np.asarray(data.p_mask)[:, None] * np.asarray(data.q_mask)[None, :]
    g = np.asarray(g, np.float64) * msk
    m = np.asarray(m, np.float64) * msk
    b = g * m
    ref = (b, g, m, f, zr, zc, (g.sum(0), (m * m * g).sum(0), (b * b).sum(0)))
    _check(_port_sweep(data, state, gram, consts, True, annealed), ref)


def test_jax_fused_kernel_diagonal_fault_at_ragged_n():
    """Documents why the port departs from the JAX fused kernel: at n=100
    (padded to 104) the JAX kernel's n_pad - 1 diagonal moves mu by ~2.5e-3
    against the XLA sweep, where the port's plain version (true diagonal)
    agrees to f32 rounding."""
    data, state, gram, consts = _problem(100, 48, 1.0, 32)
    g, m, *_ = jsw.sweep_complete(
        data.x, data.cp_x_y, gram, state.gam, state.mu_beta, state.fitted,
        consts, 32, p_mask=data.p_mask, q_mask=data.q_mask)
    msk = np.asarray(data.p_mask)[:, None] * np.asarray(data.q_mask)[None, :]
    mu_ref = np.asarray(m, np.float64) * msk
    jax_mu = j_fused(data.x, data.cp_x_y, gram, state.gam * state.mu_beta,
                     state.fitted, consts, 32, p_mask=data.p_mask,
                     q_mask=data.q_mask, q_tile=128, sub=32, qchunk=128)[2]
    port_mu = _port_sweep(data, state, gram, consts, True, False)[2]
    assert np.abs(np.asarray(jax_mu) - mu_ref).max() > 1e-3
    assert np.abs(port_mu.numpy() - mu_ref).max() < 1e-5


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="device"):
        x = torch.zeros((8, 8), device="meta")
        tsf.sweep_fused(*([x] * 15), block_size=8)
