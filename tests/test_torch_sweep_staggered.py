"""The port's staggered fused sweep (ops/sweep_staggered.py, the route of
Config(sweep_stagger=True)).  Its function is B1's: on the CPU its plain
version runs the staggered schedule in plain tensor ops and must equal
sweep_fused_plain bit for bit, and the CPU route is held against the JAX
fused kernel in interpret mode with the tolerances of
tests/test_torch_sweep_fused.py.  The JAX staggered kernel itself is not
run here: its interpret-mode compile has crashed the XLA CPU backend inside
the suite's process (tests/test_pallas.py runs it in a subprocess).  The
CUDA kernel is held against B1 on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import dataclasses

import numpy as np
import pytest
import torch

from atlasqtl_tpu_torch.types import Config
from atlasqtl_tpu_torch.models import global_local as gl
from atlasqtl_tpu_torch.inference import elicitation as elic
from atlasqtl_tpu_torch.io.prepare import prepare_data
from atlasqtl_tpu_torch.ops import sweep_fused as sf
from atlasqtl_tpu_torch.ops import sweep_staggered as ss
from atlasqtl_tpu_torch.ops import updates as upd
from atlasqtl_tpu_torch.ops.sweep import SweepConsts, block_gram

from atlasqtl_tpu.ops.sweep_fused import sweep_complete_fused as j_fused

from conftest import simulate_fixture
from test_torch_sweep_fused import _check, _problem, _t

MODES = [(True, True), (True, False), (False, True), (False, False)]


def _operands(n, p, q, c, seed):
    """The positional operands of one float32 sweep, built on the CPU by the
    port's own builders."""
    y, x, _ = simulate_fixture(n=n, p=p, p_act=8, q=q, seed=seed)
    dat = prepare_data(y, x, 0.1, 1000)
    p_eff, q_eff = dat.x.shape[1], dat.y.shape[1]
    cfg = Config(dtype=torch.float32, shr_fac_inv=float(q_eff))
    data = gl.build_data(dat.x, dat.y, cfg, "cpu")
    block = gl.data_block(cfg, data)
    state = gl.build_state(elic.auto_set_init(dat.y, p_eff, (4, 16),
                                              float(q_eff), 7), data, cfg)
    rng = np.random.default_rng(1)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    tau = f32(rng.uniform(0.5, 2.0, data.y.shape[1]))
    cc = f32(c)
    consts = SweepConsts(
        sig2_beta=upd.sig2_beta_update(data.n, f32(0.7), tau, c=cc), tau=tau,
        log_tau=torch.log(tau), log_sig2_inv=f32(-0.3), theta=state.theta,
        zeta=state.zeta, c=cc)
    ops = sf.fused_operands(data.x, data.cp_x_y, block_gram(data.x, block),
                            state.beta, state.fitted, consts, block,
                            data.p_mask, data.q_mask)
    return ops, block


@pytest.mark.parametrize("c_one,emit", MODES)
@pytest.mark.parametrize("n,p,q,seed", [(80, 300, 256, 7), (100, 75, 20, 123)])
def test_plain_is_bitwise_the_fused_plain(n, p, q, seed, c_one, emit):
    """(80, 300, 256): the JAX equivalence worker's fixture
    (tests/_staggered_eq_worker.py), three blocks of 128, halves of 128;
    (100, 75, 20): block 80, one block (the first step meets the drain
    step), all 24 columns in half B."""
    ops, block = _operands(n, p, q, 1.0 if c_one else 0.5, seed)
    kw = dict(block_size=block, emit_gam_mu=emit, c_one=c_one)
    launches = ss.sweep_fused_staggered.launches
    got = ss.sweep_fused_staggered(*ops, **kw)
    assert ss.sweep_fused_staggered.launches == launches  # CPU: plain
    ref = sf.sweep_fused_plain(*ops, **kw)
    flat = lambda o: list(o[:6]) + list(o[6])
    for name, a, r in zip(("beta", "gam", "mu", "fitted", "z_row", "z_col",
                           "gcol", "m2gcol", "b2col"), flat(got), flat(ref)):
        if r is None:
            assert a is None, name
            continue
        assert torch.equal(a, r), name


@pytest.mark.parametrize("annealed", [False, True])
def test_cpu_route_matches_jax_fused_kernel(annealed):
    """n = 120 (a multiple of 8, where the JAX kernel's n_pad - 1 diagonal
    is right); block 32 keeps the interpret-mode trace small."""
    data, state, gram, consts = _problem(120, 128, 0.5 if annealed else 1.0,
                                         32)
    ref = j_fused(data.x, data.cp_x_y, gram, state.gam * state.mu_beta,
                  state.fitted, consts, 32, p_mask=data.p_mask,
                  q_mask=data.q_mask, q_tile=128, sub=32, qchunk=128,
                  emit_gam_mu=True, annealed=annealed)
    tconsts = SweepConsts(*[_t(v) for v in consts])
    got = ss.sweep_complete_staggered(
        _t(data.x), _t(data.cp_x_y), _t(gram), _t(state.gam * state.mu_beta),
        _t(state.fitted), tconsts, 32, p_mask=_t(data.p_mask),
        q_mask=_t(data.q_mask), emit_gam_mu=True, annealed=annealed)
    _check(got, ref)


@pytest.mark.parametrize("lite", [False, True])
def test_stagger_iteration_is_bitwise_the_fused_one(lite):
    """One CAVI iteration on the CPU with sweep_stagger equals the fused
    route's bit for bit, in the full and the lite carry; q = 200 is padded
    to 256, where the JAX package's fused tile is 256 and the flag selects
    B4 (C10), and splits into halves of 128 columns."""
    y, x, _ = simulate_fixture(n=80, p=300, p_act=8, q=200, seed=7)
    dat = prepare_data(y, x, 0.1, 1000)
    p_eff, q_eff = dat.x.shape[1], dat.y.shape[1]
    cfg = Config(dtype=torch.float32, sweep="fused",
                 shr_fac_inv=float(q_eff))
    data = gl.build_data(dat.x, dat.y, cfg, "cpu", q_pad_to=256)
    hyper = gl.build_hyper(elic.auto_set_hyper(dat.y, p_eff, (4, 16)),
                           data.y.shape[1], cfg, "cpu")
    state = gl.build_state(elic.auto_set_init(dat.y, p_eff, (4, 16),
                                              float(q_eff), 7), data, cfg)
    gram = block_gram(data.x, gl.data_block(cfg, data))
    kw = dict(cfg=cfg, annealed=lite, lite=lite)
    ref = gl.cavi_iteration(data, hyper, state, gram, 0.5, 0.5, **kw)
    kw["cfg"] = dataclasses.replace(cfg, sweep_stagger=True)
    assert gl._engine(kw["cfg"], data) == "b4"
    got = gl.cavi_iteration(data, hyper, state, gram, 0.5, 0.5, **kw)
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        assert (a is None) == (b is None), f.name
        if b is not None:
            assert torch.equal(a, b), f.name


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="device"):
        x = torch.zeros((8, 8), device="meta")
        ss.sweep_fused_staggered(*([x] * 15), block_size=8)
