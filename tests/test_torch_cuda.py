"""The CUDA sweep kernels on the card: B1 (csrc/sweep_fused.cu, the
complete-data sweep) and B2 (csrc/sweep_missing_fused.cu, the exact-missing
sweep).

Every test here needs a CUDA device and is marked `cuda`; without one it
skips.  On a machine with an H100 run

    python -m pytest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

This file imports no JAX, so it also runs where JAX is not installed: it
replaces the suite's autouse JAX-cache fixture with a no-op.

Each kernel is held against its plain PyTorch version, fed the same
operands on the CPU, at f32 tolerances: gam atol 1e-4; the other outputs max
abs error <= 1e-4 * max |plain| (the sums run in another order).
"""
import numpy as np
import pytest
import torch

import atlasqtl_tpu_torch as at
from atlasqtl_tpu_torch.types import Config
from atlasqtl_tpu_torch.models import global_local as gl
from atlasqtl_tpu_torch.inference import elicitation as elic
from atlasqtl_tpu_torch.io.prepare import prepare_data
from atlasqtl_tpu_torch.ops import sweep_fused as sf
from atlasqtl_tpu_torch.ops import sweep_missing_fused as sm
from atlasqtl_tpu_torch.ops import updates as upd
from atlasqtl_tpu_torch.ops.sweep import SweepConsts, block_gram

from conftest import simulate_fixture

pytestmark = pytest.mark.cuda

NAMES = ("beta", "gam", "mu", "fitted", "z_row", "z_col", "gcol", "m2gcol",
         "b2col")


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_between_modules():
    """Overrides tests/conftest.py's fixture of this name: nothing here uses
    JAX, and the card's machine has none."""
    yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sweep kernel runs only on the "
                    "card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _operands(n, p, q, c, seed=3):
    """The positional operands of one f32 sweep, built on the CPU by the
    port's own data and state builders."""
    y, x, _ = simulate_fixture(n=n, p=p, p_act=8, q=q, seed=seed)
    dat = prepare_data(y, x, 0.1, 1000)
    p_eff, q_eff = dat.x.shape[1], dat.y.shape[1]
    cfg = Config(dtype=torch.float32, shr_fac_inv=float(q_eff))
    data = gl.build_data(dat.x, dat.y, cfg, "cpu")
    block = gl.data_block(cfg, data)
    state = gl.build_state(elic.auto_set_init(dat.y, p_eff, (4, 16),
                                              float(q_eff), seed), data, cfg)
    rng = np.random.default_rng(seed + 1)
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


def _flat(out):
    return list(out[:6]) + list(out[6])


@pytest.mark.parametrize("c_one,emit", [(True, True), (True, False),
                                        (False, True), (False, False)])
@pytest.mark.parametrize("n,p,q", [(120, 256, 200), (100, 75, 48)])
def test_kernel_matches_plain(cuda, n, p, q, c_one, emit):
    """(120, 256, 200): ragged q (the last of 7 column slices holds 8 of 32);
    (100, 75, 48): n % 8 != 0 (the true Gram diagonal matters) and block 80."""
    ops, block = _operands(n, p, q, 1.0 if c_one else 0.5)
    kw = dict(block_size=block, emit_gam_mu=emit, c_one=c_one)
    ref = sf.sweep_fused(*ops, **kw)
    launches = sf.sweep_fused.launches
    got = sf.sweep_fused(*[o.to(cuda) for o in ops], **kw)
    torch.cuda.synchronize()
    assert sf.sweep_fused.launches == launches + 1
    for name, a, r in zip(NAMES, _flat(got), _flat(ref)):
        if r is None:
            assert a is None, name
            continue
        assert a.device.type == "cuda" and a.shape == r.shape, name
        err = float((a.cpu() - r).abs().max())
        limit = 1e-4 if name == "gam" else 1e-4 * float(r.abs().max())
        assert err <= limit, (name, err, limit)


def test_kernel_is_deterministic(cuda):
    """No float atomics: two launches on the same inputs agree bit for bit."""
    ops, block = _operands(120, 256, 200, 0.5)
    ops = [o.to(cuda) for o in ops]
    kw = dict(block_size=block, emit_gam_mu=True, c_one=False)
    a = _flat(sf.sweep_fused(*ops, **kw))
    b = _flat(sf.sweep_fused(*ops, **kw))
    for name, u, v in zip(NAMES, a, b):
        assert torch.equal(u, v), name


def test_kernel_rejects_what_it_cannot_take(cuda):
    ops, block = _operands(120, 256, 200, 1.0)
    ops = [o.to(cuda) for o in ops]
    kw = dict(block_size=block, emit_gam_mu=True, c_one=True)
    launches = sf.sweep_fused.launches
    bad_dtype = list(ops)
    bad_dtype[0] = ops[0].double()
    with pytest.raises(ValueError, match="x must"):
        sf.sweep_fused(*bad_dtype, **kw)
    strided = list(ops)
    strided[5] = ops[5].t().contiguous().t()  # beta, column-major
    with pytest.raises(ValueError, match="beta must"):
        sf.sweep_fused(*strided, **kw)
    with pytest.raises(ValueError, match="gram_flat must"):
        sf.sweep_fused(*ops, **dict(kw, block_size=block // 2 + 4))
    assert sf.sweep_fused.launches == launches


def test_fit_on_the_card(cuda):
    """device=None runs on the card, launches the kernel once per
    iteration, and its f32 PIPs agree with the float64 CPU fit."""
    y, x, _ = simulate_fixture()
    kw = dict(p0=(5, 25), verbose=0, user_seed=123)
    sf.sweep_fused.launches = 0
    res = at.atlasqtl(y, x, dtype=torch.float32, **kw)
    assert res.converged and sf.sweep_fused.launches == res.it
    ref = at.atlasqtl(y, x, dtype=torch.float64, device="cpu", **kw)
    assert np.abs(res.gam_vb - ref.gam_vb).max() <= 1e-2


MIS_NAMES = ("gam", "mu", "fitted", "z_row", "z_col")


def _mis_operands(n, p, q, c, seed=3, frac=0.2):
    """The positional operands of one f32 exact-missing sweep (B2), built on
    the CPU by the port's own builders."""
    y, x, _ = simulate_fixture(n=n, p=p, p_act=8, q=q, seed=seed,
                               missing_frac=frac)
    dat = prepare_data(y, x, 0.1, 1000)
    p_eff, q_eff = dat.x.shape[1], dat.y.shape[1]
    cfg = Config(dtype=torch.float32, shr_fac_inv=float(q_eff), sweep="fused")
    data = gl.build_data(dat.x, dat.y, cfg, "cpu")
    assert data.x_norm_sq is not None and data.mis_pair_gram is None
    block = gl.data_block(cfg, data)
    state = gl.build_state(elic.auto_set_init(dat.y, p_eff, (4, 16),
                                              float(q_eff), seed), data, cfg)
    rng = np.random.default_rng(seed + 1)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    tau, sig2_inv, cc = f32(rng.uniform(0.5, 2.0, data.y.shape[1])), \
        f32(0.7), f32(c)
    consts = SweepConsts(
        sig2_beta=upd.sig2_beta_update(data.n, sig2_inv, tau, data.x_norm_sq,
                                       cc),
        tau=tau, log_tau=torch.log(tau) - 0.1, log_sig2_inv=f32(-0.45),
        theta=state.theta, zeta=state.zeta, c=cc)
    ops = sm.missing_fused_operands(
        data.x, data.cp_x_y, data.x_norm_sq, data.mis_pat, state.gam,
        state.mu_beta, state.fitted, consts, sig2_inv, data.p_mask,
        data.q_mask)
    return ops, block


@pytest.mark.parametrize("c", [1.0, 0.5])
@pytest.mark.parametrize("n,p,q", [(80, 250, 40), (100, 75, 48)])
def test_missing_kernel_matches_plain(cuda, n, p, q, c):
    """(80, 250, 40): ragged q (the second column slice holds 8 of 32), two
    blocks of 128; (100, 75, 48): n % 8 != 0 and block 80."""
    ops, block = _mis_operands(n, p, q, c)
    ref = sm.sweep_missing_fused(*ops, block_size=block)
    launches = sm.sweep_missing_fused.launches
    got = sm.sweep_missing_fused(*[o.to(cuda) for o in ops], block_size=block)
    torch.cuda.synchronize()
    assert sm.sweep_missing_fused.launches == launches + 1
    for name, a, r in zip(MIS_NAMES, got, ref):
        assert a.device.type == "cuda" and a.shape == r.shape, name
        err = float((a.cpu() - r).abs().max())
        limit = 1e-4 if name == "gam" else 1e-4 * float(r.abs().max())
        assert err <= limit, (name, err, limit)


def test_missing_kernel_is_deterministic(cuda):
    ops, block = _mis_operands(80, 250, 40, 0.5)
    ops = [o.to(cuda) for o in ops]
    a = sm.sweep_missing_fused(*ops, block_size=block)
    b = sm.sweep_missing_fused(*ops, block_size=block)
    for name, u, v in zip(MIS_NAMES, a, b):
        assert torch.equal(u, v), name


def test_missing_kernel_rejects_what_it_cannot_take(cuda):
    ops, block = _mis_operands(80, 250, 40, 1.0)
    ops = [o.to(cuda) for o in ops]
    launches = sm.sweep_missing_fused.launches
    bad = list(ops)
    bad[3] = ops[3].double()  # mis_pat
    with pytest.raises(ValueError, match="mis_pat must"):
        sm.sweep_missing_fused(*bad, block_size=block)
    bad = list(ops)
    bad[2] = ops[2].t().contiguous().t()  # x_norm_sq, column-major
    with pytest.raises(ValueError, match="x_norm_sq must"):
        sm.sweep_missing_fused(*bad, block_size=block)
    with pytest.raises(ValueError, match="unsupported shape"):
        sm.sweep_missing_fused(*ops, block_size=12)
    assert sm.sweep_missing_fused.launches == launches


def test_missing_fit_on_the_card(cuda):
    """device=None with NaN in Y: the exact fit launches B2 once per
    iteration and no B1; its f32 PIPs agree with the float64 CPU fit."""
    y, x, _ = simulate_fixture(missing_frac=0.2, seed=5)
    kw = dict(p0=(5, 25), verbose=0, user_seed=11, maxit=600)
    sf.sweep_fused.launches = sm.sweep_missing_fused.launches = 0
    res = at.atlasqtl(y, x, dtype=torch.float32, **kw)
    assert res.converged and sm.sweep_missing_fused.launches == res.it
    assert sf.sweep_fused.launches == 0
    ref = at.atlasqtl(y, x, dtype=torch.float64, device="cpu", **kw)
    assert np.abs(res.gam_vb - ref.gam_vb).max() <= 1e-2


def test_missing_fit_raises_on_a_block_the_kernel_cannot_take(cuda):
    """A float32 exact-missing fit on the card goes through B2 or raises:
    block 256 is beyond the kernel, and no plain engine runs instead."""
    y, x, _ = simulate_fixture(p=300, missing_frac=0.2, seed=5)
    sm.sweep_missing_fused.launches = 0
    with pytest.raises(ValueError, match="unsupported shape"):
        at.atlasqtl(y, x, p0=(5, 25), dtype=torch.float32, block_size=256,
                    verbose=0, user_seed=11, maxit=5)
    assert sm.sweep_missing_fused.launches == 0
