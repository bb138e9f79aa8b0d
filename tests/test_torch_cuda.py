"""The CUDA sweep kernel (atlasqtl_tpu_torch/csrc/sweep_fused.cu) on the card.

Every test here needs a CUDA device and is marked `cuda`; without one it
skips.  On a machine with an H100 run

    python -m pytest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

This file imports no JAX, so it also runs where JAX is not installed: it
replaces the suite's autouse JAX-cache fixture with a no-op.

The kernel is held against its plain PyTorch version, fed the same operands
on the CPU, at f32 tolerances: gam atol 1e-4; the other outputs max abs
error <= 1e-4 * max |plain| (the sums run in another order).
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
        sig2_beta=upd.sig2_beta_update(data.n, f32(0.7), tau, cc), tau=tau,
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
