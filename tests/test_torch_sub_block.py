"""Predictor blocks the sweep kernels cannot hold whole, and batch="0".

The CUDA sweep kernels keep at most 128 rows of a predictor block on chip;
a larger block is walked in pieces (ops/sweep_fused.py:sub_block), which
leaves the Gauss-Seidel order unchanged.  Here, on the CPU: the launch
plans' pieces; the piece split (the repacked Gram, B1's and B4's plain
versions, B2's plain version) against the whole-block sweep in float64 to
1e-10; the port's plain B1 at block 256 against the JAX fused kernel at
block 256 in interpret mode (n % 8 == 0, so the JAX kernel's n_pad - 1
Gram diagonal is the true one); and the exact-missing engine of a
batch="0" fit, chosen as the JAX selector chooses it.  The kernels
themselves run these blocks on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from atlasqtl_tpu.types import Config as JConfig
from atlasqtl_tpu.models import global_local as jgl
from atlasqtl_tpu.inference import elicitation as jelic
from atlasqtl_tpu.io.prepare import prepare_data as j_prepare
from atlasqtl_tpu.ops import sweep as jsw
from atlasqtl_tpu.ops.sweep_fused import sweep_complete_fused as j_fused
from atlasqtl_tpu.ops.updates import sig2_beta_update

from atlasqtl_tpu_torch.types import Config
from atlasqtl_tpu_torch.models import global_local as tgl
from atlasqtl_tpu_torch.ops import sweep as tsw
from atlasqtl_tpu_torch.ops import sweep_fused as tsf
from atlasqtl_tpu_torch.ops import sweep_missing_fused as tsm
from atlasqtl_tpu_torch.ops import sweep_staggered as tss

from conftest import simulate_fixture

R_AUG = 42


@pytest.mark.parametrize("block,sub", [(8, 8), (80, 80), (128, 128),
                                       (136, 8), (200, 40), (256, 128),
                                       (384, 128), (1000, 40)])
def test_sub_block(block, sub):
    assert tsf.sub_block(block) == sub


@pytest.mark.parametrize("plan_fn", [tsf.fused_launch_plan,
                                     tsm.missing_launch_plan,
                                     tss.staggered_launch_plan])
@pytest.mark.parametrize("block,sub", [(200, 40), (256, 128), (128, 128)])
def test_plans_walk_large_blocks_in_pieces(plan_fn, block, sub):
    plan = plan_fn(1000, 10000, block, R_AUG)
    assert plan["sub_block"] == sub
    # the shared memory is the piece's, which the kernel takes
    assert plan["smem_bytes"] == plan_fn(1000, 10000, sub,
                                         R_AUG)["smem_bytes"]


@pytest.mark.parametrize("plan_fn", [tsf.fused_launch_plan,
                                     tsm.missing_launch_plan,
                                     tss.staggered_launch_plan])
@pytest.mark.parametrize("block", [1, 4, 100, 260])
def test_plans_refuse_blocks_the_reference_does_not_fuse(plan_fn, block):
    """Block 1 (batch="0") never reaches a fused kernel in either package
    (models/global_local.py:_select_sweep, _missing_uses_kernel); the JAX
    fused kernels ask block % sub == 0 with sub a multiple of 8."""
    with pytest.raises(ValueError, match="unsupported"):
        plan_fn(1000, 10000, block, R_AUG)


def _fused_operands(n, p, q, c, block, seed=5):
    """A float64 CPU operand set of one complete-data sweep."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    x = t(rng.standard_normal((n, p)))
    beta = t(rng.normal(0, 0.05, (p, q)))
    consts = tsw.SweepConsts(
        sig2_beta=t(rng.uniform(0.01, 0.1, q)), tau=t(rng.uniform(.5, 2, q)),
        log_tau=t(rng.normal(0, .1, q)), log_sig2_inv=t(-0.3),
        theta=t(rng.normal(-1, .3, p)), zeta=t(rng.normal(-1, .3, q)),
        c=t(c))
    return tsf.fused_operands(x, x.T @ t(rng.standard_normal((n, q))),
                              tsw.block_gram(x, block), beta, x @ beta,
                              consts, block)


def _close(got, ref, tol):
    flat = lambda o: [v for v in list(o[:6]) + list(o[6]) if v is not None]
    for a, r in zip(flat(got), flat(ref)):
        assert float((a - r).abs().max()) <= tol * max(
            1.0, float(r.abs().max()))


@pytest.mark.parametrize("plain", [tsf.sweep_fused_plain,
                                   tss.sweep_staggered_plain])
@pytest.mark.parametrize("block", [200, 256])
def test_piece_split_equals_the_whole_block(plain, block):
    """The pieces a kernel walks (sub_block rows, their Gram repacked by
    sub_block_gram) give the whole-block sweep to 1e-10 in float64."""
    ops = _fused_operands(64, 2 * block, 24, 0.5, block)
    sub = tsf.sub_block(block)
    pieces = list(ops)
    pieces[2] = tsf.sub_block_gram(ops[2], block, sub)
    whole_gram = tsw.block_gram(ops[0], sub).reshape(-1, sub)
    assert torch.equal(pieces[2], whole_gram)
    kw = dict(emit_gam_mu=True, c_one=False)
    _close(plain(*pieces, block_size=sub, **kw),
           plain(*ops, block_size=block, **kw), 1e-10)


def test_missing_piece_split_equals_the_whole_block():
    """B2's plain version at block 256 and in its pieces of 128 (B2 builds
    its pair Grams itself, so only the block size changes)."""
    rng = np.random.default_rng(2)
    n, p, q = 48, 512, 16
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    x = t(rng.standard_normal((n, p)))
    mis = t(rng.uniform(size=(n, q)) > 0.2)
    gam, mu = t(rng.uniform(.1, .9, (p, q))), t(rng.normal(0, .05, (p, q)))
    x_norm_sq = (x * x).T @ mis
    consts = tsw.SweepConsts(
        sig2_beta=None, tau=t(rng.uniform(.5, 2, q)),
        log_tau=t(rng.normal(0, .1, q)), log_sig2_inv=t(-0.3),
        theta=t(rng.normal(-1, .3, p)), zeta=t(rng.normal(-1, .3, q)),
        c=t(0.5))
    ops = tsm.missing_fused_operands(
        x, x.T @ (t(rng.standard_normal((n, q))) * mis), x_norm_sq, mis, gam,
        mu, (x @ (gam * mu)) * mis, consts, t(0.7), t(np.ones(p)),
        t(np.ones(q)))
    whole = tsm.sweep_missing_fused_plain(*ops, block_size=256)
    pieces = tsm.sweep_missing_fused_plain(*ops, block_size=128)
    for a, r in zip(pieces, whole):
        assert float((a - r).abs().max()) <= 1e-10 * max(
            1.0, float(r.abs().max()))


def test_plain_matches_jax_fused_kernel_at_block_256():
    """One float32 sweep at block 256 (p = 256, n = 120): the port's plain
    version against the JAX fused kernel in interpret mode.  Tolerances as
    tests/test_torch_sweep_fused.py: gam, mu, beta atol 1e-5; the rest 1e-4
    of max."""
    y, x, _ = simulate_fixture(n=120, p=256, p_act=8, q=128, seed=3)
    dat = j_prepare(y, x, 0.1, 1000)
    p_eff, q_eff = dat.x.shape[1], dat.y.shape[1]
    cfg = JConfig(dtype=jnp.float32, block_size=256, shr_fac_inv=float(q_eff))
    data = jgl.build_data(dat.x, dat.y, cfg, q_pad_to=128)
    assert data.x.shape == (120, 256)
    state = jgl.build_state(
        jelic.auto_set_init(dat.y, p_eff, (4, 16), float(q_eff), 7), data,
        cfg)
    rng = np.random.default_rng(1)
    tau = jnp.asarray(rng.uniform(0.5, 2.0, data.y.shape[1]), jnp.float32)
    cc = jnp.asarray(1.0, jnp.float32)
    consts = jsw.SweepConsts(
        sig2_beta=sig2_beta_update(data.n, jnp.asarray(0.7, jnp.float32),
                                   tau, None, cc),
        tau=tau, log_tau=jnp.log(tau),
        log_sig2_inv=jnp.asarray(-0.3, jnp.float32), theta=state.theta,
        zeta=state.zeta, c=cc)
    gram = jsw.block_gram(data.x, 256)
    ref = j_fused(data.x, data.cp_x_y, gram, state.gam * state.mu_beta,
                  state.fitted, consts, 256, p_mask=data.p_mask,
                  q_mask=data.q_mask, q_tile=128, sub=32, qchunk=128)
    t = lambda a: torch.from_numpy(np.array(a))
    got = tsf.sweep_complete_fused(
        t(data.x), t(data.cp_x_y), t(gram), t(state.gam * state.mu_beta),
        t(state.fitted), tsw.SweepConsts(*[t(v) for v in consts]), 256,
        p_mask=t(data.p_mask), q_mask=t(data.q_mask))
    names = ("beta", "gam", "mu", "fitted", "z_row", "z_col", "gcol",
             "m2gcol", "b2col")
    flat = lambda o: list(o[:6]) + list(o[6])
    for name, a, r in zip(names, flat(got), flat(ref)):
        a, r = np.asarray(a, np.float64), np.asarray(r, np.float64)
        err = np.abs(a - r).max()
        limit = 1e-5 if name in ("beta", "gam", "mu") else \
            1e-4 * np.abs(r).max()
        assert err <= limit, (name, err, limit)


@pytest.mark.parametrize("p,engine", [(80, "blocked"), (75, "scan")])
def test_batch0_missing_fit_routes_as_the_reference(p, engine):
    """batch="0" (block 1) with NaN in Y: both packages take a plain engine,
    blocked where mis_block = 8 divides p (pair Grams precomputed), else the
    per-coordinate scan; never the fused kernel, in either dtype."""
    y, x, _ = simulate_fixture(n=60, p=p, p_act=5, q=12, seed=4,
                               missing_frac=0.2)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.float64, torch.float64)):
        jcfg = JConfig(dtype=jdt, block_size=1)
        jdata = jgl.build_data(x, y, jcfg)
        tcfg = Config(dtype=tdt, block_size=1)
        tdata = tgl.build_data(x, y, tcfg, "cpu")
        assert jgl._select_missing_sweep(jcfg, jdata) == engine
        assert tgl._select_missing_sweep(tcfg, tdata) == engine
        assert not tgl._missing_uses_kernel(tcfg, "cuda")
        assert not tgl._missing_uses_kernel(
            Config(dtype=tdt, block_size=1, sweep="fused"), "cuda")
    # a block of 8 or more on the card takes B2, at any multiple of 8
    for block in (8, 128, 256):
        assert tgl._missing_uses_kernel(Config(block_size=block), "cuda")
