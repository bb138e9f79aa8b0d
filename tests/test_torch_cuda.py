"""The CUDA sweep kernels on the card: B1 (csrc/sweep_fused.cu, the
complete-data sweep), B2 (csrc/sweep_missing_fused.cu, the exact-missing
sweep), B3 (csrc/sweep_inner_gs.cu: the route's block kernel and its
tiles-read instance, float32 and float64) and B4 (csrc/sweep_staggered.cu,
the staggered complete-data sweep).

Every test here needs a CUDA device and is marked `cuda`; without one it
skips.  On a machine with an H100 run

    python -m pytest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

This file imports no JAX, so it also runs where JAX is not installed: it
replaces the suite's autouse JAX-cache fixture with a no-op.

Each kernel is held against its plain PyTorch version, fed the same
operands on the CPU, at f32 tolerances: gam atol 1e-4; the other outputs max
abs error <= 1e-4 * max |plain| (the sums run in another order); B3 in
float64 to 1e-10.  B4 computes B1's function, but B1 sums its products in
another order than B4 (one fused pass per block), so B4 is held against B1
on the card at the same tolerances.  B1 and B2 are also run at shapes that
reach each branch of their launch plans (ops/sweep_fused.py:
fused_launch_plan, ops/sweep_missing_fused.py:missing_launch_plan).
"""
import dataclasses
import os
import subprocess
import sys

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
from atlasqtl_tpu_torch.ops import sweep_pallas as sp
from atlasqtl_tpu_torch.ops import sweep_staggered as ss
from atlasqtl_tpu_torch.inference.driver import fit_global_local
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


def _operands(n, p, q, c, seed=3, block=128):
    """The positional operands of one f32 sweep, built on the CPU by the
    port's own data and state builders."""
    y, x, _ = simulate_fixture(n=n, p=p, p_act=8, q=q, seed=seed)
    dat = prepare_data(y, x, 0.1, 1000)
    p_eff, q_eff = dat.x.shape[1], dat.y.shape[1]
    cfg = Config(dtype=torch.float32, shr_fac_inv=float(q_eff),
                 block_size=block)
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
@pytest.mark.parametrize("n,p,q,width,blk", [(120, 256, 200, 32, 128),
                                             (100, 75, 48, 32, 80),
                                             (1001, 256, 104, 32, 128),
                                             (100, 128, 4804, 40, 128),
                                             (120, 512, 200, 32, 256),
                                             (100, 400, 104, 32, 200)])
def test_kernel_matches_plain(cuda, n, p, q, width, blk, c_one, emit):
    """(120, 256, 200): ragged q (the last of 7 column slices holds 8 of 32);
    (100, 75, 48): n % 8 != 0 (the true Gram diagonal matters) and block 80;
    (1001, 256, 104): many sample chunks, the last one ragged;
    (100, 128, 4804): the plan takes 40-column slices (one wave on 132 SMs
    where 32 columns take two), the last one ragged; blocks 256 and 200,
    walked in pieces of 128 and 40 (ops/sweep_fused.py:sub_block)."""
    ops, block = _operands(n, p, q, 1.0 if c_one else 0.5, block=blk)
    assert block == blk
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert sf.fused_launch_plan(n, q, block, ops[3].shape[1],
                                sms)["slice_width"] == width
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


@pytest.mark.parametrize("q", [200, 4804])
def test_kernel_is_deterministic(cuda, q):
    """No float atomics: two launches on the same inputs agree bit for bit,
    in 32-column (q = 200) and 40-column (q = 4804) slices."""
    ops, block = _operands(120, 256, q, 0.5)
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


def test_launch_plans_match_the_kernels(cuda):
    """The plans' shared-memory arithmetic (plain Python, checked on the
    CPU by tests/test_torch_launch_plan.py) equals the kernels' own, and
    B1 holds the one CTA per SM its plan counts on, at the smallest block
    too (its registers, not its shared memory, allow no second)."""
    for width in sf.FUSED_WIDTHS:
        for block in (8, 80, 128):
            for r_aug in (1, 42, 48):
                assert (sf.kernel_smem_bytes(width, block, r_aug)
                        == sf._fused_smem_bytes(width, block, r_aug))
                plan = sf.fused_launch_plan(1000, 10000, block, r_aug)
                assert sf.occupancy(width, block, r_aug) \
                    == plan["ctas_per_sm"] == 1
    for width in ss.STAG_WIDTHS:
        for block in (8, 80, 128):
            for r_aug in (1, 42, 48):
                assert (ss.kernel_smem_bytes(width, block, r_aug)
                        == ss._stag_smem_bytes(width, block, r_aug))
                assert ss.occupancy(width, block, r_aug) == 1
    for n in (1, 80, 1000, 4000, 7000, 8000, 50000):
        for r_aug in (1, 42, 48):
            plan = sm.missing_launch_plan(n, 10000, 128, r_aug)
            assert sm.kernel_smem_bytes(plan, n, r_aug) == plan["smem_bytes"]
            ctas, clusters = sm.occupancy(plan, n, r_aug)
            assert ctas >= plan["ctas_per_sm"] and clusters >= 1


def _host_init(y, x, seed):
    """The InitSpec atlasqtl(user_seed=seed) draws on the host: a card fit
    compared with a CPU fit takes it through list_init on both sides (on
    the card atlasqtl() would draw its own state on the device)."""
    dat = prepare_data(y, x, 0.1, 1000)
    return elic.auto_set_init(dat.y, dat.x.shape[1], (5, 25),
                              float(dat.y.shape[1]), seed)


def test_fit_on_the_card(cuda):
    """device=None runs on the card, launches the kernel once per
    iteration, and its f32 PIPs agree with the float64 CPU fit."""
    y, x, _ = simulate_fixture()
    kw = dict(p0=(5, 25), verbose=0, user_seed=123,
              list_init=_host_init(y, x, 123))
    sf.sweep_fused.launches = 0
    res = at.atlasqtl(y, x, dtype=torch.float32, **kw)
    assert res.converged and sf.sweep_fused.launches == res.it
    ref = at.atlasqtl(y, x, dtype=torch.float64, device="cpu", **kw)
    assert np.abs(res.gam_vb - ref.gam_vb).max() <= 1e-2


MIS_NAMES = ("gam", "mu", "fitted", "z_row", "z_col")


def _mis_operands(n, p, q, c, seed=3, frac=0.2, block=128):
    """The positional operands of one f32 exact-missing sweep (B2), built on
    the CPU by the port's own builders."""
    y, x, _ = simulate_fixture(n=n, p=p, p_act=8, q=q, seed=seed,
                               missing_frac=frac)
    dat = prepare_data(y, x, 0.1, 1000)
    p_eff, q_eff = dat.x.shape[1], dat.y.shape[1]
    cfg = Config(dtype=torch.float32, shr_fac_inv=float(q_eff), sweep="fused",
                 block_size=block)
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
@pytest.mark.parametrize("n,p,q,blk", [(80, 250, 40, 128), (100, 75, 48, 80),
                                       (100, 512, 40, 256)])
def test_missing_kernel_matches_plain(cuda, n, p, q, blk, c):
    """(80, 250, 40): ragged q (the second column slice holds 8 of 32), two
    blocks of 128; (100, 75, 48): n % 8 != 0 and block 80; (100, 512, 40):
    two blocks of 256, each walked in pieces of 128."""
    ops, block = _mis_operands(n, p, q, c, block=blk)
    assert block == blk
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


@pytest.mark.parametrize("n,p,q,cluster,on_chip", [
    (200, 128, 4800, 1, True), (500, 128, 4000, 2, True),
    (800, 128, 4800, 3, True), (4000, 128, 1024, 5, True),
    (8000, 128, 256, 1, False)])
def test_missing_kernel_plans_match_plain(cuda, n, p, q, cluster, on_chip):
    """B2 at shapes whose launch plans take clusters of 1, 2 and 3 CTAs with
    two CTAs per SM, 5 with one per SM, and the device-memory branch."""
    ops, block = _mis_operands(n, p, q, 0.5, frac=0.15)
    plan = sm.missing_launch_plan(ops[0].shape[0], ops[6].shape[1], block,
                                  ops[4].shape[1])
    assert (plan["cluster"], plan["fm_on_chip"]) == (cluster, on_chip)
    ctas, _ = sm.occupancy(plan, ops[0].shape[0], ops[4].shape[1])
    assert ctas >= plan["ctas_per_sm"]
    ref = sm.sweep_missing_fused(*ops, block_size=block)
    got = sm.sweep_missing_fused(*[o.to(cuda) for o in ops], block_size=block)
    torch.cuda.synchronize()
    for name, a, r in zip(MIS_NAMES, got, ref):
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
    kw = dict(p0=(5, 25), verbose=0, user_seed=11, maxit=600,
              list_init=_host_init(y, x, 11))
    sf.sweep_fused.launches = sm.sweep_missing_fused.launches = 0
    res = at.atlasqtl(y, x, dtype=torch.float32, **kw)
    assert res.converged and sm.sweep_missing_fused.launches == res.it
    assert sf.sweep_fused.launches == 0
    ref = at.atlasqtl(y, x, dtype=torch.float64, device="cpu", **kw)
    assert np.abs(res.gam_vb - ref.gam_vb).max() <= 1e-2


def test_missing_fit_raises_on_a_block_the_kernel_cannot_take(cuda):
    """A float32 exact-missing fit on the card at block 256, which B2 once
    refused: it now walks the block in pieces of 128, launches B2 once per
    iteration and no plain engine, and its PIPs agree with the float64 CPU
    fit at the same block within 1e-2."""
    y, x, _ = simulate_fixture(p=300, missing_frac=0.2, seed=5)
    kw = dict(p0=(5, 25), verbose=0, user_seed=11, maxit=600,
              block_size=256, list_init=_host_init(y, x, 11))
    sf.sweep_fused.launches = sm.sweep_missing_fused.launches = 0
    res = at.atlasqtl(y, x, dtype=torch.float32, **kw)
    assert res.converged and sm.sweep_missing_fused.launches == res.it
    assert sf.sweep_fused.launches == 0
    ref = at.atlasqtl(y, x, dtype=torch.float64, device="cpu", **kw)
    assert np.abs(res.gam_vb - ref.gam_vb).max() <= 1e-2


@pytest.mark.parametrize("missing", [None, "exact", "impute"])
def test_block_256_fit_on_the_card(cuda, missing):
    """atlasqtl(..., block_size=256) on complete data and with 20% of Y
    missing in each mode: B1 (complete, impute) or B2 (exact) once per
    iteration; PIPs within 1e-2 of the float64 CPU fit."""
    y, x, _ = simulate_fixture(p=300, missing_frac=0.2 if missing else 0.0,
                               seed=5)
    kw = dict(p0=(5, 25), verbose=0, user_seed=11, maxit=600,
              block_size=256, list_init=_host_init(y, x, 11),
              **({"missing": missing} if missing else {}))
    sf.sweep_fused.launches = sm.sweep_missing_fused.launches = 0
    res = at.atlasqtl(y, x, dtype=torch.float32, **kw)
    own = sm.sweep_missing_fused if missing == "exact" else sf.sweep_fused
    assert res.converged and own.launches == res.it
    ref = at.atlasqtl(y, x, dtype=torch.float64, device="cpu", **kw)
    assert np.abs(res.gam_vb - ref.gam_vb).max() <= 1e-2


def test_batch0_missing_fit_on_the_card(cuda):
    """batch="0" with NaN in Y runs the plain per-coordinate engines on the
    card (no kernel, as in the reference) and agrees with the float64 CPU
    fit within 1e-2."""
    y, x, _ = simulate_fixture(n=60, p=30, q=10, missing_frac=0.2, seed=5)
    kw = dict(p0=(5, 25), verbose=0, user_seed=11, maxit=600, batch="0",
              list_init=_host_init(y, x, 11))
    sf.sweep_fused.launches = sm.sweep_missing_fused.launches = 0
    res = at.atlasqtl(y, x, dtype=torch.float32, **kw)
    assert res.converged
    assert sf.sweep_fused.launches == sm.sweep_missing_fused.launches == 0
    ref = at.atlasqtl(y, x, dtype=torch.float64, device="cpu", **kw)
    assert np.abs(res.gam_vb - ref.gam_vb).max() <= 1e-2


GS_NAMES = ("gam", "mu", "delta")


def _gs_operands(B, q, dtype, seed=1):
    """One block's operands of the inner update (B3), from a seed."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(B, B))
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    return [t(rng.normal(size=(B, q))), t(g @ g.T / B),
            t(rng.normal(size=(B, q))), t(rng.uniform(.1, .9, (B, q))),
            t(rng.normal(size=(B, q))), t(np.log(rng.uniform(.1, .9, (B, q)))),
            t(np.log(rng.uniform(.1, .9, (B, q)))),
            t(rng.uniform(.01, .1, q)), t(rng.uniform(.5, 2, q)),
            t(rng.normal(size=q)), 0.8, 0.3]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,q", [(128, 200), (80, 48), (256, 72)])
def test_inner_gs_kernel_matches_plain(cuda, B, q, dtype):
    """(128, 200): a ragged last slice (8 of 32 columns); (80, 48): block
    80; (256, 72): a block over 128 in one launch (rows beyond 128 read
    from device memory)."""
    ops = _gs_operands(B, q, dtype)
    ref = sp.inner_gs_pallas(*ops)
    launches = sp.inner_gs_pallas.launches
    got = sp.inner_gs_pallas(*[o.to(cuda) if torch.is_tensor(o) else o
                               for o in ops])
    torch.cuda.synchronize()
    assert sp.inner_gs_pallas.launches == launches + 1
    for name, a, r in zip(GS_NAMES, got, ref):
        assert a.device.type == "cuda" and a.dtype == dtype, name
        err = float((a.cpu() - r).abs().max())
        limit = (1e-10 if dtype == torch.float64
                 else 1e-4 if name == "gam" else 1e-4 * float(r.abs().max()))
        assert err <= limit, (name, err, limit)


def test_inner_gs_kernel_repeats_and_rejects(cuda):
    ops = [o.to(cuda) if torch.is_tensor(o) else o
           for o in _gs_operands(128, 200, torch.float32)]
    a, b = sp.inner_gs_pallas(*ops), sp.inner_gs_pallas(*ops)
    for name, u, v in zip(GS_NAMES, a, b):
        assert torch.equal(u, v), name
    launches = sp.inner_gs_pallas.launches
    bad = list(ops)
    bad[2] = ops[2].double()  # cp_b
    with pytest.raises(ValueError, match="cp_b must"):
        sp.inner_gs_pallas(*bad)
    bad = list(ops)
    bad[0] = ops[0].t().contiguous().t()  # r0, column-major
    with pytest.raises(ValueError, match="r0 must"):
        sp.inner_gs_pallas(*bad)
    # a block whose deltas outgrow shared memory (over GS_BMAX rows)
    big = [o.to(cuda) if torch.is_tensor(o) else o
           for o in _gs_operands(sp.GS_BMAX[torch.float32] + 8, 64,
                                 torch.float32)]
    with pytest.raises(ValueError, match="unsupported block"):
        sp.inner_gs_pallas(*big)
    assert sp.inner_gs_pallas.launches == launches


BLOCK_NAMES = ("gam", "mu", "delta", "z_row", "z_col")


def _block_operands(B, q, dtype, c, seed=2):
    """One block's operands of the block kernel (B3's route), from a seed:
    the last 5 rows and 3 columns masked out."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(B, B))
    pm, qm = np.ones(B), np.ones(q)
    pm[-5:], qm[-3:] = 0.0, 0.0
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    return [t(rng.normal(size=(B, q))), t(g @ g.T / B),
            t(rng.normal(size=(B, q))), t(rng.uniform(.1, .9, (B, q))),
            t(rng.normal(size=(B, q))), t(rng.normal(-1.5, .7, B)),
            t(rng.normal(0, .5, q)), t(pm), t(qm), t(rng.uniform(.01, .1, q)),
            t(rng.uniform(.5, 2, q)), t(rng.normal(size=q)), c, 0.3]


def _held(got, ref, dtype):
    """Each output against the plain version's: float64 1e-10, float32 gam
    1e-4 and the rest 1e-4 of max |plain|."""
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    for name, a, r in zip(BLOCK_NAMES, got, ref):
        assert a.device.type == "cuda" and a.dtype == dtype, name
        err = float((a.cpu() - r).abs().max())
        limit = tol if name == "gam" else tol * float(r.abs().max())
        assert err <= limit, (name, err, limit)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("c", [1.0, 0.5])
@pytest.mark.parametrize("B,q", [(80, 72), (128, 72), (256, 72),
                                 (128, 10000)])
def test_block_gs_kernel_matches_plain(cuda, B, q, c, dtype):
    """The block kernel against block_gs_plain: blocks 80, 128 and 256 (rows
    beyond 128 from device memory) at a ragged q, and the eQTL block
    (128, 10000)."""
    ops = _block_operands(B, q, dtype, c)
    ref = sp.block_gs(*ops)
    launches = sp.block_gs.launches
    got = sp.block_gs(*[o.to(cuda) if torch.is_tensor(o) else o
                        for o in ops])
    torch.cuda.synchronize()
    assert sp.block_gs.launches == launches + 1
    _held(got, ref, dtype)


def test_block_gs_kernel_repeats_and_rejects(cuda):
    ops = [o.to(cuda) if torch.is_tensor(o) else o
           for o in _block_operands(128, 200, torch.float32, 0.5)]
    a, b = sp.block_gs(*ops), sp.block_gs(*ops)
    for name, u, v in zip(BLOCK_NAMES, a, b):
        assert torch.equal(u, v), name
    launches = sp.block_gs.launches
    bad = list(ops)
    bad[2] = ops[2].double()  # cp
    with pytest.raises(ValueError, match="cp must"):
        sp.block_gs(*bad)
    bad = list(ops)
    bad[0] = ops[0].t().contiguous().t()  # r0, column-major
    with pytest.raises(ValueError, match="r0 must"):
        sp.block_gs(*bad)
    big = [o.to(cuda) if torch.is_tensor(o) else o
           for o in _block_operands(sp.GS_BMAX[torch.float32] + 8, 64,
                                    torch.float32, 0.5)]
    with pytest.raises(ValueError, match="unsupported block"):
        sp.block_gs(*big)
    assert sp.block_gs.launches == launches
    # GS_BMAX is the kernel's own largest block in each type
    lib = sf._load()
    for f64, dt in ((0, torch.float32), (1, torch.float64)):
        assert lib.atlasqtl_inner_gs_smem(f64, sp.GS_BMAX[dt]) > 0
        assert lib.atlasqtl_inner_gs_smem(f64, sp.GS_BMAX[dt] + 8) < 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_route_sweep_matches_cpu(cuda, dtype):
    """One sweep of the B3 route on the card (3 blocks of 128, q = 200)
    against the CPU route, which runs the plain block: gam 1e-4, the rest
    1e-4 of max in float32; 1e-10 in float64."""
    n, p, q, block = 120, 384, 200, 128
    rng = np.random.default_rng(4)
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    x, cp = t(rng.normal(size=(n, p))), t(rng.normal(size=(p, q)))
    gam, mu = t(rng.uniform(.1, .9, (p, q))), t(rng.normal(0, .3, (p, q)))
    tau = t(rng.uniform(.5, 2, q))
    # s2 ~ 1/n, as the model's sig2_beta: the sweep contracts
    consts = SweepConsts(sig2_beta=t(rng.uniform(.2, .8, q) / n), tau=tau,
                         log_tau=torch.log(tau), log_sig2_inv=t(-0.3),
                         theta=t(rng.normal(-1.5, .7, p)),
                         zeta=t(rng.normal(0, .5, q)), c=t(0.5))
    pm, qm = torch.ones(p, dtype=dtype), torch.ones(q, dtype=dtype)
    pm[-3:], qm[-5:] = 0.0, 0.0
    args = (x, cp, block_gram(x, block), gam, mu, x @ (gam * mu), consts,
            block, pm, qm)
    ref = sp.sweep_complete_pallas(*args)
    dev = [o.to(cuda) if torch.is_tensor(o) else o for o in args]
    dev[6] = SweepConsts(*[v.to(cuda) for v in consts])
    launches = sp.block_gs.launches
    got = sp.sweep_complete_pallas(*dev)
    torch.cuda.synchronize()
    assert sp.block_gs.launches == launches + p // block
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    for name, a, r in zip(("gam", "mu", "fitted", "z_row", "z_col"), got,
                          ref):
        err = float((a.cpu() - r).abs().max())
        limit = tol if name == "gam" else tol * float(r.abs().max())
        assert err <= limit, (name, err, limit)


@pytest.mark.parametrize("c_one,emit", [(True, True), (True, False),
                                        (False, True), (False, False)])
@pytest.mark.parametrize("n,p,q,blk,width", [(120, 256, 200, 128, 32),
                                             (100, 75, 48, 80, 32),
                                             (1001, 256, 104, 128, 32),
                                             (100, 128, 4804, 128, 40),
                                             (120, 512, 200, 256, 32),
                                             (100, 400, 104, 200, 32)])
def test_staggered_kernel_matches_b1(cuda, n, p, q, blk, width, c_one, emit):
    """B4 against B1 on the card and against its plain version on the CPU,
    both at the f32 tolerances (B4 sums each half's products in its own
    order, so the two agree to rounding, not bit for bit): ragged q, block
    80 with n % 8 != 0, many sample chunks, 40-column slices, blocks 256
    and 200 in pieces."""
    ops, block = _operands(n, p, q, 1.0 if c_one else 0.5, block=blk)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert ss.staggered_launch_plan(n, q, block, ops[3].shape[1],
                                    sms)["slice_width"] == width
    kw = dict(block_size=block, emit_gam_mu=emit, c_one=c_one)
    ref = ss.sweep_fused_staggered(*ops, **kw)
    dev = [o.to(cuda) for o in ops]
    launches = ss.sweep_fused_staggered.launches
    got = ss.sweep_fused_staggered(*dev, **kw)
    b1 = sf.sweep_fused(*dev, **kw)
    torch.cuda.synchronize()
    assert ss.sweep_fused_staggered.launches == launches + 1
    for name, a, u, r in zip(NAMES, _flat(got), _flat(b1), _flat(ref)):
        if r is None:
            assert a is None and u is None, name
            continue
        for other, o in (("plain", r), ("B1", u.cpu())):
            err = float((a.cpu() - o).abs().max())
            limit = 1e-4 if name == "gam" else 1e-4 * float(o.abs().max())
            assert err <= limit, (name, other, err, limit)


@pytest.mark.parametrize("q", [200, 4804])
def test_staggered_kernel_repeats_and_rejects(cuda, q):
    """Bitwise repeatable in 32-column (q = 200) and 40-column (q = 4804)
    slices; rejects a wrong dtype and a wrong Gram shape."""
    ops, block = _operands(120, 256, q, 0.5)
    ops = [o.to(cuda) for o in ops]
    kw = dict(block_size=block, emit_gam_mu=True, c_one=False)
    a = _flat(ss.sweep_fused_staggered(*ops, **kw))
    b = _flat(ss.sweep_fused_staggered(*ops, **kw))
    for name, u, v in zip(NAMES, a, b):
        assert torch.equal(u, v), name
    launches = ss.sweep_fused_staggered.launches
    bad = list(ops)
    bad[6] = ops[6].double()  # fitted
    with pytest.raises(ValueError, match="fitted must"):
        ss.sweep_fused_staggered(*bad, **kw)
    with pytest.raises(ValueError, match="gram_flat must"):
        ss.sweep_fused_staggered(*ops, **dict(kw, block_size=block // 2 + 4))
    assert ss.sweep_fused_staggered.launches == launches


def _fit(cfg, device, seed=123, p=75):
    """fit_global_local from the library's lower-level entry (how a caller
    reaches the B3 and B4 routes): prepare_data, elicitation, the model's
    builders."""
    y, x, _ = simulate_fixture(p=p)
    dat = prepare_data(y, x, 0.1, 1000, seed, 0)
    p, q = dat.x.shape[1], dat.y.shape[1]
    cfg = dataclasses.replace(cfg, shr_fac_inv=float(q))
    data = gl.build_data(dat.x, dat.y, cfg, device)
    hyper = gl.build_hyper(elic.auto_set_hyper(dat.y, p, (5, 25)),
                           data.y.shape[1], cfg, device)
    state = gl.build_state(elic.auto_set_init(dat.y, p, (5, 25), float(q),
                                              seed), data, cfg)
    res = fit_global_local(data, hyper, state, cfg, anneal=(1, 2, 10),
                           verbose=0)
    return res, res.state.gam[:p, :q].double().cpu().numpy()


@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("route", ["pallas", "stagger", "pallas_f64"])
def test_route_fit_on_the_card(cuda, route, block):
    """Each route on the card launches its kernel (B3's block kernel once
    per predictor block per iteration, B4 once per iteration, no B1) and
    agrees with the
    float64 CPU fit: float32 PIPs within 1e-2; float64 through B3 in the
    same iterations within 1e-6.  Block 128 at p = 75 (one block of 80) and
    block 256 at p = 300 (two blocks of 256)."""
    cfg = {"pallas": Config(sweep="pallas", block_size=block),
           "stagger": Config(sweep_stagger=True, block_size=block),
           "pallas_f64": Config(dtype=torch.float64, use_pallas=True,
                                block_size=block)}[route]
    p = 75 if block == 128 else 300
    sf.sweep_fused.launches = sp.inner_gs_pallas.launches = 0
    ss.sweep_fused_staggered.launches = sp.block_gs.launches = 0
    res, gam = _fit(cfg, cuda, p=p)
    assert res.converged and sf.sweep_fused.launches == 0
    if route == "stagger":
        assert ss.sweep_fused_staggered.launches == res.it
    else:
        blocks = -(-res.state.gam.shape[0] // block)  # p = 75: one of 80
        assert sp.block_gs.launches == res.it * blocks
        assert sp.inner_gs_pallas.launches == 0
    ref, ref_gam = _fit(Config(dtype=torch.float64, block_size=block), "cpu",
                        p=p)
    if route == "pallas_f64":
        assert res.it == ref.it
        assert np.abs(gam - ref_gam).max() <= 1e-6
    else:
        assert np.abs(gam - ref_gam).max() <= 1e-2


# ------------------------------------------- the device loop and device init

LOOP_ROUTES = ("b1", "b2", "impute", "b3_f32", "b3_f64", "b4", "block256",
               "global", "batch0")


def _loop_fit(route, loop, device):
    """One small fit of `route` under device_loop=`loop`; returns the result
    and the route's launch counter and launches per iteration."""
    miss = route in ("b2", "impute", "batch0")
    # the global model on test_e2e.py's fixture: on the seed-5 one the
    # reference's own global fit stops at its monotonicity guard
    seed = 123 if route == "global" else 5
    y, x, _ = simulate_fixture(p=300 if route == "block256" else 75,
                               missing_frac=0.2 if miss else 0.0, seed=seed)
    kw = dict(p0=(5, 25), verbose=0, user_seed=seed, maxit=600,
              device=device, device_loop=loop)
    if route.startswith(("b3", "b4")):
        cfg = {"b3_f32": Config(sweep="pallas"),
               "b3_f64": Config(dtype=torch.float64, use_pallas=True),
               "b4": Config(sweep_stagger=True)}[route]
        dat = prepare_data(y, x, 0.1, 1000)
        p, q = dat.x.shape[1], dat.y.shape[1]
        cfg = dataclasses.replace(cfg, shr_fac_inv=float(q),
                                  device_loop=loop)
        data = gl.build_data(dat.x, dat.y, cfg, device)
        hyper = gl.build_hyper(elic.auto_set_hyper(dat.y, p, (5, 25)),
                               data.y.shape[1], cfg, device)
        state = gl.build_state(elic.auto_set_init(dat.y, p, (5, 25),
                                                  float(q), 11), data, cfg)
        res = fit_global_local(data, hyper, state, cfg, anneal=(1, 2, 10),
                               verbose=0)
        # B3's block kernel once per block: p = 75 is one block of 80
        own = sp.block_gs if route.startswith("b3") else \
            ss.sweep_fused_staggered
        return res, own, 1
    extra = {"b2": dict(missing="exact"), "impute": dict(missing="impute"),
             "block256": dict(block_size=256), "global": dict(model="global"),
             "batch0": dict(batch="0")}.get(route, {})
    # the global model in float64, as the reference's own tests fit it
    dtype = torch.float64 if route == "global" else torch.float32
    res = at.atlasqtl(y, x, dtype=dtype, **kw, **extra)
    own = {"b2": sm.sweep_missing_fused, "global": None,
           "batch0": None}.get(route, sf.sweep_fused)
    return res, own, 1


def _reset_counts():
    from atlasqtl_tpu_torch.inference import device_loop as dl
    for fn in dl.launch_counters():
        fn.launches = 0
    dl.replays = 0


@pytest.mark.parametrize("route", LOOP_ROUTES)
def test_graph_loop_matches_host_loop(cuda, route):
    """Every route under the CUDA-graph loop takes the host loop's
    iterations, evaluates the ELBO at the same ones and agrees on it to
    1e-6 relative; the route's kernel count equals its launches per
    iteration times the iterations under both loops (replays counted), and
    only the graph loop replays graphs."""
    from atlasqtl_tpu_torch.inference import device_loop as dl
    fits = {}
    for loop in ("off", "on"):
        _reset_counts()
        res, own, per_it = _loop_fit(route, loop, cuda)
        fits[loop] = res
        launches = sum(fn.launches for fn in dl.launch_counters())
        assert launches == (0 if own is None else res.it * per_it)
        if own is not None:
            assert own.launches == res.it * per_it
        assert (dl.replays > 0) == (loop == "on")
    off, on = fits["off"], fits["on"]
    assert off.converged and on.converged and off.it == on.it
    assert [i for i, _ in off.elbo_history] == [i for i, _ in
                                               on.elbo_history]
    np.testing.assert_allclose([lb for _, lb in on.elbo_history],
                               [lb for _, lb in off.elbo_history], rtol=1e-6)


def test_launch_counters_count_replays(cuda):
    """Under the graph loop B1's count is the fit's iterations: the eager
    first step of each kind counts its launch, a capture counts none, each
    replay counts the launches it captured; every step after the first of
    its kind (at most 4 kinds) is a replay."""
    from atlasqtl_tpu_torch.inference import device_loop as dl
    _reset_counts()
    res, _, _ = _loop_fit("b1", "on", cuda)
    assert sf.sweep_fused.launches == res.it
    assert res.it - 4 <= dl.replays < res.it


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_device_init_moments_on_the_card(cuda, dtype):
    """auto_init_device with the card's generator at (120, 256, 2048): the
    moments of tests/test_torch_dev_init.py, tau by the host rule."""
    from scipy.special import digamma
    n, p, q = 120, 256, 2048
    rng = np.random.default_rng(7)
    x = rng.binomial(2, 0.3, size=(n, p)).astype(np.float64)
    x = x[:, x.std(0) > 0][:, :p]
    p = x.shape[1]
    y = rng.normal(size=(n, q))
    cfg = Config(dtype=dtype, shr_fac_inv=float(q))
    data = gl.build_data(x, y, cfg, cuda)
    st = gl.auto_init_device(0, data, (5.0, 25.0), float(q), cfg)
    assert st.gam.device.type == "cuda" and st.gam.dtype == dtype
    host = elic.auto_set_init(y, p, (5.0, 25.0), float(q), user_seed=1)
    n0, t02 = elic.get_n0_t02(1, p, (5.0, 25.0))
    g = st.gam[:p, :q].double().cpu().numpy()
    assert abs(g.mean() - host.gam_vb.mean()) < 2e-3
    ls = np.log(st.sig2_beta[:q].double().cpu().numpy())
    tau = float(host.tau_vb[0])
    assert abs(ls.mean() + float(digamma(2.0)) + np.log(1e-2 * tau)) < 0.1
    assert abs(ls.var() - 0.6449) < 0.1
    np.testing.assert_allclose(st.tau[:q].double().cpu().numpy(),
                               host.tau_vb,
                               rtol=1e-12 if dtype == torch.float64 else 1e-6)
    z = st.zeta[:q].double().cpu().numpy()
    assert abs(z.mean() - float(n0[0])) < 4 * np.sqrt(t02 / q)
    assert abs(z.var(ddof=1) / t02 - 1.0) < 0.15
    beta = st.gam * st.mu_beta
    np.testing.assert_allclose(st.fitted.double().cpu().numpy(),
                               (data.x @ beta).double().cpu().numpy(),
                               rtol=1e-5, atol=1e-4)


def test_capture_failure_raises(cuda):
    """A step that cannot be captured (here an ELBO that reads a value back
    to the host) makes the graph loop raise; the fit never carries on in
    the host loop.  Run in a process of its own: a failed capture leaves
    the process's CUDA state to PyTorch, which does not restore it."""
    code = """
import numpy as np, torch
import atlasqtl_tpu_torch as at
from atlasqtl_tpu_torch.models import global_local as gl
orig = gl.compute_elbo
def reads_back(*a, **k):
    lb = orig(*a, **k)
    float(lb)
    return lb
gl.compute_elbo = reads_back
rng = np.random.default_rng(1)
x = rng.binomial(2, 0.2, size=(100, 75)).astype(float)
y = x[:, :10] @ rng.normal(1.0, 0.5, (10, 20)) + rng.normal(size=(100, 20))
try:
    at.atlasqtl(y, x, p0=(5, 25), verbose=0, user_seed=1, device_loop="on")
except RuntimeError as err:
    print("raised:", str(err).splitlines()[0])
else:
    print("no error")
"""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=repo,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "raised: device loop: capturing the converged full + ELBO " \
        "step" in r.stdout, r.stdout + r.stderr[-2000:]


# ------------------------------------------------- annealing replicas (A8)

def _replica_operands(kind, n, p, q, c, m, block=128, frac=0.2):
    """The operands of m replicas' sweeps of one problem (x, the Gram
    blocks, the masks shared; each replica its own host-drawn state and
    constants), each replica's list and the stacked ones: B1 (kind "b1",
    X^T Y shared; "b1_cp", X^T Y per replica as impute mode gives it) or
    B2 ("b2")."""
    y, x, _ = simulate_fixture(n=n, p=p, p_act=8, q=q, seed=3,
                               missing_frac=frac if kind == "b2" else 0.0)
    dat = prepare_data(y, x, 0.1, 1000)
    p_eff, q_eff = dat.x.shape[1], dat.y.shape[1]
    cfg = Config(dtype=torch.float32, shr_fac_inv=float(q_eff), sweep="fused",
                 block_size=block)
    data = gl.build_data(dat.x, dat.y, cfg, "cpu")
    block = gl.data_block(cfg, data)
    gram = block_gram(data.x, block) if kind != "b2" else None
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    parts = []
    for r in range(m):
        state = gl.build_state(elic.auto_set_init(dat.y, p_eff, (4, 16),
                                                  float(q_eff), 10 + r),
                               data, cfg)
        rng = np.random.default_rng(20 + r)
        tau = f32(rng.uniform(0.5, 2.0, data.y.shape[1]))
        s2i = f32(rng.uniform(0.5, 1.0))
        consts = SweepConsts(
            sig2_beta=upd.sig2_beta_update(data.n, s2i, tau, data.x_norm_sq,
                                           f32(c)),
            tau=tau, log_tau=torch.log(tau) - 0.1, log_sig2_inv=f32(-0.3),
            theta=state.theta, zeta=state.zeta, c=f32(c))
        if kind == "b2":
            parts.append(sm.missing_fused_operands(
                data.x, data.cp_x_y, data.x_norm_sq, data.mis_pat, state.gam,
                state.mu_beta, state.fitted, consts, s2i, data.p_mask,
                data.q_mask))
        else:
            cp = data.cp_x_y
            if kind == "b1_cp":
                cp = cp + 0.1 * r * torch.ones_like(cp)
            parts.append(sf.fused_operands(
                data.x, cp, gram, state.beta, state.fitted, consts, block,
                data.p_mask, data.q_mask))
    stacked = (sm.MISSING.stack(parts) if kind == "b2"
               else sf.FUSED.stack(parts, ("cp_x_y",) if kind == "b1_cp"
                                   else ()))
    return parts, stacked, block


def _replica_case(cuda, kind, parts, stacked, kw):
    """One batched launch against m single launches under the batched
    launch's plan (bit for bit: the plan for m replicas may take another
    slice width or cluster than one replica's, which sums in another
    order) and against the plain version (f32 tolerances); one launch
    counted."""
    fn = sm.sweep_missing_fused if kind == "b2" else sf.sweep_fused
    flat = (lambda o: list(o)) if kind == "b2" else _flat
    names = MIS_NAMES if kind == "b2" else NAMES
    dev = lambda ops: [o.to(cuda) for o in ops]
    m = len(parts)
    n, q = parts[0][0].shape[0], parts[0][6 if kind == "b2" else 5].shape[1]
    r_aug = parts[0][4 if kind == "b2" else 3].shape[1]
    if kind == "b2":
        plan = sm.missing_launch_plan(n, q, kw["block_size"], r_aug, m)
        single = lambda ops: sm._sweep_missing_fused_cuda(*dev(ops), **kw,
                                                          plan=plan)
    else:
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        plan = sf.fused_launch_plan(n, q, kw["block_size"], r_aug, sms, m)
        single = lambda ops: sf.fused_launch(
            "atlasqtl_sweep_fused", *dev(ops), **kw,
            slice_width=plan["slice_width"])
    launches = fn.launches
    got = flat(fn(*dev(stacked), **kw))
    torch.cuda.synchronize()
    assert fn.launches == launches + 1
    for r, ops in enumerate(parts):
        one = flat(single(ops))
        fn.launches = launches + 1   # the comparisons count nothing
        ref = flat(fn(*ops, **kw))  # the plain version on the CPU
        for name, a, b, c in zip(names, got, one, ref):
            if b is None:
                assert a is None, name
                continue
            assert torch.equal(a[r], b), (name, r)
            err = float((b.cpu() - c).abs().max())
            limit = 1e-4 if name == "gam" else 1e-4 * float(c.abs().max())
            assert err <= limit, (name, r, err, limit)


@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("kind,n,p,q,blk,c_one,emit", [
    ("b1", 120, 256, 200, 128, True, False),
    ("b1", 120, 256, 200, 128, False, True),
    ("b1_cp", 100, 75, 48, 80, False, True),
    ("b1", 120, 512, 200, 256, True, True),
    ("b1", 100, 128, 4804, 128, False, False)])
def test_batched_b1_equals_single_launches(cuda, kind, n, p, q, blk, c_one,
                                           emit, m):
    """Each replica of one batched B1 launch equals its own launch bit for
    bit: ragged q; X^T Y per replica (impute) at n % 8 != 0 and block 80;
    block 256 walked in pieces of 128; 40-column slices."""
    parts, stacked, block = _replica_operands(kind, n, p, q,
                                              1.0 if c_one else 0.5, m,
                                              block=blk)
    _replica_case(cuda, kind, parts, stacked,
                  dict(block_size=block, emit_gam_mu=emit, c_one=c_one))


@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("n,p,q,blk,c", [
    (80, 250, 40, 128, 0.5), (100, 75, 48, 80, 1.0),
    (100, 512, 40, 256, 0.5), (300, 256, 504, 128, 1.0),
    (8000, 128, 256, 128, 0.5)])
def test_batched_b2_equals_single_launches(cuda, n, p, q, blk, c, m):
    """Each replica of one batched B2 launch equals its own launch bit for
    bit: ragged q; n % 8 != 0 and block 80; block 256 in pieces of 128; a
    cluster that shrinks with m (q = 504); the device-memory branch
    (n = 8000)."""
    parts, stacked, block = _replica_operands("b2", n, p, q, c, m, block=blk,
                                              frac=0.15)
    plan = sm.missing_launch_plan(stacked[0].shape[0], stacked[6].shape[-1],
                                  block, stacked[4].shape[-1], m)
    assert plan["fm_on_chip"] == (n < 8000)
    _replica_case(cuda, "b2", parts, stacked, dict(block_size=block))


def test_batched_launch_rejects_mixed_operands(cuda):
    parts, stacked, block = _replica_operands("b1", 120, 256, 200, 0.5, 2)
    kw = dict(block_size=block, emit_gam_mu=True, c_one=False)
    ops = [o.to(cuda) for o in stacked]
    bad = list(ops)
    bad[7] = ops[7][0]   # theta of one replica only
    with pytest.raises(ValueError, match="replica axis"):
        sf.sweep_fused(*bad, **kw)
    bad = list(ops)
    bad[0] = torch.stack([ops[0], ops[0]])   # x per replica
    with pytest.raises(ValueError, match="replica axis"):
        sf.sweep_fused(*bad, **kw)
    with pytest.raises(ValueError, match="replica axis"):
        ss.sweep_fused_staggered(*ops, **kw)


@pytest.mark.parametrize("missing", [None, "exact", "impute"])
def test_replica_fit_one_launch_per_rung(cuda, missing):
    """anneal_replicas=3: one sweep launch per rung for all three replicas
    plus one per converged iteration, under the host loop and the graph
    loop, which agree."""
    from atlasqtl_tpu_torch.inference import device_loop as dl
    y, x, p_act = simulate_fixture(missing_frac=0.15 if missing else 0.0,
                                   seed=5)
    own = sm.sweep_missing_fused if missing == "exact" else sf.sweep_fused
    fits = {}
    for loop in ("off", "on"):
        _reset_counts()
        res = at.atlasqtl(y, x, p0=(5, 25), verbose=0, user_seed=5,
                          maxit=600, anneal_replicas=3, device_loop=loop,
                          **({} if missing is None else dict(missing=missing)))
        assert res.converged and own.launches == res.it
        assert (dl.replays > 0) == (loop == "on")
        assert (res.hotspot_sizes()[:p_act] > 5).all()
        fits[loop] = res
    off, on = fits["off"], fits["on"]
    assert off.it == on.it
    np.testing.assert_allclose([lb for _, lb in on.elbo_history],
                               [lb for _, lb in off.elbo_history], rtol=1e-6)


def test_checkpoint_fit_keeps_the_host_loop(cuda, tmp_path):
    """A checkpoint path (a host hook) keeps the host loop even under
    device_loop="on"; the snapshots are cleaned up on convergence, and the
    full output holds the reference's names."""
    from atlasqtl_tpu_torch.inference import device_loop as dl
    y, x, _ = simulate_fixture()
    _reset_counts()
    res = at.atlasqtl(y, x, p0=(5, 25), verbose=0, user_seed=1,
                      device_loop="on", checkpoint_path=str(tmp_path),
                      trace_path=str(tmp_path), full_output=True)
    assert res.converged and dl.replays == 0
    assert not list(tmp_path.glob("tmp_output_it_*.npz"))
    assert (tmp_path / "traces_top_local_x_global_parameters.csv").exists()
    assert len(res.full_output) == 24 and res.full_output["cp_X"].shape == (
        75, 75)


def test_no_garbage_collection_while_capturing(cuda, monkeypatch):
    """An earlier fit's device loop, cyclic garbage holding CUDA graphs, is
    never collected during a capture: destroying a graph while a stream
    captures invalidates the capture (chip_smoke.py met it after a dozen
    fits in one process)."""
    import gc
    from atlasqtl_tpu_torch.models import global_local as tgl
    y, x, _ = simulate_fixture()
    kw = dict(p0=(5, 25), verbose=0, user_seed=1, device_loop="on")
    at.atlasqtl(y, x, **kw)   # its loop is garbage from here on
    seen = []
    orig = tgl.compute_elbo

    def elbo(*a, **k):
        if torch.cuda.is_current_stream_capturing():
            seen.append(gc.isenabled())
        return orig(*a, **k)

    monkeypatch.setattr(tgl, "compute_elbo", elbo)
    res = at.atlasqtl(y, x, **kw)
    assert res.converged and seen and not any(seen)
    assert gc.isenabled()
