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
The perf probes' instances (B1's under Config.sweep_probe, B2's under
probe=) are held the same way; B1's F is scaled by the larger of F out
and F in, as a probe may make the two cancel.
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
            # the float32 probe instance keeps deltas at some windows
            # (sm._probe_rows), the pair_bf16 ones none beside their own
            for window, probe, pwin in (
                    (0, "none", 0), (16, "none", 0), (32, "none", 0),
                    (128, "none", 0), (0, "noseq", 32),
                    (0, "noadvmask", 128), (0, "noadv", 12),
                    (0, "exact", 128), (32, "noadv", 32)):
                plan = sm.missing_launch_plan(n, 10000, 128, r_aug,
                                              window=window, probe=probe,
                                              probe_window=pwin)
                assert (sm.kernel_smem_bytes(plan, n, r_aug)
                        == plan["smem_bytes"])
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


def _fit(cfg, device, seed=123, p=75, q_pad_to=8):
    """fit_global_local from the library's lower-level entry (how a caller
    reaches the B3 and B4 routes): prepare_data, elicitation, the model's
    builders (q padded to a multiple of q_pad_to)."""
    y, x, _ = simulate_fixture(p=p)
    dat = prepare_data(y, x, 0.1, 1000, seed, 0)
    p, q = dat.x.shape[1], dat.y.shape[1]
    cfg = dataclasses.replace(cfg, shr_fac_inv=float(q))
    data = gl.build_data(dat.x, dat.y, cfg, device, q_pad_to=q_pad_to)
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
    block 256 at p = 300 (two blocks of 256); q padded to 256 for B4, which
    sweep_stagger selects only where the JAX package's fused tile is at
    least 256 (C10)."""
    cfg = {"pallas": Config(sweep="pallas", block_size=block),
           "stagger": Config(sweep_stagger=True, block_size=block),
           "pallas_f64": Config(dtype=torch.float64, use_pallas=True,
                                block_size=block)}[route]
    p = 75 if block == 128 else 300
    sf.sweep_fused.launches = sp.inner_gs_pallas.launches = 0
    ss.sweep_fused_staggered.launches = sp.block_gs.launches = 0
    res, gam = _fit(cfg, cuda, p=p, q_pad_to=256 if route == "stagger"
                    else 8)
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
        # B4 where sweep_stagger selects it: q padded to 256 (C10)
        data = gl.build_data(dat.x, dat.y, cfg, device,
                             q_pad_to=256 if route == "b4" else 8)
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


# ------------------------------------------- the bf16 modes (B5a, B5b)

BF16_RATIO = 20   # mean error <= the mode's mean distance from f32 / 20


def _bf16_held(got, ref, f32, f32_kernel, names):
    """A bf16 instance against its plain version: per output, mean
    |kernel - plain| <= mean |plain f32 - plain bf16| / BF16_RATIO + 2
    mean |f32 kernel - plain f32| (the float32 instance's own distance
    from its plain version: sums in another order).  B1: a bf16 operand
    moves 2^-8 relative where a float32 sum order differs by one ulp, so
    the max is not at float32 grade (tests/test_torch_bf16.py).  B2: the
    mode moves the outputs far less than B2's max tolerance, so only this
    fails an instance that rounds no pair product, or the wrong ones."""
    for name, a, r, f, k in zip(names, got, ref, f32, f32_kernel):
        if r is None:
            assert a is None, name
            continue
        assert a.device.type == "cuda" and a.shape == r.shape, name
        err = float((a.cpu() - r).abs().double().mean())
        mode = float((f - r).abs().double().mean())
        floor = float((k.cpu() - f).abs().double().mean())
        assert err <= mode / BF16_RATIO + 2 * floor, (name, err, mode, floor)


@pytest.mark.parametrize("c", [1.0, 0.5])
@pytest.mark.parametrize("n,p,q,width,blk", [(120, 256, 200, 32, 128),
                                             (100, 128, 4804, 40, 128),
                                             (100, 120, 48, 32, 120),
                                             (120, 512, 200, 32, 256),
                                             (120, 400, 200, 32, 200)])
def test_bf16_kernel_matches_plain(cuda, n, p, q, width, blk, c):
    """B1's bf16 instance (mxu_bf16, tensor cores) against its plain
    version: ragged q in 32-column slices; 40-column slices; block 120,
    not a multiple of 16 (zero-padded columns); block 256 in pieces of
    128 and block 200 in five of 40, each piece projected against the
    block-start F with the earlier pieces through the Gram, as the plain
    version's whole-block sweep.  One launch counted, as the bf16
    instance's too."""
    ops, block = _operands(n, p, q, c, block=blk)
    assert block == blk
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert sf.fused_launch_plan(n, q, block, ops[3].shape[1], sms,
                                bf16=True)["slice_width"] == width
    ops16 = [sf.bf16_operand(ops[0])] + list(ops[1:])
    kw = dict(block_size=block, emit_gam_mu=True, c_one=c == 1.0)
    ref = _flat(sf.sweep_fused(*ops16, **kw, bf16=True))
    f32 = _flat(sf.sweep_fused(*ops, **kw))
    launches, inst = sf.sweep_fused.launches, sf.sweep_fused.bf16.launches
    got = _flat(sf.sweep_fused(*[o.to(cuda) for o in ops16], **kw,
                               bf16=True))
    torch.cuda.synchronize()
    assert sf.sweep_fused.launches == launches + 1
    assert sf.sweep_fused.bf16.launches == inst + 1
    f32_kernel = _flat(sf.sweep_fused(*[o.to(cuda) for o in ops], **kw))
    _bf16_held(got, ref, f32, f32_kernel, NAMES)


@pytest.mark.parametrize("c", [1.0, 0.5])
@pytest.mark.parametrize("n,p,q,blk", [(33, 256, 200, 128),
                                       (120, 640, 77, 128),
                                       (1000, 256, 4804, 128),
                                       (100, 64, 48, 8), (100, 240, 48, 120),
                                       (1000, 512, 104, 256)])
def test_bf16_pass_edges(cuda, n, p, q, blk, c):
    """B1's bf16 instance at the edges of its pass (64-row chunks, advance
    and projection in warps of their own): n = 33, one chunk with three
    empty 16-row groups; n = 120 and 1000, a last chunk of 56 and 40 rows;
    q not a multiple of the slice (200 in 32-column slices, 77 padded to
    80, 4804 in 40-column slices); blocks 8 (one 16-row tile of depth 16),
    120 (zero-padded columns), 128 and 256 (pieces of 128).  Against its
    plain version under the mean criterion, and bit for bit from run to
    run."""
    ops, block = _operands(n, p, q, c, block=blk)
    assert block == blk
    ops16 = [sf.bf16_operand(ops[0])] + list(ops[1:])
    kw = dict(block_size=block, emit_gam_mu=True, c_one=c == 1.0)
    ref = _flat(sf.sweep_fused(*ops16, **kw, bf16=True))
    f32 = _flat(sf.sweep_fused(*ops, **kw))
    dev16 = [o.to(cuda) for o in ops16]
    got, again = (_flat(sf.sweep_fused(*dev16, **kw, bf16=True))
                  for _ in range(2))
    torch.cuda.synchronize()
    for name, a, b in zip(NAMES, got, again):
        assert torch.equal(a, b), name
    f32_kernel = _flat(sf.sweep_fused(*[o.to(cuda) for o in ops], **kw))
    _bf16_held(got, ref, f32, f32_kernel, NAMES)


@pytest.mark.parametrize("n,p,q,blk,c", [(120, 256, 200, 128, 0.5),
                                         (1000, 512, 104, 256, 1.0)])
def test_batched_bf16_equals_single_launches(cuda, n, p, q, blk, c):
    """B1's bf16 instance with m = 2 replicas in one launch (one counted):
    each replica equals its own launch under the batched plan bit for bit
    and holds the mean criterion against its plain version; block 256 in
    pieces, whose workspaces carry the replica axis."""
    parts32, _, block = _replica_operands("b1", n, p, q, c, 2, block=blk)
    parts = [[sf.bf16_operand(ops[0])] + list(ops[1:]) for ops in parts32]
    kw = dict(block_size=block, emit_gam_mu=True, c_one=c == 1.0)
    dev = lambda ops: [o.to(cuda) for o in ops]
    q_pad, r_aug = parts[0][5].shape[1], parts[0][3].shape[1]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    width = sf.fused_launch_plan(n, q_pad, block, r_aug, sms, 2,
                                 bf16=True)["slice_width"]
    inst = sf.sweep_fused.bf16.launches
    got = _flat(sf.sweep_fused(*dev(sf.FUSED.stack(parts)), **kw, bf16=True))
    torch.cuda.synchronize()
    assert sf.sweep_fused.bf16.launches == inst + 1
    for r, (ops, ops32) in enumerate(zip(parts, parts32)):
        one = _flat(sf.fused_launch("atlasqtl_sweep_fused", *dev(ops), **kw,
                                    bf16=True, slice_width=width))
        for name, a, b in zip(NAMES, got, one):
            assert torch.equal(a[r], b), (name, r)
        _bf16_held(one, _flat(sf.sweep_fused(*ops, **kw, bf16=True)),
                   _flat(sf.sweep_fused(*ops32, **kw)),
                   _flat(sf.fused_launch("atlasqtl_sweep_fused", *dev(ops32),
                                         **kw, slice_width=width)), NAMES)


@pytest.mark.parametrize("sub", [16, 8, 4])
@pytest.mark.parametrize("c", [1.0, 0.5])
@pytest.mark.parametrize("n,p,q,blk", [(80, 250, 40, 128), (100, 75, 48, 80),
                                       (100, 512, 40, 256),
                                       (8000, 128, 256, 128)])
def test_pair_bf16_kernel_matches_plain(cuda, n, p, q, blk, c, sub):
    """B2's pair_bf16 instance at window sub (Config.mis_sub) against its
    plain version in the JAX kernel's windows of sub, at B2's tolerances
    (the rounded pair products are formed alike) and under the mean
    criterion: ragged q; n % 8 != 0 and block 80 (80 = 5 x 16, so every
    sub here divides it); block 256 in pieces of 128; the device-memory
    branch (n = 8000)."""
    _pair_bf16_held(cuda, n, p, q, blk, c, sub)


@pytest.mark.parametrize("sub", [32, 64, 128])
@pytest.mark.parametrize("c", [1.0, 0.5])
@pytest.mark.parametrize("n,p,q,blk", [(80, 250, 40, 128),
                                       (100, 512, 40, 256),
                                       (8000, 128, 256, 128)])
def test_pair_bf16_deep_windows_match_plain(cuda, n, p, q, blk, c, sub):
    """C6b: B2's pair_bf16 instances at the windows over 16 (Fm held at the
    window's start for its 8-windows, the cross pairs with every earlier
    8-window of it) against the plain version in the JAX kernel's windows:
    ragged q; block 256 in pieces of 128; the device-memory branch."""
    _pair_bf16_held(cuda, n, p, q, blk, c, sub)


def _pair_bf16_held(cuda, n, p, q, blk, c, sub):
    ops, block = _mis_operands(n, p, q, c, block=blk, frac=0.15)
    assert block == blk
    kw = dict(block_size=block, pair_bf16=True, sub=sub)
    ref = sm.sweep_missing_fused(*ops, **kw)
    f32 = sm.sweep_missing_fused(*ops, block_size=block)
    launches = sm.sweep_missing_fused.launches
    inst = sm.sweep_missing_fused.pair_bf16.launches
    got = sm.sweep_missing_fused(*[o.to(cuda) for o in ops], **kw)
    f32_kernel = sm.sweep_missing_fused(*[o.to(cuda) for o in ops],
                                        block_size=block)
    torch.cuda.synchronize()
    assert sm.sweep_missing_fused.launches == launches + 2
    assert sm.sweep_missing_fused.pair_bf16.launches == inst + 1
    for name, a, r in zip(MIS_NAMES, got, ref):
        assert a.device.type == "cuda" and a.shape == r.shape, name
        err = float((a.cpu() - r).abs().max())
        limit = 1e-4 if name == "gam" else 1e-4 * float(r.abs().max())
        assert err <= limit, (name, err, limit)
    assert any(not torch.equal(a, b) for a, b in zip(got, f32_kernel))
    _bf16_held(got, ref, f32, f32_kernel, MIS_NAMES)


def test_pair_bf16_window_refused(cuda):
    """A window that does not divide the block (16 at block 120) or that is
    not a power of two (24, which divides it) raises before any launch; at
    window 1 the mode rounds no pair and the float32 instance runs, bit
    for bit."""
    ops, block = _mis_operands(100, 120, 48, 1.0, block=120, frac=0.15)
    ops = [o.to(cuda) for o in ops]
    launches = sm.sweep_missing_fused.launches
    with pytest.raises(ValueError, match="must divide"):
        sm.sweep_missing_fused(*ops, block_size=block, pair_bf16=True, sub=16)
    with pytest.raises(NotImplementedError, match="power of two"):
        sm.sweep_missing_fused(*ops, block_size=block, pair_bf16=True, sub=24)
    assert sm.sweep_missing_fused.launches == launches
    inst = sm.sweep_missing_fused.pair_bf16.launches
    one = sm.sweep_missing_fused(*ops, block_size=block, pair_bf16=True,
                                 sub=1)
    f32 = sm.sweep_missing_fused(*ops, block_size=block)
    assert sm.sweep_missing_fused.pair_bf16.launches == inst
    for name, a, b in zip(MIS_NAMES, one, f32):
        assert torch.equal(a, b), name


def test_pair_bf16_off_at_block_256(cuda):
    """C9: an exact-missing fit under Config(mis_pair_bf16=True) at block
    256, where the JAX package runs its blocked engine and the flag
    changes nothing, launches B2's float32 instance once per iteration and
    the pair_bf16 instance never, and is the fit without the flag."""
    y, x, _ = simulate_fixture(p=250, missing_frac=0.2, seed=5)
    fits = {}
    for flag in (False, True):
        cfg = Config(block_size=256, mis_pair_bf16=flag, device_loop="off")
        dat = prepare_data(y, x, 0.1, 1000)
        p, q = dat.x.shape[1], dat.y.shape[1]
        cfg = dataclasses.replace(cfg, shr_fac_inv=float(q))
        data = gl.build_data(dat.x, dat.y, cfg, cuda)
        hyper = gl.build_hyper(elic.auto_set_hyper(dat.y, p, (5, 25)),
                               data.y.shape[1], cfg, cuda)
        state = gl.build_state(elic.auto_set_init(dat.y, p, (5, 25),
                                                  float(q), 11), data, cfg)
        _reset_counts()
        res = fit_global_local(data, hyper, state, cfg, anneal=(1, 2, 10),
                               verbose=0)
        assert sm.sweep_missing_fused.launches == res.it
        assert sm.sweep_missing_fused.pair_bf16.launches == 0
        fits[flag] = res
    assert fits[True].it == fits[False].it
    assert fits[True].lb_opt == fits[False].lb_opt
    assert torch.equal(fits[True].state.gam, fits[False].state.gam)


def test_bf16_instances_are_deterministic(cuda):
    """Both bf16 instances: two launches agree bit for bit."""
    for q in (200, 4804):
        ops, block = _operands(120, 256, q, 0.5)
        ops = [sf.bf16_operand(ops[0].to(cuda))] + [o.to(cuda)
                                                    for o in ops[1:]]
        kw = dict(block_size=block, emit_gam_mu=True, c_one=False, bf16=True)
        a, b = (_flat(sf.sweep_fused(*ops, **kw)) for _ in range(2))
        for name, u, v in zip(NAMES, a, b):
            assert torch.equal(u, v), (q, name)
    ops, block = _mis_operands(80, 250, 40, 0.5)
    ops = [o.to(cuda) for o in ops]
    a, b = (sm.sweep_missing_fused(*ops, block_size=block, pair_bf16=True)
            for _ in range(2))
    for name, u, v in zip(MIS_NAMES, a, b):
        assert torch.equal(u, v), name


@pytest.mark.parametrize("sub", sm.PAIR_WINDOWS[1:])
@pytest.mark.parametrize("n,p,q", [(100, 256, 40), (8000, 128, 256)])
def test_pair_bf16_instances_are_deterministic(cuda, n, p, q, sub):
    """Every pair_bf16 instance, on chip (ragged q, n % 16 != 0) and in the
    device-memory branch: two launches agree bit for bit (the tensor
    cores' partials are added in a fixed order, no atomics)."""
    ops, block = _mis_operands(n, p, q, 0.5, frac=0.15)
    ops = [o.to(cuda) for o in ops]
    kw = dict(block_size=block, pair_bf16=True, sub=sub)
    a, b = (sm.sweep_missing_fused(*ops, **kw) for _ in range(2))
    for name, u, v in zip(MIS_NAMES, a, b):
        assert torch.equal(u, v), (sub, name)


def test_pair_bf16_sass_holds_bf16_hmma(cuda):
    """B2's pair_bf16 instances from mis_sub 8 on take their pair Grams on
    the tensor cores (bf16 HMMA in their SASS, in both branches), the
    float32 instance holds no HMMA (chip_smoke.sass_hmma, cuobjdump)."""
    import chip_smoke
    inst = chip_smoke.b2_instances(chip_smoke.sass_hmma(sf.build()))
    assert sorted(inst) == sorted((oc, 0 if w == 1 else w)
                                  for oc in (False, True)
                                  for w in sm.PAIR_WINDOWS)
    for (oc, sub), (hmma, not_bf16) in inst.items():
        if sub >= 8:
            assert hmma > 0 and not_bf16 == 0, (oc, sub, hmma, not_bf16)
        elif sub == 0:
            assert hmma == 0, (oc, sub, hmma)


def test_bf16_plan_matches_the_kernel(cuda):
    """The bf16 instance's shared-memory arithmetic (its plan) equals the
    kernel's own at every block up to 128 (multiples of 8, and so of 16
    and 32 or not), and it holds the one CTA per SM its plan counts on;
    a launch at blocks 8, 120 and 128 in each slice width sets the
    kernel's dynamic shared memory to the plan's bytes."""
    for width in sf.FUSED_WIDTHS:
        for block in range(8, 129, 8):
            for r_aug in (1, 42, 48):
                assert (sf.kernel_smem_bytes(width, block, r_aug, True)
                        == sf._fused_smem_bytes(width, block, r_aug, True))
                plan = sf.fused_launch_plan(1000, 10000, block, r_aug,
                                            bf16=True)
                assert sf.occupancy(width, block, r_aug, True) \
                    == plan["ctas_per_sm"] == 1
                # the lookahead variant's overlapped kernel (whole blocks)
                assert (sf.kernel_smem_bytes(width, block, r_aug, True, True)
                        == sf._fused_smem_bytes(width, block, r_aug, True,
                                                True))
    for block, p in ((8, 64), (120, 240), (128, 256)):
        ops, blk = _operands(100, p, 48, 0.5, block=block)
        assert blk == block
        ops16 = [sf.bf16_operand(ops[0].to(cuda))] + [o.to(cuda)
                                                      for o in ops[1:]]
        for width in sf.FUSED_WIDTHS:
            sf.fused_launch("atlasqtl_sweep_fused", *ops16, block_size=block,
                            emit_gam_mu=False, c_one=False, bf16=True,
                            slice_width=width)
            torch.cuda.synchronize()
            assert sf.launch_smem_bytes(width, True) == sf._fused_smem_bytes(
                width, block, ops[3].shape[1], True), (width, block)


def test_bf16_operands_and_b4_refuse(cuda):
    """B4 has no bf16 instance and refuses the flag; the bf16 instance
    takes only the bfloat16 copy of x, and a bfloat16 x is refused without
    the flag; nothing launches."""
    ops, block = _operands(120, 256, 200, 1.0)
    ops = [o.to(cuda) for o in ops]
    ops16 = [sf.bf16_operand(ops[0])] + ops[1:]
    kw = dict(block_size=block, emit_gam_mu=True, c_one=True)
    launches = sf.sweep_fused.launches
    with pytest.raises(ValueError, match="no bf16 instance"):
        sf.fused_launch("atlasqtl_sweep_staggered", *ops16, **kw, bf16=True,
                        plan=ss.staggered_launch_plan)
    with pytest.raises(ValueError, match="x must"):
        sf.sweep_fused(*ops, **kw, bf16=True)
    with pytest.raises(ValueError, match="bf16 mode"):
        sf.sweep_fused(*ops16, **kw)
    assert sf.sweep_fused.launches == launches


@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("kind", ["b1", "b1_cp", "b1_256", "b2"])
def test_batched_bf16_equals_single_launches(cuda, kind, m):
    """Each replica of one batched launch of a bf16 instance equals its own
    launch under the same plan bit for bit (B1's at n % 8 != 0 and block 80
    with X^T Y per replica, as impute gives it; at block 256, in pieces,
    with each replica's workspaces)."""
    shape = dict(b1=(120, 256, 200, 128), b1_cp=(100, 75, 48, 80),
                 b1_256=(120, 512, 200, 256), b2=(80, 250, 40, 128))[kind]
    parts, stacked, block = _replica_operands(kind, *shape[:3], 0.5, m,
                                              block=shape[3], frac=0.15)
    dev = lambda ops: [o.to(cuda) for o in ops]
    if kind == "b2":
        kw = dict(block_size=block, pair_bf16=True)
        plan = sm.missing_launch_plan(shape[0], stacked[6].shape[-1], block,
                                      stacked[4].shape[-1], m)
        got = list(sm.sweep_missing_fused(*dev(stacked), **kw))
        singles = [list(sm._sweep_missing_fused_cuda(*dev(ops), **kw,
                                                     plan=plan))
                   for ops in parts]
    else:
        kw = dict(block_size=block, emit_gam_mu=True, c_one=False, bf16=True)
        x16 = sf.bf16_operand(stacked[0].to(cuda))
        plan = sf.fused_launch_plan(
            stacked[0].shape[0], stacked[5].shape[-1], block,
            stacked[3].shape[-1],
            torch.cuda.get_device_properties(cuda).multi_processor_count, m,
            bf16=True)
        got = _flat(sf.sweep_fused(x16, *dev(stacked[1:]), **kw))
        singles = [_flat(sf.fused_launch(
            "atlasqtl_sweep_fused", x16, *dev(ops[1:]), **kw,
            slice_width=plan["slice_width"])) for ops in parts]
    torch.cuda.synchronize()
    for r, one in enumerate(singles):
        for a, b in zip(got, one):
            if b is None:
                assert a is None
                continue
            assert torch.equal(a[r], b), r


# missing mode, flag, p: mis_pair_bf16 reaches B2 only where the padded p
# is a multiple of 128 (C9), so the exact fit takes p = 250 (padded to 256)
BF16_FITS = {"mxu_bf16": (None, "mxu_bf16", 75),
             "impute": ("impute", "mxu_bf16", 75),
             "exact": ("exact", "mis_pair_bf16", 250)}


@pytest.mark.parametrize("mode", list(BF16_FITS))
def test_bf16_graph_loop_matches_host_loop(cuda, mode):
    """A fit in each bf16 mode under the CUDA-graph loop takes the host
    loop's iterations and ELBO history (to 1e-6 relative, as the float32
    routes); under both loops the mode's instance launches once per
    iteration (replays counted) and is the only sweep launched.  q is
    padded to 128, where the flags reach their kernels (C10)."""
    from atlasqtl_tpu_torch.inference import device_loop as dl
    missing, flag, p = BF16_FITS[mode]
    y, x, _ = simulate_fixture(p=p, missing_frac=0.2 if missing else 0.0,
                               seed=5)
    own = sm.sweep_missing_fused if mode == "exact" else sf.sweep_fused
    inst = own.pair_bf16 if mode == "exact" else own.bf16
    fits = {}
    for loop in ("off", "on"):
        cfg = Config(missing=missing or "exact", device_loop=loop,
                     **{flag: True})
        dat = prepare_data(y, x, 0.1, 1000)
        p, q = dat.x.shape[1], dat.y.shape[1]
        cfg = dataclasses.replace(cfg, shr_fac_inv=float(q))
        data = gl.build_data(dat.x, dat.y, cfg, cuda, q_pad_to=128)
        hyper = gl.build_hyper(elic.auto_set_hyper(dat.y, p, (5, 25)),
                               data.y.shape[1], cfg, cuda)
        state = gl.build_state(elic.auto_set_init(dat.y, p, (5, 25),
                                                  float(q), 11), data, cfg)
        _reset_counts()
        res = fit_global_local(data, hyper, state, cfg, anneal=(1, 2, 10),
                               verbose=0)
        fits[loop] = res
        assert inst.launches == own.launches == res.it
        assert sum(fn.launches for fn in dl.launch_counters()) \
            == 2 * res.it
        assert (dl.replays > 0) == (loop == "on")
    off, on = fits["off"], fits["on"]
    assert off.converged and on.converged and off.it == on.it
    assert [i for i, _ in off.elbo_history] == [i for i, _ in
                                               on.elbo_history]
    np.testing.assert_allclose([lb for _, lb in on.elbo_history],
                               [lb for _, lb in off.elbo_history], rtol=1e-6)


# --------------------------------- the bf16 lookahead schedule (B5d)

def _lookahead_operands(ops, block):
    """The bf16 instance's operands of `_operands`'s float32 ones, and
    the lookahead's off-diagonal Gram blocks (from the float32 x)."""
    return ([sf.bf16_operand(ops[0])] + list(ops[1:]),
            sf.lookahead_gram(ops[0], block))


@pytest.mark.parametrize("c", [1.0, 0.5])
@pytest.mark.parametrize("n,p,q,width,blk", [(120, 256, 200, 32, 128),
                                             (100, 128, 4804, 40, 128),
                                             (100, 120, 48, 32, 120),
                                             (120, 512, 200, 32, 256),
                                             (120, 400, 200, 32, 200)])
def test_lookahead_kernel_matches_plain(cuda, n, p, q, width, blk, c):
    """The bf16 instance's lookahead variant (Config(mxu_bf16=True,
    sweep_lookahead=True)) against its plain version under the bf16 mean
    criterion, at test_bf16_kernel_matches_plain's shapes: ragged q; 40-
    column slices (one block: the schedule is the baseline's); block 120;
    block 256 in pieces of 128 and block 200 in five of 40, every piece
    projecting the previous block's start F and taking all of its deltas
    through goff.  One launch counted, as the bf16 instance's and the
    variant's too; where there are two blocks or more it is not the bf16
    sweep without lookahead."""
    ops, block = _operands(n, p, q, c, block=blk)
    ops16, goff = _lookahead_operands(ops, block)
    kw = dict(block_size=block, emit_gam_mu=True, c_one=c == 1.0)
    ref = _flat(sf.sweep_fused(*ops16, goff, **kw, bf16=True,
                               lookahead=True))
    f32 = _flat(sf.sweep_fused(*ops, **kw))
    counts = (sf.sweep_fused.launches, sf.sweep_fused.bf16.launches,
              sf.sweep_fused.lookahead.launches)
    dev = [o.to(cuda) for o in ops16]
    got = _flat(sf.sweep_fused(*dev, goff.to(cuda), **kw, bf16=True,
                               lookahead=True))
    torch.cuda.synchronize()
    assert (sf.sweep_fused.launches, sf.sweep_fused.bf16.launches,
            sf.sweep_fused.lookahead.launches) == tuple(k + 1 for k in counts)
    f32_kernel = _flat(sf.sweep_fused(*[o.to(cuda) for o in ops], **kw))
    _bf16_held(got, ref, f32, f32_kernel, NAMES)
    base = _flat(sf.sweep_fused(*dev, **kw, bf16=True))
    assert torch.equal(got[3], base[3]) == (ops[0].shape[1] == block)


def test_lookahead_kernel_is_deterministic_and_refuses(cuda):
    """The lookahead variant: two launches agree bit for bit (32- and 40-
    column slices, block 256 in pieces); it refuses lookahead without
    bf16, goff without lookahead and a goff of the wrong shape, and
    nothing launches then."""
    for n, p, q, blk in ((120, 256, 200, 128), (100, 256, 4804, 128),
                         (120, 512, 200, 256)):
        ops, block = _operands(n, p, q, 0.5, block=blk)
        ops16, goff = _lookahead_operands(ops, block)
        dev = [o.to(cuda) for o in ops16] + [goff.to(cuda)]
        kw = dict(block_size=block, emit_gam_mu=True, c_one=False,
                  bf16=True, lookahead=True)
        a, b = (_flat(sf.sweep_fused(*dev, **kw)) for _ in range(2))
        for name, u, v in zip(NAMES, a, b):
            assert torch.equal(u, v), (q, blk, name)
    launches = sf.sweep_fused.launches
    kw = dict(block_size=block, emit_gam_mu=True, c_one=False)
    f32 = [o.to(cuda) for o in ops]
    with pytest.raises(ValueError, match="variant of B1's bf16"):
        sf.fused_launch("atlasqtl_sweep_fused", *f32, dev[-1], **kw,
                        lookahead=True)
    with pytest.raises(ValueError, match="goff goes with lookahead"):
        sf.fused_launch("atlasqtl_sweep_fused", *dev, **kw, bf16=True)
    with pytest.raises(ValueError, match="goff must"):
        sf.fused_launch("atlasqtl_sweep_fused", *dev[:-1],
                        dev[-1][:, :block // 2].contiguous(), **kw,
                        bf16=True, lookahead=True)
    assert sf.sweep_fused.launches == launches


@pytest.mark.parametrize("emit", [True, False])
@pytest.mark.parametrize("n,p,q,c", [(120, 120, 200, 1.0),
                                     (120, 256, 200, 0.5),
                                     (333, 640, 77, 1.0),
                                     (300, 640, 104, 0.5),
                                     (100, 384, 4804, 1.0)])
def test_lookahead_overlap_edges(cuda, n, p, q, c, emit):
    """The lookahead variant's overlapped schedule (whole blocks of 128:
    csrc/sweep_fused.cu:sweep_lookahead_kernel) at the edges of its
    pipeline: one block (nothing to overlap), two blocks (the second
    projected beside the first chain, with no advance), five and three;
    n not a multiple of 32; q not a multiple of the slice width (77 padded
    to 80, 104, 200 in 32-column slices; 4804 in 40-column slices, the
    last of 121 holding 4); c = 1 and c < 1; gam and mu emitted or not.
    Against its plain version under the bf16 mean criterion, and two
    launches agree bit for bit."""
    ops, block = _operands(n, p, q, c)
    ops16, goff = _lookahead_operands(ops, block)
    kw = dict(block_size=block, emit_gam_mu=emit, c_one=c == 1.0)
    ref = _flat(sf.sweep_fused(*ops16, goff, **kw, bf16=True,
                               lookahead=True))
    f32 = _flat(sf.sweep_fused(*ops, **kw))
    dev = [o.to(cuda) for o in ops16] + [goff.to(cuda)]
    got, again = (_flat(sf.sweep_fused(*dev, **kw, bf16=True,
                                       lookahead=True)) for _ in range(2))
    f32_kernel = _flat(sf.sweep_fused(*[o.to(cuda) for o in ops], **kw))
    torch.cuda.synchronize()
    _bf16_held(got, ref, f32, f32_kernel, NAMES)
    for name, u, v in zip(NAMES, got, again):
        assert (u is None and v is None) or torch.equal(u, v), name


@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("kind", ["b1", "b1_cp", "b1_256"])
def test_batched_lookahead_equals_single_launches(cuda, kind, m):
    """Each replica of one batched launch of the lookahead variant (goff
    shared) equals its own launch under the same plan bit for bit: X^T Y
    per replica at n % 8 != 0 and block 80; block 256 in pieces, with each
    replica's two-deep workspaces."""
    shape = dict(b1=(120, 256, 200, 128), b1_cp=(100, 75, 48, 80),
                 b1_256=(120, 512, 200, 256))[kind]
    parts, stacked, block = _replica_operands(kind, *shape[:3], 0.5, m,
                                              block=shape[3])
    dev = lambda ops: [o.to(cuda) for o in ops]
    kw = dict(block_size=block, emit_gam_mu=True, c_one=False, bf16=True,
              lookahead=True)
    x16 = sf.bf16_operand(stacked[0].to(cuda))
    goff = sf.lookahead_gram(stacked[0], block).to(cuda)
    plan = sf.fused_launch_plan(
        stacked[0].shape[0], stacked[5].shape[-1], block,
        stacked[3].shape[-1],
        torch.cuda.get_device_properties(cuda).multi_processor_count, m,
        bf16=True)
    launches = sf.sweep_fused.lookahead.launches
    got = _flat(sf.sweep_fused(x16, *dev(stacked[1:]), goff, **kw))
    torch.cuda.synchronize()
    assert sf.sweep_fused.lookahead.launches == launches + 1
    singles = [_flat(sf.fused_launch(
        "atlasqtl_sweep_fused", x16, *dev(ops[1:]), goff, **kw,
        slice_width=plan["slice_width"])) for ops in parts]
    torch.cuda.synchronize()
    for r, one in enumerate(singles):
        for a, b in zip(got, one):
            if b is None:
                assert a is None
                continue
            assert torch.equal(a[r], b), r


def test_lookahead_graph_loop_matches_host_loop(cuda):
    """A fit under Config(mxu_bf16=True, sweep_lookahead=True) (block 32:
    p = 75 in three blocks) under the CUDA-graph loop takes the host loop's
    iterations and ELBO history (to 1e-6 relative, as the float32 routes);
    under both loops the lookahead variant launches once per iteration
    (replays counted) and is the only sweep launched; goff is built once,
    in build_data (q padded to 128, where the flags reach B1: C10)."""
    from atlasqtl_tpu_torch.inference import device_loop as dl
    y, x, _ = simulate_fixture(seed=5)
    fits = {}
    for loop in ("off", "on"):
        cfg = Config(mxu_bf16=True, sweep_lookahead=True, block_size=32,
                     device_loop=loop)
        dat = prepare_data(y, x, 0.1, 1000)
        p, q = dat.x.shape[1], dat.y.shape[1]
        cfg = dataclasses.replace(cfg, shr_fac_inv=float(q))
        data = gl.build_data(dat.x, dat.y, cfg, cuda, q_pad_to=128)
        assert data.goff is not None and data.goff.shape == (96, 32)
        hyper = gl.build_hyper(elic.auto_set_hyper(dat.y, p, (5, 25)),
                               data.y.shape[1], cfg, cuda)
        state = gl.build_state(elic.auto_set_init(dat.y, p, (5, 25),
                                                  float(q), 11), data, cfg)
        _reset_counts()
        res = fit_global_local(data, hyper, state, cfg, anneal=(1, 2, 10),
                               verbose=0)
        fits[loop] = res
        assert (sf.sweep_fused.lookahead.launches
                == sf.sweep_fused.bf16.launches
                == sf.sweep_fused.launches == res.it)
        assert sum(fn.launches for fn in dl.launch_counters()) \
            == 3 * res.it
        assert (dl.replays > 0) == (loop == "on")
    off, on = fits["off"], fits["on"]
    assert off.converged and on.converged and off.it == on.it
    assert [i for i, _ in off.elbo_history] == [i for i, _ in
                                               on.elbo_history]
    np.testing.assert_allclose([lb for _, lb in on.elbo_history],
                               [lb for _, lb in off.elbo_history], rtol=1e-6)


# ------------------------------------------------ the samplers (mcmc/)

def _mcmc_problem(device, seed=3):
    """The samplers' float64 (data, hyper, cfg) at (60, 30, 12), block 16,
    built on the CPU and moved to `device` field by field (the same
    inputs on both devices)."""
    from atlasqtl_tpu_torch.types import Data, Hyper
    y, x, _ = simulate_fixture(n=60, p=30, p_act=5, q=12, seed=seed)
    dat = prepare_data(y, x, 0.1, 1000)
    p_eff, q_eff = dat.x.shape[1], dat.y.shape[1]
    cfg = Config(dtype=torch.float64, block_size=16,
                 shr_fac_inv=float(q_eff))
    data = gl.build_data(dat.x, dat.y, cfg, "cpu")
    hyper = gl.build_hyper(elic.auto_set_hyper(dat.y, p_eff, (4, 12)),
                           data.y.shape[1], cfg, "cpu")
    move = lambda obj: dataclasses.replace(obj, **{
        f.name: v.to(device) for f in dataclasses.fields(obj)
        if isinstance(v := getattr(obj, f.name), torch.Tensor)})
    return move(data), move(hyper), cfg


def _mcmc_held(got, ref, label):
    for f in dataclasses.fields(ref):
        np.testing.assert_allclose(getattr(got, f.name).cpu().numpy(),
                                   getattr(ref, f.name).numpy(), rtol=1e-9,
                                   atol=1e-12, err_msg=f"{label}: {f.name}")


@pytest.mark.parametrize("particles", [None, 4])
def test_gibbs_sweep_on_card_matches_cpu(cuda, particles):
    """Three gibbs_sweeps (temper 1, then 0.5: an SMC mutation of 4
    particles with a particle axis) on the card equal the same sweeps on
    the CPU under the same draws."""
    from atlasqtl_tpu_torch.mcmc import gibbs as mg
    from atlasqtl_tpu_torch.mcmc.draws import RecordingDraws, TorchDraws
    out = {}
    rec = RecordingDraws(TorchDraws.seeded(4, "cpu", torch.float64))
    for dev, draws in (("cpu", rec), ("cuda", None)):
        data, hyper, cfg = _mcmc_problem(dev)
        draws = draws or rec.replay(dev)
        gram = block_gram(data.x, 16)
        st = mg.init_state(data, cfg, particles)
        for temper in (1.0, 0.5, 0.5):
            st = mg.gibbs_sweep(st, data, hyper, gram, draws, cfg=cfg,
                                temper=temper)
        out[dev] = st
    _mcmc_held(out["cuda"], out["cpu"], f"particles={particles}")
    assert out["cpu"].gam.sum() > 0


def test_nuts_step_on_card_matches_cpu(cuda):
    """One NUTS transition on the card takes the CPU's tree from the same
    host rng: the same w' and acceptance statistic."""
    from atlasqtl_tpu_torch.mcmc import nuts as mn
    rng = np.random.default_rng(7)
    a = dict(zrow=rng.normal(size=32) * 5, zcol=rng.normal(size=16) * 3,
             p_mask=(np.arange(32) < 30).astype(float),
             q_mask=(np.arange(16) < 12).astype(float), p_true=30.0,
             q_true=12.0, n0=rng.normal(size=16) - 1.0, t0=0.7,
             shr_sqrt=np.sqrt(12.0))
    w = rng.normal(size=2 * 32 + 1 + 16) * 0.3
    out = {}
    for dev in ("cpu", "cuda"):
        stats = mn.NutsStats(**{k: torch.as_tensor(v, dtype=torch.float64,
                                                   device=dev)
                                for k, v in a.items()})
        out[dev] = mn.nuts_step(np.random.default_rng(9),
                                torch.as_tensor(w, device=dev), 0.1, stats)
    np.testing.assert_allclose(out["cuda"][0].cpu().numpy(),
                               out["cpu"][0].numpy(), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-9)


def test_samplers_run_on_the_card_with_its_generator(cuda):
    """run_gibbs, run_nuts and run_smc on data that live on the card draw
    from a CUDA generator (torch._standard_gamma takes it there): the same
    seed gives the same summaries, and they are finite, of full shape."""
    from atlasqtl_tpu_torch.mcmc import gibbs as mg, nuts as mn, smc as ms
    from atlasqtl_tpu_torch.mcmc.draws import TorchDraws
    data, hyper, cfg = _mcmc_problem("cuda")
    d = TorchDraws.seeded(1, "cuda", torch.float64)
    assert d.generator.device.type == "cuda"
    g = d.standard_gamma("tau", torch.full((5,), 2.0, dtype=torch.float64,
                                           device="cuda"))
    assert g.device.type == "cuda" and bool((g > 0).all())
    runs = [mg.run_gibbs(data, hyper, cfg, n_samples=4, n_burnin=2, seed=1)
            for _ in range(2)]
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    nuts = mn.run_nuts(data, hyper, cfg, n_samples=2, n_burnin=2, seed=1)
    smc = ms.run_smc(data, hyper, cfg, n_particles=4, anneal=(1, 2, 3),
                     n_mutations=1, n_final=2, seed=1)
    p_pad, q_pad = data.x.shape[1], data.y.shape[1]
    for res in (runs[0], nuts, smc[:4]):
        assert res[0].shape == (p_pad, q_pad) and res[2].shape == (p_pad,)
        assert all(np.isfinite(v).all() for v in res)
    assert np.isfinite(smc[4])


# ---- the perf probes (B1: Config.sweep_probe, B2: probe=) ----------------

def _probe_held(got, ref, fitted_in):
    """The kernel tests' tolerance, F's scaled by the larger of F out and
    F in: F out = F in + X delta, and where a probe makes the two cancel
    (nor0: delta is near -beta, so F out is near 0) the rounding is that
    of F in's scale."""
    for name, a, r in zip(NAMES, _flat(got), _flat(ref)):
        if r is None:
            assert a is None, name
            continue
        assert a.device.type == "cuda" and a.shape == r.shape, name
        err = float((a.cpu() - r).abs().max())
        scale = float(r.abs().max())
        if name == "fitted":
            scale = max(scale, float(fitted_in.abs().max()))
        limit = 1e-4 if name == "gam" else 1e-4 * scale
        assert err <= limit, (name, err, limit)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("p,blk,sub", [(256, 128, 8), (512, 256, 16)])
@pytest.mark.parametrize("probe", list(sf.PROBES))
def test_probe_kernel_matches_plain(cuda, probe, p, blk, sub, bf16):
    """Each of B1's probes (its probe instance) against the plain version
    at block 128 (window 8) and 256 (pieces of 128, the whole block's
    function, window 16): float32 at the kernel tests' tolerance, under
    mxu_bf16 (the bf16 copy of x) by the bf16 mean criterion."""
    ops, block = _operands(120, p, 200, 1.0, block=blk)
    kw = dict(block_size=block, c_one=True, probe=probe, sub=sub)
    dev = [o.to(cuda) for o in ops]
    launches = sf.sweep_fused.probe.launches
    got32 = sf.sweep_fused(*dev, **kw)
    ref32 = sf.sweep_fused(*ops, **kw)
    assert sf.sweep_fused.probe.launches == launches + 1
    if not bf16:
        _probe_held(got32, ref32, ops[6])
        return
    got = sf.sweep_fused(dev[0].to(torch.bfloat16), *dev[1:], **kw,
                         bf16=True)
    ref = sf.sweep_fused(*ops, **kw, bf16=True)
    _bf16_held(_flat(got), _flat(ref), _flat(ref32), _flat(got32), NAMES)


@pytest.mark.parametrize("p,blk,sub", [(256, 128, 1), (256, 128, 2),
                                       (256, 128, 4), (256, 128, 32),
                                       (512, 256, 4), (240, 48, 3),
                                       (240, 48, 6), (240, 48, 12),
                                       (240, 40, 5), (384, 192, 12),
                                       (400, 200, 25), (400, 200, 20)])
@pytest.mark.parametrize("probe", ["noseq", "norank", "exact_noz"])
def test_probe_kernel_windows(cuda, probe, p, blk, sub):
    """B1's probe instance at the windows below 8 (a window of 8 rows then
    holds several), above 16, and off the 8-row grid (3, 6, 12 at block 48,
    5 at block 40: a window starts inside a chain window; 12 at block 192,
    in pieces of 96; 25 at block 200, in pieces of 40, a window across two
    pieces, and 20 inside them), where noseq and norank change with the
    window, against the plain version at the kernel tests' tolerance."""
    ops, block = _operands(120, p, 200, 1.0, block=blk)
    kw = dict(block_size=block, c_one=True, probe=probe, sub=sub)
    got = sf.sweep_fused(*[o.to(cuda) for o in ops], **kw)
    _probe_held(got, sf.sweep_fused(*ops, **kw), ops[6])


def _probe_at(ops, block, probe, sub, width, bf16=False):
    """B1's probe `probe` (a PROBES name, or a Probe) launched in slices of
    `width` columns, whatever the plan picks (at q = 200 it takes 32)."""
    x = ops[0].to(torch.bfloat16) if bf16 else ops[0]
    return sf.fused_launch(
        "atlasqtl_sweep_fused", x, *ops[1:], block_size=block,
        emit_gam_mu=True, c_one=True, bf16=bf16,
        probe=sf.PROBES[probe] if isinstance(probe, str) else probe,
        window=sub, slice_width=width)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("p,blk,sub", [(256, 128, 8), (256, 128, 16)])
@pytest.mark.parametrize("probe", list(sf.PROBES))
def test_probe_kernel_at_40_columns(cuda, probe, p, blk, sub, bf16):
    """Each of B1's probes in 40-column slices (B1's plan at the eQTL q)
    against the plain version at block 128, windows 8 and 16: float32 at
    the kernel tests' tolerance, under mxu_bf16 by the bf16 mean
    criterion.  (A block over 128 keeps 32 columns:
    test_probe_pieces_keep_32_columns.)"""
    ops, block = _operands(120, p, 200, 1.0, block=blk)
    kw = dict(block_size=block, c_one=True, probe=probe, sub=sub)
    dev = [o.to(cuda) for o in ops]
    got32 = _probe_at(dev, block, probe, sub, 40)
    ref32 = sf.sweep_fused(*ops, **kw)
    if not bf16:
        _probe_held(got32, ref32, ops[6])
        return
    got = _probe_at(dev, block, probe, sub, 40, bf16=True)
    ref = sf.sweep_fused(*ops, **kw, bf16=True)
    _bf16_held(_flat(got), _flat(ref), _flat(ref32), _flat(got32), NAMES)


@pytest.mark.parametrize("p,blk,sub", [(256, 128, 1), (256, 128, 4),
                                       (256, 128, 32), (240, 48, 3),
                                       (240, 48, 6), (240, 48, 12),
                                       (240, 40, 5), (240, 120, 24)])
@pytest.mark.parametrize("probe", ["noseq", "norank", "exact_noz"])
def test_probe_kernel_windows_at_40_columns(cuda, probe, p, blk, sub):
    """B1's probe instances at windows off the 8-row grid (and 4) in
    40-column slices, against the plain version at the kernel tests'
    tolerance: the Gram's zeros follow each window wherever it starts."""
    ops, block = _operands(120, p, 200, 1.0, block=blk)
    kw = dict(block_size=block, c_one=True, probe=probe, sub=sub)
    got = _probe_at([o.to(cuda) for o in ops], block, probe, sub, 40)
    _probe_held(got, sf.sweep_fused(*ops, **kw), ops[6])


@pytest.mark.parametrize("probe", ["noseq", "noadv", "dmalite"])
def test_probe_pieces_keep_32_columns(cuda, probe):
    """A probe at a block over 128 (in pieces of 128) runs a 32-column
    instance: its plan says so (`widths`), 40 columns forced is refused
    before any launch, and the plan's launch matches the plain version."""
    ops, block = _operands(120, 512, 200, 1.0, block=256)
    plan = sf.fused_launch_plan(120, 200, 256, ops[3].shape[1], probe=True)
    assert plan["widths"] == sf.FUSED_PROBE_PIECE_WIDTHS == (32,)
    dev = [o.to(cuda) for o in ops]
    with pytest.raises(ValueError, match="32"):
        _probe_at(dev, block, probe, 16, 40)
    kw = dict(block_size=block, c_one=True, probe=probe, sub=16)
    _probe_held(_probe_at(dev, block, probe, 16, 32),
                sf.sweep_fused(*ops, **kw), ops[6])


@pytest.mark.parametrize("blk", [128, 256])
@pytest.mark.parametrize("width", [32, 40])
def test_probe_every_part_kept_is_b1(cuda, width, blk):
    """Routing: the probe that keeps every part launches B1's float32
    instance (its outputs bit for bit B1's), at either width, whole block
    or in pieces."""
    ops, block = _operands(120, 2 * blk, 200, 1.0, block=blk)
    dev = [o.to(cuda) for o in ops]
    every = _probe_at(dev, block, sf.Probe(), 8, width)
    b1 = sf.fused_launch("atlasqtl_sweep_fused", *dev, block_size=block,
                         emit_gam_mu=True, c_one=True, slice_width=width)
    for a, b in zip(_flat(every), _flat(b1)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("parts,window", [
    (sf.Probe(corrections=False), 128), (sf.Probe(pushes=False), 1)])
@pytest.mark.parametrize("width", [32, 40])
def test_probe_dropping_nothing_is_b1(cuda, width, parts, window):
    """A probe instance whose probe drops nothing at its window (the
    corrections at a window of the whole block, the pushes at a window of
    one row) runs B1's chain on a Gram with no entry zeroed: its outputs
    are B1's float32 instance's, bit for bit, at either width."""
    ops, block = _operands(120, 256, 200, 1.0, block=128)
    dev = [o.to(cuda) for o in ops]
    got = _probe_at(dev, block, parts, window, width)
    b1 = sf.fused_launch("atlasqtl_sweep_fused", *dev, block_size=block,
                         emit_gam_mu=True, c_one=True, slice_width=width)
    for a, b in zip(_flat(got), _flat(b1)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("pair_bf16", [False, True])
@pytest.mark.parametrize("n,p,q,sub", [(80, 250, 40, 1), (80, 250, 40, 2),
                                       (80, 250, 40, 4), (80, 250, 40, 8),
                                       (80, 250, 40, 16),
                                       (8000, 128, 256, 16),
                                       (80, 250, 40, 32), (80, 250, 40, 64),
                                       (80, 250, 40, 128),
                                       (8000, 256, 256, 32),
                                       (8000, 256, 256, 64),
                                       (8000, 256, 256, 128)])
@pytest.mark.parametrize("probe", list(sm.MIS_PROBES))
def test_missing_probe_kernel_matches_plain(cuda, probe, n, p, q, sub,
                                            pair_bf16):
    """Each of B2's probes at mis_sub 1 to 128 (Fm on chip) and 16 to 128
    (Fm in device memory, n = 8000), float32 and pair_bf16, against the
    plain version at the B2 kernel tests' tolerance (in float32 B2's
    running masked advance with each probe's departure at its window's
    edges; under pair_bf16 from 16 on each 8-window of a window projects
    Fm as of the window's start and takes the rounded cross pairs)."""
    ops, block = _mis_operands(n, p, q, 1.0, block=128)
    kw = dict(block_size=block, sub=sub, pair_bf16=pair_bf16, probe=probe)
    launches = sm.sweep_missing_fused.probe.launches
    got = sm.sweep_missing_fused(*[o.to(cuda) for o in ops], **kw)
    assert sm.sweep_missing_fused.probe.launches == launches + 1
    ref = sm.sweep_missing_fused(*ops, **kw)
    for name, a, r in zip(MIS_NAMES, got, ref):
        err = float((a.cpu() - r).abs().max())
        limit = 1e-4 if name == "gam" else 1e-4 * float(r.abs().max())
        assert err <= limit, (name, err, limit)
    if probe == "noadv":   # Fm out = Fm in
        assert torch.equal(got[2].cpu(), ops[8])


@pytest.mark.parametrize("n,p,q,blk,sub", [
    *((80, 250, 40, 128, s) for s in (1, 2, 4, 8, 16, 32, 64, 128)),
    *((8000, 256, 256, 128, s) for s in (16, 32, 64, 128)),
    (80, 240, 40, 48, 12), (8000, 240, 256, 48, 12)])
def test_missing_probe_exact_is_b2(cuda, n, p, q, blk, sub):
    """The float32 probe instance's exact sweep runs B2's own schedule at
    every window (the window does not change the exact function): its
    outputs match B2's float32 instance's, Fm on chip (n = 80) and in
    device memory (n = 8000), 12 off the 8-row grid, at the B2 kernel
    tests' tolerance."""
    ops, block = _mis_operands(n, p, q, 1.0, block=blk)
    dev = [o.to(cuda) for o in ops]
    got = sm._sweep_missing_fused_cuda(*dev, block_size=block, sub=sub,
                                       probe="exact")
    ref = sm.sweep_missing_fused(*dev, block_size=block)
    for name, a, r in zip(MIS_NAMES, got, ref):
        err = float((a - r).abs().max())
        limit = 1e-4 if name == "gam" else 1e-4 * float(r.abs().max())
        assert err <= limit, (name, err, limit)


@pytest.mark.parametrize("n,p,q,m", [(1000, 256, 40, 1), (80, 250, 40, 2),
                                     (1000, 256, 40, 2),
                                     (8000, 256, 256, 2)])
@pytest.mark.parametrize("sub", [32, 128])
@pytest.mark.parametrize("probe", ["noseq", "noadv", "noadvmask"])
def test_missing_probe_kernel_ranks_and_replicas(cuda, probe, sub, n, p, q,
                                                 m):
    """B2's float32 probe instance where a window's end reads x and Fm at a
    rank's rows and a replica's slices (window_edge, the deltas'
    workspace per CTA, noadv's Fm as received): Fm on chip in a cluster of
    2 or more (n = 1000), m = 2 stacked replicas on chip and in device
    memory (n = 8000), against the plain version replica by replica at the
    B2 kernel tests' tolerance."""
    parts, stacked, block = _replica_operands("b2", n, p, q, 1.0, m,
                                              block=128, frac=0.15)
    ops = parts[0] if m == 1 else stacked
    plan = sm.missing_launch_plan(ops[0].shape[0], ops[6].shape[-1], block,
                                  ops[4].shape[-1], m, probe=probe,
                                  probe_window=sub)
    assert plan["fm_on_chip"] == (n < 8000)
    if n == 1000:
        assert plan["cluster"] > 1, plan
    kw = dict(block_size=block, sub=sub, probe=probe)
    got = sm.sweep_missing_fused(*[o.to(cuda) for o in ops], **kw)
    ref = sm.sweep_missing_fused(*ops, **kw)
    for name, a, r in zip(MIS_NAMES, got, ref):
        for i in range(m):
            a_i, r_i = (a, r) if m == 1 else (a[i], r[i])
            err = float((a_i.cpu() - r_i).abs().max())
            limit = 1e-4 if name == "gam" else 1e-4 * float(r_i.abs().max())
            assert err <= limit, (name, i, err, limit)
    if probe == "noadv":   # Fm out = Fm in
        assert torch.equal(got[2].cpu(), ops[8])


@pytest.mark.parametrize("n,q", [(80, 40), (8000, 256)])
@pytest.mark.parametrize("p,blk,sub", [(240, 48, 3), (240, 48, 6),
                                       (240, 48, 12), (240, 48, 24),
                                       (240, 40, 5), (240, 40, 20),
                                       (400, 200, 25), (400, 200, 200)])
@pytest.mark.parametrize("probe", list(sm.MIS_PROBES))
def test_missing_probe_kernel_any_window(cuda, probe, p, blk, sub, n, q):
    """B2's float32 probe instance at windows that divide the block but are
    not powers of two: off the 8-row grid (3, 5, 6, 12, 20, 25: a window
    starts inside a chain window; the window's deltas in a ring) and
    multiples of 8 (24; 200, a block over 128 whole), Fm on chip (n = 80)
    and in device memory (n = 8000), against the plain version at the B2
    kernel tests' tolerance."""
    ops, block = _mis_operands(n, p, q, 1.0, block=blk)
    assert block == blk
    kw = dict(block_size=block, sub=sub, probe=probe)
    got = sm.sweep_missing_fused(*[o.to(cuda) for o in ops], **kw)
    ref = sm.sweep_missing_fused(*ops, **kw)
    for name, a, r in zip(MIS_NAMES, got, ref):
        err = float((a.cpu() - r).abs().max())
        limit = 1e-4 if name == "gam" else 1e-4 * float(r.abs().max())
        assert err <= limit, (name, err, limit)


def test_probe_launches_under_a_cuda_graph(cuda):
    """Both probe instances captured in a CUDA graph and replayed give the
    eager launches' outputs bit for bit."""
    ops, block = _operands(120, 256, 200, 1.0)
    dev = [o.to(cuda) for o in ops]
    mops, mblock = _mis_operands(80, 250, 40, 1.0)
    mdev = [o.to(cuda) for o in mops]
    run = lambda: (_flat(sf.sweep_fused(*dev, block_size=block, c_one=True,
                                        probe="norank", sub=8))
                   + list(sm.sweep_missing_fused(*mdev, block_size=mblock,
                                                 sub=16, probe="noadvmask")))
    eager = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()   # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(eager, captured):
        assert torch.equal(a, b)


@pytest.mark.parametrize("m", [1, 2])
def test_batched_probe_equals_single_launches(cuda, m):
    """A probe applies to every replica of a batched launch, each bit for
    bit its own launch in slices of the same width (its plain version
    replica by replica within the kernel tests' tolerance)."""
    parts = [_operands(120, 256, 200, 1.0, seed=3 + r)[0] for r in range(m)]
    stacked = [o.to(cuda) for o in sf.FUSED.stack(parts)]
    kw = dict(block_size=128, c_one=True, probe="jacobi", sub=8)
    got = sf.sweep_fused(*stacked, **kw)
    width = sf.fused_launch_plan(
        120, 200, 128, parts[0][3].shape[1],
        torch.cuda.get_device_properties(cuda).multi_processor_count, m=m,
        probe=True)["slice_width"]
    shared = set(sf.FUSED.names) - sf.FUSED.state
    for r in range(m):
        ops = [o if k in shared else o[r] for k, o in
               zip(sf.FUSED.names, stacked)]
        one = sf.fused_launch("atlasqtl_sweep_fused", *ops, block_size=128,
                              emit_gam_mu=True, c_one=True,
                              probe=sf.PROBES["jacobi"], window=8,
                              slice_width=width)
        for a, b in zip(_flat(got), _flat(one)):
            assert torch.equal(a[r], b)
        ref = sf.sweep_fused(*[o.cpu() for o in ops], **kw)
        _probe_held(one, ref, ops[6])


@pytest.mark.parametrize("probe", ["jacobi", "noseq"])
def test_batched_probe_at_40_columns(cuda, probe):
    """Two replicas in one launch of a probe instance in 40-column slices,
    each bit for bit its own launch at 40 (its plain version replica by
    replica within the kernel tests' tolerance)."""
    parts = [_operands(120, 256, 200, 1.0, seed=3 + r)[0] for r in range(2)]
    stacked = [o.to(cuda) for o in sf.FUSED.stack(parts)]
    got = _probe_at(stacked, 128, probe, 8, 40)
    shared = set(sf.FUSED.names) - sf.FUSED.state
    for r in range(2):
        ops = [o if k in shared else o[r] for k, o in
               zip(sf.FUSED.names, stacked)]
        one = _probe_at(ops, 128, probe, 8, 40)
        for a, b in zip(_flat(got), _flat(one)):
            assert torch.equal(a[r], b)
        ref = sf.sweep_fused(*[o.cpu() for o in ops], block_size=128,
                             c_one=True, probe=probe, sub=8)
        _probe_held(one, ref, ops[6])


def test_probe_routes_on_the_card(cuda):
    """One cavi_iteration under Config(sweep_probe="noadv") launches B1's
    probe instance once; with sweep_stagger too it takes B1's probe
    instance, not B4 (which the same configuration takes without it)."""
    y, x, _ = simulate_fixture(n=120, p=256, p_act=8, q=200, seed=3)
    dat = prepare_data(y, x, 0.1, 1000)
    p_eff, q_eff = dat.x.shape[1], dat.y.shape[1]
    for probe, stagger in (("noadv", False), ("noadv", True),
                           ("none", True)):
        cfg = Config(dtype=torch.float32, shr_fac_inv=float(q_eff),
                     sweep_probe=probe, sweep_stagger=stagger)
        data = gl.build_data(dat.x, dat.y, cfg, cuda, q_pad_to=256)
        hyper = gl.build_hyper(elic.auto_set_hyper(dat.y, p_eff, (4, 16)),
                               data.y.shape[1], cfg, cuda)
        state = gl.build_state(elic.auto_set_init(dat.y, p_eff, (4, 16),
                                                  float(q_eff), 3), data,
                               cfg)
        counts = (sf.sweep_fused.launches, sf.sweep_fused.probe.launches,
                  ss.sweep_fused_staggered.launches)
        gl.cavi_iteration(data, hyper, state,
                          block_gram(data.x, gl.data_block(cfg, data)), 1.0,
                          1.0, cfg=cfg, annealed=False)
        moved = tuple(a - b for a, b in zip(
            (sf.sweep_fused.launches, sf.sweep_fused.probe.launches,
             ss.sweep_fused_staggered.launches), counts))
        assert moved == ((0, 0, 1) if probe == "none" else (1, 1, 0)), moved


def test_probe_kernels_refuse(cuda):
    """B1's probe instance takes no lookahead, but every window (6 at
    block 48 too); B2's takes window 32 (held to the plain version)."""
    ops, block = _operands(120, 96, 200, 1.0, block=48)
    assert block == 48
    kw = dict(block_size=block, probe="noseq", sub=6)
    _probe_held(sf.sweep_fused(*[o.to(cuda) for o in ops], **kw),
                sf.sweep_fused(*ops, **kw), ops[6])
    ops, block = _operands(120, 256, 200, 1.0)
    dev = [o.to(cuda) for o in ops]
    with pytest.raises(ValueError, match="lookahead"):
        sf.sweep_fused(dev[0].to(torch.bfloat16), *dev[1:], block_size=block,
                       bf16=True, lookahead=True,
                       goff=sf.lookahead_gram(dev[0], block), probe="noseq")
    mops, mblock = _mis_operands(80, 250, 40, 1.0)
    kw = dict(block_size=mblock, sub=32, probe="noadv")
    got = sm.sweep_missing_fused(*[o.to(cuda) for o in mops], **kw)
    for name, a, r in zip(MIS_NAMES, got, sm.sweep_missing_fused(*mops, **kw)):
        err = float((a.cpu() - r).abs().max())
        limit = 1e-4 if name == "gam" else 1e-4 * float(r.abs().max())
        assert err <= limit, (name, err, limit)


@pytest.mark.parametrize("kind", ["b1", "b5a", "b5d", "b2", "b5b"])
def test_production_instances_still_match_plain(cuda, kind):
    """Beside the probe instances, the production instances of B1 (f32,
    mxu_bf16, its lookahead) and B2 (f32, pair_bf16 at mis_sub 16) still
    match their plain versions (float32 at the kernel tests' tolerance,
    the bf16 modes by their mean criterion)."""
    if kind in ("b2", "b5b"):
        ops, block = _mis_operands(80, 250, 40, 1.0)
        kw = dict(block_size=block, pair_bf16=kind == "b5b", sub=16)
        got = sm.sweep_missing_fused(*[o.to(cuda) for o in ops], **kw)
        ref = sm.sweep_missing_fused(*ops, **kw)
        for name, a, r in zip(MIS_NAMES, got, ref):
            err = float((a.cpu() - r).abs().max())
            limit = 1e-4 if name == "gam" else 1e-4 * float(r.abs().max())
            assert err <= limit, (name, err, limit)
        return
    ops, block = _operands(120, 256, 200, 1.0)
    dev = [o.to(cuda) for o in ops]
    kw = dict(block_size=block, c_one=True)
    got32, ref32 = sf.sweep_fused(*dev, **kw), sf.sweep_fused(*ops, **kw)
    if kind == "b1":
        _probe_held(got32, ref32, ops[6])
        return
    la = kind == "b5d"
    goff = sf.lookahead_gram(ops[0], block) if la else None
    got = sf.sweep_fused(dev[0].to(torch.bfloat16), *dev[1:],
                         None if goff is None else goff.to(cuda), **kw,
                         bf16=True, lookahead=la)
    ref = sf.sweep_fused(*ops, goff, **kw, bf16=True, lookahead=la)
    _bf16_held(_flat(got), _flat(ref), _flat(ref32), _flat(got32), NAMES)
