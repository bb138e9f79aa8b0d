"""The CUDA sweep kernels on the card: B1 (csrc/sweep_fused.cu, the
complete-data sweep), B2 (csrc/sweep_missing_fused.cu, the exact-missing
sweep), B3 (csrc/sweep_inner_gs.cu, one block's inner update, float32 and
float64) and B4 (csrc/sweep_staggered.cu, the staggered complete-data
sweep).

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
@pytest.mark.parametrize("n,p,q,width", [(120, 256, 200, 32),
                                         (100, 75, 48, 32),
                                         (1001, 256, 104, 32),
                                         (100, 128, 4804, 40)])
def test_kernel_matches_plain(cuda, n, p, q, width, c_one, emit):
    """(120, 256, 200): ragged q (the last of 7 column slices holds 8 of 32);
    (100, 75, 48): n % 8 != 0 (the true Gram diagonal matters) and block 80;
    (1001, 256, 104): many sample chunks, the last one ragged;
    (100, 128, 4804): the plan takes 40-column slices (one wave on 132 SMs
    where 32 columns take two), the last one ragged."""
    ops, block = _operands(n, p, q, 1.0 if c_one else 0.5)
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
    for n in (1, 80, 1000, 4000, 7000, 8000, 50000):
        for r_aug in (1, 42, 48):
            plan = sm.missing_launch_plan(n, 10000, 128, r_aug)
            assert sm.kernel_smem_bytes(plan, n, r_aug) == plan["smem_bytes"]
            ctas, clusters = sm.occupancy(plan, n, r_aug)
            assert ctas >= plan["ctas_per_sm"] and clusters >= 1


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
@pytest.mark.parametrize("B,q", [(128, 200), (80, 48)])
def test_inner_gs_kernel_matches_plain(cuda, B, q, dtype):
    """(128, 200): a ragged last slice (8 of 32 columns); (80, 48): block
    80."""
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
    big = [o.to(cuda) if torch.is_tensor(o) else o
           for o in _gs_operands(136, 64, torch.float32)]
    with pytest.raises(ValueError, match="unsupported block"):
        sp.inner_gs_pallas(*big)
    assert sp.inner_gs_pallas.launches == launches


@pytest.mark.parametrize("c_one,emit", [(True, True), (True, False),
                                        (False, True), (False, False)])
@pytest.mark.parametrize("n,p,q", [(120, 256, 200), (100, 75, 48)])
def test_staggered_kernel_matches_b1(cuda, n, p, q, c_one, emit):
    """B4 against B1 on the card and against its plain version on the CPU,
    both at the f32 tolerances (B1 sums its products in one fused pass per
    block, B4 in two, so they no longer agree bit for bit)."""
    ops, block = _operands(n, p, q, 1.0 if c_one else 0.5)
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


def test_staggered_kernel_repeats_and_rejects(cuda):
    ops, block = _operands(120, 256, 200, 0.5)
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


def _fit(cfg, device, seed=123):
    """fit_global_local from the library's lower-level entry (how a caller
    reaches the B3 and B4 routes): prepare_data, elicitation, the model's
    builders."""
    y, x, _ = simulate_fixture()
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


@pytest.mark.parametrize("route", ["pallas", "stagger", "pallas_f64"])
def test_route_fit_on_the_card(cuda, route):
    """Each route on the card launches its kernel (B3 once per predictor
    block per iteration, B4 once per iteration, no B1) and agrees with the
    float64 CPU fit: float32 PIPs within 1e-2; float64 through B3 in the
    same iterations within 1e-6."""
    cfg = {"pallas": Config(sweep="pallas"),
           "stagger": Config(sweep_stagger=True),
           "pallas_f64": Config(dtype=torch.float64, use_pallas=True)}[route]
    sf.sweep_fused.launches = sp.inner_gs_pallas.launches = 0
    ss.sweep_fused_staggered.launches = 0
    res, gam = _fit(cfg, cuda)
    assert res.converged and sf.sweep_fused.launches == 0
    if route == "stagger":
        assert ss.sweep_fused_staggered.launches == res.it
    else:
        assert sp.inner_gs_pallas.launches == res.it  # p = 75: one block
    ref, ref_gam = _fit(Config(dtype=torch.float64), "cpu")
    if route == "pallas_f64":
        assert res.it == ref.it
        assert np.abs(gam - ref_gam).max() <= 1e-6
    else:
        assert np.abs(gam - ref_gam).max() <= 1e-2
