"""The two bf16 modes of the port's kernels, held against the JAX package:
Config.mxu_bf16 on B1 (ops/sweep_fused.py) and Config.mis_pair_bf16 on B2
(ops/sweep_missing_fused.py).  On the CPU the wrappers run the kernels'
plain versions; the CUDA instances are held against those on the card
(tests/test_torch_cuda.py, chip_smoke.py's bf16_modes phase).

Tolerances.
- B1 under mxu_bf16: F is rounded to bfloat16 before each projection, so a
  1-ulp float32 difference in F from the order of a sum can move one
  operand by 2^-8 relative; the maximum error is therefore not at float32
  grade, while the mean is.  Per output: mean |port - JAX bf16| <= 1/20 of
  mean |JAX f32 - JAX bf16| (the mode's own distance from float32; the
  ratio measured on these problems is far smaller), and max |port - JAX
  bf16| <= 2.5e-3 on beta, gam and mu.
- B2 under mis_pair_bf16: the rounded quantity, the float32 product of
  one sample row, is formed the same whatever the order of the sums, so
  B2's own tolerances hold (tests/test_torch_missing.py:_check_b2: gam
  atol 5e-5, the rest 5e-4) against the JAX kernel at the same window
  sub (Config.mis_sub), with the mean criterion above.
- Fits: PIPs within 5e-2 of the float32 fit, the JAX package's own bound
  for the mode (tests/test_pallas.py:test_fused_mxu_bf16_close_to_f32).
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from atlasqtl_tpu.types import Config as JConfig
from atlasqtl_tpu.models import global_local as jgl
from atlasqtl_tpu.inference import elicitation as jelic
from atlasqtl_tpu.io.prepare import prepare_data as jprepare
from atlasqtl_tpu.ops import sweep as jsw
from atlasqtl_tpu.ops.sweep_fused import sweep_complete_fused as j_fused
from atlasqtl_tpu.ops.sweep_missing_fused import sweep_missing_fused_driver

import atlasqtl_tpu_torch as at
from atlasqtl_tpu_torch import convert
from atlasqtl_tpu_torch.models import global_local as tgl
from atlasqtl_tpu_torch.ops import sweep as tsw
from atlasqtl_tpu_torch.ops import sweep_fused as tsf
from atlasqtl_tpu_torch.ops import sweep_missing_fused as tsm

from conftest import simulate_fixture
from test_torch_missing import OUT as MIS_OUT
from test_torch_missing import _check_b2, _consts, _jax_problem
from test_torch_sweep_fused import NAMES, _problem, _t

MEAN_RATIO = 20      # port's mean error <= the mode's mean distance / 20
MAX_COEF = 2.5e-3    # max error on beta, gam, mu
FIT_PIP = 5e-2       # a bf16 fit's PIPs against the float32 fit's


def _flat(out):
    return list(out[:6]) + list(out[6])


def _mean_criterion(got, ref, f32, names, max_names=("beta", "gam", "mu"),
                    floor=None):
    """Per output: mean |got - ref| <= mean |f32 - ref| / MEAN_RATIO (+ 2
    mean |port f32 - JAX f32| where `floor` gives those two output lists:
    the packages' own float32 distance), and max |got - ref| <= MAX_COEF
    on `max_names`.  Returns the ratios."""
    ratios = {}
    fps, fjs = floor if floor is not None else (got, got)  # none: 0
    for name, a, r, f, fp, fj in zip(names, got, ref, f32, fps, fjs):
        if r is None:
            assert a is None, name
            continue
        a, r, f = (np.asarray(v, np.float64) for v in (a, r, f))
        assert a.shape == r.shape, name
        err, mode = np.abs(a - r).mean(), np.abs(f - r).mean()
        lim = mode / MEAN_RATIO + 2 * _dist(fp, fj)[0]
        assert err <= lim, (name, err, mode, lim)
        if name in max_names:
            assert np.abs(a - r).max() <= MAX_COEF, (name,
                                                     np.abs(a - r).max())
        ratios[name] = mode / err if err else np.inf
    return ratios


_JAX_B1 = {}


def _jax_b1(c, emit, bf16):
    """The JAX fused kernel in interpret mode on `_problem(120, 128, c,
    32)`, once per (c, emit, bf16) for the module."""
    key = (c, emit, bf16)
    if key not in _JAX_B1:
        data, state, gram, consts = _problem(120, 128, c, 32)
        _JAX_B1[key] = j_fused(
            data.x, data.cp_x_y, gram, state.gam * state.mu_beta,
            state.fitted, consts, 32, p_mask=data.p_mask, q_mask=data.q_mask,
            q_tile=128, sub=32, qchunk=128, mxu_bf16=bf16, emit_gam_mu=emit,
            annealed=c != 1.0)
    return _JAX_B1[key]


def _port_b1(c, emit, bf16, x_bf16=False):
    data, state, gram, consts = _problem(120, 128, c, 32)
    tconsts = tsw.SweepConsts(*[_t(v) for v in consts])
    x = _t(data.x)
    return tsf.sweep_complete_fused(
        x, _t(data.cp_x_y), _t(gram), _t(state.gam * state.mu_beta),
        _t(state.fitted), tconsts, 32, p_mask=_t(data.p_mask),
        q_mask=_t(data.q_mask), emit_gam_mu=emit, annealed=c != 1.0,
        bf16=bf16, x_bf16=x.to(torch.bfloat16) if x_bf16 else None)


@pytest.mark.parametrize("emit", [True, False])
@pytest.mark.parametrize("c", [1.0, 0.5])
def test_b1_plain_bf16_matches_jax_kernel(c, emit):
    """`_problem(120, 128, c, 32)` (q padded to 128, 8 blocks of 32) at
    q_tile=128, sub=32, qchunk=128: the port's plain bf16 sweep against the
    JAX kernel with mxu_bf16=True, under the mean criterion."""
    got = _port_b1(c, emit, True, x_bf16=emit)
    assert tsf.sweep_fused.launches == 0  # CPU: the plain version
    ratios = _mean_criterion(_flat(got), _flat(_jax_b1(c, emit, True)),
                             _flat(_jax_b1(c, emit, False)), NAMES)
    assert min(ratios.values()) > MEAN_RATIO


def _dist(a, b):
    """(mean, max) of |a - b| in float64."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(d.mean()), float(d.max())


def c7_departure():
    """`_problem(120, 128, 1, 256)`: the port's bf16 sweep at block 256
    (two pieces of 128 in the kernel) against the JAX kernel's bf16 sweep
    at block 256, beside the mode's own distance from float32 in JAX there
    and the packages' float32 distance.  Returns the port's {bf16:
    outputs}, JAX's {bf16: outputs} and per output {"port_vs_jax", "mode",
    "f32_port_vs_jax"}, each (mean, max)."""
    data, state, gram256, consts = _problem(120, 128, 1.0, 256)
    kw = dict(p_mask=data.p_mask, q_mask=data.q_mask, q_tile=128, sub=32,
              qchunk=128, emit_gam_mu=True, annealed=False)
    beta = state.gam * state.mu_beta
    jax_at = {bf: _flat(j_fused(data.x, data.cp_x_y, gram256, beta,
                                state.fitted, consts, 256, mxu_bf16=bf, **kw))
              for bf in (False, True)}
    tconsts = tsw.SweepConsts(*[_t(v) for v in consts])
    port = {bf: _flat(tsf.sweep_complete_fused(
        _t(data.x), _t(data.cp_x_y), _t(gram256), _t(beta),
        _t(state.fitted), tconsts, 256, p_mask=_t(data.p_mask),
        q_mask=_t(data.q_mask), emit_gam_mu=True, bf16=bf))
        for bf in (False, True)}
    out = {name: dict(port_vs_jax=_dist(port[True][i], jax_at[True][i]),
                      mode=_dist(jax_at[False][i], jax_at[True][i]),
                      f32_port_vs_jax=_dist(port[False][i],
                                            jax_at[False][i]))
           for i, name in enumerate(NAMES) if port[True][i] is not None}
    return port, jax_at, out


def test_b1_bf16_block_over_128_matches_jax_kernel():
    """A block over 128 under mxu_bf16 is the JAX kernel's block: the
    port's block-256 sweep (projections against the block-start bf16 F,
    every in-block correction through the float32 Gram) against the JAX
    kernel's at block 256, under the mean criterion with the packages'
    float32 distance as its floor (z_col's is ~1/15 of the mode's there:
    the mode moves z_col less at block 256 than at 128) and the max
    bound (tests/bf16_departures.py prints the distances)."""
    port, jax_at, _ = c7_departure()
    _mean_criterion(port[True], jax_at[True], jax_at[False], NAMES,
                    floor=(port[False], jax_at[False]))


def test_b1_bf16_mode_rounds():
    """The mode is not a no-op: the port's bf16 and float32 plain sweeps
    differ by more than 1e-4 in mean |fitted|, and the bfloat16 copy of x
    (Data.x_bf16) gives the same sweep as x rounded on the fly."""
    f32 = _port_b1(1.0, True, False)
    b16 = _port_b1(1.0, True, True)
    assert np.abs(np.asarray(b16[3]) - np.asarray(f32[3])).mean() > 1e-4
    copy = _port_b1(1.0, True, True, x_bf16=True)
    for a, b in zip(_flat(b16), _flat(copy)):
        assert torch.equal(a, b)


def _iteration_problem():
    """tests/test_pallas.py:test_fused_mxu_bf16_close_to_f32's problem: n =
    120, p = 256, q = 48 padded to 128, block 128."""
    y, x, _ = simulate_fixture(n=120, p=256, p_act=8, q=48, seed=5)
    dat = jprepare(y, x, 0.1, 1000)
    p_eff, q_eff = dat.x.shape[1], dat.y.shape[1]
    jcfg = JConfig(dtype=jnp.float32, block_size=128,
                   shr_fac_inv=float(q_eff), sweep="fused")
    data = jgl.build_data(dat.x, dat.y, jcfg, q_pad_to=128)
    hyper = jgl.build_hyper(jelic.auto_set_hyper(dat.y, p_eff, (4, 16)),
                            data.y.shape[1], jcfg)
    state = jgl.build_state(
        jelic.auto_set_init(dat.y, p_eff, (4, 16), float(q_eff), 7), data,
        jcfg)
    return data, hyper, state, jcfg


def _arrays(obj):
    return {f.name: None if getattr(obj, f.name) is None
            else np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def test_one_cavi_iteration_bf16_matches_jax():
    """One cavi_iteration of each package with Config(dtype=float32,
    block_size=128, sweep="fused", mxu_bf16=True).  Per field: mean |port
    - JAX| <= 1/20 of the mode's mean distance from float32 in JAX, plus
    twice the packages' own float32 distance (mean |port f32 - JAX f32|):
    at this first iteration the mode moves some fields (gam ~5e-5, zeta,
    the pre-sweep updates not at all) less than float32 rounding between
    the packages does.  The mode's distance dominates where it is large:
    fitted and mu_beta, which it must move beyond that floor."""
    data, hyper, state, jcfg = _iteration_problem()
    gram = jsw.block_gram(data.x, 128)
    tdata = convert.data_from_numpy(_arrays(data), device="cpu")
    thyper = convert.hyper_from_numpy(_arrays(hyper), device="cpu")
    tstate = convert.state_from_numpy(_arrays(state), device="cpu")
    j, t = {}, {}
    for bf in (False, True):
        j[bf] = jgl.cavi_iteration(data, hyper, state, gram, 1.0, 1.0,
                                   cfg=dataclasses.replace(jcfg, mxu_bf16=bf),
                                   annealed=False)
        tcfg = at.Config(dtype=torch.float32, block_size=128, sweep="fused",
                         mxu_bf16=bf, shr_fac_inv=jcfg.shr_fac_inv)
        t[bf] = tgl.cavi_iteration(tdata, thyper, tstate,
                                   tsw.block_gram(tdata.x, 128), 1.0, 1.0,
                                   cfg=tcfg, annealed=False)
    for f in dataclasses.fields(t[True]):
        r = getattr(j[True], f.name)
        if r is None:
            continue
        get = lambda s: np.asarray(getattr(s, f.name), np.float64)
        a, r, jf, tf = get(t[True]), get(j[True]), get(j[False]), get(t[False])
        mode, floor = np.abs(jf - r).mean(), np.abs(tf - jf).mean()
        assert np.abs(a - r).mean() <= mode / MEAN_RATIO + 2 * floor, f.name
        if f.name in ("fitted", "mu_beta"):
            assert mode > MEAN_RATIO * 2 * floor, f.name


_JAX_B2 = {}


def _jax_b2(c, sub, pair_bf16):
    """The JAX exact-missing kernel in interpret mode on `_b2_problem(c)` at
    window `sub`, wgroup=4 (fewer where the block holds fewer windows; it
    does not change the function), once per (c, sub, pair_bf16) for the
    module."""
    key = (c, sub, pair_bf16)
    if key not in _JAX_B2:
        data, state, consts, sig2_inv = _b2_problem(c)
        jc = jsw.SweepConsts(**{k: jnp.asarray(v) for k, v in consts.items()})
        _JAX_B2[key] = sweep_missing_fused_driver(
            data.x, data.cp_x_y, data.x_norm_sq, data.mis_pat, state.gam,
            state.mu_beta, state.fitted, jc, jnp.asarray(sig2_inv), 128,
            p_mask=data.p_mask, q_mask=data.q_mask, q_tile=256, sub=sub,
            wgroup=min(4, 128 // sub), pair_bf16=pair_bf16, qchunk=256)
    return _JAX_B2[key]


def _b2_operands(data, state, consts, sig2_inv):
    tc = tsw.SweepConsts(**{k: _t(v) for k, v in consts.items()})
    d = {k: _t(v) for k, v in _arrays(data).items() if v is not None}
    return tsm.missing_fused_operands(
        d["x"], d["cp_x_y"], d["x_norm_sq"], d["mis_pat"], _t(state.gam),
        _t(state.mu_beta), _t(state.fitted), tc, _t(sig2_inv), d["p_mask"],
        d["q_mask"])


def _b2_problem(c):
    """tests/test_torch_missing.py:test_b2_plain_matches_jax_kernel's
    problem (n=80, p=250, q=40 padded to 256, 20% missing)."""
    data, _, state, _, _ = _jax_problem(jnp.float32, n=80, p=250, q=40,
                                        seed=7, mis_block=16, q_pad_to=256)
    consts, sig2_inv = _consts(data, state, c, np.float32)
    return data, state, consts, sig2_inv


def _b2_masked(out, data):
    """JAX's B2 outputs with gam and mu masked as the port writes them."""
    msk = np.asarray(data.p_mask)[:, None] * np.asarray(data.q_mask)[None, :]
    return [np.asarray(v, np.float64) * (msk if name in ("gam", "mu") else 1)
            for name, v in zip(MIS_OUT, out)]


def _b2_port(c, pair_bf16, **sub):
    data, state, consts, sig2_inv = _b2_problem(c)
    return tsm.sweep_missing_fused(*_b2_operands(data, state, consts,
                                                 sig2_inv),
                                   block_size=128, pair_bf16=pair_bf16, **sub)


def _b2_held_to_jax(c, jax_sub, **port_sub):
    """The port's plain pair_bf16 sweep (window `port_sub`, default the
    wrapper's) against the JAX kernel's at window `jax_sub`: within B2's
    tolerances and under the mean criterion, while the port's float32
    sweep fails B2's tolerances there (the mode moves the result past
    them, so they separate it).  Returns the mean-criterion ratios."""
    data = _b2_problem(c)[0]
    msk = np.asarray(data.p_mask)[:, None] * np.asarray(data.q_mask)[None, :]
    ref = _jax_b2(c, jax_sub, True)
    got, f32 = _b2_port(c, True, **port_sub), _b2_port(c, False)
    _check_b2(got, ref, msk)
    with pytest.raises(AssertionError):
        _check_b2(f32, ref, msk)
    ratios = _mean_criterion(got, _b2_masked(ref, data), f32, MIS_OUT,
                             max_names=())
    assert min(ratios.values()) > MEAN_RATIO
    return ratios


@pytest.mark.parametrize("c", [1.0, 0.5])
def test_b2_plain_pair_bf16_matches_jax_kernel(c):
    """The windowed plain sweep with bf16 pair products at the wrapper's
    default window (16, Config.mis_sub's default) against the JAX kernel
    in interpret mode with pair_bf16=True at its default sub=16, wgroup=4,
    within B2's tolerances and under the mean criterion."""
    _b2_held_to_jax(c, 16)


@pytest.mark.parametrize("sub", [16, 8, 4, 32, 128])
@pytest.mark.parametrize("c", [1.0, 0.5])
def test_b2_plain_pair_bf16_matches_jax_at_mis_sub(c, sub):
    """C6 and C6b, repaired: at each window sub the port's plain pair_bf16
    sweep is the JAX kernel's at that sub (B2's tolerances and the mean
    criterion); the windows decide which corrections are rounded, so at
    another sub the port fails B2's tolerances against it
    (tests/bf16_departures.py prints the distances)."""
    _b2_held_to_jax(c, sub, sub=sub)
    data = _b2_problem(c)[0]
    msk = np.asarray(data.p_mask)[:, None] * np.asarray(data.q_mask)[None, :]
    other = 8 if sub == 16 else 16
    with pytest.raises(AssertionError):
        _check_b2(_b2_port(c, True, sub=other), _jax_b2(c, sub, True), msk)


def test_c6b_sixteen_windows_fail_at_32():
    """C6b's evidence: the port's sweep in windows of 16, all it took
    before, fails B2's tolerances against the JAX kernel at mis_sub = 32
    (as the 8-windows failed against 16 in C6)."""
    data = _b2_problem(1.0)[0]
    msk = np.asarray(data.p_mask)[:, None] * np.asarray(data.q_mask)[None, :]
    with pytest.raises(AssertionError):
        _check_b2(_b2_port(1.0, True, sub=16), _jax_b2(1.0, 32, True), msk)


def c6_distances(c):
    """The port's pair_bf16 sweep on `_b2_problem(c)` against the JAX
    kernel's with pair_bf16 at sub = 16, 8 and 4, each at the same sub,
    beside the mode's own distance from float32 in JAX at sub = 16.  Per
    sub and output: {"port_vs_jax", "mode"}, each (mean, max)."""
    data = _b2_problem(c)[0]
    f16 = _b2_masked(_jax_b2(c, 16, False), data)
    out = {}
    for sub in (16, 8, 4):
        got = _b2_port(c, True, sub=sub)
        ref = _b2_masked(_jax_b2(c, sub, True), data)
        out[sub] = {name: dict(port_vs_jax=_dist(got[i], ref[i]),
                               mode=_dist(f16[i], ref[i]))
                    for i, name in enumerate(MIS_OUT)}
    return out


def test_pair_window_follows_the_jax_kernel():
    """The window is mis_sub clipped to the block, as the JAX kernel clips
    it; one that does not divide the block raises ValueError (the JAX
    kernel's assert).  Every power of two up to the block is taken (C6b
    repaired: 32, 64 and 128 at block 128 raised NotImplementedError
    before); a window that is not one raises NotImplementedError, which a
    fit cannot reach (the mode reaches B2 only at block 128).
    check_config accepts every window the mode takes at block 128 and
    raises the same ValueError, and the sweep raises before it runs."""
    assert [tsm.pair_window(s, 128) for s in (1, 2, 4, 8, 16, 32, 64, 128)] \
        == [1, 2, 4, 8, 16, 32, 64, 128]
    assert tsm.pair_window(16, 8) == 8 and tsm.pair_window(16, 80) == 16
    assert tsm.pair_window(256, 128) == 128
    for sub, block in ((16, 120), (16, 40), (3, 128), (8, 12), (48, 128)):
        with pytest.raises(ValueError, match="must divide"):
            tsm.pair_window(sub, block)
    with pytest.raises(NotImplementedError, match="power of two"):
        tsm.pair_window(12, 96)
    tgl.check_config(at.Config(mis_pair_bf16=True))
    tgl.check_config(at.Config(mis_sub=24))   # float32: mis_sub is ignored
    tgl.check_config(at.Config(mis_pair_bf16=True, mis_sub=24,
                               block_size=256))   # the flag is ignored
    for sub in (32, 64, 128):
        tgl.check_config(at.Config(mis_pair_bf16=True, mis_sub=sub))
    with pytest.raises(ValueError, match="must divide"):
        tgl.check_config(at.Config(mis_pair_bf16=True, mis_sub=24))
    ops = _b2_operands(*_b2_problem(1.0))
    with pytest.raises(ValueError, match="must divide"):
        tsm.sweep_missing_fused(*ops, block_size=128, pair_bf16=True, sub=48)
    # float32 ignores the window
    tsm.sweep_missing_fused(*ops, block_size=128, sub=48)


@pytest.mark.parametrize("c", [1.0, 0.5])
def test_windowed_plain_f32_matches_per_coordinate(c):
    """The windowed plain branch without rounding is the per-coordinate
    plain sweep up to float32 rounding (B2's tolerances): the windows,
    pair Grams and window advances are right."""
    data, state, consts, sig2_inv = _b2_problem(c)
    ops = _b2_operands(data, state, consts, sig2_inv)
    win = tsm._sweep_missing_plain_windows(*ops, block_size=128,
                                           round_pairs=False)
    one = tsm._sweep_missing_plain_one(*ops, block_size=128)
    msk = np.asarray(data.p_mask)[:, None] * np.asarray(data.q_mask)[None, :]
    _check_b2(win, one, msk)


def _replicas(operands, ops, m=2, seed=0):
    """m replicas of the operands `ops` (an `Operands` list): each operand
    of the state but the 0-d ones scaled per replica by a seeded factor."""
    rng = np.random.default_rng(seed)
    parts = []
    for r in range(m):
        f = 1.0 + 0.05 * r * rng.standard_normal()
        parts.append([o * f if k in operands.state and o.dim() > 0 else o
                      for k, o in zip(operands.names, ops)])
    return parts


def test_b1_bf16_replica_axis():
    """Plain B1-bf16 with m = 2 replicas stacked equals each replica swept
    alone, bit for bit."""
    data, state, gram, consts = _problem(120, 128, 0.5, 32)
    tconsts = tsw.SweepConsts(*[_t(v) for v in consts])
    ops = list(tsf.fused_operands(
        _t(data.x), _t(data.cp_x_y), _t(gram),
        _t(state.gam * state.mu_beta), _t(state.fitted), tconsts, 32,
        _t(data.p_mask), _t(data.q_mask)))
    ops[0] = tsf.bf16_operand(ops[0])
    parts = _replicas(tsf.FUSED, ops)
    kw = dict(block_size=32, emit_gam_mu=True, c_one=False, bf16=True)
    both = tsf.sweep_fused(*tsf.FUSED.stack(parts), **kw)
    for r, part in enumerate(parts):
        one = tsf.sweep_fused(*part, **kw)
        for a, b in zip(_flat(both), _flat(one)):
            assert torch.equal(a[r], b)


def test_b2_pair_bf16_replica_axis():
    """Plain B2-pair-bf16 with m = 2 replicas stacked equals each replica
    swept alone, bit for bit."""
    ops = _b2_operands(*_b2_problem(0.5))
    parts = _replicas(tsm.MISSING, ops)
    kw = dict(block_size=128, pair_bf16=True)
    both = tsm.sweep_missing_fused(*tsm.MISSING.stack(parts), **kw)
    for r, part in enumerate(parts):
        one = tsm.sweep_missing_fused(*part, **kw)
        for a, b in zip(both, one):
            assert torch.equal(a[r], b)


def _port_problem(missing_frac=0.0, seed=5, p=75):
    y, x, _ = simulate_fixture(n=100, p=p, p_act=8, q=20, seed=seed,
                               missing_frac=missing_frac)
    return y, x


def _port_iteration(cfg, missing_frac=0.0, p=75, q_pad_to=8):
    """One cavi_iteration of the port on the CPU from a host draw at
    n = 100, q = 20 (padded to a multiple of `q_pad_to`) and `p`
    predictors: the returned state's fields."""
    from atlasqtl_tpu_torch.io.prepare import prepare_data
    from atlasqtl_tpu_torch.inference import elicitation as elic
    y, x = _port_problem(missing_frac, p=p)
    dat = prepare_data(y, x, 0.1, 1000, 1, 0)
    p, q = dat.x.shape[1], dat.y.shape[1]
    cfg = dataclasses.replace(cfg, shr_fac_inv=float(q))
    data = tgl.build_data(dat.x, dat.y, cfg, "cpu", q_pad_to=q_pad_to)
    hyper = tgl.build_hyper(elic.auto_set_hyper(dat.y, p, (5, 25)),
                            data.y.shape[1], cfg, "cpu")
    state = tgl.build_state(elic.auto_set_init(dat.y, p, (5, 25), float(q),
                                               1), data, cfg)
    gram = tsw.block_gram(data.x, tgl.data_block(cfg, data))
    out = tgl.cavi_iteration(data, hyper, state, gram, 0.5, 0.5, cfg=cfg,
                             annealed=True)
    return data, out


@pytest.mark.parametrize("route,missing", [
    (dict(sweep_stagger=True, sweep="fused"), 0.0),    # B4
    (dict(sweep="pallas"), 0.0),                       # B3
    (dict(sweep="xla"), 0.0),                          # the plain sweep
    (dict(sweep="auto", dtype=torch.float64), 0.0),    # float64, plain
    (dict(sweep="xla"), 0.15),                         # exact: blocked
])
def test_bf16_flags_leave_other_engines_alone(route, missing):
    """mxu_bf16 and mis_pair_bf16 reach B1 and B2 only: every other engine
    gives its sweep bit for bit as without them, and no bf16 copy of x is
    made for it."""
    base = at.Config(**{"dtype": torch.float32, **route})
    flags = dataclasses.replace(base, mxu_bf16=True, mis_pair_bf16=True)
    tgl.check_config(flags)
    d0, s0 = _port_iteration(base, missing)
    d1, s1 = _port_iteration(flags, missing)
    assert d1.x_bf16 is None
    for f in dataclasses.fields(s0):
        a, b = getattr(s0, f.name), getattr(s1, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            assert torch.equal(a, b), f.name


def test_bf16_flags_reach_b1_and_b2():
    """On sweep="fused" the flags change the iteration (B1 under
    mxu_bf16, with its bf16 copy of x made once in build_data; B2 under
    mis_pair_bf16, at p = 250, whose padded p, 256, is a multiple of 128,
    as the JAX package's fused kernel needs: `_b2_pair_bf16`), at q padded
    to 128, where the JAX package's fused kernels find a q tile."""
    cfg = at.Config(dtype=torch.float32, sweep="fused")
    for missing, flag, p in ((0.0, "mxu_bf16", 75),
                             (0.15, "mis_pair_bf16", 250)):
        _, s0 = _port_iteration(cfg, missing, p, q_pad_to=128)
        d1, s1 = _port_iteration(dataclasses.replace(cfg, **{flag: True}),
                                 missing, p, q_pad_to=128)
        assert (d1.x_bf16 is not None) == (flag == "mxu_bf16")
        if d1.x_bf16 is not None:
            assert d1.x_bf16.dtype == torch.bfloat16
            assert torch.equal(d1.x_bf16, d1.x.to(torch.bfloat16))
        assert not torch.equal(s0.gam, s1.gam), flag


@pytest.mark.parametrize("block,p,reaches", [(256, 75, False),
                                             (64, 75, False),
                                             (128, 75, False),
                                             (128, 250, True)])
def test_c9_pair_bf16_reaches_b2_only_at_block_128(block, p, reaches):
    """C9: under Config(mis_pair_bf16=True, sweep="fused") one
    cavi_iteration on the CPU is the iteration without the flag, bit for
    bit, wherever the JAX package would not take its fused kernel: block
    256 and 64 (p = 75 pads to 80 and 128), and block 128 at p = 75
    (padded to 80, not a multiple of 128).  At block 128 with p = 250
    (padded to 256) the flag reaches B2 and the iteration differs.  q is
    padded to 128, where the JAX kernel finds its q tile (C10), so that
    only the block rule decides."""
    cfg = at.Config(dtype=torch.float32, sweep="fused", block_size=block)
    flag = dataclasses.replace(cfg, mis_pair_bf16=True)
    d0, s0 = _port_iteration(cfg, 0.15, p, q_pad_to=128)
    d1, s1 = _port_iteration(flag, 0.15, p, q_pad_to=128)
    assert tgl._engine(flag, d1) == "b2"
    assert tgl._b2_pair_bf16(flag, d1) == reaches
    same = [torch.equal(getattr(s0, f.name), getattr(s1, f.name))
            for f in dataclasses.fields(s0) if getattr(s0, f.name) is not None]
    assert all(same) != reaches


def _fit(cfg, missing_frac, seed=5, p=75, q_pad_to=8):
    from atlasqtl_tpu_torch.io.prepare import prepare_data
    from atlasqtl_tpu_torch.inference import elicitation as elic
    from atlasqtl_tpu_torch.inference.driver import fit_global_local
    y, x = _port_problem(missing_frac, seed, p=p)
    dat = prepare_data(y, x, 0.1, 1000, 1, 0)
    p, q = dat.x.shape[1], dat.y.shape[1]
    cfg = dataclasses.replace(cfg, shr_fac_inv=float(q))
    data = tgl.build_data(dat.x, dat.y, cfg, "cpu", q_pad_to=q_pad_to)
    hyper = tgl.build_hyper(elic.auto_set_hyper(dat.y, p, (5, 25)),
                            data.y.shape[1], cfg, "cpu")
    state = tgl.build_state(elic.auto_set_init(dat.y, p, (5, 25), float(q),
                                               1), data, cfg)
    res = fit_global_local(data, hyper, state, cfg, anneal=(1, 2, 5),
                           verbose=0)
    return res, res.state.gam[:p, :q].double().numpy()


@pytest.mark.parametrize("flag,missing", [("mxu_bf16", None),
                                          ("mxu_bf16", "impute"),
                                          ("mis_pair_bf16", "exact")])
def test_small_bf16_fit_converges_near_f32(flag, missing):
    """A small fit (n=100, p=75, q=20 padded to 128, where the flags reach
    their kernels; 15% NaN for the missing modes; p = 250 under
    mis_pair_bf16, which reaches B2 only where the padded p is a multiple
    of 128) on sweep="fused" in each mode converges, its PIPs within 5e-2
    of the float32 fit's from the same initial state."""
    frac = 0.0 if missing is None else 0.15
    p = 250 if flag == "mis_pair_bf16" else 75
    cfg = at.Config(dtype=torch.float32, sweep="fused",
                    missing=missing or "exact")
    ref, ref_gam = _fit(cfg, frac, p=p, q_pad_to=128)
    res, gam = _fit(dataclasses.replace(cfg, **{flag: True}), frac, p=p,
                    q_pad_to=128)
    assert ref.converged and res.converged
    assert np.isfinite(gam).all()
    assert np.abs(gam - ref_gam).max() <= FIT_PIP


# ------------------------------------------------ C10: the q-tile routing

def _spy(monkeypatch, mod, name, key):
    """Record the keyword `key` of every call of mod.name (a plain version
    of a kernel, which the CPU wrappers look up at call time)."""
    calls = []
    orig = getattr(mod, name)

    def spy(*a, **kw):
        calls.append(kw.get(key))
        return orig(*a, **kw)
    monkeypatch.setattr(mod, name, spy)
    return calls


def _same_iteration(s0, s1):
    return all(torch.equal(getattr(s0, f.name), getattr(s1, f.name))
               for f in dataclasses.fields(s0)
               if getattr(s0, f.name) is not None)


@pytest.mark.parametrize("q_pad", [24, 504, 128, 256])
@pytest.mark.parametrize("flag", ["mxu_bf16", "mis_pair_bf16"])
def test_c10_bf16_flags_reach_only_at_a_q_tile(monkeypatch, flag, q_pad):
    """C10: on sweep="fused" (q = 20 padded to q_pad) mxu_bf16 and
    mis_pair_bf16 reach their kernels' plain versions only where the JAX
    package's fused kernels find a q tile (models/global_local.py:
    fused_q_tile, mis_fused_q_tile: a padded q that is a multiple of 128).
    At 24 and 504 the iteration is the one without the flag, bit for bit,
    and no bf16 copy of x is built; at 128 and 256 B1 runs its bf16 mode
    (B2 its pair_bf16 mode at p = 250) and the iteration differs."""
    missing, p = (0.0, 75) if flag == "mxu_bf16" else (0.15, 250)
    reaches = q_pad % 128 == 0
    cfg = at.Config(dtype=torch.float32, sweep="fused")
    q_pad_to = 8 if q_pad == 24 else q_pad
    _, s0 = _port_iteration(cfg, missing, p, q_pad_to=q_pad_to)
    if flag == "mxu_bf16":
        calls = _spy(monkeypatch, tsf, "sweep_fused_plain", "bf16")
    else:
        calls = _spy(monkeypatch, tsm, "sweep_missing_fused_plain",
                     "pair_bf16")
    flagged = dataclasses.replace(cfg, **{flag: True})
    d1, s1 = _port_iteration(flagged, missing, p, q_pad_to=q_pad_to)
    assert d1.y.shape[1] == q_pad
    assert d1.x_bf16 is None if not reaches or flag != "mxu_bf16" \
        else d1.x_bf16.dtype == torch.bfloat16
    assert calls == [reaches]
    assert _same_iteration(s0, s1) != reaches


@pytest.mark.parametrize("q_pad,engine", [(384, "b1"), (512, "b4")])
def test_c10_stagger_takes_b4_from_a_tile_of_256(monkeypatch, q_pad, engine):
    """C10: Config(sweep_stagger=True, mxu_bf16=True) on sweep="fused" runs
    B4 only where the JAX package's fused tile is at least 256
    (atlasqtl_tpu/models/global_local.py:555-557): at padded q 384 (tile
    128) B1 runs, in its bf16 mode, as JAX's fused kernel does; at 512
    (tile 512) B4 runs and mxu_bf16 leaves its iteration as it is."""
    from atlasqtl_tpu_torch.ops import sweep_staggered as tss
    cfg = at.Config(dtype=torch.float32, sweep="fused", sweep_stagger=True,
                    mxu_bf16=True)
    _, s0 = _port_iteration(dataclasses.replace(cfg, mxu_bf16=False),
                            q_pad_to=q_pad)
    b1 = _spy(monkeypatch, tsf, "sweep_fused_plain", "bf16")
    b4 = _spy(monkeypatch, tss, "sweep_staggered_plain", "block_size")
    d1, s1 = _port_iteration(cfg, q_pad_to=q_pad)
    assert tgl._engine(cfg, d1) == engine
    if engine == "b1":
        assert b1 == [True] and b4 == [] and d1.x_bf16 is not None
        assert not _same_iteration(s0, s1)
    else:
        assert b1 == [] and len(b4) == 1 and d1.x_bf16 is None
        assert _same_iteration(s0, s1)


def test_c10_q_tiles_are_the_jax_packages():
    """The port's copies of the JAX package's q-tile rules give its tiles
    (atlasqtl_tpu/models/global_local.py:_fused_q_tile,
    _mis_fused_q_tile) over padded n from 8 to 200k and padded q from 8 to
    20480: a multiple of 128, and for the staggered kernel's 256 a
    multiple of 256 up to n ~ 91k."""
    for n in (8, 104, 1000, 5000, 50000, 91104, 91112, 92000, 200000):
        for q in (8, 24, 128, 256, 384, 504, 512, 1024, 10000, 10240,
                  20480):
            assert tgl.fused_q_tile(n, q) == jgl._fused_q_tile(n, q), (n, q)
            assert tgl.mis_fused_q_tile(n, q) == \
                jgl._mis_fused_q_tile(n, q), (n, q)
    assert tgl.fused_q_tile(91104, 512) == 256
    assert tgl.fused_q_tile(92000, 512) == 128


@pytest.mark.parametrize("q_shards,tile", [(1, 512), (2, 256), (4, 128),
                                           (8, None)])
def test_c10_mesh_predicate_takes_the_shard_q(q_shards, tile):
    """C10 on a 1-D mesh: the flags' predicates take the per-shard q, as
    atlasqtl_tpu/models/global_local.py:418-421 does: q padded to 512 over
    1, 2, 4 or 8 shards leaves 512, 256, 128 or 64 columns per shard, and
    the last has no tile; build_data(q_shards=) then builds x_bf16 and
    goff only where the flags reach.  sweep_stagger never selects B4 under
    a mesh.  A unit test of the predicates: no mesh processes."""
    from atlasqtl_tpu_torch.parallel.mesh import Q_AXIS
    cfg = at.Config(dtype=torch.float32, sweep="fused", mxu_bf16=True,
                    sweep_lookahead=True, sweep_stagger=True, q_axis=Q_AXIS)
    n, q_local = 104, 512 // q_shards
    assert tgl.fused_q_tile(n, q_local) == tile
    assert tgl._b1_bf16(cfg, "cpu", n, q_local) == (tile is not None)
    assert tgl._b1_lookahead(cfg, "cpu", n, q_local) == (tile is not None)
    assert not tgl._stagger(cfg, n, q_local)
    y, x = _port_problem()
    y = np.concatenate([y] * 25, axis=1)[:, :500]
    data = tgl.build_data(x, y, cfg, "cpu", q_pad_to=128, q_shards=q_shards)
    assert data.x.shape[0] == n and data.y.shape[1] == 512
    assert (data.x_bf16 is not None) == (tile is not None)
    assert (data.goff is not None) == (tile is not None)
