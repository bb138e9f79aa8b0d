"""The lookahead schedule of B1's bf16 instance, Config(mxu_bf16=True,
sweep_lookahead=True), held against the JAX package's fused kernel with
mxu_bf16=True, lookahead=True in interpret mode (atlasqtl_tpu/ops/
sweep_fused.py:166-184, 378-388).  On the CPU the port's wrappers run the
plain version (ops/sweep_fused.py:sweep_fused_plain); the kernel's
lookahead variant is held against that on the card (tests/
test_torch_cuda.py, chip_smoke.py's bf16_modes phase).

Under bf16 the schedule is another function: block b >= 1 projects the
bf16 F from before block b-1's advance and takes block b-1's float32
deltas through the float32 off-diagonal Gram x_b^T x_{b-1}.  In float32 it
is the baseline's algebra up to rounding, and the port ignores the flag.

Tolerances are tests/test_torch_bf16.py's: per output, mean |port - JAX|
<= 1/20 of the mode's own mean distance from JAX float32 (plus twice the
packages' float32 distance where named), and max |port - JAX| <= 2.5e-3
on beta, gam and mu; the float32 comparison takes tests/test_pallas.py:
test_fused_lookahead_matches_baseline's (beta, gam, fitted 5e-5; z_row,
z_col 5e-4).
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from atlasqtl_tpu.models import global_local as jgl
from atlasqtl_tpu.ops import sweep as jsw
from atlasqtl_tpu.ops.sweep_fused import sweep_complete_fused as j_fused

import atlasqtl_tpu_torch as at
from atlasqtl_tpu_torch import convert
from atlasqtl_tpu_torch.models import global_local as tgl
from atlasqtl_tpu_torch.ops import sweep as tsw
from atlasqtl_tpu_torch.ops import sweep_fused as tsf

from test_torch_bf16 import (MEAN_RATIO, _arrays, _flat, _iteration_problem,
                             _mean_criterion, _port_iteration, _replicas)
from test_torch_sweep_fused import NAMES, _problem, _t

_JAX = {}


def _jax(c, emit, bf16, lookahead, block=32):
    """The JAX fused kernel in interpret mode on `_problem(120, 128, c,
    block)` at q_tile=128, sub=32, qchunk=128, once per argument set for
    the module."""
    key = (c, emit, bf16, lookahead, block)
    if key not in _JAX:
        data, state, gram, consts = _problem(120, 128, c, block)
        _JAX[key] = _flat(j_fused(
            data.x, data.cp_x_y, gram, state.gam * state.mu_beta,
            state.fitted, consts, block, p_mask=data.p_mask,
            q_mask=data.q_mask, q_tile=128, sub=32, qchunk=128,
            mxu_bf16=bf16, lookahead=lookahead, emit_gam_mu=emit,
            annealed=c != 1.0))
    return _JAX[key]


def _port(c, emit, bf16, lookahead, block=32, x_bf16=False):
    data, state, gram, consts = _problem(120, 128, c, block)
    tconsts = tsw.SweepConsts(*[_t(v) for v in consts])
    x = _t(data.x)
    return _flat(tsf.sweep_complete_fused(
        x, _t(data.cp_x_y), _t(gram), _t(state.gam * state.mu_beta),
        _t(state.fitted), tconsts, block, p_mask=_t(data.p_mask),
        q_mask=_t(data.q_mask), emit_gam_mu=emit, annealed=c != 1.0,
        bf16=bf16, x_bf16=x.to(torch.bfloat16) if x_bf16 else None,
        lookahead=lookahead))


@pytest.mark.parametrize("emit", [True, False])
@pytest.mark.parametrize("c", [1.0, 0.5])
def test_b1_plain_bf16_lookahead_matches_jax_kernel(c, emit):
    """`_problem(120, 128, c, 32)` (q padded to 128, 8 blocks of 32): the
    port's plain bf16 sweep with lookahead against the JAX kernel with
    mxu_bf16=True, lookahead=True, under the mean criterion (the mode's
    distance: JAX float32 from JAX bf16 lookahead) and the max bound."""
    got = _port(c, emit, True, True, x_bf16=emit)
    assert tsf.sweep_fused.launches == 0  # CPU: the plain version
    ratios = _mean_criterion(got, _jax(c, emit, True, True),
                             _jax(c, emit, False, False), NAMES)
    assert min(ratios.values()) > MEAN_RATIO


@pytest.mark.parametrize("c", [1.0, 0.5])
def test_c8_sweep_without_lookahead_fails_the_criterion(c):
    """C8, what the flag repairs: the port's bf16 sweep without the
    lookahead schedule (what it ran under the flag before) fails the same
    criterion against JAX's lookahead output, and passes it against JAX's
    sweep without lookahead."""
    ref, f32 = _jax(c, True, True, True), _jax(c, True, False, False)
    base = _port(c, True, True, False)
    with pytest.raises(AssertionError):
        _mean_criterion(base, ref, f32, NAMES)
    _mean_criterion(base, _jax(c, True, True, False), f32, NAMES)


def test_b1_bf16_lookahead_block_over_128_matches_jax_kernel():
    """A block over 128 under the lookahead is JAX's whole block (the
    kernel walks it in pieces of 128): `_problem(120, 128, 1, 256)`, the
    port's block-256 plain sweep with lookahead against JAX's with
    lookahead at block 256, under the mean criterion with the packages'
    float32 distance as its floor, and the max bound."""
    got = _port(1.0, True, True, True, block=256)
    ref = _jax(1.0, True, True, True, block=256)
    f32 = _jax(1.0, True, False, False, block=256)
    _mean_criterion(got, ref, f32, NAMES,
                    floor=(_port(1.0, True, False, False, block=256), f32))


def test_one_cavi_iteration_bf16_lookahead_matches_jax():
    """One cavi_iteration of each package with Config(dtype=float32,
    block_size=128, sweep="fused", mxu_bf16=True, sweep_lookahead=True)
    (n = 120, p = 256, q = 48 padded to 128): per field, mean |port - JAX|
    <= 1/20 of the mode's mean distance from float32 in JAX plus twice the
    packages' own float32 distance, as
    tests/test_torch_bf16.py:test_one_cavi_iteration_bf16_matches_jax;
    fitted and mu_beta move beyond that floor."""
    data, hyper, state, jcfg = _iteration_problem()
    gram = jsw.block_gram(data.x, 128)
    tdata = convert.data_from_numpy(_arrays(data), device="cpu")
    thyper = convert.hyper_from_numpy(_arrays(hyper), device="cpu")
    tstate = convert.state_from_numpy(_arrays(state), device="cpu")
    j, t = {}, {}
    for bf in (False, True):
        j[bf] = jgl.cavi_iteration(
            data, hyper, state, gram, 1.0, 1.0,
            cfg=dataclasses.replace(jcfg, mxu_bf16=bf, sweep_lookahead=bf),
            annealed=False)
        tcfg = at.Config(dtype=torch.float32, block_size=128, sweep="fused",
                         mxu_bf16=bf, sweep_lookahead=bf,
                         shr_fac_inv=jcfg.shr_fac_inv)
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


def test_b1_bf16_lookahead_replica_axis():
    """Plain B1-bf16 with lookahead, m = 2 replicas stacked (goff shared)
    equals each replica swept alone, bit for bit; a replica axis on goff
    is refused."""
    data, state, gram, consts = _problem(120, 128, 0.5, 32)
    tconsts = tsw.SweepConsts(*[_t(v) for v in consts])
    ops = list(tsf.fused_operands(
        _t(data.x), _t(data.cp_x_y), _t(gram),
        _t(state.gam * state.mu_beta), _t(state.fitted), tconsts, 32,
        _t(data.p_mask), _t(data.q_mask)))
    goff = tsf.lookahead_gram(ops[0], 32)
    ops[0] = tsf.bf16_operand(ops[0])
    parts = _replicas(tsf.FUSED, ops)
    kw = dict(block_size=32, emit_gam_mu=True, c_one=False, bf16=True,
              lookahead=True)
    both = tsf.sweep_fused(*tsf.FUSED.stack(parts), goff, **kw)
    for r, part in enumerate(parts):
        one = tsf.sweep_fused(*part, goff, **kw)
        for a, b in zip(_flat(both), _flat(one)):
            assert torch.equal(a[r], b)
    with pytest.raises(ValueError, match="never on"):
        tsf.sweep_fused(*tsf.FUSED.stack(parts), torch.stack([goff, goff]),
                        **kw)


@pytest.mark.parametrize("block", [32, 128])
def test_lookahead_gram_matches_jax_einsum(block):
    """ops/sweep_fused.py:lookahead_gram against the JAX kernel wrapper's
    own expression (atlasqtl_tpu/ops/sweep_fused.py:570-574), stacked to
    (p, B): goff[b] = x_{b+1}^T x_b, the last block zero, float32, to
    1e-6 of its largest entry (the sums run in another order)."""
    data = _problem(120, 128, 1.0, block)[0]
    n, p = data.x.shape
    nb = p // block
    xr = data.x.reshape(n, nb, block)
    ref = jnp.einsum("nkj,nki->kji", xr[:, 1:], xr[:, :-1],
                     preferred_element_type=data.x.dtype)
    ref = np.asarray(jnp.concatenate(
        [ref, jnp.zeros((1, block, block), ref.dtype)], axis=0)).reshape(
            p, block)
    got = tsf.lookahead_gram(_t(data.x), block)
    assert got.dtype == torch.float32 and tuple(got.shape) == (p, block)
    assert torch.equal(got[p - block:], torch.zeros(block, block))
    np.testing.assert_allclose(got.numpy(), ref,
                               atol=1e-6 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("c", [1.0, 0.5])
def test_f32_lookahead_is_the_baseline(c):
    """In float32 the flag changes nothing in the port (its sweep is the
    baseline's, which JAX's float32 lookahead equals up to rounding): the
    port's float32 sweep stays within tests/test_pallas.py:
    test_fused_lookahead_matches_baseline's tolerances of JAX's float32
    lookahead sweep, and a float32 iteration on sweep="fused" is bit for
    bit the same with and without the flag, with no goff built (block 32:
    p = 75 in three blocks)."""
    got, ref = _port(c, True, False, False), _jax(c, True, False, True)
    for i, name, tol in ((0, "beta", 5e-5), (1, "gam", 5e-5),
                         (3, "fitted", 5e-5), (4, "z_row", 5e-4),
                         (5, "z_col", 5e-4)):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]),
                                   atol=tol, err_msg=name)
    base = at.Config(dtype=torch.float32, sweep="fused", block_size=32)
    d0, s0 = _port_iteration(base)
    d1, s1 = _port_iteration(dataclasses.replace(base, sweep_lookahead=True))
    assert d1.goff is None
    for f in dataclasses.fields(s0):
        a, b = getattr(s0, f.name), getattr(s1, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            assert torch.equal(a, b), f.name


@pytest.mark.parametrize("route,missing", [
    (dict(sweep_stagger=True, sweep="fused"), 0.0),    # B4
    (dict(sweep="pallas"), 0.0),                       # B3
    (dict(sweep="xla"), 0.0),                          # the plain sweep
    (dict(sweep="auto", dtype=torch.float64), 0.0),    # float64, plain
    (dict(sweep="fused"), 0.15),                       # exact: B2
])
def test_lookahead_reaches_b1_only(route, missing):
    """sweep_lookahead with mxu_bf16 reaches B1 only, as JAX passes it to
    its fused kernel alone: every other engine gives its sweep bit for bit
    as without the two flags, and builds no goff (block 32: p = 75 in
    three blocks)."""
    base = at.Config(**{"dtype": torch.float32, "block_size": 32, **route})
    flags = dataclasses.replace(base, mxu_bf16=True, sweep_lookahead=True)
    tgl.check_config(flags)
    d0, s0 = _port_iteration(base, missing)
    d1, s1 = _port_iteration(flags, missing)
    assert d1.goff is None
    for f in dataclasses.fields(s0):
        a, b = getattr(s0, f.name), getattr(s1, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            assert torch.equal(a, b), f.name


def test_lookahead_reaches_b1_under_bf16():
    """On sweep="fused" under mxu_bf16 the flag changes the iteration,
    with goff built once in build_data (float32, from the float32 x), and
    the graph-loop counter of the lookahead variant is registered (block
    32: p = 75 in three blocks; in one block the flag changes nothing; q
    padded to 128, where the JAX package's fused kernel finds its tile)."""
    from atlasqtl_tpu_torch.inference import device_loop as dl
    cfg = at.Config(dtype=torch.float32, sweep="fused", mxu_bf16=True,
                    block_size=32)
    _, s0 = _port_iteration(cfg, q_pad_to=128)
    d1, s1 = _port_iteration(dataclasses.replace(cfg, sweep_lookahead=True),
                             q_pad_to=128)
    assert d1.goff is not None and d1.goff.dtype == torch.float32
    assert torch.equal(d1.goff, tsf.lookahead_gram(
        d1.x, tgl.data_block(cfg, d1)))
    assert not torch.equal(s0.gam, s1.gam)
    assert tsf.sweep_fused.lookahead in dl.launch_counters()


def test_lookahead_refused_without_bf16():
    """The wrapper refuses lookahead without bf16 or without goff."""
    data, state, gram, consts = _problem(120, 128, 1.0, 32)
    tconsts = tsw.SweepConsts(*[_t(v) for v in consts])
    ops = tsf.fused_operands(
        _t(data.x), _t(data.cp_x_y), _t(gram),
        _t(state.gam * state.mu_beta), _t(state.fitted), tconsts, 32,
        _t(data.p_mask), _t(data.q_mask))
    goff = tsf.lookahead_gram(ops[0], 32)
    kw = dict(block_size=32, emit_gam_mu=True, c_one=True, lookahead=True)
    with pytest.raises(ValueError, match="bf16 mode"):
        tsf.sweep_fused(*ops, goff, **kw)
    with pytest.raises(ValueError, match="goff"):
        tsf.sweep_fused(*ops, **kw, bf16=True)


@pytest.mark.parametrize("q_pad", [24, 504, 128, 256])
def test_c10_lookahead_reaches_b1_only_at_a_q_tile(monkeypatch, q_pad):
    """C10: Config(mxu_bf16=True, sweep_lookahead=True) on sweep="fused"
    (block 32: p = 75 in three blocks; q = 20 padded to q_pad) reaches the
    lookahead schedule of B1's plain version only where the JAX package's
    fused kernel finds a q tile (a padded q that is a multiple of 128).  At
    24 and 504 the iteration is the float32 one without either flag, bit
    for bit, with no goff and no bf16 x built; at 128 and 256 goff is built
    and the iteration differs from mxu_bf16's alone."""
    from test_torch_bf16 import _same_iteration, _spy
    reaches = q_pad % 128 == 0
    q_pad_to = 8 if q_pad == 24 else q_pad
    base = at.Config(dtype=torch.float32, sweep="fused", block_size=32)
    bf16 = dataclasses.replace(base, mxu_bf16=True)
    _, s0 = _port_iteration(bf16 if reaches else base, q_pad_to=q_pad_to)
    calls = _spy(monkeypatch, tsf, "sweep_fused_plain", "lookahead")
    d1, s1 = _port_iteration(dataclasses.replace(bf16, sweep_lookahead=True),
                             q_pad_to=q_pad_to)
    assert d1.y.shape[1] == q_pad
    assert calls == [reaches]
    assert (d1.goff is not None) == reaches
    assert (d1.x_bf16 is not None) == reaches
    assert _same_iteration(s0, s1) != reaches
