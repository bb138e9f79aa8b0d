"""The perf probes of the port's fused sweeps, held against the JAX package:
B1's eleven Config.sweep_probe values (ops/sweep_fused.py:PROBES) and B2's
probe= values (ops/sweep_missing_fused.py:MIS_PROBES).  On the CPU the
wrappers run the kernels' plain versions, held here against the JAX
kernels in interpret mode; the CUDA probe instances are held against the
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py's
probes phase).  Also the probes' routing (models/global_local.py:
_b1_probe) and one CAVI iteration under a probe in both packages.

Tolerances: tests/test_torch_sweep_fused.py's for B1 (gam, mu, beta atol
1e-5; the rest 1e-4 * max |reference|), tests/test_torch_missing.py's for
B2 (gam atol 5e-5, the rest 5e-4), tests/test_torch_bf16.py's mean
criterion for B1's probes under mxu_bf16, tests/test_torch_model.py's for
the iteration.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from atlasqtl_tpu.models import global_local as jgl
from atlasqtl_tpu.ops import sweep as jsw
from atlasqtl_tpu.ops.sweep_fused import sweep_complete_fused as j_fused
from atlasqtl_tpu.ops.sweep_missing_fused import sweep_missing_fused_driver
from atlasqtl_tpu.ops.sweep import block_gram as j_block_gram

import atlasqtl_tpu_torch as at
from atlasqtl_tpu_torch.models import global_local as tgl
from atlasqtl_tpu_torch.ops import sweep as tsw
from atlasqtl_tpu_torch.ops import sweep_fused as tsf
from atlasqtl_tpu_torch.ops import sweep_missing_fused as tsm
from atlasqtl_tpu_torch.ops.sweep import block_gram as t_block_gram

from test_torch_bf16 import _flat, _mean_criterion
from test_torch_missing import _check_b2, _consts, _jax_problem as _mis_problem
from test_torch_model import _jax_problem as _model_problem
from test_torch_sweep_fused import NAMES, _check, _problem, _t

_B1 = {}


def _b1_problem(c):
    """`_problem(120, 128, c, 32)`: q padded to 128, 8 blocks of 32."""
    if c not in _B1:
        _B1[c] = _problem(120, 128, c, 32)
    return _B1[c]


def _jax_b1(probe, c, sub, bf16=False):
    data, state, gram, consts = _b1_problem(c)
    return j_fused(data.x, data.cp_x_y, gram, state.gam * state.mu_beta,
                   state.fitted, consts, 32, p_mask=data.p_mask,
                   q_mask=data.q_mask, q_tile=128, sub=sub, qchunk=128,
                   mxu_bf16=bf16, annealed=c != 1.0, probe=probe)


def _port_b1(probe, c, sub, bf16=False):
    data, state, gram, consts = _b1_problem(c)
    tconsts = tsw.SweepConsts(*[_t(v) for v in consts])
    return tsf.sweep_complete_fused(
        _t(data.x), _t(data.cp_x_y), _t(gram), _t(state.gam * state.mu_beta),
        _t(state.fitted), tconsts, 32, p_mask=_t(data.p_mask),
        q_mask=_t(data.q_mask), annealed=c != 1.0, bf16=bf16, probe=probe,
        sub=sub)


@pytest.mark.parametrize("probe,c,sub", [
    *((p, 1.0, 8) for p in tsf.PROBES),
    ("noseq", 0.5, 8), ("norank", 0.5, 8), ("jacobi", 0.5, 8),
    ("noseq", 1.0, 16), ("norank", 1.0, 16),
    ("noseq", 1.0, 4), ("norank", 1.0, 4)])
def test_b1_probe_plain_matches_jax_kernel(probe, c, sub):
    """Each probe of the JAX fused kernel (interpret mode) at (n=120,
    p=256, q=128, block 32) in windows of `sub`; under noseq and norank
    the window changes the function (at 4 a window of the CUDA probe
    instance's 8-row chain holds two)."""
    got = _port_b1(probe, c, sub)
    assert tsf.sweep_fused.launches == 0  # CPU: the plain version
    _check(got, _jax_b1(probe, c, sub))


def _b1_cut(block, p=240):
    """`_b1_problem(1.0)` with x and every (p,) and (p, q) operand cut to
    its first p = 240 predictors (a multiple of 24, 40 and 48, whose
    blocks have windows off the 8-row grid), the Gram in blocks of
    `block`; F stays the full problem's (the sweep takes any F)."""
    data, state, _, consts = _b1_problem(1.0)
    x = data.x[:, :p]
    consts = consts._replace(theta=consts.theta[:p])
    return (x, data.cp_x_y[:p], j_block_gram(x, block),
            (state.gam * state.mu_beta)[:p], state.fitted, consts,
            data.p_mask[:p], data.q_mask)


@pytest.mark.parametrize("probe,block,sub", [
    ("noseq", 48, 6), ("norank", 48, 12), ("norank", 24, 3),
    ("noseq", 40, 5)])
def test_b1_probe_off_grid_plain_matches_jax_kernel(probe, block, sub):
    """noseq and norank at windows off the CUDA probe instance's 8-row
    grid (neither dividing 8 nor a multiple of it: a window starts inside
    a chain window of 8), at (n=120, p=240, q=128): the port's plain
    version against the JAX kernel in interpret mode."""
    x, cp, gram, beta, fitted, consts, pm, qm = _b1_cut(block)
    ref = j_fused(x, cp, gram, beta, fitted, consts, block, p_mask=pm,
                  q_mask=qm, q_tile=128, sub=sub, qchunk=128, probe=probe)
    got = tsf.sweep_complete_fused(
        _t(x), _t(cp), _t(gram), _t(beta), _t(fitted),
        tsw.SweepConsts(*[_t(v) for v in consts]), block, p_mask=_t(pm),
        q_mask=_t(qm), probe=probe, sub=sub)
    assert tsf.sweep_fused.launches == 0  # CPU: the plain version
    _check(got, ref)


def _b1_masked_chain(r, g, ad, cp_b, beta_b, ct, c_inv_2s2, sub, parts):
    """The chain of B1's CUDA probe instances (csrc/sweep_fused.cu) in
    plain tensor ops: B1's own, row by row in flat order with each delta
    pushed to every later row of the block, on the block's Gram with the
    entries of what the probe drops zeroed (a push where both rows lie in
    one window of `sub`, a correction where they do not).  (The instances
    also zero the diagonal where the probe keeps none, which the plain
    version's caller takes off r before the chain.)"""
    B = beta_b.shape[0]
    win = torch.arange(B) // sub
    keep = torch.where(win[:, None] == win[None, :],
                       torch.tensor(parts.pushes),
                       torch.tensor(parts.corrections))
    gm = torch.where(keep, g, torch.zeros_like(g))
    gam_b, mu_b, delta = (torch.empty_like(beta_b) for _ in range(3))
    for i in range(B):
        mu_i = ct * (cp_b[i] - r[i])
        logit = ad[i] + mu_i * mu_i * c_inv_2s2
        gam_i = (torch.sigmoid(logit) if parts.sigmoid
                 else torch.clamp(logit, 0.0, 1.0))
        delta[i] = gam_i * mu_i - beta_b[i]
        r[i + 1:] += gm[i + 1:, i, None] * delta[i]
        gam_b[i], mu_b[i] = gam_i, mu_i
    return gam_b, mu_b, delta


@pytest.mark.parametrize("block,sub", [(48, 3), (48, 6), (48, 8), (48, 12),
                                       (40, 5), (240, 24)])
@pytest.mark.parametrize("probe", ["noseq", "norank", "jacobi", "nosig",
                                   "nor0"])
def test_b1_probe_masked_gram_is_the_windowed_chain(probe, block, sub,
                                                    monkeypatch):
    """The design of B1's CUDA probe instances, held on the CPU: B1's chain
    on a Gram whose dropped entries are zeros computes the JAX kernel's
    windowed chain (the plain version's `_probe_chain`: corrections before
    each window of `sub`, pushes inside it), on the 8-row grid and off it
    (3, 5, 6, 12), a block over 128 whole (240); float64 at (n=120,
    p=240, q=128), to 1e-10 of each output's scale."""
    x, cp, gram, beta, fitted, consts, pm, qm = _b1_cut(block)
    f64 = lambda a: torch.tensor(np.array(a), dtype=torch.float64)
    args = (f64(x), f64(cp), f64(gram), f64(beta), f64(fitted),
            tsw.SweepConsts(*[f64(v) for v in consts]), block)
    kw = dict(p_mask=f64(pm), q_mask=f64(qm), probe=probe, sub=sub)
    ref = _flat(tsf.sweep_complete_fused(*args, **kw))
    monkeypatch.setattr(tsf, "_probe_chain", _b1_masked_chain)
    got = _flat(tsf.sweep_complete_fused(*args, **kw))
    for name, a, r in zip(NAMES, got, ref):
        assert float((a - r).abs().max()) <= 1e-10 * max(
            1.0, float(r.abs().max())), name


@pytest.mark.parametrize("probe", ["jacobi", "exact_noz"])
def test_b1_probe_plain_bf16_matches_jax_kernel(probe):
    """Under mxu_bf16 a probe keeps its bf16 products: the port's plain
    version against the JAX kernel under tests/test_torch_bf16.py's mean
    criterion (the mode's distance: the same probe in float32)."""
    got = _port_b1(probe, 1.0, 8, bf16=True)
    _mean_criterion(_flat(got), _flat(_jax_b1(probe, 1.0, 8, bf16=True)),
                    _flat(_jax_b1(probe, 1.0, 8)), NAMES)


def test_b1_window_16_moves_noseq():
    """The window is part of noseq's function: sub 8 and 16 differ (the
    reason sweep_sub is read under a probe)."""
    a, b = _port_b1("noseq", 1.0, 8), _port_b1("noseq", 1.0, 16)
    assert float((a[2] - b[2]).abs().max()) > 1e-4


@pytest.mark.parametrize("window,ok", [(1, True), (2, True), (4, True),
                                       (8, True), (16, True), (24, True),
                                       (3, True), (6, True), (12, True)])
def test_b1_probe_instance_windows(window, ok):
    """The windows B1's CUDA probe instance takes: every one (off the 8-row
    grid it keeps or drops a push per pair of rows); B2's pair_bf16 probe
    instances take the mode's windows, the powers of two up to 128 (its
    float32 one every window that divides the block)."""
    assert tsf.probe_window_ok(window) is ok
    assert (window in tsm.PROBE_WINDOWS) is (window in (1, 2, 4, 8, 16, 32,
                                                        64, 128))


def test_b1_probe_rejections():
    data, state, gram, consts = _b1_problem(1.0)
    tconsts = tsw.SweepConsts(*[_t(v) for v in consts])
    args = (_t(data.x), _t(data.cp_x_y), _t(gram),
            _t(state.gam * state.mu_beta), _t(state.fitted), tconsts, 32)
    with pytest.raises(ValueError, match="unknown sweep probe"):
        tsf.sweep_complete_fused(*args, probe="bogus")
    with pytest.raises(ValueError, match="must divide"):
        tsf.sweep_complete_fused(*args, probe="noseq", sub=24)


_B2 = {}


def _b2_problem():
    """test_b2_plain_matches_jax_kernel's problem: n=80, p=250, q=40
    padded to 256, 20% missing, c = 1."""
    if not _B2:
        data, _, state, _, _ = _mis_problem(jnp.float32, n=80, p=250, q=40,
                                            seed=7, mis_block=16,
                                            q_pad_to=256)
        consts, sig2_inv = _consts(data, state, 1.0, np.float32)
        _B2["p"] = data, state, consts, sig2_inv
    return _B2["p"]


def _port_b2(probe, sub=8):
    data, state, consts, sig2_inv = _b2_problem()
    tc = tsw.SweepConsts(**{k: _t(v) for k, v in consts.items()})
    return tsm.sweep_missing_fused_driver(
        _t(data.x), _t(data.cp_x_y), _t(data.x_norm_sq), _t(data.mis_pat),
        _t(state.gam), _t(state.mu_beta), _t(state.fitted), tc, _t(sig2_inv),
        128, _t(data.p_mask), _t(data.q_mask), sub=sub, probe=probe)


@pytest.mark.parametrize("probe", ["noseq", "noadv", "noadvmask"])
def test_b2_probe_plain_matches_jax_kernel(probe):
    """Each probe of the JAX exact-missing kernel (interpret mode, sub 8,
    wgroup 4) against the port's plain version at its window."""
    data, state, consts, sig2_inv = _b2_problem()
    jc = jsw.SweepConsts(**{k: jnp.asarray(v) for k, v in consts.items()})
    ref = sweep_missing_fused_driver(
        data.x, data.cp_x_y, data.x_norm_sq, data.mis_pat, state.gam,
        state.mu_beta, state.fitted, jc, jnp.asarray(sig2_inv), 128,
        p_mask=data.p_mask, q_mask=data.q_mask, q_tile=256, sub=8, wgroup=4,
        qchunk=256, probe=probe)
    msk = np.asarray(data.p_mask)[:, None] * np.asarray(data.q_mask)[None, :]
    _check_b2(_port_b2(probe), ref, msk)
    if probe == "noadv":  # Fm out = Fm in
        np.testing.assert_array_equal(np.asarray(ref[2]),
                                      np.asarray(state.fitted))


@pytest.mark.parametrize("probe,sub", [("noadv", 32), ("noseq", 128)])
def test_b2_deep_probe_plain_matches_jax_kernel(probe, sub):
    """B2's probes at windows over 16 (wgroup 1, one window per pair
    Gram): every 8-window of a window projects Fm as of its start, noadv
    pushes the window's masked pairs, noseq none; the port's plain version
    against the JAX kernel in interpret mode."""
    data, state, consts, sig2_inv = _b2_problem()
    jc = jsw.SweepConsts(**{k: jnp.asarray(v) for k, v in consts.items()})
    ref = sweep_missing_fused_driver(
        data.x, data.cp_x_y, data.x_norm_sq, data.mis_pat, state.gam,
        state.mu_beta, state.fitted, jc, jnp.asarray(sig2_inv), 128,
        p_mask=data.p_mask, q_mask=data.q_mask, q_tile=256, sub=sub,
        wgroup=1, qchunk=256, probe=probe)
    msk = np.asarray(data.p_mask)[:, None] * np.asarray(data.q_mask)[None, :]
    _check_b2(_port_b2(probe, sub), ref, msk)


def _b2_probe_schedule(ops, block, probe, sub):
    """B2's float32 probe instance's schedule in plain tensor ops (csrc/
    sweep_missing_fused.cu): chain windows of 8 in flat order, each
    projected in one pass that first advances Fm by the previous chain
    window, its pairs pushed through the masked pair Grams; a probe's
    window of J = sub / 8 chain windows departs from B2's running masked
    advance only at its edges: inside it Fm advances masked (noseq: not at
    all); the pass of its last chain window (j = J - 1 > 0) projects Fm
    (noseq) or Fm + m s (s: the previous chain window's x delta) and stores
    the window's end but for that chain window, (Fm + m s) + m e (noseq; e
    the first J - 2 chain windows' x delta), Fm as received (noadv) or (Fm
    + s) + (1 - m) e (noadvmask); the next window's first pass advances by
    the probe's rule (noseq masked, noadv not at all, noadvmask without
    the mask), as does the sweep's tail."""
    (x, cp, xns, mis, l_aug, n_stack, gam, mu, fitted, theta, p_mask, zeta,
     q_mask, tau, c, kz, sig2_inv) = ops
    W = tsm.MIS_W
    J = sub // W
    code = tsm.MIS_PROBE_CODES[probe]
    start = {0: 1, 1: 0, 2: 2}[code]    # the advance at a window's start
    fm = fitted.clone()
    p = x.shape[1]
    gam_out, mu_out = torch.empty_like(gam), torch.empty_like(mu)
    z_row, z_col = torch.empty_like(theta), torch.zeros_like(zeta)
    kept = {}                          # the window's deltas by chain window

    def advance(rule, s):
        return fm + mis * s if rule == 1 else fm + s if rule == 2 else fm

    prev = None                        # the previous chain window's x, delta
    for b in range(p // block):
        sl = slice(b * block, (b + 1) * block)
        ad, imrd, imr0u, ct = tsm._missing_tiles(
            l_aug[sl], n_stack, theta[sl, None] + zeta[None, :], kz, c,
            xns[sl] + sig2_inv)
        gam_b, mu_b = torch.empty_like(ad), torch.empty_like(ad)
        for lo in range(0, block, W):
            j0 = b * block + lo
            w, xw = j0 // W, x[:, j0:j0 + W]
            j = w % J
            fp = fm
            if prev is not None:
                s = prev[0] @ prev[1]
                if j == 0:
                    fm = fp = advance(start, s)
                elif j < J - 1:
                    fm = fp = advance(0 if code == 0 else 1, s)
                else:
                    e = sum((x[:, j0 - (j - i) * W:j0 - (j - i - 1) * W]
                             @ kept[i] for i in range(j - 1)),
                            torch.zeros_like(fm))
                    fp = fm if code == 0 else fm + mis * s
                    fm = ((fm + mis * s) + mis * e if code == 0 else
                          fitted.clone() if code == 1 else
                          (fm + s) + (1 - mis) * e)
            r = xw.T @ fp
            h = tsm._pair_grams(xw, mis, False) if code != 0 else None
            deltas = []
            for i in range(W):
                gam_b[lo + i], mu_b[lo + i], delta = tsm._missing_coordinate(
                    j0 + i, r[i], cp, gam, mu, xns, ct[lo + i], ad[lo + i],
                    tau, c)
                if h is not None:
                    r[i + 1:] += h[i + 1:, i] * delta
                deltas.append(delta)
            kept[j] = torch.stack(deltas)
            prev = (xw, kept[j])
        tsm._missing_block_out((gam_out, mu_out, z_row, z_col), sl, gam_b,
                               mu_b, imrd, imr0u, p_mask, q_mask)
    fm = advance(start, prev[0] @ prev[1])
    return gam_out, mu_out, fm, z_row, z_col


@pytest.mark.parametrize("sub", [16, 32, 128])
@pytest.mark.parametrize("probe", ["noseq", "noadv", "noadvmask"])
def test_b2_probe_schedule_matches_plain(probe, sub):
    """The schedule of B2's float32 probe instance (`_b2_probe_schedule`:
    B2's running masked advance, each probe a departure at its window's
    edges) computes the probe's function: against the port's plain
    version (the JAX kernel's windows) at (n=80, p=250 -> 256, q=40), 20%
    missing, block 128, gam, mu within 1e-5 and Fm, z_row, z_col within
    1e-5 x their largest magnitude; noadv's Fm bit for bit."""
    from test_torch_cuda import _mis_operands
    ops, block = _mis_operands(80, 250, 40, 1.0, block=128)
    got = _b2_probe_schedule(ops, block, probe, sub)
    ref = tsm.sweep_missing_fused_plain(*ops, block_size=block, sub=sub,
                                        probe=probe)
    for name, a, r in zip(("gam", "mu", "fitted", "z_row", "z_col"), got,
                          ref):
        limit = 1e-5 * (1.0 if name in ("gam", "mu")
                        else float(r.abs().max()))
        assert float((a - r).abs().max()) <= limit, name
    if probe == "noadv":
        assert torch.equal(got[2], ops[8])


def test_b2_noh_is_noseq_and_rejections():
    """noh and noseq are one function (atlasqtl_tpu/ops/
    sweep_missing_fused.py:155, 197); an unknown probe and a window that
    does not divide the block raise."""
    for a, b in zip(_port_b2("noh", 16), _port_b2("noseq", 16)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown sweep_missing_fused"):
        _port_b2("nosig")
    with pytest.raises(ValueError, match="must divide"):
        _port_b2("noadv", 48)


class _FakeData:
    """What `_engine` reads of complete data."""

    def __init__(self, n, q):
        self.x = torch.zeros((n, 1))
        self.y = torch.zeros((1, q))
        self.x_norm_sq = None


@pytest.mark.parametrize("q,kw,reaches", [
    (128, {}, True),                                  # a fused q tile
    (120, {}, False),                                 # none: no tile
    (128, dict(q_axis="q"), False),                   # a mesh
    (256, dict(sweep_stagger=True), True),            # B1, never B4
    (128, dict(sweep="xla"), False),                  # the plain engine
    (128, dict(sweep="pallas"), False),               # the B3 route
])
def test_b1_probe_routing(q, kw, reaches):
    """`_b1_probe` at n=120 on the CPU (sweep="fused"): the probe reaches
    B1 only at a fused q tile, on one device, on the fused engine; under
    it sweep_stagger takes B1, and the lookahead is off."""
    cfg = at.Config(**{"sweep": "fused", "sweep_probe": "noadv",
                       "mxu_bf16": True, "sweep_lookahead": True, **kw})
    n = 120
    assert tgl._b1_probe(cfg, "cpu", n, q) is reaches
    if "sweep_stagger" in kw:
        assert not tgl._stagger(cfg, n, q)
        assert tgl._engine(cfg, _FakeData(n, q)) == "b1"
        assert tgl._stagger(dataclasses.replace(cfg, sweep_probe="none"),
                            n, q)
    if reaches:
        assert not tgl._b1_lookahead(cfg, "cpu", n, q)
        assert tgl._b1_bf16(cfg, "cpu", n, q)
    elif q == 128 and "q_axis" in kw:   # a mesh keeps its lookahead
        assert tgl._b1_lookahead(cfg, "cpu", n, q)


def test_b1_window_rule():
    """`_fused_sub`: sweep_sub, or 8 up to n 2048 and 32 above, clipped to
    the block; a window that does not divide the block raises."""
    assert tgl._fused_sub(at.Config(), 2048, 128) == 8
    assert tgl._fused_sub(at.Config(), 2056, 128) == 32
    assert tgl._fused_sub(at.Config(), 2056, 16) == 16
    assert tgl._fused_sub(at.Config(sweep_sub=64), 100, 128) == 64
    with pytest.raises(ValueError, match="must divide"):
        tgl._fused_sub(at.Config(sweep_sub=48), 100, 128)


def test_cavi_iteration_under_a_probe_matches_jax():
    """One float32 iteration with Config(sweep="fused",
    sweep_probe="norank") in both packages (the JAX fused kernel in
    interpret mode, the port's plain version), tests/test_torch_model.py's
    tolerances."""
    (data, hyper, state, jcfg), (tdata, thyper, tstate), cfg, tdt = \
        _model_problem(jnp.float32, 32, 128, n=120, p=256, q=48, seed=3)
    jcfg = dataclasses.replace(jcfg, sweep="fused", sweep_probe="norank")
    tcfg = at.Config(dtype=tdt, sweep="fused", sweep_probe="norank", **cfg)
    tgl.check_config(tcfg)
    j1 = jgl.cavi_iteration(data, hyper, state, j_block_gram(data.x, 32),
                            1.0, 1.0, cfg=jcfg, annealed=False)
    t1 = tgl.cavi_iteration(tdata, thyper, tstate, t_block_gram(tdata.x, 32),
                            1.0, 1.0, cfg=tcfg, annealed=False)
    assert tsf.sweep_fused.launches == 0
    for name, atol in (("gam", 5e-5), ("mu_beta", 5e-5), ("theta", 5e-5),
                       ("fitted", 5e-3)):
        np.testing.assert_allclose(getattr(t1, name).numpy(),
                                   np.asarray(getattr(j1, name)),
                                   atol=atol, err_msg=name)
    # the probe moved the iteration: the exact one differs
    t0 = tgl.cavi_iteration(tdata, thyper, tstate, t_block_gram(tdata.x, 32),
                            1.0, 1.0, cfg=dataclasses.replace(
                                tcfg, sweep_probe="none"), annealed=False)
    assert float((t0.mu_beta - t1.mu_beta).abs().max()) > 1e-4


def test_replicas_under_a_probe_match_single_iterations():
    """cavi_iteration_replicas under a probe (one batched B1 sweep, on the
    CPU its plain version replica by replica): each replica's state is
    the one cavi_iteration gives it alone, bit for bit, as JAX's vmap of
    cavi_iteration applies the probe to every replica."""
    (_, _, _, _), (tdata, thyper, tstate), cfg, tdt = _model_problem(
        jnp.float32, 32, 128, n=120, p=256, q=48, seed=3)
    tcfg = at.Config(dtype=tdt, sweep="fused", sweep_probe="noseq", **cfg)
    other = dataclasses.replace(tstate, theta=tstate.theta * 0.5,
                                fitted=tstate.fitted * 0.9)
    gram = t_block_gram(tdata.x, 32)
    both = tgl.cavi_iteration_replicas(tdata, thyper, [tstate, other], gram,
                                       0.5, 0.5, cfg=tcfg, annealed=True)
    for st, got in zip((tstate, other), both):
        one = tgl.cavi_iteration(tdata, thyper, st, gram, 0.5, 0.5,
                                 cfg=tcfg, annealed=True)
        for f in dataclasses.fields(one):
            a, b = getattr(got, f.name), getattr(one, f.name)
            assert (a is None) == (b is None), f.name
            if b is not None:
                assert torch.equal(a, b), f.name
        exact = tgl.cavi_iteration(tdata, thyper, st, gram, 0.5, 0.5,
                                   cfg=dataclasses.replace(
                                       tcfg, sweep_probe="none"),
                                   annealed=True)
        assert float((exact.mu_beta - got.mu_beta).abs().max()) > 1e-4
