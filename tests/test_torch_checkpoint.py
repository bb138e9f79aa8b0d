"""The port's checkpoints (io/checkpoint.py) and hotspot traces
(io/trace.py) held against the JAX package's: the same snapshot keys,
arrays and dtypes for the same state, snapshots of either package loaded
by the other into equal InitSpecs, the rolling window of two and the
clean-up, the exact-missing (p, q) slab variance, a fit cut short and
resumed from its snapshot, the trace CSV byte for byte, the global-only
model's dropped tracer, and the device loop's refusal of host hooks.
"""
import dataclasses
import logging
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import atlasqtl_tpu as aq
from atlasqtl_tpu.types import Config as JConfig
from atlasqtl_tpu.models import global_local as jgl
from atlasqtl_tpu.inference import elicitation as jelic
from atlasqtl_tpu.io.checkpoint import Checkpointer as JCheckpointer
from atlasqtl_tpu.io.prepare import prepare_data
from atlasqtl_tpu.io.trace import HotspotTrace as JTrace
from atlasqtl_tpu.ops.sweep import block_gram

import atlasqtl_tpu_torch as at
from atlasqtl_tpu_torch import convert
from atlasqtl_tpu_torch.inference import device_loop
from atlasqtl_tpu_torch.io.checkpoint import Checkpointer
from atlasqtl_tpu_torch.io.trace import CSV_NAME, HotspotTrace

from conftest import simulate_fixture


def _arrays(obj):
    return {f.name: None if getattr(obj, f.name) is None
            else np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _states(frac=0.0, p=80, block=16, dtype=jnp.float64, n_iter=3, q=20):
    """Float64 JAX states along a few iterations from a host draw, each
    with its port copy (convert.py); p = 80 at block 16 has no padded
    predictor, p = 75 has five; p = 16 with q = 42 has fewer predictors
    than responses (and six padded responses)."""
    y, x, _ = simulate_fixture(p=p, q=q, p_act=min(10, p), missing_frac=frac,
                               seed=5)
    dat = prepare_data(y, x, 0.1, 100)
    pe, q = dat.x.shape[1], dat.y.shape[1]
    cfg = JConfig(dtype=dtype, block_size=block, shr_fac_inv=float(q))
    data = jgl.build_data(dat.x, dat.y, cfg, q_pad_to=8)
    hyper = jgl.build_hyper(jelic.auto_set_hyper(dat.y, pe, (5, 25)),
                            data.y.shape[1], cfg)
    st = jgl.build_state(jelic.auto_set_init(dat.y, pe, (5, 25), float(q), 3),
                         data, cfg)
    gram = (block_gram(data.x, block) if data.x_norm_sq is None
            else jnp.zeros((1, 1, 1)))
    out = []
    for _ in range(n_iter):
        st = jgl.cavi_iteration(data, hyper, st, gram, 1.0, 1.0, cfg=cfg,
                                annealed=False)
        out.append((st, convert.state_from_numpy(_arrays(st),
                                                 device="cpu")))
    return out, dat


@pytest.mark.parametrize("frac,dtype,p,q", [(0.0, jnp.float64, 80, 20),
                                            (0.15, jnp.float64, 80, 20),
                                            (0.0, jnp.float32, 80, 20),
                                            (0.0, jnp.float64, 16, 42),
                                            (0.15, jnp.float64, 16, 42)])
def test_snapshots_equal_jax(tmp_path, frac, dtype, p, q):
    """Key for key, dtype for dtype, value for value, with fewer
    predictors than responses too."""
    states, dat = _states(frac, p=p, dtype=dtype, q=q)
    jst, tst = states[-1]
    p, q = dat.x.shape[1], dat.y.shape[1]
    dj, dt = tmp_path / "jax", tmp_path / "port"
    dj.mkdir(), dt.mkdir()
    JCheckpointer(str(dj), dat.names_x, dat.names_y, p, q, rate=2)(
        4, jst, False, -10.5, -11.0)
    Checkpointer(str(dt), dat.names_x, dat.names_y, p, q, rate=2)(
        4, tst, False, -10.5, -11.0)
    zj = np.load(dj / "tmp_output_it_4.npz")
    zt = np.load(dt / "tmp_output_it_4.npz")
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        assert zj[k].dtype == zt[k].dtype and zj[k].shape == zt[k].shape, k
        assert np.array_equal(zj[k], zt[k]), k
    assert zt["sig2_beta_vb"].shape == ((p, q) if frac else (q,))


def _same_init(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert np.array_equal(np.asarray(x), np.asarray(y)), f.name


@pytest.mark.parametrize("frac,p,q", [(0.0, 75, 20), (0.15, 80, 20),
                                      (0.15, 75, 20), (0.0, 16, 42),
                                      (0.15, 16, 42)])
def test_snapshots_load_in_either_package(tmp_path, frac, p, q):
    """A port snapshot through atlasqtl_tpu.load_checkpoint and a JAX one
    through the port's give equal InitSpecs, and each builds a state.  At
    p = 75 on the exact-missing path the JAX snapshot keeps the padded
    predictors' slab variances (80 rows); the port keeps the true 75
    (ROADMAP.md C5), and its loader cuts a JAX snapshot to them.  With
    p < q the complete-data (q,) slab variance keeps all q entries."""
    states, dat = _states(frac, p=p, q=q)
    jst, tst = states[-1]
    pe, q = dat.x.shape[1], dat.y.shape[1]
    dj, dt = tmp_path / "jax", tmp_path / "port"
    dj.mkdir(), dt.mkdir()
    JCheckpointer(str(dj), dat.names_x, dat.names_y, pe, q)(
        100, jst, False, -1.0, -2.0)
    Checkpointer(str(dt), dat.names_x, dat.names_y, pe, q)(
        100, tst, False, -1.0, -2.0)
    from_port_by_jax = aq.load_checkpoint(dt / "tmp_output_it_100.npz")
    from_port = at.load_checkpoint(dt / "tmp_output_it_100.npz")
    from_jax = at.load_checkpoint(dj / "tmp_output_it_100.npz")
    _same_init(from_port_by_jax, from_port)
    _same_init(from_jax, from_port)
    assert from_port.sig2_beta_vb.shape == ((pe, q) if frac else (q,))
    cfg = at.Config(dtype=torch.float64, block_size=16,
                    shr_fac_inv=float(q))
    from atlasqtl_tpu_torch.models import global_local as tgl
    data = tgl.build_data(dat.x, dat.y, cfg, "cpu")
    st = tgl.build_state(from_jax, data, cfg)
    np.testing.assert_array_equal(st.gam[:pe, :q].numpy(),
                                  np.asarray(jst.gam)[:pe, :q])
    s_t, s_j = st.sig2_beta.numpy(), np.asarray(jst.sig2_beta)
    cut = (slice(0, pe), slice(0, q)) if frac else (slice(0, q),)
    np.testing.assert_array_equal(s_t[cut], s_j[cut])


def test_rolling_window_and_clean_up(tmp_path):
    states, dat = _states(n_iter=1)
    _, tst = states[0]
    ck = Checkpointer(str(tmp_path), dat.names_x, dat.names_y,
                      dat.x.shape[1], dat.y.shape[1], rate=2)
    for it in range(1, 9):
        ck(it, tst, False, -1.0, -2.0)
    assert sorted(os.listdir(tmp_path)) == ["tmp_output_it_6.npz",
                                            "tmp_output_it_8.npz"]
    (tmp_path / "other.txt").write_text("kept")
    ck.clean_up()
    assert os.listdir(tmp_path) == ["other.txt"]


def test_cut_then_resume(tmp_path):
    """tests/test_e2e.py's checkpoint case in the port: a fit cut at maxit
    (tolerance too tight to converge) leaves its last snapshots and its
    trace; a resume from the last snapshot converges; a converged fit
    cleans its snapshots up."""
    y, x, p_act = simulate_fixture()
    ckpt, trace = tmp_path / "ckpt", tmp_path / "trace"
    ckpt.mkdir(), trace.mkdir()
    kw = dict(p0=(5, 25), dtype=torch.float64, verbose=0, device="cpu")
    res = at.atlasqtl(y, x, user_seed=123, maxit=120, tol=1e-9,
                      checkpoint_path=str(ckpt), trace_path=str(trace), **kw)
    snaps = sorted(ckpt.glob("tmp_output_it_*.npz"))
    assert not res.converged
    assert [s.name for s in snaps] == ["tmp_output_it_100.npz"]
    assert (trace / CSV_NAME).exists()
    init = at.load_checkpoint(snaps[-1])
    res2 = at.atlasqtl(y, x, anneal=None, list_init=init, maxit=500,
                       checkpoint_path=str(ckpt), **kw)
    assert res2.converged
    assert (res2.hotspot_sizes()[:p_act] > 10).all()
    assert not list(ckpt.glob("tmp_output_it_*.npz"))


def test_trace_csv_byte_identical(tmp_path):
    """Both packages' tracers over the same sequence of states write the
    same bytes."""
    states, dat = _states(n_iter=3)
    p = dat.x.shape[1]
    dj, dt = tmp_path / "jax", tmp_path / "port"
    dj.mkdir(), dt.mkdir()
    tj, tt = JTrace(str(dj), 20.0, p), HotspotTrace(str(dt), 20.0, p)
    for it, (jst, tst) in zip((1, 25, 50), states):
        tj(it, jst)
        tt(it, tst)
    a = (dj / CSV_NAME).read_bytes()
    assert a == (dt / CSV_NAME).read_bytes()
    assert a.count(b"\n") == 4


def test_trace_of_a_fit(tmp_path):
    """A fit's trace: iteration 1 and every 25th of the ladder and of the
    converged phase, the N_TOP largest variances in order."""
    y, x, _ = simulate_fixture()
    at.atlasqtl(y, x, p0=(5, 25), dtype=torch.float64, verbose=0,
                device="cpu", user_seed=1, trace_path=str(tmp_path))
    rows = (tmp_path / CSV_NAME).read_text().splitlines()
    assert rows[0].split(",")[0] == "it" and len(rows[0].split(",")) == 9
    its = [int(r.split(",")[0]) for r in rows[1:]]
    assert len(its) >= 2 and its[0] == 1
    assert all(i % 25 == 0 for i in its[1:])
    var = np.array([[float(v) for v in r.split(",")[1:5]] for r in rows[1:]])
    assert (np.diff(var, axis=1) <= 0).all()


def test_global_model_drops_the_tracer(tmp_path, caplog):
    y, x, _ = simulate_fixture()
    with caplog.at_level(logging.WARNING, logger="atlasqtl_tpu_torch"):
        res = at.atlasqtl(y, x, p0=(5, 25), dtype=torch.float64, verbose=0,
                          device="cpu", user_seed=1, model="global",
                          trace_path=str(tmp_path))
    assert res.converged
    assert "trace_path not used" in caplog.text
    assert not (tmp_path / CSV_NAME).exists()


def test_eligible_refuses_host_hooks():
    """Any host hook keeps the host loop, as in the JAX package
    (atlasqtl_tpu/inference/device_loop.py:eligible)."""
    class _Dev:
        def __init__(self, dev, k):
            self.device = torch.device(dev)
            self.shape = (1, k)

    class _D:
        def __init__(self, dev, p, q):
            self.x, self.y = _Dev(dev, p), _Dev(dev, q)

    d = _D("cuda", 2048, 512)
    for mode in ("auto", "on"):
        cfg = at.Config(device_loop=mode)
        assert device_loop.eligible(cfg, 1, d)
        assert not device_loop.eligible(cfg, 1, d, checkpointer=object())
        assert not device_loop.eligible(cfg, 1, d, tracer=object())


def test_exact_missing_resume_c5(tmp_path):
    """ROADMAP.md C5: with NaN in Y (exact) and p = 75 (padded to 80), the
    JAX package's snapshot keeps the padded rows of the (p, q) slab
    variance and its own resume fails on it; the port's snapshot keeps the
    true rows, and the port resumes from either package's snapshot."""
    y, x, _ = simulate_fixture(missing_frac=0.15, seed=5)
    dj, dt = tmp_path / "jax", tmp_path / "port"
    dj.mkdir(), dt.mkdir()
    kw = dict(p0=(5, 25), verbose=0, user_seed=1, maxit=110, tol=1e-9)
    aq.atlasqtl(y, x, dtype=jnp.float64, checkpoint_path=str(dj), **kw)
    at.atlasqtl(y, x, dtype=torch.float64, device="cpu",
                checkpoint_path=str(dt), **kw)
    snap = "tmp_output_it_100.npz"
    assert np.load(dj / snap)["sig2_beta_vb"].shape == (80, 20)
    assert np.load(dt / snap)["sig2_beta_vb"].shape == (75, 20)
    with pytest.raises(ValueError, match="broadcast"):
        aq.atlasqtl(y, x, p0=(5, 25), dtype=jnp.float64, verbose=0,
                    anneal=None, maxit=5,
                    list_init=aq.load_checkpoint(dj / snap))
    for d in (dj, dt):
        res = at.atlasqtl(y, x, p0=(5, 25), dtype=torch.float64, verbose=0,
                          device="cpu", anneal=None, maxit=500,
                          list_init=at.load_checkpoint(d / snap))
        assert res.converged
