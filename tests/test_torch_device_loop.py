"""The port's device loop (atlasqtl_tpu_torch/inference/device_loop.py) on
the CPU, held against its host loop and against the JAX package's
device_loop="on" (tests/test_device_loop.py's cases): the same iteration
count, the same ELBO evaluations and values (1e-10 in float64 between the
port's two loops; against JAX the tolerances of tests/test_torch_model.py),
the same outputs; the guard raises on both loops with the same message; a
buffer overflow warns; a ladder that exhausts maxit returns the -inf
sentinel, non-converged.
"""
import logging

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import atlasqtl_tpu as aq
import atlasqtl_tpu_torch as at
from atlasqtl_tpu_torch.inference import device_loop
from atlasqtl_tpu_torch.inference.driver import ElboDecreaseError
from atlasqtl_tpu_torch.models import global_local as tgl

from conftest import simulate_fixture

OUTPUTS = ("gam_vb", "beta_vb", "theta_vb", "zeta_vb")


def _port(y, x, loop, **kw):
    base = dict(p0=(5, 25), dtype=torch.float64, verbose=0, user_seed=123,
                device="cpu")
    base.update(kw)
    return at.atlasqtl(y, x, device_loop=loop, **base)


def _assert_same(a, b, tol):
    assert a.converged == b.converged and a.it == b.it
    assert [i for i, _ in a.elbo_history] == [i for i, _ in b.elbo_history]
    np.testing.assert_allclose([lb for _, lb in a.elbo_history],
                               [lb for _, lb in b.elbo_history], rtol=tol)


CASES = {
    "annealed": (dict(), {}),
    "no_annealing": (dict(), dict(anneal=None)),
    "exact_missing": (dict(missing_frac=0.2, seed=5), dict(missing="exact")),
    "impute": (dict(missing_frac=0.2, seed=5), dict(missing="impute")),
    "global_model": (dict(), dict(model="global")),
    "maxit_truncation": (dict(), dict(maxit=12)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_device_loop_matches_host_loop_and_jax(case):
    sim, kw = CASES[case]
    y, x, _ = simulate_fixture(**sim)
    off = _port(y, x, "off", **kw)
    on = _port(y, x, "on", **kw)
    _assert_same(on, off, 1e-10)
    for name in OUTPUTS:
        np.testing.assert_allclose(getattr(on, name), getattr(off, name),
                                   rtol=0, atol=1e-10, err_msg=name)
    ref = aq.atlasqtl(y, x, p0=(5, 25), dtype=jnp.float64, verbose=0,
                      user_seed=123, device_loop="on", **kw)
    _assert_same(on, ref, 1e-9)
    for name in OUTPUTS:
        np.testing.assert_allclose(getattr(on, name), getattr(ref, name),
                                   rtol=0, atol=1e-6, err_msg=name)
    if case == "maxit_truncation":
        assert not on.converged and on.it == 12


def test_device_loop_elbo_buf_overflow_warns(monkeypatch, caplog):
    """More evaluations than the trace buffer: the host history keeps the
    first slots and the last evaluation, and the fit warns; convergence
    and the guard ran on the device and are unaffected."""
    monkeypatch.setattr(device_loop, "ELBO_BUF", 4)
    y, x, _ = simulate_fixture()
    kw = dict(anneal=None, tol=1e-12, maxit=20, thinned_elbo_eval=False)
    with caplog.at_level(logging.WARNING, logger="atlasqtl_tpu_torch"):
        on = _port(y, x, "on", **kw)
    assert not on.converged and on.it == 20
    assert any("ELBO trace truncated" in r.getMessage()
               for r in caplog.records)
    off = _port(y, x, "off", **kw)
    assert len(on.elbo_history) == 4 and len(off.elbo_history) == 20
    assert on.elbo_history[:3] == off.elbo_history[:3]
    assert on.elbo_history[3] == off.elbo_history[-1]


@pytest.mark.parametrize("loop", ["on", "off"])
def test_ladder_exhausting_maxit_returns_the_sentinel(loop):
    """maxit inside the annealing ladder: no evaluation runs, the -inf
    sentinel comes back non-converged, never raised (the reference's
    driver.py:245-256)."""
    y, x, _ = simulate_fixture()
    res = _port(y, x, loop, maxit=3)
    assert not res.converged and res.it == 9 and res.lb_opt == -np.inf
    assert res.elbo_history == []


@pytest.mark.parametrize("fault", ["decrease", "non_finite"])
def test_guard_raises_alike_on_both_loops(monkeypatch, fault):
    """An ELBO that drops (or turns NaN) at the third evaluation raises on
    both loops, naming the same iteration (and, for a drop, the same
    pair): the device loop flags it on the device and raises from the
    recorded trace."""
    y, x, _ = simulate_fixture()
    orig = tgl.compute_elbo
    messages = []
    for loop in ("off", "on"):
        calls = []

        def faulty(*a, **k):
            lb = orig(*a, **k)
            calls.append(1)
            if len(calls) == 3:
                lb = lb - 1e3 if fault == "decrease" else lb * float("nan")
            return lb

        monkeypatch.setattr(tgl, "compute_elbo", faulty)
        with pytest.raises(ElboDecreaseError) as err:
            _port(y, x, loop)
        messages.append(str(err.value))
    head = [m.split(" (previous")[0] for m in messages]
    what = "not increasing monotonically" if fault == "decrease" \
        else "became non-finite"
    assert what in head[0] and head[0] == head[1], messages
    if fault == "non_finite":
        assert head[0].endswith(": nan")


def test_eligible_policy():
    """auto is on for CUDA at <= 2^25 cells and off on the CPU; on/off
    override; verbose=2 keeps the host loop."""
    class _Dev:
        def __init__(self, dev, k):
            self.device = torch.device(dev)
            self.shape = (1, k)

    class _D:
        def __init__(self, dev, p, q):
            self.x, self.y = _Dev(dev, p), _Dev(dev, q)

    cfg = lambda v: at.Config(device_loop=v)
    assert device_loop.eligible(cfg("auto"), 1, _D("cuda", 2048, 512))
    assert not device_loop.eligible(cfg("auto"), 1, _D("cuda", 50048, 10000))
    assert not device_loop.eligible(cfg("auto"), 1, _D("cpu", 2048, 512))
    assert device_loop.eligible(cfg("on"), 0, _D("cpu", 2048, 512))
    assert not device_loop.eligible(cfg("on"), 2, _D("cuda", 2048, 512))
    assert not device_loop.eligible(cfg("off"), 1, _D("cuda", 2048, 512))
