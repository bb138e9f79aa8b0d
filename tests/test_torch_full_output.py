"""The port's full_output (inference/full_output.py) held against the JAX
package's: assemble_full_output of both on the same float64 state (handed
over by convert.py after two iterations of the JAX model), for the
global-local and global models, complete data, impute and exact missing;
cp_X left out past MAX_P_FOR_GRAM; and atlasqtl(full_output=True) of both.

Tolerances: the same state in, atol 1e-10 (the same formulas, library
rounding only); whole fits atol 1e-6 (tests/test_torch_model.py's
end-to-end).
"""
import dataclasses
import logging

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import atlasqtl_tpu as aq
from atlasqtl_tpu.types import Config as JConfig
from atlasqtl_tpu.models import global_local as jgl
from atlasqtl_tpu.models import global_only as jgo
from atlasqtl_tpu.inference import elicitation as jelic
from atlasqtl_tpu.inference.full_output import \
    assemble_full_output as j_full
from atlasqtl_tpu.io.prepare import prepare_data
from atlasqtl_tpu.ops.sweep import block_gram

import atlasqtl_tpu_torch as at
from atlasqtl_tpu_torch import convert
from atlasqtl_tpu_torch.inference import full_output as tfo

from conftest import simulate_fixture


def _arrays(obj):
    return {f.name: None if getattr(obj, f.name) is None
            else np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _problem(model, missing="exact", frac=0.0, block=16):
    """Two float64 iterations of the JAX model from a host-drawn state,
    and the same data, hyperparameters and state in the port."""
    y, x, _ = simulate_fixture(missing_frac=frac, seed=5)
    dat = prepare_data(y, x, 0.1, 100)
    p, q = dat.x.shape[1], dat.y.shape[1]
    kw = dict(block_size=block, shr_fac_inv=float(q), missing=missing)
    jcfg = JConfig(dtype=jnp.float64, **kw)
    data = jgl.build_data(dat.x, dat.y, jcfg, q_pad_to=8)
    hyper = jgl.build_hyper(jelic.auto_set_hyper(dat.y, p, (5, 25)),
                            data.y.shape[1], jcfg)
    state = jgl.build_state(jelic.auto_set_init(dat.y, p, (5, 25), float(q),
                                                3), data, jcfg)
    mod = jgl if model == "global_local" else jgo
    gram = (block_gram(data.x, block) if data.x_norm_sq is None
            else jnp.zeros((1, 1, 1)))
    for c in (0.5, 1.0):
        state = mod.cavi_iteration(data, hyper, state, gram, c, c, cfg=jcfg,
                                   annealed=c < 1)
    port = (convert.data_from_numpy(_arrays(data), device="cpu"),
            convert.hyper_from_numpy(_arrays(hyper), device="cpu"),
            convert.state_from_numpy(_arrays(state), device="cpu"))
    return (data, hyper, state, jcfg), port, at.Config(dtype=torch.float64,
                                                       **kw)


@pytest.mark.parametrize("model,missing,frac", [
    ("global_local", "exact", 0.0), ("global", "exact", 0.0),
    ("global_local", "impute", 0.15), ("global_local", "exact", 0.15),
    ("global", "impute", 0.15)])
def test_full_output_matches_jax_f64(model, missing, frac):
    (data, hyper, state, jcfg), (td, th, ts), tcfg = _problem(
        model, missing, frac)
    ref = j_full(data, hyper, state, jcfg, model=model)
    got = tfo.assemble_full_output(td, th, ts, tcfg, model=model)
    assert set(got) == set(ref)
    assert len(got) == (24 if model == "global_local" else 17)
    for k, r in ref.items():
        g = got[k]
        assert type(g) is type(r) or isinstance(g, np.ndarray), k
        if isinstance(r, np.ndarray):
            assert g.dtype == np.float64 and g.shape == r.shape, k
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-10, err_msg=k)


def test_cp_x_left_out_past_max_p(monkeypatch, caplog):
    _, (td, th, ts), tcfg = _problem("global_local")
    monkeypatch.setattr(tfo, "MAX_P_FOR_GRAM", 50)   # p = 75
    with caplog.at_level(logging.WARNING, logger="atlasqtl_tpu_torch"):
        out = tfo.assemble_full_output(td, th, ts, tcfg)
    assert out["cp_X"] is None
    assert "cp_X" in caplog.text
    assert out["cp_X_Xbeta"].shape == (75, 20)


def test_full_output_fit_matches_jax():
    y, x, _ = simulate_fixture()
    kw = dict(p0=(5, 25), verbose=0, user_seed=123, full_output=True)
    ref = aq.atlasqtl(y, x, dtype=jnp.float64, **kw)
    res = at.atlasqtl(y, x, dtype=torch.float64, device="cpu", **kw)
    assert res.it == ref.it
    assert set(res.full_output) == set(ref.full_output)
    for k, r in ref.full_output.items():
        np.testing.assert_allclose(res.full_output[k], r, rtol=1e-9,
                                   atol=1e-6, err_msg=k)
    assert res.full_state is not None and res.full_state.gam.shape[1] >= 20
    plain = at.atlasqtl(y, x, dtype=torch.float64, device="cpu",
                        p0=(5, 25), verbose=0, user_seed=123)
    assert plain.full_output is None and plain.full_state is None
