"""Permutation-null calibration in the port
(inference/permutation.py), on the CPU: tests/test_permutation.py's three
cases (BASELINE config 3, scaled down) with device="cpu", and the
calibration against the JAX package's for the same seed (the same
permutations and fit seeds), threshold and null statistics at 1e-6
(tests/test_torch_model.py's end-to-end tolerance)."""
import numpy as np
import torch
import jax.numpy as jnp

from atlasqtl_tpu.inference.permutation import \
    permutation_null_calibration as j_cal

import atlasqtl_tpu_torch as at
from atlasqtl_tpu_torch import permutation_null_calibration

from conftest import simulate_fixture

KW = dict(dtype=torch.float64, verbose=0, anneal=None, maxit=400,
          device="cpu")


def test_threshold_separates_signal_from_null():
    y, x, p_act = simulate_fixture(n=120, p=60, p_act=6, q=24, seed=3)
    cal = permutation_null_calibration(y, x, p0=(5, 25), n_perms=4,
                                       fdr=0.05, seed=0, **KW)
    assert cal["n_perms"] == 4
    assert cal["null_stats"].shape == (4,)
    assert 0.0 < cal["threshold"] <= 1.0

    res = at.atlasqtl(y, x, p0=(5, 25), user_seed=7, **KW)
    calls = np.asarray(res.gam_vb) > cal["threshold"]
    # true hotspots called, and every call lands in the active block
    assert calls[:p_act].sum() > 10
    assert calls[p_act:].sum() == 0


def test_null_data_calls_nothing():
    y, x, _ = simulate_fixture(n=120, p=60, p_act=6, q=24, seed=3)
    rng = np.random.default_rng(42)
    y_null = rng.permutation(y, axis=0)  # destroy X-Y association
    cal = permutation_null_calibration(y_null, x, p0=(5, 25), n_perms=4,
                                       fdr=0.05, seed=1, **KW)
    res = at.atlasqtl(y_null, x, p0=(5, 25), user_seed=7, **KW)
    assert (np.asarray(res.gam_vb) > cal["threshold"]).sum() == 0


def test_pip_pool_statistic():
    y, x, p_act = simulate_fixture(n=120, p=60, p_act=6, q=24, seed=3)
    cal = permutation_null_calibration(y, x, p0=(5, 25), n_perms=2,
                                       fdr=0.05, seed=0,
                                       statistic="pip_pool", **KW)
    assert 0.0 < cal["threshold"] <= 1.0
    res = at.atlasqtl(y, x, p0=(5, 25), user_seed=7, **KW)
    calls = np.asarray(res.gam_vb) > cal["threshold"]
    assert calls[:p_act].sum() > 10


def test_calibration_matches_jax():
    y, x, _ = simulate_fixture(n=120, p=60, p_act=6, q=24, seed=3)
    kw = dict(p0=(5, 25), n_perms=2, fdr=0.05, seed=4, verbose=0,
              anneal=None, maxit=400)
    ref = j_cal(y, x, dtype=jnp.float64, **kw)
    got = permutation_null_calibration(y, x, dtype=torch.float64,
                                       device="cpu", **kw)
    assert got["n_perms"] == ref["n_perms"] == 2
    np.testing.assert_allclose(got["null_stats"], ref["null_stats"],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["threshold"], ref["threshold"], rtol=0,
                               atol=1e-6)
