"""The PyTorch port's host-side modules and entry-point rules: data
preparation, elicitation, initialization and the annealing ladder must equal
the JAX package's exactly (the port keeps its own NumPy copies so it never
imports JAX); the port imports no JAX; a missing GPU is an error, never a
silent CPU run; NaN in Y fits in both missing-data modes; options outside
the ported slices (mesh) raise NotImplementedError, and the sweep options
of the B3/B4 kernels route as in the JAX package.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from atlasqtl_tpu.io.prepare import prepare_data as j_prepare
from atlasqtl_tpu.inference import elicitation as j_elic
from atlasqtl_tpu.ops.annealing import annealing_ladder as j_ladder

import atlasqtl_tpu_torch as at
from atlasqtl_tpu_torch.io.prepare import prepare_data as t_prepare
from atlasqtl_tpu_torch.inference import elicitation as t_elic
from atlasqtl_tpu_torch.ops.annealing import annealing_ladder as t_ladder

from conftest import simulate_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("seed,missing_frac", [(123, 0.0), (5, 0.2)])
def test_prepare_elicitation_init_exact(seed, missing_frac):
    y, x, _ = simulate_fixture(seed=seed, missing_frac=missing_frac)
    x = np.concatenate([x, np.ones((x.shape[0], 1)), x[:, :2]], axis=1)
    dj = j_prepare(y, x, 0.1, 1000)
    dt = t_prepare(y, x, 0.1, 1000)
    for f in ("y", "x", "bool_rmvd_x"):
        assert np.array_equal(getattr(dj, f), getattr(dt, f), equal_nan=True)
    for f in ("initial_colnames_x", "rmvd_cst_x", "rmvd_coll_x", "names_x",
              "names_y", "names_n"):
        assert getattr(dj, f) == getattr(dt, f)
    p = dt.x.shape[1]
    hj = j_elic.auto_set_hyper(dj.y, p, (5, 25))
    ht = t_elic.auto_set_hyper(dt.y, p, (5, 25))
    ij = j_elic.auto_set_init(dj.y, p, (5, 25), 20.0, seed)
    it = t_elic.auto_set_init(dt.y, p, (5, 25), 20.0, seed)
    for a, b in ((hj, ht), (ij, it)):
        for k, v in vars(a).items():
            assert np.array_equal(np.asarray(v), np.asarray(getattr(b, k))), k


@pytest.mark.parametrize("anneal", [(1, 2, 10), (2, 5.5, 30), (3, 1.5, 7)])
def test_annealing_ladder_exact(anneal):
    assert np.array_equal(j_ladder(anneal), t_ladder(anneal))


def test_port_imports_no_jax():
    code = ("import sys, atlasqtl_tpu_torch, atlasqtl_tpu_torch.convert\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'atlasqtl_tpu')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_default_device_requires_gpu(fixture_small):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs on it")
    y, x, _ = fixture_small
    with pytest.raises(RuntimeError, match="device='cpu'"):
        at.atlasqtl(y, x, p0=(5, 25), verbose=0)


@pytest.mark.parametrize("kwargs,item", [
    (dict(mesh=object()), "A12"),
])
def test_unported_options_raise(fixture_small, kwargs, item):
    y, x, _ = fixture_small
    with pytest.raises(NotImplementedError, match=item):
        at.atlasqtl(y, x, p0=(5, 25), verbose=0, device="cpu", **kwargs)


def test_missing_modes_run_and_unknown_mode_raises():
    """NaN in Y fits on the CPU in both modes; any other mode is an error."""
    y, x, _ = simulate_fixture(missing_frac=0.2, seed=5)
    kw = dict(p0=(5, 25), verbose=0, device="cpu", user_seed=1, maxit=20)
    for missing in ("exact", "impute"):
        res = at.atlasqtl(y, x, missing=missing, **kw)
        assert res.gam_vb.shape == (75, 20)
        assert np.isfinite(res.gam_vb).all() and np.isfinite(res.lb_opt)
    with pytest.raises(ValueError, match="missing must be"):
        at.atlasqtl(y, x, missing="bogus", **kw)


@pytest.mark.parametrize("field,value,item", [
    ("mxu_bf16", True, "B5"), ("sweep_probe", "nomxu", "B5"),
    ("mis_pair_bf16", True, "B5"),
])
def test_unported_config_raises(field, value, item):
    from atlasqtl_tpu_torch.models.global_local import check_config
    check_config(at.Config(sweep_lookahead=True, sweep_interleave=True,
                           sweep_qchunk=64, sweep_sub=16))
    with pytest.raises(NotImplementedError, match=item):
        check_config(at.Config(**{field: value}))


class _FakeData:
    def __init__(self, x, y):
        self.x, self.y = x, y


@pytest.mark.parametrize("field,value", [
    ("sweep", "pallas"), ("use_pallas", True), ("sweep_stagger", True),
])
def test_ported_sweep_configs_route_as_jax(field, value):
    """The B3 and B4 configurations pass check_config and pick the engine
    JAX's _select_sweep picks on the CPU, in both dtypes."""
    import jax.numpy as jnp
    from atlasqtl_tpu.types import Config as JConfig
    from atlasqtl_tpu.models.global_local import _select_sweep as j_select
    from atlasqtl_tpu_torch.models.global_local import (_select_sweep,
                                                        check_config)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.float64, torch.float64)):
        cfg = at.Config(dtype=tdt, **{field: value})
        check_config(cfg)
        jd = _FakeData(np.zeros((100, 256), np.float32),
                       np.zeros((100, 512), np.float32))
        td = _FakeData(torch.zeros(100, 256), torch.zeros(100, 512))
        assert _select_sweep(cfg, td) == j_select(
            JConfig(dtype=jdt, **{field: value}), jd)


def test_convert_defaults_to_the_gpu():
    """convert.py's builders take device=None as the GPU, like atlasqtl()."""
    from atlasqtl_tpu_torch import convert
    arrays = {"eta": np.ones(3), "nu": np.float64(1.0)}
    assert convert.hyper_from_numpy(arrays, device="cpu").eta.device.type \
        == "cpu"
    if torch.cuda.is_available():
        assert convert.hyper_from_numpy(arrays).eta.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            convert.hyper_from_numpy(arrays)
