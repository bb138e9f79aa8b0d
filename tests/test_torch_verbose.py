"""verbose=2's hotspot-scale diagnostics: at each logged ELBO evaluation the
driver logs the global scale and the quantiles of the local scales
(atlasqtl_tpu/inference/driver.py:316-332, R/atlasqtl_global_local_core.R:
297-305).  A float64 CPU fit of each package from the same data logs them
at the same iterations, and their numbers agree to 1e-6 relative."""
import logging
import re

import numpy as np
import torch
import jax.numpy as jnp

import atlasqtl_tpu as aq
import atlasqtl_tpu_torch as at

from conftest import simulate_fixture

_NUM = re.compile(r"[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?")


def _records(caplog, logger, fit):
    caplog.clear()
    with caplog.at_level(logging.INFO, logger=logger):
        fit()
    msgs = [r.getMessage() for r in caplog.records if r.name == logger]
    # each diagnostic pair follows the ELBO line of its iteration
    out, it = [], None
    for m in msgs:
        if m.startswith("Iteration") and "ELBO" in m:
            it = int(m.split()[1].rstrip(":"))
        elif "hotspot propensity" in m:
            out.append((it, _NUM.sub("#", m),
                        [float(v) for v in _NUM.findall(m)]))
    return out


def test_verbose2_logs_the_reference_hotspot_scales(caplog):
    y, x, _ = simulate_fixture(n=100, p=75, q=20, seed=123)
    kw = dict(p0=(5, 25), verbose=2, user_seed=123, anneal=(1, 2, 5))
    ref = _records(caplog, "atlasqtl_tpu",
                   lambda: aq.atlasqtl(y, x, dtype=jnp.float64, **kw))
    got = _records(caplog, "atlasqtl_tpu_torch",
                   lambda: at.atlasqtl(y, x, dtype=torch.float64,
                                       device="cpu", **kw))
    assert len(ref) >= 4 and len(got) == len(ref)
    for (it_r, text_r, nums_r), (it_g, text_g, nums_g) in zip(ref, got):
        assert (it_g, text_g) == (it_r, text_r)
        np.testing.assert_allclose(nums_g, nums_r, rtol=1e-6)


def test_verbose1_logs_no_hotspot_scales(caplog):
    y, x, _ = simulate_fixture(n=100, p=75, q=20, seed=123)
    got = _records(caplog, "atlasqtl_tpu_torch",
                   lambda: at.atlasqtl(y, x, p0=(5, 25), verbose=1,
                                       user_seed=123, anneal=(1, 2, 5),
                                       dtype=torch.float64, device="cpu"))
    assert got == []
