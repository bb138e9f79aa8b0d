"""Permutation-null calibration for hotspot/association calling
(counterpart of atlasqtl_tpu/inference/permutation.py): fit the model on
row-permuted copies of Y (which destroys every X-Y association while
keeping the correlation structure within Y), collect the null distribution
of the largest posterior inclusion probability per permutation, and return
the PIP threshold that controls the family-wise or empirical FDR at the
requested level.

The random sequence is the JAX package's (np.random.default_rng(seed):
the permutation, then the fit's seed, per permutation), so one seed gives
the same permuted fits in both packages.
"""
from __future__ import annotations

import numpy as np


def permutation_null_calibration(Y, X, p0, n_perms: int = 10,
                                 fdr: float = 0.05, seed: int = 0,
                                 statistic: str = "max_pip",
                                 **atlasqtl_kwargs):
    """Estimate a PIP calling threshold from permuted-Y null fits.

    statistic: "max_pip" (per-permutation maximum PIP -> threshold is the
    (1-fdr) quantile of the null maxima; controls the probability of any
    false call) or "pip_pool" (pooled null PIPs -> empirical-FDR
    threshold).  atlasqtl_kwargs go to every fit (device="cpu" runs them on
    the CPU; the default is the GPU).

    Returns dict(threshold, null_stats, n_perms).
    """
    from ..api import atlasqtl

    if statistic not in ("max_pip", "pip_pool"):
        raise ValueError("statistic must be 'max_pip' or 'pip_pool'")
    rng = np.random.default_rng(seed)
    Y = np.asarray(Y, dtype=np.float64)
    atlasqtl_kwargs.setdefault("verbose", 0)
    null_max = []
    null_pool = []
    for _ in range(n_perms):
        perm = rng.permutation(Y.shape[0])
        res = atlasqtl(Y[perm], X, p0=p0,
                       user_seed=int(rng.integers(2 ** 31)),
                       **atlasqtl_kwargs)
        null_max.append(float(res.gam_vb.max()))
        if statistic == "pip_pool":
            null_pool.append(np.asarray(res.gam_vb).ravel())

    null_max = np.asarray(null_max)
    if statistic == "max_pip":
        thr = float(np.quantile(null_max, 1.0 - fdr))
    else:
        pool = np.concatenate(null_pool)
        thr = float(np.quantile(pool, 1.0 - fdr / pool.size))
    return {"threshold": thr, "null_stats": null_max, "n_perms": n_perms}
