"""The port's native C++ preparation pass (atlasqtl_tpu_torch/native, A11)
against its NumPy path, as tests/test_native.py holds the JAX package's,
and against the JAX package's native module and prepare_data on the same
NumPy inputs.  The library is built by g++ at first use: without g++ these
tests skip.  Tolerances: the standardized X to 1e-12 relative between the
paths (they sum in another order), bit for bit between the two packages'
native passes (the same source), flags and names exactly.

The JAX package's library is built here, at import, to a file of this
process and moved onto that package's library path (`_build_jax_native`):
its own build writes one shared `<library>.tmp` from every process that
finds no library, and a process whose `os.replace` loses that race keeps
`get_lib()` None and its prepare_data on the NumPy path (C11).  So every
xdist worker finds the library in place before any test runs, and a test
that compares against the JAX package's native path fails, never skips,
where that library does not load."""
import hashlib
import os
import shutil
import subprocess

import numpy as np
import pytest

from atlasqtl_tpu import native as jnative
from atlasqtl_tpu.io.prepare import prepare_data as jprepare

from atlasqtl_tpu_torch import native
from atlasqtl_tpu_torch.io import prepare as prep
from atlasqtl_tpu_torch.io.prepare import prepare_data, standardize_and_flag


def _build_jax_native(force: bool = False) -> str:
    """The JAX package's native library, compiled with its module's own
    command and flags (atlasqtl_tpu/native/__init__.py:27-31) to a
    temporary file of this process and moved onto that module's library
    path (`_fastprep_<digest>.so`, git-ignored) where it is missing (force:
    in any case).  Returns the path; raises where g++ fails."""
    with open(jnative._SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    so = os.path.join(jnative._DIR, f"_fastprep_{digest}.so")
    if force or not os.path.exists(so):
        tmp = f"{so}.{os.getpid()}.tmp"
        try:
            subprocess.run(["g++", "-O3", "-march=native", "-std=c++17",
                            "-shared", "-fPIC", "-pthread", jnative._SRC,
                            "-o", tmp], check=True, capture_output=True)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return so


if shutil.which("g++") is not None:
    try:
        _build_jax_native()
    except (OSError, subprocess.CalledProcessError):
        pass   # jax_lib fails the tests that need it, with the reason


@pytest.fixture
def lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native pass is built from its source")
    lib = native.get_lib()
    assert lib is not None, native.get_lib.error
    return lib


@pytest.fixture
def jax_lib(lib, monkeypatch):
    """The JAX package's native library, loaded in this process from
    `_build_jax_native`'s file whatever its module's earlier get_lib()
    found (set for the test through monkeypatch), so that its
    standardize_and_flag(use_native=True) takes the native path; fails
    with the reason where it does not load."""
    try:
        so = _build_jax_native()
        try:
            jl = jnative._build_and_load()
        except OSError:   # a partial file another process moved there
            so = _build_jax_native(force=True)
            jl = jnative._build_and_load()
    except (OSError, subprocess.CalledProcessError) as e:
        pytest.fail(f"the JAX package's native library did not build or "
                    f"load: {e}")
    monkeypatch.setattr(jnative, "_tried", True)
    monkeypatch.setattr(jnative, "_lib", jl)
    return jl


def _dup_matrix():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(200, 64))
    x[:, 10] = 3.0                      # constant
    x[:, 20] = x[:, 5]                  # duplicate
    x[:, 21] = x[:, 5]                  # another duplicate of the same col
    return x


def test_native_standardize_matches_numpy(lib):
    x = _dup_matrix()
    xn, cst_n, dup_n, twin_n = standardize_and_flag(x.copy(), use_native=True)
    xp, cst_p, dup_p, twin_p = standardize_and_flag(x.copy(),
                                                    use_native=False)
    np.testing.assert_array_equal(cst_n, cst_p)
    np.testing.assert_array_equal(dup_n, dup_p)
    np.testing.assert_array_equal(twin_n, twin_p)
    keep = ~cst_n
    np.testing.assert_allclose(xn[:, keep], xp[:, keep], rtol=1e-12)
    assert cst_n[10] and dup_n[20] and dup_n[21]
    assert twin_n[20] == 5 and twin_n[21] == 5


def test_native_missing_stats(lib):
    rng = np.random.default_rng(1)
    y = rng.normal(size=(100, 20))
    y[rng.uniform(size=y.shape) < 0.3] = np.nan
    mask, col_obs, col_mean, total = native.missing_stats(y)
    np.testing.assert_array_equal(mask, (~np.isnan(y)).astype(np.uint8))
    np.testing.assert_array_equal(col_obs, (~np.isnan(y)).sum(axis=0))
    np.testing.assert_allclose(col_mean, np.nanmean(y, axis=0), rtol=1e-12)
    assert total == int((~np.isnan(y)).sum())


def _prepare_both(y, x, prepare, module):
    """prepare_data on the NumPy path and, with the size gate forced open,
    on the native path."""
    d_np = prepare(y, x.copy(), 0.1, 100)
    orig = module.standardize_and_flag
    try:
        module.standardize_and_flag = lambda xx, use_native=None: orig(
            xx, use_native=True)
        d_nat = prepare(y, x.copy(), 0.1, 100)
    finally:
        module.standardize_and_flag = orig
    return d_np, d_nat


def _gen_x():
    rng = np.random.default_rng(2)
    x = rng.binomial(2, 0.3, size=(150, 80)).astype(float)
    x[:, 7] = 1.0
    x[:, 30] = x[:, 3]
    return x, rng.normal(size=(150, 12))


def test_prepare_data_native_equals_numpy_path(lib):
    x, y = _gen_x()
    d_np, d_nat = _prepare_both(y, x, prepare_data, prep)
    np.testing.assert_allclose(d_nat.x, d_np.x, rtol=1e-12)
    assert d_nat.rmvd_cst_x == d_np.rmvd_cst_x
    assert d_nat.rmvd_coll_x == d_np.rmvd_coll_x
    np.testing.assert_array_equal(d_nat.bool_rmvd_x, d_np.bool_rmvd_x)


def test_native_equals_the_jax_packages(lib, jax_lib):
    """The same source on the same inputs: the port's three entry points
    give the JAX package's native module's outputs bit for bit."""
    x = _dup_matrix()
    a, b = x.copy(), x.copy()
    cst_t, h_t = native.standardize_and_hash(a)
    cst_j, h_j = jnative.standardize_and_hash(b)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(cst_t, cst_j)
    np.testing.assert_array_equal(h_t, h_j)
    for j1, j2 in ((5, 20), (5, 6), (20, 21)):
        assert native.columns_equal(a, j1, j2) == jnative.columns_equal(
            b, j1, j2)
    y = np.random.default_rng(3).normal(size=(60, 9))
    y[::4, 2] = np.nan
    for u, v in zip(native.missing_stats(y), jnative.missing_stats(y)):
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("path", ["numpy", "native"])
def test_prepare_data_equals_the_jax_packages(lib, jax_lib, path):
    """The port's prepare_data on either path against the JAX package's on
    the same path, NaN in Y included: equal outputs."""
    import atlasqtl_tpu.io.prepare as jprep
    x, y = _gen_x()
    y[np.random.default_rng(4).uniform(size=y.shape) < 0.1] = np.nan
    i = ("numpy", "native").index(path)
    t = _prepare_both(y, x, prepare_data, prep)[i]
    j = _prepare_both(y, x, jprepare, jprep)[i]
    np.testing.assert_array_equal(t.x, j.x)
    np.testing.assert_array_equal(t.y, j.y)
    np.testing.assert_array_equal(t.bool_rmvd_x, j.bool_rmvd_x)
    assert (t.rmvd_cst_x, t.rmvd_coll_x, t.names_x) == \
        (j.rmvd_cst_x, j.rmvd_coll_x, j.names_x)


def test_gate_takes_the_reference_rule(lib, monkeypatch):
    """use_native=None runs the native pass from 2^20 entries of X on, the
    NumPy path below; use_native=True with no library raises."""
    calls = []
    orig = native.standardize_and_hash
    monkeypatch.setattr(native, "standardize_and_hash",
                        lambda x: calls.append(x.size) or orig(x))
    rng = np.random.default_rng(5)
    standardize_and_flag(rng.normal(size=(64, 100)))
    assert calls == []
    standardize_and_flag(rng.normal(size=(1024, 1024)))
    assert calls == [1 << 20]
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    with pytest.raises(RuntimeError, match="unavailable"):
        standardize_and_flag(rng.normal(size=(8, 4)), use_native=True)
