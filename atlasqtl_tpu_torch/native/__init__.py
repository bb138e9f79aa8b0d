"""The multithreaded C++ host preparation pass (fastprep.cpp, a copy of
atlasqtl_tpu/native/fastprep.cpp) and its ctypes bindings, as
atlasqtl_tpu/native/__init__.py has them.

The library is built by g++ at first use, never at import, once per hash of
the source and flags, into atlasqtl_tpu_torch/_build/ (git-ignored); nothing
is written beside the source.  Where no library can be built, `get_lib()`
is None and io/prepare.py takes its NumPy path, as the reference does.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "fastprep.cpp"
_BUILD_DIR = _SRC.parents[1] / "_build"
_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
          "-pthread"]
_lib = None
_tried = False


def build() -> Path:
    """Compile fastprep.cpp with g++ into _build/ (once per source and flag
    hash) and return the library's path; raises where it cannot."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    out = _BUILD_DIR / f"libfastprep_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native preparation pass is "
                           "built from native/fastprep.cpp at first use")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([gxx, *_FLAGS, str(_SRC), "-o", str(tmp)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {_SRC.name} ({r.returncode}):\n"
                           f"{r.stderr}")
    os.replace(tmp, out)
    return out


def _build_and_load():
    lib = ctypes.CDLL(str(build()))
    dp, lg = ctypes.POINTER(ctypes.c_double), ctypes.c_long
    lib.fastprep_standardize.restype = lg
    lib.fastprep_standardize.argtypes = [
        dp, lg, lg, dp, dp, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint64)]
    lib.fastprep_columns_equal.restype = ctypes.c_int
    lib.fastprep_columns_equal.argtypes = [dp, lg, lg, lg, lg]
    lib.fastprep_missing_stats.restype = lg
    lib.fastprep_missing_stats.argtypes = [
        dp, lg, lg, ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(lg), dp]
    return lib


def get_lib():
    """The loaded native library, built at the first call, or None where it
    cannot be built or loaded (`get_lib.error` then says why)."""
    global _lib, _tried
    if not _tried:
        _tried = True
        try:
            _lib = _build_and_load()
        except (OSError, RuntimeError) as e:
            _lib, get_lib.error = None, str(e)
    return _lib


get_lib.error = None


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _need_lib():
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native preparation pass unavailable: "
                           f"{get_lib.error}")
    return lib


def standardize_and_hash(x):
    """Standardize x in place (R scale() semantics), flag its constant
    columns and hash its columns in one multithreaded pass.  x must be
    C-contiguous float64.  Returns (is_constant bool (p,), hashes uint64
    (p,)); constant columns are zero-filled."""
    lib = _need_lib()
    n, p = x.shape
    if not (x.flags.c_contiguous and x.dtype == np.float64):
        raise ValueError("standardize_and_hash: x must be C-contiguous "
                         "float64")
    mean, sd = np.empty(p), np.empty(p)
    is_cst = np.empty(p, dtype=np.uint8)
    hashes = np.empty(p, dtype=np.uint64)
    lib.fastprep_standardize(
        _ptr(x, ctypes.c_double), n, p, _ptr(mean, ctypes.c_double),
        _ptr(sd, ctypes.c_double), _ptr(is_cst, ctypes.c_uint8),
        _ptr(hashes, ctypes.c_uint64))
    return is_cst.astype(bool), hashes


def columns_equal(x, j1, j2):
    """Whether columns j1 and j2 of the C-contiguous float64 x are equal."""
    n, p = x.shape
    return bool(_need_lib().fastprep_columns_equal(
        _ptr(x, ctypes.c_double), n, p, int(j1), int(j2)))


def missing_stats(y):
    """(mask uint8 (n, q), observed count per column (q,), NaN-aware column
    mean (q,), total observed) of y."""
    lib = _need_lib()
    n, q = y.shape
    y = np.ascontiguousarray(y, dtype=np.float64)
    mask = np.empty((n, q), dtype=np.uint8)
    col_obs = np.empty(q, dtype=np.int64)
    col_mean = np.empty(q)
    total = lib.fastprep_missing_stats(
        _ptr(y, ctypes.c_double), n, q, _ptr(mask, ctypes.c_uint8),
        _ptr(col_obs, ctypes.c_long), _ptr(col_mean, ctypes.c_double))
    return mask, col_obs, col_mean, int(total)
