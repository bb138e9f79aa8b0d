"""Host-side data preparation and validation.

Copy of atlasqtl_tpu/io/prepare.py restricted to its NumPy path (the C++
preparation pass of atlasqtl_tpu/native is not ported yet), kept in the port
so it never imports the JAX package.  Re-design of R/prepare_atlasqtl.R:8-124
and the column-removal utilities (R/utils.R:276-343)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class PreparedData:
    y: np.ndarray                 # (n, q) centered, NaNs preserved
    x: np.ndarray                 # (n, p) standardized, constant/collinear cols removed
    bool_rmvd_x: np.ndarray       # (p_orig,) True where column removed
    initial_colnames_x: list      # names after constant removal, before collinear removal
    rmvd_cst_x: list              # names of removed constant columns
    rmvd_coll_x: dict             # removed-duplicate name -> kept twin name
    names_x: list
    names_y: list
    names_n: list


def _check_matrix(m, name):
    m = np.asarray(m)
    if m.ndim != 2 or m.size == 0:
        raise ValueError(f"{name} must be a non-empty 2-D matrix")
    if not np.issubdtype(m.dtype, np.number):
        raise ValueError(f"{name} must be numeric")
    return np.asarray(m, dtype=np.float64)


def standardize_columns(x):
    """R-style scale(): center and divide by the (n-1)-denominator sd."""
    mean = x.mean(axis=0)
    sd = x.std(axis=0, ddof=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        return (x - mean) / sd


def standardize_and_flag(x):
    """Standardize columns and flag constants/duplicates in one pass.

    Returns (x_standardized, bool_cst (p,), bool_dup (p,), twin (p,)).
    Constant columns come back NaN-filled and are removed by the caller.
    bool_dup/twin are computed among non-constant columns only.
    """
    p = x.shape[1]
    x = standardize_columns(x)
    bool_cst = np.isnan(x.sum(axis=0))
    x_nc = x[:, ~bool_cst]
    dup_nc, twin_nc = find_duplicate_columns(x_nc)
    bool_dup = np.zeros(p, dtype=bool)
    twin = np.full(p, -1, dtype=np.int64)
    nc_idx = np.where(~bool_cst)[0]
    bool_dup[nc_idx] = dup_nc
    twin[nc_idx[dup_nc]] = nc_idx[twin_nc[dup_nc]]
    return x, bool_cst, bool_dup, twin


def find_duplicate_columns(x):
    """Exact duplicate columns, R `duplicated(mat, MARGIN = 2)` semantics:
    a column is flagged if an identical column appeared earlier.
    Returns (bool_dup (p,), twin_index (p,) with -1 for non-dups)."""
    p = x.shape[1]
    bool_dup = np.zeros(p, dtype=bool)
    twin = np.full(p, -1, dtype=np.int64)
    seen: dict = {}
    # hash columns first, confirm with exact compare to dodge collisions
    keys = [hash(x[:, j].tobytes()) for j in range(p)]
    for j in range(p):
        k = keys[j]
        if k in seen:
            for i in seen[k]:
                if np.array_equal(x[:, i], x[:, j]):
                    bool_dup[j] = True
                    twin[j] = i
                    break
            else:
                seen[k].append(j)
        else:
            seen[k] = [j]
    return bool_dup, twin


def prepare_data(y, x, tol, maxit, user_seed=None, verbose=1,
                 checkpoint_path=None, trace_path=None,
                 names_x=None, names_y=None, names_n=None) -> PreparedData:
    """Validate + preprocess (reference: prepare_data_, R/prepare_atlasqtl.R:8-87).

    - X standardized; constant then exactly-duplicated columns removed,
      duplicates mapped to their kept twin;
    - Y centered (NaN-aware), not scaled;
    - missingness thresholds enforced (>=5% observed overall, each column
      >=2.5% observed).
    """
    import os

    if tol <= 0:
        raise ValueError("tol must be positive")
    if maxit < 1 or int(maxit) != maxit:
        raise ValueError("maxit must be a natural number")
    if checkpoint_path is not None and not os.path.isdir(checkpoint_path):
        raise ValueError("checkpoint_path directory does not exist")
    if trace_path is not None and not os.path.isdir(trace_path):
        raise ValueError("trace_path directory does not exist")

    # dimension-name extraction + consistency (reference:
    # R/prepare_atlasqtl.R:47-55): pandas DataFrames (or anything exposing
    # .index/.columns) supply row/column names; when both X and Y carry row
    # names they must agree.
    def _frame_names(m):
        idx = getattr(m, "index", None)
        cols = getattr(m, "columns", None)
        to_list = lambda v: None if v is None else [str(e) for e in v]
        return to_list(idx), to_list(cols)

    rown_x, coln_x = _frame_names(x)
    rown_y, coln_y = _frame_names(y)
    if rown_x is not None and rown_y is not None and rown_x != rown_y:
        raise ValueError("The provided rownames of X and Y must be the same.")
    if names_n is None:
        names_n = rown_x if rown_x is not None else rown_y
    if names_x is None:
        names_x = coln_x
    if names_y is None:
        names_y = coln_y

    x = _check_matrix(x, "X")
    y = _check_matrix(y, "Y")
    if np.isnan(x).any():
        raise ValueError("X cannot contain NAs")

    n, p = x.shape
    if y.shape[0] != n:
        raise ValueError("X and Y must have the same number of samples")
    q = y.shape[1]

    obs = ~np.isnan(y)
    if obs.sum() / (n * q) < 0.05:
        raise ValueError("Too few non-NA values in matrix Y")
    frac_obs = obs.sum(axis=0) / n
    if (frac_obs < 0.025).any():
        bad = np.where(frac_obs < 0.025)[0]
        raise ValueError(f"Column(s) {bad.tolist()} of Y have more than 97.5% "
                         "missing values and should be removed")

    names_n = list(names_n) if names_n is not None else [f"Ind_{i+1}" for i in range(n)]
    names_x = list(names_x) if names_x is not None else [f"Cov_x_{j+1}" for j in range(p)]
    names_y = list(names_y) if names_y is not None else [f"Resp_{k+1}" for k in range(q)]

    # standardize + constant-column + duplicate-column detection in one pass
    # (reference: scale/rm_constant_/rm_collinear_)
    x, bool_cst, bool_dup, twin = standardize_and_flag(x)
    rmvd_cst = [names_x[j] for j in np.where(bool_cst)[0]]
    keep = ~bool_cst
    kept_names = [names_x[j] for j in np.where(keep)[0]]
    initial_colnames_x = list(kept_names)

    rmvd_coll = {names_x[j]: names_x[twin[j]]
                 for j in np.where(bool_dup)[0]}
    keep_final = keep & ~bool_dup
    bool_coll = bool_dup[keep]
    x = x[:, keep_final]
    final_names = [names_x[j] for j in np.where(keep_final)[0]]

    bool_rmvd = bool_cst.copy()
    bool_rmvd[~bool_cst] = bool_coll

    if x.shape[1] < 1:
        raise ValueError("There must be at least 1 non-constant candidate "
                         "predictor stored in X")

    # center Y (NaN-aware), do not scale
    y = y - np.nanmean(y, axis=0)

    return PreparedData(
        y=y, x=x, bool_rmvd_x=bool_rmvd,
        initial_colnames_x=initial_colnames_x,
        rmvd_cst_x=rmvd_cst, rmvd_coll_x=rmvd_coll,
        names_x=final_names, names_y=names_y, names_n=names_n,
    )


def add_collinear_back(beta_vb, gam_vb, theta_vb, initial_colnames_x,
                       rmvd_coll_x, names_x):
    """Re-insert removed duplicate predictors, copying each duplicate's
    posterior summaries from its kept twin (reference: add_collinear_back_,
    R/utils.R:671-733).  Returns (beta_full, gam_full, theta_full, row_names).
    """
    p_all = len(initial_colnames_x)
    q = gam_vb.shape[1]
    gam_full = np.full((p_all, q), np.nan)
    beta_full = np.full((p_all, q), np.nan)
    theta_full = np.full(p_all, np.nan)

    name_to_row = {nm: i for i, nm in enumerate(initial_colnames_x)}
    kept_rows = [name_to_row[nm] for nm in names_x]
    gam_full[kept_rows] = gam_vb
    beta_full[kept_rows] = beta_vb
    theta_full[kept_rows] = theta_vb

    kept_pos = {nm: i for i, nm in enumerate(names_x)}
    for dup_name, twin_name in rmvd_coll_x.items():
        src = kept_pos[twin_name]
        dst = name_to_row[dup_name]
        gam_full[dst] = gam_vb[src]
        beta_full[dst] = beta_vb[src]
        theta_full[dst] = theta_vb[src]

    return beta_full, gam_full, theta_full, list(initial_colnames_x)
