"""State containers of the PyTorch port (counterpart of atlasqtl_tpu/types.py).

Frozen dataclasses of tensors with the reference package's field names, so a
state can be handed between the two packages field by field
(convert.py):
- Hyper      <-> `list_hyper` (R/set_hyper_init.R:98-197)
- VBState    <-> the variational parameters carried through the CAVI loop
                 (R/atlasqtl_global_local_core.R:45-63, 112-123)
- Data       <-> the precomputed sufficient statistics
                 (R/atlasqtl_global_local_core.R:19-42)

Padding rules are the reference's: n -> multiple of 8, p -> multiple of the
predictor block, q -> multiple of 8; padded entries are zero-filled and
masked out of every reduction.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class Hyper:
    """Model hyperparameters. eta, kappa, n0: (q,); nu, rho, t02, m0,
    a2_inv: 0-d tensors."""
    eta: Any
    kappa: Any
    n0: Any
    nu: Any
    rho: Any
    t02: Any
    m0: Any
    a2_inv: Any


@dataclasses.dataclass(frozen=True)
class VBState:
    """Variational parameters + carried sufficient statistics.

    Shapes (padded): gam/mu_beta/beta (p, q); theta/lam2_inv/sig2_theta/l_vb
    (p,); tau/zeta/sig2_beta and the three column statistics (q,);
    sig2_inv/sig02_inv/rho_xi_inv/nu_s0_vb/rho_s0_vb 0-d; fitted (n, q) is the
    carried residual statistic F = X @ beta.

    beta = gam * mu_beta is what the complete-data sweep reads and writes;
    gam/mu_beta are refreshed only on "full" iterations and may be stale on
    "lite" ones.  On the exact-missing path sig2_beta is (p, q), fitted is
    the masked Fm = mis_pat * (X @ beta), gam/mu_beta are always fresh, and
    beta and the three column statistics are None (recomputed each
    iteration).
    """
    gam: Any
    mu_beta: Any
    sig2_beta: Any
    tau: Any
    sig2_inv: Any
    theta: Any
    zeta: Any
    sig02_inv: Any
    lam2_inv: Any
    sig2_theta: Any
    fitted: Any
    l_vb: Any
    rho_xi_inv: Any
    nu_s0_vb: Any
    rho_s0_vb: Any
    gam_colsum: Any = None
    mu2gam_colsum: Any = None
    beta2_colsum: Any = None
    beta: Any = None


@dataclasses.dataclass(frozen=True)
class Data:
    """Preprocessed data + one-time sufficient statistics.

    x: (n, p) standardized predictors; y: (n, q) centered responses (missing
    cells set to 0); cp_x_y: (p, q) X^T Y; y_norm_sq: (q,); n_eff/n_mis:
    (q,) observed and missing counts per response; p_mask (p,) and q_mask
    (q,) are 1.0 on real entries and 0.0 on padding; n, p_true, q_true: 0-d
    tensors holding the true sizes.

    With missing values in Y, mis_pat (n, q) is 1.0 where a cell is observed
    (padded responses observed, padded samples not).  The exact path adds
    x_norm_sq (p, q) = (X * X)^T mis_pat and, for the blocked CPU engine,
    mis_pair_gram (nb, B(B-1)/2, q); both are None in impute mode and for
    complete data, and mis_pat is None for complete data.
    """
    x: Any
    y: Any
    cp_x_y: Any
    y_norm_sq: Any
    mis_pat: Any
    x_norm_sq: Any
    n_eff: Any
    n_mis: Any
    p_mask: Any
    q_mask: Any
    n: Any
    p_true: Any
    q_true: Any
    mis_pair_gram: Any = None


@dataclasses.dataclass(frozen=True)
class Config:
    """Static configuration of the CAVI engine — the reference's fields
    (atlasqtl_tpu/types.py:132-216).

    Fields that select a TPU schedule (sweep_lookahead, sweep_interleave,
    sweep_qchunk, sweep_sub) are accepted and ignored: they never change the
    math.  Fields that select a path the port does not have yet are
    rejected by models/global_local.py:check_config.
    """
    block_size: int = 128
    dtype: Any = torch.float32
    elbo_dtype: Any = torch.float64
    use_pallas: bool = False
    sweep: str = "auto"   # "auto" | "fused" | "xla"
    tol: float = 0.1
    maxit: int = dataclasses.field(default=1000, compare=False)
    df: int = 1
    shr_fac_inv: float = 1.0
    missing: str = "exact"
    mis_block: int = 8
    mis_sub: int = 16
    mis_wgroup: int = 1
    mis_pair_bf16: bool = False
    anneal_scale: bool = True
    mxu_bf16: bool = False
    sweep_sub: int = 0
    sweep_lookahead: bool = False
    sweep_qchunk: int = 0
    sweep_stagger: bool = False
    sweep_interleave: bool = False
    sweep_probe: str = "none"
    debug: bool = True
    thinned_elbo_eval: bool = True
    device_loop: str = "auto"
    q_axis: Optional[str] = None
    p_axis: Optional[str] = None
    pipeline_step_overhead_qcols: float = 0.0
