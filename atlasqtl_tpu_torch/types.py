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

    x_bf16 (n, p) is x rounded to bfloat16 (round to nearest even, as
    JAX's astype), the operand B1 stages under Config.mxu_bf16; built once
    per fit where that flag reaches B1, else None.  goff (p, B) holds the
    float32 off-diagonal Gram blocks x_{b+1}^T x_b of the lookahead
    schedule (ops/sweep_fused.py:lookahead_gram); built once per fit where
    Config.sweep_lookahead reaches B1 (under mxu_bf16), else None.

    mesh is the parallel/mesh.py Mesh whose local shards the tensors are
    (parallel/mesh.py:shard_data), None for one device: the model's
    cross-shard reductions run on its process groups.
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
    x_bf16: Any = None
    goff: Any = None
    mesh: Any = None


@dataclasses.dataclass(frozen=True)
class Config:
    """Static configuration of the CAVI engine — the reference's fields
    (atlasqtl_tpu/types.py:132-216).

    Fields that select a TPU schedule (sweep_interleave, sweep_qchunk)
    are accepted and ignored: they never change the math.  sweep_sub, the
    JAX kernel's chain window, is read only under sweep_probe, where it
    changes the math under noseq and norank (the window is sweep_sub, or 8
    at a padded n up to 2048 and 32 above, clipped to the block; one that
    does not divide the block raises ValueError).  sweep_probe selects one
    of the JAX fused kernel's perf probes (wrong math by design; each
    drops one phase of the sweep: ops/sweep_fused.py:PROBES), which B1
    runs where the JAX package passes it to its fused kernel
    (models/global_local.py:_b1_probe); an unknown value raises
    ValueError.
    sweep_lookahead, the TPU kernel's one-block-lookahead schedule, is
    ignored in float32, where it is the baseline's algebra up to rounding
    (tests/test_pallas.py:test_fused_lookahead_matches_baseline), and
    honoured under mxu_bf16 on B1, where it is another function: block b
    projects the bf16 F from before block b-1's advance, and block b-1's
    float32 deltas come in through the float32 off-diagonal Gram
    (ops/sweep_fused.py:sweep_fused).  Fields that select a path the port
    does not have yet are rejected by models/global_local.py:check_config.

    The two bf16 modes, sweep_lookahead and sweep_stagger are honoured
    where the JAX package honours them, which includes its q-tile rules
    (models/global_local.py:fused_q_tile, mis_fused_q_tile): the bf16
    flags only at a padded q (per shard on a mesh) that is a multiple of
    128, sweep_stagger (B4) only at a tile of 256 or more; elsewhere B1 or
    B2 runs the float32 function.  In detail:
    - mxu_bf16: B1 (ops/sweep_fused.py, complete data and impute) rounds
      the operands of its two large products, r0 = x_b^T F and
      F += x_b delta, to bfloat16 and accumulates in float32 (on the card
      on tensor cores); the chain's Gram corrections and the interpolation
      products stay float32.  The B3, B4 and plain routes ignore it, as
      the JAX package's do (so does the exact-missing path); with
      sweep_lookahead B1 takes the lookahead schedule above.
    - mis_pair_bf16: B2 (ops/sweep_missing_fused.py, exact missing) takes
      the JAX kernel's windows of mis_sub predictors (16 by default,
      clipped to the block) and rounds each masked pair-Gram product
      x_na x_nb inside a window to bfloat16 (the f32 product rounded once,
      then to bf16; the mask stays exact), summed in float32.  The flag
      reaches B2 only where the JAX package sends the sweep to its fused
      kernel: float32, block_size 128 and a padded p that is a multiple of
      128 (models/global_local.py:_b2_pair_bf16); everywhere else, as the
      JAX package's blocked and scan engines, the fit is the float32 fit.
      There mis_sub must divide 128 (ValueError): 1, 2, 4, ..., 128.
      Under a mesh the flag is ignored, as the JAX package never takes its
      fused missing kernel there.  In float32 the window does
      not change the math, and mis_sub and mis_wgroup are ignored.
    """
    block_size: int = 128
    dtype: Any = torch.float32
    elbo_dtype: Any = torch.float64
    use_pallas: bool = False
    sweep: str = "auto"   # "auto" | "fused" | "pallas" | "xla"
    tol: float = 0.1
    maxit: int = dataclasses.field(default=1000, compare=False)
    df: int = 1
    shr_fac_inv: float = 1.0
    missing: str = "exact"
    mis_block: int = 8
    mis_sub: int = 16     # the window of mis_pair_bf16, in predictors
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
    # the mesh's axis names, set by atlasqtl(mesh=...) from the mesh
    # (parallel/mesh.py): q_axis "q" on any mesh, p_axis "p" on a 2-D one;
    # None for one device
    q_axis: Optional[str] = None
    p_axis: Optional[str] = None
    # the 2-D pipeline's per-step overhead in q columns of tile compute
    # (parallel/pipeline.py:pick_q_tile); 0 takes the asymptotic rule
    pipeline_step_overhead_qcols: float = 0.0
