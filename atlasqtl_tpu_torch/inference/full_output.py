"""Named, unpadded `full_output` assembly (counterpart of
atlasqtl_tpu/inference/full_output.py).

The reference's `full_output = TRUE` mode ("for internal use only") returns
the named list of internal variational quantities
(R/atlasqtl_global_local_core.R:404-410; global-only variant
R/atlasqtl_global_core.R:340-343).  This module rebuilds that surface from
the padded device state: every array is cut to the true (p, q) and
returned as float64 NumPy.

The Gamma factors (eta/kappa/nu/rho) are not carried in VBState; as in the
JAX package they are re-derived once from the final state at c = 1.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from ..types import Config, Data, Hyper, VBState
from ..models.global_local import _colsum_stats
from ..ops import updates as upd

log = logging.getLogger("atlasqtl_tpu_torch")

# p above which the p x p Gram matrix cp_X is not formed (the fit itself
# never forms it; at p = 50k it would be 20 GB of float64)
MAX_P_FOR_GRAM = 20_000


def _f(a) -> np.ndarray:
    return a.detach().to(torch.float64).cpu().numpy()


def assemble_full_output(data: Data, hyper: Hyper, state: VBState,
                         cfg: Config, model: str = "global_local") -> dict:
    """Reference-named dict of internal quantities (unpadded, float64)."""
    p = int(round(float(data.p_true)))
    q = int(round(float(data.q_true)))

    (gam_colsum, m2b_colsum, beta2_colsum, yf_colsum, ff_colsum, m2b,
     beta) = _colsum_stats(data, state, use_cached=False)

    impute = data.mis_pat is not None and data.x_norm_sq is None
    cp_x_y = data.cp_x_y
    y_norm_sq = data.y_norm_sq
    if impute:
        v_mis = 1.0 / state.tau
        y_eff = data.y + (1.0 - data.mis_pat) * state.fitted
        cp_x_y = data.x.T @ y_eff
        y_norm_sq = (torch.einsum("nq,nq->q", y_eff, y_eff)
                     + data.n_mis * v_mis)
        yf_colsum = torch.einsum("nq,nq->q", y_eff, state.fitted)

    sum_gam = torch.sum(gam_colsum * data.q_mask)
    nu_vb = upd.nu_update(hyper.nu, sum_gam)
    rho_vb = upd.rho_update(hyper.rho, m2b_colsum, state.tau, data.q_mask)
    eta_vb = upd.eta_update(data.n_eff, hyper.eta, gam_colsum)
    xns_m2b = xns_b2 = None
    if data.x_norm_sq is not None:
        xns_m2b = torch.einsum("pq,pq->q", data.x_norm_sq, m2b)
        xns_b2 = torch.einsum("pq,pq->q", data.x_norm_sq, beta * beta)
    kappa_vb = upd.kappa_update(data.n, y_norm_sq, yf_colsum, ff_colsum,
                                hyper.kappa, m2b_colsum, beta2_colsum,
                                state.sig2_inv, x_norm_sq_m2b=xns_m2b,
                                x_norm_sq_beta2=xns_b2)

    sig2_zeta_vb = 1.0 / (float(data.p_true) + 1.0 / float(hyper.t02))

    sig2_beta = _f(state.sig2_beta)
    sig2_beta_vb = sig2_beta[:p, :q] if sig2_beta.ndim == 2 else sig2_beta[:q]

    out = {
        "beta_vb": _f(state.gam * state.mu_beta)[:p, :q],
        "eta_vb": _f(eta_vb)[:q],
        "gam_vb": _f(state.gam)[:p, :q],
        "kappa_vb": _f(kappa_vb)[:q],
        "nu_s0_vb": float(state.nu_s0_vb),
        "nu_vb": float(nu_vb),
        "rho_s0_vb": float(state.rho_s0_vb),
        "rho_vb": float(rho_vb),
        "shr_fac_inv": float(cfg.shr_fac_inv),
        "sig02_inv_vb": float(state.sig02_inv),
        "sig2_beta_vb": sig2_beta_vb,
        "sig2_inv_vb": float(state.sig2_inv),
        "sig2_theta_vb": _f(state.sig2_theta)[:p],
        "sig2_zeta_vb": sig2_zeta_vb,
        "tau_vb": _f(state.tau)[:q],
        "theta_vb": _f(state.theta)[:p],
        "zeta_vb": _f(state.zeta)[:q],
    }
    if model == "global_local":
        # horseshoe block + the Gram-space sufficient statistics
        # (R/atlasqtl_global_local_core.R:404-410)
        out.update({
            "lam2_inv_vb": _f(state.lam2_inv)[:p],
            "nu_xi_inv_vb": 1.0,
            "rho_xi_inv_vb": float(state.rho_xi_inv),
            "xi_inv_vb": 1.0 / float(state.rho_xi_inv),
            "cp_Y_X": _f(cp_x_y).T[:q, :p],
            "cp_X_Xbeta": _f(data.x.T @ state.fitted)[:p, :q],
        })
        if p <= MAX_P_FOR_GRAM:
            out["cp_X"] = _f(data.x.T @ data.x)[:p, :p]
        else:
            out["cp_X"] = None
            log.warning("full_output: cp_X (p x p Gram) not formed at "
                        "p=%d > %d: the fit never forms it", p,
                        MAX_P_FOR_GRAM)
    return out

