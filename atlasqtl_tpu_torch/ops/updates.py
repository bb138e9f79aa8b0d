"""Closed-form VB updates in PyTorch (counterpart of
atlasqtl_tpu/ops/updates.py; re-design of R/update_vb.R).

The complete-data updates the global-local iteration uses.  The annealing
inverse temperature `c` enters as in the reference (tempered natural
parameters).  Padded predictors/responses carry mask 0 and are excluded
from every reduction.
"""
from __future__ import annotations

import torch

from .special import digamma


def sig2_beta_update(n, sig2_inv, tau, c=1.0):
    """Posterior slab variance, complete data: 1/(c (n-1+sig2_inv) tau)
    (reference: R/update_vb.R:33-50)."""
    return 1.0 / (c * (n - 1.0 + sig2_inv) * tau)


def nu_update(nu, sum_gam, c=1.0):
    """Slab-precision shape (reference: R/update_vb.R:116)."""
    return c * (nu + 0.5 * sum_gam) - c + 1.0


def rho_update(rho, m2b_colsum, tau, q_mask, c=1.0):
    """Slab-precision rate (reference: R/update_vb.R:118)."""
    return c * (rho + 0.5 * torch.sum(tau * m2b_colsum * q_mask))


def eta_update(n_eff, eta, gam_colsum, c=1.0):
    """Residual-precision shape (reference: R/update_vb.R:127-134)."""
    return c * (eta + 0.5 * n_eff + 0.5 * gam_colsum) - c + 1.0


def kappa_update(n, y_norm_sq, yF_colsum, FF_colsum, kappa, m2b_colsum,
                 beta2_colsum, sig2_inv, c=1.0):
    """Residual-precision rate (reference: R/update_vb.R:136-157) in the
    n-space form: colSums(beta * t(cp_Y_X)) == colSums(Y * F) and
    colSums(cp_X_Xbeta * beta) == colSums(F * F), F = X beta; the Gram
    diagonal of standardized X is n - 1."""
    quad = (n - 1.0 + sig2_inv) * m2b_colsum + FF_colsum \
        - (n - 1.0) * beta2_colsum
    return c * (kappa + 0.5 * (y_norm_sq - 2.0 * yF_colsum + quad))


def log_gamma_mean(shape, rate):
    """E[log g] for g ~ Gamma(shape, rate): digamma(shape) - log(rate)."""
    return digamma(shape) - torch.log(rate)


def sig2_c0_update(d, s02, c=1.0):
    """1 / (c (d + 1/s02)) (reference: R/update_vb.R:92)."""
    return 1.0 / (c * (d + 1.0 / s02))


def theta_update(z_rowsum, m0, sig02_lam_inv, sig2_theta, zeta_sum, c=1.0):
    """Hotspot propensity posterior mean (reference: R/update_vb.R:166-210,
    diagonal-Sigma_0 branch)."""
    return c * sig2_theta * (z_rowsum + sig02_lam_inv * m0 - zeta_sum)


def zeta_update(z_colsum, theta_sum, n0, sig2_zeta, t02_inv, c=1.0):
    """Response propensity posterior mean (reference: R/update_vb.R:99-110)."""
    return c * sig2_zeta * (z_colsum + t02_inv * n0 - theta_sum)
