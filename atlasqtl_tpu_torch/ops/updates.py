"""Closed-form VB updates in PyTorch (counterpart of
atlasqtl_tpu/ops/updates.py; re-design of R/update_vb.R).

The closed-form updates of the global-local iteration, complete and
missing data, and the probit latent moments Z.  The annealing
inverse temperature `c` enters as in the reference (tempered natural
parameters).  Padded predictors/responses carry mask 0 and are excluded
from every reduction.
"""
from __future__ import annotations

import torch

from .special import as_scalar, digamma, inv_mills_ratio, log_ndtr_both


def beta_mean(gam, mu_beta):
    """E[beta] = gam * mu (reference: R/update_vb.R:17)."""
    return gam * mu_beta


def m2_beta(gam, mu_beta, sig2_beta):
    """E[beta^2] = gam * (mu^2 + sig2) (reference: R/update_vb.R:19-31);
    sig2_beta broadcasts: (q,) or (p, q)."""
    return (mu_beta * mu_beta + sig2_beta) * gam


def sig2_beta_update(n, sig2_inv, tau, x_norm_sq=None, c=1.0):
    """Posterior slab variance (reference: R/update_vb.R:33-50).
    Complete data: 1/(c (n-1+sig2_inv) tau) -> (q,).
    Missing data:  1/(c (x_norm_sq + sig2_inv) tau) -> (p, q)."""
    if x_norm_sq is None:
        return 1.0 / (c * (n - 1.0 + sig2_inv) * tau)
    return 1.0 / (c * (x_norm_sq + sig2_inv) * tau[None, :])


def nu_update(nu, sum_gam, c=1.0):
    """Slab-precision shape (reference: R/update_vb.R:116)."""
    return c * (nu + 0.5 * sum_gam) - c + 1.0


def rho_update(rho, m2b_colsum, tau, q_mask, c=1.0, total=torch.sum):
    """Slab-precision rate (reference: R/update_vb.R:118); `total` sums
    over the responses (over every q-shard under a mesh)."""
    return c * (rho + 0.5 * total(tau * m2b_colsum * q_mask))


def eta_update(n_eff, eta, gam_colsum, c=1.0):
    """Residual-precision shape (reference: R/update_vb.R:127-134)."""
    return c * (eta + 0.5 * n_eff + 0.5 * gam_colsum) - c + 1.0


def kappa_update(n, y_norm_sq, yF_colsum, FF_colsum, kappa, m2b_colsum,
                 beta2_colsum, sig2_inv, c=1.0, x_norm_sq_m2b=None,
                 x_norm_sq_beta2=None):
    """Residual-precision rate (reference: R/update_vb.R:136-157) in the
    n-space form: colSums(beta * t(cp_Y_X)) == colSums(Y * F) and
    colSums(cp_X_Xbeta * beta) == colSums(F * F), F = X beta (masked when
    data are missing).  The Gram diagonal of standardized X is n - 1; the
    missing-data variant takes the per-(j, k) x_norm_sq reductions
    colSums(x_norm_sq * m2b) and colSums(x_norm_sq * beta^2) instead."""
    if x_norm_sq_m2b is None:
        quad = (n - 1.0 + sig2_inv) * m2b_colsum + FF_colsum \
            - (n - 1.0) * beta2_colsum
    else:
        quad = sig2_inv * m2b_colsum + x_norm_sq_m2b + FF_colsum \
            - x_norm_sq_beta2
    return c * (kappa + 0.5 * (y_norm_sq - 2.0 * yF_colsum + quad))


def log_gamma_mean(shape, rate):
    """E[log g] for g ~ Gamma(shape, rate): digamma(shape) - log(rate)."""
    return digamma(shape) - torch.log(rate)


def sig2_c0_update(d, s02, c=1.0):
    """1 / (c (d + 1/s02)) (reference: R/update_vb.R:92)."""
    return 1.0 / (c * (d + 1.0 / s02))


def _z_block(gam_b, theta_b, zeta, p_mask_b, q_mask, sqrt_c):
    u = sqrt_c * (theta_b[:, None] + zeta[None, :])
    log_p, log_1p = log_ndtr_both(u)
    imr0 = inv_mills_ratio(0, u, log_1p, log_p)
    imr1 = inv_mills_ratio(1, u, log_1p, log_p)
    z = ((gam_b * (imr1 - imr0) + imr0) / sqrt_c
         + (theta_b[:, None] + zeta[None, :]))
    z = z * p_mask_b[:, None] * q_mask[None, :]
    return torch.sum(z, dim=1), torch.sum(z, dim=0)


def z_moments(gam, theta, zeta, p_mask, q_mask, c=1.0, block_size=None):
    """Row/column sums of the truncated-normal latent posterior mean Z
    (reference: R/update_vb.R:217-234), block by block over the predictors
    so no (p, q) Z or log-Phi matrix is held.  Returns (row sums (p,),
    column sums (q,)).  Under annealing (c != 1) the probit argument is
    sqrt(c) (theta + zeta) and the inverse-Mills terms are scaled by
    1/sqrt(c)."""
    sqrt_c = torch.sqrt(as_scalar(c, gam.dtype, gam.device))
    p, q = gam.shape
    if block_size is None or p % block_size != 0 or p <= block_size:
        return _z_block(gam, theta, zeta, p_mask, q_mask, sqrt_c)
    col = torch.zeros(q, dtype=gam.dtype, device=gam.device)
    rows = []
    for b in range(p // block_size):
        sl = slice(b * block_size, (b + 1) * block_size)
        r, cb = _z_block(gam[sl], theta[sl], zeta, p_mask[sl], q_mask, sqrt_c)
        col = col + cb
        rows.append(r)
    return torch.cat(rows), col


def theta_update(z_rowsum, m0, sig02_lam_inv, sig2_theta, zeta_sum, c=1.0):
    """Hotspot propensity posterior mean (reference: R/update_vb.R:166-210,
    diagonal-Sigma_0 branch)."""
    return c * sig2_theta * (z_rowsum + sig02_lam_inv * m0 - zeta_sum)


def zeta_update(z_colsum, theta_sum, n0, sig2_zeta, t02_inv, c=1.0):
    """Response propensity posterior mean (reference: R/update_vb.R:99-110)."""
    return c * sig2_zeta * (z_colsum + t02_inv * n0 - theta_sum)
