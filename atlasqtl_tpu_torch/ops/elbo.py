"""ELBO terms of the global-local and global-only models in PyTorch
(counterpart of atlasqtl_tpu/ops/elbo.py; re-design of R/elbo.R and
elbo_global_local_, R/atlasqtl_global_local_core.R:440-495).  The blocked
assemblies live in models/global_local.py and models/global_only.py
(compute_elbo).
"""
from __future__ import annotations

import math

import torch

from .special import gammaln, log_ndtr_both
from .horseshoe import log_integral_hs

_EPS_GAM = float(torch.finfo(torch.float64).eps) ** 0.75  # R/elbo.R:15


def _xlogx(g):
    return g * torch.log(torch.where(g > 0, g + _EPS_GAM,
                                     torch.full_like(g, _EPS_GAM)))


def e_beta_gamma_blocked(gam_b, mu_b, theta_b, zeta, log_tau, tau, sig2_beta,
                         log_sig2_inv, sig2_inv, sig2_zeta, sig2_theta_b,
                         mask_b, q_mask):
    """One predictor block's part of E log p(beta, gamma | .) -
    E log q(beta, gamma) (reference: R/elbo.R:10-34), in the inputs' dtype.
    gam_b/mu_b/sig2_beta: (B, q); theta_b/sig2_theta_b/mask_b: (B,)."""
    log_p, log_1p = log_ndtr_both(theta_b[:, None] + zeta[None, :])
    m2_b = (mu_b * mu_b + sig2_beta) * gam_b
    arg = (log_sig2_inv * gam_b / 2.0
           + gam_b * log_tau[None, :] / 2.0
           - m2_b * tau[None, :] * sig2_inv / 2.0
           + gam_b * log_p
           + (1.0 - gam_b) * log_1p
           - sig2_zeta / 2.0
           - _xlogx(gam_b) - _xlogx(1.0 - gam_b)
           - sig2_theta_b[:, None] / 2.0
           + 0.5 * gam_b * (torch.log(sig2_beta) + 1.0))
    return torch.sum(arg * mask_b[:, None] * q_mask[None, :])


def e_theta_hs(lam2_inv, l_vb, log_sig02_inv_shr, theta, q_app, sig02_inv_shr,
               sig2_theta, p_mask, df: int):
    """E log p(theta|.) - E log q(theta) under the horseshoe
    (reference: R/elbo.R:85-128; m0 = 0)."""
    quad = sig02_inv_shr * lam2_inv * (theta * theta + sig2_theta) / 2.0
    if df == 1:
        per_j = (log_sig02_inv_shr / 2.0 - quad
                 + (torch.log(sig2_theta) + 1.0) / 2.0
                 - math.log(math.pi) + l_vb * lam2_inv + torch.log(q_app))
    elif df == 3:
        log_b = math.log(9.0) - torch.log(q_app * (1.0 + l_vb) - 1.0)
        per_j = (math.log(6.0) + math.log(3.0) / 2.0 - math.log(math.pi)
                 - log_b + df * l_vb * lam2_inv + log_sig02_inv_shr / 2.0
                 - quad + (torch.log(sig2_theta) + 1.0) / 2.0)
    else:
        expo = (df + 1) / 2
        log_b = -log_integral_hs(df, l_vb * df, m=expo, n=expo - 1)
        per_j = (-math.log(math.pi) / 2.0 - math.lgamma(df / 2.0)
                 + df * math.log(float(df)) / 2.0
                 + math.lgamma((df - 1) / 2.0 + 1.0)
                 - log_b + df * l_vb * lam2_inv
                 + log_sig02_inv_shr / 2.0 - quad
                 + (torch.log(sig2_theta) + 1.0) / 2.0)
    return torch.sum(per_j * p_mask)


def e_sig2_inv(nu, nu_vb, log_sig2_inv_vb, rho, rho_vb, sig2_inv_vb):
    """Generic Gamma-factor term (reference: R/elbo.R:41-46)."""
    return ((nu - nu_vb) * log_sig2_inv_vb - (rho - rho_vb) * sig2_inv_vb
            + nu * torch.log(rho) - nu_vb * torch.log(rho_vb)
            - gammaln(nu) + gammaln(nu_vb))


def e_sig2_inv_hs(xi_inv, nu_s0_vb, log_xi_inv, log_sig02_inv, rho_s0_vb,
                  sig02_inv):
    """Horseshoe global-scale term (reference: R/elbo.R:49-56)."""
    return (-0.5 * log_sig02_inv - xi_inv * sig02_inv + log_xi_inv / 2.0
            - math.lgamma(0.5) - (nu_s0_vb - 1.0) * log_sig02_inv
            + rho_s0_vb * sig02_inv - nu_s0_vb * torch.log(rho_s0_vb)
            + gammaln(nu_s0_vb))


def e_tau(eta, eta_vb, kappa, kappa_vb, log_tau_vb, tau_vb, q_mask):
    """Residual-precision term (reference: R/elbo.R:63-68)."""
    per_k = ((eta - eta_vb) * log_tau_vb - (kappa - kappa_vb) * tau_vb
             + eta * torch.log(kappa) - eta_vb * torch.log(kappa_vb)
             - gammaln(eta) + gammaln(eta_vb))
    return torch.sum(per_k * q_mask)


def e_y(n_eff, kappa, kappa_vb, log_tau_vb, m2b_colsum, sig2_inv, tau_vb,
        q_mask):
    """E log p(y|.) (reference: R/elbo.R:135-146)."""
    arg = n_eff * (log_tau_vb - math.log(2.0 * math.pi)) / 2.0
    per_k = arg - tau_vb * (kappa_vb - m2b_colsum * sig2_inv / 2.0 - kappa)
    return torch.sum(per_k * q_mask)


def e_zeta(zeta, n0, sig2_zeta, t02_inv, vec_sum_log_det_zeta, q_true, q_mask,
           total=torch.sum):
    """Response-propensity term (reference: R/elbo.R:153-161); `total`
    sums over the responses (over every q-shard under a mesh)."""
    ss = total((zeta - n0) ** 2 * q_mask)
    return (vec_sum_log_det_zeta - t02_inv * ss
            - q_true * t02_inv * sig2_zeta + q_true) / 2.0


def e_theta_global(theta, sig02_inv_shr, sig2_theta, vec_sum_log_det_theta,
                   p_mask, p_true, total=torch.sum):
    """The global-only model's theta term (reference: R/elbo.R:75-82;
    m0 = 0); vec_sum_log_det_theta is the summed log-determinant term;
    `total` sums over the predictors (over every p-shard under a mesh)."""
    ss = total(theta * theta * p_mask)
    tr = sig02_inv_shr * total(sig2_theta * p_mask)
    return (vec_sum_log_det_theta - sig02_inv_shr * ss - tr + p_true) / 2.0
