"""Blocked Gauss-Seidel sweep in plain PyTorch — the float64 / CPU engine
(counterpart of atlasqtl_tpu/ops/sweep.py:41-170, what _select_sweep calls
"xla").

Same algorithm as the reference's: the n-space residual statistic
F = X beta replaces the Gram-space cp_betaX_X of src/coreLoop.cpp:38-86, and
predictors run in blocks of B — one (B, n) @ (n, q) projection per block, a
strictly sequential update of the B coordinates through the block Gram, one
(n, B) @ (B, q) advance of F.  The update order is the reference's k-major,
j ascending.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .special import inv_mills_ratio, log_ndtr_both


class SweepConsts(NamedTuple):
    """Per-iteration scalars/vectors consumed by the sweep."""
    sig2_beta: torch.Tensor      # (q,)
    tau: torch.Tensor            # (q,)
    log_tau: torch.Tensor        # (q,)
    log_sig2_inv: torch.Tensor   # 0-d
    theta: torch.Tensor          # (p,)
    zeta: torch.Tensor           # (q,)
    c: torch.Tensor              # 0-d inverse temperature


def block_gram(x, block_size):
    """The (nb, B, B) diagonal Gram blocks X_b^T X_b."""
    n, p = x.shape
    xb = x.reshape(n, p // block_size, block_size).permute(1, 0, 2)
    return xb.transpose(1, 2) @ xb


def _inner_gs(r0, g_b, cp_b, gam_b, mu_b, log_p_b, log_1p_b, consts):
    """Sequential Gauss-Seidel over the B coordinates of one block,
    vectorized over the q responses (src/coreLoop.cpp:64-84).  r0: (B, q)
    projections x_j^T F; g_b: (B, B) block Gram; cp_b: (B, q) block of X^T Y.
    Returns updated (gam_b, mu_b) and delta = beta_new - beta_old."""
    c = consts.c
    s2 = consts.sig2_beta[None, :].expand_as(gam_b)
    cst = -(consts.log_tau[None, :] + consts.log_sig2_inv
            + torch.log(s2)) / 2.0
    ct = c * s2 * consts.tau[None, :]
    beta0 = gam_b * mu_b
    d = torch.diagonal(g_b)
    r = r0
    gam_b, mu_b, beta_b = gam_b.clone(), mu_b.clone(), beta0.clone()
    for i in range(gam_b.shape[0]):
        beta_old_i = beta_b[i]
        r_i = r[i] - beta_old_i * d[i]
        mu_i = ct[i] * (cp_b[i] - r_i)
        logit = c * (log_1p_b[i] - log_p_b[i]
                     - mu_i * mu_i / (2.0 * s2[i]) + cst[i])
        gam_i = torch.sigmoid(-logit)
        beta_i = gam_i * mu_i
        delta_i = beta_i - beta_old_i
        r = r + g_b[:, i][:, None] * delta_i[None, :]
        gam_b[i], mu_b[i], beta_b[i] = gam_i, mu_i, beta_i
    return gam_b, mu_b, beta_b - beta0


def _z_block_sums(gam_b, theta_b, zeta, pm_b, q_mask, c):
    """Per-block row/column sums of the probit latent means Z
    (R/update_vb.R:217-234), fused into the sweep."""
    sqrt_c = torch.sqrt(c)
    u = sqrt_c * (theta_b[:, None] + zeta[None, :])
    log_p, log_1p = log_ndtr_both(u)
    imr0 = inv_mills_ratio(0, u, log_1p, log_p)
    imr1 = inv_mills_ratio(1, u, log_1p, log_p)
    z = ((gam_b * (imr1 - imr0) + imr0) / sqrt_c
         + (theta_b[:, None] + zeta[None, :]))
    z = z * pm_b[:, None] * q_mask[None, :]
    return torch.sum(z, dim=1), torch.sum(z, dim=0)


def sweep_complete(x, cp_x_y, gram_blocks, gam, mu_beta, fitted, consts,
                   block_size, p_mask, q_mask):
    """Full sweep over all p predictors, complete data.

    x: (n, p); cp_x_y: (p, q); gram_blocks: (nb, B, B); gam/mu_beta: (p, q);
    fitted: (n, q) = X @ (gam*mu).  Returns (gam', mu_beta', fitted', z_row,
    z_col) with the Z-moment reductions fused into the block loop.
    """
    p = x.shape[1]
    B = block_size
    gam_out, mu_out, z_rows = [], [], []
    z_col = torch.zeros(gam.shape[1], dtype=fitted.dtype, device=fitted.device)
    for b in range(p // B):
        sl = slice(b * B, (b + 1) * B)
        xb, thb, pmb = x[:, sl], consts.theta[sl], p_mask[sl]
        log_p, log_1p = log_ndtr_both(thb[:, None] + consts.zeta[None, :])
        r0 = xb.T @ fitted
        gamb, mub, delta = _inner_gs(r0, gram_blocks[b], cp_x_y[sl], gam[sl],
                                     mu_beta[sl], log_p, log_1p, consts)
        fitted = fitted + xb @ delta
        masked_gam = gamb * pmb[:, None] * q_mask[None, :]
        zr, zc = _z_block_sums(masked_gam, thb, consts.zeta, pmb, q_mask,
                               consts.c)
        z_col = z_col + zc
        gam_out.append(gamb)
        mu_out.append(mub)
        z_rows.append(zr)
    return (torch.cat(gam_out), torch.cat(mu_out), fitted, torch.cat(z_rows),
            z_col)
