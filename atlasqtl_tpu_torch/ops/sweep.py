"""Blocked Gauss-Seidel sweeps in plain PyTorch — the float64 / CPU engines
(counterpart of atlasqtl_tpu/ops/sweep.py; the complete-data sweep is what
_select_sweep calls "xla", the two exact-missing sweeps what
_select_missing_sweep calls "blocked" and "scan").

Same algorithm as the reference's: the n-space residual statistic
F = X beta replaces the Gram-space cp_betaX_X of src/coreLoop.cpp:38-86, and
predictors run in blocks of B — one (B, n) @ (n, q) projection per block, a
strictly sequential update of the B coordinates through the block Gram, one
(n, B) @ (B, q) advance of F.  The update order is the reference's k-major,
j ascending.

The exact-missing sweeps carry the masked statistic Fm = M * (X beta), M the
(n, q) observation pattern: each coordinate's Gram diagonal is the per-(j, k)
x_norm_sq[j, k] = sum_n m_nk x_nj^2, and each accepted update advances Fm by
M * (x_j delta_j) (src/coreLoop.cpp:91-138 keeps q dense p x p Grams
instead).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .special import inv_mills_ratio, log_ndtr_both


class SweepConsts(NamedTuple):
    """Per-iteration scalars/vectors consumed by the sweep."""
    sig2_beta: torch.Tensor      # (q,), or (p, q) with missing data
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


def mis_pair_gram(x, mis_pat, block: int):
    """The within-block masked pair Grams of the blocked exact-missing sweep,

        h[b, pair(i, j), k] = sum_n m_nk x_{n, bB+i} x_{n, bB+j},   j < i,

    row-major by i (flat pair index i(i-1)/2 + j).  Returns (nb, B(B-1)/2,
    q); one (B-1)/2 * n p q multiply-add pass, constant across iterations."""
    n, p = x.shape
    ii, jj = torch.tril_indices(block, block, -1, device=x.device)
    out = []
    for b in range(p // block):
        xb = x[:, b * block:(b + 1) * block]
        out.append((xb[:, ii] * xb[:, jj]).T @ mis_pat)
    return torch.stack(out)


def sweep_missing_blocked(x, cp_x_y, x_norm_sq, mis_pat, pair_gram, gam,
                          mu_beta, fitted_masked, consts, block: int,
                          p_mask, q_mask):
    """Blocked exact-missing sweep, B predictors per step, same flat update
    order as coreDualMisLoop (src/coreLoop.cpp:91-138).

    Per block: r0 = X_b^T Fm; the sequential in-block updates take their
    predecessors' corrections through the precomputed pair Grams
    (`mis_pair_gram`) and their own diagonal from x_norm_sq; then
    Fm += M * (X_b delta).  Returns (gam', mu_beta', Fm', z_row, z_col) with
    the Z-moment sums fused into the block loop."""
    p = x.shape[1]
    c = consts.c
    gam_out, mu_out, z_rows = [], [], []
    z_col = torch.zeros(gam.shape[1], dtype=fitted_masked.dtype,
                        device=fitted_masked.device)
    fm = fitted_masked
    for b in range(p // block):
        sl = slice(b * block, (b + 1) * block)
        xb, thb, pmb = x[:, sl], consts.theta[sl], p_mask[sl]
        s2b, db, hb, cpb = consts.sig2_beta[sl], x_norm_sq[sl], pair_gram[b], \
            cp_x_y[sl]
        gamb, mub = gam[sl], mu_beta[sl]
        log_p, log_1p = log_ndtr_both(thb[:, None] + consts.zeta[None, :])
        cst = -(consts.log_tau[None, :] + consts.log_sig2_inv
                + torch.log(s2b)) / 2.0
        ct = c * s2b * consts.tau[None, :]
        r0 = xb.T @ fm
        deltas, gam_rows, mu_rows = [], [], []
        for i in range(block):
            r_i = r0[i]
            base = i * (i - 1) // 2
            for j in range(i):
                r_i = r_i + hb[base + j] * deltas[j]
            beta_old = gamb[i] * mub[i]
            r_i = r_i - beta_old * db[i]
            mu_new = ct[i] * (cpb[i] - r_i)
            logit = c * (log_1p[i] - log_p[i]
                         - mu_new * mu_new / (2.0 * s2b[i]) + cst[i])
            gam_new = torch.sigmoid(-logit)
            deltas.append(gam_new * mu_new - beta_old)
            gam_rows.append(gam_new)
            mu_rows.append(mu_new)
        fm = fm + mis_pat * (xb @ torch.stack(deltas))
        gamb_new, mub_new = torch.stack(gam_rows), torch.stack(mu_rows)
        masked_gam = gamb_new * pmb[:, None] * q_mask[None, :]
        zr, zc = _z_block_sums(masked_gam, thb, consts.zeta, pmb, q_mask, c)
        z_col = z_col + zc
        gam_out.append(gamb_new)
        mu_out.append(mub_new)
        z_rows.append(zr)
    return (torch.cat(gam_out), torch.cat(mu_out), fm, torch.cat(z_rows),
            z_col)


def sweep_missing(x, cp_x_y, x_norm_sq, mis_pat, gam, mu_beta, fitted_masked,
                  consts):
    """Exact-missing sweep, one coordinate at a time (the engine when no
    pair Grams were precomputed, mis_block = 1): the per-response Gram
    entries arise as x_j^T M_k x_j = x_norm_sq[j, k] and x_j^T Fm_k.
    Returns (gam', mu_beta', Fm'); the caller sums Z (ops/updates.py)."""
    c = consts.c
    fm = fitted_masked
    gam_out = torch.empty_like(gam)
    mu_out = torch.empty_like(mu_beta)
    for j in range(x.shape[1]):
        x_j, s2_j = x[:, j], consts.sig2_beta[j]
        log_p, log_1p = log_ndtr_both(consts.theta[j] + consts.zeta)
        beta_old = gam[j] * mu_beta[j]
        r = x_j @ fm - beta_old * x_norm_sq[j]
        mu_new = c * s2_j * consts.tau * (cp_x_y[j] - r)
        logit = c * (log_1p - log_p - mu_new * mu_new / (2.0 * s2_j)
                     - torch.log(s2_j) / 2.0 - consts.log_tau / 2.0
                     - consts.log_sig2_inv / 2.0)
        gam_new = torch.sigmoid(-logit)
        fm = fm + mis_pat * (x_j[:, None] * (gam_new * mu_new
                                              - beta_old)[None, :])
        gam_out[j], mu_out[j] = gam_new, mu_new
    return gam_out, mu_out, fm
