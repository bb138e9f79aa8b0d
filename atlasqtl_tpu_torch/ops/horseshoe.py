"""Horseshoe local-scale updates in PyTorch (counterpart of
atlasqtl_tpu/ops/horseshoe.py).

- exact (c = 1) update via Q(x) = e^x E1(x) (R/atlasqtl_global_local_core.R:
  241-274), all odd df;
- annealed update via incomplete-gamma / Kummer ratios (R/update_vb.R:70-85);
- odd-df integrals int_0^inf x^n (1+a x)^{-m} e^{-b x} dx by a closed
  exponential-integral form for b/a < 1 and Gauss-Laguerre quadrature in log
  space beyond (the reference's closed forms, R/utils.R:425-568).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .special import (as_scalar, gammaln, hyperg_1f1, q_approx,
                      upper_gamma_ratio)


def lam2_inv_exact(l_vb, df: int = 1):
    """Exact (c=1) local-scale update E_q[1/lam^2]; returns (lam2_inv, Q(L))
    so the ELBO can reuse Q(L)."""
    q_app = q_approx(l_vb)
    if df == 1:
        lam2_inv = 1.0 / (q_app * l_vb) - 1.0
    elif df == 3:
        lam2_inv = torch.exp(
            -math.log(3.0) - torch.log(l_vb)
            + torch.log(1.0 - l_vb * q_app)
            - torch.log(q_app * (1.0 + l_vb) - 1.0)
        ) - 1.0 / 3.0
    else:
        expo = (df + 1) / 2
        log_num = log_integral_hs(df, l_vb * df, m=expo, n=expo)
        log_den = log_integral_hs(df, l_vb * df, m=expo, n=expo - 1)
        lam2_inv = torch.exp(log_num - log_den)
    return lam2_inv, q_app


def lam2_inv_annealed(l_vb, c_s, df: int = 1):
    """Annealed local-scale update (R/update_vb.R:70-85); l_vb is already
    c_s * L / df.  df=1: Gamma(2-c, L)/(Gamma(1-c, L) L) - 1.  df>1: the
    reference's 1F1 combination for L <= 5, and its Kummer-U integral form
    (positive integrand, Gauss-Laguerre) beyond, where the 1F1 series
    overflows."""
    if df == 1:
        return upper_gamma_ratio(c_s, l_vb) - 1.0
    c = as_scalar(c_s, l_vb.dtype, l_vb.device)
    a1 = c * (df - 1) / 2.0
    a2 = c * (df + 1) / 2.0
    l_vb = torch.clamp(l_vb, min=1e-300)

    l_lo = torch.clamp(l_vb, max=5.0)
    g = lambda z: torch.exp(gammaln(z))
    num_lo = (g(a1 + 2) * g(c) * hyperg_1f1(a1 + 2, 3 - c, l_lo)
              / (c - 1) / (c - 2) / g(a2)
              + g(2 - c) * l_lo ** (c - 2) * hyperg_1f1(a2, c - 1, l_lo))
    den_lo = (g(a1 + 1) * g(c) * hyperg_1f1(a1 + 1, 2 - c, l_lo)
              / (c - 1) / g(a2)
              + g(1 - c) * l_lo ** (c - 1) * hyperg_1f1(a2, c, l_lo))
    out_lo = num_lo / den_lo / df

    l_hi = torch.clamp(l_vb, min=5.0)
    log_num = _log_integral_laguerre(1.0, l_hi, a2, a1 + 1.0)
    log_den = _log_integral_laguerre(1.0, l_hi, a2, a1)
    out_hi = torch.exp(log_num - log_den) / df
    return torch.where(l_vb <= 5.0, out_lo, out_hi)


_GL_NODES = 100


@functools.lru_cache(maxsize=None)
def _laguerre_nodes(dtype, device):
    """Gauss-Laguerre nodes and log-weights for int_0^inf f(x) e^{-x} dx."""
    x, w = np.polynomial.laguerre.laggauss(_GL_NODES)
    return (torch.as_tensor(x, dtype=dtype, device=device),
            torch.as_tensor(np.log(w), dtype=dtype, device=device))


def _log_integral_laguerre(alpha, beta, m, n):
    """Gauss-Laguerre evaluation after u = beta x (accurate when
    beta/alpha >~ 1)."""
    u, log_w = _laguerre_nodes(beta.dtype, beta.device)
    log_terms = (
        log_w[None, :]
        + n * (torch.log(u)[None, :] - torch.log(beta)[..., None])
        - m * torch.log1p(alpha * u[None, :] / beta[..., None])
        - torch.log(beta)[..., None]
    )
    return torch.logsumexp(log_terms, dim=-1)


def _log_integral_expint(alpha, beta, m, n):
    """Closed form via y = 1 + alpha x:
    I = alpha^{-n-1} e^z sum_k C(n,k) (-1)^{n-k} E_{m-k}(z), z = beta/alpha,
    with E_j built upward from E_0 = e^{-z}/z and E_1 = Q(z) e^{-z}
    (no cancellation for z <~ 1)."""
    z = beta / alpha
    e_neg = torch.exp(-z)
    ej = [e_neg / z, q_approx(z) * e_neg]
    for j in range(1, m):
        ej.append((e_neg - z * ej[j]) / j)
    s = torch.zeros_like(z)
    for k in range(n + 1):
        s = s + ((-1) ** (n - k)) * math.comb(n, k) * ej[m - k]
    s = torch.clamp(s, min=torch.finfo(z.dtype).tiny)
    return -(n + 1) * math.log(alpha) + z + torch.log(s)


def log_integral_hs(alpha, beta, m, n):
    """log of int_0^inf x^n (1 + alpha x)^{-m} e^{-beta x} dx, batched over
    beta; m, n are Python ints with m in {n, n+1}."""
    m, n = int(m), int(n)
    z = beta / alpha
    lo = _log_integral_expint(alpha, torch.clamp(beta, min=1e-300), m, n)
    hi = _log_integral_laguerre(alpha, torch.clamp(beta, min=1e-300), m, n)
    return torch.where(z < 1.0, lo, hi)
