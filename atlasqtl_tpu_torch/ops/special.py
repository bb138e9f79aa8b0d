"""Special functions for the horseshoe CAVI updates, in PyTorch
(counterpart of atlasqtl_tpu/ops/special.py).

Only the functions the complete-data global-local path reaches are here.
digamma, gammaln and the regularized upper incomplete gamma come from
torch.special / torch.lgamma.
"""
from __future__ import annotations

import torch

_LOG_SQRT_2PI = 0.9189385332046727417803297364056176  # log(sqrt(2*pi))
_EULER_GAMMA = 0.5772156649015328606065120900824024

digamma = torch.special.digamma
gammaln = torch.lgamma


def log_ndtr_both(x):
    """(log Phi(x), log(1 - Phi(x))).  float32 takes the erfcx fast path
    (1.2e-7 absolute), float64 the reference-grade log_ndtr."""
    if x.dtype == torch.float32:
        return log_ndtr_both_fast(x)
    return torch.special.log_ndtr(x), torch.special.log_ndtr(-x)


_NR_ERFC = (-1.26551223, 1.00002368, 0.37409196, 0.09678418, -0.18628806,
            0.27886807, -1.13520398, 1.48851587, -0.82215223, 0.17087277)


def _log_half_erfcx(z):
    """log(0.5 * erfcx(z)) for z >= 0 via the Numerical-Recipes rational fit
    (fractional error < 1.2e-7): erfcx(z) = t * exp(poly(t)),
    t = 1/(1 + z/2)."""
    t = 1.0 / (1.0 + 0.5 * z)
    poly = _NR_ERFC[9]
    for coef in _NR_ERFC[8::-1]:
        poly = poly * t + coef
    return torch.log(0.5 * t) + poly


def log_ndtr_both_fast(x):
    """One-branch evaluation of (log Phi(x), log Phi(-x)):

      log Phi(-|x|) = -x^2/2 + log(0.5 erfcx(|x|/sqrt(2)))
      log Phi(+|x|) = log1p(-exp(log Phi(-|x|)))      (safe: arg <= log 0.5)
    """
    ax = torch.abs(x)
    z = ax * 0.7071067811865476
    log_lo = -0.5 * ax * ax + _log_half_erfcx(z)
    log_hi = torch.log1p(-torch.exp(log_lo))
    pos = x >= 0
    return torch.where(pos, log_hi, log_lo), torch.where(pos, log_lo, log_hi)


# erfcx(z) ~= P12(t), t = 1/(1+z/2): degree-12 least-squares monomial fit on
# z in [0, 38] (relative error < 1e-8 in f64; a few f32 ulps in f32).
_ERFCX_P12 = (
    -3.3165308299e-08, 2.8209689277e-01, 2.8203939145e-01,
    2.4763853382e-01, 1.6907953642e-01, 1.2618805762e-01,
    -1.7237056852e-01, 3.9533528873e-01, -8.6823027223e-01,
    9.2534894166e-01, -5.2180538714e-01, 1.5311423141e-01,
    -1.8434608331e-02,
)


def _erfcx_nr(z):
    """erfcx(z) for z >= 0, exp-free polynomial fit (see _ERFCX_P12)."""
    t = 1.0 / (1.0 + 0.5 * z)
    poly = _ERFCX_P12[12]
    for coef in _ERFCX_P12[11::-1]:
        poly = poly * t + coef
    return poly


# m_small(a) - a = pdf(a)/Phi(-a) - a, fitted in t = 1/(1 + a/2) on [0, 40]
_MSC12 = (
    3.9501551376e-01, 4.3649747640e-01, 6.9558655886e-03,
    -5.9315123697e-02, 1.6028903291e-02, 9.0810490265e-03,
    -8.6900561279e-03, 1.2751740786e-03, 2.3521225869e-03,
    -1.4029417590e-03, -2.0112653784e-04, 3.2224146215e-04,
    -3.4510945732e-05,
)


def _horner(coefs, s):
    acc = coefs[-1]
    for c in coefs[-2::-1]:
        acc = acc * s + c
    return acc


def inv_mills_ratio(y: int, u, log_1_pnorm_u, log_pnorm_u):
    """Inverse Mills ratio of the truncated-normal probit latent variable
    (reference: R/utils.R:172-191), clamped at -u as the reference does."""
    if y == 1:
        m = torch.exp(-0.5 * u * u - _LOG_SQRT_2PI - log_pnorm_u)
        return torch.maximum(m, -u)
    m = -torch.exp(-0.5 * u * u - _LOG_SQRT_2PI - log_1_pnorm_u)
    return torch.minimum(m, -u)


def _e1_series(x):
    """E1(x) for 0 < x <= 1: -gamma - log x + sum_k (-1)^{k+1} x^k/(k k!),
    30 terms (remainder below f64 eps at x = 1)."""
    term = torch.ones_like(x)
    acc = torch.zeros_like(x)
    for k in range(1, 31):
        term = term * (-x) / k
        acc = acc - term / k
    return -_EULER_GAMMA - torch.log(x) + acc


def _q_lentz_cf(x, n_iter: int = 80):
    """Q(x) = e^x E1(x) for x > 1 by the modified Lentz continued fraction
    (R/utils.R:346-423) with a fixed iteration count."""
    f = torch.full_like(x, 1e-30)
    cc = torch.full_like(x, 1e-30)
    d = torch.zeros_like(x)
    for j in range(2, 2 + n_iter):
        a = (j - 1.0) ** 2
        b = x + 2.0 * j - 1.0
        d = 1.0 / (b - a * d)
        cc = b - a / cc
        f = f * (cc * d)
    return 1.0 / (x + 1.0 + f)


def q_approx(x):
    """Q(x) = e^x E1(x) (reference: R/utils.R:346-423): series branch for
    x <= 1, Lentz continued fraction for x > 1."""
    tiny = torch.finfo(x.dtype).tiny
    safe_lo = torch.clamp(torch.clamp(x, max=1.0), min=tiny)
    safe_hi = torch.clamp(x, min=1.0)
    lo = torch.exp(safe_lo) * _e1_series(safe_lo)
    hi = _q_lentz_cf(safe_hi)
    return torch.where(x <= 1.0, lo, hi)


def _as_like(v, x):
    return torch.as_tensor(v, dtype=x.dtype, device=x.device)


def upper_gamma(a, x):
    """Non-regularized upper incomplete gamma Gamma(a, x), a > 0."""
    a = _as_like(a, x)
    return torch.exp(torch.log(torch.special.gammaincc(a, x)) + gammaln(a))


def upper_gamma_ratio(c, x):
    """Gamma(2-c, x) / (Gamma(1-c, x) * x) via regularized gammas in log
    space, with the Tricomi asymptotic ratio past the dtype's gammaincc
    underflow horizon (x > 600 in f64, > 80 in f32)."""
    thresh = 600.0 if x.dtype == torch.float64 else 80.0
    a2 = _as_like(2.0 - c, x)
    a1 = _as_like(1.0 - c, x)
    x_lo = torch.clamp(x, max=thresh)
    log_num = torch.log(torch.special.gammaincc(a2, x_lo)) + gammaln(a2)
    log_den = torch.log(torch.special.gammaincc(a1, x_lo)) + gammaln(a1)
    exact = torch.exp(log_num - log_den - torch.log(x_lo))

    def s3(a):
        t1 = (a - 1.0) / x
        t2 = t1 * (a - 2.0) / x
        t3 = t2 * (a - 3.0) / x
        return 1.0 + t1 + t2 + t3

    asym = s3(a2) / s3(a1)
    return torch.where(x > thresh, asym, exact)


def hyperg_1f1(a, b, x, n_terms: int = 400):
    """Kummer 1F1(a; b; x) by direct series with a fixed number of terms
    (valid for |x| <~ 50; the small-L branch of the annealed df > 1 update)."""
    a = _as_like(a, x)
    b = _as_like(b, x)
    term = torch.ones_like(x + a + b)
    acc = term
    for k in range(n_terms):
        term = term * (a + k) / (b + k) * x / (k + 1.0)
        acc = acc + term
    return acc
