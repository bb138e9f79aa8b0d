"""Hyperparameter elicitation, defaults and initialization.

A verbatim copy of atlasqtl_tpu/inference/elicitation.py (NumPy/SciPy only),
kept in the port so it never imports the JAX package: the same seed gives the
same host initial state in both packages.  Re-design of R/set_hyper_init.R (set_hyper/auto_set_hyper_,
set_init/auto_set_init_, map_hyperprior_elicitation) and the elicitation
helpers of R/utils.R:218-272.  All host-side (O(1) or O(pq) one-time work).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
from scipy.optimize import brentq
from scipy.special import ndtr, ndtri, owens_t


# ----------------------------------------------------------- (n0, t02) solve

def e_phi_x(mu, s2):
    """E[Phi(X)] for X ~ N(mu, s2) (reference: R/utils.R:218-222)."""
    return ndtr(mu / np.sqrt(1.0 + s2))


def e_phi_x_2(mu, s2):
    """E[Phi(X)^2] via Owen's T (reference: R/utils.R:224-229)."""
    h = mu / np.sqrt(1.0 + s2)
    return ndtr(h) - 2.0 * owens_t(h, 1.0 / np.sqrt(1.0 + 2.0 * s2))


def get_v_p_t(mu, s2, p):
    """Prior variance of the number of active predictors per response
    (reference: R/utils.R:231-235)."""
    return (p * (p - 1) * e_phi_x_2(mu, s2)
            - p ** 2 * e_phi_x(mu, s2) ** 2
            + p * e_phi_x(mu, s2))


def get_mu(e_p_t, s2, p):
    """Invert E[#active] = p Phi(mu/sqrt(1+s2)) (reference: R/utils.R:238-242)."""
    return np.sqrt(1.0 + s2) * ndtri(e_p_t / p)


def get_n0_t02(q, p, p_star):
    """Root-solve for (n0, t02) from the prior mean/variance of the number of
    active predictors per response (reference: R/utils.R:245-272)."""
    e_p_t = float(p_star[0])
    v_p_t = min(float(p_star[1]), np.floor(2 * p / 3))
    lo, hi = 1e-6, 1e5
    try:
        t02 = brentq(lambda s2: get_v_p_t(get_mu(e_p_t, s2, p), s2, p) - v_p_t,
                     lo, hi)
    except ValueError as exc:
        raise ValueError(
            "No hyperparameter values matching the expectation and variance "
            "of the number of active predictors per response supplied in p0. "
            "Please change p0.") from exc
    n0 = get_mu(e_p_t, t02, p)
    return np.full(q, n0), float(t02)


# ----------------------------------------------------------------- hyper/init

@dataclasses.dataclass
class HyperSpec:
    """User/auto hyperparameters (class 'hyper'/'out_hyper' analog,
    reference: R/set_hyper_init.R:98-197)."""
    q: int
    p: int
    eta: np.ndarray     # (q,)
    kappa: np.ndarray   # (q,)
    n0: np.ndarray      # (q,)
    nu: float
    rho: float
    t02: float
    m0: float = 0.0
    a2_inv: float = 1.0
    auto: bool = False  # True when produced by auto_set_hyper ('out_hyper')


@dataclasses.dataclass
class InitSpec:
    """User/auto initial variational parameters (class 'init'/'out_init'
    analog, reference: R/set_hyper_init.R:311-418)."""
    q: int
    p: int
    gam_vb: np.ndarray        # (p, q)
    mu_beta_vb: np.ndarray    # (p, q)
    sig02_inv_vb: float
    sig2_beta_vb: np.ndarray  # (q,), or (p, q) when resuming an
                              # exact-missing-data run
    sig2_theta_vb: np.ndarray # (p,)
    tau_vb: np.ndarray        # (q,)
    theta_vb: np.ndarray      # (p,)
    zeta_vb: np.ndarray       # (q,)
    auto: bool = False


def _as_vec(v, length, name):
    v = np.atleast_1d(np.asarray(v, dtype=np.float64))
    if v.size == 1:
        v = np.full(length, float(v[0]))
    if v.shape != (length,):
        raise ValueError(f"{name} must have length 1 or {length}")
    return v


def _check_positive(v, name):
    if np.any(np.asarray(v) < np.finfo(float).eps ** 0.75):
        raise ValueError(f"{name} must be positive")


def set_hyper(q, p, eta, kappa, n0, nu, rho, t02) -> HyperSpec:
    """User-specified hyperparameters (reference: set_hyper,
    R/set_hyper_init.R:98-140)."""
    q, p = int(q), int(p)
    eta = _as_vec(eta, q, "eta"); _check_positive(eta, "eta")
    kappa = _as_vec(kappa, q, "kappa"); _check_positive(kappa, "kappa")
    n0 = _as_vec(n0, q, "n0")
    nu = float(nu); _check_positive(nu, "nu")
    rho = float(rho); _check_positive(rho, "rho")
    t02 = float(t02); _check_positive(t02, "t02")
    return HyperSpec(q=q, p=p, eta=eta, kappa=kappa, n0=n0, nu=nu, rho=rho,
                     t02=t02)


def auto_set_hyper(y, p, p0) -> HyperSpec:
    """Default hyperparameters elicited from p0 = (E, V)
    (reference: auto_set_hyper_, R/set_hyper_init.R:146-197)."""
    q = y.shape[1]
    nu, rho = 1e-2, 1.0
    med_var = np.nanmedian(np.nanvar(y, axis=0, ddof=1))
    eta = 1.0 / med_var if np.isfinite(1.0 / med_var) else 1e3
    n0, t02 = get_n0_t02(q, p, p0)
    return HyperSpec(q=q, p=p, eta=np.full(q, eta), kappa=np.ones(q),
                     n0=n0, nu=nu, rho=rho, t02=t02, auto=True)


def set_init(q, p, gam_vb, mu_beta_vb, sig02_inv_vb, sig2_beta_vb,
             sig2_theta_vb, tau_vb, theta_vb, zeta_vb) -> InitSpec:
    """User-specified initial variational parameters (reference: set_init,
    R/set_hyper_init.R:311-351)."""
    q, p = int(q), int(p)
    gam_vb = np.asarray(gam_vb, dtype=np.float64)
    if gam_vb.shape != (p, q):
        raise ValueError("gam_vb must be a p x q matrix")
    if (gam_vb < 0).any() or (gam_vb > 1).any():
        raise ValueError("gam_vb entries must lie in [0, 1]")
    mu_beta_vb = np.asarray(mu_beta_vb, dtype=np.float64)
    if mu_beta_vb.shape != (p, q):
        raise ValueError("mu_beta_vb must be a p x q matrix")
    sig02_inv_vb = float(sig02_inv_vb); _check_positive(sig02_inv_vb, "sig02_inv_vb")
    sig2_beta_vb = np.asarray(sig2_beta_vb, dtype=np.float64)
    if sig2_beta_vb.ndim == 2:
        if sig2_beta_vb.shape != (p, q):
            raise ValueError("matrix sig2_beta_vb must be p x q")
    else:
        sig2_beta_vb = _as_vec(sig2_beta_vb, q, "sig2_beta_vb")
    _check_positive(sig2_beta_vb, "sig2_beta_vb")
    sig2_theta_vb = _as_vec(sig2_theta_vb, p, "sig2_theta_vb")
    _check_positive(sig2_theta_vb, "sig2_theta_vb")
    tau_vb = _as_vec(tau_vb, q, "tau_vb"); _check_positive(tau_vb, "tau_vb")
    theta_vb = _as_vec(theta_vb, p, "theta_vb")
    zeta_vb = _as_vec(zeta_vb, q, "zeta_vb")
    return InitSpec(q=q, p=p, gam_vb=gam_vb, mu_beta_vb=mu_beta_vb,
                    sig02_inv_vb=sig02_inv_vb, sig2_beta_vb=sig2_beta_vb,
                    sig2_theta_vb=sig2_theta_vb, tau_vb=tau_vb,
                    theta_vb=theta_vb, zeta_vb=zeta_vb)


def auto_set_init(y, p, p0, shr_fac_inv, user_seed=None) -> InitSpec:
    """Seeded random initialization, matching the reference's sampling
    distributions (reference: auto_set_init_, R/set_hyper_init.R:356-418);
    RNG streams differ from R (tolerance-based output comparison only)."""
    q = y.shape[1]
    rng = np.random.default_rng(user_seed)

    n0_vec, t02 = get_n0_t02(1, p, p0)
    n0 = float(n0_vec[0])
    s02 = 1e-4

    gam_vb = ndtr(rng.normal(loc=n0, scale=s02 + t02, size=(p, q)))
    mu_beta_vb = rng.normal(size=(p, q))

    sig2_inv_vb = 1e-2
    med_var = np.nanmedian(np.nanvar(y, axis=0, ddof=1))
    tau = 1.0 / med_var if np.isfinite(1.0 / med_var) else 1e3
    tau_vb = np.full(q, tau)

    # R: 1 / rgamma(q, shape = 2, rate = 1 / (sig2_inv * tau))
    sig2_beta_vb = 1.0 / rng.gamma(shape=2.0,
                                   scale=sig2_inv_vb * tau_vb)
    sig02_inv_vb = float(rng.gamma(shape=max(p, q), scale=1.0))

    theta_vb = rng.normal(scale=1.0 / np.sqrt(sig02_inv_vb * shr_fac_inv),
                          size=p)
    sig2_theta_vb = 1.0 / (q + rng.gamma(shape=sig02_inv_vb * shr_fac_inv,
                                         scale=1.0, size=p))
    zeta_vb = rng.normal(loc=n0, scale=np.sqrt(t02), size=q)

    return InitSpec(q=q, p=p, gam_vb=gam_vb, mu_beta_vb=mu_beta_vb,
                    sig02_inv_vb=sig02_inv_vb, sig2_beta_vb=sig2_beta_vb,
                    sig2_theta_vb=sig2_theta_vb, tau_vb=tau_vb,
                    theta_vb=theta_vb, zeta_vb=zeta_vb, auto=True)


# ------------------------------------------------- elicitation MC diagnostic

def map_hyperprior_elicitation(p0, p, q, n_draws=100_000, seed=None):
    """Monte-Carlo estimate of the elicitation error under the horseshoe
    (reference: map_hyperprior_elicitation, R/set_hyper_init.R:452-501).

    Fully vectorized (NumPy broadcasting replaces the reference's
    parallel::mclapply fork pool).  Returns dict(error_E_p, error_sd_p).
    """
    p0 = np.asarray(p0, dtype=float)
    if p0.shape != (2,):
        raise ValueError("p0 must be a vector of length 2")
    e_p, v_p = p0
    _check_positive(e_p, "p0[0]"); _check_positive(v_p, "p0[1]")
    if e_p > p:
        raise ValueError("The prior mean number of predictors per response "
                         "must be smaller than p")
    if n_draws < 1_000:
        import warnings
        warnings.warn("The number of draws may be too small for accurate "
                      "Monte Carlo estimation.")

    n0_vec, t02 = get_n0_t02(1, p, (e_p, v_p))
    n0 = float(n0_vec[0])

    rng = np.random.default_rng(seed)
    # half-Cauchy draws via tan transform
    lam = np.abs(np.tan(np.pi * (rng.uniform(size=n_draws) - 0.5)))
    sig0 = np.abs(np.tan(np.pi * (rng.uniform(size=n_draws) - 0.5))) / np.sqrt(q)

    s2 = t02 + lam ** 2 * sig0 ** 2
    e_phi = ndtr(n0 / np.sqrt(1.0 + s2))
    e_phi2 = e_phi - 2.0 * owens_t(n0 / np.sqrt(1.0 + s2),
                                   1.0 / np.sqrt(1.0 + 2.0 * s2))

    e_p_hs = np.mean(p * e_phi)
    v_p_hs = np.mean(p * (p - 1) * e_phi2 - p ** 2 * e_phi ** 2 + p * e_phi)

    return {"error_E_p": abs(e_p_hs - e_p),
            "error_sd_p": abs(np.sqrt(v_p_hs) - np.sqrt(v_p))}
