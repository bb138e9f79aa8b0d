"""NUTS-within-Gibbs for the horseshoe hotspot block (counterpart of
atlasqtl_tpu/mcmc/nuts.py).

The spike-and-slab indicators are discrete, so the joint cannot be one
Hamiltonian system:

- the conjugate likelihood block -- the (beta, gamma) blocked draw, the
  Albert-Chib latents Z, the residual and slab precisions -- takes the
  exact Gibbs conditionals of mcmc/gibbs.py;
- the hotspot block (theta_s, lambda_s, sigma_0, zeta_t), the funnel where
  conjugate auxiliaries mix worst, takes NUTS (Hoffman & Gelman 2014,
  Algorithm 6, slice variable, dual-averaging step size) in the
  NON-CENTERED parameterization

      theta_s = sigma_0 lambda_s eta_s / sqrt(shr),  eta_s ~ N(0, 1),
      w = (eta (p,), log lambda (p,), log sigma_0, zeta_raw (q,)),

  whose potential given Z needs only the row and column sums of Z, so a
  leapfrog step costs O(p + q).  The tree recursion runs on the host with
  NumPy's generator, as the JAX package's does; each potential and its
  gradient (torch.autograd) run where the data are.

The half-Cauchy priors on lambda_s and sigma_0 are used directly in log
space (the model's Gamma-Gamma mixture marginalizes to them exactly,
R/set_hyper_init.R:126-128, 183-184).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..parallel import mesh as pmesh
from ..parallel.mesh import q_sum
from ..types import Config, Data, Hyper
from .draws import Draws, for_data
from .gibbs import (GibbsState, _beta_gam_sweep, _slab_consts, accumulate,
                    accumulators, chain_setup, init_state, sample_tau_sig2,
                    sample_z, summaries)

_LOG_2_PI = float(np.log(2.0 / np.pi))


class NutsStats(NamedTuple):
    """The O(p + q) sufficient statistics of the hotspot block's
    potential (full q on a trait mesh)."""
    zrow: Any     # (p,) row sums of Z over the responses
    zcol: Any     # (q,) column sums of Z over the predictors
    p_mask: Any
    q_mask: Any
    p_true: Any
    q_true: Any
    n0: Any       # (q,)
    t0: Any       # scalar sqrt(t02)
    shr_sqrt: Any


def _unpack(w, p, q):
    return w[:p], w[p:2 * p], w[2 * p], w[2 * p + 1:]


def theta_zeta_from_w(w, stats: NutsStats):
    p, q = stats.zrow.shape[0], stats.zcol.shape[0]
    eta, loglam, logsig0, zeta_raw = _unpack(w, p, q)
    theta = (torch.exp(logsig0 + loglam) * eta / stats.shr_sqrt) \
        * stats.p_mask
    zeta = (stats.n0 + stats.t0 * zeta_raw) * stats.q_mask
    return theta, zeta


def potential(w, stats: NutsStats):
    """-log posterior of the hotspot block given Z (up to a constant)."""
    p, q = stats.zrow.shape[0], stats.zcol.shape[0]
    eta, loglam, logsig0, zeta_raw = _unpack(w, p, q)
    theta, zeta = theta_zeta_from_w(w, stats)

    # priors (masked coordinates get a pure N(0,1)/C+(0,1) keep-in-place
    # density so they stay bounded and contribute a constant)
    u_eta = 0.5 * torch.sum(eta * eta)
    lam2 = torch.exp(2.0 * loglam)
    u_lam = -torch.sum((_LOG_2_PI + loglam - torch.log1p(lam2))
                       * stats.p_mask) \
        - torch.sum((-0.5 * loglam * loglam) * (1.0 - stats.p_mask))
    sig0sq = torch.exp(2.0 * logsig0)
    u_sig0 = -(_LOG_2_PI + logsig0 - torch.log1p(sig0sq))
    u_zeta = 0.5 * torch.sum(zeta_raw * zeta_raw)

    # likelihood of the probit latents: 0.5 sum_st (z - theta - zeta)^2
    # expanded through the row/col sums (the z^2 term is constant in w)
    th_sum, ze_sum = torch.sum(theta), torch.sum(zeta)
    u_lik = (-torch.dot(theta, stats.zrow) - torch.dot(zeta, stats.zcol)
             + 0.5 * stats.q_true * torch.sum(theta * theta)
             + 0.5 * stats.p_true * torch.sum(zeta * zeta)
             + th_sum * ze_sum)
    return u_eta + u_lam + u_sig0 + u_zeta + u_lik


def _potential_and_grad(w, stats: NutsStats):
    """(potential(w), its gradient in w), both detached."""
    with torch.enable_grad():
        wg = w.detach().requires_grad_(True)
        u = potential(wg, stats)
        (g,) = torch.autograd.grad(u, wg)
    return u.detach(), g


def _leapfrog(w, m, eps, stats):
    _, g = _potential_and_grad(w, stats)
    m = m - 0.5 * eps * g
    w = w + eps * m
    u, g = _potential_and_grad(w, stats)
    m = m - 0.5 * eps * g
    return w, m, u


def _hamiltonian(u, m):
    return float(u) + 0.5 * float(torch.dot(m, m))


class _Tree(NamedTuple):
    w_minus: Any
    m_minus: Any
    w_plus: Any
    m_plus: Any
    w_prop: Any
    n: int
    s: int
    alpha: float
    n_alpha: int


_DELTA_MAX = 1000.0


def _no_uturn(w_minus, w_plus, m_minus, m_plus):
    dw = w_plus - w_minus
    return (float(torch.dot(dw, m_minus)) >= 0.0
            and float(torch.dot(dw, m_plus)) >= 0.0)


def _build_tree(rng, w, m, log_u, v, j, eps, stats, h0):
    """Hoffman & Gelman Algorithm 6 recursion (host control flow).
    Returns a _Tree."""
    if j == 0:
        w1, m1, u1 = _leapfrog(w, m, v * eps, stats)
        h1 = _hamiltonian(u1, m1)
        n1 = int(log_u <= -h1)
        s1 = int(log_u < _DELTA_MAX - h1)
        alpha = min(1.0, float(np.exp(min(0.0, h0 - h1))))
        return _Tree(w1, m1, w1, m1, w1, n1, s1, alpha, 1)
    t = _build_tree(rng, w, m, log_u, v, j - 1, eps, stats, h0)
    if t.s != 1:
        return t
    if v < 0:
        t2 = _build_tree(rng, t.w_minus, t.m_minus, log_u, v, j - 1, eps,
                         stats, h0)
        w_minus, m_minus = t2.w_minus, t2.m_minus
        w_plus, m_plus = t.w_plus, t.m_plus
    else:
        t2 = _build_tree(rng, t.w_plus, t.m_plus, log_u, v, j - 1, eps,
                         stats, h0)
        w_minus, m_minus = t.w_minus, t.m_minus
        w_plus, m_plus = t2.w_plus, t2.m_plus
    w_prop = t.w_prop
    tot = t.n + t2.n
    if tot > 0 and rng.uniform() < t2.n / tot:
        w_prop = t2.w_prop
    s = t2.s * int(_no_uturn(w_minus, w_plus, m_minus, m_plus))
    return _Tree(w_minus, m_minus, w_plus, m_plus, w_prop, tot, s,
                 t.alpha + t2.alpha, t.n_alpha + t2.n_alpha)


def nuts_step(rng, w, eps, stats, max_depth: int = 8):
    """One NUTS transition.  Returns (w', mean acceptance statistic)."""
    m0 = torch.as_tensor(rng.normal(size=w.shape[0]), dtype=w.dtype,
                         device=w.device)
    u0, _ = _potential_and_grad(w, stats)
    h0 = _hamiltonian(u0, m0)
    log_u = -h0 - rng.exponential()   # log of u ~ U(0, exp(-H0))

    w_minus = w_plus = w_prop = w
    m_minus = m_plus = m0
    j, n, s = 0, 1, 1
    alpha_sum, n_alpha = 0.0, 1
    while s == 1 and j < max_depth:
        v = 1.0 if rng.uniform() < 0.5 else -1.0
        if v < 0:
            t = _build_tree(rng, w_minus, m_minus, log_u, v, j, eps, stats,
                            h0)
            w_minus, m_minus = t.w_minus, t.m_minus
        else:
            t = _build_tree(rng, w_plus, m_plus, log_u, v, j, eps, stats, h0)
            w_plus, m_plus = t.w_plus, t.m_plus
        if t.s == 1 and rng.uniform() < min(1.0, t.n / max(n, 1)):
            w_prop = t.w_prop
        n += t.n
        s = t.s * int(_no_uturn(w_minus, w_plus, m_minus, m_plus))
        j += 1
        alpha_sum, n_alpha = t.alpha, t.n_alpha
    return w_prop, alpha_sum / max(n_alpha, 1)


class DualAveraging:
    """Nesterov dual averaging of log(eps) (Hoffman & Gelman section
    3.2)."""

    def __init__(self, eps0, target=0.8, gamma=0.05, t0=10.0, kappa=0.75):
        self.mu = np.log(10.0 * eps0)
        self.target, self.gamma, self.t0, self.kappa = target, gamma, t0, kappa
        self.log_eps = np.log(eps0)
        self.log_eps_bar = 0.0
        self.h_bar = 0.0
        self.t = 0

    def update(self, alpha):
        self.t += 1
        frac = 1.0 / (self.t + self.t0)
        self.h_bar = (1 - frac) * self.h_bar + frac * (self.target - alpha)
        self.log_eps = self.mu - np.sqrt(self.t) / self.gamma * self.h_bar
        w = self.t ** (-self.kappa)
        self.log_eps_bar = w * self.log_eps + (1 - w) * self.log_eps_bar
        return np.exp(self.log_eps)

    @property
    def eps_final(self):
        return float(np.exp(self.log_eps_bar))


def _likelihood_gibbs(state: GibbsState, data: Data, hyper: Hyper,
                      gram_blocks, draws: Draws, *, cfg: Config):
    """Exact conjugate draws of the likelihood block given (theta, zeta):
    (beta, gamma), the Z latents, tau and sig2_inv.  Returns the new state
    and the Z row sums (summed over the trait mesh) and this rank's column
    sums."""
    draws = for_data(draws, data)
    one = torch.ones((), dtype=cfg.dtype, device=data.x.device)
    gam, beta, fitted = _beta_gam_sweep(
        state, data, gram_blocks, _slab_consts(state, data, one), draws)
    z = sample_z(draws, gam, state.theta, state.zeta, data.p_mask,
                 data.q_mask)
    tau, sig2_inv = sample_tau_sig2(draws, data, hyper, gam, beta, fitted,
                                    state.sig2_inv, one)
    new = state.replace(beta=beta, gam=gam, fitted=fitted, tau=tau,
                        sig2_inv=sig2_inv)
    return new, q_sum(data.mesh, torch.sum(z, dim=1)), torch.sum(z, dim=0)


def _q_full(data: Data, t):
    """A (q,) tensor of this rank's columns gathered to the full q."""
    if data.mesh is None:
        return t
    return pmesh.gather(t, data.mesh, (pmesh.Q_AXIS,))


def _q_local(data: Data, t):
    """This rank's columns of a full (q,) tensor."""
    if data.mesh is None:
        return t
    return pmesh.shard(t, data.mesh, (pmesh.Q_AXIS,))


def run_nuts(data: Data, hyper: Hyper, cfg: Config, n_samples: int,
             n_burnin: int, seed: int = 0, thin: int = 1,
             max_depth: int = 8, target_accept: float = 0.8, draws=None):
    """NUTS-within-Gibbs; returns posterior-mean summaries (pip (p, q),
    beta_mean (p, q), theta_mean (p,), zeta_mean (q,)) as NumPy, like
    run_gibbs.  The Gibbs block's draws are run_gibbs's; the tree's come
    from np.random.default_rng(seed + 1), as in the JAX package."""
    dt, dev = cfg.dtype, data.x.device
    p_pad = data.x.shape[1]
    gram_blocks, draws = chain_setup(data, cfg, seed, draws)
    state = init_state(data, cfg)
    rng = np.random.default_rng(seed + 1)
    t = lambda v: torch.as_tensor(v, dtype=dt, device=dev)
    stats_fixed = dict(
        p_mask=data.p_mask, q_mask=_q_full(data, data.q_mask),
        p_true=data.p_true, q_true=data.q_true,
        n0=_q_full(data, hyper.n0), t0=torch.sqrt(hyper.t02),
        shr_sqrt=torch.sqrt(t(cfg.shr_fac_inv)))
    q_full = stats_fixed["q_mask"].shape[0]

    # non-centered coordinates; start at the prior-ish origin
    w = torch.cat([
        t(rng.normal(size=p_pad) * 0.1),                       # eta
        torch.zeros(p_pad, dtype=dt, device=dev),              # log lam
        t([-0.5 * np.log(max(float(data.q_true), 1.0))]),      # log sig0
        torch.zeros(q_full, dtype=dt, device=dev),             # zeta_raw
    ])

    eps = 0.1
    da = DualAveraging(eps, target=target_accept)
    acc, kept = accumulators(state), 0
    for it in range(n_burnin + n_samples):
        state, zrow, zcol = _likelihood_gibbs(state, data, hyper,
                                              gram_blocks, draws, cfg=cfg)
        stats = NutsStats(zrow=zrow, zcol=_q_full(data, zcol), **stats_fixed)
        w, alpha = nuts_step(rng, w, eps, stats, max_depth=max_depth)
        if it < n_burnin:
            eps = float(da.update(alpha))
        elif it == n_burnin:
            eps = da.eps_final
        theta, zeta = theta_zeta_from_w(w, stats)
        state = state.replace(
            theta=theta, zeta=_q_local(data, zeta),
            lam2_inv=torch.exp(-2.0 * w[p_pad:2 * p_pad]),
            sig02_inv=torch.exp(-2.0 * w[2 * p_pad]))
        if it >= n_burnin and (it - n_burnin) % thin == 0:
            accumulate(acc, state)
            kept += 1
    return summaries(acc, kept, data)
