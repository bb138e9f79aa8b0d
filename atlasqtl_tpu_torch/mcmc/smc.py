"""Annealed SMC sampler over the tempered posterior (counterpart of
atlasqtl_tpu/mcmc/smc.py).

A sequential Monte Carlo sampler in the Del Moral-Doucet-Jasra style
targeting pi_t propto prior * likelihood^{c_t} along the SAME
inverse-temperature ladder the CAVI engine anneals over
(R/utils.R:108-146).  Mutations are the exact tempered Gibbs kernel
(mcmc/gibbs.py, `temper`), weights are the tempered-likelihood increments,
with systematic resampling at low ESS.

The particles are one GibbsState with a leading axis of n_particles, so a
mutation is one batched gibbs_sweep over all of them.  On a rank of a trait
mesh the log-likelihood's sum over q is an all-reduce, and the summaries
are gathered to the full q, as in mcmc/gibbs.py.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.annealing import annealing_ladder
from ..types import Config, Data, Hyper
from ..parallel.mesh import q_sum
from .gibbs import (GibbsState, chain_setup, gibbs_sweep, init_state,
                    summaries)


def log_likelihood(state: GibbsState, data: Data, *, cfg: Config):
    """Gaussian log-likelihood log p(y | beta, tau), one per particle."""
    resid2 = (data.y_norm_sq
              - 2.0 * torch.einsum("nq,...nq->...q", data.y, state.fitted)
              + torch.einsum("...nq,...nq->...q", state.fitted,
                             state.fitted))
    per_q = (0.5 * data.n_eff * (torch.log(state.tau) - np.log(2.0 * np.pi))
             - 0.5 * state.tau * resid2)
    return q_sum(data.mesh, torch.sum(per_q * data.q_mask, dim=-1))


def _systematic_resample(draws, log_w, n):
    """The n indices of systematic resampling under weights softmax(log_w).
    A position past the last cumulative weight by rounding takes the last
    particle (JAX clamps the gather index there)."""
    w = torch.softmax(log_w, dim=0)
    u = draws.uniform("resample", (), 0.0, 1.0)
    positions = (u + torch.arange(n, dtype=log_w.dtype,
                                  device=log_w.device)) / n
    idx = torch.searchsorted(torch.cumsum(w, dim=0), positions)
    return torch.clamp(idx, max=n - 1)


def run_smc(data: Data, hyper: Hyper, cfg: Config, n_particles: int = 32,
            anneal=(1, 2, 10), n_mutations: int = 3, n_final: int = 200,
            seed: int = 0, draws=None):
    """Annealed SMC; after reaching temperature 1 the particle set is
    refined with `n_final` plain Gibbs sweeps (averaging over them and the
    particles).  Returns (pip, beta_mean, theta_mean, zeta_mean) as NumPy
    and the log evidence estimate, a float."""
    gram_blocks, draws = chain_setup(data, cfg, seed, draws)
    particles = init_state(data, cfg, n_particles)

    def mutate(ps, temper):
        return gibbs_sweep(ps, data, hyper, gram_blocks, draws, cfg=cfg,
                           temper=temper)

    ladder = np.concatenate([[0.0], annealing_ladder(anneal)])
    log_w = torch.zeros(n_particles, dtype=cfg.dtype, device=data.x.device)
    log_evidence = 0.0
    for c_prev, c in zip(ladder[:-1], ladder[1:]):
        inc = float(c - c_prev) * log_likelihood(particles, data, cfg=cfg)
        log_evidence += float(torch.logsumexp(log_w + inc, 0)
                              - torch.logsumexp(log_w, 0))
        log_w = log_w + inc
        ess = float(1.0 / torch.sum(torch.softmax(log_w, 0) ** 2))
        if ess < n_particles / 2:
            idx = _systematic_resample(draws, log_w, n_particles)
            particles = particles.map(lambda a: a[idx])
            log_w = torch.zeros_like(log_w)
        for _ in range(n_mutations):
            particles = mutate(particles, float(c))

    # final refinement at temperature 1, accumulating posterior summaries
    # (in float64, as the JAX package accumulates them in NumPy)
    w = torch.softmax(log_w, 0)
    acc = {k: torch.zeros(getattr(particles, k).shape[1:],
                          dtype=torch.float64, device=w.device)
           for k in ("gam", "beta", "theta", "zeta")}
    for _ in range(n_final):
        particles = mutate(particles, 1.0)
        for k in acc:
            acc[k] += torch.tensordot(w, getattr(particles, k), dims=1)
    return (*summaries(acc, n_final, data), log_evidence)
