"""Trait-sharded MCMC: the Gibbs and NUTS-within-Gibbs cross-checks on a
mesh of processes (counterpart of atlasqtl_tpu/mcmc/sharded.py).

Given (theta, zeta) and the scalar precisions, the (beta, gamma, Z, tau)
blocks are independent across responses, and every cross-trait quantity
is a plain sum: sum(gam) and sum(tau ||beta_k||^2) for the slab precision,
the Z row sums and the zeta sum for theta.  So each rank keeps the q
columns of its shard of every (., q) tensor, replicates the rest (x, the
(p,) vectors, the scalars), and runs the samplers of mcmc/gibbs.py and
mcmc/nuts.py themselves: data.mesh makes those sums all-reduces
(parallel/mesh.py:q_sum).  On a 2-D mesh the p ranks of one q column hold
the same shard and run the same chain.

The draws do not depend on the layout: each (., q) site is drawn at the
full padded q width on every rank, which keeps its own columns
(mcmc/draws.py:QShardDraws), so the sharded chain is the single-process
chain up to reduction rounding.  NUTS's tree runs replicated on every rank
from the q-summed Z row sums and the gathered column sums.  Both samplers
return the full (p, q) summaries on every rank.  mcmc/smc.py:run_smc runs
on the shards of shard_data_by_traits too (its log-likelihood's sum over
q is an all-reduce).
"""
from __future__ import annotations

import dataclasses

from ..parallel import mesh as pmesh
from ..types import Config, Data, Hyper
from .gibbs import run_gibbs
from .nuts import run_nuts


def _q_spec(table):
    """A placement table (parallel/mesh.py) with its p axes replicated."""
    return {k: tuple(a if a == pmesh.Q_AXIS else None for a in v)
            for k, v in table.items()}


_DATA_Q = _q_spec(pmesh._DATA_SPEC)
_HYPER_Q = _q_spec(pmesh._HYPER_SPEC)


def shard_data_by_traits(data: Data, hyper: Hyper, mesh):
    """This rank's shards of (data, hyper): every (., q) tensor cut to the
    rank's columns of the mesh's trait axis, everything else replicated;
    the data carry the mesh."""
    return (dataclasses.replace(pmesh._put(data, mesh, _DATA_Q), mesh=mesh),
            pmesh._put(hyper, mesh, _HYPER_Q))


def run_gibbs_sharded(data: Data, hyper: Hyper, cfg: Config, mesh,
                      n_samples: int, n_burnin: int, seed: int = 0,
                      thin: int = 1, draws=None):
    """run_gibbs with the chain's (., q) state sharded over the mesh's
    trait axis: the single-process chain's samples, up to reduction
    rounding.  data, hyper: the full problem, the same on every rank."""
    data_s, hyper_s = shard_data_by_traits(data, hyper, mesh)
    return run_gibbs(data_s, hyper_s, cfg, n_samples, n_burnin, seed=seed,
                     thin=thin, draws=draws)


def run_nuts_sharded(data: Data, hyper: Hyper, cfg: Config, mesh,
                     n_samples: int, n_burnin: int, seed: int = 0,
                     thin: int = 1, draws=None):
    """NUTS-within-Gibbs with the conjugate blocks trait-sharded; the NUTS
    hotspot block consumes only the reduced O(p + q) statistics."""
    data_s, hyper_s = shard_data_by_traits(data, hyper, mesh)
    return run_nuts(data_s, hyper_s, cfg, n_samples, n_burnin, seed=seed,
                    thin=thin, draws=draws)
