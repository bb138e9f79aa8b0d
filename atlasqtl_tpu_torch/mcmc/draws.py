"""The samplers' one source of randomness (the port's own module; the JAX
package threads an "rbg" key through GibbsState.key instead).

Every random draw of mcmc/ goes through an object with three methods, each
named by its draw site:

    uniform(site, shape, low, high)    U[low, high) of `shape`
    normal(site, shape)                N(0, 1) of `shape`
    standard_gamma(site, alpha)        Gamma(alpha, 1) of alpha's shape

The sites of one gibbs_sweep, in the order it draws them, and the JAX key
each one replaces (keys = split(state.key, 12), atlasqtl_tpu/mcmc/
gibbs.py:189):

    beta_gam   keys[0]: per predictor block a uniform on [tiny, 1) and a
               normal, both (B, q)
    z          keys[1]: uniform on [1e-7, 1 - 1e-7), (p, q)
    theta      keys[2]: normal (p,)        zeta      keys[3]: normal (q,)
    tau        keys[4]: gamma (q,)         sig2_inv  keys[5]: gamma ()
    lam2_inv   keys[6]: gamma (p,)         inv_nu    keys[7]: gamma (p,)
    sig02_inv  keys[8]: gamma ()           xi_inv    keys[9]: gamma ()

NUTS's likelihood block draws beta_gam, z, tau and sig2_inv; SMC's
resampling draws one uniform at `resample`.  Batched particles add a
leading axis to every shape.

- TorchDraws draws from a torch.Generator on the data's device.
- ArrayDraws plays back given arrays, per site in order (a JAX chain's
  recorded draws, or one chain's draws on two devices); RecordingDraws
  keeps what another source draws, for ArrayDraws to play back.
- QShardDraws serves a rank of a trait mesh: each (., q) site is drawn at
  the full padded q width and the rank keeps its own columns, so that the
  chain does not depend on the layout (tau's per-column gamma shapes are
  gathered first).
"""
from __future__ import annotations

from typing import Protocol

import numpy as np
import torch

from ..parallel import mesh as pmesh

# the sites whose last axis is q
Q_SITES = frozenset(("beta_gam", "z", "zeta", "tau"))


class Draws(Protocol):
    def uniform(self, site: str, shape, low: float, high: float): ...

    def normal(self, site: str, shape): ...

    def standard_gamma(self, site: str, alpha): ...


class TorchDraws:
    """Draws from `generator` (its device is the draws' device) in
    `dtype`."""

    def __init__(self, generator: torch.Generator, dtype=torch.float64):
        self.generator, self.dtype = generator, dtype
        self.device = generator.device

    @classmethod
    def seeded(cls, seed: int, device, dtype):
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        return cls(gen, dtype)

    def uniform(self, site, shape, low, high):
        u = torch.rand(tuple(shape), generator=self.generator,
                       dtype=self.dtype, device=self.device)
        # as jax.random.uniform: scaled, then held at low
        return torch.clamp_min(u * (high - low) + low, low)

    def normal(self, site, shape):
        return torch.randn(tuple(shape), generator=self.generator,
                           dtype=self.dtype, device=self.device)

    def standard_gamma(self, site, alpha):
        return torch._standard_gamma(alpha, generator=self.generator)


class ArrayDraws:
    """Plays back `arrays[site]`, a sequence of arrays, one per draw at that
    site in the order the chain draws them, on `device` in `dtype`.  Each
    draw's shape is checked; running out of a site's arrays raises."""

    def __init__(self, arrays, device, dtype=torch.float64):
        self.arrays = {k: list(v) for k, v in arrays.items()}
        self.device, self.dtype = torch.device(device), dtype
        self.used = dict.fromkeys(self.arrays, 0)

    def _next(self, site, shape):
        i = self.used.get(site, 0)
        queue = self.arrays.get(site, ())
        if i >= len(queue):
            raise IndexError(f"ArrayDraws: no draw {i} at site {site!r}")
        self.used[site] = i + 1
        a = torch.tensor(np.asarray(queue[i]), dtype=self.dtype,
                         device=self.device)
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"ArrayDraws: draw {i} at site {site!r} has "
                             f"shape {tuple(a.shape)}, the chain asks for "
                             f"{tuple(shape)}")
        return a

    def uniform(self, site, shape, low, high):
        return self._next(site, shape)

    def normal(self, site, shape):
        return self._next(site, shape)

    def standard_gamma(self, site, alpha):
        return self._next(site, alpha.shape)


class RecordingDraws:
    """`draws`, keeping a host copy of every draw by site; `replay()` plays
    them back (one chain's draws on another device)."""

    def __init__(self, draws):
        self.draws, self.sites = draws, {}

    def _keep(self, site, v):
        self.sites.setdefault(site, []).append(v.detach().cpu().numpy())
        return v

    def uniform(self, site, shape, low, high):
        return self._keep(site, self.draws.uniform(site, shape, low, high))

    def normal(self, site, shape):
        return self._keep(site, self.draws.normal(site, shape))

    def standard_gamma(self, site, alpha):
        return self._keep(site, self.draws.standard_gamma(site, alpha))

    def replay(self, device, dtype=torch.float64) -> ArrayDraws:
        return ArrayDraws(self.sites, device, dtype)


class QShardDraws:
    """`draws` on one rank of a trait-sharded chain: a Q_SITES draw is made
    at the full q width (this rank's width times the mesh's q-shards) on
    every rank, which keeps its own columns; every other site is drawn as
    asked, the same on every rank."""

    def __init__(self, draws, mesh):
        self.draws, self.mesh = draws, mesh

    def _cols(self, full):
        return pmesh.shard(full, self.mesh, self._spec(full))

    @staticmethod
    def _spec(t):
        return (None,) * (t.dim() - 1) + (pmesh.Q_AXIS,)

    def _full(self, shape):
        return (*shape[:-1], shape[-1] * self.mesh.n_q)

    def uniform(self, site, shape, low, high):
        if site not in Q_SITES:
            return self.draws.uniform(site, shape, low, high)
        return self._cols(self.draws.uniform(site, self._full(shape), low,
                                             high))

    def normal(self, site, shape):
        if site not in Q_SITES:
            return self.draws.normal(site, shape)
        return self._cols(self.draws.normal(site, self._full(shape)))

    def standard_gamma(self, site, alpha):
        if site not in Q_SITES:
            return self.draws.standard_gamma(site, alpha)
        full = pmesh.gather(alpha, self.mesh, self._spec(alpha))
        return self._cols(self.draws.standard_gamma(site, full))


def for_data(draws, data):
    """`draws` as the chain on `data` must use them: wrapped in QShardDraws
    when data is a rank's shard of a trait mesh."""
    if data.mesh is None or isinstance(draws, QShardDraws):
        return draws
    return QShardDraws(draws, data.mesh)
