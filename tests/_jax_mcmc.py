"""The JAX package's samplers (atlasqtl_tpu/mcmc) with every draw they make
recorded, for tests/test_torch_mcmc.py and tests/test_torch_mesh.py.

The JAX chains thread an "rbg" key; every draw can be replayed outside the
chain from the key schedule (keys = split(state.key, 12) per gibbs_sweep,
split 6 in NUTS's likelihood block, one split of the master key per SMC
resampling), and every gamma shape is a function of the hyperparameters
and the sweep's new gam.  `run_recorded` runs a sampler with its sweeps
wrapped so that each one's draws are replayed beside it (`sweep_draws`);
the port plays them back through atlasqtl_tpu_torch/mcmc/draws.py:
ArrayDraws.  SMC's draws are replayed inside the same vmap over the
particle keys that run_smc makes: rbg draws under vmap are not the per-key
draws.
"""
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from atlasqtl_tpu.mcmc import gibbs as jgibbs
from atlasqtl_tpu.mcmc import nuts as jnuts
from atlasqtl_tpu.mcmc import smc as jsmc

from atlasqtl_tpu_torch.mcmc.draws import ArrayDraws


def sweep_draws(key, data, hyper, gam, temper, block, nuts=False):
    """Every draw one JAX gibbs_sweep (nuts: _likelihood_gibbs) made from
    `key`, by site, given the sweep's new gam; vmap it over particle keys
    to replay a vmapped sweep."""
    dt = data.x.dtype
    p, q = gam.shape
    keys = jax.random.split(key, 6 if nuts else 12)
    bg = []
    for kb in jax.random.split(keys[0], p // block):
        ku, kn = jax.random.split(kb)
        bg.append(jax.random.uniform(ku, (block, q), dt,
                                     minval=jnp.finfo(dt).tiny))
        bg.append(jax.random.normal(kn, (block, q), dt))
    out = dict(beta_gam=bg, z=[jax.random.uniform(
        keys[1], (p, q), dt, minval=1e-7, maxval=1.0 - 1e-7)])
    temper = jnp.asarray(temper, dt)
    shape_tau = hyper.eta + 0.5 * temper * data.n_eff + 0.5 * jnp.sum(gam, 0)
    shape_s = hyper.nu + 0.5 * jnp.sum(gam)
    k_tau, k_s = (keys[2], keys[3]) if nuts else (keys[4], keys[5])
    out["tau"] = [jax.random.gamma(k_tau, shape_tau, shape_tau.shape)]
    out["sig2_inv"] = [jax.random.gamma(k_s, shape_s, ())]
    if nuts:
        return out
    one = jnp.asarray(1.0, dt)
    out["theta"] = [jax.random.normal(keys[2], (p,), dt)]
    out["zeta"] = [jax.random.normal(keys[3], (q,), dt)]
    out["lam2_inv"] = [jax.random.gamma(keys[6], one, (p,))]
    out["inv_nu"] = [jax.random.gamma(keys[7], one, (p,))]
    out["sig02_inv"] = [jax.random.gamma(keys[8], 0.5 + 0.5 * data.p_true,
                                         ())]
    out["xi_inv"] = [jax.random.gamma(keys[9], one, ())]
    return out


class Recorder:
    """The draws of a sequence of JAX sweeps, by site in order."""

    def __init__(self, sites=None):
        self.sites = sites or {}

    def add(self, draws):
        for site, arrays in draws.items():
            self.sites.setdefault(site, []).extend(np.asarray(a)
                                                   for a in arrays)

    def draws(self, device="cpu", dtype=torch.float64):
        return ArrayDraws(self.sites, device, dtype)


class _JaxWith:
    """The jax module with some attributes replaced."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def __getattr__(self, name):
        return getattr(jax, name)


def run_recorded(sampler, data, hyper, cfg, block, **kw):
    """(Recorder, result) of the JAX package's run_gibbs, run_nuts or
    run_smc (sampler "gibbs", "nuts", "smc") on (data, hyper, cfg) with
    keyword arguments kw; `block` is the data's predictor block."""
    rec = Recorder()
    sweep, lik, resample = (jgibbs.gibbs_sweep, jnuts._likelihood_gibbs,
                            jsmc._systematic_resample)

    def gibbs_rec(state, data, hyper, gram, *, cfg, temper=1.0):
        new = sweep(state, data, hyper, gram, cfg=cfg, temper=temper)
        rec.add(sweep_draws(state.key, data, hyper, new.gam, temper, block))
        return new

    def nuts_rec(state, data, hyper, gram, *, cfg):
        new, zrow, zcol = lik(state, data, hyper, gram, cfg=cfg)
        rec.add(sweep_draws(state.key, data, hyper, new.gam, 1.0, block,
                            nuts=True))
        return new, zrow, zcol

    def resample_rec(key, log_w, n):
        rec.add(dict(resample=[jax.random.uniform(key, ())]))
        return resample(key, log_w, n)

    def vmap_rec(fn, in_axes=0, **vkw):
        # run_smc's mutations, sweep_v = jax.vmap(..., in_axes=(0, None)):
        # the draws are replayed inside the same vmap
        if in_axes != (0, None):
            return jax.vmap(fn, in_axes=in_axes, **vkw)

        def both(st, tmp):
            new = fn(st, tmp)
            return new, sweep_draws(st.key, data, hyper, new.gam, tmp, block)

        vm = jax.vmap(both, in_axes=in_axes, **vkw)

        def call(st, tmp):
            new, draws = vm(st, tmp)
            rec.add(draws)
            return new
        return call

    run = dict(gibbs=jgibbs.run_gibbs, nuts=jnuts.run_nuts,
               smc=jsmc.run_smc)[sampler]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgibbs, "gibbs_sweep", gibbs_rec)
        mp.setattr(jnuts, "_likelihood_gibbs", nuts_rec)
        mp.setattr(jsmc, "_systematic_resample", resample_rec)
        mp.setattr(jsmc, "jax", _JaxWith(vmap=vmap_rec))
        return rec, run(data, hyper, cfg, **kw)


def save_sites(path, rec: Recorder):
    """The recorded draws to an .npz, written whole before it appears
    (another process may be waiting for it)."""
    tmp = str(path) + ".tmp.npz"
    np.savez(tmp, **{f"{site}__{i:05d}": a
                     for site, arrays in rec.sites.items()
                     for i, a in enumerate(arrays)})
    os.replace(tmp, path)
