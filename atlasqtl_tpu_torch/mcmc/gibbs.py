"""Exact blocked Gibbs sampler, the gold-standard cross-check (counterpart
of atlasqtl_tpu/mcmc/gibbs.py).

Samples the SAME joint model the CAVI engine approximates (reference model
at R/set_hyper_init.R:16-31, 126-128, 183-184):

  y_t | beta, tau_t   ~ N(X beta_.t, tau_t^{-1} I)
  beta_st | gam_st=1  ~ N(0, sig2 / tau_t),  spike at 0 otherwise
  gam_st              ~ Bernoulli(Phi(theta_s + zeta_t))
  theta_s             ~ N(0, sig0^2 lam_s^2 / shr),  lam_s ~ C+(0,1)
  sig0^{-2}           ~ Gamma(1/2, xi^{-1}),  xi^{-1} ~ Gamma(1/2, A^{-2})
  zeta_t              ~ N(n0_t, t0^2);  tau_t ~ Gamma(eta, kappa);
  sig^{-2}            ~ Gamma(nu, rho)

Every conditional is conjugate (probit -> Albert-Chib truncated-normal
latents; half-Cauchy -> inverse-gamma auxiliaries), so the sampler is
exact.  The (beta, gam) draw is the CAVI sweep's structure: predictor
blocks in order, each projecting the n-space fitted matrix F = X beta
(r0 = x_b^T F), then a sequential chain over the block's coordinates
through the block Gram, vectorized over the responses, then F += x_b delta.

The draws come from an explicit source (mcmc/draws.py), named by site.  A
state may carry a leading particle axis (mcmc/smc.py): every function here
then sweeps all particles at once.  On a rank of a trait mesh (data.mesh,
mcmc/sharded.py) the cross-trait sums are all-reduces (parallel/mesh.py:
q_sum) and the draws are made at the full q width.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..models.global_local import data_block
from ..ops.special import log_ndtr_both
from ..ops.sweep import block_gram
from ..parallel import mesh as pmesh
from ..parallel.mesh import q_sum
from ..types import Config, Data, Hyper
from .draws import Draws, TorchDraws, for_data


@dataclasses.dataclass(frozen=True)
class GibbsState:
    """The chain's state, JAX's fields less the key.  Shapes, after an
    optional leading particle axis: beta, gam (p, q), gam in {0, 1};
    fitted (n, q) = X beta; tau, zeta (q,); theta, lam2_inv, nu_aux (p,)
    (nu_aux the half-Cauchy auxiliary of lam); sig2_inv, sig02_inv, xi_inv
    scalars."""
    beta: Any
    gam: Any
    fitted: Any
    tau: Any
    sig2_inv: Any
    theta: Any
    zeta: Any
    lam2_inv: Any
    nu_aux: Any
    sig02_inv: Any
    xi_inv: Any

    def replace(self, **kw) -> "GibbsState":
        return dataclasses.replace(self, **kw)

    def map(self, fn) -> "GibbsState":
        """fn applied to every field."""
        return GibbsState(**{f.name: fn(getattr(self, f.name))
                             for f in dataclasses.fields(self)})


def init_state(data: Data, cfg: Config, n_particles=None) -> GibbsState:
    """The chain's start (gibbs.py:52-70), with a leading axis of
    n_particles if given."""
    lead = () if n_particles is None else (int(n_particles),)
    n, p_pad = data.x.shape
    q_pad = data.y.shape[1]
    kw = dict(dtype=cfg.dtype, device=data.x.device)
    full = lambda shape, v: torch.full((*lead, *shape), float(v), **kw)
    return GibbsState(
        beta=full((p_pad, q_pad), 0.0), gam=full((p_pad, q_pad), 0.0),
        fitted=full((n, q_pad), 0.0), tau=full((q_pad,), 1.0),
        sig2_inv=full((), 1.0), theta=full((p_pad,), 0.0),
        zeta=full((q_pad,), -1.0), lam2_inv=full((p_pad,), 1.0),
        nu_aux=full((p_pad,), 1.0), sig02_inv=full((), float(data.q_true)),
        xi_inv=full((), 1.0))


def _sample_gamma(draws, site, shape_param, rate, size=()):
    """Gamma(shape, rate): a standard gamma draw of shape_param (broadcast
    to `size`) over rate."""
    alpha = torch.broadcast_to(shape_param, torch.broadcast_shapes(
        shape_param.shape, tuple(size)))
    return draws.standard_gamma(site, alpha) / rate


def _beta_gam_sweep(state: GibbsState, data: Data, gram_blocks, consts,
                    draws):
    """Sequential (beta, gam) draw: blocked Gauss-Seidel over predictors,
    the exact conditional per coordinate (slab mean and variance are the
    CAVI sweep's; gam is a Bernoulli draw and beta a normal draw where the
    sweep takes their expectations).  consts: s2, temper * tau and
    log_s2_sig_tau, each (..., q).

    The chain is eager PyTorch, 11 launches per coordinate and no other
    host call: what does not depend on the chain is computed for the whole
    block first and split into (..., 1, q) row views, and the Bernoulli
    draw u < sigmoid(logit) is taken on the logit scale, logit > log(u) -
    log1p(-u), with the padded predictors' thresholds infinite."""
    x = data.x
    block = gram_blocks.shape[1]
    nb = x.shape[1] // block
    s2, tau_t, log_s2_sig_tau = (c[..., None, :] for c in consts)
    lead, q = state.beta.shape[:-2], state.beta.shape[-1]
    tiny = torch.finfo(x.dtype).tiny
    sd, ct, half_inv_s2 = torch.sqrt(s2), s2 * tau_t, 1.0 / (2.0 * s2)
    fitted = state.fitted
    gam, beta = state.gam.clone(), state.beta.clone()
    rows = lambda t: torch.split(t, 1, dim=-2)
    diag = torch.diagonal(gram_blocks, dim1=-2, dim2=-1).tolist()
    for b in range(nb):
        sl = slice(b * block, (b + 1) * block)
        xb, gb = x[:, sl], gram_blocks[b]
        unif = draws.uniform("beta_gam", (*lead, block, q), tiny, 1.0)
        norm = draws.normal("beta_gam", (*lead, block, q))
        thr = rows(torch.where(data.p_mask[sl, None] > 0,
                               torch.log(unif) - torch.log1p(-unif),
                               torch.inf))
        sdn = rows(sd * norm)
        log_p, log_1p = log_ndtr_both(state.theta[..., sl, None]
                                      + state.zeta[..., None, :])
        lo = rows(log_p - log_1p + log_s2_sig_tau)
        ctcp = rows(ct * data.cp_x_y[sl])
        r = torch.einsum("ni,...nq->...iq", xb, fitted)
        r_rows, gcols, d = rows(r), torch.split(gb, 1, dim=1), diag[b]
        beta_old_b = beta[..., sl, :].clone()
        gam_rows, beta_rows = rows(gam[..., sl, :]), rows(beta[..., sl, :])
        for i in range(block):
            beta_old = beta_rows[i]
            r_i = torch.add(r_rows[i], beta_old, alpha=-d[i])
            mu_i = torch.addcmul(ctcp[i], ct, r_i, value=-1.0)
            logit = torch.addcmul(lo[i], mu_i * mu_i, half_inv_s2)
            inc = logit > thr[i]
            beta_new = torch.where(inc, mu_i + sdn[i], 0.0)
            r.addcmul_(gcols[i], beta_new - beta_old)
            gam_rows[i].copy_(inc)
            beta_old.copy_(beta_new)
        fitted = fitted + torch.einsum("ni,...iq->...nq", xb,
                                       beta[..., sl, :] - beta_old_b)
    qm = data.q_mask
    return gam * qm, beta * qm, fitted


def sample_z(draws, gam, theta, zeta, p_mask, q_mask):
    """Albert-Chib probit latents: Z | gam, theta, zeta by inverse-CDF
    truncated normals (gam = 1 -> Z > 0, gam = 0 -> Z < 0)."""
    u_mean = theta[..., :, None] + zeta[..., None, :]
    _, log_1p = log_ndtr_both(u_mean)
    uz = draws.uniform("z", gam.shape, 1e-7, 1.0 - 1e-7)
    p_le0 = torch.exp(log_1p)      # P(Z <= 0) for Z ~ N(u, 1) is Phi(-u)
    v = torch.where(gam > 0.5, p_le0 + uz * (1.0 - p_le0), uz * p_le0)
    v = torch.clamp(v, 1e-7, 1.0 - 1e-7)
    z = u_mean + torch.special.ndtri(v)
    return z * p_mask[:, None] * q_mask[None, :]


def sample_tau_sig2(draws, data: Data, hyper: Hyper, gam, beta, fitted,
                    sig2_inv, temper):
    """Conjugate draws of the residual precisions tau and the slab
    precision sig2_inv given (beta, gam, fitted)."""
    resid2 = (data.y_norm_sq - 2.0 * torch.einsum("nq,...nq->...q", data.y,
                                                  fitted)
              + torch.einsum("...nq,...nq->...q", fitted, fitted))
    beta2_colsum = torch.einsum("...pq,...pq->...q", beta, beta)
    shape_tau = (hyper.eta + 0.5 * temper * data.n_eff
                 + 0.5 * torch.sum(gam, dim=-2))
    rate_tau = hyper.kappa + 0.5 * (temper * resid2
                                    + sig2_inv[..., None] * beta2_colsum)
    tau = _sample_gamma(draws, "tau", shape_tau, rate_tau)
    sums = q_sum(data.mesh, torch.stack([torch.sum(gam, dim=(-2, -1)),
                                         torch.sum(tau * beta2_colsum, -1)]))
    shape_s = hyper.nu + 0.5 * sums[0]
    rate_s = hyper.rho + 0.5 * sums[1]
    return tau, _sample_gamma(draws, "sig2_inv", shape_s, rate_s)


def _slab_consts(state: GibbsState, data: Data, temper):
    """s2_t = 1 / (tau_t (temper (n - 1) + sig2_inv)) -- the CAVI
    sig2_beta at temper = 1 (complete data, X standardized) -- temper *
    tau and 0.5 (log s2 + log sig2_inv + log tau)."""
    sig2_inv = state.sig2_inv[..., None]
    s2 = 1.0 / (state.tau * (temper * (data.n - 1.0) + sig2_inv))
    log_s2_sig_tau = 0.5 * (torch.log(s2) + torch.log(sig2_inv)
                            + torch.log(state.tau))
    return s2, temper * state.tau, log_s2_sig_tau


def gibbs_sweep(state: GibbsState, data: Data, hyper: Hyper, gram_blocks,
                draws: Draws, *, cfg: Config, temper=1.0) -> GibbsState:
    """One full Gibbs scan over all blocks of conditionals.

    `temper` raises the LIKELIHOOD to the given power (SMC tempering); the
    conjugate conditionals absorb it exactly: the slab posterior precision
    becomes temper tau (n - 1) + tau sig2_inv and the tau shape and rate
    terms scale by temper.  temper = 1 is the plain sampler."""
    draws = for_data(draws, data)
    mesh = data.mesh
    kw = dict(dtype=cfg.dtype, device=data.x.device)
    temper = torch.as_tensor(temper, **kw)
    shr = torch.as_tensor(cfg.shr_fac_inv, **kw)

    # ---- (beta, gam) | rest
    gam, beta, fitted = _beta_gam_sweep(
        state, data, gram_blocks, _slab_consts(state, data, temper), draws)

    # ---- Z | gam, theta, zeta, then theta and zeta | Z in sequence
    z = sample_z(draws, gam, state.theta, state.zeta, data.p_mask,
                 data.q_mask)
    prec_th = data.q_true + state.sig02_inv[..., None] * state.lam2_inv * shr
    var_th = 1.0 / prec_th
    zsums = q_sum(mesh, torch.cat([
        torch.sum(z, dim=-1),
        torch.sum(state.zeta * data.q_mask, dim=-1)[..., None]], dim=-1))
    mean_th = var_th * (zsums[..., :-1] - zsums[..., -1:])
    theta = (mean_th + torch.sqrt(var_th)
             * draws.normal("theta", mean_th.shape)) * data.p_mask

    t02_inv = 1.0 / hyper.t02
    var_ze = 1.0 / (data.p_true + t02_inv)
    mean_ze = var_ze * (torch.sum(z, dim=-2) + t02_inv * hyper.n0
                        - torch.sum(theta, dim=-1)[..., None])
    zeta = (mean_ze + torch.sqrt(var_ze)
            * draws.normal("zeta", mean_ze.shape)) * data.q_mask

    # ---- tau, sig2_inv | rest
    tau, sig2_inv = sample_tau_sig2(draws, data, hyper, gam, beta, fitted,
                                    state.sig2_inv, temper)

    # ---- horseshoe scales
    # lam_s^2 | theta, sig02_inv, nu_aux ~ IG(1, 1/nu_aux + th^2 prec/2)
    quad = state.sig02_inv[..., None] * shr * theta * theta / 2.0
    rate_lam = 1.0 / state.nu_aux + quad
    one = torch.ones((), **kw)
    lam2_inv = _sample_gamma(draws, "lam2_inv", one, rate_lam,
                             rate_lam.shape)
    # nu_aux | lam ~ IG(1, 1 + lam^{-2}) -> 1/nu_aux ~ Gamma(1, 1 + lam2_inv)
    inv_nu = _sample_gamma(draws, "inv_nu", one, 1.0 + lam2_inv,
                           lam2_inv.shape)
    nu_aux = 1.0 / inv_nu
    # sig0^{-2} | theta, lam, xi
    shape_s0 = 0.5 + 0.5 * data.p_true
    rate_s0 = state.xi_inv + 0.5 * torch.sum(
        lam2_inv * shr * theta * theta * data.p_mask, dim=-1)
    sig02_inv = _sample_gamma(draws, "sig02_inv", shape_s0, rate_s0,
                              rate_s0.shape)
    # xi^{-1} | sig0^{-2} ~ Gamma(1, A^{-2} + sig0^{-2})
    xi_inv = _sample_gamma(draws, "xi_inv", one, hyper.a2_inv + sig02_inv,
                           sig02_inv.shape)
    return GibbsState(beta=beta, gam=gam, fitted=fitted, tau=tau,
                      sig2_inv=sig2_inv, theta=theta, zeta=zeta,
                      lam2_inv=lam2_inv, nu_aux=nu_aux, sig02_inv=sig02_inv,
                      xi_inv=xi_inv)


def chain_setup(data: Data, cfg: Config, seed: int, draws):
    """The Gram blocks of the fit's predictor block and the draws: a
    TorchDraws on the data's device seeded with `seed` unless `draws` is
    given."""
    gram_blocks = block_gram(data.x, data_block(cfg, data))
    if draws is None:
        draws = TorchDraws.seeded(seed, data.x.device, cfg.dtype)
    return gram_blocks, draws


def summaries(acc, kept, data: Data):
    """(pip, beta_mean, theta_mean, zeta_mean) as NumPy from the
    accumulated sums, gathered to the full q on a trait mesh."""
    spec = dict(gam=(None, pmesh.Q_AXIS), beta=(None, pmesh.Q_AXIS),
                theta=(None,), zeta=(pmesh.Q_AXIS,))
    out = []
    for name in ("gam", "beta", "theta", "zeta"):
        t = acc[name] / kept
        if data.mesh is not None:
            t = pmesh.gather(t, data.mesh, spec[name])
        out.append(t.cpu().numpy())
    return tuple(out)


def accumulators(state: GibbsState):
    """Zero sums of the four summarised fields, shaped as the state's."""
    return {k: torch.zeros_like(getattr(state, k))
            for k in ("gam", "beta", "theta", "zeta")}


def accumulate(acc, state: GibbsState):
    for name in acc:
        acc[name] += getattr(state, name)


def run_gibbs(data: Data, hyper: Hyper, cfg: Config, n_samples: int,
              n_burnin: int, seed: int = 0, thin: int = 1, draws=None):
    """Run the sampler; returns posterior-mean summaries as NumPy: pip
    (p, q), beta_mean (p, q), theta_mean (p,), zeta_mean (q,).  The draws
    come from a generator on the data's device seeded with `seed`, or from
    `draws` (mcmc/draws.py)."""
    gram_blocks, draws = chain_setup(data, cfg, seed, draws)
    state = init_state(data, cfg)
    for _ in range(n_burnin):
        state = gibbs_sweep(state, data, hyper, gram_blocks, draws, cfg=cfg)
    acc, kept = accumulators(state), 0
    for s in range(n_samples):
        state = gibbs_sweep(state, data, hyper, gram_blocks, draws, cfg=cfg)
        if s % thin == 0:
            accumulate(acc, state)
            kept += 1
    return summaries(acc, kept, data)
