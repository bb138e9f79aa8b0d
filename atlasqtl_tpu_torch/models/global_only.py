"""Global-scale-only CAVI variant in PyTorch (counterpart of
atlasqtl_tpu/models/global_only.py; re-design of atlasqtl_global_core_,
R/atlasqtl_global_core.R:8-421): no local horseshoe scales, a conjugate
inverse-gamma update of the hotspot-propensity global scale, a Cauchy
prior through nu_s0 = rho_s0 = 1/2.  Selected with
atlasqtl(..., model="global").

The update order differs from the global-local model: theta and zeta are
refreshed before the global scale (R/atlasqtl_global_core.R:229-244), and
sig2_theta uses the previous iteration's sig02_inv.  The sweeps are the
plain engines (ops/sweep.py), as in the reference: no kernel.  On a mesh
(Data.mesh) the sums over q and p cross the shards as in the global-local
model, and a 2-D mesh pipelines the plain engines over the p-stages
(parallel/pipeline.py).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..types import Config, Data, Hyper, VBState
from ..ops import elbo as elbo_ops
from ..ops import updates as upd
from ..ops.special import as_scalar
from ..ops.sweep import SweepConsts, sweep_complete, sweep_missing
from ..parallel.mesh import has_p, p_sum, q_sum
from ..parallel.pipeline import pipelined_sweep_2d, pipelined_sweep_missing_2d
from .global_local import (_colsum_stats, _p_total, _q_total, _xns_sums,
                           data_block, divisor_block)

NU_S0 = 0.5   # Cauchy prior for theta (R/atlasqtl_global_core.R:90)
RHO_S0 = 0.5


def cavi_iteration(data: Data, hyper: Hyper, state: VBState, gram_blocks, c,
                   c_s, *, cfg: Config, annealed: bool, lite: bool = False,
                   block: int | None = None) -> VBState:
    """One CAVI iteration of the global-only model
    (R/atlasqtl_global_core.R:117-271; atlasqtl_tpu/models/global_only.py:
    _iteration_impl).  annealed, lite and block are accepted for the
    drivers and not needed: no special-function branch, the plain engines
    always emit fresh gam/mu and take the block from the Gram blocks (a
    2-D mesh's exact-missing pipeline reads `block`)."""
    del annealed, lite
    dt = cfg.dtype
    dev = data.x.device
    c, c_s = as_scalar(c, dt, dev), as_scalar(c_s, dt, dev)
    shr = as_scalar(cfg.shr_fac_inv, dt, dev)

    (gam_colsum, m2b_colsum, beta2_colsum, yf_colsum, ff_colsum, m2b,
     beta) = _colsum_stats(data, state)

    # impute: fold the q(y_mis) moments into the complete-data statistics,
    # as the global-local model does
    exact = data.x_norm_sq is not None
    cp_x_y, y_norm_sq = data.cp_x_y, data.y_norm_sq
    if data.mis_pat is not None and not exact:
        v_mis = 1.0 / (c * state.tau)
        y_eff = data.y + (1.0 - data.mis_pat) * state.fitted
        cp_x_y = data.x.T @ y_eff
        y_norm_sq = (torch.einsum("nq,nq->q", y_eff, y_eff)
                     + data.n_mis * v_mis)
        yf_colsum = torch.einsum("nq,nq->q", y_eff, state.fitted)

    mesh = data.mesh
    q_total, p_total = _q_total(mesh), _p_total(mesh)
    sum_gam = q_total(gam_colsum * data.q_mask)
    nu_vb = upd.nu_update(hyper.nu, sum_gam, c)
    rho_vb = upd.rho_update(hyper.rho, m2b_colsum, state.tau, data.q_mask, c,
                            total=q_total)
    sig2_inv = nu_vb / rho_vb

    eta_vb = upd.eta_update(data.n_eff, hyper.eta, gam_colsum, c)
    xns_m2b = xns_b2 = None
    if exact:
        xns_m2b, xns_b2 = _xns_sums(data, m2b, beta)
    kappa_vb = upd.kappa_update(data.n, y_norm_sq, yf_colsum, ff_colsum,
                                hyper.kappa, m2b_colsum, beta2_colsum,
                                sig2_inv, c, x_norm_sq_m2b=xns_m2b,
                                x_norm_sq_beta2=xns_b2)
    tau = eta_vb / kappa_vb
    sig2_beta = upd.sig2_beta_update(data.n, sig2_inv, tau, data.x_norm_sq, c)
    log_tau = upd.log_gamma_mean(eta_vb, kappa_vb)
    log_sig2_inv = upd.log_gamma_mean(nu_vb, rho_vb)

    consts = SweepConsts(sig2_beta=sig2_beta, tau=tau, log_tau=log_tau,
                         log_sig2_inv=log_sig2_inv, theta=state.theta,
                         zeta=state.zeta, c=c)
    msk = data.p_mask[:, None] * data.q_mask[None, :]
    beta_new = colstats = None
    if has_p(mesh):
        if not exact:
            (beta_new, gam_new, mu_new, fitted, z_row, z_col,
             colstats) = pipelined_sweep_2d(
                data, state, None, gram_blocks, cp_x_y, consts,
                gram_blocks.shape[1], cfg, False)
        else:
            gam_new, mu_new, fitted, z_row, z_col = \
                pipelined_sweep_missing_2d(
                    data, state, consts, None,
                    data_block(cfg, data) if block is None else block, cfg,
                    "scan")
    elif not exact:  # complete data or impute
        gam_new, mu_new, fitted, z_row, z_col = sweep_complete(
            data.x, cp_x_y, gram_blocks, state.gam, state.mu_beta,
            state.fitted, consts, gram_blocks.shape[1], p_mask=data.p_mask,
            q_mask=data.q_mask)
        gam_new, mu_new = gam_new * msk, mu_new * msk
        # the same carried column statistics as the global-local model, so
        # the state's fields are the same from iteration to iteration
        beta_new = gam_new * mu_new
        colstats = (torch.sum(gam_new, dim=0),
                    torch.einsum("pq,pq->q", mu_new * mu_new, gam_new),
                    torch.einsum("pq,pq->q", beta_new, beta_new))
    else:
        gam_new, mu_new, fitted = sweep_missing(
            data.x, data.cp_x_y, data.x_norm_sq, data.mis_pat, state.gam,
            state.mu_beta, state.fitted, consts)
        gam_new, mu_new = gam_new * msk, mu_new * msk
        z_row, z_col = upd.z_moments(gam_new, state.theta, state.zeta,
                                     data.p_mask, data.q_mask, c,
                                     block_size=cfg.block_size)
    if not has_p(mesh):
        z_row = q_sum(mesh, z_row)   # on a 1-D mesh, over the q-shards

    # theta/zeta with the previous global scale
    # (R/atlasqtl_global_core.R:229-235): sig2_theta is one value for all
    # predictors in the reference, broadcast to (p,) so the state's layout
    # is the global-local model's
    sig2_theta = upd.sig2_c0_update(
        data.q_true, 1.0 / (state.sig02_inv * shr), c).expand(
            data.p_mask.shape)
    zeta_sum = q_total(state.zeta * data.q_mask)
    theta = upd.theta_update(z_row, hyper.m0, state.sig02_inv * shr,
                             sig2_theta, zeta_sum, c) * data.p_mask
    sig2_zeta = upd.sig2_c0_update(data.p_true, hyper.t02, c)
    zeta = upd.zeta_update(z_col, p_total(theta), hyper.n0, sig2_zeta,
                           1.0 / hyper.t02, c) * data.q_mask

    # conjugate global-scale update (R/atlasqtl_global_core.R:241-244)
    nu_s0_vb = c_s * (NU_S0 + 0.5 * data.p_true) - c_s + 1.0
    rho_s0_vb = c_s * (RHO_S0 + 0.5 * p_total(
        (sig2_theta + theta * theta) * data.p_mask))
    sig02_inv = nu_s0_vb / rho_s0_vb

    return VBState(
        gam=gam_new, mu_beta=mu_new, sig2_beta=sig2_beta, tau=tau,
        sig2_inv=sig2_inv, theta=theta, zeta=zeta, sig02_inv=sig02_inv,
        lam2_inv=state.lam2_inv, sig2_theta=sig2_theta.contiguous(),
        fitted=fitted, l_vb=state.l_vb, rho_xi_inv=state.rho_xi_inv,
        nu_s0_vb=nu_s0_vb, rho_s0_vb=rho_s0_vb, beta=beta_new,
        gam_colsum=None if colstats is None else colstats[0],
        mu2gam_colsum=None if colstats is None else colstats[1],
        beta2_colsum=None if colstats is None else colstats[2])


def compute_elbo(data: Data, hyper: Hyper, state: VBState, *,
                 cfg: Config) -> torch.Tensor:
    """7-term ELBO of the global-only model (elbo_global_,
    R/atlasqtl_global_core.R:372-421; atlasqtl_tpu/models/global_only.py:
    compute_elbo), in cfg.elbo_dtype (float64) from a cast of the whole
    state, its column sums re-accumulated in that dtype."""
    dt = cfg.elbo_dtype
    dev = data.x.device
    f = lambda a: None if a is None else a.to(dt)
    shr = as_scalar(cfg.shr_fac_inv, dt, dev)
    st = VBState(**{k.name: f(getattr(state, k.name))
                    for k in dataclasses.fields(state)})
    # the data fields the terms read (x and the cross-products are not)
    dat = dataclasses.replace(data, **{k: f(getattr(data, k)) for k in (
        "y", "y_norm_sq", "mis_pat", "x_norm_sq", "n_eff", "n_mis", "p_mask",
        "q_mask", "n", "p_true", "q_true")})
    hy = Hyper(**{k.name: f(getattr(hyper, k.name))
                  for k in dataclasses.fields(hyper)})

    (gam_colsum, m2b_colsum, beta2_colsum, yf_colsum, ff_colsum, m2b,
     beta) = _colsum_stats(dat, st, use_cached=False)
    mesh = data.mesh
    q_total, p_total = _q_total(mesh), _p_total(mesh)
    sum_gam = q_total(gam_colsum * dat.q_mask)

    # impute: re-derived q(y_mis) moments and the imputation factor's
    # entropy (as models/global_local.py:compute_elbo)
    exact = data.x_norm_sq is not None
    y_norm_sq = dat.y_norm_sq
    entropy_y_mis = torch.zeros((), dtype=dt, device=dev)
    if data.mis_pat is not None and not exact:
        v_mis = 1.0 / st.tau
        y_eff = dat.y + (1.0 - dat.mis_pat) * st.fitted
        y_norm_sq = torch.einsum("nq,nq->q", y_eff, y_eff) + dat.n_mis * v_mis
        yf_colsum = torch.einsum("nq,nq->q", y_eff, st.fitted)
        entropy_y_mis = 0.5 * q_total(
            dat.n_mis * (torch.log(2.0 * math.pi * v_mis) + 1.0)
            * dat.q_mask)

    eta_vb = upd.eta_update(dat.n_eff, hy.eta, gam_colsum)
    xns_m2b = xns_b2 = None
    if exact:
        xns_m2b, xns_b2 = _xns_sums(dat, m2b, beta)
    kappa_vb = upd.kappa_update(dat.n, y_norm_sq, yf_colsum, ff_colsum,
                                hy.kappa, m2b_colsum, beta2_colsum,
                                st.sig2_inv, x_norm_sq_m2b=xns_m2b,
                                x_norm_sq_beta2=xns_b2)
    nu_vb = upd.nu_update(hy.nu, sum_gam)
    rho_vb = upd.rho_update(hy.rho, m2b_colsum, st.tau, dat.q_mask,
                            total=q_total)
    log_tau = upd.log_gamma_mean(eta_vb, kappa_vb)
    log_sig2_inv = upd.log_gamma_mean(nu_vb, rho_vb)
    log_sig02_inv = upd.log_gamma_mean(st.nu_s0_vb, st.rho_s0_vb)

    t02_inv = 1.0 / hy.t02
    sig2_zeta = 1.0 / (dat.p_true + t02_inv)
    vsld_zeta = -dat.q_true * (torch.log(hy.t02)
                               + torch.log(dat.p_true + t02_inv))
    # E log det of the theta prior and posterior covariances
    vsld_theta = (dat.p_true * (log_sig02_inv + torch.log(shr))
                  + p_total(torch.log(st.sig2_theta) * dat.p_mask))

    term_a = q_sum(mesh, elbo_ops.e_y(dat.n_eff, hy.kappa, kappa_vb, log_tau,
                                      m2b_colsum, st.sig2_inv, st.tau,
                                      dat.q_mask))

    p_pad, q_pad = state.gam.shape
    block = divisor_block(cfg.block_size, p_pad)
    term_b = torch.zeros((), dtype=dt, device=dev)
    for b in range(p_pad // block):
        sl = slice(b * block, (b + 1) * block)
        s2_b = (st.sig2_beta[sl] if st.sig2_beta.dim() == 2
                else st.sig2_beta[None, :].expand(block, q_pad))
        term_b = term_b + elbo_ops.e_beta_gamma_blocked(
            st.gam[sl], st.mu_beta[sl], st.theta[sl], st.zeta, log_tau,
            st.tau, s2_b, log_sig2_inv, st.sig2_inv, sig2_zeta,
            st.sig2_theta[sl], dat.p_mask[sl], dat.q_mask)
    term_b = q_sum(mesh, p_sum(mesh, term_b))

    term_c = elbo_ops.e_theta_global(st.theta, st.sig02_inv * shr,
                                     st.sig2_theta, vsld_theta, dat.p_mask,
                                     dat.p_true, total=p_total)
    term_d = elbo_ops.e_zeta(st.zeta, hy.n0, sig2_zeta, t02_inv, vsld_zeta,
                             dat.q_true, dat.q_mask, total=q_total)
    term_e = q_sum(mesh, elbo_ops.e_tau(hy.eta, eta_vb, hy.kappa, kappa_vb,
                                        log_tau, st.tau, dat.q_mask))
    term_f = elbo_ops.e_sig2_inv(hy.nu, nu_vb, log_sig2_inv, hy.rho, rho_vb,
                                 st.sig2_inv)
    term_g = elbo_ops.e_sig2_inv(as_scalar(NU_S0, dt, dev), st.nu_s0_vb,
                                 log_sig02_inv, as_scalar(RHO_S0, dt, dev),
                                 st.rho_s0_vb, st.sig02_inv)
    return (term_a + term_b + term_c + term_d + term_e + term_f + term_g
            + entropy_y_mis)
