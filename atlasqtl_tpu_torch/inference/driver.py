"""CAVI driver: annealing schedule, adaptive ELBO thinning, convergence
control and the monotonicity guard, with annealing replicas and the
checkpoint and trace hooks (counterpart of the host loop of
atlasqtl_tpu/inference/driver.py; re-design of the iteration-control half
of R/atlasqtl_global_local_core.R:69-97, 125-132, 318-399).

Two loops with one semantics: the host loop here (one call of the model's
cavi_iteration per iteration; control flow, logging and the guard on the
host) and the device loop of inference/device_loop.py, chosen by its
`eligible` as the reference chooses (atlasqtl_tpu/inference/driver.py:
150-259).
"""
from __future__ import annotations

import dataclasses
import logging
import math

import numpy as np
import torch

from ..types import Config, Data, Hyper, VBState
from ..models import global_local as gl
from ..ops.annealing import annealing_ladder
from ..ops.special import as_scalar
from ..ops.sweep import block_gram

log = logging.getLogger("atlasqtl_tpu_torch")


@dataclasses.dataclass
class FitResult:
    state: VBState
    converged: bool
    it: int
    lb_opt: float
    diff_lb: float
    elbo_history: list


class ElboDecreaseError(RuntimeError):
    """Raised in debug mode when the ELBO decreases beyond tolerance or
    becomes non-finite (R/atlasqtl_global_local_core.R:359-360)."""


def _log_hotspot_scales(data: Data, state: VBState, cfg: Config,
                        eps: float):
    """verbose=2's per-evaluation hotspot-scale diagnostics, the global
    scale and the quantiles of the local scales (reference:
    R/atlasqtl_global_local_core.R:297-305), from one host copy of
    nu_s0, rho_s0, p and lam2_inv."""
    host = torch.cat([state.nu_s0_vb.reshape(1), state.rho_s0_vb.reshape(1),
                      data.p_true.reshape(1).to(state.lam2_inv.dtype),
                      state.lam2_inv]).double().cpu().numpy()
    nu_s0, rho_s0, p_t = host[0], host[1], int(host[2])
    glob = math.sqrt(rho_s0 / max(nu_s0 - 1.0, eps) / cfg.shr_fac_inv)
    lam = np.sqrt(1.0 / host[3:3 + p_t])
    qs = np.percentile(lam, [0, 25, 50, 75, 100])
    log.info("Variational hotspot propensity global scale: %.3g", glob)
    log.info("Approximate variational hotspot propensity local scale: "
             "min=%.3g 1stQ=%.3g med=%.3g mean=%.3g 3rdQ=%.3g max=%.3g",
             qs[0], qs[1], qs[2], float(lam.mean()), qs[3], qs[4])


def _anneal_replicas_batched(mod, data: Data, hyper: Hyper, replica_states,
                             gram_blocks, ladder, cfg: Config, verbose,
                             block=None):
    """Annealing replicas (counterpart of
    atlasqtl_tpu/inference/driver.py:_anneal_replicas_batched): the m
    initial states are annealed side by side, every rung of the ladder one
    batched iteration of all of them (`cavi_iteration_replicas`: on the B1
    and B2 routes one kernel launch sweeps all m; a model without it steps
    the replicas in turn), the last rung full because the selection reads
    its gam/mu.  The replica with the largest float64 ELBO after the ladder
    is returned with the rung count.  The rungs run eagerly under host
    control, as the JAX package's do."""
    m = len(replica_states)
    dev = data.x.device
    block = gl.data_block(cfg, data) if block is None else block
    one = as_scalar(1.0, cfg.dtype, dev)
    cs = torch.as_tensor(np.asarray(ladder[:-1], np.float64), dtype=cfg.dtype,
                         device=dev)
    rung = getattr(mod, "cavi_iteration_replicas", None)
    if rung is None:
        rung = lambda dat, hyp, sts, gram, c, c_s, **kw: [
            mod.cavi_iteration(dat, hyp, st, gram, c, c_s, **kw)
            for st in sts]
    states = list(replica_states)
    n_rungs = len(ladder) - 1
    for k, c in enumerate(ladder[:-1]):  # c = 1 exits annealing
        c_s = cs[k] if cfg.anneal_scale else one
        states = rung(data, hyper, states, gram_blocks, cs[k], c_s, cfg=cfg,
                      annealed=True, lite=k + 1 < n_rungs, block=block)
        if verbose and (k == 0 or (k + 1) % 5 == 0):
            log.info("Iteration %d (temperature %.4g, %d replicas)", k + 1,
                     1.0 / c, m)
    elbos = torch.stack([
        mod.compute_elbo(data, hyper, st, cfg=cfg).to(cfg.elbo_dtype)
        for st in states]).double().cpu().numpy()
    best = int(np.argmax(elbos))
    if verbose:
        for r, lb in enumerate(elbos):
            log.info("Annealing replica %d: ELBO = %.6f", r, lb)
    return states[best], n_rungs


def fit_global_local(data: Data, hyper: Hyper, state: VBState, cfg: Config,
                     anneal=None, verbose: int = 1,
                     checkpointer=None, tracer=None,
                     model: str = "global_local",
                     replica_states=None) -> FitResult:
    """Run annealed CAVI to convergence.

    checkpointer: optional callable(it, state, converged, lb_new, lb_old),
           called after each converged-phase iteration (io/checkpoint.py)
    tracer: optional callable(it, state), called at iteration 1 and every
           25th, annealing rungs included (io/trace.py)
    model: "global_local" (horseshoe, the product path) or "global" (the
           global-scale-only variant, R/atlasqtl_global_core.R)
    replica_states: optional list of initial states, each annealed (side by
           side, `_anneal_replicas_batched`); the replica with the best
           ELBO after the ladder goes on to convergence.

    The loop is the host loop below or, where device_loop.eligible says so
    (no host hook; cfg.device_loop "on", or "auto" on a CUDA device at
    <= 2^25 cells), the device loop of inference/device_loop.py, with the
    same semantics."""
    if model == "global_local":
        mod = gl
    elif model == "global":
        from ..models import global_only as mod
    else:
        raise ValueError(f"unknown model {model!r}")
    gl.check_config(cfg)
    dev = data.x.device
    # the predictor block, read from the device once per fit
    block = gl.data_block(cfg, data)
    # the Gram blocks serve the complete-data formulas (impute mode too);
    # the exact-missing sweeps take their Grams from x_norm_sq and the mask
    gram_blocks = (block_gram(data.x, block)
                   if data.x_norm_sq is None else None)

    eps = float(np.finfo(np.float64).eps) ** 0.5
    # arithmetic-precision allowance of the monotonicity guard and the
    # convergence noise floor, from the ELBO's dtype (float64)
    eps_rel = 64.0 * float(torch.finfo(cfg.elbo_dtype).eps)

    from . import device_loop as dl
    use_dev = dl.eligible(cfg, verbose, data, checkpointer, tracer)

    if cfg.thinned_elbo_eval:
        times_sched = np.array([1.0, 5.0, 10.0, 50.0])
        batch_sched = np.array([1, 10, 25, 50])
    else:
        times_sched = np.array([1.0])
        batch_sched = np.array([1])
    ind_batch_conv = len(batch_sched) + 1
    batch_conv = 1

    it = 0
    lb_new = -math.inf
    converged = False
    elbo_history = []
    # the temperatures reach every step as device tensors: the ladder is
    # copied to the device once, c = 1 is a cached device constant
    one = as_scalar(1.0, cfg.dtype, dev)
    ladder = annealing_ladder(anneal) if anneal is not None else None
    # with replicas the loop starts from the selected replica, after the
    # ladder
    loop = (dl.DeviceLoop(mod, data, hyper, state, gram_blocks, cfg, block,
                          ladder=ladder)
            if use_dev and replica_states is None else None)

    # ---------------------------------------------------- annealing phase
    if anneal is not None:
        it_init = int(anneal[2])
        if verbose:
            log.info("** Annealing with %s spacing **",
                     {1: "geometric", 2: "harmonic", 3: "linear"}[int(anneal[0])])
        if replica_states is not None:
            state, it = _anneal_replicas_batched(
                mod, data, hyper, replica_states, gram_blocks, ladder, cfg,
                verbose, block)
        elif use_dev:
            loop.anneal(len(ladder) - 1)
            it = len(ladder) - 1
            if verbose:
                log.info("Annealing ladder: %d rungs in the device loop", it)
        else:
            cs = torch.as_tensor(np.asarray(ladder[:-1], np.float64),
                                 dtype=cfg.dtype, device=dev)
            for k, c in enumerate(ladder[:-1]):  # c = 1 exits annealing
                it += 1
                c_s = cs[k] if cfg.anneal_scale else one
                # annealing rungs never feed an ELBO evaluation: run lite
                # (the first converged-phase iteration is always full)
                state = mod.cavi_iteration(data, hyper, state, gram_blocks,
                                           cs[k], c_s, cfg=cfg,
                                           annealed=True, lite=True,
                                           block=block)
                if verbose and (it == 1 or it % 5 == 0):
                    log.info("Iteration %d (temperature %.4g)", it, 1.0 / c)
                if tracer is not None and (it == 1 or it % 25 == 0):
                    tracer(it, state)
        if verbose:
            log.info("** Exiting annealing mode. **")
    else:
        it_init = 1

    # ------------------------------------------------- converged CAVI phase
    if use_dev:
        if loop is None:
            loop = dl.DeviceLoop(mod, data, hyper, state, gram_blocks, cfg,
                                 block)
        (state, it, lb_new, converged, diff_lb, nev, elbo_history,
         mono) = loop.converged(it, it_init, cfg.maxit)
        if nev > loop.buf:
            log.warning(
                "ELBO trace truncated: %d evaluations exceed the "
                "device-loop buffer (%d); convergence/guard logic ran on "
                "device and is unaffected, but elbo_history drops the "
                "overflow (last slot holds the final evaluation).",
                nev, loop.buf)
        if verbose:
            for it_e, lb_e in elbo_history:
                log.info("Iteration %d: ELBO = %.6f", it_e, lb_e)
        _raise_from_trace(elbo_history, it, lb_new, nev, mono, cfg, eps,
                          eps_rel)
        return _finish(state, converged, it, lb_new, diff_lb, elbo_history,
                       verbose)

    diff_lb_final = math.inf
    ckpt_rate = getattr(checkpointer, "rate", 1) if checkpointer else 0
    while not converged and it < cfg.maxit:
        lb_old = lb_new
        it += 1
        # gam/mu must be fresh only where this iteration's result feeds an
        # ELBO evaluation, a checkpoint or the final output; the others run
        # "lite"
        will_eval = (it <= it_init + 1 or it % batch_conv == 0
                     or it % batch_conv == 1)
        need_full = (will_eval or it >= cfg.maxit
                     or (ckpt_rate and it % ckpt_rate == 0))
        state = mod.cavi_iteration(data, hyper, state, gram_blocks, one, one,
                                   cfg=cfg, annealed=False,
                                   lite=not need_full, block=block)
        if tracer is not None and (it == 1 or it % 25 == 0):
            tracer(it, state)

        if will_eval:
            lb_new = float(mod.compute_elbo(data, hyper, state, cfg=cfg))
            elbo_history.append((it, lb_new))
            if not math.isfinite(lb_new):
                # NaN compares False against everything: it would pass both
                # the guard and the convergence test below
                raise ElboDecreaseError(
                    f"ELBO became non-finite at iteration {it}: {lb_new} "
                    f"(previous {lb_old:.10g})")
            if verbose and (it == it_init or it % max(5, batch_conv) == 0):
                log.info("Iteration %d: ELBO = %.6f", it, lb_new)
            if verbose == 2 and (it == it_init
                                 or it % max(5, batch_conv) == 0):
                _log_hotspot_scales(data, state, cfg, eps)

            if (cfg.debug and lb_old != -math.inf
                    and lb_new + eps + eps_rel * abs(lb_old) < lb_old):
                raise ElboDecreaseError(
                    f"ELBO not increasing monotonically at iteration {it}: "
                    f"{lb_old:.10g} -> {lb_new:.10g}")

            diff_lb = abs(lb_new - lb_old)
            diff_lb_final = diff_lb
            sum_exceed = int(np.sum(diff_lb > times_sched * cfg.tol))
            if sum_exceed == 0 or diff_lb <= eps_rel * abs(lb_new):
                converged = True
            elif ind_batch_conv > sum_exceed:
                ind_batch_conv = sum_exceed
                batch_conv = int(batch_sched[ind_batch_conv - 1])

        if checkpointer is not None:
            checkpointer(it, state, converged, lb_new, lb_old)

    return _finish(state, converged, it, lb_new, diff_lb_final, elbo_history,
                   verbose)


def _finish(state, converged, it, lb_new, diff_lb, elbo_history, verbose):
    if verbose:
        if converged:
            log.info("Convergence obtained after %d iterations. ELBO = %.6f",
                     it, lb_new)
        else:
            log.warning("Maximal number of iterations reached before "
                        "convergence. Exit.")
    return FitResult(state=state, converged=converged, it=it, lb_opt=lb_new,
                     diff_lb=diff_lb, elbo_history=elbo_history)


def _raise_from_trace(history, it, lb_new, nev, mono, cfg, eps, eps_rel):
    """The device loop's guard, raised after the loop from the recorded
    trace as atlasqtl_tpu/inference/driver.py raises it: a non-finite ELBO
    always (no evaluation at all leaves the -inf sentinel, which is not a
    failure), a decrease in debug mode, each with its first offending
    evaluation."""
    its = [i for i, _ in history]
    lbs = [lb for _, lb in history]
    if nev > 0 and not math.isfinite(lb_new):
        it_bad, lb_bad = it, lb_new
        for k, lb in enumerate(lbs):
            if not math.isfinite(lb):
                it_bad, lb_bad = its[k], lb
                break
        raise ElboDecreaseError(
            f"ELBO became non-finite at iteration {it_bad}: {lb_bad}")
    if cfg.debug and mono:
        for k, lb in enumerate(lbs):
            if not math.isfinite(lb):
                raise ElboDecreaseError(
                    f"ELBO became non-finite at iteration {its[k]}: {lb}")
        lo, hi, it_bad = math.nan, math.nan, it
        for k in range(1, len(lbs)):
            if lbs[k] + eps + eps_rel * abs(lbs[k - 1]) < lbs[k - 1]:
                lo, hi, it_bad = lbs[k - 1], lbs[k], its[k]
                break
        raise ElboDecreaseError(
            f"ELBO not increasing monotonically at iteration {it_bad}: "
            f"{lo:.10g} -> {hi:.10g}")
