"""CAVI driver: annealing schedule, adaptive ELBO thinning, convergence
control and the monotonicity guard (counterpart of the host loop of
atlasqtl_tpu/inference/driver.py; re-design of the iteration-control half
of R/atlasqtl_global_local_core.R:69-97, 125-132, 318-399).

One call of models/global_local.py:cavi_iteration per iteration; control
flow, logging and the guard run on the host.
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


def fit_global_local(data: Data, hyper: Hyper, state: VBState, cfg: Config,
                     anneal=None, verbose: int = 1) -> FitResult:
    """Run annealed CAVI to convergence."""
    gl.check_config(cfg)
    # the Gram blocks serve the complete-data formulas (impute mode too);
    # the exact-missing sweeps take their Grams from x_norm_sq and the mask
    gram_blocks = (block_gram(data.x, gl.data_block(cfg, data))
                   if data.x_norm_sq is None else None)

    eps = float(np.finfo(np.float64).eps) ** 0.5
    # arithmetic-precision allowance of the monotonicity guard and the
    # convergence noise floor, from the ELBO's dtype (float64)
    eps_rel = 64.0 * float(torch.finfo(cfg.elbo_dtype).eps)

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

    # ---------------------------------------------------- annealing phase
    if anneal is not None:
        ladder = annealing_ladder(anneal)
        it_init = int(anneal[2])
        if verbose:
            log.info("** Annealing with %s spacing **",
                     {1: "geometric", 2: "harmonic", 3: "linear"}[int(anneal[0])])
        for c in ladder[:-1]:  # the final rung c = 1 exits annealing mode
            it += 1
            c_s = c if cfg.anneal_scale else 1.0
            # annealing rungs never feed an ELBO evaluation: run lite (the
            # first converged-phase iteration is always full)
            state = gl.cavi_iteration(data, hyper, state, gram_blocks, c, c_s,
                                      cfg=cfg, annealed=True, lite=True)
            if verbose and (it == 1 or it % 5 == 0):
                log.info("Iteration %d (temperature %.4g)", it, 1.0 / c)
        if verbose:
            log.info("** Exiting annealing mode. **")
    else:
        it_init = 1

    # ------------------------------------------------- converged CAVI phase
    diff_lb_final = math.inf
    while not converged and it < cfg.maxit:
        lb_old = lb_new
        it += 1
        # gam/mu must be fresh only where this iteration's result feeds an
        # ELBO evaluation or the final output; the others run "lite"
        will_eval = (it <= it_init + 1 or it % batch_conv == 0
                     or it % batch_conv == 1)
        need_full = will_eval or it >= cfg.maxit
        state = gl.cavi_iteration(data, hyper, state, gram_blocks, 1.0, 1.0,
                                  cfg=cfg, annealed=False, lite=not need_full)

        if will_eval:
            lb_new = float(gl.compute_elbo(data, hyper, state, cfg=cfg))
            elbo_history.append((it, lb_new))
            if not math.isfinite(lb_new):
                # NaN compares False against everything: it would pass both
                # the guard and the convergence test below
                raise ElboDecreaseError(
                    f"ELBO became non-finite at iteration {it}: {lb_new} "
                    f"(previous {lb_old:.10g})")
            if verbose and (it == it_init or it % max(5, batch_conv) == 0):
                log.info("Iteration %d: ELBO = %.6f", it, lb_new)

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

    if verbose:
        if converged:
            log.info("Convergence obtained after %d iterations. ELBO = %.6f",
                     it, lb_new)
        else:
            log.warning("Maximal number of iterations reached before "
                        "convergence. Exit.")
    return FitResult(state=state, converged=converged, it=it, lb_opt=lb_new,
                     diff_lb=diff_lb_final, elbo_history=elbo_history)
