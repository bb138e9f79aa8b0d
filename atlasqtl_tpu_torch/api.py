"""Public API: `atlasqtl()` on PyTorch (counterpart of atlasqtl_tpu/api.py;
re-design of the reference entry point R/atlasqtl.R:179-322).

The same surface as the reference package.  This port runs the global-local
and the global-only fits on one device, on complete data or with NaN in Y
(missing="exact" or "impute"), with the host loop or the device loop
(device_loop); every other option keeps its place in the signature and
raises NotImplementedError naming its ROADMAP.md item.

On a CUDA device with no list_init (and not save_init, one replica,
model="global_local"), the initial state is drawn on the device
(models/global_local.py:auto_init_device) as the reference draws it on an
accelerator; elsewhere it is drawn on the host (elicitation.auto_set_init).
To compare a card fit with a CPU fit, give both the same host InitSpec
through list_init.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from .types import Config
from .io.prepare import prepare_data, add_collinear_back
from .inference import elicitation as elic
from .inference.driver import fit_global_local
from .inference.summarise import AtlasQTLResult
from .models import global_local as gl
from .ops.annealing import check_annealing

log = logging.getLogger("atlasqtl_tpu_torch")


def resolve_device(device) -> torch.device:
    """None means the GPU; a missing GPU is an error, never a silent CPU
    run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("atlasqtl_tpu_torch runs on a CUDA GPU and none "
                           "is available; pass device='cpu' to run on the "
                           "CPU")
    return dev


def atlasqtl(Y, X, p0=None, anneal=(1, 2, 10), tol: float = 0.1,
             maxit: int = 1000, user_seed=None, verbose: int = 1,
             list_hyper: Optional[elic.HyperSpec] = None,
             list_init: Optional[elic.InitSpec] = None,
             save_hyper: bool = False, save_init: bool = False,
             full_output: bool = False, thinned_elbo_eval: bool = True,
             checkpoint_path=None, trace_path=None,
             add_collinear_back_: bool = False,
             dtype=None, block_size: int = 128,
             batch: str = "y", mesh=None,
             model: str = "global_local", df: int = 1,
             anneal_replicas: int = 1,
             missing: str = "exact",
             device_loop: str = "auto", device=None) -> AtlasQTLResult:
    """Fit the global-local hotspot model (reference: atlasqtl,
    R/atlasqtl.R).  `dtype` is torch.float32 (default) or torch.float64;
    `device` is None (the GPU) or any torch device, e.g. "cpu".  NaN cells
    of Y are missing: missing="exact" fits the observed cells only (masked
    statistics), missing="impute" integrates them out under q(y_mis).
    model="global" fits the global-scale-only variant.  device_loop "auto"
    (the default) runs the fit loop on the device for a CUDA device and at
    most 2^25 padded cells, "on" and "off" force it (verbose=2 keeps the
    host loop)."""
    dev = resolve_device(device)
    not_ported = [
        (mesh is not None, "mesh (ROADMAP.md A12)"),
        (anneal_replicas != 1, "anneal_replicas > 1 (ROADMAP.md A8)"),
        (checkpoint_path is not None, "checkpoint_path (ROADMAP.md A8)"),
        (trace_path is not None, "trace_path (ROADMAP.md A8)"),
        (full_output, "full_output=True (ROADMAP.md A8)"),
    ]
    for bad, what in not_ported:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet")
    if verbose not in (0, 1, 2):
        raise ValueError("verbose must be 0, 1 or 2")
    if batch not in ("y", "0"):
        raise ValueError("Batch scheme not defined. Exit.")
    check_annealing(None if anneal is None else np.asarray(anneal, float))

    dat = prepare_data(Y, X, tol, maxit, user_seed, verbose)
    n, p = dat.x.shape
    q = dat.y.shape[1]
    shr_fac_inv = float(q)  # reference: R/atlasqtl.R:218

    if list_hyper is None or list_init is None:
        p0_arr = np.asarray(p0, dtype=float)
        if p0_arr.shape != (2,) or (p0_arr <= 0).any():
            raise ValueError("p0 must be a positive vector of length 2")
    elif p0 is not None:
        log.warning("Provided argument p0 not used, as both list_hyper and "
                    "list_init were provided.")

    if list_hyper is None:
        hyper_spec = elic.auto_set_hyper(dat.y, p, p0)
    else:
        expected_p = len(dat.bool_rmvd_x) if not list_hyper.auto else p
        if list_hyper.q != q:
            raise ValueError("list_hyper dimensions (q) inconsistent with Y")
        if list_hyper.p != expected_p:
            raise ValueError("list_hyper dimensions (p) inconsistent with X")
        hyper_spec = list_hyper

    init_spec = list_init
    if list_init is not None:
        expected_p = len(dat.bool_rmvd_x) if not list_init.auto else p
        if list_init.q != q:
            raise ValueError("list_init dimensions (q) inconsistent with Y")
        if list_init.p != expected_p:
            raise ValueError("list_init dimensions (p) inconsistent with X")
        if not list_init.auto and dat.bool_rmvd_x.any():
            keep = ~dat.bool_rmvd_x
            init_spec = dataclasses.replace(
                list_init, p=p,
                gam_vb=list_init.gam_vb[keep],
                mu_beta_vb=list_init.mu_beta_vb[keep],
                sig2_theta_vb=list_init.sig2_theta_vb[keep],
                theta_vb=list_init.theta_vb[keep])

    if dtype is None:
        dtype = torch.float32
    if dtype not in (torch.float32, torch.float64):
        raise ValueError("dtype must be torch.float32 or torch.float64")
    if df < 1 or df % 2 == 0:
        raise ValueError("df must be an odd natural number (1, 3, 5, ...)")
    if missing not in ("exact", "impute"):
        raise ValueError("missing must be 'exact' or 'impute'")
    cfg = Config(block_size=(1 if batch == "0" else block_size), dtype=dtype,
                 tol=float(tol), maxit=int(maxit), df=int(df),
                 shr_fac_inv=shr_fac_inv,
                 thinned_elbo_eval=thinned_elbo_eval, debug=True,
                 missing=missing, device_loop=device_loop)
    gl.check_config(cfg)

    data = gl.build_data(dat.x, dat.y, cfg, dev)
    hyper = gl.build_hyper(hyper_spec, data.y.shape[1], cfg, dev)
    # the reference's rule (atlasqtl_tpu/api.py:151-163): draw on the
    # device when nothing needs the host InitSpec
    use_dev_init = (list_init is None and not save_init and mesh is None
                    and model == "global_local" and anneal_replicas == 1
                    and dev.type == "cuda")
    if use_dev_init:
        # an unseeded fit draws a fresh init each run, as the host path does
        dev_seed = (int(np.random.SeedSequence().generate_state(1)[0])
                    if user_seed is None else int(user_seed))
        state = gl.auto_init_device(dev_seed, data,
                                    tuple(np.asarray(p0, float)),
                                    shr_fac_inv, cfg)
    else:
        if init_spec is None:
            init_spec = elic.auto_set_init(dat.y, p, p0, shr_fac_inv,
                                           user_seed)
        state = gl.build_state(init_spec, data, cfg)

    res = fit_global_local(data, hyper, state, cfg, anneal=anneal,
                           verbose=verbose, model=model)
    st = res.state
    host = lambda t: t.detach().to(torch.float64).cpu().numpy()
    gam_vb = host(st.gam)[:p, :q]
    beta_vb = host(st.gam * st.mu_beta)[:p, :q]
    theta_vb = host(st.theta)[:p]
    names_x = dat.names_x
    if add_collinear_back_ and len(dat.rmvd_coll_x) > 0:
        beta_vb, gam_vb, theta_vb, names_x = add_collinear_back(
            beta_vb, gam_vb, theta_vb, dat.initial_colnames_x,
            dat.rmvd_coll_x, dat.names_x)

    return AtlasQTLResult(
        beta_vb=beta_vb, gam_vb=gam_vb, theta_vb=theta_vb,
        zeta_vb=host(st.zeta)[:q],
        converged=res.converged, it=res.it, lb_opt=res.lb_opt,
        diff_lb=res.diff_lb, n=n, p=p, q=q,
        p0=None if p0 is None else tuple(np.asarray(p0, float)),
        anneal=None if anneal is None else tuple(np.asarray(anneal, float)),
        tol=float(tol), maxit=int(maxit),
        rmvd_cst_x=dat.rmvd_cst_x, rmvd_coll_x=dat.rmvd_coll_x,
        names_x=names_x, names_y=dat.names_y,
        elbo_history=res.elbo_history,
        lam2_inv_vb=host(st.lam2_inv)[:p],
        x_beta_vb=host(st.fitted)[:n, :q],
        sig02_inv_vb=float(st.sig02_inv),
        list_hyper=hyper_spec if save_hyper else None,
        list_init=init_spec if save_init else None)
