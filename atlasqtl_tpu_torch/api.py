"""Public API: `atlasqtl()` on PyTorch (counterpart of atlasqtl_tpu/api.py;
re-design of the reference entry point R/atlasqtl.R:179-322).

The same surface as the reference package.  This port runs the global-local
and the global-only fits, on complete data or with NaN in Y
(missing="exact" or "impute"), with the host loop or the device loop
(device_loop), with annealing replicas, checkpoints, hotspot traces and
the full output, on one device or on a mesh of processes
(parallel/mesh.py: one process per device over torch.distributed, q- or
p x q-sharded; every rank calls atlasqtl with the same inputs and gets the
full result).

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
import torch.distributed as dist

from .types import Config
from .io.prepare import prepare_data, add_collinear_back
from .inference import elicitation as elic
from .inference.driver import fit_global_local
from .inference.full_output import assemble_full_output
from .inference.summarise import AtlasQTLResult
from .models import global_local as gl
from .ops.annealing import check_annealing
from .parallel import mesh as pmesh

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
    host loop).

    mesh (parallel/mesh.py:make_mesh, after initialize_distributed): every
    rank of the mesh calls atlasqtl with the same inputs; the fit runs on
    the mesh's device (`device` None, or the same), q is padded to
    q_pad_multiple(mesh) (on a CUDA device to 32 per q-shard, whole
    32-column slices of B1 and B2) and p to whole blocks per p-shard; the
    initial state is drawn on the host (an unseeded fit takes the mesh's
    first rank's seed), checkpoints and traces are written by that rank,
    and every rank returns the full result."""
    if mesh is not None:
        if not isinstance(mesh, pmesh.Mesh):
            raise TypeError("atlasqtl: mesh must be a Mesh of "
                            "atlasqtl_tpu_torch.parallel.mesh.make_mesh "
                            "(ROADMAP.md A12), not a JAX mesh")
        if not mesh.member:
            raise ValueError(f"atlasqtl: this rank is not in {mesh}")
        req = torch.device(mesh.device if device is None else device)
        if req.type != mesh.device.type or req.index not in (
                None, mesh.device.index):
            raise ValueError(f"atlasqtl: device {device} is not the mesh's "
                             f"{mesh.device}")
        device = mesh.device
    dev = resolve_device(device)
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
    two_d = pmesh.has_p(mesh)
    cfg = Config(block_size=(1 if batch == "0" else block_size), dtype=dtype,
                 tol=float(tol), maxit=int(maxit), df=int(df),
                 shr_fac_inv=shr_fac_inv,
                 thinned_elbo_eval=thinned_elbo_eval, debug=True,
                 missing=missing, device_loop=device_loop,
                 q_axis=None if mesh is None else pmesh.Q_AXIS,
                 p_axis=pmesh.P_AXIS if two_d else None)
    gl.check_config(cfg)

    q_pad_to, p_shards, q_shards = 8, 1, 1
    if mesh is not None:
        # every rank draws the same init: an unseeded fit takes the first
        # rank's seed
        if user_seed is None:
            user_seed = pmesh.broadcast_int(mesh, int(
                np.random.SeedSequence().generate_state(1)[0] & 0x7FFFFFFF))
        q_pad_to = pmesh.q_pad_multiple(mesh)
        if dev.type == "cuda":
            q_pad_to = max(q_pad_to, 32 * mesh.n_q)
        p_shards, q_shards = mesh.n_p, mesh.n_q
    data = gl.build_data(dat.x, dat.y, cfg, dev, q_pad_to=q_pad_to,
                         p_shards=p_shards, q_shards=q_shards)
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

    checkpointer = tracer = None
    if checkpoint_path is not None:
        from .io.checkpoint import Checkpointer
        checkpointer = Checkpointer(checkpoint_path, dat.names_x, dat.names_y,
                                    p, q)
    if trace_path is not None:
        from .io.trace import HotspotTrace
        tracer = HotspotTrace(trace_path, shr_fac_inv, p)
    if model == "global" and trace_path is not None:
        log.warning("Provided argument trace_path not used with the "
                    "global-scale-only model.")
        tracer = None
    replica_states = None
    if anneal_replicas > 1:
        if anneal is None:
            raise ValueError("anneal_replicas requires an annealing schedule")
        seeds = [user_seed + 1 + r if user_seed is not None else r + 1
                 for r in range(anneal_replicas - 1)]
        replica_states = [state] + [gl.build_state(
            elic.auto_set_init(dat.y, p, p0, shr_fac_inv, s_), data, cfg)
            for s_ in seeds]
    full_data, full_hyper = data, hyper
    if mesh is not None:
        data = pmesh.shard_data(data, mesh)
        hyper = pmesh.shard_hyper(hyper, mesh)
        state = pmesh.shard_state(state, mesh)
        if replica_states is not None:
            replica_states = [pmesh.shard_state(s_, mesh)
                              for s_ in replica_states]
        # the host writers run on the first rank only
        if checkpointer is not None:
            checkpointer = _FirstRankHook(checkpointer, mesh)
        if tracer is not None:
            tracer = _FirstRankHook(tracer, mesh)
    res = fit_global_local(data, hyper, state, cfg, anneal=anneal,
                           verbose=verbose, checkpointer=checkpointer,
                           tracer=tracer, model=model,
                           replica_states=replica_states)
    if checkpointer is not None and res.converged:
        # the reference cleans up unconditionally (R/utils.R:614-627); the
        # last snapshots stay after a fit that did not converge, to resume
        checkpointer.clean_up()
    # every rank returns the full matrices
    st = pmesh.to_host(res.state, mesh)
    data, hyper = full_data, full_hyper
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
        list_init=init_spec if save_init else None,
        full_state=st if full_output else None,
        full_output=(assemble_full_output(data, hyper, st, cfg, model=model)
                     if full_output else None))


class _FirstRankHook:
    """A host hook (a Checkpointer or a HotspotTrace) under a mesh: every
    rank gathers the state the hook is called with (the gather is
    collective), and the mesh's first rank hands the full state to the
    hook; the others write nothing.  A checkpointer's off iterations
    (it % rate) gather nothing."""

    def __init__(self, hook, mesh):
        self.hook, self.mesh = hook, mesh
        self.first = dist.get_rank() == int(mesh.devices.ravel()[0])
        self.rate = getattr(hook, "rate", 1)

    def __call__(self, it, state, *args):
        if it % self.rate:
            return
        full = pmesh.to_host(state, self.mesh)
        if self.first:
            self.hook(it, full, *args)

    def clean_up(self):
        if self.first:
            self.hook.clean_up()
