"""The pipelined 2-D (p x q) Gauss-Seidel sweep (counterpart of
atlasqtl_tpu/parallel/pipeline.py).

On a ("p", "q") mesh the q axis shards the traits as on a 1-D mesh, and
the p axis shards the predictors: x (n, p), the Gram blocks and every
(p, .) tensor.  The sweep is sequential over the predictors
(src/coreLoop.cpp:58-85), so the p-shards cannot sweep the same response
tile at once.  The local q-shard is cut into T tiles that flow through the
P predictor stages as a software pipeline: at step s, stage d sweeps tile
t = s - d and passes its updated (n, q_tile) fitted tile to stage d + 1 of
its q-row (torch.distributed point-to-point, each step's send and receive
posted as one batch).  Stage d touches tile t only after stages < d
finished it, so the update order is the single-device order: the pipeline
is a schedule, not an approximation.  After the last step the last stage's
fitted matrix is summed over p (the other stages hold zeros), z_row over q,
and the column statistics over p.

A tile processor is one launch of the port's engine on the stage's shard
and the tile's columns, copied into contiguous tensors (B1 and B2 take no
strided operand): B1 (complete data and impute, float32 on the card, or
Config(sweep="fused")), B2 (exact missing), or the plain engines.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import updates as upd
from ..ops.sweep import (SweepConsts, sweep_complete, sweep_missing,
                         sweep_missing_blocked)
from ..ops.sweep_fused import sweep_complete_fused
from ..ops.sweep_missing_fused import sweep_missing_fused_driver
from .mesh import p_sum, q_sum

TILE_CANDIDATES = (1024, 512, 256, 128, 64, 32, 16, 8)


def resolve_step_overhead(cfg_value: float) -> float:
    """Config.pipeline_step_overhead_qcols where set (> 0), else 0, the
    asymptotic rule.  The JAX package's "auto" on an accelerator takes a
    constant measured on a TPU (atlasqtl_tpu/parallel/pipeline.py:46); none
    is measured for the port's card, so it takes the asymptotic rule
    everywhere.  The tile changes the schedule, never the function."""
    return cfg_value if cfg_value > 0.0 else 0.0


def pick_q_tile(q_local: int, p_shards: int,
                step_overhead_qcols: float = 0.0):
    """The tile width: a candidate that divides q_local
    (atlasqtl_tpu/parallel/pipeline.py:56-89, without the TPU kernel's VMEM
    limit: B1 and B2 take any multiple of 4).  One iteration costs
    (P + T - 1) steps of (q_local / T + A) column-units, A the per-step
    overhead in columns of tile work: with A > 0 the candidate that
    minimises that, with A = 0 the widest tile that still gives T >= 2 P
    tiles (the fill and drain bubble at most a third of the steps).  None
    where no candidate divides q_local."""
    divisors = [c for c in TILE_CANDIDATES if q_local % c == 0]
    if not divisors:
        return None
    if step_overhead_qcols > 0.0:
        return min(divisors, key=lambda c: ((p_shards + q_local // c - 1)
                                            * (c + step_overhead_qcols)))
    for c in divisors:
        if q_local // c >= 2 * p_shards:
            return c
    return divisors[-1]


def _tile_width(mesh, cfg, q_local):
    qt = pick_q_tile(q_local, mesh.n_p,
                     resolve_step_overhead(cfg.pipeline_step_overhead_qcols))
    if qt is None:
        raise ValueError(f"pipelined sweep: no tile divides the local q "
                         f"{q_local}")
    return qt


def _run_pipeline(mesh, fitted, qt, run_tile):
    """The schedule: for each step, run_tile(columns, fitted tile in) ->
    fitted tile out on this stage's tile, then send it on to the next
    stage and receive the next tile from the previous one.  Returns the
    (n, q_local) fitted matrix of the last stage (zeros on the others)."""
    P, d = mesh.n_p, mesh.p_index
    n, q_local = fitted.shape
    T = q_local // qt
    fout = torch.zeros_like(fitted)
    fcur = None
    for s in range(P + T - 1):
        t = s - d
        f_new = None
        if 0 <= t < T:
            cols = slice(t * qt, (t + 1) * qt)
            fin = fitted[:, cols].contiguous() if d == 0 else fcur
            f_new = run_tile(cols, fin)
            if d == P - 1:
                fout[:, cols] = f_new
        # one batch per step: this stage's send and its receive of the tile
        # that stage d - 1 sweeps now (this stage's next)
        ops = []
        if f_new is not None and d < P - 1:
            ops.append(dist.P2POp(dist.isend, f_new.contiguous(),
                                  mesh.p_ranks[d + 1], mesh.p_group))
        if d > 0 and 0 <= s - d + 1 < T:
            fcur = torch.empty((n, qt), dtype=fitted.dtype,
                               device=fitted.device)
            ops.append(dist.P2POp(dist.irecv, fcur, mesh.p_ranks[d - 1],
                                  mesh.p_group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    return fout


def _consts_tile(consts, cols, p_cols=False):
    """The sweep constants of the tile's columns (sig2_beta (p, q) under
    exact missing: p_cols)."""
    return SweepConsts(
        sig2_beta=(consts.sig2_beta[:, cols] if p_cols
                   else consts.sig2_beta[cols]).contiguous(),
        tau=consts.tau[cols].contiguous(),
        log_tau=consts.log_tau[cols].contiguous(),
        log_sig2_inv=consts.log_sig2_inv, theta=consts.theta,
        zeta=consts.zeta[cols].contiguous(), c=consts.c)


def pipelined_sweep_2d(data, state, beta_carry, gram_blocks, cp_x_y, consts,
                       block, cfg, fused, bf16=False, emit_gam_mu=True,
                       annealed=False):
    """The complete-data (and impute) sweep over a ("p", "q") mesh, with the
    global values of the single-device sweep.  fused: the tile processor
    is B1 (its plain version on the CPU; bf16 its mxu_bf16 instance), which
    reads the carried beta and, with emit_gam_mu False ("lite"), returns
    gam and mu as None; else the plain blocked engine.  Returns (beta, gam,
    mu, fitted, z_row, z_col, (gam colsum, mu^2 gam colsum, beta^2
    colsum))."""
    mesh = data.mesh
    p_l, q_local = state.gam.shape
    qt = _tile_width(mesh, cfg, q_local)
    emit = emit_gam_mu or not fused
    dt, dev = state.gam.dtype, state.gam.device
    beta = torch.empty_like(state.gam)
    gam = torch.empty_like(state.gam) if emit else None
    mu = torch.empty_like(state.gam) if emit else None
    z_row = torch.zeros(p_l, dtype=dt, device=dev)
    cstats = torch.zeros((4, q_local), dtype=dt, device=dev)  # z_col + 3

    def run_tile(cols, fin):
        ct = _consts_tile(consts, cols)
        cp_t = cp_x_y[:, cols].contiguous()
        qm_t = data.q_mask[cols].contiguous()
        if fused:
            b, g, m, f, zr, zc, cs = sweep_complete_fused(
                data.x, cp_t, gram_blocks, beta_carry[:, cols].contiguous(),
                fin, ct, block, p_mask=data.p_mask, q_mask=qm_t,
                emit_gam_mu=emit_gam_mu, annealed=annealed, bf16=bf16,
                x_bf16=data.x_bf16)
        else:
            g, m, f, zr, zc = sweep_complete(
                data.x, cp_t, gram_blocks, state.gam[:, cols].contiguous(),
                state.mu_beta[:, cols].contiguous(), fin, ct, block,
                p_mask=data.p_mask, q_mask=qm_t)
            msk = data.p_mask[:, None] * qm_t[None, :]
            g, m = g * msk, m * msk
            b = g * m
            cs = (torch.sum(g, dim=0), torch.einsum("pq,pq->q", m * m, g),
                  torch.einsum("pq,pq->q", b, b))
        beta[:, cols] = b
        if emit:
            gam[:, cols] = g
            mu[:, cols] = m
        z_row.add_(zr)
        cstats[:, cols] = torch.stack([zc, *cs])
        return f

    fout = _run_pipeline(mesh, state.fitted, qt, run_tile)
    fitted = p_sum(mesh, fout)       # only the last stage's is nonzero
    z_row = q_sum(mesh, z_row)       # theta needs the full q row sum
    z_col, gcol, m2g, b2 = p_sum(mesh, cstats)
    return beta, gam, mu, fitted, z_row, z_col, (gcol, m2g, b2)


def pipelined_sweep_missing_2d(data, state, consts, sig2_inv, block, cfg,
                               engine):
    """The exact-missing sweep over a ("p", "q") mesh: the same schedule on
    the masked fitted matrix Fm = mis_pat * (X beta), whose masked rank
    updates stay exact tile by tile.  engine: "b2" (B2, its plain version
    on the CPU), "blocked" (pair Grams precomputed, Config.mis_block) or
    "scan" (one coordinate at a time), the port's single-device engine on
    the shard.  Returns (gam, mu, Fm, z_row, z_col), gam and mu masked."""
    mesh = data.mesh
    p_l, q_local = state.gam.shape
    qt = _tile_width(mesh, cfg, q_local)
    dt, dev = state.gam.dtype, state.gam.device
    gam = torch.empty_like(state.gam)
    mu = torch.empty_like(state.gam)
    z_row = torch.zeros(p_l, dtype=dt, device=dev)
    z_col = torch.zeros(q_local, dtype=dt, device=dev)

    def run_tile(cols, fin):
        ct = _consts_tile(consts, cols, p_cols=True)
        tile = lambda a: a[:, cols].contiguous()
        qm_t = data.q_mask[cols].contiguous()
        args = (data.x, tile(data.cp_x_y), tile(data.x_norm_sq),
                tile(data.mis_pat))
        msk = data.p_mask[:, None] * qm_t[None, :]
        if engine == "b2":
            g, m, f, zr, zc = sweep_missing_fused_driver(
                *args, tile(state.gam), tile(state.mu_beta), fin, ct,
                sig2_inv, block, data.p_mask, qm_t)
        elif engine == "blocked":
            g, m, f, zr, zc = sweep_missing_blocked(
                *args, data.mis_pair_gram[:, :, cols].contiguous(),
                tile(state.gam), tile(state.mu_beta), fin, ct, cfg.mis_block,
                data.p_mask, qm_t)
            g, m = g * msk, m * msk
        else:
            g, m, f = sweep_missing(*args, tile(state.gam),
                                    tile(state.mu_beta), fin, ct)
            g, m = g * msk, m * msk
            zr, zc = upd.z_moments(g, consts.theta, ct.zeta, data.p_mask,
                                   qm_t, consts.c, block_size=block)
        gam[:, cols] = g
        mu[:, cols] = m
        z_row.add_(zr)
        z_col[cols] = zc
        return f

    fout = _run_pipeline(mesh, state.fitted, qt, run_tile)
    return (gam, mu, p_sum(mesh, fout), q_sum(mesh, z_row),
            p_sum(mesh, z_col))
