"""The blocked complete-data sweep of Config(sweep="pallas") and
Config(use_pallas=True): per predictor block, r0 = X_b^T F and
F += X_b delta are plain matrix products, and everything between them -- the
probit tiles, the sequential update of the block's B coordinates, the Z
sums -- is one launch.

Counterpart of atlasqtl_tpu/ops/sweep_pallas.py.  For CUDA tensors the block
step is the hand-written kernel in csrc/sweep_inner_gs.cu, in float32 or
float64, which replaces the TPU kernel
atlasqtl_tpu/ops/sweep_pallas.py:_inner_gs_kernel and the per-block glue
around it; for CPU tensors it is `block_gs_plain`, the same function in
plain tensor ops (ops/sweep.py:_inner_gs, log_ndtr_both, _z_block_sums).
`inner_gs_pallas` keeps the JAX wrapper's signature (the probit tiles
given, no Z sums) and launches the same kernel body's tiles-read instance.
"""
from __future__ import annotations

import ctypes

import torch

from .special import as_scalar, log_ndtr_both
from .sweep import SweepConsts, _inner_gs, _z_block_sums
from .sweep_fused import _load

GS_QS = 32   # response columns per CTA (csrc/sweep_inner_gs.cu:QS)
# the largest block the kernel takes (csrc/sweep_inner_gs.cu:smem_bytes:
# the Gram's first 128 rows, B x 32 deltas, two slots of window tiles, the
# partial pushes, at most 232,448 bytes)
GS_BMAX = {torch.float32: 1368, torch.float64: 456}
_TILE_OPERANDS = ("r0", "cp_b", "gam_b", "mu_b", "log_p", "log_1p")
_COLUMN_OPERANDS = ("sig2_beta", "tau", "log_tau")


# the phase clock slots of csrc/sweep_inner_gs.cu:g_gs_clocks
CLOCK_PHASES = ("chain", "chain_barrier", "pushes", "pushes_barrier",
                "z_operands_loads", "operands_barrier")


def phase_clocks() -> dict:
    """The SM clock cycles the latest B3 launch's first CTA spent in each
    phase, summed over the windows: its chain thread (thread 0) in the
    chains (the pushes added in first) and at the barriers; a push thread
    (thread 32) in the pushes and at the barriers; an operand thread
    (thread 128) in its Z cells, next-window operands and loads, and at the
    barriers (csrc/sweep_inner_gs.cu:g_gs_clocks)."""
    out = (ctypes.c_longlong * len(CLOCK_PHASES))()
    err = _load().atlasqtl_inner_gs_clocks(out)
    if err != 0:
        raise RuntimeError("inner_gs clocks: "
                           + _load().atlasqtl_error_string(err).decode())
    return dict(zip(CLOCK_PHASES, out))


def _on_card(device):
    """True for a CUDA device, False for the CPU; any other device raises."""
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"inner_gs_pallas: unsupported device {device}")
    return device.type == "cuda"


def _scalars(c, log_sig2_inv, like):
    """The kernel's (4,) scalar operand (c, log sig2_inv, sqrt c, 0) on
    like's device, built once per sweep."""
    c = as_scalar(c, like.dtype, like.device).reshape(())
    lsi = as_scalar(log_sig2_inv, like.dtype, like.device).reshape(())
    return torch.stack([c, lsi, torch.sqrt(c), torch.zeros_like(c)])


def _check(label, like, operands, shapes):
    """Raise unless every operand is a contiguous tensor of like's dtype and
    device with its shape in `shapes`."""
    dt = like.dtype
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"{label}: float32 or float64 only, got {dt}")
    for name, t in operands.items():
        if (t.device != like.device or t.dtype != dt or not t.is_contiguous()
                or tuple(t.shape) != shapes[name]):
            raise ValueError(
                f"{label}: {name} must be a contiguous {dt} tensor of shape "
                f"{shapes[name]} on {like.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")


def _check_block(label, g_b, B, dt):
    """Raise unless the kernel takes a block of B rows whose Gram is g_b
    (read 16 bytes at a time)."""
    if B <= 0 or B % 8 or _load().atlasqtl_inner_gs_smem(
            int(dt == torch.float64), B) < 0:
        raise ValueError(f"{label}: unsupported block {B} (a multiple of 8 "
                         f"whose deltas fit in shared memory: {GS_BMAX[dt]} "
                         f"in {dt})")
    if g_b.data_ptr() % 16:
        raise ValueError(f"{label}: the block Gram must be 16-byte aligned")


def _launch(tiles, r0, g_b, cp, gam, mu, log_p, log_1p, theta, zeta, pm, qm,
            s2, tau, log_tau, scal, gam_out, mu_out, delta, z_col, zrow_part):
    """One launch of csrc/sweep_inner_gs.cu on the current stream, operands
    already checked.  cp/gam/mu/gam_out/mu_out are the block's rows (row
    stride q); zrow_part the block's columns of the (n_slices, p) partial
    buffer; the tile-free operands are None with `tiles`."""
    B, q = r0.shape
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _load().atlasqtl_inner_gs(
        int(r0.dtype == torch.float64), int(tiles), *map(ptr, (
            r0, g_b, cp, gam, mu, log_p, log_1p, theta, zeta, pm, qm, s2, tau,
            log_tau, scal, gam_out, mu_out, delta, z_col, zrow_part)),
        q, B, 0 if zrow_part is None else zrow_part.stride(0),
        torch.cuda.current_stream(r0.device).cuda_stream)
    if err != 0:
        raise RuntimeError("inner_gs kernel launch failed: "
                           + _load().atlasqtl_error_string(err).decode())


def _zrow_reduce(part, z_row):
    """z_row = the (n_slices, p) partials summed in slice order (one
    launch)."""
    err = _load().atlasqtl_zrow_reduce(
        int(part.dtype == torch.float64), part.data_ptr(), z_row.data_ptr(),
        part.shape[0], part.shape[1],
        torch.cuda.current_stream(part.device).cuda_stream)
    if err != 0:
        raise RuntimeError("zrow_reduce launch failed: "
                           + _load().atlasqtl_error_string(err).decode())


def _block_shapes(B, q, p):
    return dict(r0=(B, q), g_b=(B, B), cp=(p, q), gam=(p, q), mu=(p, q),
                theta=(p,), zeta=(q,), pm=(p,), qm=(q,), sig2_beta=(q,),
                tau=(q,), log_tau=(q,))


def _block_gs_cuda(r0, g_b, cp, gam, mu, theta, zeta, pm, qm, s2, tau,
                   log_tau, scal, row, gam_out, mu_out, delta, z_col,
                   zrow_part):
    """The route's launch for the block starting at `row` (operands checked
    once per sweep by the caller): gam/mu/cp/theta/pm are the sweep's whole
    (p, q) and (p,) tensors, written and read at the block's rows."""
    sl = slice(row, row + r0.shape[0])
    _launch(False, r0, g_b, cp[sl], gam[sl], mu[sl], None, None, theta[sl],
            zeta, pm[sl], qm, s2, tau, log_tau, scal, gam_out[sl], mu_out[sl],
            delta, z_col, zrow_part[:, sl])
    block_gs.launches += 1


def block_gs_plain(r0, g_b, cp_b, gam_b, mu_b, theta_b, zeta, pm_b, q_mask,
                   sig2_beta, tau, log_tau, c, log_sig2_inv):
    """The block kernel's function in plain tensor ops, as ops/sweep.py:
    sweep_complete computes one block: the exact probit tiles at theta_b +
    zeta, _inner_gs, the Z sums of the masked new gam.  Returns (gam, mu,
    delta) (B, q), the block's z_row (B,) and its z_col contribution
    (q,)."""
    as_t = lambda v: as_scalar(v, r0.dtype, r0.device)
    c = as_t(c)
    log_p, log_1p = log_ndtr_both(theta_b[:, None] + zeta[None, :])
    consts = SweepConsts(sig2_beta=sig2_beta, tau=tau, log_tau=log_tau,
                         log_sig2_inv=as_t(log_sig2_inv), theta=None,
                         zeta=None, c=c)
    gam, mu, delta = _inner_gs(r0, g_b, cp_b, gam_b, mu_b, log_p, log_1p,
                               consts)
    z_row, z_col = _z_block_sums(gam * pm_b[:, None] * q_mask[None, :],
                                 theta_b, zeta, pm_b, q_mask, c)
    return gam, mu, delta, z_row, z_col


def block_gs(r0, g_b, cp_b, gam_b, mu_b, theta_b, zeta, pm_b, q_mask,
             sig2_beta, tau, log_tau, c, log_sig2_inv):
    """One block of the B3 route with `block_gs_plain`'s arguments and
    results.  CPU tensors run the plain version; CUDA tensors launch the
    block kernel (counted in `block_gs.launches`) and the z_row reduction,
    or raise."""
    args = (r0, g_b, cp_b, gam_b, mu_b, theta_b, zeta, pm_b, q_mask,
            sig2_beta, tau, log_tau)
    if not _on_card(r0.device):
        return block_gs_plain(*args, c, log_sig2_inv)
    B, q = r0.shape
    _check("block_gs kernel", r0, dict(zip(_block_shapes(B, q, B), args)),
           _block_shapes(B, q, B))
    _check_block("block_gs kernel", g_b, B, r0.dtype)
    gam, mu, delta = (torch.empty_like(r0) for _ in range(3))
    z_col = torch.zeros_like(zeta)
    part = r0.new_empty(-(-q // GS_QS), B)
    _block_gs_cuda(*args, _scalars(c, log_sig2_inv, r0), 0, gam, mu, delta,
                   z_col, part)
    z_row = r0.new_empty(B)
    _zrow_reduce(part, z_row)
    return gam, mu, delta, z_row, z_col


block_gs.launches = 0


def inner_gs_pallas(r0, g_b, cp_b, gam_b, mu_b, log_p, log_1p, sig2_beta,
                    tau, log_tau, c, log_sig2_inv):
    """The sequential Gauss-Seidel update of one predictor block, with the
    arguments of the JAX wrapper (the probit tiles given, no Z sums).

    r0/cp_b/gam_b/mu_b/log_p/log_1p: (B, q); g_b: (B, B); sig2_beta/tau/
    log_tau: (q,); c, log_sig2_inv: scalars.  Returns (gam_new, mu_new,
    delta) each (B, q).

    CPU tensors run `inner_gs_plain` (ops/sweep.py:_inner_gs); CUDA tensors
    launch the tiles-read instance of the block kernel
    (csrc/sweep_inner_gs.cu) or raise.  `inner_gs_pallas.launches` counts
    its launches.
    """
    args = (r0, g_b, cp_b, gam_b, mu_b, log_p, log_1p, sig2_beta, tau,
            log_tau)
    if not _on_card(r0.device):
        return inner_gs_plain(*args, c, log_sig2_inv)
    B, q = r0.shape
    shapes = dict({k: (B, q) for k in _TILE_OPERANDS}, g_b=(B, B),
                  **{k: (q,) for k in _COLUMN_OPERANDS})
    _check("inner_gs kernel", r0, dict(zip(
        ("r0", "g_b", "cp_b", "gam_b", "mu_b", "log_p", "log_1p",
         *_COLUMN_OPERANDS), args)), shapes)
    _check_block("inner_gs kernel", g_b, B, r0.dtype)
    gam, mu, delta = (torch.empty_like(r0) for _ in range(3))
    _launch(True, r0, g_b, cp_b, gam_b, mu_b, log_p, log_1p, None, None, None,
            None, sig2_beta, tau, log_tau, _scalars(c, log_sig2_inv, r0), gam,
            mu, delta, None, None)
    inner_gs_pallas.launches += 1
    return gam, mu, delta


inner_gs_pallas.launches = 0


def inner_gs_plain(r0, g_b, cp_b, gam_b, mu_b, log_p, log_1p, sig2_beta,
                   tau, log_tau, c, log_sig2_inv):
    """The tiles-read instance's function in plain tensor ops:
    ops/sweep.py:_inner_gs with the arguments of `inner_gs_pallas`."""
    as_t = lambda v: as_scalar(v, r0.dtype, r0.device)
    consts = SweepConsts(sig2_beta=sig2_beta, tau=tau, log_tau=log_tau,
                         log_sig2_inv=as_t(log_sig2_inv), theta=None,
                         zeta=None, c=as_t(c))
    return _inner_gs(r0, g_b, cp_b, gam_b, mu_b, log_p, log_1p, consts)


def sweep_complete_pallas(x, cp_x_y, gram_blocks, gam, mu_beta, fitted,
                          consts, block_size, p_mask, q_mask):
    """Full sweep over all p predictors, complete data, as
    atlasqtl_tpu/ops/sweep_pallas.py:sweep_complete_pallas (:154-202)
    computes it; returns (gam', mu_beta', fitted', z_row, z_col).

    Per block: r0 = X_b^T F into a reused buffer, the block step, F +=
    X_b delta in place on a copy of F made once per sweep (addmm_ rounds
    F + X_b delta once, where fitted + xb @ delta rounded twice).  On the
    card the block step is one launch of the block kernel, which writes gam
    and mu at the block's rows, delta to a reused (B, q) buffer, adds to
    z_col and leaves z_row partials for one reduction per sweep; operands
    are checked once per sweep.  On the CPU it is `block_gs_plain`."""
    p, q = gam.shape
    B = block_size
    card = _on_card(fitted.device)
    gam_out, mu_out = torch.empty_like(gam), torch.empty_like(mu_beta)
    z_col = torch.zeros_like(consts.zeta)
    z_row = fitted.new_empty(p)
    fitted = fitted.clone()
    r0 = fitted.new_empty(B, q)
    if card:
        shapes = dict(_block_shapes(B, q, p), x=(fitted.shape[0], p),
                      fitted=(fitted.shape[0], q), grams=(p // B, B, B))
        _check("block_gs kernel", fitted, dict(
            x=x, fitted=fitted, grams=gram_blocks, cp=cp_x_y, gam=gam,
            mu=mu_beta, theta=consts.theta, zeta=consts.zeta, pm=p_mask,
            qm=q_mask, sig2_beta=consts.sig2_beta, tau=consts.tau,
            log_tau=consts.log_tau), shapes)
        _check_block("block_gs kernel", gram_blocks, B, fitted.dtype)
        scal = _scalars(consts.c, consts.log_sig2_inv, fitted)
        delta = torch.empty_like(r0)
        part = fitted.new_empty(-(-q // GS_QS), p)
    for b in range(p // B):
        sl = slice(b * B, (b + 1) * B)
        xb = x[:, sl]
        torch.matmul(xb.T, fitted, out=r0)
        if card:
            _block_gs_cuda(r0, gram_blocks[b], cp_x_y, gam, mu_beta,
                           consts.theta, consts.zeta, p_mask, q_mask,
                           consts.sig2_beta, consts.tau, consts.log_tau, scal,
                           b * B, gam_out, mu_out, delta, z_col, part)
        else:
            (gam_out[sl], mu_out[sl], delta, z_row[sl],
             zc) = block_gs_plain(
                r0, gram_blocks[b], cp_x_y[sl], gam[sl], mu_beta[sl],
                consts.theta[sl], consts.zeta, p_mask[sl], q_mask,
                consts.sig2_beta, consts.tau, consts.log_tau, consts.c,
                consts.log_sig2_inv)
            z_col += zc
        fitted.addmm_(xb, delta)
    if card:
        _zrow_reduce(part, z_row)
    return gam_out, mu_out, fitted, z_row, z_col
