"""The blocked complete-data sweep with the inner Gauss-Seidel update as a
kernel: per predictor block, r0 = X_b^T F and F += X_b delta are plain
matrix products, and the sequential update of the block's B coordinates is
one launch.

Counterpart of atlasqtl_tpu/ops/sweep_pallas.py (the route of
Config(sweep="pallas") and of Config(use_pallas=True)).  For CUDA tensors the
update is the hand-written kernel in csrc/sweep_inner_gs.cu, in float32 or
float64, which replaces the TPU kernel
atlasqtl_tpu/ops/sweep_pallas.py:_inner_gs_kernel.  For CPU tensors it is
ops/sweep.py:_inner_gs, the same function in plain tensor ops.
"""
from __future__ import annotations

import torch

from .sweep import SweepConsts, _inner_gs, sweep_complete
from .sweep_fused import _load

# the largest block the kernel takes (csrc/sweep_inner_gs.cu:smem_bytes:
# the Gram's first 128 rows packed, B x 32 deltas, 8 x 32 residuals, at
# most 232,448 bytes)
GS_BMAX = {torch.float32: 1544, torch.float64: 640}
_BLOCK_OPERANDS = ("r0", "cp_b", "gam_b", "mu_b", "log_p", "log_1p")
_COLUMN_OPERANDS = ("sig2_beta", "tau", "log_tau")


def _on_card(device):
    """True for a CUDA device, False for the CPU; any other device raises."""
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"inner_gs_pallas: unsupported device {device}")
    return device.type == "cuda"


def _scalars(c, log_sig2_inv, like):
    """The kernel's (2,) scalar operand (c, log sig2_inv) on like's device."""
    return torch.stack([torch.as_tensor(v, dtype=like.dtype,
                                        device=like.device).reshape(())
                        for v in (c, log_sig2_inv)])


def _inner_gs_cuda(r0, g_b, cp_b, gam_b, mu_b, log_p, log_1p, sig2_beta, tau,
                   log_tau, scal):
    B, q = r0.shape
    dt = r0.dtype
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"inner_gs kernel: float32 or float64 only, got {dt}")
    operands = dict(r0=r0, cp_b=cp_b, gam_b=gam_b, mu_b=mu_b, log_p=log_p,
                    log_1p=log_1p, g_b=g_b, sig2_beta=sig2_beta, tau=tau,
                    log_tau=log_tau, scal=scal)
    shapes = dict({k: (B, q) for k in _BLOCK_OPERANDS}, g_b=(B, B),
                  scal=(2,), **{k: (q,) for k in _COLUMN_OPERANDS})
    for name, t in operands.items():
        if (t.device != r0.device or t.dtype != dt or not t.is_contiguous()
                or tuple(t.shape) != shapes[name]):
            raise ValueError(
                f"inner_gs kernel: {name} must be a contiguous {dt} tensor of "
                f"shape {shapes[name]} on {r0.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    lib = _load()
    if B <= 0 or B % 8 or lib.atlasqtl_inner_gs_smem(
            int(dt == torch.float64), B) < 0:
        raise ValueError(f"inner_gs kernel: unsupported block {B} (a "
                         f"multiple of 8 whose deltas fit in shared memory:"
                         f" {GS_BMAX[dt]} in {dt})")
    gam_out, mu_out, delta = (torch.empty_like(r0) for _ in range(3))
    err = lib.atlasqtl_inner_gs(
        int(dt == torch.float64), r0.data_ptr(), g_b.data_ptr(),
        cp_b.data_ptr(), gam_b.data_ptr(), mu_b.data_ptr(), log_p.data_ptr(),
        log_1p.data_ptr(), sig2_beta.data_ptr(), tau.data_ptr(),
        log_tau.data_ptr(), scal.data_ptr(), gam_out.data_ptr(),
        mu_out.data_ptr(), delta.data_ptr(), q, B,
        torch.cuda.current_stream(r0.device).cuda_stream)
    if err != 0:
        raise RuntimeError("inner_gs kernel launch failed: "
                           + lib.atlasqtl_error_string(err).decode())
    inner_gs_pallas.launches += 1
    return gam_out, mu_out, delta


def inner_gs_pallas(r0, g_b, cp_b, gam_b, mu_b, log_p, log_1p, sig2_beta,
                    tau, log_tau, c, log_sig2_inv):
    """The sequential Gauss-Seidel update of one predictor block, with the
    arguments of the JAX wrapper.

    r0/cp_b/gam_b/mu_b/log_p/log_1p: (B, q); g_b: (B, B); sig2_beta/tau/
    log_tau: (q,); c, log_sig2_inv: scalars.  Returns (gam_new, mu_new,
    delta) each (B, q).

    CPU tensors run `inner_gs_plain` (ops/sweep.py:_inner_gs); CUDA tensors
    launch the kernel (csrc/sweep_inner_gs.cu) or raise.
    `inner_gs_pallas.launches` counts kernel launches.
    """
    args = (r0, g_b, cp_b, gam_b, mu_b, log_p, log_1p, sig2_beta, tau,
            log_tau)
    if _on_card(r0.device):
        return _inner_gs_cuda(*args, _scalars(c, log_sig2_inv, r0))
    return inner_gs_plain(*args, c, log_sig2_inv)


inner_gs_pallas.launches = 0


def inner_gs_plain(r0, g_b, cp_b, gam_b, mu_b, log_p, log_1p, sig2_beta,
                   tau, log_tau, c, log_sig2_inv):
    """The kernel's function in plain tensor ops: ops/sweep.py:_inner_gs
    with the arguments of `inner_gs_pallas`."""
    as_t = lambda v: torch.as_tensor(v, dtype=r0.dtype, device=r0.device)
    consts = SweepConsts(sig2_beta=sig2_beta, tau=tau, log_tau=log_tau,
                         log_sig2_inv=as_t(log_sig2_inv), theta=None,
                         zeta=None, c=as_t(c))
    return _inner_gs(r0, g_b, cp_b, gam_b, mu_b, log_p, log_1p, consts)


def sweep_complete_pallas(x, cp_x_y, gram_blocks, gam, mu_beta, fitted,
                          consts, block_size, p_mask, q_mask):
    """Full sweep with the inner update as a kernel (complete data).  Same
    block loop, products and fused Z sums as ops/sweep.py:sweep_complete
    (atlasqtl_tpu/ops/sweep_pallas.py:154-202); returns (gam', mu_beta',
    fitted', z_row, z_col).  On the card the kernel's scalar operand is
    built once per sweep; on the CPU the in-block update is _inner_gs."""
    args = (x, cp_x_y, gram_blocks, gam, mu_beta, fitted, consts, block_size,
            p_mask, q_mask)
    if not _on_card(fitted.device):
        return sweep_complete(*args, inner=_inner_gs)
    scal = _scalars(consts.c, consts.log_sig2_inv, fitted)

    def inner(r0, g_b, cp_b, gam_b, mu_b, log_p, log_1p, consts):
        return _inner_gs_cuda(r0, g_b, cp_b, gam_b, mu_b, log_p, log_1p,
                              consts.sig2_beta, consts.tau, consts.log_tau,
                              scal)
    return sweep_complete(*args, inner=inner)
