"""The fused exact-missing sweep: one whole Gauss-Seidel pass per call.

Counterpart of atlasqtl_tpu/ops/sweep_missing_fused.py.  For CUDA tensors the
sweep is the hand-written kernel in csrc/sweep_missing_fused.cu, which
replaces the TPU kernel atlasqtl_tpu/ops/sweep_missing_fused.py:_mis_kernel.
For CPU tensors it is `sweep_missing_fused_plain`, the same function in plain
tensor ops, one coordinate at a time (the kernel is held against it on the
card; the CPU tests hold it against the JAX kernel).

The carried statistic is the masked fitted matrix Fm = mis_pat * (X beta).
Coordinate (j, k) takes its own Gram diagonal from x_norm_sq[j, k] and
derives its slab variance in the kernel: with den = x_norm_sq + sig2_inv,
mu = (cp - r) / den (= c s2 tau (cp - r)) and
logit = ad + (c^2 / 2) tau mu (cp - r), where ad = c d(u) - c cst_k
- (c / 2) log(den) and cst_k, the rank-1 part of the logit constant, rides
the interpolation's cst row (ops/interp.py).  So no (p, q) slab-variance
array is read.

What bounds the kernel on an H100: the function needs the projection and
the masked advance of Fm for each (j, k), about 5 n p q FP32 operations per
sweep; the bytes it must move take a ninth of that time at 3.35 TB/s.  The
kernel's windows of W = 8 predictors add 28 masked pair Grams per window,
which roughly doubles its operations.  Each CTA keeps its rows of a
32-column Fm slice in shared memory for the whole sweep, split over a
thread-block cluster where one SM cannot hold them (`missing_launch_plan`);
csrc/sweep_missing_fused.cu says how it is laid out.
"""
from __future__ import annotations

import ctypes

import torch

from .interp import K_BASE, tail_interp_operands
from .special import as_scalar
from .sweep_fused import (H100_SMS, SMEM_MAX, SMEM_TWO_PER_SM, Operands,
                          _load, sub_block)

# the kernel's constants (csrc/sweep_missing_fused.cu)
MIS_QS = 32                          # response columns per slice
MIS_W = 8                            # chain window
MIS_NRH = MIS_W + MIS_W * (MIS_W - 1) // 2   # sums of one window pass
MIS_NSLOT = 2                        # warp-partial slots
MIS_NWT = 4                          # chain operand tiles per window
MIS_NWS = 3                          # window scalar sets
MIS_MAX_CLUSTER = 8                  # largest cluster the kernel takes
MIS_SPREAD = 4                       # largest cluster taken only to spread
MIS_NCLK = 10                        # the kernel's phase clock slots
MIS_CLKF = (2 * MIS_NCLK + 3) & ~3   # their floats, kept 16-byte whole


def _mis_smem_bytes(on_chip: bool, nloc: int, r_aug: int) -> int:
    """csrc/sweep_missing_fused.cu:smem_bytes: two sets of window operand
    tiles, two windows of gam, the deltas, two sum buffers, the partial
    slots, the phase clocks, three sets of window scalars (p_mask, theta,
    rows of L), the slice's interpolation nodes; on chip also nloc rows of
    Fm (32 floats), of x (two slots of W) and of mask bits.  The card holds
    it to the kernel's own (`kernel_smem_bytes`)."""
    fixed = (2 * MIS_NWT * MIS_W * MIS_QS + 3 * MIS_W * MIS_QS
             + 2 * MIS_NRH * MIS_QS + MIS_NSLOT * MIS_NRH * MIS_QS
             + MIS_CLKF + MIS_NWS * (2 * MIS_W + MIS_W * r_aug)
             + 3 * r_aug * MIS_QS)
    return 4 * (fixed + (nloc * (MIS_QS + 2 * MIS_W + 1) if on_chip else 0))


def missing_launch_plan(n: int, q: int, block: int, r_aug: int,
                        m: int = 1) -> dict:
    """The launch of B2 at (n, q, block, r + 2) for m replicas (one launch
    of grid x m CTAs; `grid` counts one replica's).  The rows of each
    32-column slice are split over the smallest cluster (1..MIS_MAX_CLUSTER
    CTAs) whose CTAs each hold their rows of Fm on chip in at most
    SMEM_TWO_PER_SM bytes, so that two CTAs share an SM and one's chain
    overlaps the other's pass; failing that, in at most SMEM_MAX bytes (one
    per SM).  While the card would still hold one CTA per SM of a cluster
    one larger for all m replicas' slices, the cluster grows (up to
    MIS_SPREAD), so that few slices spread over more SMs.  Where no
    cluster holds the rows, the device-memory branch: Fm stays in device
    memory, one CTA per slice.  A block over 128 is walked in pieces of
    `sub_block` rows (ops/sweep_fused.py:sub_block); the kernel builds its
    pair Grams per window, so no piece needs anything precomputed.  Returns slice_width,
    sub_block, cluster, grid, smem_bytes, fm_on_chip, rows_per_cta and
    ctas_per_sm (the CTAs that share an SM); the C entry point takes the
    decisions (piece, cluster, fm_on_chip) and derives the rest.  Raises
    ValueError on a shape the kernel does not take."""
    if (n <= 0 or block <= 0 or block % MIS_W or q % 4 or q <= 0
            or not 0 < r_aug <= 48 or m < 1):
        raise ValueError(f"sweep_missing_fused kernel: unsupported shape "
                         f"n={n}, q={q}, block={block}, r+2={r_aug}, m={m}")
    sub = sub_block(block)
    slices = -(-q // MIS_QS)
    smem = lambda cs: _mis_smem_bytes(True, -(-n // cs), r_aug)
    for limit, ctas in ((SMEM_TWO_PER_SM, 2), (SMEM_MAX, 1)):
        fits = [cs for cs in range(1, MIS_MAX_CLUSTER + 1)
                if smem(cs) <= limit]
        if fits:
            cs = fits[0]
            while cs < MIS_SPREAD and m * slices * (cs + 1) <= H100_SMS:
                cs += 1
            return dict(slice_width=MIS_QS, sub_block=sub, cluster=cs,
                        grid=slices * cs,
                        smem_bytes=smem(cs), fm_on_chip=True,
                        rows_per_cta=-(-n // cs), ctas_per_sm=ctas)
    return dict(slice_width=MIS_QS, sub_block=sub, cluster=1, grid=slices,
                smem_bytes=_mis_smem_bytes(False, 0, r_aug), fm_on_chip=False,
                rows_per_cta=n, ctas_per_sm=2)


def window() -> int:
    """The kernel's chain window W (predictors per on-the-fly pair-Gram
    window); builds the kernel library if needed."""
    return _load().atlasqtl_sweep_missing_window()


def occupancy(plan: dict, n: int, r_aug: int) -> tuple:
    """(CTAs of B2 resident on one SM, clusters resident on the card) under
    `plan` at n samples and r + 2, from the occupancy calculator on the
    card."""
    clusters = ctypes.c_int(-1)
    ctas = _load().atlasqtl_sweep_missing_occupancy(
        n, plan["cluster"], int(plan["fm_on_chip"]), r_aug,
        ctypes.byref(clusters))
    return ctas, clusters.value


def kernel_smem_bytes(plan: dict, n: int, r_aug: int) -> int:
    """The kernel's own shared-memory bytes under `plan` at n samples and
    r + 2, -1 where it refuses the plan."""
    return _load().atlasqtl_sweep_missing_smem(
        n, plan["cluster"], int(plan["fm_on_chip"]), r_aug)


PHASES = ("prologue", "pass", "reduce", "cluster_sync", "gather", "chain",
          "x_wait", "barrier", "tail", "total")


def phase_clocks() -> dict:
    """The SM clock cycles the latest B2 launch's first CTA spent in each
    phase (its thread 0, which also runs the chain; csrc:g_clocks)."""
    out = (ctypes.c_longlong * MIS_NCLK)()
    err = _load().atlasqtl_sweep_missing_clocks(out)
    if err != 0:
        raise RuntimeError("sweep_missing_fused clocks: "
                           + _load().atlasqtl_error_string(err).decode())
    return dict(zip(PHASES, out))


# sweep_missing_fused's operands: x, X^T Y, x_norm_sq, the observation
# pattern and the masks are shared by all replicas; c (one temperature) may
# be either
MISSING = Operands(
    dict(x=2, cp_x_y=2, x_norm_sq=2, mis_pat=2, l_aug=2, n_stack=3, gam=2,
         mu=2, fitted=2, theta=1, p_mask=1, zeta=1, q_mask=1, tau=1, c=0,
         kz=0, sig2_inv=0),
    shared=("x", "cp_x_y", "x_norm_sq", "mis_pat", "p_mask", "q_mask"),
    either=("c",))


def sweep_missing_fused_plain(x, cp_x_y, x_norm_sq, mis_pat, l_aug, n_stack,
                              gam, mu, fitted, theta, p_mask, zeta, q_mask,
                              tau, c, kz, sig2_inv, *, block_size: int):
    """The kernel's function in plain tensor ops, block by block and one
    coordinate at a time in flat sequential order.  Same arguments and
    outputs as `sweep_missing_fused`; with a replica axis, one replica
    after another."""
    args = (x, cp_x_y, x_norm_sq, mis_pat, l_aug, n_stack, gam, mu, fitted,
            theta, p_mask, zeta, q_mask, tau, c, kz, sig2_inv)
    if gam.dim() == 3:
        return MISSING.loop(_sweep_missing_plain_one, args,
                            dict(block_size=block_size))
    return _sweep_missing_plain_one(*args, block_size=block_size)


def _sweep_missing_plain_one(x, cp_x_y, x_norm_sq, mis_pat, l_aug, n_stack,
                             gam, mu, fitted, theta, p_mask, zeta, q_mask,
                             tau, c, kz, sig2_inv, *, block_size):
    p = x.shape[1]
    B = block_size
    fm = fitted.clone()
    gam_out = torch.empty_like(gam)
    mu_out = torch.empty_like(mu)
    z_row = torch.empty_like(theta)
    z_col = torch.zeros_like(zeta)
    for b in range(p // B):
        sl = slice(b * B, (b + 1) * B)
        l_blk = l_aug[sl]
        u = theta[sl, None] + zeta[None, :]
        u2 = u * u
        s_z = torch.sqrt(u2 + kz)
        den = x_norm_sq[sl] + sig2_inv
        ad = (c * (0.5 * u * torch.sqrt(u2 + K_BASE)) + l_blk @ n_stack[0]
              - 0.5 * c * torch.log(den))
        imrd = s_z + l_blk @ n_stack[1]
        imr0u = l_blk @ n_stack[2] - 0.5 * (s_z + u)
        ct = 1.0 / den
        gam_b = torch.empty_like(ad)
        mu_b = torch.empty_like(ad)
        for i in range(B):
            j = b * B + i
            x_j = x[:, j]
            beta_old = gam[j] * mu[j]
            r = x_j @ fm - beta_old * x_norm_sq[j]
            d = cp_x_y[j] - r
            mu_i = ct[i] * d
            gam_i = torch.sigmoid(ad[i] + 0.5 * c * c * tau * (mu_i * d))
            fm.addcmul_(mis_pat, torch.outer(x_j, gam_i * mu_i - beta_old))
            gam_b[i], mu_b[i] = gam_i, mu_i
        msk = p_mask[sl, None] * q_mask[None, :]
        gam_out[sl] = gam_b * msk
        mu_out[sl] = mu_b * msk
        z = (gam_out[sl] * imrd + imr0u) * msk
        z_row[sl] = torch.sum(z, dim=1)
        z_col += torch.sum(z, dim=0)
    return gam_out, mu_out, fm, z_row, z_col


def _sweep_missing_fused_cuda(x, cp_x_y, x_norm_sq, mis_pat, l_aug, n_stack,
                              gam, mu, fitted, theta, p_mask, zeta, q_mask,
                              tau, c, kz, sig2_inv, *, block_size, plan=None):
    """Check the operands of one B2 launch, launch it and count it: the
    state's operands of `MISSING` with or without a replica axis, one
    launch of grid x m CTAs.  `plan` (None: `missing_launch_plan` for the
    operands' replica count) is there only to compare a replica's single
    launch with a batched one under the batched launch's plan.  Raises on
    what the kernel cannot take and on a failed launch."""
    n, p = x.shape[-2:]
    q = gam.shape[-1]
    r_aug = l_aug.shape[-1]
    args = (x, cp_x_y, x_norm_sq, mis_pat, l_aug, n_stack, gam, mu, fitted,
            theta, p_mask, zeta, q_mask, tau, c, kz, sig2_inv)
    try:
        m, batched = MISSING.replica_axis(args)
    except ValueError as e:
        raise ValueError(f"sweep_missing_fused kernel: {e}") from None
    shapes = ((n, p), (p, q), (p, q), (n, q), (p, r_aug), (3, r_aug, q),
              (p, q), (p, q), (n, q), (p,), (p,), (q,), (q,), (q,))
    for i, (name, shape) in enumerate(zip(MISSING.names, shapes)):
        t = args[i]
        shape = (m, *shape) if batched[i] else shape
        # every replica's slice is 16-byte aligned too
        step = t[0].numel() * 4 if batched[i] else 0
        if (t.device.type != "cuda" or t.dtype != torch.float32
                or not t.is_contiguous() or tuple(t.shape) != shape
                or t.data_ptr() % 16 or step % 16):
            raise ValueError(
                f"sweep_missing_fused kernel: {name} must be a contiguous, "
                f"16-byte aligned float32 CUDA tensor of shape {shape}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if block_size <= 0 or block_size % 8 or p % block_size or q % 4 \
            or r_aug > 48:
        raise ValueError(f"sweep_missing_fused kernel: unsupported shape "
                         f"n={n}, p={p}, q={q}, block={block_size}, "
                         f"r+2={r_aug}")
    plan = plan or missing_launch_plan(n, q, block_size, r_aug, m)
    lib = _load()
    lead = (m,) if any(batched) else ()
    f32 = lambda v: as_scalar(v, torch.float32, x.device).expand(lead)
    scal = torch.stack([f32(c), f32(kz), f32(sig2_inv)], dim=-1).contiguous()
    fitted = fitted.clone()
    gam_out = torch.empty_like(gam)
    mu_out = torch.empty_like(mu)
    zrow_part = torch.empty((*lead, plan["grid"] // plan["cluster"], p),
                            dtype=torch.float32, device=x.device)
    z_row = torch.empty_like(theta)
    z_col = torch.empty_like(zeta)
    ptr = lambda t: t.data_ptr()
    err = lib.atlasqtl_sweep_missing_fused(
        ptr(x), ptr(cp_x_y), ptr(gam), ptr(mu), ptr(x_norm_sq), ptr(mis_pat),
        ptr(l_aug), ptr(n_stack), ptr(fitted), ptr(theta), ptr(p_mask),
        ptr(zeta), ptr(q_mask), ptr(tau), ptr(scal), ptr(gam_out),
        ptr(mu_out), ptr(zrow_part), ptr(z_row), ptr(z_col), n, p, q,
        plan["sub_block"], r_aug, plan["cluster"], int(plan["fm_on_chip"]),
        m, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"sweep_missing_fused kernel launch failed at n={n}, p={p}, "
            f"q={q}, block={block_size}, {m} replica(s), plan {plan}: "
            + lib.atlasqtl_error_string(err).decode())
    sweep_missing_fused.launches += 1
    return gam_out, mu_out, fitted, z_row, z_col


def sweep_missing_fused(x, cp_x_y, x_norm_sq, mis_pat, l_aug, n_stack, gam,
                        mu, fitted, theta, p_mask, zeta, q_mask, tau, c, kz,
                        sig2_inv, *, block_size: int):
    """One exact-missing Gauss-Seidel sweep with fused Z reductions.

    x: (n, p); cp_x_y/x_norm_sq/gam/mu: (p, q); mis_pat/fitted: (n, q), the
    observation pattern and the masked Fm; l_aug (p, r+2) / n_stack
    (3, r+2, q) / kz: the interpolation operands (`missing_fused_operands`);
    theta/p_mask (p,); zeta/q_mask/tau (q,); c, kz, sig2_inv 0-d.  Returns
    (gam', mu', Fm', z_row (p,), z_col (q,)), gam' and mu' masked.  The
    inputs are not modified.

    Replicas: the state's operands (l_aug, n_stack, gam, mu, fitted, theta,
    zeta, tau, kz, sig2_inv) may carry a leading axis of m replicas, and
    then c may too; every output then carries it.  That is one kernel
    launch for all m sweeps.

    CPU tensors run `sweep_missing_fused_plain`; CUDA tensors launch the
    kernel (csrc/sweep_missing_fused.cu) or raise.
    `sweep_missing_fused.launches` counts kernel launches (one per call,
    whatever m).
    """
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"sweep_missing_fused: unsupported device {x.device}")
    fn = (_sweep_missing_fused_cuda if x.device.type == "cuda"
          else sweep_missing_fused_plain)
    return fn(x, cp_x_y, x_norm_sq, mis_pat, l_aug, n_stack, gam, mu, fitted,
              theta, p_mask, zeta, q_mask, tau, c, kz, sig2_inv,
              block_size=block_size)


sweep_missing_fused.launches = 0


def missing_fused_operands(x, cp_x_y, x_norm_sq, mis_pat, gam, mu, fitted,
                           consts, sig2_inv, p_mask, q_mask,
                           interp_r: int = 40):
    """The positional operands of `sweep_missing_fused` for one iteration.

    The rank-1 part of the logit constant rides the interpolation's cst
    row: with s2 = 1/(c (x_norm_sq + sig2_inv) tau),
      -(E[log tau] + E[log sig2_inv] + log s2)/2
        = -(E[log tau] - log tau + E[log sig2_inv] - log c)/2
          + log(x_norm_sq + sig2_inv)/2,
    and the per-(j, k) log term is applied in the kernel."""
    c = as_scalar(consts.c, gam.dtype, gam.device)
    cst_q = -0.5 * (consts.log_tau - torch.log(consts.tau)
                    + consts.log_sig2_inv - torch.log(c))
    l_aug, n_stack, kz = tail_interp_operands(consts.theta, consts.zeta,
                                              cst_q, c, p_mask, r=interp_r)
    return (x, cp_x_y, x_norm_sq, mis_pat, l_aug, n_stack, gam, mu, fitted,
            consts.theta, p_mask, consts.zeta, q_mask, consts.tau, c, kz,
            sig2_inv)


def sweep_missing_fused_driver(x, cp_x_y, x_norm_sq, mis_pat, gam, mu,
                               fitted, consts, sig2_inv, block_size, p_mask,
                               q_mask, interp_r: int = 40):
    """Driver-facing wrapper matching ops/sweep.py:sweep_missing_blocked.
    sig2_inv is the scalar slab precision; consts.sig2_beta is not read
    (the kernel derives the per-cell variance from x_norm_sq)."""
    return sweep_missing_fused(
        *missing_fused_operands(x, cp_x_y, x_norm_sq, mis_pat, gam, mu,
                                fitted, consts, sig2_inv, p_mask, q_mask,
                                interp_r),
        block_size=block_size)
