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

pair_bf16=True is the TPU kernel's mis_pair_bf16 mode (atlasqtl_tpu/ops/
sweep_missing_fused.py:100-215) at its window sub (Config.mis_sub, 16 by
default; `pair_window` clips it to the block as the JAX kernel does): the
windows of sub predictors are aligned at each block's start, each window's
projections are taken against Fm as of the window's start, every pair
(a > b) inside a window goes through the masked pair Gram
sum_n m_nk bf16(x_na x_nb) (each float32 product rounded to bfloat16, the
mask exact, float32 sums), and Fm advances in float32 once per window.
The plain version then walks those windows (`_sweep_missing_plain_windows`).
The kernel keeps its chain windows of W = 8 and rounds the same pairs:
under sub < 8 only those of one sub-window; under sub = 16 also the cross
pairs of the two 8-windows of each 16-window, whose second 8-window
projects Fm from before the first one's advance and adds them; under
sub = 32, 64 and 128 every 8-window of a sub-window projects Fm as of the
sub-window's start and adds the rounded cross pairs with every earlier
8-window of it, and Fm advances once per sub-window.  From sub = 8 on,
the pair Grams run on the tensor cores (bf16 x bf16 -> f32 products of the
rounded pairs and the exact mask), the cross pairs contracted with their
deltas in registers (csrc/sweep_missing_fused.cu).  In float32 the window
does not change the function, and sub is ignored.
"""
from __future__ import annotations

import ctypes
import types

import torch

from .interp import K_BASE, tail_interp_operands
from .special import as_scalar
from .sweep_fused import (H100_SMS, SMEM_MAX, SMEM_TWO_PER_SM, Operands,
                          _load, fused_window, sub_block)

# the kernel's constants (csrc/sweep_missing_fused.cu)
MIS_QS = 32                          # response columns per slice
MIS_W = 8                            # chain window
MIS_NRH = MIS_W + MIS_W * (MIS_W - 1) // 2   # sums of one window pass
MIS_NSLOT = 2                        # warp-partial slots
MIS_NWT = 4                          # chain operand tiles per window
MIS_NWS = 3                          # window scalar sets
MIS_MAX_CLUSTER = 8                  # largest cluster the kernel takes
MIS_SPREAD = 4                       # largest cluster taken only to spread
MIS_NCLK = 11                        # the kernel's phase clock slots
MIS_CLKF = (2 * (MIS_NCLK + 2) + 3) & ~3   # with the probe's two ticks
PAIR_WINDOWS = (1, 2, 4, 8, 16, 32, 64, 128)   # the pair_bf16 windows B2 takes
MIS_KC = 16                          # samples per tensor-core step
MIS_RING_ROWS = 8 * 2 * MIS_KC       # x rows of the deep windows' rings


def pair_window(sub: int, block: int) -> int:
    """The pair_bf16 mode's window at Config.mis_sub = sub and predictor
    block `block`: min(sub, block), as the JAX kernel clips it
    (atlasqtl_tpu/ops/sweep_missing_fused.py:272-273).  Raises ValueError
    where it does not divide the block (that kernel's assert) and
    NotImplementedError for a window that is not a power of two (B2's
    instances take PAIR_WINDOWS; the mode reaches B2 only at block 128,
    whose divisors all are)."""
    s = fused_window(sub, block, "sweep_missing_fused pair_bf16", "mis_sub")
    if s not in PAIR_WINDOWS:
        raise NotImplementedError(
            f"sweep_missing_fused pair_bf16: window {s} (mis_sub={sub}) is "
            f"not a power of two; B2 takes {PAIR_WINDOWS}")
    return s


# the JAX kernel's perf probes (atlasqtl_tpu/ops/sweep_missing_fused.py:155,
# 197, 207-213): noseq and noh (one function) form no pair Gram and push
# nothing inside a window, noadv never advances Fm, noadvmask advances it
# without the mask; Z stays exact
MIS_PROBES = ("noseq", "noh", "noadv", "noadvmask")
# the probe instance's codes (csrc/sweep_missing_fused.cu); "exact" keeps
# every part, the exact function in B2's own schedule, to time the probes
# against (not a probe of the JAX kernel: the wrappers refuse it)
MIS_PROBE_CODES = {"noseq": 0, "noh": 0, "noadv": 1, "noadvmask": 2,
                   "exact": 3}
# the windows of B2's pair_bf16 probe instances, the mode's own
# (PAIR_WINDOWS); the float32 probe instance takes every window that
# divides the block (csrc/sweep_missing_fused.cu)
PROBE_WINDOWS = PAIR_WINDOWS


def probe_window(probe: str, sub: int, block: int) -> int:
    """The window of B2's perf probe `probe` at the call's sub and
    predictor block: min(sub, block), as the JAX kernel clips it; ValueError
    for an unknown probe or a window that does not divide the block (that
    kernel's assert)."""
    if probe not in MIS_PROBE_CODES:
        raise ValueError(f"unknown sweep_missing_fused probe {probe!r}: one "
                         f"of {', '.join(MIS_PROBES)} (or 'none')")
    return fused_window(sub, block, "sweep_missing_fused probe")


def _delta_rows(window: int) -> int:
    """The deltas a CTA keeps (csrc:delta_rows): one chain window's, or
    under a pair_bf16 window over 16 those of the whole window."""
    return window if window > 2 * MIS_W else MIS_W


def _probe_rows(probe: str, probe_window: int) -> int:
    """The float32 probe instance's deltas in a region of their own
    (csrc:probe_rows) under `probe` at its window: off the 8-row grid
    (neither dividing MIS_W nor a multiple of it) a ring of whole chain
    windows over its latest window + 7 rows, but for the exact sweep (B2's
    own schedule); else none (on the grid a window's deltas for its end
    term go to a workspace in device memory, `_delta_workspace`)."""
    if (MIS_PROBE_CODES.get(probe, 3) != 3 and probe_window
            and MIS_W % probe_window and probe_window % MIS_W):
        return (probe_window + 2 * MIS_W - 2) // MIS_W * MIS_W
    return 0


def _delta_workspace(probe: str, probe_window: int) -> int:
    """Floats per CTA of the float32 probe instance's deltas in device memory
    (csrc: MisProbe::dws): under noseq, noh and noadvmask at a window of J >
    2 chain windows on the 8-row grid those of its first J - 2 (the
    window's end term), else none."""
    if (MIS_PROBE_CODES.get(probe, 3) in (0, 2)
            and probe_window % MIS_W == 0 and probe_window > 2 * MIS_W):
        return (probe_window - 2 * MIS_W) * MIS_QS
    return 0


def _x_rows(rows: int, window: int) -> int:
    """The rows of one x slot (csrc:x_rows): the CTA's rows, under a
    pair_bf16 window over 16 at least the warps' cp.async rings."""
    return max(rows, MIS_RING_ROWS) if window > 2 * MIS_W else rows


def _mis_smem_bytes(on_chip: bool, nloc: int, r_aug: int,
                    window: int = 0, probe: str = "none",
                    probe_window: int = 0) -> int:
    """csrc/sweep_missing_fused.cu:smem_bytes: two sets of window operand
    tiles, two windows of gam, the deltas (`_delta_rows` of the pair_bf16
    window, 0 for float32), two sum buffers, the partial
    slots, the phase clocks, three sets of window scalars (p_mask, theta,
    rows of L), the slice's interpolation nodes; on chip also nloc rows of
    Fm (32 floats) and of mask bits; two x slots of W floats per row of
    `_x_rows` (in device memory only under a window over 16, the rings);
    under `probe` at `probe_window` the float32 probe instance's (window
    0) `_probe_rows`, from a 16-byte boundary after the mask words.  The
    card holds it to the kernel's own (`kernel_smem_bytes`)."""
    rows = nloc if on_chip else 0
    fixed = (2 * MIS_NWT * MIS_W * MIS_QS + 2 * MIS_W * MIS_QS
             + _delta_rows(window) * MIS_QS
             + 2 * MIS_NRH * MIS_QS + MIS_NSLOT * MIS_NRH * MIS_QS
             + MIS_CLKF + MIS_NWS * (2 * MIS_W + MIS_W * r_aug)
             + 3 * r_aug * MIS_QS)
    prows = 0 if window else _probe_rows(probe, probe_window)
    return 4 * (fixed + rows * (MIS_QS + 1)
                + 2 * _x_rows(rows, window) * MIS_W
                + (-(-rows // 4) * 4 - rows + prows * MIS_QS if prows else 0))


def missing_launch_plan(n: int, q: int, block: int, r_aug: int,
                        m: int = 1, window: int = 0, probe: str = "none",
                        probe_window: int = 0) -> dict:
    """The launch of B2 at (n, q, block, r + 2) for m replicas (one launch
    of grid x m CTAs; `grid` counts one replica's) of the instance at the
    pair_bf16 window `window` (0: the float32 instance; a window over 16
    keeps all its deltas on chip), under the perf probe `probe` ("none",
    or a key of MIS_PROBE_CODES) at its window `probe_window` (the float32
    probe instance keeps more deltas at some: `_probe_rows`).  The rows of
    each
    32-column slice are split over the smallest cluster (1..MIS_MAX_CLUSTER
    CTAs) whose CTAs each hold their rows of Fm on chip in at most
    SMEM_TWO_PER_SM bytes, so that two CTAs share an SM and one's chain
    overlaps the other's pass; failing that, in at most SMEM_MAX bytes (one
    per SM).  While the card would still hold one CTA per SM of a cluster
    one larger for all m replicas' slices, the cluster grows (up to
    MIS_SPREAD), so that few slices spread over more SMs.  Where no
    cluster holds the rows, the device-memory branch: Fm stays in device
    memory, one CTA per slice, two per SM (one from window 16 on, whose
    cross pairs take more registers: csrc's launch bounds).  A block over
    128 is walked in pieces of `sub_block` rows (ops/sweep_fused.py:
    sub_block); the kernel builds its pair Grams per window, so no piece
    needs anything precomputed.  Returns slice_width,
    sub_block, cluster, grid, smem_bytes, fm_on_chip, rows_per_cta,
    ctas_per_sm (the CTAs that share an SM), window, probe and
    probe_window; the C entry point takes the decisions (piece, cluster,
    fm_on_chip) and derives the rest.
    Raises ValueError on a shape the kernel does not take."""
    if (n <= 0 or block <= 0 or block % MIS_W or q % 4 or q <= 0
            or not 0 < r_aug <= 48 or m < 1):
        raise ValueError(f"sweep_missing_fused kernel: unsupported shape "
                         f"n={n}, q={q}, block={block}, r+2={r_aug}, m={m}")
    sub = sub_block(block)
    slices = -(-q // MIS_QS)
    smem = lambda cs: _mis_smem_bytes(True, -(-n // cs), r_aug, window,
                                      probe, probe_window)
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
                        rows_per_cta=-(-n // cs), ctas_per_sm=ctas,
                        window=window, probe=probe,
                        probe_window=probe_window)
    return dict(slice_width=MIS_QS, sub_block=sub, cluster=1, grid=slices,
                smem_bytes=_mis_smem_bytes(False, 0, r_aug, window, probe,
                                           probe_window),
                fm_on_chip=False, rows_per_cta=n,
                ctas_per_sm=2 if window < 2 * MIS_W else 1, window=window,
                probe=probe, probe_window=probe_window)


def window() -> int:
    """The kernel's chain window W (predictors per on-the-fly pair-Gram
    window); builds the kernel library if needed."""
    return _load().atlasqtl_sweep_missing_window()


def occupancy(plan: dict, n: int, r_aug: int) -> tuple:
    """(CTAs of B2's instance at the plan's window resident on one SM,
    clusters resident on the card) under `plan` at n samples and r + 2,
    from the occupancy calculator on the card."""
    clusters = ctypes.c_int(-1)
    ctas = _load().atlasqtl_sweep_missing_occupancy(
        n, plan["cluster"], int(plan["fm_on_chip"]), r_aug, plan["window"],
        ctypes.byref(clusters))
    return ctas, clusters.value


def kernel_smem_bytes(plan: dict, n: int, r_aug: int) -> int:
    """The kernel's own shared-memory bytes under `plan` at n samples and
    r + 2, -1 where it refuses the plan."""
    return _load().atlasqtl_sweep_missing_smem(
        n, plan["cluster"], int(plan["fm_on_chip"]), r_aug, plan["window"],
        MIS_PROBE_CODES.get(plan["probe"], -1), plan["probe_window"])


PHASES = ("prologue", "pass", "reduce", "cluster_sync", "gather", "chain",
          "x_wait", "barrier", "tail", "pairs", "total")


def phase_clocks() -> dict:
    """The SM clock cycles the latest B2 launch's first CTA spent in each
    phase (its thread 0, which also runs the chain; csrc:g_clocks):
    "pass" is its share of the window passes (under pair_bf16 at windows of
    8 and over, their float32 rows), "pairs" its share of their pair Grams
    on the tensor cores (0 in the other instances)."""
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
                              tau, c, kz, sig2_inv, *, block_size: int,
                              pair_bf16: bool = False, sub: int = 16,
                              probe: str = "none"):
    """The kernel's function in plain tensor ops, block by block in flat
    sequential order: one coordinate at a time, or under pair_bf16 in the
    JAX kernel's windows of `pair_window(sub, block_size)` predictors with
    bf16-rounded pair Grams; under a perf probe in the JAX kernel's
    windows of `probe_window(probe, sub, block_size)` with what the probe
    drops left out (pair products rounded under pair_bf16).  Same
    arguments and outputs as `sweep_missing_fused`; with a replica axis,
    one replica after another."""
    args = (x, cp_x_y, x_norm_sq, mis_pat, l_aug, n_stack, gam, mu, fitted,
            theta, p_mask, zeta, q_mask, tau, c, kz, sig2_inv)
    one, kw = _sweep_missing_plain_one, dict(block_size=block_size)
    if probe != "none":
        one = _sweep_missing_plain_windows
        kw.update(sub=probe_window(probe, sub, block_size),
                  round_pairs=pair_bf16,
                  pairs=probe not in ("noseq", "noh"),
                  advance={"noadv": None, "noadvmask": "all"}.get(
                      probe, "masked"))
    elif pair_bf16:
        one = _sweep_missing_plain_windows
        kw["sub"] = pair_window(sub, block_size)
    if gam.dim() == 3:
        return MISSING.loop(one, args, kw)
    return one(*args, **kw)


def _missing_tiles(l_blk, n_stack, u, kz, c, den):
    """The block's logit constant (with -(c/2) log(den)), Mills tiles and
    1/den (the kernel's per-(j, k) factor)."""
    u2 = u * u
    s_z = torch.sqrt(u2 + kz)
    ad = (c * (0.5 * u * torch.sqrt(u2 + K_BASE)) + l_blk @ n_stack[0]
          - 0.5 * c * torch.log(den))
    imrd = s_z + l_blk @ n_stack[1]
    imr0u = l_blk @ n_stack[2] - 0.5 * (s_z + u)
    return ad, imrd, imr0u, 1.0 / den


def _missing_block_out(out, sl, gam_b, mu_b, imrd, imr0u, p_mask, q_mask):
    """Write block sl's masked gam and mu and add its Z sums."""
    gam_out, mu_out, z_row, z_col = out
    msk = p_mask[sl, None] * q_mask[None, :]
    gam_out[sl] = gam_b * msk
    mu_out[sl] = mu_b * msk
    z = (gam_out[sl] * imrd + imr0u) * msk
    z_row[sl] = torch.sum(z, dim=1)
    z_col += torch.sum(z, dim=0)


def _missing_coordinate(j, r, cp_x_y, gam, mu, x_norm_sq, ct_i, ad_i, tau,
                        c):
    """Coordinate j's update from its projection r = x_j^T Fm: (gam, mu,
    delta)."""
    beta_old = gam[j] * mu[j]
    d = cp_x_y[j] - (r - beta_old * x_norm_sq[j])
    mu_i = ct_i * d
    gam_i = torch.sigmoid(ad_i + 0.5 * c * c * tau * (mu_i * d))
    return gam_i, mu_i, gam_i * mu_i - beta_old


def _sweep_missing_plain_one(x, cp_x_y, x_norm_sq, mis_pat, l_aug, n_stack,
                             gam, mu, fitted, theta, p_mask, zeta, q_mask,
                             tau, c, kz, sig2_inv, *, block_size):
    p = x.shape[1]
    B = block_size
    fm = fitted.clone()
    out = (torch.empty_like(gam), torch.empty_like(mu),
           torch.empty_like(theta), torch.zeros_like(zeta))
    for b in range(p // B):
        sl = slice(b * B, (b + 1) * B)
        ad, imrd, imr0u, ct = _missing_tiles(
            l_aug[sl], n_stack, theta[sl, None] + zeta[None, :], kz, c,
            x_norm_sq[sl] + sig2_inv)
        gam_b = torch.empty_like(ad)
        mu_b = torch.empty_like(ad)
        for i in range(B):
            j = b * B + i
            x_j = x[:, j]
            gam_b[i], mu_b[i], delta = _missing_coordinate(
                j, x_j @ fm, cp_x_y, gam, mu, x_norm_sq, ct[i], ad[i], tau, c)
            fm.addcmul_(mis_pat, torch.outer(x_j, delta))
        _missing_block_out(out, sl, gam_b, mu_b, imrd, imr0u, p_mask, q_mask)
    return out[0], out[1], fm, out[2], out[3]


def _pair_grams(xw, mis_pat, round_pairs, chunk=16):
    """The masked pair Grams of one window x_w (n, W): h[a, b, k] =
    sum_n m_nk x_na x_nb for b < a (round_pairs: each product rounded to
    bfloat16, the mask exact, sums in x's dtype), built `chunk` rows of a
    at a time so that a window of 128 (8128 pairs) stays small; h[a, b]
    for b >= a is not read."""
    n, W = xw.shape
    h = xw.new_zeros((W, W, mis_pat.shape[1]))
    for a0 in range(1, W, chunk):
        a1 = min(W, a0 + chunk)
        prod = xw[:, a0:a1, None] * xw[:, None, :a1 - 1]
        if round_pairs:
            prod = prod.to(torch.bfloat16).to(xw.dtype)
        h[a0:a1, :a1 - 1] = (prod.reshape(n, -1).T @ mis_pat).reshape(
            a1 - a0, a1 - 1, -1)
    return h


def _sweep_missing_plain_windows(x, cp_x_y, x_norm_sq, mis_pat, l_aug,
                                 n_stack, gam, mu, fitted, theta, p_mask,
                                 zeta, q_mask, tau, c, kz, sig2_inv, *,
                                 block_size, sub=MIS_W, round_pairs=True,
                                 pairs=True, advance="masked"):
    """The sweep in windows of `sub` predictors (a divisor of the block),
    aligned at each block's start (atlasqtl_tpu/ops/sweep_missing_fused.py:
    157-215): each window's projections against Fm advanced through the
    previous window; the corrections inside the window through the masked
    pair Grams h[a, b, k] = sum_n m_nk x_na x_nb (round_pairs: each f32
    product rounded to bfloat16, the mask exact, f32 sums); then
    Fm += M * (x_w delta_w).  In float32 (round_pairs False) it is the
    per-coordinate sweep up to rounding.  The perf probes: pairs=False
    forms no pair Gram and pushes nothing inside a window (noseq, noh);
    advance None leaves Fm as it is (noadv), "all" adds x_w delta_w
    without the mask (noadvmask)."""
    p = x.shape[1]
    B = block_size
    W = sub
    fm = fitted.clone()
    out = (torch.empty_like(gam), torch.empty_like(mu),
           torch.empty_like(theta), torch.zeros_like(zeta))
    for b in range(p // B):
        sl = slice(b * B, (b + 1) * B)
        ad, imrd, imr0u, ct = _missing_tiles(
            l_aug[sl], n_stack, theta[sl, None] + zeta[None, :], kz, c,
            x_norm_sq[sl] + sig2_inv)
        gam_b = torch.empty_like(ad)
        mu_b = torch.empty_like(ad)
        for lo in range(0, B, W):
            j0 = b * B + lo
            xw = x[:, j0:j0 + W]
            r = xw.T @ fm
            h = _pair_grams(xw, mis_pat, round_pairs) if pairs else None
            deltas = []
            for i in range(W):
                gam_b[lo + i], mu_b[lo + i], delta = _missing_coordinate(
                    j0 + i, r[i], cp_x_y, gam, mu, x_norm_sq, ct[lo + i],
                    ad[lo + i], tau, c)
                if pairs:
                    r[i + 1:] += h[i + 1:, i] * delta
                deltas.append(delta)
            if advance == "masked":
                fm += mis_pat * (xw @ torch.stack(deltas))
            elif advance == "all":
                fm += xw @ torch.stack(deltas)
        _missing_block_out(out, sl, gam_b, mu_b, imrd, imr0u, p_mask, q_mask)
    return out[0], out[1], fm, out[2], out[3]


def _sweep_missing_fused_cuda(x, cp_x_y, x_norm_sq, mis_pat, l_aug, n_stack,
                              gam, mu, fitted, theta, p_mask, zeta, q_mask,
                              tau, c, kz, sig2_inv, *, block_size, plan=None,
                              pair_bf16=False, sub=16, probe="none"):
    """Check the operands of one B2 launch, launch it and count it: the
    state's operands of `MISSING` with or without a replica axis, one
    launch of grid x m CTAs (the pair_bf16 instance at the window
    `pair_window(sub, block_size)` if pair_bf16; at window 1 the mode
    rounds no pair, and the float32 instance runs).  Under a perf probe,
    the probe instance at its window (`probe_window`): of the float32
    instance, any window that divides the block, or under pair_bf16
    (noadv, noadvmask; noseq and noh form no pair) of the pair_bf16
    instance at that window (`pair_window`'s rule).  `plan` (None:
    `missing_launch_plan` for the operands' replica count) is there only
    to compare a replica's single launch with a batched one under the
    batched launch's plan.  Raises on what the kernel cannot take and on a
    failed launch."""
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
    pcode, pwin = -1, 0   # the probe instance's code (-1: none), window
    if probe != "none":
        pcode = MIS_PROBE_CODES[probe]
        pair_bf16 = pair_bf16 and pcode > 0
        pwin = (pair_window(sub, block_size) if pair_bf16
                else probe_window(probe, sub, block_size))
    window = (pwin if pcode >= 0 else pair_window(sub, block_size)) \
        if pair_bf16 else 1
    ksub = window if window > 1 else 0   # the instance: 0 is float32
    plan = plan or missing_launch_plan(n, q, block_size, r_aug, m, ksub,
                                       probe, pwin)
    lib = _load()
    lead = (m,) if any(batched) else ()
    f32 = lambda v: as_scalar(v, torch.float32, x.device).expand(lead)
    scal = torch.stack([f32(c), f32(kz), f32(sig2_inv)], dim=-1).contiguous()
    # noadv restores Fm from fm0 where Fm is in device memory and a window
    # ends in its own pass (csrc: window_edge)
    fm0 = (fitted if not ksub and probe == "noadv" and not plan["fm_on_chip"]
           and pwin % MIS_W == 0 and pwin > 2 * MIS_W else None)
    fitted = fitted.clone()
    nws = 0 if ksub else _delta_workspace(probe, pwin)
    dws = (torch.empty(m * plan["grid"] * nws, dtype=torch.float32,
                       device=x.device) if nws else None)
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
        m, ksub, pcode, pwin, None if fm0 is None else ptr(fm0),
        dws.data_ptr() if nws else None,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"sweep_missing_fused kernel launch failed at n={n}, p={p}, "
            f"q={q}, block={block_size}, {m} replica(s), plan {plan}"
            f"{f', pair_bf16 window {window}' if pair_bf16 else ''}"
            f"{f', probe {probe} at window {pwin}' if pcode >= 0 else ''}: "
            + lib.atlasqtl_error_string(err).decode())
    sweep_missing_fused.launches += 1
    if pcode >= 0:
        sweep_missing_fused.probe.launches += 1
    elif window > 1:
        sweep_missing_fused.pair_bf16.launches += 1
    return gam_out, mu_out, fitted, z_row, z_col


def sweep_missing_fused(x, cp_x_y, x_norm_sq, mis_pat, l_aug, n_stack, gam,
                        mu, fitted, theta, p_mask, zeta, q_mask, tau, c, kz,
                        sig2_inv, *, block_size: int,
                        pair_bf16: bool = False, sub: int = 16,
                        probe: str = "none"):
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

    pair_bf16 (Config.mis_pair_bf16): the JAX kernel's windows of sub
    predictors (Config.mis_sub, clipped to the block; `pair_window` raises
    on one that does not divide it or that B2 does not take), whose pair
    products are rounded to bfloat16 before their float32 sums.

    probe: one of the JAX kernel's perf probes (`MIS_PROBES`, wrong math
    by design) in its windows of sub predictors (`probe_window`): noseq
    and noh push nothing inside a window, noadv never advances Fm,
    noadvmask advances it without the mask; pair_bf16 rounds the pairs
    noadv and noadvmask form.  sub is read only under pair_bf16 or a
    probe.

    CPU tensors run `sweep_missing_fused_plain`; CUDA tensors launch the
    kernel (csrc/sweep_missing_fused.cu; its pair_bf16 instance at the
    window if pair_bf16, but at window 1, where the mode rounds nothing;
    its probe instance under a probe) or raise.
    `sweep_missing_fused.launches` counts kernel launches (one per call,
    whatever m, any instance), `sweep_missing_fused.pair_bf16.launches`
    those of the pair_bf16 instance, `sweep_missing_fused.probe.launches`
    those of the probe instance.
    """
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"sweep_missing_fused: unsupported device {x.device}")
    if probe != "none" and probe not in MIS_PROBES:
        raise ValueError(f"unknown sweep_missing_fused probe {probe!r}: one "
                         f"of {', '.join(MIS_PROBES)} (or 'none')")
    if probe != "none":
        probe_window(probe, sub, block_size)
    fn = (_sweep_missing_fused_cuda if x.device.type == "cuda"
          else sweep_missing_fused_plain)
    return fn(x, cp_x_y, x_norm_sq, mis_pat, l_aug, n_stack, gam, mu, fitted,
              theta, p_mask, zeta, q_mask, tau, c, kz, sig2_inv,
              block_size=block_size, pair_bf16=pair_bf16, sub=sub,
              probe=probe)


sweep_missing_fused.launches = 0
sweep_missing_fused.pair_bf16 = types.SimpleNamespace(launches=0)
sweep_missing_fused.probe = types.SimpleNamespace(launches=0)


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
                               q_mask, interp_r: int = 40,
                               pair_bf16: bool = False, sub: int = 8,
                               probe: str = "none"):
    """Driver-facing wrapper matching ops/sweep.py:sweep_missing_blocked
    (sub defaults to 8, as the JAX driver's does; the fit passes
    Config.mis_sub; probe: `sweep_missing_fused`'s, which the fit never
    sets).  sig2_inv is the scalar slab precision; consts.sig2_beta is not
    read (the kernel derives the per-cell variance from x_norm_sq)."""
    return sweep_missing_fused(
        *missing_fused_operands(x, cp_x_y, x_norm_sq, mis_pat, gam, mu,
                                fitted, consts, sig2_inv, p_mask, q_mask,
                                interp_r),
        block_size=block_size, pair_bf16=pair_bf16, sub=sub, probe=probe)
