"""The staggered fused sweep: B1's function with each response slice split
into two column halves, half B lagging half A by half a step.

Counterpart of atlasqtl_tpu/ops/sweep_staggered.py.  For CUDA tensors the
sweep is the hand-written kernel in csrc/sweep_staggered.cu, which replaces
the TPU kernel atlasqtl_tpu/ops/sweep_staggered.py:_stag_kernel: four warps
run the sequential chain of one half while eight others run the other
half's fused pass over the samples, and each column's per-element formulas
are B1's, so the outputs agree with `sweep_fused`'s to f32 tolerance; the
two kernels sum their products in different orders (csrc/sweep_staggered.cu
says more).  For CPU tensors it is `sweep_staggered_plain`, the staggered
schedule in plain tensor ops, bitwise equal to `sweep_fused_plain`.

Like B1, and unlike the TPU kernel (atlasqtl_tpu/ops/sweep_staggered.py:330),
each coordinate's Gram diagonal is the true x_j^T x_j, not n_pad - 1.
"""
from __future__ import annotations

import ctypes

import torch

from .sweep_fused import (H100_SMS, _chain, _emit_block, _load, _new_outputs,
                          _outputs, _tiles, _widest_fill, fused_launch,
                          fused_operands, sub_block)

# the kernel's constants (csrc/sweep_staggered.cu)
STAG_WIDTHS = (32, 40)   # the slice widths built (two halves each)
STAG_NP = 256            # threads of the pass warps
STAG_NCH = 32            # sample rows per pass chunk
STAG_NF = 3              # F chunk stages
STAG_NX = 2              # stages of each x chunk (projected, advanced)
STAG_W = 8               # chain window
STAG_NRW = 3             # window buffers of cp and beta rows per half
STAG_PMAX = 128          # the largest piece of a block (its p_mask rows)


def _stag_smem_bytes(width: int, block: int, r_aug: int) -> int:
    """csrc/sweep_staggered.cu:smem_bytes for `width`-column slices: the
    packed Gram triangle; per half the projection (later new-gam), delta
    and logit tiles and the window tiles (corrections twice, cp and beta
    rows STAG_NRW times); the nodes; the piece's p_mask; the slice's zeta
    and q_mask; the z_col partials of the 32 tile rows; one stage area,
    which holds during a pass the F chunks (half
    width), the x chunks of both blocks (rows padded by 4) and the advance
    partials, and after it four warps' projection partials and two blocks' rows
    of L.  The card holds it to the kernel's own (`kernel_smem_bytes`)."""
    h = width // 2
    gp = (block * (block + 1) // 2 + 3) & ~3
    xl = block + 4
    pass_f = (STAG_NF * STAG_NCH * h + 2 * STAG_NX * STAG_NCH * xl
              + (STAG_NP // width) * STAG_NCH * h)
    post = 4 * 32 * 4 * (h // 2) + 2 * block * r_aug  # four warps' partials
    return 4 * (gp + 6 * block * h + 2 * (2 + 2 * STAG_NRW) * STAG_W * h
                + 3 * r_aug * width + STAG_PMAX + 2 * width
                + STAG_PMAX // 4 * width + max(pass_f, post))


def staggered_launch_plan(n: int, q: int, block: int, r_aug: int,
                          sms: int = H100_SMS) -> dict:
    """The launch of B4 at (n, q, block, r + 2) on a card of `sms` SMs, by
    B1's rule: one CTA per slice and per SM, the slice width among those
    built whose slices fill whole waves best (40 columns at q = 10000 on
    132 SMs: 250 CTAs in 2 waves), a block over 128 walked in pieces of
    `sub_block` rows, and two z_row partial rows per slice (one per half).
    Returns slice_width, sub_block, cluster, grid, waves, smem_bytes,
    ctas_per_sm and zrow_parts.  Raises ValueError on a shape the kernel
    does not take."""
    if (n <= 0 or block <= 0 or block % STAG_W or q <= 0 or q % 4
            or not 0 < r_aug <= 48):
        raise ValueError(f"sweep_staggered kernel: unsupported shape n={n},"
                         f" q={q}, block={block}, r+2={r_aug}")
    sub = sub_block(block)
    width, waves = _widest_fill(q, STAG_WIDTHS, sms)
    return dict(slice_width=width, sub_block=sub, cluster=1,
                grid=-(-q // width), waves=waves,
                smem_bytes=_stag_smem_bytes(width, sub, r_aug),
                ctas_per_sm=1, zrow_parts=2)


def occupancy(width: int, block: int, r_aug: int) -> int:
    """CTAs of B4 in `width`-column slices resident on one SM at (block,
    r + 2), from the occupancy calculator on the card."""
    return _load().atlasqtl_sweep_staggered_occupancy(width, block, r_aug)


def kernel_smem_bytes(width: int, block: int, r_aug: int) -> int:
    """The kernel's own shared-memory bytes at (width, block, r + 2), -1
    where it refuses them."""
    return _load().atlasqtl_sweep_staggered_smem(width, block, r_aug)


PHASES = ("chain_wait", "chain", "pass", "tiles", "pass_wait", "pass_sync",
          "total")


def phase_clocks() -> dict:
    """The SM clock cycles the latest B4 launch's first CTA spent in each
    phase, summed over the blocks: its chain thread (thread 0) waiting for
    a half's projections and for the block's Gram, and running the chain
    windows; its first pass thread in the passes over the samples, in the
    partial sums and tiles, waiting for a half's deltas, and (part of the
    passes) at the passes' barriers; the whole kernel
    (csrc/sweep_staggered.cu:g_clocks)."""
    out = (ctypes.c_longlong * len(PHASES))()
    err = _load().atlasqtl_sweep_staggered_clocks(out)
    if err != 0:
        raise RuntimeError("sweep_staggered clocks: "
                           + _load().atlasqtl_error_string(err).decode())
    return dict(zip(PHASES, out))


def sweep_staggered_plain(x, cp_x_y, gram_flat, l_aug, n_stack, beta, fitted,
                          theta, p_mask, zeta, q_mask, sig2_beta, tau, c, kz,
                          *, block_size: int, emit_gam_mu: bool = True,
                          c_one: bool = False):
    """The staggered schedule in plain tensor ops, one column half at a
    time (atlasqtl_tpu/ops/sweep_staggered.py:13-18): at step b,

        advance_A(b-1), chain_B(b-1), r0_A(b), advance_B(b-1), chain_A(b),
        r0_B(b), emit(b-1), buffer A's gam, mu and Z of block b,

    with step 0 running only the block-0 ops and a drain step b = nb
    running only the block nb-1 ops.  Same arguments and outputs as
    `sweep_fused`, and on the CPU bitwise equal to `sweep_fused_plain`.

    The halves split at a multiple of 64 columns (below 128 columns half A
    is empty): PyTorch's CPU elementwise kernels round differently in their
    vector loop and in its remainder (torch.sigmoid does), so each half must
    start where the full width's vector loop would be at the same column."""
    q = beta.shape[1]
    B = block_size
    nb = x.shape[1] // B
    ct = c * sig2_beta * tau
    c_inv_2s2 = c * 0.5 / sig2_beta
    fitted = fitted.clone()
    out = _new_outputs(beta, theta, emit_gam_mu)
    split = 64 * (q // 128)
    halves = (slice(0, split), slice(split, q))
    blk = lambda b: slice(b * B, (b + 1) * B)
    tiles = [None, None]   # each half's (ad, imrd, imr0u) of its block
    r = [None, None]       # each half's residual projections
    done = [None, None]    # each half's (gam, mu, delta) of its block
    buf_a = None           # half A's (gam, mu, z) of the previous block

    def probit(h, b):
        sl, hs = blk(b), halves[h]
        tiles[h] = _tiles(theta[sl, None] + zeta[None, hs], l_aug[sl],
                          n_stack[:, :, hs], c, kz, c_one)

    def r0(h, b):
        sl, hs = blk(b), halves[h]
        r[h] = (x[:, sl].T @ fitted[:, hs]
                - beta[sl, hs] * torch.diagonal(gram_flat[sl])[:, None])

    def chain(h, b):
        sl, hs = blk(b), halves[h]
        done[h] = _chain(r[h], gram_flat[sl], tiles[h][0], cp_x_y[sl, hs],
                         beta[sl, hs], ct[hs], c_inv_2s2[hs])

    def advance(h, b):
        fitted[:, halves[h]] += x[:, blk(b)] @ done[h][2]

    def z_tile(h):
        return done[h][0] * tiles[h][1] + tiles[h][2]

    for b in range(nb + 1):
        if b > 0:
            advance(0, b - 1)
            probit(1, b - 1)
            chain(1, b - 1)
        if b < nb:
            probit(0, b)
            r0(0, b)
        if b > 0:
            advance(1, b - 1)
        if b < nb:
            chain(0, b)
            r0(1, b)
        if b > 0:  # before the buffer is overwritten with block b
            gam_a, mu_a, z_a = buf_a
            _emit_block(out, blk(b - 1), torch.cat([gam_a, done[1][0]], 1),
                        torch.cat([mu_a, done[1][1]], 1),
                        torch.cat([z_a, z_tile(1)], 1), p_mask[blk(b - 1)],
                        q_mask)
        if b < nb:
            buf_a = (done[0][0], done[0][1], z_tile(0))
    return _outputs(out, fitted)


def _sweep_staggered_cuda(*args, **kw):
    out = fused_launch("atlasqtl_sweep_staggered", *args,
                       plan=staggered_launch_plan, **kw)
    sweep_fused_staggered.launches += 1
    return out


def sweep_fused_staggered(x, cp_x_y, gram_flat, l_aug, n_stack, beta, fitted,
                          theta, p_mask, zeta, q_mask, sig2_beta, tau, c, kz,
                          *, block_size: int, emit_gam_mu: bool = True,
                          c_one: bool = False):
    """One staggered sweep; the arguments and outputs of
    ops/sweep_fused.py:sweep_fused.

    CPU tensors run `sweep_staggered_plain`; CUDA tensors launch the kernel
    (csrc/sweep_staggered.cu) or raise: it takes every shape B1 takes,
    under `staggered_launch_plan`.
    `sweep_fused_staggered.launches` counts kernel launches.
    """
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"sweep_fused_staggered: unsupported device "
                         f"{x.device}")
    fn = (_sweep_staggered_cuda if x.device.type == "cuda"
          else sweep_staggered_plain)
    return fn(x, cp_x_y, gram_flat, l_aug, n_stack, beta, fitted, theta,
              p_mask, zeta, q_mask, sig2_beta, tau, c, kz,
              block_size=block_size, emit_gam_mu=emit_gam_mu, c_one=c_one)


sweep_fused_staggered.launches = 0


def sweep_complete_staggered(x, cp_x_y, gram_blocks, beta, fitted, consts,
                             block_size, p_mask=None, q_mask=None,
                             interp_r: int = 40, emit_gam_mu: bool = True,
                             annealed: bool = False):
    """Driver-facing wrapper matching ops/sweep_fused.py:sweep_complete_fused
    (annealed=False asserts c == 1)."""
    return sweep_fused_staggered(
        *fused_operands(x, cp_x_y, gram_blocks, beta, fitted, consts,
                        block_size, p_mask, q_mask, interp_r),
        block_size=block_size, emit_gam_mu=emit_gam_mu, c_one=not annealed)
