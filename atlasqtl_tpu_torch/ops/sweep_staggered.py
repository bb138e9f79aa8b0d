"""The staggered fused sweep: B1's function with each response slice split
into two column halves, half B lagging half A by half a step.

Counterpart of atlasqtl_tpu/ops/sweep_staggered.py.  For CUDA tensors the
sweep is the hand-written kernel in csrc/sweep_staggered.cu, which replaces
the TPU kernel atlasqtl_tpu/ops/sweep_staggered.py:_stag_kernel: one warp
runs the sequential chain of one half while the other warps run the other
half's products, and each column's operations are B1's, in B1's order, so
the outputs are bitwise equal to `sweep_fused`'s (csrc/sweep_staggered.cu
says more).  For CPU tensors it is `sweep_staggered_plain`, the staggered
schedule in plain tensor ops, bitwise equal to `sweep_fused_plain`.

Like B1, and unlike the TPU kernel (atlasqtl_tpu/ops/sweep_staggered.py:330),
each coordinate's Gram diagonal is the true x_j^T x_j, not n_pad - 1.
"""
from __future__ import annotations

import torch

from .sweep_fused import (_chain, _emit_block, _new_outputs, _outputs,
                          _tiles, fused_launch, fused_operands)


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
    out = fused_launch("atlasqtl_sweep_staggered", *args, **kw)
    sweep_fused_staggered.launches += 1
    return out


def sweep_fused_staggered(x, cp_x_y, gram_flat, l_aug, n_stack, beta, fitted,
                          theta, p_mask, zeta, q_mask, sig2_beta, tau, c, kz,
                          *, block_size: int, emit_gam_mu: bool = True,
                          c_one: bool = False):
    """One staggered sweep; the arguments and outputs of
    ops/sweep_fused.py:sweep_fused.

    CPU tensors run `sweep_staggered_plain`; CUDA tensors launch the kernel
    (csrc/sweep_staggered.cu) or raise: it takes every shape B1 takes.
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
