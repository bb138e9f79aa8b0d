"""Chebyshev-interpolation operands of the probit tail tiles, in PyTorch
(counterpart of atlasqtl_tpu/ops/interp.py).

The fused sweep needs three (p, q) tiles per iteration, all smooth 1-D
functions of u = theta_j + zeta_k:

  ad     = c * (d(u) - cst_k),      d(u) = log Phi(u) - log Phi(-u)
  imrd   = imr1(uc)/sqrt(c) - imr0(uc)/sqrt(c)
  imr0u  = imr0(uc)/sqrt(c) + u,    uc = sqrt(c) * u

Interpolating in the theta direction on r Chebyshev nodes spanning the
iteration's theta range gives f(theta_j + zeta_k) ~= sum_i L_ij f(x_i + zeta_k):
a (B, r+2) @ (r+2, q) product per block against tiny node-value matrices.
The unbounded growth of each function is carried by the analytic base
s(u) = sqrt(u^2 + K), evaluated per element in the kernel, so only bounded
remainders are interpolated (r = 40 keeps the truncation error near 2e-6).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .special import _MSC12, _erfcx_nr, _horner, as_scalar

K_BASE = 10.19
_INV_SQRT_2PI = 0.3989422804014327


@functools.lru_cache(maxsize=None)
def _cheb_unit(r: int, dtype, device):
    """The r first-kind Chebyshev nodes on [-1, 1] and their barycentric
    weights, built once per (r, dtype, device)."""
    k = np.arange(r)
    x01 = torch.as_tensor(np.cos(np.pi * (2 * k + 1) / (2 * r)),
                          dtype=dtype, device=device)
    w = torch.as_tensor(((-1.0) ** k) * np.sin(np.pi * (2 * k + 1) / (2 * r)),
                        dtype=dtype, device=device)
    return x01, w


def cheb_nodes(lo, hi, r: int):
    """First-kind Chebyshev nodes on [lo, hi] and their barycentric weights."""
    x01, w = _cheb_unit(r, lo.dtype, lo.device)
    return lo + (hi - lo) * (x01 + 1.0) / 2.0, w


def lagrange_matrix(theta, nodes, w):
    """Barycentric Lagrange basis L[j, i] = L_i(theta_j), shape (p, r), with
    the one-hot guard for exact node hits."""
    diff = theta[:, None] - nodes[None, :]
    hit = diff == 0.0
    c = w[None, :] / torch.where(hit, torch.ones_like(diff), diff)
    l_reg = c / torch.sum(c, dim=1, keepdim=True)
    any_hit = torch.any(hit, dim=1, keepdim=True)
    return torch.where(any_hit, hit.to(theta.dtype), l_reg)


def _remainders(u):
    """(rem_d, rem_imrd, rem_imr0) at u, in cancellation-free forms."""
    a = torch.abs(u)
    s = torch.sqrt(u * u + K_BASE)
    s_min_a = K_BASE / (s + a)                           # s - a
    e = _erfcx_nr(a * 0.7071067811865476)                # erfcx(a/sqrt2)
    g = torch.exp(-0.5 * a * a)
    phi_lo = 0.5 * e * g                                 # Phi(-a)
    m_large = _INV_SQRT_2PI * g / (1.0 - phi_lo)         # pdf/Phi(a)
    t = 1.0 / (1.0 + 0.5 * a)
    corr = _horner(_MSC12, (t - 0.047619047619047616)
                   * (2.0 / 0.9523809523809523) - 1.0)   # m_small(a) - a
    psi = -torch.log(0.5 * e) + torch.log1p(-phi_lo)     # d_abs - a^2/2
    rem_d = torch.sign(u) * (psi - 0.5 * a * s_min_a)
    rem_imrd = corr + m_large - s_min_a
    pos = u >= 0
    rem_imr0 = (0.5 * s_min_a - torch.where(pos, a + corr, m_large)
                + torch.where(pos, a, torch.zeros_like(a)))
    return rem_d, rem_imrd, rem_imr0


def tail_interp_operands(theta, zeta, cst, c, p_mask, r: int = 40):
    """The kernel's interpolation operands for one iteration.

    Returns (l_aug, n_stack, kz):
      l_aug   (p, r + 2): [L(theta) | ones | theta]
      n_stack (3, r + 2, q): row blocks for ad / imrd / imr0u so that
              tile = l_aug @ n_stack[i] + the in-kernel sqrt base;
      kz      0-d K/c for the Z base sqrt(u^2 + K/c).
    """
    dt = theta.dtype
    q = zeta.shape[0]
    c = as_scalar(c, dt, theta.device)
    sqrt_c = torch.sqrt(c)
    th_real = torch.where(p_mask > 0, theta, torch.zeros_like(theta))
    lo = torch.min(th_real)
    hi = torch.max(th_real)
    ctr = 0.5 * (lo + hi)
    half = torch.clamp(0.5 * (hi - lo), min=0.25)
    nodes, w = cheb_nodes(ctr - half, ctr + half, r)

    l_mat = lagrange_matrix(theta, nodes, w)
    l_aug = torch.cat([l_mat, torch.ones_like(theta)[:, None], theta[:, None]],
                      dim=1)

    u_nodes = nodes[:, None] + zeta[None, :]
    rem_d, _, _ = _remainders(u_nodes)
    _, rem_imrd_c, rem_imr0_c = _remainders(sqrt_c * u_nodes)

    zrow = torch.zeros((1, q), dtype=dt, device=theta.device)
    n_ad = torch.cat([c * rem_d, -c * cst[None, :], zrow])
    n_imrd = torch.cat([rem_imrd_c / sqrt_c, zrow, zrow])
    n_imr0u = torch.cat([rem_imr0_c / sqrt_c, zeta[None, :],
                         torch.ones_like(zrow)])
    return l_aug, torch.stack([n_ad, n_imrd, n_imr0u]), K_BASE / c
