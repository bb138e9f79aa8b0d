"""Global-local (horseshoe) CAVI in PyTorch — the product inference path
(counterpart of atlasqtl_tpu/models/global_local.py): complete data, and
missing values in Y either imputed (q(y_mis) moments folded into the
complete-data statistics) or handled exactly (masked statistics, per-(j, k)
slab variance).

One function per CAVI iteration with the reference's update order (the step
numbers below mirror R/atlasqtl_global_local_core.R:125-338), a blocked
sweep instead of the C++ Gauss-Seidel loop, and masked reductions so the
padding never leaks into the math.
"""
from __future__ import annotations

import functools
import logging
from typing import NamedTuple

import numpy as np
import torch

from ..types import Config, Data, Hyper, VBState
from ..ops import elbo as elbo_ops
from ..ops import updates as upd
from ..ops.horseshoe import lam2_inv_annealed, lam2_inv_exact
from ..ops.special import as_scalar, log_ndtr_both, q_approx
from ..ops.sweep import (SweepConsts, mis_pair_gram, sweep_complete,
                         sweep_missing, sweep_missing_blocked)
from ..ops.sweep_fused import (FUSED, fused_operands, fused_window,
                               lookahead_gram, probe_parts,
                               sweep_complete_fused, sweep_fused)
from ..ops.sweep_pallas import sweep_complete_pallas
from ..ops.sweep_staggered import sweep_complete_staggered
from ..ops.sweep_missing_fused import (MISSING, missing_fused_operands,
                                       pair_window, sweep_missing_fused,
                                       sweep_missing_fused_driver)
from ..parallel.mesh import has_p, p_sum, q_sum
from ..parallel.pipeline import pipelined_sweep_2d, pipelined_sweep_missing_2d

log = logging.getLogger("atlasqtl_tpu_torch")


def _round_up(v, m):
    return ((v + m - 1) // m) * m


def check_config(cfg: Config):
    """Reject the options the port cannot take.  The TPU scheduling fields
    are ignored but for sweep_lookahead, which B1 honours under mxu_bf16
    (in float32 it is the baseline's algebra), and sweep_sub, the window
    of B1's perf probes; mxu_bf16 and mis_pair_bf16 reach B1 and B2
    (types.py:Config).  sweep_probe is "none" or one of the JAX kernel's
    eleven probes (ops/sweep_fused.py:PROBES), else ValueError; it reaches
    B1 where `_b1_probe` says.  Under mis_pair_bf16 at block_size 128, the
    one block where the flag reaches B2, the JAX kernel's window mis_sub
    must divide the block (ops/sweep_missing_fused.py:pair_window raises
    ValueError, as the JAX kernel's assert does).  The mesh axes q_axis and
    p_axis come from atlasqtl(mesh=...) (parallel/mesh.py)."""
    if cfg.sweep not in ("auto", "fused", "pallas", "xla"):
        raise ValueError(f"unknown Config.sweep={cfg.sweep!r}")
    if cfg.sweep_probe != "none":
        probe_parts(cfg.sweep_probe)
    if cfg.mis_pair_bf16 and cfg.block_size == 128:
        pair_window(cfg.mis_sub, cfg.block_size)


def build_data(x_np, y_np, cfg: Config, device, q_pad_to: int = 8,
               p_shards: int = 1, q_shards: int = 1) -> Data:
    """Pad to n -> 8, p -> block x p_shards, q -> q_pad_to and precompute
    the sufficient statistics on `device`
    (R/atlasqtl_global_local_core.R:19-42).  NaN in Y marks a missing cell;
    cfg.missing chooses how the fit treats them.  p_shards: a 2-D mesh's
    p-shards each hold whole predictor blocks; q_shards: the mesh's
    q-shards, whose local q decides where the bf16 flags reach
    (`_b1_bf16`)."""
    n, p = x_np.shape
    q = y_np.shape[1]
    block = min(cfg.block_size, _round_up(p, 8))
    p_pad = _round_up(p, block * p_shards)
    q_pad = _round_up(q, q_pad_to)
    # padded samples are all-zero rows: they add nothing to any statistic
    # and the n of the update formulas stays the true n
    n_pad = _round_up(n, 8)
    dt = cfg.dtype
    x = np.zeros((n_pad, p_pad), dtype=np.float64)
    x[:n, :p] = x_np
    y = np.zeros((n_pad, q_pad), dtype=np.float64)
    y[:n, :q] = y_np

    n_mis = np.zeros(q_pad)
    n_eff = np.full(q_pad, float(n))
    mis_pat = None
    if np.isnan(y).any():
        mis_pat = (~np.isnan(y)).astype(np.float64)
        mis_pat[:n, q:] = 1.0  # padded responses behave as fully observed
        mis_pat[n:, :] = 0.0   # padded samples are never observed
        y = np.nan_to_num(y, nan=0.0)
        if cfg.missing == "impute":
            # complete-data formulas with the q(y_mis) moments folded in;
            # n_eff stays the full n
            n_mis[:q] = n - mis_pat[:n, :q].sum(axis=0)
        else:
            n_eff = mis_pat.sum(axis=0)
            n_eff[q:] = float(n)
    exact = mis_pat is not None and cfg.missing == "exact"

    t = lambda a: torch.as_tensor(a, dtype=dt, device=device)
    xd, yd = t(x), t(y)
    md = None if mis_pat is None else t(mis_pat)
    x_norm_sq = (xd * xd).T @ md if exact else None
    pair_gram = None
    if (exact and cfg.mis_block > 1
            and not _missing_uses_kernel(cfg, xd.device)):
        # the B2 kernel builds its pair Grams per window on the fly; the
        # plain blocked engine needs them precomputed, (B-1)/2 p q floats
        if p_pad % cfg.mis_block == 0:
            pair_gram = mis_pair_gram(xd, md, cfg.mis_block)
        else:
            log.warning("mis_block=%d does not divide the padded p=%d; "
                        "falling back to the per-coordinate missing-data "
                        "scan", cfg.mis_block, p_pad)
    p_mask = np.zeros(p_pad); p_mask[:p] = 1.0
    q_mask = np.zeros(q_pad); q_mask[:q] = 1.0
    scalar = lambda v: torch.tensor(float(v), dtype=dt, device=device)
    # B1's bf16 operand, rounded once per fit (round to nearest even), and
    # the lookahead's off-diagonal Gram blocks, also once per fit
    b1_bf16 = not exact and _b1_bf16(cfg, xd.device, n_pad,
                                     q_pad // q_shards)
    x_bf16 = xd.to(torch.bfloat16) if b1_bf16 else None
    goff = (lookahead_gram(xd, block) if b1_bf16 and cfg.sweep_lookahead
            else None)
    return Data(
        x=xd, y=yd, cp_x_y=xd.T @ yd, y_norm_sq=torch.sum(yd * yd, dim=0),
        mis_pat=md, x_norm_sq=x_norm_sq, n_eff=t(n_eff), n_mis=t(n_mis),
        p_mask=t(p_mask), q_mask=t(q_mask), n=scalar(n), p_true=scalar(p),
        q_true=scalar(q), mis_pair_gram=pair_gram, x_bf16=x_bf16, goff=goff)


def build_hyper(hs, q_pad: int, cfg: Config, device) -> Hyper:
    """Pad the (q,)-shaped hyperparameters; padded entries are benign
    (eta=kappa=1, n0=0) and masked out of every reduction."""
    dt = cfg.dtype

    def padv(v, fill):
        out = np.full(q_pad, fill, dtype=np.float64)
        out[:hs.q] = v
        return torch.as_tensor(out, dtype=dt, device=device)

    scalar = lambda v: torch.tensor(float(v), dtype=dt, device=device)
    return Hyper(eta=padv(hs.eta, 1.0), kappa=padv(hs.kappa, 1.0),
                 n0=padv(hs.n0, 0.0), nu=scalar(hs.nu), rho=scalar(hs.rho),
                 t02=scalar(hs.t02), m0=scalar(hs.m0),
                 a2_inv=scalar(hs.a2_inv))


def build_state(init, data: Data, cfg: Config) -> VBState:
    """Assemble the padded VBState from an InitSpec and compute the carried
    F = X beta, masked on the exact-missing path
    (R/atlasqtl_global_local_core.R:112-115)."""
    dt = cfg.dtype
    dev = data.x.device
    p_pad = data.x.shape[1]
    q_pad = data.y.shape[1]
    p, q = init.p, init.q

    def pad2(a, fill=0.0):
        out = np.full((p_pad, q_pad), fill, dtype=np.float64)
        out[:p, :q] = a
        return out

    def pad1(a, size, fill):
        out = np.full(size, fill, dtype=np.float64)
        out[:len(a)] = a
        return out

    exact = data.x_norm_sq is not None
    t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
    gam = pad2(init.gam_vb)
    mu = pad2(init.mu_beta_vb)
    init_s2b = np.asarray(init.sig2_beta_vb)
    if init_s2b.ndim == 2:  # per-(j, k) values from an exact-missing run
        sig2_beta = pad2(init_s2b, fill=1.0)
        sig2_beta = t(sig2_beta) if exact else t(sig2_beta.mean(axis=0))
    else:
        sig2_beta = t(pad1(init_s2b, q_pad, 1.0))
        if exact:  # the exact path carries a (p, q) slab variance
            sig2_beta = sig2_beta[None, :].expand(p_pad, q_pad).contiguous()
    beta = t(gam * mu)
    fitted = data.x @ beta
    colstats = (None, None, None)
    if exact:
        fitted = fitted * data.mis_pat
        beta = None
    else:
        colstats = (t(gam.sum(0)), t(np.einsum("pq,pq->q", mu * mu, gam)),
                    t(np.einsum("pq,pq->q", gam * mu, gam * mu)))
    return VBState(
        gam_colsum=colstats[0], mu2gam_colsum=colstats[1],
        beta2_colsum=colstats[2],
        beta=beta, gam=t(gam), mu_beta=t(mu), sig2_beta=sig2_beta,
        tau=t(pad1(init.tau_vb, q_pad, 1.0)), sig2_inv=t(1e-2),
        theta=t(pad1(init.theta_vb, p_pad, 0.0)),
        zeta=t(pad1(init.zeta_vb, q_pad, 0.0)),
        sig02_inv=t(init.sig02_inv_vb), lam2_inv=t(np.ones(p_pad)),
        sig2_theta=t(pad1(init.sig2_theta_vb, p_pad, 1.0)),
        fitted=fitted,
        l_vb=t(np.ones(p_pad)), rho_xi_inv=t(1.0), nu_s0_vb=t(1.0),
        rho_s0_vb=t(1.0))


def _host_rule_tau(data: Data) -> float:
    """The initial residual precision by the host rule
    (inference/elicitation.py:auto_set_init, as the R reference): 1 over
    the median of the per-response sample variances (ddof 1) over the true
    rows and observed cells, 1e3 where that is not finite.  The variances
    are taken on the device in float64; only the (q,) vector comes to the
    host for NumPy's nanmedian.  (The JAX package's device init takes the
    variance over the padded rows with missing cells zeroed instead:
    ROADMAP.md C4.)"""
    n = int(round(float(data.n)))
    q = int(round(float(data.q_true)))
    y = data.y[:n, :q].to(torch.float64)
    if data.mis_pat is None:
        obs = torch.ones_like(y)
    else:
        obs = data.mis_pat[:n, :q].to(torch.float64)
    cnt = obs.sum(dim=0)
    mean = (y * obs).sum(dim=0) / cnt
    ss = (obs * (y - mean[None, :]) ** 2).sum(dim=0)
    var = torch.where(cnt > 1.0, ss / (cnt - 1.0),
                      torch.full_like(ss, float("nan")))
    with np.errstate(divide="ignore"):
        med_var = float(np.nanmedian(var.cpu().numpy()))
        tau = 1.0 / med_var
    return tau if np.isfinite(tau) else 1e3


def _gamma_large(shape_param, size, dt, dev, gen):
    """Gamma(a, 1) ~= N(a, sqrt(a)) for a large shape a, floored at a / 10
    (atlasqtl_tpu/models/global_local.py:_gamma_large)."""
    z = torch.randn(size, dtype=dt, device=dev, generator=gen)
    g = shape_param + torch.sqrt(shape_param) * z
    return torch.maximum(g, 0.1 * shape_param)


def auto_init_device(seed, data: Data, p0, shr_fac_inv: float, cfg: Config,
                     generator=None) -> VBState:
    """Random initial state drawn on the data's device (counterpart of
    atlasqtl_tpu/models/global_local.py:220-318 auto_init_device): the
    sampling distributions of inference/elicitation.py:auto_set_init
    (R/set_hyper_init.R:356-418), drawn in cfg.dtype from a
    torch.Generator on that device seeded with `seed` (`generator`, if
    given, is used as it is), so no (p, q) array is made on the host.
    Returns the fields, shapes and dtypes build_state returns for the same
    data and cfg (complete data, impute and exact missing).  tau takes the
    host rule (`_host_rule_tau`, ROADMAP.md C4).

    Draws: gam = Phi(n0 + (s02 + t02) Z); mu = Z; sig2_beta = 1 / (g2
    sig2_inv tau), g2 ~ Gamma(2, 1) a sum of two exponentials; sig02_inv
    and the Gamma of sig2_theta by their normal approximation for a large
    shape; theta ~ N(0, 1 / (sig02_inv shr)); zeta ~ N(n0, t02)."""
    from ..inference.elicitation import get_n0_t02

    dt = cfg.dtype
    dev = data.x.device
    gen = generator
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    p_true = int(round(float(data.p_true)))
    q_true = int(round(float(data.q_true)))
    n0_vec, t02 = get_n0_t02(1, p_true, p0)
    n0 = float(n0_vec[0])
    s02 = 1e-4
    sig2_inv0 = 1e-2
    tau0 = _host_rule_tau(data)

    p_pad, q_pad = data.x.shape[1], data.y.shape[1]
    pm, qm = data.p_mask, data.q_mask
    cell = pm[:, None] * qm[None, :]
    randn = lambda *size: torch.randn(size, dtype=dt, device=dev,
                                      generator=gen)
    gam = randn(p_pad, q_pad).mul_(s02 + t02).add_(n0)
    gam = torch.special.ndtr(gam, out=gam).mul_(cell)
    mu = randn(p_pad, q_pad).mul_(cell)
    del cell
    tau = torch.full((q_pad,), tau0, dtype=dt, device=dev)
    tiny = torch.finfo(dt).tiny
    u = torch.rand((2, q_pad), dtype=dt, device=dev,
                   generator=gen).clamp_(min=tiny)
    g2 = -torch.log(u[0]) - torch.log(u[1])
    # R: 1 / rgamma(shape = 2, rate = 1 / (sig2_inv tau))
    sig2_beta = 1.0 / (g2 * (sig2_inv0 * tau))
    shape0 = torch.full((), float(max(p_true, q_true)), dtype=dt, device=dev)
    sig02_inv = _gamma_large(shape0, (), dt, dev, gen)
    theta = randn(p_pad) / torch.sqrt(sig02_inv * shr_fac_inv) * pm
    sig2_theta = 1.0 / (q_true + _gamma_large(sig02_inv * shr_fac_inv,
                                              (p_pad,), dt, dev, gen))
    zeta = (n0 + float(np.sqrt(t02)) * randn(q_pad)) * qm

    exact = data.x_norm_sq is not None
    beta = gam * mu
    fitted = data.x @ beta
    colstats = (None, None, None)
    if exact:
        fitted = fitted * data.mis_pat
        beta = None
        sig2_beta = sig2_beta[None, :].expand(p_pad, q_pad).contiguous()
    else:
        colstats = (torch.sum(gam, dim=0), torch.sum(beta * mu, dim=0),
                    torch.sum(beta * beta, dim=0))
    one = lambda *size: torch.ones(size, dtype=dt, device=dev)
    return VBState(
        gam_colsum=colstats[0], mu2gam_colsum=colstats[1],
        beta2_colsum=colstats[2], beta=beta, gam=gam, mu_beta=mu,
        sig2_beta=sig2_beta, tau=tau,
        sig2_inv=torch.full((), sig2_inv0, dtype=dt, device=dev),
        theta=theta, zeta=zeta, sig02_inv=sig02_inv, lam2_inv=one(p_pad),
        sig2_theta=sig2_theta, fitted=fitted, l_vb=one(p_pad),
        rho_xi_inv=one(), nu_s0_vb=one(), rho_s0_vb=one())


def data_block(cfg: Config, data: Data) -> int:
    """The predictor block build_data padded p with (reads the true p from
    the device once: a fit computes it before its first iteration and
    passes it on)."""
    p_true = int(round(float(data.p_true)))
    return min(cfg.block_size, _round_up(p_true, 8))


def divisor_block(block_size: int, p_pad: int) -> int:
    """Largest multiple-of-8 block <= block_size dividing p_pad (the ELBO's
    blocked pass only tiles the zero-masked padded p axis)."""
    b = min(block_size, p_pad)
    while p_pad % b:
        b -= 8
    return b


def fused_q_tile(n: int, q_pad: int, block: int = 128):
    """The response tile of the JAX package's fused complete-data kernel
    at n padded samples and q_pad (local) responses, None where it finds
    none: a copy of atlasqtl_tpu/models/global_local.py:_fused_q_tile, its
    budget formula and candidates as they are.  It states where the
    reference runs its fused kernel, and so where the flags that only that
    kernel reads (mxu_bf16, sweep_lookahead) and its staggered sibling
    (sweep_stagger, from a tile of 256) apply; it is no memory model of
    the card.  At the sizes fits run it comes to a q_pad that is a multiple
    of 128, and, for a tile of 256, to a multiple of 256 with n up to
    about 91k."""
    budget = max(128, int(95e6 / (4 * (n + 13 * block))) // 128 * 128)
    for cand in (5120, 2560, 2048, 1024, 512, 256, 128):
        if cand <= budget and q_pad % cand == 0:
            return cand
    return None


def mis_fused_q_tile(n: int, q_pad: int, block: int = 128):
    """The response tile of the JAX package's fused exact-missing kernel,
    None where it finds none: a copy of atlasqtl_tpu/models/
    global_local.py:_mis_fused_q_tile (where mis_pair_bf16 applies; a q_pad
    that is a multiple of 128)."""
    budget = max(128, int(28e6 / (4 * (2 * n + 7 * block))) // 128 * 128)
    for cand in (2048, 1024, 512, 256, 128):
        if cand <= budget and q_pad % cand == 0:
            return cand
    return None


def _at(data: Data):
    """(device, padded n, local padded q) of `data`: on a mesh rank its y
    is the rank's q-shard."""
    return data.x.device, data.x.shape[0], data.y.shape[1]


def _select_sweep(cfg: Config, data: Data) -> str:
    """The complete-data engine, chosen as atlasqtl_tpu's _select_sweep
    chooses it: "fused" (B1, or B4 under cfg.sweep_stagger where
    `_stagger` says) for float32 on CUDA; else "pallas" (the B3 inner
    kernel) when cfg.use_pallas; else the plain blocked sweep ("xla").  An
    explicit cfg.sweep passes through: sweep="fused" on the CPU runs the
    kernel's plain version, and sweep="pallas" on the CPU runs B3's plain
    version.  JAX's third case, float32 on an accelerator whose fused
    kernel finds no q tile (`fused_q_tile`), runs B1 in float32 here: B1
    takes every padded q and computes the same function up to rounding,
    but there the flags of JAX's fused kernel (mxu_bf16, sweep_lookahead,
    sweep_stagger) do not apply.  Under a mesh (cfg.q_axis) the engine is
    B1 or the plain sweep, never B3 or B4: sweep="pallas", use_pallas and
    sweep_stagger apply to one device only
    (atlasqtl_tpu/models/global_local.py:422, 553-566)."""
    return _complete_impl(cfg, data.x.device)


def _complete_impl(cfg: Config, device) -> str:
    impl = cfg.sweep
    if cfg.q_axis is not None:
        on_card = torch.device(device).type == "cuda"
        return ("fused" if impl == "fused" or (
            impl == "auto" and cfg.block_size >= 8
            and cfg.dtype == torch.float32 and on_card) else "xla")
    if impl == "auto":
        if cfg.block_size < 8:
            return "xla"  # batch="0" reference mode
        if (cfg.dtype == torch.float32
                and torch.device(device).type == "cuda"):
            return "fused"
        return "pallas" if cfg.use_pallas else "xla"
    return impl


def _stagger(cfg: Config, n: int, q: int) -> bool:
    """Whether cfg.sweep_stagger turns the "fused" engine into B4: on one
    device, without a perf probe, and only where the JAX package's fused
    tile at (n, q) is at least 256 (atlasqtl_tpu/models/
    global_local.py:555-557); elsewhere B1 runs, and honours mxu_bf16 (and
    the probe) as JAX's fused kernel does (:566-578)."""
    tile = fused_q_tile(n, q)
    return (cfg.sweep_stagger and cfg.q_axis is None and tile is not None
            and tile >= 256 and cfg.sweep_probe == "none")


def _b1_probe(cfg: Config, device, n: int, q: int) -> bool:
    """Whether cfg.sweep_probe reaches B1 (its probe instance) at n padded
    samples and the padded q: only where the JAX package passes it to its
    fused kernel (atlasqtl_tpu/models/global_local.py:566-578): one
    device (its sharded call, :700-715, and its 2-D pipeline do not take
    it), the "fused" engine (B1: under a probe sweep_stagger does not take
    B4, `_stagger`), complete data or impute, and a q where the JAX
    kernel finds a tile (`fused_q_tile`).  Elsewhere (the B3 route, the
    plain engine, the exact-missing path, a mesh, no tile) the probe is
    ignored, as in the JAX package."""
    return (cfg.sweep_probe != "none" and cfg.q_axis is None
            and _complete_impl(cfg, device) == "fused"
            and fused_q_tile(n, q) is not None)


def _fused_sub(cfg: Config, n: int, block: int) -> int:
    """The probes' chain window: cfg.sweep_sub, or 8 at n padded samples up
    to 2048 and 32 above (atlasqtl_tpu/models/global_local.py:357-361
    _fused_sub), clipped to the block; ValueError where it does not divide
    it (ops/sweep_fused.py:fused_window)."""
    return fused_window(cfg.sweep_sub or (8 if n <= 2048 else 32), block)


def _b1_bf16(cfg: Config, device, n: int, q: int) -> bool:
    """Whether cfg.mxu_bf16 reaches B1 on complete data and impute at n
    padded samples and a local padded q: only where B1 (not B4, B3 or the
    plain sweep) is the engine and the JAX package's fused kernel, the one
    engine of its that reads the flag, finds a q tile (`fused_q_tile`, on
    a mesh of the per-shard q, atlasqtl_tpu/models/global_local.py:
    418-421, 700; its 2-D pipeline's fused tiles are the same multiples of
    128, atlasqtl_tpu/parallel/pipeline.py:78-80).  Where the tile is
    missing, B1 runs the float32 function, an explicit sweep="fused" too
    (JAX's own call fails there: its tile is None at :555)."""
    return (cfg.mxu_bf16 and _complete_impl(cfg, device) == "fused"
            and fused_q_tile(n, q) is not None and not _stagger(cfg, n, q))


def _b1_lookahead(cfg: Config, device, n: int, q: int) -> bool:
    """Whether cfg.sweep_lookahead reaches B1: only under mxu_bf16 where it
    reaches B1 (`_b1_bf16`), where the JAX kernel's lookahead schedule
    computes another function (atlasqtl_tpu/ops/sweep_fused.py:166-184,
    378-388); in float32 it is the baseline's algebra, which B1 runs.  The
    JAX package passes the flag to its fused kernel alone
    (atlasqtl_tpu/models/global_local.py: 576, and on a 1-D mesh :712), as
    this one to B1 alone; its 2-D pipeline's tile processor does not take
    it (atlasqtl_tpu/parallel/pipeline.py:110-140), nor does the port's.
    Where a perf probe reaches B1 (`_b1_probe`) the lookahead is off
    (atlasqtl_tpu/ops/sweep_fused.py:669)."""
    return (cfg.sweep_lookahead and cfg.p_axis is None
            and _b1_bf16(cfg, device, n, q)
            and not _b1_probe(cfg, device, n, q))


def _missing_uses_kernel(cfg: Config, device) -> bool:
    """Whether the exact-missing sweep goes through B2: its kernel for
    float32 on CUDA (which raises on a predictor block it cannot take, as
    B1 does), or sweep="fused" anywhere (the kernel's plain version on the
    CPU), at any block of 8 or more.  In float32 B2 is the JAX package's
    blocked engine up to rounding, so it also runs at the blocks where
    the JAX package would not take its fused kernel; cfg.mis_pair_bf16
    reaches it only where that kernel would run (`_b2_pair_bf16`).
    Otherwise (float64, the CPU, sweep="xla", or a block under 8 as
    batch="0" sets, which the reference never sends to its fused kernel:
    atlasqtl_tpu/models/global_local.py:390-404) the plain engines run:
    blocked when pair Grams were precomputed, else one coordinate at a
    time."""
    if cfg.block_size < 8:
        return False
    if cfg.sweep == "fused":
        return True
    return (cfg.sweep == "auto" and cfg.dtype == torch.float32
            and torch.device(device).type == "cuda")


def _b2_pair_bf16(cfg: Config, data: Data) -> bool:
    """Whether cfg.mis_pair_bf16 reaches B2: only where the JAX package
    sends the exact-missing sweep to its fused kernel, the one engine of
    its that reads the flag (atlasqtl_tpu/models/global_local.py:396-401),
    condition for condition: no mesh (the JAX package never takes its
    fused missing kernel under one, :396);
    cfg.sweep "auto" or "fused" and float32 (`_engine` gives B2 and the
    dtype is float32; the CPU runs B2's plain version, the port's stand-in
    for a kernel there); cfg.block_size == 128 and the padded p a multiple
    of 128 (build_data pads p to min(block_size, round_up(p, 8)), so p = 75
    pads to 80 and fails); and a q tile of JAX's kernel at the padded n
    and q (`mis_fused_q_tile`: a padded q that is a multiple of 128, which
    build_data's default padding to 8 gives only where q already is one).
    Elsewhere the JAX package runs its blocked or scan engine, whose
    float32 fit the flag leaves as it is, and so does the port."""
    _, n, q = _at(data)
    return (cfg.mis_pair_bf16 and cfg.q_axis is None
            and cfg.dtype == torch.float32
            and _engine(cfg, data) == "b2" and cfg.block_size == 128
            and data.x.shape[1] % 128 == 0
            and mis_fused_q_tile(n, q) is not None)


def _select_missing_sweep(cfg: Config, data: Data) -> str:
    """The exact-missing engine: "fused" (B2), "blocked" (pair Grams
    precomputed) or "scan" (one coordinate at a time), chosen from the
    configuration as atlasqtl_tpu's _select_missing_sweep chooses it."""
    if _missing_uses_kernel(cfg, data.x.device):
        return "fused"
    return "blocked" if data.mis_pair_gram is not None else "scan"


def _engine(cfg: Config, data: Data) -> str:
    """The sweep engine of an iteration on this configuration: "b2",
    "blocked" or "scan" on the exact-missing path; "b1", "b4", "pallas"
    (the B3 route) or "xla" (the plain blocked sweep) on complete data and
    impute.  Only "b1" and "b2" take a replica axis."""
    if data.x_norm_sq is not None:
        engine = _select_missing_sweep(cfg, data)
        return "b2" if engine == "fused" else engine
    impl = _select_sweep(cfg, data)
    if impl == "fused":
        _, n, q = _at(data)
        return "b4" if _stagger(cfg, n, q) else "b1"
    return impl


# ------------------------------------------------------------ one iteration

def _colsum_stats(data: Data, state: VBState, use_cached: bool = True):
    """Masked column statistics shared by the tau/sigma updates.  Complete
    data and impute mode: the gam and beta sums come from the sweep that
    produced `state` (or build_state).  Exact missing data, or
    use_cached=False (an ELBO that re-accumulates in its own dtype):
    recomputed from the (p, q) state, and m2b = (mu^2 + s2) gam and beta =
    gam mu are returned too for the x_norm_sq-weighted sums (m2b is None
    for a (q,) slab variance; both None from the cached sums).  On a 2-D
    mesh the recomputed sums are summed over the p-shards (the cached ones
    were, by the sweep)."""
    yf_colsum = torch.einsum("nq,nq->q", data.y, state.fitted)
    ff_colsum = torch.einsum("nq,nq->q", state.fitted, state.fitted)
    if use_cached and state.gam_colsum is not None:
        m2b_colsum = state.mu2gam_colsum + state.sig2_beta * state.gam_colsum
        return (state.gam_colsum, m2b_colsum, state.beta2_colsum, yf_colsum,
                ff_colsum, None, None)
    gam = state.gam  # masked by the sweep that produced it
    beta = gam * state.mu_beta
    gam_colsum = torch.sum(gam, dim=0)
    if state.sig2_beta.dim() == 1:
        m2b = None
        m2b_colsum = (torch.einsum("pq,pq->q", state.mu_beta * state.mu_beta,
                                   gam) + state.sig2_beta * gam_colsum)
    else:
        m2b = (state.mu_beta * state.mu_beta + state.sig2_beta) * gam
        m2b_colsum = torch.sum(m2b, dim=0)
    gam_colsum, m2b_colsum, beta2_colsum = p_sum(data.mesh, torch.stack(
        [gam_colsum, m2b_colsum, torch.einsum("pq,pq->q", beta, beta)]))
    return (gam_colsum, m2b_colsum, beta2_colsum, yf_colsum, ff_colsum, m2b,
            beta)


def cavi_iteration(data: Data, hyper: Hyper, state: VBState, gram_blocks, c,
                   c_s, *, cfg: Config, annealed: bool, lite: bool = False,
                   block: int | None = None) -> VBState:
    """One CAVI iteration (the reference's _cavi_iteration_impl), update
    order identical to R/atlasqtl_global_local_core.R:125-338: the
    pre-sweep updates, the sweep, the post-sweep updates
    (`cavi_iteration_replicas` composes the same pieces around one batched
    sweep of several states).

    lite=True (fused engine only): the sweep reads/writes the carried
    beta = gam * mu_beta and emits no fresh gam/mu; the returned state's
    gam/mu_beta are the stale inputs.  Every per-iteration update consumes
    only beta and the fused column statistics, so the math is unchanged.
    The driver runs full iterations wherever gam/mu must be fresh.  lite has
    no effect on the exact-missing path, whose gam/mu are always fresh;
    that path takes no Gram blocks (gram_blocks may be None).

    c and c_s are best given as 0-d tensors on the device (the fit loops
    write them there); numbers become cached device constants.  `block` is
    the predictor block of `data` (`data_block`), which the exact-missing
    kernel path needs; None reads it from the device.
    """
    c, c_s = _scalars(c, c_s, cfg, data)
    pre = _pre_sweep(data, hyper, state, c, cfg)
    out = _sweep(data, state, pre, gram_blocks, cfg, annealed, lite, block)
    return _post_sweep(data, hyper, state, pre, out, c, c_s, cfg, annealed)


def cavi_iteration_replicas(data: Data, hyper: Hyper, states, gram_blocks,
                            c, c_s, *, cfg: Config, annealed: bool,
                            lite: bool = False,
                            block: int | None = None) -> list:
    """One CAVI iteration of each state in `states` (annealing replicas of
    one fit), at one temperature.  The pre- and post-sweep updates run on
    each state as in `cavi_iteration`; on the B1 route (complete data and
    impute) and the B2 route (exact missing) the sweep of all the states
    is one batched kernel launch (on the CPU, the kernels' plain versions
    replica by replica).  Elsewhere (the B3 and B4 routes, the plain
    engines) the states' sweeps run one after another.  Each returned
    state is the state `cavi_iteration` returns for it."""
    c, c_s = _scalars(c, c_s, cfg, data)
    pres = [_pre_sweep(data, hyper, st, c, cfg) for st in states]
    engine = _engine(cfg, data)
    if engine == "b1":
        outs = _sweep_fused_replicas(data, states, pres, gram_blocks, cfg,
                                     lite, annealed)
    elif engine == "b2":
        outs = _sweep_missing_replicas(
            data, states, pres, data_block(cfg, data) if block is None
            else block, _b2_pair_bf16(cfg, data), cfg.mis_sub)
    else:
        outs = [_sweep(data, st, pre, gram_blocks, cfg, annealed, lite,
                       block) for st, pre in zip(states, pres)]
    return [_post_sweep(data, hyper, st, pre, out, c, c_s, cfg, annealed)
            for st, pre, out in zip(states, pres, outs)]


def _scalars(c, c_s, cfg: Config, data: Data):
    dev = data.x.device
    return as_scalar(c, cfg.dtype, dev), as_scalar(c_s, cfg.dtype, dev)


class _Pre(NamedTuple):
    """What the pre-sweep updates hand the sweep and the post-sweep
    updates."""
    consts: SweepConsts
    sig2_inv: torch.Tensor
    cp_x_y: torch.Tensor   # X^T Y, or X^T Y_eff in impute mode


def _q_total(mesh):
    """t -> the sum of all of t over the q-shards (torch.sum with no
    mesh)."""
    return lambda t: q_sum(mesh, torch.sum(t))


def _p_total(mesh):
    """t -> the sum of all of t over the p-shards of a 2-D mesh."""
    return lambda t: p_sum(mesh, torch.sum(t))


def _xns_sums(data: Data, m2b, beta):
    """The exact path's x_norm_sq-weighted column sums of m2b and beta^2,
    summed over the p-shards of a 2-D mesh."""
    return p_sum(data.mesh, torch.stack([
        torch.einsum("pq,pq->q", data.x_norm_sq, m2b),
        torch.einsum("pq,pq->q", data.x_norm_sq, beta * beta)]))


def _pre_sweep(data: Data, hyper: Hyper, state: VBState, c,
               cfg: Config) -> _Pre:
    """Steps 1-4: slab and residual precisions, slab variance and the
    log-expectations the sweep reads."""
    (gam_colsum, m2b_colsum, beta2_colsum, yf_colsum, ff_colsum, m2b,
     beta) = _colsum_stats(data, state)

    exact = data.x_norm_sq is not None
    cp_x_y, y_norm_sq = data.cp_x_y, data.y_norm_sq
    if data.mis_pat is not None and not exact:
        # impute: q(y_mis) is N((X beta)_mis, 1/(c tau)); its moments fold
        # into the complete-data sufficient statistics
        v_mis = 1.0 / (c * state.tau)
        y_eff = data.y + (1.0 - data.mis_pat) * state.fitted
        cp_x_y = data.x.T @ y_eff
        y_norm_sq = (torch.einsum("nq,nq->q", y_eff, y_eff)
                     + data.n_mis * v_mis)
        yf_colsum = torch.einsum("nq,nq->q", y_eff, state.fitted)

    # 1-2: slab precision (:134-137); sums over q cross the q-shards
    q_total = _q_total(data.mesh)
    sum_gam = q_total(gam_colsum * data.q_mask)
    nu_vb = upd.nu_update(hyper.nu, sum_gam, c)
    rho_vb = upd.rho_update(hyper.rho, m2b_colsum, state.tau, data.q_mask, c,
                            total=q_total)
    sig2_inv = nu_vb / rho_vb

    # residual precision (:141-145)
    eta_vb = upd.eta_update(data.n_eff, hyper.eta, gam_colsum, c)
    xns_m2b = xns_b2 = None
    if exact:
        xns_m2b, xns_b2 = _xns_sums(data, m2b, beta)
    kappa_vb = upd.kappa_update(data.n, y_norm_sq, yf_colsum, ff_colsum,
                                hyper.kappa, m2b_colsum, beta2_colsum,
                                sig2_inv, c, x_norm_sq_m2b=xns_m2b,
                                x_norm_sq_beta2=xns_b2)
    tau = eta_vb / kappa_vb

    # 3-4: slab variance + log-expectations (:147-150)
    sig2_beta = upd.sig2_beta_update(data.n, sig2_inv, tau, data.x_norm_sq, c)
    log_tau = upd.log_gamma_mean(eta_vb, kappa_vb)
    log_sig2_inv = upd.log_gamma_mean(nu_vb, rho_vb)
    consts = SweepConsts(sig2_beta=sig2_beta, tau=tau, log_tau=log_tau,
                         log_sig2_inv=log_sig2_inv, theta=state.theta,
                         zeta=state.zeta, c=c)
    return _Pre(consts, sig2_inv, cp_x_y)


def _sweep(data: Data, state: VBState, pre: _Pre, gram_blocks, cfg: Config,
           annealed: bool, lite: bool, block):
    """Step 5, the Gauss-Seidel sweep (:166-176 -> src/coreLoop.cpp), by
    the engine the configuration selects.  Returns (gam, mu, beta, fitted,
    z_row, z_col, column statistics); gam/mu None after a lite fused
    sweep, beta and the statistics None on the exact-missing path.  On a
    1-D mesh the engine sweeps the local q-shard and z_row is summed over
    the q-shards (atlasqtl_tpu/models/global_local.py:689-735); on a 2-D
    mesh the pipeline of parallel/pipeline.py runs the same engine on
    q-tiles of the shard."""
    consts, sig2_inv, cp_x_y = pre
    msk = data.p_mask[:, None] * data.q_mask[None, :]
    engine = _engine(cfg, data)
    if has_p(data.mesh):
        block = data_block(cfg, data) if block is None else block
        if data.x_norm_sq is not None:
            gam_new, mu_new, fitted, z_row, z_col = \
                pipelined_sweep_missing_2d(data, state, consts, sig2_inv,
                                           block, cfg, engine)
            return gam_new, mu_new, None, fitted, z_row, z_col, None
        (beta_new, gam_new, mu_new, fitted, z_row, z_col,
         colstats) = pipelined_sweep_2d(
            data, state, state.beta, gram_blocks, cp_x_y, consts, block, cfg,
            engine == "b1", bf16=_b1_bf16(cfg, *_at(data)),
            emit_gam_mu=not lite, annealed=annealed)
        return gam_new, mu_new, beta_new, fitted, z_row, z_col, colstats
    (gam_new, mu_new, beta_new, fitted, z_row, z_col,
     colstats) = _sweep_local(data, state, pre, gram_blocks, cfg, annealed,
                              lite, block, engine, msk)
    return (gam_new, mu_new, beta_new, fitted, q_sum(data.mesh, z_row),
            z_col, colstats)


def _sweep_local(data, state, pre, gram_blocks, cfg, annealed, lite, block,
                 engine, msk):
    """`_sweep` on one device, or on the local shard of a 1-D mesh."""
    consts, sig2_inv, cp_x_y = pre
    if data.x_norm_sq is not None:
        if engine == "b2":
            gam_new, mu_new, fitted, z_row, z_col = sweep_missing_fused_driver(
                data.x, data.cp_x_y, data.x_norm_sq, data.mis_pat, state.gam,
                state.mu_beta, state.fitted, consts, sig2_inv,
                data_block(cfg, data) if block is None else block,
                data.p_mask, data.q_mask, pair_bf16=_b2_pair_bf16(cfg, data),
                sub=cfg.mis_sub)
            # the kernel masks gam/mu at write time
        elif engine == "blocked":
            gam_new, mu_new, fitted, z_row, z_col = sweep_missing_blocked(
                data.x, data.cp_x_y, data.x_norm_sq, data.mis_pat,
                data.mis_pair_gram, state.gam, state.mu_beta, state.fitted,
                consts, cfg.mis_block, data.p_mask, data.q_mask)
            gam_new, mu_new = gam_new * msk, mu_new * msk
        else:
            gam_new, mu_new, fitted = sweep_missing(
                data.x, data.cp_x_y, data.x_norm_sq, data.mis_pat, state.gam,
                state.mu_beta, state.fitted, consts)
            gam_new, mu_new = gam_new * msk, mu_new * msk
            # 7: probit latent moments (:237)
            z_row, z_col = upd.z_moments(gam_new, state.theta, state.zeta,
                                         data.p_mask, data.q_mask, consts.c,
                                         block_size=cfg.block_size)
        return gam_new, mu_new, None, fitted, z_row, z_col, None
    if engine in ("b1", "b4"):
        # mxu_bf16 and its lookahead reach B1 only, and only where the JAX
        # package's fused kernel finds a q tile (`_b1_bf16`)
        fused = sweep_complete_staggered
        if engine == "b1":
            fused = functools.partial(
                sweep_complete_fused, bf16=_b1_bf16(cfg, *_at(data)),
                x_bf16=data.x_bf16, lookahead=_b1_lookahead(cfg, *_at(data)),
                goff=data.goff, **_probe_kw(cfg, data, gram_blocks.shape[1]))
        (beta_new, gam_new, mu_new, fitted, z_row, z_col,
         colstats) = fused(
            data.x, cp_x_y, gram_blocks, state.beta, state.fitted,
            consts, gram_blocks.shape[1], p_mask=data.p_mask,
            q_mask=data.q_mask, emit_gam_mu=not lite, annealed=annealed)
        # the kernel masks beta/gam/mu at write time
        return gam_new, mu_new, beta_new, fitted, z_row, z_col, colstats
    blocked = sweep_complete_pallas if engine == "pallas" else sweep_complete
    gam_new, mu_new, fitted, z_row, z_col = blocked(
        data.x, cp_x_y, gram_blocks, state.gam, state.mu_beta,
        state.fitted, consts, gram_blocks.shape[1], p_mask=data.p_mask,
        q_mask=data.q_mask)
    gam_new = gam_new * msk
    mu_new = mu_new * msk
    beta_new = gam_new * mu_new
    colstats = (torch.sum(gam_new, dim=0),
                torch.einsum("pq,pq->q", mu_new * mu_new, gam_new),
                torch.einsum("pq,pq->q", beta_new, beta_new))
    return gam_new, mu_new, beta_new, fitted, z_row, z_col, colstats


def _probe_kw(cfg: Config, data: Data, block: int) -> dict:
    """B1's probe and window where the probe reaches it (`_b1_probe`)."""
    if not _b1_probe(cfg, *_at(data)):
        return {}
    return dict(probe=cfg.sweep_probe,
                sub=_fused_sub(cfg, data.x.shape[0], block))


def _sweep_fused_replicas(data: Data, states, pres, gram_blocks, cfg: Config,
                          lite, annealed):
    """One B1 sweep of every state (sweep_fused with a replica axis)."""
    block = gram_blocks.shape[1]
    bf16 = _b1_bf16(cfg, *_at(data))
    parts = [fused_operands(data.x, pre.cp_x_y, gram_blocks, st.beta,
                            st.fitted, pre.consts, block, data.p_mask,
                            data.q_mask, bf16=bf16, x_bf16=data.x_bf16)
             for st, pre in zip(states, pres)]
    # X^T Y is each replica's own in impute mode (Y_eff holds its fitted)
    also = ("cp_x_y",) if data.mis_pat is not None else ()
    lookahead = _b1_lookahead(cfg, *_at(data))
    goff = None
    if lookahead:
        goff = (data.goff if data.goff is not None
                else lookahead_gram(data.x, block))
    beta, gam, mu, fitted, z_row, z_col, stats = sweep_fused(
        *FUSED.stack(parts, also), goff, block_size=block,
        emit_gam_mu=not lite, c_one=not annealed, bf16=bf16,
        lookahead=lookahead, **_probe_kw(cfg, data, block))
    return [(None if gam is None else gam[r], None if mu is None else mu[r],
             beta[r], fitted[r], z_row[r], z_col[r],
             tuple(s[r] for s in stats)) for r in range(len(states))]


def _sweep_missing_replicas(data: Data, states, pres, block, pair_bf16,
                            sub):
    """One B2 sweep of every state (sweep_missing_fused with a replica
    axis)."""
    parts = [missing_fused_operands(
        data.x, data.cp_x_y, data.x_norm_sq, data.mis_pat, st.gam,
        st.mu_beta, st.fitted, pre.consts, pre.sig2_inv, data.p_mask,
        data.q_mask) for st, pre in zip(states, pres)]
    gam, mu, fitted, z_row, z_col = sweep_missing_fused(
        *MISSING.stack(parts), block_size=block, pair_bf16=pair_bf16,
        sub=sub)
    return [(gam[r], mu[r], None, fitted[r], z_row[r], z_col[r], None)
            for r in range(len(states))]


def _post_sweep(data: Data, hyper: Hyper, state: VBState, pre: _Pre, out,
                c, c_s, cfg: Config, annealed: bool) -> VBState:
    """Steps 8-9: local and global scales, propensities, the new state."""
    gam_new, mu_new, beta_new, fitted, z_row, z_col, colstats = out
    shr = as_scalar(cfg.shr_fac_inv, cfg.dtype, data.x.device)
    # 8: horseshoe local scales — "keep this order!" (:239-274)
    l_vb = (c_s * state.sig02_inv * shr
            * (state.theta ** 2 + state.sig2_theta) / 2.0 / cfg.df)
    # padded predictor rows carry sig2_theta = 1, so their L is large enough
    # to overflow the special functions; pin them to a benign value (they
    # are masked out of every reduction, but NaN * 0 would still poison the
    # sig02 sum)
    l_vb = torch.where(data.p_mask > 0, l_vb, torch.ones_like(l_vb))
    rho_xi_inv = c_s * (hyper.a2_inv + state.sig02_inv)
    if annealed:
        lam2_inv = lam2_inv_annealed(l_vb, c_s, cfg.df)
    else:
        lam2_inv, _ = lam2_inv_exact(l_vb, cfg.df)

    # 9: global scale + propensities (:276-291)
    xi_inv = 1.0 / rho_xi_inv
    sig02_lam_shr = state.sig02_inv * lam2_inv * shr
    sig2_theta = upd.sig2_c0_update(data.q_true, 1.0 / sig02_lam_shr, c)
    # sums over q and over p cross the shards of a mesh
    zeta_sum = _q_total(data.mesh)(state.zeta * data.q_mask)
    theta = upd.theta_update(z_row, hyper.m0, sig02_lam_shr, sig2_theta,
                             zeta_sum, c) * data.p_mask

    p_total = _p_total(data.mesh)
    nu_s0_vb = upd.nu_update(0.5, data.p_true, c_s)
    rho_s0_vb = c_s * (xi_inv + 0.5 * p_total(
        lam2_inv * shr * (theta ** 2 + sig2_theta) * data.p_mask))
    sig02_inv = nu_s0_vb / rho_s0_vb

    sig2_zeta = upd.sig2_c0_update(data.p_true, hyper.t02, c)
    theta_sum = p_total(theta)
    zeta = upd.zeta_update(z_col, theta_sum, hyper.n0, sig2_zeta,
                           1.0 / hyper.t02, c) * data.q_mask

    if gam_new is None:  # lite fused iteration: gam/mu stay (stale) as-is
        gam_new, mu_new = state.gam, state.mu_beta
    return VBState(
        gam=gam_new, mu_beta=mu_new, beta=beta_new,
        sig2_beta=pre.consts.sig2_beta, tau=pre.consts.tau,
        sig2_inv=pre.sig2_inv, theta=theta,
        zeta=zeta, sig02_inv=sig02_inv, lam2_inv=lam2_inv,
        sig2_theta=sig2_theta, fitted=fitted,
        gam_colsum=None if colstats is None else colstats[0],
        mu2gam_colsum=None if colstats is None else colstats[1],
        beta2_colsum=None if colstats is None else colstats[2],
        l_vb=l_vb, rho_xi_inv=rho_xi_inv, nu_s0_vb=nu_s0_vb,
        rho_s0_vb=rho_s0_vb)


# -------------------------------------------------------------------- ELBO

def compute_elbo(data: Data, hyper: Hyper, state: VBState, *,
                 cfg: Config) -> torch.Tensor:
    """8-term ELBO at c = 1 with the reference's re-derived Gamma factors
    (R/atlasqtl_global_local_core.R:440-495), accumulated in
    cfg.elbo_dtype (float64).  The (p, q) state is cast block by block, so
    peak memory stays O(block x q) above the state.  Impute mode re-derives
    the q(y_mis) moments (a coordinate update, so the ELBO stays monotone)
    and adds their entropy; the exact-missing path takes the
    x_norm_sq-weighted column sums and the per-(j, k) slab variance.  On a
    mesh every sum over q or p crosses the shards (`q_sum`, `p_sum`), so
    every rank gets the same value."""
    dt = cfg.elbo_dtype
    f = lambda a: a.to(dt)
    shr = as_scalar(cfg.shr_fac_inv, dt, data.x.device)

    eta, kappa, n0 = f(hyper.eta), f(hyper.kappa), f(hyper.n0)
    nu, rho, t02, a2_inv = f(hyper.nu), f(hyper.rho), f(hyper.t02), \
        f(hyper.a2_inv)
    tau = f(state.tau)
    sig2_inv = f(state.sig2_inv)
    zeta = f(state.zeta)
    fitted = f(state.fitted)
    y = f(data.y)
    q_mask = f(data.q_mask)
    n_eff = f(data.n_eff)
    p_true, q_true, n_s = f(data.p_true), f(data.q_true), f(data.n)
    missing_exact = data.x_norm_sq is not None
    y_norm_sq = f(data.y_norm_sq)
    entropy_y_mis = torch.zeros((), dtype=dt, device=data.x.device)
    if data.mis_pat is not None and not missing_exact:
        n_mis = f(data.n_mis)
        v_mis = 1.0 / tau
        y_eff = y + (1.0 - f(data.mis_pat)) * fitted
        y_norm_sq = torch.einsum("nq,nq->q", y_eff, y_eff) + n_mis * v_mis
        yf_colsum = torch.einsum("nq,nq->q", y_eff, fitted)
        entropy_y_mis = 0.5 * torch.sum(
            n_mis * (torch.log(2.0 * np.pi * v_mis) + 1.0) * q_mask)
    else:
        yf_colsum = torch.einsum("nq,nq->q", y, fitted)
    ff_colsum = torch.einsum("nq,nq->q", fitted, fitted)

    t02_inv = 1.0 / t02
    sig2_zeta = 1.0 / (p_true + t02_inv)
    vec_sum_log_det_zeta = -q_true * (torch.log(t02)
                                      + torch.log(p_true + t02_inv))

    p_pad, q_pad = state.gam.shape
    block = divisor_block(cfg.block_size, p_pad)
    s2_1d = state.sig2_beta.dim() == 1
    zq = lambda: torch.zeros(q_pad, dtype=dt, device=data.x.device)
    gam_colsum, mu2g_colsum, beta2_colsum = zq(), zq(), zq()
    xns_m2b, xns_b2 = zq(), zq()
    bg_fixed = sum_gam = m2b_tau_sum = s2theta_sum = torch.zeros(
        (), dtype=dt, device=data.x.device)
    for b in range(p_pad // block):
        sl = slice(b * block, (b + 1) * block)
        gam_b = f(state.gam[sl])
        mu_b = f(state.mu_beta[sl])
        pm_b = f(data.p_mask[sl])
        cell = pm_b[:, None] * q_mask[None, :]
        gam_m = gam_b * cell
        beta_b = gam_b * mu_b
        s2_b = (f(state.sig2_beta)[None, :].expand(block, q_pad) if s2_1d
                else f(state.sig2_beta[sl]))
        m2_b = (mu_b * mu_b + s2_b) * gam_b

        gam_colsum = gam_colsum + torch.sum(gam_m, dim=0)
        mu2g_colsum = mu2g_colsum + torch.sum(m2_b * cell, dim=0)
        beta2_colsum = beta2_colsum + torch.sum(beta_b * beta_b * cell, dim=0)
        if missing_exact:
            xns_b = f(data.x_norm_sq[sl])
            xns_m2b = xns_m2b + torch.sum(xns_b * m2_b * cell, dim=0)
            xns_b2 = xns_b2 + torch.sum(xns_b * beta_b * beta_b * cell, dim=0)

        # fixed part of E log p(beta,gamma) - E log q (R/elbo.R:10-34); the
        # log_tau / log_sig2_inv / tau*sig2_inv pieces are folded in after
        # the pass through the accumulated sums
        log_p, log_1p = log_ndtr_both(f(state.theta[sl])[:, None]
                                      + zeta[None, :])
        bg_fixed = bg_fixed + torch.sum(
            (gam_b * log_p + (1.0 - gam_b) * log_1p
             - elbo_ops._xlogx(gam_b) - elbo_ops._xlogx(1.0 - gam_b)
             + 0.5 * gam_b * (torch.log(s2_b) + 1.0)) * cell)
        sum_gam = sum_gam + torch.sum(gam_m)
        m2b_tau_sum = m2b_tau_sum + torch.sum(m2_b * tau[None, :] * cell)
        s2theta_sum = s2theta_sum + torch.sum(f(state.sig2_theta[sl]) * pm_b)
    mesh = data.mesh
    q_total, p_total = _q_total(mesh), _p_total(mesh)
    # the blocked pass summed this rank's predictors: the (q,) sums over
    # the p-shards, the totals over both axes, s2theta over p only (it is
    # q-replicated)
    (gam_colsum, mu2g_colsum, beta2_colsum, xns_m2b, xns_b2) = p_sum(
        mesh, torch.stack([gam_colsum, mu2g_colsum, beta2_colsum, xns_m2b,
                           xns_b2]))
    bg_fixed, sum_gam, m2b_tau_sum = q_sum(mesh, p_sum(mesh, torch.stack(
        [bg_fixed, sum_gam, m2b_tau_sum])))
    s2theta_sum = p_sum(mesh, s2theta_sum)
    entropy_y_mis = q_sum(mesh, entropy_y_mis)
    m2b_colsum = mu2g_colsum  # (mu^2 + s2) gam summed — already includes s2

    eta_vb = upd.eta_update(n_eff, eta, gam_colsum)
    kappa_vb = upd.kappa_update(
        n_s, y_norm_sq, yf_colsum, ff_colsum, kappa, m2b_colsum, beta2_colsum,
        sig2_inv, x_norm_sq_m2b=xns_m2b if missing_exact else None,
        x_norm_sq_beta2=xns_b2 if missing_exact else None)
    nu_vb = upd.nu_update(nu, sum_gam)
    rho_vb = upd.rho_update(rho, m2b_colsum, tau, q_mask, total=q_total)
    log_tau = upd.log_gamma_mean(eta_vb, kappa_vb)
    log_sig2_inv = upd.log_gamma_mean(nu_vb, rho_vb)
    nu_s0_vb, rho_s0_vb = f(state.nu_s0_vb), f(state.rho_s0_vb)
    rho_xi_inv = f(state.rho_xi_inv)
    log_sig02_inv = upd.log_gamma_mean(nu_s0_vb, rho_s0_vb)
    log_xi_inv = upd.log_gamma_mean(torch.ones_like(rho_xi_inv), rho_xi_inv)
    xi_inv = 1.0 / rho_xi_inv

    term_a = q_sum(mesh, elbo_ops.e_y(n_eff, kappa, kappa_vb, log_tau,
                                      m2b_colsum, sig2_inv, tau, q_mask))
    term_b = (bg_fixed
              + 0.5 * log_sig2_inv * sum_gam
              + 0.5 * q_total(gam_colsum * log_tau * q_mask)
              - 0.5 * sig2_inv * m2b_tau_sum
              - 0.5 * sig2_zeta * p_true * q_true
              - 0.5 * q_true * s2theta_sum)

    l_vb = f(state.l_vb)
    term_c = p_sum(mesh, elbo_ops.e_theta_hs(
        f(state.lam2_inv), l_vb, log_sig02_inv + torch.log(shr),
        f(state.theta), q_approx(l_vb), f(state.sig02_inv) * shr,
        f(state.sig2_theta), f(data.p_mask), cfg.df))
    term_d = elbo_ops.e_zeta(zeta, n0, sig2_zeta, t02_inv,
                             vec_sum_log_det_zeta, q_true, q_mask,
                             total=q_total)
    term_e = q_sum(mesh, elbo_ops.e_tau(eta, eta_vb, kappa, kappa_vb,
                                        log_tau, tau, q_mask))
    term_f = elbo_ops.e_sig2_inv_hs(xi_inv, nu_s0_vb, log_xi_inv,
                                    log_sig02_inv, rho_s0_vb,
                                    f(state.sig02_inv))
    half = torch.full_like(rho_xi_inv, 0.5)
    term_g = elbo_ops.e_sig2_inv(half, torch.ones_like(half), log_xi_inv,
                                 a2_inv, rho_xi_inv, xi_inv)
    term_h = elbo_ops.e_sig2_inv(nu, nu_vb, log_sig2_inv, rho, rho_vb,
                                 sig2_inv)
    return (term_a + term_b + term_c + term_d + term_e + term_f + term_g
            + term_h + entropy_y_mis)
