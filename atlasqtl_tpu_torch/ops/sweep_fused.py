"""The fused complete-data sweep: one whole Gauss-Seidel pass per call.

Counterpart of atlasqtl_tpu/ops/sweep_fused.py.  For CUDA tensors the sweep
is the hand-written kernel in csrc/sweep_fused.cu, which replaces the TPU
kernel atlasqtl_tpu/ops/sweep_fused.py:_fused_kernel.  For CPU tensors it is
`sweep_fused_plain`, the same function in plain tensor ops (the kernel is
held against it on the card; the CPU tests hold it against the JAX kernel).

What bounds the kernel on an H100: the two products r0 = x_b^T F and
F += x_b delta, 4 n p q FP32 operations per sweep (no TF32: the reference's
products are full f32); moving the bytes it must move (x, cp, beta in and
out, F) takes under a tenth of that time at 3.35 TB/s.  One CTA per slice
of 32 or 40 response columns (`fused_launch_plan` picks the width that fills
whole waves of SMs best) walks every predictor block with one pass over the
samples per block (the advance by the previous block fused with this block's
projection, staged by cp.async) and a windowed chain on one thread per
column while the other warps prepare the next window (csrc/sweep_fused.cu
says more).

One deliberate difference from the TPU kernel: each coordinate's Gram
diagonal is the true x_j^T x_j, where the TPU kernel uses n_pad - 1
(atlasqtl_tpu/ops/sweep_fused.py:504), which is wrong whenever the sample
count is not a multiple of 8.

Per block b: r = x_b^T F - beta_b * diag(G_b); ad/imrd/imr0u = L_b @ N +
sqrt base (ops/interp.py); the strictly sequential update of the B
coordinates; gam, mu, beta masked at write; column statistics and Z sums;
F += x_b @ delta.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from .interp import K_BASE, tail_interp_operands
from .special import as_scalar

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
# every kernel source goes into one shared library; each includes the header
_SOURCES = (_CSRC / "sweep_fused.cu", _CSRC / "sweep_missing_fused.cu",
            _CSRC / "sweep_inner_gs.cu", _CSRC / "sweep_staggered.cu")
_HEADERS = (_CSRC / "common.cuh",)
_BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
               "-Xcompiler", "-fPIC"]
_lib = None
SMEM_MAX = 232448   # shared memory one CTA may take on an H100 (bytes)
# the most each of two CTAs may take to share an SM (228 KB, less 1 KB
# reserved per CTA)
SMEM_TWO_PER_SM = 233472 // 2 - 1024
H100_SMS = 132      # SMs of an H100 SXM, for the launch plans' wave counts


def _nvcc() -> str:
    cands = [shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA sweep kernels are built from "
                       "csrc/*.cu at first use and need the CUDA toolkit (set "
                       "CUDA_HOME)")


def build(verbose: bool = False) -> Path:
    """Compile the kernel sources of csrc/ for sm_90a into one shared library
    in _build/ (once per source hash) and return its path: one nvcc per
    source, all started together, then one link.  verbose rebuilds and
    prints ptxas's register and shared-memory report (kept in
    `build.ptxas_report`)."""
    h = hashlib.sha256()
    for src in (*_SOURCES, *_HEADERS):
        h.update(src.read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    out = _BUILD_DIR / f"libatlasqtl_sweeps_{h.hexdigest()[:16]}.so"
    if out.exists() and not verbose:
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [out.with_suffix(f".{src.stem}.{os.getpid()}.o")
            for src in _SOURCES]
    procs = [subprocess.Popen(
        [nvcc, *_NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-c",
         "-o", str(obj), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for src, obj in zip(_SOURCES, objs)]
    errs = [proc.communicate()[1] for proc in procs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        for src, proc, err in zip(_SOURCES, procs, errs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} "
                                   f"({proc.returncode}):\n{err}")
        r = subprocess.run([nvcc, *_NVCC_FLAGS, "-shared", "-o", str(tmp),
                            *map(str, objs)], capture_output=True, text=True)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({r.returncode}):\n{r.stderr}")
    if verbose:
        build.ptxas_report = "".join(errs)
        print(build.ptxas_report, flush=True)
    os.replace(tmp, out)
    return out


build.ptxas_report = ""


def _load():
    """The ctypes handle of the kernel library (every sweep kernel), built
    at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.atlasqtl_sweep_fused.argtypes = [ptr] * 23 + [i32] * 9 + [ptr]
        lib.atlasqtl_sweep_staggered.argtypes = [ptr] * 23 + [i32] * 7 + [ptr]
        for fn in (lib.atlasqtl_sweep_fused, lib.atlasqtl_sweep_staggered):
            fn.restype = i32
        lib.atlasqtl_sweep_fused_clocks.argtypes = [ptr]
        lib.atlasqtl_sweep_fused_clocks.restype = i32
        lib.atlasqtl_sweep_fused_occupancy.argtypes = [i32] * 3
        lib.atlasqtl_sweep_fused_occupancy.restype = i32
        lib.atlasqtl_sweep_fused_smem.argtypes = [i32] * 3
        lib.atlasqtl_sweep_fused_smem.restype = ctypes.c_longlong
        lib.atlasqtl_sweep_staggered_occupancy.argtypes = [i32] * 3
        lib.atlasqtl_sweep_staggered_occupancy.restype = i32
        lib.atlasqtl_sweep_staggered_smem.argtypes = [i32] * 3
        lib.atlasqtl_sweep_staggered_smem.restype = ctypes.c_longlong
        lib.atlasqtl_sweep_staggered_clocks.argtypes = [ptr]
        lib.atlasqtl_sweep_staggered_clocks.restype = i32
        lib.atlasqtl_inner_gs_occupancy.argtypes = [i32] * 3
        lib.atlasqtl_inner_gs_occupancy.restype = i32
        lib.atlasqtl_sweep_missing_fused.argtypes = ([ptr] * 20 + [i32] * 8
                                                     + [ptr])
        lib.atlasqtl_sweep_missing_fused.restype = i32
        lib.atlasqtl_sweep_missing_smem.argtypes = [i32] * 4
        lib.atlasqtl_sweep_missing_smem.restype = i32
        lib.atlasqtl_sweep_missing_occupancy.argtypes = [i32] * 4 + [ptr]
        lib.atlasqtl_sweep_missing_occupancy.restype = i32
        lib.atlasqtl_sweep_missing_clocks.argtypes = [ptr]
        lib.atlasqtl_sweep_missing_clocks.restype = i32
        lib.atlasqtl_sweep_missing_window.argtypes = []
        lib.atlasqtl_sweep_missing_window.restype = i32
        lib.atlasqtl_inner_gs_smem.argtypes = [i32, i32]
        lib.atlasqtl_inner_gs_smem.restype = i32
        lib.atlasqtl_inner_gs.argtypes = [i32] * 2 + [ptr] * 20 + [i32] * 3 \
            + [ptr]
        lib.atlasqtl_inner_gs.restype = i32
        lib.atlasqtl_inner_gs_clocks.argtypes = [ptr]
        lib.atlasqtl_inner_gs_clocks.restype = i32
        lib.atlasqtl_zrow_reduce.argtypes = [i32, ptr, ptr, i32, i32, ptr]
        lib.atlasqtl_zrow_reduce.restype = i32
        lib.atlasqtl_error_string.argtypes = [ctypes.c_int]
        lib.atlasqtl_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


# the kernel's constants (csrc/sweep_fused.cu)
FUSED_BMAX = 128          # the largest block a launch walks in one piece
FUSED_WIDTHS = (32, 40)   # the slice widths built (response columns)
FUSED_NCH = 32            # sample rows per pass chunk
FUSED_NSTAGE = 3          # F and x_b chunk stages
FUSED_NXA = 2             # x_{b-1} chunk stages
FUSED_NG = 4              # thread groups of the two products
FUSED_W = 8               # chain window


def _fused_smem_bytes(width: int, block: int, r_aug: int) -> int:
    """csrc/sweep_fused.cu:smem_bytes for `width`-column slices: the packed
    Gram triangle, the delta and projection tiles, the pass stages (F, x_b
    and x_{b-1} chunks, x rows padded by 4), the advance partials, the
    window tiles (corrections twice, cp and beta rows three times), the
    nodes, the block's p_mask and theta, the slice's zeta and q_mask.  The
    card holds it to the kernel's own (`kernel_smem_bytes`)."""
    gp = (block * (block + 1) // 2 + 3) & ~3
    stages = (FUSED_NSTAGE * FUSED_NCH * width
              + (FUSED_NSTAGE + FUSED_NXA) * FUSED_NCH * (block + 4))
    return 4 * (gp + 2 * block * width + stages
                + FUSED_NG * FUSED_NCH * width
                + 8 * FUSED_W * width + 3 * r_aug * width + 2 * 128
                + 2 * width)


def sub_block(block: int) -> int:
    """The piece a sweep kernel walks a predictor block in: the block itself
    up to FUSED_BMAX rows, else the largest multiple of 8 up to FUSED_BMAX
    that divides it (block 256: two pieces of 128; block 200: five of 40).
    The Gauss-Seidel order is unchanged: a coordinate of a later piece sees
    the earlier pieces' updates through F (x_j^T (F + X_1 delta_1) =
    x_j^T F + G_j1 delta_1), so the sweep equals the whole-block sweep up to
    rounding.  Raises ValueError for a block that is not a positive
    multiple of 8."""
    if block <= 0 or block % 8:
        raise ValueError(f"unsupported block {block} (a positive multiple "
                         "of 8)")
    return max(s for s in range(8, min(block, FUSED_BMAX) + 1, 8)
               if block % s == 0)


def sub_block_gram(gram_flat, block: int, sub: int):
    """The (p, sub) stacked diagonal Gram pieces of the (p, block) stacked
    diagonal Gram blocks: row j keeps the columns of its own piece."""
    if sub == block:
        return gram_flat
    p = gram_flat.shape[0]
    k = block // sub
    g = gram_flat.reshape(p // sub, sub, k, sub)
    piece = torch.arange(p // sub, device=gram_flat.device)
    return g[piece, :, piece % k, :].reshape(p, sub).contiguous()


def fused_launch_plan(n: int, q: int, block: int, r_aug: int,
                      sms: int = H100_SMS, m: int = 1) -> dict:
    """The launch of B1 at (n, q, block, r + 2) for m replicas on a card of
    `sms` SMs: one CTA per slice and replica and one CTA per SM (a second
    needs at most 128 registers per thread and 113 KB of shared memory,
    against ptxas's 211 and 167 for the two widths and over 200 KB at
    block 128), no cluster.  Of the widths built, the one whose m x slices
    CTAs fill whole waves best: the fewest columns of SM time (waves x
    width), the narrower on a tie.  At q = 10000 on 132 SMs, 40 columns
    take 2 waves where 32 take 3.  A block over FUSED_BMAX is walked in
    pieces of `sub_block` rows.  Returns slice_width, sub_block, cluster,
    grid (the slices of one replica; the launch is grid x m CTAs), waves
    (of all m replicas), smem_bytes, ctas_per_sm and zrow_parts (z_row
    partial rows per slice); the C entry point takes the width and the
    piece and sizes the rest itself.  Raises ValueError on a shape the
    kernel does not take."""
    if (n <= 0 or block <= 0 or block % FUSED_W or q <= 0 or q % 4
            or not 0 < r_aug <= 48 or m < 1):
        raise ValueError(f"sweep_fused kernel: unsupported shape n={n}, "
                         f"q={q}, block={block}, r+2={r_aug}, m={m}")
    sub = sub_block(block)
    width, waves = _widest_fill(q, FUSED_WIDTHS, sms, m)
    return dict(slice_width=width, sub_block=sub, cluster=1,
                grid=-(-q // width), waves=waves,
                smem_bytes=_fused_smem_bytes(width, sub, r_aug),
                ctas_per_sm=1, zrow_parts=1)


def _widest_fill(q: int, widths, sms: int, m: int = 1):
    """(width, waves) of the slice width among `widths` whose slices of m
    replicas fill whole waves of `sms` SMs best: the fewest columns of SM
    time (waves x width), the narrower on a tie."""
    waves = lambda w: -(-(m * -(-q // w)) // sms)
    width = min(widths, key=lambda w: (waves(w) * w, w))
    return width, waves(width)


def occupancy(width: int, block: int, r_aug: int) -> int:
    """CTAs of B1 in `width`-column slices resident on one SM at (block,
    r + 2), from the occupancy calculator on the card."""
    return _load().atlasqtl_sweep_fused_occupancy(width, block, r_aug)


def kernel_smem_bytes(width: int, block: int, r_aug: int) -> int:
    """The kernel's own shared-memory bytes at (width, block, r + 2), -1
    where it refuses them."""
    return _load().atlasqtl_sweep_fused_smem(width, block, r_aug)


PHASES = ("pass", "tiles", "chain", "z_tile", "total")


def phase_clocks() -> dict:
    """The SM clock cycles the latest B1 launch's first CTA spent in each
    phase, summed over the blocks (its thread 0, which also runs the chain;
    csrc/sweep_fused.cu:g_clocks)."""
    out = (ctypes.c_longlong * len(PHASES))()
    err = _load().atlasqtl_sweep_fused_clocks(out)
    if err != 0:
        raise RuntimeError("sweep_fused clocks: "
                           + _load().atlasqtl_error_string(err).decode())
    return dict(zip(PHASES, out))


def _tiles(u, l_blk, n_stack, c, kz, c_one):
    """The logit and Mills tiles of one block: interpolation product plus
    the analytic sqrt base (ops/interp.py)."""
    u2 = u * u
    s_d = torch.sqrt(u2 + K_BASE)
    h = 0.5 * u
    if c_one:
        ad = h * s_d + l_blk @ n_stack[0]
        imrd = s_d + l_blk @ n_stack[1]
        imr0u = l_blk @ n_stack[2] - 0.5 * s_d - h
    else:
        ad = c * (h * s_d) + l_blk @ n_stack[0]
        s_z = torch.sqrt(u2 + kz)
        imrd = s_z + l_blk @ n_stack[1]
        imr0u = l_blk @ n_stack[2] - 0.5 * s_z - h
    return ad, imrd, imr0u


def _chain(r, g, ad, cp_b, beta_b, ct, c_inv_2s2):
    """The strictly sequential update of one block's B coordinates, row by
    row, for the columns of r (advanced in place).  Returns (gam, mu,
    delta)."""
    gam_b = torch.empty_like(beta_b)
    mu_b = torch.empty_like(beta_b)
    delta = torch.empty_like(beta_b)
    for i in range(beta_b.shape[0]):
        mu_i = ct * (cp_b[i] - r[i])
        gam_i = torch.sigmoid(ad[i] + mu_i * mu_i * c_inv_2s2)
        delta[i] = gam_i * mu_i - beta_b[i]
        r[i + 1:] += g[i + 1:, i, None] * delta[i][None, :]
        gam_b[i], mu_b[i] = gam_i, mu_i
    return gam_b, mu_b, delta


def _new_outputs(beta, theta, emit_gam_mu):
    zero_q = lambda: torch.zeros(beta.shape[1], dtype=beta.dtype,
                                 device=beta.device)
    return dict(beta=torch.empty_like(beta),
                gam=torch.empty_like(beta) if emit_gam_mu else None,
                mu=torch.empty_like(beta) if emit_gam_mu else None,
                z_row=torch.empty_like(theta), z_col=zero_q(), gcol=zero_q(),
                m2gcol=zero_q(), b2col=zero_q())


def _emit_block(out, sl, gam_b, mu_b, z_b, pm, q_mask):
    """Write block sl's masked beta (gam, mu) and add its column statistics
    and Z sums; z_b = gam * imrd + imr0u."""
    msk = pm[:, None] * q_mask[None, :]
    t_bm = gam_b * mu_b
    out["beta"][sl] = t_bm * msk
    if out["gam"] is not None:
        out["gam"][sl] = gam_b * msk
        out["mu"][sl] = mu_b * msk
    out["gcol"] += (pm @ gam_b) * q_mask
    out["m2gcol"] += (pm @ (t_bm * mu_b)) * q_mask
    out["b2col"] += (pm @ (t_bm * t_bm)) * q_mask
    z_qm = z_b * q_mask[None, :]
    out["z_row"][sl] = torch.sum(z_qm, dim=1) * pm
    out["z_col"] += pm @ z_qm


def _outputs(out, fitted):
    return (out["beta"], out["gam"], out["mu"], fitted, out["z_row"],
            out["z_col"], (out["gcol"], out["m2gcol"], out["b2col"]))


class Operands:
    """A sweep kernel's operands in call order, each with its dims without
    a replica axis, and which of them a batched launch of several replicas
    takes how: `shared` ones once for all replicas, `either` ones once or
    one per replica, every other (the state) one per replica."""

    def __init__(self, ndims: dict, shared, either=()):
        self.names = tuple(ndims)
        self.ndims = tuple(ndims.values())
        self.shared = frozenset(shared)
        self.either = frozenset(either)
        self.state = frozenset(self.names) - self.shared - self.either

    def replica_axis(self, args):
        """The replica count m of the operands `args` (1 without a replica
        axis) and, per operand, whether it carries the axis (one dim more
        than its own).  Raises ValueError on operands of mixed replica
        counts, and on a replica axis on a shared operand or missing from
        an operand of the state."""
        batched = [a is not None and a.dim() == nd + 1
                   for a, nd in zip(args, self.ndims)]
        ms = {a.shape[0] for a, b in zip(args, batched) if b}
        if len(ms) > 1:
            raise ValueError(
                f"operands of different replica counts {sorted(ms)}")
        on = {k for k, b in zip(self.names, batched) if b}
        if on and (not self.state <= on or on & self.shared):
            raise ValueError(
                "a replica axis goes on every operand of the state ("
                + ", ".join(k for k in self.names if k in self.state)
                + "), never on " + ", ".join(
                    k for k in self.names if k in self.shared))
        return (ms.pop() if ms else 1), batched

    def stack(self, parts, also=()):
        """The operand lists `parts` of several replicas' sweeps as the
        operands of one batched launch: the state and the operands named in
        `also` stacked on a leading replica axis, every other taken from
        the first replica (the same tensor for all: data, masks, the
        temperature)."""
        per_replica = self.state | set(also)
        return [torch.stack(ops) if k in per_replica else ops[0]
                for k, ops in zip(self.names, zip(*parts))]

    def loop(self, fn, args, kw):
        """fn(*args, **kw) replica by replica (each operand that carries
        the replica axis sliced to its replica), the outputs stacked on a
        leading axis: the plain versions' form of a batched launch."""
        m, batched = self.replica_axis(args)
        outs = [fn(*(a[r] if b else a for a, b in zip(args, batched)), **kw)
                for r in range(m)]

        def stack(parts):
            if parts[0] is None:
                return None
            if isinstance(parts[0], tuple):
                return tuple(stack(list(p)) for p in zip(*parts))
            return torch.stack(parts)
        return tuple(stack(list(p)) for p in zip(*outs))


# sweep_fused's operands: x, the Gram blocks and the masks are shared by
# all replicas; X^T Y (each replica's own in impute mode) and c (one
# temperature) may be either
FUSED = Operands(
    dict(x=2, cp_x_y=2, gram_flat=2, l_aug=2, n_stack=3, beta=2, fitted=2,
         theta=1, p_mask=1, zeta=1, q_mask=1, sig2_beta=1, tau=1, c=0, kz=0),
    shared=("x", "gram_flat", "p_mask", "q_mask"), either=("cp_x_y", "c"))


def sweep_fused_plain(x, cp_x_y, gram_flat, l_aug, n_stack, beta, fitted,
                      theta, p_mask, zeta, q_mask, sig2_beta, tau, c, kz, *,
                      block_size: int, emit_gam_mu: bool = True,
                      c_one: bool = False):
    """The kernel's function in plain tensor ops, block by block and row by
    row in flat sequential order.  Same arguments and outputs as
    `sweep_fused`; with a replica axis, one replica after another."""
    args = (x, cp_x_y, gram_flat, l_aug, n_stack, beta, fitted, theta, p_mask,
            zeta, q_mask, sig2_beta, tau, c, kz)
    kw = dict(block_size=block_size, emit_gam_mu=emit_gam_mu, c_one=c_one)
    if beta.dim() == 3:
        return FUSED.loop(_sweep_fused_plain_one, args, kw)
    return _sweep_fused_plain_one(*args, **kw)


def _sweep_fused_plain_one(x, cp_x_y, gram_flat, l_aug, n_stack, beta,
                           fitted, theta, p_mask, zeta, q_mask, sig2_beta,
                           tau, c, kz, *, block_size, emit_gam_mu, c_one):
    B = block_size
    ct = c * sig2_beta * tau
    c_inv_2s2 = c * 0.5 / sig2_beta
    fitted = fitted.clone()
    out = _new_outputs(beta, theta, emit_gam_mu)
    for b in range(x.shape[1] // B):
        sl = slice(b * B, (b + 1) * B)
        xb, g = x[:, sl], gram_flat[sl]
        ad, imrd, imr0u = _tiles(theta[sl, None] + zeta[None, :], l_aug[sl],
                                 n_stack, c, kz, c_one)
        r = xb.T @ fitted - beta[sl] * torch.diagonal(g)[:, None]
        gam_b, mu_b, delta = _chain(r, g, ad, cp_x_y[sl], beta[sl], ct,
                                    c_inv_2s2)
        fitted += xb @ delta
        _emit_block(out, sl, gam_b, mu_b, gam_b * imrd + imr0u, p_mask[sl],
                    q_mask)
    return _outputs(out, fitted)


def fused_launch(entry, x, cp_x_y, gram_flat, l_aug, n_stack, beta, fitted,
                 theta, p_mask, zeta, q_mask, sig2_beta, tau, c, kz, *,
                 block_size, emit_gam_mu, c_one, slice_width=None,
                 plan=None):
    """Check the operands of one fused-sweep launch and launch the C entry
    point `entry` of the kernel library (atlasqtl_sweep_fused, B1, or
    atlasqtl_sweep_staggered, B4: the same arguments and function) under
    `plan(n, q, block, r + 2, sms)` (None: B1's `fused_launch_plan`), whose
    slice width `slice_width` overrides; a block over FUSED_BMAX goes in as
    its `sub_block` pieces with their Gram pieces.  B1 takes a replica axis
    (the state's operands of `FUSED` stacked): one launch of grid x m
    CTAs, each replica's outputs bit for bit those of its own launch in
    slices of the same width (the plan for m replicas may pick another
    width than one replica's, and z_row then sums in another order).
    Raises on what the kernels cannot take and on a failed launch."""
    n, p = x.shape[-2:]
    q = beta.shape[-1]
    r_aug = l_aug.shape[-1]
    what = entry.replace("atlasqtl_", "")
    args = (x, cp_x_y, gram_flat, l_aug, n_stack, beta, fitted, theta, p_mask,
            zeta, q_mask, sig2_beta, tau, c, kz)
    try:
        m, batched = FUSED.replica_axis(args)
    except ValueError as e:
        raise ValueError(f"{what} kernel: {e}") from None
    if any(batched) and entry != "atlasqtl_sweep_fused":
        raise ValueError(f"{what} kernel: no replica axis (B1 only)")
    shapes = ((n, p), (p, q), (p, block_size), (p, r_aug), (3, r_aug, q),
              (p, q), (n, q), (p,), (p,), (q,), (q,), (q,), (q,))
    for i, (name, shape) in enumerate(zip(FUSED.names, shapes)):
        t = args[i]
        shape = (m, *shape) if batched[i] else shape
        # every replica's slice is 16-byte aligned too
        step = t[0].numel() * 4 if batched[i] else 0
        if (t.device.type != "cuda" or t.dtype != torch.float32
                or not t.is_contiguous() or tuple(t.shape) != shape
                or t.data_ptr() % 16 or step % 16):
            raise ValueError(
                f"{what} kernel: {name} must be a contiguous, 16-byte "
                f"aligned float32 CUDA tensor of shape {shape}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if (block_size <= 0 or block_size % 8 or p % block_size or q % 4
            or r_aug > 48):
        raise ValueError(f"{what} kernel: unsupported shape n={n}, p={p},"
                         f" q={q}, block={block_size}, r+2={r_aug}")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    launch = (plan(n, q, block_size, r_aug, sms) if plan is not None
              else fused_launch_plan(n, q, block_size, r_aug, sms, m))
    slice_width = slice_width or launch["slice_width"]
    sub = launch["sub_block"]
    gram_flat = sub_block_gram(gram_flat, block_size, sub)
    lib = _load()
    dev = x.device
    lead = (m,) if any(batched) else ()
    scal = torch.stack([
        as_scalar(c, torch.float32, dev).expand(lead),
        as_scalar(kz, torch.float32, dev).expand(lead)], dim=-1).contiguous()
    fitted = fitted.clone()
    beta_out = torch.empty_like(beta)
    gam_out = torch.empty_like(beta) if emit_gam_mu else None
    mu_out = torch.empty_like(beta) if emit_gam_mu else None
    zrow_part = torch.empty(
        (*lead, launch["zrow_parts"] * -(-q // slice_width), p),
        dtype=torch.float32, device=dev)
    z_row = torch.empty_like(theta)
    z_col, gcol, m2gcol, b2col = (torch.empty_like(zeta) for _ in range(4))
    ptr = lambda t: None if t is None else t.data_ptr()
    # B1's replica count and whether X^T Y is per replica
    extra = ((m, int(batched[1])) if entry == "atlasqtl_sweep_fused"
             else ())
    err = getattr(lib, entry)(
        ptr(x), ptr(cp_x_y), ptr(gram_flat), ptr(l_aug), ptr(n_stack),
        ptr(beta), ptr(fitted), ptr(theta), ptr(p_mask), ptr(zeta),
        ptr(q_mask), ptr(sig2_beta), ptr(tau), ptr(scal), ptr(beta_out),
        ptr(gam_out), ptr(mu_out), ptr(zrow_part), ptr(z_row), ptr(z_col),
        ptr(gcol), ptr(m2gcol), ptr(b2col), n, p, q, sub,
        r_aug, int(bool(c_one)), slice_width, *extra,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed at n={n}, p={p}, "
                           f"q={q}, block={block_size} (pieces of {sub}), "
                           f"{slice_width}-column slices, {m} replica(s): "
                           + lib.atlasqtl_error_string(err).decode())
    return beta_out, gam_out, mu_out, fitted, z_row, z_col, (gcol, m2gcol,
                                                             b2col)


def _sweep_fused_cuda(*args, **kw):
    out = fused_launch("atlasqtl_sweep_fused", *args, **kw)
    sweep_fused.launches += 1
    return out


def sweep_fused(x, cp_x_y, gram_flat, l_aug, n_stack, beta, fitted, theta,
                p_mask, zeta, q_mask, sig2_beta, tau, c, kz, *,
                block_size: int, emit_gam_mu: bool = True,
                c_one: bool = False):
    """One full Gauss-Seidel sweep with fused Z and column reductions.

    x: (n, p); cp_x_y/beta: (p, q); fitted: (n, q); gram_flat: (p, B)
    stacked diagonal Gram blocks; l_aug (p, r+2) / n_stack (3, r+2, q) /
    kz: the interpolation operands (ops/interp.py); theta/p_mask (p,);
    zeta/q_mask/sig2_beta/tau (q,); c, kz 0-d.  Returns (beta', gam'|None,
    mu'|None, fitted', z_row (p,), z_col (q,), (colsum gam, colsum mu^2 gam,
    colsum beta^2)).  The inputs are not modified.

    Replicas: the state's operands (l_aug, n_stack, beta, fitted, theta,
    zeta, sig2_beta, tau, kz) may carry a leading axis of m replicas, and
    then cp_x_y and c may too; every output then carries it.  That is one
    kernel launch for all m sweeps.

    CPU tensors run `sweep_fused_plain`; CUDA tensors launch the kernel
    (csrc/sweep_fused.cu) or raise.  `sweep_fused.launches` counts kernel
    launches (one per call, whatever m).
    """
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"sweep_fused: unsupported device {x.device}")
    fn = _sweep_fused_cuda if x.device.type == "cuda" else sweep_fused_plain
    return fn(x, cp_x_y, gram_flat, l_aug, n_stack, beta, fitted, theta,
              p_mask, zeta, q_mask, sig2_beta, tau, c, kz,
              block_size=block_size, emit_gam_mu=emit_gam_mu, c_one=c_one)


sweep_fused.launches = 0


def fused_operands(x, cp_x_y, gram_blocks, beta, fitted, consts, block_size,
                   p_mask=None, q_mask=None, interp_r: int = 40):
    """The positional operands of `sweep_fused` for one iteration: the
    flattened Gram blocks and the interpolation operands (ops/interp.py)."""
    p = x.shape[1]
    q = beta.shape[1]
    gram_flat = gram_blocks.reshape(p, block_size)
    if p_mask is None:
        p_mask = torch.ones(p, dtype=beta.dtype, device=beta.device)
    if q_mask is None:
        q_mask = torch.ones(q, dtype=beta.dtype, device=beta.device)
    # folded logit constant: ad = c*(d(u) - cst), cst = -log(tau sig2_inv
    # s2)/2 (reference src/coreLoop.cpp:52-57)
    cst = -0.5 * (consts.log_tau + consts.log_sig2_inv
                  + torch.log(consts.sig2_beta))
    l_aug, n_stack, kz = tail_interp_operands(
        consts.theta, consts.zeta, cst, consts.c, p_mask, r=interp_r)
    return (x, cp_x_y, gram_flat, l_aug, n_stack, beta, fitted, consts.theta,
            p_mask, consts.zeta, q_mask, consts.sig2_beta, consts.tau,
            consts.c, kz)


def sweep_complete_fused(x, cp_x_y, gram_blocks, beta, fitted, consts,
                         block_size, p_mask=None, q_mask=None,
                         interp_r: int = 40, emit_gam_mu: bool = True,
                         annealed: bool = False):
    """Driver-facing wrapper matching ops/sweep.py:sweep_complete, carrying
    beta = gam * mu_beta.  annealed=False asserts the converged phase
    (c == 1), which the kernel specializes on; annealed=True takes the
    tempered path for any consts.c."""
    return sweep_fused(
        *fused_operands(x, cp_x_y, gram_blocks, beta, fitted, consts,
                        block_size, p_mask, q_mask, interp_r),
        block_size=block_size, emit_gam_mu=emit_gam_mu, c_one=not annealed)
