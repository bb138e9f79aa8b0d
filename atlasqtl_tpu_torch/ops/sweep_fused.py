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

bf16=True is the TPU kernel's mxu_bf16 mode (atlasqtl_tpu/ops/
sweep_fused.py:151-160, 366-371): the operands of the two products are
rounded to bfloat16 (x once per fit, F before each projection, delta
before each advance) and the products accumulate in float32, on the card
as tensor-core mma.sync tiles (the kernel's bf16 instance); the chain's
Gram corrections and the interpolation products stay float32.  A block
over FUSED_BMAX is the JAX kernel's block there too: the kernel walks it in
its `sub_block` pieces, but projects each against the bf16 F of the block's
start and passes the earlier pieces' deltas through the float32 Gram, as
the whole-block sweep of the plain version and of JAX does.  lookahead=True
(Config.sweep_lookahead under mxu_bf16) is the TPU kernel's one-block-
lookahead schedule there, another function under bf16 (`sweep_fused`
says which); the kernel's bf16 instance has a variant for it.

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
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

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
    source, all started together, then one link; each nvcc's wall seconds
    go to `build.seconds` by source name.  verbose rebuilds and prints
    ptxas's register and shared-memory report (kept in
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
    def compile_one(src, obj):
        t = time.perf_counter()
        proc = subprocess.run(
            [nvcc, *_NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
             "-c", "-o", str(obj), str(src)], capture_output=True, text=True)
        return proc, time.perf_counter() - t

    with ThreadPoolExecutor(len(_SOURCES)) as pool:
        runs = list(pool.map(compile_one, _SOURCES, objs))
    build.seconds = {src.name: sec for src, (_, sec) in zip(_SOURCES, runs)}
    errs = [proc.stderr for proc, _ in runs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        for src, (proc, _), err in zip(_SOURCES, runs, errs):
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
build.seconds = {}


def _load():
    """The ctypes handle of the kernel library (every sweep kernel), built
    at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.atlasqtl_sweep_fused.argtypes = [ptr] * 23 + [i32] * 14 + [ptr] * 5
        lib.atlasqtl_sweep_staggered.argtypes = [ptr] * 23 + [i32] * 7 + [ptr]
        for fn in (lib.atlasqtl_sweep_fused, lib.atlasqtl_sweep_staggered):
            fn.restype = i32
        lib.atlasqtl_sweep_fused_clocks.argtypes = [ptr]
        lib.atlasqtl_sweep_fused_clocks.restype = i32
        lib.atlasqtl_sweep_fused_occupancy.argtypes = [i32] * 4
        lib.atlasqtl_sweep_fused_occupancy.restype = i32
        lib.atlasqtl_sweep_fused_smem.argtypes = [i32] * 5
        lib.atlasqtl_sweep_fused_smem.restype = ctypes.c_longlong
        lib.atlasqtl_sweep_fused_launch_smem.argtypes = [i32] * 2
        lib.atlasqtl_sweep_fused_launch_smem.restype = ctypes.c_longlong
        lib.atlasqtl_sweep_staggered_occupancy.argtypes = [i32] * 3
        lib.atlasqtl_sweep_staggered_occupancy.restype = i32
        lib.atlasqtl_sweep_staggered_smem.argtypes = [i32] * 3
        lib.atlasqtl_sweep_staggered_smem.restype = ctypes.c_longlong
        lib.atlasqtl_sweep_staggered_clocks.argtypes = [ptr]
        lib.atlasqtl_sweep_staggered_clocks.restype = i32
        lib.atlasqtl_inner_gs_occupancy.argtypes = [i32] * 3
        lib.atlasqtl_inner_gs_occupancy.restype = i32
        lib.atlasqtl_sweep_missing_fused.argtypes = ([ptr] * 20 + [i32] * 11
                                                     + [ptr] * 3)
        lib.atlasqtl_sweep_missing_fused.restype = i32
        lib.atlasqtl_sweep_missing_smem.argtypes = [i32] * 7
        lib.atlasqtl_sweep_missing_smem.restype = i32
        lib.atlasqtl_sweep_missing_occupancy.argtypes = [i32] * 5 + [ptr]
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
# the slice widths of the probe instances that take a block over
# FUSED_BMAX in pieces (at 40 columns the pieces' code would spill B1's
# f32 schedule); the others are built at FUSED_WIDTHS
FUSED_PROBE_PIECE_WIDTHS = (32,)
FUSED_NCH = 32            # sample rows per pass chunk
FUSED_NSTAGE = 3          # F and x_b chunk stages
FUSED_NXA = 2             # x_{b-1} chunk stages
FUSED_LA_NXB = 4          # the lookahead kernel's x_b and x_{b-2} stages
FUSED_LA_NXA = 3
FUSED_NG = 4              # thread groups of the two products
FUSED_W = 8               # chain window
FUSED_HLD = 40            # bf16 row of an F chunk or delta tile (odd 16 B)
FUSED_BF16_NCH = 64       # the bf16 instance's sample rows per pass chunk


def _ld16(width: int) -> int:
    """csrc/sweep_fused.cu:ld16: a bf16 row of `width` values padded to an
    odd number of 16-byte units (ldmatrix without bank conflicts)."""
    return width if (width // 8) % 2 else width + 8


def _fused_smem_bytes(width: int, block: int, r_aug: int,
                      bf16: bool = False, lookahead: bool = False) -> int:
    """csrc/sweep_fused.cu:smem_bytes for `width`-column slices: the packed
    Gram triangle, the delta and projection tiles, the pass stages (F, x_b
    and x_{b-1} chunks, x rows padded by 4), the advance partials, the
    window tiles (corrections twice, cp and beta rows three times), the
    nodes, the block's p_mask and theta, the slice's zeta and q_mask.  The
    bf16 instance's stages hold chunks of FUSED_BF16_NCH rows, from a
    1024-byte boundary (256 floats kept for it): two of F in f32 rows of
    the slice's columns (its TMA box), two each of x_{b-1} and x_b in
    tiles of 16, 32 or 64 bf16 columns (the block rounded up to 16, to
    the tile), two bf16 F chunks of FUSED_HLD; no advance partial; then
    two 8-byte mbarriers (the chunks come by TMA) and a bf16 delta tile
    of the block rounded up to 32 rows.  lookahead: the lookahead
    variant's overlapped kernel (whole blocks; la_smem_bytes),
    whose pass and chain run at once: two more B x QS tiles (the logit
    tile, gam), two blocks' p_mask and theta, the pass threads' z_col
    partials (32 x QS), and the stages sized for the
    largest of the pass (x chunks two ahead: four stages of x_b, three of
    x_{b-2}), the goff rows (B rows of B + 4) and the nodes with two
    blocks' rows of L and the z_row partials; every buffer sized for block
    128 and r + 2 = 48, whatever the launch's (constant offsets).  The
    card holds it to the kernel's own (`kernel_smem_bytes`)."""
    gp = (block * (block + 1) // 2 + 3) & ~3
    if lookahead:  # sized for block 128 and r + 2 = 48, whatever B, R
        B, R = FUSED_BMAX, 48
        stages = max(
            FUSED_NSTAGE * FUSED_NCH * width
            + (FUSED_LA_NXB + FUSED_LA_NXA) * FUSED_NCH * _ld16(B) // 2
            + FUSED_NCH * width + FUSED_NCH * FUSED_HLD,
            B * (B + 4), 3 * R * width + 2 * B * R + B * (width // 4))
        return 4 * ((B * (B + 1) // 2 + 3 & ~3) + 4 * B * width + stages
                    + 8 * FUSED_W * width + 4 * B + 2 * width
                    + B * FUSED_HLD // 2 + 32 * width)
    if bf16:
        b16 = -(-block // 16) * 16
        xw = 16 if b16 <= 16 else 32 if b16 <= 32 else 64
        stages = (256 + FUSED_BF16_NCH * (2 * width + FUSED_HLD)
                  + 4 * -(-b16 // xw) * FUSED_BF16_NCH * xw // 2)
    else:
        stages = (FUSED_NSTAGE * FUSED_NCH * width
                  + (FUSED_NSTAGE + FUSED_NXA) * FUSED_NCH * (block + 4)
                  + FUSED_NG * FUSED_NCH * width)
    return 4 * (gp + 2 * block * width + stages
                + 8 * FUSED_W * width + 3 * r_aug * width + 2 * 128
                + 2 * width
                + bf16 * (4 + -(-block // 32) * 32 * FUSED_HLD // 2))


def sub_block(block: int) -> int:
    """The piece a sweep kernel walks a predictor block in: the block itself
    up to FUSED_BMAX rows, else the largest multiple of 8 up to FUSED_BMAX
    that divides it (block 256: two pieces of 128; block 200: five of 40).
    The Gauss-Seidel order is unchanged: a coordinate of a later piece sees
    the earlier pieces' updates through F (x_j^T (F + X_1 delta_1) =
    x_j^T F + G_j1 delta_1), so the sweep equals the whole-block sweep up to
    rounding (B1's bf16 instance, where rounding F to bf16 would make them
    differ by more, passes them through G_j1 itself).  Raises ValueError for a block that is not a positive
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
                      sms: int = H100_SMS, m: int = 1,
                      bf16: bool = False, lookahead: bool = False,
                      probe: bool = False) -> dict:
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
    piece and sizes the rest itself.  bf16: the plan of the bf16 instance
    (mxu_bf16), the same width and grid, its own shared memory (under 210
    KB at block 128: still one CTA per SM).  lookahead (with bf16): its
    lookahead variant, whose overlapped kernel takes a block up to
    FUSED_BMAX whole (224 KB at block 128, width 40, r + 2 = 48) and a
    larger block in pieces through the bf16 instance's serial schedule.
    probe: the plan of the probe instances, the float32 one's (they run
    its schedule in slices of FUSED_WIDTHS, B1's), but for a block
    over FUSED_BMAX in FUSED_PROBE_PIECE_WIDTHS.  `widths` names the
    widths the plan chose among.  Raises ValueError on a shape the kernel
    does not take."""
    if (n <= 0 or block <= 0 or block % FUSED_W or q <= 0 or q % 4
            or not 0 < r_aug <= 48 or m < 1):
        raise ValueError(f"sweep_fused kernel: unsupported shape n={n}, "
                         f"q={q}, block={block}, r+2={r_aug}, m={m}")
    sub = sub_block(block)
    widths = (FUSED_WIDTHS if not probe
              else FUSED_WIDTHS if sub == block
              else FUSED_PROBE_PIECE_WIDTHS)
    width, waves = _widest_fill(q, widths, sms, m)
    return dict(slice_width=width, widths=widths, sub_block=sub, cluster=1,
                grid=-(-q // width), waves=waves,
                smem_bytes=_fused_smem_bytes(
                    width, sub, r_aug, bf16,
                    lookahead=bf16 and lookahead and sub == block),
                ctas_per_sm=1, zrow_parts=1)


def _widest_fill(q: int, widths, sms: int, m: int = 1):
    """(width, waves) of the slice width among `widths` whose slices of m
    replicas fill whole waves of `sms` SMs best: the fewest columns of SM
    time (waves x width), the narrower on a tie."""
    waves = lambda w: -(-(m * -(-q // w)) // sms)
    width = min(widths, key=lambda w: (waves(w) * w, w))
    return width, waves(width)


def occupancy(width: int, block: int, r_aug: int, bf16: bool = False) -> int:
    """CTAs of B1 (its bf16 instance if bf16) in `width`-column slices
    resident on one SM at (block, r + 2), from the occupancy calculator on
    the card."""
    return _load().atlasqtl_sweep_fused_occupancy(width, block, r_aug,
                                                  int(bf16))


def kernel_smem_bytes(width: int, block: int, r_aug: int,
                      bf16: bool = False, lookahead: bool = False) -> int:
    """The kernel's own shared-memory bytes at (width, block, r + 2) (of
    its bf16 instance if bf16, of the lookahead variant's overlapped kernel
    if lookahead), -1 where it refuses them."""
    return _load().atlasqtl_sweep_fused_smem(width, block, r_aug, int(bf16),
                                             int(lookahead))


def launch_smem_bytes(width: int, bf16: bool = False) -> int:
    """The dynamic shared-memory bytes that the latest launch of B1 (its
    bf16 instance if bf16) in `width`-column slices set for its kernel."""
    return _load().atlasqtl_sweep_fused_launch_smem(width, int(bf16))


PHASES = ("pass", "tiles", "chain", "z_tile", "total")
# the overlapped lookahead kernel's: its first pass thread's busy cycles in
# the passes beside a chain, the part of them inside the chain's span, and
# the chain thread's wait for the helper warps at the end of its windows
LA_PHASES = PHASES + ("pass_busy", "pass_in_chain", "chain_wait")


def phase_clocks(lookahead: bool = False) -> dict:
    """The SM clock cycles the latest B1 launch's first CTA spent in each
    phase, summed over the blocks (its thread 0, which also runs the chain;
    csrc/sweep_fused.cu:g_clocks).  lookahead: those of the latest launch
    of the lookahead variant's overlapped kernel (whole blocks): "pass" is
    the chain thread's wait for the passes (beyond each chain, and the
    first and last passes, which run alone), "chain" its chains; "tiles"
    (the goff product) and "z_tile" (the rows of L, the Z and logit tiles)
    are the first pass thread's between the chains; with LA_PHASES' three
    more."""
    names = LA_PHASES if lookahead else PHASES
    out = (ctypes.c_longlong * len(LA_PHASES))()
    err = _load().atlasqtl_sweep_fused_clocks(out)
    if err != 0:
        raise RuntimeError("sweep_fused clocks: "
                           + _load().atlasqtl_error_string(err).decode())
    return dict(zip(names, out))


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


class Probe(NamedTuple):
    """What one perf probe of B1 keeps of the sweep (atlasqtl_tpu/ops/
    sweep_fused.py:116-212, 265-361, 429-433, 509-519): the probit tiles
    (else the logit tile is u = theta + zeta), the projection x_b^T F
    (else r = X^T Y's rows), the within-window pushes, the cross-window
    corrections (with neither, the Jacobi update), the sigmoid (else
    clip(logit, 0, 1)), the advance F += x_b delta, the Z Mills tiles
    (else z = gam), and dmalite's pin of x and X^T Y to block 0."""
    tiles: bool = True
    proj: bool = True
    pushes: bool = True
    corrections: bool = True
    sigmoid: bool = True
    advance: bool = True
    mills: bool = True
    pin: bool = False

    @property
    def jacobi(self) -> bool:
        return not self.pushes and not self.corrections

    @property
    def diagonal(self) -> bool:
        """Whether r loses beta diag(G): after the projection, and in the
        Jacobi update (nomxu's r = X^T Y too: atlasqtl_tpu/ops/
        sweep_fused.py:199-201)."""
        return self.proj or self.jacobi

    def code(self, bf16: bool) -> int:
        """The probe instances' code (csrc/sweep_fused.cu:PrBits): one bit
        per part kept, the diagonal's, and bf16 x; the sigmoid's bit, bf16
        x, the pin and (with the window) the pushes' and corrections' bits
        pick the instance (PrInst), the others are read once per block."""
        return (sum(int(v) << i for i, v in enumerate(self))
                | int(self.diagonal) << len(self) | int(bf16) << len(self) + 1)


# the JAX kernel's eleven probes
PROBES = {
    "jacobi": Probe(pushes=False, corrections=False),
    "jacobi_min": Probe(tiles=False, pushes=False, corrections=False,
                        mills=False),
    "nomxu": Probe(tiles=False, proj=False, pushes=False, corrections=False,
                   advance=False, mills=False),
    "nor0": Probe(proj=False),
    "chain_only": Probe(tiles=False, proj=False, advance=False, mills=False),
    "exact_noz": Probe(mills=False),
    "noseq": Probe(pushes=False, mills=False),
    "nosig": Probe(sigmoid=False, mills=False),
    "norank": Probe(corrections=False, mills=False),
    "noadv": Probe(advance=False),
    "dmalite": Probe(pin=True),
}


def probe_parts(probe: str) -> Probe:
    """The `Probe` of Config.sweep_probe's value `probe`; ValueError for a
    value that is neither one of PROBES nor "none" (the JAX kernel runs no
    chain and leaves delta unwritten there)."""
    if probe not in PROBES:
        raise ValueError(f"unknown sweep probe {probe!r}: one of "
                         f"{', '.join(PROBES)} (or 'none')")
    return PROBES[probe]


def probe_window_ok(window: int) -> bool:
    """Whether B1's probe instances take the chain window `window`: every
    positive window (`fused_window` holds it to a divisor of the block).
    They run B1's chain on the block's Gram triangle with the entries of
    what the probe drops (pushes inside a window, corrections across
    windows) zeroed as it lands, on the 8-row grid and off it alike."""
    return window >= 1


def fused_window(sub: int, block: int, what: str = "sweep_fused probe",
                 name: str = "sub") -> int:
    """A JAX fused kernel's window at its `sub` and predictor block
    `block`: min(sub, block) (atlasqtl_tpu/ops/sweep_fused.py:500,
    sweep_missing_fused.py:272); ValueError, naming `what` and the field
    `name`, where it does not divide the block (those kernels' asserts).
    B1's probes' chain window: under noseq and norank it changes the
    function, the other probes do not depend on it beyond rounding."""
    s = min(int(sub), int(block))
    if s < 1 or block % s:
        raise ValueError(f"{what}: the window {name}={sub} (clipped to {s}) "
                         f"must divide the predictor block {block}")
    return s


def _probe_chain(r, g, ad, cp_b, beta_b, ct, c_inv_2s2, sub, parts):
    """The JAX kernel's windowed chain of one block under a probe
    (atlasqtl_tpu/ops/sweep_fused.py:194-358): windows of `sub` rows; before
    window s the corrections G[lo:lo+sub, :lo] delta[:lo] (if kept), inside
    it each row's push to the window's later rows (if kept); with neither
    it is the Jacobi update.  Returns (gam, mu, delta)."""
    B = beta_b.shape[0]
    gam_b = torch.empty_like(beta_b)
    mu_b = torch.empty_like(beta_b)
    delta = torch.zeros_like(beta_b)
    for lo in range(0, B, sub):
        if lo and parts.corrections:
            r[lo:lo + sub] += g[lo:lo + sub, :lo] @ delta[:lo]
        for i in range(lo, lo + sub):
            mu_i = ct * (cp_b[i] - r[i])
            logit = ad[i] + mu_i * mu_i * c_inv_2s2
            gam_i = (torch.sigmoid(logit) if parts.sigmoid
                     else torch.clamp(logit, 0.0, 1.0))
            delta[i] = gam_i * mu_i - beta_b[i]
            if parts.pushes:
                r[i + 1:lo + sub] += g[i + 1:lo + sub, i, None] * delta[i]
            gam_b[i], mu_b[i] = gam_i, mu_i
    return gam_b, mu_b, delta


def _sweep_fused_probe_one(x, cp_x_y, gram_flat, l_aug, n_stack, beta,
                           fitted, theta, p_mask, zeta, q_mask, sig2_beta,
                           tau, c, kz, goff, *, block_size, emit_gam_mu,
                           c_one, bf16, probe, sub):
    """B1 under the perf probe `probe` in windows of `sub`, as the JAX
    kernel computes it (its whole block, whatever the block; `PROBES`
    says what each probe keeps; goff, the lookahead's, is not read: no
    probe takes the lookahead)."""
    parts = probe_parts(probe)
    B = block_size
    ct = c * sig2_beta * tau
    c_inv_2s2 = c * 0.5 / sig2_beta
    out = _new_outputs(beta, theta, emit_gam_mu)
    rnd = ((lambda t: _bf16_round(t, fitted.dtype)) if bf16
           else (lambda t: t))
    xp = rnd(x)
    for b in range(x.shape[1] // B):
        sl = slice(b * B, (b + 1) * B)
        xs = slice(0, B) if parts.pin else sl   # dmalite: block 0's x, cp
        xb, g = xp[:, xs], gram_flat[sl]
        u = theta[sl, None] + zeta[None, :]
        if parts.tiles:
            ad, imrd, imr0u = _tiles(u, l_aug[sl], n_stack, c, kz, c_one)
        else:
            ad = u
        diag = torch.diagonal(g)[:, None]
        r = xb.T @ rnd(fitted) if parts.proj else cp_x_y[xs].clone()
        if parts.diagonal:
            r = r - beta[sl] * diag
        gam_b, mu_b, delta = _probe_chain(r, g, ad, cp_x_y[xs], beta[sl], ct,
                                          c_inv_2s2, sub, parts)
        if parts.advance:
            fitted = fitted + xb @ rnd(delta)
        z_b = gam_b * imrd + imr0u if parts.mills else gam_b
        _emit_block(out, sl, gam_b, mu_b, z_b, p_mask[sl], q_mask)
    return _outputs(out, fitted)


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


# sweep_fused's operands: x, the Gram blocks, the masks and the lookahead's
# off-diagonal Gram blocks are shared by all replicas; X^T Y (each
# replica's own in impute mode) and c (one temperature) may be either
FUSED = Operands(
    dict(x=2, cp_x_y=2, gram_flat=2, l_aug=2, n_stack=3, beta=2, fitted=2,
         theta=1, p_mask=1, zeta=1, q_mask=1, sig2_beta=1, tau=1, c=0, kz=0,
         goff=2),
    shared=("x", "gram_flat", "p_mask", "q_mask", "goff"),
    either=("cp_x_y", "c"))


def sweep_fused_plain(x, cp_x_y, gram_flat, l_aug, n_stack, beta, fitted,
                      theta, p_mask, zeta, q_mask, sig2_beta, tau, c, kz,
                      goff=None, *, block_size: int, emit_gam_mu: bool = True,
                      c_one: bool = False, bf16: bool = False,
                      lookahead: bool = False, probe: str = "none",
                      sub: int = 16):
    """The kernel's function in plain tensor ops, block by block and row by
    row in flat sequential order; under a perf probe the JAX kernel's
    windowed chain in windows of `fused_window(sub, block_size)`, with what
    the probe drops left out (`_sweep_fused_probe_one`).  Same arguments
    and outputs as `sweep_fused`; with a replica axis, one replica after
    another."""
    args = (x, cp_x_y, gram_flat, l_aug, n_stack, beta, fitted, theta, p_mask,
            zeta, q_mask, sig2_beta, tau, c, kz, goff)
    kw = dict(block_size=block_size, emit_gam_mu=emit_gam_mu, c_one=c_one,
              bf16=bf16)
    one = _sweep_fused_plain_one
    if probe != "none":
        one = _sweep_fused_probe_one
        kw.update(probe=probe, sub=fused_window(sub, block_size))
    else:
        kw["lookahead"] = lookahead
    if beta.dim() == 3:
        return FUSED.loop(one, args, kw)
    return one(*args, **kw)


def _bf16_round(t, dtype):
    """t rounded to bfloat16 (round to nearest even), in `dtype`."""
    return t.to(torch.bfloat16).to(dtype)


def _sweep_fused_plain_one(x, cp_x_y, gram_flat, l_aug, n_stack, beta,
                           fitted, theta, p_mask, zeta, q_mask, sig2_beta,
                           tau, c, kz, goff, *, block_size, emit_gam_mu,
                           c_one, bf16, lookahead):
    B = block_size
    ct = c * sig2_beta * tau
    c_inv_2s2 = c * 0.5 / sig2_beta
    out = _new_outputs(beta, theta, emit_gam_mu)
    # the products' operands: bf16 rounds x (once), F and delta
    rnd = ((lambda t: _bf16_round(t, fitted.dtype)) if bf16
           else (lambda t: t))
    xp = rnd(x)
    # lookahead: block b projects F before block b-1's advance (F_{<=b-2}),
    # and block b-1's deltas come in through goff[b-1] = x_b^T x_{b-1}
    f_proj = fitted
    delta = None
    for b in range(x.shape[1] // B):
        sl = slice(b * B, (b + 1) * B)
        xb, g = xp[:, sl], gram_flat[sl]
        ad, imrd, imr0u = _tiles(theta[sl, None] + zeta[None, :], l_aug[sl],
                                 n_stack, c, kz, c_one)
        r = xb.T @ rnd(f_proj if lookahead else fitted)
        if lookahead and b > 0:
            r = r + goff[sl.start - B:sl.start] @ delta
        r = r - beta[sl] * torch.diagonal(g)[:, None]
        gam_b, mu_b, delta = _chain(r, g, ad, cp_x_y[sl], beta[sl], ct,
                                    c_inv_2s2)
        f_proj = fitted
        fitted = fitted + xb @ rnd(delta)
        _emit_block(out, sl, gam_b, mu_b, gam_b * imrd + imr0u, p_mask[sl],
                    q_mask)
    return _outputs(out, fitted)


def fused_launch(entry, x, cp_x_y, gram_flat, l_aug, n_stack, beta, fitted,
                 theta, p_mask, zeta, q_mask, sig2_beta, tau, c, kz,
                 goff=None, *, block_size, emit_gam_mu, c_one,
                 slice_width=None, plan=None, bf16=False, lookahead=False,
                 probe=None, window=8):
    """Check the operands of one fused-sweep launch and launch the C entry
    point `entry` of the kernel library (atlasqtl_sweep_fused, B1, or
    atlasqtl_sweep_staggered, B4: the same arguments and function) under
    `plan(n, q, block, r + 2, sms)` (None: B1's `fused_launch_plan`), whose
    slice width `slice_width` overrides; a block over FUSED_BMAX goes in as
    its `sub_block` pieces with their Gram pieces (B1's bf16 instance also
    reads the whole blocks, and two workspaces).  B1 takes a replica axis
    (the state's operands of `FUSED` stacked): one launch of grid x m
    CTAs, each replica's outputs bit for bit those of its own launch in
    slices of the same width (the plan for m replicas may pick another
    width than one replica's, and z_row then sums in another order).
    bf16 launches B1's bf16 instance (mxu_bf16), whose x is the bfloat16
    copy (`bf16_operand`); B4 has none.  lookahead launches that instance's
    lookahead variant, which also reads `goff` (`lookahead_gram`).  probe
    (a `Probe`) launches one of B1's probe instances, in windows of
    `window` (any that divides the block, `fused_window`): the float32
    instance's schedule in its plan, reading the bf16 copy of x under bf16;
    a block in pieces is the whole block there (each piece projects the
    block-start F, the block's advance deferred to its last piece, the
    earlier pieces' deltas through the Gram where the probe keeps them),
    its deltas in a workspace.  `Probe()` (every part kept) in float32 is
    B1 itself: it launches the float32 instance.  Raises on what the
    kernels cannot take and on a failed launch."""
    n, p = x.shape[-2:]
    q = beta.shape[-1]
    r_aug = l_aug.shape[-1]
    what = entry.replace("atlasqtl_", "")
    if probe == Probe() and not bf16:
        probe = None   # every part kept: B1's float32 instance
    args = (x, cp_x_y, gram_flat, l_aug, n_stack, beta, fitted, theta, p_mask,
            zeta, q_mask, sig2_beta, tau, c, kz, goff)
    try:
        m, batched = FUSED.replica_axis(args)
    except ValueError as e:
        raise ValueError(f"{what} kernel: {e}") from None
    if any(batched) and entry != "atlasqtl_sweep_fused":
        raise ValueError(f"{what} kernel: no replica axis (B1 only)")
    if bf16 and entry != "atlasqtl_sweep_fused":
        raise ValueError(f"{what} kernel: no bf16 instance (mxu_bf16 "
                         "reaches B1 only)")
    if probe is not None and (lookahead or entry != "atlasqtl_sweep_fused"):
        raise ValueError(f"{what} kernel: a probe runs B1's probe instance, "
                         "without the lookahead")
    if probe is not None and not probe_window_ok(
            fused_window(window, block_size)):
        raise ValueError(f"{what} kernel: probe window "
                         f"{fused_window(window, block_size)}")
    if lookahead and not bf16:
        raise ValueError(f"{what} kernel: lookahead is a variant of B1's "
                         "bf16 instance (in float32 it is the same algebra "
                         "as the baseline, which the port runs)")
    if (goff is not None) != bool(lookahead):
        raise ValueError(f"{what} kernel: goff goes with lookahead and only "
                         "with it")
    shapes = ((n, p), (p, q), (p, block_size), (p, r_aug), (3, r_aug, q),
              (p, q), (n, q), (p,), (p,), (q,), (q,), (q,), (q,), (), (),
              (p, block_size))
    for i, (name, shape) in enumerate(zip(FUSED.names, shapes)):
        if name in ("c", "kz") or (name == "goff" and goff is None):
            continue
        t = args[i]
        shape = (m, *shape) if batched[i] else shape
        # every replica's slice is 16-byte aligned too
        step = t[0].numel() * 4 if batched[i] else 0
        # the bf16 instance stages the bfloat16 copy of x
        dt = torch.bfloat16 if bf16 and i == 0 else torch.float32
        if (t.device.type != "cuda" or t.dtype != dt
                or not t.is_contiguous() or tuple(t.shape) != shape
                or t.data_ptr() % 16 or step % 16):
            raise ValueError(
                f"{what} kernel: {name} must be a contiguous, 16-byte "
                f"aligned {str(dt)[6:]} CUDA tensor of shape {shape}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if (block_size <= 0 or block_size % 8 or p % block_size or q % 4
            or r_aug > 48):
        raise ValueError(f"{what} kernel: unsupported shape n={n}, p={p},"
                         f" q={q}, block={block_size}, r+2={r_aug}")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    # the probe instances run the float32 one's schedule (bf16 x or not)
    inst_bf16 = bool(bf16) and probe is None
    launch = (plan(n, q, block_size, r_aug, sms) if plan is not None
              else fused_launch_plan(n, q, block_size, r_aug, sms, m,
                                     inst_bf16, lookahead,
                                     probe=probe is not None))
    slice_width = slice_width or launch["slice_width"]
    sub = launch["sub_block"]
    if (probe is not None and sub < block_size
            and slice_width not in FUSED_PROBE_PIECE_WIDTHS):
        raise ValueError(f"{what} kernel: a probe takes a block over "
                         f"{FUSED_BMAX} in slices of "
                         f"{FUSED_PROBE_PIECE_WIDTHS} columns only, not "
                         f"{slice_width}")
    gram_full = gram_flat
    gram_flat = sub_block_gram(gram_flat, block_size, sub)
    lib = _load()
    dev = x.device
    lead = (m,) if any(batched) else ()
    # c and K/c
    scal = torch.stack([as_scalar(v, torch.float32, dev).expand(lead)
                        for v in (c, kz)], dim=-1).contiguous()
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
    # the bf16 instance's workspaces for a block in pieces: the bf16 F of
    # the block's start and the earlier pieces' deltas, for all slices;
    # under lookahead two of each, by the block's parity (a block projects
    # the previous block's start F and takes all of its deltas)
    fh_ws = dw_ws = None
    if probe is not None and block_size > sub:
        cols = -(-q // slice_width) * slice_width
        dw_ws = torch.empty((*lead, block_size - sub, cols),
                            dtype=torch.float32, device=dev)
    elif bf16 and block_size > sub:
        cols = -(-q // slice_width) * slice_width
        fh_ws = torch.empty((*lead, 2 if lookahead else 1, n, cols),
                            dtype=torch.bfloat16, device=dev)
        dw_ws = torch.empty((*lead, 2 * block_size if lookahead
                             else block_size - sub, cols),
                            dtype=torch.float32, device=dev)
    # B1's replica count, whether X^T Y is per replica, its instance and
    # variant, the whole block and what its bf16 instance reads of it
    # B1's probe instances: the probe's code (-1: none) and window
    extra = ((m, int(batched[1]), int(inst_bf16), int(bool(lookahead)),
              block_size, -1 if probe is None else probe.code(bf16),
              fused_window(window, block_size) if probe is not None else 0,
              ptr(gram_full), ptr(goff), ptr(fh_ws), ptr(dw_ws))
             if entry == "atlasqtl_sweep_fused" else ())
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
                           f"{slice_width}-column slices, {m} replica(s)"
                           f"{', bf16' if bf16 else ''}"
                           f"{', lookahead' if lookahead else ''}"
                           f"{f', probe {probe}' if probe else ''}: "
                           + lib.atlasqtl_error_string(err).decode())
    return beta_out, gam_out, mu_out, fitted, z_row, z_col, (gcol, m2gcol,
                                                             b2col)


def _sweep_fused_cuda(*args, bf16=False, lookahead=False, probe="none",
                      sub=16, **kw):
    parts = None if probe == "none" else probe_parts(probe)
    out = fused_launch("atlasqtl_sweep_fused", *args, bf16=bf16,
                       lookahead=lookahead, probe=parts, window=sub, **kw)
    sweep_fused.launches += 1
    if parts is not None:
        sweep_fused.probe.launches += 1
    elif bf16:
        sweep_fused.bf16.launches += 1
    if lookahead:
        sweep_fused.lookahead.launches += 1
    return out


def sweep_fused(x, cp_x_y, gram_flat, l_aug, n_stack, beta, fitted, theta,
                p_mask, zeta, q_mask, sig2_beta, tau, c, kz, goff=None, *,
                block_size: int, emit_gam_mu: bool = True,
                c_one: bool = False, bf16: bool = False,
                lookahead: bool = False, probe: str = "none", sub: int = 16):
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

    bf16 (Config.mxu_bf16): the two products take bfloat16 operands with
    float32 accumulation; x is then the bfloat16 copy of x
    (`bf16_operand`; the plain version also takes float32 x and rounds
    it), and only then may it be bfloat16.

    lookahead (Config.sweep_lookahead under mxu_bf16; bf16 only): the TPU
    kernel's one-block-lookahead schedule (atlasqtl_tpu/ops/sweep_fused.py:
    166-184, 378-388), another function under bf16.  Block b >= 1 projects
    the bf16 F from before block b-1's advance, and block b-1's float32
    deltas come in through the float32 off-diagonal Gram `goff`
    (`lookahead_gram`, required then): r_b = bf16(x_b)^T bf16(F_{<=b-2})
    + goff[b-1] delta_{b-1} - beta_b diag(G_b).  Block 0 and the advance
    are unchanged.

    probe (Config.sweep_probe): one of the TPU kernel's perf probes
    (`PROBES`: each drops one phase of the sweep, wrong math by design),
    in its windows of `sub` predictors (`fused_window(sub, block_size)`,
    ValueError where it does not divide the block); under bf16 its two
    products stay bf16; not with the lookahead.  sub is read only under a
    probe.

    CPU tensors run `sweep_fused_plain`; CUDA tensors launch the kernel
    (csrc/sweep_fused.cu; its bf16 instance if bf16, that instance's
    lookahead variant if lookahead, its probe instance under a probe) or
    raise.  `sweep_fused.launches` counts kernel launches (one per call,
    whatever m, any instance), `sweep_fused.bf16.launches` those of the
    bf16 instance (lookahead or not), `sweep_fused.lookahead.launches`
    those of its lookahead variant, `sweep_fused.probe.launches` those of
    the probe instance (bf16 or not).
    """
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"sweep_fused: unsupported device {x.device}")
    if x.dtype == torch.bfloat16 and not bf16:
        raise ValueError("sweep_fused: a bfloat16 x is the operand of the "
                         "bf16 mode (bf16=True)")
    if lookahead and (not bf16 or goff is None):
        raise ValueError("sweep_fused: lookahead is a schedule of the bf16 "
                         "mode (bf16=True) and takes goff (lookahead_gram)")
    if probe != "none":
        probe_parts(probe)
        fused_window(sub, block_size)
        if lookahead:
            raise ValueError("sweep_fused: no probe takes the lookahead "
                             "(atlasqtl_tpu/ops/sweep_fused.py:669)")
    fn = _sweep_fused_cuda if x.device.type == "cuda" else sweep_fused_plain
    return fn(x, cp_x_y, gram_flat, l_aug, n_stack, beta, fitted, theta,
              p_mask, zeta, q_mask, sig2_beta, tau, c, kz,
              goff if lookahead else None, block_size=block_size,
              emit_gam_mu=emit_gam_mu, c_one=c_one, bf16=bf16,
              lookahead=lookahead, probe=probe, sub=sub)


sweep_fused.launches = 0
sweep_fused.bf16 = types.SimpleNamespace(launches=0)
sweep_fused.lookahead = types.SimpleNamespace(launches=0)
sweep_fused.probe = types.SimpleNamespace(launches=0)


def fused_operands(x, cp_x_y, gram_blocks, beta, fitted, consts, block_size,
                   p_mask=None, q_mask=None, interp_r: int = 40,
                   bf16: bool = False, x_bf16=None):
    """The positional operands of `sweep_fused` for one iteration up to kz
    (goff, the lookahead's, is `lookahead_gram`'s): the flattened Gram
    blocks and the interpolation operands (ops/interp.py); under bf16 (the
    mxu_bf16 mode) x is `bf16_operand(x, x_bf16)`."""
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
    if bf16:
        x = bf16_operand(x, x_bf16)
    return (x, cp_x_y, gram_flat, l_aug, n_stack, beta, fitted, consts.theta,
            p_mask, consts.zeta, q_mask, consts.sig2_beta, consts.tau,
            consts.c, kz)


def bf16_operand(x, x_bf16=None):
    """The x operand of the bf16 mode: `x_bf16` (Data.x_bf16, rounded once
    per fit) if given, else x rounded to bfloat16 now (round to nearest
    even, as JAX's astype)."""
    return x_bf16 if x_bf16 is not None else x.to(torch.bfloat16)


def lookahead_gram(x, block_size: int):
    """The (p, B) float32 stacked off-diagonal Gram blocks of the lookahead
    schedule, goff[b] = x_{b+1}^T x_b (rows: block b+1's predictors), the
    last block's zero: the counterpart of atlasqtl_tpu/ops/sweep_fused.py:
    570-574, from the float32 x (never its bfloat16 copy).  Built once per
    fit (Data.goff), as X does not change; p x B x 4 bytes."""
    n, p = x.shape
    nb = p // block_size
    xr = x.reshape(n, nb, block_size)
    goff = torch.zeros((nb, block_size, block_size), dtype=x.dtype,
                       device=x.device)
    goff[:-1] = torch.einsum("nkj,nki->kji", xr[:, 1:], xr[:, :-1])
    return goff.reshape(p, block_size)


def sweep_complete_fused(x, cp_x_y, gram_blocks, beta, fitted, consts,
                         block_size, p_mask=None, q_mask=None,
                         interp_r: int = 40, emit_gam_mu: bool = True,
                         annealed: bool = False, bf16: bool = False,
                         x_bf16=None, lookahead: bool = False, goff=None,
                         probe: str = "none", sub: int = 16):
    """Driver-facing wrapper matching ops/sweep.py:sweep_complete, carrying
    beta = gam * mu_beta.  annealed=False asserts the converged phase
    (c == 1), which the kernel specializes on; annealed=True takes the
    tempered path for any consts.c.  bf16: the mxu_bf16 mode, x staged as
    `x_bf16` (made from x if None).  lookahead (under bf16 only): the
    lookahead schedule, with `goff` (made from x if None); under a probe
    it is off, as in the JAX wrapper (atlasqtl_tpu/ops/sweep_fused.py:669).
    probe, sub: `sweep_fused`'s."""
    lookahead = lookahead and probe == "none"
    if lookahead and goff is None:
        goff = lookahead_gram(x, block_size)
    return sweep_fused(
        *fused_operands(x, cp_x_y, gram_blocks, beta, fitted, consts,
                        block_size, p_mask, q_mask, interp_r, bf16, x_bf16),
        goff, block_size=block_size, emit_gam_mu=emit_gam_mu,
        c_one=not annealed, bf16=bf16, lookahead=lookahead, probe=probe,
        sub=sub)
