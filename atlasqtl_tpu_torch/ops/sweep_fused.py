"""The fused complete-data sweep: one whole Gauss-Seidel pass per call.

Counterpart of atlasqtl_tpu/ops/sweep_fused.py.  For CUDA tensors the sweep
is the hand-written kernel in csrc/sweep_fused.cu, which replaces the TPU
kernel atlasqtl_tpu/ops/sweep_fused.py:_fused_kernel.  For CPU tensors it is
`sweep_fused_plain`, the same function in plain tensor ops (the kernel is
held against it on the card; the CPU tests hold it against the JAX kernel).

What bounds the kernel on an H100: the two products r0 = x_b^T F and
F += x_b delta, 4 n p q FP32 operations per sweep (no TF32: the reference's
products are full f32); moving the bytes it must move (x, cp, beta in and
out, F) takes under a tenth of that time at 3.35 TB/s.  This first version is simple on
purpose: one CTA per 32 response columns walking every predictor block, FMA
loops over shared-memory tiles, a windowed chain on one warp
(csrc/sweep_fused.cu says more).

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

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
# both kernel sources go into one shared library; each includes the header
_SOURCES = (_CSRC / "sweep_fused.cu", _CSRC / "sweep_missing_fused.cu")
_HEADERS = (_CSRC / "common.cuh",)
_BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
               "-Xcompiler", "-fPIC"]
_lib = None


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
    prints ptxas's register and shared-memory report."""
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
        print("".join(errs), flush=True)
    os.replace(tmp, out)
    return out


def _load():
    """The ctypes handle of the kernel library (both sweeps), built at first
    use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.atlasqtl_sweep_fused.argtypes = [ptr] * 23 + [i32] * 6 + [ptr]
        lib.atlasqtl_sweep_fused.restype = i32
        lib.atlasqtl_sweep_slices.argtypes = [i32]
        lib.atlasqtl_sweep_slices.restype = i32
        lib.atlasqtl_sweep_missing_fused.argtypes = ([ptr] * 20 + [i32] * 5
                                                     + [ptr])
        lib.atlasqtl_sweep_missing_fused.restype = i32
        lib.atlasqtl_sweep_missing_slices.argtypes = [i32]
        lib.atlasqtl_sweep_missing_slices.restype = i32
        lib.atlasqtl_sweep_missing_window.argtypes = []
        lib.atlasqtl_sweep_missing_window.restype = i32
        lib.atlasqtl_error_string.argtypes = [ctypes.c_int]
        lib.atlasqtl_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


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


def sweep_fused_plain(x, cp_x_y, gram_flat, l_aug, n_stack, beta, fitted,
                      theta, p_mask, zeta, q_mask, sig2_beta, tau, c, kz, *,
                      block_size: int, emit_gam_mu: bool = True,
                      c_one: bool = False):
    """The kernel's function in plain tensor ops, block by block and row by
    row in flat sequential order.  Same arguments and outputs as
    `sweep_fused`."""
    p = x.shape[1]
    q = beta.shape[1]
    B = block_size
    ct = c * sig2_beta * tau
    c_inv_2s2 = c * 0.5 / sig2_beta
    fitted = fitted.clone()
    beta_out = torch.empty_like(beta)
    gam_out = torch.empty_like(beta) if emit_gam_mu else None
    mu_out = torch.empty_like(beta) if emit_gam_mu else None
    z_row = torch.empty_like(theta)
    zero_q = lambda: torch.zeros(q, dtype=beta.dtype, device=beta.device)
    z_col, gcol, m2gcol, b2col = zero_q(), zero_q(), zero_q(), zero_q()
    for b in range(p // B):
        sl = slice(b * B, (b + 1) * B)
        xb, g, beta_b, pm = x[:, sl], gram_flat[sl], beta[sl], p_mask[sl]
        ad, imrd, imr0u = _tiles(theta[sl, None] + zeta[None, :], l_aug[sl],
                                 n_stack, c, kz, c_one)
        r = xb.T @ fitted - beta_b * torch.diagonal(g)[:, None]
        gam_b = torch.empty_like(beta_b)
        mu_b = torch.empty_like(beta_b)
        delta = torch.empty_like(beta_b)
        cp_b = cp_x_y[sl]
        for i in range(B):
            mu_i = ct * (cp_b[i] - r[i])
            gam_i = torch.sigmoid(ad[i] + mu_i * mu_i * c_inv_2s2)
            delta[i] = gam_i * mu_i - beta_b[i]
            r[i + 1:] += g[i + 1:, i, None] * delta[i][None, :]
            gam_b[i], mu_b[i] = gam_i, mu_i
        fitted += xb @ delta
        msk = pm[:, None] * q_mask[None, :]
        t_bm = gam_b * mu_b
        beta_out[sl] = t_bm * msk
        if emit_gam_mu:
            gam_out[sl] = gam_b * msk
            mu_out[sl] = mu_b * msk
        gcol += (pm @ gam_b) * q_mask
        m2gcol += (pm @ (t_bm * mu_b)) * q_mask
        b2col += (pm @ (t_bm * t_bm)) * q_mask
        z_qm = (gam_b * imrd + imr0u) * q_mask[None, :]
        z_row[sl] = torch.sum(z_qm, dim=1) * pm
        z_col += pm @ z_qm
    return beta_out, gam_out, mu_out, fitted, z_row, z_col, (gcol, m2gcol,
                                                             b2col)


def _sweep_fused_cuda(x, cp_x_y, gram_flat, l_aug, n_stack, beta, fitted,
                      theta, p_mask, zeta, q_mask, sig2_beta, tau, c, kz, *,
                      block_size, emit_gam_mu, c_one):
    n, p = x.shape
    q = beta.shape[1]
    operands = dict(x=x, cp_x_y=cp_x_y, gram_flat=gram_flat, l_aug=l_aug,
                    n_stack=n_stack, beta=beta, fitted=fitted, theta=theta,
                    p_mask=p_mask, zeta=zeta, q_mask=q_mask,
                    sig2_beta=sig2_beta, tau=tau)
    shapes = dict(x=(n, p), cp_x_y=(p, q), gram_flat=(p, block_size),
                  l_aug=(p, l_aug.shape[1]), n_stack=(3, l_aug.shape[1], q),
                  beta=(p, q), fitted=(n, q), theta=(p,), p_mask=(p,),
                  zeta=(q,), q_mask=(q,), sig2_beta=(q,), tau=(q,))
    for name, t in operands.items():
        if (t.device.type != "cuda" or t.dtype != torch.float32
                or not t.is_contiguous() or tuple(t.shape) != shapes[name]
                or t.data_ptr() % 16):
            raise ValueError(
                f"sweep_fused kernel: {name} must be a contiguous, 16-byte "
                f"aligned float32 CUDA tensor of shape {shapes[name]}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if (block_size % 8 or block_size > 128 or p % block_size or q % 4
            or l_aug.shape[1] > 48):
        raise ValueError(f"sweep_fused kernel: unsupported shape n={n}, p={p},"
                         f" q={q}, block={block_size}, r+2={l_aug.shape[1]}")
    lib = _load()
    scal = torch.stack([torch.as_tensor(c, dtype=torch.float32,
                                        device=x.device).reshape(()),
                        torch.as_tensor(kz, dtype=torch.float32,
                                        device=x.device).reshape(())])
    fitted = fitted.clone()
    beta_out = torch.empty_like(beta)
    gam_out = torch.empty_like(beta) if emit_gam_mu else None
    mu_out = torch.empty_like(beta) if emit_gam_mu else None
    zrow_part = torch.empty((lib.atlasqtl_sweep_slices(q), p),
                            dtype=torch.float32, device=x.device)
    z_row = torch.empty_like(theta)
    z_col, gcol, m2gcol, b2col = (torch.empty_like(zeta) for _ in range(4))
    ptr = lambda t: None if t is None else t.data_ptr()
    err = lib.atlasqtl_sweep_fused(
        ptr(x), ptr(cp_x_y), ptr(gram_flat), ptr(l_aug), ptr(n_stack),
        ptr(beta), ptr(fitted), ptr(theta), ptr(p_mask), ptr(zeta),
        ptr(q_mask), ptr(sig2_beta), ptr(tau), ptr(scal), ptr(beta_out),
        ptr(gam_out), ptr(mu_out), ptr(zrow_part), ptr(z_row), ptr(z_col),
        ptr(gcol), ptr(m2gcol), ptr(b2col), n, p, q, block_size,
        l_aug.shape[1], int(bool(c_one)),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("sweep_fused kernel launch failed: "
                           + lib.atlasqtl_error_string(err).decode())
    sweep_fused.launches += 1
    return beta_out, gam_out, mu_out, fitted, z_row, z_col, (gcol, m2gcol,
                                                             b2col)


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

    CPU tensors run `sweep_fused_plain`; CUDA tensors launch the kernel
    (csrc/sweep_fused.cu) or raise.  `sweep_fused.launches` counts kernel
    launches.
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
