#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (atlasqtl_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                 # all phases
    python3 chip_smoke.py kernel mis_kernel   # just the kernel-vs-plain phases

Builds the CUDA sweep kernels from the sources in this checkout (one nvcc
per source, started together) and prints ptxas's registers and spills
(B1 and B2 may not spill), then:
  kernel  the kernel against its plain PyTorch version on the card, float32,
          one sweep each, identical inputs, all four mode pairs
          (converged/annealed x full/lite), at four shapes (ragged q;
          n % 8 != 0 with block 80; the fit phase's shape; the eQTL n and q);
          times both; at the eQTL n and q checks the launch plan against
          the kernel (shared memory, CTAs resident per SM) and runs and
          times each slice width built (32 and 40 columns) against the
          plain version;
  fit     atlasqtl() at the sim_anneal shape of BASELINE.json (n=300,
          p=2000, q=500, anneal=(1, 2, 10)) to convergence: the kernel
          launches once per iteration and the hotspot AUC of theta_vb
          against the simulation's active SNPs is >= 0.95; a small fit on
          the card in float32 agrees with the CPU float64 fit;
  eqtl    atlasqtl() at the eqtl_1host shape (n=1000, p=50000, q=10000),
          anneal=(1, 2, 5), maxit=10: ms per sweep and per iteration, host
          init and ELBO seconds, peak device memory, launches;
  mis_kernel  the exact-missing kernel (B2) against its plain version,
          float32, c = 1 and c = 0.5, seeded MCAR missingness, at ten
          shapes (ragged q; n % 8 != 0 with block 80; the fit shape; the
          eQTL n and q; shapes whose launch plans take each cluster size
          and the device-memory branch, MIS_SHAPES); checks the CTAs
          resident per SM against the plan's; times both at the fit and
          eQTL-cut shapes, with the kernel's phase clocks;
  missing_fit  atlasqtl() at the sim_anneal shape with 15% of Y missing,
          missing="exact" (B2 launches once per iteration) and "impute" (B1
          does), each to convergence with hotspot AUC >= 0.95; a small fit
          on the card in float32 agrees with the CPU float64 fit, both modes;
  eqtl_missing  the eqtl phase with 15% of Y missing, once per mode.
  gs_kernel  the inner Gauss-Seidel kernel (B3) against its plain version,
          float32 and float64, c = 1 and c = 0.5, one predictor block at
          (B, q) = (128, 200) ragged, (80, 48), (128, 504), (128, 10000);
          times both at the two largest;
  stag_kernel  the staggered kernel (B4) against B1 on the card and against
          its plain version (gam 1e-4, the rest 1e-4 of max), all four mode
          pairs, at the kernel phase's shapes and the deep-n
          (5000, 2048, 1024); times B4 and B1 side by side at the two
          largest;
  sweeps_fit  fit_global_local at the sim_anneal shape to convergence through
          Config(sweep="pallas") (B3 launches once per predictor block per
          iteration) and Config(sweep_stagger=True) (B4 once per
          iteration), beside the default route (B1); B4's fit reaches B1's
          converged state (iterations within 2%, lb_opt within 1e-5
          relative, PIPs within 1e-2); small fits on the card through each
          route agree with the CPU float64 fit, and a float64 use_pallas fit
          on the card matches it to 1e-6;
  eqtl_sweeps  the eQTL problem built once, then 10 iterations through B3
          and through B4 from clones of its state;
  scaling  B1 and B2 timed at (n, 2048, 10000), n = 250 .. 2000, and each
          time split into a + b n: the part that does not grow with n (the
          chain, tiles, waits) and the cost per sample.
Each phase prints one JSON line; then a `kernels` line, and last the
contract line {"ok": true, "device": {...}}.  Any failure exits non-zero
before that line.  Imports torch, NumPy, SciPy and the port only.
"""
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np

FP32_PEAK = 67e12     # H100 SXM float32 outside the tensor cores, FLOP/s
HBM_RATE = 3.35e12    # H100 SXM HBM3, bytes/s
KERNEL_SHAPES = ((120, 256, 200), (300, 75, 48), (300, 2000, 500),
                 (1000, 2048, 10000))
MODES = ((True, True), (True, False), (False, True), (False, False))
# n, p, q, missing fraction.  B2's plan (missing_launch_plan) takes a
# cluster of 4 at the first three (few slices spread over more SMs), 3 at
# the eQTL cut, 1 at (200, 256, 4800) and 2 at (500, 256, 4000), all with
# two CTAs per SM; with one CTA per SM 5 at (4000, 256, 1024), 6 at
# bench.py's pod_slice n and q (5000, 256, 1024) and 8 at (7000, 256, 256);
# and at (8000, 256, 256) it keeps Fm in device memory
MIS_SHAPES = ((80, 250, 40, 0.2), (300, 75, 48, 0.15), (300, 2000, 500, 0.15),
              (1000, 2048, 10000, 0.15), (200, 256, 4800, 0.15),
              (500, 256, 4000, 0.15), (4000, 256, 1024, 0.15),
              (5000, 256, 1024, 0.15), (7000, 256, 256, 0.15),
              (8000, 256, 256, 0.15))
PHASES = ("kernel", "fit", "eqtl", "mis_kernel", "missing_fit",
          "eqtl_missing", "gs_kernel", "stag_kernel", "sweeps_fit",
          "eqtl_sweeps", "scaling")
SCALE_NS = (250, 500, 1000, 2000)   # the scaling phase's sample counts
SCALE_PQ = (2048, 10000)            # and its (p, q)
GS_SHAPES = ((128, 200), (80, 48), (128, 504), (128, 10000))   # B, q
# the kernel phase's shapes and bench.py's pod_slice n and q with p cut
STAG_SHAPES = KERNEL_SHAPES + ((5000, 2048, 1024),)
FP64_PEAK = 67e12     # H100 SXM float64 on the tensor cores, FLOP/s
DEVICE = "cuda"
FIT_SHAPE = (300, 2000, 500, 20, 100)     # n, p, q, active SNPs, hit traits
EQTL_SHAPE = (1000, 50000, 10000, 500, 2000)


def emit(obj):
    print(json.dumps(obj), flush=True)


KERNEL_NAMES = ("sweep_fused_kernel", "sweep_missing_kernel",
                "inner_gs_kernel", "sweep_staggered_kernel")


def ptxas_summary(report):
    """{kernel: {registers, spill_stores, spill_loads}} from nvcc's
    `-Xptxas -v` report; a template instance is named with its mangled
    arguments (e.g. sweep_missing_kernel<true> as
    sweep_missing_kernelILb1E)."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = None
            for k in KERNEL_NAMES:
                if k in m.group(1):
                    tail = m.group(1).split(k, 1)[1]
                    name = k + (tail.split("EEv", 1)[0] + "E"
                                if tail.startswith("I") else "")
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out.setdefault(name, {}).update(spill_stores=int(m.group(1)),
                                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def pct(bound_ms, ms):
    """A kernel's time as a share of its bound, in percent."""
    return 100.0 * bound_ms / ms


def cuda_ms(fn, reps):
    """Median over `reps` runs of fn's device time (CUDA events)."""
    import torch
    fn()  # warm-up
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, kernel, reps):
    """Mean device time per call of fn of the CUDA kernels whose name holds
    `kernel`, from torch.profiler's CUDA activity; None if it records no
    such kernel.  Unlike cuda_ms it leaves out the gaps in which the device
    waits for the host to enqueue."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0)
             for e in prof.key_averages() if kernel in e.key)
    return us / 1e3 / reps if us else None


def sweep_bound_ms(n, p, q, block, r_aug, emit_gam_mu):
    """Least time of one sweep on an H100: the larger of its FP32 operations
    (the two n-products, the in-block Gram corrections, the three
    interpolation products) over the FP32 peak and its bytes (x, cp, beta in
    and out, gam/mu out when emitted, F in and out, the Gram blocks) over the
    HBM rate."""
    ops = p * q * (4 * n + block + 6 * r_aug)
    nbytes = 4 * (n * p + p * q * (3 + 2 * emit_gam_mu) + 2 * n * q
                  + p * block + p * r_aug + 3 * r_aug * q)
    return 1e3 * max(ops / FP32_PEAK, nbytes / HBM_RATE), \
        ("operations" if ops / FP32_PEAK >= nbytes / HBM_RATE else "bytes")


def mis_bound_ms(n, p, q, r_aug):
    """Least time of one exact-missing sweep on an H100: the larger of the
    FP32 operations the function needs (per (j, k) the projection x_j^T Fm,
    2n, and the masked advance Fm += m (x_j delta), 3n; the three
    interpolation products) over the FP32 peak and its bytes (x, cp, gam,
    mu, x_norm_sq in; gam, mu out; Fm in and out; the mask; the
    interpolation operands) over the HBM rate.  The kernel's windowed pair
    Grams are extra work of its design, not of the function."""
    ops = p * q * (5 * n + 6 * r_aug)
    nbytes = 4 * (n * p + 7 * p * q + 3 * n * q + p * r_aug + 3 * r_aug * q)
    return 1e3 * max(ops / FP32_PEAK, nbytes / HBM_RATE), \
        ("operations" if ops / FP32_PEAK >= nbytes / HBM_RATE else "bytes")


def mis_kernel_ops(n, p, q, r_aug, w):
    """FP32 operations the B2 kernel does per sweep at window w: the masked
    advance, the projections and the pair Grams of each window, the three
    interpolation products."""
    return p * q * (4 * n + (w - 1) * n + 2 * n / w + 6 * r_aug)


def gs_bound_ms(B, q, itemsize):
    """Least time of one inner Gauss-Seidel launch (B3) on an H100: the
    larger of its operations (the pushes below the diagonal, B^2 q / 2
    FMAs, and ~15 elementwise operations per element) over the FP32 (or
    FP64) peak and its bytes (six B x q tiles in: r0, cp, gam, mu, log_p,
    log_1p; the Gram and three column vectors in; three B x q tiles out:
    gam, mu, delta) over the HBM rate."""
    ops = B * B * q + 15 * B * q
    nbytes = itemsize * (9 * B * q + B * B + 3 * q)
    peak = FP32_PEAK if itemsize == 4 else FP64_PEAK
    return 1e3 * max(ops / peak, nbytes / HBM_RATE), \
        ("operations" if ops / peak >= nbytes / HBM_RATE else "bytes")


def simulate(n, p, q, seed, p_act, q_hit, missing_frac=0.0):
    """Gaussian genotypes, a dense planted block of effects of the first
    p_act SNPs on the first q_hit traits, unit noise; then a seeded MCAR
    share missing_frac of the traits' cells set to NaN."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, p))
    y = rng.standard_normal((n, q))
    y[:, :q_hit] += x[:, :p_act] @ (0.3 * rng.normal(1.0, 0.5, (p_act, q_hit)))
    if missing_frac > 0:
        y[rng.random(y.shape) < missing_frac] = np.nan
    return x, y


def kernel_inputs(n, p, q, c, seed=0):
    """Device operands of one sweep at (n, p, q), built by the port's own
    data/state builders from a seeded random problem."""
    import torch
    from atlasqtl_tpu_torch.types import Config
    from atlasqtl_tpu_torch.models import global_local as gl
    from atlasqtl_tpu_torch.inference import elicitation as elic
    from atlasqtl_tpu_torch.ops import updates as upd
    from atlasqtl_tpu_torch.ops.sweep import SweepConsts, block_gram
    from atlasqtl_tpu_torch.ops.sweep_fused import fused_operands

    x, y = simulate(n, p, q, seed, min(10, p), max(2, q // 5))
    x = (x - x.mean(0)) / x.std(0, ddof=1)
    y = y - y.mean(0)
    cfg = Config(dtype=torch.float32, shr_fac_inv=float(q))
    data = gl.build_data(x, y, cfg, DEVICE)
    block = gl.data_block(cfg, data)
    state = gl.build_state(elic.auto_set_init(y, p, (4, 16), float(q), seed),
                           data, cfg)
    rng = np.random.default_rng(seed + 1)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=DEVICE)
    tau = f32(rng.uniform(0.5, 2.0, data.y.shape[1]))
    cc = f32(c)
    consts = SweepConsts(
        sig2_beta=upd.sig2_beta_update(data.n, f32(0.7), tau, c=cc), tau=tau,
        log_tau=torch.log(tau), log_sig2_inv=f32(-0.3), theta=state.theta,
        zeta=state.zeta, c=cc)
    ops = fused_operands(data.x, data.cp_x_y, block_gram(data.x, block),
                         state.beta, state.fitted, consts, block,
                         data.p_mask, data.q_mask)
    return ops, block


B1_NAMES = ("beta", "gam", "mu", "fitted", "z_row", "z_col", "gcol",
            "m2gcol", "b2col")


def b1_plan_check(ops, block, ref, kw):
    """B1's launch plan at these operands, held to the kernel: its shared
    memory equals the kernel's own, the card holds the CTAs per SM it
    counts on; then every slice width built, launched directly (not
    counted), against the plain outputs `ref` and timed (CUDA events,
    median of 7), with the phase clocks of the plan's width."""
    import torch
    from atlasqtl_tpu_torch.ops import sweep_fused as sf
    n, q, r_aug = ops[0].shape[0], ops[5].shape[1], ops[3].shape[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = sf.fused_launch_plan(n, q, block, r_aug, sms)
    width = plan["slice_width"]
    out = dict(plan=plan, ctas_per_sm=sf.occupancy(width, block, r_aug),
               by_width={})
    if out["ctas_per_sm"] != plan["ctas_per_sm"] or \
            sf.kernel_smem_bytes(width, block, r_aug) != plan["smem_bytes"]:
        raise AssertionError(f"B1 plan {plan} vs the kernel: "
                             f"{out['ctas_per_sm']} CTAs per SM, "
                             f"{sf.kernel_smem_bytes(width, block, r_aug)} "
                             f"bytes of shared memory")
    for w in sf.FUSED_WIDTHS:
        fn = lambda: sf.fused_launch("atlasqtl_sweep_fused", *ops, **kw,
                                     slice_width=w)
        got = fn()
        torch.cuda.synchronize()
        errs = {}
        for name, a, r in zip(B1_NAMES, list(got[:6]) + list(got[6]),
                              list(ref[:6]) + list(ref[6])):
            if r is None:
                continue
            errs[name] = float((a - r).abs().max())
            limit = 1e-4 if name == "gam" else 1e-4 * float(r.abs().max())
            if not (errs[name] <= limit):
                raise AssertionError(f"B1 in {w}-column slices vs plain: "
                                     f"{name} {errs[name]:.3g} > {limit:.3g}")
        out["by_width"][w] = dict(
            ms=cuda_ms(fn, 7), grid=-(-q // w),
            waves=-(-(-(-q // w)) // sms), max_abs_err=errs,
            ctas_per_sm=sf.occupancy(w, block, r_aug))
        if w == width:
            out["clocks"] = sf.phase_clocks()
    return out


def phase_kernel():
    import torch
    from atlasqtl_tpu_torch.ops import sweep_fused as sf

    names = B1_NAMES
    cases, max_abs, timing = [], 0.0, None
    for n, p, q in KERNEL_SHAPES:
        for c_one, emit_gm in MODES:
            ops, block = kernel_inputs(n, p, q, 1.0 if c_one else 0.5)
            kw = dict(block_size=block, emit_gam_mu=emit_gm, c_one=c_one)
            got = sf.sweep_fused(*ops, **kw)
            ref = sf.sweep_fused_plain(*ops, **kw)
            torch.cuda.synchronize()
            flat = lambda o: list(o[:6]) + list(o[6])
            errs = {}
            for name, a, r in zip(names, flat(got), flat(ref)):
                if r is None:
                    continue
                err = float((a - r).abs().max())
                scale = float(r.abs().max())
                errs[name] = err
                max_abs = max(max_abs, err)
                limit = 1e-4 if name == "gam" else 1e-4 * scale
                if not (err <= limit):  # also catches NaN
                    raise AssertionError(
                        f"kernel vs plain at n={n} p={p} q={q} c_one={c_one}"
                        f" emit={emit_gm}: {name} max abs err {err:.3g} > "
                        f"{limit:.3g}")
            case = dict(n=n, p=p, q=q, block=block, c_one=c_one,
                        emit_gam_mu=emit_gm, max_abs_err=errs)
            if (n, p, q) == KERNEL_SHAPES[-1] or c_one:
                case["ms"] = cuda_ms(lambda: sf.sweep_fused(*ops, **kw), 7)
                case["plain_ms"] = cuda_ms(
                    lambda: sf.sweep_fused_plain(*ops, **kw), 3)
                case["bound_ms"], case["bound_by"] = sweep_bound_ms(
                    ops[0].shape[0], ops[0].shape[1], ops[5].shape[1], block,
                    ops[3].shape[1], emit_gm)
            if (n, p, q) in KERNEL_SHAPES[-2:] and c_one and not emit_gm:
                # the steady-state (converged, lite) sweep, at the fit
                # shape (32-column slices) and the eQTL cut (40)
                case.update(b1_plan_check(ops, block, ref, kw))
                timing = case
            cases.append(case)
            del ops, got, ref
            torch.cuda.empty_cache()
    emit({"phase": "kernel", "cases": cases, "max_abs_err": max_abs})
    return max_abs, timing


def mis_kernel_inputs(n, p, q, c, missing_frac, seed=0):
    """Device operands of one exact-missing sweep at (n, p, q), built by the
    port's own data/state builders from a seeded random problem."""
    import torch
    from atlasqtl_tpu_torch.types import Config
    from atlasqtl_tpu_torch.models import global_local as gl
    from atlasqtl_tpu_torch.inference import elicitation as elic
    from atlasqtl_tpu_torch.ops import updates as upd
    from atlasqtl_tpu_torch.ops.sweep import SweepConsts
    from atlasqtl_tpu_torch.ops.sweep_missing_fused import \
        missing_fused_operands

    x, y = simulate(n, p, q, seed, min(10, p), max(2, q // 5), missing_frac)
    x = (x - x.mean(0)) / x.std(0, ddof=1)
    y = y - np.nanmean(y, axis=0)
    cfg = Config(dtype=torch.float32, shr_fac_inv=float(q))
    data = gl.build_data(x, y, cfg, DEVICE)
    block = gl.data_block(cfg, data)
    state = gl.build_state(elic.auto_set_init(y, p, (4, 16), float(q), seed),
                           data, cfg)
    rng = np.random.default_rng(seed + 1)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=DEVICE)
    tau, sig2_inv, cc = f32(rng.uniform(0.5, 2.0, data.y.shape[1])), \
        f32(0.7), f32(c)
    consts = SweepConsts(
        sig2_beta=upd.sig2_beta_update(data.n, sig2_inv, tau, data.x_norm_sq,
                                       cc),
        tau=tau, log_tau=torch.log(tau) - 0.1, log_sig2_inv=f32(-0.45),
        theta=state.theta, zeta=state.zeta, c=cc)
    ops = missing_fused_operands(
        data.x, data.cp_x_y, data.x_norm_sq, data.mis_pat, state.gam,
        state.mu_beta, state.fitted, consts, sig2_inv, data.p_mask,
        data.q_mask)
    return ops, block


def phase_mis_kernel():
    import torch
    from atlasqtl_tpu_torch.ops import sweep_missing_fused as sm

    names = ("gam", "mu", "fitted", "z_row", "z_col")
    w = sm.window()
    cases, max_abs, timing = [], 0.0, None
    for n, p, q, frac in MIS_SHAPES:
        for c in (1.0, 0.5):
            ops, block = mis_kernel_inputs(n, p, q, c, frac)
            kw = dict(block_size=block)
            got = sm.sweep_missing_fused(*ops, **kw)
            ref = sm.sweep_missing_fused_plain(*ops, **kw)
            torch.cuda.synchronize()
            errs = {}
            for name, a, r in zip(names, got, ref):
                err = float((a - r).abs().max())
                scale = float(r.abs().max())
                errs[name] = err
                max_abs = max(max_abs, err)
                limit = 1e-4 if name == "gam" else 1e-4 * scale
                if not (err <= limit):  # also catches NaN
                    raise AssertionError(
                        f"missing kernel vs plain at n={n} p={p} q={q} c={c}:"
                        f" {name} max abs err {err:.3g} > {limit:.3g}")
            n_, r_aug = ops[0].shape[0], ops[4].shape[1]
            plan = sm.missing_launch_plan(n_, ops[6].shape[1], block, r_aug)
            ctas, clusters = sm.occupancy(plan, n_, r_aug)
            smem = sm.kernel_smem_bytes(plan, n_, r_aug)
            case = dict(n=n, p=p, q=q, missing_frac=frac, block=block, c=c,
                        plan=plan, ctas_per_sm=ctas,
                        resident_clusters=clusters, max_abs_err=errs)
            if ctas < plan["ctas_per_sm"] or smem != plan["smem_bytes"]:
                raise AssertionError(f"B2 at n={n} p={p} q={q}: {ctas} CTAs "
                                     f"per SM and {smem} bytes of shared "
                                     f"memory, the plan counts on "
                                     f"{plan['ctas_per_sm']} and "
                                     f"{plan['smem_bytes']}")
            if p >= 2000 and c == 1.0:
                case["ms"] = cuda_ms(lambda: sm.sweep_missing_fused(*ops,
                                                                    **kw), 7)
                case["plain_ms"] = cuda_ms(
                    lambda: sm.sweep_missing_fused_plain(*ops, **kw), 3)
                dims = (ops[0].shape[0], ops[0].shape[1], ops[6].shape[1],
                        ops[4].shape[1])
                case["bound_ms"], case["bound_by"] = mis_bound_ms(*dims)
                case["window"] = w
                case["kernel_ops"] = mis_kernel_ops(*dims, w)
                case["clocks"] = sm.phase_clocks()
                timing = case  # the last timed case is the eQTL-cut shape
            cases.append(case)
            del ops, got, ref
            torch.cuda.empty_cache()
    emit({"phase": "mis_kernel", "window": w, "cases": cases,
          "max_abs_err": max_abs})
    return max_abs, timing


def phase_scaling():
    """Split B1's and B2's time into the part that grows with n and the part
    that does not: each timed (CUDA events, median of 5) at
    (n, SCALE_PQ) for n in SCALE_NS, then T = a + b n fitted by least
    squares.  a is the chain, tiles and waits; b the cost per sample, beside
    the FP32 floor per sample of the function's n-products (4 p q operations
    for B1, 5 p q for B2)."""
    from atlasqtl_tpu_torch.ops import sweep_fused as sf
    from atlasqtl_tpu_torch.ops import sweep_missing_fused as sm

    p, q = SCALE_PQ
    out = {}
    for name, per_sample_ops in (("sweep_fused", 4),
                                 ("sweep_missing_fused", 5)):
        ms = []
        for n in SCALE_NS:
            if name == "sweep_fused":
                ops, block = kernel_inputs(n, p, q, 1.0)
                kw = dict(block_size=block, emit_gam_mu=False, c_one=True)
                fn = lambda: sf.sweep_fused(*ops, **kw)
            else:
                ops, block = mis_kernel_inputs(n, p, q, 1.0, 0.15)
                fn = lambda: sm.sweep_missing_fused(*ops, block_size=block)
            ms.append(cuda_ms(fn, 5))
            del ops, fn
        b, a = np.polyfit(np.asarray(SCALE_NS, float), np.asarray(ms), 1)
        out[name] = dict(n=list(SCALE_NS), ms=ms, a_ms=float(a),
                         b_ms_per_sample=float(b),
                         floor_ms_per_sample=1e3 * per_sample_ops * p * q
                         / FP32_PEAK)
    emit({"phase": "scaling", "p": p, "q": q, **out})
    return out


def hotspot_auc(score, p_act):
    from scipy.stats import rankdata
    r = rankdata(score)
    n1, n0 = p_act, len(score) - p_act
    return float((r[:p_act].sum() - n1 * (n1 + 1) / 2) / (n1 * n0))


def phase_fit():
    import torch
    import atlasqtl_tpu_torch as at
    from atlasqtl_tpu_torch.ops import sweep_fused as sf

    # the small reference fit first: float32 on the card vs float64 on CPU
    xs, ys = simulate(100, 75, 20, 123, 10, 20)
    kw = dict(p0=(5, 25), verbose=0, user_seed=123)
    small_gpu = at.atlasqtl(ys, xs, dtype=torch.float32, device=DEVICE, **kw)
    small_cpu = at.atlasqtl(ys, xs, dtype=torch.float64, device="cpu", **kw)
    pip_diff = float(np.abs(small_gpu.gam_vb - small_cpu.gam_vb).max())
    if not (small_gpu.converged and pip_diff <= 1e-2):
        raise AssertionError(f"small fit: GPU float32 vs CPU float64 PIPs "
                             f"differ by {pip_diff:.3g} (converged="
                             f"{small_gpu.converged})")

    n, p, q, p_act, q_hit = FIT_SHAPE
    x, y = simulate(n, p, q, 0, p_act, q_hit)
    torch.cuda.synchronize()
    sf.sweep_fused.launches = 0
    t0 = time.perf_counter()
    res = at.atlasqtl(y, x, p0=(5, 25), anneal=(1, 2, 10), dtype=torch.float32,
                      verbose=0, user_seed=0, device=DEVICE)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = sf.sweep_fused.launches
    auc = hotspot_auc(res.theta_vb, p_act)
    out = dict(phase="fit", n=n, p=p, q=q, anneal=[1, 2, 10],
               converged=bool(res.converged), it=res.it, launches=launches,
               seconds=secs, lb_opt=res.lb_opt, hotspot_auc_theta=auc,
               small_fit_pip_max_diff_vs_cpu_f64=pip_diff,
               finite=bool(np.isfinite(res.gam_vb).all()
                           and np.isfinite(res.theta_vb).all()))
    emit(out)
    if not res.converged:
        raise AssertionError("fit phase did not converge")
    if launches != res.it:
        raise AssertionError(f"{launches} kernel launches for {res.it} "
                             "iterations")
    if auc < 0.95 or not out["finite"]:
        raise AssertionError(f"fit phase: hotspot AUC {auc:.3f}, finite="
                             f"{out['finite']}")
    if res.gam_vb.shape != (p, q) or res.theta_vb.shape != (p,):
        raise AssertionError("fit phase: unexpected output shapes")
    return launches


def phase_missing_fit():
    """The exact and impute fits with 15% of Y missing; each is driven with
    both kernels' counts set to 0 just before it and read just after."""
    import torch
    import atlasqtl_tpu_torch as at
    from atlasqtl_tpu_torch.ops import sweep_fused as sf
    from atlasqtl_tpu_torch.ops import sweep_missing_fused as sm

    xs, ys = simulate(100, 75, 20, 123, 10, 20, missing_frac=0.2)
    kw = dict(p0=(5, 25), verbose=0, user_seed=123)
    pip_diff = {}
    for missing in ("exact", "impute"):
        gpu = at.atlasqtl(ys, xs, dtype=torch.float32, device=DEVICE,
                          missing=missing, **kw)
        cpu = at.atlasqtl(ys, xs, dtype=torch.float64, device="cpu",
                          missing=missing, **kw)
        pip_diff[missing] = float(np.abs(gpu.gam_vb - cpu.gam_vb).max())
        if not (gpu.converged and pip_diff[missing] <= 1e-2):
            raise AssertionError(
                f"small {missing} fit: GPU float32 vs CPU float64 PIPs differ"
                f" by {pip_diff[missing]:.3g} (converged={gpu.converged})")

    n, p, q, p_act, q_hit = FIT_SHAPE
    x, y = simulate(n, p, q, 0, p_act, q_hit, missing_frac=0.15)
    launches = {}
    for missing in ("exact", "impute"):
        torch.cuda.synchronize()
        sf.sweep_fused.launches = sm.sweep_missing_fused.launches = 0
        t0 = time.perf_counter()
        res = at.atlasqtl(y, x, p0=(5, 25), anneal=(1, 2, 10),
                          dtype=torch.float32, verbose=0, user_seed=0,
                          device=DEVICE, missing=missing)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {"sweep_fused": sf.sweep_fused.launches,
                  "sweep_missing_fused": sm.sweep_missing_fused.launches}
        own = "sweep_missing_fused" if missing == "exact" else "sweep_fused"
        launches[missing] = counts[own]
        auc = hotspot_auc(res.theta_vb, p_act)
        out = dict(phase="missing_fit", missing=missing, n=n, p=p, q=q,
                   missing_frac=0.15, anneal=[1, 2, 10],
                   converged=bool(res.converged), it=res.it,
                   launches=counts, seconds=secs, lb_opt=res.lb_opt,
                   hotspot_auc_theta=auc,
                   small_fit_pip_max_diff_vs_cpu_f64=pip_diff[missing],
                   finite=bool(np.isfinite(res.gam_vb).all()
                               and np.isfinite(res.theta_vb).all()))
        emit(out)
        if not res.converged:
            raise AssertionError(f"missing_fit {missing}: did not converge")
        if counts[own] != res.it or sum(counts.values()) != res.it:
            raise AssertionError(f"missing_fit {missing}: launches {counts} "
                                 f"for {res.it} iterations")
        if auc < 0.95 or not out["finite"]:
            raise AssertionError(f"missing_fit {missing}: hotspot AUC "
                                 f"{auc:.3f}, finite={out['finite']}")
        if res.gam_vb.shape != (p, q) or res.theta_vb.shape != (p,):
            raise AssertionError("missing_fit: unexpected output shapes")
    return launches


def timed_run(run, launch, counter, bound, sweep=None):
    """Run `run()` (a fit) with per-stage timers wrapped around the port's
    own functions: host init, state building, ELBO, the iteration, and the
    kernel launch `launch` = (module, name); `sweep` = (module, name) times
    whole sweeps where a sweep is more than one launch (B3), else the
    launch is the sweep.  `counter` is the launching wrapper, whose count
    is set to 0 just before the run; bound(args, kwargs) gives a launch's
    bound_ms from its operands.  Returns (result, stats)."""
    import torch
    from atlasqtl_tpu_torch.inference import elicitation as elic
    from atlasqtl_tpu_torch.models import global_local as gl

    acc = {"init_s": 0.0, "build_state_s": 0.0, "elbo_s": 0.0}
    iter_ms, launch_ev, sweep_ev, bounds = [], [], [], []
    sweep = sweep or launch
    orig = dict(init=elic.auto_set_init, state=gl.build_state,
                elbo=gl.compute_elbo, it=gl.cavi_iteration,
                launch=getattr(*launch), sweep=getattr(*sweep))

    def timed(key, fn):
        def w(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            acc[key] += time.perf_counter() - t
            return out
        return w

    def iteration(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig["it"](*a, **k)
        torch.cuda.synchronize()
        iter_ms.append(1e3 * (time.perf_counter() - t))
        return out

    def events(fn, evs, on_launch=None):
        def w(*a, **k):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*a, **k)
            ev[1].record()
            evs.append(ev)
            if on_launch:
                on_launch(a, k)
            return out
        return w

    elic.auto_set_init = timed("init_s", orig["init"])
    gl.build_state = timed("build_state_s", orig["state"])
    gl.compute_elbo = timed("elbo_s", orig["elbo"])
    gl.cavi_iteration = iteration
    setattr(*launch, events(orig["launch"], launch_ev,
                            lambda a, k: bounds.append(bound(a, k))))
    if sweep != launch:
        setattr(*sweep, events(orig["sweep"], sweep_ev))
    try:
        torch.cuda.reset_peak_memory_stats()
        counter.launches = 0
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        elic.auto_set_init, gl.build_state = orig["init"], orig["state"]
        gl.compute_elbo, gl.cavi_iteration = orig["elbo"], orig["it"]
        setattr(*launch, orig["launch"])
        setattr(*sweep, orig["sweep"])
    launch_ms = [a.elapsed_time(b) for a, b in launch_ev]
    sweep_ms = ([a.elapsed_time(b) for a, b in sweep_ev] if sweep_ev
                else launch_ms)
    stats = dict(it=res.it, launches=counter.launches, sweep_ms=sweep_ms,
                 sweep_ms_median=statistics.median(sweep_ms),
                 sweep_bound_ms=bounds,
                 iter_ms=iter_ms, iter_ms_median=statistics.median(iter_ms),
                 host_init_s=acc["init_s"], build_state_s=acc["build_state_s"],
                 elbo_s=acc["elbo_s"], elbo_evals=len(res.elbo_history),
                 total_s=total,
                 max_memory_allocated_gb=torch.cuda.max_memory_allocated()
                 / 1e9)
    if sweep_ev:  # per-launch numbers beside the per-sweep ones
        stats.update(launch_ms_median=statistics.median(launch_ms),
                     launches_per_sweep=len(launch_ms) // len(sweep_ms),
                     launch_bound_ms=statistics.median(bounds),
                     sweep_bound_ms=None)
    return res, stats


def eqtl_run(phase, x, y, launch_mod, launch_fn, counter, bound, **fit_kw):
    """One atlasqtl() at the eQTL shape under `timed_run`'s timers."""
    import torch
    import atlasqtl_tpu_torch as at

    n, p = x.shape
    q = y.shape[1]
    res, stats = timed_run(
        lambda: at.atlasqtl(y, x, p0=(5, 25), anneal=(1, 2, 5), maxit=10,
                            dtype=torch.float32, verbose=0, user_seed=1,
                            device=DEVICE, **fit_kw),
        (launch_mod, launch_fn), counter, bound)
    out = dict(phase=phase, **fit_kw, n=n, p=p, q=q, anneal=[1, 2, 5],
               maxit=10, **stats, finite=bool(np.isfinite(res.gam_vb).all()))
    emit(out)
    if out["launches"] != res.it or not out["finite"]:
        raise AssertionError(f"{phase} phase: {out['launches']} launches "
                             f"for {res.it} iterations, finite="
                             f"{out['finite']}")


def b1_launch_bound(a, k):
    """bound_ms of one B1 launch from its operands (x, cp, gram_flat,
    l_aug, n_stack, beta, ...)."""
    return sweep_bound_ms(a[0].shape[0], a[0].shape[1], a[5].shape[1],
                          k["block_size"], a[3].shape[1],
                          k["emit_gam_mu"])[0]


def b2_launch_bound(a, k):
    """bound_ms of one B2 launch from its operands (x, cp, x_norm_sq,
    mis_pat, l_aug, n_stack, gam, ...)."""
    return mis_bound_ms(a[0].shape[0], a[0].shape[1], a[6].shape[1],
                        a[4].shape[1])[0]


def phase_eqtl():
    from atlasqtl_tpu_torch.ops import sweep_fused as sf
    n, p, q, p_act, q_hit = EQTL_SHAPE
    x, y = simulate(n, p, q, 1, p_act, q_hit)
    eqtl_run("eqtl", x, y, sf, "_sweep_fused_cuda", sf.sweep_fused,
             b1_launch_bound)


def phase_eqtl_missing():
    """The eqtl phase's problem with 15% of Y missing (MCAR, seeded), once
    with missing="exact" (B2) and once with "impute" (B1)."""
    from atlasqtl_tpu_torch.ops import sweep_fused as sf
    from atlasqtl_tpu_torch.ops import sweep_missing_fused as sm
    n, p, q, p_act, q_hit = EQTL_SHAPE
    x, y = simulate(n, p, q, 1, p_act, q_hit, missing_frac=0.15)
    eqtl_run("eqtl_missing", x, y, sm, "_sweep_missing_fused_cuda",
             sm.sweep_missing_fused, b2_launch_bound, missing="exact")
    eqtl_run("eqtl_missing", x, y, sf, "_sweep_fused_cuda", sf.sweep_fused,
             b1_launch_bound, missing="impute")


def gs_inputs(B, q, c, dtype, seed=0):
    """Device operands of one inner Gauss-Seidel launch (B3) at (B, q): a
    seeded random problem of p = B predictors built by the port's own
    data/state builders, r0 = X^T F, the block Gram and the exact probit
    tiles, as sweep_complete_pallas hands them to the kernel."""
    import torch
    from atlasqtl_tpu_torch.types import Config
    from atlasqtl_tpu_torch.models import global_local as gl
    from atlasqtl_tpu_torch.inference import elicitation as elic
    from atlasqtl_tpu_torch.ops import updates as upd
    from atlasqtl_tpu_torch.ops.special import log_ndtr_both
    from atlasqtl_tpu_torch.ops.sweep import block_gram

    n = 1000 if q >= 10000 else 300
    x, y = simulate(n, B, q, seed, min(10, B), max(2, q // 5))
    x = (x - x.mean(0)) / x.std(0, ddof=1)
    y = y - y.mean(0)
    cfg = Config(dtype=dtype, shr_fac_inv=float(q))
    data = gl.build_data(x, y, cfg, DEVICE)
    state = gl.build_state(elic.auto_set_init(y, B, (4, 16), float(q), seed),
                           data, cfg)
    rng = np.random.default_rng(seed + 1)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=DEVICE)
    tau, cc = t(rng.uniform(0.5, 2.0, data.y.shape[1])), t(c)
    s2 = upd.sig2_beta_update(data.n, t(0.7), tau, c=cc)
    log_p, log_1p = log_ndtr_both(state.theta[:, None] + state.zeta[None, :])
    return (data.x.T @ state.fitted, block_gram(data.x, B)[0], data.cp_x_y,
            state.gam, state.mu_beta, log_p, log_1p, s2, tau, torch.log(tau),
            cc, t(-0.3))


def phase_gs_kernel():
    import torch
    from atlasqtl_tpu_torch.ops import sweep_fused as sf
    from atlasqtl_tpu_torch.ops import sweep_pallas as sp

    cases, max_abs, timing = [], 0.0, {}
    for dtype in (torch.float32, torch.float64):
        for B, q in GS_SHAPES:
            for c in (1.0, 0.5):
                ops = gs_inputs(B, q, c, dtype)
                got = sp.inner_gs_pallas(*ops)
                ref = sp.inner_gs_plain(*ops)
                torch.cuda.synchronize()
                errs = {}
                for name, a, r in zip(("gam", "mu", "delta"), got, ref):
                    err = float((a - r).abs().max())
                    scale = float(r.abs().max())
                    errs[name] = err
                    max_abs = max(max_abs, err)
                    tol = 1e-10 if dtype == torch.float64 else 1e-4
                    limit = tol if name == "gam" else tol * scale
                    if not (err <= limit):  # also catches NaN
                        raise AssertionError(
                            f"inner_gs kernel vs plain at B={B} q={q} c={c} "
                            f"{dtype}: {name} max abs err {err:.3g} > "
                            f"{limit:.3g}")
                case = dict(B=B, q=q, c=c, dtype=str(dtype).split(".")[-1],
                            max_abs_err=errs)
                if q >= 504 and c == 1.0:
                    case["ms"] = cuda_ms(lambda: sp.inner_gs_pallas(*ops), 20)
                    case["device_ms"] = device_ms(
                        lambda: sp.inner_gs_pallas(*ops), "inner_gs_kernel",
                        20)
                    case["plain_ms"] = cuda_ms(
                        lambda: sp.inner_gs_plain(*ops), 3)
                    case["bound_ms"], case["bound_by"] = gs_bound_ms(
                        B, q, ops[0].element_size())
                    case["ctas_per_sm"] = \
                        sf._load().atlasqtl_inner_gs_occupancy(
                            int(dtype == torch.float64), B)
                    timing[(case["dtype"], q)] = case
                cases.append(case)
                del ops, got, ref
    emit({"phase": "gs_kernel", "cases": cases, "max_abs_err": max_abs})
    return max_abs, timing[("float32", GS_SHAPES[-1][1])]


def phase_stag_kernel():
    import torch
    from atlasqtl_tpu_torch.ops import sweep_fused as sf
    from atlasqtl_tpu_torch.ops import sweep_staggered as ss

    names = ("beta", "gam", "mu", "fitted", "z_row", "z_col", "gcol",
             "m2gcol", "b2col")
    flat = lambda o: list(o[:6]) + list(o[6])
    cases, max_abs, timing = [], 0.0, None
    for n, p, q in STAG_SHAPES:
        for c_one, emit_gm in MODES:
            ops, block = kernel_inputs(n, p, q, 1.0 if c_one else 0.5)
            kw = dict(block_size=block, emit_gam_mu=emit_gm, c_one=c_one)
            got = ss.sweep_fused_staggered(*ops, **kw)
            b1 = sf.sweep_fused(*ops, **kw)
            ref = ss.sweep_staggered_plain(*ops, **kw)
            torch.cuda.synchronize()
            errs, errs_b1 = {}, {}
            for name, a, u, r in zip(names, flat(got), flat(b1), flat(ref)):
                if r is None:
                    continue
                for other, o, out in (("plain", r, errs), ("B1", u, errs_b1)):
                    err = float((a - o).abs().max())
                    limit = 1e-4 if name == "gam" else 1e-4 * float(
                        o.abs().max())
                    out[name] = err
                    if not (err <= limit):  # also catches NaN
                        raise AssertionError(
                            f"staggered kernel vs {other} at n={n} p={p} "
                            f"q={q} c_one={c_one} emit={emit_gm}: {name} max"
                            f" abs err {err:.3g} > {limit:.3g}")
                max_abs = max(max_abs, errs[name])
            case = dict(n=n, p=p, q=q, block=block, c_one=c_one,
                        emit_gam_mu=emit_gm, max_abs_err=errs,
                        max_abs_err_vs_b1=errs_b1)
            if p * q >= 2048 * 1024 and c_one:
                # B1, B4, B4, B1 in turns on the same inputs
                b1_ms = cuda_ms(lambda: sf.sweep_fused(*ops, **kw), 5)
                case["ms"] = cuda_ms(
                    lambda: ss.sweep_fused_staggered(*ops, **kw), 5)
                case["ms_2"] = cuda_ms(
                    lambda: ss.sweep_fused_staggered(*ops, **kw), 5)
                case["b1_ms"] = [b1_ms,
                                 cuda_ms(lambda: sf.sweep_fused(*ops, **kw),
                                         5)]
                case["plain_ms"] = cuda_ms(
                    lambda: ss.sweep_staggered_plain(*ops, **kw), 2)
                case["bound_ms"], case["bound_by"] = sweep_bound_ms(
                    ops[0].shape[0], ops[0].shape[1], ops[5].shape[1], block,
                    ops[3].shape[1], emit_gm)
                if (n, p, q) == KERNEL_SHAPES[-1] and not emit_gm:
                    timing = case  # the steady-state (converged, lite) sweep
                    case["ctas_per_sm"] = \
                        sf._load().atlasqtl_sweep_staggered_occupancy(
                            block, ops[3].shape[1])
            cases.append(case)
            del ops, got, b1, ref
            torch.cuda.empty_cache()
    emit({"phase": "stag_kernel", "cases": cases, "max_abs_err": max_abs})
    return max_abs, timing


def prepared_fit(y, x, cfg, device, anneal=(1, 2, 10), seed=123):
    """fit_global_local through the library's lower-level entry, as
    atlasqtl() prepares it (prepare_data, elicitation with p0 = (5, 25), the
    model's builders); the caller's Config picks the route.  Returns the
    FitResult and the unpadded (theta, gam) on the host."""
    from atlasqtl_tpu_torch.io.prepare import prepare_data
    from atlasqtl_tpu_torch.inference import elicitation as elic
    from atlasqtl_tpu_torch.inference.driver import fit_global_local
    from atlasqtl_tpu_torch.models import global_local as gl

    dat = prepare_data(y, x, 0.1, cfg.maxit, seed, 0)
    p, q = dat.x.shape[1], dat.y.shape[1]
    cfg = dataclasses.replace(cfg, shr_fac_inv=float(q))
    data = gl.build_data(dat.x, dat.y, cfg, device)
    hyper = gl.build_hyper(elic.auto_set_hyper(dat.y, p, (5, 25)),
                           data.y.shape[1], cfg, device)
    state = gl.build_state(elic.auto_set_init(dat.y, p, (5, 25), float(q),
                                              seed), data, cfg)
    res = fit_global_local(data, hyper, state, cfg, anneal=anneal, verbose=0)
    host = lambda t: t.double().cpu().numpy()
    return res, host(res.state.theta[:p]), host(res.state.gam[:p, :q])


def phase_sweeps_fit():
    """The B3 and B4 routes through fit_global_local, each driven with every
    sweep kernel's count set to 0 just before it and read just after."""
    import torch
    from atlasqtl_tpu_torch.types import Config
    from atlasqtl_tpu_torch.ops import sweep_fused as sf
    from atlasqtl_tpu_torch.ops import sweep_pallas as sp
    from atlasqtl_tpu_torch.ops import sweep_staggered as ss

    routes = (("fused", Config()), ("pallas", Config(sweep="pallas")),
              ("stagger", Config(sweep_stagger=True)))
    counters = {"sweep_fused": sf.sweep_fused,
                "inner_gs_pallas": sp.inner_gs_pallas,
                "sweep_fused_staggered": ss.sweep_fused_staggered}

    # small fits: the card against the CPU float64 fit
    xs, ys = simulate(100, 75, 20, 123, 10, 20)
    ref, _, ref_gam = prepared_fit(ys, xs, Config(dtype=torch.float64), "cpu")
    small = {}
    for route, cfg in routes[1:]:
        res, _, gam = prepared_fit(ys, xs, cfg, DEVICE)
        small[route] = float(np.abs(gam - ref_gam).max())
        if not (res.converged and small[route] <= 1e-2):
            raise AssertionError(
                f"small {route} fit: GPU float32 vs CPU float64 PIPs differ "
                f"by {small[route]:.3g} (converged={res.converged})")
    res, _, gam = prepared_fit(ys, xs, Config(dtype=torch.float64,
                                              use_pallas=True), DEVICE)
    small["pallas_f64"] = float(np.abs(gam - ref_gam).max())
    if not (res.it == ref.it and small["pallas_f64"] <= 1e-6):
        raise AssertionError(
            f"small float64 use_pallas fit on the card: it {res.it} vs "
            f"{ref.it} on the CPU, PIPs differ by {small['pallas_f64']:.3g}")

    n, p, q, p_act, q_hit = FIT_SHAPE
    x, y = simulate(n, p, q, 0, p_act, q_hit)
    own = {"fused": "sweep_fused", "pallas": "inner_gs_pallas",
           "stagger": "sweep_fused_staggered"}
    out, gams = {}, {}
    for route, cfg in routes:
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res, theta, gam = prepared_fit(y, x, cfg, DEVICE, seed=0)
        gams[route] = gam
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {k: fn.launches for k, fn in counters.items()}
        per_it = (res.state.gam.shape[0] // 128 if route == "pallas" else 1)
        auc = hotspot_auc(theta, p_act)
        out[route] = dict(phase="sweeps_fit", route=route, n=n, p=p, q=q,
                          anneal=[1, 2, 10], converged=bool(res.converged),
                          it=res.it, launches=counts, seconds=secs,
                          lb_opt=res.lb_opt, hotspot_auc_theta=auc,
                          small_fit_pip_max_diff_vs_cpu_f64=small.get(route),
                          finite=bool(np.isfinite(gam).all()
                                      and np.isfinite(theta).all()))
        if route == "pallas":
            out[route]["small_f64_fit_pip_max_diff_vs_cpu_f64"] = \
                small["pallas_f64"]
        if route == "stagger":
            out[route]["b1_it"] = out["fused"]["it"]
            out[route]["b1_lb_opt"] = out["fused"]["lb_opt"]
            out[route]["pip_max_diff_vs_b1"] = float(
                np.abs(gam - gams["fused"]).max())
        emit(out[route])
        if not res.converged:
            raise AssertionError(f"sweeps_fit {route}: did not converge")
        if (counts[own[route]] != res.it * per_it
                or sum(counts.values()) != counts[own[route]]):
            raise AssertionError(f"sweeps_fit {route}: launches {counts} for "
                                 f"{res.it} iterations")
        if auc < 0.95 or not out[route]["finite"]:
            raise AssertionError(f"sweeps_fit {route}: hotspot AUC {auc:.3f}"
                                 f", finite={out[route]['finite']}")
        if gam.shape != (p, q) or theta.shape != (p,):
            raise AssertionError("sweeps_fit: unexpected output shapes")
    # B4 computes B1's function, its sums in another order: the same
    # converged state, not the same bits
    st, b1 = out["stagger"], out["fused"]
    if not (abs(st["it"] - b1["it"]) <= 0.02 * b1["it"]
            and abs(st["lb_opt"] - b1["lb_opt"]) <= 1e-5 * abs(b1["lb_opt"])
            and st["pip_max_diff_vs_b1"] <= 1e-2):
        raise AssertionError(
            f"sweeps_fit: the staggered fit (it {st['it']}, lb_opt "
            f"{st['lb_opt']}) differs from B1's (it {b1['it']}, lb_opt "
            f"{b1['lb_opt']}), PIPs by {st['pip_max_diff_vs_b1']:.3g}")
    return {r: out[r]["launches"][own[r]] for r in ("pallas", "stagger")}


def gs_launch_bound(a, k):
    """bound_ms of one B3 launch from its operands (r0, ...)."""
    return gs_bound_ms(*a[0].shape, a[0].element_size())[0]


def phase_eqtl_sweeps():
    """The eQTL problem (full width) built once -- simulation,
    prepare_data, host init, build_state -- then 10 iterations through B3
    and through B4, each from a clone of the built state."""
    import torch
    from atlasqtl_tpu_torch.types import Config
    from atlasqtl_tpu_torch.io.prepare import prepare_data
    from atlasqtl_tpu_torch.inference import elicitation as elic
    from atlasqtl_tpu_torch.inference.driver import fit_global_local
    from atlasqtl_tpu_torch.models import global_local as gl
    from atlasqtl_tpu_torch.ops import sweep_pallas as sp
    from atlasqtl_tpu_torch.ops import sweep_staggered as ss

    n, p, q, p_act, q_hit = EQTL_SHAPE
    x, y = simulate(n, p, q, 1, p_act, q_hit)
    t0 = time.perf_counter()
    dat = prepare_data(y, x, 0.1, 10, 1, 0)
    t1 = time.perf_counter()
    hyper_spec = elic.auto_set_hyper(dat.y, p, (5, 25))
    init = elic.auto_set_init(dat.y, p, (5, 25), float(q), 1)
    t2 = time.perf_counter()
    cfg = Config(dtype=torch.float32, maxit=10, shr_fac_inv=float(q))
    data = gl.build_data(dat.x, dat.y, cfg, DEVICE)
    hyper = gl.build_hyper(hyper_spec, data.y.shape[1], cfg, DEVICE)
    state = gl.build_state(init, data, cfg)
    torch.cuda.synchronize()
    built = dict(prepare_s=t1 - t0, host_init_s=t2 - t1,
                 build_s=time.perf_counter() - t2)
    del dat, init
    routes = (
        ("pallas", dataclasses.replace(cfg, sweep="pallas"),
         (sp, "_inner_gs_cuda"), sp.inner_gs_pallas, gs_launch_bound,
         (gl, "sweep_complete_pallas"), data.x.shape[1] // 128),
        ("stagger", dataclasses.replace(cfg, sweep_stagger=True),
         (ss, "_sweep_staggered_cuda"), ss.sweep_fused_staggered,
         b1_launch_bound, None, 1))
    for route, rcfg, launch, counter, bound, sweep, per_it in routes:
        st = dataclasses.replace(state, **{
            f.name: getattr(state, f.name).clone()
            for f in dataclasses.fields(state)
            if torch.is_tensor(getattr(state, f.name))})
        res, stats = timed_run(
            lambda: fit_global_local(data, hyper, st, rcfg, anneal=(1, 2, 5),
                                     verbose=0),
            launch, counter, bound, sweep)
        stats.pop("host_init_s"), stats.pop("build_state_s")
        finite = bool(torch.isfinite(res.state.gam).all())
        emit(dict(phase="eqtl_sweeps", route=route, n=n, p=p, q=q,
                  anneal=[1, 2, 5], maxit=10, built_once=built, **stats,
                  finite=finite))
        if stats["launches"] != res.it * per_it or not finite:
            raise AssertionError(f"eqtl_sweeps {route}: {stats['launches']} "
                                 f"launches for {res.it} iterations, "
                                 f"finite={finite}")
        del st, res
        torch.cuda.empty_cache()


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    phases = sys.argv[1:] or list(PHASES)
    unknown = set(phases) - set(PHASES)
    if unknown:
        raise SystemExit(f"chip_smoke: unknown phase(s) {sorted(unknown)}")
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from atlasqtl_tpu_torch.ops import sweep_fused as sf

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    t0 = time.perf_counter()
    lib = sf.build(verbose=True)
    regs = ptxas_summary(sf.build.ptxas_report)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": lib.name, "ptxas": regs})
    spills = {k: v for k, v in regs.items()
              if k.startswith(("sweep_fused_kernel", "sweep_missing_kernel"))
              and (v.get("spill_stores") or v.get("spill_loads"))}
    if spills:
        raise AssertionError(f"B1/B2 spill registers: {spills}")

    max_abs, timing, launches = None, None, None
    mis_max_abs, mis_timing, mis_launches = None, None, {}
    if "kernel" in phases:
        max_abs, timing = phase_kernel()
    if "fit" in phases:
        launches = phase_fit()
    if "eqtl" in phases:
        phase_eqtl()
    if "mis_kernel" in phases:
        mis_max_abs, mis_timing = phase_mis_kernel()
    if "missing_fit" in phases:
        mis_launches = phase_missing_fit()
    if "eqtl_missing" in phases:
        phase_eqtl_missing()
    gs_max_abs, gs_timing, stag_max_abs, stag_timing = None, None, None, None
    route_launches = {}
    if "gs_kernel" in phases:
        gs_max_abs, gs_timing = phase_gs_kernel()
    if "stag_kernel" in phases:
        stag_max_abs, stag_timing = phase_stag_kernel()
    if "sweeps_fit" in phases:
        route_launches = phase_sweeps_fit()
    if "eqtl_sweeps" in phases:
        phase_eqtl_sweeps()
    if "scaling" in phases:
        phase_scaling()
    kernels = []
    if timing is not None:
        kernels.append({
            "name": "sweep_fused", "route": "cuda",
            "source": "atlasqtl_tpu_torch/csrc/sweep_fused.cu",
            "replaces": "atlasqtl_tpu/ops/sweep_fused.py:68",
            "launches": launches, "max_abs_err": max_abs,
            "shape": {k: timing[k] for k in ("n", "p", "q", "block")},
            "mode": "converged, lite",
            "ms": timing["ms"], "kernel_ms": timing["ms"],
            "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"], "library_ms": None,
            "pct_of_bound": pct(timing["bound_ms"], timing["ms"]),
            "ctas_per_sm": timing["ctas_per_sm"], "plan": timing["plan"],
            "ms_by_width": {w: d["ms"]
                            for w, d in timing["by_width"].items()},
            "impute_fit_launches": mis_launches.get("impute")})
    if mis_timing is not None:
        kernels.append({
            "name": "sweep_missing_fused", "route": "cuda",
            "source": "atlasqtl_tpu_torch/csrc/sweep_missing_fused.cu",
            "replaces": "atlasqtl_tpu/ops/sweep_missing_fused.py:51",
            "launches": mis_launches.get("exact"),
            "max_abs_err": mis_max_abs,
            "shape": {k: mis_timing[k]
                      for k in ("n", "p", "q", "block", "missing_frac")},
            "window": mis_timing["window"],
            "kernel_ops": mis_timing["kernel_ops"],
            "ms": mis_timing["ms"], "plain_ms": mis_timing["plain_ms"],
            "bound_ms": mis_timing["bound_ms"],
            "bound_by": mis_timing["bound_by"], "library_ms": None,
            "pct_of_bound": pct(mis_timing["bound_ms"], mis_timing["ms"]),
            "ctas_per_sm": mis_timing["ctas_per_sm"],
            "plan": mis_timing["plan"]})
    if gs_timing is not None:
        kernels.append({
            "name": "inner_gs", "route": "cuda",
            "source": "atlasqtl_tpu_torch/csrc/sweep_inner_gs.cu",
            "replaces": "atlasqtl_tpu/ops/sweep_pallas.py:25",
            "launches": route_launches.get("pallas"),
            "max_abs_err": gs_max_abs,
            "shape": {k: gs_timing[k] for k in ("B", "q", "dtype")},
            "ms": gs_timing["ms"], "device_ms": gs_timing["device_ms"],
            "plain_ms": gs_timing["plain_ms"],
            "bound_ms": gs_timing["bound_ms"],
            "bound_by": gs_timing["bound_by"], "library_ms": None,
            "pct_of_bound": pct(gs_timing["bound_ms"], gs_timing["ms"]),
            "ctas_per_sm": gs_timing["ctas_per_sm"]})
    if stag_timing is not None:
        kernels.append({
            "name": "sweep_staggered", "route": "cuda",
            "source": "atlasqtl_tpu_torch/csrc/sweep_staggered.cu",
            "replaces": "atlasqtl_tpu/ops/sweep_staggered.py:52",
            "launches": route_launches.get("stagger"),
            "max_abs_err": stag_max_abs,
            "shape": {k: stag_timing[k] for k in ("n", "p", "q", "block")},
            "mode": "converged, lite", "ms": stag_timing["ms"],
            "b1_ms": stag_timing["b1_ms"],
            "plain_ms": stag_timing["plain_ms"],
            "bound_ms": stag_timing["bound_ms"],
            "bound_by": stag_timing["bound_by"], "library_ms": None,
            "pct_of_bound": pct(stag_timing["bound_ms"], stag_timing["ms"]),
            "ctas_per_sm": stag_timing["ctas_per_sm"]})
    if kernels:
        emit({"kernels": kernels})
    print(f"chip_smoke: wall time {time.perf_counter() - t_start:.1f} s",
          flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
