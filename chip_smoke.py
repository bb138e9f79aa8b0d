#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (atlasqtl_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                 # all phases
    python3 chip_smoke.py kernel mis_kernel   # just these phases

Builds the CUDA sweep kernels from the sources in this checkout (one nvcc
per source, started together) and prints ptxas's registers and spills
(no kernel may spill), then:
  kernel  the kernel against its plain PyTorch version on the card, float32,
          one sweep each, identical inputs, all four mode pairs
          (converged/annealed x full/lite), at four shapes (ragged q;
          n % 8 != 0 with block 80; the fit phase's shape; the eQTL n and
          q), and at block 256 (pieces of 128) at the fit shape;
          times both; at the eQTL n and q checks the launch plan against
          the kernel (shared memory, CTAs resident per SM) and runs and
          times each slice width built (32 and 40 columns) against the
          plain version;
  fit     atlasqtl() at the sim_anneal shape of BASELINE.json (n=300,
          p=2000, q=500, anneal=(1, 2, 10)) to convergence: the kernel
          launches once per iteration and the hotspot AUC of theta_vb
          against the simulation's active SNPs is >= 0.95; a small fit on
          the card in float32 agrees with the CPU float64 fit (every
          card-against-CPU comparison gives both sides the same host-drawn
          initial state through list_init: on the card atlasqtl() draws
          its own on the device);
  eqtl    atlasqtl() at the eqtl_1host shape (n=1000, p=50000, q=10000),
          anneal=(1, 2, 5), maxit=10: ms per sweep and per iteration, host
          init and ELBO seconds, seconds from prepare_data to the first
          iteration, peak device memory, launches (the eQTL phases share
          each problem's host-drawn initial state, passed as list_init);
  dev_init  the eqtl fit with no list_init: the initial state drawn on the
          card; its seconds and the host path's, the drawn moments against
          their theory, peak memory no more than the host-init fit's;
  mis_kernel  the exact-missing kernel (B2) against its plain version,
          float32, c = 1 and c = 0.5, seeded MCAR missingness, at ten
          shapes (ragged q; n % 8 != 0 with block 80; the fit shape; the
          eQTL n and q; shapes whose launch plans take each cluster size
          and the device-memory branch, MIS_SHAPES) and at block 256 at
          the fit shape; checks the CTAs
          resident per SM against the plan's; times both at the fit and
          eQTL-cut shapes, with the kernel's phase clocks;
  missing_fit  atlasqtl() at the sim_anneal shape with 15% of Y missing,
          missing="exact" (B2 launches once per iteration) and "impute" (B1
          does), each to convergence with hotspot AUC >= 0.95; a small fit
          on the card in float32 agrees with the CPU float64 fit, both modes;
  eqtl_missing  the eqtl phase with 15% of Y missing, once per mode;
  block_fits  atlasqtl(..., block_size=256) at the sim_anneal shape on
          complete data (B1, walking each block in pieces of 128) and with
          15% of Y missing (exact: B2; impute: B1), each to convergence
          with hotspot AUC >= 0.95 and one launch per iteration; a batch="0"
          fit with NaN in Y there (the plain engines, no kernel), cut to 2
          iterations; small fits of each against the CPU float64 fit;
  gs_kernel  B3's block kernel (probit tiles, the Gauss-Seidel update and
          the Z sums of one predictor block) against its plain version, and
          its tiles-read instance (inner_gs_pallas) against its own,
          float32 and float64, c = 1 and c = 0.5, at (B, q) = (128, 200)
          ragged, (80, 48), (128, 504), (128, 10000), (256, 504) (a block
          over 128 in one launch); times the block kernel alone at the
          block-128 shapes of q >= 504 beside its bound and CTAs per SM;
  stag_kernel  the staggered kernel (B4) against B1 on the card and against
          its plain version (gam 1e-4, the rest 1e-4 of max), all four mode
          pairs, at the kernel phase's shapes, the deep-n (5000, 2048,
          1024), the 40-column (300, 512, 4804) and block 256 at the fit
          shape; times B1, B4, B4, B1 in turns at the four largest (the
          fit phase's shape too), with B4's launch plan (width, waves) and
          phase clocks;
  sweeps_fit  fit_global_local at the sim_anneal shape to convergence through
          Config(sweep="pallas") (B3's block kernel launches once per
          predictor block per iteration, iterations within 2% of B1's) and
          Config(sweep_stagger=True) (B4 once per iteration), beside the
          default route (B1); B4's fit reaches B1's
          converged state (iterations within 2%, lb_opt within 1e-5
          relative, PIPs within 1e-2); small fits on the card through each
          route, at block 128 and 256, agree with the CPU float64 fit, and
          float64 use_pallas fits on the card match it to 1e-6;
  device_loop  every route (B1, B2, impute, B3 f32 and f64, B4, block
          256, model="global") at the sim_anneal shape under
          device_loop="off" and "on" (CUDA graphs): equal iterations, the
          ELBO histories within 1e-6, launches per iteration under both
          loops, graph replays, seconds, and 0 device-to-host copies per
          lite step (torch.profiler); B1's fit profiled under both loops;
  eqtl_sweeps  the eQTL problem built once, then 10 iterations through B3
          and through B4 from clones of its state; the B3 route's last
          sweep again under torch.profiler: its CUDA launches (3 per
          predictor block -- r0 product, block kernel, advance -- not
          counting the reductions of cuBLAS's split-K r0 products, and at
          most 10 more) and the device ms of the r0 products, block
          kernels, advances and z_row reduction;
  scaling  B1 and B2 timed at (n, 2048, 10000), n = 250 .. 2000, and each
          time split into a + b n: the part that does not grow with n (the
          chain, tiles, waits) and the cost per sample;
  replica_kernel  B1 and B2 with a replica axis (one launch sweeps m
          annealing replicas) at (300, 2000, 500) and (1000, 2048, 10000),
          B2 with 15% of Y missing, c = 1 and 0.5, m = 1, 2, 4: each
          replica bit for bit its own single launch, which matches the
          plain version; ms per batched launch against m single launches,
          the plan for m replicas, % of bound;
  a8_fit  at the sim_anneal shape: anneal_replicas=3 on complete data,
          exact missing and impute (one sweep launch per rung, the
          converged phase on the graph loop, the selected replica's ELBO
          the largest of the three computed apart, AUC >= 0.95); a fit with
          checkpoint_path and trace_path cut at maxit, resumed through
          load_checkpoint to convergence; full_output=True with the
          reference's names; permutation_null_calibration, 4 permutations,
          timed.
Each phase prints one JSON line; then a `kernels` line, and last the
contract line {"ok": true, "device": {...}}.  Any failure exits non-zero
before that line.  Imports torch, NumPy, SciPy and the port only.
"""
import dataclasses
import json
import logging
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
PHASES = ("kernel", "fit", "eqtl", "dev_init", "mis_kernel", "missing_fit",
          "eqtl_missing", "block_fits", "gs_kernel", "stag_kernel",
          "sweeps_fit", "device_loop", "eqtl_sweeps", "scaling",
          "replica_kernel", "a8_fit")
SCALE_NS = (250, 500, 1000, 2000)   # the scaling phase's sample counts
SCALE_PQ = (2048, 10000)            # and its (p, q)
GS_SHAPES = ((128, 200), (80, 48), (128, 504), (128, 10000),
             (256, 504))   # B, q; block 256 in one launch
GS_BLOCK_NAMES = ("gam", "mu", "delta", "z_row", "z_col")
# the kernel phase's shapes, bench.py's pod_slice n and q with p cut, and a
# shape whose launch plan takes 40-column slices in one wave
STAG_SHAPES = KERNEL_SHAPES + ((5000, 2048, 1024), (300, 512, 4804))
# n, p, q of the block-256 cases (walked in pieces of 128) of the kernel
# phases, at the fit phase's shape
BLOCK256_SHAPE = (300, 2048, 500)
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


def held(label, got, ref, names, tol=1e-4):
    """Max abs error of each output of `got` against `ref` by name; raises
    past the tolerance: gam `tol`, the others tol * max |ref| (also on
    NaN).  The phases hold float32 kernels at 1e-4, float64 at 1e-10."""
    errs = {}
    for name, a, r in zip(names, got, ref):
        if r is None:
            continue
        errs[name] = float((a - r).abs().max())
        limit = tol if name == "gam" else tol * float(r.abs().max())
        if not (errs[name] <= limit):
            raise AssertionError(f"{label}: {name} max abs err "
                                 f"{errs[name]:.3g} > {limit:.3g}")
    return errs


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
    """Mean device time per launch of fn's CUDA kernels whose name holds
    `kernel`, from torch.profiler's CUDA activity over `reps` calls after a
    step that warms the tracer up (it may miss its first launches); None if
    it records no such kernel.  Unlike cuda_ms it leaves out the gaps in
    which the device waits for the host to enqueue."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 acc_events=True) as prof:
        for _ in range(2):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
    hits = [e for e in prof.key_averages() if kernel in e.key]
    count = sum(e.count for e in hits)
    us = sum(getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0) for e in hits)
    return us / 1e3 / count if count else None


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


def gs_bound_ms(B, q, itemsize, c_one=True):
    """Least time of one launch of B3's block kernel on an H100: the larger
    of its operations over the FP32 (or FP64) peak and its bytes over the
    HBM rate.  Operations: the pushes below the diagonal, B^2 q / 2 FMAs,
    and per cell the probit tiles (log_ndtr_both, ~35), the two Mills
    ratios (~12), the chain (~15) and the Z cell (~8): 70, or 105 when
    c != 1 takes a second log_ndtr_both at sqrt(c) u.  Bytes: four B x q
    tiles in (r0, cp, gam, mu), three out (gam, mu, delta), the Gram, theta
    and p_mask, the q-vectors zeta, q_mask, s2, tau, log tau, z_col in and
    out, and z_row out."""
    ops = B * B * q + (70 if c_one else 105) * B * q
    nbytes = itemsize * (7 * B * q + B * B + 3 * B + 7 * q)
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


def kernel_inputs(n, p, q, c, seed=0, block=128):
    """Device operands of one sweep at (n, p, q) and predictor block
    `block`, built by the port's own data/state builders from a seeded
    random problem."""
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
    cfg = Config(dtype=torch.float32, shr_fac_inv=float(q), block_size=block)
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
        errs = held(f"B1 in {w}-column slices vs plain",
                    list(got[:6]) + list(got[6]), list(ref[:6]) + list(ref[6]),
                    B1_NAMES)
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
            errs = held(f"kernel vs plain at n={n} p={p} q={q} "
                        f"c_one={c_one} emit={emit_gm}", flat(got), flat(ref),
                        names)
            max_abs = max(max_abs, *errs.values())
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
    n, p, q = BLOCK256_SHAPE
    for c_one in (True, False):  # block 256: two pieces of 128
        ops, block = kernel_inputs(n, p, q, 1.0 if c_one else 0.5, block=256)
        kw = dict(block_size=block, emit_gam_mu=True, c_one=c_one)
        got = sf.sweep_fused(*ops, **kw)
        ref = sf.sweep_fused_plain(*ops, **kw)
        torch.cuda.synchronize()
        flat = lambda o: list(o[:6]) + list(o[6])
        errs = held(f"kernel vs plain at n={n} p={p} q={q} block={block} "
                    f"c_one={c_one}", flat(got), flat(ref), names)
        max_abs = max(max_abs, *errs.values())
        case = dict(n=n, p=p, q=q, block=block, sub_block=sf.sub_block(block),
                    c_one=c_one, emit_gam_mu=True, max_abs_err=errs)
        if c_one:
            case["ms"] = cuda_ms(lambda: sf.sweep_fused(*ops, **kw), 5)
        cases.append(case)
        del ops, got, ref
    emit({"phase": "kernel", "cases": cases, "max_abs_err": max_abs})
    return max_abs, timing


def mis_kernel_inputs(n, p, q, c, missing_frac, seed=0, block=128):
    """Device operands of one exact-missing sweep at (n, p, q) and block
    `block`, built by the port's own data/state builders from a seeded
    random problem."""
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
    cfg = Config(dtype=torch.float32, shr_fac_inv=float(q), block_size=block)
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
            errs = held(f"missing kernel vs plain at n={n} p={p} q={q} c={c}",
                        got, ref, names)
            max_abs = max(max_abs, *errs.values())
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
    n, p, q = BLOCK256_SHAPE
    for c in (1.0, 0.5):  # block 256: two pieces of 128
        ops, block = mis_kernel_inputs(n, p, q, c, 0.15, block=256)
        got = sm.sweep_missing_fused(*ops, block_size=block)
        ref = sm.sweep_missing_fused_plain(*ops, block_size=block)
        torch.cuda.synchronize()
        errs = held(f"missing kernel vs plain at n={n} p={p} q={q} "
                    f"block={block} c={c}", got, ref, names)
        max_abs = max(max_abs, *errs.values())
        cases.append(dict(n=n, p=p, q=q, missing_frac=0.15, block=block,
                          sub_block=sm.missing_launch_plan(
                              n, ops[6].shape[1], block,
                              ops[4].shape[1])["sub_block"],
                          c=c, max_abs_err=errs))
        del ops, got, ref
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


def host_init(y, x, seed, p0=(5, 25)):
    """The InitSpec atlasqtl(user_seed=seed) draws on the host for (y, x):
    a card fit and a CPU fit compared with each other both take it through
    list_init (on the card atlasqtl() would draw its own state on the
    device)."""
    from atlasqtl_tpu_torch.io.prepare import prepare_data
    from atlasqtl_tpu_torch.inference import elicitation as elic
    dat = prepare_data(y, x, 0.1, 1000, seed, 0)
    return elic.auto_set_init(dat.y, dat.x.shape[1], p0,
                              float(dat.y.shape[1]), seed)


def phase_fit():
    import torch
    import atlasqtl_tpu_torch as at
    from atlasqtl_tpu_torch.ops import sweep_fused as sf

    # the small reference fit first: float32 on the card vs float64 on CPU,
    # both from the same host-drawn initial state
    xs, ys = simulate(100, 75, 20, 123, 10, 20)
    kw = dict(p0=(5, 25), verbose=0, user_seed=123,
              list_init=host_init(ys, xs, 123))
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
    kw = dict(p0=(5, 25), verbose=0, user_seed=123,
              list_init=host_init(ys, xs, 123))
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


def phase_block_fits():
    """atlasqtl(..., block_size=256) (each block walked in pieces of 128:
    B1 on complete data and in impute mode, B2 in exact mode, 15% of Y
    missing) and a batch="0" fit with NaN in Y (block 1: the plain
    engines, no kernel, as the reference routes it).  Small fits on the card
    are held against the CPU float64 fit (PIPs within 1e-2); the fits at the
    sim_anneal shape are each driven with every kernel's count set to 0
    just before it and read just after, the batch="0" one cut to 2
    iterations."""
    import torch
    import atlasqtl_tpu_torch as at
    from atlasqtl_tpu_torch.ops import sweep_fused as sf
    from atlasqtl_tpu_torch.ops import sweep_missing_fused as sm

    counters = {"sweep_fused": sf.sweep_fused,
                "sweep_missing_fused": sm.sweep_missing_fused}
    fits = (("complete", {}), ("exact", {"missing": "exact"}),
            ("impute", {"missing": "impute"}))
    small = {}
    for name, kw in fits + (("batch0", {"batch": "0"}),):
        frac = 0.0 if name == "complete" else 0.2
        xs, ys = simulate(100, 75 if name == "batch0" else 300, 20, 123, 10,
                          20, missing_frac=frac)
        args = dict(p0=(5, 25), verbose=0, user_seed=123, **kw,
                    list_init=host_init(ys, xs, 123),
                    **({} if name == "batch0" else {"block_size": 256}))
        gpu = at.atlasqtl(ys, xs, dtype=torch.float32, device=DEVICE, **args)
        cpu = at.atlasqtl(ys, xs, dtype=torch.float64, device="cpu", **args)
        small[name] = float(np.abs(gpu.gam_vb - cpu.gam_vb).max())
        if not (gpu.converged and small[name] <= 1e-2):
            raise AssertionError(
                f"small {name} fit: GPU float32 vs CPU float64 PIPs differ "
                f"by {small[name]:.3g} (converged={gpu.converged})")

    n, p, q, p_act, q_hit = FIT_SHAPE
    launches = {}
    for name, kw in fits + (("batch0", {"batch": "0"}),):
        x, y = simulate(n, p, q, 0, p_act, q_hit,
                        missing_frac=0.0 if name == "complete" else 0.15)
        run = (dict(anneal=None, maxit=2) if name == "batch0"
               else dict(anneal=(1, 2, 10), block_size=256))
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = at.atlasqtl(y, x, p0=(5, 25), dtype=torch.float32, verbose=0,
                          user_seed=0, device=DEVICE, **run, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {k: fn.launches for k, fn in counters.items()}
        auc = hotspot_auc(res.theta_vb, p_act)
        out = dict(phase="block_fits", fit=name, n=n, p=p, q=q,
                   block=1 if name == "batch0" else 256,
                   missing_frac=0.0 if name == "complete" else 0.15,
                   converged=bool(res.converged), it=res.it, launches=counts,
                   seconds=secs, lb_opt=res.lb_opt, hotspot_auc_theta=auc,
                   small_fit_pip_max_diff_vs_cpu_f64=small[name],
                   finite=bool(np.isfinite(res.gam_vb).all()
                               and np.isfinite(res.theta_vb).all()))
        emit(out)
        if res.gam_vb.shape != (p, q) or not out["finite"]:
            raise AssertionError(f"block_fits {name}: shapes or finiteness")
        if name == "batch0":
            if sum(counts.values()) or res.it != 2:
                raise AssertionError(f"block_fits batch0: launches {counts} "
                                     f"in {res.it} iterations")
            continue
        own = "sweep_missing_fused" if name == "exact" else "sweep_fused"
        launches[name] = counts[own]
        if not res.converged or auc < 0.95:
            raise AssertionError(f"block_fits {name}: converged="
                                 f"{res.converged}, hotspot AUC {auc:.3f}")
        if counts[own] != res.it or sum(counts.values()) != res.it:
            raise AssertionError(f"block_fits {name}: launches {counts} for "
                                 f"{res.it} iterations")
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
    from atlasqtl_tpu_torch import api
    from atlasqtl_tpu_torch.inference import elicitation as elic
    from atlasqtl_tpu_torch.models import global_local as gl

    acc = {"init_s": 0.0, "build_state_s": 0.0, "elbo_s": 0.0}
    iter_ms, launch_ev, sweep_ev, bounds = [], [], [], []
    marks = {}   # the end of prepare_data, the start of the first iteration
    sweep = sweep or launch
    orig = dict(init=elic.auto_set_init, state=gl.build_state,
                elbo=gl.compute_elbo, it=gl.cavi_iteration,
                prep=api.prepare_data,
                launch=getattr(*launch), sweep=getattr(*sweep))

    def prepared(*a, **k):
        out = orig["prep"](*a, **k)
        marks["prepared"] = time.perf_counter()
        return out

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
        marks.setdefault("first_iteration", t)
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
    api.prepare_data = prepared
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
        api.prepare_data = orig["prep"]
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
                 prepare_to_first_iteration_s=marks["first_iteration"]
                 - marks["prepared"] if "prepared" in marks else None,
                 total_s=total,
                 max_memory_allocated_gb=torch.cuda.max_memory_allocated()
                 / 1e9)
    if sweep_ev:  # per-launch numbers beside the per-sweep ones
        stats.update(launch_ms_median=statistics.median(launch_ms),
                     launches_per_sweep=len(launch_ms) // len(sweep_ms),
                     launch_bound_ms=statistics.median(bounds),
                     sweep_bound_ms=None)
    return res, stats


_EQTL = {}
_EQTL_STATS = {}   # eqtl_run's stats by (phase, missing), for dev_init


def eqtl_problem(missing_frac=0.0):
    """The eQTL shape's seeded (x, y) with a share missing_frac of Y
    missing, and the initial state atlasqtl(user_seed=1) would draw for it
    on the host, made once per missing fraction and shared by the phases
    that fit it (the host init takes ~30-40 s at this shape): (x, y, init,
    host seconds of the init)."""
    if missing_frac not in _EQTL:
        from atlasqtl_tpu_torch.io.prepare import prepare_data
        from atlasqtl_tpu_torch.inference import elicitation as elic
        n, p, q, p_act, q_hit = EQTL_SHAPE
        x, y = simulate(n, p, q, 1, p_act, q_hit, missing_frac=missing_frac)
        dat = prepare_data(y, x, 0.1, 10, 1, 0)
        t0 = time.perf_counter()
        init = elic.auto_set_init(dat.y, dat.x.shape[1], (5, 25), float(q), 1)
        _EQTL[missing_frac] = (x, y, init, time.perf_counter() - t0)
    return _EQTL[missing_frac]


def eqtl_run(phase, missing_frac, launch_mod, launch_fn, counter, bound,
             **fit_kw):
    """One atlasqtl() at the eQTL shape under `timed_run`'s timers, from
    eqtl_problem's shared initial state (list_init)."""
    import torch
    import atlasqtl_tpu_torch as at

    x, y, init, init_s = eqtl_problem(missing_frac)
    n, p = x.shape
    q = y.shape[1]
    res, stats = timed_run(
        lambda: at.atlasqtl(y, x, p0=(5, 25), anneal=(1, 2, 5), maxit=10,
                            dtype=torch.float32, verbose=0, user_seed=1,
                            device=DEVICE, list_init=init, **fit_kw),
        (launch_mod, launch_fn), counter, bound)
    stats["host_init_s"] = init_s  # drawn once, by eqtl_problem
    # the host path from prepare_data to the first iteration: the draw
    # (eqtl_problem's) and then build_data/build_state
    stats["host_path_prepare_to_first_iteration_s"] = \
        stats["prepare_to_first_iteration_s"] + init_s
    _EQTL_STATS[(phase, fit_kw.get("missing"))] = stats
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
    eqtl_run("eqtl", 0.0, sf, "_sweep_fused_cuda", sf.sweep_fused,
             b1_launch_bound)


def phase_eqtl_missing():
    """The eqtl phase's problem with 15% of Y missing (MCAR, seeded), once
    with missing="exact" (B2) and once with "impute" (B1)."""
    from atlasqtl_tpu_torch.ops import sweep_fused as sf
    from atlasqtl_tpu_torch.ops import sweep_missing_fused as sm
    eqtl_run("eqtl_missing", 0.15, sm, "_sweep_missing_fused_cuda",
             sm.sweep_missing_fused, b2_launch_bound, missing="exact")
    eqtl_run("eqtl_missing", 0.15, sf, "_sweep_fused_cuda", sf.sweep_fused,
             b1_launch_bound, missing="impute")
    del _EQTL[0.15]  # no later phase fits it


def gs_inputs(B, q, c, dtype, seed=0):
    """Device operands of one launch of B3's block kernel at (B, q), with
    block_gs's arguments: a seeded random problem of p = B predictors made
    by the port's own build_data and build_state, r0 = X^T F, the block
    Gram, the state's gam, mu, theta and zeta, the masks, as
    sweep_complete_pallas hands them to the kernel."""
    import torch
    from atlasqtl_tpu_torch.types import Config
    from atlasqtl_tpu_torch.models import global_local as gl
    from atlasqtl_tpu_torch.inference import elicitation as elic
    from atlasqtl_tpu_torch.ops import updates as upd
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
    return (data.x.T @ state.fitted, block_gram(data.x, B)[0], data.cp_x_y,
            state.gam, state.mu_beta, state.theta, state.zeta, data.p_mask,
            data.q_mask, s2, tau, torch.log(tau), cc, t(-0.3))


def tiles_operands(ops):
    """inner_gs_pallas's operands from block_gs's: the exact probit tiles
    at theta + zeta in place of theta, zeta and the masks."""
    from atlasqtl_tpu_torch.ops.special import log_ndtr_both
    r0, g, cp, gam, mu, theta, zeta, pm, qm, s2, tau, log_tau, c, lsi = ops
    log_p, log_1p = log_ndtr_both(theta[:, None] + zeta[None, :])
    return (r0, g, cp, gam, mu, log_p, log_1p, s2, tau, log_tau, c, lsi)


def phase_gs_kernel():
    """B3's block kernel against block_gs_plain, and its tiles-read
    instance (inner_gs_pallas) against inner_gs_plain, at every GS_SHAPES
    case, float32 and float64, c = 1 and 0.5; the block kernel timed alone
    (one launch on prepared buffers) at the block-128 shapes of q >= 504."""
    import torch
    from atlasqtl_tpu_torch.ops import sweep_fused as sf
    from atlasqtl_tpu_torch.ops import sweep_pallas as sp

    cases, max_abs, timing = [], 0.0, {}
    for dtype in (torch.float32, torch.float64):
        f64 = dtype == torch.float64
        tol = 1e-10 if f64 else 1e-4
        for B, q in GS_SHAPES:
            for c in (1.0, 0.5):
                ops = gs_inputs(B, q, c, dtype)
                label = f"at B={B} q={q} c={c} {dtype}"
                errs = held(f"block kernel vs plain {label}",
                            sp.block_gs(*ops), sp.block_gs_plain(*ops),
                            GS_BLOCK_NAMES, tol=tol)
                tiles = tiles_operands(ops)
                tiles_errs = held(f"inner_gs kernel vs plain {label}",
                                  sp.inner_gs_pallas(*tiles),
                                  sp.inner_gs_plain(*tiles),
                                  GS_BLOCK_NAMES[:3], tol=tol)
                torch.cuda.synchronize()
                max_abs = max(max_abs, *errs.values(), *tiles_errs.values())
                case = dict(B=B, q=q, c=c, dtype=str(dtype).split(".")[-1],
                            max_abs_err=errs, tiles_max_abs_err=tiles_errs)
                if q >= 504 and B == 128:
                    scal = sp._scalars(ops[12], ops[13], ops[0])
                    gam = torch.empty_like(ops[3])
                    mu = torch.empty_like(ops[4])
                    delta = torch.empty_like(ops[0])
                    z_col = torch.zeros_like(ops[6])
                    part = ops[0].new_empty(-(-q // sp.GS_QS), B)
                    launch = lambda: sp._block_gs_cuda(
                        *ops[:12], scal, 0, gam, mu, delta, z_col, part)
                    case["ms"] = cuda_ms(launch, 20)
                    case["device_ms"] = device_ms(launch, "inner_gs_kernel",
                                                  20)
                    case["plain_ms"] = cuda_ms(
                        lambda: sp.block_gs_plain(*ops), 3)
                    case["tiles_device_ms"] = device_ms(
                        lambda: sp.inner_gs_pallas(*tiles),
                        "inner_gs_kernel", 20)
                    case["bound_ms"], case["bound_by"] = gs_bound_ms(
                        B, q, ops[0].element_size(), c_one=c == 1.0)
                    case["pct_of_bound"] = pct(case["bound_ms"], case["ms"])
                    case["pct_of_bound_device"] = (
                        pct(case["bound_ms"], case["device_ms"])
                        if case["device_ms"] else None)
                    case["ctas_per_sm"] = \
                        sf._load().atlasqtl_inner_gs_occupancy(int(f64), 0, B)
                    launch()
                    torch.cuda.synchronize()
                    case["clocks"] = sp.phase_clocks()
                    timing[(case["dtype"], q, c)] = case
                    del gam, mu, delta, z_col, part
                cases.append(case)
                del ops, tiles
    emit({"phase": "gs_kernel", "cases": cases, "max_abs_err": max_abs})
    return max_abs, timing[("float32", 10000, 1.0)]


def phase_stag_kernel():
    """B4 against B1 on the card and against its plain version, all four
    mode pairs, at STAG_SHAPES and at block 256; B1, B4, B4, B1 timed in
    turns at the largest shapes, with B4's launch plan and phase clocks."""
    import torch
    from atlasqtl_tpu_torch.ops import sweep_fused as sf
    from atlasqtl_tpu_torch.ops import sweep_staggered as ss

    names = B1_NAMES
    flat = lambda o: list(o[:6]) + list(o[6])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases, max_abs, timing = [], 0.0, None
    shapes = [(n, p, q, 128) for n, p, q in STAG_SHAPES] + [
        (*BLOCK256_SHAPE, 256)]
    for n, p, q, blk in shapes:
        for c_one, emit_gm in MODES:
            ops, block = kernel_inputs(n, p, q, 1.0 if c_one else 0.5,
                                       block=blk)
            kw = dict(block_size=block, emit_gam_mu=emit_gm, c_one=c_one)
            got = ss.sweep_fused_staggered(*ops, **kw)
            b1 = sf.sweep_fused(*ops, **kw)
            ref = ss.sweep_staggered_plain(*ops, **kw)
            torch.cuda.synchronize()
            label = (f"staggered kernel vs %s at n={n} p={p} q={q} "
                     f"block={block} c_one={c_one} emit={emit_gm}")
            errs = held(label % "plain", flat(got), flat(ref), names)
            errs_b1 = held(label % "B1", flat(got), flat(b1), names)
            max_abs = max(max_abs, *errs.values())
            r_aug = ops[3].shape[1]
            plan = ss.staggered_launch_plan(ops[0].shape[0], ops[5].shape[1],
                                            block, r_aug, sms)
            case = dict(n=n, p=p, q=q, block=block, c_one=c_one,
                        emit_gam_mu=emit_gm, max_abs_err=errs,
                        max_abs_err_vs_b1=errs_b1,
                        plan={k: plan[k] for k in ("slice_width", "sub_block",
                                                   "grid", "waves")})
            if p * q >= 2000 * 500 and c_one and blk == 128:
                # B1, B4, B4, B1 in turns on the same inputs
                b1_ms = cuda_ms(lambda: sf.sweep_fused(*ops, **kw), 5)
                case["ms"] = cuda_ms(
                    lambda: ss.sweep_fused_staggered(*ops, **kw), 5)
                case["ms_2"] = cuda_ms(
                    lambda: ss.sweep_fused_staggered(*ops, **kw), 5)
                case["clocks"] = ss.phase_clocks()
                case["b1_ms"] = [b1_ms,
                                 cuda_ms(lambda: sf.sweep_fused(*ops, **kw),
                                         5)]
                case["ratio_to_b1"] = (case["ms"] + case["ms_2"]) / sum(
                    case["b1_ms"])
                case["plain_ms"] = cuda_ms(
                    lambda: ss.sweep_staggered_plain(*ops, **kw), 2)
                case["bound_ms"], case["bound_by"] = sweep_bound_ms(
                    ops[0].shape[0], ops[0].shape[1], ops[5].shape[1], block,
                    r_aug, emit_gm)
                case["ctas_per_sm"] = ss.occupancy(plan["slice_width"],
                                                   block, r_aug)
                if case["ctas_per_sm"] != plan["ctas_per_sm"] or \
                        ss.kernel_smem_bytes(plan["slice_width"], block,
                                             r_aug) != plan["smem_bytes"]:
                    raise AssertionError(
                        f"B4 plan {plan} vs the kernel: "
                        f"{case['ctas_per_sm']} CTAs per SM, "
                        f"{ss.kernel_smem_bytes(plan['slice_width'], block, r_aug)}"
                        f" bytes of shared memory")
                if (n, p, q) == KERNEL_SHAPES[-1] and not emit_gm:
                    timing = case  # the steady-state (converged, lite) sweep
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
    counters = {"sweep_fused": sf.sweep_fused, "block_gs": sp.block_gs,
                "inner_gs_pallas": sp.inner_gs_pallas,
                "sweep_fused_staggered": ss.sweep_fused_staggered}

    # small fits: the card against the CPU float64 fit
    xs, ys = simulate(100, 75, 20, 123, 10, 20)
    ref, _, ref_gam = prepared_fit(ys, xs, Config(dtype=torch.float64), "cpu")
    small = {}
    for route, cfg in routes[1:3]:
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
    # block 256 (two blocks at p = 300): B3 takes it in one launch per block,
    # B4 in pieces of 128
    xs, ys = simulate(100, 300, 20, 123, 10, 20)
    f64 = Config(dtype=torch.float64, block_size=256)
    ref, _, ref_gam = prepared_fit(ys, xs, f64, "cpu")
    for route, cfg, tol in (
            ("pallas", Config(sweep="pallas", block_size=256), 1e-2),
            ("stagger", Config(sweep_stagger=True, block_size=256), 1e-2),
            ("pallas_f64", dataclasses.replace(f64, use_pallas=True), 1e-6)):
        res, _, gam = prepared_fit(ys, xs, cfg, DEVICE)
        key = f"{route}_block256"
        small[key] = float(np.abs(gam - ref_gam).max())
        if not (res.converged and small[key] <= tol
                and (tol > 1e-6 or res.it == ref.it)):
            raise AssertionError(
                f"small {route} fit at block 256: the card vs the CPU float64"
                f" fit, PIPs differ by {small[key]:.3g} (it {res.it} vs "
                f"{ref.it}, converged={res.converged})")

    n, p, q, p_act, q_hit = FIT_SHAPE
    x, y = simulate(n, p, q, 0, p_act, q_hit)
    own = {"fused": "sweep_fused", "pallas": "block_gs",
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
            out[route]["b1_it"] = out["fused"]["it"]
            out[route]["b1_seconds"] = out["fused"]["seconds"]
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
    # B3's route and B4 compute B1's function, their sums in another
    # order: the same converged state, not the same bits
    b1 = out["fused"]
    if abs(out["pallas"]["it"] - b1["it"]) > 0.02 * b1["it"]:
        raise AssertionError(f"sweeps_fit: the B3 route took "
                             f"{out['pallas']['it']} iterations, B1 "
                             f"{b1['it']}")
    st = out["stagger"]
    if not (abs(st["it"] - b1["it"]) <= 0.02 * b1["it"]
            and abs(st["lb_opt"] - b1["lb_opt"]) <= 1e-5 * abs(b1["lb_opt"])
            and st["pip_max_diff_vs_b1"] <= 1e-2):
        raise AssertionError(
            f"sweeps_fit: the staggered fit (it {st['it']}, lb_opt "
            f"{st['lb_opt']}) differs from B1's (it {b1['it']}, lb_opt "
            f"{b1['lb_opt']}), PIPs by {st['pip_max_diff_vs_b1']:.3g}")
    return {r: out[r]["launches"][own[r]] for r in ("pallas", "stagger")}


def gs_launch_bound(a, k):
    """bound_ms of one launch of B3's block kernel from its operands (r0,
    ...), at the c = 1 operation count: bytes bound it at either count."""
    return gs_bound_ms(*a[0].shape, a[0].element_size())[0]


def route_profile(fn, args, nb):
    """One B3-route sweep fn(*args) of nb blocks under torch.profiler: its
    CUDA launches (every kernel, memset and copy on the device), by name;
    the launches beyond 3 per block (the r0 product, the block kernel, the
    advance), not counting the reduction kernels of cuBLAS's split-K r0
    products; the device ms of the r0 products (aten::mm), the block
    kernels, the advances (aten::addmm_) and the z_row reduction."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    # one sweep to warm the tracer up (it may miss its first launches),
    # then the one it records
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 acc_events=True) as prof:
        for _ in range(2):
            fn(*args)
            torch.cuda.synchronize()
            prof.step()
    dev = lambda e: (getattr(e, "device_time_total", None)
                     or getattr(e, "cuda_time_total", 0)) / 1e3
    kernels, by_op = {}, {}
    for e in prof.key_averages():
        if e.key.startswith("ProfilerStep"):
            continue  # the step's own annotation, not a launch
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] = dict(count=e.count, ms=dev(e))
        elif e.key in ("aten::mm", "aten::addmm_") and dev(e):
            by_op[e.key] = dev(e)
    launches = sum(k["count"] for k in kernels.values())
    named = lambda part: sum(k["ms"] for name, k in kernels.items()
                             if part in name)
    # cuBLAS may split the r0 product's sum over the samples in two kernels
    # (split-K), the second a reduction: one host call, two launches
    split_k = sum(k["count"] for name, k in kernels.items()
                  if "splitKreduce" in name)
    blk = sum(k["count"] for name, k in kernels.items()
              if "inner_gs_kernel" in name)
    # the tracer loses a few records at the start of a window (1-3 of each
    # kernel in these runs): per block, count what it saw per block kernel
    return dict(launches_per_sweep=launches, blocks=nb,
                block_kernel_launches=blk, split_k_reduce_launches=split_k,
                launches_per_block=(launches - split_k) / blk,
                launches_beyond_3_per_block=launches - split_k - 3 * blk,
                r0_product_ms=by_op.get("aten::mm"),
                block_kernel_ms=named("inner_gs_kernel"),
                advance_ms=by_op.get("aten::addmm_"),
                zrow_reduce_ms=named("zrow_reduce"),
                device_ms=sum(k["ms"] for k in kernels.values()),
                kernels=kernels)


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
    x, y, init, init_s = eqtl_problem(0.0)
    t0 = time.perf_counter()
    dat = prepare_data(y, x, 0.1, 10, 1, 0)
    t1 = time.perf_counter()
    hyper_spec = elic.auto_set_hyper(dat.y, p, (5, 25))
    t2 = time.perf_counter()
    cfg = Config(dtype=torch.float32, maxit=10, shr_fac_inv=float(q))
    data = gl.build_data(dat.x, dat.y, cfg, DEVICE)
    hyper = gl.build_hyper(hyper_spec, data.y.shape[1], cfg, DEVICE)
    state = gl.build_state(init, data, cfg)
    torch.cuda.synchronize()
    built = dict(prepare_s=t1 - t0, host_init_s=init_s,
                 build_s=time.perf_counter() - t2)
    del dat
    _EQTL.clear()  # the last phase that fits the eQTL problem
    routes = (
        ("pallas", dataclasses.replace(cfg, sweep="pallas"),
         (sp, "_block_gs_cuda"), sp.block_gs, gs_launch_bound,
         (gl, "sweep_complete_pallas"), data.x.shape[1] // 128),
        ("stagger", dataclasses.replace(cfg, sweep_stagger=True),
         (ss, "_sweep_staggered_cuda"), ss.sweep_fused_staggered,
         b1_launch_bound, None, 1))
    profile = None
    for route, rcfg, launch, counter, bound, sweep, per_it in routes:
        st = dataclasses.replace(state, **{
            f.name: getattr(state, f.name).clone()
            for f in dataclasses.fields(state)
            if torch.is_tensor(getattr(state, f.name))})
        last = {}
        if sweep:  # keep the last sweep's arguments to profile it again
            orig_sweep = getattr(*sweep)

            def keep(*a, **k):
                last.update(args=a, kwargs=k)
                return orig_sweep(*a, **k)
            setattr(*sweep, keep)
        try:
            res, stats = timed_run(
                lambda: fit_global_local(data, hyper, st, rcfg,
                                         anneal=(1, 2, 5), verbose=0),
                launch, counter, bound, sweep)
        finally:
            if sweep:
                setattr(*sweep, orig_sweep)
        stats.pop("host_init_s"), stats.pop("build_state_s")
        if last:
            stats["profile"] = route_profile(
                lambda *a: orig_sweep(*a, **last["kwargs"]), last["args"],
                per_it)
            last.clear()
        finite = bool(torch.isfinite(res.state.gam).all())
        emit(dict(phase="eqtl_sweeps", route=route, n=n, p=p, q=q,
                  anneal=[1, 2, 5], maxit=10, built_once=built, **stats,
                  finite=finite))
        prof = stats.get("profile")
        if prof and not (per_it - 5 <= prof["block_kernel_launches"] <= per_it
                         and prof["launches_beyond_3_per_block"] <= 10):
            raise AssertionError(f"eqtl_sweeps {route}: "
                                 f"{stats['profile']['launches_per_sweep']} "
                                 f"launches for {per_it} blocks")
        if stats["launches"] != res.it * per_it or not finite:
            raise AssertionError(f"eqtl_sweeps {route}: {stats['launches']} "
                                 f"launches for {res.it} iterations, "
                                 f"finite={finite}")
        if route == "pallas":
            profile = stats["profile"]
        del st, res
        torch.cuda.empty_cache()
    return profile


def phase_dev_init():
    """atlasqtl(user_seed=1, maxit=10, anneal=(1, 2, 5)) at the eQTL shape
    with no list_init: the initial state is drawn on the card
    (models/global_local.py:auto_init_device).  Prints the draw's seconds,
    the seconds from the end of prepare_data to the first iteration beside
    the host path's (the eqtl phase's, when it ran: eqtl_problem's host
    draw plus its state building), the drawn state's moments against their
    theoretical values, and the fit's peak device memory, which may not
    exceed the host-init fit's."""
    import torch
    from scipy.special import digamma, ndtr
    import atlasqtl_tpu_torch as at
    from atlasqtl_tpu_torch import api
    from atlasqtl_tpu_torch.inference.elicitation import get_n0_t02
    from atlasqtl_tpu_torch.models import global_local as gl

    x, y, _, host_init_s = eqtl_problem(0.0)
    n, p = x.shape
    q = y.shape[1]
    orig = dict(draw=gl.auto_init_device, it=gl.cavi_iteration,
                prep=api.prepare_data)
    marks, moments = {}, {}

    def prepared(*a, **k):
        out = orig["prep"](*a, **k)
        marks["prepared"] = time.perf_counter()
        return out

    def draw(seed, data, *a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        st = orig["draw"](seed, data, *a, **k)
        torch.cuda.synchronize()
        marks["draw_s"] = time.perf_counter() - t
        pt, qt = int(data.p_true), int(data.q_true)
        ls2b = torch.log(st.sig2_beta[:qt].double())
        z = st.zeta[:qt].double()
        moments.update(
            gam_mean=float(st.gam[:pt, :qt].double().mean()),
            log_sig2_beta_mean=float(ls2b.mean()),
            log_sig2_beta_var=float(ls2b.var()),
            zeta_mean=float(z.mean()), zeta_var=float(z.var()),
            tau=float(st.tau[0]), sig02_inv=float(st.sig02_inv))
        return st

    def iteration(*a, **k):
        if "first_iteration" not in marks:
            torch.cuda.synchronize()
            marks["first_iteration"] = time.perf_counter()
        return orig["it"](*a, **k)

    gl.auto_init_device, gl.cavi_iteration = draw, iteration
    api.prepare_data = prepared
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = at.atlasqtl(y, x, p0=(5, 25), anneal=(1, 2, 5), maxit=10,
                          dtype=torch.float32, verbose=0, user_seed=1,
                          device=DEVICE)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        gl.auto_init_device, gl.cavi_iteration = orig["draw"], orig["it"]
        api.prepare_data = orig["prep"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    n0_vec, t02 = get_n0_t02(1, p, (5, 25))
    n0 = float(n0_vec[0])
    theory = dict(
        gam_mean=float(ndtr(n0 / np.sqrt(1.0 + (1e-4 + t02) ** 2))),
        log_sig2_beta_mean=float(-digamma(2.0)
                                 - np.log(1e-2 * moments["tau"])),
        log_sig2_beta_var=0.6449340668482264,   # trigamma(2)
        zeta_mean=n0, zeta_var=float(t02))
    host = _EQTL_STATS.get(("eqtl", None))
    out = dict(phase="dev_init", n=n, p=p, q=q, anneal=[1, 2, 5], maxit=10,
               it=res.it, device_init_s=marks["draw_s"],
               prepare_to_first_iteration_s=marks["first_iteration"]
               - marks["prepared"],
               host_init_s=host_init_s,
               host_path_prepare_to_first_iteration_s=None if host is None
               else host["host_path_prepare_to_first_iteration_s"],
               total_s=total, max_memory_allocated_gb=peak,
               host_init_fit_max_memory_allocated_gb=None if host is None
               else host["max_memory_allocated_gb"],
               moments=moments, theory=theory,
               finite=bool(np.isfinite(res.gam_vb).all()
                           and np.isfinite(res.theta_vb).all()))
    emit(out)
    if not out["finite"] or res.gam_vb.shape != (p, q):
        raise AssertionError("dev_init: non-finite or misshapen outputs")
    se = lambda v: 4.0 * np.sqrt(v / q)
    checks = dict(
        gam_mean=abs(moments["gam_mean"] / theory["gam_mean"] - 1) < 0.02,
        log_sig2_beta_mean=abs(moments["log_sig2_beta_mean"]
                               - theory["log_sig2_beta_mean"])
        < se(theory["log_sig2_beta_var"]),
        log_sig2_beta_var=abs(moments["log_sig2_beta_var"]
                              - theory["log_sig2_beta_var"]) < 0.06,
        zeta_mean=abs(moments["zeta_mean"] - n0) < se(t02),
        zeta_var=abs(moments["zeta_var"] / t02 - 1) < 0.06)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"dev_init: moments off their theory: {bad}")
    limit = 22.5 if host is None else host["max_memory_allocated_gb"]
    if peak > limit:
        raise AssertionError(f"dev_init: peak {peak:.2f} GB over the host-"
                             f"init fit's {limit:.2f} GB")


def _count_lite_d2h(prof):
    """Device-to-host copies made inside the device loop's lite steps of a
    torch.profiler run (the steps are record_function ranges named
    "device_loop:<kind>"): the CPU calls inside a lite range that launched a
    "Memcpy DtoH" or read a scalar (aten::_local_scalar_dense).  Returns
    (copies, lite steps)."""
    evs = [e for e in prof.events() if e.device_type.name == "CPU"]
    lite = [e for e in evs if e.name.startswith("device_loop:")
            and "lite" in e.name]
    copies = 0
    for e in evs:
        if e.name.startswith("device_loop:"):
            continue
        d2h = (e.name == "aten::_local_scalar_dense"
               or any("DtoH" in k.name for k in e.kernels))
        if d2h and any(r.thread == e.thread
                       and r.time_range.start <= e.time_range.start
                       and e.time_range.end <= r.time_range.end
                       for r in lite):
            copies += 1
    return copies, len(lite)


# the hand-written kernels' names (csrc/*.cu); B3's cuBLAS products count
# as other kernels
SWEEP_KERNELS = ("sweep_fused_kernel", "sweep_missing_kernel",
                 "sweep_staggered_kernel", "inner_gs_kernel",
                 "zrow_reduce_kernel")


def fit_profile(run, loop, window=None):
    """One fit under torch.profiler (CPU and CUDA activity), split as the
    host loop's ranges (the model's cavi_iteration and compute_elbo) or the
    device loop's steps (record_function ranges per step kind): wall
    seconds; host seconds in each range kind; host seconds blocked in
    synchronising calls; device seconds in the sweep kernels and in every
    other kernel (glue and ELBO) and the device's idle share; kernel
    launches and graph launches; and the device-to-host copies inside lite
    steps (`_count_lite_d2h`).  window = (skip, steps) records only the
    device loop's steps skip+2 .. skip+steps+1 (torch.profiler's schedule:
    skip, one warm-up step, then the active ones), where every kind of
    step is a graph replay; the wall seconds are then the whole fit's."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from atlasqtl_tpu_torch.inference import device_loop as dl
    from atlasqtl_tpu_torch.models import global_local as gl

    orig = dict(it=gl.cavi_iteration, elbo=gl.compute_elbo,
                step=dl._Step.__call__)

    def ranged(name, fn):
        def w(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return w

    def step(self):
        with record_function(f"device_loop:{self.name}"):
            out = orig["step"](self)
        if window:
            prof.step()
        return out

    gl.cavi_iteration = ranged("model:iteration", orig["it"])
    gl.compute_elbo = ranged("model:elbo", orig["elbo"])
    dl._Step.__call__ = step
    try:
        torch.cuda.synchronize()
        sched = None if window is None else torch.profiler.schedule(
            wait=window[0], warmup=1, active=window[1], repeat=1)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=sched) as prof:
            t0 = time.perf_counter()
            res = run(loop)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        gl.cavi_iteration, gl.compute_elbo = orig["it"], orig["elbo"]
        dl._Step.__call__ = orig["step"]
    evs = prof.events()
    cpu = [e for e in evs if e.device_type.name == "CPU"]
    dev = [e for e in evs if e.device_type.name == "CUDA"]
    ranges = {}
    for e in cpu:
        if e.name.startswith(("model:", "device_loop:")):
            r = ranges.setdefault(e.name, [0, 0.0])
            r[0] += 1
            r[1] += (e.time_range.end - e.time_range.start) / 1e6
    sync_s = sum((e.time_range.end - e.time_range.start) / 1e6 for e in cpu
                 if e.name in ("cudaStreamSynchronize",
                               "cudaDeviceSynchronize", "cudaMemcpy",
                               "cudaEventSynchronize"))
    # the device events are kernels, copies, fills and the ranges' own
    # GPU-side annotations (named as the ranges), which are not work
    kern = [e for e in dev if not e.name.startswith(
        ("Memcpy", "Memset", "model:", "device_loop:"))]
    span = lambda e: (e.time_range.end - e.time_range.start) / 1e6
    sweep_s = sum(span(e) for e in kern
                  if any(k in e.name for k in SWEEP_KERNELS))
    busy = sum(span(e) for e in kern)
    d2h, lite = _count_lite_d2h(prof) if loop == "on" else (None, None)
    return res, dict(
        loop=loop, wall_s=wall,
        ranges={k: {"count": v[0], "host_s": v[1]}
                for k, v in sorted(ranges.items())},
        host_sync_s=sync_s, device_sweep_s=sweep_s,
        device_other_s=busy - sweep_s,
        device_idle_share=None if window else 1.0 - busy / wall,
        device_kernels=len(kern),
        kernel_launch_calls=sum(1 for e in cpu
                                if e.name in ("cudaLaunchKernel",
                                              "cudaLaunchKernelExC",
                                              "cuLaunchKernel",
                                              "cuLaunchKernelEx")),
        graph_launch_calls=sum(1 for e in cpu if e.name == "cudaGraphLaunch"),
        d2h_device_copies=sum(1 for e in dev if "DtoH" in e.name),
        lite_steps_profiled=lite, d2h_copies_in_lite_steps=d2h,
        d2h_copies_per_lite_step=None if not lite else d2h / lite)


def phase_device_loop():
    """At the sim_anneal shape, every route under device_loop="off" and
    "on": B1 (complete data), B2 (exact missing), impute (B1), the B3 route
    in float32 and float64, B4, block 256 (B1 in pieces of 128) and
    model="global" (the plain engines, ~50k launches per iteration: cut to
    40 iterations, float64).  Each fit is driven with every kernel's count
    set to 0 just before it and read just after; the "on" fit runs again
    under torch.profiler, recording steps 16-35 (global: 16-19), where
    every kind of step is a graph replay, for its device-to-host copies per
    lite step, which must be 0; B1's fit cut to 60 iterations is profiled
    whole under both loops for PERF.md's breakdown.  Fails unless both loops take the same
    iterations, evaluate the ELBO at the same ones and agree on it to 1e-6
    relative; prints seconds per fit, CUDA-graph replays and launches."""
    import torch
    import atlasqtl_tpu_torch as at
    from atlasqtl_tpu_torch.types import Config
    from atlasqtl_tpu_torch.inference import device_loop as dl
    from atlasqtl_tpu_torch.ops import sweep_fused as sf
    from atlasqtl_tpu_torch.ops import sweep_missing_fused as sm
    from atlasqtl_tpu_torch.ops import sweep_pallas as sp
    from atlasqtl_tpu_torch.ops import sweep_staggered as ss

    n, p, q, p_act, q_hit = FIT_SHAPE
    x, y = simulate(n, p, q, 0, p_act, q_hit)
    xm, ym = simulate(n, p, q, 0, p_act, q_hit, missing_frac=0.15)
    counters = {"sweep_fused": sf.sweep_fused,
                "sweep_missing_fused": sm.sweep_missing_fused,
                "block_gs": sp.block_gs,
                "sweep_fused_staggered": ss.sweep_fused_staggered}
    api_kw = dict(p0=(5, 25), anneal=(1, 2, 10), dtype=torch.float32,
                  verbose=0, user_seed=0, device=DEVICE)

    def api_fit(yy, xx, **kw):
        def run(loop, **cut):
            return at.atlasqtl(yy, xx, device_loop=loop,
                               **{**api_kw, **kw, **cut})
        return run

    def route_fit(cfg):
        def run(loop, **cut):
            return prepared_fit(y, x, dataclasses.replace(
                cfg, device_loop=loop, **cut), DEVICE, seed=0)[0]
        return run

    routes = (
        ("b1", api_fit(y, x), "sweep_fused", 1),
        ("b2", api_fit(ym, xm, missing="exact"), "sweep_missing_fused", 1),
        ("impute", api_fit(ym, xm, missing="impute"), "sweep_fused", 1),
        ("b3_f32", route_fit(Config(sweep="pallas")), "block_gs", 16),
        ("b3_f64", route_fit(Config(dtype=torch.float64, use_pallas=True)),
         "block_gs", 16),
        ("b4", route_fit(Config(sweep_stagger=True)),
         "sweep_fused_staggered", 1),
        ("block256", api_fit(y, x, block_size=256), "sweep_fused", 1),
        # the plain engines: ~50k launches per iteration, so cut to 40
        # iterations; float64, as the reference's own tests fit this model
        ("global", api_fit(y, x, model="global", dtype=torch.float64,
                           maxit=40), None, 0),
    )
    profiles = {}
    for route, run, own, per_it in routes:
        t_route = time.perf_counter()
        fits = {}
        for loop in ("off", "on"):
            torch.cuda.synchronize()
            for fn in counters.values():
                fn.launches = 0
            dl.replays = 0
            t0 = time.perf_counter()
            res = run(loop)
            torch.cuda.synchronize()
            fits[loop] = dict(res=res, seconds=time.perf_counter() - t0,
                              launches={k: fn.launches
                                        for k, fn in counters.items()},
                              replays=dl.replays)
        if route == "b1":  # PERF.md's breakdown: 60 iterations, both loops
            profiles = {loop: fit_profile(
                lambda lp: run(lp, maxit=60), loop)[1]
                for loop in ("off", "on")}
        # the copies per lite step, over steps 16-35 (global: 16-19), every
        # kind of step a graph replay by then
        _, prof = fit_profile(run, "on",
                              window=(14, 4 if route == "global" else 20))
        off, on = fits["off"]["res"], fits["on"]["res"]
        h_off = np.array([lb for _, lb in off.elbo_history])
        h_on = np.array([lb for _, lb in on.elbo_history])
        same_evals = ([i for i, _ in off.elbo_history]
                      == [i for i, _ in on.elbo_history])
        rel = (float(np.max(np.abs(h_on - h_off) / np.abs(h_off)))
               if same_evals and len(h_off) else None)
        out = dict(phase="device_loop", route=route, n=n, p=p, q=q,
                   it_off=off.it, it_on=on.it, converged_off=off.converged,
                   converged_on=on.converged, elbo_evals=len(h_on),
                   same_elbo_iterations=same_evals,
                   elbo_max_rel_diff=rel,
                   seconds_off=fits["off"]["seconds"],
                   seconds_on=fits["on"]["seconds"],
                   graph_replays_on=fits["on"]["replays"],
                   graph_replays_off=fits["off"]["replays"],
                   launches_off=fits["off"]["launches"],
                   launches_on=fits["on"]["launches"],
                   d2h_copies_per_lite_step=prof[
                       "d2h_copies_per_lite_step"],
                   lite_steps_profiled=prof["lite_steps_profiled"],
                   d2h_device_copies_on=prof["d2h_device_copies"],
                   phase_seconds=time.perf_counter() - t_route)
        emit(out)
        if not ((off.converged and on.converged or route == "global")
                and off.it == on.it and same_evals and rel is not None
                and rel <= 1e-6):
            raise AssertionError(f"device_loop {route}: the loops differ "
                                 f"(it {off.it} / {on.it}, same evaluations "
                                 f"{same_evals}, ELBO rel diff {rel})")
        if prof["d2h_copies_in_lite_steps"] or not prof["lite_steps_profiled"]:
            raise AssertionError(f"device_loop {route}: "
                                 f"{prof['d2h_copies_in_lite_steps']} "
                                 f"device-to-host copies in "
                                 f"{prof['lite_steps_profiled']} lite steps")
        if fits["on"]["replays"] == 0 or fits["off"]["replays"]:
            raise AssertionError(f"device_loop {route}: graph replays "
                                 f"{fits['on']['replays']} (on), "
                                 f"{fits['off']['replays']} (off)")
        for loop in ("off", "on"):
            counts = fits[loop]["launches"]
            want = fits[loop]["res"].it * per_it
            if (own and counts[own] != want) or sum(counts.values()) != want:
                raise AssertionError(f"device_loop {route} ({loop}): "
                                     f"launches {counts} for "
                                     f"{fits[loop]['res'].it} iterations")
    emit(dict(phase="device_loop_profile", route="b1", **profiles))


# ---------------------------------------------------- annealing replicas (A8)

REPLICA_SHAPES = ((300, 2000, 500), (1000, 2048, 10000))
REPLICA_MS = (1, 2, 4)


def replica_problem(kind, n, p, q, m, seed=0):
    """One seeded problem at (n, p, q) (15% of Y missing for B2) and m
    host-drawn states of it (seeds seed .. seed + m - 1), on the card."""
    import torch
    from atlasqtl_tpu_torch.types import Config
    from atlasqtl_tpu_torch.models import global_local as gl
    from atlasqtl_tpu_torch.inference import elicitation as elic
    from atlasqtl_tpu_torch.ops.sweep import block_gram

    frac = 0.15 if kind == "b2" else 0.0
    x, y = simulate(n, p, q, seed, min(10, p), max(2, q // 5), frac)
    x = (x - x.mean(0)) / x.std(0, ddof=1)
    y = y - np.nanmean(y, axis=0)
    cfg = Config(dtype=torch.float32, shr_fac_inv=float(q), block_size=128)
    data = gl.build_data(x, y, cfg, DEVICE)
    block = gl.data_block(cfg, data)
    states = [gl.build_state(elic.auto_set_init(y, p, (4, 16), float(q),
                                                seed + r), data, cfg)
              for r in range(m)]
    gram = block_gram(data.x, block) if kind == "b1" else None
    return data, states, gram, block


def replica_operands(kind, data, states, gram, block, c):
    """Each replica's operands of one sweep at temperature c (its own
    tau, slab precision and log-expectations drawn from its seed), and
    the stacked operands of the batched launch."""
    import torch
    from atlasqtl_tpu_torch.ops import updates as upd
    from atlasqtl_tpu_torch.ops.sweep import SweepConsts
    from atlasqtl_tpu_torch.ops.sweep_fused import fused_operands
    from atlasqtl_tpu_torch.ops.sweep_missing_fused import \
        missing_fused_operands

    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=DEVICE)
    parts = []
    for r, st in enumerate(states):
        rng = np.random.default_rng(100 + r)
        tau = f32(rng.uniform(0.5, 2.0, data.y.shape[1]))
        s2i = f32(rng.uniform(0.5, 1.0))
        consts = SweepConsts(
            sig2_beta=upd.sig2_beta_update(data.n, s2i, tau, data.x_norm_sq,
                                           f32(c)),
            tau=tau, log_tau=torch.log(tau) - 0.1, log_sig2_inv=f32(-0.3),
            theta=st.theta, zeta=st.zeta, c=f32(c))
        if kind == "b2":
            parts.append(missing_fused_operands(
                data.x, data.cp_x_y, data.x_norm_sq, data.mis_pat, st.gam,
                st.mu_beta, st.fitted, consts, s2i, data.p_mask,
                data.q_mask))
        else:
            parts.append(fused_operands(
                data.x, data.cp_x_y, gram, st.beta, st.fitted, consts, block,
                data.p_mask, data.q_mask))
    from atlasqtl_tpu_torch.ops import sweep_fused as sf
    from atlasqtl_tpu_torch.ops import sweep_missing_fused as sm
    return parts, (sm.MISSING if kind == "b2" else sf.FUSED).stack(parts)


def replica_bound_ms(kind, n, p, q, block, r_aug, m):
    """Least time of one launch of m replicas' sweeps: m times one sweep's
    operations; the shared operands' bytes once (x, X^T Y and the Gram
    blocks; for B2 also x_norm_sq and the mask), the state's m times."""
    if kind == "b1":
        ops = m * p * q * (4 * n + block + 6 * r_aug)
        shared = n * p + p * q + p * block
        per = 2 * p * q + 2 * n * q + p * r_aug + 3 * r_aug * q
    else:
        ops = m * p * q * (5 * n + 6 * r_aug)
        shared = n * p + 2 * p * q + n * q
        per = 4 * p * q + 2 * n * q + p * r_aug + 3 * r_aug * q
    nbytes = 4 * (shared + m * per)
    return 1e3 * max(ops / FP32_PEAK, nbytes / HBM_RATE), \
        ("operations" if ops / FP32_PEAK >= nbytes / HBM_RATE else "bytes")


def phase_replica_kernel():
    """B1 and B2 with a replica axis (annealing replicas: one launch sweeps
    m states), at REPLICA_SHAPES (B2 with 15% of Y missing), c = 1 and
    c = 0.5, m = 1, 2, 4: each replica of a batched launch bit for bit
    equal to its own single launch under the same plan, and each
    replica's single launch held against the plain version at the kernel
    phases' tolerance; then (c = 1) ms per batched
    launch against m single launches in a row (CUDA events, median of 7),
    the plan for m replicas (width or cluster, waves) and the share of
    the bound per launch."""
    import torch
    from atlasqtl_tpu_torch.ops import sweep_fused as sf
    from atlasqtl_tpu_torch.ops import sweep_missing_fused as sm

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases, timing, max_abs = [], {"b1": {}, "b2": {}}, {"b1": 0.0, "b2": 0.0}
    for kind in ("b1", "b2"):
        fn = sf.sweep_fused if kind == "b1" else sm.sweep_missing_fused
        plain = (sf.sweep_fused_plain if kind == "b1"
                 else sm.sweep_missing_fused_plain)
        flat = ((lambda o: list(o[:6]) + list(o[6])) if kind == "b1"
                else list)
        names = (B1_NAMES if kind == "b1"
                 else ("gam", "mu", "fitted", "z_row", "z_col"))
        for n, p, q in REPLICA_SHAPES:
            data, states, gram, block = replica_problem(kind, n, p, q,
                                                        max(REPLICA_MS))
            for c in (1.0, 0.5):
                parts, stacked = replica_operands(kind, data, states, gram,
                                                  block, c)
                kw = (dict(block_size=block, emit_gam_mu=c != 1.0,
                           c_one=c == 1.0) if kind == "b1"
                      else dict(block_size=block))
                singles = [flat(fn(*ops, **kw)) for ops in parts]
                errs = {}
                for r, ops in enumerate(parts):
                    e = held(f"{kind} replica {r} vs plain at n={n} p={p} "
                             f"q={q} c={c}", singles[r],
                             flat(plain(*ops, **kw)), names)
                    errs = {k: max(v, errs.get(k, 0.0)) for k, v in e.items()}
                max_abs[kind] = max(max_abs[kind], *errs.values())
                r_aug = parts[0][3 if kind == "b1" else 4].shape[1]
                q_pad = parts[0][5 if kind == "b1" else 6].shape[1]
                n_pad, p_pad = parts[0][0].shape
                for m in REPLICA_MS:
                    ops_m = [o if o.dim() == parts[0][i].dim() else o[:m]
                             for i, o in enumerate(stacked)]
                    before = fn.launches
                    got = flat(fn(*ops_m, **kw))
                    torch.cuda.synchronize()
                    if fn.launches != before + 1:
                        raise AssertionError(f"{kind} at m={m}: "
                                             f"{fn.launches - before} "
                                             "launches counted for one")
                    # each replica against its single launch under the
                    # same plan (m replicas may take another slice width
                    # or cluster, which sums in another order); the count
                    # is put back after them
                    plan = (sf.fused_launch_plan(n_pad, q_pad, block, r_aug,
                                                 sms, m) if kind == "b1"
                            else sm.missing_launch_plan(n_pad, q_pad, block,
                                                        r_aug, m))
                    for r in range(m):
                        one = flat(
                            sf.fused_launch("atlasqtl_sweep_fused", *parts[r],
                                            **kw,
                                            slice_width=plan["slice_width"])
                            if kind == "b1"
                            else sm._sweep_missing_fused_cuda(
                                *parts[r], **kw, plan=plan))
                        for name, a, b in zip(names, got, one):
                            if b is not None and not torch.equal(a[r], b):
                                raise AssertionError(
                                    f"{kind} replica {r} of {m} at n={n} "
                                    f"p={p} q={q} c={c}: {name} differs "
                                    "from its single launch")
                    fn.launches = before + 1
                    case = dict(kernel=kind, n=n, p=p, q=q, c=c, m=m,
                                bitwise_equal=True, max_abs_err=errs,
                                plan=plan)
                    if c == 1.0:
                        case["ms"] = cuda_ms(lambda: fn(*ops_m, **kw), 7)
                        case["single_ms"] = cuda_ms(
                            lambda: [fn(*parts[r], **kw) for r in range(m)],
                            7)
                        case["bound_ms"], case["bound_by"] = \
                            replica_bound_ms(kind, n_pad, p_pad, q_pad,
                                             block, r_aug, m)
                        case["pct_of_bound"] = pct(case["bound_ms"],
                                                   case["ms"])
                        if kind == "b1":
                            case["waves"] = plan["waves"]
                        else:
                            case["ctas"] = plan["grid"] * m
                            case["waves"] = -(-plan["grid"] * m
                                              // (sms * plan["ctas_per_sm"]))
                        timing[kind].setdefault(f"{n}x{p}x{q}", {})[m] = {
                            k: case[k] for k in ("ms", "single_ms",
                                                 "bound_ms", "pct_of_bound",
                                                 "waves")}
                    cases.append(case)
                    del got
                del parts, stacked, singles
            del data, states, gram
            torch.cuda.empty_cache()
    emit({"phase": "replica_kernel", "cases": cases, "max_abs_err": max_abs})
    return timing, max_abs


def _replica_elbos_apart(y, x, seed, missing, m):
    """Each of the m replicas a fit with anneal_replicas=m and user_seed=
    seed anneals (the host draws of seeds seed, seed + 1 + r), each taken
    through the ladder alone (single-replica iterations, the last rung
    full): their float64 ELBOs."""
    import torch
    from atlasqtl_tpu_torch.types import Config
    from atlasqtl_tpu_torch.io.prepare import prepare_data
    from atlasqtl_tpu_torch.inference import elicitation as elic
    from atlasqtl_tpu_torch.models import global_local as gl
    from atlasqtl_tpu_torch.ops.annealing import annealing_ladder
    from atlasqtl_tpu_torch.ops.sweep import block_gram

    dat = prepare_data(y, x, 0.1, 1000, seed, 0)
    p, q = dat.x.shape[1], dat.y.shape[1]
    cfg = Config(dtype=torch.float32, shr_fac_inv=float(q), missing=missing)
    data = gl.build_data(dat.x, dat.y, cfg, DEVICE)
    hyper = gl.build_hyper(elic.auto_set_hyper(dat.y, p, (5, 25)),
                           data.y.shape[1], cfg, DEVICE)
    block = gl.data_block(cfg, data)
    gram = block_gram(data.x, block) if data.x_norm_sq is None else None
    ladder = annealing_ladder(np.array([1.0, 2.0, 10.0]))
    elbos = []
    for s in [seed] + [seed + 1 + r for r in range(m - 1)]:
        st = gl.build_state(elic.auto_set_init(dat.y, p, (5, 25), float(q),
                                               s), data, cfg)
        for k, c in enumerate(ladder[:-1]):
            st = gl.cavi_iteration(data, hyper, st, gram, c, c, cfg=cfg,
                                   annealed=True, block=block,
                                   lite=k + 1 < len(ladder) - 1)
        elbos.append(float(gl.compute_elbo(data, hyper, st, cfg=cfg)))
    return elbos


class _ReplicaElbos(logging.Handler):
    """Collects a fit's 'Annealing replica r: ELBO = x' log lines."""

    def __init__(self):
        super().__init__()
        self.elbos = {}

    def emit(self, record):
        m = re.match(r"Annealing replica (\d+): ELBO = (\S+)",
                     record.getMessage())
        if m:
            self.elbos[int(m.group(1))] = float(m.group(2))


def phase_a8_fit():
    """The A8 options at the sim_anneal shape (float32, anneal=(1, 2, 10)):
    anneal_replicas=3 on complete data, with 15% of Y missing (exact, B2)
    and imputed (B1): one sweep launch per rung for the three replicas plus
    one per converged iteration (counts set to 0 just before each fit and
    read just after), the converged phase on the graph loop, the selected
    replica's ELBO the largest of the three as each replica's ladder
    computes it alone, AUC >= 0.95; a fit with checkpoint_path and
    trace_path (the host loop) cut at maxit before convergence, then a
    resume from its last snapshot through load_checkpoint that converges;
    full_output=True with the reference's 24 names (cp_X formed at
    p = 2000); permutation_null_calibration with n_perms=4, timed."""
    import os
    import tempfile
    import torch
    import atlasqtl_tpu_torch as at
    from atlasqtl_tpu_torch.inference import device_loop as dl
    from atlasqtl_tpu_torch.ops import sweep_fused as sf
    from atlasqtl_tpu_torch.ops import sweep_missing_fused as sm

    n, p, q, p_act, q_hit = FIT_SHAPE
    base = dict(p0=(5, 25), anneal=(1, 2, 10), dtype=torch.float32,
                device=DEVICE)
    out = {"phase": "a8_fit", "n": n, "p": p, "q": q}
    logger = logging.getLogger("atlasqtl_tpu_torch")
    for missing in (None, "exact", "impute"):
        frac = 0.0 if missing is None else 0.15
        x, y = simulate(n, p, q, 0, p_act, q_hit, frac)
        rec = _ReplicaElbos()
        logger.addHandler(rec)
        level = logger.level
        logger.setLevel(logging.INFO)
        torch.cuda.synchronize()
        sf.sweep_fused.launches = sm.sweep_missing_fused.launches = 0
        dl.replays = 0
        t0 = time.perf_counter()
        try:
            res = at.atlasqtl(y, x, verbose=1, user_seed=0, anneal_replicas=3,
                              missing=missing or "exact", **base)
            torch.cuda.synchronize()
        finally:
            logger.removeHandler(rec)
            logger.setLevel(level)
        secs = time.perf_counter() - t0
        counts = {"sweep_fused": sf.sweep_fused.launches,
                  "sweep_missing_fused": sm.sweep_missing_fused.launches}
        replays = dl.replays
        own = "sweep_missing_fused" if missing == "exact" else "sweep_fused"
        apart = _replica_elbos_apart(y, x, 0, missing or "exact", 3)
        fit_elbos = [rec.elbos.get(r) for r in range(3)]
        auc = hotspot_auc(res.theta_vb, p_act)
        key = missing or "complete"
        out[key] = dict(converged=bool(res.converged), it=res.it,
                        launches=counts, graph_replays=replays, seconds=secs,
                        replica_elbos=fit_elbos, replica_elbos_apart=apart,
                        hotspot_auc_theta=auc, lb_opt=res.lb_opt)
        if not res.converged or auc < 0.95:
            raise AssertionError(f"a8_fit replicas {key}: converged="
                                 f"{res.converged}, AUC {auc:.3f}")
        if counts[own] != res.it or sum(counts.values()) != res.it:
            raise AssertionError(f"a8_fit replicas {key}: launches {counts} "
                                 f"for {res.it} iterations (9 rungs of 3 "
                                 "replicas, one launch each)")
        if replays == 0:
            raise AssertionError(f"a8_fit replicas {key}: the converged "
                                 "phase did not run on the graph loop")
        if None in fit_elbos or int(np.argmax(fit_elbos)) != int(
                np.argmax(apart)) or not np.allclose(fit_elbos, apart,
                                                     rtol=1e-6):
            raise AssertionError(f"a8_fit replicas {key}: the fit's replica "
                                 f"ELBOs {fit_elbos} vs apart {apart}")

    x, y = simulate(n, p, q, 0, p_act, q_hit)
    with tempfile.TemporaryDirectory() as tmp:
        ck, tr = os.path.join(tmp, "ckpt"), os.path.join(tmp, "trace")
        os.makedirs(ck), os.makedirs(tr)
        dl.replays = 0
        t0 = time.perf_counter()
        cut = at.atlasqtl(y, x, verbose=0, user_seed=0, maxit=110,
                          checkpoint_path=ck, trace_path=tr, **base)
        torch.cuda.synchronize()
        cut_s, cut_replays = time.perf_counter() - t0, dl.replays
        snaps = sorted(f for f in os.listdir(ck) if f.startswith("tmp_"))
        with open(os.path.join(
                tr, "traces_top_local_x_global_parameters.csv")) as fh:
            trace_rows = len(fh.read().splitlines()) - 1
        if cut.converged or snaps != ["tmp_output_it_100.npz"] or \
                cut_replays != 0 or trace_rows != 5:
            raise AssertionError(f"a8_fit checkpoint: converged="
                                 f"{cut.converged}, snapshots {snaps}, "
                                 f"graph replays {cut_replays}, trace rows "
                                 f"{trace_rows}")
        init = at.load_checkpoint(os.path.join(ck, snaps[-1]))
        t0 = time.perf_counter()
        res = at.atlasqtl(y, x, verbose=0, list_init=init, **dict(
            base, anneal=None))
        torch.cuda.synchronize()
        auc = hotspot_auc(res.theta_vb, p_act)
        out["checkpoint"] = dict(cut_it=cut.it, cut_seconds=cut_s,
                                 snapshots=snaps, trace_rows=trace_rows,
                                 resume_it=res.it,
                                 resume_converged=bool(res.converged),
                                 resume_seconds=time.perf_counter() - t0,
                                 hotspot_auc_theta=auc)
        if not res.converged or auc < 0.95:
            raise AssertionError(f"a8_fit resume: converged={res.converged}"
                                 f", AUC {auc:.3f}")

    t0 = time.perf_counter()
    res = at.atlasqtl(y, x, verbose=0, user_seed=0, full_output=True, **base)
    torch.cuda.synchronize()
    fo = res.full_output
    expected = {"beta_vb", "eta_vb", "gam_vb", "kappa_vb", "lam2_inv_vb",
                "nu_s0_vb", "nu_vb", "nu_xi_inv_vb", "rho_s0_vb", "rho_vb",
                "rho_xi_inv_vb", "shr_fac_inv", "sig02_inv_vb",
                "sig2_beta_vb", "sig2_inv_vb", "sig2_theta_vb",
                "sig2_zeta_vb", "tau_vb", "theta_vb", "cp_Y_X", "cp_X",
                "cp_X_Xbeta", "xi_inv_vb", "zeta_vb"}
    auc = hotspot_auc(res.theta_vb, p_act)
    finite = all(np.isfinite(np.asarray(v)).all() for v in fo.values())
    out["full_output"] = dict(seconds=time.perf_counter() - t0, keys=len(fo),
                              cp_X_shape=list(np.shape(fo["cp_X"])),
                              finite=bool(finite), hotspot_auc_theta=auc)
    if set(fo) != expected or np.shape(fo["cp_X"]) != (p, p) or not finite \
            or auc < 0.95 or not res.converged:
        raise AssertionError(f"a8_fit full_output: {sorted(fo)}, cp_X "
                             f"{np.shape(fo['cp_X'])}, finite={finite}, "
                             f"AUC {auc:.3f}")

    t0 = time.perf_counter()
    cal = at.permutation_null_calibration(y, x, p0=(5, 25), n_perms=4,
                                          seed=0, dtype=torch.float32,
                                          device=DEVICE)
    torch.cuda.synchronize()
    out["permutation"] = dict(seconds=time.perf_counter() - t0, n_perms=4,
                              threshold=cal["threshold"],
                              null_stats=cal["null_stats"].tolist())
    if not (0.0 < cal["threshold"] <= 1.0) or cal["null_stats"].shape != (4,):
        raise AssertionError(f"a8_fit permutation: {cal}")
    emit(out)
    return out


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
              if v.get("spill_stores") or v.get("spill_loads")}
    if spills:
        raise AssertionError(f"kernels spill registers: {spills}")

    max_abs, timing, launches = None, None, None
    mis_max_abs, mis_timing, mis_launches = None, None, {}
    if "kernel" in phases:
        max_abs, timing = phase_kernel()
    if "fit" in phases:
        launches = phase_fit()
    if "eqtl" in phases:
        phase_eqtl()
    if "dev_init" in phases:
        phase_dev_init()
    if "mis_kernel" in phases:
        mis_max_abs, mis_timing = phase_mis_kernel()
    if "missing_fit" in phases:
        mis_launches = phase_missing_fit()
    if "eqtl_missing" in phases:
        phase_eqtl_missing()
    if "block_fits" in phases:
        phase_block_fits()
    gs_max_abs, gs_timing, stag_max_abs, stag_timing = None, None, None, None
    route_launches = {}
    if "gs_kernel" in phases:
        gs_max_abs, gs_timing = phase_gs_kernel()
    if "stag_kernel" in phases:
        stag_max_abs, stag_timing = phase_stag_kernel()
    if "sweeps_fit" in phases:
        route_launches = phase_sweeps_fit()
    if "device_loop" in phases:
        phase_device_loop()
    route_profile_ = None
    if "eqtl_sweeps" in phases:
        route_profile_ = phase_eqtl_sweeps()
    if "scaling" in phases:
        phase_scaling()
    replica = {"b1": None, "b2": None}
    if "replica_kernel" in phases:
        replica, _ = phase_replica_kernel()
    if "a8_fit" in phases:
        phase_a8_fit()
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
            "impute_fit_launches": mis_launches.get("impute"),
            "replica_ms": replica["b1"]})
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
            "plan": mis_timing["plan"], "replica_ms": replica["b2"]})
    if gs_timing is not None:
        kernels.append({
            "name": "block_gs", "route": "cuda",
            "source": "atlasqtl_tpu_torch/csrc/sweep_inner_gs.cu",
            "replaces": "atlasqtl_tpu/ops/sweep_pallas.py:25",
            "launches": route_launches.get("pallas"),
            "max_abs_err": gs_max_abs,
            "shape": {k: gs_timing[k] for k in ("B", "q", "dtype", "c")},
            "ms": gs_timing["ms"], "device_ms": gs_timing["device_ms"],
            "plain_ms": gs_timing["plain_ms"],
            "bound_ms": gs_timing["bound_ms"],
            "bound_by": gs_timing["bound_by"], "library_ms": None,
            "pct_of_bound": gs_timing["pct_of_bound"],
            "ctas_per_sm": gs_timing["ctas_per_sm"],
            "tiles_instance_device_ms": gs_timing["tiles_device_ms"],
            "clocks": gs_timing["clocks"],
            "eqtl_route_products_ms_per_sweep": None if not route_profile_
            else {k: route_profile_[k] for k in ("r0_product_ms",
                                                  "advance_ms")}})
    if stag_timing is not None:
        kernels.append({
            "name": "sweep_staggered", "route": "cuda",
            "source": "atlasqtl_tpu_torch/csrc/sweep_staggered.cu",
            "replaces": "atlasqtl_tpu/ops/sweep_staggered.py:52",
            "launches": route_launches.get("stagger"),
            "max_abs_err": stag_max_abs,
            "shape": {k: stag_timing[k] for k in ("n", "p", "q", "block")},
            "mode": "converged, lite", "ms": stag_timing["ms"],
            "ms_2": stag_timing["ms_2"], "b1_ms": stag_timing["b1_ms"],
            "ratio_to_b1": stag_timing["ratio_to_b1"],
            "plain_ms": stag_timing["plain_ms"],
            "bound_ms": stag_timing["bound_ms"],
            "bound_by": stag_timing["bound_by"], "library_ms": None,
            "pct_of_bound": pct(stag_timing["bound_ms"], stag_timing["ms"]),
            "ctas_per_sm": stag_timing["ctas_per_sm"],
            "plan": stag_timing["plan"], "clocks": stag_timing["clocks"]})
    if kernels:
        emit({"kernels": kernels})
    print(f"chip_smoke: wall time {time.perf_counter() - t_start:.1f} s",
          flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
