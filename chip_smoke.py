#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (atlasqtl_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                 # all phases
    python3 chip_smoke.py kernel mis_kernel   # just these phases

Builds the CUDA sweep kernels from the sources in this checkout (one nvcc
per source, started together) and prints ptxas's registers and spills
(no kernel may spill), and the host preparation pass
(atlasqtl_tpu_torch/native/fastprep.cpp, g++), then:
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
          one host draw of the initial state, passed as list_init);
          prepare_data's host seconds on the NumPy and the native path,
          their outputs equal, and the path the fit took;
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
          Config(sweep_stagger=True) (B4 once per iteration, at q padded
          to 512, where the JAX package's fused tile is 512 and the flag
          selects B4), beside the default route (B1), all three on that
          padding; B4's fit reaches B1's
          converged state (iterations within 2%, lb_opt within 1e-5
          relative, PIPs within 1e-2); small fits on the card through each
          route, at block 128 and 256, agree with the CPU float64 fit, and
          float64 use_pallas fits on the card match it to 1e-6;
  device_loop  every route (B1, B2, impute, B3 f32 and f64, B4 at q
          padded to 512, block 256, model="global") at the sim_anneal
          shape, cut to 80 iterations (global: 24), under
          device_loop="off" and "on" (CUDA graphs): equal iterations, the
          ELBO histories within 1e-6, launches per iteration under both
          loops, graph replays, seconds, and 0 device-to-host copies per
          lite step (torch.profiler); B1's fit profiled under both loops;
  eqtl_sweeps  the eQTL problem built once (q padded to 10240, where
          sweep_stagger selects B4), then 10 iterations through B3
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
          timed;
  bf16_modes  the two bf16 modes: B1's tensor-core instance
          (Config.mxu_bf16) against its plain version at (120, 120, 200)
          (block 120, zero-padded to 128), (300, 2000, 500), (1000, 2048,
          10000) and block 256, c = 1 and 0.5, under the mean criterion
          (mean_held), both slice widths, its plan and SASS (bf16 HMMA,
          none in the float32 instances), timed with its phase clocks and
          CTA 0's pass cycles per 32 sample rows, its registers and
          spills; its lookahead variant
          (Config(mxu_bf16=True, sweep_lookahead=True); the overlapped
          kernel of whole blocks, the serial one in pieces) against its
          plain version at the same shapes and at LA_EDGES (two, three and
          five blocks, n % 32 != 0, ragged q, gam/mu emitted or not), two
          replicas in one launch bit for bit their single launches, timed
          beside the bf16 and float32 instances with its plan, its phase
          clocks and how much of its pass ran under the chain, with a
          sim_anneal fit beside the bf16 fit without it; registers and
          spills of every B1 instance;
          B2's pair_bf16 instance
          (Config.mis_pair_bf16) at the windows mis_sub = 16, 8, 4, 32,
          64 and 128 against its plain version at three MIS_SHAPES (the fit shape,
          the eQTL cut, the device-memory branch) at the kernel phases'
          tolerance and under the mean criterion, timed at each window in
          turns with the float32 instance, with its phase clocks and
          registers; each timed beside its float32 instance with its
          bound; sim_anneal fits in each mode, q padded to 512 (the flags
          reach their kernels at a multiple of 128)
          (complete and impute under mxu_bf16, exact under mis_pair_bf16,
          at mis_sub 16 and at 32, 64 and 128) on the graph loop beside
          the float32 fit from the same draw (AUC >= 0.95, PIPs within
          5e-2, the instance launched once per iteration); the eQTL cut
          (maxit 10, q padded to 10112) in both B1 instances from one
          device draw, ms per sweep and per iteration;
  mesh    the mesh (atlasqtl_tpu_torch.parallel) at world size 1 on NCCL:
          atlasqtl(mesh=...) at the sim_anneal shape (cut to 80
          iterations) on the 1-D mesh and
          the (1, 1) pipeline (2 q-tiles), complete (B1) and 15% exact
          missing (B2), each reaching the single-device fit from the same
          list_init (iterations, PIPs within 1e-4, AUC >= 0.95) with its
          launches per iteration (1; 2); a graph-loop fit under the mesh
          (its all-reduces captured); the eQTL cut under the 1-D mesh
          beside one device, ms per iteration and launches;
  mcmc    the cross-check samplers (atlasqtl_tpu_torch.mcmc): at the test
          shape (60, 30, 12) in float64, three Gibbs sweeps, one NUTS
          iteration and one batched SMC mutation on the card equal the
          same calls on the CPU from the same draws; at the fit shape in
          float32 on the card's own generator run_gibbs (ms and CUDA
          launches per sweep, the device's busy share), run_nuts (ms and
          leapfrogs per iteration), run_smc (8 particles, ms per batched
          mutation) and run_gibbs_sharded on a world-size-1 NCCL mesh equal
          to run_gibbs from the same seed; each sampler's theta-mean
          hotspot AUC (Gibbs >= 0.95) and mean |PIP - CAVI gam| against
          the fit phase's fit;
  probes  the perf probes of B1 (Config.sweep_probe, its eleven values)
          and B2 (probe=, four), each kernel's probe instance against its
          plain version (B1 at blocks 128 and 256, c = 1 and 0.5, under
          mxu_bf16, windows 1 to 32, off the 8-row grid (3, 6, 12 at block
          48, 5 at 40, 12 at 192, 25 at 200), two replicas in one launch;
          B2 at mis_sub 1 to 128, f32 and pair_bf16, Fm on chip and in
          device memory, and f32 at windows 3 to 200 that are not powers
          of two); at the eQTL
          cut (1000, 2048, 10000) each probe's ms beside the exact sweep in
          rounds of turns and the phase costs they imply, each with its
          range over the rounds (projection, advance, the
          chain's order, sigmoid, pushes, corrections, Z Mills, the x/cp
          stream, tiles), and in one round of turns B1's noseq and norank
          at block 48 window 6 and block 96 window 12 (p = 2016), B2's
          four at mis_sub 32, 64 and 128; a cavi_iteration under a probe
          launches the probe instance once (with sweep_stagger too: B1,
          not B4).
Each phase prints one JSON line; then each phase's seconds, a `kernels`
line, and last the contract line {"ok": true, "device": {...}}.  Any failure exits non-zero
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
          "replica_kernel", "a8_fit", "bf16_modes", "mesh", "mcmc", "probes")
# the mcmc phase: the test shape of tests/test_torch_mcmc.py (n, p, q,
# active SNPs, hit traits; block 16), run in float64 on the CPU and on the
# card from the same draws, then the samplers' runs at FIT_SHAPE (float32,
# block 128) on the card.  The chain starts with the horseshoe scales
# shrunk (sig02_inv = q, as the JAX package's init_state) and an active
# SNP whose local scale collapsed leaves the funnel slowly: 20 burn-in
# sweeps left the theta-mean AUC at 0.957 on the card (PERF.md), hence 100
MCMC_TEST_SHAPE = (60, 30, 12, 5, 12)
MCMC_GIBBS = dict(n_burnin=60, n_samples=30, seed=1)
MCMC_NUTS = dict(n_burnin=4, n_samples=4, seed=1)
MCMC_SMC = dict(n_particles=8, anneal=(1, 2, 5), n_mutations=1, n_final=5,
                seed=1)
MCMC_MESH = dict(n_burnin=2, n_samples=3, seed=7)
MCMC_AUC = 0.95       # PERF.md section 2's gate, on Gibbs's theta mean
MCMC_PARTICLES = 8
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
DL_MAXIT = 80        # the device_loop phase's fits but global's, cut in depth
EQTL_SHAPE = (1000, 50000, 10000, 500, 2000)


def emit(obj):
    print(json.dumps(obj), flush=True)


KERNEL_NAMES = ("sweep_fused_kernel", "sweep_lookahead_kernel",
                "sweep_missing_kernel", "inner_gs_kernel",
                "sweep_staggered_kernel", "bf16_pass")


def ptxas_summary(report):
    """{kernel: {registers, spill_stores, spill_loads}} from nvcc's
    `-Xptxas -v` report; a template instance is named with its mangled
    arguments (e.g. sweep_missing_kernel<true> as
    sweep_missing_kernelILb1E); a device function that is not inlined
    (B1's bf16_pass<QS>) has its spills, its registers counting in its
    callers'."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'|"
                      r"Function properties for (\S+)", line)
        if m:
            fn, name = m.group(1) or m.group(2), None
            for k in KERNEL_NAMES:
                if k in fn:
                    tail = fn.split(k, 1)[1]
                    name = k + (re.split(r"EE[vj]", tail, 1)[0] + "E"
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


def held(label, got, ref, names, tol=1e-4, scales=None):
    """Max abs error of each output of `got` against `ref` by name; raises
    past the tolerance: gam `tol`, the others tol * max |ref| (also on
    NaN), or tol * the larger of that and scales[name] where given.  The
    phases hold float32 kernels at 1e-4, float64 at 1e-10."""
    errs = {}
    for name, a, r in zip(names, got, ref):
        if r is None:
            continue
        errs[name] = float((a - r).abs().max())
        scale = max(float(r.abs().max()), (scales or {}).get(name, 0.0))
        limit = tol if name == "gam" else tol * scale
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


_FIT = {}   # the fit phase's atlasqtl() result, for the mcmc phase


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
    _FIT["res"] = res
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
    that fit it: (x, y, init, host seconds of the init).  The host draw
    takes ~30 s at this shape and is made once: the problems share x and
    the draws, and auto_set_init reads Y only for tau's point value (1 /
    the median column variance), on which sig2_beta's draw depends only as
    a scale, 1 / Gamma(2, scale=sig2_inv tau); so a second problem's init
    is the first one's with its own tau and sig2_beta rescaled, the state
    auto_set_init draws for it, to rounding."""
    if missing_frac not in _EQTL:
        from atlasqtl_tpu_torch.io.prepare import prepare_data
        from atlasqtl_tpu_torch.inference import elicitation as elic
        n, p, q, p_act, q_hit = EQTL_SHAPE
        x, y = simulate(n, p, q, 1, p_act, q_hit, missing_frac=missing_frac)
        if _EQTL:
            init, init_s = next(iter(_EQTL.values()))[2:]
            tau = 1.0 / np.nanmedian(np.nanvar(y, axis=0, ddof=1))
            init = dataclasses.replace(
                init, tau_vb=np.full(q, tau),
                sig2_beta_vb=init.sig2_beta_vb * (init.tau_vb / tau))
        else:
            dat = prepare_data(y, x, 0.1, 10, 1, 0)
            t0 = time.perf_counter()
            init = elic.auto_set_init(dat.y, dat.x.shape[1], (5, 25),
                                      float(q), 1)
            init_s = time.perf_counter() - t0
        _EQTL[missing_frac] = (x, y, init, init_s)
    return _EQTL[missing_frac]


def prepare_paths(y, x):
    """prepare_data at (y, x) on the NumPy path and on the native C++ path
    (atlasqtl_tpu_torch/native), host seconds of each, their outputs equal
    (X to 1e-12 relative, flags exactly); raises if the native library is
    not there."""
    from atlasqtl_tpu_torch import native
    from atlasqtl_tpu_torch.io import prepare as prep

    if native.get_lib() is None:
        raise AssertionError(f"native library: {native.get_lib.error}")
    orig, out, dats = prep.standardize_and_flag, {}, {}
    try:
        for path, flag in (("numpy", False), ("native", True)):
            prep.standardize_and_flag = (
                lambda xx, use_native=None, f=flag: orig(xx, use_native=f))
            t0 = time.perf_counter()
            dats[path] = prep.prepare_data(y, x, 0.1, 10, 1, 0)
            out[f"prepare_{path}_s"] = time.perf_counter() - t0
    finally:
        prep.standardize_and_flag = orig
    a, b = dats["numpy"], dats["native"]
    if not (np.allclose(a.x, b.x, rtol=1e-12, atol=0)
            and np.array_equal(a.bool_rmvd_x, b.bool_rmvd_x)
            and a.rmvd_coll_x == b.rmvd_coll_x):
        raise AssertionError("prepare_data: the native and NumPy paths "
                             "differ at the eQTL shape")
    return out


def eqtl_run(phase, missing_frac, launch_mod, launch_fn, counter, bound,
             prepare=False, **fit_kw):
    """One atlasqtl() at the eQTL shape under `timed_run`'s timers, from
    eqtl_problem's shared initial state (list_init); prepare: also
    prepare_data's host seconds on both paths (`prepare_paths`) and the
    path the fit's prepare_data took."""
    import torch
    import atlasqtl_tpu_torch as at
    from atlasqtl_tpu_torch import native

    x, y, init, init_s = eqtl_problem(missing_frac)
    n, p = x.shape
    q = y.shape[1]
    paths = prepare_paths(y, x) if prepare else {}
    native_calls = []
    orig = native.standardize_and_hash
    native.standardize_and_hash = lambda xx: (native_calls.append(1)
                                              or orig(xx))
    try:
        res, stats = timed_run(
            lambda: at.atlasqtl(y, x, p0=(5, 25), anneal=(1, 2, 5),
                                maxit=10, dtype=torch.float32, verbose=0,
                                user_seed=1, device=DEVICE, list_init=init,
                                **fit_kw),
            (launch_mod, launch_fn), counter, bound)
    finally:
        native.standardize_and_hash = orig
    stats.update(paths, fit_prepare_path="native" if native_calls
                 else "numpy")
    stats["host_init_s"] = init_s  # drawn once, by eqtl_problem
    # the host path from prepare_data to the first iteration: the draw
    # (eqtl_problem's) and then build_data/build_state
    stats["host_path_prepare_to_first_iteration_s"] = \
        stats["prepare_to_first_iteration_s"] + init_s
    _EQTL_STATS[(phase, fit_kw.get("missing"))] = stats
    shown = {k: (dict(v.shape) if k == "mesh" else v)
             for k, v in fit_kw.items()}
    out = dict(phase=phase, **shown, n=n, p=p, q=q, anneal=[1, 2, 5],
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
             b1_launch_bound, prepare=True)


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


def prepared_fit(y, x, cfg, device, anneal=(1, 2, 10), seed=123,
                 q_pad_to=8):
    """fit_global_local through the library's lower-level entry, as
    atlasqtl() prepares it (prepare_data, elicitation with p0 = (5, 25), the
    model's builders, q padded to a multiple of q_pad_to); the caller's
    Config picks the route.  Returns the FitResult and the unpadded (theta,
    gam) on the host."""
    from atlasqtl_tpu_torch.io.prepare import prepare_data
    from atlasqtl_tpu_torch.inference import elicitation as elic
    from atlasqtl_tpu_torch.inference.driver import fit_global_local
    from atlasqtl_tpu_torch.models import global_local as gl

    dat = prepare_data(y, x, 0.1, cfg.maxit, seed, 0)
    p, q = dat.x.shape[1], dat.y.shape[1]
    cfg = dataclasses.replace(cfg, shr_fac_inv=float(q))
    data = gl.build_data(dat.x, dat.y, cfg, device, q_pad_to=q_pad_to)
    hyper = gl.build_hyper(elic.auto_set_hyper(dat.y, p, (5, 25)),
                           data.y.shape[1], cfg, device)
    state = gl.build_state(elic.auto_set_init(dat.y, p, (5, 25), float(q),
                                              seed), data, cfg)
    res = fit_global_local(data, hyper, state, cfg, anneal=anneal, verbose=0)
    host = lambda t: t.double().cpu().numpy()
    return res, host(res.state.theta[:p]), host(res.state.gam[:p, :q])


def phase_sweeps_fit():
    """The B3 and B4 routes through fit_global_local, each driven with every
    sweep kernel's count set to 0 just before it and read just after; B4's
    fits with q padded to 256, where sweep_stagger selects it (C10)."""
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
    qpad = {"stagger": 256}
    for route, cfg in routes[1:3]:
        res, _, gam = prepared_fit(ys, xs, cfg, DEVICE,
                                   q_pad_to=qpad.get(route, 8))
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
        res, _, gam = prepared_fit(ys, xs, cfg, DEVICE,
                                   q_pad_to=qpad.get(route, 8))
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
        # every route on the problem B4 takes: q = 500 padded to 512
        res, theta, gam = prepared_fit(y, x, cfg, DEVICE, seed=0,
                                       q_pad_to=256)
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
    prepare_data, host init, build_state, q padded to 256 (10240
    columns), where sweep_stagger selects B4 (C10) -- then 10 iterations
    through B3 and through B4, each from a clone of the built state."""
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
    data = gl.build_data(dat.x, dat.y, cfg, DEVICE, q_pad_to=256)
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
    model="global" (the plain engines, ~50k launches per iteration, float64);
    every fit cut to DL_MAXIT iterations (global's to 24), past the
    annealing ladder into the converged phase's lite and full steps.  Each
    fit is driven with every kernel's count
    set to 0 just before it and read just after; the "on" fit runs again
    under torch.profiler, recording steps 16-25 (global: 16-19), where
    every kind of step is a graph replay, for its device-to-host copies per
    lite step, which must be 0 (that fit cut to 30 iterations, global's to
    24); B1's fit cut to 15 iterations is profiled whole under both loops
    for PERF.md's breakdown.  Fails unless both loops take the same
    iterations (both to convergence, or both to the cut), evaluate the
    ELBO at the same ones and agree on it to 1e-6 relative; prints seconds
    per fit, CUDA-graph replays and launches."""
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

    def route_fit(cfg, q_pad_to=8):
        def run(loop, **cut):
            return prepared_fit(y, x, dataclasses.replace(
                cfg, device_loop=loop, **cut), DEVICE, seed=0,
                q_pad_to=q_pad_to)[0]
        return run

    routes = (
        ("b1", api_fit(y, x), "sweep_fused", 1),
        ("b2", api_fit(ym, xm, missing="exact"), "sweep_missing_fused", 1),
        ("impute", api_fit(ym, xm, missing="impute"), "sweep_fused", 1),
        ("b3_f32", route_fit(Config(sweep="pallas")), "block_gs", 16),
        ("b3_f64", route_fit(Config(dtype=torch.float64, use_pallas=True)),
         "block_gs", 16),
        # B4 where sweep_stagger selects it: q padded to 256 (C10)
        ("b4", route_fit(Config(sweep_stagger=True), q_pad_to=256),
         "sweep_fused_staggered", 1),
        ("block256", api_fit(y, x, block_size=256), "sweep_fused", 1),
        # the plain engines: ~50k launches per iteration, so cut to 24
        # iterations (the profiled fit's); float64, as the reference's own
        # tests fit this model
        ("global", api_fit(y, x, model="global", dtype=torch.float64),
         None, 0),
    )
    profiles = {}
    for route, run, own, per_it in routes:
        t_route = time.perf_counter()
        maxit = 24 if route == "global" else DL_MAXIT
        fits = {}
        for loop in ("off", "on"):
            torch.cuda.synchronize()
            for fn in counters.values():
                fn.launches = 0
            dl.replays = 0
            t0 = time.perf_counter()
            res = run(loop, maxit=maxit)
            torch.cuda.synchronize()
            fits[loop] = dict(res=res, seconds=time.perf_counter() - t0,
                              launches={k: fn.launches
                                        for k, fn in counters.items()},
                              replays=dl.replays)
        if route == "b1":  # PERF.md's breakdown: 15 iterations, both loops
            profiles = {loop: fit_profile(
                lambda lp: run(lp, maxit=15), loop)[1]
                for loop in ("off", "on")}
        # the copies per lite step, over steps 16-25 (global: 16-19), every
        # kind of step a graph replay by then, in a fit cut to 30
        # iterations (global: 24)
        _, prof = fit_profile(
            lambda lp: run(lp, maxit=24 if route == "global" else 30), "on",
            window=(14, 4 if route == "global" else 10))
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
        if not ((off.converged and on.converged or off.it == maxit)
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

BF16_PEAK = 989e12    # H100 SXM bf16 dense on the tensor cores, FLOP/s
# B1's bf16 instance: a block not a multiple of 16 (120, zero-padded
# columns), the fit shape (32-column slices) and the eQTL cut (40)
BF16_SHAPES = ((120, 120, 200), (300, 2000, 500), (1000, 2048, 10000))
# the lookahead variant's overlapped schedule at its pipeline's edges (n, p,
# q, c, gam/mu emitted): two blocks, the second projected beside the first
# chain with no advance; five blocks with n not a multiple of 32 and q (77,
# padded to 80) not a multiple of the slice width, lite; three blocks
LA_EDGES = ((120, 256, 200, 0.5, True), (333, 640, 77, 1.0, False),
            (300, 384, 104, 0.5, False))
BF16_FIT_QPAD = 128   # the bf16 flags reach their kernels at q % 128 == 0
# B2's pair_bf16 instance: the fit shape, the eQTL cut, the device-memory
# branch; at the windows Config.mis_sub = 16 (the default), 8, 4 and the
# windows over 16 (32, 64, 128: Fm held at the window's start)
BF16_MIS_SHAPES = (MIS_SHAPES[2], MIS_SHAPES[3], MIS_SHAPES[9])
BF16_MIS_SUBS = (16, 8, 4, 32, 64, 128)
BF16_DEEP_SUBS = (32, 64, 128)
MESH_PIP = 1e-4      # a mesh fit's PIPs against the single-device fit's
MESH_MAXIT = 80      # the mesh phase's sim_anneal fits, cut in depth
BF16_RATIO = 20       # kernel's mean error <= the mode's mean distance / 20
BF16_FIT_PIP = 5e-2   # a bf16 fit's PIPs against the float32 fit's


def bf16_bound_ms(n, p, q, block, r_aug, emit_gam_mu, lookahead=False):
    """Least time of one sweep of B1's bf16 instance on an H100: the
    largest of its tensor-core operations (the two n-products, 4 n p q, at
    the bf16 dense tensor rate), its other operations (sweep_bound_ms's
    FP32 work at the FP32 rate: a separate pipe, which may run at the same
    time) and its bytes (sweep_bound_ms's, with x at 2 bytes) over the HBM
    rate.  lookahead (its lookahead variant): the FP32 work adds the goff
    product, 2 p q B, and the bytes the (p, B) goff blocks."""
    t_ops = max(4 * n * p * q / BF16_PEAK,
                p * q * (block + 6 * r_aug + 2 * block * lookahead)
                / FP32_PEAK)
    nbytes = 2 * n * p + 4 * (p * q * (3 + 2 * emit_gam_mu) + 2 * n * q
                              + p * block * (1 + lookahead) + p * r_aug
                              + 3 * r_aug * q)
    t_bytes = nbytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), \
        ("operations" if t_ops >= t_bytes else "bytes")


def mis_bf16_bound_ms(n, p, q, r_aug, sub):
    """Least time of one sweep of B2's pair_bf16 instance at window sub on
    an H100: the largest of its rounded pair Grams, (sub - 1) n p q
    operations (sub (sub - 1) / 2 pairs per window of sub, n q multiply-
    adds each), at the bf16 dense tensor rate; mis_bound_ms's FP32
    operations at the FP32 rate (a separate pipe, which may run at the
    same time); and mis_bound_ms's bytes over the HBM rate.  In float32
    the pair Grams are the kernel's design, not the function; under the
    mode they are the function (the JAX kernel's _pair_dot)."""
    t_pairs = (sub - 1) * n * p * q / BF16_PEAK
    t_fp32 = p * q * (5 * n + 6 * r_aug) / FP32_PEAK
    t_bytes = 4 * (n * p + 7 * p * q + 3 * n * q + p * r_aug
                   + 3 * r_aug * q) / HBM_RATE
    t = max(t_pairs, t_fp32, t_bytes)
    return 1e3 * t, "bytes" if t == t_bytes else "operations"


def b2_instances(by_name, probe=False):
    """{(fm_on_chip, sub): value} of B2's instances
    sweep_missing_kernel<FM_ON_CHIP, SUB> (probe: its probe instances
    <FM_ON_CHIP, SUB, true>) from a dict keyed by their mangled names
    (sass_hmma's counts, ptxas_summary's reports)."""
    out = {}
    for name, v in by_name.items():
        m = re.search(r"sweep_missing_kernelILb([01])ELi(\d+)ELb"
                      + ("1" if probe else "0") + "E", name)
        if m:
            out[(m.group(1) == "1", int(m.group(2)))] = v
    return out


def b1_any_launch_bound(a, k):
    """bound_ms of one B1 launch, any instance, from its operands."""
    dims = (a[0].shape[0], a[0].shape[1], a[5].shape[1], k["block_size"],
            a[3].shape[1], k["emit_gam_mu"])
    if k.get("bf16"):
        return bf16_bound_ms(*dims, bool(k.get("lookahead")))[0]
    return sweep_bound_ms(*dims)[0]


def mean_held(label, got, ref, f32, f32_kernel, names, ratio=BF16_RATIO):
    """The bf16 criterion, per output: mean |got - ref| <= mean |f32 - ref|
    / ratio (the mode's own distance from float32) + 2 mean |f32_kernel -
    f32| (the float32 instance's own distance from its plain version: the
    sums of z_row and the column statistics run in another order, as in
    float32).  B1: a bf16 operand may move 2^-8 relative where a float32
    sum order differs by 1 ulp, so the max is not at float32 grade while
    the mean is.  B2: the mode moves its outputs far less than B2's max
    tolerance, so only this criterion fails an instance that rounds no
    pair product, or others than the mode's.  Returns the mean and max
    errors, the mode's mean distance and that floor per output; raises
    past it."""
    errs = {}
    for name, a, r, f, k in zip(names, got, ref, f32, f32_kernel):
        if r is None:
            continue
        d = (a - r).abs().double()
        err, mode = float(d.mean()), float((f - r).abs().double().mean())
        floor = float((k - f).abs().double().mean())
        errs[name] = dict(mean=err, max=float(d.max()), mode_mean=mode,
                          f32_floor=floor)
        if not (err <= mode / ratio + 2 * floor):
            raise AssertionError(f"{label}: {name} mean abs err {err:.3g} > "
                                 f"1/{ratio} of the mode's {mode:.3g} + 2 x "
                                 f"the float32 floor {floor:.3g}")
    return errs


def sass_hmma(lib):
    """{kernel function: [HMMA instructions, those not bf16]} from
    cuobjdump's SASS of the built library, which links every kernel's
    source: B1's instances and B2's (`b2_instances`) alike."""
    import os
    from atlasqtl_tpu_torch.ops import sweep_fused as sf
    exe = os.path.join(os.path.dirname(sf._nvcc()), "cuobjdump")
    out = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = [0, 0]
        elif name and re.search(r"\bHMMA\b", line):
            counts[name][0] += 1
            counts[name][1] += ".BF16" not in line
    return counts


def device_fit(y, x, cfg, seed, anneal, q_pad_to=8):
    """fit_global_local as prepared_fit runs it, from the initial state
    drawn on the card (auto_init_device, as atlasqtl() draws it there with
    user_seed=seed)."""
    from atlasqtl_tpu_torch.io.prepare import prepare_data
    from atlasqtl_tpu_torch.inference import elicitation as elic
    from atlasqtl_tpu_torch.inference.driver import fit_global_local
    from atlasqtl_tpu_torch.models import global_local as gl

    dat = prepare_data(y, x, 0.1, cfg.maxit, seed, 0)
    p, q = dat.x.shape[1], dat.y.shape[1]
    cfg = dataclasses.replace(cfg, shr_fac_inv=float(q))
    data = gl.build_data(dat.x, dat.y, cfg, DEVICE, q_pad_to=q_pad_to)
    hyper = gl.build_hyper(elic.auto_set_hyper(dat.y, p, (5, 25)),
                           data.y.shape[1], cfg, DEVICE)
    state = gl.auto_init_device(seed, data, (5.0, 25.0), float(q), cfg)
    return fit_global_local(data, hyper, state, cfg, anneal=anneal,
                            verbose=0)


def phase_bf16_modes():
    """The two bf16 modes (Config.mxu_bf16 on B1's tensor-core instance,
    with its lookahead variant under Config.sweep_lookahead;
    Config.mis_pair_bf16 on B2's): each instance against its plain
    version (B1 and its lookahead variant under the mean criterion, B2 at
    the kernel phases' tolerance and under the mean criterion at each
    window of BF16_MIS_SUBS), repeatable bit for bit, timed beside its
    float32 instance in the same call (CUDA events, median of 9; the
    lookahead variant beside the bf16 and float32 instances, B2's windows
    in turns, `b2_turns`) with its bound; B1's SASS holds bf16 HMMA and its float32
    instances none; sim_anneal fits in each mode (complete, lookahead and
    impute under mxu_bf16, exact under mis_pair_bf16) on the graph loop,
    each beside the float32 fit from the same draw (the lookahead fit also
    beside the bf16 fit without it), the instance's launches counted; the
    eQTL cut in both B1 instances from one device draw."""
    import torch
    from atlasqtl_tpu_torch.types import Config
    from atlasqtl_tpu_torch.inference import device_loop as dl
    from atlasqtl_tpu_torch.ops import sweep_fused as sf
    from atlasqtl_tpu_torch.ops import sweep_missing_fused as sm

    out = {"phase": "bf16_modes"}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sass = sass_hmma(sf.build())
    b1_sass = {k: v for k, v in sass.items()
               if "sweep_fused_kernel" in k or "sweep_lookahead_kernel" in k}
    out["b1_sass_hmma"] = b1_sass
    # the bf16 instances, their lookahead variants in pieces <QS, true, LA>
    # (each with its copy of bf16_pass<QS>, which ptxas keeps out of line)
    # and the overlapped lookahead kernel <QS>
    bf_inst = {k: v for k, v in b1_sass.items()
               if re.search(r"sweep_fused_kernelILi\d+ELb1E", k)
               or "sweep_lookahead_kernel" in k}
    if (len(bf_inst) != 6 or any(v[0] == 0 or v[1] for v in bf_inst.values())
            or any(v[0] for k, v in b1_sass.items() if k not in bf_inst)):
        raise AssertionError(f"B1's SASS: HMMA (all, not bf16) per instance "
                             f"{b1_sass}: the bf16 instances need bf16 HMMA, "
                             f"the float32 instances none")
    # registers and spills of every B1 instance (float32 and bf16)
    out["registers"] = {k: v for k, v in
                        ptxas_summary(sf.build.ptxas_report).items()
                        if k.startswith(("sweep_fused_kernel",
                                         "sweep_lookahead_kernel",
                                         "bf16_pass"))}
    emit({"phase": "bf16_modes", "b1_registers": out["registers"]})
    # B2's pair_bf16 instances from mis_sub 8 on take the pair Grams on the
    # tensor cores, the float32 instance (SUB = 0) never
    b2s = b2_instances(sass)
    out["b2_sass_hmma"] = {f"{'chip' if oc else 'device'}_{sub}": v
                           for (oc, sub), v in sorted(b2s.items())}
    if (len(b2s) != 2 * len(sm.PAIR_WINDOWS)
            or any(v[0] == 0 or v[1] for (_, sub), v in b2s.items()
                   if sub >= 8)
            or any(v[0] for (_, sub), v in b2s.items() if sub == 0)):
        raise AssertionError(f"B2's SASS: HMMA (all, not bf16) per instance "
                             f"{out['b2_sass_hmma']}: the pair_bf16 "
                             f"instances from mis_sub 8 on need bf16 HMMA, "
                             f"the float32 instance none")
    flat = lambda o: list(o[:6]) + list(o[6])

    # ---- B1's bf16 instance (and its lookahead variant) against its
    # plain version ----
    def lookahead_held(label, ops16, goff, kw, f32, f32_kernel):
        """The lookahead variant against its plain version (mean
        criterion) and itself (two launches bit for bit)."""
        kwl = dict(kw, bf16=True, lookahead=True)
        got = flat(sf.sweep_fused(*ops16, goff, **kwl))
        again = flat(sf.sweep_fused(*ops16, goff, **kwl))
        ref = flat(sf.sweep_fused_plain(*ops16, goff, **kwl))
        torch.cuda.synchronize()
        if not all(a is None and b is None or torch.equal(a, b)
                   for a, b in zip(got, again)):
            raise AssertionError(f"{label}: two launches differ")
        return mean_held(label, got, ref, f32, f32_kernel, B1_NAMES)

    b1_cases, b1_timing, la_cases, la_timing = [], None, [], None
    for n, p, q in BF16_SHAPES:
        for c in (1.0, 0.5):
            ops, block = kernel_inputs(n, p, q, c)
            ops16 = [sf.bf16_operand(ops[0])] + list(ops[1:])
            goff = sf.lookahead_gram(ops[0], block)
            kw = dict(block_size=block, emit_gam_mu=True, c_one=c == 1.0)
            got = flat(sf.sweep_fused(*ops16, **kw, bf16=True))
            again = flat(sf.sweep_fused(*ops16, **kw, bf16=True))
            ref = flat(sf.sweep_fused_plain(*ops16, **kw, bf16=True))
            f32 = flat(sf.sweep_fused_plain(*ops, **kw))
            f32_kernel = flat(sf.sweep_fused(*ops, **kw))
            torch.cuda.synchronize()
            label = f"B1 bf16 vs plain at n={n} p={p} q={q} c={c}"
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{label}: two launches differ")
            case = dict(n=n, p=p, q=q, block=block, c=c,
                        err=mean_held(label, got, ref, f32, f32_kernel,
                                      B1_NAMES))
            la_case = dict(n=n, p=p, q=q, block=block, c=c,
                           err=lookahead_held(
                               f"B1 bf16 lookahead vs plain at n={n} p={p} "
                               f"q={q} c={c}", ops16, goff, kw, f32,
                               f32_kernel))
            dims = (ops[0].shape[0], ops[0].shape[1], ops[5].shape[1],
                    block, ops[3].shape[1])
            if p >= 2000 and c == 1.0:  # converged, lite; both widths
                kwl = dict(kw, emit_gam_mu=False)
                plan = sf.fused_launch_plan(dims[0], dims[2], block, dims[4],
                                            sms, bf16=True)
                w = plan["slice_width"]
                smem = sf.kernel_smem_bytes(w, block, dims[4], True)
                ctas = sf.occupancy(w, block, dims[4], True)
                if smem != plan["smem_bytes"] or ctas != plan["ctas_per_sm"]:
                    raise AssertionError(f"B1 bf16 plan {plan} vs the kernel:"
                                         f" {smem} bytes, {ctas} CTAs per SM")
                by_width = {}
                for width in sf.FUSED_WIDTHS:
                    fw = lambda: sf.fused_launch(
                        "atlasqtl_sweep_fused", *ops16, **kw, bf16=True,
                        slice_width=width)
                    gw = flat(fw())
                    by_width[width] = dict(
                        err=mean_held(f"{label} in {width}-column slices",
                                      gw, ref, f32, f32_kernel, B1_NAMES),
                        ms=cuda_ms(lambda: sf.fused_launch(
                            "atlasqtl_sweep_fused", *ops16, **kwl, bf16=True,
                            slice_width=width), 9))
                lite = lambda: sf.sweep_fused(*ops16, **kwl, bf16=True)
                lite()
                torch.cuda.synchronize()
                clocks = sf.phase_clocks()
                case.update(
                    plan=plan, smem_bytes=smem, ctas_per_sm=ctas,
                    by_width=by_width, clocks=clocks,
                    # CTA 0's pass cycles per 32 sample rows, over the
                    # passes (one per block and a last)
                    pass_cycles_per_32_rows=clocks["pass"] / (
                        (dims[1] // block + 1) * dims[0] / 32),
                    registers={k: v for k, v in out["registers"].items()
                               if k.endswith("Lb1ELb0ELb0EE")
                               or k.startswith("bf16_pass")},
                    ms=cuda_ms(lite, 9),
                    f32_ms=cuda_ms(lambda: sf.sweep_fused(*ops, **kwl), 9),
                    ms_2=cuda_ms(lite, 9),
                    plain_ms=cuda_ms(lambda: sf.sweep_fused_plain(
                        *ops16, **kwl, bf16=True), 3))
                case["bound_ms"], case["bound_by"] = bf16_bound_ms(
                    *dims, False)
                case["f32_bound_ms"] = sweep_bound_ms(*dims, False)[0]
                case["pct_of_bound"] = pct(case["bound_ms"], case["ms"])
                case["f32_pct_of_bound"] = pct(case["f32_bound_ms"],
                                               case["f32_ms"])
                b1_timing = case
                # the lookahead variant beside the bf16 and float32
                # instances, in turns, in this call
                kwla = dict(kwl, bf16=True, lookahead=True)
                la_plan = sf.fused_launch_plan(dims[0], dims[2], block,
                                               dims[4], sms, bf16=True,
                                               lookahead=True)
                la_smem = sf.kernel_smem_bytes(la_plan["slice_width"], block,
                                               dims[4], True, True)
                if la_smem != la_plan["smem_bytes"]:
                    raise AssertionError(f"B1 lookahead plan {la_plan} vs "
                                         f"the kernel: {la_smem} bytes")
                la = lambda: sf.sweep_fused(*ops16, goff, **kwla)
                la()
                torch.cuda.synchronize()
                clocks = sf.phase_clocks(lookahead=True)
                la_case.update(
                    plan=la_plan, clocks=clocks,
                    # how much of the pass ran under the chain: of the pass
                    # thread's busy cycles beside a chain, and of the chain
                    pass_under_chain=clocks["pass_in_chain"]
                    / max(1, clocks["pass_busy"]),
                    chain_under_pass=clocks["pass_in_chain"]
                    / max(1, clocks["chain"]),
                    ms=cuda_ms(la, 9),
                    bf16_ms=cuda_ms(lite, 9),
                    f32_ms=cuda_ms(lambda: sf.sweep_fused(*ops, **kwl), 9),
                    ms_2=cuda_ms(la, 9),
                    plain_ms=cuda_ms(lambda: sf.sweep_fused_plain(
                        *ops16, goff, **kwla), 3))
                la_case["bound_ms"], la_case["bound_by"] = bf16_bound_ms(
                    *dims, False, True)
                la_case["pct_of_bound"] = pct(la_case["bound_ms"],
                                              la_case["ms"])
                la_timing = la_case
            b1_cases.append(case)
            la_cases.append(la_case)
            emit({"phase": "bf16_modes", "b1_case": case,
                  "lookahead_case": la_case})
            del ops, ops16, goff, got, again, ref, f32, f32_kernel
            torch.cuda.empty_cache()
    # block 256: two pieces of 128, the second projected against the
    # block-start F and corrected through the Gram (the whole-block sweep)
    n, p, q = BLOCK256_SHAPE
    ops, block = kernel_inputs(n, p, q, 0.5, block=256)
    ops16 = [sf.bf16_operand(ops[0])] + list(ops[1:])
    kw = dict(block_size=block, emit_gam_mu=True, c_one=False)
    # the lookahead variant: every piece projects the previous block's
    # start F and takes all of its deltas through goff
    goff = sf.lookahead_gram(ops[0], block)
    f32, f32_kernel = (flat(sf.sweep_fused_plain(*ops, **kw)),
                       flat(sf.sweep_fused(*ops, **kw)))
    la_cases.append(dict(
        n=n, p=p, q=q, block=block, c=0.5, err=lookahead_held(
            f"B1 bf16 lookahead vs plain at block {block}", ops16, goff, kw,
            f32, f32_kernel),
        ms=cuda_ms(lambda: sf.sweep_fused(*ops16, goff, **kw, bf16=True,
                                          lookahead=True), 9),
        bf16_ms=cuda_ms(lambda: sf.sweep_fused(*ops16, **kw, bf16=True), 9)))
    emit({"phase": "bf16_modes", "lookahead_case": la_cases[-1]})
    del goff, f32, f32_kernel
    b1_cases.append(dict(
        n=n, p=p, q=q, block=block, c=0.5, err=mean_held(
            f"B1 bf16 vs plain at block {block}",
            flat(sf.sweep_fused(*ops16, **kw, bf16=True)),
            flat(sf.sweep_fused_plain(*ops16, **kw, bf16=True)),
            flat(sf.sweep_fused_plain(*ops, **kw)),
            flat(sf.sweep_fused(*ops, **kw)), B1_NAMES),
        ms=cuda_ms(lambda: sf.sweep_fused(*ops16, **kw, bf16=True), 9),
        f32_ms=cuda_ms(lambda: sf.sweep_fused(*ops, **kw), 9)))
    # the same sweep at block 128: what the pieces' workspaces and cross-
    # Gram cost the bf16 instance
    ops, _ = kernel_inputs(n, p, q, 0.5, block=128)
    ops16 = [sf.bf16_operand(ops[0])] + list(ops[1:])
    kw = dict(kw, block_size=128)
    b1_cases[-1].update(
        block128_ms=cuda_ms(lambda: sf.sweep_fused(*ops16, **kw, bf16=True),
                            9),
        block128_f32_ms=cuda_ms(lambda: sf.sweep_fused(*ops, **kw), 9))
    emit({"phase": "bf16_modes", "b1_case": b1_cases[-1]})
    del ops, ops16
    # the overlapped lookahead schedule at its edges, then two replicas in
    # one launch against their single launches, bit for bit
    for n, p, q, c, emit_gm in LA_EDGES:
        ops, block = kernel_inputs(n, p, q, c)
        ops16 = [sf.bf16_operand(ops[0])] + list(ops[1:])
        kw = dict(block_size=block, emit_gam_mu=emit_gm, c_one=c == 1.0)
        la_cases.append(dict(
            n=n, p=p, q=q, block=block, c=c, emit_gam_mu=emit_gm,
            err=lookahead_held(
                f"B1 bf16 lookahead vs plain at n={n} p={p} q={q} c={c} "
                f"emit={emit_gm}", ops16, sf.lookahead_gram(ops[0], block),
                kw, flat(sf.sweep_fused_plain(*ops, **kw)),
                flat(sf.sweep_fused(*ops, **kw)))))
        emit({"phase": "bf16_modes", "lookahead_case": la_cases[-1]})
    n, p, q, c, _ = LA_EDGES[-1]
    parts = [kernel_inputs(n, p, q, c, seed=s_)[0] for s_ in (0, 1)]
    goff = sf.lookahead_gram(parts[0][0], block)
    parts = [[sf.bf16_operand(ops[0])] + list(ops[1:]) for ops in parts]
    kw = dict(block_size=block, emit_gam_mu=True, c_one=False, bf16=True,
              lookahead=True)
    # every operand but the state's is the first replica's for both
    both = flat(sf.sweep_fused(*sf.FUSED.stack(
        [ops + [goff] for ops in parts]), **kw))
    width = sf.fused_launch_plan(n, parts[0][5].shape[1], block,
                                 parts[0][3].shape[1], sms, 2)["slice_width"]
    own = [k in sf.FUSED.state for k in sf.FUSED.names]
    for r_, ops in enumerate(parts):
        ops = [b if mine else a for a, b, mine in zip(parts[0], ops, own)]
        one = flat(sf.fused_launch("atlasqtl_sweep_fused", *ops, goff, **kw,
                                   slice_width=width))
        if not all(a is None and b is None or torch.equal(a[r_], b)
                   for a, b in zip(both, one)):
            raise AssertionError(f"B1 bf16 lookahead: replica {r_} of a "
                                 f"batched launch is not its own launch")
    out["lookahead_replicas_bitwise"] = 2
    del parts, both, goff
    out["b1"] = b1_cases
    out["b1_lookahead"] = la_cases

    # ---- B2's pair_bf16 instance against its plain version, at each
    # window mis_sub ----
    names = ("gam", "mu", "fitted", "z_row", "z_col")
    b2_cases, b2_timing = [], None
    out["b2_registers"] = {
        k: v for k, v in ptxas_summary(sf.build.ptxas_report).items()
        if "sweep_missing_kernel" in k}
    for n, p, q, frac in BF16_MIS_SHAPES:
        for c in (1.0, 0.5):
            ops, block = mis_kernel_inputs(n, p, q, c, frac)
            f32 = sm.sweep_missing_fused_plain(*ops, block_size=block)
            f32_kernel = sm.sweep_missing_fused(*ops, block_size=block)
            dims = (ops[0].shape[0], ops[0].shape[1], ops[6].shape[1],
                    ops[4].shape[1])
            plan = sm.missing_launch_plan(dims[0], dims[2], block, dims[3])
            for sub in BF16_MIS_SUBS:
                kw = dict(block_size=block, pair_bf16=True, sub=sub)
                got = sm.sweep_missing_fused(*ops, **kw)
                again = sm.sweep_missing_fused(*ops, **kw)
                ref = sm.sweep_missing_fused_plain(*ops, **kw)
                torch.cuda.synchronize()
                label = (f"B2 pair_bf16 mis_sub={sub} vs plain at n={n} "
                         f"p={p} q={q} c={c}")
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"{label}: two launches differ")
                # B2's own tolerance, and the mean criterion, which a
                # kernel that rounds no pair product (or others) does not
                # meet
                case = dict(n=n, p=p, q=q, missing_frac=frac, block=block,
                            c=c, mis_sub=sub, plan=plan,
                            max_abs_err=held(label, got, ref, names),
                            err=mean_held(label, got, ref, f32, f32_kernel,
                                          names))
                b2_cases.append(case)
                emit({"phase": "bf16_modes", "b2_case": case})
                del got, again, ref
            if p >= 2000 and c == 1.0:
                b2_timing = b2_turns(ops, block, dims)
                emit({"phase": "bf16_modes", "b2_timing": b2_timing})
            del ops, f32, f32_kernel
            torch.cuda.empty_cache()
    out["b2"] = b2_cases

    # ---- sim_anneal fits in each mode beside the float32 fit ----
    n, p, q, p_act, q_hit = FIT_SHAPE
    complete = simulate(n, p, q, 0, p_act, q_hit)
    missing = simulate(n, p, q, 0, p_act, q_hit, missing_frac=0.15)
    fits, gams = {}, {}
    for mode, (xx, yy), base, flags, inst, own in (
            ("complete", complete, Config(), ("mxu_bf16",),
             sf.sweep_fused.bf16, sf.sweep_fused),
            ("lookahead", complete, Config(), ("mxu_bf16", "sweep_lookahead"),
             sf.sweep_fused.lookahead, sf.sweep_fused),
            ("impute", missing, Config(missing="impute"), ("mxu_bf16",),
             sf.sweep_fused.bf16, sf.sweep_fused),
            ("exact", missing, Config(), ("mis_pair_bf16",),
             sm.sweep_missing_fused.pair_bf16, sm.sweep_missing_fused)):
        t0 = time.perf_counter()
        ref, _, ref_gam = prepared_fit(yy, xx, base, DEVICE, seed=0,
                                       q_pad_to=BF16_FIT_QPAD)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        for fn in dl.launch_counters():
            fn.launches = 0
        dl.replays = 0
        t0 = time.perf_counter()
        res, theta, gam = prepared_fit(
            yy, xx, dataclasses.replace(base, **dict.fromkeys(flags, True)),
            DEVICE, seed=0, q_pad_to=BF16_FIT_QPAD)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {"instance": inst.launches, "wrapper": own.launches,
                  "replays": dl.replays}
        auc = hotspot_auc(theta, p_act)
        gams[mode] = gam
        fits[mode] = dict(flag="+".join(flags), it=res.it, f32_it=ref.it,
                          seconds=secs, f32_seconds=ref_s,
                          converged=bool(res.converged),
                          launches=counts, hotspot_auc_theta=auc,
                          pip_max_diff_vs_f32=float(
                              np.abs(gam - ref_gam).max()),
                          lb_opt=res.lb_opt, f32_lb_opt=ref.lb_opt)
        if mode == "lookahead":  # beside the bf16 fit without it
            fits[mode].update(
                bf16_it=fits["complete"]["it"],
                bf16_lb_opt=fits["complete"]["lb_opt"],
                pip_max_diff_vs_bf16=float(
                    np.abs(gam - gams["complete"]).max()))
        if not (res.converged and counts["instance"] == res.it
                and counts["wrapper"] == res.it and counts["replays"] > 0):
            raise AssertionError(f"bf16 {mode} fit: converged="
                                 f"{res.converged}, it {res.it}, launches "
                                 f"{counts}")
        if not (auc >= 0.95 and np.isfinite(gam).all()
                and fits[mode]["pip_max_diff_vs_f32"] <= BF16_FIT_PIP):
            raise AssertionError(f"bf16 {mode} fit: AUC {auc:.3f}, PIPs "
                                 f"{fits[mode]['pip_max_diff_vs_f32']:.3g} "
                                 f"from the float32 fit's")
        if mode == "exact":
            f32_exact_gam = ref_gam
    # B2's windows over 16 (C6b), each beside the float32 exact fit
    xx, yy = missing
    for sub in BF16_DEEP_SUBS:
        for fn in dl.launch_counters():
            fn.launches = 0
        dl.replays = 0
        t0 = time.perf_counter()
        res, theta, gam = prepared_fit(
            yy, xx, Config(mis_pair_bf16=True, mis_sub=sub), DEVICE, seed=0,
            q_pad_to=BF16_FIT_QPAD)
        torch.cuda.synchronize()
        counts = {"instance": sm.sweep_missing_fused.pair_bf16.launches,
                  "wrapper": sm.sweep_missing_fused.launches,
                  "replays": dl.replays}
        auc = hotspot_auc(theta, p_act)
        pip = float(np.abs(gam - f32_exact_gam).max())
        fits[f"exact_mis_sub{sub}"] = dict(
            flag=f"mis_pair_bf16, mis_sub={sub}", it=res.it,
            f32_it=fits["exact"]["f32_it"],
            seconds=time.perf_counter() - t0,
            converged=bool(res.converged), launches=counts,
            hotspot_auc_theta=auc, pip_max_diff_vs_f32=pip,
            lb_opt=res.lb_opt)
        if not (res.converged and counts["instance"] == res.it
                and counts["wrapper"] == res.it and counts["replays"] > 0
                and auc >= 0.95 and np.isfinite(gam).all()
                and pip <= BF16_FIT_PIP):
            raise AssertionError(f"bf16 exact fit at mis_sub={sub}: "
                                 f"{fits[f'exact_mis_sub{sub}']}")
    out["fits"] = fits

    # ---- the eQTL cut, both B1 instances from one device draw ----
    n, p, q, p_act, q_hit = EQTL_SHAPE
    x, y = simulate(n, p, q, 1, p_act, q_hit)
    eqtl = {}
    for flag in (False, True):
        cfg = Config(mxu_bf16=flag, maxit=10)
        res, stats = timed_run(
            lambda: device_fit(y, x, cfg, 1, (1, 2, 5),
                               q_pad_to=BF16_FIT_QPAD),
            (sf, "_sweep_fused_cuda"), sf.sweep_fused, b1_any_launch_bound)
        eqtl["bf16" if flag else "f32"] = dict(
            it=res.it, launches=stats["launches"],
            sweep_ms_median=stats["sweep_ms_median"],
            iter_ms_median=stats["iter_ms_median"],
            sweep_bound_ms=statistics.median(stats["sweep_bound_ms"]),
            total_s=stats["total_s"],
            max_memory_allocated_gb=stats["max_memory_allocated_gb"])
        if stats["launches"] != res.it:
            raise AssertionError(f"bf16_modes eQTL cut: {stats['launches']} "
                                 f"launches for {res.it} iterations")
        del res
    del x, y
    out["eqtl"] = eqtl
    emit(out)
    return dict(
        b1=dict(launches=fits["complete"]["launches"]["instance"],
                impute_fit_launches=fits["impute"]["launches"]["instance"],
                timing=b1_timing,
                max_abs_err=max(e["max"] for cs in b1_cases
                                for e in cs["err"].values()),
                mean_abs_err=max(e["mean"] for cs in b1_cases
                                 for e in cs["err"].values()),
                eqtl=eqtl),
        b1_lookahead=dict(
            launches=fits["lookahead"]["launches"]["instance"],
            timing=la_timing,
            max_abs_err=max(e["max"] for cs in la_cases
                            for e in cs["err"].values()),
            mean_abs_err=max(e["mean"] for cs in la_cases
                             for e in cs["err"].values())),
        b2=dict(launches=fits["exact"]["launches"]["instance"],
                launches_by_mis_sub={
                    "16": fits["exact"]["launches"]["instance"],
                    **{str(s_): fits[f"exact_mis_sub{s_}"]["launches"][
                        "instance"] for s_ in BF16_DEEP_SUBS}},
                timing=b2_timing,
                max_abs_err=max(v for cs in b2_cases
                                for v in cs["max_abs_err"].values()),
                mean_abs_err=max(e["mean"] for cs in b2_cases
                                 for e in cs["err"].values())))


def b2_turns(ops, block, dims):
    """B2's float32 instance and its pair_bf16 instance at each window of
    BF16_MIS_SUBS timed in turns on one problem (f32, 16, 8, ..., 128, then
    back, f32; CUDA events, median of 9 each), with each one's phase
    clocks, bound (`mis_bf16_bound_ms`; the float32 instance's
    `mis_bound_ms`), share of it and registers (ptxas), and the plain
    version's time at the default window."""
    import torch
    from atlasqtl_tpu_torch.ops import sweep_fused as sf
    from atlasqtl_tpu_torch.ops import sweep_missing_fused as sm

    kern = {sub: (lambda s=sub: sm.sweep_missing_fused(
        *ops, block_size=block, pair_bf16=True, sub=s))
        for sub in BF16_MIS_SUBS}
    kern["f32"] = lambda: sm.sweep_missing_fused(*ops, block_size=block)
    order = ["f32", *BF16_MIS_SUBS]
    turns = {k: [] for k in order}
    for k in order + order[::-1]:
        turns[k].append(cuda_ms(kern[k], 9))
    clocks = {}
    for k in order:
        kern[k]()
        torch.cuda.synchronize()
        clocks[str(k)] = sm.phase_clocks()
    sub = BF16_MIS_SUBS[0]
    t = dict(n=dims[0], p=dims[1], q=dims[2], block=block, mis_sub=sub,
             ms=turns[sub][0], ms_2=turns[sub][1], f32_ms=turns["f32"][0],
             f32_ms_2=turns["f32"][1],
             ms_by_mis_sub={str(k): turns[k] for k in BF16_MIS_SUBS},
             clocks=clocks,
             plain_ms=cuda_ms(lambda: sm.sweep_missing_fused_plain(
                 *ops, block_size=block, pair_bf16=True, sub=sub), 3))
    t["bound_ms"], t["bound_by"] = mis_bf16_bound_ms(*dims, sub)
    t["pct_of_bound"] = pct(t["bound_ms"], t["ms"])
    t["f32_bound_ms"] = mis_bound_ms(*dims)[0]
    t["bound_ms_by_mis_sub"] = {str(k): mis_bf16_bound_ms(*dims, k)[0]
                                for k in BF16_MIS_SUBS}
    t["pct_of_bound_by_mis_sub"] = {
        k: pct(b, min(turns[int(k)]))
        for k, b in t["bound_ms_by_mis_sub"].items()}
    on_chip = sm.missing_launch_plan(dims[0], dims[2], block,
                                     dims[3])["fm_on_chip"]
    regs = b2_instances(ptxas_summary(sf.build.ptxas_report))
    t["registers_by_mis_sub"] = {
        str(k): regs.get((on_chip, 0 if k == "f32" else k)) for k in order}
    return t


def bf16_mode(res, instance):
    """A kernel line's entry for one bf16 instance from phase_bf16_modes:
    its launches on the mode's sim_anneal fit, its time, its float32
    instance's time, its plain version's, its bound, its errors."""
    t = res["timing"]
    return dict(instance=instance, launches=res["launches"],
                shape={k: t[k] for k in ("n", "p", "q", "block")},
                ms=t["ms"], f32_ms=t["f32_ms"], plain_ms=t["plain_ms"],
                **{k: t[k] for k in ("bf16_ms", "mis_sub", "ms_by_mis_sub",
                                     "pass_cycles_per_32_rows", "registers",
                                     "f32_ms_2", "bound_ms_by_mis_sub",
                                     "pct_of_bound_by_mis_sub",
                                     "registers_by_mis_sub") if k in t},
                bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                pct_of_bound=t["pct_of_bound"], library_ms=None,
                max_abs_err=res["max_abs_err"],
                mean_abs_err=res["mean_abs_err"],
                **{k: res[k] for k in ("impute_fit_launches", "eqtl",
                                       "launches_by_mis_sub") if k in res})


def phase_mesh():
    """The mesh (atlasqtl_tpu_torch.parallel) on the card: NCCL at world size
    1; atlasqtl(mesh=...) on the 1-D mesh and on a (1, 1) 2-D mesh (the
    p x q pipeline, T >= 2 q-tiles per iteration) at the sim_anneal shape,
    cut to MESH_MAXIT iterations (past the annealing ladder),
    on complete data (B1) and with 15% of Y missing (exact: B2), each
    beside the single-device fit from the same list_init (the same
    iterations, PIPs within MESH_PIP, AUC >= 0.95) with its kernel's
    launches per iteration (1 on the 1-D mesh, T on the pipeline); one
    fit on the graph loop under the 1-D mesh (its NCCL all-reduces
    captured) beside the host loop's; the eQTL cut (maxit 10) under the
    1-D mesh from the phases' shared host draw, ms per iteration and B1
    launches per iteration beside the single-device run's."""
    import socket
    import torch
    import torch.distributed as dist
    import atlasqtl_tpu_torch as at
    from atlasqtl_tpu_torch.parallel import mesh as pmesh
    from atlasqtl_tpu_torch.parallel import pipeline as pp
    from atlasqtl_tpu_torch.inference import device_loop as dl
    from atlasqtl_tpu_torch.ops import sweep_fused as sf
    from atlasqtl_tpu_torch.ops import sweep_missing_fused as sm

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    at.initialize_distributed(init_method=f"tcp://localhost:{port}",
                              world_size=1, rank=0, device=DEVICE)
    if dist.get_backend() != "nccl":
        raise AssertionError(f"mesh phase: backend {dist.get_backend()}")
    meshes = {"1d": pmesh.make_mesh(), "2d": pmesh.make_mesh(two_d=True)}
    out = {"phase": "mesh", "backend": dist.get_backend(),
           "world_size": dist.get_world_size(),
           "meshes": {k: dict(m.shape) for k, m in meshes.items()}}
    n, p, q, p_act, q_hit = FIT_SHAPE
    fits = {}
    for kind, frac, wrapper in (("complete", 0.0, sf.sweep_fused),
                                ("exact", 0.15, sm.sweep_missing_fused)):
        x, y = simulate(n, p, q, 0, p_act, q_hit, missing_frac=frac)
        kw = dict(p0=(5, 25), anneal=(1, 2, 10), dtype=torch.float32,
                  verbose=0, user_seed=0, device=DEVICE,
                  list_init=host_init(y, x, 0), device_loop="off",
                  maxit=MESH_MAXIT)

        def run(mesh, **more):
            for fn in dl.launch_counters():
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = at.atlasqtl(y, x, mesh=mesh, **{**kw, **more})
            torch.cuda.synchronize()
            return res, time.perf_counter() - t0, wrapper.launches

        single, single_s, single_l = run(None)
        q_local = -(-q // 32) * 32   # the mesh pads q to 32 per q-shard
        tiles = q_local // pp.pick_q_tile(q_local, 1)
        for mname, mesh in meshes.items():
            res, secs, launches = run(mesh)
            per_it = 1 if mname == "1d" else tiles
            pip = float(np.abs(res.gam_vb - single.gam_vb).max())
            auc = hotspot_auc(res.theta_vb, p_act)
            fits[f"{mname}_{kind}"] = dict(
                it=res.it, single_it=single.it, converged=res.converged,
                seconds=secs, single_seconds=single_s, launches=launches,
                single_launches=single_l, launches_per_iteration=per_it,
                pip_max_diff_vs_single=pip, hotspot_auc_theta=auc,
                lb_opt=res.lb_opt, single_lb_opt=single.lb_opt)
            if not ((res.converged or res.it == MESH_MAXIT)
                    and res.it == single.it
                    and launches == per_it * res.it and single_l == single.it
                    and pip <= MESH_PIP and auc >= 0.95
                    and np.isfinite(res.gam_vb).all()):
                raise AssertionError(f"mesh {mname} {kind} fit: "
                                     f"{fits[f'{mname}_{kind}']}")
        if kind == "complete":
            # the graph loop under the 1-D mesh
            for fn in dl.launch_counters():
                fn.launches = 0
            dl.replays = 0
            t0 = time.perf_counter()
            res = at.atlasqtl(y, x, mesh=meshes["1d"],
                              **{**kw, "device_loop": "on"})
            torch.cuda.synchronize()
            host = fits["1d_complete"]
            fits["1d_complete_graph_loop"] = dict(
                it=res.it, host_loop_it=host["it"],
                seconds=time.perf_counter() - t0,
                launches=sf.sweep_fused.launches, replays=dl.replays,
                lb_opt=res.lb_opt, host_loop_lb_opt=host["lb_opt"])
            if not (res.it == host["it"] and dl.replays > 0
                    and sf.sweep_fused.launches == res.it
                    and abs(res.lb_opt - host["lb_opt"])
                    <= 1e-6 * abs(host["lb_opt"])):
                raise AssertionError(f"mesh graph-loop fit: "
                                     f"{fits['1d_complete_graph_loop']}")
    out["fits"] = fits
    emit(out)
    # the eQTL cut under the 1-D mesh, and without one if the eqtl phase
    # has not run in this call
    if ("eqtl", None) not in _EQTL_STATS:
        eqtl_run("eqtl", 0.0, sf, "_sweep_fused_cuda", sf.sweep_fused,
                 b1_launch_bound)
    eqtl_run("mesh_eqtl", 0.0, sf, "_sweep_fused_cuda", sf.sweep_fused,
             b1_launch_bound, mesh=meshes["1d"])
    single, mesh_ = _EQTL_STATS[("eqtl", None)], _EQTL_STATS[("mesh_eqtl",
                                                                None)]
    out["eqtl"] = {k: dict(iter_ms_median=v["iter_ms_median"],
                           sweep_ms_median=v["sweep_ms_median"],
                           launches_per_iteration=v["launches"] / v["it"],
                           it=v["it"], total_s=v["total_s"])
                   for k, v in (("single", single), ("mesh_1d", mesh_))}
    emit(out)
    dist.destroy_process_group()
    return dict(fits=fits, eqtl=out["eqtl"])


def mcmc_problem(n, p, q, p_act, q_hit, device, dtype, block, seed=0):
    """The samplers' (data, hyper, cfg) of simulate(n, p, q, seed, ...) on
    `device`, built as tests/test_mcmc.py builds them (shr_fac_inv = q,
    p0 = (5, 25))."""
    import atlasqtl_tpu_torch as at
    from atlasqtl_tpu_torch.io.prepare import prepare_data
    from atlasqtl_tpu_torch.inference import elicitation as elic
    from atlasqtl_tpu_torch.models import global_local as gl
    x, y = simulate(n, p, q, seed, p_act, q_hit)
    dat = prepare_data(y, x, 0.1, 1000)
    p_eff, q_eff = dat.x.shape[1], dat.y.shape[1]
    cfg = at.Config(dtype=dtype, block_size=block, shr_fac_inv=float(q_eff))
    data = gl.build_data(dat.x, dat.y, cfg, device)
    hyper = gl.build_hyper(elic.auto_set_hyper(dat.y, p_eff, (5, 25)),
                           data.y.shape[1], cfg, device)
    return data, hyper, cfg


def mcmc_same_draws():
    """At MCMC_TEST_SHAPE in float64: three Gibbs sweeps, one NUTS
    iteration and one SMC mutation (4 particles, temper 0.5) on the card
    from the draws the same calls made on the CPU; each output's max abs
    difference, held to rtol 1e-9."""
    import torch
    from atlasqtl_tpu_torch.mcmc import gibbs as mg, nuts as mn
    from atlasqtl_tpu_torch.mcmc.draws import RecordingDraws, TorchDraws
    from atlasqtl_tpu_torch.ops.sweep import block_gram

    def fields(st):
        return [getattr(st, f.name).cpu().numpy()
                for f in dataclasses.fields(st)]

    def gibbs(data, hyper, cfg, draws):
        gram, st = block_gram(data.x, 16), mg.init_state(data, cfg)
        for _ in range(3):
            st = mg.gibbs_sweep(st, data, hyper, gram, draws, cfg=cfg)
        return fields(st)

    def nuts(data, hyper, cfg, draws):
        return mn.run_nuts(data, hyper, cfg, n_samples=1, n_burnin=0,
                           seed=3, draws=draws)

    def smc(data, hyper, cfg, draws):
        st = mg.init_state(data, cfg, 4)
        return fields(mg.gibbs_sweep(st, data, hyper, block_gram(data.x, 16),
                                     draws, cfg=cfg, temper=0.5))

    out = {}
    for name, run in (("gibbs_3_sweeps", gibbs), ("nuts_1_iteration", nuts),
                      ("smc_1_mutation", smc)):
        rec = RecordingDraws(TorchDraws.seeded(3, "cpu", torch.float64))
        ref = run(*mcmc_problem(*MCMC_TEST_SHAPE, "cpu", torch.float64, 16),
                  rec)
        got = run(*mcmc_problem(*MCMC_TEST_SHAPE, DEVICE, torch.float64, 16),
                  rec.replay(DEVICE))
        out[name] = max(float(np.abs(g - r).max()) for g, r in zip(got, ref))
        if not all(np.allclose(g, r, rtol=1e-9, atol=1e-12)
                   for g, r in zip(got, ref)):
            raise AssertionError(f"mcmc {name}: the card's chain differs "
                                 f"from the CPU's by {out[name]:.3g}")
    return out


def sweep_launches(sweep):
    """One call of sweep() under torch.profiler (after one to warm the
    tracer up): its CUDA launches (kernels, memsets and copies on the
    device) and their device ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 acc_events=True) as prof:
        for _ in range(2):
            sweep()
            torch.cuda.synchronize()
            prof.step()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.key.startswith("ProfilerStep")]
    return (sum(e.count for e in dev),
            sum((getattr(e, "device_time_total", None)
                 or getattr(e, "cuda_time_total", 0)) for e in dev) / 1e3)


def phase_mcmc():
    """The cross-check samplers (atlasqtl_tpu_torch.mcmc) on the card: the
    card's chains equal the CPU's under the same draws (mcmc_same_draws);
    then at FIT_SHAPE in float32 with the card's own generator, run_gibbs
    (ms and CUDA launches per sweep, the device's busy share of a sweep),
    run_nuts (ms and leapfrogs per iteration), run_smc (MCMC_PARTICLES
    particles; ms per batched mutation) and run_gibbs_sharded on a
    world-size-1 NCCL mesh beside run_gibbs from the same seed; each
    sampler's theta-mean hotspot AUC (Gibbs's held to MCMC_AUC) and its
    mean |PIP - CAVI gam| against the fit phase's fit."""
    import socket
    import torch
    import torch.distributed as dist
    import atlasqtl_tpu_torch as at
    from atlasqtl_tpu_torch.mcmc import gibbs as mg, nuts as mn, smc as ms
    from atlasqtl_tpu_torch.mcmc.draws import TorchDraws
    from atlasqtl_tpu_torch.mcmc.sharded import run_gibbs_sharded
    from atlasqtl_tpu_torch.ops.sweep import block_gram
    from atlasqtl_tpu_torch.parallel import mesh as pmesh

    t0 = time.perf_counter()
    out = {"phase": "mcmc", "same_draws_max_abs_diff": mcmc_same_draws(),
           "same_draws_seconds": time.perf_counter() - t0}
    n, p, q, p_act, q_hit = FIT_SHAPE
    data, hyper, cfg = mcmc_problem(n, p, q, p_act, q_hit, DEVICE,
                                    torch.float32, 128)
    out["cavi_fit_from_fit_phase"] = "res" in _FIT
    if "res" not in _FIT:   # the fit phase did not run in this call
        x, y = simulate(n, p, q, 0, p_act, q_hit)
        _FIT["res"] = at.atlasqtl(y, x, p0=(5, 25), anneal=(1, 2, 10),
                                  dtype=torch.float32, verbose=0, user_seed=0,
                                  device=DEVICE)
    cavi = _FIT["res"].gam_vb

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def summary(res, secs, steps):
        pip, theta = res[0][:p, :q], res[2][:p]
        return dict(seconds=secs, ms_per_step=1e3 * secs / steps,
                    hotspot_auc_theta=hotspot_auc(theta, p_act),
                    pip_mean_abs_diff_vs_cavi=float(np.abs(pip - cavi).mean()),
                    pip_active_mean=float(pip[:p_act, :q_hit].mean()),
                    pip_null_mean=float(pip[p_act:].mean()),
                    finite=all(bool(np.isfinite(v).all()) for v in res))

    # Gibbs: its sweep's launches and device time, then the chain
    gram = block_gram(data.x, 128)
    draws = TorchDraws.seeded(0, DEVICE, torch.float32)
    st = mg.init_state(data, cfg)
    t0 = time.perf_counter()
    launches, device_ms = sweep_launches(
        lambda: mg.gibbs_sweep(st, data, hyper, gram, draws, cfg=cfg))
    out["profile_seconds"] = time.perf_counter() - t0
    res, secs = timed(lambda: mg.run_gibbs(data, hyper, cfg, **MCMC_GIBBS))
    steps = MCMC_GIBBS["n_burnin"] + MCMC_GIBBS["n_samples"]
    out["gibbs"] = dict(summary(res, secs, steps), sweeps=steps,
                        launches_per_sweep=launches,
                        launches_per_coordinate=launches / data.x.shape[1],
                        device_ms_per_sweep=device_ms,
                        device_busy_share=device_ms / (1e3 * secs / steps))

    # NUTS-within-Gibbs: count the leapfrogs of its trees
    leapfrog, count = mn._leapfrog, [0]

    def counted(*a):
        count[0] += 1
        return leapfrog(*a)
    mn._leapfrog = counted
    try:
        res, secs = timed(lambda: mn.run_nuts(data, hyper, cfg, **MCMC_NUTS))
    finally:
        mn._leapfrog = leapfrog
    steps = MCMC_NUTS["n_burnin"] + MCMC_NUTS["n_samples"]
    out["nuts"] = dict(summary(res, secs, steps), iterations=steps,
                       leapfrogs_per_iteration=count[0] / steps)

    # SMC: one batched mutation of MCMC_PARTICLES particles, then the run
    ps = mg.init_state(data, cfg, MCMC_PARTICLES)
    ps = mg.gibbs_sweep(ps, data, hyper, gram, draws, cfg=cfg, temper=0.5)
    _, mut_s = timed(lambda: mg.gibbs_sweep(ps, data, hyper, gram, draws,
                                            cfg=cfg, temper=0.5))
    res, secs = timed(lambda: ms.run_smc(data, hyper, cfg, **MCMC_SMC))
    rungs = MCMC_SMC["anneal"][2]
    steps = rungs * MCMC_SMC["n_mutations"] + MCMC_SMC["n_final"]
    out["smc"] = dict(summary(res[:4], secs, steps), mutations=steps,
                      particles=MCMC_PARTICLES,
                      ms_per_batched_mutation=1e3 * mut_s,
                      log_evidence=res[4])

    # run_gibbs_sharded on a world-size-1 NCCL mesh
    if not dist.is_initialized():
        with socket.socket() as sk:
            sk.bind(("localhost", 0))
            port = sk.getsockname()[1]
        at.initialize_distributed(init_method=f"tcp://localhost:{port}",
                                  world_size=1, rank=0, device=DEVICE)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"mcmc phase: backend {dist.get_backend()}")
        one, one_s = timed(lambda: mg.run_gibbs(data, hyper, cfg,
                                                **MCMC_MESH))
        shd, shd_s = timed(lambda: run_gibbs_sharded(
            data, hyper, cfg, pmesh.make_mesh(), **MCMC_MESH))
    finally:
        dist.destroy_process_group()
    diff = max(float(np.abs(a - b).max()) for a, b in zip(shd, one))
    out["sharded_gibbs"] = dict(backend="nccl", world_size=1,
                                seconds=shd_s, single_seconds=one_s,
                                max_abs_diff_vs_single=diff)
    emit(out)
    g = out["gibbs"]
    if not (g["hotspot_auc_theta"] >= MCMC_AUC and g["finite"]
            and out["nuts"]["finite"] and out["smc"]["finite"]
            and np.isfinite(res[4])):
        raise AssertionError(f"mcmc phase: {out}")
    if diff > 1e-6:
        raise AssertionError(f"mcmc phase: the sharded chain differs from "
                             f"run_gibbs by {diff:.3g}")
    return out


# ---- the probes phase: B1's and B2's perf probes (B5c, B5e) ------------
PROBE_SHAPE = (120, 256, 200)   # n, p, q of the B1 parity cases
# B2's parity shapes: on chip (a cluster of 4) and Fm in device memory
PROBE_MIS_SHAPES = ((80, 250, 40, 0.2), (8000, 256, 256, 0.15))
PROBE_TIMED = (1000, 2048, 10000)   # the eQTL cut, block 128
# a shape whose plan takes 32 columns (the probe instances that also take
# a block over 128 in pieces), timed likewise beside B1
PROBE_TIMED_32 = (1000, 2048, 2048)
PROBE_REPS = 5                  # CUDA-event launches per turn (median)
PROBE_ROUNDS = 3                # rounds of turns (each sweep once a round)
# B1's windows off the 8-row grid (neither dividing 8 nor a multiple of
# it), held to the plain version at (120, p, 200): (p, block, windows);
# block 192 goes in pieces of 96, block 200 in pieces of 40 (25 spans two)
PROBE_OFF_GRID = ((240, 48, (3, 6, 12)), (240, 40, (5,)), (384, 192, (12,)),
                  (400, 200, (25,)))
# and timed at the eQTL cut's n and q with p = 2016 = 42 x 48 = 21 x 96:
# (block, window), in rounds of turns against B1's float32 instance at
# that block; B2's windows over 16 likewise at PROBE_TIMED
PROBE_OFF_GRID_TIMED = (1000, 2016, 10000)
PROBE_OFF_GRID_WINDOWS = ((48, 6), (96, 12))
PROBE_DEEP_WINDOWS = (32, 64, 128)
# B2 off the 8-row grid, timed beside its float32 instance at that block:
# (n, p, q, block, window)
PROBE_MIS_OFF_TIMED = (1000, 2016, 10000, 48, 12)
# B2's float32 probe instance where a window's end reads a rank's rows and
# a replica's slices, held to the plain version at windows 32 and 128:
# (n, p, q, replicas), Fm on chip in a cluster of 4 (n = 1000 and 80) and
# in device memory (8000)
PROBE_MIS_RANKS = ((1000, 256, 40, 1), (80, 250, 40, 2), (1000, 256, 40, 2),
                   (8000, 256, 256, 2))
# B2's float32 probe instance at windows that are not powers of two, held
# to the plain version at (80, p, 40): (p, block, windows)
PROBE_MIS_ANY = ((240, 48, (3, 6, 12, 24)), (240, 40, (5, 20)),
                 (400, 200, (25, 200)))
PROBE_MAIN = "noadv"            # the probe the phase's main path runs
# each phase's cost as the difference of two sweeps at the eQTL cut: the
# sweep that keeps it less the probe that drops it ("none": B1's float32
# instance itself, in its plan, whose schedule every probe runs);
# tiles_and_z (jacobi - jacobi_min) also holds the Z Mills tiles
PROBE_COSTS = {"projection": ("none", "nor0"), "advance": ("none", "noadv"),
               "chain_order": ("none", "jacobi"),
               "z_mills": ("none", "exact_noz"),
               "sigmoid": ("exact_noz", "nosig"),
               "pushes": ("exact_noz", "noseq"),
               "corrections": ("exact_noz", "norank"),
               "x_cp_stream": ("none", "dmalite"),
               "tiles_and_z": ("jacobi", "jacobi_min")}
# (B2's: "none" is its float32 instance, the probe instance's exact sweep
# timed beside it)
MIS_PROBE_COSTS = {"pairs_and_pushes": ("none", "noseq"),
                   "advance": ("none", "noadv"),
                   "advance_mask": ("none", "noadvmask")}


def probe_bound_ms(n, p, q, block, r_aug, emit_gam_mu, parts, sub):
    """Least time of one B1 sweep under the probe `parts`
    (ops/sweep_fused.py:Probe): sweep_bound_ms's terms with what the probe
    drops left out.  Operations per (j, k): 2 n for each product kept,
    the in-block Gram corrections (sweep_bound_ms's `block`; of them a
    probe keeping one kind keeps sub - 1 pushes or block - sub
    corrections), 2 r + 2 for the logit tile's product if the tiles are
    kept and 4 r + 4 for the Z tile's if the Mills are.  Bytes: x if a
    product is kept (block 0's n x block under dmalite), X^T Y (block 0's
    rows under dmalite), beta in and out, gam/mu when emitted, F in if a
    product is kept and out if the advance is, the Gram blocks, L and the
    nodes if a tile is kept."""
    prod = 2 * n * (parts.proj + parts.advance)
    gram = (block if parts.pushes and parts.corrections
            else (sub - 1) if parts.pushes
            else (block - sub) if parts.corrections else 0)
    interp = 2 * r_aug * parts.tiles + 4 * r_aug * parts.mills
    ops = p * q * (prod + gram + interp)
    rows = block if parts.pin else p
    uses_f = parts.proj or parts.advance
    nbytes = 4 * (n * rows * uses_f + rows * q + p * q * (2 + 2 * emit_gam_mu)
                  + n * q * (uses_f + parts.advance) + p * block
                  + (p * r_aug + 3 * r_aug * q) * (parts.tiles or parts.mills))
    return 1e3 * max(ops / FP32_PEAK, nbytes / HBM_RATE), \
        ("operations" if ops / FP32_PEAK >= nbytes / HBM_RATE else "bytes")


def mis_probe_bound_ms(n, p, q, r_aug, probe, sub):
    """mis_bound_ms's terms as B2's probe keeps them at its window of S =
    sub predictors: the projection (2 n per (j, k)), the tiles (6 (r + 2))
    and Fm's advance as the probe's function needs it from these inputs,
    counted as mis_bound_ms counts a masked advance (3 n: the product, the
    mask's, the sum), with f = (S - 1) / S the share of a window's
    predictors that a later one in it must see: noseq and noh the masked
    advance of every predictor at its window's end (3 n); noadv the running
    masked advance inside a window (3 n f; Fm, restored at the window's end,
    is a copy, no operation); noadvmask the same plus, at the window's end,
    its unmasked remainder (1 - m) (n f) and the last predictor's advance
    without the mask (2 n / S).  The pair Grams of a window are B2's
    design, not the function, and not counted.  Bytes: mis_bound_ms's, Fm
    not written under noadv."""
    f = (sub - 1) / sub
    adv = {"noadv": 3 * f, "noadvmask": 4 * f + 2 / sub}.get(probe, 3)
    ops = p * q * ((2 + adv) * n + 6 * r_aug)
    nbytes = 4 * (n * p + 7 * p * q + (3 - (probe == "noadv")) * n * q
                  + p * r_aug + 3 * r_aug * q)
    return 1e3 * max(ops / FP32_PEAK, nbytes / HBM_RATE), \
        ("operations" if ops / FP32_PEAK >= nbytes / HBM_RATE else "bytes")


def probe_turns(fns, reps=PROBE_REPS, rounds=PROBE_ROUNDS):
    """Each sweep of fns beside fns["none"] (the exact sweep), `rounds`
    times over: in each round, for each other sweep, the turns (exact,
    probe, probe, exact), each the median of `reps` CUDA-event launches.
    Returns ({name: [ms of every turn]}, {name: [its two turns' mean less
    the two exact turns' mean beside them, one per round]}), the exact
    sweep's offsets all 0."""
    turns = {name: [] for name in fns}
    offsets = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            if name == "none":
                continue
            a = cuda_ms(fns["none"], reps)
            b, c = cuda_ms(fn, reps), cuda_ms(fn, reps)
            d = cuda_ms(fns["none"], reps)
            turns["none"] += [a, d]
            turns[name] += [b, c]
            offsets[name].append((b + c) / 2 - (a + d) / 2)
        offsets["none"].append(0.0)
    return turns, offsets


def implied_costs(offsets, costs):
    """Each phase's ms, the sweep that keeps it less the probe that drops
    it, from the two's offsets to the exact sweep round by round: the
    median over the rounds, the least and the most, and `resolved` where
    every round gives the same sign (else the difference is within the
    turns' spread)."""
    out = {}
    for k, (a, b) in costs.items():
        d = [x - y for x, y in zip(offsets[a], offsets[b])]
        out[k] = dict(ms=statistics.median(d), min=min(d), max=max(d),
                      resolved=min(d) > 0 or max(d) < 0)
    return out


def probe_routing():
    """The main path of B1's probes: one cavi_iteration on the card with
    Config(sweep_probe=PROBE_MAIN) at PROBE_SHAPE (q padded to 256, where
    the JAX kernel finds a tile), the launch counters zeroed just before
    and read just after: one probe-instance launch.  Then with
    sweep_stagger=True, which takes B4 without a probe and B1's probe
    instance with one."""
    import torch
    from atlasqtl_tpu_torch.types import Config
    from atlasqtl_tpu_torch.models import global_local as gl
    from atlasqtl_tpu_torch.inference import elicitation as elic
    from atlasqtl_tpu_torch.ops import sweep_fused as sf
    from atlasqtl_tpu_torch.ops import sweep_staggered as ss
    from atlasqtl_tpu_torch.ops.sweep import block_gram

    n, p, q = PROBE_SHAPE
    x, y = simulate(n, p, q, 3, 10, 40)
    x = (x - x.mean(0)) / x.std(0, ddof=1)
    y = y - y.mean(0)
    out = {}
    for name, kw in (("probe", {}), ("stagger", dict(sweep_stagger=True)),
                     ("stagger_probe", dict(sweep_stagger=True))):
        cfg = Config(dtype=torch.float32, shr_fac_inv=float(q),
                     sweep_probe="none" if name == "stagger" else PROBE_MAIN,
                     **kw)
        gl.check_config(cfg)
        data = gl.build_data(x, y, cfg, DEVICE, q_pad_to=256)
        hyper = gl.build_hyper(elic.auto_set_hyper(y, p, (4, 16)),
                               data.y.shape[1], cfg, DEVICE)
        state = gl.build_state(elic.auto_set_init(y, p, (4, 16), float(q), 3),
                               data, cfg)
        gram = block_gram(data.x, gl.data_block(cfg, data))
        torch.cuda.synchronize()
        for c in (sf.sweep_fused, sf.sweep_fused.probe,
                  ss.sweep_fused_staggered):
            c.launches = 0
        st = gl.cavi_iteration(data, hyper, state, gram, 1.0, 1.0, cfg=cfg,
                               annealed=False)
        torch.cuda.synchronize()
        got = dict(b1=sf.sweep_fused.launches,
                   probe=sf.sweep_fused.probe.launches,
                   b4=ss.sweep_fused_staggered.launches,
                   finite=bool(torch.isfinite(st.mu_beta).all()
                               and torch.isfinite(st.theta).all()))
        want = (dict(b1=0, probe=0, b4=1) if name == "stagger"
                else dict(b1=1, probe=1, b4=0))
        if any(got[k] != v for k, v in want.items()) or not got["finite"]:
            raise AssertionError(f"probe routing, {name}: launches {got}, "
                                 f"expected {want} and finite outputs")
        out[name] = got
    return out


def b2_exact_case(ops, blk, sub, prod, names, max_abs, **where):
    """The float32 probe instance's exact sweep at window `sub` (B2's own
    schedule) held to B2's float32 instance's outputs `prod` at the
    mis_kernel phase's tolerance; the case, with whether the two agree bit
    for bit."""
    import torch
    from atlasqtl_tpu_torch.ops import sweep_missing_fused as sm
    got = sm._sweep_missing_fused_cuda(*ops, block_size=blk, sub=sub,
                                       probe="exact")
    errs = held(f"B2's exact sweep in the probe instance at window {sub} "
                f"({where}) vs B2's float32 instance", got, prod, names)
    max_abs["b2"] = max(max_abs["b2"], *errs.values())
    return dict(probe="exact", vs="production", block=blk, mis_sub=sub,
                **where, max_abs_err=max(errs.values()),
                bit_for_bit=all(torch.equal(a, b) for a, b in zip(got, prod)))


def b2_probe_rounds(ops, blk, win, mdims, rounds=PROBE_ROUNDS):
    """B2's four probes and the float32 probe instance's exact sweep at
    window `win` in `rounds` rounds of turns (`probe_turns`) beside B2's
    float32 instance ("production", the turns' baseline): each probe's ms,
    its bound (`mis_probe_bound_ms`) and share of it, its time over
    production's; the exact sweep's over production's; the implied phase
    costs (MIS_PROBE_COSTS, `implied_costs`, read against production); and
    CTA 0's phase clocks of one launch of each (sm.phase_clocks)."""
    import torch
    from atlasqtl_tpu_torch.ops import sweep_missing_fused as sm
    fns = {"none": lambda: sm.sweep_missing_fused(*ops, block_size=blk)}
    fns.update({pr: (lambda pr=pr: sm._sweep_missing_fused_cuda(
        *ops, block_size=blk, sub=win, probe=pr))
        for pr in ("exact", *sm.MIS_PROBES)})
    turns, offsets = probe_turns(fns, rounds=rounds)
    med = {k: statistics.median(v) for k, v in turns.items()}
    clocks = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        clocks["production" if name == "none" else name] = sm.phase_clocks()
    entry = dict(block=blk, window=win, rounds=rounds, exact_ms=med["exact"],
                 exact_turns=turns["exact"], production_ms=med["none"],
                 production_turns=turns["none"],
                 exact_over_production=med["exact"] / med["none"],
                 exact_bound_ms=mis_bound_ms(*mdims)[0],
                 implied_ms=implied_costs(offsets, MIS_PROBE_COSTS),
                 clocks=clocks)
    for pr in sm.MIS_PROBES:
        b, by = mis_probe_bound_ms(*mdims, pr, win)
        entry[pr] = dict(ms=med[pr], turns=turns[pr], bound_ms=b,
                         bound_by=by, pct_of_bound=pct(b, med[pr]),
                         over_production=med[pr] / med["none"])
    return entry


def b1_probe_rounds(ops, kw, sub, probes, rounds=PROBE_ROUNDS):
    """B1's probes `probes` at window `sub` in `rounds` rounds of turns
    (`probe_turns`) beside B1's float32 instance (its own launch, in its
    plan; the turns' baseline "none"): B1's ms and bound, each probe's ms,
    bound (`probe_bound_ms`) and share of it and its time over B1's; the
    implied phase costs (PROBE_COSTS, read against B1, where `probes`
    holds them all); and CTA 0's phase clocks of one launch of each
    (sf.phase_clocks)."""
    import torch
    from atlasqtl_tpu_torch.ops import sweep_fused as sf
    fns = {"none": lambda: sf.sweep_fused(*ops, **kw)}
    fns.update({pr: (lambda pr=pr: sf.sweep_fused(*ops, **kw, probe=pr,
                                                  sub=sub))
                for pr in probes})
    turns, offsets = probe_turns(fns, rounds=rounds)
    med = {k: statistics.median(v) for k, v in turns.items()}
    clocks = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        clocks["b1" if name == "none" else name] = sf.phase_clocks()
    dims = (ops[0].shape[0], ops[0].shape[1], ops[5].shape[1],
            kw["block_size"], ops[3].shape[1], kw["emit_gam_mu"])
    entry = dict(block=kw["block_size"], window=sub, rounds=rounds,
                 b1_ms=med["none"], b1_turns=turns["none"],
                 b1_bound_ms=sweep_bound_ms(*dims)[0], by_probe={},
                 clocks=clocks)
    for pr in probes:
        b, by = probe_bound_ms(*dims, sf.PROBES[pr], sub)
        entry["by_probe"][pr] = dict(
            ms=med[pr], turns=turns[pr], bound_ms=b, bound_by=by,
            pct_of_bound=pct(b, med[pr]), over_b1=med[pr] / med["none"])
    if all(pr in probes for pair in PROBE_COSTS.values() for pr in pair
           if pr != "none"):
        entry["implied_ms"] = implied_costs(offsets, PROBE_COSTS)
    return entry


def phase_probes():
    """The perf probes of B1 (Config.sweep_probe, ops/sweep_fused.py:
    PROBES, B5c) and B2 (probe=, ops/sweep_missing_fused.py:MIS_PROBES,
    B5e), each an instance of its kernel (csrc/sweep_fused.cu:
    sweep_fused_kernel<QS, false, false, PR>, PR one of 12 PrInst codes
    per width, csrc/sweep_missing_fused.cu: sweep_missing_kernel<
    FM_ON_CHIP, SUB, true>).  Parity: every B1 probe against its plain
    version at PROBE_SHAPE at each width its plan can take (32, and 40
    forced; a block over 128 only 32), blocks 128
    (window 8) and 256 (pieces of 128, window 16), c = 1 and 0.5, at the
    kernel phase's tolerance; under mxu_bf16 at block 128 by the bf16_modes
    phase's mean criterion; noseq and norank at windows 1, 2, 4 and 32
    (block 128) and 4 (block 256), and with exact_noz off the 8-row grid
    (PROBE_OFF_GRID); the probe with every part kept bit for bit B1's
    float32 instance; one probe with m = 2 replicas (held against the plain
    version, each replica bit for bit its own launch in slices of the same
    width).  Each B2 probe at mis_sub 1 to 128, f32 and pair_bf16, on chip
    and (mis_sub 16 to 128) with Fm in device memory, and in f32 at the
    windows of PROBE_MIS_ANY, at the mis_kernel phase's tolerance; at each
    of those windows the float32 probe instance's exact sweep (B2's own
    schedule) against B2's float32 instance at that tolerance, and whether
    bit for bit; noseq, noadv and noadvmask at windows 32 and 128 at
    PROBE_MIS_RANKS (a cluster of 4 at n = 1000, two replicas in one
    launch, each held on its own).  Times at the eQTL cut (PROBE_TIMED,
    block 128, converged and lite): each B1 probe in its plan beside B1's
    float32 instance in turns (B1, probe, probe, B1), median of PROBE_REPS
    launches, PROBE_ROUNDS rounds (`b1_probe_rounds`): its time over B1's
    and the implied phase costs (PROBE_COSTS, `implied_costs`: median,
    range and whether the rounds agree in sign), CTA 0's phase clocks of
    each; B1's eleven at PROBE_TIMED_32 (32 columns) and its noseq and
    norank at PROBE_OFF_GRID_WINDOWS (PROBE_OFF_GRID_TIMED) likewise; B2's four at mis_sub 16 and
    PROBE_DEEP_WINDOWS likewise, and at PROBE_MIS_OFF_TIMED off the 8-row
    grid (`b2_probe_rounds`: against B2's float32 instance, the probe
    instance's exact sweep beside it; each sweep's CTA 0 phase clocks);
    B2's pair_bf16 probe instances (noadv, noadvmask) at mis_sub 16 beside
    B2's pair_bf16 instance.  Registers and spills of the probe instances
    and of the production ones (any spill fails).  The main path:
    `probe_routing` and one B2 probe call through
    sweep_missing_fused_driver, each with the counters zeroed before."""
    import torch
    from atlasqtl_tpu_torch.ops import sweep_fused as sf
    from atlasqtl_tpu_torch.ops import sweep_missing_fused as sm

    out = {"b1": {}, "b2": {}}
    flat = lambda o: list(o[:6]) + list(o[6])
    max_abs = {"b1": 0.0, "b2": 0.0}
    regs = ptxas_summary(sf.build.ptxas_report)
    out["registers"] = {k: v for k, v in regs.items()
                        if k.startswith(("sweep_fused_kernel",
                                         "sweep_missing_kernel"))}
    # B1's probe instances: ten PrInst codes at each width (B1's chain,
    # the clipped logit, the pin, the chain without its corrections or
    # without its pushes and corrections; bf16 x or not), none spilling
    b1_inst = {k: v for k, v in regs.items() if re.fullmatch(
        r"sweep_fused_kernelILi(32|40)ELb0ELb0ELi[1-9]\d*EE", k)}
    out["b1"]["instances"] = b1_inst
    if len(b1_inst) != 10 * len(sf.FUSED_WIDTHS) or any(
            v.get("spill_stores") or v.get("spill_loads")
            for v in b1_inst.values()):
        raise AssertionError(f"B1's probe instances: {b1_inst}")

    # ---- B1: each probe against its plain version, at both widths ----
    n, p, q = PROBE_SHAPE
    cases = []

    def b1_launch(ops, kw, probe, width, x=None, bf16=False):
        return flat(sf.fused_launch(
            "atlasqtl_sweep_fused", ops[0] if x is None else x, *ops[1:],
            block_size=kw["block_size"], emit_gam_mu=True,
            c_one=kw["c_one"], bf16=bf16, probe=sf.PROBES[probe],
            window=kw["sub"], slice_width=width))

    def b1_held(label, ops, kw, probe, f_scale, **where):
        """B1's probe `probe` at each width its plan could take
        (PROBE_SHAPE's plan takes 32 columns; 40 forced; a block over 128
        only 32) against its plain version."""
        ref = flat(sf.sweep_fused_plain(*ops, **kw, probe=probe))
        widths = sf.fused_launch_plan(
            ops[0].shape[0], ops[5].shape[1], kw["block_size"],
            ops[3].shape[1], probe=True)["widths"]
        for w in widths:
            errs = held(f"{label}, {w} columns",
                        b1_launch(ops, kw, probe, w), ref, B1_NAMES,
                        scales=f_scale)
            max_abs["b1"] = max(max_abs["b1"], *errs.values())
            cases.append(dict(probe=probe, slice_width=w, **where,
                              max_abs_err=max(errs.values())))

    for block, sub in ((128, 8), (256, 16)):
        for c in (1.0, 0.5):
            ops, blk = kernel_inputs(n, p, q, c, block=block)
            kw = dict(block_size=blk, c_one=c == 1.0, sub=sub)
            # F out = F in + X delta: where a probe makes the two
            # cancel (nor0), F's rounding is that of F in's scale
            f_scale = {"fitted": float(ops[6].abs().max())}
            for probe in sf.PROBES:
                b1_held(f"B1 probe {probe} vs plain at block {blk} window "
                        f"{sub} c={c}", ops, kw, probe, f_scale, block=blk,
                        window=sub, c=c)
            # the windows where noseq and norank change: below 8 (a
            # window of 8 rows holds several), 32; 4 in pieces too
            for win in ((1, 2, 4, 32) if block == 128 else (4,)):
                if c != 1.0:
                    break
                for probe in ("noseq", "norank"):
                    b1_held(f"B1 probe {probe} block {blk} window {win}",
                            ops, dict(kw, sub=win), probe, f_scale,
                            block=blk, window=win, c=c)
            if block == 128 and c == 1.0:
                # under mxu_bf16: the kernel reads the bf16 copy of x
                x16 = ops[0].to(torch.bfloat16)
                for probe in sf.PROBES:
                    ref = sf.sweep_fused_plain(*ops, **kw, probe=probe,
                                               bf16=True)
                    f32 = sf.sweep_fused_plain(*ops, **kw, probe=probe)
                    for w in sf.FUSED_WIDTHS:
                        errs = mean_held(
                            f"B1 probe {probe} under mxu_bf16, {w} columns",
                            b1_launch(ops, kw, probe, w, x16, True),
                            flat(ref), flat(f32), b1_launch(ops, kw, probe, w),
                            B1_NAMES)
                        cases.append(dict(probe=probe, block=blk, window=sub,
                                          c=c, bf16=True, slice_width=w,
                                          mean_abs_err=max(
                                              e["mean"]
                                              for e in errs.values())))
            del ops
    # the windows off the 8-row grid (a window starts inside a chain
    # window), at blocks 48, 40, 192 (pieces of 96) and 200 (pieces of 40)
    for p_, blk_, wins in PROBE_OFF_GRID:
        ops, blk = kernel_inputs(n, p_, q, 1.0, block=blk_)
        kw = dict(block_size=blk, c_one=True)
        f_scale = {"fitted": float(ops[6].abs().max())}
        for win in wins:
            for probe in ("noseq", "norank", "exact_noz"):
                b1_held(f"B1 probe {probe} block {blk} window {win}", ops,
                        dict(kw, sub=win), probe, f_scale, block=blk,
                        window=win, c=1.0, p=ops[0].shape[1])
        del ops
    # routing: the probe with every part kept launches B1's float32
    # instance; and a probe instance that drops nothing at its window (the
    # corrections at a window of the whole block, the pushes at a window
    # of one row: B1's chain on a Gram with no entry zeroed) is B1, bit
    # for bit
    ops, blk = kernel_inputs(n, p, q, 1.0)
    for w in sf.FUSED_WIDTHS:
        kw = dict(block_size=blk, emit_gam_mu=True, c_one=True,
                  slice_width=w)
        b1 = flat(sf.fused_launch("atlasqtl_sweep_fused", *ops, **kw))
        for label, parts, win in (
                ("every part kept", sf.Probe(), 8),
                ("no corrections, window = block",
                 sf.Probe(corrections=False), blk),
                ("no pushes, window 1", sf.Probe(pushes=False), 1)):
            got = flat(sf.fused_launch("atlasqtl_sweep_fused", *ops, **kw,
                                       probe=parts, window=win))
            if not all(torch.equal(a, b) for a, b in zip(got, b1)):
                raise AssertionError(f"B1's probe ({label}) differs from "
                                     f"B1 at {w} columns")
            cases.append(dict(probe=label, vs="B1", slice_width=w,
                              bit_for_bit=True))
    del ops
    # m = 2 replicas in one launch, at each width
    data, states, gram, blk = replica_problem("b1", n, p, q, 2)
    parts, stacked = replica_operands("b1", data, states, gram, blk, 1.0)
    kw = dict(block_size=blk, c_one=True, sub=8, probe=PROBE_MAIN)
    ref = flat(sf.sweep_fused_plain(*stacked, **kw))
    lk = dict(block_size=blk, emit_gam_mu=True, c_one=True,
              probe=sf.PROBES[PROBE_MAIN], window=8)
    for w in sf.FUSED_WIDTHS:
        got = flat(sf.fused_launch("atlasqtl_sweep_fused", *stacked, **lk,
                                   slice_width=w))
        held(f"B1 probe {PROBE_MAIN}, 2 replicas, {w} columns, vs plain",
             got, ref, B1_NAMES,
             scales={"fitted": float(stacked[6].abs().max())})
        for r, ops in enumerate(parts):
            one = flat(sf.fused_launch("atlasqtl_sweep_fused", *ops, **lk,
                                       slice_width=w))
            if not all(torch.equal(a[r], b) for a, b in zip(got, one)):
                raise AssertionError(f"B1 probe replica {r} differs from "
                                     f"its own launch at {w} columns")
        cases.append(dict(probe=PROBE_MAIN, replicas=2, block=blk,
                          slice_width=w, replicas_bit_for_bit=True))
    del data, states, gram, parts, stacked
    out["b1"]["cases"] = cases

    # ---- B2: each probe against its plain version ----
    names = ("gam", "mu", "fitted", "z_row", "z_col")
    cases = []
    for i, (n2, p2, q2, frac) in enumerate(PROBE_MIS_SHAPES):
        ops, blk = mis_kernel_inputs(n2, p2, q2, 1.0, frac)
        plan = sm.missing_launch_plan(ops[0].shape[0], ops[6].shape[1], blk,
                                      ops[4].shape[1])
        prod = sm.sweep_missing_fused(*ops, block_size=blk)
        for sub in ((1, 2, 4, 8, 16, 32, 64, 128) if i == 0
                    else (16, *PROBE_DEEP_WINDOWS)):
            cases.append(b2_exact_case(ops, blk, sub, prod, names, max_abs,
                                       n=n2))
            for pb in (False, True):
                for probe in sm.MIS_PROBES:
                    kw = dict(block_size=blk, sub=sub, pair_bf16=pb,
                              probe=probe)
                    errs = held(f"B2 probe {probe} at mis_sub {sub}"
                                f"{', pair_bf16' if pb else ''} n={n2}",
                                sm.sweep_missing_fused(*ops, **kw),
                                sm.sweep_missing_fused_plain(*ops, **kw),
                                names)
                    max_abs["b2"] = max(max_abs["b2"], *errs.values())
                    cases.append(dict(probe=probe, n=n2, mis_sub=sub,
                                      pair_bf16=pb,
                                      fm_on_chip=plan["fm_on_chip"],
                                      max_abs_err=max(errs.values())))
        del ops
    for p2, blk_, wins in PROBE_MIS_ANY:
        ops, blk = mis_kernel_inputs(80, p2, 40, 1.0, 0.2, block=blk_)
        prod = sm.sweep_missing_fused(*ops, block_size=blk)
        for sub in wins:
            cases.append(b2_exact_case(ops, blk, sub, prod, names, max_abs,
                                       n=80, p=p2))
            for probe in sm.MIS_PROBES:
                kw = dict(block_size=blk, sub=sub, probe=probe)
                errs = held(f"B2 probe {probe} block {blk} window {sub}",
                            sm.sweep_missing_fused(*ops, **kw),
                            sm.sweep_missing_fused_plain(*ops, **kw), names)
                max_abs["b2"] = max(max_abs["b2"], *errs.values())
                cases.append(dict(probe=probe, n=80, p=p2, block=blk,
                                  mis_sub=sub,
                                  max_abs_err=max(errs.values())))
        del ops
    # a rank's rows and a replica's slices at a window's end
    for n2, p2, q2, m in PROBE_MIS_RANKS:
        data, states, _, blk = replica_problem("b2", n2, p2, q2, m)
        parts, stacked = replica_operands("b2", data, states, None, blk, 1.0)
        ops = parts[0] if m == 1 else stacked
        plan = sm.missing_launch_plan(n2, ops[6].shape[-1], blk,
                                      ops[4].shape[-1], m, probe="noseq",
                                      probe_window=32)
        if n2 == 1000 and plan["cluster"] < 2:
            raise AssertionError(f"B2 probe ranks: a cluster of 2 or more "
                                 f"expected at n = 1000, plan {plan}")
        for sub in (32, 128):
            for probe in ("noseq", "noadv", "noadvmask"):
                kw = dict(block_size=blk, sub=sub, probe=probe)
                got = sm.sweep_missing_fused(*ops, **kw)
                ref = sm.sweep_missing_fused_plain(*ops, **kw)
                for r in range(m):
                    one = (lambda t: t) if m == 1 else (lambda t: t[r])
                    errs = held(f"B2 probe {probe} at mis_sub {sub} n={n2} "
                                f"cluster {plan['cluster']} replica {r} of "
                                f"{m}", [one(a) for a in got],
                                [one(b) for b in ref], names)
                    max_abs["b2"] = max(max_abs["b2"], *errs.values())
                    cases.append(dict(probe=probe, n=n2, q=q2, mis_sub=sub,
                                      cluster=plan["cluster"],
                                      fm_on_chip=plan["fm_on_chip"],
                                      replicas=m, replica=r,
                                      max_abs_err=max(errs.values())))
        del data, states, parts, stacked, ops
    out["b2"]["cases"] = cases

    # ---- the main path: the counters zeroed just before each run ----
    out["b1"]["routing"] = probe_routing()
    out["b1"]["launches"] = out["b1"]["routing"]["probe"]["probe"]
    ops, blk = mis_kernel_inputs(*PROBE_MIS_SHAPES[0][:3], 1.0,
                                 PROBE_MIS_SHAPES[0][3])
    torch.cuda.synchronize()
    sm.sweep_missing_fused.launches = sm.sweep_missing_fused.probe.launches = 0
    res = sm.sweep_missing_fused(*ops, block_size=blk, sub=16,
                                 probe=PROBE_MAIN)
    torch.cuda.synchronize()
    out["b2"]["launches"] = sm.sweep_missing_fused.probe.launches
    if (out["b2"]["launches"] != 1 or sm.sweep_missing_fused.launches != 1
            or not all(bool(torch.isfinite(t).all()) for t in res)):
        raise AssertionError("B2's probe: one probe-instance launch with "
                             "finite outputs expected")
    del ops

    # ---- times at the eQTL cut, against B1's float32 instance ----
    n, p, q = PROBE_TIMED
    ops, blk = kernel_inputs(n, p, q, 1.0)
    kw = dict(block_size=blk, emit_gam_mu=False, c_one=True)
    sub = 8   # the JAX rule at n <= 2048
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    width = sf.fused_launch_plan(n, q, blk, ops[3].shape[1],
                                 sms)["slice_width"]
    entry = b1_probe_rounds(ops, kw, sub, list(sf.PROBES))
    plain = lambda: sf.sweep_fused_plain(*ops, **kw, probe=PROBE_MAIN,
                                         sub=sub)
    out["b1"]["timing"] = dict(n=n, p=p, q=q, slice_width=width, **entry,
                               plain_ms=cuda_ms(plain, 2))
    del ops
    torch.cuda.empty_cache()
    ops, blk = kernel_inputs(*PROBE_TIMED_32, 1.0)
    kw = dict(block_size=blk, emit_gam_mu=False, c_one=True)
    out["b1"]["timing"]["at_32"] = dict(
        n=ops[0].shape[0], p=ops[0].shape[1], q=ops[5].shape[1],
        slice_width=sf.fused_launch_plan(ops[0].shape[0], ops[5].shape[1],
                                         blk, ops[3].shape[1], sms,
                                         probe=True)["slice_width"],
        **b1_probe_rounds(ops, kw, sub, list(sf.PROBES)))
    del ops
    torch.cuda.empty_cache()

    # windows off the 8-row grid: noseq and norank in rounds of turns
    # against B1's float32 instance at that block
    by_window = {}
    for blk_, win in PROBE_OFF_GRID_WINDOWS:
        ops, blk = kernel_inputs(*PROBE_OFF_GRID_TIMED, 1.0, block=blk_)
        kw = dict(block_size=blk, emit_gam_mu=False, c_one=True)
        by_window[f"block {blk} window {win}"] = dict(
            n=ops[0].shape[0], p=ops[0].shape[1], q=ops[5].shape[1],
            **b1_probe_rounds(ops, kw, win, ["noseq", "norank"]))
        del ops
        torch.cuda.empty_cache()
    out["b1"]["timing"]["by_window"] = by_window

    ops, blk = mis_kernel_inputs(n, p, q, 1.0, 0.15)
    mdims = (ops[0].shape[0], ops[0].shape[1], ops[6].shape[1],
             ops[4].shape[1])
    # mis_sub 16 (the default) and the windows over 16, each in rounds of
    # turns beside the exact sweep and B2's float32 instance
    by_window = {win: b2_probe_rounds(ops, blk, win, mdims)
                 for win in (16, *PROBE_DEEP_WINDOWS)}
    e16 = by_window[16]
    out["b2"]["timing"] = dict(
        n=n, p=p, q=q, block=blk, missing_frac=0.15, mis_sub=16,
        exact_ms=e16["exact_ms"], exact_turns=e16["exact_turns"],
        production_ms=e16["production_ms"],
        exact_over_production=e16["exact_over_production"],
        exact_bound_ms=e16["exact_bound_ms"],
        by_probe={pr: e16[pr] for pr in sm.MIS_PROBES},
        implied_ms=e16["implied_ms"], clocks=e16["clocks"],
        plain_ms=cuda_ms(lambda: sm.sweep_missing_fused_plain(
            *ops, block_size=blk, sub=16, probe=PROBE_MAIN), 2))
    # the pair_bf16 probe instances at mis_sub 16 (noadv, noadvmask) beside
    # B2's pair_bf16 instance there
    pb = dict(block_size=blk, pair_bf16=True, sub=16)
    fns = {"none": lambda: sm.sweep_missing_fused(*ops, **pb)}
    fns.update({pr: (lambda pr=pr: sm.sweep_missing_fused(*ops, **pb,
                                                          probe=pr))
                for pr in ("noadv", "noadvmask")})
    turns, _ = probe_turns(fns)
    med = {k: statistics.median(v) for k, v in turns.items()}
    out["b2"]["timing"]["pair_bf16"] = dict(
        mis_sub=16, production_ms=med["none"],
        production_turns=turns["none"],
        **{pr: dict(ms=med[pr], turns=turns[pr],
                    over_production=med[pr] / med["none"])
           for pr in ("noadv", "noadvmask")})
    del ops, fns
    torch.cuda.empty_cache()
    # a window off the 8-row grid, beside B2's float32 instance at its block
    n_, p_, q_, blk_, win = PROBE_MIS_OFF_TIMED
    ops, blk = mis_kernel_inputs(n_, p_, q_, 1.0, 0.15, block=blk_)
    by_window[f"block {blk} window {win}"] = dict(
        n=n_, p=p_, q=q_, **b2_probe_rounds(
            ops, blk, win, (ops[0].shape[0], ops[0].shape[1],
                            ops[6].shape[1], ops[4].shape[1])))
    out["b2"]["timing"]["by_window"] = by_window
    del ops
    torch.cuda.empty_cache()
    out["max_abs_err"] = max_abs
    emit({"phase": "probes", **out})
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
    from atlasqtl_tpu_torch import native
    t0 = time.perf_counter()
    lib = sf.build(verbose=True)
    regs = ptxas_summary(sf.build.ptxas_report)
    t1 = time.perf_counter()
    native_lib = native.build()   # the host preparation pass, g++
    emit({"phase": "build", "seconds": t1 - t0, "library": lib.name,
          "nvcc_seconds": sf.build.seconds,
          "native_seconds": time.perf_counter() - t1,
          "native_library": native_lib.name, "ptxas": regs})
    spills = {k: v for k, v in regs.items()
              if v.get("spill_stores") or v.get("spill_loads")}
    if spills:
        raise AssertionError(f"kernels spill registers: {spills}")

    seconds = {}

    def run(name, fn, default=None):
        """Phase `name` if it was asked for, its seconds kept."""
        if name not in phases:
            return default
        t = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t
        return out

    max_abs, timing = run("kernel", phase_kernel, (None, None))
    launches = run("fit", phase_fit)
    run("eqtl", phase_eqtl)
    run("dev_init", phase_dev_init)
    mis_max_abs, mis_timing = run("mis_kernel", phase_mis_kernel,
                                  (None, None))
    mis_launches = run("missing_fit", phase_missing_fit, {})
    run("eqtl_missing", phase_eqtl_missing)
    run("block_fits", phase_block_fits)
    gs_max_abs, gs_timing = run("gs_kernel", phase_gs_kernel, (None, None))
    stag_max_abs, stag_timing = run("stag_kernel", phase_stag_kernel,
                                    (None, None))
    route_launches = run("sweeps_fit", phase_sweeps_fit, {})
    run("device_loop", phase_device_loop)
    route_profile_ = run("eqtl_sweeps", phase_eqtl_sweeps)
    run("scaling", phase_scaling)
    replica = run("replica_kernel", phase_replica_kernel,
                  ({"b1": None, "b2": None}, None))[0]
    run("a8_fit", phase_a8_fit)
    bf16 = run("bf16_modes", phase_bf16_modes)
    mesh = run("mesh", phase_mesh)
    run("mcmc", phase_mcmc)
    probes = run("probes", phase_probes)
    emit({"phase_seconds": seconds})
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
            "replica_ms": replica["b1"],
            "modes": None if bf16 is None else {
                "mxu_bf16": bf16_mode(
                    bf16["b1"], "csrc/sweep_fused.cu:sweep_fused_kernel<QS, "
                    "true, false>"),
                "mxu_bf16_lookahead": bf16_mode(
                    bf16["b1_lookahead"], "csrc/sweep_fused.cu:"
                    "sweep_lookahead_kernel<QS> (whole blocks; in pieces "
                    "sweep_fused_kernel<QS, true, true>)")}})
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
            "plan": mis_timing["plan"], "replica_ms": replica["b2"],
            "modes": None if bf16 is None else {"mis_pair_bf16": bf16_mode(
                bf16["b2"], "csrc/sweep_missing_fused.cu:"
                "sweep_missing_kernel<FM_ON_CHIP, SUB>, SUB = mis_sub")}})
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
    if probes is not None:
        t = probes["b1"]["timing"]
        main_probe = t["by_probe"][PROBE_MAIN]
        kernels.append({
            "name": "sweep_fused.probe", "route": "cuda",
            "source": "atlasqtl_tpu_torch/csrc/sweep_fused.cu",
            "replaces": "atlasqtl_tpu/ops/sweep_fused.py:68",
            "launches": probes["b1"]["launches"],
            "max_abs_err": probes["max_abs_err"]["b1"], "probe": PROBE_MAIN,
            "shape": {k: t[k] for k in ("n", "p", "q", "block")},
            "slice_width": t["slice_width"], "ms": main_probe["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": main_probe["bound_ms"],
            "bound_by": main_probe["bound_by"], "library_ms": None,
            "pct_of_bound": main_probe["pct_of_bound"], "b1_ms": t["b1_ms"],
            "ms_by_probe": {k: v["ms"] for k, v in t["by_probe"].items()},
            "over_b1": {k: v["over_b1"] for k, v in t["by_probe"].items()},
            "ms_by_window": {w: dict(b1_ms=e["b1_ms"], **{
                k: v["ms"] for k, v in e["by_probe"].items()})
                for w, e in t["by_window"].items()},
            "over_b1_by_window": {w: {k: v["over_b1"]
                                      for k, v in e["by_probe"].items()}
                                  for w, e in t["by_window"].items()},
            "implied_ms": t["implied_ms"],
            "at_32": {"shape": {k: t["at_32"][k] for k in ("n", "p", "q")},
                      "slice_width": t["at_32"]["slice_width"],
                      "b1_ms": t["at_32"]["b1_ms"],
                      "over_b1": {k: v["over_b1"] for k, v in
                                  t["at_32"]["by_probe"].items()}},
            "build_seconds": sf.build.seconds.get("sweep_fused.cu"),
            "registers": probes["b1"]["instances"]})
        t = probes["b2"]["timing"]
        main_probe = t["by_probe"][PROBE_MAIN]
        kernels.append({
            "name": "sweep_missing_fused.probe", "route": "cuda",
            "source": "atlasqtl_tpu_torch/csrc/sweep_missing_fused.cu",
            "replaces": "atlasqtl_tpu/ops/sweep_missing_fused.py:51",
            "launches": probes["b2"]["launches"],
            "max_abs_err": probes["max_abs_err"]["b2"], "probe": PROBE_MAIN,
            "shape": {k: t[k] for k in ("n", "p", "q", "block")},
            "ms": main_probe["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": main_probe["bound_ms"],
            "bound_by": main_probe["bound_by"], "library_ms": None,
            "pct_of_bound": main_probe["pct_of_bound"],
            "exact_ms": t["exact_ms"], "production_ms": t["production_ms"],
            "ms_by_probe": {k: v["ms"] for k, v in t["by_probe"].items()},
            "ms_by_window": {
                str(w): {k: (v if k.endswith("_ms") else v["ms"])
                         for k, v in e.items()
                         if k in ("exact_ms", "production_ms")
                         or isinstance(v, dict) and "ms" in v}
                for w, e in t["by_window"].items()},
            "implied_ms": t["implied_ms"]})
    if kernels:
        emit({"kernels": kernels})
    print(f"chip_smoke: wall time {time.perf_counter() - t_start:.1f} s",
          flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
