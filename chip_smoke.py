#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (atlasqtl_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                 # all phases
    python3 chip_smoke.py kernel mis_kernel   # just the kernel-vs-plain phases

Builds the CUDA sweep kernels from the sources in this checkout (one nvcc
per source, started together), then:
  kernel  the kernel against its plain PyTorch version on the card, float32,
          one sweep each, identical inputs, all four mode pairs
          (converged/annealed x full/lite), at four shapes (ragged q;
          n % 8 != 0 with block 80; the fit phase's shape; the eQTL n and q);
          times both;
  fit     atlasqtl() at the sim_anneal shape of BASELINE.json (n=300,
          p=2000, q=500, anneal=(1, 2, 10)) to convergence: the kernel
          launches once per iteration and the hotspot AUC of theta_vb
          against the simulation's active SNPs is >= 0.95; a small fit on
          the card in float32 agrees with the CPU float64 fit;
  eqtl    atlasqtl() at the eqtl_1host shape (n=1000, p=50000, q=10000),
          anneal=(1, 2, 5), maxit=10: ms per sweep and per iteration, host
          init and ELBO seconds, peak device memory, launches;
  mis_kernel  the exact-missing kernel (B2) against its plain version,
          float32, c = 1 and c = 0.5, seeded MCAR missingness, at four
          shapes (ragged q; n % 8 != 0 with block 80; the fit shape; the
          eQTL n and q); times both at the two largest;
  missing_fit  atlasqtl() at the sim_anneal shape with 15% of Y missing,
          missing="exact" (B2 launches once per iteration) and "impute" (B1
          does), each to convergence with hotspot AUC >= 0.95; a small fit
          on the card in float32 agrees with the CPU float64 fit, both modes;
  eqtl_missing  the eqtl phase with 15% of Y missing, once per mode.
Each phase prints one JSON line; then a `kernels` line, and last the
contract line {"ok": true, "device": {...}}.  Any failure exits non-zero
before that line.  Imports torch, NumPy, SciPy and the port only.
"""
import json
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
MIS_SHAPES = ((80, 250, 40, 0.2), (300, 75, 48, 0.15), (300, 2000, 500, 0.15),
              (1000, 2048, 10000, 0.15))   # n, p, q, missing fraction
PHASES = ("kernel", "fit", "eqtl", "mis_kernel", "missing_fit",
          "eqtl_missing")
DEVICE = "cuda"
FIT_SHAPE = (300, 2000, 500, 20, 100)     # n, p, q, active SNPs, hit traits
EQTL_SHAPE = (1000, 50000, 10000, 500, 2000)


def emit(obj):
    print(json.dumps(obj), flush=True)


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


def phase_kernel():
    import torch
    from atlasqtl_tpu_torch.ops import sweep_fused as sf

    names = ("beta", "gam", "mu", "fitted", "z_row", "z_col", "gcol",
             "m2gcol", "b2col")
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
            if (n, p, q) == KERNEL_SHAPES[-1] and c_one and not emit_gm:
                timing = case  # the steady-state (converged, lite) sweep
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
            case = dict(n=n, p=p, q=q, missing_frac=frac, block=block, c=c,
                        max_abs_err=errs)
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
                timing = case  # the last timed case is the eQTL-cut shape
            cases.append(case)
            del ops, got, ref
            torch.cuda.empty_cache()
    emit({"phase": "mis_kernel", "window": w, "cases": cases,
          "max_abs_err": max_abs})
    return max_abs, timing


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


def eqtl_run(phase, x, y, launch_mod, launch_fn, counter, bound, **fit_kw):
    """One atlasqtl() at the eQTL shape with per-stage timers wrapped around
    the port's own functions (host init, state building, ELBO, the kernel
    launch `launch_mod.launch_fn`, the iteration); `counter` is the
    launching wrapper, whose count is set to 0 just before the fit;
    bound(args, kwargs) gives a launch's bound_ms from its operands."""
    import torch
    import atlasqtl_tpu_torch as at
    from atlasqtl_tpu_torch.inference import elicitation as elic
    from atlasqtl_tpu_torch.models import global_local as gl

    n, p = x.shape
    q = y.shape[1]
    acc = {"init_s": 0.0, "build_state_s": 0.0, "elbo_s": 0.0}
    iter_ms, sweep_ev, bounds = [], [], []
    orig = dict(init=elic.auto_set_init, state=gl.build_state,
                elbo=gl.compute_elbo, it=gl.cavi_iteration,
                sweep=getattr(launch_mod, launch_fn))

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

    def sweep(*a, **k):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = orig["sweep"](*a, **k)
        ev[1].record()
        sweep_ev.append(ev)
        bounds.append(bound(a, k))
        return out

    elic.auto_set_init = timed("init_s", orig["init"])
    gl.build_state = timed("build_state_s", orig["state"])
    gl.compute_elbo = timed("elbo_s", orig["elbo"])
    gl.cavi_iteration = iteration
    setattr(launch_mod, launch_fn, sweep)  # the launch, inside the wrapper
    try:
        torch.cuda.reset_peak_memory_stats()
        counter.launches = 0
        t0 = time.perf_counter()
        res = at.atlasqtl(y, x, p0=(5, 25), anneal=(1, 2, 5), maxit=10,
                          dtype=torch.float32, verbose=0, user_seed=1,
                          device=DEVICE, **fit_kw)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        elic.auto_set_init, gl.build_state = orig["init"], orig["state"]
        gl.compute_elbo, gl.cavi_iteration = orig["elbo"], orig["it"]
        setattr(launch_mod, launch_fn, orig["sweep"])
    sweep_ms = [a.elapsed_time(b) for a, b in sweep_ev]
    launches = counter.launches
    out = dict(phase=phase, **fit_kw, n=n, p=p, q=q, anneal=[1, 2, 5],
               maxit=10, it=res.it, launches=launches,
               sweep_ms=sweep_ms, sweep_ms_median=statistics.median(sweep_ms),
               sweep_bound_ms=bounds,
               iter_ms=iter_ms, iter_ms_median=statistics.median(iter_ms),
               host_init_s=acc["init_s"], build_state_s=acc["build_state_s"],
               elbo_s=acc["elbo_s"], elbo_evals=len(res.elbo_history),
               total_s=total,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
               finite=bool(np.isfinite(res.gam_vb).all()))
    emit(out)
    if launches != res.it or not out["finite"]:
        raise AssertionError(f"{phase} phase: {launches} launches for "
                             f"{res.it} iterations, finite={out['finite']}")


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
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": lib.name})

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
            "bound_by": mis_timing["bound_by"], "library_ms": None})
    if kernels:
        emit({"kernels": kernels})
    print(f"chip_smoke: wall time {time.perf_counter() - t_start:.1f} s",
          flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
