#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (atlasqtl_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases
    python3 chip_smoke.py kernel     # just the kernel-vs-plain phase

Builds the CUDA sweep kernel from the sources in this checkout, then:
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
          init and ELBO seconds, peak device memory, launches.
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


def simulate(n, p, q, seed, p_act, q_hit):
    """Gaussian genotypes, a dense planted block of effects of the first
    p_act SNPs on the first q_hit traits, unit noise."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, p))
    y = rng.standard_normal((n, q))
    y[:, :q_hit] += x[:, :p_act] @ (0.3 * rng.normal(1.0, 0.5, (p_act, q_hit)))
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
        sig2_beta=upd.sig2_beta_update(data.n, f32(0.7), tau, cc), tau=tau,
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


def phase_eqtl():
    """The eqtl_1host shape with per-stage timers wrapped around the port's
    own functions (host init, ELBO, the sweep, the iteration)."""
    import torch
    import atlasqtl_tpu_torch as at
    from atlasqtl_tpu_torch.inference import elicitation as elic
    from atlasqtl_tpu_torch.models import global_local as gl
    from atlasqtl_tpu_torch.ops import sweep_fused as sf

    n, p, q, p_act, q_hit = EQTL_SHAPE
    x, y = simulate(n, p, q, 1, p_act, q_hit)
    acc = {"init_s": 0.0, "build_state_s": 0.0, "elbo_s": 0.0}
    iter_ms, sweep_ev = [], []
    orig = dict(init=elic.auto_set_init, state=gl.build_state,
                elbo=gl.compute_elbo, it=gl.cavi_iteration,
                sweep=sf._sweep_fused_cuda)

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
        return out

    elic.auto_set_init = timed("init_s", orig["init"])
    gl.build_state = timed("build_state_s", orig["state"])
    gl.compute_elbo = timed("elbo_s", orig["elbo"])
    gl.cavi_iteration = iteration
    sf._sweep_fused_cuda = sweep  # the kernel launch, inside sweep_fused
    try:
        torch.cuda.reset_peak_memory_stats()
        sf.sweep_fused.launches = 0
        t0 = time.perf_counter()
        res = at.atlasqtl(y, x, p0=(5, 25), anneal=(1, 2, 5), maxit=10,
                          dtype=torch.float32, verbose=0, user_seed=1,
                          device=DEVICE)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        elic.auto_set_init, gl.build_state = orig["init"], orig["state"]
        gl.compute_elbo, gl.cavi_iteration = orig["elbo"], orig["it"]
        sf._sweep_fused_cuda = orig["sweep"]
    sweep_ms = [a.elapsed_time(b) for a, b in sweep_ev]
    launches = sf.sweep_fused.launches
    out = dict(phase="eqtl", n=n, p=p, q=q, anneal=[1, 2, 5], maxit=10,
               it=res.it, launches=launches,
               sweep_ms=sweep_ms, sweep_ms_median=statistics.median(sweep_ms),
               iter_ms=iter_ms, iter_ms_median=statistics.median(iter_ms),
               host_init_s=acc["init_s"], build_state_s=acc["build_state_s"],
               elbo_s=acc["elbo_s"], elbo_evals=len(res.elbo_history),
               total_s=total,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
               finite=bool(np.isfinite(res.gam_vb).all()))
    emit(out)
    if launches != res.it or not out["finite"]:
        raise AssertionError(f"eqtl phase: {launches} launches for {res.it} "
                             f"iterations, finite={out['finite']}")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    phases = sys.argv[1:] or ["kernel", "fit", "eqtl"]
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
    if "kernel" in phases:
        max_abs, timing = phase_kernel()
    if "fit" in phases:
        launches = phase_fit()
    if "eqtl" in phases:
        phase_eqtl()
    if timing is not None:
        emit({"kernels": [{
            "name": "sweep_fused", "route": "cuda",
            "source": "atlasqtl_tpu_torch/csrc/sweep_fused.cu",
            "replaces": "atlasqtl_tpu/ops/sweep_fused.py:68",
            "launches": launches, "max_abs_err": max_abs,
            "shape": {k: timing[k] for k in ("n", "p", "q", "block")},
            "mode": "converged, lite",
            "ms": timing["ms"], "kernel_ms": timing["ms"],
            "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"], "library_ms": None}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
