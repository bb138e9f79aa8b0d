"""Subprocess body of tests/test_torch_mesh.py: one of W gloo processes on
localhost running every case of the port's mesh (atlasqtl_tpu_torch
.parallel) once, and writing what the parent compares to one .npz.

Imports torch, NumPy and the port only (no JAX): the parent computes the
JAX package's side.  Every rank builds the three meshes of the module, a
1-D mesh of W, the 2-D (2, W/2) and (W, 1) meshes, and a 1-D mesh of the
first two ranks (torch.distributed.new_group is collective), and on each
runs, per case (complete data, exact missing, impute, model="global"):
three CAVI iterations and the ELBO from the host-drawn state (gathered),
and an atlasqtl() fit; rank r also fits case r in one process (no mesh).
Then the samplers (atlasqtl_tpu_torch.mcmc) on the 1-D and (2, 2) meshes:
run_gibbs_sharded from the port's own draws and from the JAX package's
(recorded by the parent, which writes them to MCMC_DRAWS meanwhile),
run_nuts_sharded and run_smc on the shards, beside the single-process
runs.

Usage: python _torch_mesh_worker.py <port> <rank> <world> <out.npz>
(the parent imports it for its constants and `simulate`).
"""
import faulthandler
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import atlasqtl_tpu_torch as at  # noqa: E402
from atlasqtl_tpu_torch.inference import elicitation as elic  # noqa: E402
from atlasqtl_tpu_torch.mcmc.draws import ArrayDraws  # noqa: E402
from atlasqtl_tpu_torch.mcmc.gibbs import run_gibbs  # noqa: E402
from atlasqtl_tpu_torch.mcmc.nuts import run_nuts  # noqa: E402
from atlasqtl_tpu_torch.mcmc.sharded import (  # noqa: E402
    run_gibbs_sharded, run_nuts_sharded, shard_data_by_traits)
from atlasqtl_tpu_torch.mcmc.smc import run_smc  # noqa: E402
from atlasqtl_tpu_torch.io.prepare import prepare_data  # noqa: E402
from atlasqtl_tpu_torch.models import global_local as gl  # noqa: E402
from atlasqtl_tpu_torch.models import global_only as go  # noqa: E402
from atlasqtl_tpu_torch.ops.sweep import block_gram  # noqa: E402
from atlasqtl_tpu_torch.parallel import mesh as pmesh  # noqa: E402

# the problem of every case (tests/test_torch_mesh.py: PROBLEM, CASES)
N, P, P_ACT, Q, SEED = 80, 48, 6, 32, 3
P0, INIT_SEED, BLOCK, MAXIT = (3, 10), 42, 16, 30
CASES = dict(complete=(0.0, "exact", "global_local"),
             exact=(0.2, "exact", "global_local"),
             impute=(0.2, "impute", "global_local"),
             glob=(0.0, "exact", "global"))

# the samplers' problem, tests/test_mcmc_sharded.py:_build (q padded to 64,
# 16 columns per shard on the 1-D mesh), their runs, and the file in which
# the parent leaves the JAX package's recorded draws of MCMC_GIBBS
MCMC_SIM = dict(n=100, p=32, p_act=5, q=16, seed=11)
MCMC_BLOCK, MCMC_Q_PAD, MCMC_P0 = 16, 64, (4, 12)
MCMC_GIBBS = dict(n_samples=3, n_burnin=2, seed=5)
MCMC_NUTS = dict(n_samples=2, n_burnin=2, seed=5)
MCMC_SMC = dict(n_particles=3, anneal=(1, 2, 2), n_mutations=1, n_final=2,
                seed=5)
MCMC_MESHES = ("1d", "2x2")
MCMC_DRAWS = "jax_mcmc_draws.npz"
MCMC_WAIT_S = 100

T0 = time.time()


def mark(msg):
    print(f"[mesh-worker +{time.time() - T0:.1f}s] {msg}", flush=True)


def simulate(missing_frac, n=N, p=P, p_act=P_ACT, q=Q, seed=SEED):
    """tests/conftest.py:simulate_fixture (inlined: conftest imports
    JAX's environment machinery)."""
    rng = np.random.default_rng(seed)
    x = rng.binomial(2, 0.2, size=(n, p)).astype(np.float64)
    beta = np.zeros((p, q))
    beta[:p_act] = rng.normal(1.0, 0.5, size=(p_act, q))
    y = x @ beta + rng.normal(size=(n, q))
    if missing_frac > 0:
        mask = rng.uniform(size=y.shape) < missing_frac
        y = y.copy()
        y[mask] = np.nan
    return y, x


def iterations(mesh, y, x, missing, model):
    """Three CAVI iterations and the ELBO on the mesh from the host-drawn
    state (user seed INIT_SEED), gathered to full matrices."""
    dat = prepare_data(y, x, 0.1, 1000)
    p, q = dat.x.shape[1], dat.y.shape[1]
    cfg = at.Config(dtype=torch.float64, block_size=BLOCK,
                    shr_fac_inv=float(q), missing=missing,
                    q_axis=pmesh.Q_AXIS,
                    p_axis=pmesh.P_AXIS if pmesh.has_p(mesh) else None)
    data = gl.build_data(dat.x, dat.y, cfg, "cpu",
                         q_pad_to=pmesh.q_pad_multiple(mesh),
                         p_shards=mesh.n_p)
    hyper = gl.build_hyper(elic.auto_set_hyper(dat.y, p, P0),
                           data.y.shape[1], cfg, "cpu")
    state = gl.build_state(elic.auto_set_init(dat.y, p, P0, float(q),
                                              INIT_SEED), data, cfg)
    data_s = pmesh.shard_data(data, mesh)
    hyper_s = pmesh.shard_hyper(hyper, mesh)
    st = pmesh.shard_state(state, mesh)
    gram = (block_gram(data_s.x, BLOCK) if data_s.x_norm_sq is None
            else None)
    mod = go if model == "global" else gl
    for _ in range(3):
        st = mod.cavi_iteration(data_s, hyper_s, st, gram, 1.0, 1.0,
                                cfg=cfg, annealed=False, block=BLOCK)
    lb = float(mod.compute_elbo(data_s, hyper_s, st, cfg=cfg))
    full = pmesh.to_host(st, mesh)
    return dict(gam=full.gam[:p, :q].numpy(), theta=full.theta[:p].numpy(),
                fitted=full.fitted[:N, :q].numpy(), lb=lb)


def summary(res):
    return dict(gam=res.gam_vb, beta=res.beta_vb, theta=res.theta_vb,
                zeta=res.zeta_vb, fitted=res.x_beta_vb, lb=res.lb_opt,
                it=res.it, converged=res.converged)


def fit(mesh, y, x, missing, model, **kw):
    return summary(at.atlasqtl(
        y, x, p0=P0, dtype=torch.float64, verbose=0, device="cpu",
        block_size=BLOCK, maxit=MAXIT, missing=missing, model=model,
        mesh=mesh, **dict(dict(user_seed=INIT_SEED), **kw)))


def replica_fit(mesh, y, x, **kw):
    """Two annealing replicas with the full output, complete data."""
    return at.atlasqtl(y, x, p0=P0, dtype=torch.float64, verbose=0,
                       device="cpu", block_size=BLOCK, maxit=MAXIT,
                       user_seed=INIT_SEED, mesh=mesh, anneal_replicas=2,
                       full_output=True, **kw)


def mcmc_problem():
    """The samplers' (data, hyper, cfg), float64 on the CPU."""
    y, x = simulate(0.0, **MCMC_SIM)
    dat = prepare_data(y, x, 0.1, 1000)
    p, q = dat.x.shape[1], dat.y.shape[1]
    cfg = at.Config(dtype=torch.float64, block_size=MCMC_BLOCK,
                    shr_fac_inv=float(q))
    data = gl.build_data(dat.x, dat.y, cfg, "cpu", q_pad_to=MCMC_Q_PAD)
    hyper = gl.build_hyper(elic.auto_set_hyper(dat.y, p, MCMC_P0),
                           data.y.shape[1], cfg, "cpu")
    return data, hyper, cfg


def jax_draws(path):
    """The JAX package's recorded draws, once the parent has written them
    (tests/_jax_mcmc.py:save_sites), as ArrayDraws."""
    deadline = time.time() + MCMC_WAIT_S
    while not os.path.exists(path):
        if time.time() > deadline:
            raise TimeoutError(f"no {path} after {MCMC_WAIT_S} s")
        time.sleep(0.2)
    sites = {}
    with np.load(path) as f:
        for k in sorted(f.files):
            sites.setdefault(k.rsplit("__", 1)[0], []).append(f[k])
    return ArrayDraws(sites, "cpu", torch.float64)


def mcmc_cases(meshes, outdir, out):
    """run_gibbs_sharded (the port's own draws, and the JAX package's),
    run_nuts_sharded and run_smc on the shards of each of MCMC_MESHES, and
    the single-process runs."""
    data, hyper, cfg = mcmc_problem()
    names = ("pip", "beta", "theta", "zeta")
    runs = {"single__gibbs": run_gibbs(data, hyper, cfg, **MCMC_GIBBS),
            "single__nuts": run_nuts(data, hyper, cfg, **MCMC_NUTS),
            "single__smc": run_smc(data, hyper, cfg, **MCMC_SMC)}
    for m in MCMC_MESHES:
        mesh = meshes[m]
        runs[f"{m}__gibbs"] = run_gibbs_sharded(data, hyper, cfg, mesh,
                                                **MCMC_GIBBS)
        runs[f"{m}__gibbs_jax_draws"] = run_gibbs_sharded(
            data, hyper, cfg, mesh, **MCMC_GIBBS,
            draws=jax_draws(os.path.join(outdir, MCMC_DRAWS)))
        runs[f"{m}__nuts"] = run_nuts_sharded(data, hyper, cfg, mesh,
                                              **MCMC_NUTS)
        runs[f"{m}__smc"] = run_smc(*shard_data_by_traits(data, hyper, mesh),
                                    cfg, **MCMC_SMC)
    for key, res in runs.items():
        for name, v in zip(names + ("log_evidence",), res):
            out[f"mcmc__{key}__{name}"] = v


def main(port, rank, world, outfile):
    mark("initializing gloo")
    at.initialize_distributed(init_method=f"tcp://localhost:{port}",
                              world_size=world, rank=rank, device="cpu")
    meshes = {"1d": pmesh.make_mesh(),
              "2x2": pmesh.make_mesh(p_shards=2),
              f"{world}x1": pmesh.make_mesh(p_shards=world)}
    pair = pmesh.make_mesh([0, 1])
    mark(f"meshes built: {meshes}")
    out = {}
    m2 = meshes["2x2"]
    out["layout__2x2"] = np.asarray(m2.devices)
    out["layout__coords"] = np.asarray([m2.p_index, m2.q_index])

    # each rank's shards are its slices of the full arrays, and to_host
    # gathers them back whole
    y, x = simulate(0.2)
    dat = prepare_data(y, x, 0.1, 1000)
    cfg = at.Config(dtype=torch.float64, block_size=BLOCK,
                    shr_fac_inv=float(Q), q_axis="q", p_axis="p")
    data = gl.build_data(dat.x, dat.y, cfg, "cpu", q_pad_to=16, p_shards=2)
    state = gl.build_state(elic.auto_set_init(dat.y, P, P0, float(Q), 1),
                           data, cfg)
    ds, ss = pmesh.shard_data(data, m2), pmesh.shard_state(state, m2)
    pl, ql = data.x.shape[1] // 2, data.y.shape[1] // 2
    rows = slice(m2.p_index * pl, (m2.p_index + 1) * pl)
    cols = slice(m2.q_index * ql, (m2.q_index + 1) * ql)
    checks = [torch.equal(ss.gam, state.gam[rows, cols]),
              torch.equal(ss.sig2_beta, state.sig2_beta[rows, cols]),
              torch.equal(ss.fitted, state.fitted[:, cols]),
              torch.equal(ss.theta, state.theta[rows]),
              torch.equal(ss.tau, state.tau[cols]),
              torch.equal(ss.sig02_inv, state.sig02_inv),
              torch.equal(ds.x, data.x[:, rows]),
              torch.equal(ds.y, data.y[:, cols]),
              torch.equal(ds.cp_x_y, data.cp_x_y[rows, cols]),
              torch.equal(ds.mis_pair_gram, data.mis_pair_gram[
                  m2.p_index * pl // 8:(m2.p_index + 1) * pl // 8, :, cols]),
              all(v.is_contiguous() for v in (ss.gam, ss.fitted, ds.x, ds.y))]
    out["shards__2x2"] = np.asarray(checks)
    back = pmesh.to_host(ss, m2)
    out["to_host__2x2"] = np.asarray([torch.equal(getattr(back, f),
                                                  getattr(state, f))
                                      for f in ("gam", "sig2_beta", "fitted",
                                                "theta", "tau", "zeta")])
    mark("placement checked")

    for mname, mesh in meshes.items():
        for case, (frac, missing, model) in CASES.items():
            y, x = simulate(frac)
            for k, v in iterations(mesh, y, x, missing, model).items():
                out[f"{mname}__{case}__iter__{k}"] = v
            for k, v in fit(mesh, y, x, missing, model).items():
                out[f"{mname}__{case}__fit__{k}"] = v
            mark(f"{mname} {case} done")

    # the 1-D mesh's device loop on the CPU, annealing replicas, the trace
    # written by the first rank only and the full output
    y, x = simulate(0.0)
    for k, v in fit(meshes["1d"], y, x, "exact", "global_local",
                    device_loop="on").items():
        out[f"1d__loop__fit__{k}"] = v
    trace_dir = os.path.join(os.path.dirname(outfile), "trace")
    os.makedirs(trace_dir, exist_ok=True)
    res = replica_fit(meshes["1d"], y, x, trace_path=trace_dir)
    for k, v in summary(res).items():
        out[f"1d__replicas__fit__{k}"] = v
    for k, v in res.full_output.items():
        if isinstance(v, np.ndarray) or np.isscalar(v):
            out[f"full_output__{k}"] = np.asarray(v)
    mark("loop, replicas, trace and full output done")
    # the single-process fits the parent holds the mesh's to, one per rank
    cases = list(CASES)
    if rank < len(cases):
        frac, missing, model = CASES[cases[rank]]
        y1, x1 = simulate(frac)
        for k, v in fit(None, y1, x1, missing, model).items():
            out[f"single__{cases[rank]}__fit__{k}"] = v
    if rank == world - 1:
        res = replica_fit(None, y, x)
        for k, v in summary(res).items():
            out[f"single__replicas__fit__{k}"] = v
        for k, v in res.full_output.items():
            if isinstance(v, np.ndarray) or np.isscalar(v):
                out[f"single_full_output__{k}"] = np.asarray(v)
    # an unseeded fit on the mesh of the first two ranks
    if pair.member:
        for k, v in fit(pair, y, x, "exact", "global_local",
                        user_seed=None).items():
            out[f"pair__unseeded__fit__{k}"] = v
    mcmc_cases(meshes, os.path.dirname(outfile), out)
    mark("samplers done")
    mark("saving")
    np.savez(outfile, **out)
    torch.distributed.destroy_process_group()
    faulthandler.cancel_dump_traceback_later()
    mark("done")


if __name__ == "__main__":
    # a worker that hangs in a collective dumps its stacks and exits
    # non-zero
    faulthandler.dump_traceback_later(
        int(os.environ.get("MESH_WATCHDOG_S", "150")), exit=True)
    torch.set_num_threads(1)
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
