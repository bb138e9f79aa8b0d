"""The port's mesh (atlasqtl_tpu_torch.parallel: explicit SPMD over
torch.distributed) held against the JAX package, mirroring
tests/test_sharding.py and tests/test_multiprocess.py: W = 4 gloo
processes on localhost (tests/_torch_mesh_worker.py, started once for the
module, every case run in them) on a 1-D mesh of 4 and the 2-D (p, q)
meshes (2, 2) and (4, 1), each on complete data, exact missing, impute and
model="global".

- Three CAVI iterations and the ELBO on the mesh from the host-drawn state
  against the JAX package's single-device float64 iterations, at its own
  tolerances (tests/test_sharding.py:71-77, 141-149): gam rtol 1e-10 and
  atol 1e-12, theta and fitted rtol 1e-9, lb rtol 1e-10.
- The atlasqtl(mesh=...) fit against the port's single-process fit at the
  tolerances above (the same iterations and convergence), and for
  model="global", which converges within the fits' maxit, against the JAX
  package's single-device fit (the same iteration count and convergence,
  the values at the port's own fit tolerance against it,
  tests/test_torch_model.py); the single-process fits are held to the JAX
  package's by tests/test_torch_model.py, test_torch_missing.py and
  test_torch_global_only.py.
- The layout (p minor in the 2-D mesh), each rank's shards, to_host's full
  matrices on every rank, the device loop and annealing replicas on the
  mesh, the trace written once, and an unseeded fit of two ranks.
The parent computes the JAX side while the workers run, once per test
session: under xdist the workers that take tests of this module share it.
"""
import os
import pickle
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from filelock import FileLock

import atlasqtl_tpu as aq
from atlasqtl_tpu.types import Config as JConfig
from atlasqtl_tpu.inference import elicitation as jelic
from atlasqtl_tpu.io.prepare import prepare_data as jprepare
from atlasqtl_tpu.models import global_local as jgl
from atlasqtl_tpu.models import global_only as jgo
from atlasqtl_tpu.ops.sweep import block_gram as j_block_gram

import atlasqtl_tpu_torch as at

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_mesh_worker as W  # noqa: E402  (constants only: no main)
import _jax_mcmc as J  # noqa: E402

WORLD = 4
MESHES = ("1d", "2x2", f"{WORLD}x1")
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_torch_mesh_worker.py")
WAIT_S = 240          # each worker's own watchdog fires first (150 s)
# JAX's own tolerances for a sharded run against one device
ITER_TOL = dict(gam=dict(rtol=1e-10, atol=1e-12),
                theta=dict(rtol=1e-9, atol=1e-12),
                fitted=dict(rtol=1e-9, atol=1e-11))
# the port's fit against the JAX package's (tests/test_torch_model.py)
FIT_ATOL, FIT_LB_RTOL = 1e-6, 1e-9
JAX_FIT_CASES = ("glob",)   # the case whose fits converge within MAXIT
MCMC_NAMES = ("pip", "beta", "theta", "zeta")
# a sharded chain against the single-process chain or the JAX package's
# (tests/test_mcmc_sharded.py:46)
MCMC_ATOL = 1e-8


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_iterations(frac, missing, model):
    y, x = W.simulate(frac)
    dat = jprepare(y, x, 0.1, 1000)
    p, q = dat.x.shape[1], dat.y.shape[1]
    cfg = JConfig(dtype=jnp.float64, block_size=W.BLOCK,
                  shr_fac_inv=float(q), missing=missing)
    data = jgl.build_data(dat.x, dat.y, cfg)
    hyper = jgl.build_hyper(jelic.auto_set_hyper(dat.y, p, W.P0),
                            data.y.shape[1], cfg)
    s = jgl.build_state(jelic.auto_set_init(dat.y, p, W.P0, float(q),
                                            W.INIT_SEED), data, cfg)
    gram = j_block_gram(data.x, W.BLOCK)
    mod = jgo if model == "global" else jgl
    for _ in range(3):
        s = mod.cavi_iteration(data, hyper, s, gram, 1.0, 1.0, cfg=cfg,
                               annealed=False)
    return dict(gam=np.asarray(s.gam)[:p, :q],
                theta=np.asarray(s.theta)[:p],
                fitted=np.asarray(s.fitted)[:W.N, :q],
                lb=float(mod.compute_elbo(data, hyper, s, cfg=cfg)))


def _jax_mcmc(d):
    """The JAX package's run_gibbs on the samplers' problem
    (tests/test_mcmc_sharded.py:_build), its draws recorded and left in d
    for the workers; returns its summaries by name."""
    y, x = W.simulate(0.0, **W.MCMC_SIM)
    dat = jprepare(y, x, 0.1, 1000)
    p, q = dat.x.shape[1], dat.y.shape[1]
    cfg = JConfig(dtype=jnp.float64, block_size=W.MCMC_BLOCK,
                  shr_fac_inv=float(q))
    data = jgl.build_data(dat.x, dat.y, cfg, q_pad_to=W.MCMC_Q_PAD)
    hyper = jgl.build_hyper(jelic.auto_set_hyper(dat.y, p, W.MCMC_P0),
                            data.y.shape[1], cfg)
    rec, res = J.run_recorded("gibbs", data, hyper, cfg, W.MCMC_BLOCK,
                              **W.MCMC_GIBBS)
    J.save_sites(d / W.MCMC_DRAWS, rec)
    return dict(zip(MCMC_NAMES, res))


def _fit_kw(missing, model):
    return dict(p0=W.P0, verbose=0, user_seed=W.INIT_SEED,
                block_size=W.BLOCK, maxit=W.MAXIT, missing=missing,
                model=model)


def _summary(res):
    return dict(gam=res.gam_vb, beta=res.beta_vb, theta=res.theta_vb,
                zeta=res.zeta_vb, fitted=res.x_beta_vb, lb=res.lb_opt,
                it=res.it, converged=res.converged)


def _start_workers(d):
    """The WORLD workers on a free port, their logs in d."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for r in range(WORLD):
        with open(d / f"r{r}.log", "wb") as fh:
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, str(port), str(r), str(WORLD),
                 str(d / f"r{r}.npz")], env=env, stdout=fh,
                stderr=subprocess.STDOUT))
    return procs


def _wait(procs, deadline):
    """Wait for every worker until the deadline; kill any still running
    (no worker outlives the fixture).  Returns the logs of those that
    failed."""
    try:
        for pr in procs:
            pr.wait(timeout=max(1.0, deadline - time.time()))
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    return [pr.args[-1].replace(".npz", ".log") for pr in procs
            if pr.returncode != 0]


def _compute(d):
    """Start the workers, compute the JAX package's iterations (and its
    fits of JAX_FIT_CASES) meanwhile, wait for the workers, and keep
    everything in d.  A run whose rendezvous port was taken meanwhile
    (the free port is found before the first worker binds it) starts
    again once on another port."""
    procs = _start_workers(d)
    try:
        deadline = time.time() + WAIT_S
        jax_mcmc = _jax_mcmc(d)
        jax_iter, jax_fit = {}, {}
        for case, (frac, missing, model) in W.CASES.items():
            jax_iter[case] = _jax_iterations(frac, missing, model)
            if case in JAX_FIT_CASES:
                y, x = W.simulate(frac)
                jax_fit[case] = _summary(aq.atlasqtl(
                    y, x, dtype=jnp.float64, **_fit_kw(missing, model)))
        failed = _wait(procs, deadline)
    finally:
        _wait(procs, 0.0)
    logs = [open(f, errors="replace").read() for f in failed]
    if logs and any("Address already in use" in lg for lg in logs):
        failed = _wait(_start_workers(d), time.time() + WAIT_S)
        logs = [open(f, errors="replace").read() for f in failed]
    assert not logs, f"mesh worker failed:\n{logs[0][-4000:]}"
    with open(d / "refs.pkl", "wb") as fh:
        pickle.dump((jax_iter, jax_fit), fh)
    with open(d / "mcmc_ref.pkl", "wb") as fh:
        pickle.dump(jax_mcmc, fh)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four workers' results (one dict per rank), the JAX package's
    iterations and fits, the port's single-process fits (made by the
    workers) and the run's directory.  Computed once per test session:
    the xdist workers that take tests of this module share one directory
    under a file lock, the first one computes (`_compute`) and the others
    read it."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent   # the session's, shared by the xdist workers
    d = root / "torch_mesh"
    with FileLock(str(root / "torch_mesh.lock")):
        if not (d / "done").exists() and not (d / "failed").exists():
            d.mkdir(exist_ok=True)
            try:
                _compute(d)
            except BaseException as e:
                (d / "failed").write_text(f"{type(e).__name__}: {e}")
                raise
            (d / "done").touch()
    if (d / "failed").exists():
        pytest.fail("the mesh run failed: " + (d / "failed").read_text())
    ranks = [dict(np.load(d / f"r{r}.npz")) for r in range(WORLD)]
    with open(d / "refs.pkl", "rb") as fh:
        jax_iter, jax_fit = pickle.load(fh)
    port_fit = {key: _fit_of(rank, f"single__{key}") for rank in ranks
                for key in (*W.CASES, "replicas")
                if f"single__{key}__fit__it" in rank}
    port_fit["full_output"] = {
        k[len("single_full_output__"):]: v for k, v in ranks[-1].items()
        if k.startswith("single_full_output__")}
    return ranks, jax_iter, jax_fit, port_fit, d


def _held(got, ref, tol, label):
    for name, kw in tol.items():
        np.testing.assert_allclose(got[name], ref[name], **kw,
                                   err_msg=f"{label}: {name}")


def _fit_of(rank, key):
    pre = f"{key}__fit__"
    return {k[len(pre):]: v for k, v in rank.items() if k.startswith(pre)}


@pytest.mark.parametrize("case", list(W.CASES))
@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_iterations_match_jax(runs, mesh, case):
    """Three iterations and the ELBO on the mesh equal the JAX package's
    single-device float64 iterations at its sharding tolerances, on every
    rank (gathered)."""
    ranks, jax_iter = runs[0], runs[1]
    ref = jax_iter[case]
    for r, rank in enumerate(ranks):
        pre = f"{mesh}__{case}__iter__"
        got = {k[len(pre):]: v for k, v in rank.items()
               if k.startswith(pre)}
        _held(got, ref, ITER_TOL, f"rank {r}, {mesh}, {case}")
        np.testing.assert_allclose(float(got["lb"]), ref["lb"], rtol=1e-10)


@pytest.mark.parametrize("case", list(W.CASES))
@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_fit_matches_one_process_and_jax(runs, mesh, case):
    """atlasqtl(mesh=...) takes the port's single-process fit's iterations
    and convergence and its values at the sharding tolerances, and (on
    JAX_FIT_CASES) the JAX package's iteration count and convergence and
    its values at the port's fit tolerance against it; every rank returns
    the same full matrices."""
    ranks, _, jax_fit, port_fit, _ = runs
    fits = [_fit_of(rank, f"{mesh}__{case}") for rank in ranks]
    one, got = port_fit[case], fits[0]
    assert int(got["it"]) == int(one["it"])
    assert bool(got["converged"]) == bool(one["converged"])
    _held(got, one, ITER_TOL, f"{mesh}, {case} against one process")
    np.testing.assert_allclose(float(got["lb"]), one["lb"], rtol=1e-10)
    if case in jax_fit:
        ref = jax_fit[case]
        assert int(got["it"]) == ref["it"] and ref["converged"]
        assert bool(got["converged"]) == ref["converged"]
        for name in ("gam", "beta", "theta", "zeta"):
            np.testing.assert_allclose(got[name], ref[name], rtol=0,
                                       atol=FIT_ATOL, err_msg=name)
        np.testing.assert_allclose(float(got["lb"]), ref["lb"],
                                   rtol=FIT_LB_RTOL)
    for other in fits[1:]:
        for name in ("gam", "beta", "theta", "zeta", "fitted", "lb"):
            np.testing.assert_array_equal(other[name], got[name],
                                          err_msg=name)


def test_2d_mesh_p_axis_is_minor(runs):
    """make_mesh lays the ranks out as the JAX package does
    (devices.reshape(-1, p_shards).T): p varies fastest, so a p-pipeline
    column is consecutive ranks; each rank sits where the layout says."""
    ranks = runs[0]
    layout = ranks[0]["layout__2x2"]
    assert layout.shape == (2, 2)
    for qcol in range(2):
        assert layout[1, qcol] == layout[0, qcol] + 1
    for r, rank in enumerate(ranks):
        np.testing.assert_array_equal(rank["layout__2x2"], layout)
        pi, qi = rank["layout__coords"]
        assert layout[pi, qi] == r


def test_shards_are_the_rank_slices(runs):
    """On the (2, 2) mesh each rank's shards of the data and the state are
    its contiguous (p, q) slices of the full arrays (x by p, y and fitted
    by q, the pair Grams by both, the scalars whole)."""
    for rank in runs[0]:
        assert rank["shards__2x2"].all(), rank["shards__2x2"]


def test_to_host_returns_full_matrices_on_every_rank(runs):
    """to_host gathers every rank's shards back into the full state,
    bit for bit."""
    for rank in runs[0]:
        assert rank["to_host__2x2"].all(), rank["to_host__2x2"]


def test_device_loop_and_replicas_on_the_mesh(runs):
    """The device loop (control on tensors, here on the CPU) gives the host
    loop's fit on the 1-D mesh; annealing replicas on the mesh, stepped one
    after another, give the single-process replica fit."""
    ranks, _, _, port_fit, _ = runs
    for rank in ranks:
        host, loop = _fit_of(rank, "1d__complete"), _fit_of(rank, "1d__loop")
        assert int(loop["it"]) == int(host["it"])
        _held(loop, host, ITER_TOL, "device loop")
        rep = _fit_of(rank, "1d__replicas")
        one = port_fit["replicas"]
        assert int(rep["it"]) == int(one["it"])
        _held(rep, one, ITER_TOL, "replicas")


def test_full_output_on_the_mesh(runs):
    """full_output=True on the 1-D mesh (the replica fit): the reference's
    named quantities from the gathered state, those of the single-process
    fit."""
    ranks, _, _, port_fit, _ = runs
    one = port_fit["full_output"]
    for rank in ranks:
        got = {k[len("full_output__"):]: v for k, v in rank.items()
               if k.startswith("full_output__")}
        assert sorted(got) == sorted(one)
        for k, v in one.items():
            np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                       np.asarray(v, np.float64),
                                       rtol=1e-9, atol=1e-12, err_msg=k)


def test_trace_written_by_the_first_rank(runs):
    d = runs[4]
    files = sorted(os.listdir(d / "trace"))
    assert "traces_top_local_x_global_parameters.csv" in files


def test_unseeded_fit_agrees_on_both_ranks(runs):
    """An unseeded fit on a mesh of two ranks draws one initial state (the
    first rank's seed), so both ranks return the same fit."""
    ranks = runs[0]
    a, b = _fit_of(ranks[0], "pair__unseeded"), _fit_of(ranks[1],
                                                         "pair__unseeded")
    assert a and b and not _fit_of(ranks[2], "pair__unseeded")
    for name in ("gam", "theta", "zeta", "lb", "it"):
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


@pytest.fixture(scope="module")
def mcmc_ref(runs):
    """The JAX package's run_gibbs summaries on the samplers' problem."""
    with open(runs[4] / "mcmc_ref.pkl", "rb") as fh:
        return pickle.load(fh)


def _mcmc_of(rank, key):
    return {n: rank[f"mcmc__{key}__{n}"] for n in MCMC_NAMES}


@pytest.mark.parametrize("mesh", W.MCMC_MESHES)
def test_sharded_gibbs_matches_one_process_and_jax(runs, mcmc_ref, mesh):
    """run_gibbs_sharded equals the port's single-process run_gibbs from the
    same seed (draws made at the full q width on every rank), and, from
    the JAX package's recorded draws, JAX's run_gibbs; every rank returns
    the full summaries."""
    ranks, ref = runs[0], mcmc_ref
    for r, rank in enumerate(ranks):
        one = _mcmc_of(rank, "single__gibbs")
        own = _mcmc_of(rank, f"{mesh}__gibbs")
        jx = _mcmc_of(rank, f"{mesh}__gibbs_jax_draws")
        for n in MCMC_NAMES:
            assert own[n].shape == ref[n].shape
            np.testing.assert_allclose(own[n], one[n], rtol=0,
                                       atol=MCMC_ATOL, err_msg=f"{r} {n}")
            np.testing.assert_allclose(jx[n], ref[n], rtol=0,
                                       atol=MCMC_ATOL, err_msg=f"{r} {n}")
        assert one["pip"].sum() > 0


@pytest.mark.parametrize("sampler", ["nuts", "smc"])
@pytest.mark.parametrize("mesh", W.MCMC_MESHES)
def test_sharded_nuts_and_smc_match_one_process(runs, mesh, sampler):
    """run_nuts_sharded (the tree replicated on every rank from the q-summed
    and gathered Z sums) equals the port's single-process run_nuts, and
    run_smc on the shards (its log-likelihood summed over the q group)
    equals run_smc, log evidence too."""
    for r, rank in enumerate(runs[0]):
        one = _mcmc_of(rank, f"single__{sampler}")
        got = _mcmc_of(rank, f"{mesh}__{sampler}")
        for n in MCMC_NAMES:
            np.testing.assert_allclose(got[n], one[n], rtol=0,
                                       atol=MCMC_ATOL, err_msg=f"{r} {n}")
        if sampler == "smc":
            key = "mcmc__{}__smc__log_evidence"
            np.testing.assert_allclose(rank[key.format(mesh)],
                                       rank[key.format("single")],
                                       rtol=1e-12)
