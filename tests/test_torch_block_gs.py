"""One block of the port's B3 route (ops/sweep_pallas.py): the block
kernel's plain version `block_gs_plain`, which the CPU runs, held against
the JAX package's per-block composition in sweep_complete_pallas -- the
exact probit tiles (log_ndtr_both), the Pallas inner kernel in interpret
mode (inner_gs_pallas) and the fused Z sums (_z_block_sums).  The CUDA
kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Cases: float32 and float64; c = 1 and 0.5; B = 80 (no JAX sub-blocking),
128 and 256; q = 72 (not a multiple of the kernel's 32-column slices);
padded rows and columns masked out by p_mask and q_mask.

Tolerances: float32 gam 2e-6 and mu/delta 2e-5 (those of
tests/test_pallas.py:40-42: the JAX kernel defers the pushes of 32-row
sub-blocks to one product, so its sums run in another order), z_row and
z_col 1e-4 of their max |.|; float64 1e-10 for every output.

The route's card glue (reused buffers, row offsets, the z_row partials and
their one reduction per sweep) is also run here, with the launch replaced
by the plain block: it must give the CPU route's sweep.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from atlasqtl_tpu.ops.special import log_ndtr_both as j_log_ndtr_both
from atlasqtl_tpu.ops.sweep import _z_block_sums as j_z_block_sums
from atlasqtl_tpu.ops.sweep_pallas import inner_gs_pallas as j_inner

from atlasqtl_tpu_torch.ops import sweep_pallas as tsp
from atlasqtl_tpu_torch.ops.sweep import SweepConsts, block_gram

Q = 72        # 72 % 32 = 8: a ragged last column slice on the card
PAD_ROWS = 5  # padded predictors (p_mask 0) at the end of the block
PAD_COLS = 3  # padded responses (q_mask 0) at the end


def _block(B, q, dtype, seed):
    """One block's operands from a seed, as numpy arrays in `dtype`."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(B, B))
    pm = np.ones(B)
    pm[B - PAD_ROWS:] = 0.0
    qm = np.ones(q)
    qm[q - PAD_COLS:] = 0.0
    out = dict(r0=rng.normal(size=(B, q)), g=g @ g.T / B,
               cp=rng.normal(size=(B, q)), gam=rng.uniform(.1, .9, (B, q)),
               mu=rng.normal(size=(B, q)), theta=rng.normal(-1.5, 0.7, B),
               zeta=rng.normal(0.0, 0.5, q), pm=pm, qm=qm,
               s2=rng.uniform(.01, .1, q), tau=rng.uniform(.5, 2, q),
               logtau=rng.normal(size=q))
    return {k: v.astype(dtype) for k, v in out.items()}


ORDER = ("r0", "g", "cp", "gam", "mu", "theta", "zeta", "pm", "qm", "s2",
         "tau", "logtau")
NAMES = ("gam", "mu", "delta", "z_row", "z_col")


def _jax_block(a, c, lsi):
    """sweep_complete_pallas's step for one block (atlasqtl_tpu/ops/
    sweep_pallas.py:169-193), on the CPU: the Pallas kernel in interpret
    mode."""
    j = {k: jnp.asarray(v) for k, v in a.items()}
    log_p, log_1p = j_log_ndtr_both(j["theta"][:, None] + j["zeta"][None, :])
    gam, mu, delta = j_inner(j["r0"], j["g"], j["cp"], j["gam"], j["mu"],
                             log_p, log_1p, j["s2"], j["tau"], j["logtau"], c,
                             lsi)
    zr, zc = j_z_block_sums(gam * j["pm"][:, None] * j["qm"][None, :],
                            j["theta"], j["zeta"], j["pm"], j["qm"],
                            jnp.asarray(c, j["r0"].dtype))
    return gam, mu, delta, zr, zc


@pytest.mark.parametrize("B", [80, 128, 256])
@pytest.mark.parametrize("c", [1.0, 0.5])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_block_matches_jax_composition(dtype, c, B):
    a = _block(B, Q, dtype, seed=B + int(10 * c))
    lsi = 0.3
    ref = _jax_block(a, c, lsi)
    launches = tsp.block_gs.launches
    got = tsp.block_gs(*[torch.from_numpy(a[k]) for k in ORDER], c, lsi)
    assert tsp.block_gs.launches == launches  # CPU: the plain version
    f32 = dtype == np.float32
    for name, u, v in zip(NAMES, got, ref):
        v = np.asarray(v)
        assert u.dtype == torch.from_numpy(a["r0"]).dtype, name
        assert tuple(u.shape) == v.shape, name
        if not f32:
            tol = 1e-10
        elif name == "gam":
            tol = 2e-6
        elif name in ("mu", "delta"):
            tol = 2e-5
        else:
            tol = 1e-4 * np.abs(v).max()
        np.testing.assert_allclose(u.numpy(), v, rtol=0, atol=tol,
                                   err_msg=name)
    # the masked rows and columns add nothing to the Z sums
    assert float(got[3][B - PAD_ROWS:].abs().max()) == 0.0
    assert float(got[4][Q - PAD_COLS:].abs().max()) == 0.0


def _sweep_inputs(n, p, q, B, dtype, c, seed=5):
    """A seeded complete-data sweep's operands, as the model hands them to
    sweep_complete_pallas."""
    rng = np.random.default_rng(seed)
    t = lambda v: torch.as_tensor(v, dtype=dtype)
    x = t(rng.normal(size=(n, p)))
    gam, mu = t(rng.uniform(.1, .9, (p, q))), t(rng.normal(0, .3, (p, q)))
    pm, qm = torch.ones(p, dtype=dtype), torch.ones(q, dtype=dtype)
    pm[-3:], qm[-2:] = 0.0, 0.0
    tau = t(rng.uniform(.5, 2, q))
    # s2 ~ 1/n, as the model's sig2_beta: the sweep contracts
    consts = SweepConsts(sig2_beta=t(rng.uniform(.2, .8, q) / n), tau=tau,
                         log_tau=torch.log(tau), log_sig2_inv=t(0.2),
                         theta=t(rng.normal(-1.5, .7, p)),
                         zeta=t(rng.normal(0, .5, q)), c=t(c))
    return (x, t(rng.normal(size=(p, q))), block_gram(x, B), gam, mu,
            x @ (gam * mu), consts, B, pm, qm)


def _fake_card(monkeypatch):
    """Route the card branch of sweep_complete_pallas through the plain
    block: _launch computes block_gs_plain and writes what the kernel writes
    (gam, mu at the block's rows, delta, z_col added to, the block's z_row
    in slice 0 of the partials, zeros in the other slices)."""
    class Lib:
        @staticmethod
        def atlasqtl_inner_gs_smem(is_f64, B):
            return 1

    def launch(tiles, r0, g_b, cp, gam, mu, log_p, log_1p, theta, zeta, pm,
               qm, s2, tau, log_tau, scal, gam_out, mu_out, delta, z_col,
               zrow_part):
        assert not tiles
        out = tsp.block_gs_plain(r0, g_b, cp, gam, mu, theta, zeta, pm, qm,
                                 s2, tau, log_tau, scal[0], scal[1])
        gam_out[:], mu_out[:], delta[:] = out[:3]
        z_col += out[4]
        zrow_part.zero_()
        zrow_part[0] = out[3]

    monkeypatch.setattr(tsp, "_on_card", lambda device: True)
    monkeypatch.setattr(tsp, "_load", lambda: Lib)
    monkeypatch.setattr(tsp, "_launch", launch)
    monkeypatch.setattr(tsp, "_zrow_reduce",
                        lambda part, z_row: z_row.copy_(part.sum(0)))


@pytest.mark.parametrize("dtype,B", [(torch.float64, 80),
                                     (torch.float32, 128)])
def test_route_card_glue_matches_cpu_route(monkeypatch, dtype, B):
    args = _sweep_inputs(30, 2 * B, Q, B, dtype, 0.5)
    ref = tsp.sweep_complete_pallas(*args)
    launches = tsp.block_gs.launches
    _fake_card(monkeypatch)
    got = tsp.sweep_complete_pallas(*args)
    assert tsp.block_gs.launches == launches + 2  # one per block
    for name, u, v in zip(("gam", "mu", "fitted", "z_row", "z_col"), got,
                          ref):
        assert bool(torch.isfinite(v).all()), name
        torch.testing.assert_close(u, v, rtol=0, atol=0, msg=name)
    # the sweep leaves its inputs alone
    torch.testing.assert_close(args[5], args[0] @ (args[3] * args[4]))


def test_route_checks_operands_once_per_sweep(monkeypatch):
    """A wrong operand is refused before any launch of the sweep."""
    args = list(_sweep_inputs(30, 160, Q, 80, torch.float32, 1.0))
    _fake_card(monkeypatch)
    launches = tsp.block_gs.launches
    args[1] = args[1].double()   # cp_x_y
    with pytest.raises(ValueError, match="cp must"):
        tsp.sweep_complete_pallas(*args)
    args[1] = args[1].float().t().contiguous().t()   # column-major
    with pytest.raises(ValueError, match="cp must"):
        tsp.sweep_complete_pallas(*args)
    assert tsp.block_gs.launches == launches
