"""Checkpoint/resume for the CAVI state (counterpart of
atlasqtl_tpu/io/checkpoint.py; re-design of checkpoint_ /
checkpoint_clean_up_, R/utils.R:571-627): periodic .npz snapshots with a
rolling window of the last two, and `load_checkpoint`, which turns a
snapshot into an InitSpec for a resume through atlasqtl(...,
list_init=...).

The snapshot schema is the JAX package's, key for key and dtype for dtype
(arrays in the state's dtype, unpadded; it, converged, lb_new, diff_lb and
the names as NumPy makes them), so either package reads the other's
snapshots.  A resume restores the variational state only, not the
annealing rung (ROADMAP.md A8).
"""
from __future__ import annotations

import os

import numpy as np


class Checkpointer:
    def __init__(self, path, names_x, names_y, p, q, rate: int = 100):
        self.path = path
        self.names_x = list(names_x)
        self.names_y = list(names_y)
        self.p, self.q = p, q
        self.rate = rate

    def __call__(self, it, state, converged, lb_new, lb_old):
        if it % self.rate != 0:
            return
        p, q = self.p, self.q
        host = lambda t: t.detach().cpu().numpy()
        fname = os.path.join(self.path, f"tmp_output_it_{it}.npz")
        # (q,), or (p, q) on the exact-missing path (the JAX package keeps
        # the padded rows there: ROADMAP.md C5); cut by rank
        s2b = host(state.sig2_beta)
        sig2_beta_vb = s2b[:p, :q] if s2b.ndim == 2 else s2b[:q]
        np.savez(
            fname,
            beta_vb=host(state.gam * state.mu_beta)[:p, :q],
            gam_vb=host(state.gam)[:p, :q],
            mu_beta_vb=host(state.mu_beta)[:p, :q],
            sig2_beta_vb=sig2_beta_vb,
            tau_vb=host(state.tau)[:q],
            theta_vb=host(state.theta)[:p],
            zeta_vb=host(state.zeta)[:q],
            sig2_theta_vb=host(state.sig2_theta)[:p],
            lam2_inv_vb=host(state.lam2_inv)[:p],
            sig02_inv_vb=host(state.sig02_inv),
            converged=np.asarray(converged),
            it=np.asarray(it),
            lb_new=np.asarray(lb_new),
            diff_lb=np.asarray(abs(lb_new - lb_old)),
            names_x=np.asarray(self.names_x),
            names_y=np.asarray(self.names_y),
        )
        # rolling window: keep only the last two snapshots
        old = os.path.join(self.path,
                           f"tmp_output_it_{it - 2 * self.rate}.npz")
        if os.path.exists(old):
            os.remove(old)

    def clean_up(self):
        """Remove all snapshots at the end of a successful run
        (reference: checkpoint_clean_up_, R/utils.R:614-627)."""
        for f in os.listdir(self.path):
            if f.startswith("tmp_output_it_"):
                os.remove(os.path.join(self.path, f))


def load_checkpoint(fname):
    """Load a snapshot (of either package) into an InitSpec for a resume
    through atlasqtl(..., list_init=...)."""
    from ..inference.elicitation import InitSpec

    z = np.load(fname, allow_pickle=False)
    gam = z["gam_vb"]
    p, q = gam.shape
    # exact-missing runs store a (p, q) sig2_beta; keep it so the first
    # resumed sweep uses the same per-(j, k) variances it was saved with (a
    # JAX snapshot holds the padded rows too: only the true p are kept)
    sig2_beta = z["sig2_beta_vb"]
    if sig2_beta.ndim == 2:
        sig2_beta = sig2_beta[:p]
    return InitSpec(
        q=q, p=p, gam_vb=gam, mu_beta_vb=z["mu_beta_vb"],
        sig02_inv_vb=float(z["sig02_inv_vb"]),
        sig2_beta_vb=sig2_beta,
        sig2_theta_vb=z["sig2_theta_vb"], tau_vb=z["tau_vb"],
        theta_vb=z["theta_vb"], zeta_vb=z["zeta_vb"], auto=True,
    )
