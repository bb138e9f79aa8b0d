"""Hotspot-variance trace diagnostics (counterpart of
atlasqtl_tpu/io/trace.py; re-design of plot_trace_var_hs_,
R/utils.R:630-668): at the iterations the fit loop picks (1 and every 25th),
record the N_TOP largest hotspot-variance products
sig0^2 * lam_s^2 / shr_fac_inv, rewrite the CSV trace and, when matplotlib
is available, a PNG with changepoint markers.  The CSV's name, header and
rows are the JAX package's, byte for byte for the same states.
"""
from __future__ import annotations

import csv
import os

import numpy as np
import torch

N_TOP = 4
CSV_NAME = "traces_top_local_x_global_parameters.csv"


class HotspotTrace:
    def __init__(self, path, shr_fac_inv, p):
        self.path = path
        self.shr_fac_inv = shr_fac_inv
        self.p = p
        self.iters = []
        self.top_idx = []   # list of (N_TOP,) arrays
        self.top_var = []

    def __call__(self, it, state):
        # sig02_inv and the true rows of lam2_inv in one copy to the host
        host = torch.cat([state.sig02_inv.reshape(1),
                          state.lam2_inv[:self.p]]).double().cpu().numpy()
        sig02_inv, lam2_inv = float(host[0]), host[1:]
        x = 1.0 / sig02_inv / lam2_inv / self.shr_fac_inv
        idx = np.argsort(-x, kind="stable")[:N_TOP]
        self.iters.append(it)
        self.top_idx.append(idx)
        self.top_var.append(x[idx])
        self._write()

    def _write(self):
        with open(os.path.join(self.path, CSV_NAME), "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["it"] + [f"var_{i+1}" for i in range(N_TOP)]
                       + [f"idx_{i+1}" for i in range(N_TOP)])
            for it, var, idx in zip(self.iters, self.top_var, self.top_idx):
                w.writerow([it] + list(var) + list(idx))
        try:
            self._plot()
        except Exception:  # plotting is best-effort, never fails the run
            pass

    def _plot(self):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        var = np.array(self.top_var)
        idx = np.array(self.top_idx)
        fig, ax = plt.subplots(figsize=(8, 6))
        for i in range(var.shape[1]):
            ax.plot(self.iters, var[:, i], "-o", color="black",
                    markerfacecolor=f"C{i}", markersize=4)
            # changepoints: predictor identity changed along the trace
            if len(self.iters) > 1:
                cps = 1 + np.where(np.diff(idx[:, i]) != 0)[0]
                ax.scatter(np.array(self.iters)[cps], var[cps, i],
                           color="blue", zorder=5, s=20)
        ax.axhline(5, color="red", linestyle=":")
        ax.set_xlabel("Iteration")
        ax.set_ylabel(f"Top-{N_TOP} hotspot variance parameters")
        ax.set_title("Trace 1/sig02_inv_vb x 1/lam2_inv_vb x shr_factor")
        fig.savefig(os.path.join(
            self.path, "traces_top_local_x_global_parameters.png"), dpi=120)
        plt.close(fig)
