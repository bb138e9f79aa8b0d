"""Posterior summaries — result object, Bayesian FDR, hotspot reports.

A verbatim copy of atlasqtl_tpu/inference/summarise.py (NumPy only), kept in
the port so it never imports the JAX package.  Re-design of R/summarise_output.R (print/summary/plot.atlasqtl and
assign_bFDR).  The plot method returns the Manhattan data (positions, hotspot
sizes) rather than drawing to a device; a convenience matplotlib renderer is
included.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def assign_bfdr(mat_ppi: np.ndarray) -> np.ndarray:
    """Bayesian FDR = running mean of (1 - PIP) over PIPs sorted decreasing,
    mapped back to the p x q layout (reference: assign_bFDR,
    R/summarise_output.R:207-223)."""
    vec = np.asarray(mat_ppi, dtype=np.float64).ravel(order="F")
    order = np.argsort(-vec, kind="stable")
    fdr_sorted = np.cumsum(1.0 - vec[order]) / np.arange(1, vec.size + 1)
    fdr = np.empty_like(fdr_sorted)
    fdr[order] = fdr_sorted
    return fdr.reshape(mat_ppi.shape, order="F")


@dataclasses.dataclass
class AtlasQTLResult:
    """Posterior output of `atlasqtl` (reference S3 class "atlasqtl",
    R/atlasqtl.R:75-114)."""
    beta_vb: np.ndarray
    gam_vb: np.ndarray
    theta_vb: np.ndarray
    zeta_vb: np.ndarray
    converged: bool
    it: int
    lb_opt: float
    diff_lb: float
    n: int
    p: int
    q: int
    p0: Optional[tuple]
    anneal: Optional[tuple]
    tol: float
    maxit: int
    rmvd_cst_x: list
    rmvd_coll_x: dict
    names_x: list
    names_y: list
    elbo_history: list
    lam2_inv_vb: Optional[np.ndarray] = None
    x_beta_vb: Optional[np.ndarray] = None  # n x q fitted X beta (the output
    # the reference documents but never returns, R/atlasqtl.R:89-91)
    sig02_inv_vb: Optional[float] = None
    list_hyper: Optional[object] = None
    list_init: Optional[object] = None
    full_state: Optional[object] = None
    full_output: Optional[dict] = None  # reference-named internal list
    # (R/atlasqtl_global_local_core.R:404-410), unpadded float64 — see
    # inference/full_output.py

    # ------------------------------------------------------------ methods
    def __repr__(self):  # print.atlasqtl (R/summarise_output.R:14-59)
        if self.converged:
            head = (f"Successful convergence after {self.it} iterations, "
                    f"using a tolerance of {self.tol} on the ELBO.\n")
            if self.anneal is not None:
                kind = {1: "Geometric", 2: "Harmonic", 3: "Linear"}[
                    int(self.anneal[0])]
                head += (f"{kind} annealing applied for the first "
                         f"{int(self.anneal[2])} iterations, initial "
                         f"temperature {self.anneal[1]}.\n")
            head += (f"Samples: {self.n}; non-redundant predictors: {self.p}; "
                     f"responses: {self.q}.\n")
            if self.p0 is not None:
                head += (f"Prior E[#predictors/response] = {self.p0[0]} "
                         f"(sd {np.sqrt(self.p0[1]):.2g}).\n")
            return f"<atlasqtl>\n{head}"
        return (f"<atlasqtl>\nUnsuccessful convergence after {self.maxit} "
                f"iterations; last ELBO change {self.diff_lb:.3g}. Try "
                f"increasing maxit or tol.\n")

    def hotspot_sizes(self, thres: float = 0.5, fdr_adjust: bool = False):
        """#responses associated with each predictor at the given threshold
        (reference: summary/plot.atlasqtl)."""
        if fdr_adjust:
            return (assign_bfdr(self.gam_vb) < thres).sum(axis=1)
        return (self.gam_vb > thres).sum(axis=1)

    def summary(self, thres: float = 0.5, fdr_adjust: bool = False,
                full_summary: bool = True) -> dict:
        """Posterior summary (reference: summary.atlasqtl,
        R/summarise_output.R:83-137).  Returns a dict instead of printing."""
        out = {}
        if full_summary:
            out["gam_vb_summary"] = _five_num(self.gam_vb)
            out["beta_vb_summary"] = _five_num(self.beta_vb)
            out["theta_vb_summary"] = _five_num(self.theta_vb)
        if fdr_adjust:
            mat_fdr = assign_bfdr(self.gam_vb)
            sel = mat_fdr < thres
        else:
            sel = self.gam_vb > thres
        rs = sel.sum(axis=1)
        out["n_pairwise"] = int(sel.sum())
        out["n_active_predictors"] = int((rs > 0).sum())
        out["hotspot_sizes"] = _five_num(rs[rs > 0]) if (rs > 0).any() else None
        order = np.argsort(-rs, kind="stable")
        top = [(self.names_x[j], int(rs[j])) for j in order[:6] if rs[j] > 0]
        out["top_hotspots"] = top
        return out

    def manhattan_data(self, thres: float = 0.5, fdr_adjust: bool = False):
        """(positions, hotspot sizes) for the Manhattan plot
        (reference: plot.atlasqtl, R/summarise_output.R:167-190)."""
        rs = self.hotspot_sizes(thres, fdr_adjust)
        return np.arange(1, len(rs) + 1), rs

    def plot(self, thres: float = 0.5, fdr_adjust: bool = False, ax=None,
             **kwargs):
        """Render the hotspot Manhattan plot with matplotlib."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        pos, rs = self.manhattan_data(thres, fdr_adjust)
        if ax is None:
            _, ax = plt.subplots(figsize=(9, 4))
        ax.scatter(pos, rs, s=8, **kwargs)
        ax.set_xlabel("Predictors")
        ax.set_ylabel("Nb of associated responses")
        ax.set_title("Hotspot Manhattan plot")
        return ax


def _five_num(a):
    a = np.asarray(a, dtype=np.float64).ravel()
    if a.size == 0:
        return None
    return {
        "min": float(a.min()),
        "q1": float(np.quantile(a, 0.25)),
        "median": float(np.median(a)),
        "mean": float(a.mean()),
        "q3": float(np.quantile(a, 0.75)),
        "max": float(a.max()),
    }
