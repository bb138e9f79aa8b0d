"""Annealing ladder generation (reference: R/utils.R:108-146).

A verbatim copy of atlasqtl_tpu/ops/annealing.py (NumPy only), kept in the
port so it never imports the JAX package.

Inverse-temperature grids following the Gramacy & Samworth importance-
tempering spacings.  anneal = (type, T0, m) with type 1 = geometric,
2 = harmonic, 3 = linear; the ladder ends at 1 (no tempering).
"""
from __future__ import annotations

import numpy as np


def annealing_ladder(anneal):
    """Return the length-m numpy ladder of inverse temperatures."""
    a_type, t0, m = int(anneal[0]), float(anneal[1]), int(anneal[2])
    k_m = 1.0 / t0
    idx = np.arange(m, 0, -1)  # m, m-1, ..., 1
    if a_type == 1:    # geometric
        delta = k_m ** (1.0 / (1.0 - m)) - 1.0
        ladder = (1.0 + delta) ** (1.0 - idx)
    elif a_type == 2:  # harmonic
        delta = (1.0 / k_m - 1.0) / (m - 1.0)
        ladder = 1.0 / (1.0 + delta * (idx - 1.0))
    elif a_type == 3:  # linear
        delta = (1.0 - k_m) / (m - 1.0)
        ladder = k_m + delta * (np.arange(1, m + 1) - 1.0)
    else:
        raise ValueError("annealing spacing type must be 1, 2 or 3")
    return ladder


def check_annealing(anneal):
    """Validate the annealing spec (reference: R/prepare_atlasqtl.R:100-124)."""
    if anneal is None:
        return
    anneal = np.asarray(anneal, dtype=float)
    if anneal.shape != (3,):
        raise ValueError("anneal must be a vector of length 3 or None")
    if not float(anneal[0]).is_integer() or int(anneal[0]) not in (1, 2, 3):
        raise ValueError("annealing spacing scheme must be 1 (geometric), "
                         "2 (harmonic) or 3 (linear)")
    if anneal[1] < 1.5:
        raise ValueError("initial annealing temperature too small (< 1.5); "
                         "increase it or disable annealing")
    if not float(anneal[2]).is_integer() or anneal[2] < 1:
        raise ValueError("temperature grid size must be a natural number")
    if anneal[2] > 1000:
        raise ValueError("temperature grid size too large (> 1000)")
