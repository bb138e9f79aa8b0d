"""Build the port's Data / Hyper / VBState from NumPy arrays keyed by field
name — how a state of the reference package (or one saved to disk) is handed
to the port without the port importing JAX:

    arrays = {f.name: np.asarray(getattr(s, f.name))
              for f in dataclasses.fields(s)}
    state = state_from_numpy(arrays, device="cpu")

A field that is None (or missing) stays None.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .types import Data, Hyper, VBState


def _from_numpy(cls, arrays, device, dtype):
    out = {}
    for f in dataclasses.fields(cls):
        v = arrays.get(f.name)
        if v is None or (isinstance(v, np.ndarray) and v.dtype == object):
            out[f.name] = None
            continue
        t = torch.from_numpy(np.array(v))  # a writable copy
        out[f.name] = t.to(device=device, dtype=dtype or t.dtype)
    return cls(**out)


def data_from_numpy(arrays, device="cpu", dtype=None) -> Data:
    """Data from {field: array}; dtype None keeps each array's dtype."""
    return _from_numpy(Data, arrays, device, dtype)


def hyper_from_numpy(arrays, device="cpu", dtype=None) -> Hyper:
    """Hyper from {field: array}; dtype None keeps each array's dtype."""
    return _from_numpy(Hyper, arrays, device, dtype)


def state_from_numpy(arrays, device="cpu", dtype=None) -> VBState:
    """VBState from {field: array}; dtype None keeps each array's dtype."""
    return _from_numpy(VBState, arrays, device, dtype)
