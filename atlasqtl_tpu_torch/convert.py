"""Build the port's Data / Hyper / VBState, and the samplers' GibbsState,
from NumPy arrays keyed by field name — how a state of the reference
package (or one saved to disk) is handed to the port without the port
importing JAX:

    arrays = {f.name: np.asarray(getattr(s, f.name))
              for f in dataclasses.fields(s)}
    state = state_from_numpy(arrays)          # on the GPU
    state = state_from_numpy(arrays, device="cpu")

`device` None means the GPU, and a missing GPU is an error, as for
api.atlasqtl.  A field that is None (or missing) stays None.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .api import resolve_device
from .mcmc.gibbs import GibbsState
from .types import Data, Hyper, VBState


def _from_numpy(cls, arrays, device, dtype):
    device = resolve_device(device)
    out = {}
    for f in dataclasses.fields(cls):
        v = arrays.get(f.name)
        if v is None or (isinstance(v, np.ndarray) and v.dtype == object):
            out[f.name] = None
            continue
        t = torch.from_numpy(np.array(v))  # a writable copy
        out[f.name] = t.to(device=device, dtype=dtype or t.dtype)
    return cls(**out)


def data_from_numpy(arrays, device=None, dtype=None) -> Data:
    """Data from {field: array}; dtype None keeps each array's dtype."""
    return _from_numpy(Data, arrays, device, dtype)


def hyper_from_numpy(arrays, device=None, dtype=None) -> Hyper:
    """Hyper from {field: array}; dtype None keeps each array's dtype."""
    return _from_numpy(Hyper, arrays, device, dtype)


def state_from_numpy(arrays, device=None, dtype=None) -> VBState:
    """VBState from {field: array}; dtype None keeps each array's dtype."""
    return _from_numpy(VBState, arrays, device, dtype)


def gibbs_state_from_numpy(arrays, device=None,
                           dtype=None) -> GibbsState:
    """mcmc/gibbs.py:GibbsState from {field: array} (a JAX chain's
    GibbsState fields; its `key` has no counterpart and is ignored); dtype
    None keeps each array's dtype."""
    return _from_numpy(GibbsState, arrays, device, dtype)
