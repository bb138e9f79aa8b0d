"""atlasqtl_tpu_torch — the PyTorch/CUDA port of atlasqtl_tpu.

Annealed variational inference for global-local hotspot QTL mapping on one
NVIDIA GPU.  The sweeps are hand-written CUDA kernels (csrc/*.cu, built
with nvcc at first use); the rest is plain PyTorch.  Imports torch, NumPy
and SciPy only — never JAX, never the atlasqtl_tpu package.
"""
from .api import atlasqtl
from .inference.elicitation import (set_hyper, set_init, auto_set_hyper,
                                    auto_set_init, map_hyperprior_elicitation,
                                    HyperSpec, InitSpec)
from .inference.summarise import assign_bfdr, AtlasQTLResult
from .inference.permutation import permutation_null_calibration
from .io.checkpoint import load_checkpoint
from .types import Config

__version__ = "0.1.0"

__all__ = [
    "atlasqtl", "set_hyper", "set_init", "auto_set_hyper", "auto_set_init",
    "map_hyperprior_elicitation", "assign_bfdr", "AtlasQTLResult",
    "permutation_null_calibration", "load_checkpoint", "Config",
    "HyperSpec", "InitSpec",
]
