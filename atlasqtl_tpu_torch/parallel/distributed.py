"""Multi-process execution entry points (counterpart of
atlasqtl_tpu/parallel/distributed.py).

The port's mesh is explicit SPMD over torch.distributed: one process per
device, every process calls `initialize()` once, builds one mesh over the
world's ranks (parallel/mesh.py:make_mesh), loads the same data and calls
atlasqtl(..., mesh=mesh).  Each rank slices its own shards out of the full
host arrays, every reduction that crosses a shard is a named collective on
a process group of the mesh, and the results are gathered back so that
every rank returns the full matrices.

The backend follows the device the caller names: NCCL for CUDA, gloo for
the CPU.  A CUDA request on a machine without a GPU raises; nothing falls
back from one backend to the other.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["initialize", "is_initialized", "is_multiprocess"]


def is_initialized() -> bool:
    """True once this process has joined a process group."""
    return dist.is_available() and dist.is_initialized()


def _backend(device) -> str:
    """"nccl" for a CUDA device (raises without a GPU), "gloo" for the
    CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize: NCCL needs a CUDA GPU and none "
                               "is available; pass device='cpu' for gloo")
        return "nccl"
    if dev.type == "cpu":
        return "gloo"
    raise ValueError(f"initialize: unsupported device {dev}")


def initialize(init_method=None, world_size=None, rank=None, device=None,
               **kwargs) -> None:
    """Idempotent wrapper over torch.distributed.init_process_group.

    Call once per process before atlasqtl(..., mesh=...).  device (None:
    the GPU) picks the backend (`_backend`).  init_method, world_size
    and rank are optional: left out, torch.distributed reads them from the
    environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK); on a manual
    launch pass init_method="tcp://host:port", world_size and rank.  Under
    NCCL the process's current CUDA device is its rank's device (set it,
    e.g. torch.cuda.set_device(local_rank), before the call)."""
    if is_initialized():
        return
    opts = dict(init_method=init_method, world_size=world_size, rank=rank)
    opts = {k: v for k, v in opts.items() if v is not None}
    opts.update(kwargs)
    dist.init_process_group(backend=_backend(device), **opts)


def is_multiprocess() -> bool:
    """True when more than one process takes part."""
    return is_initialized() and dist.get_world_size() > 1
