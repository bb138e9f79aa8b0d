"""Trait (q) and predictor (p) sharding over torch.distributed (counterpart
of atlasqtl_tpu/parallel/mesh.py).

The JAX package's mesh is GSPMD: every (.., q) array is q-sharded and XLA
inserts the cross-shard reductions from the sharding annotations.  The
port's mesh is explicit SPMD instead: one process per device, each rank
holds its local shards as plain contiguous tensors (the kernels take
nothing else), and every reduction that crosses a shard is a named
collective on one of the mesh's process groups (`q_sum`, `p_sum`).

- q (traits): the sweep is independent across responses given (theta,
  zeta) (src/coreLoop.cpp:58), so every (.., q) tensor shards on q; the
  cross-q reductions are sum(gam), rowSums(Z), the rho/kappa accumulations,
  the horseshoe-scale moments and the ELBO's sums over q.
- p (predictors, 2-D mesh): x (n, p), the Gram blocks and every (p, .)
  tensor shard on p as well; the sequential order over p is kept by the
  pipeline of parallel/pipeline.py, and the (q,) column statistics and the
  sums over p are summed over the p group.

1-D layout (q only):
  replicated: x (n, p), theta/lam2_inv/sig2_theta/p_mask (p,), scalars
  q-sharded:  y/fitted/mis_pat (n, q), cp_x_y/gam/mu_beta/x_norm_sq (p, q),
              tau/zeta/eta/kappa/n0/q_mask/y_norm_sq/n_eff (q,)
2-D layout ((p, q) mesh): as above, plus p-sharding of x (dim 1), the
  (p, q) matrices (dim 0) and the (p,) vectors; fitted stays q-sharded and
  p-replicated (every p-stage needs the full sample dimension).

Every process holds the full host inputs (the multi-process contract of
atlasqtl_tpu/parallel/mesh.py:63-83) and slices its own shards out of them
(`shard_data`, `shard_hyper`, `shard_state`); `to_host` gathers a state
back so that every rank returns the full matrices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..types import Data, Hyper, VBState

Q_AXIS = "q"
P_AXIS = "p"


class Mesh:
    """A 1-D ("q",) or 2-D ("p", "q") grid of the world's ranks, with this
    rank's place in it and its process groups.  `devices` is the grid of
    ranks (the JAX Mesh's devices), `shape` maps axis name to size,
    `device` is this rank's torch device (its CUDA device under NCCL, the
    CPU under gloo).  Built by `make_mesh`, which every rank of the world
    calls (torch.distributed.new_group is collective)."""

    def __init__(self, grid: np.ndarray, axis_names):
        self.devices = grid if len(axis_names) == 2 else grid[0]
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.n_p, self.n_q = grid.shape
        rank = dist.get_rank()
        where = np.argwhere(grid == rank)
        self.member = len(where) == 1
        self.p_index, self.q_index = ((int(where[0][0]), int(where[0][1]))
                                      if self.member else (None, None))
        # every rank creates every group, in the same order
        q_groups = [dist.new_group([int(r) for r in row]) for row in grid]
        p_groups = ([dist.new_group([int(r) for r in col]) for col in grid.T]
                    if len(axis_names) == 2 else None)
        self.group = dist.new_group([int(r) for r in grid.ravel()])
        self.q_group = q_groups[self.p_index] if self.member else None
        self.p_group = (p_groups[self.q_index]
                        if self.member and p_groups else None)
        # this rank's p-stage neighbours, as global ranks
        self.p_ranks = [int(r) for r in grid[:, self.q_index]] \
            if self.member else []
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if dist.get_backend() == "nccl"
                       else torch.device("cpu"))

    def __repr__(self):
        return (f"Mesh({dict(self.shape)}, rank {dist.get_rank()} at "
                f"p={self.p_index}, q={self.q_index})")


def make_mesh(devices=None, p_shards: int = 1, two_d: bool = False) -> Mesh:
    """The 1-D trait mesh by default; p_shards > 1 (or two_d) builds the
    2-D (p, q) mesh.  `devices` is a list of global ranks (None: all of the
    world's); every rank of the world must call it, those outside
    `devices` too (they are no member and take no part in a fit on it).

    2-D layout as atlasqtl_tpu/parallel/mesh.py:58 lays it out,
    devices.reshape(-1, p_shards).T: the p axis varies fastest over the
    rank list, so a p-pipeline column is a run of consecutive ranks (one
    host's GPUs, on NVLink) and the per-step (n, q_tile) transfers stay
    there, while only the small q-axis sums cross hosts."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: call parallel.distributed.initialize "
                           "(atlasqtl_tpu_torch.initialize_distributed) "
                           "first")
    if devices is None:
        devices = range(dist.get_world_size())
    devices = np.asarray(list(devices), dtype=np.int64)
    if p_shards > 1 or two_d:
        if devices.size % p_shards:
            raise ValueError(f"make_mesh: {devices.size} ranks do not split "
                             f"into {p_shards} p-shards")
        return Mesh(devices.reshape(-1, p_shards).T, (P_AXIS, Q_AXIS))
    return Mesh(devices.reshape(1, -1), (Q_AXIS,))


def has_p(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and P_AXIS in mesh.axis_names


def q_pad_multiple(mesh: Optional[Mesh]) -> int:
    """q is padded to a multiple of 8 x #q-shards, so that the shards are
    even and each keeps the port's own padding of 8.  (p is padded by
    models/global_local.py:build_data(p_shards=...) to whole predictor
    blocks per p-shard, the JAX package's p_pad_multiple, which it
    imports and never calls.)"""
    return 8 if mesh is None else 8 * mesh.n_q


# ------------------------------------------------------------ reductions

def _all_reduce(t, group):
    out = t.clone()
    dist.all_reduce(out, group=group)
    return out


def q_sum(mesh: Optional[Mesh], t):
    """The sum of t over the q-shards (every rank gets it); t itself with no
    mesh."""
    return t if mesh is None else _all_reduce(t, mesh.q_group)


def p_sum(mesh: Optional[Mesh], t):
    """The sum of t over the p-shards on a 2-D mesh; t itself otherwise."""
    return _all_reduce(t, mesh.p_group) if has_p(mesh) else t


def broadcast_int(mesh: Mesh, v: int) -> int:
    """The mesh's first rank's v, on every rank of the mesh."""
    t = torch.tensor([int(v)], dtype=torch.int64, device=mesh.device)
    dist.broadcast(t, int(mesh.devices.ravel()[0]), group=mesh.group)
    return int(t.item())


# ------------------------------------------------------------ placement
# Each table gives a field's axes, dimension by dimension: "q" or "p"
# sharded, None replicated; a field not listed is replicated.  A tensor
# with fewer dimensions takes the table's last ones (a (q,) slab variance
# under the (p, q) entry of sig2_beta).  On a 1-D mesh "p" is replicated.

_DATA_SPEC = dict(
    y=(None, Q_AXIS), mis_pat=(None, Q_AXIS), cp_x_y=(P_AXIS, Q_AXIS),
    x_norm_sq=(P_AXIS, Q_AXIS), y_norm_sq=(Q_AXIS,), n_eff=(Q_AXIS,),
    q_mask=(Q_AXIS,), n_mis=(Q_AXIS,), mis_pair_gram=(P_AXIS, None, Q_AXIS),
    x=(None, P_AXIS), x_bf16=(None, P_AXIS), p_mask=(P_AXIS,),
    goff=(P_AXIS, None))

_HYPER_SPEC = dict(eta=(Q_AXIS,), kappa=(Q_AXIS,), n0=(Q_AXIS,))

_STATE_SPEC = dict(
    gam=(P_AXIS, Q_AXIS), mu_beta=(P_AXIS, Q_AXIS), beta=(P_AXIS, Q_AXIS),
    sig2_beta=(P_AXIS, Q_AXIS), tau=(Q_AXIS,), zeta=(Q_AXIS,),
    gam_colsum=(Q_AXIS,), mu2gam_colsum=(Q_AXIS,), beta2_colsum=(Q_AXIS,),
    fitted=(None, Q_AXIS), theta=(P_AXIS,), lam2_inv=(P_AXIS,),
    sig2_theta=(P_AXIS,), l_vb=(P_AXIS,))


def _spec(table, name, t):
    spec = table.get(name, ())
    return spec[len(spec) - t.dim():] if t.dim() < len(spec) else spec


def _axes(mesh, spec):
    """(dim, shards, this rank's index, group) of each dimension sharded
    over more than one rank, q first."""
    out = []
    for d, ax in enumerate(spec):
        if ax == Q_AXIS and mesh.n_q > 1:
            out.insert(0, (d, mesh.n_q, mesh.q_index, mesh.q_group))
        elif ax == P_AXIS and has_p(mesh) and mesh.n_p > 1:
            out.append((d, mesh.n_p, mesh.p_index, mesh.p_group))
    return out


def shard(t, mesh: Mesh, spec):
    """This rank's contiguous shard of the full tensor t under `spec`."""
    if not mesh.member:
        raise ValueError(f"shard: rank {dist.get_rank()} is not in {mesh}")
    for d, k, i, _ in _axes(mesh, spec):
        if t.shape[d] % k:
            raise ValueError(f"shard: dimension {d} of {tuple(t.shape)} does "
                             f"not split into {k} shards")
        size = t.shape[d] // k
        t = t.narrow(d, i * size, size)
    return t.contiguous()


def gather(t, mesh: Mesh, spec):
    """The full tensor of this rank's shard t under `spec`, on every rank
    (all-gathers over the q group, then the p group)."""
    for d, k, _, group in _axes(mesh, spec):
        parts = [torch.empty_like(t) for _ in range(k)]
        dist.all_gather(parts, t.contiguous(), group=group)
        t = torch.cat(parts, dim=d)
    return t


def _put(obj, mesh, table):
    return dataclasses.replace(obj, **{
        f.name: shard(v, mesh, _spec(table, f.name, v))
        for f in dataclasses.fields(obj)
        if isinstance(v := getattr(obj, f.name), torch.Tensor)})


def shard_data(data: Data, mesh: Mesh) -> Data:
    """This rank's shards of the full Data, which then carries the mesh
    (the model's reductions read it there)."""
    return dataclasses.replace(_put(data, mesh, _DATA_SPEC), mesh=mesh)


def shard_hyper(hyper: Hyper, mesh: Mesh) -> Hyper:
    return _put(hyper, mesh, _HYPER_SPEC)


def shard_state(state: VBState, mesh: Mesh) -> VBState:
    return _put(state, mesh, _STATE_SPEC)


def to_host(state: VBState, mesh: Optional[Mesh]) -> VBState:
    """The full state on every rank of the mesh, gathered field by field
    (atlasqtl_tpu/parallel/mesh.py:to_host: the R API always returns full
    matrices); the state itself with no mesh."""
    if mesh is None:
        return state
    return dataclasses.replace(state, **{
        f.name: gather(v, mesh, _spec(_STATE_SPEC, f.name, v))
        for f in dataclasses.fields(state)
        if isinstance(v := getattr(state, f.name), torch.Tensor)})
