"""The collectives of the sharded solvers, on tensors over a process group.

The JAX package runs its sharded bodies under ``shard_map`` and calls
``jax.lax.psum``, ``all_gather``, ``ppermute`` and ``axis_index`` in them.
Here every rank runs the body on its own shard (SPMD: every rank calls the
same collectives in the same order) and calls these functions.

Each is one ``all_reduce`` with SUM.  ``all_gather`` and the neighbour
shift put each rank's part into its own slot of a buffer that is zero
elsewhere, so the sum hands every rank every part, bit for bit: adding
zeros changes no bit beyond the sign of a zero.  That one collective runs
on every layout the port meets: gloo on CPU tensors, NCCL with a GPU per
rank, and gloo on CUDA tensors where ranks share one GPU (NCCL refuses two
ranks on one device; gloo's collectives on CUDA tensors are broadcast and
all_reduce).  A mesh of one shard (no group) makes each of them the
identity, or zeros where no rank sends.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist


class Mesh(NamedTuple):
    """The ranks a sharded function spans (``multihost.observation_mesh``):
    ``group`` the process group (None for one shard: no collective runs),
    this process's ``rank`` in it, the world ``size`` and the ``device``
    its shard lives on."""
    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device


def axis_index(mesh: Mesh) -> int:
    """This shard's index (``jax.lax.axis_index``)."""
    return mesh.rank


def axis_size(mesh: Mesh) -> int:
    """The number of shards (``jax.lax.psum(1, axis)``)."""
    return mesh.size


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over the ranks, on every rank (a new tensor)."""
    if mesh.size == 1:
        return x
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=mesh.group)
    return y


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``x`` concatenated along axis 0 in rank order
    (``jax.lax.all_gather(..., tiled=True)``); each rank's ``x`` has the
    same shape."""
    if mesh.size == 1:
        return x
    buf = x.new_zeros((mesh.size,) + tuple(x.shape))
    buf[mesh.rank] = x
    return psum(buf, mesh).reshape((-1,) + tuple(x.shape[1:]))


def ppermute_shift(x: torch.Tensor, mesh: Mesh, shift: int) -> torch.Tensor:
    """Rank r's result is rank (r - shift)'s ``x``, zeros where that rank
    does not exist: ``shift`` 1 sends each rank's tensor to the next rank,
    -1 to the previous one (``jax.lax.ppermute`` with the pairs (i, i+1)
    or (i+1, i))."""
    src = mesh.rank - shift
    if mesh.size == 1:
        return x if shift == 0 else torch.zeros_like(x)
    parts = all_gather(x[None], mesh)
    return parts[src] if 0 <= src < mesh.size else torch.zeros_like(x)


def pmax(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The largest of a scalar ``x`` over the ranks (``jax.lax.pmax``), on
    every rank: the gathered values' max."""
    if mesh.size == 1:
        return x
    return all_gather(x.reshape(1), mesh).amax()
