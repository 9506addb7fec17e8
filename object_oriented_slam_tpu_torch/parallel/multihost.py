"""Process groups and the mesh of the sharded solvers (port of
``parallel/multihost.py``).

JAX starts ``jax.distributed`` from its coordinator's environment and
builds a 1-D ``Mesh`` over every device.  Here ``initialize`` starts
``torch.distributed`` from torchrun's environment (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``) or from an
``init_method`` the caller gives, and ``observation_mesh`` returns the
small object every sharded function takes as its ``mesh``: the group, this
process's rank, the world size and the rank's device
(``collectives.Mesh``).  Without a group the mesh is one shard, as JAX's
mesh over one local device is: the sharded functions then run unsharded.

The backend is the caller's choice and is never switched: NCCL needs a GPU
per rank (it refuses two ranks on one device), gloo runs on the CPU and
lets ranks share one GPU.
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.device import indexed_device, resolve_device
from .collectives import Mesh

__all__ = ["Mesh", "initialize", "observation_mesh", "shutdown"]


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def initialize(backend: Optional[str] = None, device=None,
               init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               timeout_s: float = 120.0) -> bool:
    """Start the default process group where one is configured; returns
    True if one is active.

    torchrun's environment configures it, or ``init_method`` (for example
    ``tcp://localhost:PORT`` or a ``file://`` store), ``world_size`` and
    ``rank`` given here.  Without either it returns False, as JAX's
    ``initialize`` does without a coordinator.  ``backend``: "nccl" or
    "gloo", the default ``default_backend(device)``.  ``device``: the card
    unless the caller names one ("cpu" for gloo on the CPU).  Each rank
    takes GPU ``LOCAL_RANK`` under NCCL, ``LOCAL_RANK`` modulo the GPUs
    under gloo, and makes it the current device.  ``timeout_s`` bounds the
    start and every collective, so a rank that is lost ends the run
    instead of hanging it.
    """
    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None:
        if not all(k in env for k in ("MASTER_ADDR", "MASTER_PORT",
                                      "WORLD_SIZE", "RANK")):
            return False
        init_method = "env://"
    world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    rank = int(env["RANK"]) if rank is None else rank
    local_rank = int(env.get("LOCAL_RANK", rank))
    dev = resolve_device(device)
    backend = backend or default_backend(dev)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend={backend!r}: 'nccl' or 'gloo'")
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        if backend == "nccl" and local_rank >= n:
            raise ValueError(
                f"backend='nccl' needs a GPU per rank: local rank "
                f"{local_rank} of this host has none of its own ({n} GPU(s)); "
                f"NCCL refuses two ranks on one device, backend='gloo' "
                f"lets them share it")
        torch.cuda.set_device(dev.index if dev.index is not None
                              else local_rank % n)
    elif backend == "nccl":
        raise ValueError(f"backend='nccl' takes CUDA tensors, the device is "
                         f"{dev}; backend='gloo' runs on the CPU")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    return True


def observation_mesh(device=None) -> Mesh:
    """The mesh over every rank of the default group, each rank's shard on
    ``device`` (the card unless the caller names one; an unindexed
    ``cuda`` is the current device, the one ``initialize`` picked); one
    shard where no group is active."""
    dev = indexed_device(resolve_device(device))
    if not dist.is_initialized():
        return Mesh(None, 0, 1, dev)
    return Mesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size(),
                dev)


def shutdown():
    """End the default process group, where one is active."""
    if dist.is_initialized():
        dist.destroy_process_group()
