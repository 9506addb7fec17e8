"""The port's process groups and meshes (parallel/multihost.py) and the
tracker's default mesh, without a group.  Imports no JAX: the ``cuda``
case runs on the card with ``python -m pytest tests/test_torch_multihost.py
--noconftest -q``.
"""
import os

import pytest
import torch

from object_oriented_slam_tpu_torch.parallel import multihost
from object_oriented_slam_tpu_torch.system import System

torch.set_num_threads(1)    # the test workers share the CPU

SETTINGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "object_oriented_slam_tpu_torch", "configs",
    "synthetic_depth.yaml")


def test_initialize_without_a_launcher_is_one_shard(monkeypatch):
    """Without torchrun's environment (or an init_method) nothing starts
    and the mesh is one shard; NCCL on the CPU raises and names gloo."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert not multihost.initialize(device="cpu")
    mesh = multihost.observation_mesh("cpu")
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)
    assert mesh.device == torch.device("cpu")
    with pytest.raises(ValueError, match="gloo"):
        multihost.initialize(backend="nccl", device="cpu",
                             init_method="file:///nonexistent", world_size=1,
                             rank=0)
    assert multihost.default_backend("cpu") == "gloo"


def test_open_distributed_backend_defaults_to_the_systems_device():
    """With no mesh the backend shards over observation_mesh on the
    system's device: without a group, one shard on the CPU."""
    slam = System(SETTINGS, device="cpu")
    slam.open_distributed_backend()
    mesh = slam.tracker._mesh
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)
    assert mesh.device == torch.device("cpu")


@pytest.mark.cuda
def test_open_distributed_backend_defaults_on_the_card():
    """The default System lives on an unindexed ``cuda``; its default mesh
    on the current card is the same device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the default System runs there")
    slam = System(SETTINGS)
    assert slam.tracker.device == torch.device("cuda")
    slam.open_distributed_backend()
    assert slam.tracker._mesh.device == torch.device(
        "cuda", torch.cuda.current_device())
