"""The port's default device: the card unless the caller names another."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device the port runs on: ``cuda`` unless the caller names one.
    There is no fall-back: without a usable CUDA device the default (or a
    named cuda device) raises; ``device="cpu"`` asks for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} is not available: the mapping loop runs "
            "its LM on an NVIDIA GPU by default (torch.cuda.is_available() "
            "is False here); pass device=\"cpu\" to run the plain PyTorch "
            "versions on the CPU")
    return dev


def indexed_device(device) -> torch.device:
    """``device`` with its index: an unindexed ``cuda`` is the current
    device, so that two names of one card compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev
