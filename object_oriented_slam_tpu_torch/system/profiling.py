"""Device profiling hooks (port of ``system/profiling.py``): a
``torch.profiler`` trace in Chrome's format around a block of work, and
named ranges that show in it (and, on the card, as NVTX ranges)."""
from __future__ import annotations

import contextlib
import os

import torch

from ..utils.device import resolve_device


@contextlib.contextmanager
def device_trace(log_dir: str, device=None):
    """Record a ``torch.profiler`` trace around a block and write it as a
    Chrome trace into ``log_dir`` (``trace.json``).  On the card (the
    default device) it records CUDA activity beside the host's;
    ``device="cpu"`` records CPU activity only.

    Usage:
        with device_trace("/tmp/slam_trace"):
            slam.track_with_objects(...)
    """
    device = resolve_device(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield log_dir
    finally:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Label a pipeline stage: a ``record_function`` range in the
    profiler's trace, plus an NVTX range when a card is present."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
