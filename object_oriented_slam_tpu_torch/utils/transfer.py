"""Host <-> device copies that do not make the host wait for the stream.

PyTorch runs a copy from pageable host memory, and any device-to-host copy
into it, as ``cudaMemcpyAsync`` followed by ``cudaStreamSynchronize``: the
host waits for everything queued before it.  Here a host-to-device copy
goes through pinned memory with ``non_blocking=True`` (PyTorch's caching
host allocator does not hand the pinned block out again before the copy
has run), and a device-to-host copy lands in pinned memory behind a CUDA
event that the reader waits on: the twin of JAX's asynchronous
``device_put`` and ``copy_to_host_async``.  On the CPU both are plain
(the tensor itself).
"""
from __future__ import annotations

import numpy as np
import torch


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy array on ``device``; on a CUDA device the copy is queued on
    the current stream and the host goes on."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class HostCopy:
    """A device tensor's copy to the host, started now (``start``) and read
    with ``wait``, which waits on the copy's event only."""

    def __init__(self, host: torch.Tensor, event):
        self.host = host
        self.event = event

    @classmethod
    def start(cls, t: torch.Tensor) -> "HostCopy":
        if t.device.type != "cuda":
            return cls(t, None)
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return cls(host, event)

    def wait(self) -> torch.Tensor:
        """The host tensor, once the copy has landed."""
        if self.event is not None:
            self.event.synchronize()
        return self.host
