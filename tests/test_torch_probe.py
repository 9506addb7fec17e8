"""The port's probe and architecture choice (system/probe.py) against the
JAX package's rules: its three cases (tests/test_probe.py) on the port,
on the CPU, and the default device (the card) raising where there is none.
"""
import numpy as np
import pytest
import torch

from object_oriented_slam_tpu.system import probe as jprobe
from object_oriented_slam_tpu_torch.io import native_loader as tnl
from object_oriented_slam_tpu_torch.system.probe import (
    RTT_THRESHOLD_MS, choose_architecture, probe_device_rtt_ms)

torch.set_num_threads(1)    # the test workers share the CPU


def test_probe_measures_finite_rtt():
    rtt = probe_device_rtt_ms(n=3, device="cpu")
    assert np.isfinite(rtt) and rtt > 0.0


def test_selection_rules():
    assert RTT_THRESHOLD_MS == jprobe.RTT_THRESHOLD_MS == 5.0
    cases = [(30.0, True), (0.5, True), (0.5, False),
             (RTT_THRESHOLD_MS, True), (RTT_THRESHOLD_MS - 1e-6, True)]
    for rtt, ok in cases:
        assert choose_architecture(rtt_ms=rtt, native_ok=ok) == \
            jprobe.choose_architecture(rtt_ms=rtt, native_ok=ok)
    # a remote link -> mono, no fusion; a local device with the host
    # clustering -> fused-split + LM fusion; the fused path needs the
    # clustering library; the boundary belongs to the remote regime
    assert choose_architecture(rtt_ms=30.0, native_ok=True) == \
        ("mono", False)
    assert choose_architecture(rtt_ms=0.5, native_ok=True) == \
        ("fused", True)
    assert choose_architecture(rtt_ms=0.5, native_ok=False) == \
        ("mono", False)
    assert choose_architecture(rtt_ms=RTT_THRESHOLD_MS,
                               native_ok=True)[0] == "mono"


def test_probe_selects_on_this_backend():
    """End to end on the CPU: the probe's round trip is local and the
    clustering library builds from native/src/cluster.cpp here, so the
    choice is fused-split with LM fusion."""
    arch, fuse = choose_architecture(device="cpu")
    assert tnl.cluster_available()
    assert (arch, fuse) == ("fused", True)


def test_probe_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="not available"):
        probe_device_rtt_ms(n=1)
    with pytest.raises(RuntimeError, match="not available"):
        choose_architecture(native_ok=True)
