"""system/profiling: ``device_trace(device="cpu")`` writes a Chrome trace
that holds the names of the ``annotate`` ranges inside it (JAX
``system/profiling.py`` writes an XProf trace; the port's is
``torch.profiler``'s).  On the card the trace also holds the kernels:
chip_smoke.py ``[aos]`` checks it."""
import json
import os

import pytest
import torch

from object_oriented_slam_tpu_torch.system import profiling

torch.set_num_threads(1)    # the test workers share the CPU


def test_device_trace_holds_the_annotations(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profiling.device_trace(log_dir, device="cpu") as d:
        assert d == log_dir
        with profiling.annotate("oslam_stage_one"):
            x = torch.randn(64, 64) @ torch.randn(64, 64)
        with profiling.annotate("oslam_stage_two"):
            (x * 2).sum()
    path = os.path.join(log_dir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"oslam_stage_one", "oslam_stage_two"} <= names
    assert any("mm" in (n or "") for n in names)


def test_device_trace_defaults_to_the_card(tmp_path):
    """Without a device it traces the card, and raises without one (no
    fall-back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card; chip_smoke.py traces it")
    with pytest.raises(RuntimeError, match="cuda"):
        with profiling.device_trace(str(tmp_path / "t")):
            pass


def test_annotate_outside_a_trace_is_harmless():
    with profiling.annotate("nothing_records_this"):
        y = torch.ones(3) + 1
    assert float(y.sum()) == 6.0
