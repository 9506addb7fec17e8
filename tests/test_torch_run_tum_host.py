"""The port's TUM command line (examples/torch_run_tum.py) on the CPU in its
other architectures, on tests/test_torch_run_tum.py's export and settings
(that file holds the runs against the JAX CLI; the two files' runs go to
two workers).

The first SPLIT frames run ``--extractor mono`` (the reference of this
file, as in tests/test_torch_run_tum.py), then ``--extractor split`` and
the default ``auto`` (which probes the CPU and picks fused-split with LM
fusion), each held to the mono run within 1e-4, as is the offline mode
(``--offline --batch 4 --offline-per-frame-ba``: the plane's bootstrap
frame, then two batches of 4).  The distributed command line runs in
tests/test_torch_dist.py's rank processes.  Each check is a case of its
own: xdist (``--dist loadfile``) queues files by their number of cases,
and this file's runs are long.
"""
import numpy as np
import pytest
import torch

from test_torch_run_tum import (SPLIT, YAML, _history_rows, _objects,
                                _port_cli, export)

torch.set_num_threads(1)    # the test workers share the CPU


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The export's first SPLIT frames by each architecture: the output
    directories, and each in-process run's (System, log)."""
    tmp = tmp_path_factory.mktemp("tum_cli_host")
    seq = export(tmp)
    out = {k: str(tmp / k) for k in ("split", "host_split", "auto",
                                      "offline")}
    first = ["--device", "cpu", "--max-frames", str(SPLIT)]
    _port_cli([YAML, seq, "--out", out["split"], *first, "--extractor",
               "mono"])
    host = {}
    for name, extra in (("host_split", ["--extractor", "split"]),
                        ("auto", []),
                        ("offline", ["--extractor", "mono", "--offline",
                                     "--batch", "4",
                                     "--offline-per-frame-ba"])):
        host[name] = _port_cli([YAML, seq, "--out", out[name], *first,
                                *extra])
    return out, host


ARCHITECTURES = ["host_split", "auto", "offline"]


@pytest.mark.parametrize("name", ARCHITECTURES)
def test_host_clustered_cli_matches_mono(runs, name):
    """``--extractor split`` and the default ``auto`` (on this CPU the
    probe picks fused-split with LM fusion, and says so) reproduce the
    mono run of the same frames within 1e-4, as does the offline mode
    (mono extraction)."""
    out, host = runs
    want = _objects(out["split"])
    slam, log = host[name]
    assert ("probed device RTT" in log) == (name == "auto")
    if name == "auto":
        assert "-> extractor=fused, fuse_lm=True" in log
    kinds = {"host_split": "SplitExtractor", "auto": "FusedSplitExtractor",
             "offline": "MonolithicExtractor"}
    assert type(slam.tracker.extractor).__name__ == kinds[name]
    assert slam.tracker.fuse_lm == (name == "auto")
    got = _objects(out[name])
    assert sorted(got) == sorted(want) and len(want) >= 5
    for inst in want:
        np.testing.assert_allclose(got[inst], want[inst], atol=1e-4)


@pytest.mark.parametrize("name", ARCHITECTURES)
def test_host_clustered_cli_history_matches_mono(runs, name):
    """The same runs' object_history.txt: the mono run's rows per
    instance."""
    out = runs[0]
    assert _history_rows(out[name]) == _history_rows(out["split"])


def test_offline_cli_matches_online(runs):
    """``--offline --batch 4 --offline-per-frame-ba`` on the first SPLIT
    frames: the mono run's objects.txt within 1e-4 (the per-frame BA
    schedule and the same rows per frame)."""
    out = runs[0]
    got, want = _objects(out["offline"]), _objects(out["split"])
    assert sorted(got) == sorted(want) and len(want) >= 5
    for inst in want:
        np.testing.assert_allclose(got[inst], want[inst], atol=1e-4)
    print(f"offline CLI objects.txt bit-equal to the mono run's: "
          f"{all(np.array_equal(got[i], want[i]) for i in want)}")


def test_offline_cli_prints_its_batches(runs):
    """The offline run prints the JAX CLI's Offline line (the plane's
    bootstrap frame, then two batches of 4) and undoes its pipeline
    override."""
    slam, log = runs[1]["offline"]
    assert f"Offline: {SPLIT} frames in " in log
    assert "2 batched programs of 4" in log
    assert slam.tracker.pipeline_depth == 4
