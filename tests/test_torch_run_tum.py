"""The port's TUM command line (examples/torch_run_tum.py) against the JAX
package's (examples/run_tum.py) on the CPU.

One TUM-format export, written by the port's exporter
(examples/torch_make_synthetic_tum.py), of tests/test_torch_depth_slice.py's
scene: 6 objects, 12 frames, 640x480, odometry noise 0.01 m.  The JAX CLI
runs it with ``--extractor mono``, the port's with ``--extractor mono
--device cpu``; both at their default pipeline (adaptive depth 4,
asynchronous plane); the port's whole run also takes ``--slam-mode
--checkpoint`` (SLAM mode runs after objects.txt is written and leaves the
state alone; tests/test_torch_slam.py runs ``--odometry --slam-mode`` on
this export's first SPLIT frames, in its own module for this file's
time).  A run to SPLIT frames is checkpointed and resumed.  The port's
other architectures on the same export (the host-clustered extractors and
the offline mode) are in tests/test_torch_run_tum_host.py, so that the two
files' runs go to two workers, and the distributed command line is in
tests/test_torch_dist.py.  Two settings differ from the
CLI's defaults, on both sides alike, for the CPU's time: ``ExtractorConfig.cloud_capacity`` is 2048
(as in tests/test_torch_depth_slice.py; the CLI's 16384 lets a frame's tier
grow to its largest box), and the port's LM batch starts at 8 object slots
instead of 24 (empty slots are masked, so results are the same; the plain
normal equations' CPU cost goes with the slots).  The file takes about
three minutes: the port's plain LM costs seconds a call on the CPU, and the
checkpoint case runs the sequence a second time.  Tolerance:
tests/test_torch_depth_slice.py's TOL = 2e-3 on centres and sorted scales
(f32 LM round-off accumulated over the run), the same instances, and
object_history.txt with the same rows per instance.
"""
import contextlib
import functools
import importlib.util
import io
import os
import sys

import numpy as np
import pytest
import torch

import object_oriented_slam_tpu.frontend as jfrontend
import object_oriented_slam_tpu_torch.frontend as tfrontend
from object_oriented_slam_tpu_torch.backend import slam_ba
from object_oriented_slam_tpu_torch.io import synthetic as tsyn
from object_oriented_slam_tpu_torch.io.writers import load_objects
from object_oriented_slam_tpu_torch.system import Tracking

torch.set_num_threads(1)    # the test workers share the CPU

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(ROOT, "object_oriented_slam_tpu_torch", "configs",
                    "synthetic_depth.yaml")
SCENE_KW = dict(n_objects=6, seed=3, radius_range=(1.3, 2.2),
                scale_range=(0.2, 0.4))
DATA_KW = dict(n_frames=12, orbit_radius=3.6, height=1.7)
CLOUD_CAPACITY = 2048
SPLIT = 9           # checkpoint after this many frames
TOL = 2e-3
MONO = ["--device", "cpu", "--extractor", "mono"]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_cli(argv):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Tracking, "MAX_OBJECTS", 8)
        mp.setattr(tfrontend, "ExtractorConfig", functools.partial(
            tfrontend.ExtractorConfig, cloud_capacity=CLOUD_CAPACITY))
        with contextlib.redirect_stdout(io.StringIO()) as out:
            slam = _example("torch_run_tum").main(argv)
    return slam, out.getvalue()


def _jax_cli(argv):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["run_tum.py", *argv])
        mp.setattr(jfrontend, "ExtractorConfig", functools.partial(
            jfrontend.ExtractorConfig, cloud_capacity=CLOUD_CAPACITY))
        with contextlib.redirect_stdout(io.StringIO()) as out:
            _example("run_tum").main()
    return out.getvalue()


def export(tmp):
    """The TUM export of the scene in ``tmp``/seq; returns its path."""
    seq = str(tmp / "seq")
    scene = tsyn.make_scene(**SCENE_KW)
    n = _example("torch_make_synthetic_tum").export_synthetic_tum(
        seq, scene, tsyn.SyntheticDataset(scene, **DATA_KW),
        odometry_noise=0.01)
    assert n == DATA_KW["n_frames"]
    return seq


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The export, and the JAX CLI's and the port CLI's output directories:
    the whole run, and a run to SPLIT frames checkpointed then resumed."""
    tmp = tmp_path_factory.mktemp("tum_cli")
    seq = export(tmp)
    out = {k: str(tmp / k) for k in ("jax", "port", "split", "resumed")}
    ckpt = str(tmp / "state.npz")
    jax_log = _jax_cli([YAML, seq, "--out", out["jax"], "--extractor",
                        "mono", "--checkpoint", str(tmp / "jax.npz")])
    slam, log = _port_cli([YAML, seq, "--out", out["port"], *MONO,
                           "--slam-mode", "--checkpoint",
                           str(tmp / "full.npz")])
    _port_cli([YAML, seq, "--out", out["split"], *MONO,
               "--max-frames", str(SPLIT), "--checkpoint", ckpt])
    _port_cli([YAML, seq, "--out", out["resumed"], *MONO, "--resume", ckpt])
    return seq, out, slam, log, jax_log


def _objects(d):
    insts, vecs = load_objects(os.path.join(d, "objects.txt"))
    return dict(zip(insts, vecs))


def _history_rows(d):
    """Rows per instance of object_history.txt (a count line, then per
    instance a header ``instance n_rows`` and its rows)."""
    with open(os.path.join(d, "object_history.txt")) as f:
        lines = [ln.split() for ln in f if ln.strip()]
    rows, i = {}, 1
    while i < len(lines):
        inst, n = int(lines[i][0]), int(lines[i][1])
        rows[inst] = n
        i += 1 + n
    return rows


def test_cli_matches_jax(runs):
    seq, out, slam, log, jax_log = runs[:5]
    got, want = _objects(out["port"]), _objects(out["jax"])
    assert sorted(got) == sorted(want) and len(want) >= 5
    for inst in want:
        np.testing.assert_allclose(got[inst][:3], want[inst][:3], atol=TOL)
        np.testing.assert_allclose(np.sort(got[inst][7:]),
                                   np.sort(want[inst][7:]), atol=TOL)
    assert _history_rows(out["port"]) == _history_rows(out["jax"])
    # the run went through the deferred pipeline and printed what the JAX
    # CLI prints
    tr = slam.tracker
    assert tr.pipeline_depth >= 4 and tr.adaptive_depth
    assert len(tr.metrics["plane_wait"]) == 1
    assert len(tr.depth_trace) == 12 == len(tr.metrics["fetch"])
    for line in ("Processed 12 frames", "Timing:", "Objects:"):
        assert line in log and line in jax_log


def test_cli_map_against_ground_truth(runs):
    seq, out = runs[:2]
    got = _objects(out["port"])
    gt = {int(r[0]): r[1:] for r in np.loadtxt(
        os.path.join(seq, "objects_gt.txt"), ndmin=2)}
    err = [np.linalg.norm(v[:3] - gt[i][:3]) for i, v in got.items()]
    assert np.median(err) < 0.05, err


def test_checkpoint_then_resume_reproduces_the_run(runs):
    out = runs[1]
    whole, resumed = _objects(out["port"]), _objects(out["resumed"])
    assert sorted(resumed) == sorted(whole)
    for inst in whole:
        np.testing.assert_allclose(resumed[inst], whole[inst], atol=1e-6)
    assert _history_rows(out["resumed"]) == _history_rows(out["port"])


@pytest.mark.parametrize("flags", [
    ["--build-dense"], ["--map-format", "pcd"], ["--viz"],
    ["--viz-live", "5"]])
def test_unported_flags_raise(flags, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        _example("torch_run_tum").main(
            [YAML, str(tmp_path), "--device", "cpu", *flags])


@pytest.mark.parametrize("flags", [["--no-depth"], ["--no-depth",
                                                    "--offline-split"]])
def test_offline_without_depth_is_a_usage_error(flags, tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        _example("torch_run_tum").main(
            [YAML, str(tmp_path), "--device", "cpu", "--offline", *flags])
    assert exc.value.code == 2
    assert "--offline requires the depth pipeline" in capsys.readouterr().err


def test_default_device_is_the_card(tmp_path):
    """Without a CUDA device the CLI's default device raises: there is no
    fall-back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="not available"):
        _example("torch_run_tum").main([YAML, str(tmp_path)])


def _trajectory(path):
    rows = np.loadtxt(path, ndmin=2)
    return rows[:, 0], rows[:, 1:]


def test_slam_mode_cli_is_run_slam_mode_on_the_checkpoint(runs):
    """``--slam-mode --checkpoint`` on the whole run: trajectory_refined.txt
    and objects_slam.txt are the port's run_slam_mode on the checkpoint read
    back with the port's load_state, in the JAX package's file formats, and
    the graph packed from that checkpoint is JAX's build_slam_graph on the
    same .npz read by JAX's load_state, array for array."""
    import re

    from object_oriented_slam_tpu.backend.lm import LMConfig as JLMConfig
    from object_oriented_slam_tpu.io.writers import \
        save_objects as jax_save_objects
    from object_oriented_slam_tpu.system.checkpoint import \
        load_state as jax_load_state
    from object_oriented_slam_tpu.system.slam_mode import \
        build_slam_graph as jax_build_slam_graph
    from object_oriented_slam_tpu_torch.backend import LMConfig
    from object_oriented_slam_tpu_torch.system.checkpoint import load_state
    from object_oriented_slam_tpu_torch.system.slam_mode import (
        build_slam_graph, run_slam_mode)

    out, slam, log = runs[1], runs[2], runs[3]
    ckpt = os.path.join(os.path.dirname(out["port"]), "full.npz")
    state = load_state(ckpt)
    poses, objs, chi2 = run_slam_mode(state, slam.tracker.K,
                                      LMConfig(iters=10), device="cpu")
    line = next(ln for ln in log.splitlines() if ln.startswith("SLAM mode:"))
    assert line == (f"SLAM mode: refined {len(poses)} poses, {len(objs)} "
                    f"objects (chi2 {chi2:.4g})")
    assert len(poses) == 12 and len(objs) >= 5
    ts, traj = _trajectory(os.path.join(out["port"], "trajectory_refined.txt"))
    np.testing.assert_allclose(ts, state.frames_ts, rtol=0, atol=5e-7)
    np.testing.assert_allclose(traj, poses, rtol=0, atol=1e-9)
    with open(os.path.join(out["port"], "trajectory_refined.txt")) as f:
        assert all(re.fullmatch(r"\d+\.\d{6}( -?\d+\.\d{9}){7}", ln)
                   for ln in f.read().splitlines())
    insts = sorted(objs)
    want = os.path.join(os.path.dirname(out["port"]), "objects_slam_jax.txt")
    jax_save_objects(want, insts, np.stack([objs[i] for i in insts]))
    with open(want) as f, open(os.path.join(out["port"],
                                            "objects_slam.txt")) as g:
        assert g.read() == f.read()
    jg, jinsts = jax_build_slam_graph(jax_load_state(ckpt), JLMConfig())
    tg, tinsts = build_slam_graph(state, LMConfig(), device="cpu")
    assert tinsts == jinsts
    for name in slam_ba.JAX_FIELDS:
        a, b = getattr(tg, name).numpy(), np.asarray(getattr(jg, name))
        assert a.shape == b.shape and np.array_equal(a, b), name


def test_recorded_state_matches_jax(runs):
    """What SLAM mode refines, as each package records it: the graph the
    port packs from its whole run's checkpoint against the graph JAX packs
    from the JAX CLI's checkpoint of the same export.  The same edges,
    frames and weights; the camera poses equal; the objects' centres and
    sorted scales and the 3D measurements (camera frame) within TOL, the
    run's own LM round-off: a fault in the frame a recorded observation
    is expressed in would move them by the camera's distance."""
    from object_oriented_slam_tpu.backend.lm import LMConfig as JLMConfig
    from object_oriented_slam_tpu.system.checkpoint import \
        load_state as jax_load_state
    from object_oriented_slam_tpu.system.slam_mode import \
        build_slam_graph as jax_build_slam_graph
    from object_oriented_slam_tpu_torch.backend import LMConfig
    from object_oriented_slam_tpu_torch.system.checkpoint import load_state
    from object_oriented_slam_tpu_torch.system.slam_mode import \
        build_slam_graph

    tmp = os.path.dirname(runs[1]["port"])
    tg, tinsts = build_slam_graph(load_state(os.path.join(tmp, "full.npz")),
                                  LMConfig(), device="cpu")
    jg, jinsts = jax_build_slam_graph(
        jax_load_state(os.path.join(tmp, "jax.npz")), JLMConfig())
    assert tinsts == jinsts
    got = {k: getattr(tg, k).numpy() for k in slam_ba.JAX_FIELDS}
    want = {k: np.asarray(getattr(jg, k)) for k in slam_ba.JAX_FIELDS}
    for name in slam_ba.JAX_FIELDS:
        assert got[name].shape == want[name].shape, name
    for name in (*slam_ba.INDEX_FIELDS, *slam_ba.MASK_FIELDS):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for name in ("poses_cw", "e2_bbox", "e2_w", "e3_w", "odo_meas", "odo_w",
                 "grav_w"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    live = want["e3_w"] != 0
    assert live.sum() >= 12
    np.testing.assert_allclose(got["e3_meas"][live], want["e3_meas"][live],
                               atol=TOL)
    om = want["obj_mask"]
    np.testing.assert_allclose(got["objects"][om, :3],
                               want["objects"][om, :3], atol=TOL)
    np.testing.assert_allclose(np.sort(got["objects"][om, 7:], 1),
                               np.sort(want["objects"][om, 7:], 1), atol=TOL)
