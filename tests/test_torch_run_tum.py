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
import json
import os
import re
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
                        "mono", "--checkpoint", str(tmp / "jax.npz"),
                        "--build-dense", "--viz-live", "5"])
    slam, log = _port_cli([YAML, seq, "--out", out["port"], *MONO,
                           "--slam-mode", "--checkpoint",
                           str(tmp / "full.npz"), "--build-dense",
                           "--viz-live", "5"])
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


def _map_rows(path):
    """The vertex rows of a map.ply (x y z r g b) or map.pcd (x y z rgb)."""
    with open(path) as f:
        lines = f.read().splitlines()
    end = next(i for i, ln in enumerate(lines)
               if ln in ("end_header", "DATA ascii"))
    return np.array([[float(v) for v in ln.split()]
                     for ln in lines[end + 1:]]).reshape(-1, 6 if path
                                                         .endswith("ply")
                                                         else 4)


def _same_map(mine, theirs):
    """The port's map file against JAX's.  XLA's jitted back-projection
    rounds some coordinates an ulp apart from the eager one, and a point
    that sits on a cell boundary then lands in the next cell: over a run
    the maps may differ by a few cells.  So: the point counts within 1e-4
    relative (and within 2), and all but 1e-4 of each map's points within
    one unit of the 4th decimal of a point of the other (PLY colours of
    those within one level: a truncated mean)."""
    from scipy.spatial import cKDTree
    a, b = _map_rows(mine), _map_rows(theirs)
    assert a.shape[1] == b.shape[1] and len(a) > 0
    assert abs(len(a) - len(b)) <= max(2, 1e-4 * len(b))
    for x, y in ((a, b), (b, a)):
        dist, idx = cKDTree(y[:, :3]).query(x[:, :3])
        near = dist <= 1.5e-4 * np.sqrt(3)
        assert (~near).sum() <= max(2, 1e-4 * len(x))
        if x.shape[1] == 6:
            assert np.abs(x[near, 3:] - y[idx[near], 3:]).max() <= 1


def _live_data(d):
    """The JSON that live.html embeds."""
    html = open(os.path.join(d, "live.html")).read()
    assert html.count("<script>") == 1
    m = re.search(r"const DATA = (\{.*?\});\n", html, re.S)
    return json.loads(m.group(1))


@pytest.mark.parametrize("flags", [
    ["--build-dense"], ["--map-format", "pcd"], ["--viz"],
    ["--viz-live", "5"]])
def test_unported_flags_raise(flags, runs, tmp_path):
    """The four flags were unported and are ported now.  ``--build-dense``
    and ``--map-format``: the whole runs (``runs``) take ``--build-dense``
    on both sides and write map.ply; a 2-frame 2D-only run of each CLI with
    ``--build-dense --map-format pcd`` writes map.pcd.  Each port map
    against JAX's (``_same_map``).  ``--viz-live 5``: the whole runs take
    it on both sides; live.html's data (the map of the last frame, the
    trajectory, the plane, the image panels) against JAX's at the run's
    tolerance.  ``--viz``: a 3-frame run of each CLI at ``--pipeline-depth
    1`` (the map drawn at each frame is that frame's; objects seeded from
    3D from the first frame on): the same frame_XXXX.png files, their
    images against JAX's (60 pixels of 921,600 differed when this was
    written: an ellipse outline one pixel apart), and map.png."""
    seq, out, slam = runs[:3]
    if flags[0] == "--build-dense":
        builder = slam.tracker.dense_builder
        assert builder is None                     # the external builder
        _same_map(os.path.join(out["port"], "map.ply"),
                  os.path.join(out["jax"], "map.ply"))
        return
    if flags[0] == "--map-format":
        argv = [YAML, seq, "--no-depth", "--max-frames", "2",
                "--build-dense", *flags]
        port, log = _port_cli(argv[:2] + ["--out", str(tmp_path / "p"),
                                          "--device", "cpu"] + argv[2:])
        jlog = _jax_cli(argv[:2] + ["--out", str(tmp_path / "j")] + argv[2:])
        assert "Saved dense map.pcd" in log and "Saved dense map.pcd" in jlog
        _same_map(str(tmp_path / "p" / "map.pcd"),
                  str(tmp_path / "j" / "map.pcd"))
        return
    if flags[0] == "--viz-live":
        got, want = _live_data(out["port"]), _live_data(out["jax"])
        assert got["title"] == want["title"] == \
            f"live map — frame {DATA_KW['n_frames']}"
        assert got["reload_s"] == want["reload_s"] == 1.0
        assert [o["id"] for o in got["objects"]] == \
            [o["id"] for o in want["objects"]]
        assert len(want["objects"]) >= 4
        for o, w in zip(got["objects"], want["objects"]):
            np.testing.assert_allclose(o["vec10"][:3], w["vec10"][:3],
                                       atol=TOL)
            np.testing.assert_allclose(np.sort(o["vec10"][7:]),
                                       np.sort(w["vec10"][7:]), atol=TOL)
        np.testing.assert_allclose(got["traj"], want["traj"], atol=1e-4)
        np.testing.assert_allclose(got["plane"], want["plane"], atol=2e-3)
        assert len(got["frusta"]) == len(want["frusta"])
        assert sorted(got["history"]) == sorted(want["history"])
        for k in want["history"]:
            assert len(got["history"][k]) == len(want["history"][k])
        # the last frame's RGB and depth panels, base64 JPEGs of the same
        # renders: the depth panel byte for byte
        assert [p["name"] for p in got["panels"]] == \
            [p["name"] for p in want["panels"]] == ["frame", "depth"]
        assert got["panels"][1]["b64"] == want["panels"][1]["b64"]
        assert got["clouds"] == want["clouds"]
        return
    cv2 = pytest.importorskip("cv2")
    argv = [YAML, seq, "--extractor", "mono", "--max-frames", "3",
            "--pipeline-depth", "1", "--viz"]
    _, log = _port_cli(argv[:2] + ["--out", str(tmp_path / "p"),
                                   "--device", "cpu"] + argv[2:])
    jlog = _jax_cli(argv[:2] + ["--out", str(tmp_path / "j")] + argv[2:])
    assert "Saved map.png" in log and "Saved map.png" in jlog
    names = sorted(f for f in os.listdir(tmp_path / "j")
                   if f.startswith("frame_"))
    assert len(names) == 3 and names == sorted(
        f for f in os.listdir(tmp_path / "p") if f.startswith("frame_"))
    differ = red = 0
    for name in names:
        a = cv2.imread(str(tmp_path / "p" / name))
        b = cv2.imread(str(tmp_path / "j" / name))
        assert a.shape == b.shape == (480, 640, 3)
        differ += int((a != b).any(-1).sum())
        red += int(((b[..., 2] == 255) & (b[..., 0] == 0)).sum())
    assert red > 1000       # the map's ellipses are drawn (3D-seeded)
    # the boxes are the same pixels; a projected map ellipse's centre and
    # axes are truncated to whole pixels from the f32 LM's estimate (within
    # TOL of JAX's), so an outline may step by one pixel
    assert differ <= 1e-3 * len(names) * 480 * 640, differ
    assert cv2.imread(str(tmp_path / "p" / "map.png")) is not None


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
