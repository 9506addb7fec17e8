"""Port parity of the 2D-only mapping loop (System without an extractor;
the depth path is tests/test_torch_depth_slice.py) against the JAX package, and the checkpoint hand-over from a
JAX run to the port.

One 8-object, 30-frame synthetic sequence (io/synthetic.py) with the
in-repo settings file goes through both Systems with the same detections.
The CPU tests ask for the CPU (``device="cpu"``): the port's entry points
default to the CUDA device.  Tolerance: the same initialized instances, centres and sorted scales
within 2e-3 (f32 LM round-off accumulated over the run, the class of
tests/test_lm_soa.py); quaternions are not compared, since a near
z-symmetric object may flip its yaw along a flat direction of the cost.
"""
import os

import numpy as np
import pytest
import torch

from object_oriented_slam_tpu.io import synthetic as jsyn
from object_oriented_slam_tpu.system import System as JSystem
from object_oriented_slam_tpu.system import checkpoint as jckpt
from object_oriented_slam_tpu_torch.io import synthetic as tsyn
from object_oriented_slam_tpu_torch.io.config import Config
from object_oriented_slam_tpu_torch.system import System, Tracking
from object_oriented_slam_tpu_torch.system import checkpoint as tckpt

torch.set_num_threads(1)    # the test workers share the CPU

YAML = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "object_oriented_slam_tpu_torch", "configs",
                    "synthetic_2d.yaml")
SCENE_KW = dict(n_objects=8, seed=7, radius_range=(1.3, 2.2),
                scale_range=(0.2, 0.4))
DATA_KW = dict(n_frames=30, orbit_radius=3.6, height=1.7)
SPLIT = 26          # checkpoint after this many frames
TOL = 2e-3


def _frames():
    scene = tsyn.make_scene(**SCENE_KW)
    return scene, list(tsyn.SyntheticDataset(scene, **DATA_KW).frames())


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX System over the sequence, checkpointed after SPLIT frames."""
    scene, frames = _frames()
    tmp = tmp_path_factory.mktemp("jax_run")
    ckpt = str(tmp / "state.npz")
    slam = JSystem(YAML)
    for i, ts, pose, depth, rgb, det in frames:
        slam.track_with_objects(ts, pose, det)
        if i == SPLIT - 1:
            slam.tracker.sync()
            jckpt.save_state(slam.tracker.state, ckpt)
    slam.save_object_history(str(tmp / "object_history.txt"))
    return scene, frames, slam.map_objects, ckpt, str(tmp / "object_history.txt")


def _history(path):
    """object_history.txt -> {instance: [rows, 11] (n_obs, valid, vec9)}."""
    lines = open(path).read().split("\n")
    out, i = {}, 1
    for _ in range(int(lines[0])):
        inst, n = (int(x) for x in lines[i].split())
        out[inst] = np.array([[float(x) for x in ln.split()]
                              for ln in lines[i + 1:i + 1 + n]])
        i += 1 + n
    return out


def _assert_maps_close(got, want):
    assert sorted(got) == sorted(want) and len(want) >= 6
    for inst in want:
        np.testing.assert_allclose(got[inst][:3], want[inst][:3], atol=TOL)
        np.testing.assert_allclose(np.sort(got[inst][7:]),
                                   np.sort(want[inst][7:]), atol=TOL)


def test_slice_matches_jax(jax_run, tmp_path):
    scene, frames, want, _, jhist = jax_run
    slam = System(YAML, device="cpu")
    for i, ts, pose, depth, rgb, det in frames:
        slam.track_with_objects(ts, pose, det, depth=depth)
    got = slam.map_objects
    _assert_maps_close(got, want)
    # and the map is the scene (noise-free detections)
    err = [np.linalg.norm(v[:3] - scene.ellipsoids[i][:3])
           for i, v in got.items()]
    assert np.median(err) < 0.05, err
    path = str(tmp_path / "objects.txt")
    slam.save_objects_to_file(path)
    rows = np.loadtxt(path, ndmin=2)
    assert rows.shape == (len(got), 11)
    np.testing.assert_array_equal(rows[:, 0], sorted(got))
    # object_history.txt: one row per LM call per instance, the same
    # observation counts, centres within the map tolerance
    slam.save_object_history(str(tmp_path / "object_history.txt"))
    hist, jh = _history(str(tmp_path / "object_history.txt")), _history(jhist)
    assert sorted(hist) == sorted(jh)
    for inst in jh:
        assert hist[inst].shape == jh[inst].shape
        np.testing.assert_array_equal(hist[inst][:, :2], jh[inst][:, :2])
        np.testing.assert_allclose(hist[inst][:, 2:5], jh[inst][:, 2:5],
                                   atol=TOL)


def test_checkpoint_handover_from_jax(jax_run, tmp_path):
    """A JAX run's checkpoint resumes in the port and ends where the JAX
    run ends."""
    _, frames, want, ckpt, _ = jax_run
    slam = System(YAML, device="cpu")
    slam.tracker.restore_state(tckpt.load_state(ckpt))
    # the per-LM-call object_list.txt dump (Optimizer.WriteObjectList.Open)
    slam.tracker.write_object_list = True
    slam.tracker.object_list_path = str(tmp_path / "object_list.txt")
    for i, ts, pose, depth, rgb, det in frames[SPLIT:]:
        slam.track_with_objects(ts, pose, det)
    _assert_maps_close(slam.map_objects, want)
    assert len(slam.tracker.state.frames_pose_wc) == len(frames)
    listed = open(slam.tracker.object_list_path).read().splitlines()
    assert [int(ln.split("\t")[0]) for ln in listed] == sorted(want)


def test_checkpoint_written_by_port_loads_in_jax(jax_run, tmp_path):
    """The port writes the JAX package's .npz format: a JAX checkpoint
    loaded and saved again by the port loads in JAX unchanged."""
    ckpt = jax_run[3]
    path = str(tmp_path / "port_state.npz")
    tckpt.save_state(tckpt.load_state(ckpt), path)
    want, got = jckpt.load_state(ckpt), jckpt.load_state(path)
    np.testing.assert_array_equal(np.stack(got.frames_pose_wc),
                                  np.stack(want.frames_pose_wc))
    assert got.frames_ts == want.frames_ts
    assert (got.ground_plane, got.ground_state) \
        == (want.ground_plane, want.ground_state)
    assert sorted(got.objects) == sorted(want.objects)
    for inst, w in want.objects.items():
        g = got.objects[inst]
        assert (g.label, g.initialized, g.init_by_3d) \
            == (w.label, w.initialized, w.init_by_3d)
        for name in ("vec10", "obs2d_pose_cw", "obs2d_pose_wc", "obs2d_bbox",
                     "obs2d_prob", "obs2d_frame", "obs3d_pose_wc",
                     "obs3d_meas", "obs3d_prob", "obs3d_frame", "history"):
            np.testing.assert_array_equal(np.asarray(getattr(g, name)),
                                          np.asarray(getattr(w, name)))


def test_synthetic_frames_match_jax():
    """The port's generator gives the JAX generator's detections: the same
    scene and trajectory, bboxes within 0.1 px (the f32 conic inverse is
    ill-conditioned, and XLA compiles it with contracted multiply-adds)."""
    scene = tsyn.make_scene(**SCENE_KW)
    jscene = jsyn.make_scene(**SCENE_KW)
    np.testing.assert_array_equal(scene.ellipsoids, jscene.ellipsoids)
    np.testing.assert_array_equal(
        tsyn.orbit_trajectory(12, 3.6, 1.7), jsyn.orbit_trajectory(12, 3.6, 1.7))
    ell = scene.ellipsoids.astype(np.float32)
    for pose in tsyn.orbit_trajectory(6, 3.6, 1.7).astype(np.float32):
        bb, vis = tsyn.project_bboxes(ell, pose, scene.camera)
        jbb, jvis = jsyn.project_bboxes(ell, pose, jscene.camera)
        np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis))
        np.testing.assert_allclose(bb.numpy(), np.asarray(jbb), atol=0.1)


def test_object_tier_grows():
    """More instances than MAX_OBJECTS double the object axis with the
    buffers (and the device warm start) carried over."""
    tr = Tracking(Config(YAML), device="cpu")
    tr._est_prev_dev = torch.ones((tr.MAX_OBJECTS, 10))
    pose = np.array([0, 0, 0, 0, 0, 0, 1.0])
    for inst in range(tr.MAX_OBJECTS + 1):
        tr._append_obs2d(inst, pose, np.array([10.0, 20, 30, 40 + inst]), 0.9)
    assert tr.max_objects == 2 * tr.MAX_OBJECTS
    assert tr._b_views["b2"][tr.MAX_OBJECTS - 1, 0, 3] == 40 + 23
    assert tr._b_views["m2"][:, 0].sum() == tr.MAX_OBJECTS + 1
    assert tuple(tr._est_prev_dev.shape) == (2 * tr.MAX_OBJECTS, 10)
    assert float(tr._est_prev_dev[tr.MAX_OBJECTS:].abs().sum()) == 0.0


def test_default_device_is_cuda_with_no_fallback():
    """Without a device argument the entry points run on the card; on a
    host without CUDA they raise an error that names the device instead of
    falling back, and ``device="cpu"`` runs the plain versions."""
    if torch.cuda.is_available():
        assert System(YAML).tracker.device.type == "cuda"
        assert Tracking(Config(YAML)).device.type == "cuda"
    else:
        for make in (lambda: System(YAML), lambda: Tracking(Config(YAML)),
                     lambda: System(YAML, device="cuda:0")):
            with pytest.raises(RuntimeError, match="cuda"):
                make()
    slam = System(YAML, device="cpu")
    assert slam.tracker.device == torch.device("cpu")
    assert Tracking(Config(YAML), device="cpu").device.type == "cpu"
    scene, frames = _frames()
    for i, ts, pose, depth, rgb, det in frames[:3]:
        assert slam.track_with_objects(ts, pose, det)
    assert slam.tracker._K_dev.device.type == "cpu"


def test_observation_tiers_are_powers_of_two():
    assert Tracking._next_pow2(0, 64, 512) == 64
    assert Tracking._next_pow2(65, 64, 512) == 128
    assert Tracking._next_pow2(9999, 64, 512) == 512
    assert Tracking._next_pow2(33, 32, 256) == 64


@pytest.mark.parametrize("what", [
    "batch_svd_init", "aos_backend", "ground_plane", "dense_builder"])
def test_unported_options_raise(what):
    """What is not ported raises: "ground_plane" is the plane's interactive
    confirmation (the extractors, LM fusion, the plane estimate and its
    latch, the deferred pipeline, the adaptive depth and the asynchronous
    plane are ported: tests/test_torch_pipeline.py,
    tests/test_torch_split_extractor.py, tests/test_torch_lm_fusion.py;
    so are precomputed extraction rows, ``ext_result``:
    tests/test_torch_offline.py, and the distributed backend:
    tests/test_torch_dist.py)."""
    cfg = Config(YAML)
    if what in ("dense_builder", "ground_plane"):
        key = {"dense_builder": "Visualization.Builder.Open",
               "ground_plane": "Plane.MannualCheck.Open"}[what]
        cfg._file[key] = 1.0
        with pytest.raises(NotImplementedError, match=key):
            Tracking(cfg, device="cpu")
        return
    tr = Tracking(cfg, device="cpu")
    act = {
        "batch_svd_init": lambda: setattr(tr, "use_incremental_init", False),
        "aos_backend": lambda: setattr(tr, "use_soa_backend", False),
    }[what]
    with pytest.raises(NotImplementedError):
        act()
    # the supported values stay settable
    tr.pipeline_depth = 1
    tr.fuse_lm = False
    tr.async_plane = False
    tr.open_ground_plane_estimation()
    assert tr.state.ground_state == 1
