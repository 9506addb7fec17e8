"""Port parity of the whole depth path (ground plane, monolithic
extraction, 3D observations and 3D initialisation, the LM with live 3D
edges) against the JAX package on the CPU, and the hand-over of a JAX
checkpoint that carries 3D observations.

One 6-object, 12-frame synthetic sequence rendered by the port; the SAME
depth arrays and detections go through both Systems, eagerly
(``pipeline_depth = 1``), at ``cloud_capacity=2048`` and the default
``cluster_min_size`` (one more case runs at 30, where a thin fragment seeds
an object whose degenerate 2D edge the LM has to leave out).  Tolerance: the same
initialised instances, the same 3D observations (frames equal,
measurements 1e-4), centres and sorted scales within 2e-3 (f32 LM
round-off accumulated over the run, as in tests/test_torch_slice.py);
quaternions are not compared.
"""
import os

import numpy as np
import pytest
import torch

from object_oriented_slam_tpu.core.camera import Camera as JCamera
from object_oriented_slam_tpu.frontend import ExtractorConfig as JExtCfg
from object_oriented_slam_tpu.frontend import make_extractor as jmake_ext
from object_oriented_slam_tpu.frontend import \
    make_plane_estimator as jmake_plane
from object_oriented_slam_tpu.system import System as JSystem
from object_oriented_slam_tpu.system import checkpoint as jckpt
from object_oriented_slam_tpu_torch.frontend import (ExtractorConfig,
                                                     make_extractor,
                                                     make_plane_estimator)
from object_oriented_slam_tpu_torch.io import synthetic as tsyn
from object_oriented_slam_tpu_torch.io.config import Config
from object_oriented_slam_tpu_torch.system import System, Tracking
from object_oriented_slam_tpu_torch.system import checkpoint as tckpt

torch.set_num_threads(1)    # the test workers share the CPU

YAML = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "object_oriented_slam_tpu_torch", "configs",
                    "synthetic_depth.yaml")
SCENE_KW = dict(n_objects=6, seed=3, radius_range=(1.3, 2.2),
                scale_range=(0.2, 0.4))
DATA_KW = dict(n_frames=12, orbit_radius=3.6, height=1.7)
EXT_KW = dict(cloud_capacity=2048)
SPLIT = 9           # checkpoint after this many frames
TOL = 2e-3


def _frames():
    scene = tsyn.make_scene(**SCENE_KW)
    return scene, list(tsyn.SyntheticDataset(scene, **DATA_KW).frames())


@pytest.fixture(autouse=True)
def small_object_tier(monkeypatch):
    """The port's LM batch starts at 8 object slots instead of 24 (6
    objects; empty slots are masked, so results are the same): the plain
    normal equations' cost on the CPU goes with the slots."""
    monkeypatch.setattr(Tracking, "MAX_OBJECTS", 8)


def _port_system(cam, ext_kw=EXT_KW):
    """The port's System, eager like the JAX one it is held against (the
    deferred pipeline against the eager loop: tests/test_torch_pipeline.py)."""
    slam = System(YAML,
                  extractor=make_extractor(cam, ExtractorConfig(**ext_kw),
                                           device="cpu"),
                  plane_estimator=make_plane_estimator(cam, device="cpu"),
                  device="cpu")
    slam.tracker.pipeline_depth = 1
    slam.open_ground_plane_estimation()
    return slam


def _jax_system(cam, ext_kw=EXT_KW):
    jcam = JCamera(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                   scale=cam.scale, width=cam.width, height=cam.height)
    slam = JSystem(YAML, extractor=jmake_ext(jcam, JExtCfg(**ext_kw)),
                   plane_estimator=jmake_plane(jcam))
    slam.tracker.pipeline_depth = 1
    slam.open_ground_plane_estimation()
    return slam


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX System over the sequence, checkpointed after SPLIT frames."""
    scene, frames = _frames()
    ckpt = str(tmp_path_factory.mktemp("jax_depth") / "state.npz")
    slam = _jax_system(scene.camera)
    for i, ts, pose, depth, rgb, det in frames:
        slam.track_with_objects(ts, pose, det, depth=depth)
        if i == SPLIT - 1:
            slam.tracker.sync()
            jckpt.save_state(slam.tracker.state, ckpt)
    return scene, frames, slam.map_objects, slam.tracker.state, ckpt


def _assert_maps_close(got, want, tol_of=None):
    """Centres and sorted scales within TOL, or within ``tol_of[inst]`` for
    the instances named there."""
    assert sorted(got) == sorted(want) and len(want) >= 5
    for inst in want:
        tol = (tol_of or {}).get(inst, TOL)
        np.testing.assert_allclose(got[inst][:3], want[inst][:3], atol=tol)
        np.testing.assert_allclose(np.sort(got[inst][7:]),
                                   np.sort(want[inst][7:]), atol=tol)


def test_depth_slice_matches_jax(jax_run, tmp_path):
    scene, frames, want, jstate, _ = jax_run
    slam = _port_system(scene.camera)
    for i, ts, pose, depth, rgb, det in frames:
        assert slam.track_with_objects(ts, pose, det, depth=depth)
    got = slam.map_objects
    st = slam.tracker.state
    # the plane latched on the first frame, and it is the floor
    assert st.ground_state == 2 == jstate.ground_state
    np.testing.assert_allclose(st.ground_plane, jstate.ground_plane,
                               atol=1e-4)
    assert abs(st.ground_plane[3]) < 0.02 and st.ground_plane[2] > 0.999
    # the same 3D observations, and objects seeded from them
    for inst, jrec in jstate.objects.items():
        rec = st.objects[inst]
        assert rec.obs3d_frame == jrec.obs3d_frame
        assert rec.obs2d_frame == jrec.obs2d_frame
        assert rec.init_by_3d == jrec.init_by_3d
        if jrec.obs3d_meas:
            a, b = np.stack(rec.obs3d_meas), np.stack(jrec.obs3d_meas)
            np.testing.assert_allclose(a[:, :3], b[:, :3], atol=1e-4)
            np.testing.assert_allclose(np.sort(a[:, 7:]), np.sort(b[:, 7:]),
                                       atol=1e-4)
    assert sum(r.init_by_3d for r in st.objects.values()) >= 5
    assert sum(len(r.obs3d_meas) for r in st.objects.values()) >= 20
    _assert_maps_close(got, want)
    # and the map is the scene
    err = [np.linalg.norm(v[:3] - scene.ellipsoids[i][:3])
           for i, v in got.items()]
    assert np.median(err) < 0.05, err
    path = str(tmp_path / "objects.txt")
    slam.save_objects_to_file(path)
    rows = np.loadtxt(path, ndmin=2)
    assert rows.shape == (len(got), 11) and np.isfinite(rows).all()
    # the LM ran with live 3D edges, and the frontend was timed per frame
    assert slam.tracker._b_n3.max() >= 5
    m = slam.tracker.metrics
    assert len(m["dispatch"]) == len(m["fetch"]) == len(frames)


def test_fragment_seed_matches_jax():
    """The sequence at ``cluster_min_size=30``, where a thin fragment passes
    the cluster gate and seeds an object (scales 0.104, 0.018, 0.029).  At
    that estimate a projected conic's minor semi-axis^2 rounds to zero or
    below in one view and its tangent is NaN; the port leaves that edge out
    of the iteration's normal equations (lm_soa.soa_normal_eq_plain) and
    the object moves on, as it does in the JAX run, which gets past the
    same view through another rounding.  So object 3 is held to the
    goldens' map tolerance (0.05), the others to the file's TOL."""
    scene, frames = _frames()
    kw = dict(EXT_KW, cluster_min_size=30)
    jslam = _jax_system(scene.camera, kw)
    slam = _port_system(scene.camera, kw)
    for i, ts, pose, depth, rgb, det in frames:
        jslam.track_with_objects(ts, pose, det, depth=depth)
        slam.track_with_objects(ts, pose, det, depth=depth)
    jrec, rec = jslam.tracker.state.objects[3], slam.tracker.state.objects[3]
    # the same fragment seeds object 3 in both
    assert rec.init_by_3d and jrec.init_by_3d
    assert rec.obs3d_frame == jrec.obs3d_frame
    np.testing.assert_allclose(rec.obs3d_meas[0][7:], jrec.obs3d_meas[0][7:],
                               atol=1e-4)
    assert np.sort(rec.obs3d_meas[0][7:])[0] < 0.03
    _assert_maps_close(slam.map_objects, jslam.map_objects, {3: 0.05})


def test_checkpoint_with_3d_observations_resumes(jax_run):
    """A JAX checkpoint taken mid-run (ground plane latched, 3D
    observations stored, objects initialised from them) resumes in the
    port and ends where the JAX run ends."""
    scene, frames, want, _, ckpt = jax_run
    jstate = jckpt.load_state(ckpt)
    state = tckpt.load_state(ckpt)
    assert state.ground_state == 2
    np.testing.assert_array_equal(state.ground_plane, jstate.ground_plane)
    n3 = 0
    for inst, jrec in jstate.objects.items():
        rec = state.objects[inst]
        assert (rec.initialized, rec.init_by_3d) \
            == (jrec.initialized, jrec.init_by_3d)
        for name in ("obs3d_pose_wc", "obs3d_meas", "obs3d_prob",
                     "obs3d_frame"):
            np.testing.assert_array_equal(np.asarray(getattr(rec, name)),
                                          np.asarray(getattr(jrec, name)))
        n3 += len(rec.obs3d_meas)
    assert n3 >= 10 and any(r.init_by_3d for r in state.objects.values())

    slam = _port_system(scene.camera)
    slam.tracker.restore_state(state)
    tr = slam.tracker
    # the 3D rings are rebuilt from the checkpoint
    assert int(tr._b_n3.sum()) == n3
    assert int(tr._b_views["m3"].sum()) == n3
    for i, ts, pose, depth, rgb, det in frames[SPLIT:]:
        slam.track_with_objects(ts, pose, det, depth=depth)
    _assert_maps_close(slam.map_objects, want)
    assert len(tr.state.frames_pose_wc) == len(frames)
    assert tr.state.ground_state == 2


def test_automatic_association_uses_the_3d_centres():
    """Without manual instances every valid detection is matched by its
    extracted world centre: each object gets one instance, kept over the
    frames, and a detection without a 3D estimate gets none."""
    scene, frames = _frames()
    slam = _port_system(scene.camera)
    slam.close_optimization()
    for i, ts, pose, depth, rgb, det in frames[:4]:
        slam.track_with_objects(ts, pose, det, depth=depth,
                                with_association=False)
    st = slam.tracker.state
    assert 3 <= len(st.objects) <= 6
    centres = np.array([r.vec10[:3] for r in st.objects.values()])
    truth = scene.ellipsoids[:, :3]
    nearest = np.linalg.norm(centres[:, None] - truth[None], axis=2).argmin(1)
    assert len(set(nearest)) == len(nearest)          # one instance each
    assert all(r.init_by_3d and r.obs3d_meas for r in st.objects.values())
    assert max(len(r.obs3d_meas) for r in st.objects.values()) >= 3


def test_no_plane_no_extraction():
    """Until the plane is latched (estimation not opened) no detection is
    extracted, as in the reference's state machine."""
    scene, frames = _frames()
    cam = scene.camera
    calls = []

    def extractor(*args):
        calls.append(args)

    tr = Tracking(Config(YAML), extractor=extractor,
                  plane_estimator=make_plane_estimator(cam, device="cpu"),
                  device="cpu")
    tr.pipeline_depth = 1           # eager: the plane latches in its frame
    tr.open_optimization = False
    i, ts, pose, depth, rgb, det = frames[0]
    tr.grab_pose_and_objects(ts, pose, det, depth)
    assert not calls and tr.state.ground_state == 0
    tr.open_ground_plane_estimation()
    tr.grab_pose_and_objects(ts, pose, det, None)       # no depth: stays 1
    assert not calls and tr.state.ground_state == 1
    tr.grab_pose_and_objects(ts, pose, det, depth)
    assert len(calls) == 1 and tr.state.ground_state == 2
    # border and unassociated detections are gated out (c1, c3)
    base = tr.run_gates(det, True)
    assert base[:3].all()
    det2 = det.copy()
    det2[0, 7] = -1
    det2[1, 1:5] = [0.0, 100.0, 50.0, 200.0]
    run = tr.run_gates(det2, True)
    assert not run[0] and not run[1]
    np.testing.assert_array_equal(run[2:], base[2:])
    assert tr.run_gates(det2, False)[0]
