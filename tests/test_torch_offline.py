"""The port's offline batch mapper (system/offline.py) against the JAX
package's and against the port's own online loop, on the CPU.

One 3-object, 10-frame depth sequence of the port's generator (seed 11,
tests/test_torch_lm_fusion.py's), rendered once: frame 0 bootstraps the
ground plane through the per-frame path, the 9 others go in batches of
B = 4 (4 + 4 + a tail of 1 padded with empty frames).  For the plain LM's
CPU cost the port's batch starts at 4 object slots and every run, the JAX
one included, takes 3 LM iterations a call.  Held here:
  * ``backend_per_batch=False`` (the online BA schedule): the port's map
    within 2e-3 of the JAX package's OfflineMapper (the CLI's TOL,
    tests/test_torch_run_tum.py) on centres and sorted scales, the same
    instances; within 1e-3 of the port's online map (JAX's own bound,
    tests/test_offline_batch.py) with equal observation counts;
  * the default per-batch BA at B = 2 (so that the deferred window, 4 B
    frames, runs BA on fewer frames than online): fewer LM calls than
    online, every object's 3D IoU against the online map above 0.65 and
    its centre within 5e-2 (as JAX's
    test_offline_throughput_mode_close_to_online);
  * the split protocol, with and without the u16 phase A, against the
    monolithic offline map within 1e-4;
  * no fall-back: ``mesh=`` raises naming ROADMAP.md queue 1 item 8, and
    ``split=True`` raises where cluster.cpp does not build.
"""
import os

import numpy as np
import pytest

from object_oriented_slam_tpu.core.camera import Camera as JCamera
from object_oriented_slam_tpu.frontend import ExtractorConfig as JExtCfg
from object_oriented_slam_tpu.frontend import make_extractor as jmake_ext
from object_oriented_slam_tpu.frontend import \
    make_plane_estimator as jmake_plane
from object_oriented_slam_tpu.system import System as JSystem
from object_oriented_slam_tpu.system.offline import \
    OfflineMapper as JOfflineMapper
from object_oriented_slam_tpu_torch.frontend import (ExtractorConfig,
                                                     make_extractor,
                                                     make_plane_estimator)
from object_oriented_slam_tpu_torch.frontend import batch_extractor as bx
from object_oriented_slam_tpu_torch.io import native_loader as tnl
from object_oriented_slam_tpu_torch.io import synthetic as tsyn
from object_oriented_slam_tpu_torch.system import System, Tracking
from object_oriented_slam_tpu_torch.system.metrics import object_map_iou
from object_oriented_slam_tpu_torch.system.offline import OfflineMapper

YAML = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "object_oriented_slam_tpu_torch", "configs",
                    "synthetic_depth.yaml")
SCENE_KW = dict(n_objects=3, seed=11, radius_range=(1.3, 2.0),
                scale_range=(0.2, 0.35))
EXT_KW = dict(cloud_capacity=2048)
N_FRAMES = 10
BATCH = 4
LM_ITERS = 3
TOL = 2e-3


@pytest.fixture(scope="module")
def sequence():
    scene = tsyn.make_scene(**SCENE_KW)
    return scene, list(tsyn.SyntheticDataset(
        scene, n_frames=N_FRAMES, orbit_radius=3.6, height=1.7).frames())


def _port_system(scene):
    cam = scene.camera
    slam = System(YAML, extractor=make_extractor(cam, ExtractorConfig(
        **EXT_KW), device="cpu"),
        plane_estimator=make_plane_estimator(cam, device="cpu"),
        device="cpu")
    slam.open_ground_plane_estimation()
    slam.tracker.lm_cfg = slam.tracker.lm_cfg._replace(iters=LM_ITERS)
    return slam


def _offline(sequence, batch=BATCH, **kw):
    scene, frames = sequence
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Tracking, "MAX_OBJECTS", 4)
        slam = _port_system(scene)
        mapper = OfflineMapper(slam, scene.camera, ExtractorConfig(**EXT_KW),
                               batch_size=batch, **kw)
        stats = mapper.run(iter(frames))
    return slam, mapper, stats


_RUNS = {}


def _cached(name, fn):
    if name not in _RUNS:
        _RUNS[name] = fn()
    return _RUNS[name]


@pytest.fixture(scope="module")
def online(sequence):
    scene, frames = sequence
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Tracking, "MAX_OBJECTS", 4)
        slam = _port_system(scene)
        for i, ts, pose, depth, rgb, det in frames:
            slam.track_with_objects(ts, pose, det, depth=depth)
        slam.tracker.sync()
    return slam


def _per_frame_ba(sequence):
    return _cached("per_frame_ba", lambda: _offline(
        sequence, backend_per_batch=False))


def _same_instances(got, want):
    assert sorted(got) == sorted(want) and len(want) >= 2


def test_offline_matches_jax_offline(sequence):
    slam, mapper, stats = _per_frame_ba(sequence)
    scene, frames = sequence
    cam = scene.camera
    jcam = JCamera(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                   scale=cam.scale, width=cam.width, height=cam.height)
    jslam = JSystem(YAML, extractor=jmake_ext(jcam, JExtCfg(**EXT_KW)),
                    plane_estimator=jmake_plane(jcam))
    jslam.tracker.lm_cfg = jslam.tracker.lm_cfg._replace(iters=LM_ITERS)
    jslam.open_ground_plane_estimation()
    jmapper = JOfflineMapper(jslam, jcam, JExtCfg(**EXT_KW),
                             batch_size=BATCH, backend_per_batch=False)
    jstats = jmapper.run(iter(frames))
    assert stats["frames"] == jstats["frames"] == N_FRAMES
    assert mapper.batches_dispatched == jmapper.batches_dispatched == 3
    got, want = slam.map_objects, jslam.map_objects
    _same_instances(got, want)
    for inst in want:
        np.testing.assert_allclose(got[inst][:3], want[inst][:3], atol=TOL)
        np.testing.assert_allclose(np.sort(got[inst][7:]),
                                   np.sort(want[inst][7:]), atol=TOL)
    for inst in want:
        r, jr = slam.tracker.state.objects[inst], \
            jslam.tracker.state.objects[inst]
        assert len(r.obs3d_meas) == len(jr.obs3d_meas)
        assert len(r.obs2d_bbox) == len(jr.obs2d_bbox)


def test_offline_matches_online(sequence, online):
    slam, mapper, stats = _per_frame_ba(sequence)
    tr, otr = slam.tracker, online.tracker
    got, want = slam.map_objects, online.map_objects
    _same_instances(got, want)
    for inst in want:
        np.testing.assert_allclose(got[inst], want[inst], atol=1e-3)
        r, o = tr.state.objects[inst], otr.state.objects[inst]
        assert len(r.obs3d_meas) == len(o.obs3d_meas) > 0
        assert len(r.obs2d_bbox) == len(o.obs2d_bbox)
    assert tr._backend_calls == otr._backend_calls
    # the run's overrides are put back; every batch was read
    assert tr.pipeline_depth == 4 and tr.adaptive_depth and tr.async_plane
    assert [s["frames"] for s in mapper.batch_stats] == [BATCH] * 3
    assert all(s["cluster_converged"] for s in mapper.batch_stats)
    bits = all(np.array_equal(got[i], want[i]) for i in want)
    print(f"offline (per-frame BA) map bit-equal to the online map: {bits}")


def test_per_batch_ba_close_to_online(sequence, online):
    slam, mapper, _ = _cached("per_batch", lambda: _offline(sequence,
                                                            batch=2))
    got, want = slam.map_objects, online.map_objects
    _same_instances(got, want)
    assert slam.tracker._backend_calls < online.tracker._backend_calls
    iou = object_map_iou(got, want)
    assert min(iou.values()) > 0.65, iou
    for inst in want:
        np.testing.assert_allclose(got[inst][:3], want[inst][:3], atol=5e-2)


@pytest.mark.parametrize("quant", [True, False])
def test_split_offline_matches_monolithic(sequence, quant):
    slam, mapper, _ = _offline(sequence, backend_per_batch=False,
                               split=True, split_quant=quant)
    mono = _per_frame_ba(sequence)[0]
    assert mapper.split and mapper.split_quant == quant
    assert all("cluster_survivors" in s and "cluster_rounds" not in s
               for s in mapper.batch_stats)
    got, want = slam.map_objects, mono.map_objects
    _same_instances(got, want)
    for inst in want:
        np.testing.assert_allclose(got[inst], want[inst], atol=1e-4)
    print(f"split (quantized {quant}) bit-equal to the monolithic offline "
          f"map: {all(np.array_equal(got[i], want[i]) for i in want)}")


def test_mesh_raises_naming_the_distributed_item(sequence):
    scene = sequence[0]
    slam = System(YAML, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1, item 8"):
        OfflineMapper(slam, scene.camera, ExtractorConfig(), mesh=object())
    fb = bx.pack_frames_batch(
        scene.camera, ExtractorConfig(**EXT_KW),
        [(np.zeros((480, 640), np.uint16), np.zeros((0, 4)),
          np.zeros(0, int), np.zeros(0, bool),
          np.array([0, 0, 0, 0, 0, 0, 1.0]))],
        np.array([0, 0, 1.0, 0]))
    with pytest.raises(NotImplementedError, match="queue 1, item 8"):
        bx.dispatch_batch(fb, scene.camera, mesh=object(), device="cpu")


def test_split_raises_without_the_cluster_library(sequence, tmp_path,
                                                  monkeypatch):
    bad = tmp_path / "cluster.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnl, "CLUSTER_SOURCE", str(bad))
    monkeypatch.setattr(tnl, "_CLUSTER_LIB", None)
    monkeypatch.setattr(tnl, "_CLUSTER_ERROR", None)
    slam = System(YAML, device="cpu")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed .*error"):
        OfflineMapper(slam, sequence[0].camera, ExtractorConfig(),
                      split=True)


def test_batched_call_defaults_to_the_card(sequence):
    """Without a CUDA device the batched call's default device raises:
    there is no fall-back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    scene = sequence[0]
    fb = bx.pack_frames_batch(
        scene.camera, ExtractorConfig(**EXT_KW),
        [(np.zeros((480, 640), np.uint16), np.zeros((0, 4)),
          np.zeros(0, int), np.zeros(0, bool),
          np.array([0, 0, 0, 0, 0, 0, 1.0]))], np.array([0, 0, 1.0, 0]))
    for call in (lambda: bx.dispatch_batch(fb, scene.camera),
                 lambda: bx.dispatch_batch_phase_a(fb, scene.camera)):
        with pytest.raises(RuntimeError, match="not available"):
            call()
