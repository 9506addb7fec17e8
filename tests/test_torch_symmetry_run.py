"""Port parity of a whole run with symmetry completion against the JAX
package on the CPU: System over 8 frames of the 6-object depth scene with
two dual reflections (label 28), three reflections and one object without a
prior, from configs/synthetic_depth_sym.yaml (EllipsoidExtraction.Symmetry.
Open: 1), the port on ``device="cpu"`` beside the JAX package on the same
frames, eagerly.  Tolerance: the same instances and 3D observation frames,
centres and sorted scales within tests/test_torch_depth_slice.py's 2e-3.
"""
import os

import numpy as np
import torch

from object_oriented_slam_tpu.core.camera import Camera as JCamera
from object_oriented_slam_tpu.frontend import ExtractorConfig as JExtCfg
from object_oriented_slam_tpu.frontend import make_extractor as jmake_ext
from object_oriented_slam_tpu.frontend import \
    make_plane_estimator as jmake_plane
from object_oriented_slam_tpu.system import System as JSystem
from object_oriented_slam_tpu_torch.frontend import (ExtractorConfig,
                                                     make_extractor,
                                                     make_plane_estimator)
from object_oriented_slam_tpu_torch.io import synthetic as tsyn
from object_oriented_slam_tpu_torch.system import System, Tracking

torch.set_num_threads(1)    # the test workers share the CPU

YAML = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "object_oriented_slam_tpu_torch", "configs",
                    "synthetic_depth_sym.yaml")
LABELS = [28, 57, 58, 28, 63, 59]


def test_whole_run_with_symmetry_matches_jax(monkeypatch):
    """System over 8 frames of the 6-object scene with LABELS and
    configs/synthetic_depth_sym.yaml, port (device cpu) against the JAX
    package on the same frames: the same instances, centres and sorted
    scales within the depth slice's 2e-3."""
    monkeypatch.setattr(Tracking, "MAX_OBJECTS", 8)
    scene = tsyn.make_scene(n_objects=6, seed=7, radius_range=(1.3, 2.2),
                            scale_range=(0.2, 0.4), labels=LABELS)
    frames = list(tsyn.SyntheticDataset(scene, n_frames=8, orbit_radius=3.6,
                                        height=1.7).frames())
    cam = scene.camera
    jcam = JCamera(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                   scale=cam.scale, width=cam.width, height=cam.height)
    kw = dict(cloud_capacity=2048, open_symmetry=True)
    slam = System(YAML, extractor=make_extractor(cam, ExtractorConfig(**kw),
                                                 device="cpu"),
                  plane_estimator=make_plane_estimator(cam, device="cpu"),
                  device="cpu")
    jslam = JSystem(YAML, extractor=jmake_ext(jcam, JExtCfg(**kw)),
                    plane_estimator=jmake_plane(jcam))
    for s in (slam, jslam):
        # eager, so the extractor's stats after a frame are that frame's
        s.tracker.pipeline_depth = 1
        s.open_ground_plane_estimation()
    duals = []
    for i, ts, pose, depth, rgb, det in frames:
        slam.track_with_objects(ts, pose, det, depth=depth)
        jslam.track_with_objects(ts, pose, det, depth=depth)
        duals.append(slam.tracker.extractor.stats["sym_dual"])
    got, want = slam.map_objects, jslam.map_objects
    assert sorted(got) == sorted(want) and len(want) >= 5
    for inst in want:
        np.testing.assert_allclose(got[inst][:3], want[inst][:3], atol=2e-3)
        np.testing.assert_allclose(np.sort(got[inst][7:]),
                                   np.sort(want[inst][7:]), atol=2e-3)
    st, jst = slam.tracker.state, jslam.tracker.state
    for inst, jrec in jst.objects.items():
        assert st.objects[inst].obs3d_frame == jrec.obs3d_frame
    # symmetry ran: dual detections on every frame, probs below 1 stored
    assert all(duals)
    assert any(p < 1 for r in st.objects.values() for p in r.obs3d_prob)
    err = [np.linalg.norm(v[:3] - scene.ellipsoids[i][:3])
           for i, v in got.items()]
    assert np.median(err) < 0.05, err
