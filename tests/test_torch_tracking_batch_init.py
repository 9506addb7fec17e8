"""Port parity: the tracker's batch SVD initialization path
(``use_incremental_init = False``: observations padded to the next power
of two from 16, the packed [11] result, one host fetch per attempt) on a
short synthetic 2D sequence against the JAX package's tracker on the same
path, the same detections handed to both, 3 LM iterations a call on both
sides (the plain LM's CPU cost).

Tolerance: the same initialized instances at every frame, centres and
sorted scales within 2e-3 (tests/test_torch_slice.py's class: f32 LM
round-off accumulated over the run).
"""
import os

import numpy as np
import pytest
import torch

from object_oriented_slam_tpu.system import System as JSystem
from object_oriented_slam_tpu_torch.io import synthetic as tsyn
from object_oriented_slam_tpu_torch.system import System

torch.set_num_threads(1)    # the test workers share the CPU

YAML = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "object_oriented_slam_tpu_torch", "configs",
                    "synthetic_2d.yaml")
SCENE_KW = dict(n_objects=8, seed=7, radius_range=(1.3, 2.2),
                scale_range=(0.2, 0.4))
DATA_KW = dict(n_frames=20, orbit_radius=3.6, height=1.7)
TOL = 2e-3


def _batch_init(slam):
    tr = slam.tracker
    tr.use_incremental_init = False
    tr.lm_cfg = tr.lm_cfg._replace(iters=3)
    return slam


@pytest.fixture(scope="module")
def runs():
    """Both trackers over the sequence; their initialized instances after
    every frame, and the final maps."""
    scene = tsyn.make_scene(**SCENE_KW)
    frames = list(tsyn.SyntheticDataset(scene, **DATA_KW).frames())
    port = _batch_init(System(YAML, device="cpu"))
    ref = _batch_init(JSystem(YAML))
    port.tracker.pipeline_depth = ref.tracker.pipeline_depth = 1
    inits = []
    for i, ts, pose, depth, rgb, det in frames:
        port.track_with_objects(ts, pose, det)
        ref.track_with_objects(ts, pose, det)
        inits.append((sorted(port.tracker.state.initialized_instances()),
                      sorted(ref.tracker.state.initialized_instances())))
    return scene, port, ref, inits


def test_batch_init_tracker_matches_jax(runs):
    scene, port, ref, inits = runs
    for mine, theirs in inits:
        assert mine == theirs
    got, want = port.map_objects, ref.map_objects
    assert sorted(got) == sorted(want) and len(want) >= 4
    for inst in want:
        np.testing.assert_allclose(got[inst][:3], want[inst][:3], atol=TOL)
        np.testing.assert_allclose(np.sort(got[inst][7:]),
                                   np.sort(want[inst][7:]), atol=TOL)
    err = [np.linalg.norm(v[:3] - scene.ellipsoids[i][:3])
           for i, v in got.items()]
    assert np.median(err) < 0.05, err


def test_batch_path_skips_the_incremental_state(runs):
    """With the batch initializer the host's Gram accumulator is never fed
    (the JAX package adds observations to it only on the incremental
    path)."""
    _, port, _, _ = runs
    assert not port.tracker._inc_init.n_planes(0)
