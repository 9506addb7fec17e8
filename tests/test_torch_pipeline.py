"""The port's deferred frame pipeline (system/tracking.py) on the CPU.

The pipeline is scheduling only: extraction deferral, the chained LM warm
starts drained late, the asynchronous plane and the adaptive depth keep
every frame's processing order and inputs, so the map and the per-frame
history rows after ``sync()`` must match the eager loop (``pipeline_depth =
1``): within 1e-4, the bound of the JAX package's
tests/test_pipeline_equivalence.py (each case also reports whether they are
bit-equal).  Small sequences of the port's own generator, on the in-repo
yamls: depth mode 3 objects x 8 frames, 2D mode 3 objects x 18 frames (the
2D initialisation needs 15 observations), the LM batch at 4 object slots
(empty slots are masked) for the plain LM's CPU cost.  Also: the
asynchronous plane's replay order, an extraction handle fetched after
later calls, and the adaptive controller's six cases of the JAX package's
tests/test_adaptive_depth.py on configs/synthetic_2d.yaml.
"""
import os

import numpy as np
import pytest
import torch

from object_oriented_slam_tpu_torch.frontend import (ExtractorConfig,
                                                     make_extractor,
                                                     make_plane_estimator)
from object_oriented_slam_tpu_torch.io import synthetic as tsyn
from object_oriented_slam_tpu_torch.io.config import Config
from object_oriented_slam_tpu_torch.system import System, Tracking

torch.set_num_threads(1)    # the test workers share the CPU

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "object_oriented_slam_tpu_torch", "configs")
YAML_2D = os.path.join(CONFIGS, "synthetic_2d.yaml")
YAML_DEPTH = os.path.join(CONFIGS, "synthetic_depth.yaml")
SCENE_KW = dict(n_objects=3, seed=11, radius_range=(1.3, 2.0),
                scale_range=(0.2, 0.35))
FRAMES = {"depth": 8, "2d": 18}
EXT_KW = dict(cloud_capacity=2048)


@pytest.fixture(autouse=True)
def small_object_tier(monkeypatch):
    monkeypatch.setattr(Tracking, "MAX_OBJECTS", 4)


def _frames(mode):
    scene = tsyn.make_scene(**SCENE_KW)
    ds = tsyn.SyntheticDataset(scene, n_frames=FRAMES[mode],
                               orbit_radius=3.6, height=1.7,
                               with_depth=mode == "depth")
    return scene, list(ds.frames())


def _system(mode, cam):
    if mode == "2d":
        return System(YAML_2D, device="cpu")
    slam = System(YAML_DEPTH,
                  extractor=make_extractor(cam, ExtractorConfig(**EXT_KW),
                                           device="cpu"),
                  plane_estimator=make_plane_estimator(cam, device="cpu"),
                  device="cpu")
    slam.open_ground_plane_estimation()
    return slam


def _run(mode, schedule):
    """The sequence through one System; ``schedule``: "eager" (depth 1),
    "depth4" (pinned 4), "grow" (every fetch blocks: 4 deepens) or
    "shrink" (the controller deepened to 6 beforehand, every fetch free:
    it drains back toward 4).  Returns (map, histories, depths seen)."""
    scene, frames = _frames(mode)
    slam = _system(mode, scene.camera)
    tr = slam.tracker
    if schedule == "eager":
        tr.pipeline_depth = 1
        tr.adaptive_depth = False
    elif schedule == "depth4":
        tr.pipeline_depth = 4
        tr.adaptive_depth = False
    elif schedule == "grow":
        tr.adapt_deepen_s = -1.0
    elif schedule == "shrink":
        tr.adapt_depth_max = 6          # room to drain within 8 frames
        while tr.pipeline_depth < tr.adapt_depth_max:
            tr._adapt_depth(10 * tr.adapt_deepen_s)
        tr._adapt_fetches = type(tr._adapt_fetches)(maxlen=2)
        tr.adapt_deepen_s = float("inf")
        tr.adapt_shallow_s = float("inf")
    depths = set()
    for i, ts, pose, depth, rgb, det in frames:
        slam.track_with_objects(ts, pose, det, depth=depth)
        depths.add(tr.pipeline_depth)
    tr.sync()
    hist = {i: np.stack(r.history) for i, r in tr.state.objects.items()
            if r.history}
    return slam.map_objects, hist, depths


_EAGER = {}


def _eager(mode):
    if mode not in _EAGER:
        _EAGER[mode] = _run(mode, "eager")
    return _EAGER[mode]


@pytest.mark.parametrize("mode,schedule", [
    ("depth", "depth4"), ("depth", "grow"), ("depth", "shrink"),
    ("2d", "depth4")])
def test_pipelined_matches_eager(mode, schedule):
    objs_e, hist_e, _ = _eager(mode)
    objs_p, hist_p, depths = _run(mode, schedule)
    if schedule in ("grow", "shrink"):
        assert len(depths) > 1, f"depth never changed: {depths}"
    assert set(objs_p) == set(objs_e) and len(objs_e) >= 2
    for inst in objs_e:
        np.testing.assert_allclose(objs_p[inst], objs_e[inst], atol=1e-4)
    assert set(hist_p) == set(hist_e)
    for inst in hist_e:
        assert hist_p[inst].shape == hist_e[inst].shape
        np.testing.assert_allclose(hist_p[inst], hist_e[inst], atol=1e-4)
    bits = (all(np.array_equal(objs_p[i], objs_e[i]) for i in objs_e)
            and all(np.array_equal(hist_p[i], hist_e[i]) for i in hist_e))
    print(f"{mode} {schedule}: depths {sorted(depths)}, map and histories "
          f"bit-equal to the eager run: {bits}")


class _Plane:
    """A plane estimator with dispatch / resolve whose first ``fails``
    estimates fail; records the order of dispatches and resolves."""

    def __init__(self, fails):
        self.fails = fails
        self.log = []

    def dispatch(self, depth):
        self.log.append("dispatch")
        return len(self.log)

    def resolve(self, handle):
        self.log.append("resolve")
        if self.fails > 0:
            self.fails -= 1
            return None
        return np.array([0.0, 0.0, -1.0, 0.0])   # z = 0 in the camera frame

    def __call__(self, depth):
        return self.resolve(self.dispatch(depth))


def test_async_plane_replays_deferred_frames_in_order():
    """The frame that dispatches the plane is deferred to the next grab;
    a failed estimate replays it without a plane (no extraction) and the
    next frame dispatches again; frames without detections replay too.
    Every frame's body runs once, in frame order."""
    calls, bodies = [], []

    def extractor(depth, bboxes, labels, pose, plane):
        calls.append(len(bboxes))

    tr = Tracking(Config(YAML_DEPTH), extractor=extractor,
                  plane_estimator=_Plane(fails=2), device="cpu")
    tr.open_optimization = False
    body = tr._frame_body

    def recorded(frame_id, *args):
        bodies.append(frame_id)
        return body(frame_id, *args)

    tr._frame_body = recorded
    depth = np.ones((480, 640), np.int32)
    det = np.array([[0, 200, 150, 300, 250, 57, 1.0, 0]])
    empty = np.zeros((0, 8))
    pose = np.array([0, 0, 0, 0, 0, 0, 1.0])
    tr.open_ground_plane_estimation()
    for k, d in enumerate([empty, empty, det, det, det, det]):
        tr.grab_pose_and_objects(float(k), pose, d, depth)
        if k == 0:
            assert bodies == [] and tr._plane_deferred
    tr.sync()
    assert bodies == list(range(6))
    # three dispatches (two failures), each resolved at the next grab
    assert tr.plane_estimator.log == ["dispatch", "resolve"] * 3
    assert tr.state.ground_state == 2
    assert len(tr.metrics["plane_wait"]) == 3
    # the third estimate latched when frame 3 grabbed, before frame 2 (the
    # frame that dispatched it) replayed: frames 2 to 5 extract
    assert calls == [1, 1, 1, 1]
    assert len(tr.depth_trace) == 6 and len(tr.metrics["fetch"]) == 6


def test_earlier_handle_fetches_its_own_rows_and_stats():
    """Two extraction calls in flight: each handle's fetch returns its own
    call's rows and counts, in either order, and equal to a lone call."""
    scene, frames = _frames("depth")
    cam = scene.camera
    plane = np.array([0.0, 0.0, 1.0, 0.0])
    ex = make_extractor(cam, ExtractorConfig(**EXT_KW), device="cpu")

    def call(f):
        _, _, pose, depth, _, det = f
        return ex(depth, det[:, 1:5].copy(), det[:, 5].astype(int), pose,
                  plane)

    lone = []
    for f in (frames[1], frames[5]):
        h = call(f)
        lone.append((ex.fetch(h), dict(ex.stats)))
    a, b = call(frames[1]), call(frames[5])
    assert ex.stats is b.stats and "cluster_rounds" not in b.stats
    for h, (rows, stats) in ((b, lone[1]), (a, lone[0]), (b, lone[1])):
        np.testing.assert_array_equal(ex.fetch(h), rows)
        assert h.stats == stats and ex.stats is h.stats
    assert lone[0][1] != lone[1][1] or not np.array_equal(lone[0][0],
                                                          lone[1][0])


# --- the adaptive controller (tests/test_adaptive_depth.py's cases) -------

def _tracker():
    return Tracking(Config(YAML_2D), device="cpu")


def test_controller_deepens_on_blocked_fetches():
    tr = _tracker()
    base = tr.pipeline_depth
    assert base == 4 and tr.adaptive_depth and tr.adapt_depth_max == 8
    for _ in range(3):
        tr._adapt_depth(10 * tr.adapt_deepen_s)
    assert tr.pipeline_depth == base + 1
    # window cleared on transition: two more blocked fetches are not enough
    tr._adapt_depth(10 * tr.adapt_deepen_s)
    tr._adapt_depth(10 * tr.adapt_deepen_s)
    assert tr.pipeline_depth == base + 1
    for _ in range(64):
        tr._adapt_depth(10 * tr.adapt_deepen_s)
    assert tr.pipeline_depth == tr.adapt_depth_max


def test_controller_shallows_after_sustained_free_fetches():
    tr = _tracker()
    base = tr.pipeline_depth
    for _ in range(64):
        tr._adapt_depth(10 * tr.adapt_deepen_s)
    assert tr.pipeline_depth == tr.adapt_depth_max
    n = tr._adapt_fetches.maxlen
    for _ in range(n - 1):
        tr._adapt_depth(0.1 * tr.adapt_shallow_s)
    assert tr.pipeline_depth == tr.adapt_depth_max  # window not full yet
    tr._adapt_depth(0.1 * tr.adapt_shallow_s)
    assert tr.pipeline_depth == tr.adapt_depth_max - 1
    for _ in range(20 * n):
        tr._adapt_depth(0.1 * tr.adapt_shallow_s)
    assert tr.pipeline_depth == tr._depth_base == base


def test_pinned_depth_rebases_controller():
    tr = _tracker()
    tr.pipeline_depth = 6
    for _ in range(64):
        tr._adapt_depth(0.1 * tr.adapt_shallow_s)
    assert tr.pipeline_depth == 6
    for _ in range(3):
        tr._adapt_depth(10 * tr.adapt_deepen_s)
    assert tr.pipeline_depth == 7
    for _ in range(20 * tr._adapt_fetches.maxlen):
        tr._adapt_depth(0.1 * tr.adapt_shallow_s)
    assert tr.pipeline_depth == 6


def test_sync_flush_does_not_adapt():
    tr = _tracker()
    base = tr.pipeline_depth
    tr._flushing = True
    for _ in range(64):
        tr._adapt_depth(10 * tr.adapt_deepen_s)
    assert tr.pipeline_depth == base
    assert len(tr._adapt_fetches) == 0


def test_controller_mixed_fetches_hold_depth():
    tr = _tracker()
    base = tr.pipeline_depth
    for i in range(64):
        tr._adapt_depth(10 * tr.adapt_deepen_s if i % 2 else
                        0.1 * tr.adapt_shallow_s)
    assert tr.pipeline_depth == base


def test_controller_off_switch():
    tr = _tracker()
    tr.adaptive_depth = False
    base = tr.pipeline_depth
    for _ in range(64):
        tr._adapt_depth(10 * tr.adapt_deepen_s)
    assert tr.pipeline_depth == base
