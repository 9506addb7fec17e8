"""LM fusion (Tracking.fuse_lm): the due frame's global-BA LM call is
issued by the next frame's extraction call (MonolithicExtractor.
dispatch_with_lm, FusedSplitExtractor.step_with_lm), against the unfused
loop and the JAX package, on the CPU.

The fusion moves only which call issues the LM; the batch, the warm start
and the order of frames are the same, so maps and histories must match
the port's eager loop (``pipeline_depth = 1``, no fusion) within 1e-4, the
bound of the JAX package's tests/test_lm_fusion.py, with the same number
of LM calls, and fusion must engage (more than 5 fused calls, counted
with the JAX test's spy).  Fused-split extraction with LM fusion, the
architecture the probe picks on a local device, lands within 2e-3 of the
JAX package's eager mono map (tests/test_torch_run_tum.py's TOL).  One
3-object, 10-frame depth sequence of the port's generator, rendered once;
for the plain LM's CPU cost the port's batch starts at 4 object slots and
every run, the JAX one included, takes 3 LM iterations a call.
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
from object_oriented_slam_tpu_torch.frontend import (ExtractorConfig,
                                                     make_extractor,
                                                     make_fused_extractor,
                                                     make_plane_estimator)
from object_oriented_slam_tpu_torch.io import synthetic as tsyn
from object_oriented_slam_tpu_torch.system import System, Tracking

YAML = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "object_oriented_slam_tpu_torch", "configs",
                    "synthetic_depth.yaml")
SCENE_KW = dict(n_objects=3, seed=11, radius_range=(1.3, 2.0),
                scale_range=(0.2, 0.35))
EXT_KW = dict(cloud_capacity=2048)
LM_ITERS = 3
TOL = 2e-3


@pytest.fixture(scope="module")
def sequence():
    scene = tsyn.make_scene(**SCENE_KW)
    return scene, list(tsyn.SyntheticDataset(
        scene, n_frames=10, orbit_radius=3.6, height=1.7).frames())


def _drive(slam, frames):
    for i, ts, pose, depth, rgb, det in frames:
        slam.track_with_objects(ts, pose, det, depth=depth)
    slam.tracker.sync()
    hist = {i: np.stack(r.history)
            for i, r in slam.tracker.state.objects.items() if r.history}
    return slam.map_objects, hist


def _run(sequence, make=make_extractor, depth=1, fuse=False):
    """The port over the sequence; returns (System, map, histories, fused
    LM calls: the dispatch_with_lm / step_with_lm calls that issued one)."""
    scene, frames = sequence
    cam = scene.camera
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Tracking, "MAX_OBJECTS", 4)
        slam = System(YAML, extractor=make(cam, ExtractorConfig(**EXT_KW),
                                           device="cpu"),
                      plane_estimator=make_plane_estimator(cam, device="cpu"),
                      device="cpu")
        slam.open_ground_plane_estimation()
        tr = slam.tracker
        tr.lm_cfg = tr.lm_cfg._replace(iters=LM_ITERS)
        tr.pipeline_depth = depth
        tr.adaptive_depth = False
        tr.fuse_lm = fuse
        fused = [0]
        ex = tr.extractor
        name = "step_with_lm" if getattr(ex, "fused", False) \
            else "dispatch_with_lm"
        orig = getattr(ex, name)

        def spy(*a, **k):
            out = orig(*a, **k)
            fused[0] += out is not None and out[-2] is not None
            return out

        setattr(ex, name, spy)
        objs, hist = _drive(slam, frames)
    return slam, objs, hist, fused[0]


@pytest.fixture(scope="module")
def unfused(sequence):
    return _run(sequence)


_FUSED = {}


def _fused_run(sequence, depth):
    if depth not in _FUSED:
        _FUSED[depth] = _run(sequence, depth=depth, fuse=True)
    return _FUSED[depth]


def _assert_same(got, want, tol):
    (objs, hist), (objs_w, hist_w) = got, want
    assert set(objs) == set(objs_w) and len(objs_w) >= 2
    for inst in objs_w:
        np.testing.assert_allclose(objs[inst], objs_w[inst], atol=tol)
    assert set(hist) == set(hist_w)
    for inst in hist_w:
        assert hist[inst].shape == hist_w[inst].shape
        np.testing.assert_allclose(hist[inst], hist_w[inst], atol=tol)
    return (all(np.array_equal(objs[i], objs_w[i]) for i in objs_w)
            and all(np.array_equal(hist[i], hist_w[i]) for i in hist_w))


@pytest.mark.parametrize("depth", [4, 2])
def test_fused_lm_matches_unfused(sequence, unfused, depth):
    slam, objs, hist, n_fused = _fused_run(sequence, depth)
    assert slam.tracker._backend_calls == unfused[0].tracker._backend_calls > 0
    bits = _assert_same((objs, hist), unfused[1:3], 1e-4)
    print(f"depth {depth}: {n_fused} fused LM calls; map and histories "
          f"bit-equal to the unfused eager run: {bits}")


def test_fusion_engages(sequence):
    slam, _, _, n_fused = _fused_run(sequence, 4)
    assert n_fused > 5
    assert slam.tracker._backend_calls > n_fused - 1


def test_fused_split_with_lm_fusion_matches_jax_mono(sequence, unfused):
    """The probe's choice on a local device (fused-split + LM fusion at the
    default depth) against the JAX package's eager mono run on the same
    frames, and against the port's."""
    scene, frames = sequence
    slam, objs, hist, n_fused = _run(sequence, make_fused_extractor, 4, True)
    assert n_fused > 3
    bits = _assert_same((objs, hist), unfused[1:3], 1e-4)
    cam = scene.camera
    jcam = JCamera(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                   scale=cam.scale, width=cam.width, height=cam.height)
    jslam = JSystem(YAML, extractor=jmake_ext(jcam, JExtCfg(**EXT_KW)),
                    plane_estimator=jmake_plane(jcam))
    jslam.tracker.pipeline_depth = 1
    jslam.tracker.lm_cfg = jslam.tracker.lm_cfg._replace(iters=LM_ITERS)
    jslam.open_ground_plane_estimation()
    want, _ = _drive(jslam, frames)
    assert sorted(objs) == sorted(want) and len(want) >= 2
    for inst in want:
        np.testing.assert_allclose(objs[inst][:3], want[inst][:3], atol=TOL)
        np.testing.assert_allclose(np.sort(objs[inst][7:]),
                                   np.sort(want[inst][7:]), atol=TOL)
    print(f"fused split + LM fusion: {n_fused} fused LM calls; bit-equal to "
          f"the port's unfused mono run: {bits}")
