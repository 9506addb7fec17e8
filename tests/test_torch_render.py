"""The port's analytic depth renderer against the JAX package's.

``t * scale`` is truncated to an integer, so another rounding order moves
a pixel by one count, and a silhouette pixel between a hit and a miss
(then it reads the floor or the sky behind).  Tolerance: within +-1 count
on at least 99.5 % of the pixels, and every frame the dataset yields is
the renderer's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_oriented_slam_tpu.io import synthetic as jsyn
from object_oriented_slam_tpu_torch.io import synthetic as tsyn

torch.set_num_threads(1)    # the test workers share the CPU

SCENE_KW = dict(n_objects=6, seed=3, radius_range=(1.3, 2.2),
                scale_range=(0.2, 0.4))


@pytest.mark.parametrize("frame", [0, 3, 7, 10])
def test_render_depth_matches_jax(frame):
    scene = tsyn.make_scene(**SCENE_KW)
    jscene = jsyn.make_scene(**SCENE_KW)
    pose = tsyn.orbit_trajectory(12, 3.6, 1.7)[frame]
    got = tsyn.render_depth(scene.ellipsoids, pose, scene.camera)
    want = np.asarray(jsyn.render_depth(
        jnp.asarray(jscene.ellipsoids.astype(np.float32)),
        jnp.asarray(pose.astype(np.float32)), jscene.camera))
    assert got.dtype == torch.int32 and tuple(got.shape) == (480, 640)
    diff = np.abs(got.numpy().astype(np.int64) - want)
    assert (diff <= 1).mean() >= 0.995
    # the image holds objects in front of the floor, and sky
    assert (got == 0).any() and int(got.max()) > 15000
    assert np.median(got.numpy()[got.numpy() > 0]) > 5000


def test_render_depth_plane_only_and_sky():
    """No object: the floor below the horizon, zeros above it."""
    cam = tsyn.default_camera()
    pose = tsyn.orbit_trajectory(12, 3.6, 1.7)[0]
    got = tsyn.render_depth(np.zeros((0, 10)), pose, cam).numpy()
    assert (got[:40] == 0).all() and (got[-100:] > 0).all()


def test_dataset_yields_the_rendered_depth():
    scene = tsyn.make_scene(**SCENE_KW)
    ds = tsyn.SyntheticDataset(scene, n_frames=12, orbit_radius=3.6,
                               height=1.7)
    frames = list(ds.frames())
    i, ts, pose, depth, rgb, det = frames[3]
    assert isinstance(depth, np.ndarray) and depth.dtype == np.int32
    np.testing.assert_array_equal(
        depth, tsyn.render_depth(scene.ellipsoids, pose,
                                 scene.camera).numpy())
    # the 2D-only loop asks for no depth
    flat = list(tsyn.SyntheticDataset(scene, n_frames=12, orbit_radius=3.6,
                                      height=1.7, with_depth=False).frames())
    assert flat[3][3] is None
    np.testing.assert_array_equal(flat[3][5], det)
