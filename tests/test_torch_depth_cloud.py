"""Port parity of the two fused downsamples against the JAX package, on the
CPU: ``depth_cloud_plain`` (stages (a)-(c) of an extraction call) against
JAX ``frontend/extractor._stage_a_one`` (vmapped over the detections), and
``voxel_downsample_plain`` against JAX ``ops/voxel.voxel_downsample`` /
``voxel_downsample_cells``; and both plain versions against the single-step
plain functions they compose.

Inputs: frames of the 6-object synthetic scene of
``tests/test_torch_extractor.py`` (scene seed 7, an orbit of 12 frames),
rendered once with numpy-seeded geometry; the SAME depth array goes to both
sides.  Masks and cells must be EQUAL, floats within 1e-5 of JAX (XLA:CPU
contracts multiply-adds and sums in another order) and bit-equal to the
single steps, except the centre's world transform, which the plain version
writes out in the kernel's order where the extractor had a matrix product:
1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_oriented_slam_tpu.core.camera import Camera as JCamera
from object_oriented_slam_tpu.frontend import extractor as jext
from object_oriented_slam_tpu.ops import voxel as jvx
from object_oriented_slam_tpu_torch.io import synthetic as tsyn
from object_oriented_slam_tpu_torch.ops import backproject as bp
from object_oriented_slam_tpu_torch.ops import depth_cloud as dc
from object_oriented_slam_tpu_torch.ops import frontend_kernels as fk
from object_oriented_slam_tpu_torch.ops import voxel as vx

TOL = 1e-5
PLANE = np.array([0.001, -0.002, 1.0, -0.0005], np.float32)
# a whole-image box, a zero (padded) box, a box over the sky (no valid
# depth) and a box running past the image's right and bottom edges
EXTRA = np.array([[0.0, 0.0, 640.0, 480.0], [0.0, 0.0, 0.0, 0.0],
                  [300.0, 5.0, 340.0, 30.0], [560.3, 380.6, 700.0, 520.0]],
                 np.float32)


@pytest.fixture(scope="module")
def scene():
    sc = tsyn.make_scene(n_objects=6, seed=7, radius_range=(1.3, 2.2),
                         scale_range=(0.2, 0.4))
    frames = list(tsyn.SyntheticDataset(sc, n_frames=12, orbit_radius=3.6,
                                        height=1.7).frames())
    cam = sc.camera
    jcam = JCamera(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                   scale=cam.scale, width=cam.width, height=cam.height)
    return frames, cam, jcam


def _inputs(scene, k, extra=True):
    frames, cam, jcam = scene
    _, _, pose, depth, _, det = frames[k]
    bboxes = det[:, 1:5].astype(np.float32)
    if extra:
        bboxes = np.concatenate([bboxes, EXTRA])
    return depth, bboxes, pose.astype(np.float32), cam, jcam


def _jax_stage_a(depth, bboxes, pose, jcam, **kw):
    jcfg = jext.ExtractorConfig(**kw)
    return jax.vmap(lambda b: jext._stage_a_one(
        jnp.asarray(depth), b, jnp.asarray(pose), jnp.asarray(PLANE), jcam,
        jcfg))(jnp.asarray(bboxes))


def _plain(depth, bboxes, pose, cam, leaf=0.01, capacity=2048):
    return dc.depth_cloud_plain(
        torch.from_numpy(np.asarray(depth, np.int32)),
        torch.from_numpy(bboxes), torch.from_numpy(pose),
        torch.from_numpy(PLANE), cam, leaf, 6.0, 0.05, capacity)


def _assert_like_jax(got, want, name):
    want = np.asarray(want)
    got = got.numpy()
    if got.dtype in (np.bool_, np.int32):
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, atol=TOL, err_msg=name)


def _single_steps(pts, mask, leaf, capacity, world=None):
    """The downsample as the plain single steps: keys, a stable sort and
    the segment means (with the world epilogue when ``world`` is given)."""
    key, cmin = vx.voxel_keys(pts, mask, leaf)
    key_s, order = torch.sort(key, dim=1, stable=True)
    return vx.voxel_segment_mean_plain(key_s, order, pts, cmin, capacity,
                                       world)


def _cell_span(depth, bboxes, cam, leaf):
    """The most cells a box's live points span on one axis."""
    pts, m0 = bp.bbox_point_cloud_plain(torch.from_numpy(depth),
                                        torch.from_numpy(bboxes), cam, 6.0)
    cell = vx.voxel_cells(pts, leaf)
    big = 2 ** 30
    span = (torch.where(m0[..., None], cell, -big).amax(1)
            - torch.where(m0[..., None], cell, big).amin(1))
    return int(torch.where(m0.any(1)[:, None], span, 0).max())


def _bits(a, b):
    return a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


@pytest.mark.parametrize("k,capacity,leaf", [(0, 2048, 0.01), (3, 4096, 0.01),
                                             (7, 2048, 0.01), (10, 1024, 0.01),
                                             (5, 4096, 0.001)])
def test_depth_cloud_plain_matches_jax(scene, k, capacity, leaf):
    """Leaf 0.001: a cloud spanning more than 1024 cells on an axis (the
    clamp's collisions)."""
    depth, bboxes, pose, cam, jcam = _inputs(scene, k)
    got = _plain(depth, bboxes, pose, cam, leaf=leaf, capacity=capacity)
    want = _jax_stage_a(depth, bboxes, pose, jcam, cloud_capacity=capacity,
                        voxel_leaf=leaf)
    pairs = {"pts_v": (got.pts_v, want[0]), "pts_w": (got.pts_w, want[1]),
             "cells_v": (got.cells_v, want[2]), "m2": (got.m2, want[3]),
             "center_w": (got.center_w, want[4]),
             "ok_points": (got.ok_points, want[5]),
             "ok_center": (got.ok_center, want[6])}
    for name, (g, w) in pairs.items():
        _assert_like_jax(g, w, name)
    n_box = len(bboxes) - len(EXTRA)
    m = got.m2.sum(1)
    assert int(m[:n_box].min()) > 50 and bool(got.ok_points[:n_box].all())
    if leaf == 0.01:
        # the whole-image box fills the capacity: the segments past it dropped
        assert int((got.pts_v[n_box, :, 2] > 0).sum()) == capacity
    else:
        assert _cell_span(depth, bboxes, cam, leaf) > 1023
    # the padded box and the sky box hold no point and no voxel
    assert not bool(got.m2[n_box + 1:n_box + 3].any())
    assert not bool(got.ok_points[n_box + 1]) and not bool(
        got.ok_center[n_box + 2])
    # the box running off the image keeps its in-image pixels (floor: the
    # plane test drops them)
    assert int((got.pts_v[n_box + 3, :, 2] > 0).sum()) > 100


@pytest.mark.parametrize("leaf", [0.01, 0.001])
def test_depth_cloud_plain_is_the_single_steps(scene, leaf):
    """The fused plain version is the single-step plain functions in the
    extractor's order, bit for bit; leaf 0.001 spans more than 1024 cells
    on an axis (the clamp's collisions)."""
    depth, bboxes, pose, cam, _ = _inputs(scene, 5)
    got = _plain(depth, bboxes, pose, cam, leaf=leaf, capacity=4096)
    d_t, b_t = torch.from_numpy(depth), torch.from_numpy(bboxes)
    pose_t, plane_t = torch.from_numpy(pose), torch.from_numpy(PLANE)
    world = dc.plane_world(pose_t, plane_t, 0.05)
    pts, m0 = bp.bbox_point_cloud_plain(d_t, b_t, cam, 6.0)
    pts_v, cells_v, _, pts_w, m2 = _single_steps(pts, m0, leaf, 4096, world)
    for g, w in ((got.pts_v, pts_v), (got.cells_v, cells_v),
                 (got.pts_w, pts_w), (got.m2, m2), (got.R_wc, world.R)):
        assert _bits(g, w)
    assert torch.equal(got.ok_points, m2.sum(1) >= 1)
    centre, ok_c = bp.center_estimate(d_t, b_t, cam, 6.0)
    assert torch.equal(got.ok_center, ok_c)
    # the extractor had a matrix product for the centre's world transform
    # and a reduction for its sum: both in another order, 1e-6
    old = centre @ world.R.T + world.t
    np.testing.assert_allclose(got.center_w.numpy(), old.numpy(), atol=1e-6)
    if leaf == 0.001:
        assert _cell_span(depth, bboxes, cam, leaf) > 1023


def _object_clouds(scene, k):
    depth, bboxes, pose, cam, _ = _inputs(scene, k, extra=False)
    got = _plain(depth, bboxes, pose, cam, capacity=4096)
    return got.pts_w, got.m2


@pytest.mark.parametrize("k,leaf,capacity", [(2, 0.1, 512), (6, 0.1, 512),
                                             (9, 0.05, 64), (4, 0.001, 4096)])
def test_voxel_downsample_plain_matches_jax(scene, k, leaf, capacity):
    """The object downsample: 0.1 m at the extractor's capacity, a capacity
    that drops segments, and a leaf that clamps."""
    pts, mask = _object_clouds(scene, k)
    out, cells, m = vx.voxel_downsample_plain(pts, mask, leaf, capacity)
    jout, jcells, jm = jax.vmap(lambda p, q: jvx.voxel_downsample_cells(
        p, q, leaf, capacity))(jnp.asarray(pts.numpy()),
                               jnp.asarray(mask.numpy()))
    _assert_like_jax(m, jm, "mask")
    _assert_like_jax(cells, jcells, "cells")
    _assert_like_jax(out, jout, "pts")
    jout2, jm2 = jax.vmap(lambda p, q: jvx.voxel_downsample(
        p, q, leaf, capacity))(jnp.asarray(pts.numpy()),
                               jnp.asarray(mask.numpy()))
    _assert_like_jax(m, jm2, "mask (voxel_downsample)")
    _assert_like_jax(out, jout2, "pts (voxel_downsample)")
    if capacity == 64:
        assert bool(m[:, -1].any())
    # the single steps, bit for bit
    single = _single_steps(pts, mask, leaf, capacity)
    assert _bits(out, single[0]) and torch.equal(cells, single[1])
    assert torch.equal(m, single[2])


def test_cpu_wrappers_take_the_plain_versions(scene):
    """On CPU tensors the wrappers are the plain versions and launch
    nothing."""
    depth, bboxes, pose, cam, _ = _inputs(scene, 1)
    before = {k.name: k.launches for k in fk.KERNELS}
    want = _plain(depth, bboxes, pose, cam)
    got = dc.depth_cloud(torch.from_numpy(depth), torch.from_numpy(bboxes),
                         torch.from_numpy(pose), torch.from_numpy(PLANE),
                         cam, 0.01, 6.0, 0.05, 2048)
    for g, w in zip(got, want):
        assert _bits(g, w)
    out, m = vx.voxel_downsample(want.pts_w, want.m2, 0.1, 512)
    want_o = vx.voxel_downsample_plain(want.pts_w, want.m2, 0.1, 512)
    assert _bits(out, want_o[0]) and torch.equal(m, want_o[2])
    assert {k.name: k.launches for k in fk.KERNELS} == before
