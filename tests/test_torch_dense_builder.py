"""Port parity: ops/dense_fuse (K12's plain version, which the CPU runs)
and system/dense_builder against the JAX package's DenseBuilder on the
same numpy frames: tests/test_aux.py's frame fused twice, and two
synthetic frames (a tilted, rippled wall under two camera poses, random
colours) at capacity 4096 and stride 8, whose 1 cm cells overflow the
capacity on the first frame.

Tolerance: points 1e-6, colours 1e-4, masks and occupied counts equal (the
same sums in the same order; XLA's jitted back-projection and world
transform round some coordinates an ulp apart from PyTorch's eager ones);
the PLY and PCD writers byte for byte equal to JAX's on the same arrays,
each builder's map included.  K12 itself is held against ``dense_fuse_plain`` on the card by the
``cuda`` cases of tests/test_torch_frontend_kernels.py.
"""
import os

import numpy as np
import pytest
import torch

from object_oriented_slam_tpu.core.camera import Camera as JCamera
from object_oriented_slam_tpu.system import dense_builder as jdb
from object_oriented_slam_tpu_torch.core.camera import Camera
from object_oriented_slam_tpu_torch.ops import dense_fuse as df
from object_oriented_slam_tpu_torch.system import dense_builder as tdb

torch.set_num_threads(1)    # the test workers share the CPU

CAMS = dict(fx=535.4, fy=539.2, cx=320.1, cy=247.6, scale=5000.0)
CAM, JCAM = Camera(**CAMS), JCamera(**CAMS)


def aux_frames():
    """test_aux.py's frame (a wall at 2 m, grey), twice, identity pose."""
    depth = np.full((480, 640), int(2.0 * CAM.scale), np.uint16)
    rgb = np.full((480, 640, 3), 128, np.uint8)
    pose = np.array([0, 0, 0, 0, 0, 0, 1], np.float64)
    return [(rgb, depth, pose)] * 2


def wall_frames():
    """Two frames of a tilted, rippled wall with random colours and holes,
    seen from two poses (a yaw and a shift apart)."""
    rng = np.random.default_rng(16)
    yy, xx = np.mgrid[0:480, 0:640].astype(np.float64)
    out = []
    for k, (yaw, shift) in enumerate(((0.0, 0.0), (0.3, 0.25))):
        z = 1.6 + 0.002 * xx + 0.05 * np.sin(yy / 23.0 + k)
        depth = (z * CAM.scale).astype(np.uint16)
        depth[rng.random(depth.shape) < 0.1] = 0            # holes
        depth[:40, :80] = 40000                              # past range
        rgb = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
        q = [0.0, np.sin(yaw / 2), 0.0, np.cos(yaw / 2)]
        pose = np.array([shift, -0.1 * k, 0.05 * k, *q], np.float64)
        out.append((rgb, depth, pose))
    return out


SETUPS = {
    "aux": (aux_frames, dict(leaf=0.05, stride=8, capacity=4096)),
    "overflow": (wall_frames, dict(leaf=0.01, stride=8, capacity=4096)),
}


def _state(b):
    return (np.asarray(b.pts, np.float32), np.asarray(b.rgb, np.float32),
            np.asarray(b.mask, bool))


@pytest.fixture(scope="module")
def runs():
    """Each setup's frames through both builders; the state after each
    frame."""
    out = {}
    for name, (frames, kw) in SETUPS.items():
        port = tdb.DenseBuilder(CAM, device="cpu", **kw)
        ref = jdb.DenseBuilder(JCAM, **kw)
        steps = []
        for rgb, depth, pose in frames():
            port.process_frame(rgb, depth, pose)
            ref.process_frame(rgb, depth, pose)
            steps.append((_state(port), _state(ref)))
        out[name] = (port, ref, steps)
    return out


@pytest.mark.parametrize("name", list(SETUPS))
def test_builder_matches_jax(runs, name):
    _, _, steps = runs[name]
    for (pts, rgb, mask), (wpts, wrgb, wmask) in steps:
        np.testing.assert_array_equal(mask, wmask)
        assert mask.sum() == wmask.sum()
        np.testing.assert_allclose(pts, wpts, rtol=0, atol=1e-6)
        np.testing.assert_allclose(rgb, wrgb, rtol=0, atol=1e-4)


def test_the_overflow_case_overflows(runs):
    """The wall frames fill the capacity on the first frame (the overflow
    rule decides which cells survive); the grey wall fused twice stays."""
    _, _, steps = runs["overflow"]
    assert steps[0][0][2].all() and steps[1][0][2].all()
    _, _, steps = runs["aux"]
    n1, n2 = steps[0][0][2].sum(), steps[1][0][2].sum()
    assert 100 < n1 < 4096 and abs(int(n2) - int(n1)) < n1 * 0.05


@pytest.mark.parametrize("name", list(SETUPS))
@pytest.mark.parametrize("fmt", ["ply", "pcd"])
def test_map_files_byte_equal_to_jax(runs, name, fmt, tmp_path):
    """Each builder's map file equals the other package's writer on that
    builder's arrays, byte for byte (and the writers agree on arrays with
    and without colour).  The two maps' files themselves are not compared
    byte for byte: XLA's jitted back-projection rounds some coordinates an
    ulp apart from the eager one (``(jj - cx) * z / fx`` fused), which can
    move a ``%.4f`` digit or a truncated colour."""
    port, ref, _ = runs[name]
    mine, theirs = tmp_path / f"port.{fmt}", tmp_path / f"jax.{fmt}"
    for builder, writer in ((port, jdb), (ref, tdb)):
        builder.save_map(str(mine))
        pts, rgb = builder.get_map()
        getattr(writer, f"save_{fmt}")(str(theirs), pts, rgb)
        assert mine.read_bytes() == theirs.read_bytes()
        assert os.path.getsize(mine) > 100
    pts, rgb = ref.get_map()
    for colours in (rgb, None):
        getattr(tdb, f"save_{fmt}")(str(mine), pts, colours)
        getattr(jdb, f"save_{fmt}")(str(theirs), pts, colours)
        assert mine.read_bytes() == theirs.read_bytes()


def test_rgb_none_fuses_zeros():
    """``rgb=None``: the frame's colours are zeros, as in JAX."""
    rgb, depth, pose = wall_frames()[0]
    b = tdb.DenseBuilder(CAM, leaf=0.05, stride=8, capacity=4096,
                         device="cpu")
    b.process_frame(None, depth, pose)
    pts, colours = b.get_map()
    assert len(pts) > 100 and not colours.any()


def test_fuse_plain_is_the_builder_step():
    """dense_fuse on CPU tensors is dense_fuse_plain, and the strided
    grid's size is ceil(H / s) x ceil(W / s)."""
    assert df.frame_grid(480, 640, 8) == (60, 80)
    assert df.frame_grid(481, 641, 4) == (121, 161)
    rgb, depth, pose = wall_frames()[1]
    args = (torch.zeros(512, 3), torch.zeros(512, 3),
            torch.zeros(512, dtype=torch.bool),
            torch.as_tensor(depth.astype(np.int32)),
            torch.as_tensor(rgb).float(),
            torch.as_tensor(pose.astype(np.float32)), CAM, 8, 0.02, 512, 6.0)
    got, want = df.dense_fuse(*args), df.dense_fuse_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(NotImplementedError):
        df.dense_fuse(*(a.to("meta") if torch.is_tensor(a) else a
                        for a in args))


def test_tracker_feeds_its_builder_like_jax(tmp_path):
    """``Visualization.Builder.Open: 1``: each tracker builds its builder
    and feeds it every frame body with a depth image, and no other (JAX
    tracking.py:531-533): the port's tracker map is a builder's fed those
    frames, bit for bit.  Against JAX's tracker (its default 1 cm leaf at
    stride 4): the cell counts within 1e-4 (XLA's jitted back-projection
    moves a boundary point now and then, see the file tests)."""
    from object_oriented_slam_tpu.io.config import Config as JConfig
    from object_oriented_slam_tpu.system.tracking import Tracking as JTracking
    from object_oriented_slam_tpu_torch.io.config import Config
    from object_oriented_slam_tpu_torch.system import Tracking
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "object_oriented_slam_tpu_torch", "configs",
                       "synthetic_2d.yaml")
    path = str(tmp_path / "settings.yaml")
    with open(src) as f, open(path, "w") as g:
        g.write(f.read() + "\nVisualization.Builder.Open: 1\n")
    port, ref = Tracking(Config(path), device="cpu"), JTracking(JConfig(path))
    alone = tdb.DenseBuilder(CAM, device="cpu")
    assert port.dense_builder is not None and ref.dense_builder is not None
    for k, (rgb, depth, pose) in enumerate(wall_frames()):
        for tr in (port, ref):
            tr.grab_pose_and_objects(float(k), pose, np.zeros((0, 8)), depth,
                                     rgb)
            tr.grab_pose_and_objects(9.0 + k, pose, np.zeros((0, 8)), None,
                                     rgb)
        alone.process_frame(rgb, depth, pose)
    for a, b in zip(_state(port.dense_builder), _state(alone)):
        np.testing.assert_array_equal(a, b)
    n, want = int(port.dense_builder.mask.sum()), int(
        np.asarray(ref.dense_builder.mask).sum())
    assert n > 1000 and abs(n - want) <= 1e-4 * want
