"""The port's TUM input (io/png.py, io/tum.py, io/native_loader.py) on the
CPU.

``read_png`` against ``cv2.imread(..., IMREAD_UNCHANGED)`` on 16-bit gray,
8-bit gray and 8-bit colour PNGs that ``cv2`` wrote with each of the five
row filters and with libpng's adaptive choice per row: equal arrays (the
decode is exact); ``write_png`` then ``read_png`` round-trips exactly, with
each filter.  ``TUMDataset`` against the JAX package's
``TUMDataset(use_native=False)`` on one export of the port's exporter: the
same indices, timestamps, poses (after ``set_odometry`` within 1e-12: the
same numpy alignment), detections, depth arrays, ``valid_indices`` and
``read_next``.  Where ``native/lib/liboslam_native.so`` loads, its twin
decodes what the numpy decoder does.
"""
import importlib.util
import os
import sys
import zlib

import numpy as np
import pytest

from object_oriented_slam_tpu_torch.io import native_loader as tnl
from object_oriented_slam_tpu_torch.io import png
from object_oriented_slam_tpu_torch.io import synthetic as tsyn
from object_oriented_slam_tpu_torch.io import tum as ttum

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _images():
    """A depth-like 16-bit image with holes and a noisy band, an 8-bit
    colour image with a gradient and a noisy band, and an 8-bit gray one."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:120, 0:160]
    depth = (5000 + 3000 * np.sin(xx / 13.0) + 7 * yy).astype(np.uint16)
    depth[20:40, 30:90] = 0
    depth[80:] = rng.integers(0, 65536, (40, 160))
    bgr = np.stack([xx % 256, (3 * yy) % 256, (xx * yy) % 256],
                   -1).astype(np.uint8)
    bgr[50:70] = rng.integers(0, 256, (20, 160, 3))
    gray = ((xx * yy) % 251).astype(np.uint8)
    return {"depth16": depth, "bgr8": bgr, "gray8": gray}


@pytest.mark.parametrize("kind", ["depth16", "bgr8", "gray8"])
@pytest.mark.parametrize("filt", ["NONE", "SUB", "UP", "AVG", "PAETH",
                                  "ALL"])
def test_read_png_equals_cv2(kind, filt, tmp_path):
    cv2 = pytest.importorskip("cv2")
    img = _images()[kind]
    flag = (cv2.IMWRITE_PNG_ALL_FILTERS if filt == "ALL"
            else getattr(cv2, "IMWRITE_PNG_FILTER_" + filt))
    path = str(tmp_path / "img.png")
    assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_FILTER, flag])
    got = png.read_png(path)
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("kind", ["depth16", "bgr8", "gray8"])
@pytest.mark.parametrize("filt", range(5))
def test_write_png_round_trips(kind, filt, tmp_path):
    img = _images()[kind]
    path = str(tmp_path / "img.png")
    png.write_png(path, img, filt)
    got = png.read_png(path)
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, img)
    # every row carries the filter asked for
    chunks = png._chunks(open(path, "rb").read())
    idat = b"".join(body for name, body in chunks if name == b"IDAT")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        img.shape[0], -1)
    assert (rows[:, 0] == filt).all()


def test_png_rejects_what_it_does_not_read():
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"GIF89a")
    with pytest.raises(ValueError, match="write_png takes"):
        png.encode_png(np.zeros((4, 4), np.float32))


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def export(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tum_io") / "seq")
    scene = tsyn.make_scene(n_objects=4, seed=3, radius_range=(1.3, 2.2),
                            scale_range=(0.2, 0.4))
    ds = tsyn.SyntheticDataset(scene, n_frames=5, orbit_radius=3.6,
                               height=1.7)
    _example("torch_make_synthetic_tum").export_synthetic_tum(
        out, scene, ds, odometry_noise=0.01)
    # a frame without a depth association and one without a pose: both
    # are skipped by frames(), valid_indices() and read_next()
    for name in ("associate.txt", "associateGroundtruth.txt"):
        p = os.path.join(out, name)
        rows = open(p).read().splitlines()
        drop = 1 if name == "associate.txt" else 3
        open(p, "w").write("\n".join(r for k, r in enumerate(rows)
                                     if k != drop) + "\n")
    return out


def _frames(ds):
    return [(i, ts, pose, depth, det) for i, ts, pose, depth, _, det
            in ds.frames()]


def _assert_frames_equal(got, want, pose_tol=0.0):
    assert [f[0] for f in got] == [f[0] for f in want]
    for (i, ts, pose, depth, det), (j, jts, jpose, jdepth, jdet) in zip(
            got, want):
        assert ts == jts
        np.testing.assert_allclose(pose, jpose, rtol=0, atol=pose_tol)
        assert depth.dtype == jdepth.dtype == np.uint16
        np.testing.assert_array_equal(depth, jdepth)
        np.testing.assert_array_equal(det, jdet)


def test_tum_dataset_matches_jax(export):
    pytest.importorskip("cv2")
    from object_oriented_slam_tpu.io.tum import TUMDataset as JTUMDataset
    ds, jds = ttum.TUMDataset(export), JTUMDataset(export, use_native=False)
    try:
        assert ds.valid_indices() == jds.valid_indices() == [0, 2, 4]
        assert ds.rgb_stamps == jds.rgb_stamps
        _assert_frames_equal(_frames(ds), _frames(jds))
        seq, jseq = [], []
        while not ds.empty():
            r = ds.read_next()
            if r is not None:
                seq.append(r[0])
        while not jds.empty():
            r = jds.read_next()
            if r is not None:
                jseq.append(r[0])
        assert seq == jseq == [0, 2, 4]
        ds.set_current(2)
        jds.set_current(2)
        assert ds.read_next()[0] == jds.read_next()[0] == 2
        # odometry aligned to the groundtruth of its first frame
        odo = os.path.join(export, "odometry.txt")
        assert ds.set_odometry(odo) and jds.set_odometry(odo)
        _assert_frames_equal(_frames(ds), _frames(jds), pose_tol=1e-12)
        np.testing.assert_allclose(ds.pose_for(0), jds.pose_for(0),
                                   rtol=0, atol=1e-12)
    finally:
        ds.close()


def _decoded(export):
    """The sequence's valid frames decoded one by one, without the pool."""
    ds = ttum.TUMDataset(export)
    try:
        return [(i, float(ds.rgb_stamps[i]), ds.pose_for(i),
                 png.read_png(ds._depth_path(i)), ds.detections(i))
                for i in ds.valid_indices()]
    finally:
        ds.close()


def test_prefetch_and_rgb(export, monkeypatch):
    """The prefetching pool yields what a plain decode does; RGB is decoded
    only when asked, and a JPEG without cv2 raises."""
    plain = ttum.TUMDataset(export)
    ahead = ttum.TUMDataset(export, with_rgb=True)
    try:
        _assert_frames_equal(_frames(ahead), _decoded(export))
        assert all(f[4] is None for f in plain.frames())
        rgb = [f[4] for f in ahead.frames()]
        assert all(r.shape == (480, 640, 3) and r.dtype == np.uint8
                   for r in rgb)
        assert (rgb[0][..., 0] == 128).all()     # gray, BGR order kept
    finally:
        plain.close()
        ahead.close()
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="needs cv2"):
        ttum.read_rgb(os.path.join(export, "rgb", "1000.0000.jpg"))
    with pytest.raises(ValueError, match="decoder"):
        ttum.TUMDataset(export, decoder="pil")


def test_native_twin_matches_numpy(export):
    if not tnl.native_available():
        pytest.skip("native/lib/liboslam_native.so does not load here")
    from object_oriented_slam_tpu.io import native_loader as jnl
    depth_path = os.path.join(export, "depth", "1000.0000.png")
    rgb_path = os.path.join(export, "rgb", "1000.0000.png")
    np.testing.assert_array_equal(tnl.decode_depth(depth_path),
                                  png.read_png(depth_path))
    np.testing.assert_array_equal(tnl.decode_rgb(rgb_path),
                                  png.read_png(rgb_path))
    nat = ttum.TUMDataset(export, decoder="native", with_rgb=True)
    ref = ttum.TUMDataset(export, with_rgb=True)
    try:
        got, want = list(nat.frames()), list(ref.frames())
        _assert_frames_equal([(f[0], f[1], f[2], f[3], f[5]) for f in got],
                             [(f[0], f[1], f[2], f[3], f[5]) for f in want])
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a[4], b[4])
    finally:
        nat.close()
        ref.close()
    rng = np.random.default_rng(1)
    pts = rng.uniform(0, 0.2, (400, 3)).astype(np.float32)
    mask = rng.random(400) > 0.1
    np.testing.assert_array_equal(tnl.cluster_labels(pts, mask, 0.02),
                                  jnl.cluster_labels(pts, mask, 0.02))


def test_frames_decode_without_cv2(export, monkeypatch):
    """The mapping path's input never needs cv2: with it blocked the
    sequence still yields its depth frames."""
    want = _decoded(export)
    monkeypatch.setitem(sys.modules, "cv2", None)
    ds = ttum.TUMDataset(export)
    try:
        _assert_frames_equal(_frames(ds), want)
    finally:
        ds.close()
