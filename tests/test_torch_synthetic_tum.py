"""The port's TUM exporter (examples/torch_make_synthetic_tum.py) against
the JAX package's (examples/make_synthetic_tum.py) on the CPU.

One scene (4 objects, seed 3, 5 frames), exported by each package from its
own generator: once clean and once with every corruption knob on (depth
noise, bbox jitter, detection dropout, odometry noise).  The same files
(RGB is a PNG in the port, a JPEG in the JAX export) and the same rows:
timestamps and paths equal, numbers within the 4-decimal precision they
are written at (objects_gt.txt at 6 decimals), the same detection rows
dropped and the boxes within tests/test_torch_slice.py's 0.1 px (both
project in f32); depth as tests/test_torch_render.py holds it (|delta| <= 1
on at least 99.5 % of the pixels: the two renderers round differently at a
few silhouette pixels), with the same noise draws on top.
"""
import importlib.util
import os

import numpy as np
import pytest

from object_oriented_slam_tpu.core.camera import Camera as JCamera
from object_oriented_slam_tpu.io import synthetic as jsyn
from object_oriented_slam_tpu_torch.io import synthetic as tsyn
from object_oriented_slam_tpu_torch.io.png import read_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE_KW = dict(n_objects=4, seed=3, radius_range=(1.3, 2.2),
                scale_range=(0.2, 0.4))
DATA_KW = dict(n_frames=5, orbit_radius=3.6, height=1.7)
CORRUPT = dict(odometry_noise=0.01, seed=5, depth_noise=0.01,
               bbox_jitter=2.0, det_dropout=0.3)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", params=["clean", "corrupted"])
def exports(request, tmp_path_factory):
    pytest.importorskip("cv2")
    kw = CORRUPT if request.param == "corrupted" else {}
    tmp = tmp_path_factory.mktemp("export_" + request.param)
    scene = tsyn.make_scene(**SCENE_KW)
    cam = scene.camera
    jscene = jsyn.make_scene(**SCENE_KW, camera=JCamera(
        fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, scale=cam.scale,
        width=cam.width, height=cam.height))
    np.testing.assert_allclose(scene.ellipsoids, jscene.ellipsoids,
                               atol=1e-12)
    port, jax = str(tmp / "port"), str(tmp / "jax")
    n = _example("torch_make_synthetic_tum").export_synthetic_tum(
        port, scene, tsyn.SyntheticDataset(scene, **DATA_KW), **kw)
    jn = _example("make_synthetic_tum").export_synthetic_tum(
        jax, jscene, jsyn.SyntheticDataset(jscene, **DATA_KW), **kw)
    assert n == jn == DATA_KW["n_frames"]
    return port, jax, request.param


def _rows(path):
    with open(path) as f:
        return [ln.split() for ln in f if ln.strip()]


def _assert_rows_close(got, want, tol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            try:
                fx, fy = float(x), float(y)
            except ValueError:      # a path: the RGB extension differs
                assert x == (y.replace(".jpg", ".png")
                             if y.startswith("rgb/") else y)
                continue
            assert abs(fx - fy) <= tol, (a, b)


def test_same_files(exports):
    port, jax, kind = exports
    for sub in ("rgb", "depth", "bbox"):
        got = sorted(os.listdir(os.path.join(port, sub)))
        want = sorted(os.listdir(os.path.join(jax, sub)))
        if sub == "rgb":
            got = [f.replace(".png", ".jpg") for f in got]
        assert got == want and len(got) == DATA_KW["n_frames"]
    top = sorted(f for f in os.listdir(port) if f.endswith(".txt"))
    assert top == sorted(f for f in os.listdir(jax) if f.endswith(".txt"))
    assert ("odometry.txt" in top) == (kind == "corrupted")


def test_same_rows(exports):
    port, jax, _ = exports
    for name in ("groundtruth.txt", "associate.txt",
                 "associateGroundtruth.txt", "odometry.txt"):
        if os.path.exists(os.path.join(jax, name)):
            # timestamps as text; poses written at 4 decimals from float64
            # orbits computed alike
            _assert_rows_close(_rows(os.path.join(port, name)),
                               _rows(os.path.join(jax, name)), 1e-4 + 1e-9)
    _assert_rows_close(_rows(os.path.join(port, "objects_gt.txt")),
                       _rows(os.path.join(jax, "objects_gt.txt")), 1e-6)
    n_rows = 0
    for f in sorted(os.listdir(os.path.join(jax, "bbox"))):
        # the same rows kept and jittered by the same draws; the boxes
        # project in f32 in both packages, within tests/test_torch_slice.py's
        # 0.1 px
        got = _rows(os.path.join(port, "bbox", f))
        want = _rows(os.path.join(jax, "bbox", f))
        _assert_rows_close(got, want, 0.1)
        n_rows += len(want)
    assert n_rows >= 8


def test_depth_within_render_tolerance(exports):
    import cv2
    port, jax, _ = exports
    for f in sorted(os.listdir(os.path.join(jax, "depth"))):
        got = read_png(os.path.join(port, "depth", f)).astype(np.int64)
        want = cv2.imread(os.path.join(jax, "depth", f),
                          cv2.IMREAD_UNCHANGED).astype(np.int64)
        assert got.shape == want.shape == (480, 640)
        diff = np.abs(got - want)
        assert (diff <= 1).mean() >= 0.995, (f, (diff > 1).sum())
        assert (want > 0).mean() > 0.3
