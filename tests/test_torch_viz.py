"""The port's viewers (``viz/web_viewer.py``, ``viz/export.py``) against the
JAX package's, on the CPU.

The six cases of tests/test_web_viewer.py, each run through both packages
on the same inputs: the embedded JSON parsed and compared (numbers within
1e-6, everything else equal) and the page's structure (one script, the
live-reload machinery).  ``draw_frame`` / ``draw_depth_frame`` on
tests/test_aux.py's frame and on a frame with map ellipses in view, pixel
for pixel against JAX's images; ``render_map`` writes its PNG.  cv2 and
matplotlib are optional in both packages; the cases that need them skip
without them.
"""
import json
import os
import re

import numpy as np
import pytest
import torch

from object_oriented_slam_tpu.system.state import SlamState as JState
from object_oriented_slam_tpu.viz import export as jexport
from object_oriented_slam_tpu.viz import web_viewer as jweb
from object_oriented_slam_tpu_torch.system.state import SlamState as TState
from object_oriented_slam_tpu_torch.viz import export as texport
from object_oriented_slam_tpu_torch.viz import web_viewer as tweb

torch.set_num_threads(1)    # the test workers share the CPU

K = np.array([[60.0, 0, 32], [0, 60, 24], [0, 0, 1]])
K_VGA = np.array([[525.0, 0, 319.5], [0, 525.0, 239.5], [0, 0, 1]])


def _objects():
    return {0: np.array([0, 0, 0.2, 0, 0, 0, 1, 0.3, 0.2, 0.2]),
            3: np.array([1, 0.5, 0.2, 0, 0, 0.7071, 0.7071, 0.4, 0.2, 0.1])}


def _data(path):
    html = open(path).read()
    assert html.count("<script>") == 1
    m = re.search(r"const DATA = (\{.*?\});\n", html, re.S)
    assert m, "embedded DATA not found"
    return html, json.loads(m.group(1))


def _same(a, b, where="DATA"):
    """JSON values equal, numbers within 1e-6."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, (int, float)) and not isinstance(a, bool):
        assert isinstance(b, (int, float)) and abs(a - b) <= 1e-6, \
            (where, a, b)
    else:
        assert a == b, (where, a, b)


def _both(tmp_path, name, fn):
    """``fn(module, state class, directory)`` for the port and JAX; returns
    (port html, port data, JAX html, JAX data) of the file it writes."""
    out = []
    for tag, mod, state in (("p", tweb, TState), ("j", jweb, JState)):
        d = tmp_path / tag
        d.mkdir(exist_ok=True)
        out += list(_data(fn(mod, state, str(d))))
    _same(out[1], out[3])
    return out


def _export_html(mod, state, d):
    return mod.export_html(os.path.join(d, "map.html"), _objects(),
                           trajectory=np.tile([0, 0, 0, 0, 0, 0, 1.0],
                                              (5, 1)),
                           ground_plane=np.array([0, 0, 1, 0.0]))


def _live_mode(mod, state, d):
    return mod.export_html(os.path.join(d, "live.html"), _objects(),
                           live_reload_s=2.5)


def _snapshot(mod, state, d, second=False):
    st = state()
    st.frames_pose_wc.append(np.array([0, 0, 0, 0, 0, 0, 1.0]))
    rec = st.record(0)
    rec.vec10 = np.array([0, 0, 0, 0, 0, 0, 1, 0.3, 0.2, 0.1])
    rec.initialized = True
    f1 = mod.export_live_snapshot(d, st, 10)
    assert "frame 10" in open(f1).read()
    st.record(1).vec10 = np.array([1, 1, 0, 0, 0, 0, 1, 0.2, 0.2, 0.2])
    st.objects[1].initialized = True
    f2 = mod.export_live_snapshot(d, st, 20)
    assert f2 == f1 and not os.path.exists(f1 + ".tmp")
    return f2


def _state_html(mod, state, d):
    st = state()
    rec = st.record(2)
    rec.vec10 = np.array([0, 0, 0, 0, 0, 0, 1, 0.3, 0.2, 0.1])
    rec.initialized = True
    rec.history.append(np.array([5, 1, 0, 0, 0, 0, 0, 0, 0.3, 0.2, 0.1]))
    st.add_point_cloud_list("Extractor.ObjectPoints",
                            np.random.RandomState(0).rand(50, 3))
    return mod.export_state_html(os.path.join(d, "s.html"), st,
                                 live_reload_s=1.0)


def _panels(mod, state, d):
    pytest.importorskip("cv2")
    rgb = np.full((48, 64, 3), 120, np.uint8)
    depth = (np.random.RandomState(0).rand(48, 64) * 20000).astype(np.uint16)
    det = np.array([[0, 5, 5, 30, 30, 56, 1.0, 0]])
    panels = mod.frame_panels(rgb=rgb, depth=depth, det_mat=det,
                              map_objects=_objects(),
                              pose_wc=np.array([0, 0, -3, 0, 0, 0, 1.0]),
                              K=K, depth_scale=5000.0)
    assert set(panels) == {"frame", "depth"}
    return mod.export_live_snapshot(d, state(), 7, image_panels=panels)


def _no_panels(mod, state, d):
    return mod.export_live_snapshot(d, state(), 1)


@pytest.mark.parametrize("case", [
    "export_html_structure", "live_mode_embeds_reload",
    "export_live_snapshot_atomic", "export_state_html_passthrough",
    "frame_panels_embedded", "panels_absent_by_default"])
def test_web_viewer_matches_jax(case, tmp_path):
    fn = {"export_html_structure": _export_html,
          "live_mode_embeds_reload": _live_mode,
          "export_live_snapshot_atomic": _snapshot,
          "export_state_html_passthrough": _state_html,
          "frame_panels_embedded": _panels,
          "panels_absent_by_default": _no_panels}[case]
    html, data, jhtml, _ = _both(tmp_path, case, fn)
    # the page around the data is the JAX package's template
    assert html.replace(re.search(r"const DATA = .*?;\n", html, re.S)[0],
                        "") == jhtml.replace(re.search(
                            r"const DATA = .*?;\n", jhtml, re.S)[0], "")
    if case == "export_html_structure":
        assert len(data["objects"]) == 2 and data["plane"] is not None
        assert data["reload_s"] == 0
    elif case == "live_mode_embeds_reload":
        assert data["reload_s"] == 2.5
        assert "localStorage" in html and "location.reload" in html
    elif case == "export_live_snapshot_atomic":
        assert "frame 20" in data["title"] and len(data["objects"]) == 2
    elif case == "export_state_html_passthrough":
        assert data["reload_s"] == 1.0 and "2" in data["history"]
        assert data["clouds"][0]["name"] == "Extractor.ObjectPoints"
    elif case == "frame_panels_embedded":
        assert {e["name"] for e in data["panels"]} == {"frame", "depth"}
    else:
        assert data["panels"] == []


def _scene_frame():
    """A VGA frame with two detections and two map objects in view."""
    rgb = (np.random.RandomState(3).rand(480, 640, 3) * 255).astype(np.uint8)
    det = np.array([[0, 100, 100, 200, 200, 28, 0.9, 0],
                    [1, 300.5, 120.2, 420.9, 300.7, 57, 0.8, 0]])
    objs = {0: np.array([0, 0, 3, 0, 0, 0, 1, 0.5, 0.5, 0.5]),
            4: np.array([0.6, 0.1, 3.5, 0.1, 0.2, 0.3, 0.927, 0.4, 0.2,
                         0.3])}
    return rgb, det, objs


def test_draw_frame_matches_jax():
    """tests/test_aux.py's frame (one box, one ellipsoid ahead) and a
    frame with two boxes and two map ellipses: the images equal JAX's."""
    pytest.importorskip("cv2")
    pose = np.array([0, 0, 0, 0, 0, 0, 1.0])
    rgb = np.zeros((480, 640, 3), np.uint8)
    det = np.array([[0, 100, 100, 200, 200, 28, 0.9, 0]])
    objs = {0: np.array([0, 0, 3, 0, 0, 0, 1, 0.5, 0.5, 0.5])}
    cases = [(rgb, det, objs), _scene_frame()]
    for rgb, det, objs in cases:
        img = texport.draw_frame(rgb, det, objs, pose, K_VGA)
        jimg = jexport.draw_frame(rgb, det, objs, pose, K_VGA)
        assert img.sum() > 0 and img.shape == (480, 640, 3)
        np.testing.assert_array_equal(img, jimg)
    # an object behind the camera projects to no ellipse on either side
    behind = {7: np.array([0, 0, -3, 0, 0, 0, 1, 0.5, 0.5, 0.5])}
    np.testing.assert_array_equal(
        texport.draw_frame(rgb, None, behind, pose, K_VGA),
        jexport.draw_frame(rgb, None, behind, pose, K_VGA))
    depth = np.full((480, 640), 10000, np.uint16)
    depth[100:200, 50:400] = 25000
    d = texport.draw_depth_frame(depth)
    assert d.shape == (480, 640, 3)
    np.testing.assert_array_equal(d, jexport.draw_depth_frame(depth))


def test_render_map_writes_png(tmp_path):
    pytest.importorskip("matplotlib")
    _, _, objs = _scene_frame()
    traj = np.stack([np.linspace(-1, 1, 20), np.zeros(20),
                     np.full(20, 1.5)], 1)
    cloud = np.random.RandomState(0).rand(300, 3)
    path = texport.render_map(objs, traj, np.array([0, 0, 1, 0.0]), cloud,
                              str(tmp_path / "map.png"))
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    # the wireframe's points are JAX's
    for v in objs.values():
        got, shape = texport._ellipsoid_wireframe(v)
        want, jshape = jexport._ellipsoid_wireframe(v)
        assert shape == jshape
        np.testing.assert_allclose(got, want, atol=1e-6)
