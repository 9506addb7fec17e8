"""Offline visualization / export.

Port of ``object_oriented_slam_tpu/viz/export.py``, which replaces the
reference's Pangolin/OpenGL stack (``src/core/Viewer.cpp``,
``MapDrawer.cpp``, ``FrameDrawer.cpp``) with headless renderers; the
ellipse projection runs through the port's ``core`` on CPU tensors, and
``cv2`` / ``matplotlib`` stay optional (imported where they are used):

  * ``draw_frame``: detection bboxes + labels and projected map-ellipsoid
    ellipses over the RGB image (FrameDrawer.cpp:63-115)
  * ``draw_depth_frame``: false-color depth (FrameDrawer.cpp:36-61)
  * ``render_map``: matplotlib 3D view of ellipsoids, trajectory and
    ground plane (MapDrawer analogue)
  * PLY export of colored clouds lives in system.dense_builder
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def draw_frame(rgb: np.ndarray, det_mat: Optional[np.ndarray],
               map_objects: Optional[Dict[int, np.ndarray]],
               pose_wc: Optional[np.ndarray], K: np.ndarray) -> np.ndarray:
    """Observed bboxes (green) + projected map ellipses (red)."""
    from ..core import ellipsoid as ell, se3

    img = rgb.copy()
    if det_mat is not None:
        for row in np.asarray(det_mat).reshape(-1, det_mat.shape[-1]):
            x1, y1, x2, y2 = [int(v) for v in row[1:5]]
            cv2.rectangle(img, (x1, y1), (x2, y2), (0, 255, 0), 2)
            cv2.putText(img, f"{int(row[5])}", (x1, max(0, y1 - 4)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 255, 0), 1)
    if map_objects and pose_wc is not None:
        pose_cw = se3.se3_inv(torch.as_tensor(pose_wc.astype(np.float32)))
        for inst, v in map_objects.items():
            try:
                e5 = ell.project_ellipse(
                    torch.as_tensor(np.asarray(v, np.float32)), pose_cw,
                    torch.as_tensor(np.asarray(K, np.float32))).numpy()
            except Exception:
                continue
            if not np.all(np.isfinite(e5)):
                continue
            center = (int(e5[0]), int(e5[1]))
            axes = (max(1, int(e5[3])), max(1, int(e5[4])))
            ang = float(np.degrees(e5[2]))
            cv2.ellipse(img, center, axes, ang, 0, 360, (0, 0, 255), 2)
            cv2.putText(img, f"#{inst}", center, cv2.FONT_HERSHEY_SIMPLEX,
                        0.5, (0, 0, 255), 1)
    return img


def draw_depth_frame(depth: np.ndarray, scale: float = 5000.0,
                     max_m: float = 6.0) -> np.ndarray:
    """False-color depth (FrameDrawer.cpp:36-61)."""
    z = depth.astype(np.float32) / scale
    z = np.clip(z / max_m, 0, 1)
    img = (z * 255).astype(np.uint8)
    return cv2.applyColorMap(img, cv2.COLORMAP_JET)


def _ellipsoid_wireframe(v, n_u=16, n_v=8):
    from ..core import se3
    u = np.linspace(0, 2 * np.pi, n_u)
    w = np.linspace(-np.pi / 2, np.pi / 2, n_v)
    uu, ww = np.meshgrid(u, w)
    x = v[7] * np.cos(ww) * np.cos(uu)
    y = v[8] * np.cos(ww) * np.sin(uu)
    z = v[9] * np.sin(ww)
    pts = np.stack([x, y, z], -1).reshape(-1, 3)
    R = se3.quat_to_mat(torch.as_tensor(
        np.asarray(v[3:7], np.float32))).numpy()
    return pts @ R.T + v[:3], (n_v, n_u)


def render_map(map_objects: Dict[int, np.ndarray],
               trajectory: Optional[np.ndarray] = None,
               ground_plane: Optional[np.ndarray] = None,
               cloud: Optional[np.ndarray] = None,
               path: str = "map.png"):
    """Headless 3D map rendering to an image file."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection="3d")
    if cloud is not None and len(cloud):
        sub = cloud[:: max(1, len(cloud) // 5000)]
        ax.scatter(sub[:, 0], sub[:, 1], sub[:, 2], s=0.2, c="gray",
                   alpha=0.3)
    if trajectory is not None and len(trajectory):
        t = np.asarray(trajectory)
        ax.plot(t[:, 0], t[:, 1], t[:, 2], "b-", lw=1, label="trajectory")
    for inst, v in (map_objects or {}).items():
        pts, (nv, nu) = _ellipsoid_wireframe(v)
        grid = pts.reshape(nv, nu, 3)
        for i in range(nv):  # latitude rings
            ax.plot(grid[i, :, 0], grid[i, :, 1], grid[i, :, 2], "r-",
                    lw=0.6)
        for j in range(0, nu, 2):  # longitude arcs
            ax.plot(grid[:, j, 0], grid[:, j, 1], grid[:, j, 2], "r-",
                    lw=0.4, alpha=0.8)
        ax.text(v[0], v[1], v[2], f"#{inst}", color="red")
    if ground_plane is not None:
        n = ground_plane[:3] / np.linalg.norm(ground_plane[:3])
        d = -ground_plane[3] / np.linalg.norm(ground_plane[:3])
        # draw a small grid patch of the plane near the scene center
        c = (np.mean([v[:3] for v in map_objects.values()], axis=0)
             if map_objects else np.zeros(3))
        c = c - (np.dot(n, c) - d) * n
        a = np.cross(n, [0, 0, 1.0])
        if np.linalg.norm(a) < 1e-6:
            a = np.array([1.0, 0, 0])
        a = a / np.linalg.norm(a)
        b = np.cross(n, a)
        g = np.linspace(-1.5, 1.5, 6)
        for gi in g:
            p0, p1 = c + gi * a - 1.5 * b, c + gi * a + 1.5 * b
            ax.plot(*np.stack([p0, p1]).T, "g-", lw=0.4, alpha=0.6)
            p0, p1 = c + gi * b - 1.5 * a, c + gi * b + 1.5 * a
            ax.plot(*np.stack([p0, p1]).T, "g-", lw=0.4, alpha=0.6)
    ax.set_xlabel("x"); ax.set_ylabel("y"); ax.set_zlabel("z")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
