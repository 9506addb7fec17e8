"""Dense RGB-D map builder (visualization-grade reconstruction).

Port of ``system/dense_builder.py`` (the reference's
``src/dense_builder/builder.cpp``): per frame the full RGB-D image is
back-projected at a stride, moved to the world by Twc, merged into the
global cloud and voxel-filtered (builder.cpp:46-137).  The map is a
fixed-capacity voxel-fused buffer on the device, updated by one
``ops/dense_fuse.dense_fuse`` a frame (K12 on the card; its buffers are
allocated once, at the first frame); PCD / PLY export replaces
``saveMap``.  Colours are BGR rows, the channel order of the frames
``io/png.py`` decodes.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.camera import Camera
from ..ops.dense_fuse import FuseWork, dense_fuse
from ..utils.device import resolve_device
from ..utils.transfer import to_device


class DenseBuilder:
    """Accumulates a voxel-fused global colour cloud on ``device`` (the
    card unless the caller names another, e.g. ``device="cpu"``)."""

    def __init__(self, cam: Camera, leaf: float = 0.01, stride: int = 4,
                 capacity: int = 1 << 19, depth_range: float = 6.0,
                 device=None):
        self.cam = cam
        self.leaf = leaf
        self.stride = stride
        self.capacity = capacity
        self.depth_range = depth_range
        self.device = resolve_device(device)
        self.pts = torch.zeros((capacity, 3), device=self.device)
        self.rgb = torch.zeros((capacity, 3), device=self.device)
        self.mask = torch.zeros(capacity, dtype=torch.bool, device=self.device)
        self._work = None    # the kernel's buffers, made at the first frame

    def process_frame(self, rgb, depth, pose_wc):
        """Fuse one frame: depth [H, W] (TUM units), rgb [H, W, 3] or None
        (fuses zeros), pose_wc [7]."""
        dev = self.device
        depth = np.asarray(depth)
        depth_t = to_device(depth.astype(np.int32), dev)
        rgb_t = None
        if rgb is not None:
            # uint8 frames go up as they are and widen on the device
            rgb_t = to_device(np.asarray(rgb), dev).to(torch.float32)
        elif dev.type != "cuda":
            rgb_t = torch.zeros(depth.shape + (3,), device=dev)
        pose = to_device(np.asarray(pose_wc, np.float32), dev)
        if dev.type == "cuda" and (self._work is None or not self._work.fits(
                self.capacity, *depth.shape, self.stride, dev)):
            self._work = FuseWork(self.capacity, *depth.shape, self.stride,
                                  dev)
        self.pts, self.rgb, self.mask = dense_fuse(
            self.pts, self.rgb, self.mask, depth_t, rgb_t, pose, self.cam,
            self.stride, self.leaf, self.capacity, self.depth_range,
            work=self._work)

    def get_map(self):
        """(points [n, 3], BGR colours [n, 3]) of the occupied cells, numpy."""
        m = self.mask.cpu().numpy()
        return self.pts.cpu().numpy()[m], self.rgb.cpu().numpy()[m]

    def save_ply(self, path: str):
        pts, rgb = self.get_map()
        save_ply(path, pts, rgb)

    def save_pcd(self, path: str):
        pts, rgb = self.get_map()
        save_pcd(path, pts, rgb)

    def save_map(self, path: str):
        """Format chosen by extension (.pcd like the reference, else PLY)."""
        if path.lower().endswith(".pcd"):
            self.save_pcd(path)
        else:
            self.save_ply(path)


def save_pcd(path: str, pts: np.ndarray, rgb: np.ndarray = None):
    """ASCII PCD v0.7 export, the format the reference saves
    (``pcl::io::savePCDFile``, builder.cpp:121-125).  ``rgb`` rows are BGR
    floats as the builder stores them, packed into PCL's single float rgb
    field as RGB."""
    n = len(pts)
    with_rgb = rgb is not None
    fields = "x y z rgb" if with_rgb else "x y z"
    k = 4 if with_rgb else 3
    with open(path, "w") as f:
        f.write("# .PCD v0.7 - Point Cloud Data file format\n")
        f.write("VERSION 0.7\n")
        f.write(f"FIELDS {fields}\n")
        f.write("SIZE" + " 4" * k + "\n")
        f.write("TYPE" + " F" * k + "\n")
        f.write("COUNT" + " 1" * k + "\n")
        f.write(f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n")
        f.write(f"POINTS {n}\nDATA ascii\n")
        if with_rgb:
            c = np.clip(rgb, 0, 255).astype(np.uint32)
            packed = (c[:, 2] << 16) | (c[:, 1] << 8) | c[:, 0]  # BGR->RGB
            packed_f = packed.astype(np.uint32).view(np.float32)
            for i in range(n):
                f.write(f"{pts[i, 0]:.4f} {pts[i, 1]:.4f} {pts[i, 2]:.4f} "
                        f"{packed_f[i]:.9e}\n")
        else:
            for i in range(n):
                f.write(f"{pts[i, 0]:.4f} {pts[i, 1]:.4f} {pts[i, 2]:.4f}\n")


def save_ply(path: str, pts: np.ndarray, rgb: np.ndarray = None):
    """ASCII PLY export (alternative to the reference's PCD save); the
    builder's BGR rows are written as RGB."""
    n = len(pts)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if rgb is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        for i in range(n):
            row = f"{pts[i, 0]:.4f} {pts[i, 1]:.4f} {pts[i, 2]:.4f}"
            if rgb is not None:
                c = rgb[i].astype(int)
                row += f" {c[2]} {c[1]} {c[0]}"
            f.write(row + "\n")
