"""Stages (a)-(c) of an extraction call for every detection of a frame.

For each detection: the strided depth back-projection of its box
(``backproject.bbox_point_cloud``), the voxel downsample of that cloud
(``voxel.voxel_keys``, a stable sort, the segment means), the world
transform and the supporting-plane mask of the voxel cloud, and the 10x10
centre estimate with its world transform.  The JAX package writes these as
``frontend/extractor._stage_a_one`` over ``ops/backproject`` and
``ops/voxel``, ``vmap``-ed over the detections.

``depth_cloud`` is one launch of the ``depth_cloud`` CUDA kernel
(csrc/frontend.cu) for tensors on a CUDA device and ``depth_cloud_plain``,
the plain functions composed in the extractor's order, for tensors on the
CPU.  ``depth_cloud_border`` (sparse symmetry) is the same launch with one
more output, each voxel's mean depth-border flag (JAX ``_stage_a_one`` with
``border_map``: ``ops/filters.depth_border_mask``,
``ops/backproject.bbox_pixel_lookup``, ``ops/voxel.voxel_downsample_full``);
its plain version is ``depth_cloud_border_plain``.

The offline batch mapper passes B frames at once: depth [B, H, W], pose
[B, 7] and each detection's frame index ``frame`` [D] int32 (JAX's
``extract_local_ellipsoids_multi`` with its per-detection ``row0``).  On a
CUDA device that is still ONE launch, of the kernel's frame lane; R_wc is
then one rotation a detection [D, 3, 3].  A detection's outputs are those
of its frame's own call, bit for bit: the lane only moves the depth
image's and the pose's base, and the border's 4-neighbour test wraps
inside the detection's own frame.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import se3
from ..core.camera import Camera
from . import backproject as bp
from . import filters
from . import frontend_kernels as fk
from . import voxel as vx


class DepthCloud(NamedTuple):
    pts_w: torch.Tensor        # [D, capacity, 3] world voxel cloud
    m2: torch.Tensor           # [D, capacity] voxels above the plane
    center_w: torch.Tensor     # [D, 3] world centre estimate
    ok_points: torch.Tensor    # [D] some voxel survives the plane test
    ok_center: torch.Tensor    # [D] >= 2 valid centre samples
    R_wc: torch.Tensor         # [3, 3] camera -> world rotation ([D, 3, 3]
    #                            with a batch of frames)
    pts_v: torch.Tensor        # [D, capacity, 3] camera-frame voxel cloud
    cells_v: torch.Tensor      # [D, capacity, 3] int32 its cells


def plane_world(pose_wc: torch.Tensor, plane: torch.Tensor,
                clearance: float, frame=None) -> vx.World:
    """The extractor's world transform and supporting-plane test for the
    pose ``pose_wc`` [7] and the world ground ``plane`` [4]; with ``frame``
    [D], poses [B, 7] and one transform a detection, its frame's."""
    n = plane[:3]
    den = torch.sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]).clamp_min(1e-8)
    if frame is not None:
        pose_wc = pose_wc[frame.long()]
    return vx.World(se3.quat_to_mat(pose_wc[..., 3:]), pose_wc[..., :3],
                    plane, den, clearance)


def _plain(depth, bboxes, pose_wc, plane, cam: Camera, leaf: float,
           depth_range: float, clearance: float, capacity: int,
           border: bool, frame=None):
    world = plane_world(pose_wc, plane, clearance, frame)
    pts_cam, m0 = bp.bbox_point_cloud_plain(depth, bboxes, cam, depth_range,
                                            frame)
    key, cmin = vx.voxel_keys(pts_cam, m0, leaf)
    key_s, order = torch.sort(key, dim=1, stable=True)
    pts_v, cells_v, _, pts_w, m2 = vx.voxel_segment_mean_plain(
        key_s, order, pts_cam, cmin, capacity, world)
    center, ok_center = bp.center_estimate(depth, bboxes, cam, depth_range,
                                           frame)
    center_w, _ = vx.world_points_plain(center, world)
    cloud = DepthCloud(pts_w, m2, center_w, m2.any(1), ok_center, world.R,
                       pts_v, cells_v)
    if not border:
        return cloud
    attr = bp.bbox_pixel_lookup(filters.depth_border_mask(depth, cam.scale),
                                bboxes, frame)
    return cloud, vx.voxel_attr_mean_plain(key_s, order, attr, capacity)


def depth_cloud_plain(depth, bboxes, pose_wc, plane, cam: Camera,
                      leaf: float, depth_range: float, clearance: float,
                      capacity: int, frame=None) -> DepthCloud:
    """Plain PyTorch version of ``depth_cloud`` (any device)."""
    return _plain(depth, bboxes, pose_wc, plane, cam, leaf, depth_range,
                  clearance, capacity, False, frame)


def depth_cloud_border_plain(depth, bboxes, pose_wc, plane, cam: Camera,
                             leaf: float, depth_range: float,
                             clearance: float, capacity: int, frame=None):
    """Plain PyTorch version of ``depth_cloud_border`` (any device): the
    border map of the whole image (``filters.depth_border_mask``; of each
    frame, wrapped in itself, with a batch), sampled at the boxes' strided
    pixels (``backproject.bbox_pixel_lookup``) and averaged per voxel in
    the points' sorted order."""
    return _plain(depth, bboxes, pose_wc, plane, cam, leaf, depth_range,
                  clearance, capacity, True, frame)


def _launch(depth, bboxes, pose_wc, plane, cam: Camera, leaf: float,
            depth_range: float, clearance: float, capacity: int,
            border: bool, frame=None):
    """One launch of the ``depth_cloud`` kernel; with ``border`` also the
    voxels' border attribute, with ``frame`` the frame lane.  Returns
    (DepthCloud, battr_v | None)."""
    H, W = depth.shape[-2:]
    D = bboxes.shape[0]
    dev = depth.device
    if frame is None:
        fk.check("depth", depth, torch.int32, (H, W), dev)
        fk.check("pose_wc", pose_wc, torch.float32, (7,), dev)
    else:
        B = depth.shape[0] if depth.dim() == 3 else -1
        fk.check("depth", depth, torch.int32, (B, H, W), dev)
        fk.check("pose_wc", pose_wc, torch.float32, (B, 7), dev)
        fk.check("frame", frame, torch.int32, (D,), dev)
        if D < 1:
            raise ValueError("depth_cloud's frame lane takes at least one "
                             "detection")
    fk.check("bboxes", bboxes, torch.float32, (D, 4), dev)
    fk.check("plane", plane, torch.float32, (4,), dev)
    G = (-(-H // bp.STRIDE)) * (-(-W // bp.STRIDE))
    if G > vx.MAX_IDS:
        raise ValueError(f"depth_cloud takes at most {vx.MAX_IDS} strided "
                         f"pixels an image (got {G} at {H}x{W}): point ids "
                         "are 16-bit")
    if capacity < 1:
        raise ValueError(f"capacity={capacity}")

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    pts_w, m2 = empty(D, capacity, 3), empty(D, capacity, dtype=torch.bool)
    center_w = empty(D, 3)
    ok_points = empty(D, dtype=torch.bool)
    ok_center = empty(D, dtype=torch.bool)
    R_wc = empty(3, 3) if frame is None else empty(D, 3, 3)
    pts_v = empty(D, capacity, 3)
    cells_v = empty(D, capacity, 3, dtype=torch.int32)
    battr_v = empty(D, capacity) if border else None
    fk.launch(fk.DEPTH_CLOUD, "oslam_depth_cloud", dev,
              [depth.data_ptr(), H, W, bboxes.data_ptr(), D,
               pose_wc.data_ptr(), plane.data_ptr(), cam.scale, cam.fx,
               cam.fy, cam.cx, cam.cy, depth_range, leaf, clearance, capacity,
               pts_w.data_ptr(), m2.data_ptr(), center_w.data_ptr(),
               ok_points.data_ptr(), ok_center.data_ptr(), R_wc.data_ptr(),
               pts_v.data_ptr(), cells_v.data_ptr(),
               battr_v.data_ptr() if border else None, filters.BORDER_JUMP,
               None if frame is None else frame.data_ptr()])
    return DepthCloud(pts_w, m2, center_w, ok_points, ok_center, R_wc, pts_v,
                      cells_v), battr_v


def depth_cloud(depth, bboxes, pose_wc, plane, cam: Camera, leaf: float,
                depth_range: float, clearance: float, capacity: int,
                frame=None) -> DepthCloud:
    """Stages (a)-(c) of every detection.

    depth [H, W] int32; bboxes [D, 4] float32 x1 y1 x2 y2 (padded lanes
    zero); pose_wc [7] camera -> world (t, quaternion x y z w); plane [4]
    the world ground plane; all on one device.  ``leaf``: the voxel size,
    ``clearance``: the height above the plane a voxel needs, ``capacity``:
    the voxels kept per detection (the first in key order).  ``frame`` [D]
    int32 (a batch of frames): depth [B, H, W], pose_wc [B, 7], detection d
    in frame frame[d]; R_wc is then [D, 3, 3].

    On a CUDA device this is one launch of the ``depth_cloud`` kernel; on
    the CPU the plain version.
    """
    if depth.device.type != "cuda":
        return depth_cloud_plain(depth, bboxes, pose_wc, plane, cam, leaf,
                                 depth_range, clearance, capacity, frame)
    return _launch(depth, bboxes, pose_wc, plane, cam, leaf, depth_range,
                   clearance, capacity, False, frame)[0]


def depth_cloud_border(depth, bboxes, pose_wc, plane, cam: Camera,
                       leaf: float, depth_range: float, clearance: float,
                       capacity: int, frame=None):
    """``depth_cloud`` with each voxel's depth-border attribute (sparse
    symmetry): a strided pixel is a border pixel where its depth jumps by
    more than ``filters.BORDER_JUMP`` metres against one of its 4
    neighbours (wrapped across the image edge) or a neighbour has no depth
    (``filters.depth_border_mask``); a voxel's attribute is the mean of its
    points' flags.  Returns (DepthCloud, battr_v [D, capacity] float32, 0
    on empty slots).

    On a CUDA device one launch of the ``depth_cloud`` kernel, which tests
    the neighbours of the boxes' strided pixels itself (no border map of
    the image; the 4 neighbours wrap inside the detection's own frame); on
    the CPU ``depth_cloud_border_plain``.  ``frame``: see ``depth_cloud``.
    """
    if depth.device.type != "cuda":
        return depth_cloud_border_plain(depth, bboxes, pose_wc, plane, cam,
                                        leaf, depth_range, clearance,
                                        capacity, frame)
    return _launch(depth, bboxes, pose_wc, plane, cam, leaf, depth_range,
                   clearance, capacity, True, frame)
