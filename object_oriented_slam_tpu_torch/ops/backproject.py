"""Depth -> point cloud (fixed-shape, masked), batched over detections.

Port of ``object_oriented_slam_tpu/ops/backproject.py``, the replacement
for the reference's pixel loops:
  * ``getPointCloudInRect`` (src/symmetry/PointCloudFilter.cpp:21-61):
    bbox region scanned with stride 3, depth gated to (0.1, range].
  * full-image back-projection (src/core/Geometry.cpp:8-41,
    src/plane/PlaneExtractor.cpp:31-49).
  * center sampling ``GetCenter`` (src/pca/EllipsoidExtractor.cpp:583-643):
    10x10 samples around the bbox center.

The JAX functions take one detection and are ``vmap``-ed; here the
detections are a leading axis D.  All outputs are fixed-capacity tensors +
validity masks.

``bbox_point_cloud_plain`` and ``bbox_pixel_lookup`` are plain PyTorch on
any device: the main path's back-projection, border lookup and centre
estimate are part of the ``depth_cloud`` kernel (``ops/depth_cloud``), and
``depth_cloud_plain`` is built on them.
The offline batch mapper passes a batch of frames' images [B, H, W] and
each detection's frame index ``frame`` [D] (JAX stacks them as [B*H, W]
with a row offset ``row0`` per detection and ``hw`` the frame's shape:
the same pixels).
Divisions are by 0-dim tensors on the tensor's device: dividing a CUDA
tensor by a Python number (or by a CPU scalar tensor) multiplies by the
reciprocal instead, which lands in another last bit than the CPU.
"""
from __future__ import annotations

import torch

from ..core.camera import Camera

# stride-3 scan of a full 640x480 image fits in a (160, 214) grid
BBOX_GRID_H = 160
BBOX_GRID_W = 214
STRIDE = 3  # PointCloudFilter.cpp:31-32


def scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """0-dim float32 tensor on ``like``'s device (a true divisor), made by
    a fill on the device: no host-to-device copy, which would make the host
    wait for the stream."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _bbox_corners(bboxes, H, W):
    b = bboxes.to(torch.int32)          # truncates like the reference's casts
    return (b[:, 0].clamp(0, W - 1), b[:, 1].clamp(0, H - 1),
            b[:, 2].clamp(0, W), b[:, 3].clamp(0, H))


def pixels(image: torch.Tensor, frame, py, px):
    """image[py, px] ([H, W]), or image[frame, py, px] ([B, H, W]) with
    ``frame`` [D] each detection's frame, broadcast over py / px's
    trailing axes."""
    if frame is None:
        return image[py, px]
    f = frame.long().reshape((-1,) + (1,) * (py.dim() - 1))
    return image[f, py, px]


def bbox_point_cloud_plain(depth: torch.Tensor, bboxes: torch.Tensor,
                           cam: Camera, depth_range: float, frame=None):
    """Strided back-projection of every detection's bbox region, plain
    PyTorch on any device.

    depth: [H, W] int32; bboxes: [D, 4] x1 y1 x2 y2 (float32, may be
    fractional; truncated like the reference's int casts).  With ``frame``
    [D] int: depth [B, H, W], detection d's box in frame frame[d].
    Returns (points [D, gh*gw, 3] camera-frame, mask [D, gh*gw]) with
    gh, gw = ceil(H/3), ceil(W/3).
    """
    H, W = depth.shape[-2:]
    x1, y1, x2, y2 = _bbox_corners(bboxes, H, W)
    gh = (H + STRIDE - 1) // STRIDE
    gw = (W + STRIDE - 1) // STRIDE
    dev = depth.device
    jj = torch.arange(gw, dtype=torch.int32, device=dev)[None, None, :]
    ii = torch.arange(gh, dtype=torch.int32, device=dev)[None, :, None]
    px = x1[:, None, None] + STRIDE * jj                  # [D, 1, gw]
    py = y1[:, None, None] + STRIDE * ii                  # [D, gh, 1]
    in_box = (px < x2[:, None, None]) & (py < y2[:, None, None])
    # the [H, W] window at (y1, x1) runs past the image: those positions
    # read 0 -> z = 0 -> invalid (in_box excludes them anyway)
    inside = (px < W) & (py < H)
    pxc = px.clamp(max=W - 1).long()
    pyc = py.clamp(max=H - 1).long()
    d = torch.where(inside, pixels(depth, frame, pyc, pxc), 0).to(
        torch.float32)
    z = d / scalar(cam.scale, d)
    valid = in_box & (z > 0.1) & (z <= depth_range)
    x = (pxc.to(torch.float32) - cam.cx) * z / scalar(cam.fx, d)
    y = (pyc.to(torch.float32) - cam.cy) * z / scalar(cam.fy, d)
    pts = torch.stack([x.expand_as(z), y.expand_as(z), z], dim=-1)
    return pts.reshape(len(bboxes), -1, 3), valid.reshape(len(bboxes), -1)


def bbox_pixel_lookup(attr_map: torch.Tensor, bboxes: torch.Tensor,
                      frame=None):
    """A per-pixel attribute map [H, W] (bool or float) sampled at the SAME
    strided grid as ``bbox_point_cloud_plain``, so the result [D, gh*gw]
    float32 aligns row for row with its points (the sparse symmetry mode
    tags each point with its depth-border flag, BorderExtractor.cpp:58-132).
    Positions past the image read 0, as the JAX package's zero pad.  With
    ``frame`` [D]: maps [B, H, W], detection d's in frame frame[d]."""
    H, W = attr_map.shape[-2:]
    x1, y1, _, _ = _bbox_corners(bboxes, H, W)
    gh = (H + STRIDE - 1) // STRIDE
    gw = (W + STRIDE - 1) // STRIDE
    dev = attr_map.device
    jj = torch.arange(gw, dtype=torch.int32, device=dev)[None, None, :]
    ii = torch.arange(gh, dtype=torch.int32, device=dev)[None, :, None]
    px = x1[:, None, None] + STRIDE * jj
    py = y1[:, None, None] + STRIDE * ii
    inside = (px < W) & (py < H)
    a = pixels(attr_map, frame, py.clamp(max=H - 1).long(),
                px.clamp(max=W - 1).long())
    a = torch.where(inside, a.to(torch.float32), 0.0)
    return a.reshape(len(bboxes), -1)


def full_point_cloud(depth: torch.Tensor, cam: Camera, stride: int = 1,
                     depth_range: float = float("inf")):
    """Full-image back-projection (organized), [H//s, W//s, 3] + mask."""
    d = depth[::stride, ::stride].to(torch.float32)
    H, W = d.shape
    z = d / scalar(cam.scale, d)
    jj = torch.arange(W, dtype=torch.float32, device=d.device)[None, :] * stride
    ii = torch.arange(H, dtype=torch.float32, device=d.device)[:, None] * stride
    x = (jj - cam.cx) * z / scalar(cam.fx, d)
    y = (ii - cam.cy) * z / scalar(cam.fy, d)
    mask = (z > 1e-6) & (z <= depth_range)
    return torch.stack([x, y, z], dim=-1), mask


def center_estimate(depth: torch.Tensor, bboxes: torch.Tensor, cam: Camera,
                    depth_range: float, frame=None):
    """10x10-sample 3D center estimate in camera frame per detection
    (EllipsoidExtractor.cpp:583-643).  With ``frame`` [D]: depth
    [B, H, W], detection d's samples from frame frame[d].

    Returns (center [D, 3], ok [D] bool); ok requires >= 2 valid samples.
    """
    H, W = depth.shape[-2:]
    n = 10
    two, four, ten = (scalar(v, bboxes) for v in (2.0, 4.0, float(n)))
    xc = ((bboxes[:, 0] + bboxes[:, 2]) / two).to(torch.int32)
    yc = ((bboxes[:, 1] + bboxes[:, 3]) / two).to(torch.int32)
    x_delta = ((bboxes[:, 0] - bboxes[:, 2]).abs() / four / ten).to(torch.int32)
    y_delta = ((bboxes[:, 1] - bboxes[:, 3]).abs() / four / ten).to(torch.int32)

    k = torch.arange(n, dtype=torch.int32, device=depth.device) - n // 2
    px = (xc[:, None, None] + k[None, None, :] * x_delta[:, None, None]
          ).clamp(0, W - 1).expand(-1, n, n)
    py = (yc[:, None, None] + k[None, :, None] * y_delta[:, None, None]
          ).clamp(0, H - 1).expand(-1, n, n)
    z = pixels(depth, frame, py.long(), px.long()).to(
        torch.float32) / scalar(cam.scale, bboxes)
    valid = (z > 0.1) & (z <= depth_range)

    x = (px.to(torch.float32) - cam.cx) * z / scalar(cam.fx, bboxes)
    y = (py.to(torch.float32) - cam.cy) * z / scalar(cam.fy, bboxes)
    pts = torch.stack([x, y, z], dim=-1).reshape(-1, n * n, 3)
    w = valid.reshape(-1, n * n).to(torch.float32)
    count = w.sum(1)
    # summed in sample order from 0, the depth_cloud kernel's order (a
    # reduction's order is the library's own)
    pw = pts * w[..., None]
    acc = torch.zeros_like(pw[:, 0])
    for k in range(n * n):
        acc = acc + pw[:, k]
    center = acc / count.clamp_min(1.0)[:, None]
    return center, count >= 2


def proj_depth_map(depth: torch.Tensor, cam: Camera) -> torch.Tensor:
    """Plane-depth -> ray-length depth, elementwise (Symmetry.cpp:137-161):
    d' = d * sqrt(xi^2 + f^2 + yi^2) / f with xi = x-cx, yi = y-cy.
    depth [..., H, W] int32 -> float32 of its shape (a batch of frames
    [B, H, W] maps each frame); f^2 is rounded to float32 from double, as
    the JAX package's weakly typed constant is."""
    H, W = depth.shape[-2:]
    xi = torch.arange(W, dtype=torch.float32, device=depth.device)[None] - cam.cx
    yi = torch.arange(H, dtype=torch.float32, device=depth.device)[:, None] \
        - cam.cy
    f = scalar(cam.fx, depth)
    scale = torch.sqrt(xi * xi + scalar(cam.fx * cam.fx, depth) + yi * yi) / f
    return depth.to(torch.float32) * scale
