"""Ground-plane extraction from a depth image.

Port of ``object_oriented_slam_tpu/frontend/ground_plane.py``, the re-design
of ``PlaneExtractor`` (``src/plane/PlaneExtractor.cpp``): the reference uses
PCL IntegralImageNormalEstimation (AVERAGE_3D_GRADIENT) + OrganizedMultiPlane
Segmentation, keeps planes with >= Plane.MinSize inliers, rejects planes
whose normal deviates more than 45 deg from the camera Y (gravity
assumption), picks the largest by inlier count, and sign-normalizes so the
camera sits on the positive side (:126-183).

Here the same output contract is met with a dense, fixed-shape pipeline:
organized normals from smoothed depth gradients, a deterministic grid of
seed-pixel plane hypotheses (point + normal each define a plane), inlier
counting under the same distance/angle thresholds, and a least-squares
refinement over the winning hypothesis's inliers.  Hypothesis scoring is
one [S, P] masked distance computation.  Plain PyTorch on the depth
tensor's device: it runs once per sequence.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.camera import Camera
from ..ops import backproject as bp
from ..ops import linalg
from ..utils.transfer import HostCopy, to_device


@dataclasses.dataclass(frozen=True)
class GroundPlaneConfig:
    angle_threshold_deg: float = 5.0    # Plane.AngleThreshold
    distance_threshold: float = 0.1     # Plane.DistanceThreshold
    min_size: int = 200                 # Plane.MinSize
    gravity_max_angle: float = 45.0     # PlaneExtractor.cpp:148-157
    stride: int = 4                     # pixel subsampling for speed
    seeds: int = 64                     # hypothesis grid size (8x8)
    smooth: int = 2                     # half-window of normal smoothing


def estimate_ground_plane(depth: torch.Tensor, cam: Camera,
                          cfg: GroundPlaneConfig):
    """depth [H, W] -> (plane vec4 camera frame, ok 0-dim bool).

    The returned plane satisfies the reference's contract: unit-ish normal
    within 45 deg of camera +Y, >= min_size inliers (scaled by stride^2),
    positive distance to the camera center.
    """
    depth = depth.to(torch.int32)
    dev = depth.device
    pts, mask = bp.full_point_cloud(depth, cam, stride=cfg.stride,
                                    depth_range=10.0)
    H, W = pts.shape[:2]

    # organized normals: smoothed depth-gradient cross products
    dx = torch.roll(pts, -1, dims=1) - torch.roll(pts, 1, dims=1)
    dy = torch.roll(pts, -1, dims=0) - torch.roll(pts, 1, dims=0)
    raw_n = linalg.cross(dx, dy)

    # 5-tap separable box smoothing via shifted adds; rolls wrap around at
    # the borders, and the 2-pixel border where that differs from a
    # convolution is masked out below (``interior``)
    def box5(x, axis):
        return sum(torch.roll(x, s, dims=axis) for s in (-2, -1, 0, 1, 2)) / 5.0

    sm = box5(box5(raw_n, 0), 1)
    nrm = torch.sqrt((sm * sm).sum(-1, keepdim=True))
    normals = sm / nrm.clamp_min(1e-9)
    n_ok = (nrm[..., 0] > 1e-12) & mask
    interior = torch.zeros((H, W), dtype=torch.bool, device=dev)
    interior[2:-2, 2:-2] = True
    n_ok = n_ok & interior

    pts_f = pts.reshape(-1, 3)
    normals_f = normals.reshape(-1, 3)
    ok_f = n_ok.reshape(-1)

    # gravity gate: normal within 45 deg of +-Y (PlaneExtractor.cpp:148-157)
    cos_y = normals_f[:, 1]
    grav_ok = cos_y.abs() > math.cos(math.radians(cfg.gravity_max_angle))
    cand = ok_f & grav_ok

    # deterministic seed grid over the image
    g = int(cfg.seeds ** 0.5)
    si = torch.arange(g, device=dev) * (H // g) + H // (2 * g)
    sj = torch.arange(g, device=dev) * (W // g) + W // (2 * g)
    seed_idx = (si[:, None] * W + sj[None, :]).reshape(-1)

    seed_pts = pts_f[seed_idx]
    seed_nrm = normals_f[seed_idx]
    seed_ok = cand[seed_idx]

    ang_th = math.cos(math.radians(cfg.angle_threshold_deg))

    # score every seed hypothesis against every point: [S, P]
    d = (pts_f[None, :, :] - seed_pts[:, None, :]) @ seed_nrm[:, :, None]
    dist_ok = d[..., 0].abs() < cfg.distance_threshold
    ang_ok = (normals_f @ seed_nrm.T).T.abs() > ang_th
    inls = cand[None, :] & dist_ok & ang_ok
    counts = torch.where(seed_ok, inls.sum(1), -1)
    best = torch.argmax(counts)
    best_count = counts[best]
    inl = inls[best]

    # least-squares refinement over inliers: centroid + smallest-eig normal
    wgt = inl.to(torch.float32)
    n_in = wgt.sum().clamp_min(1.0)
    c = (pts_f * wgt[:, None]).sum(0) / n_in
    dc = (pts_f - c) * wgt[:, None]
    cov = dc.T @ dc / n_in
    _, vecs = linalg.eigh3(cov)
    nrm_fit = vecs[:, 0]
    # keep orientation near the winning hypothesis
    nrm_fit = torch.where((nrm_fit * seed_nrm[best]).sum() < 0,
                          -nrm_fit, nrm_fit)
    dpar = -(nrm_fit * c).sum()
    plane = torch.cat([nrm_fit, dpar[None]])

    # positive distance to camera center (PlaneExtractor.cpp:175-178)
    plane = torch.where(plane[3] < 0, -plane, plane)

    min_inliers = cfg.min_size / (cfg.stride * cfg.stride)
    ok = (best_count >= min_inliers) & torch.isfinite(plane).all()
    return plane, ok


def make_plane_estimator(cam: Camera,
                         cfg: GroundPlaneConfig = GroundPlaneConfig(),
                         device=None):
    """Adapter for system.Tracking's plane_estimator hook: a callable
    ``estimator(depth) -> plane [4] float64 numpy (camera frame) | None``
    that runs on ``device`` (the CUDA device unless the caller names one).

    ``dispatch`` / ``resolve`` split the call for the tracker's
    asynchronous one-shot plane, as the JAX package's estimator does:
    ``dispatch`` copies the depth image from pinned memory, queues the
    estimate and starts the copy of (plane, ok) home behind an event,
    without waiting for the device; ``resolve`` waits on that event only
    (a frame later the copy has usually landed).
    """
    from ..system.tracking import resolve_device
    dev = resolve_device(device)

    def _dispatch(depth):
        plane, ok = estimate_ground_plane(
            to_device(np.asarray(depth, np.int32), dev), cam, cfg)
        return HostCopy.start(torch.cat([plane, ok.to(plane.dtype)[None]]))

    def _resolve(handle):
        host = handle.wait().numpy().astype(np.float64)
        if not host[4] > 0.5:
            return None
        return host[:4]

    def estimator(depth):
        return _resolve(_dispatch(depth))

    estimator.dispatch = _dispatch
    estimator.resolve = _resolve
    estimator.device = dev
    return estimator
