"""Point-cloud filters.

Port of ``object_oriented_slam_tpu/ops/filters.py``, which replaces the
remaining PCL helpers of ``src/symmetry/PointCloudFilter.cpp``:
  * statistical outlier removal (:263-276): drop points whose mean k-NN
    distance exceeds mean + stddev_mul * std of the population
  * keep-points-inside-quadric ``FiltPointsInBox`` (:278-300)
and the range-image border extraction of ``src/symmetry/BorderExtractor.cpp``
(:58-132), which becomes a depth-discontinuity test on the organized image.

Plain PyTorch on any device.  The extractor's sparse symmetry does not call
``depth_border_mask`` on a CUDA device: the ``depth_cloud`` kernel tests the
strided pixels of the boxes itself (``ops/depth_cloud.depth_cloud_border``),
and ``depth_cloud_border_plain`` is built on this function.
"""
from __future__ import annotations

import torch

from ..core import se3
from .backproject import scalar

BORDER_JUMP = 0.1       # metres: BorderExtractor's discontinuity


def statistical_outlier_mask(pts: torch.Tensor, mask: torch.Tensor,
                             k: int = 20, stddev_mul: float = 1.0):
    """Inlier mask [N] via mean-of-kNN-distance thresholding (masked,
    O(N^2)): the distance matrix replaces PCL's KdTree, the top k are a
    sort of each row."""
    nrm = (pts * pts).sum(1)
    d2 = nrm[:, None] + nrm[None, :] - 2.0 * pts @ pts.T
    d2 = torch.where(mask[None, :], d2, torch.inf)
    eye = torch.eye(pts.shape[0], dtype=torch.bool, device=pts.device)
    d2 = torch.where(eye, torch.inf, d2)
    d2_sorted = torch.sort(d2, dim=1).values[:, :k]
    finite = torch.isfinite(d2_sorted)
    n_fin = finite.sum(1)
    dmean = torch.where(finite, torch.sqrt(d2_sorted.clamp_min(0.0)),
                        0.0).sum(1) / n_fin.clamp_min(1)
    valid = mask & (n_fin > 0)

    n = valid.sum().to(pts.dtype).clamp_min(1.0)
    mu = torch.where(valid, dmean, 0.0).sum() / n
    var = torch.where(valid, (dmean - mu) ** 2, 0.0).sum() / n
    thresh = mu + stddev_mul * torch.sqrt(var)
    return valid & (dmean <= thresh)


def points_inside_quadric_mask(pts: torch.Tensor, mask: torch.Tensor,
                               e_vec10: torch.Tensor):
    """FiltPointsInBox: keep points X with X^T Q X <= 0 (inside the
    ellipsoid ``e_vec10`` [10]), PointCloudFilter.cpp:278-300."""
    Tow = se3.se3_inv(e_vec10[:7])
    R = se3.quat_to_mat(Tow[3:])
    local = pts @ R.T + Tow[:3]
    v = local / e_vec10[7:10].clamp_min(1e-9)
    return mask & ((v * v).sum(1) <= 1.0)


def depth_border_mask(depth: torch.Tensor, scale: float,
                      jump: float = BORDER_JUMP):
    """Range-image border pixels [H, W]: a depth discontinuity above
    ``jump`` metres against any 4-neighbour, or a neighbour without depth
    (BorderExtractor analogue).  The neighbours are taken with
    ``torch.roll``, which wraps: the first column is the last one's
    neighbour and the first row the last one's, as ``jnp.roll`` has it.
    ``depth`` [..., H, W]: a batch of frames [B, H, W] wraps each frame in
    itself (JAX's batch extractor maps each frame before it stacks them),
    never into the next frame of the stack."""
    z = depth.to(torch.float32) / scalar(scale, depth)
    valid = z > 1e-6
    border = torch.zeros_like(valid)
    for shift, dim in ((1, -2), (-1, -2), (1, -1), (-1, -1)):
        zn = torch.roll(z, shift, dim)
        vn = torch.roll(valid, shift, dim)
        border = border | (valid & vn & ((z - zn).abs() > jump))
        border = border | (valid & ~vn)
    return border
