"""Masked PCA and the reference's rotation post-processing.

Port of ``object_oriented_slam_tpu/ops/pca.py``: ``ProcessPCA``
(src/pca/EllipsoidExtractor.cpp:170-196: PCL normalized covariance +
eigendecomposition), ``AdjustChirality`` (:760-764),
``AlignZAxisToGravity`` (:207-267) and ``calibRotMatAccordingToGroundPlane``
(:766-788) over masked point sets.  Every function takes any leading batch
axes (the extractor passes one row per detection).  Plain PyTorch: the
3xN . Nx3 covariance product goes to ``torch.matmul``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import linalg

_EPS = 1e-9


class PCAResult(NamedTuple):
    center: torch.Tensor     # [..., 3]
    rot: torch.Tensor        # [..., 3, 3] columns = axes
    eigvals: torch.Tensor    # [..., 3] ascending (normalized covariance)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(-1))


def masked_pca(pts: torch.Tensor, mask: torch.Tensor) -> PCAResult:
    """Centroid + normalized-covariance eigendecomposition.
    pts [..., N, 3], mask [..., N]."""
    w = mask.to(pts.dtype)[..., None]
    n = w.sum((-2, -1)).clamp_min(1.0)[..., None]
    c = (pts * w).sum(-2) / n
    d = (pts - c[..., None, :]) * w
    cov = (d.transpose(-1, -2) @ d) / n[..., None]  # "normalized" like PCL
    vals, vecs = linalg.eigh3(cov)
    return PCAResult(center=c, rot=vecs, eigvals=vals)


def adjust_chirality(rot: torch.Tensor) -> torch.Tensor:
    """col2 = col0 x col1 (EllipsoidExtractor.cpp:760-764)."""
    return torch.stack([rot[..., 0], rot[..., 1],
                        linalg.cross(rot[..., 0], rot[..., 1])], dim=-1)


def _column(rot: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """rot[..., :, idx] with one index per batch element."""
    return torch.gather(rot, -1, idx[..., None, None].expand(
        *idx.shape, 3, 1))[..., 0]


def align_z_to_gravity(rot: torch.Tensor, eigvals: torch.Tensor,
                       z_axis: torch.Tensor):
    """Permute axes so the column most parallel to ``z_axis`` [3] becomes z
    (EllipsoidExtractor.cpp:207-267). Returns (rot', eigvals')."""
    z = z_axis / _norm(z_axis).clamp_min(_EPS)
    cos = (rot * z[:, None]).sum(-2)              # rot^T z, [..., 3]
    max_id = torch.argmax(cos.abs(), dim=-1)
    cmax = torch.gather(cos, -1, max_id[..., None])[..., 0]
    sign = torch.where(cmax > 0, 1.0, -1.0)

    z_col = sign[..., None] * _column(rot, max_id)
    x_id = (max_id + 1) % 3
    y_id = (max_id + 2) % 3
    x_col = _column(rot, x_id)
    y_col = linalg.cross(z_col, x_col)

    new_rot = torch.stack([x_col, y_col, z_col], dim=-1)
    ids = torch.stack([x_id, y_id, max_id], dim=-1)
    return new_rot, torch.gather(eigvals, -1, ids)


def calibrate_to_normal(rot: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Small rotation making column z exactly parallel to ``normal`` [3]
    (EllipsoidExtractor.cpp:766-788)."""
    z = rot[..., 2]
    axis = linalg.cross(z, normal.expand_as(z))
    axis_n = _norm(axis)
    axis = axis / axis_n.clamp_min(_EPS)[..., None]
    cos_t = ((normal * z).sum(-1)
             / (_norm(normal) * _norm(z)).clamp_min(_EPS)).clamp(-1.0, 1.0)
    theta = torch.acos(cos_t)[..., None, None]
    # Rodrigues
    o = torch.zeros_like(axis_n)
    Kx = torch.stack([
        torch.stack([o, -axis[..., 2], axis[..., 1]], -1),
        torch.stack([axis[..., 2], o, -axis[..., 0]], -1),
        torch.stack([-axis[..., 1], axis[..., 0], o], -1)], dim=-2)
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
    R = eye + torch.sin(theta) * Kx + (1 - torch.cos(theta)) * (Kx @ Kx)
    # degenerate (already aligned): identity
    R = torch.where((axis_n > _EPS)[..., None, None], R, eye)
    return R @ rot


def normalized_frame_stats(pts: torch.Tensor, mask: torch.Tensor):
    """RMS + max-extent per axis in the normalized object frame
    (ProcessPCANormalized, EllipsoidExtractor.cpp:495-531).

    Returns (rms [..., 3], max_extent [..., 3]); the reference uses
    max_extent as the ellipsoid scale.
    """
    w = mask.to(pts.dtype)[..., None]
    n = w.sum((-2, -1)).clamp_min(1.0)[..., None]
    rms = (pts * pts * w).sum(-2) / n
    mx = (pts.abs() * w).amax(-2)
    return rms, mx
