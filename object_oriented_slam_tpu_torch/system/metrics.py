"""Evaluation metrics and timing instrumentation.

Port of ``object_oriented_slam_tpu/system/metrics.py``.  The reference has
only commented-out clock() deltas (SURVEY.md section 5); timing is a
per-stage record (system.Tracking.metrics) and this module adds the
accuracy metrics the papers report:

  * ATE-RMSE between estimated and ground-truth trajectories, with optional
    SE3 (or Sim3-style) Umeyama alignment
  * 3D object IoU between maps (via ops.polygon.ellipsoid_iou_3d)

numpy on the host; the IoU runs the port's plain PyTorch polygon clip on
the CPU.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops.polygon import ellipsoid_iou_3d


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = False):
    """Least-squares rigid alignment src->dst. Returns (s, R, t)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = (np.trace(np.diag(D) @ S) / np.mean(np.sum(xs * xs, 1))
         if with_scale else 1.0)
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_xyz: np.ndarray, gt_xyz: np.ndarray,
             align: bool = True) -> float:
    """Absolute trajectory error RMSE over paired positions."""
    est, gt = np.asarray(est_xyz, float), np.asarray(gt_xyz, float)
    if est.shape != gt.shape:
        raise ValueError(f"trajectories of shapes {est.shape} and "
                         f"{gt.shape} do not pair")
    if align and len(est) >= 3:
        s, R, t = umeyama_alignment(est, gt)
        est = (s * (R @ est.T)).T + t
    d = est - gt
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))


def object_map_iou(map_a: Dict[int, np.ndarray],
                   map_b: Dict[int, np.ndarray]) -> Dict[int, float]:
    """Per-instance 3D IoU between two object maps (shared instance ids)."""
    out = {}
    for inst in sorted(set(map_a) & set(map_b)):
        out[inst] = float(ellipsoid_iou_3d(
            torch.from_numpy(np.asarray(map_a[inst], np.float32)),
            torch.from_numpy(np.asarray(map_b[inst], np.float32))))
    return out


def timing_summary(metrics: Dict[str, list]) -> Dict[str, float]:
    """Mean/median per-stage times in ms (skip the first compile frame)."""
    out = {}
    for k, v in metrics.items():
        arr = np.asarray(v[1:] if len(v) > 1 else v) * 1e3
        if len(arr):
            out[f"{k}_mean_ms"] = float(arr.mean())
            out[f"{k}_p50_ms"] = float(np.median(arr))
    return out
