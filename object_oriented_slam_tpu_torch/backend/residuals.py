"""Factor residuals of the object-SLAM graph (port of
``object_oriented_slam_tpu/backend/residuals.py``).

The reference's g2o edges (``src/core/BasicEllipsoidEdges.cpp``):

  * 2D projection edge ``EdgeSE3EllipsoidProj`` (:102-112): projected
    conic bbox minus measured bbox, per coordinate; coordinates whose
    measurement is < 5 (border-invalidated to -1) contribute zero.
  * 3D edge ``EdgeSE3Ellipsoid9DOF`` (:68-77): 9-DoF rotation-aware log
    error between the map ellipsoid and the measured camera-local
    ellipsoid transformed to world.
  * gravity prior ``EdgeEllipsoidGravityPlanePrior`` (:129-152): angle
    between the ellipsoid z-axis and the ground-plane normal.
  * odometry edge ``EdgeSE3Expmap`` (g2o types_six_dof_expmap.h).

Every residual is a plain differentiable function of the vertex estimates
with leading batch dimensions; Jacobians come from ``torch.func.jacfwd``
(``backend/slam_ba.py``).  Information matrices are per-residual
sqrt-weights applied by the caller.
"""
from __future__ import annotations

import torch

from ..core import ellipsoid as ell
from ..core import se3


def residual_proj(e_vec10: torch.Tensor, pose_cw: torch.Tensor,
                  K: torch.Tensor, meas_bbox: torch.Tensor) -> torch.Tensor:
    """2D projection residual [..., 4] (BasicEllipsoidEdges.cpp:102-112).

    Coordinates with measurement < 5 are invalid and contribute 0.
    """
    proj = ell.project_bbox(e_vec10, pose_cw, K)
    return torch.where(meas_bbox >= 5.0, proj - meas_bbox,
                       torch.zeros_like(proj))


def residual_3d(e_vec10: torch.Tensor, pose_wc: torch.Tensor,
                meas_local_vec10: torch.Tensor) -> torch.Tensor:
    """3D ellipsoid residual [..., 9] (BasicEllipsoidEdges.cpp:68-77)."""
    meas_world = ell.transform_from(meas_local_vec10, pose_wc)
    return ell.min_log_error_9dof(e_vec10, meas_world)


def precompute_3d_measurement(pose_wc: torch.Tensor,
                              meas_local_vec10: torch.Tensor):
    """The estimate-independent part of the 3D residual: the measured
    local ellipsoid in the world, its four yaw rotations and their
    inverted poses.  Returns (inv_pose4 [..., 4, 7], scale4 [..., 4, 3])."""
    meas_world = ell.transform_from(meas_local_vec10, pose_wc)
    rots = [ell.rotate_yaw(meas_world, k) for k in (-1, 0, 1, 2)]
    inv_pose4 = torch.stack([se3.se3_inv(r[..., :7]) for r in rots], dim=-2)
    scale4 = torch.stack([r[..., 7:10] for r in rots], dim=-2)
    return inv_pose4, scale4


def residual_3d_pre(e_vec10: torch.Tensor, inv_pose4: torch.Tensor,
                    scale4: torch.Tensor) -> torch.Tensor:
    """residual_3d with precomputed measurement rotations (see
    precompute_3d_measurement); the candidate is picked by the squared
    norm, as in the JAX package."""
    pose_diff = se3.se3_mul(inv_pose4, e_vec10[..., None, :7])
    errs = torch.cat([se3.se3_log(pose_diff),
                      e_vec10[..., None, 7:10] - scale4], dim=-1)
    idx = torch.argmin((errs * errs).sum(-1), dim=-1)
    return torch.gather(errs, -2, idx[..., None, None].expand(
        *idx.shape, 1, 9).detach())[..., 0, :]


def residual_gravity(e_vec10: torch.Tensor,
                     normal: torch.Tensor) -> torch.Tensor:
    """Gravity-prior residual [..., 1] (BasicEllipsoidEdges.cpp:129-152)."""
    z_axis = se3.quat_to_mat(e_vec10[..., 3:7])[..., :, 2]
    cos_angle = (z_axis * normal).sum(-1) / (
        torch.linalg.vector_norm(z_axis, dim=-1)
        * torch.clamp_min(torch.linalg.vector_norm(normal, dim=-1), 1e-8))
    cos_angle = torch.clamp(cos_angle, -1.0 + 1e-4, 1.0 - 1e-4)
    return torch.arccos(cos_angle)[..., None]


def residual_odometry(pose_i_cw: torch.Tensor, pose_j_cw: torch.Tensor,
                      meas_ij: torch.Tensor) -> torch.Tensor:
    """Odometry residual [..., 6] between consecutive camera vertices,
    ``log(meas^-1 * Tcw_j * Tcw_i^-1)`` with ``meas_ij = Tcw_j * Twc_i``
    (Optimizer.cpp:142-158): a consistent (pose_i, pose_j) pair gives
    zero.  SLAM mode's odometry edge is ``slam_ba._odo_residual``, another
    formula."""
    delta = se3.se3_mul(se3.se3_mul(se3.se3_inv(meas_ij), pose_j_cw),
                        se3.se3_inv(pose_i_cw))
    return se3.se3_log(delta)
