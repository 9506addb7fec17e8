"""Ellipsoid (dual quadric) operations as PyTorch functions.

Port of ``object_oriented_slam_tpu/core/ellipsoid.py`` (the reference's
``g2o::ellipsoid``, ``src/core/Ellipsoid.cpp``).  An ellipsoid is a
``[..., 10]`` float32 tensor ``[tx, ty, tz, qx, qy, qz, qw, sa, sb, sc]``
("vec10"); a minimal 9-vector is ``[x, y, z, roll, pitch, yaw, sa, sb, sc]``.
Every function broadcasts over leading batch dimensions.
"""
from __future__ import annotations

import math

import torch

from . import se3
from ..ops.linalg import inv3


# ---------------------------------------------------------------------------
# Parameterisation conversions
# ---------------------------------------------------------------------------

def from_minimal(v9: torch.Tensor) -> torch.Tensor:
    """minimal vec9 (xyz-rpy-abc) -> vec10 (Ellipsoid.cpp:16-22)."""
    q = se3.zyx_euler_to_quat(v9[..., 3], v9[..., 4], v9[..., 5])
    return torch.cat([v9[..., :3], q, v9[..., 6:9]], dim=-1)


def to_minimal(e: torch.Tensor) -> torch.Tensor:
    """vec10 -> minimal vec9 (Ellipsoid.cpp:144-149)."""
    rpy = se3.quat_to_euler_zyx(e[..., 3:7])
    return torch.cat([e[..., :3], rpy, e[..., 7:10]], dim=-1)


def pose_of(e: torch.Tensor) -> torch.Tensor:
    return e[..., :7]


def scale_of(e: torch.Tensor) -> torch.Tensor:
    return e[..., 7:10]


def make(pose7: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    lead = torch.broadcast_shapes(pose7.shape[:-1], scale.shape[:-1])
    return torch.cat([pose7.expand(lead + (7,)), scale.expand(lead + (3,))],
                     dim=-1)


# ---------------------------------------------------------------------------
# Updates and frame transforms
# ---------------------------------------------------------------------------

def exp_update(e: torch.Tensor, u9: torch.Tensor) -> torch.Tensor:
    """SE3 right-multiplicative update + additive scale (Ellipsoid.cpp:38-47).

    ``u9 = [omega(3), upsilon(3), dscale(3)]`` -- rotation first.
    """
    new_pose = se3.se3_mul(e[..., :7], se3.se3_exp(u9[..., :6]))
    return make(new_pose, e[..., 7:10] + u9[..., 6:9])


def exp_update_xyzabc(e: torch.Tensor, u6: torch.Tensor) -> torch.Tensor:
    """6-DoF update variant: translation-only SE3 exp + additive scale
    (VertexEllipsoidXYZABC, Ellipsoid.cpp:50-61)."""
    u9 = torch.cat([torch.zeros_like(u6[..., :3]), u6[..., :3], u6[..., 3:6]],
                   dim=-1)
    return exp_update(e, u9)


def log_error_9dof(e: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """9-DoF log error between two ellipsoids (Ellipsoid.cpp:63-71):
    ``log(other.pose^-1 * e.pose)``, then ``e.scale - other.scale``."""
    pose_diff = se3.se3_mul(se3.se3_inv(pose_of(other)), pose_of(e))
    return torch.cat([se3.se3_log(pose_diff), scale_of(e) - scale_of(other)],
                     dim=-1)


def rotate_yaw(e: torch.Tensor, k: int) -> torch.Tensor:
    """Rotate the body frame about its z axis by k*90deg (Ellipsoid.cpp:
    75-90); for odd k the x/y half-axes swap, so the shape is the same."""
    yaw = k * math.pi / 2.0
    z = e[..., :1] * 0.0
    rot = torch.cat([z, z, z, z, z, z + math.sin(yaw * 0.5),
                     z + math.cos(yaw * 0.5)], dim=-1)
    new_pose = se3.se3_mul(pose_of(e), rot)
    s = scale_of(e)
    if k % 2 != 0:
        s = s[..., [1, 0, 2]]
    return make(new_pose, s)


def min_log_error_9dof(e: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """Rotation-ambiguity-aware 9-DoF error (Ellipsoid.cpp:92-117): the
    error to ``other`` rotated by {-90, 0, 90, 180} deg of yaw with the
    least norm (the first on a tie); the branch index carries no tangent,
    so a Jacobian differentiates the chosen branch alone."""
    errs = torch.stack([log_error_9dof(e, rotate_yaw(other, k))
                        for k in (-1, 0, 1, 2)], dim=-2)
    idx = torch.argmin(torch.linalg.vector_norm(errs, dim=-1), dim=-1)
    return torch.gather(errs, -2, idx[..., None, None].expand(
        *idx.shape, 1, 9).detach())[..., 0, :]


def transform_from(e: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Local -> global given T (e.g. Twc) (Ellipsoid.cpp:120-129)."""
    return make(se3.se3_mul(T, e[..., :7]), e[..., 7:10])


def transform_to(e: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Global -> local given T=Twc (Ellipsoid.cpp:132-141)."""
    return make(se3.se3_mul(se3.se3_inv(T), e[..., :7]), e[..., 7:10])


# ---------------------------------------------------------------------------
# Quadric / projection
# ---------------------------------------------------------------------------

def quadric_Qstar(e: torch.Tensor) -> torch.Tensor:
    """Dual quadric Q* = T diag(a^2,b^2,c^2,-1) T^T [..., 4, 4]
    (Ellipsoid.cpp:290-300)."""
    s = scale_of(e)
    d = torch.cat([s * s, -torch.ones_like(s[..., :1])], dim=-1)
    T = se3.se3_to_mat(pose_of(e))
    return (T * d[..., None, :]) @ T.transpose(-1, -2)


def projection_matrix(pose_cw: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """P = K [I|0] Tcw, [..., 3, 4] (Ellipsoid.cpp:276-287)."""
    return K @ se3.se3_to_mat(pose_cw)[..., :3, :]


def _homogeneous(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def project_center(e: torch.Tensor, pose_cw: torch.Tensor,
                   K: torch.Tensor) -> torch.Tensor:
    """Image point [..., 2] of the ellipsoid center (Ellipsoid.cpp:195-205)."""
    u = se3._mv(projection_matrix(pose_cw, K), _homogeneous(e[..., :3]))
    return u[..., :2] / u[..., 2:3]


def _conic_cstar(e: torch.Tensor, pose_cw: torch.Tensor,
                 K: torch.Tensor) -> torch.Tensor:
    """Dual conic C* = P Q* P^T in closed form: (W S)(W S)^T - v v^T with
    W = K R_cw R and v = K (R_cw t + t_cw)."""
    R = se3.quat_to_mat(e[..., 3:7])
    R_cw = se3.quat_to_mat(pose_cw[..., 3:])
    A = K @ R_cw
    WS = (A @ R) * e[..., None, 7:10]
    v = se3._mv(A, e[..., :3]) + se3._mv(K, pose_cw[..., :3])
    return WS @ WS.transpose(-1, -2) - v[..., :, None] * v[..., None, :]


def project_ellipse(e: torch.Tensor, pose_cw: torch.Tensor,
                    K: torch.Tensor) -> torch.Tensor:
    """Project to an image ellipse [..., 5] = [x_c, y_c, theta, axis1, axis2].

    Conic C = (P Q* P^T)^-1 normalized by C(2,2), then the closed-form
    conic -> ellipse parameter extraction of Ellipsoid.cpp:209-249.
    """
    C = inv3(_conic_cstar(e, pose_cw, K))
    C = C / C[..., 2:3, 2:3]

    a = C[..., 0, 0]
    b = C[..., 0, 1] * 2.0
    c = C[..., 1, 1]
    d = C[..., 0, 2] * 2.0
    ecoef = C[..., 2, 1] * 2.0

    theta = 0.5 * torch.atan2(b, a - c)
    den = 4.0 * a * c - b * b
    x_c = (b * ecoef - 2.0 * c * d) / den
    y_c = (b * d - 2.0 * a * ecoef) / den

    quad = a * x_c * x_c + c * y_c * y_c + b * x_c * y_c - 1.0
    root = torch.sqrt((a - c) * (a - c) + b * b)
    a2 = 2.0 * quad / (a + c + root)
    b2 = 2.0 * quad / (a + c - root)
    axis1 = torch.sqrt(torch.clamp_min(a2, 0.0))
    axis2 = torch.sqrt(torch.clamp_min(b2, 0.0))
    return torch.stack([x_c, y_c, theta, axis1, axis2], dim=-1)


def ellipse_to_bbox(ellipse: torch.Tensor) -> torch.Tensor:
    """Axis-aligned bbox [x1,y1,x2,y2] of an ellipse (Ellipsoid.cpp:252-273)."""
    x, y, theta, a, b = ellipse.unbind(-1)
    c2 = torch.cos(theta) ** 2
    s2 = 1.0 - c2
    x_limit = torch.sqrt(a * a * c2 + b * b * s2)
    y_limit = torch.sqrt(a * a * s2 + b * b * c2)
    return torch.stack([x - x_limit, y - y_limit, x + x_limit, y + y_limit],
                       dim=-1)


def project_bbox(e: torch.Tensor, pose_cw: torch.Tensor,
                 K: torch.Tensor) -> torch.Tensor:
    """Projected bounding box via the conic (Ellipsoid.cpp:303-307)."""
    return ellipse_to_bbox(project_ellipse(e, pose_cw, K))


def project_bbox_dual(e: torch.Tensor, pose_cw: torch.Tensor,
                      K: torch.Tensor) -> torch.Tensor:
    """Projected bbox straight from the dual conic: the tangent vertical /
    horizontal lines l with l^T C* l = 0 give the extrema
    x = (C*02 +- sqrt(C*02^2 - C*00 C*22)) / C*22 (likewise y); the same
    bbox as ``project_bbox`` for a valid ellipse, without the angle."""
    C = _conic_cstar(e, pose_cw, K)
    c00, c11, c22 = C[..., 0, 0], C[..., 1, 1], C[..., 2, 2]
    c02, c12 = C[..., 0, 2], C[..., 1, 2]
    dx = torch.sqrt(torch.clamp_min(c02 * c02 - c00 * c22, 0.0))
    dy = torch.sqrt(torch.clamp_min(c12 * c12 - c11 * c22, 0.0))
    xa, xb = (c02 - dx) / c22, (c02 + dx) / c22
    ya, yb = (c12 - dy) / c22, (c12 + dy) / c22
    return torch.stack([torch.minimum(xa, xb), torch.minimum(ya, yb),
                        torch.maximum(xa, xb), torch.maximum(ya, yb)], dim=-1)


# the circumscribed cube's corners in the body frame (Ellipsoid.cpp:475-477)
_CUBE_CORNERS = ((1, 1, -1, -1, 1, 1, -1, -1),
                 (1, -1, -1, 1, 1, -1, -1, 1),
                 (-1, -1, -1, -1, 1, 1, 1, 1))


def cube_corners(e: torch.Tensor) -> torch.Tensor:
    """World coords [..., 3, 8] of the circumscribed cube's 8 corners
    (Ellipsoid.cpp:472-480)."""
    R = se3.quat_to_mat(e[..., 3:7])
    corners = torch.tensor(_CUBE_CORNERS, dtype=e.dtype, device=e.device)
    return (R * scale_of(e)[..., None, :]) @ corners + e[..., :3, None]


def project_cube_bbox(e: torch.Tensor, pose_cw: torch.Tensor,
                      K: torch.Tensor) -> torch.Tensor:
    """Bbox [..., 4] = [x1,y1,x2,y2] of the projected cube corners
    (Ellipsoid.cpp:482-497)."""
    corners = cube_corners(e)                                   # [..., 3, 8]
    homo = torch.cat([corners, torch.ones_like(corners[..., :1, :])], dim=-2)
    uv = projection_matrix(pose_cw, K) @ homo
    uv = uv[..., :2, :] / uv[..., 2:3, :]
    return torch.cat([uv.amin(dim=-1), uv.amax(dim=-1)], dim=-1)


def project_cube_bbox_cwh(e: torch.Tensor, pose_cw: torch.Tensor,
                          K: torch.Tensor) -> torch.Tensor:
    """Projected cube bbox as [center_x, center_y, width, height]
    (projectOntoImageBbox, Ellipsoid.cpp:500-506)."""
    r = project_cube_bbox(e, pose_cw, K)
    return torch.cat([(r[..., 2:] + r[..., :2]) / 2.0,
                      r[..., 2:] - r[..., :2]], dim=-1)


def is_observable(e: torch.Tensor, pose_cw: torch.Tensor) -> torch.Tensor:
    """Center-in-front-of-camera check (Ellipsoid.cpp:328-343)."""
    return se3.se3_apply(pose_cw, e[..., :3])[..., 2] >= 0
