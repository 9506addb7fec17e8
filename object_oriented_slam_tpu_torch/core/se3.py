"""SE(3) / quaternion operations as PyTorch functions.

Port of ``object_oriented_slam_tpu/core/se3.py`` (the reference's
``g2o::SE3Quat``).  Every function takes tensors with arbitrary leading
batch dimensions, so one call covers a single pose or a whole batch.

Conventions (matching the JAX package and the reference exactly):
  * quaternion ``q`` is ``[..., 4]`` ``[qx, qy, qz, qw]`` (TUM file order).
  * a rigid transform ("pose7") is ``[..., 7]`` ``[tx,ty,tz,qx,qy,qz,qw]``.
  * ``se3_exp`` takes a ``[..., 6]`` tangent ``[omega(3), upsilon(3)]`` --
    rotation first, like ``SE3Quat::exp``.
  * euler conversions use the ZYX (roll-pitch-yaw) convention.

All math is float32; host-side IO keeps float64 and casts at the boundary.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] @ [..., 3], unrolled like the JAX package's ``_mv``."""
    return (M * v[..., None, :]).sum(-1)


# ---------------------------------------------------------------------------
# Quaternion primitives
# ---------------------------------------------------------------------------

def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp_min(torch.linalg.vector_norm(q, dim=-1,
                                                        keepdim=True), _EPS)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product; both quats are [x, y, z, w]."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector v by unit quaternion q (R(q) @ v)."""
    qv = q[..., :3]
    w = q[..., 3:]
    t = 2.0 * _cross(qv, v)
    return v + w * t + _cross(qv, t)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> [..., 3, 3] rotation matrix."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
    ], dim=-2)


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation matrix -> unit quaternion [x,y,z,w] (branchless
    Shepperd): all four branch candidates are computed and the one with the
    largest pivot is selected."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tr = m00 + m11 + m22
    q0 = torch.stack([m21 - m12, m02 - m20, m10 - m01, 1.0 + tr], -1)
    q1 = torch.stack([1.0 + m00 - m11 - m22, m01 + m10, m02 + m20,
                      m21 - m12], -1)
    q2 = torch.stack([m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21,
                      m02 - m20], -1)
    q3 = torch.stack([m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22,
                      m10 - m01], -1)
    cands = torch.stack([q0, q1, q2, q3], -2)            # [..., 4, 4]
    pivots = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                          1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)
    idx = torch.argmax(pivots, dim=-1)
    q = torch.gather(cands, -2,
                     idx[..., None, None].expand(*idx.shape, 1, 4))[..., 0, :]
    q = quat_normalize(q)
    # canonical sign: w >= 0
    return torch.where(q[..., 3:] < 0, -q, q)


def skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([
        torch.stack([o, -z, y], -1),
        torch.stack([z, o, -x], -1),
        torch.stack([-y, x, o], -1),
    ], dim=-2)


# ---------------------------------------------------------------------------
# SO(3) exp / log
# ---------------------------------------------------------------------------

def so3_exp_quat(omega: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> quaternion [x,y,z,w], small-angle safe."""
    theta2 = (omega * omega).sum(-1, keepdim=True)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    half = 0.5 * theta
    k = torch.where(theta2 > 1e-10, torch.sin(half) / theta,
                    0.5 - theta2 / 48.0)
    return torch.cat([omega * k, torch.cos(half)], dim=-1)


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """Quaternion [x,y,z,w] -> axis-angle [..., 3]."""
    w = q[..., 3:]
    sgn = torch.where(w < 0, -1.0, 1.0)
    qv = q[..., :3] * sgn
    w = w * sgn
    n = torch.linalg.vector_norm(qv, dim=-1, keepdim=True)
    theta = 2.0 * torch.atan2(n, w)
    k = torch.where(n > 1e-7, theta / torch.clamp_min(n, _EPS),
                    2.0 / torch.clamp_min(w, _EPS))
    return qv * k


# ---------------------------------------------------------------------------
# SE(3) on pose7 = [t(3), q(4)]
# ---------------------------------------------------------------------------

def se3_identity(device=None) -> torch.Tensor:
    return torch.tensor([0, 0, 0, 0, 0, 0, 1], dtype=torch.float32,
                        device=device)


def se3_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose: (a*b) x = a(b(x))."""
    t = a[..., :3] + quat_rotate(a[..., 3:], b[..., :3])
    q = quat_normalize(quat_mul(a[..., 3:], b[..., 3:]))
    return torch.cat([t, q], dim=-1)


def se3_inv(a: torch.Tensor) -> torch.Tensor:
    qi = quat_conj(a[..., 3:])
    return torch.cat([-quat_rotate(qi, a[..., :3]), qi], dim=-1)


def _so3_left_jacobian(omega: torch.Tensor) -> torch.Tensor:
    """V matrix of SE(3) exp: t = V @ upsilon (se3quat.h:249-287)."""
    theta2 = (omega * omega).sum(-1)[..., None, None]
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    Om = skew(omega)
    Om2 = Om @ Om
    a = torch.where(theta2 > 1e-10,
                    (1.0 - torch.cos(theta)) / torch.clamp_min(theta2, _EPS),
                    0.5 - theta2 / 24.0)
    b = torch.where(theta2 > 1e-10,
                    (theta - torch.sin(theta))
                    / torch.clamp_min(theta2 * theta, _EPS),
                    1.0 / 6.0 - theta2 / 120.0)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    return eye + a * Om + b * Om2


def se3_exp(u: torch.Tensor) -> torch.Tensor:
    """Tangent [..., 6] [omega, upsilon] -> pose7, matching SE3Quat::exp."""
    omega = u[..., :3]
    q = so3_exp_quat(omega)
    V = _so3_left_jacobian(omega)
    return torch.cat([_mv(V, u[..., 3:6]), q], dim=-1)


def _so3_left_jacobian_inv(omega: torch.Tensor) -> torch.Tensor:
    """Closed-form V^-1 = I - 1/2 [w]x + c [w]x^2 with
    c = (1 - (theta/2) cot(theta/2)) / theta^2."""
    theta2 = (omega * omega).sum(-1)[..., None, None]
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    Om = skew(omega)
    Om2 = Om @ Om
    half = 0.5 * theta
    cot_term = half * torch.cos(half) / torch.clamp_min(torch.sin(half), _EPS)
    c = torch.where(theta2 > 1e-10,
                    (1.0 - cot_term) / torch.clamp_min(theta2, _EPS),
                    1.0 / 12.0 + theta2 / 720.0)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    return eye - 0.5 * Om + c * Om2


def se3_log(a: torch.Tensor) -> torch.Tensor:
    """pose7 -> tangent [..., 6] [omega, upsilon], inverse of se3_exp."""
    omega = so3_log(a[..., 3:])
    upsilon = _mv(_so3_left_jacobian_inv(omega), a[..., :3])
    return torch.cat([omega, upsilon], dim=-1)


# ---------------------------------------------------------------------------
# Euler conversions (ZYX), matching src/utils/matrix_utils.cpp:41-118
# ---------------------------------------------------------------------------

def zyx_euler_to_quat(roll, pitch, yaw) -> torch.Tensor:
    """matrix_utils.cpp:41-54; returns [x,y,z,w]."""
    sy, cy = torch.sin(yaw * 0.5), torch.cos(yaw * 0.5)
    sp, cp = torch.sin(pitch * 0.5), torch.cos(pitch * 0.5)
    sr, cr = torch.sin(roll * 0.5), torch.cos(roll * 0.5)
    return torch.stack([
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
        cr * cp * cy + sr * sp * sy,
    ], dim=-1)


def quat_to_euler_zyx(q: torch.Tensor) -> torch.Tensor:
    """matrix_utils.cpp:60-70; returns [roll, pitch, yaw]."""
    qx, qy, qz, qw = q.unbind(-1)
    roll = torch.atan2(2 * (qw * qx + qy * qz), 1 - 2 * (qx * qx + qy * qy))
    pitch = torch.asin(torch.clamp(2 * (qw * qy - qz * qx), -1.0, 1.0))
    yaw = torch.atan2(2 * (qw * qz + qx * qy), 1 - 2 * (qy * qy + qz * qz))
    return torch.stack([roll, pitch, yaw], dim=-1)


def rot_to_euler_zyx(R: torch.Tensor) -> torch.Tensor:
    """matrix_utils.cpp:76-95 (non-degenerate branch; degeneracy clamped)."""
    pitch = torch.asin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([roll, pitch, yaw], dim=-1)


def euler_zyx_to_rot(roll, pitch, yaw) -> torch.Tensor:
    """matrix_utils.cpp:102-116; returns [..., 3, 3]."""
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    sr, cr = torch.sin(roll), torch.cos(roll)
    sy, cy = torch.sin(yaw), torch.cos(yaw)
    return torch.stack([
        torch.stack([cp * cy, sr * sp * cy - cr * sy, cr * sp * cy + sr * sy],
                    -1),
        torch.stack([cp * sy, sr * sp * sy + cr * cy, cr * sp * sy - sr * cy],
                    -1),
        torch.stack([-sp, sr * cp, cr * cp], -1),
    ], dim=-2)


def pose7_to_xyzrpy(a: torch.Tensor) -> torch.Tensor:
    """pose7 -> [x,y,z,roll,pitch,yaw] (se3quat.h toXYZPRYVector)."""
    return torch.cat([a[..., :3], quat_to_euler_zyx(a[..., 3:])], dim=-1)


def xyzrpy_to_pose7(v: torch.Tensor) -> torch.Tensor:
    return torch.cat([v[..., :3], zyx_euler_to_quat(v[..., 3], v[..., 4],
                                                     v[..., 5])], dim=-1)


def se3_apply(a: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply transform(s) a [..., 7] to point(s) p [..., 3].  One pose and
    a batch of points go through the rotation matrix (as in the JAX
    package); otherwise the quaternion rotates each point."""
    if a.dim() == 1 and p.dim() > 1:
        return p @ quat_to_mat(a[3:]).T + a[:3]
    return quat_rotate(a[..., 3:], p) + a[..., :3]


def se3_to_mat(a: torch.Tensor) -> torch.Tensor:
    """pose7 -> [..., 4, 4] homogeneous matrix (se3quat.h
    to_homogeneous_matrix)."""
    R = quat_to_mat(a[..., 3:])
    top = torch.cat([R, a[..., :3, None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def mat_to_se3(m: torch.Tensor) -> torch.Tensor:
    return torch.cat([m[..., :3, 3], mat_to_quat(m[..., :3, :3])], dim=-1)
