"""Plane (pi^T X = 0) operations as PyTorch functions.

Port of ``object_oriented_slam_tpu/core/plane.py`` (the reference's
``g2o::plane``, ``src/core/Plane.cpp``, ``include/core/Plane.h``).

A plane is a ``[4]`` tensor ``[A, B, C, D]`` with ``AX+BY+CZ+D=0``:
construction, transform, distance, and the azimuth/elevation ``oplus``
updates used by the symmetry-plane optimizer.
"""
from __future__ import annotations

import torch

from ..ops import linalg
from . import se3

_EPS = 1e-8


def from_point_normal(point: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Plane.cpp:83-90."""
    d = -(point * normal).sum()
    return torch.cat([normal, d[None]])


def from_dis_angle(dis, angle):
    """Plane.cpp:92-105 (fromDisAngleTrans with trans handled separately):
    normal = (sin a, -cos a, 0), D = -dis."""
    return torch.stack([torch.sin(angle), -torch.cos(angle),
                        torch.zeros_like(angle), -dis])


def _norm3(n: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2])


def distance_to_point(pi: torch.Tensor, p: torch.Tensor,
                      keep_flag: bool = False) -> torch.Tensor:
    """Signed (keep_flag) or absolute point-plane distance (Plane.cpp:108-115).

    ``p`` is [..., 3].  The dot product is written out, so the sum has one
    order on the CPU and on the card (the supporting-plane test compares
    this value with a threshold).
    """
    num = p[..., 0] * pi[0] + p[..., 1] * pi[1] + p[..., 2] * pi[2] + pi[3]
    den = torch.clamp_min(_norm3(pi), _EPS)
    val = num / den
    return val if keep_flag else val.abs()


def transform(pi: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """pi' = (T^T)^-1 pi, T = pose7 mapping local points to global
    (Plane.cpp:117-122).  The 4x4 inverse is the closed-form cofactor one
    (``ops.linalg.inv4``); a rigid T is well conditioned, and the result
    agrees with a pivoted solve to ~1e-6 in float32."""
    R = se3.quat_to_mat(T[3:])
    M = torch.cat([torch.cat([R, T[:3, None]], dim=1),
                   torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=R.dtype,
                                device=R.device)], dim=0)
    return linalg.inv4(M.T) @ pi


def normalize(pi: torch.Tensor) -> torch.Tensor:
    """Scale so the normal has unit length (Plane.h:78-81)."""
    return pi / torch.clamp_min(_norm3(pi), _EPS)


def azimuth(pi: torch.Tensor) -> torch.Tensor:
    """atan2(B, A) (Plane.h:94-96)."""
    return torch.atan2(pi[1], pi[0])


def distance(pi: torch.Tensor) -> torch.Tensor:
    """-D (Plane.h:104-106)."""
    return -pi[3]


def _rotation_of_normal(n: torch.Tensor) -> torch.Tensor:
    """R = Rz(azimuth) * Ry(-elevation) (Plane.h:88-92)."""
    az = torch.atan2(n[1], n[0])
    el = torch.atan2(n[2], torch.sqrt(n[0] * n[0] + n[1] * n[1]))
    ca, sa = torch.cos(az), torch.sin(az)
    ce, se_ = torch.cos(-el), torch.sin(-el)
    o, l = torch.zeros_like(ca), torch.ones_like(ca)
    Rz = torch.stack([torch.stack([ca, -sa, o]), torch.stack([sa, ca, o]),
                      torch.stack([o, o, l])])
    Ry = torch.stack([torch.stack([ce, o, se_]), torch.stack([o, l, o]),
                      torch.stack([-se_, o, ce])])
    return Rz @ Ry


def oplus(pi: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """3-DoF update [azimuth, elevation, ddistance] (Plane.h:45-59).

    Builds a unit normal from (azimuth, elevation) in the frame of the current
    normal, rotates it back, and bumps the distance.
    """
    az, el = v[0], v[1]
    s, c = torch.sin(el), torch.cos(el)
    n = torch.stack([c * torch.cos(az), c * torch.sin(az), s])
    R = _rotation_of_normal(pi[:3])
    d = distance(pi) + v[2]
    out = torch.cat([R @ n, -d[None]])
    return normalize(out)


def oplus_2dof(pi: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """The VertexPlane update: [azimuth, distance] with elevation pinned to 0
    (SymmetrySolver.cpp:527-532)."""
    return oplus(pi, torch.stack([v2[0], torch.zeros_like(v2[0]), v2[1]]))


def oplus_dual(pi: torch.Tensor, dual_dis: torch.Tensor, v3: torch.Tensor):
    """VertexDualPlane update: [azimuth, ddistance, ddual_dis] with
    elevation 0 (Plane.h:61-76, SymmetrySolver.cpp:544-547).

    Returns (new_plane, new_dual_dis).
    """
    new_pi = oplus(pi, torch.stack([v3[0], torch.zeros_like(v3[0]), v3[1]]))
    return new_pi, dual_dis + v3[2]


def dual_other_plane(pi: torch.Tensor, dual_dis: torch.Tensor) -> torch.Tensor:
    """Second plane of a dual-reflection pair: same azimuth, distance=dual_dis
    (Plane.cpp:137-144 GenerateAnotherPlaneVec)."""
    return from_dis_angle(dual_dis, azimuth(pi))


def mirror_points(pi: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Reflect points [..., 3] across the plane
    (SymmetrySolver.cpp:193-214 GetSymmetryPointOfPlane).

    Equivalent closed form: p' = p - 2 (n.p + d) n / |n|^2.
    """
    n = pi[:3]
    n2 = torch.clamp_min((n * n).sum(), _EPS)
    s = (pts @ n + pi[3]) / n2
    return pts - 2.0 * s[..., None] * n
