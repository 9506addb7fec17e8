"""Multi-view SVD quadric initialization (port of ``init/svd_init.py``).

The reference's ``src/core/Initializer.cpp``: from >=3 (bbox, camera pose)
pairs, each bbox edge becomes an image line, back-projected to a tangent
plane pi = P^T l (Initializer.cpp:58-91); each plane yields one linear
constraint on the 10-vec dual quadric (Initializer.cpp:147-164); the
least-squares quadric is the last right singular vector of the stacked
constraints (Initializer.cpp:166-184); Q* is decomposed into an ellipsoid
(Initializer.cpp:186-248).

As in the JAX package: fixed-capacity masked arrays (invalid bbox edges
become zeroed constraint rows), unit-normalized planes and constraint rows
for float32 conditioning, and the exact central-quadric axis reduction
from the 3x3 block (``ellipsoid_from_qstar``).  Every function takes
leading batch dimensions (the JAX package's ``vmap`` over candidates).
The SVD is ``torch.linalg.svd`` and the 3x3 eigen-decomposition the
closed-form ``ops/linalg.eigh3``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import ellipsoid as ell
from ..core import se3
from ..ops import linalg

_EPS = 1e-12


class InitResult(NamedTuple):
    ellipsoid: torch.Tensor  # [..., 10] vec10
    ok: torch.Tensor         # [...] bool
    n_planes: torch.Tensor   # [...] int


def tangent_planes(pose_wc: torch.Tensor, bbox: torch.Tensor,
                   K: torch.Tensor, rows: int, cols: int):
    """Planes from (pose, bbox) pairs: pose_wc [..., 7], bbox [..., 4].

    Returns (planes [..., 4, 4], valid [..., 4]): the four bbox-edge
    tangent planes in the world frame, normals unit-normalized, and their
    validity (edge not on the image boundary, Initializer.cpp:107-145;
    the whole detection invalid when all coords < 1, Initializer.cpp:71).
    """
    x1, y1, x2, y2 = bbox.unbind(-1)
    one, zero = torch.ones_like(x1), torch.zeros_like(x1)
    lines = torch.stack([
        torch.stack([one, zero, -x1], dim=-1),
        torch.stack([zero, one, -y1], dim=-1),
        torch.stack([one, zero, -x2], dim=-1),
        torch.stack([zero, one, -y2], dim=-1)], dim=-2)   # [..., 4, 3]

    all_invalid = (x1 < 1) & (y1 < 1) & (x2 < 1) & (y2 < 1)
    valid = torch.stack([
        (x1 > 0) & (x1 < cols - 1),
        (y1 > 0) & (y1 < rows - 1),
        (x2 > 0) & (x2 < cols - 1),
        (y2 > 0) & (y2 < rows - 1),
    ], dim=-1) & ~all_invalid[..., None]

    P = K @ se3.se3_to_mat(se3.se3_inv(pose_wc))[..., :3, :]   # [..., 3, 4]
    planes = lines @ P                                         # [..., 4, 4]
    # a tangent plane's scale does not change its constraint; without the
    # normalization the d^2 entry dwarfs the normal entries in float32
    nrm = torch.linalg.vector_norm(planes[..., :3], dim=-1, keepdim=True)
    return planes / torch.clamp_min(nrm, _EPS), valid


def plane_to_constraint(pi: torch.Tensor) -> torch.Tensor:
    """10-vec quadratic constraint [..., 10] of tangent planes [..., 4]
    (Initializer.cpp:147-164)."""
    p0, p1, p2, p3 = pi.unbind(-1)
    return torch.stack([
        p0 * p0, 2 * p0 * p1, 2 * p0 * p2, 2 * p0 * p3,
        p1 * p1, 2 * p1 * p2, 2 * p1 * p3,
        p2 * p2, 2 * p2 * p3, p3 * p3,
    ], dim=-1)


def qstar_from_constraints(A: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Least-squares dual quadric [..., 4, 4] from masked constraint rows
    A [..., N, 10], mask [..., N] (Initializer.cpp:166-184): the right
    singular vector of the smallest singular value of the masked,
    row-normalized rows."""
    A = torch.where(mask[..., None], A, 0.0)
    norms = torch.linalg.vector_norm(A, dim=-1, keepdim=True)
    A = A / torch.clamp_min(norms, _EPS)
    _, _, Vh = torch.linalg.svd(A, full_matrices=False)
    q = Vh[..., -1, :]
    idx = torch.tensor([[0, 1, 2, 3], [1, 4, 5, 6], [2, 5, 7, 8],
                        [3, 6, 8, 9]], device=A.device)
    return q[..., idx]


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def ellipsoid_from_qstar(Qstar: torch.Tensor):
    """Decompose Q* [..., 4, 4] -> (vec10 [..., 10], ok [...])
    (Initializer.cpp:186-248).

    ok requires the eigen signature of Q = Q*^-1 * cbrt(det Q*) to be
    (+++-) or (---+) (Initializer.cpp:197-207).  The axes come from the
    3x3 block (``axis_i = sqrt(-k / lambda_i(Q33))``, ``k =
    det(Q)/det(Q33)``), the JAX package's deliberate fix of the
    reference's translation-dependent scale bias; the rotation from the
    same block's eigenvectors, made right-handed and round-tripped through
    Euler angles like the reference.
    """
    det = torch.linalg.det(Qstar)
    Q = torch.linalg.inv(Qstar) * _cbrt(det)[..., None, None]
    Q = 0.5 * (Q + Q.transpose(-1, -2))

    eigs = torch.linalg.eigvalsh(Q)
    num_pos = (eigs > 0).sum(-1)
    num_neg = (eigs < 0).sum(-1)
    ok = ((num_pos == 3) & (num_neg == 1)) | ((num_pos == 1) & (num_neg == 3))

    # orient the sign so Q33 is positive definite (ellipsoid normal form)
    tr = torch.diagonal(Q[..., :3, :3], dim1=-2, dim2=-1).sum(-1)
    Q = torch.where((tr < 0)[..., None, None], -Q, Q)
    Q33 = Q[..., :3, :3]

    w33, V33 = linalg.eigh3(Q33)
    k = torch.linalg.det(Q) / torch.linalg.det(Q33)
    s = torch.sqrt(torch.abs(-k[..., None] / w33))

    # translation from Q*'s last column (Initializer.cpp:229-231)
    t = Qstar[..., :, 3] / Qstar[..., 3:4, 3]

    V33 = torch.where((torch.linalg.det(V33) < 0)[..., None, None], -V33, V33)
    rpy = se3.rot_to_euler_zyx(V33)
    q = se3.zyx_euler_to_quat(rpy[..., 0], rpy[..., 1], rpy[..., 2])

    vec10 = torch.cat([t[..., :3], q, s], dim=-1)
    ok = ok & torch.all(torch.isfinite(vec10), dim=-1)
    return vec10, ok


def _masked_planes(pose_mat, bbox_mat, obs_mask, K, rows, cols):
    planes, valid = tangent_planes(pose_mat, bbox_mat, K, rows, cols)
    valid = valid & obs_mask[..., None]
    lead = planes.shape[:-3]
    return planes.reshape(lead + (-1, 4)), valid.reshape(lead + (-1,))


def init_quadric_svd(pose_mat: torch.Tensor, bbox_mat: torch.Tensor,
                     obs_mask: torch.Tensor, K: torch.Tensor,
                     rows: int, cols: int) -> InitResult:
    """Initialize quadrics from masked observations.

    pose_mat [..., M, 7] Twc per observation; bbox_mat [..., M, 4] (x1 y1
    x2 y2, border coords marked -1); obs_mask [..., M].  Requires >= 9
    valid planes (Initializer.cpp:38-43).
    """
    planes, valid = _masked_planes(pose_mat, bbox_mat, obs_mask, K, rows,
                                   cols)
    n_planes = valid.sum(-1)
    Qstar = qstar_from_constraints(plane_to_constraint(planes), valid)
    vec10, ok = ellipsoid_from_qstar(Qstar)
    return InitResult(vec10, ok & (n_planes >= 9), n_planes)


def quadric_plane_error(e_vec10: torch.Tensor, pose_mat, bbox_mat, obs_mask,
                        K, rows, cols) -> torch.Tensor:
    """Residual metric pi^T Q* pi squared and summed over the valid planes
    (Initializer.cpp:271-284), for validating an initialization."""
    planes, valid = _masked_planes(pose_mat, bbox_mat, obs_mask, K, rows,
                                   cols)
    planes = planes / torch.clamp_min(
        torch.linalg.vector_norm(planes, dim=-1, keepdim=True), _EPS)
    Qs = ell.quadric_Qstar(e_vec10)
    r = torch.einsum("...ni,...ij,...nj->...n", planes, Qs, planes)
    r = torch.where(valid, r, 0.0)
    return torch.sum(r * r, dim=-1)
