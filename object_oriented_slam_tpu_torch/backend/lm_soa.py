"""Structure-of-arrays (SoA) batched LM backend (port of ``backend/lm_soa.py``).

Same factor-graph semantics as the JAX package's ``lm_soa``: 2D-edge
>2-obs gate, info = I4·prob, NaN-edge drop at the initial estimate,
3D edges info = I9·prob·Scale, gravity prior, the optional visibility
gate, the 10-iteration g2o LM lambda schedule and the right-multiplicative
SE3⊕scale vertex update.  Every quantity is a tuple of ``[O, M]``
component tensors, mirroring the JAX arithmetic term for term.

The normal-equation build and the chi2 evaluation have two
implementations with one contract:

* ``soa_normal_eq_plain`` / ``soa_chi2_plain``: plain PyTorch.  The
  Jacobian is ``torch.func.jvp`` vmapped over the 9 tangent basis
  directions at u = 0, as ``jax.linearize`` does in the JAX package.
* ``backend/ba_kernels.py``: the hand-written CUDA kernels
  (``csrc/ba_edges.cu``) that fuse residual, forward-mode Jacobian and
  the J^T J / J^T r / r^T r reductions per object.

``soa_normal_eq`` / ``soa_chi2`` dispatch on the tensors' device: CUDA
tensors go to the kernels (which raise if they cannot run), CPU tensors
to the plain versions, any other device raises.

One LM iteration is two steps with the same two implementations:
``lm_solve_step`` (normal equations, damped Cholesky solve, trial
estimate) and ``lm_accept_step`` (chi2 at the trial estimate, gain ratio,
accept test, lambda schedule).  On CUDA tensors each is one launch of a
BA kernel with an LM epilogue, so ``optimize_objects_soa`` runs an
iteration in two launches.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.linalg import chol_solve_small
from . import ba_kernels
from .lm import LMConfig, ObjectObservations

_EPS = 1e-8
_TAU = 1e-5


def _maximum(x, c: float):
    """jnp.maximum(x, c) for a tensor x and a python scalar c, with its
    derivative rule (0.5 on a tie) in the differentiated residual chain."""
    return torch.maximum(x, torch.full_like(x, c))


# ---------------------------------------------------------------------------
# Componentwise (tuple-of-tensors) quaternion / SE3 helpers, term for term
# the JAX package's lm_soa helpers.
# ---------------------------------------------------------------------------

def _qmul(q1, q2):
    x1, y1, z1, w1 = q1
    x2, y2, z2, w2 = q2
    return (w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2)


def _qnormalize(q):
    x, y, z, w = q
    n = torch.sqrt(x * x + y * y + z * z + w * w)
    n = _maximum(n, _EPS)
    return (x / n, y / n, z / n, w / n)


def _cross(a, b):
    ax, ay, az = a
    bx, by, bz = b
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def _qrotate(q, v):
    """R(q) @ v, componentwise (se3.quat_rotate)."""
    qv = (q[0], q[1], q[2])
    w = q[3]
    tx, ty, tz = _cross(qv, v)
    t = (2.0 * tx, 2.0 * ty, 2.0 * tz)
    c = _cross(qv, t)
    return (v[0] + w * t[0] + c[0],
            v[1] + w * t[1] + c[1],
            v[2] + w * t[2] + c[2])


def _qconj(q):
    return (-q[0], -q[1], -q[2], q[3])


def _qtomat(q):
    """Rotation-matrix entries r[i][j] as a 3x3 nested tuple."""
    x, y, z, w = q
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return ((1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)),
            (2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)),
            (2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)))


def _se3_mul(a, b):
    """Compose pose tuples a*b; a = (t3tuple, q4tuple)."""
    ta, qa = a
    tb, qb = b
    r = _qrotate(qa, tb)
    t = (ta[0] + r[0], ta[1] + r[1], ta[2] + r[2])
    q = _qnormalize(_qmul(qa, qb))
    return (t, q)


def _se3_inv(a):
    t, q = a
    qi = _qconj(q)
    r = _qrotate(qi, t)
    return ((-r[0], -r[1], -r[2]), qi)


def _so3_exp_quat(omega):
    ox, oy, oz = omega
    theta2 = ox * ox + oy * oy + oz * oz
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    half = 0.5 * theta
    k = torch.where(theta2 > 1e-10, torch.sin(half) / theta,
                    0.5 - theta2 / 48.0)
    return (ox * k, oy * k, oz * k, torch.cos(half))


def _so3_log(q):
    x, y, z, w = q
    sgn = torch.where(w < 0, -1.0, 1.0)
    x, y, z, w = x * sgn, y * sgn, z * sgn, w * sgn
    n = torch.sqrt(x * x + y * y + z * z)
    theta = 2.0 * torch.atan2(n, w)
    k = torch.where(n > 1e-7, theta / _maximum(n, _EPS),
                    2.0 / _maximum(w, _EPS))
    return (x * k, y * k, z * k)


def _vinv_apply(omega, t):
    """(V^-1 of SE3 log) @ t, componentwise (se3._so3_left_jacobian_inv)."""
    ox, oy, oz = omega
    theta2 = ox * ox + oy * oy + oz * oz
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    half = 0.5 * theta
    cot_term = half * torch.cos(half) / _maximum(torch.sin(half), _EPS)
    c = torch.where(theta2 > 1e-10,
                    (1.0 - cot_term) / _maximum(theta2, _EPS),
                    1.0 / 12.0 + theta2 / 720.0)
    o00 = -(oz * oz + oy * oy)
    o01 = oy * ox
    o02 = oz * ox
    o11 = -(oz * oz + ox * ox)
    o12 = oz * oy
    o22 = -(oy * oy + ox * ox)
    v00, v01, v02 = 1.0 + c * o00, 0.5 * oz + c * o01, -0.5 * oy + c * o02
    v10, v11, v12 = -0.5 * oz + c * o01, 1.0 + c * o11, 0.5 * ox + c * o12
    v20, v21, v22 = 0.5 * oy + c * o02, -0.5 * ox + c * o12, 1.0 + c * o22
    tx, ty, tz = t
    return (v00 * tx + v01 * ty + v02 * tz,
            v10 * tx + v11 * ty + v12 * tz,
            v20 * tx + v21 * ty + v22 * tz)


def _se3_log(a):
    t, q = a
    omega = _so3_log(q)
    ups = _vinv_apply(omega, t)
    return omega + ups  # 6-tuple


def _se3_exp(u6):
    """Tangent 6-tuple [omega, upsilon] -> pose tuple (se3.se3_exp)."""
    omega = u6[:3]
    ups = u6[3:]
    q = _so3_exp_quat(omega)
    ox, oy, oz = omega
    theta2 = ox * ox + oy * oy + oz * oz
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    a = torch.where(theta2 > 1e-10,
                    (1.0 - torch.cos(theta)) / _maximum(theta2, _EPS),
                    0.5 - theta2 / 24.0)
    b = torch.where(theta2 > 1e-10,
                    (theta - torch.sin(theta)) / _maximum(theta2 * theta, _EPS),
                    1.0 / 6.0 - theta2 / 120.0)
    o00 = -(oz * oz + oy * oy)
    o01 = oy * ox
    o02 = oz * ox
    o11 = -(oz * oz + ox * ox)
    o12 = oz * oy
    o22 = -(oy * oy + ox * ox)
    v00, v01, v02 = 1.0 + b * o00, -a * oz + b * o01, a * oy + b * o02
    v10, v11, v12 = a * oz + b * o01, 1.0 + b * o11, -a * ox + b * o12
    v20, v21, v22 = -a * oy + b * o02, a * ox + b * o12, 1.0 + b * o22
    ux, uy, uz = ups
    t = (v00 * ux + v01 * uy + v02 * uz,
         v10 * ux + v11 * uy + v12 * uz,
         v20 * ux + v21 * uy + v22 * uz)
    return (t, q)


def _exp_update(est10, u9):
    """Ellipsoid oplus: pose*exp(u[:6]), s+u[6:] on 10-/9-tuples."""
    pose = ((est10[0], est10[1], est10[2]),
            (est10[3], est10[4], est10[5], est10[6]))
    d = _se3_exp(u9[:6])
    t, q = _se3_mul(pose, d)
    return (t[0], t[1], t[2], q[0], q[1], q[2], q[3],
            est10[7] + u9[6], est10[8] + u9[7], est10[9] + u9[8])


# ---------------------------------------------------------------------------
# Residual chains (componentwise over [O, M] observation grids)
# ---------------------------------------------------------------------------

def _proj_bbox_soa(e, tcw, qcw, fx, fy, cx, cy):
    """Projected ellipse bbox; 4-tuple (x1,y1,x2,y2) of [O, M2] tensors.

    project_ellipse + ellipse_to_bbox (Ellipsoid.cpp:209-273) with every
    3x3 product unrolled; ``e`` is a 10-tuple of [O, 1] tensors.
    """
    Rcw = _qtomat((qcw[0], qcw[1], qcw[2], qcw[3]))
    Robj = _qtomat((e[3], e[4], e[5], e[6]))
    s = (e[7], e[8], e[9])
    t = (e[0], e[1], e[2])

    # A = K @ R_cw with K = [[fx,0,cx],[0,fy,cy],[0,0,1]]
    A = ((fx * Rcw[0][0] + cx * Rcw[2][0],
          fx * Rcw[0][1] + cx * Rcw[2][1],
          fx * Rcw[0][2] + cx * Rcw[2][2]),
         (fy * Rcw[1][0] + cy * Rcw[2][0],
          fy * Rcw[1][1] + cy * Rcw[2][1],
          fy * Rcw[1][2] + cy * Rcw[2][2]),
         (Rcw[2][0], Rcw[2][1], Rcw[2][2]))

    # W = A @ R_obj ; WS = W * diag(s)
    WS = tuple(
        tuple((A[i][0] * Robj[0][j] + A[i][1] * Robj[1][j]
               + A[i][2] * Robj[2][j]) * s[j] for j in range(3))
        for i in range(3))
    # v = A @ t_obj + K @ t_cw
    kt = (fx * tcw[0] + cx * tcw[2], fy * tcw[1] + cy * tcw[2], tcw[2])
    v = tuple(A[i][0] * t[0] + A[i][1] * t[1] + A[i][2] * t[2] + kt[i]
              for i in range(3))

    def cs(i, j):
        return (WS[i][0] * WS[j][0] + WS[i][1] * WS[j][1]
                + WS[i][2] * WS[j][2]) - v[i] * v[j]

    a_, b_, c_ = cs(0, 0), cs(0, 1), cs(0, 2)
    e_, f_ = cs(1, 1), cs(1, 2)
    i_ = cs(2, 2)

    # C = inv3(C*) (adjugate form, symmetric operands), normalized by C[2,2]
    adjA = e_ * i_ - f_ * f_
    adjD = -(b_ * i_ - c_ * f_)
    adjE = a_ * i_ - c_ * c_
    adjG = b_ * f_ - c_ * e_
    adjH = -(a_ * f_ - c_ * b_)
    adjI = a_ * e_ - b_ * b_
    det = a_ * adjA + b_ * (-(b_ * i_ - f_ * c_)) + c_ * (b_ * f_ - e_ * c_)
    det = det + torch.where(det == 0, 1e-30, 0.0)
    c00 = adjA / det
    c01 = adjD / det
    c11 = adjE / det
    c02 = adjG / det
    c21 = adjH / det
    c22 = adjI / det
    ca = c00 / c22
    cb = (c01 / c22) * 2.0
    cc = c11 / c22
    cd = (c02 / c22) * 2.0
    ce = (c21 / c22) * 2.0

    theta = 0.5 * torch.atan2(cb, ca - cc)
    den = 4.0 * ca * cc - cb * cb
    x_c = (cb * ce - 2.0 * cc * cd) / den
    y_c = (cb * cd - 2.0 * ca * ce) / den
    quad = ca * x_c * x_c + cc * y_c * y_c + cb * x_c * y_c - 1.0
    root = torch.sqrt((ca - cc) * (ca - cc) + cb * cb)
    a2 = 2.0 * quad / (ca + cc + root)
    b2 = 2.0 * quad / (ca + cc - root)
    ax1 = torch.sqrt(_maximum(a2, 0.0))
    ax2 = torch.sqrt(_maximum(b2, 0.0))
    c2t = torch.cos(theta) ** 2
    s2t = 1.0 - c2t
    x_lim = torch.sqrt(ax1 * ax1 * c2t + ax2 * ax2 * s2t)
    y_lim = torch.sqrt(ax1 * ax1 * s2t + ax2 * ax2 * c2t)
    return (x_c - x_lim, y_c - y_lim, x_c + x_lim, y_c + y_lim)


def _proj_residual_soa(e, tcw, qcw, bbox, fx, fy, cx, cy):
    """2D conic-projection residual; border coords (< 5) are skipped
    (BasicEllipsoidEdges.cpp:102-112)."""
    proj = _proj_bbox_soa(e, tcw, qcw, fx, fy, cx, cy)
    return tuple(torch.where(bbox[k] >= 5.0, proj[k] - bbox[k], 0.0)
                 for k in range(4))


def soa_visibility2d(est0, tcw, qcw, K, rows, cols):
    """[O,M2] visibility mask of 2D edges at the initial estimate.

    The optional ``checkVisibility`` gate the reference keeps disabled
    (Optimizer.cpp:35-81,232): an edge is dropped when the object center
    is behind the camera, the camera center lies inside the quadric, or
    neither the projected center nor a projected-bbox corner lies inside
    the image (Optimizer.cpp:20-27).
    """
    e0 = tuple(est0[:, k:k + 1] for k in range(10))
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    Rcw = _qtomat((qcw[0], qcw[1], qcw[2], qcw[3]))

    pc = tuple(Rcw[i][0] * e0[0] + Rcw[i][1] * e0[1] + Rcw[i][2] * e0[2]
               + tcw[i] for i in range(3))
    in_front = pc[2] >= 0.0

    xw = tuple(-(Rcw[0][i] * tcw[0] + Rcw[1][i] * tcw[1]
                 + Rcw[2][i] * tcw[2]) for i in range(3))
    Robj = _qtomat((e0[3], e0[4], e0[5], e0[6]))
    d = (xw[0] - e0[0], xw[1] - e0[1], xw[2] - e0[2])
    lo = tuple(Robj[0][i] * d[0] + Robj[1][i] * d[1] + Robj[2][i] * d[2]
               for i in range(3))
    q_val = sum((lo[i] / _maximum(torch.abs(e0[7 + i]), 1e-8)) ** 2
                for i in range(3))
    outside = q_val >= 1.0

    zden = torch.where(torch.abs(pc[2]) > 1e-8, pc[2], 1e-8)
    u = fx * pc[0] / zden + cx
    v = fy * pc[1] / zden + cy

    def in_img(x, y):
        return (x > 0) & (x < cols) & (y > 0) & (y < rows)

    center_in = in_img(u, v)
    x1, y1, x2, y2 = _proj_bbox_soa(e0, tcw, qcw, fx, fy, cx, cy)
    corner_in = in_img(x1, y1) | in_img(x2, y2)
    return in_front & outside & (center_in | corner_in)


def _precompute_3d_soa(p3, me3):
    """Estimate-independent 3D-measurement work, hoisted out of the LM.

    p3: 7-tuple of [O,M3] (pose_wc), me3: 10-tuple of [O,M3].  Returns
    invp4[k] (7-tuple) and sc4[k] (3-tuple) for the {-90, 0, 90, 180}-deg
    yaw candidates k.
    """
    mw = _se3_mul(((p3[0], p3[1], p3[2]), (p3[3], p3[4], p3[5], p3[6])),
                  ((me3[0], me3[1], me3[2]),
                   (me3[3], me3[4], me3[5], me3[6])))
    sx, sy, sz = me3[7], me3[8], me3[9]
    zeros = torch.zeros_like(sx)
    invp4, sc4 = [], []
    for k in (-1, 0, 1, 2):
        yaw = k * math.pi / 2.0
        s_h, c_h = math.sin(yaw * 0.5), math.cos(yaw * 0.5)
        rot = ((zeros, zeros, zeros), (zeros, zeros, zeros + s_h, zeros + c_h))
        t, q = _se3_inv(_se3_mul(mw, rot))
        invp4.append((t[0], t[1], t[2], q[0], q[1], q[2], q[3]))
        sc4.append((sy, sx, sz) if k % 2 != 0 else (sx, sy, sz))
    return invp4, sc4


def _first_argmin4(norms):
    """Index of the least of 4 [O,M] tensors; the first NaN wins, like
    jnp.argmin, and the first of equal values."""
    nmat = torch.stack(norms)
    nmat = torch.where(torch.isnan(nmat), -math.inf, nmat)
    return torch.argmin(nmat, dim=0)


def _res3d_soa(e, invp4, sc4):
    """3D 9-DoF residual with 4-rotation minimization; 9-tuple of [O,M3]."""
    errs = []
    norms = []
    for k in range(4):
        p = invp4[k]
        diff = _se3_mul(((p[0], p[1], p[2]), (p[3], p[4], p[5], p[6])),
                        ((e[0], e[1], e[2]), (e[3], e[4], e[5], e[6])))
        lg = _se3_log(diff)
        err = lg + (e[7] - sc4[k][0], e[8] - sc4[k][1], e[9] - sc4[k][2])
        errs.append(err)
        n = err[0] * err[0]
        for c in err[1:]:
            n = n + c * c
        norms.append(n)
    idx = _first_argmin4([n.detach() for n in norms])
    out = []
    for c in range(9):
        acc = torch.where(idx == 0, errs[0][c], errs[1][c])
        acc = torch.where(idx == 2, errs[2][c], acc)
        acc = torch.where(idx == 3, errs[3][c], acc)
        out.append(acc)
    return tuple(out)


def _gravity_residual_soa(e, normal):
    """Gravity-prior residual, [O] tensor (residuals.residual_gravity)."""
    R = _qtomat((e[3], e[4], e[5], e[6]))
    zx, zy, zz = R[0][2], R[1][2], R[2][2]
    nx, ny, nz = normal[0], normal[1], normal[2]
    dot = zx * nx + zy * ny + zz * nz
    zn = torch.sqrt(zx * zx + zy * zy + zz * zz)
    nn = torch.sqrt(nx * nx + ny * ny + nz * nz)
    cosang = dot / (zn * _maximum(nn, 1e-8))
    cosang = torch.minimum(_maximum(cosang, -1.0 + 1e-4),
                           torch.full_like(cosang, 1.0 - 1e-4))
    return torch.acos(cosang)


def _huber_w(comps, delta):
    s = comps[0] * comps[0]
    for c in comps[1:]:
        s = s + c * c
    s = s.detach()
    return torch.where(s > delta * delta,
                       torch.sqrt(delta / _maximum(torch.sqrt(s), 1e-12)), 1.0)


def _finite0(x):
    return torch.where(torch.isfinite(x), x, 0.0)


# ---------------------------------------------------------------------------
# Estimate-independent preparation
# ---------------------------------------------------------------------------

class SoaPrep(NamedTuple):
    """Estimate-independent observation data of one LM call.

    pose2d_cw [O,M2,7] and bbox2d [O,M2,4] are the 2D edges; invp3
    [O,M3,4,7] and sc3 [O,M3,4,3] are the hoisted 3D measurements, one
    per yaw candidate k in {-90, 0, 90, 180} deg: the inverse measured
    world pose and the (axis-swapped) measured scales.
    """
    pose2d_cw: torch.Tensor
    bbox2d: torch.Tensor
    invp3: torch.Tensor
    sc3: torch.Tensor

    @property
    def tcw(self):
        return tuple(self.pose2d_cw[..., k] for k in range(3))

    @property
    def qcw(self):
        return tuple(self.pose2d_cw[..., 3 + k] for k in range(4))

    @property
    def b2(self):
        return tuple(self.bbox2d[..., k] for k in range(4))

    @property
    def invp4(self):
        return [tuple(self.invp3[..., k, c] for c in range(7))
                for k in range(4)]

    @property
    def sc4(self):
        return [tuple(self.sc3[..., k, c] for c in range(3))
                for k in range(4)]


def soa_prepare(pose2d_cw, bbox2d, pose3d_wc, meas3d) -> SoaPrep:
    """Everything estimate-independent, including the hoisted
    3D-measurement rotations (computed once per LM call)."""
    p3 = tuple(pose3d_wc[:, :, k] for k in range(7))
    me3 = tuple(meas3d[:, :, k] for k in range(10))
    invp4, sc4 = _precompute_3d_soa(p3, me3)
    invp3 = torch.stack([torch.stack(p, dim=-1) for p in invp4], dim=-2)
    sc3 = torch.stack([torch.stack(s, dim=-1) for s in sc4], dim=-2)
    return SoaPrep(pose2d_cw.contiguous(), bbox2d.contiguous(),
                   invp3.contiguous(), sc3.contiguous())


def soa_finite2d(est0, tcw, qcw, b2, K):
    """[O,M2] mask of 2D edges finite at the initial estimate."""
    e0c = tuple(est0[:, k:k + 1] for k in range(10))
    r2 = _proj_residual_soa(e0c, tcw, qcw, b2,
                            K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    fin = torch.isfinite(r2[0])
    for c in r2[1:]:
        fin = fin & torch.isfinite(c)
    return fin


def soa_residual_comps(est_flat, u_flat, prep: SoaPrep, w2d, w3d, wg,
                       ground_normal, K, huber_delta=0.0):
    """All weighted residual components at exp_update(est, u).

    est_flat [O,10], u_flat [O,9] -> tuple of 14 tensors:
    4x[O,M2] + 9x[O,M3] + 1x[O].  Weights fold masks/probs/gates.
    """
    normal = (ground_normal[0], ground_normal[1], ground_normal[2])
    e10 = _exp_update(tuple(est_flat[:, k] for k in range(10)),
                      tuple(u_flat[:, k] for k in range(9)))
    eb = tuple(c[:, None] for c in e10)
    r2 = _proj_residual_soa(eb, prep.tcw, prep.qcw, prep.b2,
                            K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    r2 = tuple(c * w2d for c in r2)
    r3 = _res3d_soa(eb, prep.invp4, prep.sc4)
    r3 = tuple(c * w3d for c in r3)
    if huber_delta > 0.0:
        h2 = _huber_w(r2, huber_delta)
        r2 = tuple(c * h2 for c in r2)
        h3 = _huber_w(r3, huber_delta)
        r3 = tuple(c * h3 for c in r3)
    rg = _gravity_residual_soa(tuple(c[:, 0] for c in eb), normal) * wg
    return tuple(_finite0(c) for c in (r2 + r3 + (rg,)))


def soa_flat_r(comps, O):
    """Concatenate residual components into [..., O, R]."""
    lead = comps[0].shape[:-2]
    parts = [c.reshape(lead + (O, -1)) for c in comps[:-1]]
    parts.append(comps[-1].reshape(lead + (O, 1)))
    return torch.cat(parts, dim=-1)


# ---------------------------------------------------------------------------
# Normal equations and chi2: plain versions and the device dispatch
# ---------------------------------------------------------------------------

def _drop_nonfinite_edges(r_comps, t_comps):
    """Zero the residual and tangent rows of every edge that has a
    non-finite tangent component.  r_comps: 14 residual components (4 of
    the 2D edges [O,M2], 9 of the 3D edges [O,M3], gravity [O]); t_comps:
    their tangents with a leading axis of 9 directions."""
    r_out, t_out = [], []
    for lo, hi in ((0, 4), (4, 13), (13, 14)):
        fin = torch.isfinite(t_comps[lo])
        for t in t_comps[lo + 1:hi]:
            fin = fin & torch.isfinite(t)
        fin = fin.all(dim=0)                       # per edge, all directions
        r_out += [torch.where(fin, r, 0.0) for r in r_comps[lo:hi]]
        t_out += [torch.where(fin, t, 0.0) for t in t_comps[lo:hi]]
    return tuple(r_out), tuple(t_out)


def soa_normal_eq_plain(est, prep, w2d, w3d, wg, ground_normal, K,
                        huber_delta=0.0):
    """(H [O,9,9], g [O,9], r2sum [O]) in plain PyTorch on any device.

    One jvp per tangent basis direction at u = 0 (vmapped), then the
    J^T J / J^T r contractions over the flat residual axis.

    An edge any of whose tangent components is non-finite (the sqrt of a
    projected conic's semi-axis^2 that rounded to zero or below) is left
    out of this iteration's sums: its rows of J and r count as 0, so one
    degenerate view no longer makes H non-finite and the ``du_ok`` gate no
    longer freezes the object.  Where every tangent is finite nothing is
    replaced and the sums are what they were.  (The JAX package gates the
    whole object in that case: a deliberate difference.)
    """
    O = est.shape[0]
    u0 = torch.zeros((O, 9), dtype=est.dtype, device=est.device)

    def f(u):
        return soa_residual_comps(est, u, prep, w2d, w3d, wg, ground_normal,
                                  K, huber_delta)

    basis = torch.eye(9, dtype=est.dtype, device=est.device)[:, None, :]
    basis = basis.expand(9, O, 9)
    r_comps, t_comps = torch.func.vmap(
        lambda t: torch.func.jvp(f, (u0,), (t,)))(basis)
    r_comps = tuple(c[0] for c in r_comps)
    r_comps, t_comps = _drop_nonfinite_edges(r_comps, t_comps)
    J = soa_flat_r(t_comps, O)                     # [9, O, R]
    r = soa_flat_r(r_comps, O)                     # [O, R]
    H = torch.einsum("kor,lor->okl", J, J)
    g = torch.einsum("kor,or->ok", J, r)
    return H, g, torch.sum(r * r, dim=-1)


def soa_chi2_plain(est, prep, w2d, w3d, wg, ground_normal, K,
                   huber_delta=0.0):
    O = est.shape[0]
    r = soa_flat_r(soa_residual_comps(
        est, torch.zeros((O, 9), dtype=est.dtype, device=est.device), prep,
        w2d, w3d, wg, ground_normal, K, huber_delta), O)
    return torch.sum(r * r, dim=-1)


def _on_cuda(est) -> bool:
    if est.device.type == "cuda":
        return True
    if est.device.type == "cpu":
        return False
    raise NotImplementedError(
        f"no backend for tensors on {est.device}: the BA edge work runs "
        "as CUDA kernels on cuda tensors and in plain PyTorch on cpu")


def soa_normal_eq(est, prep, w2d, w3d, wg, ground_normal, K,
                  huber_delta=0.0):
    """(H [O,9,9], g [O,9], r2sum [O]); the CUDA kernel on cuda tensors."""
    if _on_cuda(est):
        return ba_kernels.normal_eq(est, prep, w2d, w3d, wg, ground_normal,
                                    K, huber_delta)
    return soa_normal_eq_plain(est, prep, w2d, w3d, wg, ground_normal, K,
                               huber_delta)


def soa_chi2(est, prep, w2d, w3d, wg, ground_normal, K, huber_delta=0.0):
    """chi2 [O] of all edges; the CUDA kernel on cuda tensors."""
    if _on_cuda(est):
        return ba_kernels.chi2(est, prep, w2d, w3d, wg, ground_normal, K,
                               huber_delta)
    return soa_chi2_plain(est, prep, w2d, w3d, wg, ground_normal, K,
                          huber_delta)


def soa_exp_update_flat(est, du):
    """Batched ellipsoid oplus on [O,10] / [O,9] tensors."""
    return torch.stack(
        _exp_update(tuple(est[:, k] for k in range(10)),
                    tuple(du[:, k] for k in range(9))), dim=-1)


# ---------------------------------------------------------------------------
# One LM iteration in two steps: plain versions and the device dispatch
# ---------------------------------------------------------------------------

def lm_solve_step_plain(est, lam, prep, w2d, w3d, wg, ground_normal, K,
                        huber_delta=0.0, want_H=False):
    """First half of an LM iteration in plain PyTorch on any device.

    The normal equations at ``est``, the damping (``lam`` < 0 asks for the
    initial tau * max diag H), the unrolled Cholesky solve of
    (H + lam0 I) x = g, du = -x behind the all-finite gate and the trial
    estimate.  Returns (est_new [O,10], du [O,9], g [O,9], lam0 [O], H);
    H [O,9,9] only if ``want_H``, else None.
    """
    H, g, _ = soa_normal_eq_plain(est, prep, w2d, w3d, wg, ground_normal, K,
                                  huber_delta)
    est_new, du, lam0 = solve_from_normal_eq(est, lam, H, g)
    return est_new, du, g, lam0, (H if want_H else None)


def solve_from_normal_eq(est, lam, H, g):
    """The per-object part of the solve step: (est_new, du, lam0) from the
    reduced H [O,9,9] and g [O,9]."""
    lam0 = torch.where(lam < 0, _TAU * torch.amax(
        torch.diagonal(H, dim1=1, dim2=2), dim=1), lam)
    lam0 = torch.clamp_min(lam0, 1e-12)
    eye9 = torch.eye(9, dtype=H.dtype, device=H.device)
    A = H + lam0[:, None, None] * eye9
    du = -chol_solve_small(A, g)              # [O, 9]
    du_ok = torch.all(torch.isfinite(du), dim=1, keepdim=True)
    du = torch.where(du_ok, du, 0.0)
    return soa_exp_update_flat(est, du), du, lam0


def lm_accept_step_plain(est, chi2, lam, nu, est_new, du, g, lam0, prep, w2d,
                         w3d, wg, ground_normal, K, huber_delta=0.0):
    """Second half of an LM iteration in plain PyTorch on any device.

    chi2 at the trial estimate, the gain ratio, the accept test and the
    g2o lambda / nu schedule.  Returns new tensors (est, chi2, lam, nu,
    accept [O] bool); nothing is updated in place.
    """
    chi2_new = soa_chi2_plain(est_new, prep, w2d, w3d, wg, ground_normal, K,
                              huber_delta)
    return accept_from_chi2(est, chi2, nu, est_new, chi2_new, du, g, lam0)


def accept_from_chi2(est, chi2, nu, est_new, chi2_new, du, g, lam0):
    """The per-object part of the accept step, from chi2 at est_new."""
    denom = torch.sum(du * (lam0[:, None] * du - g), dim=1)
    rho = (chi2 - chi2_new) / torch.where(torch.abs(denom) > 1e-20,
                                          denom, 1e-20)
    accept = (chi2_new < chi2) & torch.isfinite(chi2_new)
    factor = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, 1.0 / 3.0,
                         2.0 / 3.0)
    lam = torch.where(accept, lam0 * factor, lam0 * nu)
    nu = torch.where(accept, 2.0, nu * 2.0)
    est = torch.where(accept[:, None], est_new, est)
    chi2 = torch.where(accept, chi2_new, chi2)
    return est, chi2, lam, nu, accept


def lm_solve_step(est, lam, prep, w2d, w3d, wg, ground_normal, K,
                  huber_delta=0.0, want_H=False):
    """(est_new, du, g, lam0, H or None); one kernel launch on cuda
    tensors."""
    step = ba_kernels.lm_solve_step if _on_cuda(est) else lm_solve_step_plain
    return step(est, lam, prep, w2d, w3d, wg, ground_normal, K, huber_delta,
                want_H)


def lm_accept_step(est, chi2, lam, nu, est_new, du, g, lam0, prep, w2d, w3d,
                   wg, ground_normal, K, huber_delta=0.0):
    """(est, chi2, lam, nu, accept) after the accept test.  On cuda tensors
    this is one kernel launch that updates ``est``, ``chi2``, ``lam`` and
    ``nu`` in place and returns them; on cpu tensors new tensors are
    returned.  Callers use the returned ones."""
    step = (ba_kernels.lm_accept_step if _on_cuda(est)
            else lm_accept_step_plain)
    return step(est, chi2, lam, nu, est_new, du, g, lam0, prep, w2d, w3d, wg,
                ground_normal, K, huber_delta)


# ---------------------------------------------------------------------------
# The solver
# ---------------------------------------------------------------------------

def soa_edge_weights(obs: ObjectObservations, prep: SoaPrep, K,
                     ground_set, cfg: LMConfig):
    """(w2d [O,M2], w3d [O,M3], wg [O]): sqrt-info edge weights with every
    gate folded in (>2-obs gate, NaN gate at est0, optional visibility
    gate, gravity prior switch)."""
    O = obs.mask2d.shape[0]
    n2d = obs.mask2d.sum(dim=1)
    gate2d = (n2d >= cfg.min_2d_obs)[:, None]
    w2d = torch.sqrt(torch.clamp_min(obs.prob2d, 0.0))
    w2d = torch.where(obs.mask2d & gate2d, w2d, 0.0)
    w3d = torch.sqrt(torch.clamp_min(obs.prob3d, 0.0) * cfg.scale_3d)
    w3d = torch.where(obs.mask3d, w3d, 0.0)
    gravity_active = bool(ground_set) and bool(cfg.gravity_on)
    wg = torch.full((O,), cfg.gravity_scale if gravity_active else 0.0,
                    dtype=obs.est0.dtype, device=obs.est0.device)

    # NaN gate at the initial estimate (Optimizer.cpp:234-243)
    w2d = torch.where(soa_finite2d(obs.est0, prep.tcw, prep.qcw, prep.b2, K),
                      w2d, 0.0)
    # optional visibility gate (Optimizer.cpp:35-81, off by default)
    if cfg.check_visibility:
        w2d = torch.where(soa_visibility2d(obs.est0, prep.tcw, prep.qcw, K,
                                           cfg.vis_rows, cfg.vis_cols),
                          w2d, 0.0)
    return w2d.contiguous(), w3d.contiguous(), wg


def optimize_objects_soa(obs: ObjectObservations, K: torch.Tensor,
                         ground_normal: torch.Tensor, ground_set: bool,
                         cfg: LMConfig = LMConfig()):
    """Mapping-mode global object-graph optimization (SoA layout).

    Runs on the device of ``obs``; returns (estimates [O,10], chi2 [O]).
    """
    O = obs.mask2d.shape[0]
    dev, f32 = obs.est0.device, obs.est0.dtype
    K = K.to(device=dev, dtype=f32)
    ground_normal = ground_normal.to(device=dev, dtype=f32)

    prep = soa_prepare(obs.pose2d_cw, obs.bbox2d, obs.pose3d_wc, obs.meas3d)
    w2d, w3d, wg = soa_edge_weights(obs, prep, K, ground_set, cfg)

    problem = (prep, w2d, w3d, wg, ground_normal, K, cfg.huber_delta)

    # a copy: on cuda tensors the accept step updates est in place
    est = obs.est0.clone(memory_format=torch.contiguous_format)
    lam = torch.full((O,), -1.0, dtype=f32, device=dev)
    nu = torch.full((O,), 2.0, dtype=f32, device=dev)
    chi2 = soa_chi2(est, *problem)
    for _ in range(cfg.iters):
        est_new, du, g, lam0, _ = lm_solve_step(est, lam, *problem)
        est, chi2, lam, nu, _ = lm_accept_step(est, chi2, lam, nu, est_new,
                                               du, g, lam0, *problem)

    has_edges = (torch.sum(w2d, dim=1) + torch.sum(w3d, dim=1)) > 0
    keep = (obs.obj_mask & has_edges)[:, None]
    return torch.where(keep, est, obs.est0), chi2
