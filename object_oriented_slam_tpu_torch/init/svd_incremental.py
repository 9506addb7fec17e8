"""Incremental multi-view quadric initialization (host-side).

The batch initializer (``init/svd_init.py``) re-runs an SVD over every
stored observation each time an instance is re-attempted
(the reference's ``src/core/Initializer.cpp:166-184`` does the same).
The least-squares dual quadric only needs the 10x10 Gram matrix
G = sum_i a_i a_i^T of the (normalized) plane constraints: the last
right singular vector of A equals the smallest-eigenvalue eigenvector
of G, and G updates in O(100) flops per plane.  This module maintains G
per candidate instance on the host in float64 (numpy), so an
initialization attempt costs one 10x10 ``eigh`` and never touches the
device -- a per-attempt device round trip would stall the frame loop
(system/tracking.py).

Semantics match ``init_quadric_svd``: the same plane validity gates
(bbox edges on the image boundary dropped, Initializer.cpp:107-145),
the same per-plane and per-row normalization, the >=9-plane gate
(Initializer.cpp:38-43), the (+++-) signature check
(Initializer.cpp:197-207), and the same exact-Q33 axis reduction
(see svd_init.ellipsoid_from_qstar).  Differences: float64 host
arithmetic (the reference also runs in double) and accumulation in
Gram form (equal minimizer; conditioning is squared, which float64
absorbs -- constraint rows are unit-normalized first).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

_EPS = 1e-12


def _quat_to_mat_np(q):
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def tangent_plane_constraints(pose_wc: np.ndarray, bbox: np.ndarray,
                              K: np.ndarray, rows: int, cols: int):
    """(constraints [k,10], count) for one (pose, bbox) pair.

    Mirrors svd_init.tangent_planes + plane_to_constraint on the host.
    """
    x1, y1, x2, y2 = bbox[:4]
    all_invalid = (x1 < 1) and (y1 < 1) and (x2 < 1) and (y2 < 1)
    valid = np.array([
        0 < x1 < cols - 1, 0 < y1 < rows - 1,
        0 < x2 < cols - 1, 0 < y2 < rows - 1,
    ]) & (not all_invalid)
    lines = np.array([
        [1.0, 0.0, -x1],
        [0.0, 1.0, -y1],
        [1.0, 0.0, -x2],
        [0.0, 1.0, -y2],
    ])
    R = _quat_to_mat_np(pose_wc[3:7])
    t = pose_wc[:3]
    Tcw = np.eye(4)
    Tcw[:3, :3] = R.T
    Tcw[:3, 3] = -R.T @ t
    P = K @ Tcw[:3, :]
    planes = lines @ P                              # rows = (P^T l)^T
    nrm = np.linalg.norm(planes[:, :3], axis=1, keepdims=True)
    planes = planes / np.maximum(nrm, _EPS)

    cons = []
    for i in range(4):
        if not valid[i]:
            continue
        p0, p1, p2, p3 = planes[i]
        a = np.array([p0 * p0, 2 * p0 * p1, 2 * p0 * p2, 2 * p0 * p3,
                      p1 * p1, 2 * p1 * p2, 2 * p1 * p3,
                      p2 * p2, 2 * p2 * p3, p3 * p3])
        a = a / max(np.linalg.norm(a), _EPS)        # row normalization
        cons.append(a)
    return np.asarray(cons).reshape(-1, 10), len(cons)


def ellipsoid_from_qstar_np(Qstar: np.ndarray):
    """Host mirror of svd_init.ellipsoid_from_qstar (same gates/reduction)."""
    det = np.linalg.det(Qstar)
    Q = np.linalg.inv(Qstar) * np.cbrt(det)
    Q = 0.5 * (Q + Q.T)

    eigs = np.linalg.eigvalsh(Q)
    num_pos = int(np.sum(eigs > 0))
    num_neg = int(np.sum(eigs < 0))
    ok = (num_pos, num_neg) in ((3, 1), (1, 3))

    if np.trace(Q[:3, :3]) < 0:
        Q = -Q
    Q33 = Q[:3, :3]
    w33, V33 = np.linalg.eigh(Q33)
    k = np.linalg.det(Q) / np.linalg.det(Q33)
    s = np.sqrt(np.abs(-k / w33))

    t = Qstar[:, 3] / Qstar[3, 3]
    if np.linalg.det(V33) < 0:
        V33 = -V33
    # euler roundtrip like the reference (matrix_utils.cpp:76-95,41-54)
    pitch = np.arcsin(np.clip(-V33[2, 0], -1.0, 1.0))
    roll = np.arctan2(V33[2, 1], V33[2, 2])
    yaw = np.arctan2(V33[1, 0], V33[0, 0])
    sy, cy = np.sin(yaw / 2), np.cos(yaw / 2)
    sp, cp = np.sin(pitch / 2), np.cos(pitch / 2)
    sr, cr = np.sin(roll / 2), np.cos(roll / 2)
    q = np.array([sr * cp * cy - cr * sp * sy,
                  cr * sp * cy + sr * cp * sy,
                  cr * cp * sy - sr * sp * cy,
                  cr * cp * cy + sr * sp * sy])

    vec10 = np.concatenate([t[:3], q, s])
    ok = ok and bool(np.all(np.isfinite(vec10)))
    return vec10, ok


class IncrementalQuadricInit:
    """Per-instance Gram-matrix accumulator with O(1) attempts."""

    def __init__(self, K: np.ndarray, rows: int, cols: int):
        self.K = np.asarray(K, np.float64)
        self.rows = rows
        self.cols = cols
        self._gram: Dict[int, np.ndarray] = {}
        self._n_planes: Dict[int, int] = {}

    def add_observation(self, inst: int, pose_wc: np.ndarray,
                        bbox: np.ndarray):
        cons, k = tangent_plane_constraints(
            np.asarray(pose_wc, np.float64), np.asarray(bbox, np.float64),
            self.K, self.rows, self.cols)
        if k == 0:
            return
        G = self._gram.get(inst)
        if G is None:
            G = np.zeros((10, 10))
            self._gram[inst] = G
            self._n_planes[inst] = 0
        G += cons.T @ cons
        self._n_planes[inst] += k

    def n_planes(self, inst: int) -> int:
        return self._n_planes.get(inst, 0)

    def try_init(self, inst: int) -> Optional[np.ndarray]:
        """vec10 if the quadric decomposes to an ellipsoid, else None."""
        if self._n_planes.get(inst, 0) < 9:       # Initializer.cpp:38-43
            return None
        w, V = np.linalg.eigh(self._gram[inst])
        q = V[:, 0]                                # smallest eigenvalue
        Qstar = np.array([
            [q[0], q[1], q[2], q[3]],
            [q[1], q[4], q[5], q[6]],
            [q[2], q[5], q[7], q[8]],
            [q[3], q[6], q[8], q[9]],
        ])
        vec10, ok = ellipsoid_from_qstar_np(Qstar)
        return vec10 if ok else None

    def drop(self, inst: int):
        self._gram.pop(inst, None)
        self._n_planes.pop(inst, None)
