"""SLAM-mode integration: build the joint pose + object graph from a
SlamState and refine it (port of ``object_oriented_slam_tpu/system/
slam_mode.py``).

The reference's SLAM mode (``bSLAM_mode``, Optimizer.cpp:126,142-158) frees
the camera vertices and chains them with odometry edges computed from the
input poses.  The graph is packed on the host (numpy, the JAX package's
arrays) from the tracker's recorded state and solved by the Schur
complement backend (``backend/slam_ba.py``) on the device; the odometry
measurements are the relative transforms of the *input* trajectory (which
may be noisy odometry rather than ground truth, ``io/tum.py``
set_odometry), and the optimisation refines trajectory and objects.
"""
from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np
import torch

from ..backend import slam_ba
from ..backend.lm import LMConfig
from .state import SlamState
from .tracking import _np_se3_inv, _np_se3_mul, resolve_device

_LOG = logging.getLogger("object_oriented_slam_tpu_torch")

# grow-only capacity tiers (powers of two above a floor), as the JAX
# package's, so repeated refinements of a growing run keep their shapes
_F_MIN, _O_MIN, _E2_MIN, _E3_MIN = 64, 16, 256, 128


def _tier(n: int, lo: int) -> int:
    c = lo
    while c < n:
        c *= 2
    return c


def pack_slam_graph(state: SlamState, lm_cfg: LMConfig,
                    max_frames: Optional[int] = None,
                    max_objects: Optional[int] = None,
                    max_e2: Optional[int] = None,
                    max_e3: Optional[int] = None,
                    gravity_on: bool = True,
                    odometry_wc: Optional[np.ndarray] = None,
                    odo_weight: float = 1.0):
    """The recorded observations as the graph's numpy arrays (the JAX
    package's ``build_slam_graph`` arrays, its dtypes) and the instance
    order: see ``build_slam_graph``."""
    F_all = len(state.frames_pose_wc)
    if max_frames is None:
        max_frames = _tier(max(F_all, 1), _F_MIN)
    elif F_all > max_frames:
        _LOG.warning(
            "SLAM-mode frame window: %d frames recorded but max_frames=%d "
            "— refining only the most recent %d (pass max_frames=None for "
            "the full unbounded graph)", F_all, max_frames, max_frames)
    start = max(0, F_all - max_frames)
    F = min(F_all, max_frames)
    frame_of = {start + i: i for i in range(F)}

    poses_cw = np.tile(np.array([0, 0, 0, 0, 0, 0, 1], np.float32),
                       (max_frames, 1))
    frame_mask = np.zeros(max_frames, bool)
    for gi, li in frame_of.items():
        poses_cw[li] = _np_se3_inv(state.frames_pose_wc[gi]).astype(np.float32)
        frame_mask[li] = True

    insts_all = sorted(state.initialized_instances())
    if max_objects is None:
        max_objects = _tier(max(len(insts_all), 1), _O_MIN)
    elif len(insts_all) > max_objects:
        _LOG.warning(
            "SLAM-mode object cap: %d initialized instances but "
            "max_objects=%d — DROPPING %d objects (pass max_objects=None "
            "for the full graph)", len(insts_all), max_objects,
            len(insts_all) - max_objects)
    instances = insts_all[:max_objects]

    # size the edge capacities from the actual counts before filling
    need2 = need3 = 0
    for inst in instances:
        rec = state.objects[inst]
        if len(rec.obs2d_bbox) > 2:  # >2-obs gate (Optimizer.cpp:201)
            need2 += sum(1 for fb in rec.obs2d_frame if fb in frame_of)
        need3 += sum(1 for fb in rec.obs3d_frame if fb in frame_of)
    if max_e2 is None:
        max_e2 = _tier(max(need2, 1), _E2_MIN)
    elif need2 > max_e2:
        _LOG.warning("SLAM-mode 2D-edge cap: %d edges but max_e2=%d — "
                     "DROPPING %d", need2, max_e2, need2 - max_e2)
    if max_e3 is None:
        max_e3 = _tier(max(need3, 1), _E3_MIN)
    elif need3 > max_e3:
        _LOG.warning("SLAM-mode 3D-edge cap: %d edges but max_e3=%d — "
                     "DROPPING %d", need3, max_e3, need3 - max_e3)

    objects = np.tile(np.array([0, 0, 0, 0, 0, 0, 1, 1, 1, 1], np.float32),
                      (max_objects, 1))
    obj_mask = np.zeros(max_objects, bool)
    grav_w = np.zeros(max_objects, np.float32)
    gset = state.ground_plane is not None and gravity_on
    for k, inst in enumerate(instances):
        objects[k] = state.objects[inst].vec10.astype(np.float32)
        obj_mask[k] = True
        if gset:
            grav_w[k] = lm_cfg.gravity_scale

    e2_f = np.zeros(max_e2, np.int32)
    e2_o = np.zeros(max_e2, np.int32)
    e2_b = np.full((max_e2, 4), -1.0, np.float32)
    e2_w = np.zeros(max_e2, np.float32)
    n2 = 0
    e3_f = np.zeros(max_e3, np.int32)
    e3_o = np.zeros(max_e3, np.int32)
    e3_m = np.tile(np.array([0, 0, 0, 0, 0, 0, 1, 1, 1, 1], np.float32),
                   (max_e3, 1))
    e3_w = np.zeros(max_e3, np.float32)
    n3 = 0
    for k, inst in enumerate(instances):
        rec = state.objects[inst]
        if len(rec.obs2d_bbox) > 2:  # >2-obs gate (Optimizer.cpp:201)
            for fb, bb, pr in zip(rec.obs2d_frame, rec.obs2d_bbox,
                                  rec.obs2d_prob):
                if fb in frame_of and n2 < max_e2:
                    e2_f[n2] = frame_of[fb]
                    e2_o[n2] = k
                    e2_b[n2] = bb
                    e2_w[n2] = np.sqrt(max(pr, 0.0))
                    n2 += 1
        for fb, mm, pr in zip(rec.obs3d_frame, rec.obs3d_meas,
                              rec.obs3d_prob):
            if fb in frame_of and n3 < max_e3:
                e3_f[n3] = frame_of[fb]
                e3_o[n3] = k
                e3_m[n3] = mm.astype(np.float32)
                e3_w[n3] = np.sqrt(max(pr, 0.0) * lm_cfg.scale_3d)
                n3 += 1

    # odometry chain from the input trajectory (Optimizer.cpp:142-158)
    max_odo = max_frames - 1
    odo_i = np.zeros(max_odo, np.int32)
    odo_j = np.zeros(max_odo, np.int32)
    odo_m = np.tile(np.array([0, 0, 0, 0, 0, 0, 1], np.float32),
                    (max_odo, 1))
    odo_w = np.zeros(max_odo, np.float32)
    if odometry_wc is not None:
        ocw = [_np_se3_inv(np.asarray(odometry_wc[start + i], np.float64))
               for i in range(F)]
    else:
        ocw = [poses_cw[i].astype(np.float64) for i in range(F)]
    for i in range(F - 1):
        odo_i[i] = i
        odo_j[i] = i + 1
        odo_m[i] = _np_se3_mul(ocw[i + 1],
                               _np_se3_inv(ocw[i])).astype(np.float32)
        odo_w[i] = odo_weight

    arrays = dict(
        poses_cw=poses_cw, frame_mask=frame_mask, objects=objects,
        obj_mask=obj_mask, e2_frame=e2_f, e2_obj=e2_o, e2_bbox=e2_b,
        e2_w=e2_w, e3_frame=e3_f, e3_obj=e3_o, e3_meas=e3_m, e3_w=e3_w,
        odo_i=odo_i, odo_j=odo_j, odo_meas=odo_m, odo_w=odo_w,
        grav_w=grav_w)
    return arrays, instances


def build_slam_graph(state: SlamState, lm_cfg: LMConfig,
                     max_frames: Optional[int] = None,
                     max_objects: Optional[int] = None,
                     max_e2: Optional[int] = None,
                     max_e3: Optional[int] = None,
                     gravity_on: bool = True,
                     odometry_wc: Optional[np.ndarray] = None,
                     odo_weight: float = 1.0, device=None
                     ) -> Tuple[slam_ba.SlamGraph, list]:
    """Pack the recorded observations into a fixed-capacity SlamGraph on
    ``device`` (CUDA unless the caller names one).

    Returns (graph, instance order).  Capacities default to grow-only
    power-of-two tiers sized from the actual frame / object / edge counts,
    so -- like the reference, whose SLAM-mode vertex / edge loops are
    unbounded (Optimizer.cpp:126-158,175-180) -- nothing is silently
    dropped.  An explicit cap re-enables windowing: frames beyond
    ``max_frames`` use the most recent window, objects / edges past the
    caps are dropped, and every truncation is logged loudly.

    ``odometry_wc`` optionally gives a separate trajectory whose relative
    motions become the odometry measurements (e.g. wheel odometry); the
    default is the input trajectory itself.  ``odo_weight`` is the
    odometry sqrt-information (the reference uses identity information,
    Optimizer.cpp:153-156).
    """
    arrays, instances = pack_slam_graph(
        state, lm_cfg, max_frames=max_frames, max_objects=max_objects,
        max_e2=max_e2, max_e3=max_e3, gravity_on=gravity_on,
        odometry_wc=odometry_wc, odo_weight=odo_weight)
    return (slam_ba.graph_from_numpy(arrays, resolve_device(device)),
            instances)


def run_slam_mode(state: SlamState, K: np.ndarray, lm_cfg: LMConfig,
                  banded: bool = True, device=None, **kwargs):
    """Joint optimisation over the recorded run on ``device`` (CUDA unless
    the caller names one); returns (poses_wc [F,7] refined,
    {instance: vec10}, chi2).

    ``banded`` (default): the O(F K) block-tridiagonal + low-rank Schur
    solve; build_slam_graph emits the chain odometry it requires.  The
    graph and its segment plan are made on the host; the solve makes no
    host synchronisation, and its results come home in one copy at the
    end.
    """
    arrays, instances = pack_slam_graph(state, lm_cfg, **kwargs)
    dev = resolve_device(device)
    g = slam_ba.graph_from_numpy(arrays, dev)
    normal = (state.ground_plane[:3].astype(np.float32)
              if state.ground_plane is not None else np.zeros(3, np.float32))
    poses_cw, objects, chi2 = slam_ba.optimize_slam(
        g, torch.as_tensor(np.asarray(K, np.float32), device=dev),
        torch.as_tensor(normal, device=dev), lm_cfg, banded=banded)
    flat = torch.cat([poses_cw.flatten(), objects.flatten(),
                      chi2.reshape(1)]).cpu().numpy().astype(np.float64)
    n_p = poses_cw.numel()
    poses_cw = flat[:n_p].reshape(-1, 7)
    objects = flat[n_p:-1].reshape(-1, 10)
    F = min(len(state.frames_pose_wc), g.frame_mask.shape[0])
    poses_wc = np.stack([_np_se3_inv(p) for p in poses_cw[:F]])
    obj_map = {inst: objects[k] for k, inst in enumerate(instances)}
    return poses_wc, obj_map, float(flat[-1])
