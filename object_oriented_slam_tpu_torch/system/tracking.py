"""Per-frame pipeline orchestrator with the deferred frame pipeline.

Port of ``object_oriented_slam_tpu/system/tracking.py`` (the reference's
``src/core/Tracking.cpp``): the host drives the frame loop and appends
observations into fixed-capacity numpy buffers; the per-frame ellipsoid
extraction (``frontend/extractor.py``) and the global object-graph LM
(``backend/lm_soa.py``) run on ``device`` (their hot stages are the CUDA
kernels on a CUDA device).

Per-frame flow (GrabPoseAndObjects, Tracking.cpp:170-204):
  1. record frame; once, estimate and latch the ground plane
     (Tracking.cpp:716-799)
  2. UpdateObjectObservation (:493-564): single-frame ellipsoid
     extraction of every gated detection (with an extractor and a depth
     image), data association (manual column 7, or automatic by the 3D
     estimates' world centres), key-observation gating, store the 3D and
     2D observations
  3. JudgeInitialization (:566-638): incremental SVD init on the host,
     or directly from the latest 3D estimate
  4. ProcessCurrentFrame (:219-257): the LM over all observations, warm
     started from the previous call's estimate kept on the device

The pipeline keeps that per-frame order and those inputs; only the moment
the host reads a device result moves, so results do not depend on the
depth:
  * extraction deferral: frame t's extraction is launched at once, its
    result's copy home starts with it (``MonolithicExtractor.run``), and
    the host-side half of the frame (steps 2-4) runs ``pipeline_depth`` - 1
    frames later, when the copy has usually landed;
  * backend chaining: each LM call starts from the previous call's device
    estimate; its copy home starts at dispatch behind an event and is
    drained (history, outputs) once ``pipeline_depth`` later calls have
    been dispatched;
  * the asynchronous one-shot plane: the frame that estimates the plane
    defers its whole body to the next grab (or ``sync()``), where the
    plane is read and the frame replayed first;
  * the adaptive depth: 4 by default, one deeper (up to 8) after three
    blocked fetches in a row (> 3 ms), one shallower (down to the set
    depth) after 16 free ones (< 1 ms).
Every host-to-device copy of a frame comes from pinned memory and every
device-to-host copy lands in pinned memory behind an event
(``utils/transfer.py``): the host waits for the device only on the due
frame's fetch, the backend drain and the plane's resolve.
``pipeline_depth = 1`` is the eager loop.  ``sync()`` flushes everything.

The extractor may also be host-clustered (``frontend.SplitExtractor``,
``FusedSplitExtractor``):
  * a two-phase extractor's call launches phase A only; ``_midway_due``
    runs its host middle stage and phase B ``pipeline_depth // 2`` frames
    later (or at the frame's processing, eagerly or at a flush);
  * a fused extractor's ``step`` launches this frame's phase A and the
    phase B of a frame ``chain_lag`` frames older, whose result is kept by
    frame id (``_ext_results``) until that frame is processed; frames that
    launch nothing ``drain`` the due ones.
``fuse_lm`` (LM fusion, JAX ``Tracking.fuse_lm``): with a deferred
pipeline, the due frame is processed before this frame's extraction, its
LM batch packed but not launched (``defer_backend``), and the extraction
call issues it (``dispatch_with_lm`` / ``step_with_lm``).  Every wait
these add is on a pinned copy's event.

A frame may also bring its extraction result, precomputed by the offline
batch mapper (``ext_result``, ``system/offline.py``): the frame then
launches no extraction and its host-side half reads those rows.

``enable_distributed(mesh)`` shards the LM call's observation axis over
a mesh's ranks (``parallel/dist_lm.py``); LM fusion is off while a mesh is
set, as in the JAX package.

The backend is ``lm_soa.optimize_objects_soa`` unless ``use_soa_backend``
is False when the tracker is built (then the AoS ``lm.optimize_objects``;
the flag is read once, in ``__init__``, as in the JAX package); the 2D
initialization is the host's incremental SVD unless
``use_incremental_init`` is set False (then the batch SVD initializer
``init.init_quadric_svd`` on the device, one host fetch per attempt).
``Visualization.Builder.Open: 1`` builds a ``DenseBuilder`` fed by every
frame body with a depth image.  ``Plane.MannualCheck.Open: 1`` offers
each estimated plane to ``plane_manual_check_fn`` (a terminal Y/N on a
tty, else accepted) before it latches.
"""
from __future__ import annotations

import logging
import math
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..assoc import (InstanceCounter, associate_observations,
                     associate_observations_optimal)
from ..backend import (LMConfig, ObjectObservations, observations_from_flat,
                       optimize_objects, optimize_objects_soa)
from ..core import camera as cam_mod
from ..core import plane as plane_mod
from ..init import init_quadric_svd
from ..init.svd_incremental import IncrementalQuadricInit
from ..io.config import Config
from ..utils import calibrate_measurement_np
from ..utils.device import indexed_device, resolve_device
from ..utils.transfer import HostCopy, to_device
from .state import SlamState

_log = logging.getLogger("object_oriented_slam_tpu_torch")

# sentinel: this frame's extraction ran under the fused protocol; the
# result is (or will be) in Tracking._ext_results[frame_id]
_FUSED_PENDING = object()


def _np_se3_inv(p):
    q = p[3:] * np.array([-1.0, -1, -1, 1])
    w = q[3]
    t = p[:3]
    qv = q[:3]
    tt = 2.0 * np.cross(qv, -t)
    rt = -t + w * tt + np.cross(qv, tt)
    return np.concatenate([rt, q])


def _np_se3_mul(a, b):
    qa, qb = a[3:], b[3:]
    x1, y1, z1, w1 = qa
    x2, y2, z2, w2 = qb
    q = np.array([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ])
    qv, w = qa[:3], qa[3]
    t2 = 2.0 * np.cross(qv, b[:3])
    tb = b[:3] + w * t2 + np.cross(qv, t2)
    return np.concatenate([a[:3] + tb, q / np.linalg.norm(q)])


def _shared_opt_fn(use_soa: bool):
    """The LM call the tracker's ``_opt_fn`` is (JAX ``_shared_opt_fn``):
    the SoA solver, or the AoS one."""
    return optimize_objects_soa if use_soa else optimize_objects


def _shared_init_fn(rows: int, cols: int):
    """The batch SVD initializer packed as [11] (vec10, ok), so that an
    attempt costs one host fetch (JAX ``_shared_init_fn``)."""
    def init_packed(p, b, m, K):
        res = init_quadric_svd(p, b, m, K, rows, cols)
        return torch.cat([res.ellipsoid,
                          res.ok.to(res.ellipsoid.dtype)[None]])
    return init_packed


def _default_plane_check(plane_world) -> bool:
    """Tracking.cpp:758-772: print the plane, ask Y/N on the terminal.
    Non-interactive runs auto-accept (the reference would block forever
    on getchar)."""
    import sys
    print(f"Estimated ground plane: {np.round(plane_world, 4)}")
    if not sys.stdin.isatty():
        return True
    ans = input("Accept ground plane? [Y/n] ").strip().lower()
    return ans in ("", "y", "yes")


class Tracking:
    """Host orchestrator of the mapping loop on ``device`` (the CUDA device
    unless the caller passes one, e.g. ``device="cpu"``).

    ``extractor``: optional single-frame ellipsoid estimation
    (``frontend.make_extractor``, ``make_split_extractor`` or
    ``make_fused_extractor``): ``extractor(depth, bboxes[N,4], labels[N],
    pose_wc7, ground_plane_vec4)`` returns a handle that
    ``extractor.fetch`` turns into the [pad, 12] host result (vec10, prob,
    valid); a two-phase extractor's handle goes through
    ``extractor.midway`` first, a fused extractor is driven by ``step``.
    ``plane_estimator``: optional
    callable ``depth -> plane vec4 (camera frame) | None``
    (``frontend.make_plane_estimator``).
    """

    # capacities of the batched backend call: MAX_OBJECTS is the initial
    # object tier (grows 24 -> 48 -> ... on demand, like the reference's
    # unbounded instance count); the observation axes are ring windows
    MAX_OBJECTS = 24
    MAX_OBS2D = 512
    MAX_OBS3D = 256

    def __init__(self, config: Config, extractor=None, plane_estimator=None,
                 device=None):
        self.cfg = config
        self.device = resolve_device(device)
        self.camera = cam_mod.Camera(
            fx=config.get_float("Camera.fx"),
            fy=config.get_float("Camera.fy"),
            cx=config.get_float("Camera.cx"),
            cy=config.get_float("Camera.cy"),
            scale=config.get_float("Camera.scale"),
            width=config.get_int("Camera.width", 640),
            height=config.get_int("Camera.height", 480),
        )
        self.K = self.camera.K
        self._K_dev = torch.as_tensor(self.K, device=self.device)
        self.rows = self.camera.height
        self.cols = self.camera.width
        self.state = SlamState()
        self.extractor = extractor
        self.plane_estimator = plane_estimator
        # interactive ground-plane confirmation (Tracking.cpp:758-772): when
        # open, the estimated plane is offered to ``plane_manual_check_fn``
        # (default: terminal Y/N when stdin is a tty, auto-accept
        # otherwise); a rejection keeps the estimation state machine at 1,
        # so the next frame retries
        self.plane_manual_check = config.get_int(
            "Plane.MannualCheck.Open") == 1
        self.plane_manual_check_fn = _default_plane_check
        self.da_counter = InstanceCounter()
        self.open_optimization = True
        self.depth_ellipsoid_opened = extractor is not None

        self.lm_cfg = LMConfig(
            scale_3d=config.get_float("Optimizer.Edges.3DEllipsoid.Scale", 1.0),
            gravity_scale=config.get_float("Optimizer.Edges.GravityPrior.Scale", 1.0),
            gravity_on=config.get_int("Optimizer.Edges.GravityPrior.Open") == 1,
            check_visibility=config.get_int(
                "Optimizer.Edges.2DProjection.CheckVisibility") == 1,
            vis_rows=self.rows, vis_cols=self.cols,
        )
        self.border_px = config.get_int("Measurement.Border.Pixels")
        self.length_limit_px = config.get_int("Measurement.LengthLimit.Pixels")
        self.min_init_frames = int(config.read_value(
            "Tracking_MINIMUM_INITIALIZATION_FRAME"))
        self.keyframe_check_close = config.get_int(
            "Tracking.KeyFrameCheck.Close") == 1
        self.use_optimal_assoc = config.get_int(
            "Tracking.DataAssociation.Optimal") == 1
        # per-optimizer-run object_list.txt dump (Optimizer.cpp:308-316)
        self.write_object_list = config.get_int(
            "Optimizer.WriteObjectList.Open") == 1
        self.object_list_path = "./object_list.txt"

        # dense visualization map driven by the config key exactly like
        # Tracking.cpp:234-250 (absent key -> 0 -> off)
        self.dense_builder = None
        if config.get_int("Visualization.Builder.Open") == 1:
            from .dense_builder import DenseBuilder
            self.dense_builder = DenseBuilder(self.camera, device=self.device)

        # the backend: read once, here, as in the JAX package (a later
        # assignment of the flag changes nothing; ROADMAP queue 3)
        self.use_soa_backend = True
        self._opt_fn = _shared_opt_fn(self.use_soa_backend)
        # host-side incremental SVD init; the batch initializer on the
        # device behind the flag (packed [11] result, one fetch an attempt)
        self.use_incremental_init = True
        self._inc_init = IncrementalQuadricInit(self.K, self.rows, self.cols)
        self._init_fn = _shared_init_fn(self.rows, self.cols)
        # the pipeline (module docstring); the JAX package's defaults.
        # ``pipeline_depth`` is a property: setting it pins the depth and
        # re-bases the adaptive controller, which moves ``_pipeline_depth``
        # itself and never goes below the base
        self.pipeline_depth = 4
        self.adaptive_depth = True
        self.adapt_depth_max = 8
        self.adapt_deepen_s = 3e-3
        self.adapt_shallow_s = 1e-3
        self._adapt_fetches = deque(maxlen=16)
        self._saturation_logged = False
        self._flushing = False     # sync(): its fetches do not adapt
        self.async_plane = True
        self._pending_plane = None
        self._plane_deferred: List[tuple] = []
        self._pending_extraction = deque()
        # LM fusion (off by default, as in the JAX package; the CLI's
        # probe turns it on for a local device)
        self.fuse_lm = False
        self._deferred_lm = None
        self._mesh = None          # set by enable_distributed
        self._ext_results: Dict[int, object] = {}  # fused-protocol results
        # (call_no, its HostCopy, slots, nobs)
        self._pending_backends = deque()
        self._backend_calls = 0
        self.max_objects = self.MAX_OBJECTS  # current object-axis tier
        self._init_np_buffers()
        # per-frame instrumentation (host seconds): "dispatch" the
        # extraction call's launches, "fetch" the wait for a frame's
        # extraction result (its copy's event) and its conversion, "host"
        # the host-side half of a frame, "plane_wait" the asynchronous
        # plane's resolve; ``depth_trace`` the depth at each frame
        self.metrics: Dict[str, List[float]] = {"backend": [], "frontend": [],
                                                "total": [], "dispatch": [],
                                                "fetch": [], "host": [],
                                                "plane_wait": []}
        self.depth_trace: List[int] = []

    # ------------------------------------------------------------------
    @property
    def pipeline_depth(self) -> int:
        return self._pipeline_depth

    @pipeline_depth.setter
    def pipeline_depth(self, value: int):
        """Pin the deferral window and re-base the adaptive controller."""
        self._pipeline_depth = int(value)
        self._depth_base = int(value)
        if hasattr(self, "_adapt_fetches"):
            self._adapt_fetches.clear()

    # ------------------------------------------------------------------
    def open_ground_plane_estimation(self):
        """Tracking.cpp:690-703."""
        self.state.ground_state = 1

    def enable_distributed(self, mesh=None):
        """Shard the mapping-mode backend over a mesh (JAX
        ``Tracking.enable_distributed``): the LM call becomes the
        observation-sharded ``parallel.dist_lm.optimize_objects_sharded``,
        each rank on its slice of the observation tiers, with the same
        iterates up to the order of the sums.  ``mesh`` defaults to
        ``parallel.multihost.observation_mesh`` on this tracker's device
        (call ``multihost.initialize`` first); it must live on this
        device (an unindexed ``cuda`` is the current card).  Every rank
        drives the same frames.  LM fusion is off while a mesh is set."""
        from ..parallel.multihost import observation_mesh
        mesh = mesh if mesh is not None else observation_mesh(self.device)
        if indexed_device(mesh.device) != indexed_device(self.device):
            raise ValueError(f"the mesh's device {mesh.device} is not the "
                             f"tracker's {self.device}")
        self._mesh = mesh
        from ..parallel.dist_lm import optimize_objects_sharded

        def fn(obs, K, normal, gset, cfg):
            return optimize_objects_sharded(obs, K, normal, gset, mesh, cfg)

        self._opt_fn = fn

    # ------------------------------------------------------------------
    def grab_pose_and_objects(self, timestamp: float, pose_wc: np.ndarray,
                              det_mat: np.ndarray, depth: Optional[np.ndarray],
                              rgb: Optional[np.ndarray] = None,
                              with_association: bool = True,
                              ext_result=None) -> bool:
        """One frame of the pipeline (System::TrackWithObjects entry).

        ``depth``: [H, W] integer depth image (TUM scale) or None; ``rgb``
        [H, W, 3] (BGR) or None feeds the dense builder, when one is on.
        ``ext_result``: the frame's extraction rows [n, 12] on the host
        (vec10, prob, valid), precomputed by the offline batch mapper's
        batched call; the frame then launches no extraction.
        """
        # a plane estimate dispatched by an earlier frame: read it and
        # replay that frame's body first, before this frame's t0 (the wait
        # and the replayed body carry their own metric entries)
        self._resolve_pending_plane()
        t0 = time.perf_counter()
        pose_wc = np.asarray(pose_wc, np.float64)
        frame_id = len(self.state.frames_pose_wc)
        self.state.frames_pose_wc.append(pose_wc)
        self.state.frames_ts.append(timestamp)
        det_mat = np.asarray(det_mat, np.float64).reshape(-1, 8) \
            if det_mat is not None and det_mat.size else np.zeros((0, 8))
        # ---- [1.1] ground plane estimation (once) ---------------------
        if self.state.ground_state == 1 and self.plane_estimator is not None \
                and depth is not None:
            if (self.async_plane and self.pipeline_depth >= 2
                    and hasattr(self.plane_estimator, "dispatch")):
                # queue the estimate and its copy home, and defer this
                # frame's whole body to the next grab (or sync())
                self._pending_plane = (self.plane_estimator.dispatch(depth),
                                       pose_wc)
                self._plane_deferred.append(
                    (frame_id, pose_wc, det_mat, depth, rgb,
                     with_association, ext_result))
                return True
            plane_cam = self.plane_estimator(depth)
            if plane_cam is not None:
                self._latch_plane(plane_cam, pose_wc)
            # else: state stays 1, retry next frame (Tracking.cpp:766-771)
        return self._frame_body(frame_id, pose_wc, det_mat, depth, rgb,
                                with_association, t0, ext_result)

    # ------------------------------------------------------------------
    def _latch_plane(self, plane_cam, pose_wc):
        """World-transform + manual check + latch (Tracking.cpp:723-771),
        in float32 on the host like the JAX package.  A rejected plane
        leaves ground_state at 1: the next frame estimates again (an
        asynchronous estimate's deferred frames replay without a plane)."""
        pw = plane_mod.transform(
            torch.as_tensor(np.asarray(plane_cam, np.float32)),
            torch.as_tensor(pose_wc.astype(np.float32)))
        pw = pw.numpy().astype(np.float64)
        if self.plane_manual_check and not self.plane_manual_check_fn(pw):
            return
        self.state.ground_plane = pw
        self.state.ground_state = 2

    # ------------------------------------------------------------------
    def _resolve_pending_plane(self):
        """Read an asynchronous plane estimate and replay the frames that
        waited for it, in order.  On a failed estimate they replay without
        a plane (ground_state stays 1), which skips their extraction as the
        reference's state machine does while estimation is open."""
        if self._pending_plane is None:
            return
        handle, disp_pose = self._pending_plane
        self._pending_plane = None
        t0 = time.perf_counter()
        plane_cam = self.plane_estimator.resolve(handle)
        if plane_cam is not None:
            self._latch_plane(plane_cam, disp_pose)
        self.metrics["plane_wait"].append(time.perf_counter() - t0)
        deferred, self._plane_deferred = self._plane_deferred, []
        for fid, pw, dm, dep, rgb, wa, er in deferred:
            self._frame_body(fid, pw, dm, dep, rgb, wa, time.perf_counter(),
                             er)

    # ------------------------------------------------------------------
    def _frame_body(self, frame_id, pose_wc, det_mat, depth, rgb,
                    with_association, t0, ext_result=None):
        """Everything after ground-plane handling for one frame: the
        extraction's launches, the dense builder's fuse, then the host-side
        half of this frame (eager) or of the frames now due (deferred)."""
        # ---- [1.2] single-frame ellipsoid estimation (dispatch) --------
        n_det = det_mat.shape[0]
        ext_out = None
        run = np.zeros(n_det, bool)
        if (self.depth_ellipsoid_opened or ext_result is not None) \
                and depth is not None and n_det > 0 \
                and self.state.ground_state == 2:
            run[:] = self.run_gates(det_mat, with_association)
            if ext_result is not None:
                # the offline batch mapper's rows: no dispatch
                ext_out = ext_result if np.any(run) else None
            elif np.any(run):
                ext_out = self._dispatch_extraction(
                    frame_id, pose_wc, depth, det_mat[:, 1:5].copy(),
                    det_mat[:, 5].astype(int))
        if ext_out is None and getattr(self.extractor, "fused", False):
            # a frame that launches no extraction: the fused chain's due
            # frames run their phase B now (their copies landed long ago)
            self._ext_results.update(self.extractor.drain(frame_id))
        # dense visualization map (Tracking.cpp:234-250, config-gated)
        if self.dense_builder is not None and depth is not None:
            self.dense_builder.process_frame(rgb, depth, pose_wc)
        self.metrics["dispatch"].append(time.perf_counter() - t0)
        item = [frame_id, pose_wc, det_mat, ext_out, run, with_association]
        if self.pipeline_depth >= 2 and self.extractor is not None:
            self._pending_extraction.append(item)
            self._midway_due()
            # `while`, not `if`: a shallower adaptive depth drains the
            # surplus.  _midway_due after every pop: a two-item drain moves
            # the queue by 2 and the midway index by 1
            while len(self._pending_extraction) >= self.pipeline_depth:
                self._process_frame_obs(*self._pending_extraction.popleft())
                self._midway_due()
            # the backend time is recorded by the deferred processing
            t1 = t2 = t3 = time.perf_counter()
        else:
            self._process_frame_obs(*item)
            t1, t2, t3 = self._t1, self._t2, self._t3
            self.metrics["backend"].append(t3 - t2)
        self.metrics["frontend"].append(t1 - t0)
        self.metrics["total"].append(t3 - t0)
        self.depth_trace.append(self.pipeline_depth)
        return True

    def _dispatch_extraction(self, frame_id, pose_wc, depth, bboxes, labels):
        """The frame's extraction call.  With ``fuse_lm`` the due frame is
        processed FIRST, its LM batch packed, not launched, so that this
        frame's extraction call issues it (it is consumed one call earlier
        than by the pop in ``_frame_body``).  Returns the extraction's
        handle, ``_FUSED_PENDING`` for a fused extractor or None."""
        ex = self.extractor
        gp = self.state.ground_plane
        self._deferred_lm = None
        if (self.fuse_lm and self.pipeline_depth >= 2
                and self._mesh is None
                and getattr(ex, "supports_lm_fusion", False)
                and len(self._pending_extraction)
                >= self.pipeline_depth - 1):
            self._process_frame_obs(*self._pending_extraction.popleft(),
                                    defer_backend=True)
        prep, self._deferred_lm = self._deferred_lm, None
        if getattr(ex, "fused", False):
            # the results delivered now belong to EARLIER frames
            if prep is not None:
                ran, results, est, _ = ex.step_with_lm(
                    frame_id, depth, bboxes, labels, pose_wc, gp,
                    self._lm_args(prep))
                if est is not None:
                    self._finish_backend(prep, est)
                    prep = None
            else:
                ran, results = ex.step(frame_id, depth, bboxes, labels,
                                       pose_wc, gp)
            self._ext_results.update(results)
            ext_out = _FUSED_PENDING if ran else None
        elif prep is not None:
            res = ex.dispatch_with_lm(depth, bboxes, labels, pose_wc, gp,
                                      self._lm_args(prep))
            ext_out = None
            if res is not None:
                ext_out, est, _ = res
                self._finish_backend(prep, est)
                prep = None
        else:
            ext_out = ex(depth, bboxes, labels, pose_wc, gp)
        if prep is not None:
            # the call could not carry the prepared LM: launch it alone
            self._dispatch_prepared(prep)
        return ext_out

    def _midway_due(self):
        """Two-phase extractor: the host middle stage and phase B of the
        item ``pipeline_depth // 2`` frames behind the queue's head (its
        phase-A copy has had that long to land; phase B gets the rest of
        the window)."""
        if not getattr(self.extractor, "two_phase", False):
            return
        k = len(self._pending_extraction) - 1 - max(
            1, self.pipeline_depth // 2)
        if k >= 0:
            it = self._pending_extraction[k]
            if getattr(it[3], "is_phase_a", False):
                it[3] = self.extractor.midway(it[3])

    # ------------------------------------------------------------------
    def run_gates(self, det_mat, with_association: bool) -> np.ndarray:
        """Extraction gates c1 (bbox on border) and c3 (invalid manual
        association), Tracking.cpp:313-327."""
        n_det = det_mat.shape[0]
        run = np.ones(n_det, bool)
        for i in range(n_det):
            _, is_border = calibrate_measurement_np(
                det_mat[i, 1:5].copy(), self.rows, self.cols,
                self.border_px, self.length_limit_px)
            if is_border:
                run[i] = False
            if with_association and det_mat[i, 7] < 0:
                run[i] = False
        return run

    # ------------------------------------------------------------------
    def _process_frame_obs(self, frame_id, pose_wc, det_mat, ext_out, run,
                           with_association, defer_backend=False):
        """Host-side half of a frame: fetch the extraction result,
        associate, store observations, initialize, dispatch the backend.
        With ``pipeline_depth`` >= 2 it runs ``pipeline_depth`` - 1 frames
        after the frame's dispatch, with the same inputs.
        ``defer_backend``: pack the LM batch into ``_deferred_lm`` instead
        of launching it (LM fusion: the next extraction call issues it)."""
        tp0 = time.perf_counter()
        if ext_out is _FUSED_PENDING:
            ext_out = self._ext_results.pop(frame_id, None)
            if ext_out is None:
                # not delivered by a later step yet: flush the chain
                self._ext_results.update(self.extractor.flush())
                ext_out = self._ext_results.pop(frame_id)
        elif getattr(ext_out, "is_phase_a", False):
            # a two-phase handle not taken midway (eager, or a flush)
            ext_out = self.extractor.midway(ext_out)
        n_det = det_mat.shape[0]
        local_vec10 = np.zeros((n_det, 10))
        local_prob = np.zeros(n_det)
        local_valid = np.zeros(n_det, bool)

        # ---- fetch the extraction result -----------------------------
        # the extractor returned None or the call's handle, whose copy home
        # started at dispatch: the wait is what is left of the frame's
        # kernels and copy.  The call's counts (clustering rounds, lanes)
        # ride the same copy into its stats
        ext_np = None
        if isinstance(ext_out, np.ndarray):
            ext_np = np.asarray(ext_out, np.float64)   # precomputed rows
        elif ext_out is not None:
            ext_np = self.extractor.fetch(ext_out)
        fetch_s = time.perf_counter() - tp0
        self.metrics["fetch"].append(fetch_s)
        if ext_np is not None and self.pipeline_depth >= 2:
            self._adapt_depth(fetch_s)
        if ext_np is not None:
            # the extractor may return fewer rows than detections (its
            # detection-axis capacity); the overflow keeps 2D-only obs
            n_rows = min(n_det, ext_np.shape[0])
            if n_rows < n_det and np.any(run[n_rows:]):
                _log.warning(
                    "extractor returned %d rows for %d detections; "
                    "detections beyond the capacity keep 2D-only "
                    "observations", n_rows, n_det)
            r = run[:n_rows]
            local_vec10[:n_rows][r] = ext_np[:n_rows][r, :10]
            local_prob[:n_rows][r] = ext_np[:n_rows][r, 10]
            local_valid[:n_rows][r] = ext_np[:n_rows][r, 11] > 0.5

        # drain the backend results whose copies have had their window
        # (the warm start stays on the device; the host copy feeds the
        # history and the outputs only)
        self._drain_ready_backends()

        # ---- [1.3] data association ----------------------------------
        if with_association:
            associations = [int(round(det_mat[i, 7])) for i in range(n_det)]
        else:
            # automatic: by world-center distance to map objects
            centers = np.zeros((n_det, 3))
            for i in range(n_det):
                if local_valid[i]:
                    world = _np_se3_mul(pose_wc, local_vec10[i, :7])
                    centers[i] = world[:3]
            inst_ids = self.state.initialized_instances()
            map_centers = np.array([self.state.objects[i].vec10[:3]
                                    for i in inst_ids]).reshape(-1, 3)
            assoc_fn = (associate_observations_optimal
                        if self.use_optimal_assoc else associate_observations)
            associations = assoc_fn(
                centers, local_valid, inst_ids, map_centers, self.da_counter)

        # ---- [1.4] key-observation gating (Tracking.cpp:421-475) ------
        kf_checks = self._check_keyframes(associations, pose_wc)

        # ---- [1.5] store observations --------------------------------
        pose_cw = _np_se3_inv(pose_wc)
        for i in range(n_det):
            inst = associations[i]
            if inst < 0 or not kf_checks[i]:
                continue
            # 3D observation
            if local_valid[i]:
                rec = self.state.record(inst)
                rec.obs3d_pose_wc.append(pose_wc)
                rec.obs3d_meas.append(local_vec10[i])
                rec.obs3d_prob.append(float(local_prob[i]))
                rec.obs3d_frame.append(frame_id)
                if rec.label < 0:
                    rec.label = int(det_mat[i, 5])
                self._append_obs3d(inst, pose_wc, local_vec10[i],
                                   float(local_prob[i]))
            # 2D observation
            meas = det_mat[i, 1:5].copy()
            meas_cal, is_border = calibrate_measurement_np(
                meas, self.rows, self.cols, self.border_px,
                self.length_limit_px)
            if is_border:
                continue
            rec = self.state.record(inst)
            rec.obs2d_pose_cw.append(pose_cw)
            rec.obs2d_pose_wc.append(pose_wc)
            rec.obs2d_bbox.append(meas_cal)
            rec.obs2d_prob.append(float(det_mat[i, 6]))
            rec.obs2d_frame.append(frame_id)
            if rec.label < 0:
                rec.label = int(det_mat[i, 5])
            self._append_obs2d(inst, pose_cw, meas_cal, float(det_mat[i, 6]))
            if self.use_incremental_init and not rec.initialized:
                self._inc_init.add_observation(inst, pose_wc, meas_cal)

        self._t1 = time.perf_counter()

        # ---- [2] initialization (Tracking.cpp:566-638) ----------------
        self._judge_initialization()

        # ---- [3] global optimization ----------------------------------
        self._t2 = time.perf_counter()
        if self.open_optimization and self.state.initialized_instances():
            if defer_backend:
                self._deferred_lm = self._prepare_backend()
            else:
                self._run_backend()
        self._t3 = time.perf_counter()
        self.metrics["host"].append(self._t3 - tp0)
        if self.pipeline_depth >= 2 and self.extractor is not None:
            # a deferred frame: the grab recorded its dispatch only
            self.metrics["backend"].append(self._t3 - self._t2)

    # ------------------------------------------------------------------
    def _adapt_depth(self, fetch_s: float):
        """Adjust the depth from the wait of the due frame's fetch: three
        blocked fetches in a row (> ``adapt_deepen_s``) deepen it by one up
        to ``adapt_depth_max``; a full window of free ones (<
        ``adapt_shallow_s``) makes it one shallower, down to the set
        depth."""
        if not self.adaptive_depth or self._flushing:
            # sync()'s fetches read copies that never had their window
            return
        w = self._adapt_fetches
        w.append(fetch_s)
        recent = list(w)
        blocked = len(recent) >= 3 and min(recent[-3:]) > self.adapt_deepen_s
        if (blocked and self._pipeline_depth >= self.adapt_depth_max
                and not self._saturation_logged):
            self._saturation_logged = True
            _log.info("extraction fetches still block at the maximum "
                      "pipeline depth (%d)", self.adapt_depth_max)
        if blocked and self._pipeline_depth < self.adapt_depth_max:
            self._pipeline_depth += 1
            w.clear()
        elif (len(recent) == w.maxlen
                and max(recent) < self.adapt_shallow_s
                and self._pipeline_depth > self._depth_base):
            self._pipeline_depth -= 1
            w.clear()

    # ------------------------------------------------------------------
    def _check_keyframes(self, associations, pose_wc) -> List[bool]:
        if self.keyframe_check_close:
            dis_th, ang_th = 0.0, 0.0
        else:
            dis_th, ang_th = 0.4, math.pi / 180.0 * 15  # Tracking.cpp:433-434
        checks = []
        for inst in associations:
            if inst < 0:
                checks.append(False)
                continue
            rec = self.state.objects.get(inst)
            if rec is None or not rec.obs2d_pose_wc:
                checks.append(True)
                continue
            last = rec.obs2d_pose_wc[-1]
            diff = _np_se3_mul(_np_se3_inv(pose_wc), last)
            dis = float(np.linalg.norm(diff[:3]))
            w = np.clip(abs(diff[6]), -1, 1)
            angle = 2.0 * math.acos(min(1.0, w))
            checks.append(dis > dis_th or angle > ang_th)
        return checks

    # ------------------------------------------------------------------
    def _judge_initialization(self):
        # 2D SVD path: the host's incremental initializer, or the batch one
        for inst, rec in self.state.objects.items():
            if rec.initialized or len(rec.obs2d_bbox) < self.min_init_frames:
                continue
            if self.use_incremental_init:
                vec10 = self._inc_init.try_init(inst)
                if vec10 is not None:
                    rec.vec10 = vec10
                    rec.initialized = True
                    self._inc_init.drop(inst)
                continue
            # padded to the next power of two from 16, as the JAX package
            # pads for its compiled shapes
            M = len(rec.obs2d_bbox)
            cap = 16
            while cap < M:
                cap *= 2
            poses = np.zeros((cap, 7), np.float32)
            bboxes = np.full((cap, 4), -1.0, np.float32)
            mask = np.zeros(cap, bool)
            poses[:M] = np.stack(rec.obs2d_pose_wc).astype(np.float32)
            bboxes[:M] = np.stack(rec.obs2d_bbox).astype(np.float32)
            mask[:M] = True
            dev = self.device
            res = self._init_fn(to_device(poses, dev), to_device(bboxes, dev),
                                to_device(mask, dev), self._K_dev)
            res = res.cpu().numpy().astype(np.float64)   # the one fetch
            if res[10] > 0.5:
                rec.vec10 = res[:10]
                rec.initialized = True

        # 3D path: seed directly from the latest local estimate
        if self.depth_ellipsoid_opened:
            for inst, rec in self.state.objects.items():
                if rec.initialized or not rec.obs3d_meas:
                    continue
                pose_wc = rec.obs3d_pose_wc[-1]
                local = rec.obs3d_meas[-1]
                world_pose = _np_se3_mul(pose_wc, local[:7])
                rec.vec10 = np.concatenate([world_pose, local[7:]])
                rec.initialized = True
                rec.init_by_3d = True
                self._inc_init.drop(inst)

    # ------------------------------------------------------------------
    # Incremental backend buffers: observations are written in place into
    # preallocated [O, M, ...] arrays (ring window once a slot's capacity
    # is exceeded -- edge order is irrelevant to the LM).
    def _init_np_buffers(self):
        O, M2, M3 = self.max_objects, self.MAX_OBS2D, self.MAX_OBS3D
        self._slot_of: Dict[int, int] = {}
        self._slot_to_instance = []
        # one contiguous float32 block; the named buffers are views into
        # it, so a batch ships to the device as one transfer
        shapes = {
            "est0": (O, 10), "objmask": (O,), "useprev": (O,),
            "p2": (O, M2, 7), "b2": (O, M2, 4), "pr2": (O, M2),
            "m2": (O, M2),
            "p3": (O, M3, 7), "me3": (O, M3, 10), "pr3": (O, M3),
            "m3": (O, M3),
        }
        total = sum(int(np.prod(v)) for v in shapes.values())
        self._b_flat = np.zeros(total, np.float32)
        self._b_views = {}
        off = 0
        for name, shp in shapes.items():
            n = int(np.prod(shp))
            self._b_views[name] = self._b_flat[off:off + n].reshape(shp)
            off += n
        v = self._b_views
        v["est0"][:] = np.array([0, 0, 0, 0, 0, 0, 1, 1, 1, 1], np.float32)
        v["p2"][:] = np.array([0, 0, 0, 0, 0, 0, 1], np.float32)
        v["b2"][:] = -1.0
        v["p3"][:] = np.array([0, 0, 0, 0, 0, 0, 1], np.float32)
        v["me3"][:] = np.array([0, 0, 0, 0, 0, 0, 1, 1, 1, 1], np.float32)
        self._b_n2 = np.zeros(O, np.int64)
        self._b_n3 = np.zeros(O, np.int64)
        # device-side warm start: est0 of call k is the device output of
        # call k-1 for slots already in the previous batch
        self._est_prev_dev: Optional[torch.Tensor] = None
        self._prev_batch_slots: set = set()

    def _slot_for(self, inst: int):
        slot = self._slot_of.get(inst)
        if slot is None:
            if len(self._slot_of) >= self.max_objects:
                self._grow_object_tier()
            slot = len(self._slot_of)
            self._slot_of[inst] = slot
        return slot

    def _grow_object_tier(self):
        """Double the object-axis capacity (24 -> 48 -> 96 -> ...): contents
        copied over, the device warm-start estimate zero-padded (new slots
        have useprev=0 so the pad is never read)."""
        old_views = {k: v.copy() for k, v in self._b_views.items()}
        old_n2, old_n3 = self._b_n2, self._b_n3
        old_state = (dict(self._slot_of), list(self._slot_to_instance),
                     set(self._prev_batch_slots), self._est_prev_dev)
        O_old = self.max_objects
        self.max_objects = O_old * 2
        _log.info("growing backend object tier %d -> %d", O_old,
                  self.max_objects)
        self._init_np_buffers()
        for name, v in self._b_views.items():
            v[:O_old] = old_views[name]
        self._b_n2[:O_old] = old_n2
        self._b_n3[:O_old] = old_n3
        (self._slot_of, self._slot_to_instance,
         self._prev_batch_slots, est_prev) = old_state
        if est_prev is not None:
            self._est_prev_dev = torch.cat(
                [est_prev, est_prev.new_zeros(self.max_objects - O_old, 10)])

    def _append_obs2d(self, inst, pose_cw, bbox, prob):
        slot = self._slot_for(inst)
        v = self._b_views
        i = int(self._b_n2[slot] % self.MAX_OBS2D)
        v["p2"][slot, i] = pose_cw
        v["b2"][slot, i] = bbox
        v["pr2"][slot, i] = prob
        v["m2"][slot, i] = 1.0
        self._b_n2[slot] += 1

    def _append_obs3d(self, inst, pose_wc, meas_vec10, prob):
        slot = self._slot_for(inst)
        v = self._b_views
        i = int(self._b_n3[slot] % self.MAX_OBS3D)
        v["p3"][slot, i] = pose_wc
        v["me3"][slot, i] = meas_vec10
        v["pr3"][slot, i] = prob
        v["m3"][slot, i] = 1.0
        self._b_n3[slot] += 1

    @staticmethod
    def _next_pow2(n, lo, hi):
        cap = lo
        while cap < min(n, hi):
            cap *= 2
        return cap

    @staticmethod
    def _lm_layout(O: int, M2t: int, M3t: int):
        """Packed-batch layout: ((name, offset, shape), ...)."""
        shapes = [("est0", (O, 10)), ("objmask", (O,)), ("useprev", (O,)),
                  ("p2", (O, M2t, 7)), ("b2", (O, M2t, 4)),
                  ("pr2", (O, M2t)), ("m2", (O, M2t)),
                  ("p3", (O, M3t, 7)), ("me3", (O, M3t, 10)),
                  ("pr3", (O, M3t)), ("m3", (O, M3t))]
        layout = []
        off = 0
        for name, shp in shapes:
            layout.append((name, off, shp))
            off += int(np.prod(shp))
        return tuple(layout)

    def _pack_backend_batch(self):
        """Pack the current observation state into the flat f32 batch at
        the smallest power-of-two observation tier that holds it.

        Returns (flat np, est_prev device, O, M2t, M3t); also refreshes
        ``_slot_to_instance`` / ``_prev_batch_slots``.
        """
        v = self._b_views
        self._slot_to_instance = []
        v["objmask"][:] = 0.0
        v["useprev"][:] = 0.0
        cur_slots = set()
        for inst in sorted(self.state.initialized_instances()):
            slot = self._slot_of.get(inst)
            if slot is None:
                continue
            cur_slots.add(slot)
            if slot in self._prev_batch_slots \
                    and self._est_prev_dev is not None:
                v["useprev"][slot] = 1.0
            else:
                v["est0"][slot] = self.state.objects[inst].vec10.astype(
                    np.float32)
            v["objmask"][slot] = 1.0
            self._slot_to_instance.append((slot, inst))
        self._prev_batch_slots = cur_slots
        est_prev = self._est_prev_dev
        if est_prev is None:
            est_prev = torch.zeros((self.max_objects, 10), dtype=torch.float32,
                                   device=self.device)

        # ring buffers fill their prefix until they wrap, so slicing
        # [:, :Mt] covers every stored entry
        f2 = int(min(self._b_n2.max(initial=0), self.MAX_OBS2D))
        f3 = int(min(self._b_n3.max(initial=0), self.MAX_OBS3D))
        M2t = self._next_pow2(f2, 64, self.MAX_OBS2D)
        M3t = self._next_pow2(f3, 32, self.MAX_OBS3D)
        flat_t = np.concatenate([
            v["est0"].ravel(), v["objmask"].ravel(), v["useprev"].ravel(),
            v["p2"][:, :M2t].ravel(), v["b2"][:, :M2t].ravel(),
            v["pr2"][:, :M2t].ravel(), v["m2"][:, :M2t].ravel(),
            v["p3"][:, :M3t].ravel(), v["me3"][:, :M3t].ravel(),
            v["pr3"][:, :M3t].ravel(), v["m3"][:, :M3t].ravel()])
        return flat_t, est_prev, self.max_objects, M2t, M3t

    def _unpack(self, prep) -> ObjectObservations:
        """One host->device copy of the packed batch (from pinned memory,
        no wait), then views into it."""
        return observations_from_flat(
            to_device(prep["flat"], self.device), prep["est_prev"],
            self._lm_layout(prep["O"], prep["M2t"], prep["M3t"]))

    def _lm_args(self, prep):
        """A prepared batch as the extractor's LM fusion takes it: (flat on
        the device, est_prev, K, normal, gset, layout, lm_cfg)."""
        return (to_device(prep["flat"], self.device), prep["est_prev"],
                self._K_dev, to_device(prep["normal"], self.device),
                prep["gset"],
                self._lm_layout(prep["O"], prep["M2t"], prep["M3t"]),
                self.lm_cfg)

    def restore_state(self, state: SlamState):
        """Resume from a checkpointed SlamState (system/checkpoint.py).

        Rebuilds what the checkpoint does not carry: the backend
        observation buffers (replayed in first-observation order, so slot
        assignment matches the original run), the incremental-init Gram
        matrices of uninitialized instances, and the association counter.
        Call on a freshly constructed Tracking.
        """
        self.state = state
        self._init_np_buffers()

        def first_frame(rec):
            f2 = rec.obs2d_frame[0] if rec.obs2d_frame else 1 << 60
            f3 = rec.obs3d_frame[0] if rec.obs3d_frame else 1 << 60
            return min(f2, f3)

        for inst in sorted(state.objects,
                           key=lambda i: (first_frame(state.objects[i]), i)):
            rec = state.objects[inst]
            for pose_cw, pose_wc, bbox, prob in zip(
                    rec.obs2d_pose_cw, rec.obs2d_pose_wc, rec.obs2d_bbox,
                    rec.obs2d_prob):
                self._append_obs2d(inst, pose_cw, bbox, prob)
                if self.use_incremental_init and not rec.initialized:
                    self._inc_init.add_observation(inst, pose_wc, bbox)
            for pose_wc, meas, prob in zip(rec.obs3d_pose_wc, rec.obs3d_meas,
                                           rec.obs3d_prob):
                self._append_obs3d(inst, pose_wc, meas, prob)
        if state.objects:
            self.da_counter.seed(max(state.objects) + 1)

    def _prepare_backend(self):
        """Pack the LM batch; returns the dict _dispatch_prepared takes."""
        flat_t, est_prev, O, M2t, M3t = self._pack_backend_batch()
        gset = self.state.ground_plane is not None
        normal = (self.state.ground_plane[:3].astype(np.float32)
                  if gset else np.zeros(3, np.float32))
        # the per-instance observation counts NOW: the history row written
        # at drain time pairs frame-t estimates with frame-t counts
        # (RefreshObjectHistory semantics, Tracking.cpp:810-852)
        nobs = {inst: len(self.state.objects[inst].obs2d_bbox)
                for _, inst in self._slot_to_instance}
        return {"flat": flat_t, "est_prev": est_prev, "O": O, "M2t": M2t,
                "M3t": M3t, "gset": gset, "normal": normal, "nobs": nobs,
                "slots": list(self._slot_to_instance)}

    def _dispatch_prepared(self, prep):
        """The LM call of a prepared batch, launched alone."""
        obs = self._unpack(prep)
        normal = to_device(prep["normal"], self.device)
        est, _chi2 = self._opt_fn(obs, self._K_dev, normal, prep["gset"],
                                  self.lm_cfg)
        self._finish_backend(prep, est)

    def _finish_backend(self, prep, est):
        """After any LM launch: the next LM call chains from this device
        tensor; its copy home (history/outputs) starts now and is drained
        ``pipeline_depth`` calls later."""
        self._est_prev_dev = est
        self._backend_calls += 1
        self._pending_backends.append(
            (self._backend_calls, HostCopy.start(est), prep["slots"],
             prep["nobs"]))

    def _run_backend(self):
        self._dispatch_prepared(self._prepare_backend())

    def _drain_ready_backends(self, all_pending: bool = False):
        """Apply pending backend results in dispatch order: those at least
        ``pipeline_depth`` calls old, or all of them at sync points."""
        while self._pending_backends:
            age = self._backend_calls - self._pending_backends[0][0]
            if not all_pending and age < self.pipeline_depth:
                break
            _, copy, slot_to_instance, nobs = self._pending_backends.popleft()
            est = copy.wait().numpy().astype(np.float64)
            for slot, inst in slot_to_instance:
                self.state.objects[inst].vec10 = est[slot]
            self._refresh_history(nobs)
            if self.write_object_list:
                # per-optimizer-run dump (Optimizer.cpp:308-316)
                from ..io.writers import save_object_list
                insts = sorted(inst for _, inst in slot_to_instance)
                save_object_list(
                    self.object_list_path, insts,
                    np.stack([self._np_to_minimal(
                        self.state.objects[i].vec10) for i in insts]),
                    [self.state.objects[i].label for i in insts])

    def sync(self):
        """Flush the pipeline: resolve a pending plane, run the fused
        chain's pending phase B, process the deferred frames in order,
        drain every backend result."""
        self._resolve_pending_plane()
        self._flushing = True
        try:
            if getattr(self.extractor, "fused", False):
                # phase B of every frame still in the fused chain
                self._ext_results.update(self.extractor.flush())
            while self._pending_extraction:
                self._process_frame_obs(*self._pending_extraction.popleft())
            self._drain_ready_backends(all_pending=True)
        finally:
            self._flushing = False

    # ------------------------------------------------------------------
    @staticmethod
    def _np_to_minimal(vec10):
        """Host-side vec10 -> vec9 (xyz, roll-pitch-yaw, scales)."""
        qx, qy, qz, qw = vec10[3:7]
        roll = np.arctan2(2 * (qw * qx + qy * qz), 1 - 2 * (qx * qx + qy * qy))
        pitch = np.arcsin(np.clip(2 * (qw * qy - qz * qx), -1.0, 1.0))
        yaw = np.arctan2(2 * (qw * qz + qx * qy), 1 - 2 * (qy * qy + qz * qz))
        return np.concatenate([vec10[:3], [roll, pitch, yaw], vec10[7:]])

    def _refresh_history(self, nobs: Dict[int, int]):
        """Tracking.cpp:810-852 (nobs = obs counts at optimization time)."""
        for inst in sorted(nobs):
            rec = self.state.objects[inst]
            vec9 = self._np_to_minimal(rec.vec10)
            n_obs = nobs[inst]
            row = np.concatenate([[n_obs, 1], vec9])
            if rec.history and int(rec.history[-1][0]) == n_obs:
                rec.history[-1] = row
            else:
                rec.history.append(row)
