"""Offline (throughput / batch) mapping mode.

Port of ``object_oriented_slam_tpu/system/offline.py``.  In mapping mode
the per-frame order of the reference (``Tracking.cpp:170-204``) is not a
data dependency of the extraction, which reads only the frame's pose,
depth and the latched ground plane.  This mapper processes a recorded
sequence by:

  1. bootstrapping the ground plane through the normal per-frame path
     (the state machine as online, Tracking.cpp:716-799),
  2. flattening every next B frames' detections into one batched
     extraction call (``frontend/batch_extractor.py``: the monolithic
     launches once a batch, or the split protocol, device phase A -> the
     host's union-find -> device phase B),
  3. keeping ``queue_depth`` batches in flight, so the device and the
     copies home overlap the host,
  4. feeding each frame's rows into the unchanged sequential SLAM core
     (association -> init -> global BA) in frame order
     (``Tracking.grab_pose_and_objects(ext_result=...)``).

With ``backend_per_batch`` (the default) the global BA runs once a batch,
on its last frame, instead of once a frame: its call's host enqueue is
paid once a batch too.  ``backend_per_batch=False`` keeps the reference's
per-frame schedule, and then the map is the online map's.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Iterable, Optional

import numpy as np

from ..frontend import batch_extractor as bx


class OfflineMapper:
    """Drives a ``System`` over a recorded sequence in batch mode, on the
    system's device.

    ``ext_cfg`` / ``cam``: the configuration and camera the online
    extractor was built with (the batches share its tier rules).
    ``split``: the device-A / host-cluster / device-B protocol
    (``split_quant``: phase A's copy home quantized to u16); it needs the
    host clustering library (``native/src/cluster.cpp``) and raises where
    it does not build.  ``mesh``: sharding the detection axis over devices
    is the distributed backend, not ported: it raises.
    """

    def __init__(self, system, cam, ext_cfg, batch_size: int = 8,
                 mesh=None, with_association: bool = True,
                 split: Optional[bool] = None, queue_depth: int = 2,
                 backend_per_batch: bool = True,
                 split_quant: bool = True):
        if mesh is not None:
            bx._mesh_unported()
        self.system = system
        self.cam = cam
        self.ext_cfg = ext_cfg
        self.batch_size = int(batch_size)
        if self.batch_size < 1:
            raise ValueError(f"batch_size={batch_size}")
        self.with_association = with_association
        # batches in flight between a stage's dispatch and the read of its
        # result (the copy home streams meanwhile)
        self.queue_depth = max(1, int(queue_depth))
        self.split = bool(split)
        if self.split:
            from ..io import native_loader
            if not native_loader.cluster_available():
                raise RuntimeError(
                    f"OfflineMapper(split=True): the host clustering "
                    f"library does not build from "
                    f"{native_loader.CLUSTER_SOURCE}: "
                    f"{native_loader.cluster_error()}")
        self.split_quant = bool(split_quant)
        # one global BA a batch, on its last frame (module docstring);
        # False: the reference's per-frame schedule
        self.backend_per_batch = backend_per_batch
        self.batches_dispatched = 0
        # each batch's call's counts (cloud tier, pad, symmetry counts and
        # the device's), filled as its result is read
        self.batch_stats = []

    def run(self, frames: Iterable, progress: Optional[callable] = None):
        """Process every frame (i, ts, pose, depth, rgb, det) of
        ``frames``; returns {frames, seconds, fps, batches}."""
        tracker = self.system.tracker
        # the history rows are needed only at the end: let the backend's
        # drains lag several batches (the LM warm-starts on the device), and
        # bootstrap the plane synchronously (the mapper drains between
        # bootstrap frames anyway)
        prev_depth, prev_adapt = tracker.pipeline_depth, \
            tracker.adaptive_depth
        prev_async = tracker.async_plane
        tracker.pipeline_depth = max(prev_depth, 4 * self.batch_size)
        tracker.adaptive_depth = False
        tracker.async_plane = False
        try:
            return self._run(tracker, frames, progress)
        finally:
            tracker.pipeline_depth = prev_depth
            tracker.adaptive_depth = prev_adapt
            tracker.async_plane = prev_async

    def _run(self, tracker, frames, progress):
        t0 = time.perf_counter()
        n = 0
        dev = tracker.device
        bucket = []        # frames accumulating toward one batch
        stage_a = deque()  # (recs, FrameBatch, BatchPhaseA)
        stage_b = deque()  # (recs, FrameBatch, ExtractionHandle)

        def advance_a():
            """The oldest phase-A batch: host middle stage and phase B.
            Its copy home has had the batches behind it to land."""
            recs, fb, h = stage_a.popleft()
            stage_b.append((recs, fb, bx.dispatch_batch_phase_b(
                fb, h, self.cam, dev)))

        def consume_b():
            recs, fb, handle = stage_b.popleft()
            out_np = bx.fetch_batch(handle)     # one copy home a batch
            self.batch_stats.append(handle.stats)
            # zip stops at the real frames; the zero pad frames of a tail
            # batch are left out
            opt_base = tracker.open_optimization
            try:
                for k, ((s, nn), (ts, pose, det, d)) in enumerate(
                        zip(fb.slices, recs)):
                    if self.backend_per_batch:
                        tracker.open_optimization = (
                            opt_base and k == len(recs) - 1)
                    tracker.grab_pose_and_objects(
                        ts, pose, det, d,
                        with_association=self.with_association,
                        ext_result=out_np[s:s + nn])
            finally:
                tracker.open_optimization = opt_base

        def flush_bucket():
            if not bucket:
                return
            recs = list(bucket)
            bucket.clear()
            packed = [(d, det[:, 1:5], det[:, 5].astype(int),
                       tracker.run_gates(det, self.with_association), pose)
                      for (_, pose, det, d) in recs]
            # a tail batch is padded with empty frames to the full batch
            # size, so every batch has the same B (and pad, min_pad = B)
            while len(packed) < self.batch_size:
                packed.append((np.zeros_like(packed[0][0]),
                               np.zeros((0, 4)), np.zeros(0, int),
                               np.zeros(0, bool), packed[0][4]))
            fb = bx.pack_frames_batch(
                self.cam, self.ext_cfg, packed, tracker.state.ground_plane,
                min_pad=self.batch_size)
            if self.split:
                stage_a.append((recs, fb, bx.dispatch_batch_phase_a(
                    fb, self.cam, quantized=self.split_quant, device=dev)))
                if len(stage_a) > self.queue_depth:
                    advance_a()
                if len(stage_b) > self.queue_depth:
                    consume_b()
            else:
                stage_b.append((recs, fb, bx.dispatch_batch(
                    fb, self.cam, device=dev)))
                if len(stage_b) > self.queue_depth:
                    consume_b()
            self.batches_dispatched += 1

        def drain():
            flush_bucket()
            while stage_a:
                advance_a()
            while stage_b:
                consume_b()

        for i, ts, pose, depth, rgb, det in frames:
            n += 1
            det = (np.asarray(det, np.float64).reshape(-1, 8)
                   if det is not None and np.asarray(det).size
                   else np.zeros((0, 8)))
            if tracker.state.ground_state != 2 or depth is None:
                # the plane's bootstrap and depth-free frames go through the
                # per-frame path, in order
                drain()
                tracker.grab_pose_and_objects(
                    ts, pose, det, depth,
                    with_association=self.with_association)
            else:
                # frames without a detection (or with every detection
                # gated) ride the batch too, with no rows
                bucket.append((ts, pose, det, depth))
                if len(bucket) >= self.batch_size:
                    flush_bucket()
            if progress is not None:
                progress(i)
        drain()
        tracker.sync()
        dt = time.perf_counter() - t0
        return {"frames": n, "seconds": dt,
                "fps": (n / dt if dt > 0 else 0.0),
                "batches": self.batches_dispatched}
