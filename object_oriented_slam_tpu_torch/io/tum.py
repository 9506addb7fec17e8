"""TUM RGB-D dataset loader.

Port of ``object_oriented_slam_tpu/io/tum.py``, the host-side (numpy)
re-design of the reference's ``src/tum_rgbd/io.cpp``:
  * frames enumerated from ``rgb/``, sorted numerically by timestamp stem
    (dataprocess_utils.cpp:25-69)
  * ``groundtruth.txt`` rows ``ts x y z qx qy qz qw`` (io.cpp:156-172)
  * ``associate.txt`` rgb<->depth association (io.cpp:174-207)
  * ``associateGroundtruth.txt`` rgb<->gt association with the trailing
    two-digit precision trim (io.cpp:209-244)
  * timestamp matching at 1 ms tolerance (io.cpp:97-123)
  * per-frame detections from ``bbox/<rgb_ts>.txt`` rows
    ``id x1 y1 x2 y2 label rate instanceID`` (io.cpp:277-290)
  * optional external odometry with SE3 alignment of the first frame to the
    groundtruth (io.cpp:327-418)

Images: the 16-bit depth PNG is decoded in numpy over ``zlib``
(``io/png.py``, no ``cv2``), ahead of the consumer in a thread pool
(lookahead 8, 4 threads, as the JAX package's native loader); or, with
``decoder="native"``, by ``native/lib/liboslam_native.so`` through
``io/native_loader.py``, which raises where that library does not load.
Nothing on the mapping path reads RGB, so it is decoded only with
``with_rgb=True``: a PNG in numpy, a JPEG with ``cv2`` (without ``cv2`` a
JPEG raises).
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from .png import read_png


def _quat_mul_np(q1, q2):
    x1, y1, z1, w1 = q1
    x2, y2, z2, w2 = q2
    return np.array([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ])


def _quat_rotate_np(q, v):
    qv, w = q[:3], q[3]
    t = 2.0 * np.cross(qv, v)
    return v + w * t + np.cross(qv, t)


def _se3_mul_np(a, b):
    t = a[:3] + _quat_rotate_np(a[3:], b[:3])
    q = _quat_mul_np(a[3:], b[3:])
    return np.concatenate([t, q / np.linalg.norm(q)])


def _se3_inv_np(a):
    qi = a[3:] * np.array([-1.0, -1.0, -1.0, 1.0])
    return np.concatenate([-_quat_rotate_np(qi, a[:3]), qi])


class _StampIndex:
    """Sorted-timestamp index for 1 ms-tolerance association: a bisect over
    a sorted float array per lookup (the reference scans every timestamp,
    io.cpp:97-123); the nearest entry within the tolerance wins."""

    def __init__(self, mapping: Dict[str, object]):
        self.keys = sorted(mapping, key=float)
        self.times = np.array([float(k) for k in self.keys], np.float64)
        self.mapping = mapping

    def lookup(self, stamp, tol: float = 0.001):
        t = float(stamp)
        i = int(np.searchsorted(self.times, t))
        best, best_d = None, tol
        for j in (i - 1, i):
            if 0 <= j < len(self.times):
                d = abs(float(self.times[j]) - t)
                if d < best_d:
                    best, best_d = self.keys[j], d
        return self.mapping[best] if best is not None else None


def _read_rows(path: str) -> List[List[str]]:
    rows = []
    if not os.path.exists(path):
        return rows
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append(line.replace(",", " ").split())
    return rows


def read_rgb(path: str) -> np.ndarray:
    """An RGB frame as uint8 [H, W, 3] BGR: a PNG in numpy, anything else
    (the TUM sequences' JPEGs) with ``cv2``, which must then be there."""
    if path.lower().endswith(".png"):
        return read_png(path)
    try:
        import cv2
    except ImportError:
        raise RuntimeError(
            f"{path}: decoding a JPEG needs cv2, which is not installed "
            "(the port's numpy decoder reads PNG only)") from None
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise RuntimeError(f"{path}: cv2 could not decode the image")
    return img


# the decode-ahead window of the JAX package's native loader
PREFETCH_THREADS, PREFETCH_LOOKAHEAD = 4, 8


class _Prefetcher:
    """Decode frames ahead of a sequential consumer in a thread pool:
    ``get(i)`` returns frame i's decode and keeps the frames after it, up to
    PREFETCH_LOOKAHEAD, in flight (frames behind the consumer are
    dropped)."""

    def __init__(self, decode, n: int):
        self._decode = decode
        self._n = n
        self._pool = ThreadPoolExecutor(PREFETCH_THREADS,
                                        thread_name_prefix="tum-decode")
        self._futures = {}

    def get(self, index: int):
        for k in [k for k in self._futures if k < index]:
            self._futures.pop(k).cancel()
        for k in range(index, min(self._n, index + PREFETCH_LOOKAHEAD)):
            if k not in self._futures:
                self._futures[k] = self._pool.submit(self._decode, k)
        return self._futures.pop(index).result()

    def close(self):
        for f in self._futures.values():
            f.cancel()
        self._futures.clear()
        self._pool.shutdown(wait=True)


class TUMDataset:
    """Sequential access to a TUM RGB-D sequence with detections.

    ``decoder``: "numpy" (default; ``io/png.py`` in a prefetching thread
    pool) or "native" (``native/lib/liboslam_native.so``'s prefetching
    loader; raises where the library does not load).  ``with_rgb``: decode
    the RGB frames too (otherwise ``rgb`` is None).
    """

    def __init__(self, dataset_dir: str, detection_dir: Optional[str] = None,
                 decoder: str = "numpy", with_rgb: bool = False):
        if decoder not in ("numpy", "native"):
            raise ValueError(f"decoder={decoder!r}: 'numpy' or 'native'")
        self.dir = dataset_dir.rstrip("/") + "/"
        self.rgb_dir = self.dir + "rgb/"
        self.depth_dir = self.dir + "depth/"
        self.detection_dir = detection_dir or (self.dir + "bbox/")
        self.with_rgb = with_rgb

        rgb_files = [f for f in os.listdir(self.rgb_dir)]
        rgb_files.sort(key=lambda s: float(os.path.splitext(s)[0]))
        self.rgb_files = rgb_files
        self.rgb_stamps = [os.path.splitext(f)[0] for f in rgb_files]
        self.total = len(rgb_files)

        self.gt: Dict[str, np.ndarray] = {}
        for row in _read_rows(self.dir + "groundtruth.txt"):
            self.gt[row[0]] = np.array([float(v) for v in row[1:8]], np.float64)

        # rgb ts -> (depth ts, depth path)
        self.rgb_to_depth: Dict[str, Tuple[str, str]] = {}
        for row in _read_rows(self.dir + "associate.txt"):
            self.rgb_to_depth[row[0]] = (row[2], row[3])

        # rgb ts -> gt ts (trim last 2 digits, io.cpp:221-223)
        self.rgb_to_gt: Dict[str, str] = {}
        for row in _read_rows(self.dir + "associateGroundtruth.txt"):
            self.rgb_to_gt[row[0]] = row[2][:-2]

        self.current = 0
        self.odometry: Optional[Dict[str, np.ndarray]] = None
        self._gt_idx = _StampIndex(self.gt)
        self._depth_idx = _StampIndex(self.rgb_to_depth)
        self._gt_ts_idx = _StampIndex(self.rgb_to_gt)
        self._odom_idx: Optional[_StampIndex] = None

        self._native = None
        self._prefetch = None
        if decoder == "native":
            from . import native_loader as nl
            if not nl.native_available():
                raise RuntimeError(
                    f"decoder='native': {nl.LIBRARY} does not load here "
                    "(it links libpng and libjpeg); use decoder='numpy'")
            self._native = nl.PrefetchingLoader(
                [self._depth_path(i) or "" for i in range(self.total)],
                [self._rgb_path(i) if with_rgb else ""
                 for i in range(self.total)])
        else:
            self._prefetch = _Prefetcher(self._decode, self.total)

    def _depth_path(self, index: int) -> Optional[str]:
        dp = self._depth_idx.lookup(self.rgb_stamps[index])
        return os.path.join(self.dir, dp[1]) if dp else None

    def _rgb_path(self, index: int) -> str:
        return os.path.join(self.rgb_dir, self.rgb_files[index])

    def _decode(self, index: int):
        """(depth u16 [H, W], rgb [H, W, 3] BGR or None) of frame index."""
        path = self._depth_path(index)
        depth = read_png(path) if path and os.path.exists(path) else None
        rgb = read_rgb(self._rgb_path(index)) if self.with_rgb else None
        return depth, rgb

    def close(self):
        """Stop the decoding threads."""
        if self._prefetch is not None:
            self._prefetch.close()
            self._prefetch = None
        if self._native is not None:
            self._native.close()
            self._native = None

    def pose_for(self, index: int) -> Optional[np.ndarray]:
        rgb_ts = self.rgb_stamps[index]
        if self._odom_idx is not None:
            return self._odom_idx.lookup(rgb_ts)
        gt_ts = self._gt_ts_idx.lookup(rgb_ts)
        if gt_ts is None:
            return None
        return self._gt_idx.lookup(gt_ts)

    def read_frame(self, index: int):
        """Returns (timestamp, pose7[w<-c], depth u16, rgb u8 or None) or
        None."""
        if index < 0 or index >= self.total:
            return None
        rgb_ts = self.rgb_stamps[index]
        pose = self.pose_for(index)
        if pose is None or self._depth_path(index) is None:
            return None
        if self._native is not None:
            out = self._native.get(index)
            if out is None:
                return None
            depth, rgb = out
            rgb = rgb if self.with_rgb else None
        else:
            depth, rgb = self._prefetch.get(index)
        if depth is None:
            return None
        return float(rgb_ts), pose.astype(np.float64), depth, rgb

    def detections(self, index: int) -> np.ndarray:
        """Detection matrix rows: id x1 y1 x2 y2 label rate instanceID
        (io.cpp:277-290). Empty (0, 8) if file missing."""
        path = os.path.join(self.detection_dir, self.rgb_stamps[index] + ".txt")
        rows = _read_rows(path)
        if not rows:
            return np.zeros((0, 8), np.float64)
        return np.array([[float(v) for v in r] for r in rows], np.float64)

    def frames(self):
        """Iterate valid frames: yields (index, ts, pose, depth, rgb, detmat)."""
        for i in range(self.total):
            out = self.read_frame(i)
            if out is None:
                continue
            ts, pose, depth, rgb = out
            yield i, ts, pose, depth, rgb, self.detections(i)

    # -- sequential-access API parity (io.cpp:50-61,292-325,420-441) ------
    def valid_indices(self):
        """Frames with both a depth association and a pose
        (generateValidVector, io.cpp:292-325)."""
        return [i for i in range(self.total)
                if self._depth_path(i) is not None
                and self.pose_for(i) is not None]

    def set_current(self, index: int) -> None:
        """SetCurrentID (io.cpp:420-431)."""
        if 0 <= index < self.total:
            self.current = index

    def empty(self) -> bool:
        return self.current >= self.total

    def read_next(self):
        """readFrame-style sequential access (io.cpp:50-61): returns
        (index, ts, pose, depth, rgb, detections) or None and advances."""
        while self.current < self.total:
            i = self.current
            self.current += 1
            out = self.read_frame(i)
            if out is not None:
                ts, pose, depth, rgb = out
                return i, ts, pose, depth, rgb, self.detections(i)
        return None

    # -- odometry (io.cpp:327-418) ---------------------------------------
    def set_odometry(self, odom_path: str, calibrate: bool = True) -> bool:
        rows = _read_rows(odom_path)
        if not rows:
            return False
        odom = {r[0]: np.array([float(v) for v in r[1:8]], np.float64)
                for r in rows}
        if calibrate:
            # align first odometry pose to the groundtruth of its frame
            trans = None
            odom_idx = _StampIndex(odom)
            for idx, stamp in enumerate(self.rgb_stamps):
                gt_pose = self.pose_for(idx)
                odom_pose = odom_idx.lookup(stamp)
                if gt_pose is not None and odom_pose is not None:
                    trans = _se3_mul_np(gt_pose, _se3_inv_np(odom_pose))
                    break
            if trans is not None:
                odom = {k: _se3_mul_np(trans, v) for k, v in odom.items()}
        self.odometry = odom
        self._odom_idx = _StampIndex(odom)
        return True
