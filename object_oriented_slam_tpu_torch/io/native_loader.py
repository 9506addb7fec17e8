"""ctypes bindings of the repository's native code.

Port of ``object_oriented_slam_tpu/io/native_loader.py``, in two parts:

* the frame decoder, over the committed ``native/lib/liboslam_native.so``
  (``native/src/tum_loader.cpp``: a threaded-prefetch PNG / JPEG decoder on
  libpng and libjpeg).  The port never builds that library and never
  writes into ``native/``: where it does not load (a machine without libpng
  or libjpeg), ``native_available()`` is False and every decoder entry
  point raises instead of falling back;
* the host clustering of the split extractors (``native/src/cluster.cpp``:
  grid-hash connected components, the C++ standard library only), built
  from that source alone at first use with the host C++ compiler into
  ``object_oriented_slam_tpu_torch/build/`` (``ops/_cuda_build.build_host``:
  named by the hash of source and flags, an atomic rename) and bound from
  there.  ``cluster_available()`` says whether it builds and loads,
  ``cluster_error()`` why not; ``cluster_labels`` raises with the
  compiler's error.
"""
from __future__ import annotations

import ctypes
import os
from typing import List

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LIBRARY = os.path.join(_REPO, "native", "lib", "liboslam_native.so")
CLUSTER_SOURCE = os.path.join(_REPO, "native", "src", "cluster.cpp")
_LIB = None
_LOAD_ERROR = None
_CLUSTER_LIB = None
_CLUSTER_ERROR = None


def _load_lib():
    global _LIB, _LOAD_ERROR
    if _LIB is not None or _LOAD_ERROR is not None:
        return _LIB
    try:
        lib = ctypes.CDLL(LIBRARY)
        lib.oslam_cluster_labels      # the current library has all five
    except (OSError, AttributeError) as e:
        _LOAD_ERROR = str(e)
        return None
    lib.oslam_loader_create.restype = ctypes.c_void_p
    lib.oslam_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.oslam_loader_get.restype = ctypes.c_int
    lib.oslam_loader_get.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.oslam_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.oslam_decode_depth.restype = ctypes.c_int
    lib.oslam_decode_depth.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint16),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.oslam_decode_rgb.restype = ctypes.c_int
    lib.oslam_decode_rgb.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    _LIB = lib
    return lib


def native_available() -> bool:
    """Whether the committed frame-decoder library loads."""
    return _load_lib() is not None


def _lib():
    lib = _load_lib()
    if lib is None:
        raise RuntimeError(f"{LIBRARY} does not load: {_LOAD_ERROR}")
    return lib


def _load_cluster():
    """Build ``native/src/cluster.cpp`` (once per source and flags) and
    bind ``oslam_cluster_labels``; None with ``_CLUSTER_ERROR`` set when
    the build or the load fails."""
    global _CLUSTER_LIB, _CLUSTER_ERROR
    if _CLUSTER_LIB is not None or _CLUSTER_ERROR is not None:
        return _CLUSTER_LIB
    from ..ops import _cuda_build
    try:
        lib = ctypes.CDLL(_cuda_build.build_host(CLUSTER_SOURCE)[0])
        fn = lib.oslam_cluster_labels
    except (OSError, RuntimeError, AttributeError) as e:
        _CLUSTER_ERROR = str(e)
        return None
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_float, ctypes.POINTER(ctypes.c_int32)]
    _CLUSTER_LIB = lib
    return lib


def cluster_available() -> bool:
    """Whether the host clustering library builds from
    ``native/src/cluster.cpp`` and loads (built at the first call)."""
    return _load_cluster() is not None


def cluster_error() -> str:
    """Why the host clustering library is unavailable ("" when it is
    not)."""
    _load_cluster()
    return _CLUSTER_ERROR or ""


def cluster_labels(pts: np.ndarray, mask: np.ndarray,
                   tol: float) -> np.ndarray:
    """Grid-hash union-find connected components (native/src/cluster.cpp).

    pts: [N, 3] float32; mask: [N] bool.  Returns int32 labels [N] with
    the ops/cluster.py convention (label = min point index in component,
    masked points -> N)."""
    lib = _load_cluster()
    if lib is None:
        raise RuntimeError(f"the host clustering library "
                           f"({CLUSTER_SOURCE}) is unavailable: "
                           f"{_CLUSTER_ERROR}")
    pts = np.ascontiguousarray(pts, np.float32)
    m = np.ascontiguousarray(mask, np.uint8)
    n = len(pts)
    out = np.empty(n, np.int32)
    rc = lib.oslam_cluster_labels(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, ctypes.c_float(tol),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        raise RuntimeError(f"oslam_cluster_labels returned {rc}")
    return out


def decode_depth(path: str, max_hw=(480, 640)) -> np.ndarray:
    """A 16-bit gray PNG as uint16 [H, W] (libpng)."""
    buf = np.zeros(max_hw, np.uint16)
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = _lib().oslam_decode_depth(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise RuntimeError(f"{path}: the native decoder returned {rc}")
    return buf[:h.value, :w.value].copy()


def decode_rgb(path: str, max_hw=(480, 640)) -> np.ndarray:
    """An 8-bit RGB PNG or a JPEG as uint8 [H, W, 3] BGR (cv2's order)."""
    buf = np.zeros((*max_hw, 3), np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = _lib().oslam_decode_rgb(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise RuntimeError(f"{path}: the native decoder returned {rc}")
    # native gives RGB; repo convention (cv2) is BGR
    return buf[:h.value, :w.value, ::-1].copy()


class PrefetchingLoader:
    """Threaded-prefetch sequential frame reader (4 threads, lookahead 8).
    An empty RGB path skips that frame's RGB decode."""

    def __init__(self, depth_paths: List[str], rgb_paths: List[str],
                 n_threads: int = 4, lookahead: int = 8,
                 max_hw=(480, 640)):
        lib = _lib()
        self._lib = lib
        n = len(depth_paths)
        self._dp = (ctypes.c_char_p * n)(*[p.encode() for p in depth_paths])
        self._rp = (ctypes.c_char_p * n)(*[p.encode() for p in rgb_paths])
        self._handle = lib.oslam_loader_create(self._dp, self._rp, n,
                                               n_threads, lookahead)
        self._max_hw = max_hw

    def get(self, index: int):
        """Returns (depth u16 [H,W], rgb u8 [H,W,3] BGR) or None."""
        depth = np.zeros(self._max_hw, np.uint16)
        rgb = np.zeros((*self._max_hw, 3), np.uint8)
        h, w = ctypes.c_int(), ctypes.c_int()
        rc = self._lib.oslam_loader_get(
            self._handle, index,
            depth.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.byref(h), ctypes.byref(w))
        if rc != 0:
            return None
        return (depth[:h.value, :w.value].copy(),
                rgb[:h.value, :w.value, ::-1].copy())

    def close(self):
        if self._handle:
            self._lib.oslam_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
