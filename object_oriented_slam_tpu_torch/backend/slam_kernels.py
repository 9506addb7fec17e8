"""Host side of K11, the SLAM edge kernel (``csrc/slam_edges.cu``).

``edge_terms`` launches the kernel's Jacobian instantiation over every
edge of a ``slam_ba.SlamGraph``: per edge the weighted residual and its
Jacobians with respect to the left-multiplied pose tangent(s) and the
object's 9-DoF tangent, what the JAX package's
``slam_ba._edge_terms_2d/3d/odo/grav`` compute (plain version:
``slam_ba.edge_terms_plain``).  ``chi2`` launches the float instantiation
of the same chains: the chi2 of the graph at (poses, objects), summed in
the launch (plain version: ``slam_ba._chi2_plain``).  Each entry point
has its launch counter (``EDGE_TERMS``, ``CHI2``).  The source builds the
Jacobian kernel at 1, 2, 3 and 5 tangent directions a thread;
``edge_terms`` launches it at ``LANES``, and ``edge_terms_at`` at any of
them, to hold them against each other and to time them.  The shared
library
is compiled with ``nvcc`` for ``sm_90a`` at first use into
``object_oriented_slam_tpu_torch/build/`` (``ops/_cuda_build.py``) and
bound with ctypes.  Each launch runs on PyTorch's current stream and does
not synchronise; outputs are allocated here.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from ..ops import _cuda_build
from ..ops._cuda_build import Kernel

SOURCE = os.path.join(_cuda_build.CSRC_DIR, "slam_edges.cu")
NVCC_FLAGS = list(_cuda_build.NVCC_FLAGS)

EDGE_TERMS = Kernel("slam_edge_terms")
CHI2 = Kernel("slam_chi2")
KERNELS = (EDGE_TERMS, CHI2)

CHI2_EDGES = 128       # edges of a block of the chi2 sum tree
LANES_BUILT = (1, 2, 3, 5)
LANES = 1              # tangent directions a thread of edge_terms' launch

_lib: Optional[ctypes.CDLL] = None
_tickets = {}    # (device index, stream) -> chi2's ticket counter
build_log = ""   # nvcc's output (ptxas register / spill report) of the build


def build() -> str:
    """Compile the kernel (if this source is not built yet); returns the
    path of the shared library."""
    global build_log
    lib_path, log = _cuda_build.build(SOURCE, tuple(NVCC_FLAGS))
    build_log = log or build_log
    return lib_path


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        p, i = ctypes.c_void_p, ctypes.c_int
        graph = [p] * 17 + [i] * 5          # pointers, then E2 E3 Eo K F
        lib.oslam_slam_edge_terms.argtypes = graph + [p] * 11 + [i, p]
        lib.oslam_slam_edge_terms.restype = i
        lib.oslam_slam_edge_terms_shape.argtypes = [i] * 5 + [p]
        lib.oslam_slam_edge_terms_shape.restype = i
        lib.oslam_slam_chi2.argtypes = graph + [p] * 3 + [p]
        lib.oslam_slam_chi2.restype = i
        lib.oslam_slam_error_string.argtypes = [i]
        lib.oslam_slam_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(poses, objects, g, K_mat, normal):
    """Validate device, dtype, shape and contiguity; returns the tensors in
    the kernel's argument order and (E2, E3, Eo, K, F)."""
    F, K = poses.shape[0], objects.shape[0]
    E2, E3, Eo = g.e2_w.shape[0], g.e3_w.shape[0], g.odo_w.shape[0]
    f32, i64 = torch.float32, torch.int64
    want = (
        ("poses", poses, (F, 7), f32), ("objects", objects, (K, 10), f32),
        ("K", K_mat, (3, 3), f32), ("normal", normal, (3,), f32),
        ("e2_frame", g.e2_frame, (E2,), i64), ("e2_obj", g.e2_obj, (E2,), i64),
        ("e2_bbox", g.e2_bbox, (E2, 4), f32), ("e2_w", g.e2_w, (E2,), f32),
        ("e3_frame", g.e3_frame, (E3,), i64), ("e3_obj", g.e3_obj, (E3,), i64),
        ("e3_meas", g.e3_meas, (E3, 10), f32), ("e3_w", g.e3_w, (E3,), f32),
        ("odo_i", g.odo_i, (Eo,), i64), ("odo_j", g.odo_j, (Eo,), i64),
        ("odo_meas", g.odo_meas, (Eo, 7), f32), ("odo_w", g.odo_w, (Eo,), f32),
        ("grav_w", g.grav_w, (K,), f32))
    dev = poses.device
    for name, t, shape, dtype in want:
        # one test on the launch path; which part failed only when one did
        if (t.dtype is dtype and t.shape == shape and t.is_contiguous()
                and t.device == dev and dev.type == "cuda"):
            continue
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the SLAM edge kernel "
                             f"takes tensors on one CUDA device ({dev})")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}; the SLAM edge kernel "
                            f"takes {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        raise ValueError(f"{name} is not contiguous")
    return [t for _, t, _, _ in want], (E2, E3, Eo, K, F)


def _launch(kernel, fn_name, device, args):
    """One launch on the current stream of ``device``; raises if the library
    does not build or the launch is refused."""
    lib = _load()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = getattr(lib, fn_name)(*args, stream)
    if rc != 0:
        msg = lib.oslam_slam_error_string(rc).decode()
        raise RuntimeError(f"{kernel.name} ({fn_name}) launch failed: CUDA "
                           f"error {rc} ({msg})")
    kernel.launches += 1


def launch_shape(E2, E3, Eo, K, lanes=LANES):
    """(threads a block, blocks, threads dealt) of the Jacobian launch on a
    graph of these counts at ``lanes`` tangent directions a thread."""
    out = (ctypes.c_longlong * 3)()
    if _load().oslam_slam_edge_terms_shape(E2, E3, Eo, K, lanes, out):
        raise ValueError(f"the SLAM edge kernel takes no launch of {lanes} "
                         f"lanes")
    return tuple(out)


def edge_terms(poses, objects, g, K_mat, normal):
    """(r2 [E2,4], Jp2 [E2,4,6], Jo2 [E2,4,9], r3 [E3,9], Jp3 [E3,9,6],
    Jo3 [E3,9,9], ro [Eo,6], Ji [Eo,6,6], Jj [Eo,6,6], rg [K,1],
    Jg [K,1,9]) by one launch of the kernel's Jacobian instantiation."""
    return edge_terms_at(poses, objects, g, K_mat, normal)


def edge_terms_at(poses, objects, g, K_mat, normal, lanes=LANES):
    """``edge_terms`` by the Jacobian kernel built at ``lanes`` tangent
    directions a thread (one of LANES_BUILT).  Every instantiation
    computes the same bits."""
    tensors, (E2, E3, Eo, K, F) = _check(poses, objects, g, K_mat, normal)
    dev = poses.device
    shapes = ((E2, 4), (E2, 4, 6), (E2, 4, 9), (E3, 9), (E3, 9, 6),
              (E3, 9, 9), (Eo, 6), (Eo, 6, 6), (Eo, 6, 6), (K, 1), (K, 1, 9))
    outs = [torch.empty(s, dtype=torch.float32, device=dev) for s in shapes]
    if E2 + E3 + Eo + K > 0:
        _launch(EDGE_TERMS, "oslam_slam_edge_terms", dev,
                [t.data_ptr() for t in tensors] + [E2, E3, Eo, K, F]
                + [t.data_ptr() for t in outs] + [lanes])
    return tuple(outs)


def _ticket(device):
    """The chi2 launches' ticket counter on the current stream of
    ``device``: zeroed when first asked for; every launch leaves it at
    zero, and launches on one stream run in turn."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    done = _tickets.get(key)
    if done is None:
        done = _tickets[key] = torch.zeros(1, dtype=torch.int32,
                                           device=device)
    return done


def chi2(poses, objects, g, K_mat, normal):
    """chi2 [] of the graph by one launch of the kernel's float
    instantiation: each edge's gated sum of squares, summed in a fixed
    tree (CHI2_EDGES edges a block of the tree, in order; the blocks'
    sums in block order) that the last block to finish completes.  The
    call is that one device operation."""
    tensors, (E2, E3, Eo, K, F) = _check(poses, objects, g, K_mat, normal)
    dev = poses.device
    n_blocks = 4 * max(1, -(-(E2 + E3 + Eo + K) // CHI2_EDGES))
    partial = torch.empty(n_blocks, dtype=torch.float32, device=dev)
    done = _ticket(dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    _launch(CHI2, "oslam_slam_chi2", dev,
            [t.data_ptr() for t in tensors] + [E2, E3, Eo, K, F]
            + [partial.data_ptr(), done.data_ptr(), out.data_ptr()])
    return out
