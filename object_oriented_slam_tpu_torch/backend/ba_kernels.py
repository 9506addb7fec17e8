"""Host side of the bundle-adjustment edge kernels (``csrc/ba_edges.cu``).

``normal_eq`` and ``chi2`` launch the hand-written CUDA kernels that
replace the Pallas kernels K1-K4 of ``attic/pallas_ba_kernels.py``; their
plain PyTorch versions are ``lm_soa.soa_normal_eq_plain`` and
``lm_soa.soa_chi2_plain``.  ``lm_solve_step`` and ``lm_accept_step`` launch
the same two kernels with their LM epilogues (plain versions
``lm_soa.lm_solve_step_plain`` / ``lm_accept_step_plain``), so that one LM
iteration is two launches.  The shared library is compiled with ``nvcc``
for ``sm_90a`` at first use into ``object_oriented_slam_tpu_torch/build/``
(``ops/_cuda_build.py``: named by the source's hash, so an edited source
rebuilds) and bound with ctypes.  Each launch runs on PyTorch's current
stream and does not synchronise; outputs are allocated here with
``torch.empty``.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from ..ops import _cuda_build
from ..ops._cuda_build import Kernel  # noqa: F401  (the counters' type)

SOURCE = os.path.join(_cuda_build.CSRC_DIR, "ba_edges.cu")
NVCC_FLAGS = list(_cuda_build.NVCC_FLAGS)   # a caller may add a -D flag

NORMAL_EQ = Kernel("ba_normal_eq")
CHI2 = Kernel("ba_chi2")
KERNELS = (NORMAL_EQ, CHI2)

_lib: Optional[ctypes.CDLL] = None
build_log = ""   # nvcc's output (ptxas register / spill report) of the build


def build() -> str:
    """Compile the kernels (if this source is not built yet); returns the
    path of the shared library."""
    global build_log
    lib_path, log = _cuda_build.build(SOURCE, tuple(NVCC_FLAGS))
    build_log = log or build_log
    return lib_path


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        problem = [p] * 10 + [f, f] + [i] * 5   # ..., O, M2, M3, S, T
        for name, n_more in (("oslam_ba_normal_eq", 4), ("oslam_ba_chi2", 2),
                             ("oslam_lm_solve_step", 7),
                             ("oslam_lm_accept_step", 9)):
            fn = getattr(lib, name)
            fn.argtypes = problem + [p] * n_more   # tensors, then the stream
            fn.restype = i
        lib.oslam_error_string.argtypes = [i]
        lib.oslam_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch_shape(n_edges: int):
    """(S, T): blocks per object (the cluster's size) and threads per block
    for an object with ``n_edges`` = M2 + M3 edge slots.

    One edge per thread where 8 blocks of T threads reach (the LM tiers up
    to 512 + 256), so that O objects keep O x S blocks in flight.  On an
    H100 a launch's time is the same for every shape that gives each
    thread one edge and rises by a third with a second round
    (examples/torch_ba_launch_sweep.py; PERF.md has the numbers), so two
    cases do: 64-thread blocks up to 256 edge slots, 128-thread blocks
    above.
    """
    T = 64 if n_edges <= 256 else 128
    S = min(8, max(1, -(-n_edges // T)))
    return S, T


def _check(est, prep, w2d, w3d, wg, ground_normal, K, **per_object):
    """Validate device, dtype, shape and contiguity; returns (O, M2, M3).
    ``per_object`` holds further [O, ...] tensors as name=(tensor, width),
    width 0 for shape [O]."""
    O = est.shape[0]
    M2, M3 = w2d.shape[1], w3d.shape[1]
    want = {
        "est": (est, (O, 10)),
        "pose2d_cw": (prep.pose2d_cw, (O, M2, 7)),
        "bbox2d": (prep.bbox2d, (O, M2, 4)),
        "w2d": (w2d, (O, M2)),
        "invp3": (prep.invp3, (O, M3, 4, 7)),
        "sc3": (prep.sc3, (O, M3, 4, 3)),
        "w3d": (w3d, (O, M3)),
        "wg": (wg, (O,)),
        "ground_normal": (ground_normal, (3,)),
        "K": (K, (3, 3)),
    }
    for name, (t, width) in per_object.items():
        want[name] = (t, (O, width) if width else (O,))
    dev, f32 = est.device, torch.float32
    for name, (t, shape) in want.items():
        # one test on the launch path; which part failed only when one did
        if (t.dtype is f32 and t.shape == shape and t.is_contiguous()
                and t.device == dev and dev.type == "cuda"):
            continue
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the BA kernels take "
                             f"tensors on one CUDA device ({dev})")
        if t.dtype != f32:
            raise TypeError(f"{name} is {t.dtype}; the BA kernels take "
                            "float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        raise ValueError(f"{name} is not contiguous")
    return O, M2, M3


def _args(est, prep, w2d, w3d, wg, ground_normal, K, huber_delta, O, M2, M3):
    hd = float(huber_delta)
    return ([t.data_ptr() for t in (est, prep.pose2d_cw, prep.bbox2d, w2d,
                                    prep.invp3, prep.sc3, w3d, wg,
                                    ground_normal, K)]
            + [hd, hd * hd]    # c_float rounds the product to float32
            + [O, M2, M3, *launch_shape(M2 + M3)])


def _launch(kernel: Kernel, fn_name: str, device, args):
    """One launch on the current stream of ``device``; raises if the library
    does not build or the launch is refused."""
    lib = _load()
    stream = torch.cuda.current_stream(device).cuda_stream
    if torch.cuda.current_device() == device.index:
        rc = getattr(lib, fn_name)(*args, stream)
    else:
        with torch.cuda.device(device):
            rc = getattr(lib, fn_name)(*args, stream)
    if rc != 0:
        msg = lib.oslam_error_string(rc).decode()
        raise RuntimeError(
            f"{kernel.name} ({fn_name}) launch failed: CUDA error {rc} "
            f"({msg})")
    kernel.launches += 1


def normal_eq(est, prep, w2d, w3d, wg, ground_normal, K, huber_delta=0.0):
    """(H [O,9,9], g [O,9], r2sum [O]) by the ba_normal_eq kernel."""
    O, M2, M3 = _check(est, prep, w2d, w3d, wg, ground_normal, K)
    H = torch.empty((O, 9, 9), dtype=torch.float32, device=est.device)
    g = torch.empty((O, 9), dtype=torch.float32, device=est.device)
    c = torch.empty((O,), dtype=torch.float32, device=est.device)
    if O == 0:
        return H, g, c
    _launch(NORMAL_EQ, "oslam_ba_normal_eq", est.device,
            _args(est, prep, w2d, w3d, wg, ground_normal, K, huber_delta,
                  O, M2, M3) + [H.data_ptr(), g.data_ptr(), c.data_ptr()])
    return H, g, c


def chi2(est, prep, w2d, w3d, wg, ground_normal, K, huber_delta=0.0):
    """chi2 [O] by the ba_chi2 kernel."""
    O, M2, M3 = _check(est, prep, w2d, w3d, wg, ground_normal, K)
    c = torch.empty((O,), dtype=torch.float32, device=est.device)
    if O == 0:
        return c
    _launch(CHI2, "oslam_ba_chi2", est.device,
            _args(est, prep, w2d, w3d, wg, ground_normal, K, huber_delta,
                  O, M2, M3) + [c.data_ptr()])
    return c


def lm_solve_step(est, lam, prep, w2d, w3d, wg, ground_normal, K,
                  huber_delta=0.0, want_H=False):
    """First half of an LM iteration in one launch of ba_normal_eq with its
    solve epilogue (plain version: ``lm_soa.lm_solve_step_plain``).

    Returns (est_new [O,10], du [O,9], g [O,9], lam0 [O], H): the normal
    equations at ``est``, the damped Cholesky solve, the all-finite gate
    and the trial estimate.  H [O,9,9] only if ``want_H``, else None.
    """
    O, M2, M3 = _check(est, prep, w2d, w3d, wg, ground_normal, K,
                       lam=(lam, 0))
    f32, dev = torch.float32, est.device
    est_new = torch.empty((O, 10), dtype=f32, device=dev)
    du = torch.empty((O, 9), dtype=f32, device=dev)
    g = torch.empty((O, 9), dtype=f32, device=dev)
    lam0 = torch.empty((O,), dtype=f32, device=dev)
    H = torch.empty((O, 9, 9), dtype=f32, device=dev) if want_H else None
    if O == 0:
        return est_new, du, g, lam0, H
    _launch(NORMAL_EQ, "oslam_lm_solve_step", dev,
            _args(est, prep, w2d, w3d, wg, ground_normal, K, huber_delta,
                  O, M2, M3)
            + [lam.data_ptr(), est_new.data_ptr(), du.data_ptr(),
               g.data_ptr(), lam0.data_ptr(),
               H.data_ptr() if want_H else None])
    return est_new, du, g, lam0, H


def lm_accept_step(est, chi2, lam, nu, est_new, du, g, lam0, prep, w2d, w3d,
                   wg, ground_normal, K, huber_delta=0.0):
    """Second half of an LM iteration in one launch of ba_chi2 with its
    accept epilogue (plain version: ``lm_soa.lm_accept_step_plain``).

    chi2 at ``est_new``, the gain ratio, the accept test and the lambda /
    nu schedule.  ``est``, ``chi2``, ``lam`` and ``nu`` are UPDATED IN
    PLACE (an accepted object takes ``est_new`` and its chi2) and returned
    with the accept flags: (est, chi2, lam, nu, accept [O] bool).
    """
    O, M2, M3 = _check(est_new, prep, w2d, w3d, wg, ground_normal, K,
                       est_to_update=(est, 10), chi2=(chi2, 0), lam=(lam, 0),
                       nu=(nu, 0), du=(du, 9), g=(g, 9), lam0=(lam0, 0))
    accept = torch.empty((O,), dtype=torch.uint8, device=est.device)
    if O == 0:
        return est, chi2, lam, nu, accept.view(torch.bool)
    _launch(CHI2, "oslam_lm_accept_step", est.device,
            _args(est_new, prep, w2d, w3d, wg, ground_normal, K, huber_delta,
                  O, M2, M3)
            + [t.data_ptr() for t in (du, g, lam0, est, chi2, lam, nu,
                                      accept)])
    return est, chi2, lam, nu, accept.view(torch.bool)
