"""Host side of the bundle-adjustment edge kernels (``csrc/ba_edges.cu``).

``normal_eq`` and ``chi2`` launch the hand-written CUDA kernels that
replace the Pallas kernels K1-K4 of ``attic/pallas_ba_kernels.py``; their
plain PyTorch versions are ``lm_soa.soa_normal_eq_plain`` and
``lm_soa.soa_chi2_plain``.  The shared library is compiled with ``nvcc``
for ``sm_90a`` at first use into ``object_oriented_slam_tpu_torch/build/``
(named by the source's hash, so an edited source rebuilds) and bound with
ctypes.  Each launch runs on PyTorch's current stream and does not
synchronise; outputs are allocated here with ``torch.empty``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "ba_edges.cu")
BUILD_DIR = os.path.join(_PKG, "build")
# -fmad=false: every multiply and add rounds on its own, as in the plain
# version's elementwise kernels, so both compute the same residuals
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class Kernel:
    """A launch counter: ``launches`` grows by one per kernel launch."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0


NORMAL_EQ = Kernel("ba_normal_eq")
CHI2 = Kernel("ba_chi2")
KERNELS = (NORMAL_EQ, CHI2)

_lib: Optional[ctypes.CDLL] = None
build_log = ""   # nvcc's output (ptxas register / spill report) of the build


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the BA kernels are built from "
                           "csrc/ba_edges.cu with the CUDA toolkit")
    return path


def build() -> str:
    """Compile the kernels (if this source is not built yet); returns the
    path of the shared library."""
    global build_log
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    lib_path = os.path.join(BUILD_DIR, f"libba_edges_{digest.hexdigest()[:12]}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{build_log}")
        os.replace(tmp, lib_path)   # atomic: concurrent builders agree
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib_path


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.oslam_ba_normal_eq.argtypes = [p] * 10 + [f, f, i, i, i] + [p] * 4
        lib.oslam_ba_normal_eq.restype = i
        lib.oslam_ba_chi2.argtypes = [p] * 10 + [f, f, i, i, i] + [p] * 2
        lib.oslam_ba_chi2.restype = i
        lib.oslam_error_string.argtypes = [i]
        lib.oslam_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(est, prep, w2d, w3d, wg, ground_normal, K):
    """Validate device, dtype, shape and contiguity; returns (O, M2, M3)."""
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
    for name, (t, shape) in want.items():
        if t.device != est.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the BA kernels take "
                             f"tensors on one CUDA device ({est.device})")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the BA kernels take "
                            "float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return O, M2, M3


def _args(est, prep, w2d, w3d, wg, ground_normal, K, huber_delta):
    hd = float(huber_delta)
    return ([t.data_ptr() for t in (est, prep.pose2d_cw, prep.bbox2d, w2d,
                                    prep.invp3, prep.sc3, w3d, wg,
                                    ground_normal, K)]
            + [hd, hd * hd])   # c_float rounds the product to float32


def _raise_on(rc: int, lib, name: str):
    if rc != 0:
        msg = lib.oslam_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


def normal_eq(est, prep, w2d, w3d, wg, ground_normal, K, huber_delta=0.0):
    """(H [O,9,9], g [O,9], r2sum [O]) by the ba_normal_eq kernel."""
    O, M2, M3 = _check(est, prep, w2d, w3d, wg, ground_normal, K)
    H = torch.empty((O, 9, 9), dtype=torch.float32, device=est.device)
    g = torch.empty((O, 9), dtype=torch.float32, device=est.device)
    c = torch.empty((O,), dtype=torch.float32, device=est.device)
    if O == 0:
        return H, g, c
    lib = _load()
    with torch.cuda.device(est.device):
        stream = torch.cuda.current_stream(est.device).cuda_stream
        rc = lib.oslam_ba_normal_eq(
            *_args(est, prep, w2d, w3d, wg, ground_normal, K, huber_delta),
            O, M2, M3, H.data_ptr(), g.data_ptr(), c.data_ptr(), stream)
    _raise_on(rc, lib, NORMAL_EQ.name)
    NORMAL_EQ.launches += 1
    return H, g, c


def chi2(est, prep, w2d, w3d, wg, ground_normal, K, huber_delta=0.0):
    """chi2 [O] by the ba_chi2 kernel."""
    O, M2, M3 = _check(est, prep, w2d, w3d, wg, ground_normal, K)
    c = torch.empty((O,), dtype=torch.float32, device=est.device)
    if O == 0:
        return c
    lib = _load()
    with torch.cuda.device(est.device):
        stream = torch.cuda.current_stream(est.device).cuda_stream
        rc = lib.oslam_ba_chi2(
            *_args(est, prep, w2d, w3d, wg, ground_normal, K, huber_delta),
            O, M2, M3, c.data_ptr(), stream)
    _raise_on(rc, lib, CHI2.name)
    CHI2.launches += 1
    return c
