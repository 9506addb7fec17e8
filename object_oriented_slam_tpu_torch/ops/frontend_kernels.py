"""Host side of the depth-frontend kernels (``csrc/frontend.cu``).

The library is compiled with ``nvcc`` for ``sm_90a`` at first use
(``ops/_cuda_build.py``) and bound with ctypes.  The wrappers that call
``launch`` live beside their plain PyTorch versions.  The main path's:
``depth_cloud.depth_cloud`` and ``depth_cloud.depth_cloud_border``
(depth_cloud: stages (a)-(c) of an extraction call, the latter with each
point's depth-border flag averaged per voxel), ``cluster.cluster_components``
and ``cluster.cluster_select`` (the clustering: one kernel, without and with
the selection epilogue, one launch counter; its exact and chain lanes count
apart), ``cluster.cluster_grid`` / ``cluster.cluster_grid_select`` (K13
``cluster_grid``, the grid pass of ``grid_cluster``: a kernel of its own
beside the clustering kernel, with which it shares the compaction and the
selection epilogue; a counter of its own), ``voxel.voxel_downsample`` and
its attribute variants (voxel_downsample: the object downsample) and
``frontend.symmetry.estimate_symmetry`` (symmetry_search: the
symmetry-plane search of stage (g), over every live point or, with a source
mask, over the border points).  depth_cloud and symmetry_search also take a
batch of frames with each detection's frame index (the offline batch
mapper, ``frontend/batch_extractor``): still one launch a batch.  Each
launch runs on PyTorch's
current stream and does not synchronise; the wrappers allocate the outputs
with ``torch.empty``.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from . import _cuda_build
from ._cuda_build import Kernel

SOURCE = os.path.join(_cuda_build.CSRC_DIR, "frontend.cu")

DEPTH_CLOUD = Kernel("depth_cloud")
VOXEL_DOWNSAMPLE = Kernel("voxel_downsample")
CLUSTER_COMPONENTS = Kernel("cluster_components")
SYMMETRY_SEARCH = Kernel("symmetry_search")
KERNELS = (DEPTH_CLOUD, VOXEL_DOWNSAMPLE, CLUSTER_COMPONENTS, SYMMETRY_SEARCH)
# the clustering options' kernels, each with its own count: K13 (the grid
# pass, ``grid_cluster``) and K5's exact and chain lanes (``exact=True``,
# ``cluster_chains > 0``); none of them runs on the default path
CLUSTER_GRID = Kernel("cluster_grid")
CLUSTER_EXACT = Kernel("cluster_components_exact")
CLUSTER_CHAIN = Kernel("cluster_components_chain")
OPTION_KERNELS = (CLUSTER_GRID, CLUSTER_EXACT, CLUSTER_CHAIN)
# the most points of a detection's cloud symmetry_search takes (its shared
# memory holds them as float4: OSLAM_SYM_MAX_S in csrc/frontend.cu)
SYM_MAX_POINTS = 2048

_lib: Optional[ctypes.CDLL] = None
build_log = ""   # nvcc's output (ptxas register / spill report) of the build


def build(defines=()) -> str:
    """Compile the kernels (if this source is not built yet); returns the
    path of the shared library.  ``defines``: extra ``-D`` flags, a build of
    its own (``rebuild``)."""
    global build_log
    lib_path, log = _cuda_build.build(
        SOURCE, _cuda_build.NVCC_FLAGS + tuple(defines))
    build_log = log or build_log
    return lib_path


def rebuild(*defines: str):
    """Bind the library built with extra ``-D`` flags from here on (none:
    the default build).  For examples/torch_cluster_sweep.py, which times
    the clustering kernel at other points a lane (``-DOSLAM_CC_P=4``)."""
    global _lib
    _lib = _bind(build(defines))


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = _bind(build())
    return _lib


def _bind(lib_path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(lib_path)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, argtypes in (
            ("oslam_depth_cloud",
             [p, i, i, p, i, p, p] + [f] * 8 + [i] + [p] * 9 + [f, p]),
            ("oslam_voxel_downsample", [p, p, i, i, f, i] + [p] * 5),
            ("oslam_cluster_components",
             [p] * 4 + [i, i, f] + [i] * 7 + [p, i] + [p] * 3
             + [i, p, p, i]),
            ("oslam_cluster_select",
             [p] * 4 + [i, i, f] + [i] * 7 + [p, i] + [p] * 3
             + [i, p, p, i] + [p, p, i, f, p, p, p]),
            ("oslam_cluster_grid",
             [p] * 4 + [i, i, f, i, p] + [i] * 5 + [p, i] + [p] * 4
             + [p, p, i, f, p, p, p]),
            ("oslam_symmetry_search",
             [p] * 9 + [i] * 4 + [f] * 11 + [i, i] + [p] * 6)):
        fn = getattr(lib, name)
        fn.argtypes = argtypes + [p]      # ..., then the stream
        fn.restype = i
    lib.oslam_cluster_grid_max_clusters.argtypes = [i, i, i, p]
    lib.oslam_cluster_grid_max_clusters.restype = i
    lib.oslam_fe_error_string.argtypes = [i]
    lib.oslam_fe_error_string.restype = ctypes.c_char_p
    return lib


def check(name: str, t: torch.Tensor, dtype, shape, device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    the CUDA device ``device``."""
    if t.device != device or device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}; the frontend kernels take "
                         f"tensors on one CUDA device ({device})")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def launch(kernel: Kernel, fn_name: str, device, args):
    """One launch on the current stream of ``device``; raises if the library
    does not build or the launch is refused."""
    lib = _load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(*args, stream)
    if rc != 0:
        msg = lib.oslam_fe_error_string(rc).decode()
        raise RuntimeError(f"{kernel.name} ({fn_name}) launch failed: CUDA "
                           f"error {rc} ({msg})")
    kernel.launches += 1
