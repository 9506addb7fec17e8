"""One frame of the dense RGB-D map builder: K12, ``dense_fuse``.

Port of the JAX package's ``system/dense_builder.py:24-39`` ``_fuse_frame``
(the reference's ``src/dense_builder/builder.cpp:46-137``): the frame's
depth is back-projected at ``stride`` (``backproject.full_point_cloud``),
moved to the world by the camera pose, given its pixels' BGR colours,
appended after the map's rows, and the whole is voxel-filtered at ``leaf``
into at most ``capacity`` cells (``ops/voxel.py`` ``_voxel_core`` with the
three colour channels as attributes; segments past ``capacity`` dropped,
keys clipped to 1024 leafs an axis from the masked minimum cell, as in
JAX).

``dense_fuse`` on CUDA tensors runs the hand-written kernel
(``csrc/dense_fuse.cu``, built with ``nvcc`` at first use), one cooperative
launch a fuse: the frame back-projected into the tail of a
``[capacity + F]`` buffer after the map's rows, every key, and then, where
the map's keys ascend (the map a previous fuse wrote), the frame's keys
sorted by hand and merged into the map's sorted prefix, else all keys
sorted by a radix sort of the kernel's own; the segments summed in merged
order into the other buffer's capacity prefix.  The path is chosen on the
device (``FuseWork.tally`` counts fuses by path); nothing synchronises.
``FuseWork`` holds the buffers, allocated once (the builder keeps one); the
map alternates between their two prefixes.  On CPU tensors it is
``dense_fuse_plain``: ``full_point_cloud``, the world transform written out
left to right as the kernel has it, and the segment sums of
``voxel_segment_mean_plain`` / ``voxel_attr_mean_plain`` on one stable
sort, whose sequential ``index_add_`` gives the kernel's bits.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from ..core import se3
from ..core.camera import Camera
from ..utils.device import indexed_device
from . import _cuda_build
from ._cuda_build import Kernel
from .backproject import full_point_cloud
from .voxel import voxel_attr_mean_plain, voxel_keys, voxel_segment_mean_plain

SOURCE = os.path.join(_cuda_build.CSRC_DIR, "dense_fuse.cu")
DENSE_FUSE = Kernel("dense_fuse")     # one count a fused frame
KERNELS = (DENSE_FUSE,)
_GRID_MAX, _PART, _DIGITS, _PER, _BUCKETS = 512, 16, 256, 4, 4096

_lib: Optional[ctypes.CDLL] = None
build_log = ""


def build() -> str:
    """Compile csrc/dense_fuse.cu (if not built yet); the library's path."""
    global build_log
    lib_path, log = _cuda_build.build(SOURCE, _cuda_build.NVCC_FLAGS)
    build_log = log or build_log
    return lib_path


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.oslam_dense_fuse.argtypes = ([i] * 4 + [f] * 7 + [p] * 11
                                         + [ctypes.c_longlong, p, p])
        lib.oslam_dense_fuse.restype = i
        lib.oslam_df_error_string.argtypes = [i]
        lib.oslam_df_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _call(fn_name: str, device, args):
    lib = _load()
    with torch.cuda.device(device):
        rc = getattr(lib, fn_name)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dense_fuse ({fn_name}) launch failed: CUDA error "
                           f"{rc} ({lib.oslam_df_error_string(rc).decode()})")


def scratch_ints(capacity: int, frame: int) -> int:
    """int32 words of a fuse's scratch (df_scratch_ints): the blocks'
    partial results, the radix histograms, the merge tiles' counts and
    splits, the radix buffers and ranks, the frame sort's bucket counts
    and starts."""
    n = capacity + frame
    tiles = n // (_PER * 32) + _GRID_MAX + 2
    return (_GRID_MAX * (_PART + _DIGITS) + 2 * tiles + 1 + 5 * n
            + 2 * _BUCKETS + 1)


def frame_grid(height: int, width: int, stride: int):
    """(rows, cols) of the strided grid: ceil(H / s), ceil(W / s)."""
    return (height + stride - 1) // stride, (width + stride - 1) // stride


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def frame_points_plain(depth, rgb, pose_wc, cam: Camera, stride: int,
                       depth_range: float):
    """(world points [F, 3], colours [F, 3], mask [F]) of a frame's strided
    grid, row-major; ``rgb`` None gives zeros."""
    pts, mask = full_point_cloud(depth, cam, stride=stride,
                                 depth_range=depth_range)
    x, y, z = pts.reshape(-1, 3).unbind(-1)
    R, t = se3.quat_to_mat(pose_wc[3:]), pose_wc[:3]
    w = torch.stack([x * R[i, 0] + y * R[i, 1] + z * R[i, 2] + t[i]
                     for i in range(3)], dim=-1)
    if rgb is None:
        colors = torch.zeros_like(w)
    else:
        colors = rgb[::stride, ::stride].reshape(-1, 3).to(torch.float32)
    return w, colors, mask.reshape(-1)


def dense_fuse_plain(map_pts, map_rgb, map_mask, depth, rgb, pose_wc,
                     cam: Camera, stride: int, leaf: float, capacity: int,
                     depth_range: float):
    """Plain PyTorch version of ``dense_fuse`` (any device; the wrapper
    takes it for CPU tensors only)."""
    pts_w, colors, m = frame_points_plain(depth, rgb, pose_wc, cam, stride,
                                          depth_range)
    all_p = torch.cat([map_pts, pts_w])[None]
    all_c = torch.cat([map_rgb, colors])[None]
    all_m = torch.cat([map_mask, m])[None]
    key, cmin = voxel_keys(all_p, all_m, leaf)
    key_s, order = torch.sort(key, dim=1, stable=True)
    out, _, out_mask, _, _ = voxel_segment_mean_plain(key_s, order, all_p,
                                                      cmin, capacity)
    out_c = voxel_attr_mean_plain(key_s, order, all_c, capacity)
    return out[0], out_c[0], out_mask[0]


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

class FuseWork:
    """The device buffers of fuses at one capacity and frame shape,
    allocated once: two ``[capacity + F]`` point / colour / mask buffers
    (the map's rows in one's prefix, a fuse's output in the other's; they
    alternate), the keys, the kernel's int32 scratch (the blocks' partial
    results, the radix buffers, the merge tiles) and ``tally``, fuses by
    path (fast, general), counted on the device.

    Every map a fuse reads is zero where it is masked: the kernel writes
    its outputs so and ``load`` makes a copied map so; a fuse then clears
    only the rows an older map left set past the new one."""

    def __init__(self, capacity: int, height: int, width: int, stride: int,
                 device):
        self.capacity, self.height, self.width = capacity, height, width
        self.stride = stride
        self.device = indexed_device(device)
        hs, ws = frame_grid(height, width, stride)
        self.frame = hs * ws
        n = self.n = capacity + self.frame

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        self.pts = [zeros(n, 3), zeros(n, 3)]
        self.col = [zeros(n, 3), zeros(n, 3)]
        self.mask = [zeros(n, dtype=torch.bool), zeros(n, dtype=torch.bool)]
        self.keys = zeros(n, dtype=torch.int32)
        self.scratch = zeros(scratch_ints(capacity, self.frame),
                             dtype=torch.int32)
        self.tally = zeros(2, dtype=torch.int32)
        self.cur = 0

    def fits(self, capacity, height, width, stride, device) -> bool:
        return ((self.capacity, self.height, self.width, self.stride)
                == (capacity, height, width, stride)
                and self.device == indexed_device(device))

    def map(self):
        """The current map: views of the current buffer's prefix."""
        c, i = self.capacity, self.cur
        return self.pts[i][:c], self.col[i][:c], self.mask[i][:c]

    def load(self, pts, rgb, mask):
        """Make (pts, rgb, mask) the current map (no copy when they are
        already the current prefix; a copied map's masked rows are
        zeroed)."""
        cur = self.map()
        copied = False
        for src, dst in zip((pts, rgb, mask), cur):
            if src.data_ptr() != dst.data_ptr():
                dst.copy_(src)
                copied = True
        if copied:
            unset = ~cur[2][:, None]
            cur[0].masked_fill_(unset, 0.0)
            cur[1].masked_fill_(unset, 0.0)

    def _launch(self, args):
        _call("oslam_dense_fuse", self.device, args)

    def fuse(self, depth, rgb, pose_wc, cam: Camera, leaf: float,
             depth_range: float):
        """One frame into the map: one kernel launch.  Returns the new map
        (views of the other buffer's prefix, which becomes the current
        one)."""
        a, b = self.cur, 1 - self.cur
        self._launch([
            self.capacity, self.height, self.width, self.stride, cam.fx,
            cam.fy, cam.cx, cam.cy, cam.scale, depth_range, leaf,
            depth.data_ptr(), rgb.data_ptr() if rgb is not None else None,
            pose_wc.data_ptr(), self.pts[a].data_ptr(), self.col[a].data_ptr(),
            self.mask[a].data_ptr(), self.pts[b].data_ptr(),
            self.col[b].data_ptr(), self.mask[b].data_ptr(),
            self.keys.data_ptr(), self.scratch.data_ptr(),
            self.scratch.numel(), self.tally.data_ptr()])
        DENSE_FUSE.launches += 1
        self.cur = b
        return self.map()


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, not {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def dense_fuse(map_pts, map_rgb, map_mask, depth, rgb, pose_wc, cam: Camera,
               stride: int = 4, leaf: float = 0.01, capacity: int = 1 << 19,
               depth_range: float = 6.0, work: Optional[FuseWork] = None):
    """Fuse one RGB-D frame into a voxel map.

    map_pts / map_rgb [capacity, 3] float32 (BGR), map_mask [capacity]
    bool; depth [H, W] int32; rgb [H, W, 3] float32 or None (zeros);
    pose_wc [7] float32.  Returns the new (pts, rgb, mask).  On CUDA
    tensors K12 (``FuseWork.fuse``; the results are views into ``work``'s
    buffers, valid until its fuse after next); on CPU tensors
    ``dense_fuse_plain``.
    """
    dev = map_pts.device
    if dev.type == "cpu":
        return dense_fuse_plain(map_pts, map_rgb, map_mask, depth, rgb,
                                pose_wc, cam, stride, leaf, capacity,
                                depth_range)
    if dev.type != "cuda":
        raise NotImplementedError(
            f"no dense_fuse for tensors on {dev}: the kernel takes cuda "
            "tensors, the plain version cpu ones")
    H, W = depth.shape
    _check("map_pts", map_pts, torch.float32, (capacity, 3), dev)
    _check("map_rgb", map_rgb, torch.float32, (capacity, 3), dev)
    _check("map_mask", map_mask, torch.bool, (capacity,), dev)
    _check("depth", depth, torch.int32, (H, W), dev)
    if rgb is not None:
        _check("rgb", rgb, torch.float32, (H, W, 3), dev)
    _check("pose_wc", pose_wc, torch.float32, (7,), dev)
    if capacity < 1 or stride < 1 or not leaf > 0:
        raise ValueError(f"capacity={capacity}, stride={stride}, leaf={leaf}")
    if work is None or not work.fits(capacity, H, W, stride, dev):
        work = FuseWork(capacity, H, W, stride, dev)
    work.load(map_pts, map_rgb, map_mask)
    return work.fuse(depth, rgb, pose_wc, cam, leaf, depth_range)
