"""Voxel-grid downsampling (fixed-capacity, masked), batched over detections.

Port of ``object_oriented_slam_tpu/ops/voxel.py``, which replaces PCL
``VoxelGrid`` / ``DownSamplePointCloudOnly``
(src/symmetry/PointCloudFilter.cpp:249-261): points are bucketed into
``leaf``-sized cells and each occupied cell emits the centroid of its
points.  Each point's cell is packed into one integer key, the keys are
sorted STABLY (``torch.sort(stable=True)``: equal keys keep pixel order, so
the centroid sums have one order), and the sorted runs are averaged into a
fixed-capacity prefix.

``voxel_downsample`` / ``voxel_downsample_cells`` and the attribute
variants ``voxel_downsample_full`` / ``voxel_downsample_attrs`` (a
per-point value averaged per cell beside the points: the border flags of
sparse symmetry) are one launch of the ``voxel_downsample`` CUDA kernel
(csrc/frontend.cu: keys, sort and means) for tensors on a CUDA device, and
``voxel_downsample_plain`` / ``voxel_downsample_full_plain`` for tensors on
the CPU; ``voxel_segment_mean_plain`` and ``voxel_attr_mean_plain`` are
their segment part (the extractor's first downsample is part of
``ops/depth_cloud``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import frontend_kernels as fk
from .backproject import scalar

_INVALID = 2 ** 30
MAX_IDS = 65535     # candidate points a detection (the kernels' 16-bit ids)


class World(NamedTuple):
    """The extractor's epilogue of the first downsample: world points
    ``p R^T + t`` and the supporting-plane mask
    ``(n . p_w + d) / den > clearance`` (frontend/extractor.py)."""
    R: torch.Tensor            # [3, 3] camera -> world rotation, or [D, 3, 3]
    t: torch.Tensor            # [3], or [D, 3]: one a detection
    plane: torch.Tensor        # [4] world ground plane
    den: torch.Tensor          # 0-dim, max(|n|, eps)
    clearance: float


def voxel_cells(pts: torch.Tensor, leaf: float):
    """Integer cell coordinates per point (absolute, unshifted)."""
    return torch.floor(pts / scalar(leaf, pts)).to(torch.int32)


def voxel_keys(pts: torch.Tensor, mask: torch.Tensor, leaf: float):
    """Integer cell key per point [D, G]; invalid points get a sentinel key.

    Cells are shifted by the masked minimum [D, 3] so the 10-bit-per-axis
    packing is collision-free for clouds spanning up to 1024 leafs per axis.
    """
    cell = voxel_cells(pts, leaf)
    cmin = torch.where(mask[..., None], cell, _INVALID).amin(dim=1)
    c = (cell - cmin[:, None, :]).clamp(0, 1023)
    key = (c[..., 0] << 20) | (c[..., 1] << 10) | c[..., 2]
    return torch.where(mask, key, _INVALID), cmin


def world_points_plain(pts: torch.Tensor, world: World):
    """(p R^T + t, signed plane distance), sums written out left to right
    as the kernel's epilogue has them."""
    x, y, z = pts.unbind(-1)
    R, t, pi = world.R, world.t, world.plane
    if R.dim() == 3:           # a rotation a detection (a batch of frames)
        lead = (R.shape[0],) + (1,) * (x.dim() - 1)
        R, t = R.reshape(lead + (3, 3)), t.reshape(lead + (3,))
    w = [x * R[..., i, 0] + y * R[..., i, 1] + z * R[..., i, 2] + t[..., i]
         for i in range(3)]
    dist = (w[0] * pi[0] + w[1] * pi[1] + w[2] * pi[2] + pi[3]) / world.den
    return torch.stack(w, dim=-1), dist


def _segment_slots(key_s, capacity: int):
    """(is_new [D, G]: a sorted key starts a segment, flat [D * G]: each
    sorted point's output slot in a [D * (capacity + 1)] buffer).  Invalid
    points and segments past the capacity go to each detection's dump slot,
    its last."""
    D = key_s.shape[0]
    dev = key_s.device
    valid_s = key_s != _INVALID
    is_new = torch.cat([torch.ones((D, 1), dtype=torch.bool, device=dev),
                        key_s[:, 1:] != key_s[:, :-1]], dim=1) & valid_s
    seg = torch.cumsum(is_new, dim=1) - 1
    seg = torch.where(valid_s & (seg < capacity), seg, capacity)
    flat = (seg + torch.arange(D, device=dev)[:, None] * (capacity + 1)
            ).reshape(-1)
    return is_new, flat


def voxel_segment_mean_plain(key_s, order, pts, cmin, capacity: int,
                             world: Optional[World] = None):
    """Segment means of the stably sorted keys, plain PyTorch on any device
    (on the CPU ``index_add_`` adds in index order, i.e. in sorted order).

    key_s [D, G] int32 sorted keys, order [D, G] int64 the sort's indices,
    pts [D, G, 3] the points in their ORIGINAL order, cmin [D, 3] int32.
    Returns (centroids [D, capacity, 3], cells [D, capacity, 3] int32,
    mask [D, capacity], world points | None, supporting-plane mask | None).
    Segments past ``capacity`` are dropped.  Cells come from the segment's
    own key (decoding it rather than re-flooring the centroid, which can
    land in the next cell under f32 rounding), so each unmasked output
    point has a unique cell."""
    D, G = key_s.shape
    dev = key_s.device
    pts_s = torch.gather(pts, 1, order[..., None].expand(-1, -1, 3))
    is_new, flat = _segment_slots(key_s, capacity)
    sums = torch.zeros((D * (capacity + 1), 3), dtype=pts.dtype, device=dev)
    sums.index_add_(0, flat, pts_s.reshape(-1, 3))
    cnts = torch.zeros(D * (capacity + 1), dtype=pts.dtype, device=dev)
    cnts.index_add_(0, flat, torch.ones_like(flat, dtype=pts.dtype))
    # all keys of a segment are equal: its first element carries the key
    keys_out = torch.zeros(D * (capacity + 1), dtype=torch.int64, device=dev)
    keys_out.index_add_(0, flat, torch.where(is_new, key_s, 0).reshape(-1)
                        .to(torch.int64))
    sums = sums.reshape(D, capacity + 1, 3)[:, :capacity]
    cnts = cnts.reshape(D, capacity + 1)[:, :capacity]
    k = keys_out.reshape(D, capacity + 1)[:, :capacity].to(torch.int32)
    out_mask = cnts > 0
    out = torch.where(out_mask[..., None],
                      sums / cnts.clamp_min(1.0)[..., None], 0.0)
    k = torch.where(out_mask, k, 0)
    cells = torch.stack([(k >> 20) & 1023, (k >> 10) & 1023, k & 1023],
                        dim=-1) + cmin[:, None, :]
    cells = torch.where(out_mask[..., None], cells, 0)
    if world is None:
        return out, cells, out_mask, None, None
    pts_w, dist = world_points_plain(out, world)
    return out, cells, out_mask, pts_w, out_mask & (dist > world.clearance)


def voxel_attr_mean_plain(key_s, order, attrs, capacity: int):
    """The per-segment mean [D, capacity, ...] of a per-point attribute
    attrs [D, G] or [D, G, C] (points in their ORIGINAL order; C channels
    averaged alike, the dense builder's colours), summed in sorted order as
    ``voxel_segment_mean_plain`` sums the points (JAX ``_voxel_core``'s
    attribute branch); 0 where a slot holds no segment."""
    D, G = key_s.shape
    tail = tuple(attrs.shape[2:])
    _, flat = _segment_slots(key_s, capacity)
    a_s = torch.gather(attrs, 1, order.reshape((D, G) + (1,) * len(tail))
                       .expand((D, G) + tail))
    sums = torch.zeros((D * (capacity + 1),) + tail, dtype=attrs.dtype,
                       device=attrs.device)
    sums.index_add_(0, flat, a_s.reshape((-1,) + tail))
    cnts = torch.zeros(D * (capacity + 1), dtype=attrs.dtype,
                       device=attrs.device)
    cnts.index_add_(0, flat, torch.ones(D * G, dtype=attrs.dtype,
                                        device=attrs.device))
    sums = sums.reshape((D, capacity + 1) + tail)[:, :capacity]
    cnts = cnts.reshape(D, capacity + 1)[:, :capacity].reshape(
        (D, capacity) + (1,) * len(tail))
    return torch.where(cnts > 0, sums / cnts.clamp_min(1.0), 0.0)


def voxel_downsample_plain(pts: torch.Tensor, mask: torch.Tensor, leaf: float,
                           capacity: int):
    """Plain PyTorch version of ``voxel_downsample_cells`` (any device):
    keys, stable sort and ``voxel_segment_mean_plain``."""
    key, cmin = voxel_keys(pts, mask, leaf)
    key_s, order = torch.sort(key, dim=1, stable=True)
    out, cells, out_mask, _, _ = voxel_segment_mean_plain(
        key_s, order, pts, cmin, capacity)
    return out, cells, out_mask


def voxel_downsample_full_plain(pts: torch.Tensor, attrs: torch.Tensor,
                                mask: torch.Tensor, leaf: float,
                                capacity: int):
    """Plain PyTorch version of ``voxel_downsample_full`` (any device):
    ``voxel_downsample_plain`` and ``voxel_attr_mean_plain`` on one sort."""
    key, cmin = voxel_keys(pts, mask, leaf)
    key_s, order = torch.sort(key, dim=1, stable=True)
    out, cells, out_mask, _, _ = voxel_segment_mean_plain(
        key_s, order, pts, cmin, capacity)
    return (out, voxel_attr_mean_plain(key_s, order, attrs, capacity), cells,
            out_mask)


def _downsample(pts, mask, leaf: float, capacity: int, with_cells: bool,
                attrs=None):
    """One launch of the ``voxel_downsample`` kernel on CUDA tensors (cells
    are written only when asked for; with ``attrs`` [D, N] float32 the
    kernel averages them per cell beside the points); the plain version on
    the CPU.  Returns (points, attribute means | None, cells | None,
    mask)."""
    if pts.device.type != "cuda":
        if attrs is not None:
            return voxel_downsample_full_plain(pts, attrs, mask, leaf,
                                               capacity)
        out, cells, out_mask = voxel_downsample_plain(pts, mask, leaf,
                                                      capacity)
        return out, None, cells, out_mask
    D, N = mask.shape
    dev = pts.device
    fk.check("pts", pts, torch.float32, (D, N, 3), dev)
    fk.check("mask", mask, torch.bool, (D, N), dev)
    if attrs is not None:
        fk.check("attrs", attrs, torch.float32, (D, N), dev)
    if N > MAX_IDS:
        raise ValueError(f"voxel_downsample takes at most {MAX_IDS} points a "
                         f"detection (got {N}): point ids are 16-bit")
    if capacity < 1:
        raise ValueError(f"capacity={capacity}")

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out, out_mask = empty(D, capacity, 3), empty(D, capacity,
                                                 dtype=torch.bool)
    cells = empty(D, capacity, 3, dtype=torch.int32) if with_cells else None
    out_a = empty(D, capacity) if attrs is not None else None
    if D:
        fk.launch(fk.VOXEL_DOWNSAMPLE, "oslam_voxel_downsample", dev,
                  [pts.data_ptr(), mask.data_ptr(), D, N, leaf, capacity,
                   out.data_ptr(), out_mask.data_ptr(),
                   cells.data_ptr() if with_cells else None,
                   attrs.data_ptr() if attrs is not None else None,
                   out_a.data_ptr() if attrs is not None else None])
    return out, out_a, cells, out_mask


def voxel_downsample_cells(pts: torch.Tensor, mask: torch.Tensor, leaf: float,
                           capacity: int):
    """Downsample to at most ``capacity`` cell centroids per detection.

    pts [D, G, 3], mask [D, G].  Returns (out_pts [D, capacity, 3],
    out_cells [D, capacity, 3] int32 absolute cell coordinates,
    out_mask [D, capacity]).  On a CUDA device one launch of the
    ``voxel_downsample`` kernel; on the CPU the plain version.
    """
    out, _, cells, out_mask = _downsample(pts, mask, leaf, capacity, True)
    return out, cells, out_mask


def voxel_downsample(pts: torch.Tensor, mask: torch.Tensor, leaf: float,
                     capacity: int):
    """Downsample to at most ``capacity`` cell centroids per detection.

    Returns (out_pts [D, capacity, 3], out_mask [D, capacity]).  On a CUDA
    device one launch of the ``voxel_downsample`` kernel; on the CPU the
    plain version.
    """
    out, _, _, out_mask = _downsample(pts, mask, leaf, capacity, False)
    return out, out_mask


def voxel_downsample_full(pts: torch.Tensor, attrs: torch.Tensor,
                          mask: torch.Tensor, leaf: float, capacity: int):
    """Downsample with a per-point attribute attrs [D, G] (e.g. the border
    flags of sparse symmetry) averaged per cell like the points, AND cell
    coordinates.  Returns (pts, attrs [D, capacity], cells, mask).  On a
    CUDA device one launch of the ``voxel_downsample`` kernel; on the CPU
    ``voxel_downsample_full_plain``."""
    return _downsample(pts, mask, leaf, capacity, True, attrs)


def voxel_downsample_attrs(pts: torch.Tensor, attrs: torch.Tensor,
                           mask: torch.Tensor, leaf: float, capacity: int):
    """Like ``voxel_downsample`` but also averages the per-point attribute
    attrs [D, G] within each cell.  Returns (pts, attrs [D, capacity],
    mask); one launch on a CUDA device."""
    out, out_a, _, out_mask = _downsample(pts, mask, leaf, capacity, False,
                                          attrs)
    return out, out_a, out_mask
