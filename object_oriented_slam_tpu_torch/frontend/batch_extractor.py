"""Frame-batched (offline) extraction: B frames' detections in one call.

Port of ``object_oriented_slam_tpu/frontend/batch_extractor.py``.  In
mapping mode the extraction of a frame depends only on its depth, boxes,
pose and the latched ground plane, never on the map, so the detections of
B recorded frames are FLATTENED into one detection axis and extracted by
one call, each detection reading its own frame's depth image and pose
through its frame index.  The call's device operations do not grow with
B: its host enqueue, which bounds the online call (PERF.md section 5), is
paid once a batch.

On a CUDA device the call is the monolithic extractor's launches with the
frame lane: ``depth_cloud`` (depth [B, H, W], poses [B, 7], a frame index
[D]), ``cluster_select`` (its sort-frame hint one rotation a detection),
``voxel_downsample`` and, with symmetry, ``symmetry_search`` (depth
[B, H, W] and the frame index): one launch of each a batch.  Stage (d)'s
options route as in the one-frame call: ``grid_cluster`` is one K13
(``cluster_grid``) launch a batch, which needs no frame lane (each
detection's cells are its own camera's), ``cluster_chains`` > 0 K5's chain
lane.  JAX scans its
clustering per frame group (``cluster_groups``, a ``lax.map``) so that a
group pays its own rounds; the clustering kernel already stops each
detection on its own rounds (``ops/cluster.py``), so nothing here groups.

The split protocol (``dispatch_batch_phase_a`` / ``dispatch_batch_phase_b``)
runs stages (a)-(c) on the device, the host's grid-hash union-find and
cluster selection (``native/src/cluster.cpp``, built at first use) on the
copy of that result, then stages (e)-(h) on the device.  Quantized
(``quantized=True``, JAX ``_extract_multi_phase_a_q``) the copy home is
each detection's points as u16 against its own bounding box (65535 marks
a masked lane, 6 bytes a point against 16) and an 11-float tail; the f32
buffer stays on the device for phase B.  The quantization is plain torch.

Every call returns a handle whose result's copy home has started behind an
event (``utils/transfer.HostCopy``); ``fetch_batch`` waits on that event
only.  The depths go up as one [B, H, W] int32 tensor in one pinned copy,
the packed arguments in a second.  There is no fall-back: the default
device is the card (raises without one) and the split protocol raises
where ``cluster.cpp`` does not build.

With a mesh (``dispatch_batch(mesh=...)``, ``parallel/multihost.py``) the
detection axis is sharded over its ranks, as JAX shards it over its
devices: every rank packs the same batch (SPMD), runs the monolithic
launches on its contiguous slice of the detection pad, and an
``all_gather`` of the [pad, 12] rows hands every rank the whole result.
Detections never communicate, so the rows are the unsharded call's.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.camera import Camera
from ..ops import backproject as bp
from ..utils.transfer import HostCopy, to_device
from .extractor import (ExtractionHandle, ExtractorConfig, _cloud_tier,
                        _handle, _host_select, _phase_a_row, _phase_a_rows,
                        _stage_a, _stages_after_selection,
                        extract_local_ellipsoids, fetch_rows)
from .symmetry import sym_type_of_labels

# the quantized phase A's masked lane, and the largest code of a point
Q_MASKED = 65535
Q_MAX = 65534
# the per-frame detection cap (as the online extractor's)
MAX_DETECTIONS = 32


def extract_local_ellipsoids_multi(depths, bboxes, frame_idx, run_mask,
                                   poses_wc, ground_plane, cam: Camera,
                                   cfg: ExtractorConfig, sym_types,
                                   need_single: bool, need_dual: bool,
                                   stats=None):
    """Detection-batched estimation across B frames.

    depths [B, H, W] int32; bboxes [D, 4]; frame_idx [D] int32 (the frame
    of each detection); run_mask [D] bool; poses_wc [B, 7]; ground_plane
    [4] world; all on one device.  A detection's result is that of
    ``extract_local_ellipsoids`` on its own frame.  Returns (local vec10
    [D, 10], prob [D], valid [D])."""
    e, p, v, _ = extract_local_ellipsoids(
        depths, bboxes, run_mask, poses_wc, ground_plane, cam, cfg, stats,
        sym_types, need_single, need_dual, frame=frame_idx.to(torch.int32))
    return e, p, v


def _unpack(flat_d, pad: int, B: int):
    """The packed batch's fields on the device: (bboxes [pad, 4], frame
    index [pad] int32, run [pad] bool, sym types [pad], poses [B, 7],
    ground plane [4])."""
    return (flat_d[:pad * 4].reshape(pad, 4),
            flat_d[pad * 4:pad * 5].to(torch.int32),
            flat_d[pad * 5:pad * 6] > 0.5, flat_d[pad * 6:pad * 7],
            flat_d[pad * 7:pad * 7 + 7 * B].reshape(B, 7),
            flat_d[pad * 7 + 7 * B:pad * 7 + 7 * B + 4])


def _extract_multi_packed(depths_d, flat_d, cam: Camera,
                          cfg: ExtractorConfig, pad: int, B: int,
                          need_single: bool, need_dual: bool, stats=None):
    """One-upload multi-frame extraction: ``flat`` packs [bboxes(pad, 4) |
    frame_idx(pad) | run(pad) | sym_type(pad) | poses(B, 7) |
    ground_plane(4)].  Returns (vec10 [pad, 10], prob [pad], valid [pad])
    in detection order."""
    bb, fi, run, st, poses, plane = _unpack(flat_d, pad, B)
    return extract_local_ellipsoids_multi(
        depths_d, bb, fi, run, poses, plane, cam, cfg, st, need_single,
        need_dual, stats)


def _extract_multi_phase_a(depths_d, flat_d, cam: Camera,
                           cfg: ExtractorConfig, pad: int, B: int):
    """Batched phase A: stages (a)-(c) of every detection of the B frames
    (one depth_cloud launch with the frame lane), packed into one
    [pad, row] device tensor, the row of the online split's phase A."""
    bb, fi, _, _, poses, plane = _unpack(flat_d, pad, B)
    return _phase_a_rows(*_stage_a(depths_d, bb, poses, plane, cam, cfg, fi))


def _extract_multi_phase_b(depths_d, flat_d, a_out, sel_d, valid_d,
                           cam: Camera, cfg: ExtractorConfig, pad: int,
                           B: int, need_single: bool, need_dual: bool,
                           stats=None):
    """Batched phase B: stages (e)-(h) from the host's selection ``sel_d``
    [pad, cap]; the world cloud (and the border lane) sliced from phase A's
    DEVICE output ``a_out``, no re-upload.  Stage (g) runs over the
    batch's run lane as the monolithic call does; ``valid_d`` [pad], the
    host's folded validity, gates the result only, so a split batch's rows
    equal the monolithic batch's.  Returns (vec10, prob, valid)."""
    cap = cfg.cloud_capacity
    pts_w = a_out[:, :cap * 3].reshape(pad, cap, 3).contiguous()
    battr_v = None
    if cfg.open_symmetry and cfg.sparse_symmetry:
        battr_v = a_out[:, cap * 4:cap * 5].contiguous()
    bb, fi, run, st, poses, plane = _unpack(flat_d, pad, B)
    e, p, ok, _ = _stages_after_selection(
        pts_w, sel_d, battr_v, depths_d, bb, run, poses, plane, cam, cfg,
        stats, st, need_single, need_dual, fi)
    return e, p, (valid_d > 0.5) & ok


def quantize_phase_a(a_out, cfg: ExtractorConfig):
    """Phase A's points as u16 against each detection's own bounding box
    (JAX ``_extract_multi_phase_a_q``'s ``quant_one``): q [pad, cap, 3]
    (int16 holding the u16 bits: view it as uint16 on the host; 65535 a
    masked lane) and tail [pad, 11] float32 = [lo (3), scale (3), center_w
    (3), ok_points, ok_center].  scale = max((hi - lo) / 65534, 1e-9), q =
    clip(round((p - lo) / scale), 0, 65534), rounding half to even."""
    pad, cap = a_out.shape[0], cfg.cloud_capacity
    sparse = cfg.open_symmetry and cfg.sparse_symmetry
    pts = a_out[:, :cap * 3].reshape(pad, cap, 3)
    m = (a_out[:, cap * 3:cap * 4] > 0.5)[..., None]
    big = 3.4e38
    lo = torch.where(m, pts, big).amin(1)
    hi = torch.where(m, pts, -big).amax(1)
    any_m = m.any(1)
    lo = torch.where(any_m, lo, 0.0)
    hi = torch.where(any_m, hi, 1.0)
    scale = torch.clamp_min((hi - lo) / bp.scalar(float(Q_MAX), a_out),
                            1e-9)
    q = torch.clamp(torch.round((pts - lo[:, None]) / scale[:, None]), 0,
                    Q_MAX)
    q = torch.where(m, q, float(Q_MASKED)).to(torch.int32)
    # the u16 bits in an int16 (PyTorch's uint16 has few CUDA kernels)
    q = torch.where(q > 32767, q - 65536, q).to(torch.int16)
    tail = torch.cat([lo, scale, a_out[:, cap * (5 if sparse else 4):]],
                     dim=1)
    return q, tail


@dataclasses.dataclass
class FrameBatch:
    """Host-packed batch ready for dispatch."""
    depths: np.ndarray          # [B, H, W] original depth dtype
    flat: np.ndarray            # [L] f32 (see _extract_multi_packed)
    cfg: ExtractorConfig        # tiered copy (common cloud capacity)
    pad: int                    # padded total-detection capacity
    B: int                      # number of frames
    need_s: bool
    need_d: bool
    slices: List[Tuple[int, int]]  # per-frame (row start, n detections)


def pack_frames_batch(cam: Camera, cfg: ExtractorConfig,
                      frames: Sequence[Tuple[np.ndarray, np.ndarray,
                                             np.ndarray, np.ndarray,
                                             np.ndarray]],
                      ground_plane: np.ndarray,
                      min_pad: int = 1) -> Optional[FrameBatch]:
    """Flatten B frames' detections into one packed batch (host numpy, the
    JAX package's ``pack_frames_batch`` array for array).

    ``frames``: sequence of (depth, bboxes [N, 4], labels [N], run_mask [N]
    bool, pose_wc7), the run gates (border / manual association,
    Tracking.cpp:313-327) already applied by the caller.  Detections beyond
    the per-frame cap of 32 keep 2D-only observations as online.  The cloud
    tier is the largest of the frames' tiers: capacity is padding only, so
    each frame's result equals its own-tier call's (``_cloud_tier``).
    ``pad`` is the next power of two of the total detections, at least
    ``min_pad``."""
    if ground_plane is None or not len(frames):
        return None
    tier = 1024
    need_s = need_d = False
    rows = []
    slices = []
    total = 0
    for depth, bboxes, labels, run, pose_wc in frames:
        n = min(len(bboxes), MAX_DETECTIONS)
        st = (sym_type_of_labels(labels[:n]).astype(np.int64) if n
              else np.zeros(0, np.int64))
        need_s = need_s or bool((st == 1).any())
        need_d = need_d or bool((st == 2).any())
        tier = max(tier, _cloud_tier(bboxes[:n], run[:n], cam.height,
                                     cam.width, cfg.cloud_capacity))
        rows.append((depth, bboxes, st, run, pose_wc, n))
        slices.append((total, n))
        total += n
    pad = 1
    while pad < max(total, min_pad):
        pad *= 2
    B = len(rows)

    flat = np.zeros(pad * 7 + 7 * B + 4, np.float32)
    depths = np.stack([r[0] for r in rows])
    for b, (depth, bboxes, st, run, pose_wc, n) in enumerate(rows):
        s = slices[b][0]
        if n:
            flat[s * 4:(s + n) * 4] = np.asarray(bboxes[:n],
                                                 np.float32).ravel()
            flat[pad * 4 + s:pad * 4 + s + n] = b
            flat[pad * 5 + s:pad * 5 + s + n] = run[:n].astype(np.float32)
            flat[pad * 6 + s:pad * 6 + s + n] = st
        flat[pad * 7 + 7 * b:pad * 7 + 7 * (b + 1)] = pose_wc
    flat[pad * 7 + 7 * B:] = ground_plane
    cfg_t = (cfg if tier == cfg.cloud_capacity
             else dataclasses.replace(cfg, cloud_capacity=tier))
    return FrameBatch(depths=depths, flat=flat, cfg=cfg_t, pad=pad, B=B,
                      need_s=need_s, need_d=need_d, slices=slices)


def _upload(batch: FrameBatch, device):
    """The batch's two host-to-device copies from pinned memory: the depths
    as one [B, H, W] int32 tensor and the packed arguments."""
    from ..system.tracking import resolve_device
    device = resolve_device(device)
    return (to_device(np.asarray(batch.depths, np.int32), device),
            to_device(batch.flat, device))


def _stats(batch: FrameBatch) -> dict:
    """The counts the host knows at the call: the cloud tier, the batch's
    detections of the single and the dual symmetry search."""
    pad = batch.pad
    st = batch.flat[pad * 6:pad * 7]
    sym = batch.cfg.open_symmetry
    return {"cloud_tier": batch.cfg.cloud_capacity, "frames": batch.B,
            "pad": pad,
            "sym_single": int((st == 1).sum()) if sym else 0,
            "sym_dual": int((st == 2).sum()) if sym else 0}


def shard_batch(batch: FrameBatch, rank: int, size: int) -> FrameBatch:
    """Rank ``rank``'s contiguous slice of the batch's detection pad, of
    ``size`` slices (the pad divides by it): its boxes, frame indices,
    run and symmetry lanes, every frame's depth and pose and the plane.
    The batch's symmetry flags stay, so every rank makes the same
    launches."""
    pad, B, f = batch.pad, batch.B, batch.flat
    n = pad // size
    lo, hi = rank * n, (rank + 1) * n
    lanes = [f[pad * k + lo:pad * k + hi] for k in range(4, 7)]
    flat = np.concatenate([f[lo * 4:hi * 4], *lanes, f[pad * 7:]])
    return dataclasses.replace(batch, flat=flat, pad=n, slices=[])


def dispatch_batch(batch: FrameBatch, cam: Camera, mesh=None,
                   device=None) -> ExtractionHandle:
    """The batch's extraction in one call (the monolithic launches, each
    once for the batch) on ``device`` (the card unless named): returns its
    handle, the [pad, 12] (vec10, prob, valid) device result with its copy
    home started; ``fetch_batch`` reads it.

    With ``mesh`` (``parallel.multihost.observation_mesh``; ``device``
    defaults to the mesh's) every rank passes the same batch and launches
    on its slice of the detection pad (``shard_batch``); the rows are
    gathered whole on every rank, and the device counts in the handle's
    stats are this rank's.  A pad the ranks do not divide runs unsharded
    on every rank, as in the JAX package."""
    if device is None and mesh is not None:
        device = mesh.device
    sharded = mesh is not None and mesh.size > 1 and \
        batch.pad % mesh.size == 0
    part = shard_batch(batch, mesh.rank, mesh.size) if sharded else batch
    depths_d, flat_d = _upload(part, device)
    dev_stats = {}
    e, p, v = _extract_multi_packed(
        depths_d, flat_d, cam, part.cfg, part.pad, part.B, part.need_s,
        part.need_d, dev_stats)
    if sharded:
        from ..parallel.collectives import all_gather
        rows = all_gather(torch.cat([e, p[:, None], v[:, None].to(e.dtype)],
                                    dim=1), mesh)
        e, p, v = rows[:, :10], rows[:, 10], rows[:, 11] > 0.5
    return _handle(e, p, v, _stats(batch), dev_stats)


@dataclasses.dataclass
class BatchPhaseA:
    """A batch with phase A launched: ``a_out`` its [pad, row] device
    output (phase B reads it there), ``copies`` the copies home the host
    middle stage reads (``a_out`` itself, or quantized q and tail), the
    batch's device inputs."""
    a_out: torch.Tensor
    copies: Tuple[HostCopy, ...]
    quantized: bool
    depths_d: torch.Tensor
    flat_d: torch.Tensor


def dispatch_batch_phase_a(batch: FrameBatch, cam: Camera,
                           quantized: bool = False,
                           device=None) -> BatchPhaseA:
    """Launch the batched phase A (one depth_cloud launch) and start the
    copy home the host middle stage reads: the [pad, row] f32 buffer, or
    with ``quantized`` only the u16 points and the tails."""
    depths_d, flat_d = _upload(batch, device)
    a_out = _extract_multi_phase_a(depths_d, flat_d, cam, batch.cfg,
                                   batch.pad, batch.B)
    host = quantize_phase_a(a_out, batch.cfg) if quantized else (a_out,)
    return BatchPhaseA(a_out, tuple(HostCopy.start(t) for t in host),
                       quantized, depths_d, flat_d)


def host_cluster_select_multi(batch: FrameBatch, a_np: np.ndarray):
    """Host middle stage of the split protocol for a multi-frame batch:
    the grid-hash union-find labels and the reference's cluster selection
    of every run lane (``_host_select``, the online split's).  Returns
    (flat_b: the flat with ok_points & ok_center & ok_cluster folded into
    the run lane, sel [pad, cap] bool, the most survivors of a lane)."""
    pad, cfg = batch.pad, batch.cfg
    flat_b = batch.flat.copy()
    flat_b[pad * 5:pad * 6], sel, survivors = _host_select(
        cfg, batch.flat[pad * 5:pad * 6] > 0.5,
        lambda i: _phase_a_row(a_np[i], cfg))
    return flat_b, sel, survivors


def dequantize_row(q_row: np.ndarray, tail_row: np.ndarray):
    """One detection's quantized phase A on the host: (pts_w [cap, 3]
    float32, zero on masked lanes; m2 [cap]; center_w [3]; ok_points;
    ok_center).  ``q_row`` [cap, 3] uint16."""
    m2 = q_row[:, 0] != Q_MASKED
    lo, scale = tail_row[:3], tail_row[3:6]
    pts_w = (lo[None, :] + q_row.astype(np.float32) * scale[None, :]
             ).astype(np.float32)
    pts_w[~m2] = 0.0
    return pts_w, m2, tail_row[6:9], tail_row[9] > 0.5, tail_row[10] > 0.5


def host_cluster_select_multi_q(batch: FrameBatch, q_np: np.ndarray,
                                tail_np: np.ndarray):
    """``host_cluster_select_multi`` on the quantized copy: each lane
    dequantized (``dequantize_row``), labelled and selected.  q_np [pad,
    cap, 3] uint16, tail_np [pad, 11]."""
    pad, cfg = batch.pad, batch.cfg
    flat_b = batch.flat.copy()
    flat_b[pad * 5:pad * 6], sel, survivors = _host_select(
        cfg, batch.flat[pad * 5:pad * 6] > 0.5,
        lambda i: dequantize_row(q_np[i], tail_np[i]))
    return flat_b, sel, survivors


def dispatch_batch_phase_b(batch: FrameBatch, h: BatchPhaseA, cam: Camera,
                           device=None) -> ExtractionHandle:
    """The host middle stage on phase A's copy (it waits on that copy's
    events only), the selection and the folded validity up in two pinned
    copies, then the batched phase B (``_extract_multi_phase_b``).
    Returns the result's handle (``fetch_batch``)."""
    from ..system.tracking import resolve_device
    device = resolve_device(device)
    cfg, pad, B = batch.cfg, batch.pad, batch.B
    if h.quantized:
        q_np = h.copies[0].wait().numpy().view(np.uint16)
        flat_b, sel, survivors = host_cluster_select_multi_q(
            batch, q_np, h.copies[1].wait().numpy())
    else:
        flat_b, sel, survivors = host_cluster_select_multi(
            batch, h.copies[0].wait().numpy())
    dev_stats = {}
    e, p, v = _extract_multi_phase_b(
        h.depths_d, h.flat_d, h.a_out, to_device(sel, device),
        to_device(flat_b[pad * 5:pad * 6], device), cam, cfg, pad, B,
        batch.need_s, batch.need_d, dev_stats)
    stats = dict(_stats(batch), cluster_survivors=survivors)
    return _handle(e, p, v, stats, dev_stats)


# A batched call's result on the host as float64 [pad, 12] (waits on its
# copy's event only; the device counts fill ``handle.stats``)
fetch_batch = fetch_rows
