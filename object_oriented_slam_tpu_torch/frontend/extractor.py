"""Single-frame ellipsoid extraction (the dense per-frame hot loop).

Port of the monolithic extractor of
``object_oriented_slam_tpu/frontend/extractor.py``, the re-design of
``EllipsoidExtractor::EstimateLocalEllipsoid``
(``src/pca/EllipsoidExtractor.cpp:292-493``), processing ALL detections of
a frame as one batch on the device (a leading axis D where the JAX package
``vmap``s; the reference loops detections on the CPU with PCL):

  (a) strided bbox depth back-projection, 1 cm voxel downsample, transform
      to world (ExtractPointCloud, :86-168)
  (b) supporting-plane filter keeps points > 5 cm above ground (:562-578)
  (c) 10x10-sample object-center estimate (GetCenter, :583-643)
  (d) Euclidean clustering, select cluster near the center estimate
      (ApplyEuclideanFilter, :646-737): min-label propagation replaces the
      PCL KdTree
  (e) PCA + chirality fix + z-to-gravity alignment + exact normal
      calibration (:170-196, 207-267, 760-788)
  (f) normalized object frame (x from PCA, z from ground normal), 0.1 m
      downsample of the object cloud (:321-347)
  (g) with ``open_symmetry``: the symmetry plane of each detection whose
      label has a symmetry prior (frontend/symmetry.py), the cloud
      completed by its mirror image and the object frame re-derived from
      the plane (:352-456).  With ``sparse_symmetry`` too
      (Symmetry::SetBorders, Symmetry.cpp:163-167): each point carries its
      depth-border flag from (a) through both downsamples, and only the
      object cells whose mean flag exceeds 0.3 are mirrored and scored,
      every live cell staying the 1-NN reference (all of them where no
      cell passes)
  (h) scale from max |coord| per axis in the normalized frame
      (ProcessPCANormalized, :495-531); result returned camera-local
      (:459-492)

Failure gates (miSystemState analogues) are carried as a validity mask.
On a CUDA device stages (a)-(c), (d), the downsample of (f) and the plane
search of (g) are launches of the hand-written kernels of
``csrc/frontend.cu``: depth_cloud (``ops/depth_cloud``; with sparse
symmetry it also tests each strided pixel's 4 neighbours for the border
flag and averages the flag per voxel), cluster_select (``ops/cluster``),
voxel_downsample (``ops/voxel``; averaging the flag per object cell with
sparse symmetry) and, when the frame has a detection with a symmetry prior,
symmetry_search (``frontend/symmetry``; with the border cells as its
sources with sparse symmetry); the rest is plain PyTorch.

The stages also take a batch of frames (the offline batch mapper,
``frontend/batch_extractor.py``): depth [B, H, W], poses [B, 7] and each
detection's frame index ``frame`` [D] int32, with which every stage reads
its detection's own frame's image and pose; ``frame=None`` is the one frame
of an online call (depth [H, W], pose [7]), and B = 1 with every index 0
gives that call's bits.

Stage (d)'s options, as JAX routes them (``_cluster_select_batch``):
``grid_cluster`` (where ``_grid_clustering_ok``'s gate passes) labels each
detection on its camera-frame voxel cloud and cells with the grid pass, on
the card K13 ``cluster_grid`` with the selection as its epilogue;
``cluster_chains`` > 0 interleaves chain passes, on the card K5's chain
lane.  Neither falls back to a plain version on the card, and neither reads
anything back.

The host-clustered extractors (``SplitExtractor``,
``FusedSplitExtractor``) run stage (d) on the host between two device
phases: phase A is depth_cloud, its result copied home in one piece;
the host labels each detection's cloud with the grid-hash union-find of
``native/src/cluster.cpp`` (built at first use, ``io/native_loader``) and
selects its cluster; phase B runs stages (e)-(h) on the device from that
selection.  No cluster_select launch happens on those paths.
"""
from __future__ import annotations

import dataclasses
import logging
from collections import deque

import numpy as np
import torch

from ..core import se3
from ..core.camera import Camera
from ..ops import backproject as bp
from ..ops import cluster as cl
from ..ops import pca as pca_mod
from ..ops import voxel as vx
from ..ops.depth_cloud import depth_cloud, depth_cloud_border
from ..utils.transfer import HostCopy, to_device
from . import symmetry as sym_mod

_log = logging.getLogger("object_oriented_slam_tpu_torch")


@dataclasses.dataclass(frozen=True)
class ExtractorConfig:
    depth_range: float = 6.0                # EllipsoidExtractor_DEPTH_RANGE
    voxel_leaf: float = 0.01                # ExtractPointCloud downsample
    plane_clearance: float = 0.05           # supporting-plane filter
    cluster_tolerance: float = 0.02         # EllipsoidExtraction.Euclidean.*
    cluster_min_size: int = 100
    cluster_center_dis: float = 0.5
    sym_grid: float = 0.1                   # EllipsoidExtraction.Symmetry.GridSize
    cloud_capacity: int = 16384  # post-voxel budget; the per-frame pow2
    #                              tiering keeps small frames on small clouds
    sym_capacity: int = 512                 # post-0.1-downsample budget
    cluster_iters: int = 96   # convergence bound only: rounds stop early
    #                           once labels settle (ops/cluster.py).  A
    #                           truncated run FAILS the validity gate
    #                           (_cluster_select_batch)
    cluster_chains: int = -1  # -1 = one chain-seed order, 0 = none; K > 0
    #                           seeds K spatial orders AND interleaves a
    #                           chain pass per order after every pass (K5's
    #                           chain lane on the card)
    # JAX's ladder of compiled compaction capacities: any value is taken
    # and changes nothing.  The clustering kernel (and its plain version)
    # compacts each detection to its own survivors inside its one launch,
    # and labels are the same at every capacity (JAX extractor.py:84-95,
    # ops/cluster.py:379-393)
    compact_tiers: bool = True
    compact_rungs: tuple = (4, 5, 6, 7, 8, 12)
    grid_cluster: bool = False  # O(N*C) grid-hash clustering on the
    #                             camera-frame voxel cells (K13 on the card)
    #                             where _grid_clustering_ok's gate passes
    open_symmetry: bool = False
    sparse_symmetry: bool = False  # mirror only depth-border points in the
    #                                symmetry cost (Symmetry::SetBorders
    #                                path; inactive in the reference demo)
    sym_analytic_grad: bool = True   # False: central differences


def _grid_clustering_ok(cam: Camera, cfg: ExtractorConfig) -> bool:
    """Static gate for the O(N*C) grid-hash clustering path (JAX
    ``_grid_clustering_ok``): the voxel cells are unique per point by
    construction, and the largest possible camera-frame cloud span (the
    depth_range frustum) must fit the key packing."""
    span = max(cfg.depth_range,
               cfg.depth_range * cam.width / cam.fx,
               cfg.depth_range * cam.height / cam.fy)
    return cfg.grid_cluster and cl.grid_supported(
        cfg.cluster_tolerance, cfg.voxel_leaf, span)


def _stage_a(depth, bboxes, pose_wc, ground_plane, cam: Camera,
             cfg: ExtractorConfig, frame=None):
    """Stages (a)-(c) of all detections: bbox cloud -> voxel -> world,
    supporting-plane filter (EllipsoidExtractor.cpp:562-578), center
    estimate; on a CUDA device one launch (ops/depth_cloud).

    Returns (pts_v [D, cap, 3] camera-frame voxel cloud, pts_w world cloud,
    cells_v, m2 filtered mask, center_w [D, 3], ok_points [D],
    ok_center [D], R_wc [3, 3] ([D, 3, 3] with ``frame``), battr_v
    [D, cap] | None).  battr_v, each voxel's mean depth-border flag, is
    computed with sparse symmetry only (JAX ``border_map``,
    extractor.py:333,458), in the same launch.
    """
    args = (depth, bboxes, pose_wc, ground_plane, cam, cfg.voxel_leaf,
            cfg.depth_range, cfg.plane_clearance, cfg.cloud_capacity, frame)
    battr_v = None
    if cfg.open_symmetry and cfg.sparse_symmetry:
        dc, battr_v = depth_cloud_border(*args)
    else:
        dc = depth_cloud(*args)
    return (dc.pts_v, dc.pts_w, dc.cells_v, dc.m2, dc.center_w, dc.ok_points,
            dc.ok_center, dc.R_wc, battr_v)


def _stage_post(pts_w, sel, ground_plane, cfg: ExtractorConfig,
                battr_v=None):
    """Stages (e)-(f) after cluster selection: PCA, rotation
    post-processing, normalized object frame, 0.1 m object-cloud
    downsample.  Returns (Two [D, 7], pts_n [D, S, 3], obj_m [D, S],
    sym_src [D, S] | None); sym_src, with the voxels' border attribute
    battr_v, marks the object cells to mirror (JAX :196-202)."""
    # (e) PCA + rotation post-processing
    res = pca_mod.masked_pca(pts_w, sel)
    rot = pca_mod.adjust_chirality(res.rot)
    n = ground_plane[:3]
    normal = n / torch.sqrt((n * n).sum()).clamp_min(1e-9)
    rot, _ = pca_mod.align_z_to_gravity(rot, res.eigvals, normal)
    rot = pca_mod.calibrate_to_normal(rot, normal)

    # (f) normalized object frame: x from PCA, z from ground normal
    rz = normal.expand(rot.shape[0], 3)
    rx = rot[..., 0] / torch.sqrt((rot[..., 0] ** 2).sum(-1, keepdim=True)
                                  ).clamp_min(1e-9)
    ry = torch.stack([rz[:, 1] * rx[:, 2] - rz[:, 2] * rx[:, 1],
                      rz[:, 2] * rx[:, 0] - rz[:, 0] * rx[:, 2],
                      rz[:, 0] * rx[:, 1] - rz[:, 1] * rx[:, 0]], dim=-1)
    R_wo = torch.stack([rx, ry, rz], dim=-1)
    Two = torch.cat([res.center, se3.mat_to_quat(R_wo)], dim=-1)

    # 0.1 m downsample of the object cloud for the scale stats
    # (EllipsoidExtractor.cpp:321-324: downsample happens in world frame,
    # then the cloud is moved to the normalized frame)
    sym_src = None
    if battr_v is None:
        obj_pts, obj_m = vx.voxel_downsample(pts_w, sel, cfg.sym_grid,
                                             cfg.sym_capacity)
    else:
        # the border flag averaged again per object cell (a mean of the
        # voxels' means); a cell above 0.3 is a border cell.  A detection
        # with none (e.g. a fully interior view) falls back to the dense
        # cost rather than a zero-point average
        obj_pts, obj_battr, obj_m = vx.voxel_downsample_attrs(
            pts_w, battr_v, sel, cfg.sym_grid, cfg.sym_capacity)
        sym_src = obj_m & (obj_battr > 0.3)
        sym_src = torch.where(sym_src.any(1, keepdim=True), sym_src, obj_m)
    Tow = se3.se3_inv(Two)
    R_ow = se3.quat_to_mat(Tow[:, 3:])
    pts_n = obj_pts @ R_ow.transpose(-1, -2) + Tow[:, None, :3]
    pts_n = torch.where(obj_m[..., None], pts_n, 0.0)
    return Two, pts_n, obj_m, sym_src


def _cluster_select_batch(pts_w, m2, center_w, R_wc, cfg: ExtractorConfig,
                          stats=None, grid=None):
    """Stage (d) for the whole detection batch.

    The survivors of the supporting-plane filter are compacted per
    detection, propagated to their fixed point and the cluster near the
    centre estimate selected, all inside one launch
    (ops/cluster.cluster_select; with ``cluster_chains`` > 0 its chain
    lane).  ``grid`` = (pts_v, cells_v, cam), the camera-frame voxel cloud
    and its cells: with ``grid_cluster`` and ``_grid_clustering_ok``, the
    labels come from the grid pass on them instead
    (ops/cluster.cluster_grid_select, K13 on the card; the selection on
    the world points as before), as JAX routes it (extractor.py:233-287).
    Nothing is read back, so ``stats``
    receives 0-dim DEVICE tensors: the most rounds a detection ran, the
    largest survivor count (``cluster_lanes`` and ``cluster_survivors``: the
    lanes the pass works on are the survivors) and whether every detection
    converged.  ``R_wc`` [3, 3] (camera to world; [D, 3, 3] one a detection
    in a batch of frames) tells the kernel the frame the voxel cloud is
    sorted in; it changes no result.  Reference hot loop:
    EllipsoidExtractor.cpp:646-737 (PCL KdTree clustering).
    """
    # an iteration-bound-truncated propagation yields FRAGMENT components
    # that can pass every downstream gate with a biased center/scale:
    # cluster_select surfaces it as extraction failure (ok is ANDed with
    # the convergence flag)
    if grid is not None and _grid_clustering_ok(grid[2], cfg):
        pts_v, cells_v, _ = grid
        sel, ok, _, conv, rounds = cl.cluster_grid_select(
            pts_v.contiguous(), cells_v.contiguous(), m2.contiguous(),
            cl.grid_seed(pts_v, m2, cfg.cluster_tolerance),
            pts_w.contiguous(), center_w.contiguous(), cfg.cluster_tolerance,
            cfg.voxel_leaf, cfg.cluster_iters, 12, cfg.cluster_min_size,
            cfg.cluster_center_dis)
    else:
        args, orders = cl.centre_and_seed(pts_w, m2, cfg.cluster_tolerance,
                                          cfg.cluster_chains,
                                          with_orders=True)
        sel, ok, _, conv, rounds = cl.cluster_select(
            pts_w.contiguous(), *args[:4], center_w.contiguous(), args[4],
            cfg.cluster_iters, 12, cfg.cluster_min_size,
            cfg.cluster_center_dis,
            frame=R_wc.transpose(-1, -2).contiguous(), orders=orders)
    if stats is not None and m2.shape[0]:
        survivors = m2.sum(1).max()
        stats.update(cluster_rounds=rounds.max(), cluster_lanes=survivors,
                     cluster_survivors=survivors,
                     cluster_converged=conv.all())
    return sel, ok


def _detection_poses(pose_wc, D: int, frame=None):
    """Each detection's camera pose [D, 7]: the frame's pose [7] expanded,
    or with ``frame`` [D] its own frame's of the batch's poses [B, 7]."""
    if frame is None:
        return pose_wc.expand(D, 7)
    return pose_wc[frame.long()]


def _finish(Two, pts_n, obj_m, pose_wc, frame=None):
    """(h) scale from normalized stats; assemble camera-local ellipsoid."""
    _, mx = pca_mod.normalized_frame_stats(pts_n, obj_m)
    # world -> camera-local (transform_from with inverse pose,
    # EllipsoidExtractor.cpp:465-469)
    Tcw = se3.se3_inv(pose_wc)
    pose_local = se3.se3_mul(_detection_poses(Tcw, Two.shape[0], frame), Two)
    return torch.cat([pose_local, mx], dim=-1)


def _stage_sym(Two, pts_n, obj_m, bboxes, run, sym_types, pose_wc, depth,
               cam: Camera, cfg: ExtractorConfig, need_single: bool,
               need_dual: bool, sym_src=None, frame=None):
    """Stage (g) for the whole detection batch (JAX ``_sym_finish_one``):
    the symmetry search of every detection whose type needs it (one launch
    on a CUDA device, both variants), the completed clouds of the variants
    the frame needs, and the selection by each detection's type.  Type 0,
    and a detection off the run mask, keep the plain cloud padded to 4S and
    prob 1.  ``sym_src`` (sparse symmetry): the points the search mirrors;
    the completion mirrors the whole cloud (JAX :382-391).  ``frame``: the
    detections' frames of a batch (depth [B, H, W], poses [B, 7]).
    Returns (Two, pts [D, 4S, 3], mask [D, 4S], prob [D])."""
    D, S = obj_m.shape
    pose_oc = se3.se3_mul(se3.se3_inv(Two),
                          _detection_poses(pose_wc, D, frame))
    res = sym_mod.estimate_symmetry(
        pts_n.contiguous(), obj_m.contiguous(), bboxes.contiguous(),
        pose_oc.contiguous(), depth, sym_types, run, cam,
        sym_mod.SymmetryConfig(analytic_grad=cfg.sym_analytic_grad),
        None if sym_src is None else sym_src.contiguous(), frame)
    pts_fin = torch.cat([pts_n, pts_n.new_zeros((D, 3 * S, 3))], dim=1)
    m_fin = torch.cat([obj_m, obj_m.new_zeros((D, 3 * S))], dim=1)
    Two_fin, prob = Two, torch.ones_like(res.prob)
    for t, need in ((1, need_single), (2, need_dual)):
        if not need:
            continue
        pts_s, m_s, Tom = sym_mod.complete_cloud(pts_n, obj_m, res, t == 2)
        use = (sym_types == t) & run
        pts_fin = torch.where(use[:, None, None], pts_s, pts_fin)
        m_fin = torch.where(use[:, None], m_s, m_fin)
        Two_fin = torch.where(use[:, None], se3.se3_mul(Two, Tom), Two_fin)
        prob = torch.where(use, res.prob, prob)
    return Two_fin, pts_fin, m_fin, prob


def extract_local_ellipsoids(depth, bboxes, run_mask, pose_wc, ground_plane,
                             cam: Camera, cfg: ExtractorConfig, stats=None,
                             sym_types=None, need_single: bool = True,
                             need_dual: bool = True, frame=None):
    """Batched single-frame estimation over all detections.

    depth: [H, W] int32; bboxes: [D, 4]; run_mask: [D] bool; pose_wc: [7];
    ground_plane: [4] world frame; all on one device.  ``frame`` [D] int32
    (the offline batch mapper): depth [B, H, W] and pose_wc [B, 7] of a
    batch of frames, detection d in frame frame[d].  ``stats``: an
    optional dict that receives the clustering stage's round count, lane
    count, survivor count and convergence as 0-dim tensors on that device
    (the call reads nothing back); with sparse symmetry and a detection to
    search also, over the detections searched, their sources
    (``sym_sources``), their live points (``sym_points``) and how many
    mirror every live point (``sym_dense``: the fall-back, or every cell a
    border cell).  ``sym_types``: [D] int {0 none,
    1 reflection, 2 dual} (read only with ``cfg.open_symmetry``; None: all
    0); ``need_single`` / ``need_dual``: host flags, derived from the
    frame's labels, that the frame has a detection of that type, so only
    the completions it needs are computed (the search itself runs when
    either holds).
    Returns (local vec10 [D, 10], prob [D], valid [D], debug tuple
    (pts_n, obj_m, Two); after symmetry the completed clouds [D, 4S]).
    """
    depth = depth.to(torch.int32)
    bboxes = bboxes.to(torch.float32)
    pose_wc = pose_wc.to(torch.float32)
    ground_plane = ground_plane.to(torch.float32)

    (pts_v, pts_w, cells_v, m2, center_w, ok_p, ok_c, R_wc,
     battr_v) = _stage_a(depth, bboxes, pose_wc, ground_plane, cam, cfg,
                         frame)
    sel, ok_cl = _cluster_select_batch(pts_w, m2, center_w, R_wc, cfg, stats,
                                       (pts_v, cells_v, cam))
    e_local, prob, ok, debug = _stages_after_selection(
        pts_w, sel, battr_v, depth, bboxes, run_mask, pose_wc, ground_plane,
        cam, cfg, stats, sym_types, need_single, need_dual, frame)
    return e_local, prob, ok_p & ok_c & ok_cl & run_mask & ok, debug


def _stages_after_selection(pts_w, sel, battr_v, depth, bboxes, run_mask,
                            pose_wc, ground_plane, cam: Camera,
                            cfg: ExtractorConfig, stats, sym_types,
                            need_single: bool, need_dual: bool, frame=None):
    """Stages (e)-(h) from the selected cluster ``sel`` [D, N] of the world
    cloud ``pts_w``: ``_stage_post``, with ``open_symmetry`` ``_stage_sym``
    over the detections of ``run_mask``, and ``_finish`` (shared by the
    monolithic call, the split extractors' phase B and the batch
    extractor's; ``frame``: see ``extract_local_ellipsoids``).  Returns (local
    vec10 [D, 10], prob [D], ok [D]: the result finite and prob > 1e-8,
    debug tuple)."""
    Two, pts_n, obj_m, sym_src = _stage_post(pts_w, sel, ground_plane, cfg,
                                             battr_v)
    prob = torch.ones(bboxes.shape[0], dtype=torch.float32,
                      device=bboxes.device)
    if cfg.open_symmetry and (need_single or need_dual):
        if sym_types is None:
            sym_types = torch.zeros(bboxes.shape[0], dtype=torch.int32,
                                    device=bboxes.device)
        sym_types = sym_types.to(torch.int32)
        if sym_src is not None and stats is not None:
            searched = (sym_types > 0) & run_mask
            n_src = (sym_src & searched[:, None]).sum(1)
            n_pts = (obj_m & searched[:, None]).sum(1)
            stats.update(sym_sources=n_src.sum(), sym_points=n_pts.sum(),
                         sym_dense=(searched & (n_src == n_pts)).sum())
        Two, pts_n, obj_m, prob = _stage_sym(
            Two, pts_n, obj_m, bboxes, run_mask, sym_types, pose_wc, depth,
            cam, cfg, need_single, need_dual, sym_src, frame)
    e_local = _finish(Two, pts_n, obj_m, pose_wc, frame)
    ok = torch.isfinite(e_local).all(dim=1) & (prob > 1e-8)
    return e_local, prob, ok, (pts_n, obj_m, Two)


def _cloud_tier(bboxes, run, rows, cols, cap_max):
    """Power-of-two cloud capacity covering the frame's largest bbox.

    The post-voxel cloud of a detection can never exceed its strided
    pixel count, so a capacity >= that bound yields BIT-IDENTICAL
    results to the full capacity (padding only) while the sort and the
    clustering pass shrink for small objects.
    """
    n_max = 1
    for i in range(len(bboxes)):
        if not run[i]:
            continue
        x1 = max(0.0, min(float(bboxes[i][0]), cols - 1))
        y1 = max(0.0, min(float(bboxes[i][1]), rows - 1))
        x2 = max(0.0, min(float(bboxes[i][2]), cols))
        y2 = max(0.0, min(float(bboxes[i][3]), rows))
        npix = (int(max(0.0, x2 - x1)) // bp.STRIDE + 1) * \
               (int(max(0.0, y2 - y1)) // bp.STRIDE + 1)
        n_max = max(n_max, npix)
    cap = 1024
    while cap < min(n_max, cap_max):
        cap *= 2
    return min(cap, cap_max)


def _pack_frame(cam: Camera, cfg: ExtractorConfig, bboxes, labels, pose_wc,
                ground_plane):
    """Host packing of a frame: detection padding to a power of two, the
    single flat f32 argument vector [bboxes(pad,4) | run(pad) |
    sym_type(pad) | pose_wc(7) | ground_plane(4)] (the symmetry types from
    the labels, SYMMETRY_PRIOR) and the cloud-capacity tier.
    Returns (flat, pad, n, cfg at the tier, (detections of type 1, of type
    2) when ``cfg.open_symmetry``, else (0, 0))."""
    D = len(bboxes)
    n = min(D, 32)
    if D > 32:
        _log.warning("frame has %d detections; only the first 32 get 3D "
                     "extraction (the rest fall back to 2D-only)", D)
    pad = 1
    while pad < n:
        pad *= 2
    flat = np.zeros(pad * 6 + 11, np.float32)
    if n:
        flat[:n * 4] = np.asarray(bboxes[:n], np.float32).ravel()
    flat[pad * 4:pad * 4 + n] = 1.0
    st = sym_mod.sym_type_of_labels(labels[:n])
    flat[pad * 5:pad * 5 + n] = st
    n_sym = ((int((st == 1).sum()), int((st == 2).sum()))
             if cfg.open_symmetry else (0, 0))
    flat[pad * 6:pad * 6 + 7] = pose_wc
    flat[pad * 6 + 7:] = ground_plane
    tier = _cloud_tier(bboxes[:n], flat[pad * 4:pad * 4 + n] > 0,
                       cam.height, cam.width, cfg.cloud_capacity)
    cfg_t = (cfg if tier == cfg.cloud_capacity
             else dataclasses.replace(cfg, cloud_capacity=tier))
    return flat, pad, n, cfg_t, n_sym


_STAT_KEYS = ("cluster_rounds", "cluster_lanes", "cluster_survivors",
              "cluster_converged", "sym_sources", "sym_points", "sym_dense")


@dataclasses.dataclass
class ExtractionHandle:
    """One extraction call in flight: ``rows`` the [pad, 12] device result
    (vec10, prob, valid), ``stats`` the call's counts (those the host knows
    at the call; the device's after ``fetch``), ``keys`` the device counts
    riding the packed result's last row, ``copy`` that packed result's
    copy to the host, started at the call."""
    rows: torch.Tensor
    stats: dict
    keys: list
    copy: HostCopy


def _handle(e, p, v, stats, dev_stats) -> ExtractionHandle:
    """Pack (vec10, prob, valid) into [pad, 12] with the device counts
    ``dev_stats`` as one more row and start that tensor's copy home."""
    res = torch.cat([e, p[:, None], v[:, None].to(e.dtype)], dim=1)
    keys = [k for k in _STAT_KEYS if k in dev_stats]
    row = (torch.nn.functional.pad(
        torch.stack([dev_stats[k].to(e.dtype) for k in keys]),
        (0, 12 - len(keys))) if keys else e.new_zeros(12))
    packed = torch.cat([res, row[None]], dim=0)
    return ExtractionHandle(packed[:-1], stats, keys, HostCopy.start(packed))


def fetch_rows(handle: ExtractionHandle) -> np.ndarray:
    """A handle's result on the host as float64 [pad, 12]: waits on its
    copy's event only, then fills ``handle.stats`` with the device counts
    that rode the copy as its last row."""
    host = handle.copy.wait().numpy().astype(np.float64)
    for k, v in zip(handle.keys, host[-1]):
        handle.stats[k] = bool(v) if k == "cluster_converged" else int(v)
    return host[:-1]


class _Extractor:
    """What the monolithic and the split extractors share: the frame's
    packing and its two host-to-device copies, and ``fetch``."""
    supports_lm_fusion = False

    def __init__(self, cam: Camera, cfg: ExtractorConfig, device=None):
        from ..system.tracking import resolve_device
        self.cam = cam
        self.cfg = cfg
        self.device = resolve_device(device)
        self.stats = {}

    def upload(self, depth, bboxes, labels, pose_wc, ground_plane):
        """The frame's two host-to-device copies, the depth image and the
        packed arguments: (host flat, depth on the device, flat on the
        device, pad, cfg at the frame's cloud tier, symmetry counts)."""
        flat, pad, _, cfg_t, n_sym = _pack_frame(
            self.cam, self.cfg, bboxes, labels, pose_wc, ground_plane)
        depth_d = to_device(np.asarray(depth, np.int32), self.device)
        return flat, depth_d, to_device(flat, self.device), pad, cfg_t, n_sym

    def fetch(self, handle: ExtractionHandle) -> np.ndarray:
        """The call's result on the host as a float64 array [pad, 12]: waits
        for the copy the call started (its own event), then fills the
        call's ``stats`` with the counts of its last row."""
        rows = fetch_rows(handle)
        self.stats = handle.stats
        return rows


def _lm_from_flat(lm_flat, est_prev, K, normal, gset, layout, lm_cfg):
    """The due global-BA LM call from its packed batch (JAX
    ``_lm_from_flat``): ``lm_flat`` the batch on the device, ``layout``
    the tracker's ``_lm_layout``.  Returns (estimates [O, 10], chi2)."""
    from ..backend import observations_from_flat, optimize_objects_soa
    obs = observations_from_flat(lm_flat, est_prev, layout)
    return optimize_objects_soa(obs, K, normal, gset, lm_cfg)


class MonolithicExtractor(_Extractor):
    """Whole-frame extraction on ``device`` (the production default).

    A call returns an ``ExtractionHandle``: the DEVICE result packed
    [pad, 12] (vec10, prob, valid) and its copy to the host, started at
    once, so the caller reads it with one wait (``fetch``) whenever it
    likes, also after later calls.  The detection axis is padded to the
    next power of two (extraction work is linear in the padded count).
    Detections beyond the 32-slot safety cap fall back to 2D-only
    observations (tracking masks them invalid).

    A call is two host-to-device copies from pinned memory (``upload``)
    and launches (``run``); nothing in it waits for the device.  The
    clustering stage's counts stay on the device and ride the result's
    copy as one more row: ``fetch(handle)`` waits for that copy and fills
    the call's ``stats`` (its clustering rounds, lanes, survivors and
    convergence; the cloud tier and the counts of detections that take the
    single and the dual symmetry search, ``sym_single`` / ``sym_dual``,
    are known at the call from the labels; with sparse symmetry the
    searched detections' sources, live points and dense fall-backs,
    ``sym_sources`` / ``sym_points`` / ``sym_dense``, ride the row too).
    ``extractor.stats`` is the stats of the call last fetched, or of the
    call last run before its fetch.

    ``dispatch_with_lm`` (LM fusion, ``Tracking.fuse_lm``) issues the
    frame's extraction and the due LM call from one call.
    """
    supports_lm_fusion = True

    def upload(self, depth, bboxes, labels, pose_wc, ground_plane):
        """The frame's two host-to-device copies: the depth image and the
        packed arguments.  Returns what ``run`` takes."""
        return super().upload(depth, bboxes, labels, pose_wc,
                              ground_plane)[1:]

    def run(self, depth_d, flat_d, pad, cfg_t, n_sym) -> ExtractionHandle:
        """The extraction on the device: launches and the start of the
        result's copy home, no wait."""
        bb = flat_d[:pad * 4].reshape(pad, 4)
        run = flat_d[pad * 4:pad * 5] > 0.5
        self.stats = {"cloud_tier": cfg_t.cloud_capacity,
                      "sym_single": n_sym[0], "sym_dual": n_sym[1]}
        dev_stats = {}
        e, p, v, _ = extract_local_ellipsoids(
            depth_d, bb, run, flat_d[pad * 6:pad * 6 + 7],
            flat_d[pad * 6 + 7:pad * 6 + 11], self.cam, cfg_t, dev_stats,
            sym_types=flat_d[pad * 5:pad * 6], need_single=n_sym[0] > 0,
            need_dual=n_sym[1] > 0)
        return _handle(e, p, v, self.stats, dev_stats)

    def __call__(self, depth, bboxes, labels, pose_wc, ground_plane):
        if ground_plane is None:
            return None
        return self.run(*self.upload(depth, bboxes, labels, pose_wc,
                                     ground_plane))

    def dispatch_with_lm(self, depth, bboxes, labels, pose_wc, ground_plane,
                         lm_args):
        """This frame's extraction and the prepared LM batch from one call
        (JAX ``dispatch_with_lm`` over ``_combined_ext_lm``): the
        extraction's launches and its copy home first, then the LM's.
        ``lm_args`` = (lm_flat, est_prev, K, normal, gset, layout, lm_cfg),
        all on this device.  Returns (handle, est, chi2), or None when the
        extraction cannot run (no ground plane: the caller then dispatches
        the LM alone)."""
        if ground_plane is None:
            return None
        handle = self(depth, bboxes, labels, pose_wc, ground_plane)
        est, chi2 = _lm_from_flat(*lm_args)
        return handle, est, chi2


def make_extractor(cam: Camera, cfg: ExtractorConfig, device=None):
    """Adapter for system.Tracking's extractor hook (monolithic), on
    ``device`` (the CUDA device unless the caller names one)."""
    return MonolithicExtractor(cam, cfg, device)


# ---------------------------------------------------------------------------
# The host-clustered extractors: stage (d) on the host between two device
# phases (JAX ``_extract_phase_a`` / ``_host_cluster_select`` /
# ``_extract_phase_b``).  No cluster_components launch on these paths.


def _select_cluster_np(pts_w, mask, labels, center, min_size, center_dis):
    """Host mirror of ops.cluster.select_cluster (same semantics,
    EllipsoidExtractor.cpp:675-736; numpy copy of the JAX package's).
    Returns (sel mask, ok)."""
    N = len(pts_w)
    valid = mask & (labels < N)
    lab = labels[valid]
    sizes = np.zeros(N, np.float32)
    np.add.at(sizes, lab, 1.0)
    d = np.linalg.norm(pts_w - center, axis=1)
    min_d = np.full(N, np.inf, np.float32)
    np.minimum.at(min_d, lab, d[valid].astype(np.float32))

    is_cluster = sizes >= min_size
    n_clusters = int(is_cluster.sum())
    near = is_cluster & (min_d < center_dis)
    size_key = np.where(near, sizes, -1.0)
    best_near = int(np.argmax(size_key))
    size_key_all = np.where(is_cluster, sizes, -1.0)
    best_any = int(np.argmax(size_key_all))

    use_fallback = (n_clusters == 1) and (near.sum() == 0)
    chosen = best_any if use_fallback else best_near
    ok = bool(near.sum() > 0 or use_fallback)
    sel = valid & (labels == chosen) & ok
    return sel, ok


@dataclasses.dataclass
class PhaseAHandle:
    """A split extraction with phase A launched and phase B not yet:
    ``a_out`` phase A's [pad, row] device output, ``copy`` its copy home
    (started at the launch), the frame's host ``flat`` and its device
    copies, the tier's config and the symmetry counts."""
    a_out: torch.Tensor
    copy: HostCopy
    flat: np.ndarray
    depth_d: torch.Tensor
    flat_d: torch.Tensor
    pad: int
    cfg: ExtractorConfig
    n_sym: tuple
    is_phase_a = True


def _phase_a(depth_d, flat_d, pad, cam: Camera, cfg: ExtractorConfig):
    """Phase A (JAX ``_extract_phase_a``): stages (a)-(c) of every
    detection (``_stage_a``: one depth_cloud launch, the border lane with
    sparse symmetry), packed into ONE [pad, row] device tensor for a single
    copy home.  Row: [pts_w (cap*3) | m2 (cap) | battr (cap, sparse
    symmetry only) | center_w (3), ok_points, ok_center]."""
    return _phase_a_rows(*_stage_a(
        depth_d, flat_d[:pad * 4].reshape(pad, 4),
        flat_d[pad * 6:pad * 6 + 7], flat_d[pad * 6 + 7:pad * 6 + 11], cam,
        cfg))


def _phase_a_rows(pts_v, pts_w, cells_v, m2, center_w, okp, okc, R_wc,
                  battr_v):
    """``_stage_a``'s outputs packed as phase A's [D, row] device tensor
    (the row layout of ``_phase_a``)."""
    f32 = pts_w.dtype
    parts = [pts_w.reshape(pts_w.shape[0], -1), m2.to(f32)]
    if battr_v is not None:
        parts.append(battr_v)
    parts += [center_w, okp[:, None].to(f32), okc[:, None].to(f32)]
    return torch.cat(parts, dim=1)


def _phase_a_row(row, cfg: ExtractorConfig):
    """One detection's phase-A row on the host: (pts_w [cap, 3], m2 [cap],
    center_w [3], ok_points, ok_center)."""
    cap = cfg.cloud_capacity
    sparse = cfg.open_symmetry and cfg.sparse_symmetry
    tail = row[cap * (5 if sparse else 4):]
    return (row[:cap * 3].reshape(cap, 3), row[cap * 3:cap * 4] > 0.5,
            tail[:3], tail[3] > 0.5, tail[4] > 0.5)


def _host_select(cfg: ExtractorConfig, run, row_of):
    """The host middle stage over the lanes of ``run`` [pad] bool:
    ``row_of(i)`` gives lane i's (pts_w, m2, center_w, ok_points,
    ok_center) on the host; its grid-hash union-find labels
    (io/native_loader.cluster_labels) and the reference's cluster
    selection.  Returns (valid [pad] float32: ok_points & ok_center &
    ok_cluster, 0 off the run lanes; sel [pad, cap] bool; the most
    survivors of a run lane)."""
    from ..io.native_loader import cluster_labels
    pad, cap = len(run), cfg.cloud_capacity
    sel = np.zeros((pad, cap), bool)
    valid = np.zeros(pad, np.float32)
    survivors = 0
    for i in np.flatnonzero(run):
        pts_w, m2, center_w, okp, okc = row_of(i)
        labels = cluster_labels(pts_w, m2, cfg.cluster_tolerance)
        sel[i], okcl = _select_cluster_np(
            pts_w, m2, labels, center_w, cfg.cluster_min_size,
            cfg.cluster_center_dis)
        valid[i] = float(okp and okc and okcl)
        survivors = max(survivors, int(m2.sum()))
    return valid, sel, survivors


def _host_cluster_select(h: PhaseAHandle):
    """The host middle stage (JAX ``_host_cluster_select``): waits on phase
    A's copy (its event only), then per run lane the grid-hash union-find
    labels (io/native_loader.cluster_labels) and the reference's cluster
    selection.  Returns (flat_b: the flat with ok_points & ok_center &
    ok_cluster folded into the run lane, sel [pad, cap] bool, the most
    survivors of a run lane)."""
    cfg, pad = h.cfg, h.pad
    a_np = h.copy.wait().numpy()
    flat_b = h.flat.copy()
    flat_b[pad * 4:pad * 5], sel, survivors = _host_select(
        cfg, h.flat[pad * 4:pad * 5] > 0.5,
        lambda i: _phase_a_row(a_np[i], cfg))
    return flat_b, sel, survivors


def _phase_b(h: PhaseAHandle, flat_b_d, sel_d, cam: Camera):
    """Phase B (JAX ``_extract_phase_b``): stages (e)-(h) from the host's
    selection ``sel_d`` [pad, cap]; the world cloud (and the border lane)
    are sliced out of phase A's DEVICE output, with no re-upload.  The
    symmetry stage runs over the frame's run lane as in the monolithic
    call; ``flat_b_d``'s run lane, the folded validity, gates the result.
    Returns (vec10, prob, valid, device stats)."""
    cfg, pad = h.cfg, h.pad
    cap = cfg.cloud_capacity
    pts_w = h.a_out[:, :cap * 3].reshape(pad, cap, 3).contiguous()
    battr_v = None
    if cfg.open_symmetry and cfg.sparse_symmetry:
        battr_v = h.a_out[:, cap * 4:cap * 5].contiguous()
    flat_d = h.flat_d
    dev_stats = {}
    e, p, ok, _ = _stages_after_selection(
        pts_w, sel_d, battr_v, h.depth_d, flat_d[:pad * 4].reshape(pad, 4),
        flat_d[pad * 4:pad * 5] > 0.5, flat_d[pad * 6:pad * 6 + 7],
        flat_d[pad * 6 + 7:pad * 6 + 11], cam, cfg, dev_stats,
        flat_d[pad * 5:pad * 6], h.n_sym[0] > 0, h.n_sym[1] > 0)
    return e, p, (flat_b_d[pad * 4:pad * 5] > 0.5) & ok, dev_stats


class SplitExtractor(_Extractor):
    """Two-phase extractor (JAX ``SplitExtractor``): device stages (a)-(c),
    the host's grid-hash union-find clustering and cluster selection
    (native/src/cluster.cpp, built at first use), device stages
    (e)-(h) + symmetry.

    A call launches phase A (one depth_cloud launch) and starts its
    result's copy home; it returns a ``PhaseAHandle``.  ``Tracking`` calls
    ``midway`` on it ``pipeline_depth // 2`` frames later: the host middle
    stage (``middle``: waits on the copy's event, labels and selects), then
    phase B (two pinned host-to-device copies, the selection and the new
    flat; launches from ``_stage_post`` on) returns an
    ``ExtractionHandle`` that ``fetch`` reads.  Its ``stats``: the cloud
    tier, the symmetry counts and ``cluster_survivors`` (the host's), with
    sparse symmetry the device counts of the monolithic call's after
    ``fetch``.  Raises a ``RuntimeError`` naming the compiler's error when
    the clustering library cannot be built: there is no fall-back to the
    monolithic extractor.
    """
    two_phase = True

    def __init__(self, cam: Camera, cfg: ExtractorConfig, device=None):
        from ..io import native_loader
        super().__init__(cam, cfg, device)
        if not native_loader.cluster_available():
            raise RuntimeError(
                f"{type(self).__name__}: the host clustering library does "
                f"not build from {native_loader.CLUSTER_SOURCE}: "
                f"{native_loader.cluster_error()}")

    def phase_a(self, flat, depth_d, flat_d, pad, cfg_t,
                n_sym) -> PhaseAHandle:
        a_out = _phase_a(depth_d, flat_d, pad, self.cam, cfg_t)
        return PhaseAHandle(a_out, HostCopy.start(a_out), flat, depth_d,
                            flat_d, pad, cfg_t, n_sym)

    def __call__(self, depth, bboxes, labels, pose_wc, ground_plane):
        if ground_plane is None:
            return None
        return self.phase_a(*self.upload(depth, bboxes, labels, pose_wc,
                                         ground_plane))

    def middle(self, h: PhaseAHandle):
        """The host middle stage (``_host_cluster_select``)."""
        return _host_cluster_select(h)

    def midway(self, h: PhaseAHandle) -> ExtractionHandle:
        """The host middle stage, then phase B's launches and the start of
        its result's copy home."""
        flat_b, sel, survivors = self.middle(h)
        flat_b_d = to_device(flat_b, self.device)
        sel_d = to_device(sel, self.device)
        self.stats = {"cloud_tier": h.cfg.cloud_capacity,
                      "sym_single": h.n_sym[0], "sym_dual": h.n_sym[1],
                      "cluster_survivors": survivors}
        e, p, v, dev_stats = _phase_b(h, flat_b_d, sel_d, self.cam)
        return _handle(e, p, v, self.stats, dev_stats)


def make_split_extractor(cam: Camera, cfg: ExtractorConfig, device=None):
    """The split extractor on ``device``; raises when the host clustering
    library cannot be built (no fall-back to the monolithic one)."""
    return SplitExtractor(cam, cfg, device)


class FusedSplitExtractor(SplitExtractor):
    """Host-clustered extraction at one call a frame (JAX
    ``FusedSplitExtractor``).

    ``step`` launches the new frame's phase A first (its copy home starts
    earliest), then takes the oldest pending frame at least ``chain_lag``
    steps behind, runs its host middle stage (its phase-A copy had that
    many frames to land) and launches its phase B.  Results therefore
    arrive tagged with the earlier frame's id; ``Tracking`` keeps a
    frame-id -> result map.  ``step_with_lm`` also issues the due LM call
    (LM fusion).  The cloud tier only grows over a run (JAX's monotone
    tier: its fused program was compiled per pair of tiers; here it keeps
    the same shapes, the results do not depend on the tier).  Eager
    PyTorch has no program to fuse: the launches are those of phase A,
    phase B and the LM, issued from one call.
    """
    two_phase = False
    fused = True
    supports_lm_fusion = True
    chain_lag = 2

    def __init__(self, cam: Camera, cfg: ExtractorConfig, device=None):
        super().__init__(cam, cfg, device)
        self._chain = deque()      # pending (frame_id, PhaseAHandle)
        self._tier = 0

    def _step(self, frame_id, depth, bboxes, labels, pose_wc, ground_plane,
              lm_args=None):
        if ground_plane is None:
            return False, [], None, None
        up = list(self.upload(depth, bboxes, labels, pose_wc, ground_plane))
        cfg_t = up[4]
        self._tier = max(self._tier, cfg_t.cloud_capacity)
        if cfg_t.cloud_capacity != self._tier:
            up[4] = dataclasses.replace(cfg_t, cloud_capacity=self._tier)
        h = self.phase_a(*up)
        results = []
        est = chi2 = None
        if len(self._chain) >= self.chain_lag:
            fid_prev, hp = self._chain.popleft()
            results.append((fid_prev, self.midway(hp)))
            if lm_args is not None:
                est, chi2 = _lm_from_flat(*lm_args)
        self._chain.append((frame_id, h))
        return True, results, est, chi2

    def step(self, frame_id, depth, bboxes, labels, pose_wc, ground_plane):
        """Launch the frame; returns (ran, [(frame_id, handle), ...])."""
        return self._step(frame_id, depth, bboxes, labels, pose_wc,
                          ground_plane)[:2]

    def step_with_lm(self, frame_id, depth, bboxes, labels, pose_wc,
                     ground_plane, lm_args):
        """``step`` with the due LM call issued after phase B.  Returns
        (ran, results, est, chi2); est / chi2 are None when no phase B was
        due (the caller then dispatches the prepared batch alone)."""
        return self._step(frame_id, depth, bboxes, labels, pose_wc,
                          ground_plane, lm_args)

    def drain(self, current_frame_id):
        """Phase B of the pending frames at least ``chain_lag`` frames old,
        without a new frame (``Tracking`` calls this on frames that launch
        no extraction)."""
        out = []
        while (self._chain and current_frame_id - self._chain[0][0]
               >= self.chain_lag):
            fid, hp = self._chain.popleft()
            out.append((fid, self.midway(hp)))
        return out

    def flush(self):
        """Phase B of every pending frame (the tail, ``sync``)."""
        out = []
        while self._chain:
            fid, hp = self._chain.popleft()
            out.append((fid, self.midway(hp)))
        return out


def make_fused_extractor(cam: Camera, cfg: ExtractorConfig, device=None):
    """The fused split extractor on ``device``; raises when the host
    clustering library cannot be built (no fall-back to the monolithic
    one)."""
    return FusedSplitExtractor(cam, cfg, device)
