"""Euclidean clustering (connected components of the radius graph),
batched over detections.

Port of the dense path of ``object_oriented_slam_tpu/ops/cluster.py``,
which replaces PCL ``EuclideanClusterExtraction`` + KdTree
(src/pca/EllipsoidExtractor.cpp:646-737): points closer than ``tolerance``
are connected; connected components are clusters; clusters smaller than
``min_size`` are dropped; the selected cluster is the largest one whose
minimum distance to the 2D-center-estimate is below ``center_dis``
(PCL returns clusters sorted by size descending; single-cluster frames are
accepted unconditionally, EllipsoidExtractor.cpp:696-714).

Algorithm: iterative minimum-label propagation over the radius graph,
interleaved with pointer-jumping to collapse long chains in O(log N) extra
steps.  The radius test is ``nrm_i + nrm_j - 2 (x_i . x_j) <= tol^2`` on
points centred on the masked mean (centring bounds the f32 cancellation of
the expansion to ~1e-8 m^2 on metre-scale clouds), the dot product written
as ``x0*y0 + x1*y1 + x2*y2``.  A pair within that band of the radius may
fall differently under another rounding; it changes labels only when it is
the sole bridge between two components.

For tensors on a CUDA device the compaction and all rounds of a frame are
one launch of the ``cluster_components`` kernel (csrc/frontend.cu, a thread
block cluster per detection, nothing read back between rounds), with the
cluster selection as its epilogue when ``cluster_select`` asks for it; on
the CPU ``cluster_components_plain``, a loop over ``min_label_pass_plain``
(one pass) and ``pointer_jumps_plain`` (the jumps), and
``select_cluster``.  The JAX module's
grid-hash path, its exact broadcast pass and its interleaved chain passes
(``chains > 0``) are not ported and raise.

The offline batch mapper (``frontend/batch_extractor``) clusters the
detections of B frames in the same one launch.  JAX's batch extractor
scans its clustering frame by frame (``cluster_groups``, a ``lax.map``) so
that each group pays its own rounds, not the slowest detection's of the
batch; nothing here needs that: the kernel gives every detection its own
rounds and stops each on its own.  Its sort-frame hint is then one
rotation a detection (``frame`` [D, 3, 3]), since the batch's clouds are
sorted in B cameras' frames.
"""
from __future__ import annotations

import torch

from . import frontend_kernels as fk

_BIG = 2 ** 30
_PLAIN_ELEMS = 1 << 24   # most [rows, N] elements a plain pass holds at once


def min_label_pass_plain(pts_c, nrm, mask, labels, tol2: float):
    """One pass: label_i <- min(label_i, min over neighbours j of label_j),
    plain PyTorch on any device.  pts_c [D, N, 3] float32 centred points
    (masked ones zeroed), nrm [D, N] their squared norms, mask [D, N] bool,
    labels [D, N] int32.  Row blocks of the [N, N] test, so the matrix is
    never held whole."""
    D, N = mask.shape
    rows = max(1, min(N, _PLAIN_ELEMS // max(D * N, 1)))
    x, y, z = pts_c.unbind(-1)
    lab_j = torch.where(mask, labels, _BIG)[:, None, :]
    out = []
    for b in range(0, N, rows):
        s = slice(b, b + rows)
        cross = (x[:, s, None] * x[:, None, :] + y[:, s, None] * y[:, None, :]
                 + z[:, s, None] * z[:, None, :])
        d2 = nrm[:, s, None] + nrm[:, None, :] - 2.0 * cross
        out.append(torch.where(d2 <= tol2, lab_j, _BIG).amin(dim=2))
    new = torch.cat(out, dim=1)
    return torch.where(mask, torch.minimum(labels, new), labels)


def pointer_jumps_plain(labels, prev, iters: int):
    """``iters`` pointer jumps label_i <- label_{label_i} (labels >= N, the
    masked points', stay), each reading the labels of the jump before, plain
    PyTorch on any device.  Returns (labels, changed [D] int32: any label
    differs from ``prev``)."""
    N = labels.shape[1]
    for _ in range(iters):
        safe = labels.clamp(0, N - 1).long()
        labels = torch.where(labels < N, torch.gather(labels, 1, safe),
                             labels)
    return labels, (labels != prev).any(dim=1).to(torch.int32)


def _seg_min_scan(vals, start):
    """Inclusive running minimum of ``vals`` [D, N] (values in [0, 2^30])
    that restarts wherever ``start`` is set: each segment is moved below all
    earlier ones, so one ``cummin`` over the row serves every segment."""
    seg = torch.cumsum(start.to(torch.int64), dim=1)
    shifted = vals.to(torch.int64) - seg * (2 * _BIG)
    return (torch.cummin(shifted, dim=1).values + seg * (2 * _BIG)
            ).to(vals.dtype)


def _chain_seed(pts, mask, labels0, tol2: float):
    """Cheap label seeding along one spatial sort order: points are sorted
    by a voxel key of edge ``tol``; neighbours in the sort that pass the
    exact f32 radius test are linked, and a forward and a backward
    segmented min-scan spread the least label along each linked run.  The
    links are a subset of the radius graph, so seeding never merges across
    components; it only shortens the propagation.
    """
    D, N = mask.shape
    tol = torch.sqrt(torch.full((), tol2, dtype=torch.float32,
                                device=pts.device))
    c = (torch.floor(pts / tol).to(torch.int32) + 512).clamp(0, 1023)
    key = (c[..., 0] << 20) | (c[..., 1] << 10) | c[..., 2]
    key = torch.where(mask, key, _BIG)
    order = torch.sort(key, dim=1, stable=True).indices
    pts_s = torch.gather(pts, 1, order[..., None].expand(-1, -1, 3))
    mask_s = torch.gather(mask, 1, order)
    d2prev = ((pts_s[:, 1:] - pts_s[:, :-1]) ** 2).sum(-1)
    false = torch.zeros((D, 1), dtype=torch.bool, device=pts.device)
    linked = torch.cat([false, (d2prev <= tol2) & mask_s[:, 1:]
                        & mask_s[:, :-1]], dim=1)
    lab_s = torch.gather(labels0, 1, order)
    fwd = _seg_min_scan(lab_s, ~linked)
    linked_next = torch.cat([linked[:, 1:], false], dim=1)
    bwd = _seg_min_scan(lab_s.flip(1), (~linked_next).flip(1)).flip(1)
    seeded = torch.empty_like(labels0).scatter_(1, order,
                                                torch.minimum(fwd, bwd))
    return torch.where(mask, seeded, N)


def _compact(mask, *lanes):
    """The unmasked lanes moved to the front, in their original order, of
    the largest survivor count (one host read).  Returns (sub [D, cap] the
    lanes taken, the gathered mask, the gathered ``lanes`` tensors)."""
    cap = max(int(mask.sum(1).max()), 1) if mask.shape[0] else 1
    # stable: unmasked points keep their original relative order, so the
    # min compacted index maps to the min original index per component
    sub = torch.sort((~mask).to(torch.int32), dim=1, stable=True
                     ).indices[:, :cap]
    out = []
    for t in lanes:
        i = sub if t.dim() == 2 else sub[..., None].expand(-1, -1, t.shape[2])
        out.append(torch.gather(t, 1, i).contiguous())
    return sub, torch.gather(mask, 1, sub).contiguous(), out


def _rounds_loop(pts_c, nrm, mask, labels0, tol2: float, outer_iters: int,
                 jump_iters: int):
    """The propagation as a loop of single steps: the unmasked points are
    compacted to the front with a stable sort, rounds of (one pass,
    ``jump_iters`` jumps) run until no detection changes a
    label or ``outer_iters`` rounds ran (one host read a round), and the
    labels are mapped back to the original lanes.

    Labels are a fixed point once a round changes nothing, so a detection
    that went quiet keeps its labels while the others go on (a round
    passes over the detections still changing only): labels,
    ``converged`` and ``rounds`` are those of a loop per detection.
    """
    D, N = mask.shape
    dev = mask.device
    sub, m_c, (pts_k, nrm_k, l0) = _compact(mask, pts_c, nrm, labels0)
    cap = sub.shape[1]
    # a seeded label names an original lane: its compacted index is the
    # count of unmasked lanes before it
    rank = (torch.cumsum(mask.to(torch.int32), dim=1) - 1).to(torch.int32)
    lab = torch.where(m_c, torch.gather(rank, 1, l0.clamp(0, N - 1).long()),
                      cap).to(torch.int32).contiguous()
    rounds = torch.zeros(D, dtype=torch.int32, device=dev)
    still = torch.ones(D, dtype=torch.bool, device=dev)
    for r in range(1, outer_iters + 1):
        rows = still.nonzero().flatten()
        new, changed = pointer_jumps_plain(
            min_label_pass_plain(pts_k[rows], nrm_k[rows], m_c[rows],
                                 lab[rows], tol2), lab[rows], jump_iters)
        lab = lab.index_copy(0, rows, new)
        rounds[rows] = r
        still = still.index_copy(0, rows, changed != 0)
        if not bool(still.any()):
            break
    sub32 = sub.to(torch.int32)
    orig = torch.where(lab < cap,
                       torch.gather(sub32, 1, lab.clamp(0, cap - 1).long()),
                       N)
    labels = torch.full((D, N), N, dtype=torch.int32, device=dev)
    labels.scatter_(1, sub, orig)
    return labels, ~still, rounds


def cluster_components_plain(pts_c, nrm, mask, labels0, tol2: float,
                             outer_iters: int, jump_iters: int = 12):
    """Plain PyTorch version of ``cluster_components`` (any device):
    ``_rounds_loop`` over ``min_label_pass_plain`` and
    ``pointer_jumps_plain``."""
    return _rounds_loop(pts_c, nrm, mask, labels0, tol2, outer_iters,
                        jump_iters)


# the clustering kernel's launch: blocks per detection (the cluster size),
# threads per block, and the points a lane keeps in registers, which is a
# constant of the build (OSLAM_CC_P in csrc/frontend.cu; the launch is
# refused if the two differ).  examples/torch_cluster_sweep.py times the
# choices
LAUNCH_SHAPE = (8, 512, 2)
_SMEM_MAX = 227 * 1024 - 1024  # dynamic shared memory a block may ask for,
#                                less the kernel's static part
_SMEM_FIXED, _SMEM_RESIDENT = 13, 29    # bytes a lane: lane list, two label
#                                buffers, boxes; and with the float4 point


def launch_smem(N: int) -> int:
    """Dynamic shared memory for ``N`` lanes: everything resident where it
    fits, else the fixed part and what is left as the streaming tile."""
    n_pad = -(-N // 32) * 32
    need = _SMEM_FIXED * n_pad + 16 * 256
    if need > _SMEM_MAX:
        raise ValueError(
            f"cluster_components takes at most "
            f"{(_SMEM_MAX - 16 * 256) // _SMEM_FIXED // 32 * 32} lanes a "
            f"detection (got {N}): the labels of a detection stay in one "
            "block's shared memory")
    return min(_SMEM_MAX, max(need, _SMEM_RESIDENT * n_pad))


def _launch(pts_c, nrm, mask, labels0, tol2, outer_iters, jump_iters, frame,
            select=None, shape=None, smem=None, prune=True):
    """One launch of the clustering kernel on CUDA tensors, checked.
    ``select`` = (pts, center, min_size, center_dis) asks for the selection
    epilogue.  For the sweep and the kernel's tests only: ``shape`` = (blocks
    per detection, threads, points a lane) and ``smem`` override the launch,
    ``prune=False`` tests every pair.  Returns (labels, converged, rounds,
    sel | None, ok | None)."""
    D, N = mask.shape
    dev = pts_c.device
    if frame is None:
        frame = torch.eye(3, dtype=torch.float32, device=dev)
    fk.check("pts_c", pts_c, torch.float32, (D, N, 3), dev)
    fk.check("nrm", nrm, torch.float32, (D, N), dev)
    fk.check("mask", mask, torch.bool, (D, N), dev)
    fk.check("labels0", labels0, torch.int32, (D, N), dev)
    per_detection = frame.dim() == 3
    fk.check("frame", frame, torch.float32,
             (D, 3, 3) if per_detection else (3, 3), dev)
    if outer_iters < 1 or jump_iters < 0:
        raise ValueError(f"outer_iters={outer_iters}, jump_iters={jump_iters}")
    labels = torch.empty_like(labels0)
    conv = torch.empty((D,), dtype=torch.bool, device=dev)
    rounds = torch.empty((D,), dtype=torch.int32, device=dev)
    S, T, P = shape or LAUNCH_SHAPE
    args = [pts_c.data_ptr(), nrm.data_ptr(), mask.data_ptr(),
            labels0.data_ptr(), D, N, tol2, outer_iters, jump_iters, S, T, P,
            smem or launch_smem(N), int(prune), frame.data_ptr(),
            9 if per_detection else 0, labels.data_ptr(),
            conv.data_ptr(), rounds.data_ptr()]
    sel = ok = None
    fn = "oslam_cluster_components"
    if select is not None:
        pts, center, min_size, center_dis = select
        fk.check("pts", pts, torch.float32, (D, N, 3), dev)
        fk.check("center", center, torch.float32, (D, 3), dev)
        if min_size < 1:
            raise ValueError(f"min_size={min_size}: a cluster has a point")
        sel = torch.empty((D, N), dtype=torch.bool, device=dev)
        ok = torch.empty((D,), dtype=torch.bool, device=dev)
        least_d = torch.empty((D, N), dtype=torch.int32, device=dev)
        args += [pts.data_ptr(), center.data_ptr(), min_size, center_dis,
                 least_d.data_ptr(), sel.data_ptr(), ok.data_ptr()]
        fn = "oslam_cluster_select"
    if D and N:
        fk.launch(fk.CLUSTER_COMPONENTS, fn, dev, args)
    else:
        conv.fill_(True)
        rounds.fill_(1)
        if ok is not None:
            ok.fill_(False)
    return labels, conv, rounds, sel, ok


def cluster_components(pts_c, nrm, mask, labels0, tol2: float,
                       outer_iters: int, jump_iters: int = 12, frame=None):
    """The whole propagation of a frame: for each detection, rounds of one
    min-label pass over the radius graph and ``jump_iters`` synchronous
    pointer jumps, until a round changes no label or ``outer_iters`` ran.

    pts_c [D, N, 3] float32 centred points, nrm [D, N] their squared norms,
    mask [D, N] bool, labels0 [D, N] int32 the starting labels in lane
    numbering (an unmasked lane carries an unmasked lane <= itself: its own
    index or ``_chain_seed``'s; masked lanes N).  Returns (labels [D, N]
    int32: the least lane of each point's component, N on masked lanes;
    converged [D] bool: a round that changed nothing came within the bound;
    rounds [D] int32: rounds run, the quiet one included), all on the
    device: nothing is read back.

    On a CUDA device one launch of the ``cluster_components`` kernel; on
    the CPU ``cluster_components_plain``.  ``frame`` [3, 3] float32 is a
    hint for the kernel's skip of far groups and changes no result: the
    rotation (rows u, v, w, in the coordinates of ``pts_c``) of the frame
    whose cells the cloud is sorted by, for a voxel cloud the camera's
    axes; left out, the identity (the kernel also takes the identity for a
    matrix that is no rotation).  ``frame`` [D, 3, 3] gives each detection
    its own (the offline batch mapper: the detections of a batch come from
    frames of different poses).
    """
    if pts_c.device.type != "cuda":
        return cluster_components_plain(pts_c, nrm, mask, labels0, tol2,
                                        outer_iters, jump_iters)
    return _launch(pts_c, nrm, mask, labels0, tol2, outer_iters, jump_iters,
                   frame)[:3]


def cluster_select_plain(pts, pts_c, nrm, mask, labels0, center, tol2: float,
                         outer_iters: int, jump_iters: int, min_size: int,
                         center_dis: float):
    """Plain PyTorch version of ``cluster_select`` (any device):
    ``cluster_components_plain``, then ``select_cluster`` on its labels."""
    labels, conv, rounds = cluster_components_plain(
        pts_c, nrm, mask, labels0, tol2, outer_iters, jump_iters)
    sel, ok = select_cluster(pts, mask, labels, center, min_size, center_dis)
    return sel, ok & conv, labels, conv, rounds


def cluster_select(pts, pts_c, nrm, mask, labels0, center, tol2: float,
                   outer_iters: int, jump_iters: int, min_size: int,
                   center_dis: float, frame=None):
    """``cluster_components`` followed by ``select_cluster`` on its labels.

    pts [D, N, 3] the points the centre distances are taken on (the
    uncentred ones), center [D, 3]; the rest as ``cluster_components``.
    Returns (sel [D, N] bool: the points of the chosen cluster; ok [D] bool:
    a cluster was chosen AND the detection's propagation converged (a
    truncated run yields fragment components: it must fail the gate);
    labels, converged, rounds).

    On a CUDA device the selection is the epilogue of the same one launch
    (the labels are still in shared memory); on the CPU
    ``cluster_select_plain``.
    """
    if pts_c.device.type != "cuda":
        return cluster_select_plain(pts, pts_c, nrm, mask, labels0, center,
                                    tol2, outer_iters, jump_iters, min_size,
                                    center_dis)
    labels, conv, rounds, sel, ok = _launch(
        pts_c, nrm, mask, labels0, tol2, outer_iters, jump_iters, frame,
        (pts, center, min_size, center_dis))
    return sel, ok, labels, conv, rounds


def centre_and_seed(pts, mask, tol: float, chains: int = -1):
    """What ``cluster_components`` takes, from a frame's points: (pts_c,
    nrm, mask, labels0, tol2).  The points are centred on the masked mean
    once (labels are translation-invariant); ``chains`` = -1 seeds the
    labels along one spatial sort order, 0 leaves each point its own."""
    D, N = mask.shape
    tol2 = float(torch.tensor(tol * tol, dtype=torch.float32))
    idx = torch.arange(N, dtype=torch.int32, device=pts.device)
    labels0 = torch.where(mask, idx, N)
    if chains:
        labels0 = _chain_seed(pts, mask, labels0, tol2)
    w = mask[..., None]
    c = torch.where(w, pts, 0.0).sum(1) / mask.sum(1).clamp_min(1).to(
        pts.dtype)[:, None]
    pts_c = torch.where(w, pts - c[:, None, :], 0.0).contiguous()
    nrm = (pts_c * pts_c).sum(-1)
    return pts_c, nrm, mask.contiguous(), labels0.contiguous(), tol2


def connected_components(pts: torch.Tensor, mask: torch.Tensor, tol: float,
                         outer_iters: int = 8, jump_iters: int = 12,
                         exact: bool = False, with_converged: bool = False,
                         chains: int = -1, with_rounds: bool = False,
                         frame=None):
    """Labels [D, N] int32: each point's component id = min point index in
    its component.  pts [D, N, 3], mask [D, N]; ``frame``: see
    ``cluster_components``.

    Masked-out points get label N (out of range).  Both the kernel and the
    plain loop compact the unmasked points first (stable order, so the
    min-index labels map back exactly) to the survivors there are, so this
    is also the JAX package's ``components_compacted``, whose static lane
    count has no counterpart here.  With
    ``with_converged=True`` additionally returns the convergence flags [D]:
    False for a detection whose propagation the bound truncated while
    labels were still changing; callers MUST surface that (a truncated run
    silently yields fragment components).  With ``with_rounds=True`` also
    the rounds [D] each detection ran, up to and including the first one
    that changed no label.  ``chains``: -1 seeds the labels along one
    spatial sort order, 0 does not; interleaved chain passes
    (``chains > 0``) and the exact broadcast pass are not ported.
    """
    if exact:
        raise NotImplementedError(
            "exact=True: the broadcast distance pass is not ported to the "
            "torch package")
    if chains > 0 or chains < -1:
        raise NotImplementedError(
            f"chains={chains}: interleaved chain passes (cluster_chains > 0) "
            "are not ported to the torch package")
    labels, conv, rounds = cluster_components(
        *centre_and_seed(pts, mask, tol, chains), outer_iters, jump_iters,
        frame=frame)
    out = (labels,)
    if with_converged:
        out += (conv,)
    if with_rounds:
        out += (rounds,)
    return out if len(out) > 1 else labels


def select_cluster(pts: torch.Tensor, mask: torch.Tensor,
                   labels: torch.Tensor, center: torch.Tensor, min_size: int,
                   center_dis: float):
    """Reference cluster-selection semantics (EllipsoidExtractor.cpp:675-736).

    pts [D, N, 3], mask [D, N], labels [D, N], center [D, 3].
    Returns (point mask [D, N] of the chosen cluster, ok [D]).  Sizes are
    sums of ones (exact in f32) and a min has no order, so the scatters are
    deterministic on the card too.
    """
    D, N = mask.shape
    dev = pts.device
    seg = torch.where(mask, labels, N).long()
    sizes = torch.zeros((D, N + 1), dtype=torch.float32, device=dev)
    sizes.scatter_add_(1, seg, torch.ones((D, N), dtype=torch.float32,
                                          device=dev))
    sizes = sizes[:, :N]
    # per-cluster min distance to the center estimate
    d = torch.sqrt(((pts - center[:, None, :]) ** 2).sum(-1))
    d = torch.where(mask, d, torch.inf)
    min_d = torch.full((D, N + 1), torch.inf, dtype=torch.float32, device=dev)
    min_d.scatter_reduce_(1, seg, d, reduce="amin")
    min_d = min_d[:, :N]

    is_cluster = sizes >= min_size          # root slots with enough points
    n_clusters = is_cluster.sum(1)
    near = is_cluster & (min_d < center_dis)
    n_near = near.sum(1)

    # order by size desc: pick the largest "near" cluster (PCL sorts clusters
    # by size descending and the reference takes the first passing one);
    # argmax returns the first of equal maxima, like jnp.argmax
    best_near = torch.argmax(torch.where(near, sizes, -1.0), dim=1)
    # single-cluster fallback: accepted unconditionally
    best_any = torch.argmax(torch.where(is_cluster, sizes, -1.0), dim=1)

    use_fallback = (n_clusters == 1) & (n_near == 0)
    chosen = torch.where(use_fallback, best_any, best_near)
    ok = (n_near > 0) | use_fallback

    sel = mask & (labels == chosen[:, None]) & ok[:, None]
    return sel, ok
