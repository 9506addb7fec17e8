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

A round is two CUDA kernels (csrc/frontend.cu) for tensors on a CUDA
device: ``min_label_pass`` and ``pointer_jumps``; on the CPU their plain
versions ``min_label_pass_plain`` and ``pointer_jumps_plain``.  The JAX
module's grid-hash path, its exact broadcast pass and its interleaved
chain passes (``chains > 0``) are not ported and raise.
"""
from __future__ import annotations

import torch

from . import frontend_kernels as fk

_BIG = 2 ** 30
_PLAIN_ELEMS = 1 << 24   # most [rows, N] elements a plain pass holds at once
CHECK_EVERY = 4          # rounds enqueued between two reads of `changed`


def min_label_pass_plain(pts_c, nrm, mask, labels, tol2: float):
    """Plain PyTorch version of ``min_label_pass`` (any device): row blocks
    of the [N, N] test, so the matrix is never held whole."""
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


def min_label_pass(pts_c, nrm, mask, labels, tol2: float):
    """One pass: label_i <- min(label_i, min over neighbours j of label_j).

    pts_c [D, N, 3] float32 centred points (masked ones zeroed), nrm [D, N]
    their squared norms, mask [D, N] bool, labels [D, N] int32.  On a CUDA
    device one launch of the ``min_label_pass`` kernel; on the CPU the plain
    version.
    """
    if pts_c.device.type != "cuda":
        return min_label_pass_plain(pts_c, nrm, mask, labels, tol2)
    D, N = mask.shape
    dev = pts_c.device
    fk.check("pts_c", pts_c, torch.float32, (D, N, 3), dev)
    fk.check("nrm", nrm, torch.float32, (D, N), dev)
    fk.check("mask", mask, torch.bool, (D, N), dev)
    fk.check("labels", labels, torch.int32, (D, N), dev)
    out = torch.empty_like(labels)
    if D and N:
        fk.launch(fk.MIN_LABEL_PASS, "oslam_min_label_pass", dev,
                  [pts_c.data_ptr(), nrm.data_ptr(), mask.data_ptr(),
                   labels.data_ptr(), D, N, tol2, out.data_ptr()])
    return out


def pointer_jumps_plain(labels, prev, iters: int):
    """Plain PyTorch version of ``pointer_jumps`` (any device)."""
    N = labels.shape[1]
    for _ in range(iters):
        safe = labels.clamp(0, N - 1).long()
        labels = torch.where(labels < N, torch.gather(labels, 1, safe),
                             labels)
    return labels, (labels != prev).any(dim=1).to(torch.int32)


def pointer_jumps(labels, prev, iters: int):
    """``iters`` pointer jumps label_i <- label_{label_i} (labels >= N, the
    masked points', stay), each reading the labels of the jump before.
    Returns (labels, changed [D] int32: any label differs from ``prev``).
    ``labels`` may be overwritten.  On a CUDA device one launch of the
    ``pointer_jumps`` kernel; on the CPU the plain version."""
    if labels.device.type != "cuda":
        return pointer_jumps_plain(labels, prev, iters)
    D, N = labels.shape
    dev = labels.device
    fk.check("labels", labels, torch.int32, (D, N), dev)
    fk.check("prev", prev, torch.int32, (D, N), dev)
    changed = torch.empty((D,), dtype=torch.int32, device=dev)
    if D:
        tmp = torch.empty_like(labels)
        fk.launch(fk.POINTER_JUMPS, "oslam_pointer_jumps", dev,
                  [labels.data_ptr(), tmp.data_ptr(), prev.data_ptr(), D, N,
                   iters, changed.data_ptr()])
    return labels, changed


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
    tol = torch.sqrt(torch.tensor(tol2, dtype=torch.float32,
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


def _propagate(pass_fn, labels0, outer_iters: int, jump_iters: int):
    """Min-label rounds (pass, then ``jump_iters`` pointer jumps) until no
    label changed or ``outer_iters`` rounds ran.

    Returns (labels, converged [D] bool, rounds): converged is False for a
    detection whose propagation the bound truncated while labels were still
    changing; callers MUST surface that (a truncated run silently yields
    fragment components).  ``rounds`` is the number of rounds up to and
    including the first one that changed no label (or ``outer_iters``).

    The ``changed`` flag of a round stays on the device; the host reads the
    flags of ``CHECK_EVERY`` rounds at a time.  Labels are a fixed point
    once a round changes nothing, so the rounds enqueued past that one
    leave them as they are: labels and flag at exit are those of a loop
    that checks every round.
    """
    D = labels0.shape[0]
    dev = labels0.device

    def round_fn(labels):
        new, changed = pointer_jumps(pass_fn(labels), labels, jump_iters)
        return new, changed

    labels, _ = round_fn(labels0)
    rounds = 1
    still = torch.ones(D, dtype=torch.bool, device=dev)
    while rounds < outer_iters:
        flags = []
        for _ in range(min(CHECK_EVERY, outer_iters - rounds)):
            labels, changed = round_fn(labels)
            flags.append(changed)
        flags = torch.stack(flags).cpu().numpy() != 0      # [k, D]
        quiet = ~flags.any(axis=1)
        if quiet.any():
            return (labels, torch.ones(D, dtype=torch.bool, device=dev),
                    rounds + int(quiet.argmax()) + 1)
        rounds += len(flags)
        still = torch.as_tensor(flags[-1], device=dev)
    return labels, ~still, rounds


def connected_components(pts: torch.Tensor, mask: torch.Tensor, tol: float,
                         outer_iters: int = 8, jump_iters: int = 12,
                         exact: bool = False, with_converged: bool = False,
                         chains: int = -1, with_rounds: bool = False):
    """Labels [D, N] int32: each point's component id = min point index in
    its component.  pts [D, N, 3], mask [D, N].

    Masked-out points get label N (out of range).  With
    ``with_converged=True`` additionally returns the convergence flags [D]
    (see _propagate), with ``with_rounds=True`` the number of rounds.
    ``chains``: -1 seeds the labels along one spatial sort order, 0 does
    not; interleaved chain passes (``chains > 0``) and the exact broadcast
    pass are not ported.
    """
    if exact:
        raise NotImplementedError(
            "exact=True: the broadcast distance pass is not ported to the "
            "torch package")
    if chains > 0 or chains < -1:
        raise NotImplementedError(
            f"chains={chains}: interleaved chain passes (cluster_chains > 0) "
            "are not ported to the torch package")
    D, N = mask.shape
    tol2 = float(torch.tensor(tol * tol, dtype=torch.float32))
    idx = torch.arange(N, dtype=torch.int32, device=pts.device)
    labels0 = torch.where(mask, idx, N)
    if chains:
        labels0 = _chain_seed(pts, mask, labels0, tol2)

    # center once (labels are translation-invariant)
    w = mask[..., None]
    c = torch.where(w, pts, 0.0).sum(1) / mask.sum(1).clamp_min(1).to(
        pts.dtype)[:, None]
    pts_c = torch.where(w, pts - c[:, None, :], 0.0).contiguous()
    nrm = (pts_c * pts_c).sum(-1)
    mask = mask.contiguous()

    labels, conv, rounds = _propagate(
        lambda lab: min_label_pass(pts_c, nrm, mask, lab, tol2),
        labels0.contiguous(), outer_iters, jump_iters)
    out = (labels,)
    if with_converged:
        out += (conv,)
    if with_rounds:
        out += (rounds,)
    return out if len(out) > 1 else labels


def components_compacted(pts: torch.Tensor, mask: torch.Tensor, tol: float,
                         outer_iters: int, jump_iters: int,
                         compact_cap: int, with_converged: bool = False,
                         chains: int = -1, with_rounds: bool = False):
    """Components with the unmasked points compacted into the front
    ``compact_cap`` lanes.  PRECONDITION: mask.sum(1) <= compact_cap for
    every detection (overflowed points would silently be dropped).

    The supporting-plane filter discards a large part of the voxel cloud
    before clustering, but masked lanes still pay full price in every
    distance pass; compacting (stable order, so min-index labels map back
    exactly) cuts the quadratic pass cost.
    """
    D, N = mask.shape
    # stable: unmasked points keep their original relative order, so the
    # min compacted index maps to the min original index per component
    order = torch.sort((~mask).to(torch.int32), dim=1, stable=True).indices
    sub = order[:, :compact_cap]
    lab_c, conv, rounds = connected_components(
        torch.gather(pts, 1, sub[..., None].expand(-1, -1, 3)),
        torch.gather(mask, 1, sub), tol, outer_iters, jump_iters,
        with_converged=True, chains=chains, with_rounds=True)
    sub32 = sub.to(torch.int32)
    orig = torch.where(
        lab_c < compact_cap,
        torch.gather(sub32, 1, lab_c.clamp(0, compact_cap - 1).long()), N)
    labels = torch.full((D, N), N, dtype=torch.int32, device=pts.device)
    labels.scatter_(1, sub, orig)
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
