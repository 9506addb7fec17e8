"""Euclidean clustering (connected components of the radius graph),
batched over detections.

Port of ``object_oriented_slam_tpu/ops/cluster.py``, which replaces PCL
``EuclideanClusterExtraction`` + KdTree
(src/pca/EllipsoidExtractor.cpp:646-737): points closer than ``tolerance``
are connected; connected components are clusters; clusters smaller than
``min_size`` are dropped; the selected cluster is the largest one whose
minimum distance to the 2D-center-estimate is below ``center_dis``
(PCL returns clusters sorted by size descending; single-cluster frames are
accepted unconditionally, EllipsoidExtractor.cpp:696-714).

Algorithm: iterative minimum-label propagation over the radius graph,
interleaved with pointer-jumping to collapse long chains in O(log N) extra
steps.  Three passes, as in the JAX module:

* the default dense pass: ``nrm_i + nrm_j - 2 (x_i . x_j) <= tol^2`` on
  points centred on the masked mean (centring bounds the f32 cancellation
  of the expansion to ~1e-8 m^2 on metre-scale clouds), the dot product
  written as ``x0*y0 + x1*y1 + x2*y2``.  A pair within that band of the
  radius may fall differently under another rounding; it changes labels
  only when it is the sole bridge between two components;
* ``exact=True``: the direct ``((dx*dx + dy*dy) + dz*dz) <= tol^2`` on the
  uncentred points;
* the grid pass (``connected_components_grid``, the extractor's
  ``grid_cluster``): for voxel clouds, whose points each hold a cell of
  their own, every radius neighbour lies in the <= 124 stencil cells around
  a point's cell; the neighbour table is built once (the exact test on each
  stencil cell's point) and a pass is a gather and a minimum over it.

``chains`` seeds the labels along |chains| spatial sort orders (-1, the
default: one) and, when positive, also runs one chain pass per order after
every dense pass (``_chain_apply``).

For tensors on a CUDA device the compaction and all rounds of a frame are
one launch (csrc/frontend.cu, a thread block cluster per detection, nothing
read back between rounds), with the cluster selection as its epilogue when
asked: ``cluster_components`` (K5), its exact lane and its chain lane, and
``cluster_grid`` (K13, a kernel of its own: a sorted key table and the
neighbour lists in shared memory, its own launch shape ``grid_shape``); on
the CPU their plain versions, ``_rounds_loop``
over one pass function (``min_label_pass_plain``,
``min_label_pass_exact_plain`` or the grid table's minimum), the chain
passes and ``pointer_jumps_plain``, then ``select_cluster``.  No plain
version runs on the card: with any option on, the card runs K13 or a lane
of K5.

The JAX module's compaction ladder (``components_compacted`` at a compiled
capacity, ``connected_components_compact``'s choice between capacities) has
no use here: both the kernel and the plain loop compact each detection to
its own survivors, and labels are the same at every capacity.  The two
functions keep the JAX signatures and results.

The offline batch mapper (``frontend/batch_extractor``) clusters the
detections of B frames in the same one launch.  JAX's batch extractor
scans its clustering frame by frame (``cluster_groups``, a ``lax.map``) so
that each group pays its own rounds, not the slowest detection's of the
batch; nothing here needs that: the kernel gives every detection its own
rounds and stops each on its own.  Its sort-frame hint is then one
rotation a detection (``frame`` [D, 3, 3]), since the batch's clouds are
sorted in B cameras' frames.  K13 needs no hint: each detection's cells are
its own camera's.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import frontend_kernels as fk

_BIG = 2 ** 30
_PLAIN_ELEMS = 1 << 24   # most [rows, N] elements a plain pass holds at once
_CHAIN_PERMS = ((0, 1, 2), (1, 2, 0), (2, 0, 1))


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


def min_label_pass_exact_plain(pts, mask, labels, tol2: float):
    """One exact pass (JAX ``_min_label_pass``): ``min_label_pass_plain``
    with the direct test ``((dx*dx + dy*dy) + dz*dz) <= tol2`` on the
    uncentred points pts [D, N, 3]."""
    D, N = mask.shape
    rows = max(1, min(N, _PLAIN_ELEMS // max(D * N, 1)))
    x, y, z = pts.unbind(-1)
    lab_j = torch.where(mask, labels, _BIG)[:, None, :]
    out = []
    for b in range(0, N, rows):
        s = slice(b, b + rows)
        dx = x[:, s, None] - x[:, None, :]
        dy = y[:, s, None] - y[:, None, :]
        dz = z[:, s, None] - z[:, None, :]
        d2 = (dx * dx + dy * dy) + dz * dz
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


def _sq_dist(a, b):
    """((dx*dx + dy*dy) + dz*dz) of a - b over the last axis, each
    operation rounded on its own (JAX's ``jnp.sum((a - b) ** 2, -1)``)."""
    d = a - b
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
        + d[..., 2] * d[..., 2]


def _chain_structs(pts, mask, tol2: float, n_orders: int):
    """The ``n_orders`` spatial chain orders (JAX ``_chain_structs``), each
    (order [D, N] int64, linked [D, N] bool): the points sorted (stably) by
    a voxel key of edge ``tol`` with the axes permuted (``_CHAIN_PERMS``;
    masked points last, under 2^30), and linked[k] when the point at k and
    the one before it pass the exact f32 radius test.  The links are a
    subset of the radius graph, so chain passes never merge across
    components; they only shorten the propagation.  ``n_orders`` is
    clamped to the three distinct permutations."""
    tol = torch.sqrt(torch.full((), tol2, dtype=torch.float32,
                                device=pts.device))
    c = (torch.floor(pts / tol).to(torch.int32) + 512).clamp(0, 1023)
    false = torch.zeros((mask.shape[0], 1), dtype=torch.bool,
                        device=pts.device)
    structs = []
    for p in _CHAIN_PERMS[:min(n_orders, len(_CHAIN_PERMS))]:
        key = (c[..., p[0]] << 20) | (c[..., p[1]] << 10) | c[..., p[2]]
        key = torch.where(mask, key, _BIG)
        order = torch.sort(key, dim=1, stable=True).indices
        pts_s = torch.gather(pts, 1, order[..., None].expand(-1, -1, 3))
        mask_s = torch.gather(mask, 1, order)
        linked = torch.cat([false, (_sq_dist(pts_s[:, 1:], pts_s[:, :-1])
                                    <= tol2) & mask_s[:, 1:]
                            & mask_s[:, :-1]], dim=1)
        structs.append((order, linked))
    return structs


def _chain_apply(labels, order, linked):
    """One bidirectional min-label pass along a chain order (JAX
    ``_chain_apply``): labels [D, L]; order [D, L] a permutation of the
    lanes, linked [D, L] its links.  A forward and a backward segmented
    minimum spread the least label along each linked run."""
    lab_s = torch.gather(labels, 1, order)
    fwd = _seg_min_scan(lab_s, ~linked)
    linked_next = torch.cat([linked[:, 1:], torch.zeros_like(linked[:, :1])],
                            dim=1)
    bwd = _seg_min_scan(lab_s.flip(1), (~linked_next).flip(1)).flip(1)
    return torch.empty_like(labels).scatter_(1, order,
                                             torch.minimum(fwd, bwd))


def _chain_seed(pts, mask, labels0, tol2: float, structs=None):
    """Cheap label seeding along spatial sort orders (JAX ``_chain_seed``;
    ``structs`` from ``_chain_structs``, None: one order): dense clouds
    start the rounds mostly pre-merged, with no distance pass."""
    if structs is None:
        structs = _chain_structs(pts, mask, tol2, 1)
    for order, linked in structs:
        labels0 = _chain_apply(labels0, order, linked)
    return torch.where(mask, labels0, mask.shape[1])


def chain_orders(structs, mask):
    """The chain lane's orders in the kernel's compacted numbering: (order
    [D, K, N] int32, link [D, K, N] uint8) from ``_chain_structs``.  Entry k
    < n (the detection's survivors) is the compacted index of the k-th
    point of the order (the survivors sort first); entries from n on are k
    itself, so every prefix of length >= n is a permutation (the plain
    loop's compacted lanes)."""
    N = mask.shape[1]
    rank = (torch.cumsum(mask.to(torch.int32), dim=1) - 1).to(torch.int32)
    pos = torch.arange(N, dtype=torch.int32, device=mask.device)
    live = pos[None, :] < mask.sum(1, dtype=torch.int32)[:, None]
    orders = [torch.where(live, torch.gather(rank, 1, order), pos)
              for order, _ in structs]
    return (torch.stack(orders, 1).contiguous(),
            torch.stack([linked for _, linked in structs], 1).to(
                torch.uint8).contiguous())


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


def _compact_labels(mask, labels0, *lanes):
    """``_compact`` plus the starting labels in compacted numbering (a
    seeded label names an original lane: its compacted index is the count
    of unmasked lanes before it).  Returns (sub, m_c, lanes, labels)."""
    N = mask.shape[1]
    sub, m_c, out = _compact(mask, *lanes)
    cap = sub.shape[1]
    rank = (torch.cumsum(mask.to(torch.int32), dim=1) - 1).to(torch.int32)
    l0 = torch.gather(labels0, 1, sub)
    lab = torch.where(m_c, torch.gather(rank, 1, l0.clamp(0, N - 1).long()),
                      cap).to(torch.int32).contiguous()
    return sub, m_c, out, lab


def _uncompact(lab, sub, N: int):
    """Compacted labels [D, cap] back in the original lanes [D, N]."""
    cap = sub.shape[1]
    orig = torch.where(lab < cap,
                       torch.gather(sub.to(torch.int32), 1,
                                    lab.clamp(0, cap - 1).long()), N)
    labels = torch.full(sub.shape[:1] + (N,), N, dtype=torch.int32,
                        device=sub.device)
    return labels.scatter_(1, sub, orig)


def _rounds_loop(lab, pass_fn, outer_iters: int, jump_iters: int,
                 chains=()):
    """The propagation as a loop of single steps, in compacted numbering:
    rounds of (one pass ``pass_fn(rows, labels of those rows)``, the chain
    passes along ``chains`` ((order, linked) [D, cap] pairs) and
    ``jump_iters`` jumps) until no detection changes a label or
    ``outer_iters`` rounds ran (one host read a round).

    Labels are a fixed point once a round changes nothing, so a detection
    that went quiet keeps its labels while the others go on (a round
    passes over the detections still changing only): labels,
    ``converged`` and ``rounds`` are those of a loop per detection.
    Returns (labels, converged [D], rounds [D]).
    """
    D = lab.shape[0]
    dev = lab.device
    rounds = torch.zeros(D, dtype=torch.int32, device=dev)
    still = torch.ones(D, dtype=torch.bool, device=dev)
    for r in range(1, outer_iters + 1):
        rows = still.nonzero().flatten()
        new = pass_fn(rows, lab[rows])
        for order, linked in chains:
            new = _chain_apply(new, order[rows], linked[rows])
        new, changed = pointer_jumps_plain(new, lab[rows], jump_iters)
        lab = lab.index_copy(0, rows, new)
        rounds[rows] = r
        still = still.index_copy(0, rows, changed != 0)
        if not bool(still.any()):
            break
    return lab, ~still, rounds


def cluster_components_plain(pts_c, nrm, mask, labels0, tol2: float,
                             outer_iters: int, jump_iters: int = 12,
                             exact: bool = False, orders=None):
    """Plain PyTorch version of ``cluster_components`` (any device): the
    unmasked points compacted to the front with a stable sort,
    ``_rounds_loop`` over ``min_label_pass_plain`` (``exact``:
    ``min_label_pass_exact_plain`` on the uncentred points ``pts_c``) with
    the chain passes of ``orders`` (``chain_orders``; None: none), and the
    labels mapped back to the original lanes."""
    N = mask.shape[1]
    sub, m_c, (pts_k, nrm_k), lab = _compact_labels(mask, labels0, pts_c,
                                                    nrm)
    cap = sub.shape[1]
    if exact:
        def pass_fn(rows, lab_r):
            return min_label_pass_exact_plain(pts_k[rows], m_c[rows], lab_r,
                                              tol2)
    else:
        def pass_fn(rows, lab_r):
            return min_label_pass_plain(pts_k[rows], nrm_k[rows], m_c[rows],
                                        lab_r, tol2)
    chains = ()
    if orders is not None:
        order, link = orders
        chains = [(order[:, k, :cap].long(), link[:, k, :cap].bool())
                  for k in range(order.shape[1])]
    lab, conv, rounds = _rounds_loop(lab, pass_fn, outer_iters, jump_iters,
                                     chains)
    return _uncompact(lab, sub, N), conv, rounds


def _grid_offsets(tol: float, leaf: float):
    """Static packed-key deltas of the cells that can hold a radius-``tol``
    neighbor of a point in the center cell (R = ceil(tol/leaf) rings,
    pruned by the minimum cube-to-cube distance); JAX ``_grid_offsets``."""
    R = math.ceil(tol / leaf - 1e-9)
    t2 = (tol / leaf) ** 2

    def m(d):
        return max(abs(d) - 1, 0)

    offs = []
    for dx in range(-R, R + 1):
        for dy in range(-R, R + 1):
            for dz in range(-R, R + 1):
                if dx == dy == dz == 0:
                    continue
                if m(dx) ** 2 + m(dy) ** 2 + m(dz) ** 2 <= t2:
                    offs.append((dx << 20) + (dy << 10) + dz)
    return R, offs


def grid_supported(tol: float, leaf: float, max_span: float) -> bool:
    """Static gate for the grid path: the candidate-cell stencil must stay
    small (R <= 2, i.e. <= 124 candidates) and the cloud's possible spatial
    span must fit the 10-bit-per-axis key packing."""
    R, offs = _grid_offsets(tol, leaf)
    return len(offs) <= 124 and max_span / leaf + 2 * R + 2 <= 1024


def grid_stencil(tol: float, leaf: float):
    """The stencil's rings and bound (R, smax): the greatest integer sum of
    squared cell gaps a stencil cell may have (``_grid_offsets``' test
    ``... <= (tol / leaf)^2`` on integers).  Raises where the stencil
    outgrows K13's 124 cells."""
    R, offs = _grid_offsets(tol, leaf)
    if len(offs) > 124:
        raise ValueError(f"tol={tol}, leaf={leaf}: a stencil of {len(offs)} "
                         "cells; the grid kernel takes at most 124 "
                         "(grid_supported)")
    return R, int(math.floor((tol / leaf) ** 2))


def grid_rows(tol: float, leaf: float):
    """K13's stencil as rows: for each (dx, dy) of ``_grid_offsets``'
    cells, in their order, the packed-key offsets (lo, hi) of its cells,
    which are the dz of one interval [-h, h] (the middle row's interval
    also holds the centre cell, whose key the kernel leaves out).  Raises
    where the stencil outgrows the kernel (``grid_stencil``)."""
    grid_stencil(tol, leaf)
    R, offs = _grid_offsets(tol, leaf)
    rows = {}
    for o in offs:
        dz = (o + 512) % 1024 - 512
        dy = ((o - dz) >> 10) % 1024
        dy = dy - 1024 if dy >= 512 else dy
        dx = (o - dz - (dy << 10)) >> 20
        rows.setdefault((dx, dy), []).append(dz)
    out = []
    for (dx, dy), dzs in rows.items():
        if (dx, dy) == (0, 0):
            dzs = sorted(dzs + [0])
        if dzs != list(range(dzs[0], dzs[-1] + 1)):
            raise ValueError(f"the stencil's row {(dx, dy)} is no interval")
        base = (dx << 20) + (dy << 10)
        out.append((base + dzs[0], base + dzs[-1]))
    return out


def grid_neighbours_plain(pts, cells, mask, tol: float, leaf: float):
    """The grid pass's neighbour table (JAX ``connected_components_grid``,
    literally): nbr [D, N, C] int64, each point's stencil cell neighbours
    that pass the exact radius test on ``pts`` as original lane ids, the
    point itself in the other slots.  Keys are the cells less the
    survivors' least cell plus R, 10 bits an axis; masked lanes take
    unique sentinels; the keys are sorted (stably) and each stencil key
    found by ``torch.searchsorted`` (side left: of equal keys the first).
    Row blocks of [N, C], so the table's intermediates stay small."""
    D, N = mask.shape
    dev = pts.device
    tol2 = float(torch.tensor(tol * tol, dtype=torch.float32))
    R, offs = _grid_offsets(tol, leaf)
    idx = torch.arange(N, dtype=torch.int32, device=dev)
    cmin = torch.where(mask[..., None], cells, _BIG).amin(1)
    c = (cells - cmin[:, None, :] + R).clamp(0, 1023)
    key = (c[..., 0] << 20) | (c[..., 1] << 10) | c[..., 2]
    key = torch.where(mask, key, _BIG + idx).to(torch.int32)
    order = torch.sort(key, dim=1, stable=True).indices
    key_s = torch.gather(key, 1, order).contiguous()
    pts_s = torch.gather(pts, 1, order[..., None].expand(-1, -1, 3))
    mask_s = torch.gather(mask, 1, order)
    dkeys = torch.tensor(offs, dtype=torch.int32, device=dev)
    C = len(offs)
    rows = max(1, min(N, _PLAIN_ELEMS // max(D * C * 3, 1)))
    out = []
    for b in range(0, N, rows):
        s = slice(b, b + rows)
        r = key_s[:, s].shape[1]
        targets = key_s[:, s, None] + dkeys
        pos = torch.searchsorted(key_s, targets.reshape(D, -1),
                                 side="left").clamp(max=N - 1)
        hit = (torch.gather(key_s, 1, pos).view(D, r, C) == targets) \
            & mask_s[:, s, None]
        pts_j = torch.gather(pts_s, 1, pos[..., None].expand(-1, -1, 3))
        hit &= _sq_dist(pts_s[:, s, None, :], pts_j.view(D, r, C, 3)) <= tol2
        out.append(torch.where(hit, torch.gather(order, 1, pos).view(D, r, C),
                               order[:, s, None]))
    nbr_s = torch.cat(out, dim=1)
    return torch.empty_like(nbr_s).scatter_(
        1, order[..., None].expand(-1, -1, C), nbr_s)


def grid_seed(pts, mask, tol: float):
    """The grid path's starting labels (JAX ``connected_components_grid``):
    each point's own lane, seeded along one chain order of ``pts``."""
    N = mask.shape[1]
    tol2 = float(torch.tensor(tol * tol, dtype=torch.float32))
    idx = torch.arange(N, dtype=torch.int32, device=pts.device)
    return _chain_seed(pts, mask, torch.where(mask, idx, N), tol2
                       ).to(torch.int32).contiguous()


def grid_table_compacted(pts, cells, mask, labels0, tol: float,
                         leaf: float):
    """The neighbour table (``grid_neighbours_plain``) in compacted
    numbering, as ``cluster_grid_plain``'s rounds read it: (sub [D, cap] the
    lanes taken, m_c their mask, lab the starting labels, nbr_c [D, cap * C]
    each point's C stencil slots, the point itself where a slot holds no
    neighbour: a masked neighbour, which only a sentinel key can give,
    counts as the point itself, whose label never wins)."""
    D, N = mask.shape
    nbr = grid_neighbours_plain(pts, cells, mask, tol, leaf)
    sub, m_c, (nbr_k,), lab = _compact_labels(mask, labels0, nbr)
    cap = sub.shape[1]
    rank = (torch.cumsum(mask.to(torch.int32), dim=1) - 1).long()
    C = nbr.shape[2]
    flat = nbr_k.reshape(D, -1)
    self_c = torch.arange(cap, device=pts.device)[None, :, None]
    nbr_c = torch.where(torch.gather(mask, 1, flat).view(D, cap, C),
                        torch.gather(rank, 1, flat).view(D, cap, C),
                        self_c).reshape(D, -1)
    return sub, m_c, lab, nbr_c


def cluster_grid_plain(pts, cells, mask, labels0, tol: float, leaf: float,
                       outer_iters: int, jump_iters: int = 12):
    """Plain PyTorch version of ``cluster_grid`` (any device):
    ``_rounds_loop`` over the minimum of ``grid_table_compacted``'s
    table."""
    D, N = mask.shape
    sub, m_c, lab, nbr_c = grid_table_compacted(pts, cells, mask, labels0,
                                                tol, leaf)
    cap = sub.shape[1]
    C = nbr_c.shape[1] // cap

    def pass_fn(rows, lab_r):
        got = torch.gather(lab_r, 1, nbr_c[rows]).view(len(rows), cap, C)
        return torch.minimum(lab_r, got.amin(-1))

    lab, conv, rounds = _rounds_loop(lab, pass_fn, outer_iters, jump_iters)
    return _uncompact(lab, sub, N), conv, rounds


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
# K13's launch (blocks per detection, threads per block) by the detections
# a launch has, the fewest first: its own shape, chosen by
# examples/torch_cluster_sweep.py --grid.  Clusters of 8 blocks of 512
# threads are fastest for a frame's detections (a detection's chain of
# rounds is split 8 ways); an H100 holds 15 of them at once (30, 66, 132
# clusters of 4, 2, 1), and past about three waves of them fewer blocks a
# detection win
GRID_LAUNCH_SHAPES = ((0, (8, 512)), (46, (4, 512)), (91, (2, 512)),
                      (199, (1, 512)))
_GRID_SMEM_FIXED = 13   # bytes a lane K13 keeps in shared memory: the lane
#                         list, two label buffers, the neighbour counts
_GRID_SMEM_HEAD = 256   # and a block's scalars (GridHead)


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
            select=None, shape=None, smem=None, prune=True, exact=False,
            orders=None):
    """One launch of the clustering kernel on CUDA tensors, checked.
    ``select`` = (pts, center, min_size, center_dis) asks for the selection
    epilogue; ``exact`` the exact lane (pts_c the uncentred points, nrm
    their squared norms); ``orders`` (``chain_orders``) the chain lane.  Each
    lane counts its own launches (frontend_kernels.CLUSTER_EXACT,
    CLUSTER_CHAIN; the chain lane's with ``exact`` too).  For the sweep and
    the kernel's tests only: ``shape`` = (blocks per detection, threads,
    points a lane) and ``smem`` override the launch, ``prune=False`` tests
    every pair.  Returns (labels, converged, rounds, sel | None,
    ok | None)."""
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
            conv.data_ptr(), rounds.data_ptr(), int(exact)]
    kernel = fk.CLUSTER_EXACT if exact else fk.CLUSTER_COMPONENTS
    if orders is not None:
        order, link = orders
        K = order.shape[1]
        if not 1 <= K <= 3:
            raise ValueError(f"{K} chain orders: the lane takes 1 to 3")
        fk.check("chain order", order, torch.int32, (D, K, N), dev)
        fk.check("chain link", link, torch.uint8, (D, K, N), dev)
        args += [order.data_ptr(), link.data_ptr(), K]
        kernel = fk.CLUSTER_CHAIN
    else:
        args += [None, None, 0]
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
        fk.launch(kernel, fn, dev, args)
    else:
        conv.fill_(True)
        rounds.fill_(1)
        if ok is not None:
            ok.fill_(False)
    return labels, conv, rounds, sel, ok


def cluster_components(pts_c, nrm, mask, labels0, tol2: float,
                       outer_iters: int, jump_iters: int = 12, frame=None,
                       exact: bool = False, orders=None):
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
    frames of different poses).  ``exact``: the direct radius test on the
    uncentred points (pts_c then holds them, nrm their squared norms;
    ``centre_and_seed(exact=True)``), the kernel's exact lane; ``orders``
    (``chain_orders``): a chain pass along each order after every pass,
    its chain lane.
    """
    if pts_c.device.type != "cuda":
        return cluster_components_plain(pts_c, nrm, mask, labels0, tol2,
                                        outer_iters, jump_iters, exact,
                                        orders)
    return _launch(pts_c, nrm, mask, labels0, tol2, outer_iters, jump_iters,
                   frame, exact=exact, orders=orders)[:3]


def cluster_select_plain(pts, pts_c, nrm, mask, labels0, center, tol2: float,
                         outer_iters: int, jump_iters: int, min_size: int,
                         center_dis: float, exact: bool = False,
                         orders=None):
    """Plain PyTorch version of ``cluster_select`` (any device):
    ``cluster_components_plain``, then ``select_cluster`` on its labels."""
    labels, conv, rounds = cluster_components_plain(
        pts_c, nrm, mask, labels0, tol2, outer_iters, jump_iters, exact,
        orders)
    sel, ok = select_cluster(pts, mask, labels, center, min_size, center_dis)
    return sel, ok & conv, labels, conv, rounds


def cluster_select(pts, pts_c, nrm, mask, labels0, center, tol2: float,
                   outer_iters: int, jump_iters: int, min_size: int,
                   center_dis: float, frame=None, exact: bool = False,
                   orders=None):
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
                                    center_dis, exact, orders)
    labels, conv, rounds, sel, ok = _launch(
        pts_c, nrm, mask, labels0, tol2, outer_iters, jump_iters, frame,
        (pts, center, min_size, center_dis), exact=exact, orders=orders)
    return sel, ok, labels, conv, rounds


def centre_and_seed(pts, mask, tol: float, chains: int = -1,
                    exact: bool = False, with_orders: bool = False):
    """What ``cluster_components`` takes, from a frame's points: (pts_c,
    nrm, mask, labels0, tol2).  The points are centred on the masked mean
    once (labels are translation-invariant); with ``exact`` they stay
    uncentred (the exact test's), masked ones zeroed.  ``chains``: |chains|
    spatial orders seed the labels (-1: one, 0: each point its own);
    ``with_orders`` also returns the chain lane's ``chain_orders`` when
    ``chains > 0`` (else None), as ((...), orders)."""
    D, N = mask.shape
    tol2 = float(torch.tensor(tol * tol, dtype=torch.float32))
    idx = torch.arange(N, dtype=torch.int32, device=pts.device)
    labels0 = torch.where(mask, idx, N)
    structs = _chain_structs(pts, mask, tol2, abs(chains)) if chains else []
    if structs:
        labels0 = _chain_seed(pts, mask, labels0, tol2, structs)
    w = mask[..., None]
    if exact:
        pts_c = torch.where(w, pts, 0.0).contiguous()
    else:
        c = torch.where(w, pts, 0.0).sum(1) / mask.sum(1).clamp_min(1).to(
            pts.dtype)[:, None]
        pts_c = torch.where(w, pts - c[:, None, :], 0.0).contiguous()
    nrm = (pts_c * pts_c).sum(-1)
    out = (pts_c, nrm, mask.contiguous(), labels0.to(torch.int32).contiguous(),
           tol2)
    if not with_orders:
        return out
    return out, (chain_orders(structs, mask) if chains > 0 else None)


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
    min-index labels map back exactly) to the survivors there are.  With
    ``with_converged=True`` additionally returns the convergence flags [D]:
    False for a detection whose propagation the bound truncated while
    labels were still changing; callers MUST surface that (a truncated run
    silently yields fragment components).  With ``with_rounds=True`` also
    the rounds [D] each detection ran, up to and including the first one
    that changed no label.  ``exact``: the direct radius test on the
    uncentred points.  ``chains``: |chains| spatial orders seed the labels
    (-1, the default: one; 0: none); chains > 0 also interleaves a chain
    pass per order after every pass.
    """
    args, orders = centre_and_seed(pts, mask, tol, chains, exact,
                                   with_orders=True)
    labels, conv, rounds = cluster_components(
        *args, outer_iters, jump_iters, frame=frame, exact=exact,
        orders=orders)
    out = (labels,)
    if with_converged:
        out += (conv,)
    if with_rounds:
        out += (rounds,)
    return out if len(out) > 1 else labels


def grid_shape(D: int, N: int):
    """K13's launch shape (blocks per detection, threads) for D detections
    of N lanes (``GRID_LAUNCH_SHAPES``, by D; a choice from the shapes
    alone, since the survivors are on the device)."""
    shape = GRID_LAUNCH_SHAPES[0][1]
    for least, s in GRID_LAUNCH_SHAPES:
        if D >= least:
            shape = s
    return shape


@functools.lru_cache(maxsize=None)
def _grid_consts(tol: float, leaf: float):
    """K13's launch constants for (tol, leaf), computed once (the stencil's
    Python loops take far longer than a launch): (R, the stencil rows as
    host ints: their count, then each row's lo and hi; tol2 in f32)."""
    R, _ = grid_stencil(tol, leaf)
    rows = grid_rows(tol, leaf)
    flat = [len(rows)] + [v for row in rows for v in row]
    return (R, (ctypes.c_int * len(flat))(*flat),
            float(torch.tensor(tol * tol, dtype=torch.float32)))


def grid_smem_least(N: int) -> int:
    """The least dynamic shared memory K13 takes for ``N`` lanes: a block's
    scalars, then the lane list, two label buffers and the neighbour
    counts, 13 bytes a lane (rounded up to 32 lanes)."""
    return _GRID_SMEM_HEAD + _GRID_SMEM_FIXED * (-(-N // 32) * 32)


def grid_smem(N: int) -> int:
    """K13's dynamic shared memory for ``N`` lanes: all a block may have
    (``grid_smem_least``, the rest for a third label buffer, the key
    table's ids, the neighbour lists and the points their walks test,
    which the kernel leaves in device memory where they do not fit).
    Raises where the least does not fit."""
    if grid_smem_least(N) > _SMEM_MAX:
        most = (_SMEM_MAX - _GRID_SMEM_HEAD) // _GRID_SMEM_FIXED // 32 * 32
        raise ValueError(f"cluster_grid takes at most {most} lanes a "
                         f"detection (got {N}): its labels stay in one "
                         "block's shared memory")
    return _SMEM_MAX


def _launch_grid(pts, cells, mask, labels0, tol: float, leaf: float,
                 outer_iters: int, jump_iters: int, select=None, shape=None,
                 smem=None):
    """One launch of the grid kernel (K13, ``cluster_grid``) on CUDA
    tensors, checked.  ``select`` = (pts_w, center, min_size, center_dis)
    asks for the selection epilogue.  For the sweep and the kernel's tests
    only: ``shape`` = (blocks a detection, threads) overrides
    ``grid_shape``, ``smem`` the dynamic shared memory (less room moves
    the neighbour lists to device memory).  Returns (labels, converged,
    rounds, sel | None, ok | None)."""
    D, N = mask.shape
    dev = pts.device
    fk.check("pts", pts, torch.float32, (D, N, 3), dev)
    fk.check("cells", cells, torch.int32, (D, N, 3), dev)
    fk.check("mask", mask, torch.bool, (D, N), dev)
    fk.check("labels0", labels0, torch.int32, (D, N), dev)
    if outer_iters < 1 or jump_iters < 0:
        raise ValueError(f"outer_iters={outer_iters}, jump_iters={jump_iters}")
    R, host_rows, tol2 = _grid_consts(tol, leaf)
    smem = smem or grid_smem(N)
    S, T = shape or grid_shape(D, N)
    labels = torch.empty_like(labels0)
    conv = torch.empty((D,), dtype=torch.bool, device=dev)
    rounds = torch.empty((D,), dtype=torch.int32, device=dev)
    sel = ok = None
    sel_args = [None, None, 0, 0.0, None, None, None]
    if select is not None:
        pts_w, center, min_size, center_dis = select
        fk.check("pts_w", pts_w, torch.float32, (D, N, 3), dev)
        fk.check("center", center, torch.float32, (D, 3), dev)
        if min_size < 1:
            raise ValueError(f"min_size={min_size}: a cluster has a point")
        sel = torch.empty((D, N), dtype=torch.bool, device=dev)
        ok = torch.empty((D,), dtype=torch.bool, device=dev)
        least_d = torch.empty((D, N), dtype=torch.int32, device=dev)
        sel_args = [pts_w.data_ptr(), center.data_ptr(), min_size,
                    center_dis, least_d.data_ptr(), sel.data_ptr(),
                    ok.data_ptr()]
    if D and N:
        # the stencil's rows go as host ints (the C side copies them into
        # the launch's arguments); scratch from the caching allocator where
        # shared memory has no room: the sort's 16-bit ids (a block's own,
        # the power of two at or above N) and the neighbour lists (16-bit
        # compacted ids, at most 124 a survivor)
        n2 = 1 << max(0, (N - 1).bit_length())
        ids = torch.empty((D, S, n2), dtype=torch.int16, device=dev)
        nbr = torch.empty((D, 124 * N), dtype=torch.int16, device=dev)
        fk.launch(fk.CLUSTER_GRID, "oslam_cluster_grid", dev, [
            pts.data_ptr(), cells.data_ptr(), mask.data_ptr(),
            labels0.data_ptr(), D, N, tol2, R, ctypes.addressof(host_rows),
            outer_iters, jump_iters, S, T, smem, ids.data_ptr(), n2,
            nbr.data_ptr(), labels.data_ptr(), conv.data_ptr(),
            rounds.data_ptr(), *sel_args])
    else:
        conv.fill_(True)
        rounds.fill_(1)
        if ok is not None:
            ok.fill_(False)
    return labels, conv, rounds, sel, ok


def cluster_grid(pts, cells, mask, labels0, tol: float, leaf: float,
                 outer_iters: int, jump_iters: int = 12):
    """The grid path's whole propagation of a frame (JAX
    ``connected_components_grid`` after its seed): pts [D, N, 3] float32,
    cells [D, N, 3] int32 their voxel cells at ``leaf`` (one a point:
    PRECONDITION, as in JAX), mask [D, N] bool, labels0 [D, N] int32
    (``grid_seed``).  Returns (labels, converged, rounds) as
    ``cluster_components``, nothing read back.  On a CUDA device one launch
    of K13 (csrc/frontend.cu); on the CPU ``cluster_grid_plain``."""
    if pts.device.type != "cuda":
        return cluster_grid_plain(pts, cells, mask, labels0, tol, leaf,
                                  outer_iters, jump_iters)
    return _launch_grid(pts, cells, mask, labels0, tol, leaf, outer_iters,
                        jump_iters)[:3]


def cluster_grid_select_plain(pts, cells, mask, labels0, pts_w, center,
                              tol: float, leaf: float, outer_iters: int,
                              jump_iters: int, min_size: int,
                              center_dis: float):
    """Plain PyTorch version of ``cluster_grid_select`` (any device)."""
    labels, conv, rounds = cluster_grid_plain(pts, cells, mask, labels0, tol,
                                              leaf, outer_iters, jump_iters)
    sel, ok = select_cluster(pts_w, mask, labels, center, min_size,
                             center_dis)
    return sel, ok & conv, labels, conv, rounds


def cluster_grid_select(pts, cells, mask, labels0, pts_w, center, tol: float,
                        leaf: float, outer_iters: int, jump_iters: int,
                        min_size: int, center_dis: float):
    """``cluster_grid`` followed by ``select_cluster`` on the points pts_w
    [D, N, 3] (the world points; the labels come from ``pts``, the camera
    frame's, whose cells they are) and center [D, 3].  Returns (sel, ok:
    chosen and converged, labels, converged, rounds).  On a CUDA device the
    selection is K13's epilogue (K5's, shared); on the CPU
    ``cluster_grid_select_plain``."""
    if pts.device.type != "cuda":
        return cluster_grid_select_plain(pts, cells, mask, labels0, pts_w,
                                         center, tol, leaf, outer_iters,
                                         jump_iters, min_size, center_dis)
    labels, conv, rounds, sel, ok = _launch_grid(
        pts, cells, mask, labels0, tol, leaf, outer_iters, jump_iters,
        (pts_w, center, min_size, center_dis))
    return sel, ok, labels, conv, rounds


def connected_components_grid(pts: torch.Tensor, cells: torch.Tensor,
                              mask: torch.Tensor, tol: float, leaf: float,
                              outer_iters: int = 8, jump_iters: int = 12,
                              with_converged: bool = False,
                              with_rounds: bool = False):
    """Grid-hash connected components for voxel-downsampled clouds (JAX
    ``connected_components_grid``): labels [D, N] as
    ``connected_components(..., exact=True)``.  PRECONDITION: each unmasked
    point occupies a distinct ``cells`` row, computed from the SAME
    coordinates as ``pts`` (pairwise distances are rigid-invariant, the
    cell bound is not).  ``with_converged`` / ``with_rounds`` as
    ``connected_components``."""
    labels, conv, rounds = cluster_grid(
        pts.contiguous(), cells.to(torch.int32).contiguous(),
        mask.contiguous(), grid_seed(pts, mask, tol), tol, leaf, outer_iters,
        jump_iters)
    out = (labels,)
    if with_converged:
        out += (conv,)
    if with_rounds:
        out += (rounds,)
    return out if len(out) > 1 else labels


def components_compacted(pts: torch.Tensor, mask: torch.Tensor, tol: float,
                         outer_iters: int, jump_iters: int, compact_cap: int,
                         with_converged: bool = False, chains: int = -1):
    """JAX ``components_compacted``: the unmasked points compacted (stable
    order) into the front ``compact_cap`` lanes, clustered there, and the
    labels mapped back.  PRECONDITION: sum(mask) <= compact_cap per
    detection (overflowed points would be dropped).  The labels equal
    ``connected_components``'."""
    N = mask.shape[1]
    order = torch.sort((~mask).to(torch.int32), dim=1, stable=True).indices
    sub = order[:, :compact_cap]
    lab_c, conv = connected_components(
        torch.gather(pts, 1, sub[..., None].expand(-1, -1, 3)),
        torch.gather(mask, 1, sub), tol, outer_iters, jump_iters,
        with_converged=True, chains=chains)
    cap = sub.shape[1]
    orig = torch.where(lab_c < cap,
                       torch.gather(sub.to(torch.int32), 1,
                                    lab_c.clamp(0, cap - 1).long()), N)
    labels = torch.full(mask.shape, N, dtype=torch.int32, device=mask.device)
    labels.scatter_(1, sub, orig)
    return (labels, conv) if with_converged else labels


def connected_components_compact(pts: torch.Tensor, mask: torch.Tensor,
                                 tol: float, outer_iters: int = 8,
                                 jump_iters: int = 12,
                                 compact_cap: int | None = None):
    """JAX ``connected_components_compact``, whose results ALWAYS equal
    ``connected_components``': that, since the clustering already compacts
    each detection to its survivors; ``compact_cap`` changes nothing."""
    return connected_components(pts, mask, tol, outer_iters, jump_iters)


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


def euclidean_filter(pts: torch.Tensor, mask: torch.Tensor,
                     center: torch.Tensor, tol: float, min_size: int,
                     center_dis: float, outer_iters: int = 8,
                     exact: bool = False, grid_pts=None, grid_cells=None,
                     grid_leaf=None):
    """Full Euclidean-filter stage (JAX ``euclidean_filter``): cluster +
    select.  Returns (sel_mask [D, N], ok [D]).  With ``grid_pts`` /
    ``grid_cells`` / ``grid_leaf`` (the points in the frame whose
    voxelization produced the cells) the grid path computes the labels;
    ``pts`` / ``center`` still give the selection distances."""
    if grid_pts is not None:
        labels = connected_components_grid(grid_pts, grid_cells, mask, tol,
                                           grid_leaf,
                                           outer_iters=outer_iters)
    else:
        labels = connected_components(pts, mask, tol,
                                      outer_iters=outer_iters, exact=exact)
    return select_cluster(pts, mask, labels, center, min_size, center_dis)
