"""Edge-sharded SLAM-mode bundle adjustment (port of
``parallel/dist_slam.py``).

The edge set, the axis that grows with the trajectory, is split over the
ranks of a mesh: every rank computes the residuals and Jacobians of its
contiguous slice of the 2D, 3D and odometry edges (on CUDA tensors one
launch of K11, ``slam_edge_terms``, and one of ``slam_chi2`` for the
trial's chi2, per LM iteration), assembles partial normal equations, and
the blocks (dense ``Hpp`` or banded ``D``, ``B``; ``bp``, ``Hoo``, ``bo``,
the coupling ``U``) are summed over the ranks.  The Schur-complement solve
then runs replicated, so every rank holds the same iterates, or with
``shard_solve`` sharded over the frame axis as well
(``solve_schur_framesharded`` and its banded form).

Each rank's edge slice is a graph of its own, with segment tables built
from its slice (``slam_ba.graph_from_numpy``): padded edges have zero
weight and stay out of the sums, so a rank's sums run over its live edges
in edge order, and the sharded sum is the ranks' sums added together.
"""
from __future__ import annotations

import numpy as np
import torch

from ..backend import slam_ba as sb
from ..backend.lm import LMConfig
from ..backend.lm_soa import _TAU
from .collectives import Mesh, all_gather, ppermute_shift, pmax, psum

_EDGE_FAMILIES = {
    "e2": ("e2_frame", "e2_obj", "e2_bbox", "e2_w"),
    "e3": ("e3_frame", "e3_obj", "e3_meas", "e3_w"),
    "odo": ("odo_i", "odo_j", "odo_meas", "odo_w"),
}
_IDENTITY7 = np.array([0, 0, 0, 0, 0, 0, 1.0], np.float32)


def _arrays(g: sb.SlamGraph):
    """The JAX package's fields of ``g`` as host numpy arrays."""
    return {k: getattr(g, k).cpu().numpy() for k in sb.JAX_FIELDS}


def pad_graph_edges(g: sb.SlamGraph, multiple: int) -> sb.SlamGraph:
    """Pad each edge family to a multiple of the mesh size with w=0 edges
    (bboxes -1, identity 3D measurements and odometry, as in the JAX
    package); the segment tables are made anew and leave them out."""
    a = _arrays(g)
    fills = {"e2": np.float32(-1.0),
             "e3": np.concatenate([_IDENTITY7, np.ones(3, np.float32)]),
             "odo": _IDENTITY7}
    for fam, fields in _EDGE_FAMILIES.items():
        E = len(a[fields[0]])
        extra = -(-max(E, 1) // multiple) * multiple - E
        for f in fields:
            row = fills[fam] if f == fields[2] else np.zeros((), a[f].dtype)
            tail = np.broadcast_to(row, (extra,) + a[f].shape[1:])
            a[f] = np.concatenate([a[f], tail.astype(a[f].dtype)])
    return sb.graph_from_numpy(a, device=g.poses_cw.device)


def pad_graph_frames(g: sb.SlamGraph, multiple: int) -> sb.SlamGraph:
    """Pad the frame axis to a multiple of the mesh size with masked frames.

    Padded frames carry identity poses, ``frame_mask`` False (the solvers
    fix them with identity rows) and no edges, so the padded graph
    optimizes to the raw one's solution."""
    F = g.poses_cw.shape[0]
    Fp = -(-max(F, 1) // multiple) * multiple
    if Fp == F:
        return g
    a = _arrays(g)
    a["poses_cw"] = np.concatenate([a["poses_cw"],
                                    np.tile(_IDENTITY7, (Fp - F, 1))])
    a["frame_mask"] = np.concatenate([a["frame_mask"], np.zeros(Fp - F, bool)])
    return sb.graph_from_numpy(a, device=g.poses_cw.device)


def shard_graph_edges(g: sb.SlamGraph, mesh: Mesh) -> sb.SlamGraph:
    """This rank's contiguous slice of every edge family (the families'
    lengths divide over the ranks: ``pad_graph_edges``), with its own
    segment tables; frames and objects whole, the gravity edges on rank 0
    only."""
    a = _arrays(g)
    n, r = mesh.size, mesh.rank
    for fields in _EDGE_FAMILIES.values():
        E = len(a[fields[0]])
        if E % n:
            raise ValueError(f"{E} {fields[0]} edges do not divide over {n} "
                             f"ranks: pad_graph_edges first")
        for f in fields:
            a[f] = a[f][r * E // n:(r + 1) * E // n]
    if r != 0:
        a["grav_w"] = np.zeros_like(a["grav_w"])
    return sb.graph_from_numpy(a, device=g.poses_cw.device)


def _rows(mesh: Mesh, F: int) -> slice:
    if F % mesh.size:
        raise ValueError(f"{F} frames do not divide over {mesh.size} ranks: "
                         "pad_graph_frames first")
    Fl = F // mesh.size
    return slice(mesh.rank * Fl, (mesh.rank + 1) * Fl)


def _damping(diag_pp_l, diag_oo, lam, mesh):
    """lam0: g2o's tau * max |diagonal| of the ACTIVE vertices when lam < 0
    (``slam_ba._damping``), over every rank's frames: the diagonals come
    masked by the free frames and objects.  The JAX package's sharded
    solves take every frame's diagonal, the fixed frame 0 and the padded
    ones included, where its single-device solves take the active
    vertices' (a fault of JAX's, ROADMAP queue 3): they part wherever a
    fixed frame holds the largest diagonal."""
    maxdiag = torch.maximum(pmax(diag_pp_l.abs().max(), mesh),
                            diag_oo.abs().max())
    return torch.where(lam < 0, _TAU * maxdiag, lam).clamp_min(1e-12)


def _psum_dot(mesh):
    def dot(a, b):
        return psum((a * b).sum(), mesh)
    return dot


def _object_masks(Hoo, bo, lam0, om):
    eye9 = torch.eye(9, dtype=Hoo.dtype, device=Hoo.device)
    Hoo_d = Hoo + lam0 * eye9[None]
    Hoo_d = Hoo_d * om[:, None, None] + eye9[None] * (1.0 - om)[:, None, None]
    return Hoo_d, bo * om[:, None]


def _back_substitute(U_ml, dx_p_l, bo_m, Minv, fm_l, om, mesh):
    """dx_o from every rank's coupling rows, then both steps finite and
    masked; dx_p gathered whole."""
    rhs_o = bo_m + psum(torch.einsum("fkac,fa->kc", U_ml, dx_p_l), mesh)
    dx_o = -torch.einsum("kbc,kc->kb", Minv, rhs_o)
    dx_p_l = sb._finite_masked(dx_p_l, fm_l)
    return all_gather(dx_p_l, mesh), sb._finite_masked(dx_o, om)


def solve_schur_framesharded(Hpp, bp, Hoo, bo, U, lam, free_frame, free_obj,
                             cg_iters: int, mesh: Mesh):
    """Frame-sharded Schur-complement solve of assembled (replicated)
    normal equations: each rank builds its rows of the reduced camera
    system S = Hpp - U Hoo^-1 U^T and of its right-hand side, the
    block-Jacobi PCG keeps its vectors sharded by frame (per iteration one
    [F,6] all_gather and two scalar psums), and the landmarks
    back-substitute from the ranks' summed coupling.  The frames must
    divide over the ranks (``pad_graph_frames``).  Returns (dx_p [F,6]
    whole on every rank, dx_o [K,9], lam0)."""
    F = bp.shape[0]
    rows = _rows(mesh, F)
    dt, dev = Hpp.dtype, Hpp.device
    fm = free_frame.to(dt)
    om = free_obj.to(Hoo.dtype)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    gidx = torch.arange(rows.start, rows.stop, device=dev)
    onehot = (gidx[:, None] == torch.arange(F, device=dev)[None, :]).to(dt)
    Hpp_l, bp_l, fm_l = Hpp[rows], bp[rows], fm[rows]

    diag_blk = torch.einsum("figj,fg->fij", Hpp_l, onehot)
    lam0 = _damping(torch.diagonal(diag_blk, dim1=-2, dim2=-1)
                    * fm_l[:, None],
                    torch.diagonal(Hoo, dim1=-2, dim2=-1) * om[:, None],
                    lam, mesh)
    Hpp_d = Hpp_l + lam0 * torch.einsum("fg,ij->figj", onehot, eye6)
    Hpp_d = (Hpp_d * fm_l[:, None, None, None] * fm[None, None, :, None]
             + torch.einsum("fg,ij->figj", onehot * (1.0 - fm_l)[:, None],
                            eye6))
    bp_m = bp_l * fm_l[:, None]
    Hoo_d, bo_m = _object_masks(Hoo, bo, lam0, om)
    U_mf = U * fm[:, None, None, None] * om[None, :, None, None]
    U_ml = U_mf[rows]

    Minv = sb._inv9(Hoo_d)
    UM = torch.einsum("fkab,kbc->fkac", U_ml, Minv)
    S_l = Hpp_d - torch.einsum("fkac,gkdc->fagd", UM, U_mf)
    rhs_l = -bp_m + torch.einsum("fkac,kc->fa", UM, bo_m)
    Pinv = sb._inv6(torch.einsum("figj,fg->fij", S_l, onehot))

    def matvec(p_l):
        return torch.einsum("fagd,gd->fa", S_l, all_gather(p_l, mesh))

    dx_p_l = sb._pcg(matvec, rhs_l, Pinv, cg_iters, _psum_dot(mesh))
    dx_p, dx_o = _back_substitute(U_ml, dx_p_l, bo_m, Minv, fm_l, om, mesh)
    return dx_p, dx_o, lam0


def solve_schur_framesharded_banded(D, B, bp, Hoo, bo, U, lam, free_frame,
                                    free_obj, cg_iters: int, mesh: Mesh):
    """Frame-sharded banded + low-rank Schur solve: the pose Hessian is
    block-tridiagonal (the odometry chain) plus the rank-9K landmark
    coupling, so the PCG matvec needs one-row halos from the neighbouring
    ranks (``ppermute_shift`` of a [6] row each way) and a [K,9] psum; no
    O(F^2) object is built.  The frames must divide over the ranks
    (``pad_graph_frames``).  Returns (dx_p [F,6] whole on every rank,
    dx_o [K,9], lam0)."""
    rows = _rows(mesh, bp.shape[0])
    dt, dev = D.dtype, D.device
    fm = free_frame.to(dt)
    om = free_obj.to(Hoo.dtype)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    D_l, B_l, bp_l, fm_l, U_l = D[rows], B[rows], bp[rows], fm[rows], U[rows]

    def next_first(x_l):
        """x of the next row: this shard's rows shifted up by one, the next
        rank's first row last (zeros on the last rank)."""
        return torch.cat([x_l[1:], ppermute_shift(x_l[0], mesh, -1)[None]])

    lam0 = _damping(torch.diagonal(D_l, dim1=-2, dim2=-1) * fm_l[:, None],
                    torch.diagonal(Hoo, dim1=-2, dim2=-1) * om[:, None],
                    lam, mesh)
    D_d = D_l + lam0 * eye6[None]
    D_d = D_d * fm_l[:, None, None] + eye6[None] * (1.0 - fm_l)[:, None, None]
    B_d = B_l * (fm_l * next_first(fm_l))[:, None, None]
    bp_m = bp_l * fm_l[:, None]
    Hoo_d, bo_m = _object_masks(Hoo, bo, lam0, om)
    U_ml = U_l * fm_l[:, None, None, None] * om[None, :, None, None]

    Minv = sb._inv9(Hoo_d)
    UM_l = torch.einsum("fkab,kbc->fkac", U_ml, Minv)
    rhs_l = -bp_m + torch.einsum("fkac,kc->fa", UM_l, bo_m)
    Pinv = sb._inv6(D_d - torch.einsum("fkac,fkdc->fad", UM_l, U_ml))

    def matvec(x_l):
        t = psum(torch.einsum("gkdc,gd->kc", U_ml, x_l), mesh)
        y = torch.einsum("fij,fj->fi", D_d, x_l)
        y = y + torch.einsum("fij,fj->fi", B_d, next_first(x_l))
        up = torch.einsum("fij,fi->fj", B_d, x_l)    # B[f]^T x[f] -> f+1
        y = y + torch.cat([ppermute_shift(up[-1], mesh, 1)[None], up[:-1]])
        return y - torch.einsum("fkac,kc->fa", UM_l, t)

    dx_p_l = sb._pcg(matvec, rhs_l, Pinv, cg_iters, _psum_dot(mesh))
    dx_p, dx_o = _back_substitute(U_ml, dx_p_l, bo_m, Minv, fm_l, om, mesh)
    return dx_p, dx_o, lam0


def _psum_parts(parts, mesh):
    """The assembled blocks summed over the ranks in one all_reduce."""
    if mesh.size == 1:
        return parts
    flat = psum(torch.cat([p.reshape(-1) for p in parts]), mesh)
    out, at = [], 0
    for p in parts:
        out.append(flat[at:at + p.numel()].reshape(p.shape))
        at += p.numel()
    return tuple(out)


def optimize_slam_sharded(g: sb.SlamGraph, K_mat, normal, mesh: Mesh,
                          cfg: LMConfig = LMConfig(), cg_iters: int = 64,
                          shard_solve: bool = False, banded: bool = False,
                          trace=None):
    """SLAM-mode BA with the edges sharded over ``mesh``: every rank passes
    the same full graph (SPMD) on its mesh device and gets the replicated
    (poses_cw, objects, chi2), ``slam_ba.optimize_slam``'s on the same
    padded graph up to the order of the sums (``slam_ba.lm_schur``'s
    schedule on the ranks' summed equations and chi2).

    The edge families are padded to a multiple of the ranks
    (``pad_graph_edges``) and, with ``shard_solve``, the frames too
    (``pad_graph_frames``): the returned poses are the padded graph's.
    ``shard_solve`` shards the Schur solve over the frame axis;
    ``banded`` is the block-tridiagonal + low-rank formulation (chain
    odometry), whose sharded solve exchanges one-row halos and a [K,9]
    psum per PCG iteration instead of an [F,6] all_gather.  ``trace``: as
    ``lm_schur``'s.
    """
    g = pad_graph_edges(g, mesh.size)
    if shard_solve:
        g = pad_graph_frames(g, mesh.size)
    local = shard_graph_edges(g, mesh)
    F = g.poses_cw.shape[0]
    dev = g.poses_cw.device
    K_mat = K_mat.to(device=dev, dtype=torch.float32)
    normal = normal.to(device=dev, dtype=torch.float32)
    free_frame = g.frame_mask & (torch.arange(F, device=dev) > 0)
    free_obj = g.obj_mask
    build = (sb.build_normal_equations_banded if banded
             else sb.build_normal_equations)
    if banded:
        solve = (solve_schur_framesharded_banded if shard_solve
                 else sb.solve_schur_step_banded)
    else:
        solve = (solve_schur_framesharded if shard_solve
                 else sb.solve_schur_step)
    extra = (mesh,) if shard_solve else ()

    def step(poses, objects, lam):
        parts = _psum_parts(build(poses, objects, local, K_mat, normal), mesh)
        return solve(*parts, lam, free_frame, free_obj, cg_iters, *extra)

    def chi2_at(poses, objects):
        return psum(sb._chi2(poses, objects, local, K_mat, normal), mesh)

    return sb.lm_schur(g.poses_cw, g.objects, step, chi2_at, cfg.iters,
                       trace)
