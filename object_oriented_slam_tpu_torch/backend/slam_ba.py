"""SLAM-mode bundle adjustment: free camera poses + object landmarks.

Port of ``object_oriented_slam_tpu/backend/slam_ba.py``.  The reference's
SLAM mode (``bSLAM_mode``, Optimizer.cpp:126,142-158) frees the camera
vertices (frame 0 fixed), ties consecutive frames by odometry edges
``EdgeSE3Expmap`` (error = log(C * Tcw_i * Tcw_j^-1),
g2o/types/types_six_dof_expmap.h:90-99) and couples poses and landmarks
by the same 2D / 3D / gravity factors as mapping mode.

  * The graph is fixed-capacity edge tensors (``SlamGraph``).
  * Per edge, the residual and its Jacobians with respect to the
    left-multiplied pose tangent(s) and the object's 9-DoF tangent.  On a
    CUDA tensor one launch of the hand kernel K11 computes them for every
    edge (``backend/slam_kernels.py``, ``csrc/slam_edges.cu``), and a
    second instantiation the chi2 of an LM trial; on a CPU tensor the
    plain versions below do (forward mode over the residuals: one
    ``torch.func.jvp`` per tangent direction under ``torch.func.vmap``,
    what the JAX package's ``jax.jacfwd`` does).
  * The normal equations are assembled with segment sums and ``einsum``:
    dense ``Hpp [F,6,F,6]`` or, since the odometry is a chain, banded
    (``D [F,6,6]``, ``B [F,6,6]``); ``Hoo [K,9,9]``, the coupling
    ``U [F,K,6,9]``.  Every segment sum goes through a gather table that
    ``graph_from_numpy`` makes once a graph from the packed arrays (the
    graph's ``seg_*`` fields, live edges only), so the sums run in edge
    order and a solve repeats bit for bit on the card.
  * The Schur complement marginalizes the 9x9 landmark blocks and the
    reduced camera system is solved by a block-Jacobi preconditioned
    conjugate gradient of fixed length; landmarks back-substitute.
  * The LM loop keeps lambda, nu, chi2 and the accept test on the device:
    it makes no host synchronisation.

Pose update: ``Tcw' = exp(u) * Tcw`` (g2o ``VertexSE3Expmap``); object
update: ``ellipsoid.exp_update``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from ..core import ellipsoid as ell
from ..core import se3
from ..ops.linalg import chol_solve_small
from . import residuals as res
from . import slam_kernels
from .lm import LMConfig
from .lm_soa import _TAU


class SlamGraph(NamedTuple):
    """Fixed-capacity SLAM factor graph: the JAX package's fields, then the
    gather tables of the assembly's segment sums (``segment_plan``).

    F frames, K objects, E2 2d edges, E3 3d edges, Eo odometry edges.
      poses_cw   [F, 7]   initial camera estimates (Tcw)
      frame_mask [F]      bool
      objects    [K, 10]  initial landmark estimates
      obj_mask   [K]      bool
      e2_frame   [E2] int64 ; e2_obj [E2] ; e2_bbox [E2,4] ; e2_w [E2]
      e3_frame   [E3] ; e3_obj [E3] ; e3_meas [E3,10] ; e3_w [E3]
      odo_i/odo_j [Eo] ; odo_meas [Eo,7] ; odo_w [Eo]
      grav_w     [K]  gravity sqrt-weight per object (0 = off)
      seg_*      [n, C] int64 gather tables, one per entry of SEGMENTS
    Float fields are float32.
    """
    poses_cw: torch.Tensor
    frame_mask: torch.Tensor
    objects: torch.Tensor
    obj_mask: torch.Tensor
    e2_frame: torch.Tensor
    e2_obj: torch.Tensor
    e2_bbox: torch.Tensor
    e2_w: torch.Tensor
    e3_frame: torch.Tensor
    e3_obj: torch.Tensor
    e3_meas: torch.Tensor
    e3_w: torch.Tensor
    odo_i: torch.Tensor
    odo_j: torch.Tensor
    odo_meas: torch.Tensor
    odo_w: torch.Tensor
    grav_w: torch.Tensor
    seg_e2_frame: torch.Tensor
    seg_e3_frame: torch.Tensor
    seg_odo_i: torch.Tensor
    seg_odo_j: torch.Tensor
    seg_e2_obj: torch.Tensor
    seg_e3_obj: torch.Tensor
    seg_e2_pair: torch.Tensor
    seg_e3_pair: torch.Tensor
    seg_odo_pair: torch.Tensor


# the segment sums of the assembly: table field -> (the index fields whose
# key picks the segment, the weight field, the segments: frames F, objects
# K, (frame, object) pairs F*K, or the distinct (frame, frame) pairs of the
# live odometry edges, in key order: "pairs")
SEGMENTS = {
    "seg_e2_frame": (("e2_frame",), "e2_w", "F"),
    "seg_e3_frame": (("e3_frame",), "e3_w", "F"),
    "seg_odo_i": (("odo_i",), "odo_w", "F"),
    "seg_odo_j": (("odo_j",), "odo_w", "F"),
    "seg_e2_obj": (("e2_obj",), "e2_w", "K"),
    "seg_e3_obj": (("e3_obj",), "e3_w", "K"),
    "seg_e2_pair": (("e2_frame", "e2_obj"), "e2_w", "FK"),
    "seg_e3_pair": (("e3_frame", "e3_obj"), "e3_w", "FK"),
    "seg_odo_pair": (("odo_i", "odo_j"), "odo_w", "pairs"),
}
# the JAX package's fields
JAX_FIELDS = tuple(f for f in SlamGraph._fields if f not in SEGMENTS)
INDEX_FIELDS = ("e2_frame", "e2_obj", "e3_frame", "e3_obj", "odo_i", "odo_j")
MASK_FIELDS = ("frame_mask", "obj_mask")


def segment_plan(arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The gather tables of SEGMENTS from a graph's numpy arrays: row s of
    a table lists the live edges (non-zero weight) of segment s in edge
    order, padded with the edge count (the index of a zero row appended to
    the terms).  A zero-weight edge's terms are zeros, so leaving it out
    changes no sum; what is left is summed in edge order on every device,
    where ``index_add_``'s atomics on the card add in another order every
    run."""
    F, K = len(arrays["frame_mask"]), len(arrays["obj_mask"])
    plan = {}
    for name, (fields, weight, which) in SEGMENTS.items():
        key = np.asarray(arrays[fields[0]], np.int64)
        if len(fields) == 2:
            key = key * (K if which == "FK" else F) + np.asarray(
                arrays[fields[1]], np.int64)
        live = np.flatnonzero(np.asarray(arrays[weight]) != 0)
        seg = key[live]
        if which == "pairs":
            _, seg = np.unique(seg, return_inverse=True)
            n = int(seg.max(initial=-1)) + 1
        else:
            n = {"F": F, "K": K, "FK": F * K}[which]
        counts = np.bincount(seg, minlength=n)
        table = np.full((n, max(int(counts.max(initial=0)), 1)), len(key),
                        np.int64)
        order = np.argsort(seg, kind="stable")
        first = np.cumsum(counts) - counts
        table[seg[order], np.arange(len(seg)) - first[seg[order]]] = \
            live[order]
        plan[name] = table
    return plan


def graph_from_numpy(arrays: Dict[str, np.ndarray], device="cpu") -> SlamGraph:
    """The port's SlamGraph, its segment plan included, from numpy arrays
    of the JAX package's fields, e.g. a JAX graph's ``{k: np.asarray(v)
    for k, v in g._asdict().items()}``."""
    missing = set(JAX_FIELDS) - set(arrays)
    if missing:
        raise KeyError(f"missing graph fields: {sorted(missing)}")
    out = {}
    for name in JAX_FIELDS:
        dtype = (np.int64 if name in INDEX_FIELDS
                 else bool if name in MASK_FIELDS else np.float32)
        out[name] = np.asarray(arrays[name], dtype)
    out.update(segment_plan(out))
    return SlamGraph(**{k: torch.as_tensor(v, device=device)
                        for k, v in out.items()})


# ---------------------------------------------------------------------------
# Edge terms: the plain versions of K11
# ---------------------------------------------------------------------------

def _odo_residual(pose_i_cw, pose_j_cw, meas):
    """error = log(C * Tcw_i * Tcw_j^-1) (types_six_dof_expmap.h:90-99)."""
    delta = se3.se3_mul(se3.se3_mul(meas, pose_i_cw), se3.se3_inv(pose_j_cw))
    return se3.se3_log(delta)


def _jacobians(rfun, ref, *sizes):
    """(r, dr/du_0, dr/du_1, ...) of the edge-wise ``rfun(u_0 [E, n_0],
    u_1 [E, n_1], ...)`` at u = 0 by forward mode: one ``torch.func.jvp``
    per tangent direction, the same direction for every edge at once
    (vmapped), so each edge's rows come out as ``jax.jacfwd`` of that edge
    alone gives them.  Tangents of ``ref``'s dtype and device."""
    E, n = ref.shape[0], sum(sizes)
    zeros = tuple(ref.new_zeros((E, k)) for k in sizes)

    def along(t):
        tangents = tuple(c.expand(E, -1) for c in torch.split(t, sizes))
        return torch.func.jvp(rfun, zeros, tangents)

    basis = torch.eye(n, dtype=ref.dtype, device=ref.device)
    r, dr = torch.func.vmap(along)(basis)        # [n, E, R] each
    J = dr.permute(1, 2, 0)                       # [E, R, n]
    return (r[0], *torch.split(J, sizes, dim=-1))


def _gated(r, *J):
    """An edge with a non-finite residual component is zeroed, r and J
    alike (JAX's rule: the tangents are not tested)."""
    bad = ~torch.isfinite(r).all(-1)
    return (torch.where(bad[:, None], 0.0, r),
            *(torch.where(bad[:, None, None], 0.0, j) for j in J))


def _edge_terms_2d(poses, objects, g: SlamGraph, K_mat):
    """Per-2D-edge residuals and Jacobians [E2,4], [E2,4,6], [E2,4,9]."""
    pose, obj = poses[g.e2_frame], objects[g.e2_obj]

    def rfun(up, uo):
        p = se3.se3_mul(se3.se3_exp(up), pose)
        o = ell.exp_update(obj, uo)
        return res.residual_proj(o, p, K_mat, g.e2_bbox) * g.e2_w[:, None]
    return _gated(*_jacobians(rfun, pose, 6, 9))


def _edge_terms_3d(poses, objects, g: SlamGraph):
    """[E3,9], [E3,9,6], [E3,9,9]."""
    pose, obj = poses[g.e3_frame], objects[g.e3_obj]

    def rfun(up, uo):
        pose_cw = se3.se3_mul(se3.se3_exp(up), pose)
        o = ell.exp_update(obj, uo)
        return (res.residual_3d(o, se3.se3_inv(pose_cw), g.e3_meas)
                * g.e3_w[:, None])
    return _gated(*_jacobians(rfun, pose, 6, 9))


def _edge_terms_odo(poses, g: SlamGraph):
    """[Eo,6], [Eo,6,6] (left frame), [Eo,6,6] (right frame)."""
    pose_i, pose_j = poses[g.odo_i], poses[g.odo_j]

    def rfun(ui, uj):
        pi = se3.se3_mul(se3.se3_exp(ui), pose_i)
        pj = se3.se3_mul(se3.se3_exp(uj), pose_j)
        return _odo_residual(pi, pj, g.odo_meas) * g.odo_w[:, None]
    return _gated(*_jacobians(rfun, pose_i, 6, 6))


def _edge_terms_grav(objects, g: SlamGraph, normal):
    """[K,1], [K,1,9]; not gated, as in the JAX package."""
    def rfun(uo):
        return (res.residual_gravity(ell.exp_update(objects, uo), normal)
                * g.grav_w[:, None])
    return _jacobians(rfun, objects, 9)


def edge_terms_plain(poses, objects, g: SlamGraph, K_mat, normal):
    """K11's plain version: (r2, Jp2, Jo2, r3, Jp3, Jo3, ro, Ji, Jj, rg,
    Jg) of every edge of ``g`` at (poses, objects)."""
    return (*_edge_terms_2d(poses, objects, g, K_mat),
            *_edge_terms_3d(poses, objects, g),
            *_edge_terms_odo(poses, g),
            *_edge_terms_grav(objects, g, normal))


def _chi2_plain(poses, objects, g: SlamGraph, K_mat, normal):
    """chi2 of the graph: the gated residuals alone (the Jacobians are not
    taken), summed per edge kind in the JAX package's order."""
    z6 = poses.new_zeros(6)
    z9 = objects.new_zeros(9)

    def gate(r):
        return torch.where(torch.isfinite(r).all(-1, keepdim=True), r, 0.0)

    def pose(idx):
        return se3.se3_mul(se3.se3_exp(z6), poses[idx])

    def obj(idx):
        return ell.exp_update(objects[idx], z9)

    r2 = gate(res.residual_proj(obj(g.e2_obj), pose(g.e2_frame), K_mat,
                                g.e2_bbox) * g.e2_w[:, None])
    r3 = gate(res.residual_3d(obj(g.e3_obj), se3.se3_inv(pose(g.e3_frame)),
                              g.e3_meas) * g.e3_w[:, None])
    ro = gate(_odo_residual(pose(g.odo_i), pose(g.odo_j), g.odo_meas)
              * g.odo_w[:, None])
    rg = res.residual_gravity(ell.exp_update(objects, z9),
                              normal) * g.grav_w[:, None]
    return ((r2 * r2).sum() + (r3 * r3).sum() + (ro * ro).sum()
            + (rg * rg).sum())


def edge_terms(poses, objects, g: SlamGraph, K_mat, normal):
    """Every edge's residual and Jacobians: one launch of K11 on CUDA
    tensors (a build or launch failure raises), the plain version on CPU
    tensors."""
    if poses.is_cuda:
        return slam_kernels.edge_terms(poses, objects, g, K_mat, normal)
    return edge_terms_plain(poses, objects, g, K_mat, normal)


def _chi2(poses, objects, g: SlamGraph, K_mat, normal):
    """chi2 [] of the graph: K11's chi2 instantiation on CUDA tensors, the
    plain version on CPU tensors."""
    if poses.is_cuda:
        return slam_kernels.chi2(poses, objects, g, K_mat, normal)
    return _chi2_plain(poses, objects, g, K_mat, normal)


# ---------------------------------------------------------------------------
# Assembly
# ---------------------------------------------------------------------------

def _seg(x, table):
    """Segment sums of ``x`` [E, ...] by a gather table of segment_plan."""
    xz = torch.cat([x, x.new_zeros((1,) + x.shape[1:])])
    return xz[table].sum(1)


def _jtj(A, B):
    return torch.einsum("eai,eaj->eij", A, B)


def _jtr(J, r):
    return torch.einsum("eai,ea->ei", J, r)


def _object_blocks(terms, g: SlamGraph, F, K):
    """(Hoo [K,9,9], bo [K,9], U [F,K,6,9]) from the edge terms."""
    r2, Jp2, Jo2, r3, Jp3, Jo3, _, _, _, rg, Jg = terms
    t2, t3 = g.seg_e2_obj, g.seg_e3_obj
    Hoo = _seg(_jtj(Jo2, Jo2), t2) + _seg(_jtj(Jo3, Jo3), t3) + _jtj(Jg, Jg)
    bo = _seg(_jtr(Jo2, r2), t2) + _seg(_jtr(Jo3, r3), t3) + _jtr(Jg, rg)
    U = (_seg(_jtj(Jp2, Jo2), g.seg_e2_pair)
         + _seg(_jtj(Jp3, Jo3), g.seg_e3_pair)).reshape(F, K, 6, 9)
    return Hoo, bo, U


def _pose_diagonal(terms, g: SlamGraph, F):
    """(D [F,6,6], bp [F,6]): every edge's pose block on its own frame."""
    r2, Jp2, _, r3, Jp3, _, ro, Ji, Jj, _, _ = terms
    D = Jp2.new_zeros((F, 6, 6))
    bp = Jp2.new_zeros((F, 6))
    for J, r, table in ((Jp2, r2, g.seg_e2_frame), (Jp3, r3, g.seg_e3_frame),
                        (Ji, ro, g.seg_odo_i), (Jj, ro, g.seg_odo_j)):
        D = D + _seg(_jtj(J, J), table)
        bp = bp + _seg(_jtr(J, r), table)
    return D, bp


def build_normal_equations(poses, objects, g: SlamGraph, K_mat, normal):
    """Assemble (Hpp [F,6,F,6], bp [F,6], Hoo [K,9,9], bo [K,9],
    U [F,K,6,9])."""
    F, K = poses.shape[0], objects.shape[0]
    terms = edge_terms(poses, objects, g, K_mat, normal)
    _, _, _, _, _, _, _, Ji, Jj, _, _ = terms
    Hd, bp = _pose_diagonal(terms, g, F)
    eyeF = torch.eye(F, dtype=Hd.dtype, device=Hd.device)
    Hpp = torch.einsum("fij,fg->figj", Hd, eyeF)
    # odometry off-diagonal blocks (i,j) and (j,i); row p of seg_odo_pair
    # is one (i, j) pair, and its first entry an edge of that pair
    rep = g.seg_odo_pair[:, 0]
    flat = Hd.new_zeros((F, F, 6, 6)).index_put_(
        (g.odo_i[rep], g.odo_j[rep]), _seg(_jtj(Ji, Jj), g.seg_odo_pair))
    Hpp = Hpp + flat.permute(0, 2, 1, 3)
    Hpp = Hpp + flat.permute(1, 3, 0, 2)
    return (Hpp, bp, *_object_blocks(terms, g, F, K))


def build_normal_equations_banded(poses, objects, g: SlamGraph, K_mat,
                                  normal):
    """Banded assembly: (D [F,6,6], B [F,6,6], bp, Hoo, bo, U [F,K,6,9]).

    The pose Hessian is block-tridiagonal: projection / 3D edges touch one
    pose each and the odometry edges form a chain (build_slam_graph emits
    odo_j == odo_i + 1), so Hpp = tridiag(D, B) with B[f] the (f, f+1)
    coupling block (B[F-1] unused): O(F) memory instead of O(F^2).
    Precondition: active odometry edges satisfy odo_j == odo_i + 1.
    """
    F, K = poses.shape[0], objects.shape[0]
    terms = edge_terms(poses, objects, g, K_mat, normal)
    _, _, _, _, _, _, _, Ji, Jj, _, _ = terms
    D, bp = _pose_diagonal(terms, g, F)
    B = _seg(_jtj(Ji, Jj), g.seg_odo_i)     # keyed by the left frame
    return (D, B, bp, *_object_blocks(terms, g, F, K))


# ---------------------------------------------------------------------------
# Schur solves
# ---------------------------------------------------------------------------

def _inv_spd(H):
    """Inverses of SPD blocks [..., n, n] by the unrolled Cholesky solve of
    each unit column (ops/linalg.chol_solve_small)."""
    n = H.shape[-1]
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    return chol_solve_small(H[..., None, :, :], eye).transpose(-1, -2)


_inv9 = _inv6 = _inv_spd     # the JAX package's names for the 9x9 / 6x6 use


def _pcg(matvec, b, Minv_blocks, iters):
    """Block-Jacobi preconditioned CG on the reduced camera system, a
    fixed number of iterations.  b: [F, 6]; Minv_blocks: [F, 6, 6]."""
    def precond(r):
        return torch.einsum("fij,fj->fi", Minv_blocks, r)

    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = (r * z).sum()
    for _ in range(iters):
        Ap = matvec(p)
        pAp = (p * Ap).sum()
        alpha = rz / torch.where(pAp.abs() > 1e-20, pAp, 1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = (r * z).sum()
        beta = rz_new / torch.where(rz.abs() > 1e-20, rz, 1e-20)
        p = z + beta * p
        rz = rz_new
    return x


def _damping(diag_pp, diag_oo, lam):
    """lam0: g2o's tau * max diag of the ACTIVE vertices when lam < 0."""
    maxdiag = torch.maximum(diag_pp.abs().max(), diag_oo.abs().max())
    return torch.where(lam < 0, _TAU * maxdiag, lam).clamp_min(1e-12)


def _tridiag_matvec(D, B, x):
    """y[f] = D[f] x[f] + B[f] x[f+1] + B[f-1]^T x[f-1]."""
    y = torch.einsum("fij,fj->fi", D, x)
    x_next = torch.cat([x[1:], torch.zeros_like(x[:1])])
    y = y + torch.einsum("fij,fj->fi", B, x_next)
    up = torch.einsum("fij,fi->fj", B, x)          # B[f]^T x[f] -> row f+1
    return y + torch.cat([torch.zeros_like(up[:1]), up[:-1]])


def _finite_masked(dx, m):
    return torch.where(torch.isfinite(dx), dx, 0.0) * m[:, None]


def solve_schur_step_banded(D, B, bp, Hoo, bo, U, lam, free_frame,
                            free_obj, cg_iters: int):
    """Damped Schur solve on the banded + low-rank reduced system: S =
    tridiag(D_d, B_d) - UM U^T is never materialized, the PCG matvec is
    the banded part plus the rank-9K correction.  Returns (dx_p [F,6],
    dx_o [K,9], lam0)."""
    fm = free_frame.to(D.dtype)
    om = free_obj.to(Hoo.dtype)
    lam0 = _damping(torch.diagonal(D, dim1=-2, dim2=-1) * fm[:, None],
                    torch.diagonal(Hoo, dim1=-2, dim2=-1) * om[:, None], lam)
    eye6 = torch.eye(6, dtype=D.dtype, device=D.device)
    eye9 = torch.eye(9, dtype=D.dtype, device=D.device)
    fm_next = torch.cat([fm[1:], torch.zeros_like(fm[:1])])

    D_d = D + lam0 * eye6[None]
    D_d = D_d * fm[:, None, None] + eye6[None] * (1.0 - fm)[:, None, None]
    B_d = B * (fm * fm_next)[:, None, None]
    bp_m = bp * fm[:, None]
    Hoo_d = Hoo + lam0 * eye9[None]
    Hoo_d = Hoo_d * om[:, None, None] + eye9[None] * (1.0 - om)[:, None, None]
    bo_m = bo * om[:, None]
    U_m = U * fm[:, None, None, None] * om[None, :, None, None]

    Minv = _inv9(Hoo_d)                                   # [K,9,9]
    UM = torch.einsum("fkab,kbc->fkac", U_m, Minv)        # [F,K,6,9]
    rhs = -bp_m + torch.einsum("fkac,kc->fa", UM, bo_m)
    Sdiag = D_d - torch.einsum("fkac,fkdc->fad", UM, U_m)
    Pinv = _inv6(Sdiag)

    def matvec(x):
        t = torch.einsum("gkdc,gd->kc", U_m, x)           # U^T x  [K,9]
        return _tridiag_matvec(D_d, B_d, x) - torch.einsum(
            "fkac,kc->fa", UM, t)

    dx_p = _pcg(matvec, rhs, Pinv, cg_iters)
    rhs_o = bo_m + torch.einsum("fkac,fa->kc", U_m, dx_p)
    dx_o = -torch.einsum("kbc,kc->kb", Minv, rhs_o)
    return _finite_masked(dx_p, fm), _finite_masked(dx_o, om), lam0


def solve_schur_step(Hpp, bp, Hoo, bo, U, lam, free_frame, free_obj,
                     cg_iters: int):
    """One damped Schur-complement solve from the dense normal equations.
    Returns (dx_p [F,6], dx_o [K,9], lam0); lam < 0 asks for g2o's
    tau * max-diag initialisation."""
    F = bp.shape[0]
    fm = free_frame.to(Hpp.dtype)
    om = free_obj.to(Hoo.dtype)
    lam0 = _damping(torch.einsum("fifi->fi", Hpp) * fm[:, None],
                    torch.diagonal(Hoo, dim1=-2, dim2=-1) * om[:, None], lam)
    eyeF = torch.eye(F, dtype=Hpp.dtype, device=Hpp.device)
    eye6 = torch.eye(6, dtype=Hpp.dtype, device=Hpp.device)
    eye9 = torch.eye(9, dtype=Hpp.dtype, device=Hpp.device)
    Hpp_d = Hpp + lam0 * torch.einsum("fg,ij->figj", eyeF, eye6)
    Hoo_d = Hoo + lam0 * eye9[None]

    # gauge / mask: fixed frames and objects get identity rows
    Hpp_d = (Hpp_d * fm[:, None, None, None] * fm[None, None, :, None]
             + torch.einsum("fg,ij->figj", torch.diag(1.0 - fm), eye6))
    bp_m = bp * fm[:, None]
    Hoo_d = Hoo_d * om[:, None, None] + eye9[None] * (1.0 - om)[:, None, None]
    bo_m = bo * om[:, None]
    U_m = U * fm[:, None, None, None] * om[None, :, None, None]

    # Schur: S = Hpp - U Hoo^-1 U^T ; rhs = -bp + U Hoo^-1 bo
    Minv = _inv9(Hoo_d)
    UM = torch.einsum("fkab,kbc->fkac", U_m, Minv)
    S = Hpp_d - torch.einsum("fkac,gkdc->fagd", UM, U_m)
    rhs = -bp_m + torch.einsum("fkac,kc->fa", UM, bo_m)
    Sdiag = torch.diagonal(S, dim1=0, dim2=2).permute(2, 0, 1)
    Pinv = _inv6(Sdiag)

    def matvec(x):
        return torch.einsum("fagd,gd->fa", S, x)

    dx_p = _pcg(matvec, rhs, Pinv, cg_iters)
    rhs_o = bo_m + torch.einsum("fkac,fa->kc", U_m, dx_p)
    dx_o = -torch.einsum("kbc,kc->kb", Minv, rhs_o)
    return _finite_masked(dx_p, fm), _finite_masked(dx_o, om), lam0


def apply_updates(poses, objects, dx_p, dx_o):
    return (se3.se3_mul(se3.se3_exp(dx_p), poses),
            ell.exp_update(objects, dx_o))


def optimize_slam(g: SlamGraph, K_mat, normal, cfg: LMConfig = LMConfig(),
                  cg_iters: int = 64, banded: bool = False):
    """Joint pose + landmark LM with Schur-complement reduced solves.

    ``banded=True`` is the block-tridiagonal + low-rank formulation, O(F K)
    per iteration instead of O(F^2 K); it needs the chain odometry that
    build_slam_graph emits.  On CUDA tensors an iteration launches K11
    twice (the edge terms, the trial's chi2), after one launch for the
    initial chi2, and the call does not wait for the device.  The result
    repeats bit for bit.
    Returns (poses_cw [F,7], objects [K,10], chi2 []) on the graph's
    device.
    """
    F = g.poses_cw.shape[0]
    dev = g.poses_cw.device
    # frame 0 fixed (Optimizer.cpp:138); masked frames also fixed
    free_frame = g.frame_mask & (torch.arange(F, device=dev) > 0)
    free_obj = g.obj_mask

    poses, objects = g.poses_cw, g.objects
    chi2 = _chi2(poses, objects, g, K_mat, normal)
    lam = torch.full((), -1.0, device=dev)
    nu = torch.full((), 2.0, device=dev)
    three = torch.full((), 3.0, device=dev)    # lam0 / 3 a true division
    for _ in range(cfg.iters):
        if banded:
            D, Bb, bp, Hoo, bo, U = build_normal_equations_banded(
                poses, objects, g, K_mat, normal)
            dx_p, dx_o, lam0 = solve_schur_step_banded(
                D, Bb, bp, Hoo, bo, U, lam, free_frame, free_obj, cg_iters)
        else:
            Hpp, bp, Hoo, bo, U = build_normal_equations(
                poses, objects, g, K_mat, normal)
            dx_p, dx_o, lam0 = solve_schur_step(
                Hpp, bp, Hoo, bo, U, lam, free_frame, free_obj, cg_iters)
        poses_new, objects_new = apply_updates(poses, objects, dx_p, dx_o)
        chi2_new = _chi2(poses_new, objects_new, g, K_mat, normal)

        accept = (chi2_new < chi2) & torch.isfinite(chi2_new)
        lam = torch.where(accept, lam0 / three, lam0 * nu)
        nu = torch.where(accept, 2.0, nu * 2.0)
        poses = torch.where(accept, poses_new, poses)
        objects = torch.where(accept, objects_new, objects)
        chi2 = torch.where(accept, chi2_new, chi2)
    return poses, objects, chi2
