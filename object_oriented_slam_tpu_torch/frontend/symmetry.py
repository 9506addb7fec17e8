"""Symmetry-plane estimation and point-cloud completion (stage (g)).

Port of ``object_oriented_slam_tpu/frontend/symmetry.py``, the re-design of
``src/symmetry/Symmetry.cpp`` + ``src/symmetry/SymmetrySolver.cpp``:

  * 9 initial planes: angles {-5, 0, +5} deg x distances {-0.2, 0, 0.2} m
    (GenerateInitPlanes, Symmetry.cpp:44-86)
  * each optimized by 5 LM iterations over (angle, distance), or (angle,
    distance, dual distance) for dual reflection, with the exact gradient
    of the cost or central differences (SymmetrySolver.cpp:217-333)
  * cost (GetPointCloudProb, :49-138): mirror the cloud across the
    candidate plane(s); mirrored points that project inside the bbox onto
    occluded depth (d == 0 or point behind the measured surface) cost 0;
    otherwise the squared distance to the nearest original point;
    per-point ln P = -0.5 d^2 / Sigma^2, averaged; error = -mean ln P
  * winning plane = max probability = exp(-error) (Symmetry.cpp:107-127)
  * completion (EllipsoidExtractor.cpp:399-446): mirrored points merged
    into the object cloud, cloud recentered, object frame re-derived from
    the symmetry-plane normal

Where the JAX package ``vmap``s over detections and initial planes, the
plain versions here carry leading axes [D, K].  ``estimate_symmetry`` is
one launch of the ``symmetry_search`` CUDA kernel (csrc/frontend.cu) for
tensors on a CUDA device: every detection of a frame and every initial
plane with all its LM iterations, single and dual detections together (a
detection's type picks its variant).  On the CPU it is
``estimate_symmetry_plain``.  The offline batch mapper passes a batch of
frames' depth images [B, H, W] and each detection's frame index ``frame``
[D]: the same one launch (the kernel's frame lane), each detection's
pixels looked up in its own frame (JAX's ``row0`` / ``hw``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core import se3
from ..core.camera import Camera
from ..ops import backproject as bp
from ..ops import frontend_kernels as fk
from ..ops.linalg import chol_solve_small

# label -> symmetry type {0 none, 1 reflection, 2 dual reflection}
# (LoadSymmetryPrior, EllipsoidExtractor.cpp:52-79)
SYMMETRY_PRIOR = {58: 0, 59: 1, 62: 1, 57: 1, 66: 1, 63: 1, 64: 1,
                  41: 1, 28: 2}
N_INITS = 9
# the per-init record of a search: angle, distance, dual distance (0 for a
# single plane), final cost, exp(-cost)
INIT_FIELDS = 5
# a search's plane before (or without) any estimate: the parameters (0, 0)
_PLANE0 = (0.0, -1.0, 0.0, 0.0)


def sym_type_of_labels(labels):
    """Host helper: labels array -> sym types array."""
    return np.array([SYMMETRY_PRIOR.get(int(l), 0) for l in labels], np.int32)


@dataclasses.dataclass(frozen=True)
class SymmetryConfig:
    sigma: float = 0.1          # SymmetrySolver.Sigma
    iters: int = 5              # SymmetrySolver.cpp:263
    step_dis: float = 0.2       # GenerateInitPlanes
    step_angle_deg: float = 5.0
    num_delta: float = 1e-3     # numeric-jacobian step
    # exact gradient of the cost instead of the reference's central
    # differences (one gradient pass replaces 2 * n_par cost passes per LM
    # iteration); False gives the numeric-diff iterates
    analytic_grad: bool = True


class SymSearch(NamedTuple):
    """The winning plane of each detection (JAX ``SymResult``, [D] leading)
    and every initial plane's final state."""
    plane: torch.Tensor      # [D, 4] in the normalized frame
    dual_dis: torch.Tensor   # [D]; second plane = dual_other_plane
    prob: torch.Tensor       # [D]
    error: torch.Tensor      # [D]
    inits: torch.Tensor      # [D, 9, INIT_FIELDS]


def _plane_from_params(angle, dis):
    """fromDisAngleTrans (Plane.cpp:97-105): [..., 4]."""
    return torch.stack([torch.sin(angle), -torch.cos(angle),
                        torch.zeros_like(angle), -dis], dim=-1)


def init_grid(cfg: SymmetryConfig, device=None):
    """The 9 initial (angle [9], distance [9]) in the JAX package's
    ``meshgrid`` order: init k has angle step k // 3 and distance step
    k % 3, both from {-1, 0, 1}."""
    steps = torch.tensor([-1.0, 0.0, 1.0], device=device)
    ang0 = steps * float(np.float32(np.deg2rad(np.float32(
        cfg.step_angle_deg))))
    dis0 = steps * cfg.step_dis
    return ang0.repeat_interleave(3), dis0.repeat(3)


def _planes(params, dual: bool):
    """(n0, n1, d, max(|n|^2, 1e-8)) [..., P] of the planes of params
    [..., n_par] and the azimuth of the first plane: the plane of (angle,
    distance) and, for the dual type, its partner of the same azimuth at
    the dual distance (plane.dual_other_plane)."""
    ang, dis = params[..., 0], params[..., 1]
    n0, n1 = [torch.sin(ang)], [-torch.cos(ang)]
    d = [-dis]
    az = None
    if dual:
        az = torch.atan2(n1[0], n0[0])
        n0.append(torch.sin(az))
        n1.append(-torch.cos(az))
        d.append(-params[..., 2])
    n0, n1, d = (torch.stack(v, -1) for v in (n0, n1, d))
    n2 = torch.maximum(n0 * n0 + n1 * n1 + 0.0 * 0.0, bp.scalar(1e-8, n0))
    return n0, n1, d, n2, az


# threads of a symmetry_search block: the plain versions sum in its order
_BLOCK = 256


def _block_sum(v):
    """Sum over the last axis [..., L] in the kernel's order: lane i is
    thread i % 256's (i // 256)-th term, each thread adds its terms in
    order from 0, the 32 lanes of a warp meet by the xor pattern 16, 8, 4,
    2, 1, and lane 0 of each warp is added in warp order."""
    L = v.shape[-1]
    R = max(1, -(-L // _BLOCK))
    v = torch.nn.functional.pad(v, (0, R * _BLOCK - L))
    v = v.reshape(*v.shape[:-1], R, _BLOCK)
    acc = torch.zeros_like(v[..., 0, :])
    for r in range(R):
        acc = acc + v[..., r, :]
    w = acc.reshape(*acc.shape[:-1], _BLOCK // 32, 32)
    lane = torch.arange(32, device=v.device)
    for off in (16, 8, 4, 2, 1):
        w = w + w[..., lane ^ off]
    tot = w[..., 0, 0]
    for k in range(1, _BLOCK // 32):
        tot = tot + w[..., k, 0]
    return tot


class _Clouds(NamedTuple):
    """The live points of each detection, compacted to the front in index
    order as the kernel holds them (the 1-NN reference), the points that
    are mirrored (the sources: every live point, or with a source mask the
    live points it holds, compacted in index order too), and what the cost
    needs beside them."""
    pts: torch.Tensor        # [D, S, 3], S = the most live points
    live: torch.Tensor       # [D, S]
    n: torch.Tensor          # [D] live points
    src: torch.Tensor        # [D, Ss, 3] the sources (pts itself if dense)
    ns: torch.Tensor         # [D] sources
    bbox: torch.Tensor
    pose_oc: torch.Tensor
    proj_depth: torch.Tensor     # [H, W], or [B, H, W] with frame
    frame: object                # [D] each detection's frame, or None
    cam: Camera
    coef: float              # -0.5 / sigma^2


def _compact(keep, pts):
    """The points of pts [D, L, 3] that ``keep`` [D, L] holds, to the front
    in index order: (points [D, S, 3] zero past each count, kept [D, S],
    counts [D]), S the largest count (at least 1)."""
    order = torch.sort((~keep).to(torch.int32), dim=1, stable=True).indices
    n = keep.sum(1)
    S = max(int(n.max()) if n.numel() else 1, 1)
    order = order[:, :S]
    pts_c = torch.gather(pts, 1, order[..., None].expand(-1, -1, 3))
    kept = torch.arange(S, device=pts.device) < n[:, None]
    return torch.where(kept[..., None], pts_c, 0.0), kept, n, order


def _clouds(pts, mask, bbox, pose_oc, proj_depth, cam, sigma,
            src_mask=None, frame=None) -> _Clouds:
    pts_c, live, n, order = _compact(mask, pts)
    src, ns = pts_c, n
    if src_mask is not None:
        src, _, ns, _ = _compact(torch.gather(src_mask, 1, order) & live,
                                 pts_c)
    inv_sig = 1.0 / sigma
    return _Clouds(pts_c, live, n, src, ns, bbox, pose_oc, proj_depth, frame,
                   cam, -0.5 * inv_sig * inv_sig)


def _mirror_eval(params, cl: _Clouds, dual: bool, want_grad: bool = False):
    """Cost [D, K] of K candidate parameter sets params [D, K, n_par] per
    detection (JAX ``_mirror_cost``): mirror the sources (the cloud, or the
    points of JAX's ``src_mask``) across the plane(s), score every mirrored
    point with the occlusion-aware Gaussian 1-NN model against the live
    points, return -mean ln P; with ``want_grad`` also its gradient
    [D, K, n_par], written out by hand.

    The nearest-neighbour distance is the norm expansion q + r - 2 m.p
    (the dot product written out), clamped at 0 by ``torch.maximum`` over
    ``torch.amin``: differentiated by autograd, that is half the gradient
    at a tie with 0 and the gradient split evenly over equal minima, as
    ``jnp.maximum`` / ``jnp.min`` have it, and the hand gradient follows the
    same rules.  Each mirrored point sits on the kernel's lane (plane 0's
    points, then plane 1's, of the detection's own source count) and every
    sum is ``_block_sum``: the symmetry_search kernel computes the same
    bits.  Differentiable in ``params``.
    """
    D, K = params.shape[:2]
    pts, S = cl.pts, cl.pts.shape[1]
    Ss = cl.src.shape[1]
    P = 2 if dual else 1
    n0, n1, d, n2, az = _planes(params, dual)            # [D, K, P]
    x, y, z = (cl.src[:, None, None, :, c] for c in range(3))  # [D,1,1,Ss]
    n0_, n1_, d_, n2_ = (t[..., None] for t in (n0, n1, d, n2))
    s = (n0_ * x + n1_ * y + 0.0 * z + d_) / n2_         # [D, K, P, Ss]
    mx = x - 2.0 * s * n0_
    my = y - 2.0 * s * n1_
    mz = z - 2.0 * s * 0.0

    # project into the image: T_c<-o = inv(pose_oc)
    Tco = se3.se3_inv(cl.pose_oc)
    R = se3.quat_to_mat(Tco[:, 3:])[:, None, None, None]  # [D,1,1,1,3,3]
    t = Tco[:, None, None, None, :3]
    pc = [R[..., r, 0] * mx + R[..., r, 1] * my + R[..., r, 2] * mz
          + t[..., r] for r in range(3)]
    den = torch.clamp_min(pc[2], 1e-6)
    cam = cl.cam
    u = cam.fx * pc[0] / den + cam.cx
    v = cam.fy * pc[1] / den + cam.cy
    xi = u.detach().to(torch.int32)                      # truncates, as astype
    yi = v.detach().to(torch.int32)
    H, W = cl.proj_depth.shape[-2:]
    inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H) & (pc[2] > 0)
    b = cl.bbox[:, None, None, None, :]
    in_bbox = ((b[..., 0] < xi) & (xi < b[..., 2]) & (b[..., 1] < yi)
               & (yi < b[..., 3]) & inside)
    d_meas = bp.pixels(cl.proj_depth, cl.frame, yi.clamp(0, H - 1).long(),
                       xi.clamp(0, W - 1).long()) / bp.scalar(cam.scale,
                                                              pts)
    c0, c1, c2 = (cl.pose_oc[:, None, None, None, c] for c in range(3))
    ex, ey, ez = mx - c0, my - c1, mz - c2
    dis_cam = torch.sqrt(ex * ex + ey * ey + ez * ez)
    occluded = in_bbox & ((d_meas <= 1e-9) | (dis_cam > d_meas))

    # the least squared distance to the live points
    q_nrm = mx * mx + my * my + mz * mz
    px, py, pz = (pts[:, None, None, None, :, c] for c in range(3))
    ref_nrm = px * px + py * py + pz * pz                # [D,1,1,1,S]
    cross = mx[..., None] * px + my[..., None] * py + mz[..., None] * pz
    d2m = q_nrm[..., None] + ref_nrm - 2.0 * cross       # [D, K, P, Ss, S]
    d2m = torch.where(cl.live[:, None, None, None, :], d2m, 1e30)
    best = torch.amin(d2m, dim=-1)
    nn2 = torch.maximum(best, bp.scalar(0.0, pts))
    terms = [cl.coef * torch.where(occluded, 0.0, nn2)]

    # the kernel's lanes: plane q's point j of a detection of n sources is
    # lane q n + j; lanes past P n hold nothing
    L = P * Ss
    lane = torch.arange(L, device=pts.device)[None]      # [1, L]
    n = cl.ns[:, None]
    q = (lane >= n).to(torch.int64)
    src = (q * Ss + (lane - q * n)).clamp(0, L - 1)[:, None].expand(D, K, L)
    on = (lane < P * n)[:, None]                         # [D, 1, L]

    def lanes(t):                                      # [D, K, P, Ss] -> lanes
        return torch.where(on, torch.gather(t.reshape(D, K, L), 2, src), 0.0)

    nv = torch.clamp_min((P * cl.ns).to(pts.dtype), 1.0)[:, None]
    cost = -_block_sum(lanes(terms[0])) / nv
    if not want_grad:
        return cost

    # d cost / d d2 of a scored point, halved at a tie with 0
    gd2 = -(bp.scalar(1.0, nv) / nv) * cl.coef
    gd2 = gd2[..., None, None]
    w = torch.where(best > 0, gd2, torch.where(best == 0, 0.5 * gd2, 0.0))
    w = torch.where(occluded, 0.0, w)
    # the nearest points: their count and their sum in index order (a sum
    # of at most two points has one value in any order; more ties are
    # added one index at a time)
    eq = d2m == best[..., None]
    cnt = eq.sum(-1).to(pts.dtype)
    sums = []
    for pc_ in (px, py, pz):
        if bool((cnt <= 2).all()):
            sums.append(torch.where(eq, pc_, 0.0).sum(-1))
            continue
        acc = torch.zeros_like(best)
        for j in range(S):
            acc = acc + torch.where(eq[..., j], pc_[..., j], 0.0)
        sums.append(acc)
    wc = w / cnt.clamp_min(1.0)
    gx, gy, gz = (2.0 * (m * w) - 2.0 * (wc * sm)
                  for m, sm in zip((mx, my, mz), sums))
    # m = p - 2 s n, s = (n.p + d) / n2: d/ds, then (n0, n1, d)
    gsn = -2.0 * (gx * n0_ + gy * n1_ + gz * 0.0) / n2_
    g_n = [-2.0 * s * gx + gsn * mx, -2.0 * s * gy + gsn * my, gsn]
    tot = [_block_sum(lanes(torch.where(q_mask, g, 0.0)))
           for k in range(P)
           for q_mask in [torch.arange(P, device=pts.device)[:, None] == k]
           for g in g_n]
    g_n0, g_n1 = tot[0], tot[1]
    grads = []
    if dual:
        # the second plane's azimuth is atan2(n1, n0) of the first
        g_az = tot[3] * torch.cos(az) + tot[4] * torch.sin(az)
        r2 = n0[..., 0] * n0[..., 0] + n1[..., 0] * n1[..., 0]
        g_n0 = g_n0 + g_az * (-n1[..., 0] / r2)
        g_n1 = g_n1 + g_az * (n0[..., 0] / r2)
        grads.append(-tot[5])
    ang = params[..., 0]
    grads = [g_n0 * torch.cos(ang) + g_n1 * torch.sin(ang), -tot[2]] + grads
    return cost, torch.stack(grads, -1)


def optimize_inits_plain(pts, mask, bbox, pose_oc, proj_depth, cam: Camera,
                         dual: bool, cfg: SymmetryConfig, src_mask=None,
                         frame=None):
    """The 9-init search of each detection (JAX ``_optimize_one_init``
    under ``vmap``), plain PyTorch on any device, in the symmetry_search
    kernel's arithmetic.

    pts [D, S, 3], mask [D, S], bbox [D, 4], pose_oc [D, 7], proj_depth
    [H, W] (``ops/backproject.proj_depth_map``); src_mask [D, S] or None:
    the points mirrored and scored (sparse symmetry), among the live ones;
    frame [D] or None: with a batch of frames' maps proj_depth [B, H, W],
    each detection's frame.
    Returns (params [D, 9, n_par], cost [D, 9]) after ``cfg.iters`` LM
    iterations.
    """
    cl = _clouds(pts, mask, bbox, pose_oc, proj_depth, cam, cfg.sigma,
                 src_mask, frame)
    D, dev = pts.shape[0], pts.device
    n_par = 3 if dual else 2
    ang, dis = init_grid(cfg, dev)
    params = torch.zeros((D, N_INITS, n_par), dtype=pts.dtype, device=dev)
    params[..., 0] = ang
    params[..., 1] = dis
    c = _mirror_eval(params, cl, dual)
    lam = torch.full_like(c, -1.0)
    nu = torch.full_like(c, 2.0)
    eye = torch.eye(n_par, dtype=pts.dtype, device=dev)
    for _ in range(cfg.iters):
        if cfg.analytic_grad:
            _, g = _mirror_eval(params, cl, dual, want_grad=True)
        else:
            # central differences of the scalar cost, step num_delta
            steps = eye * cfg.num_delta
            around = torch.cat([params[:, :, None] + steps,
                                params[:, :, None] - steps], dim=2)
            cpm = _mirror_eval(around.reshape(D, -1, n_par), cl, dual
                               ).reshape(D, N_INITS, 2, n_par)
            g = (cpm[:, :, 0] - cpm[:, :, 1]) / bp.scalar(
                2 * cfg.num_delta, pts)
        params, c, lam, nu = lm_step(params, g, c, lam, nu,
                                     lambda p: _mirror_eval(p, cl, dual))
    return params, c


def lm_step(params, g, c, lam, nu, cost):
    """One LM iteration of ``_optimize_one_init`` on the scalar residual
    r = cost (J = g, H = g g^T, b = g c, lam0 = 1e-5 max(diag H, 1e-6) on
    the first): the Cholesky solve, the finite-step gate, the trial
    ``cost(p_new)`` and the accept test.  Leading axes [...]; returns
    (params, c, lam, nu)."""
    n_par = params.shape[-1]
    eye = torch.eye(n_par, dtype=params.dtype, device=params.device)
    H = g[..., :, None] * g[..., None, :] * 1.0
    b = g * c[..., None]
    lam0 = torch.where(lam < 0, 1e-5 * torch.clamp_min(
        H.diagonal(dim1=-2, dim2=-1).amax(-1), 1e-6), lam)
    du = -chol_solve_small(H + lam0[..., None, None] * eye, b)
    du = torch.where(torch.isfinite(du).all(-1, keepdim=True), du, 0.0)
    p_new = params + du
    c_new = cost(p_new)
    accept = (c_new < c) & torch.isfinite(c_new)
    return (torch.where(accept[..., None], p_new, params),
            torch.where(accept, c_new, c),
            torch.where(accept, lam0 / bp.scalar(3.0, c), lam0 * nu),
            torch.where(accept, 2.0, nu * 2.0))


def _pick(params, cost, dual: bool) -> SymSearch:
    """The winner of each detection's 9 inits: the first maximum of
    exp(-cost) (as ``jnp.argmax``)."""
    D = params.shape[0]
    prob = torch.exp(-cost)
    best = torch.argmax(prob, dim=1)
    rows = torch.arange(D, device=params.device)
    p = params[rows, best]
    inits = torch.cat([params, torch.zeros_like(params[..., :3 - params.shape[
        -1]]), cost[..., None], prob[..., None]], dim=-1)
    return SymSearch(plane=_plane_from_params(p[:, 0], p[:, 1]),
                     dual_dis=p[:, 2] if dual else torch.zeros_like(p[:, 0]),
                     prob=prob[rows, best], error=cost[rows, best],
                     inits=inits)


def estimate_symmetry_plain(pts, mask, bbox, pose_oc, proj_depth, sym_types,
                            run, cam: Camera,
                            cfg: SymmetryConfig = SymmetryConfig(),
                            src_mask=None, frame=None) -> SymSearch:
    """Plain PyTorch version of ``estimate_symmetry`` (any device; it reads
    the types back to the host to pick the detections of each variant).
    Takes the ray-length depth map ``proj_depth`` [H, W] float32 ([B, H, W]
    with ``frame``) where the kernel takes the raw depth."""
    D, dev = pts.shape[0], pts.device
    out = SymSearch(
        plane=torch.tensor(_PLANE0, device=dev).repeat(D, 1),
        dual_dis=torch.zeros(D, device=dev), prob=torch.zeros(D, device=dev),
        error=torch.zeros(D, device=dev),
        inits=torch.zeros((D, N_INITS, INIT_FIELDS), device=dev))
    for t, dual in ((1, False), (2, True)):
        rows = ((sym_types == t) & run).nonzero().flatten()
        if not rows.numel():
            continue
        res = _pick(*optimize_inits_plain(
            pts[rows], mask[rows], bbox[rows], pose_oc[rows], proj_depth, cam,
            dual, cfg, None if src_mask is None else src_mask[rows],
            None if frame is None else frame[rows]), dual)
        for f, v in zip(out, res):
            f[rows] = v
    return out


def estimate_symmetry(pts, mask, bbox, pose_oc, depth, sym_types, run,
                      cam: Camera, cfg: SymmetryConfig = SymmetryConfig(),
                      src_mask=None, frame=None) -> SymSearch:
    """Grid of 9 initial planes -> best plane per detection
    (Symmetry.cpp:88-128), single and dual detections in one call.

    pts [D, S, 3] the normalized object clouds, mask [D, S], bbox [D, 4],
    pose_oc [D, 7] the camera in each normalized frame, depth [H, W] int32
    the raw depth image, sym_types [D] int32 {0, 1, 2}, run [D] bool.  A
    detection of type 0 or off the run mask gets no search: plane (0, -1,
    0, 0), dual distance, prob, error and its inits 0.  ``src_mask`` [D, S]
    bool (sparse symmetry, JAX's ``src_mask``; None: dense): only the live
    points it holds are mirrored and scored, while every live point stays
    the 1-NN reference and the cost is the mean over the mirrored ones.
    ``frame`` [D] int32 (a batch of frames): depth [B, H, W], detection d
    looked up in frame frame[d].

    On a CUDA device one launch of the ``symmetry_search`` kernel (which
    computes the ray depth at each looked-up pixel); on the CPU
    ``estimate_symmetry_plain`` over ``proj_depth_map``.
    """
    if pts.device.type != "cuda":
        return estimate_symmetry_plain(pts, mask, bbox, pose_oc,
                                       bp.proj_depth_map(depth, cam),
                                       sym_types, run, cam, cfg, src_mask,
                                       frame)
    D, S = mask.shape
    H, W = depth.shape[-2:]
    dev = pts.device
    fk.check("pts", pts, torch.float32, (D, S, 3), dev)
    fk.check("mask", mask, torch.bool, (D, S), dev)
    fk.check("bbox", bbox, torch.float32, (D, 4), dev)
    fk.check("pose_oc", pose_oc, torch.float32, (D, 7), dev)
    if frame is None:
        fk.check("depth", depth, torch.int32, (H, W), dev)
    else:
        fk.check("depth", depth, torch.int32,
                 (depth.shape[0] if depth.dim() == 3 else -1, H, W), dev)
        fk.check("frame", frame, torch.int32, (D,), dev)
    fk.check("sym_types", sym_types, torch.int32, (D,), dev)
    fk.check("run", run, torch.bool, (D,), dev)
    if src_mask is not None:
        fk.check("src_mask", src_mask, torch.bool, (D, S), dev)
    if S > fk.SYM_MAX_POINTS:
        raise ValueError(f"symmetry_search takes at most {fk.SYM_MAX_POINTS} "
                         f"points a detection (got {S})")
    out = SymSearch(
        plane=torch.empty((D, 4), dtype=torch.float32, device=dev),
        dual_dis=torch.empty(D, dtype=torch.float32, device=dev),
        prob=torch.empty(D, dtype=torch.float32, device=dev),
        error=torch.empty(D, dtype=torch.float32, device=dev),
        inits=torch.empty((D, N_INITS, INIT_FIELDS), dtype=torch.float32,
                          device=dev))
    # blocks of a detection count themselves in; the last one picks
    done = torch.zeros(D, dtype=torch.int32, device=dev)
    inv_sig = 1.0 / cfg.sigma
    if D:
        fk.launch(fk.SYMMETRY_SEARCH, "oslam_symmetry_search", dev,
                  [pts.data_ptr(), mask.data_ptr(),
                   None if src_mask is None else src_mask.data_ptr(),
                   bbox.data_ptr(),
                   pose_oc.data_ptr(), depth.data_ptr(),
                   None if frame is None else frame.data_ptr(),
                   sym_types.data_ptr(),
                   run.data_ptr(), D, S, H, W, cam.fx, cam.fy, cam.cx, cam.cy,
                   cam.scale, cam.fx * cam.fx, -0.5 * inv_sig * inv_sig,
                   float(np.float32(np.deg2rad(np.float32(
                       cfg.step_angle_deg)))), cfg.step_dis, cfg.num_delta,
                   2 * cfg.num_delta, cfg.iters, int(cfg.analytic_grad),
                   *(t.data_ptr() for t in out), done.data_ptr()])
    return out


def complete_cloud(pts, mask, result, dual: bool):
    """Mirror-merge the object clouds and re-derive the object frames
    (EllipsoidExtractor.cpp:399-446), for all D detections.

    pts [D, S, 3], mask [D, S], ``result`` a SymSearch (its plane and
    dual distance).
    Returns (pts_m [D, 4S, 3] in the NEW normalized frame, mask_m [D, 4S],
    Tom [D, 7] mapping new frame -> old normalized frame).
    """
    def mirror(plane, p):
        n0, n1, n2, d = (plane[:, None, c] for c in range(4))
        n2sum = torch.clamp_min(n0 * n0 + n1 * n1 + n2 * n2, 1e-8)
        s = ((p[..., 0] * n0 + p[..., 1] * n1 + p[..., 2] * n2 + d)
             / n2sum)[..., None]
        return p - 2.0 * s * plane[:, None, :3]

    plane = result.plane
    m1 = mirror(plane, pts)
    if dual:
        az = torch.atan2(plane[:, 1], plane[:, 0])
        plane2 = _plane_from_params(az, result.dual_dis)
        all_pts = torch.cat([pts, m1, mirror(plane2, pts), mirror(plane2, m1)],
                            dim=1)
        all_mask = mask.repeat(1, 4)
    else:
        all_pts = torch.cat([pts, m1, pts, m1], dim=1)
        all_mask = torch.cat([mask, mask, torch.zeros_like(mask),
                              torch.zeros_like(mask)], dim=1)

    w = all_mask.to(pts.dtype)
    n = torch.clamp_min(w.sum(1), 1.0)
    center = (all_pts * w[..., None]).sum(1) / n[:, None]

    # new frame: x = symmetry-plane normal, z = (0,0,1), y = z cross x
    nrm = plane[:, :3]
    nx = nrm / torch.clamp_min(torch.sqrt((nrm * nrm).sum(-1, keepdim=True)),
                               1e-9)
    nz = torch.zeros_like(nx)
    nz[:, 2] = 1.0
    ny = se3._cross(nz, nx)
    R_om = torch.stack([nx, ny, nz], dim=-1)
    Tom = torch.cat([center, se3.mat_to_quat(R_om)], dim=-1)

    Tmo = se3.se3_inv(Tom)
    Rmo = se3.quat_to_mat(Tmo[:, 3:])
    out = all_pts @ Rmo.transpose(-1, -2) + Tmo[:, None, :3]
    out = torch.where(all_mask[..., None], out, 0.0)
    return out, all_mask, Tom
