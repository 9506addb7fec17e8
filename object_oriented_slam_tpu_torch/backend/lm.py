"""Mapping-mode LM: the types and the array-of-structs (AoS) solver
(port of ``backend/lm.py``).

In mapping mode the camera poses are fixed (the reference's
``Optimizer.cpp:126,136``), so the object graph decomposes into one
independent 9-DoF problem per object landmark.  ``backend/lm_soa.py``
solves all of them as one batch with the observation axis in lanes (the
tracker's default); ``optimize_objects`` here is the JAX package's AoS
solver, ``_solve_object`` per object slot, with the same edge semantics
(Optimizer.cpp:83-317): the >2-obs gate on 2D edges, info = I4·prob, the
NaN gate at the initial estimate, 3D edges at I9·prob·Scale, the gravity
prior, the optional visibility gate and Huber kernel, 10 iterations of
g2o's λ/ν schedule and the right-multiplicative SE3⊕scale update.

Its edge work has two implementations with one contract:

* on CPU tensors the plain twin in the JAX package's order: each object's
  stacked residual (``_weighted_residual``) and its 9 tangent directions
  by ``torch.func.jvp`` under ``vmap`` (JAX ``jax.linearize``), then
  J^T J, J^T r and r^T r;
* on CUDA tensors no plain version: the per-object edge sums are what the
  BA kernels K1-K4 compute, so each iteration is one launch of
  ``ba_normal_eq`` and one of ``ba_chi2`` (``lm_soa.soa_normal_eq`` /
  ``soa_chi2``, the kernels without their LM epilogues).

Around either, the AoS solve, gates and schedule are this module's own.
Where the AoS semantics differ from ``lm_soa.optimize_objects_soa``:
  * the residual and its Jacobian are the AoS formulas (the conic's
    ellipse parameters, ``core/ellipsoid.project_bbox``) on the CPU, and
    the kernels' SoA formulas on the card: ~1e-4 apart from round-off;
  * ``du`` is gated as a whole vector (any non-finite entry zeroes the
    object's step), the weights are the AoS gates (the NaN gate at est0
    through ``residuals.residual_proj``), every non-finite residual row
    counts as 0, an object without edges keeps est0, and the trial update
    is ``core/ellipsoid.exp_update``;
  * an edge with a non-finite tangent is left out of H and g (the port's
    rule, the kernels' too, ``lm_soa._drop_nonfinite_edges``; JAX freezes
    the whole object).
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from ..core import ellipsoid as ell
from ..ops.linalg import chol_solve_small
from ..utils.device import resolve_device
from . import residuals as res

_TAU = 1e-5  # g2o OptimizationAlgorithmLevenberg initial lambda factor


class ObjectObservations(NamedTuple):
    """Fixed-capacity per-object observation buffers (padded + masked).

    Shapes (O objects, M2 2d-observations, M3 3d-observations):
      est0      [O, 10]  initial ellipsoid estimates (vec10)
      obj_mask  [O]      which object slots are live
      pose2d_cw [O, M2, 7] camera Tcw per 2d obs
      bbox2d    [O, M2, 4] measured bbox (border coords = -1)
      prob2d    [O, M2]
      mask2d    [O, M2]
      pose3d_wc [O, M3, 7] camera Twc per 3d obs
      meas3d    [O, M3, 10] measured local ellipsoid (vec10)
      prob3d    [O, M3]
      mask3d    [O, M3]
    Float fields are float32, masks are bool.
    """
    est0: torch.Tensor
    obj_mask: torch.Tensor
    pose2d_cw: torch.Tensor
    bbox2d: torch.Tensor
    prob2d: torch.Tensor
    mask2d: torch.Tensor
    pose3d_wc: torch.Tensor
    meas3d: torch.Tensor
    prob3d: torch.Tensor
    mask3d: torch.Tensor


_MASKS = ("obj_mask", "mask2d", "mask3d")


def observations_from_numpy(arrays: Dict[str, np.ndarray],
                            device=None) -> ObjectObservations:
    """Build the port's ObjectObservations from numpy arrays on ``device``
    (the card unless the caller names one; it raises without one).

    ``arrays`` maps every field name of ``ObjectObservations`` (the JAX
    package's field names and shapes) to a numpy array, e.g.
    ``{k: np.asarray(v) for k, v in jax_obs._asdict().items()}``.
    """
    device = resolve_device(device)
    missing = set(ObjectObservations._fields) - set(arrays)
    if missing:
        raise KeyError(f"missing observation fields: {sorted(missing)}")
    out = {}
    for name in ObjectObservations._fields:
        a = np.asarray(arrays[name], bool if name in _MASKS else np.float32)
        out[name] = torch.tensor(a, device=device)
    return ObjectObservations(**out)


def observations_from_flat(flat: torch.Tensor, est_prev: torch.Tensor,
                           layout) -> ObjectObservations:
    """Views into one packed f32 batch on the device (the tracker's
    ``_lm_layout``: ((name, offset, shape), ...)), the slots with
    ``useprev`` warm-started from ``est_prev``, the previous LM call's
    device estimate (JAX ``Tracking._get_unpack`` / ``_lm_from_flat``)."""
    out = {}
    for name, off, shp in layout:
        out[name] = flat[off:off + int(np.prod(shp))].reshape(shp)
    est0 = torch.where(out["useprev"][:, None] > 0.5, est_prev, out["est0"])
    return ObjectObservations(
        est0=est0, obj_mask=out["objmask"] > 0.5,
        pose2d_cw=out["p2"], bbox2d=out["b2"], prob2d=out["pr2"],
        mask2d=out["m2"] > 0.5,
        pose3d_wc=out["p3"], meas3d=out["me3"], prob3d=out["pr3"],
        mask3d=out["m3"] > 0.5)


class LMConfig(NamedTuple):
    scale_3d: float = 10000.0        # Optimizer.Edges.3DEllipsoid.Scale
    gravity_scale: float = 100.0     # Optimizer.Edges.GravityPrior.Scale
    gravity_on: bool = True          # Optimizer.Edges.GravityPrior.Open
    iters: int = 10                  # Optimizer.cpp:291
    min_2d_obs: int = 3              # "> 2 observations" gate (:201)
    huber_delta: float = 0.0         # >0 enables the Huber kernel the
                                     # reference keeps disabled
                                     # (Optimizer.cpp:224)
    check_visibility: bool = False   # the optional 2D-edge visibility
                                     # gate, disabled by default like
                                     # Optimizer.cpp:232 ('c1')
    vis_rows: int = 480              # image size for the in-image test
    vis_cols: int = 640              # (Optimizer.cpp:20-27)


# ---------------------------------------------------------------------------
# The array-of-structs solver
# ---------------------------------------------------------------------------

def _huber_weight(r_edge: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS sqrt-weight of the Huber kernel per edge row [..., M]: g2o
    RobustKernelHuber's sqrt(rho'(s)), detached (the Jacobian uses the
    current iterate's weights)."""
    s = torch.sum(r_edge * r_edge, dim=-1)
    w = torch.where(s > delta * delta,
                    torch.sqrt(delta / torch.clamp_min(torch.sqrt(s), 1e-12)),
                    1.0)
    return w.detach()


def _weighted_residual(e, pose2d_cw, bbox2d, K, normal, w2d, w3d, wg, pre3d,
                       huber_delta: float = 0.0):
    """Stacked sqrt-info-weighted residual [4 M2 + 9 M3 + 1] of one object
    (e [10]); the weights fold in the edge masks, non-finite rows are 0."""
    r2 = res.residual_proj(e, pose2d_cw, K, bbox2d) * w2d[:, None]
    r3 = res.residual_3d_pre(e, pre3d[0], pre3d[1]) * w3d[:, None]
    rg = res.residual_gravity(e, normal)
    if huber_delta > 0.0:
        r2 = r2 * _huber_weight(r2, huber_delta)[:, None]
        r3 = r3 * _huber_weight(r3, huber_delta)[:, None]
    r = torch.cat([r2.reshape(-1), r3.reshape(-1), rg * wg])
    return torch.where(torch.isfinite(r), r, 0.0)


def _edge_weights(obs: ObjectObservations, K, gravity_active: bool,
                  cfg: LMConfig):
    """(w2d [O,M2], w3d [O,M3], wg [O]) with the AoS gates folded in: the
    >2-obs gate, the NaN gate at est0 (Optimizer.cpp:234-243) and the
    optional visibility gate (Optimizer.cpp:35-81)."""
    gate2d = (obs.mask2d.sum(dim=1) >= cfg.min_2d_obs)[:, None]
    w2d = torch.sqrt(torch.clamp_min(obs.prob2d, 0.0))
    w2d = torch.where(obs.mask2d & gate2d, w2d, 0.0)
    w3d = torch.sqrt(torch.clamp_min(obs.prob3d, 0.0) * cfg.scale_3d)
    w3d = torch.where(obs.mask3d, w3d, 0.0)
    O = obs.est0.shape[0]
    wg = torch.full((O,), cfg.gravity_scale if gravity_active else 0.0,
                    dtype=obs.est0.dtype, device=obs.est0.device)
    r2_init = res.residual_proj(obs.est0[:, None, :], obs.pose2d_cw, K,
                                obs.bbox2d)
    w2d = torch.where(torch.all(torch.isfinite(r2_init), dim=-1), w2d, 0.0)
    if cfg.check_visibility:
        from .lm_soa import soa_visibility2d   # lm_soa imports this module
        p2 = obs.pose2d_cw
        vis = soa_visibility2d(obs.est0, tuple(p2[..., k] for k in range(3)),
                               tuple(p2[..., 3 + k] for k in range(4)), K,
                               cfg.vis_rows, cfg.vis_cols)
        w2d = torch.where(vis, w2d, 0.0)
    return w2d.contiguous(), w3d.contiguous(), wg


def _plain_problem(obs, K, normal, w2d, w3d, wg, cfg):
    """The per-object residual function of the plain twin:
    r_of(u [O,9], e [O,10]) -> [O, R] at exp_update(e, u)."""
    pre3d = res.precompute_3d_measurement(obs.pose3d_wc, obs.meas3d)

    def one(u, e, p2, b2, ww2, ww3, wwg, inv4, sc4):
        return _weighted_residual(ell.exp_update(e, u), p2, b2, K, normal,
                                  ww2, ww3, wwg[None], (inv4, sc4),
                                  cfg.huber_delta)

    per_object = torch.func.vmap(one)
    return lambda u, e: per_object(u, e, obs.pose2d_cw, obs.bbox2d, w2d, w3d,
                                   wg, pre3d[0], pre3d[1])


def _drop_nonfinite_edges(r, J, M2, M3):
    """Zero the rows of r [O,R] and J [O,R,9] of every edge (4 rows a 2D
    edge, 9 a 3D edge, 1 gravity) with a non-finite tangent entry."""
    fin = torch.isfinite(J).all(dim=-1)
    fin = torch.cat([fin[:, :4 * M2].reshape(-1, M2, 4).all(-1)
                     .repeat_interleave(4, dim=1),
                     fin[:, 4 * M2:4 * M2 + 9 * M3].reshape(-1, M3, 9).all(-1)
                     .repeat_interleave(9, dim=1),
                     fin[:, -1:]], dim=1)
    return torch.where(fin, r, 0.0), torch.where(fin[..., None], J, 0.0)


def _normal_eq_plain(r_of, e, M2, M3):
    """(H [O,9,9], g [O,9]) of the plain twin: the 9 tangent directions of
    each object's residual at u = 0 (jvp under vmap), J^T J and J^T r."""
    O = e.shape[0]
    u0 = torch.zeros((O, 9), dtype=e.dtype, device=e.device)
    basis = torch.eye(9, dtype=e.dtype, device=e.device)[:, None, :]
    r, t = torch.func.vmap(
        lambda d: torch.func.jvp(lambda u: r_of(u, e), (u0,), (d,)))(
            basis.expand(9, O, 9))
    r, J = _drop_nonfinite_edges(r[0], t.permute(1, 2, 0), M2, M3)
    return J.transpose(1, 2) @ J, (J.transpose(1, 2) @ r[..., None])[..., 0]


def _solve_step(e, lam, H, g):
    """The damped 9x9 Cholesky solve of one AoS iteration: lambda_init =
    tau * max diag(H) where lam < 0, du = -(H + lam0 I)^-1 g zeroed as a
    whole vector where any entry is non-finite.  Returns (e_new, du,
    lam0)."""
    lam0 = torch.where(lam < 0, _TAU * torch.amax(
        torch.diagonal(H, dim1=1, dim2=2), dim=1), lam)
    lam0 = torch.clamp_min(lam0, 1e-12)
    A = H + lam0[:, None, None] * torch.eye(9, dtype=H.dtype, device=H.device)
    du = -chol_solve_small(A, g)
    du = torch.where(torch.all(torch.isfinite(du), dim=1, keepdim=True),
                     du, 0.0)
    return ell.exp_update(e, du), du, lam0


def _solve_object(obs: ObjectObservations, K, normal, cfg: LMConfig,
                  gravity_active: bool):
    """Every object slot's LM loop (JAX ``_solve_object`` over the object
    axis); returns (estimates [O,10], final chi2 [O])."""
    from . import lm_soa                # lm_soa imports this module
    w2d, w3d, wg = _edge_weights(obs, K, gravity_active, cfg)
    e0 = obs.est0
    if e0.device.type == "cuda":
        # K1-K4: the per-object edge sums of the SoA kernels
        problem = (lm_soa.soa_prepare(obs.pose2d_cw, obs.bbox2d,
                                      obs.pose3d_wc, obs.meas3d),
                   w2d, w3d, wg, normal, K, cfg.huber_delta)

        def normal_eq(e):
            H, g, _ = lm_soa.soa_normal_eq(e, *problem)
            return H, g

        def chi2_of(e):
            return lm_soa.soa_chi2(e, *problem)
    elif e0.device.type == "cpu":
        r_of = _plain_problem(obs, K, normal, w2d, w3d, wg, cfg)
        M2, M3 = obs.mask2d.shape[1], obs.mask3d.shape[1]

        def normal_eq(e):
            return _normal_eq_plain(r_of, e, M2, M3)

        def chi2_of(e):
            r = r_of(torch.zeros_like(e[:, :9]), e)
            return torch.sum(r * r, dim=-1)
    else:
        raise NotImplementedError(
            f"no backend for tensors on {e0.device}: the AoS edge work runs "
            "as CUDA kernels on cuda tensors and in plain PyTorch on cpu")

    O = e0.shape[0]
    e = e0.contiguous()
    lam = torch.full((O,), -1.0, dtype=e0.dtype, device=e0.device)
    nu = torch.full((O,), 2.0, dtype=e0.dtype, device=e0.device)
    chi2 = chi2_of(e)
    for _ in range(cfg.iters):
        H, g = normal_eq(e)
        e_new, du, lam0 = _solve_step(e, lam, H, g)
        e, chi2, lam, nu, _ = lm_soa.accept_from_chi2(
            e, chi2, nu, e_new, chi2_of(e_new), du, g, lam0)

    has_edges = (torch.sum(w2d, dim=1) + torch.sum(w3d, dim=1)) > 0
    keep = (obs.obj_mask & has_edges)[:, None]
    return torch.where(keep, e, e0), chi2


def optimize_objects(obs: ObjectObservations, K: torch.Tensor,
                     ground_normal: torch.Tensor, ground_set,
                     cfg: LMConfig = LMConfig()):
    """Global object-graph optimization, mapping mode, AoS
    (``Optimizer::GlobalObjectGraphOptimization``, Optimizer.cpp:83-317,
    for fixed camera poses).  Runs on the device of ``obs``: on CUDA
    tensors two BA kernel launches an iteration, on CPU tensors the plain
    twin.  Returns (estimates [O,10], chi2 [O])."""
    dev, f32 = obs.est0.device, obs.est0.dtype
    K = K.to(device=dev, dtype=f32)
    normal = ground_normal.to(device=dev, dtype=f32)
    gravity_active = bool(ground_set) and bool(cfg.gravity_on)
    return _solve_object(obs, K, normal, cfg, gravity_active)
