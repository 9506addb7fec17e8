"""Observation-sharded mapping-mode bundle adjustment (port of
``parallel/dist_lm.py``).

The observation axis M, the one that grows with the trajectory, is split
over the ranks of a mesh: each rank takes its contiguous slice of the 2D
and 3D observation rings and builds the normal equations of its edges,
the per-object 9x9 blocks are summed over the ranks (``psum``), and the
small replicated 9x9 solves apply the single-device LM's accept / reject
schedule, so every rank holds the same iterates and they are the
single-device ones up to the order of the sums.

On CUDA tensors each rank's shard launches the hand kernels: K1/K2
(``ba_normal_eq``, the launch without the solve epilogue, which cannot run
before the sum) and K3/K4 (``ba_chi2``, without the accept epilogue), one
of each an iteration; on CPU tensors their plain versions run.  The
replicated part is ``lm_soa.solve_from_normal_eq`` and
``lm_soa.accept_from_chi2``.
"""
from __future__ import annotations

import torch

from ..backend import lm_soa as soa
from ..backend.lm import LMConfig, ObjectObservations
from .collectives import Mesh, axis_index, psum


def _shard(obs: ObjectObservations, mesh: Mesh) -> ObjectObservations:
    """This rank's contiguous slice of the observation axes (the JAX
    package's ``P(None, AXIS)`` specs); estimates and masks replicated."""
    n, r = mesh.size, mesh.rank
    M2, M3 = obs.mask2d.shape[1], obs.mask3d.shape[1]
    if M2 % n or M3 % n:
        raise ValueError(f"the observation tiers ({M2}, {M3}) do not divide "
                         f"over {n} ranks")
    s2 = slice(r * M2 // n, (r + 1) * M2 // n)
    s3 = slice(r * M3 // n, (r + 1) * M3 // n)
    return obs._replace(
        pose2d_cw=obs.pose2d_cw[:, s2], bbox2d=obs.bbox2d[:, s2],
        prob2d=obs.prob2d[:, s2], mask2d=obs.mask2d[:, s2],
        pose3d_wc=obs.pose3d_wc[:, s3], meas3d=obs.meas3d[:, s3],
        prob3d=obs.prob3d[:, s3], mask3d=obs.mask3d[:, s3])


def optimize_objects_sharded(obs: ObjectObservations, K: torch.Tensor,
                             ground_normal: torch.Tensor, ground_set: bool,
                             mesh: Mesh, cfg: LMConfig = LMConfig()):
    """Mapping-mode BA with the observation axis sharded over ``mesh``.

    Every rank passes the same full ``obs`` (SPMD) on its mesh device and
    gets the replicated (estimates [O,10], chi2 [O]).  The tiers M2 and M3
    must divide over the ranks (the tracker's are powers of two).  As in
    the JAX package: the >2-obs gate counts every shard's observations,
    the gravity edge lives on shard 0 only, the NaN gate is taken at the
    initial estimates, and an object with no edge on any shard keeps its
    initial estimate.
    """
    O = obs.mask2d.shape[0]
    dev, f32 = obs.est0.device, obs.est0.dtype
    K = K.to(device=dev, dtype=f32)
    ground_normal = ground_normal.to(device=dev, dtype=f32)
    local = _shard(obs, mesh)

    prep = soa.soa_prepare(local.pose2d_cw, local.bbox2d, local.pose3d_wc,
                           local.meas3d)
    n2d = psum(local.mask2d.sum(dim=1), mesh)
    w2d, w3d, wg = soa.soa_edge_weights(local, prep, K, ground_set, cfg,
                                        n2d=n2d)
    if axis_index(mesh) != 0:
        wg = torch.zeros_like(wg)
    problem = (prep, w2d, w3d, wg, ground_normal, K, cfg.huber_delta)

    def chi2_at(est):
        return psum(soa.soa_chi2(est, *problem), mesh)

    est = obs.est0.contiguous()
    lam = torch.full((O,), -1.0, dtype=f32, device=dev)
    nu = torch.full((O,), 2.0, dtype=f32, device=dev)
    chi2 = chi2_at(est)
    for _ in range(cfg.iters):
        H_l, g_l, _ = soa.soa_normal_eq(est, *problem)
        Hg = psum(torch.cat([H_l.reshape(O, 81), g_l], dim=1), mesh)
        H, g = Hg[:, :81].reshape(O, 9, 9), Hg[:, 81:]
        est_new, du, lam0 = soa.solve_from_normal_eq(est, lam, H, g)
        est, chi2, lam, nu, _ = soa.accept_from_chi2(
            est, chi2, nu, est_new, chi2_at(est_new), du, g, lam0)

    has_edges = psum(w2d.sum(dim=1) + w3d.sum(dim=1), mesh) > 0
    keep = (obs.obj_mask & has_edges)[:, None]
    return torch.where(keep, est, obs.est0), chi2
