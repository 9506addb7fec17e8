"""A dry run of the sharded paths: sharded results against unsharded ones
(the port's counterpart of ``__graft_entry__.dryrun_multichip``).

Every rank of a mesh calls the same function (SPMD).  Each ``check_*``
runs one sharded path and its unsharded twin on the same inputs on the
mesh's device and raises (``AssertionError``) where they part by more
than the JAX dry run's tolerances:

  * the observation-sharded LM: estimates within 2e-4 (rtol and atol),
    chi2 within rtol 0.05;
  * the edge-sharded SLAM solve, step by step from each of its iterates:
    the unsharded step within 5e-4 of the sharded one on the same padded
    graph, the chi2 of the iterate and the trial within rtol 1e-5, and
    the unsharded test taking the same decision or a tie; end to end,
    chi2 within rtol 0.15 and atol 1e-4 of the unsharded run's, and the
    poses and objects within 5e-4 where the two paths do not part;
  * the sharded batched extraction: rows within 1e-3;
  * the offline mapper over the mesh: the map within 1e-3.

Each returns its largest differences, the hand kernels the sharded call
launched on this rank (the launch counters' growth: K1-K4, K11 or K5-K8 on
CUDA tensors, none on the CPU) and the host seconds of the sharded call and
of its twin (each ended by a device synchronisation).
``dryrun_multichip`` runs all four at the JAX dry run's tiny sizes.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict

import numpy as np
import torch

from ..backend import slam_ba as sb
from ..backend.lm import LMConfig, ObjectObservations
from ..backend.lm_soa import optimize_objects_soa
from .collectives import Mesh
from .dist_lm import optimize_objects_sharded
from .dist_slam import optimize_slam_sharded, pad_graph_edges, \
    pad_graph_frames

TOL_LM = 2e-4
TOL_SLAM = 5e-4
TOL_ROWS = 1e-3
TOL_MAP = 1e-3
K_TUM = np.array([[535.4, 0, 320.1], [0, 539.2, 247.6], [0, 0, 1]],
                 np.float32)


def _n(t):
    return t.detach().cpu().numpy()


def _launches():
    """Every hand kernel's launch counter by name."""
    from ..backend import ba_kernels, slam_kernels
    from ..ops import frontend_kernels
    return {k.name: k.launches for k in (*ba_kernels.KERNELS,
                                         *slam_kernels.KERNELS,
                                         *frontend_kernels.KERNELS)}


def _twins(sharded, unsharded, device):
    """Run the sharded call, then its twin: (sharded result, twin result,
    {"launches": the kernels the sharded call launched, "seconds": host
    seconds of each call, ended by a device synchronisation})."""
    def timed(fn):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out, time.perf_counter() - t0

    before = _launches()
    got, t_s = timed(sharded)
    launched = {k: v - before[k] for k, v in _launches().items()
                if v != before[k]}
    want, t_u = timed(unsharded)
    return got, want, {"launches": launched, "seconds": (t_s, t_u)}


def _max_err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max(initial=0.0))


def check_lm(obs: ObjectObservations, K, normal, mesh: Mesh,
             cfg: LMConfig = LMConfig()) -> Dict[str, float]:
    """optimize_objects_sharded against optimize_objects_soa (ground set)."""
    (est, chi2), (est_r, chi2_r), info = _twins(
        lambda: optimize_objects_sharded(obs, K, normal, True, mesh, cfg),
        lambda: optimize_objects_soa(obs, K, normal, True, cfg), mesh.device)
    est, chi2, est_r, chi2_r = map(_n, (est, chi2, est_r, chi2_r))
    np.testing.assert_array_equal(np.isfinite(est), True)
    np.testing.assert_allclose(est, est_r, rtol=TOL_LM, atol=TOL_LM)
    np.testing.assert_allclose(chi2, chi2_r, rtol=0.05, atol=1e-4)
    return {"est": _max_err(est, est_r), "chi2": _max_err(chi2, chi2_r),
            **info}


def check_slam(g: sb.SlamGraph, K, normal, mesh: Mesh, cfg: LMConfig,
               cg_iters: int, shard_solve: bool,
               banded: bool) -> Dict[str, float]:
    """optimize_slam_sharded against optimize_slam on the padded graph.

    Step by step, from every iterate of the sharded run: the unsharded
    step (``slam_ba.schur_step``) within TOL_SLAM of the sharded one, its
    lam0 within rtol 1e-5, and the unsharded chi2 of the trial and of the
    iterate within rtol 1e-5 of the sharded run's (f32 round-off), so that
    the unsharded test takes the sharded decision unless the two tie
    within 1e-5.  End to end, the unsharded run on its own path: chi2
    within rtol 0.15 and atol 1e-4, and where the two paths take the same
    decisions the poses and objects within TOL_SLAM (the JAX dry run's
    checks); the iteration where they part is reported (None where they do
    not)."""
    gp = pad_graph_edges(g, mesh.size)
    if shard_solve:
        gp = pad_graph_frames(gp, mesh.size)
    trace, trace_r = [], []
    (poses, objs, chi2), (poses_r, objs_r, chi2_r), info = _twins(
        lambda: optimize_slam_sharded(g, K, normal, mesh, cfg, cg_iters,
                                      shard_solve=shard_solve,
                                      banded=banded, trace=trace),
        lambda: sb.optimize_slam(gp, K, normal, cfg, cg_iters,
                                 banded=banded, trace=trace_r), mesh.device)
    poses, objs, poses_r, objs_r = map(_n, (poses, objs, poses_r, objs_r))
    np.testing.assert_array_equal(np.isfinite(poses), True)
    np.testing.assert_array_equal(np.isfinite(objs), True)

    step = sb.schur_step(gp, K, normal, cg_iters, banded)
    step_err = {"poses": 0.0, "objects": 0.0, "chi2": 0.0}
    for i, t in enumerate(trace):
        dx_p, dx_o, lam0 = step(t.poses, t.objects, t.lam)
        for name, a, b in (("poses", t.dx_p, dx_p), ("objects", t.dx_o,
                                                     dx_o)):
            a, b = _n(a), _n(b)
            np.testing.assert_allclose(
                a, b, rtol=TOL_SLAM, atol=TOL_SLAM,
                err_msg=f"iteration {i}: the sharded step of the {name}")
            step_err[name] = max(step_err[name], _max_err(a, b))
        np.testing.assert_allclose(float(t.lam0), float(lam0), rtol=1e-5)
        trial_new, trial_cur = (
            float(sb._chi2(p, o, gp, K, normal)) for p, o in (
                sb.apply_updates(t.poses, t.objects, t.dx_p, t.dx_o),
                (t.poses, t.objects)))
        got = np.array([float(t.trial_chi2), float(t.chi2)])
        want = np.array([trial_new, trial_cur])
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   err_msg=f"iteration {i}: the sharded chi2")
        step_err["chi2"] = max(step_err["chi2"], float(
            (np.abs(got - want) / np.maximum(np.abs(want), 1e-30)).max()))
        decide = bool(trial_new < trial_cur and np.isfinite(trial_new))
        if decide != bool(t.accept) and \
                abs(trial_new - trial_cur) > 1e-5 * abs(trial_cur):
            raise AssertionError(
                f"iteration {i}: the sharded run decided {bool(t.accept)}, "
                f"the unsharded test decides {decide} at trial chi2 "
                f"{trial_new!r} against {trial_cur!r}, no tie")
    chi2, chi2_r = float(chi2), float(chi2_r)
    np.testing.assert_allclose(chi2, chi2_r, rtol=0.15, atol=1e-4)
    part = next((i for i, (a, b) in enumerate(zip(trace, trace_r))
                 if bool(a.accept) != bool(b.accept)), None)
    if part is None:
        np.testing.assert_allclose(poses, poses_r, rtol=TOL_SLAM,
                                   atol=TOL_SLAM)
        np.testing.assert_allclose(objs, objs_r, rtol=TOL_SLAM,
                                   atol=TOL_SLAM)
    return {"step_poses": step_err["poses"],
            "step_objects": step_err["objects"],
            "step_chi2_rel": step_err["chi2"],
            "poses": _max_err(poses, poses_r),
            "objects": _max_err(objs, objs_r), "chi2": chi2,
            "chi2_unsharded": chi2_r, "paths_part_at": part, **info}


def check_batch(batch, cam, mesh: Mesh) -> Dict[str, float]:
    """dispatch_batch over the mesh against the unsharded call."""
    from ..frontend.batch_extractor import dispatch_batch, fetch_batch
    rows, rows_r, info = _twins(
        lambda: fetch_batch(dispatch_batch(batch, cam, mesh=mesh)),
        lambda: fetch_batch(dispatch_batch(batch, cam, device=mesh.device)),
        mesh.device)
    np.testing.assert_array_equal(rows.shape, (batch.pad, 12))
    np.testing.assert_array_equal(np.isfinite(rows), True)
    if rows_r[:, 11].sum() < 1:
        raise AssertionError("no detection of the batch was extracted")
    np.testing.assert_allclose(rows, rows_r, rtol=TOL_ROWS, atol=TOL_ROWS)
    return {"rows": _max_err(rows, rows_r), **info}


def check_map(run: Callable[[object], dict], mesh: Mesh) -> Dict[str, float]:
    """``run(mesh)`` and ``run(None)``, each returning a map {instance:
    vec10}: the same instances within TOL_MAP."""
    got, want, info = _twins(lambda: run(mesh), lambda: run(None),
                             mesh.device)
    if set(got) != set(want) or not want:
        raise AssertionError(f"maps differ in their instances: "
                             f"{sorted(got)} against {sorted(want)}")
    for inst in want:
        np.testing.assert_allclose(got[inst], want[inst], rtol=TOL_MAP,
                                   atol=TOL_MAP)
    return {"map": max(_max_err(got[i], want[i]) for i in want), **info}


# ---------------------------------------------------------------------------
# the JAX dry run's tiny workloads
# ---------------------------------------------------------------------------

def tiny_lm_workload(O, M2, M3, device):
    """``__graft_entry__._tiny_workload``: O objects seen from a camera 3 m
    behind the origin, noisy boxes and 3D measurements.  (obs, K, normal)
    on ``device``."""
    rng = np.random.default_rng(0)
    est0 = np.tile(np.array([0, 0, 0, 0, 0, 0, 1, 0.5, 0.4, 0.3],
                            np.float32), (O, 1))
    est0[:, :3] += rng.normal(0, 0.2, (O, 3)).astype(np.float32)
    p2 = np.tile(np.array([0, 0, 0, 0, 0, 0, 1], np.float32), (O, M2, 1))
    p2[..., 2] = -3.0
    b2 = np.tile(np.array([250.0, 200, 400, 320], np.float32), (O, M2, 1))
    b2 += rng.normal(0, 3, b2.shape).astype(np.float32)
    p3 = np.tile(np.array([0, 0, -3, 0, 0, 0, 1], np.float32), (O, M3, 1))
    me3 = np.tile(np.array([0, 0, 3, 0, 0, 0, 1, 0.5, 0.4, 0.3], np.float32),
                  (O, M3, 1))
    me3[..., :3] += rng.normal(0, 0.05, (O, M3, 3)).astype(np.float32)
    arrays = dict(est0=est0, obj_mask=np.ones(O, bool), pose2d_cw=p2,
                  bbox2d=b2, prob2d=np.full((O, M2), 0.9, np.float32),
                  mask2d=np.ones((O, M2), bool), pose3d_wc=p3, meas3d=me3,
                  prob3d=np.full((O, M3), 0.8, np.float32),
                  mask3d=np.ones((O, M3), bool))
    from ..backend.lm import observations_from_numpy
    return (observations_from_numpy(arrays, device),
            torch.as_tensor(K_TUM, device=device),
            torch.tensor([0.0, 0.0, 1.0], device=device))


def circle_slam_graph(F, device, seed=1) -> sb.SlamGraph:
    """``__graft_entry__._dryrun_slam_mode``'s graph: F cameras on a circle
    looking at one object, a 2D and a 3D edge a frame, chain odometry of
    weight 10, noisy initial poses (frame 0 exact) and object."""
    from ..core import ellipsoid as ell
    from ..core import se3
    rng = np.random.default_rng(seed)
    K = torch.as_tensor(K_TUM, dtype=torch.float64)
    gt_obj = torch.tensor([0.2, -0.1, 0.4, 0, 0, 0, 1, 0.5, 0.3, 0.25],
                          dtype=torch.float64)
    poses_cw, e2b, e3m = [], [], []
    for i in range(F):
        ang = 2 * np.pi * i / F
        t_wc = np.array([2.5 * np.cos(ang), 2.5 * np.sin(ang), 1.0])
        z = gt_obj[:3].numpy() - t_wc
        z /= np.linalg.norm(z)
        x = np.cross(np.array([0, 0, 1.0]), z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z], axis=1)
        q = se3.mat_to_quat(torch.as_tensor(R))
        p_wc = torch.cat([torch.as_tensor(t_wc), q])
        p_cw = se3.se3_inv(p_wc)
        poses_cw.append(p_cw.numpy())
        e2b.append(ell.project_bbox(gt_obj, p_cw, K).numpy())
        e3m.append(ell.transform_to(gt_obj, p_wc).numpy())
    poses_cw = np.stack(poses_cw).astype(np.float32)
    init_cw = poses_cw.copy()
    init_cw[1:, :3] += rng.normal(0, 0.02, (F - 1, 3)).astype(np.float32)
    pc = torch.as_tensor(poses_cw, dtype=torch.float64)
    odo = se3.se3_mul(pc[1:], se3.se3_inv(pc[:-1])).numpy()
    obj0 = gt_obj.numpy() + np.concatenate([rng.normal(0, 0.05, 3),
                                            np.zeros(7)])
    arrays = dict(
        poses_cw=init_cw, frame_mask=np.ones(F, bool),
        objects=obj0[None], obj_mask=np.ones(1, bool),
        e2_frame=np.arange(F), e2_obj=np.zeros(F), e2_bbox=np.stack(e2b),
        e2_w=np.ones(F), e3_frame=np.arange(F), e3_obj=np.zeros(F),
        e3_meas=np.stack(e3m), e3_w=np.ones(F), odo_i=np.arange(F - 1),
        odo_j=np.arange(1, F), odo_meas=odo, odo_w=np.full(F - 1, 10.0),
        grav_w=np.zeros(1))
    return sb.graph_from_numpy(arrays, device)


def probe_camera():
    """The JAX dry run's 64x48 probe camera, its one-object scene and the
    extractor settings that suit its ~4 cm pixels."""
    from ..core.camera import Camera
    from ..frontend.extractor import ExtractorConfig
    from ..io.synthetic import make_scene
    cam = Camera(fx=60.0, fy=60.0, cx=32.0, cy=24.0, scale=5000.0,
                 width=64, height=48)
    scene = make_scene(n_objects=1, seed=2, camera=cam,
                       scale_range=(0.3, 0.45))
    cfg = ExtractorConfig(cluster_min_size=5, cluster_tolerance=0.3,
                          cluster_center_dis=1.0)
    return cam, scene, cfg


def probe_batch(n_frames):
    """``_dryrun_batched_extraction``'s batch: n_frames frames of the probe
    scene packed as one batch (plane z = 0).  (batch, cam)."""
    from ..frontend.batch_extractor import pack_frames_batch
    from ..io.synthetic import SyntheticDataset
    cam, scene, cfg = probe_camera()
    frames = []
    for _, _, pose, depth, _, det in SyntheticDataset(
            scene, n_frames=n_frames, orbit_radius=2.6, height=1.2,
            min_bbox_px=3.0).frames():
        frames.append((depth, det[:, 1:5], det[:, 5].astype(int),
                       np.ones(det.shape[0], bool), pose.astype(np.float32)))
    return pack_frames_batch(cam, cfg, frames,
                             np.array([0, 0, 1, 0], np.float32)), cam


def probe_offline_run(device, n_frames, batch_size):
    """``_dryrun_offline_mapper``'s run: ``run(mesh)`` maps n_frames probe
    frames with the offline mapper (the plane latched, one BA a frame) and
    returns the map."""
    from ..frontend import make_extractor
    from ..io.synthetic import SyntheticDataset
    from ..system import System
    from ..system.offline import OfflineMapper
    cam, scene, cfg = probe_camera()
    yaml = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "configs", "synthetic_depth.yaml")

    def run(mesh):
        slam = System(yaml, extractor=make_extractor(cam, cfg, device),
                      device=device)
        slam.tracker.state.ground_plane = np.array([0, 0, 1, 0.0])
        slam.tracker.state.ground_state = 2
        mapper = OfflineMapper(slam, cam, cfg, batch_size=batch_size,
                               mesh=mesh, backend_per_batch=False)
        stats = mapper.run(SyntheticDataset(
            scene, n_frames=n_frames, orbit_radius=2.6, height=1.2,
            min_bbox_px=3.0).frames())
        if stats["frames"] != n_frames or mapper.batches_dispatched < 2:
            raise AssertionError(f"the offline run made {stats}")
        return slam.map_objects
    return run


def dryrun_multichip(mesh: Mesh = None,
                     offline: bool = True) -> Dict[str, Dict[str, float]]:
    """The four checks at the JAX dry run's sizes on ``mesh`` (default
    ``multihost.observation_mesh()``: the active group's ranks on the
    card); ``offline=False`` leaves out the offline mapper's, which maps
    the probe scene twice.  Every rank calls it; returns each check's
    largest differences."""
    if mesh is None:
        from .multihost import observation_mesh
        mesh = observation_mesh()
    n, dev = mesh.size, mesh.device
    out = {"lm": check_lm(*tiny_lm_workload(4, max(32, 8 * n),
                                            max(16, 4 * n), dev), mesh)}
    g = circle_slam_graph(max(8, n), dev)
    out["slam"] = check_slam(g, torch.as_tensor(K_TUM, device=dev),
                             torch.zeros(3, device=dev), mesh,
                             LMConfig(iters=3), 16, shard_solve=True,
                             banded=True)
    batch, cam = probe_batch(n)
    out["batch"] = check_batch(batch, cam, mesh)
    if offline:
        out["offline"] = check_map(probe_offline_run(
            dev, max(2 * n, 6) + 1, max(n, 2)), mesh)
    return out
