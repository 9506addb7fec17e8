"""The port's SLAM mode (core/se3 and core/ellipsoid additions,
backend/residuals.py, backend/slam_ba.py, system/slam_mode.py) against the
JAX package on the CPU, and the whole solver against the f64 oracle.

Inputs are made from seeds with numpy.  The graph of the edge, assembly,
chi2 and Schur cases is examples/torch_slam_edges_on_cpu.py's orbit: 12
frames, 2 objects, 24 2D and 24 3D edges, the chain odometry and gravity,
one 2D edge with a non-finite residual and one 3D measurement a quarter
turn of yaw away.
The JAX side runs its eager functions, one jitted banded assembly and one
jitted chi2 (module-scoped), and its eager banded Schur solve; no JAX
optimize_slam or run_slam_mode (their scan bodies take minutes to compile
on the CPU): the whole solver is held against tests/oracle_slam.py.  The
command line runs ``--odometry --slam-mode`` on tests/test_torch_run_tum.py's
export (its first SPLIT frames), in this module because that file is
tier-1's longest.

Tolerances: the se3 / ellipsoid additions 1e-6 (rtol and atol: the same
f32 formulas in XLA:CPU and PyTorch); the residuals and the edge terms' r
1e-5 (the projected bbox relative to its pixel coordinates, the others
with an absolute floor of 1e-5); both assemblies 1e-4 of each output's
largest entry; chi2 1e-5 relative.  On the orbit the projected-bbox chain
loses digits in f32 (the conic's inverse: ~0.02 px, in either package), so
there the edge terms' 2D r, the assemblies and chi2 may also differ from
JAX's by up to 3 times the port's own f32 error, its distance from its
float64 evaluation, where that is the larger bound.  The Schur solves
tests/test_slam_banded.py's 5e-4; the solver test_slam_oracle.py's 5e-3
on poses and 8e-3 on objects, and banded against dense 2e-3
(test_slam_banded.py); the packed graph exactly.
"""
import importlib.util
import logging
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_oriented_slam_tpu.backend import residuals as jres
from object_oriented_slam_tpu.backend import slam_ba as jslam
from object_oriented_slam_tpu.backend.lm import LMConfig as JLMConfig
from object_oriented_slam_tpu.core import ellipsoid as jell
from object_oriented_slam_tpu.core import se3 as jse3
from object_oriented_slam_tpu.system import checkpoint as jckpt
from object_oriented_slam_tpu.system import slam_mode as jmode
from object_oriented_slam_tpu.system.state import SlamState as JSlamState
from object_oriented_slam_tpu_torch.backend import LMConfig
from object_oriented_slam_tpu_torch.backend import residuals as tres
from object_oriented_slam_tpu_torch.backend import slam_ba as tslam
from object_oriented_slam_tpu_torch.core import ellipsoid as tell
from object_oriented_slam_tpu_torch.core import se3 as tse3
from object_oriented_slam_tpu_torch.system import checkpoint as tckpt
from object_oriented_slam_tpu_torch.system import slam_mode as tmode

from oracle_slam import optimize_slam_np
from test_slam_oracle import F as ORACLE_F
from test_slam_oracle import K as ORACLE_K
from test_slam_oracle import _build_graph as oracle_graph

torch.set_num_threads(1)    # the test workers share the CPU

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 16


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _n(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x,
                      np.float64)


def _rand_pose(rng, n=N, t=1.0):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.concatenate([rng.normal(0, t, (n, 3)), q], 1).astype(np.float32)


def _rand_ell(rng, n=N):
    return np.concatenate([_rand_pose(rng, n), rng.uniform(
        0.1, 0.5, (n, 3))], 1).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_n(got), _n(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# core additions and residuals against JAX's eager functions
# ---------------------------------------------------------------------------

def test_se3_additions_match_jax():
    rng = np.random.default_rng(0)
    p, pts = _rand_pose(rng), rng.normal(size=(N, 3)).astype(np.float32)
    rpy = rng.uniform(-1.4, 1.4, (N, 3)).astype(np.float32)
    v6 = np.concatenate([pts, rpy], 1)
    vm = jax.vmap
    _close(tse3.se3_apply(_t(p), _t(pts)), vm(jse3.se3_apply)(p, pts), 1e-6)
    _close(tse3.se3_apply(_t(p[0]), _t(pts)), jse3.se3_apply(p[0], pts), 1e-6)
    mats = tse3.se3_to_mat(_t(p))
    _close(mats, vm(jse3.se3_to_mat)(p), 1e-6)
    _close(tse3.mat_to_se3(mats), vm(jse3.mat_to_se3)(np.asarray(mats)),
           1e-6)
    _close(tse3.pose7_to_xyzrpy(_t(p)), vm(jse3.pose7_to_xyzrpy)(p), 1e-6)
    _close(tse3.xyzrpy_to_pose7(_t(v6)), vm(jse3.xyzrpy_to_pose7)(v6), 1e-6)
    R = tse3.euler_zyx_to_rot(*_t(rpy).unbind(-1))
    _close(R, vm(jse3.euler_zyx_to_rot)(rpy[:, 0], rpy[:, 1], rpy[:, 2]),
           1e-6)
    _close(tse3.rot_to_euler_zyx(R), vm(jse3.rot_to_euler_zyx)(np.asarray(R)),
           1e-6)


def _yaw_pairs(rng):
    """(e, other): ``other`` is ``e`` perturbed, then turned by k quarter
    turns of yaw (scales swapped for odd k), k drawn per pair, so the least
    norm lands on every candidate."""
    e = _rand_ell(rng)
    other = e.copy()
    other[:, :3] += rng.normal(0, 0.02, (N, 3))
    other[:, 7:] += rng.normal(0, 0.01, (N, 3))
    ks = rng.integers(-1, 3, N)
    turned = np.stack([np.asarray(jell.rotate_yaw(o, int(k)))
                       for o, k in zip(other, ks)])
    return e, turned.astype(np.float32), ks


def test_ellipsoid_additions_match_jax():
    rng = np.random.default_rng(1)
    e, other, ks = _yaw_pairs(rng)
    vm = jax.vmap
    _close(tell.pose_of(_t(e)), e[:, :7], 0)
    _close(tell.scale_of(_t(e)), e[:, 7:], 0)
    _close(tell.log_error_9dof(_t(e), _t(other)),
           vm(jell.log_error_9dof)(e, other), 1e-6)
    for k in (-1, 0, 1, 2):
        _close(tell.rotate_yaw(_t(e), k),
               vm(lambda x: jell.rotate_yaw(x, k))(e), 1e-6)
    _close(tell.min_log_error_9dof(_t(e), _t(other)),
           vm(jell.min_log_error_9dof)(e, other), 1e-6)
    assert len(set(ks.tolist())) == 4


def test_residuals_match_jax():
    """The five residuals of backend/residuals.py; residual_3d with
    measurements turned so every yaw candidate is chosen somewhere."""
    rng = np.random.default_rng(2)
    vm = jax.vmap
    K = ORACLE_K.astype(np.float32)
    # projection: ellipsoids 2-4 m in front of cameras looking down +z
    e = _rand_ell(rng)
    e[:, :3] = rng.normal(0, 0.3, (N, 3)) + [0, 0, 3.0]
    pose = np.tile(np.array([0, 0, 0, 0, 0, 0, 1], np.float32), (N, 1))
    pose[:, :3] = rng.normal(0, 0.2, (N, 3))
    proj = np.asarray(vm(lambda a, b: jell.project_bbox(a, b, K))(e, pose))
    meas = (proj + rng.normal(0, 3.0, proj.shape)).astype(np.float32)
    meas[::3, 0] = -1.0                                 # border coordinates
    got = tres.residual_proj(_t(e), _t(pose), _t(K), _t(meas))
    want = vm(lambda a, b, m: jres.residual_proj(a, b, K, m))(e, pose, meas)
    valid = meas >= 5
    assert (_n(got)[~valid] == 0).all() and (_n(want)[~valid] == 0).all()
    np.testing.assert_allclose((_n(got) + meas)[valid],
                               (_n(want) + meas)[valid], rtol=1e-5)
    # 3D: the measured local ellipsoid through a camera pose
    e3, other, ks = _yaw_pairs(rng)
    pwc = _rand_pose(rng)
    local = np.stack([np.asarray(jell.transform_to(o, p))
                      for o, p in zip(other, pwc)]).astype(np.float32)
    _close(tres.residual_3d(_t(e3), _t(pwc), _t(local)),
           vm(jres.residual_3d)(e3, pwc, local), 1e-5)
    inv4, sc4 = tres.precompute_3d_measurement(_t(pwc), _t(local))
    j_inv4, j_sc4 = vm(jres.precompute_3d_measurement)(pwc, local)
    _close(inv4, j_inv4, 1e-5)
    _close(sc4, j_sc4, 1e-5)
    _close(tres.residual_3d_pre(_t(e3), inv4, sc4),
           vm(jres.residual_3d_pre)(e3, j_inv4, j_sc4), 1e-5)
    # the chosen candidates: JAX's argmin of the norms, every one taken
    errs = np.stack([np.asarray(vm(jell.log_error_9dof)(e3, vm(
        lambda o: jell.rotate_yaw(o, k))(np.asarray(vm(jell.transform_from)(
            local, pwc))))) for k in (-1, 0, 1, 2)], 1)
    assert set(np.argmin(np.linalg.norm(errs, axis=2), 1).tolist()) == \
        {0, 1, 2, 3}
    # gravity and odometry
    normal = np.array([0.05, -0.02, 1.0], np.float32)
    _close(tres.residual_gravity(_t(e3), _t(normal)),
           vm(lambda a: jres.residual_gravity(a, normal))(e3), 1e-5)
    pi, pj, m = _rand_pose(rng), _rand_pose(rng), _rand_pose(rng)
    _close(tres.residual_odometry(_t(pi), _t(pj), _t(m)),
           vm(jres.residual_odometry)(pi, pj, m), 1e-5)


# ---------------------------------------------------------------------------
# the orbit graph: edge terms, assembly, chi2, Schur solves
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def orbit():
    """(numpy arrays of the graph, K, normal), the port's graph, JAX's."""
    g, K, normal = _example("torch_slam_edges_on_cpu").orbit_graph()
    arrays = {k: getattr(g, k).numpy() for k in tslam.JAX_FIELDS}
    jg = jslam.SlamGraph(**{
        k: jnp.asarray(v.astype(np.int32) if k in tslam.INDEX_FIELDS else v)
        for k, v in arrays.items()})
    return arrays, K.numpy(), normal.numpy(), g, jg


@pytest.fixture(scope="module")
def jax_banded(orbit):
    arrays, K, normal, _, jg = orbit
    out = jax.jit(jslam.build_normal_equations_banded)(
        jg.poses_cw, jg.objects, jg, jnp.asarray(K), jnp.asarray(normal))
    return [np.asarray(x, np.float64) for x in out]


def test_edge_terms_match_jax_residuals(orbit):
    """The plain edge terms' r against JAX's residuals at the zero tangent
    times the weights; the non-finite 2D edge has its r and J zeroed."""
    arrays, K, normal, g, _ = orbit
    terms = tslam.edge_terms_plain(g.poses_cw, g.objects, g, _t(K),
                                   _t(normal))
    a = arrays
    z6, z9 = np.zeros(6, np.float32), np.zeros(9, np.float32)

    def cam(p):
        return jse3.se3_mul(jse3.se3_exp(z6), p)

    def obj(o):
        return jell.exp_update(o, z9)

    P, O = a["poses_cw"], a["objects"]
    f2, o2, f3, o3 = a["e2_frame"], a["e2_obj"], a["e3_frame"], a["e3_obj"]
    def jv(fn):
        return jax.jit(jax.vmap(fn))

    r2 = jv(lambda p, o, b: jres.residual_proj(obj(o), cam(p), K, b))(
        P[f2], O[o2], a["e2_bbox"]) * a["e2_w"][:, None]
    r3 = jv(lambda p, o, m: jres.residual_3d(
        obj(o), jse3.se3_inv(cam(p)), m))(P[f3], O[o3], a["e3_meas"]) \
        * a["e3_w"][:, None]
    ro = jv(lambda pi, pj, m: jslam._odo_residual(cam(pi), cam(pj), m))(
        P[a["odo_i"]], P[a["odo_j"]], a["odo_meas"]) * a["odo_w"][:, None]
    rg = jv(lambda o: jres.residual_gravity(obj(o), normal))(O) \
        * a["grav_w"][:, None]
    bad = ~np.isfinite(np.asarray(r2)).all(1)
    assert bad.tolist().count(True) == 1
    for t in terms[:3]:
        assert (_n(t)[bad] == 0).all()
    # the projected bbox, r / w + the measurement: rtol 1e-5, or 3 times the
    # f32 evaluation's own distance from its float64 evaluation where that
    # is larger (the conic's inverse loses digits on these views)
    meas = np.where(bad[:, None] | (a["e2_bbox"] < 5), 0.0, a["e2_bbox"])
    w = a["e2_w"][:, None]
    g64 = type(g)(*[t.double() if t.is_floating_point() else t for t in g])
    r64 = _n(tslam.edge_terms_plain(g64.poses_cw, g64.objects, g64,
                                    _t(K).double(), _t(normal).double())[0])
    got = _n(terms[0]) / w + meas
    want = np.where(bad[:, None], 0.0, r2) / w + meas
    own = np.abs(_n(terms[0]) - r64)[~bad].max() / w.min()
    assert (np.abs(got - want) <= np.maximum(1e-5 * np.abs(want),
                                             3 * own)).all()
    assert 0 < own < 0.05
    _close(terms[3], r3, 1e-5)
    _close(terms[6], ro, 1e-5)
    _close(terms[9], rg, 1e-5)
    for t in terms:
        assert np.isfinite(_n(t)).all()


def _f64(g, *tensors):
    g64 = type(g)(*[t.double() if t.is_floating_point() else t for t in g])
    return (g64, *[t.double() for t in tensors])


def _agree(got, want, ref64, tol, name=""):
    """max |got - want| within ``tol`` of max |want|, or within 3 times the
    port's own f32 error (its distance from ``ref64``, its float64
    evaluation) where that is larger: the projected-bbox chain loses
    digits on some views in f32, in either package."""
    got, want, ref64 = _n(got), np.asarray(want, np.float64), _n(ref64)
    err = np.abs(got - want).max()
    own = np.abs(got - ref64).max()
    assert err <= max(tol * np.abs(want).max(), 3 * own), (name, err, own)


@pytest.fixture(scope="module")
def port_banded(orbit):
    """The port's banded and dense assemblies, each in f32 and f64."""
    _, K, normal, g, _ = orbit
    g64, K64, n64 = _f64(g, _t(K), _t(normal))
    return {(fn.__name__, dt): fn(gg.poses_cw, gg.objects, gg, KK, nn)
            for fn in (tslam.build_normal_equations_banded,
                       tslam.build_normal_equations)
            for dt, gg, KK, nn in (("f32", g, _t(K), _t(normal)),
                                   ("f64", g64, K64, n64))}


def test_banded_assembly_matches_jax(port_banded, jax_banded):
    got = port_banded["build_normal_equations_banded", "f32"]
    ref = port_banded["build_normal_equations_banded", "f64"]
    for name, a, b, c in zip(("D", "B", "bp", "Hoo", "bo", "U"), got,
                             jax_banded, ref):
        assert a.shape == b.shape, name
        _agree(a, b, c, 1e-4, name)


def test_dense_assembly_matches_jax(port_banded, jax_banded):
    """The dense Hpp through its diagonal and (f, f+1) blocks
    (tests/test_slam_banded.py's comparison), zero elsewhere."""
    Hpp, bp, Hoo, bo, U = (_n(x) for x in port_banded[
        "build_normal_equations", "f32"])
    H64, bp64, Hoo64, bo64, U64 = (_n(x) for x in port_banded[
        "build_normal_equations", "f64"])
    D, B, bp_j, Hoo_j, bo_j, U_j = jax_banded
    F = bp.shape[0]

    def diag(H, k):
        return np.stack([H[f, :, f + k, :] for f in range(F - k)])

    _agree(diag(Hpp, 0), D, diag(H64, 0), 1e-4, "D")
    _agree(diag(Hpp, 1), B[:-1], diag(H64, 1), 1e-4, "B")
    lower = np.stack([Hpp[f + 1, :, f, :] for f in range(F - 1)])
    np.testing.assert_array_equal(lower, diag(Hpp, 1).transpose(0, 2, 1))
    far = np.abs(np.subtract.outer(np.arange(F), np.arange(F))) > 1
    assert np.abs(Hpp.transpose(0, 2, 1, 3)[far]).max() == 0
    for name, a, b, c in (("bp", bp, bp_j, bp64), ("Hoo", Hoo, Hoo_j, Hoo64),
                          ("bo", bo, bo_j, bo64), ("U", U, U_j, U64)):
        _agree(a, b, c, 1e-4, name)


def test_chi2_matches_jax(orbit):
    _, K, normal, g, jg = orbit
    want = float(jax.jit(jslam._chi2)(jg.poses_cw, jg.objects, jg,
                                      jnp.asarray(K), jnp.asarray(normal)))
    got = tslam._chi2(g.poses_cw, g.objects, g, _t(K), _t(normal))
    g64, K64, n64 = _f64(g, _t(K), _t(normal))
    _agree(got, want, tslam._chi2(g64.poses_cw, g64.objects, g64, K64, n64),
           1e-5, "chi2")


def test_schur_solves_match_jax(orbit, jax_banded):
    """Both port solves on JAX's banded equations against JAX's eager
    banded solve: frame 0 fixed, lambda 1e-4, 48 CG iterations."""
    arrays, _, _, _, _ = orbit
    D, B, bp, Hoo, bo, U = (np.asarray(x, np.float32) for x in jax_banded)
    F = bp.shape[0]
    free_f = arrays["frame_mask"] & (np.arange(F) > 0)
    free_o = arrays["obj_mask"]
    dxp_j, dxo_j, _ = jslam.solve_schur_step_banded(
        D, B, bp, Hoo, bo, U, jnp.float32(1e-4), free_f, free_o, 48)
    lam = torch.tensor(1e-4)
    args = (_t(bp), _t(Hoo), _t(bo), _t(U), lam, torch.tensor(free_f),
            torch.tensor(free_o), 48)
    dxp_b, dxo_b, _ = tslam.solve_schur_step_banded(_t(D), _t(B), *args)
    Hpp = np.zeros((F, 6, F, 6), np.float32)
    for f in range(F):
        Hpp[f, :, f, :] = D[f]
        if f + 1 < F:
            Hpp[f, :, f + 1, :] = B[f]
            Hpp[f + 1, :, f, :] = B[f].T
    dxp_d, dxo_d, _ = tslam.solve_schur_step(_t(Hpp), *args)
    for dxp, dxo in ((dxp_b, dxo_b), (dxp_d, dxo_d)):
        np.testing.assert_allclose(_n(dxp), np.asarray(dxp_j), atol=5e-4)
        np.testing.assert_allclose(_n(dxo), np.asarray(dxo_j), atol=5e-4)
    assert (_n(dxp_b)[0] == 0).all() and np.abs(_n(dxp_b)).max() > 1e-4


# ---------------------------------------------------------------------------
# the whole solver against the f64 oracle (tests/test_slam_oracle.py's setup)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def oracle_run():
    poses_cw, init_cw, init_obj, e2b, e3m, odo = oracle_graph()
    F, normal, grav_w, iters = ORACLE_F, np.array([0, 0, 1.0]), 0.5, 5
    edges = {
        "e2": [(f, 0, e2b[f], 1.0) for f in range(F)],
        "e3": [(f, 0, e3m[f], 1.0) for f in range(F)],
        "odo": [(i, i + 1, odo[i], 10.0) for i in range(F - 1)],
        "grav": [(0, normal, grav_w)],
    }
    poses_ref, objs_ref, trace = optimize_slam_np(
        init_cw, init_obj[None], edges, ORACLE_K, iters=iters)
    arrays = dict(
        poses_cw=init_cw, frame_mask=np.ones(F, bool), objects=init_obj[None],
        obj_mask=np.ones(1, bool), e2_frame=np.arange(F),
        e2_obj=np.zeros(F), e2_bbox=np.stack(e2b), e2_w=np.ones(F),
        e3_frame=np.arange(F), e3_obj=np.zeros(F), e3_meas=np.stack(e3m),
        e3_w=np.ones(F), odo_i=np.arange(F - 1), odo_j=np.arange(1, F),
        odo_meas=odo, odo_w=np.full(F - 1, 10.0), grav_w=np.full(1, grav_w))
    g = tslam.graph_from_numpy(arrays, device="cpu")
    K, n = _t(ORACLE_K), _t(normal)
    runs = {banded: tslam.optimize_slam(g, K, n, LMConfig(iters=iters),
                                        cg_iters=64, banded=banded)
            for banded in (True, False)}
    chi2_0 = float(tslam._chi2(g.poses_cw, g.objects, g, K, n))
    return g, poses_ref, objs_ref, trace, runs, chi2_0


@pytest.mark.parametrize("banded", [True, False])
def test_optimize_slam_matches_f64_oracle(oracle_run, banded):
    g, poses_ref, objs_ref, trace, runs, chi2_0 = oracle_run
    np.testing.assert_allclose(chi2_0, trace[0], rtol=1e-4)
    poses, objs, chi2 = (_n(x) for x in runs[banded])
    q_sign = np.sign(np.sum(poses[:, 3:] * poses_ref[:, 3:], axis=1))[:, None]
    np.testing.assert_allclose(poses[:, :3], poses_ref[:, :3], atol=5e-3)
    np.testing.assert_allclose(poses[:, 3:] * q_sign, poses_ref[:, 3:],
                               atol=5e-3)
    np.testing.assert_allclose(objs[0], objs_ref[0], atol=8e-3)
    np.testing.assert_allclose(float(chi2), trace[-1], rtol=0.2, atol=1e-3)


def test_banded_and_dense_agree_keep_the_gauge_and_descend(oracle_run):
    g, _, _, _, runs, chi2_0 = oracle_run
    (pb, ob, cb), (pd, od, cd) = runs[True], runs[False]
    np.testing.assert_allclose(_n(pb), _n(pd), atol=2e-3)
    np.testing.assert_allclose(_n(ob), _n(od), atol=2e-3)
    for poses, objs, chi2 in (runs[True], runs[False]):
        assert np.isfinite(_n(poses)).all() and np.isfinite(_n(objs)).all()
        np.testing.assert_allclose(_n(poses)[0], _n(g.poses_cw)[0], atol=1e-7)
        assert float(chi2) < chi2_0


# ---------------------------------------------------------------------------
# the packer
# ---------------------------------------------------------------------------

def _make_state(rng, n_frames=40, n_obj=6, obs2d=6, obs3d=3):
    """A smaller twin of tests/test_slam_tiers.py's _make_state: an orbit
    around a grid of ellipsoids, each object seen over its own window of
    frames (object 5 only twice in 2D: below the >2-observation gate).
    Returns the JAX package's SlamState."""
    K = np.array([[300.0, 0, 160], [0, 300, 120], [0, 0, 1]], np.float32)
    state = JSlamState()
    gt_wc = []
    for i in range(n_frames):
        ang = 2 * np.pi * i / n_frames
        t = np.array([4.0 * np.cos(ang), 4.0 * np.sin(ang), 1.2])
        z = -t / np.linalg.norm(t)
        x = np.cross([0, 0, 1.0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z], axis=1)
        q = np.asarray(jse3.mat_to_quat(jnp.asarray(R.astype(np.float32))))
        pose_wc = np.concatenate([t, q]).astype(np.float64)
        noisy = pose_wc.copy()
        noisy[:3] += rng.normal(0, 0.02, 3)
        gt_wc.append(pose_wc)
        state.frames_pose_wc.append(noisy)
        state.frames_ts.append(float(i))
    for k in range(n_obj):
        gt = np.array([0.35 * (k % 3 - 1), 0.35 * (k // 3), 0.2, 0, 0, 0, 1,
                       0.12, 0.10, 0.08], np.float32)
        rec = state.record(k)
        rec.initialized = True
        rec.vec10 = gt.astype(np.float64) + np.concatenate(
            [rng.normal(0, 0.03, 3), np.zeros(4), rng.normal(0, 0.01, 3)])
        f0 = (k * 7) % (n_frames - 20)
        for j in range(2 if k == 5 else obs2d):
            fb = f0 + 3 * j
            p_cw = np.asarray(jse3.se3_inv(jnp.asarray(
                gt_wc[fb].astype(np.float32))))
            rec.obs2d_frame.append(fb)
            rec.obs2d_bbox.append(np.asarray(jell.project_bbox(
                jnp.asarray(gt), jnp.asarray(p_cw), jnp.asarray(K)),
                np.float64))
            rec.obs2d_pose_cw.append(p_cw.astype(np.float64))
            rec.obs2d_pose_wc.append(gt_wc[fb])
            rec.obs2d_prob.append(0.9)
        for j in range(obs3d):
            fb = f0 + 5 * j
            p_wc = gt_wc[fb].astype(np.float32)
            rec.obs3d_frame.append(fb)
            rec.obs3d_meas.append(np.asarray(jell.transform_to(
                jnp.asarray(gt), jnp.asarray(p_wc)), np.float64))
            rec.obs3d_pose_wc.append(p_wc.astype(np.float64))
            rec.obs3d_prob.append(0.8)
    state.ground_plane = np.array([0.0, 0.0, 1.0, 0.0])
    return state, np.stack(gt_wc)


def test_build_slam_graph_matches_jax(tmp_path, caplog):
    """One SlamState crossing through the checkpoint (JAX's save_state, the
    port's load_state): every packed array equal, the tiers, the odometry
    of a separate trajectory, gravity off, and the explicit caps with the
    same warnings."""
    rng = np.random.default_rng(5)
    jstate, gt_wc = _make_state(rng)
    path = str(tmp_path / "state.npz")
    jckpt.save_state(jstate, path)
    tstate = tckpt.load_state(path)
    odo = gt_wc + np.concatenate([rng.normal(0, 0.01, (len(gt_wc), 3)),
                                  np.zeros((len(gt_wc), 4))], 1)
    cases = [dict(), dict(odometry_wc=odo, odo_weight=2.0),
             dict(gravity_on=False),
             dict(max_frames=32, max_objects=4, max_e2=8, max_e3=4)]
    for kw in cases:
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            jg, jinsts = jmode.build_slam_graph(jstate, JLMConfig(), **kw)
            tg, tinsts = tmode.build_slam_graph(tstate, LMConfig(),
                                                device="cpu", **kw)
        assert tinsts == jinsts
        for name in tslam.JAX_FIELDS:
            a, b = getattr(tg, name).numpy(), np.asarray(getattr(jg, name))
            assert a.shape == b.shape and np.array_equal(a, b), (kw, name)
        msgs = {}
        for r in caplog.records:
            msgs.setdefault(r.name.endswith("_torch"), []).append(
                r.getMessage())
        assert msgs.get(True, []) == msgs.get(False, []), kw
        if "max_frames" in kw:
            assert len(msgs[True]) == 4
    # the tiers: 40 frames -> 64, 6 objects -> 16, 32 2D edges -> 256,
    # 18 3D edges -> 128; object 5 is below the gate
    assert tuple(tg.poses_cw.shape) == (32, 7)
    assert int((jg.e2_w != 0).sum()) == 8
    tg, _ = tmode.build_slam_graph(tstate, LMConfig(), device="cpu")
    assert [tg.poses_cw.shape[0], tg.objects.shape[0], tg.e2_w.shape[0],
            tg.e3_w.shape[0]] == [64, 16, 256, 128]
    assert int((tg.e2_w != 0).sum()) == 5 * 6
    # a JAX graph's arrays through graph_from_numpy give the same graph
    again = tslam.graph_from_numpy(
        {k: np.asarray(v) for k, v in jg._asdict().items()}, device="cpu")
    for a, b in zip(again, tmode.build_slam_graph(
            tstate, LMConfig(), device="cpu", max_frames=32, max_objects=4,
            max_e2=8, max_e3=4)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# the command line on noisy odometry
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def odometry_run(tmp_path_factory):
    """tests/test_torch_run_tum.py's export (its scene, frames and odometry
    noise 0.01 m a frame) run by the port's CLI with ``--odometry
    SEQ/odometry.txt --slam-mode`` on its first SPLIT frames, with that
    file's settings (here, not there: that file is tier-1's longest)."""
    import test_torch_run_tum as rt
    from object_oriented_slam_tpu_torch.io import synthetic as tsyn
    tmp = tmp_path_factory.mktemp("slam_cli")
    seq, out = str(tmp / "seq"), str(tmp / "out")
    scene = tsyn.make_scene(**rt.SCENE_KW)
    rt._example("torch_make_synthetic_tum").export_synthetic_tum(
        seq, scene, tsyn.SyntheticDataset(scene, **rt.DATA_KW),
        odometry_noise=0.01)
    slam, log = rt._port_cli([rt.YAML, seq, "--out", out, "--device", "cpu",
                              "--max-frames", str(rt.SPLIT), "--extractor",
                              "mono", "--odometry",
                              os.path.join(seq, "odometry.txt"),
                              "--slam-mode"])
    return seq, out, slam, log, rt.SPLIT


def test_slam_mode_refines_noisy_odometry(odometry_run):
    """``--odometry SEQ/odometry.txt --slam-mode`` on the first SPLIT
    frames: finite outputs, frame 0 unchanged, and the chi2 of the packed
    graph at the refined poses and objects below its chi2 at the input.
    The message records the ATE of the input and of the refined
    trajectory against the ground truth."""
    from object_oriented_slam_tpu_torch.io.writers import load_objects
    from object_oriented_slam_tpu_torch.system.metrics import ate_rmse
    from object_oriented_slam_tpu_torch.system.tracking import _np_se3_inv

    seq, d, slam, log, split = odometry_run
    assert f"SLAM mode: refined {split} poses" in log
    traj = np.loadtxt(os.path.join(d, "trajectory_refined.txt"),
                      ndmin=2)[:, 1:]
    slam_objs = dict(zip(*load_objects(os.path.join(d, "objects_slam.txt"))))
    mapped = dict(zip(*load_objects(os.path.join(d, "objects.txt"))))
    assert traj.shape == (split, 7) and np.isfinite(traj).all()
    assert sorted(slam_objs) == sorted(mapped) and len(mapped) >= 3
    assert all(np.isfinite(v).all() for v in slam_objs.values())
    state = slam.tracker.state
    g, insts = tmode.build_slam_graph(state, LMConfig(), device="cpu")
    K = _t(slam.tracker.K)
    n = _t(state.ground_plane[:3])
    poses = g.poses_cw.clone()
    poses[:split] = _t(np.stack([_np_se3_inv(p) for p in traj]))
    objects = g.objects.clone()
    for k, inst in enumerate(insts):
        objects[k] = _t(slam_objs[inst])
    # frame 0 is fixed: the refined row 0 is the packed frame 0 under the
    # solve's zero update (exp(0) * Tcw renormalizes its quaternion), to the
    # file's 9 decimals
    p0 = tse3.se3_mul(tse3.se3_exp(torch.zeros(6)), g.poses_cw[0])
    np.testing.assert_allclose(traj[0], _np_se3_inv(_n(p0)), rtol=0,
                               atol=1e-8)
    chi2_0 = float(tslam._chi2(g.poses_cw, g.objects, g, K, n))
    chi2_1 = float(tslam._chi2(poses, objects, g, K, n))
    gt = np.loadtxt(os.path.join(seq, "groundtruth.txt"), ndmin=2)[:split, 1:4]
    inp = np.stack(state.frames_pose_wc)[:, :3]
    ate = (ate_rmse(inp, gt), ate_rmse(traj[:, :3], gt))
    assert chi2_1 < chi2_0, (chi2_0, chi2_1, ate)
    print(f"SLAM mode on {split} frames of noisy odometry: chi2 {chi2_0:.6g} "
          f"-> {chi2_1:.6g}; ATE (aligned) of the input "
          f"{ate[0] * 100:.3f} cm, of the refined trajectory "
          f"{ate[1] * 100:.3f} cm")


# ---------------------------------------------------------------------------
# K11's chains built for the CPU
# ---------------------------------------------------------------------------

def test_k11_chains_on_the_host_match_the_plain_version(tmp_path):
    """csrc/slam_edges.cu's device functions built with g++
    (examples/torch_slam_edges_on_cpu.py) on the orbit graph: every output
    within 4 times the plain version's own distance from its float64
    evaluation (or 1e-4 of the output's largest entry), the non-finite
    entries alike, chi2 within 1e-5."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build K11's chains for the CPU")
    ex = _example("torch_slam_edges_on_cpu")
    g, K, normal = ex.orbit_graph()
    lines, ok = ex.compare(ex.build(workdir=str(tmp_path)), g, K, normal)
    assert ok, "\n".join(lines)


def test_k11_operation_count_counts_live_edges_once(tmp_path):
    """examples/torch_slam_edges_on_cpu.count_ops, the operations K11's
    bound in chip_smoke.py is made of: a zero-weight edge counts nothing,
    and an edge's Jacobian counts its primal chain once, so it costs less
    than the kernel's three Dual<5> threads and more than one."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build K11's chains for the CPU")
    ex = _example("torch_slam_edges_on_cpu")
    g, K, normal = ex.orbit_graph()
    full = ex.count_ops(g, K, normal, str(tmp_path))
    assert full["live"] == {k: int((w != 0).sum()) for k, w in zip(
        ("e2", "e3", "odo", "grav"), (g.e2_w, g.e3_w, g.odo_w, g.grav_w))}
    w = g.e3_w.clone()
    w[0] = 0.0
    fewer = ex.count_ops(g._replace(e3_w=w), K, normal, str(tmp_path))
    assert fewer["live"]["e3"] == full["live"]["e3"] - 1
    assert fewer["slam_edge_terms"]["e3"] < full["slam_edge_terms"]["e3"]
    assert fewer["slam_chi2"]["e3"] < full["slam_chi2"]["e3"]
    for k in ("e2", "odo", "grav"):
        assert fewer["slam_edge_terms"][k] == full["slam_edge_terms"][k]
    lib = ex.build(count=True, workdir=str(tmp_path), lanes=5)
    keep, (E2, E3, Eo, Ko, _), args = ex._graph_args(g, K, normal)
    n = E2 + E3 + Eo + Ko
    ops = (ex.ctypes.c_longlong * (4 * n))()
    lib.host_count(*args, ops)
    live = (g.e2_w != 0).numpy()
    thread = np.array(ops[:E2], np.float64)[live].sum()
    assert thread < full["slam_edge_terms"]["e2"] < 3 * thread
