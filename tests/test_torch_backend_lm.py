"""Port parity: backend/lm.optimize_objects (the array-of-structs LM) on
the CPU against the JAX package's ``optimize_objects``, over the cases of
tests/test_backend_lm.py at 3 iterations and 4 object slots, the same
numpy observations handed to both; and each place where the AoS semantics
differ from ``lm_soa`` held on its own.

Tolerance: estimates within 1e-4, chi2 rtol 1e-4 with an absolute floor
of 2e-4: the same formulas in the same order, f32 round-off of two
libraries' kernels through 3 damped 9x9 solves; at convergence a residual
is a few thousandths of a pixel, the difference of two f32 coordinates
near 300 px (ulp 3e-5), so chi2 keeps only that absolute floor.  JAX runs
``optimize_objects_jit``: the cases share three configurations (gravity
only acts with a ground plane set), three compiles.  The CUDA path (K1-K4) is held against this
CPU twin by the ``cuda`` case of tests/test_torch_ba_kernels.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_oriented_slam_tpu.backend import LMConfig as JLMConfig
from object_oriented_slam_tpu.backend.lm import optimize_objects_jit as j_opt
from object_oriented_slam_tpu.core import ellipsoid as jell
from object_oriented_slam_tpu.core import se3 as jse3
from object_oriented_slam_tpu_torch.backend import (LMConfig, lm,
                                                    observations_from_numpy,
                                                    optimize_objects)

from test_backend_lm import M2, M3, O, empty_obs, orbit_poses
from test_svd_init import K

torch.set_num_threads(1)    # the test workers share the CPU

ITERS = 3


def _np(obs):
    return {k: np.array(v) for k, v in obs._asdict().items()}


def _cw(poses_wc):
    return np.stack([np.asarray(jse3.se3_inv(jnp.asarray(p)))
                     for p in poses_wc])


def _bboxes(gt, poses_wc):
    return np.stack([np.asarray(jell.project_bbox(
        jnp.asarray(gt), jse3.se3_inv(jnp.asarray(p)), jnp.asarray(K)))
        for p in poses_wc])


def _base(est0_row, o=0):
    est0 = np.tile(np.array([0, 0, 0, 0, 0, 0, 1, 1, 1, 1], np.float32),
                   (O, 1))
    est0[o] = est0_row
    mask = np.zeros(O, bool)
    mask[o] = True
    return _np(empty_obs(est0, mask))


def _with_2d(a, gt, n, o=0):
    poses = orbit_poses(gt[:3], n)
    a["pose2d_cw"][o, :n] = _cw(poses)
    a["bbox2d"][o, :n] = _bboxes(gt, poses)
    a["prob2d"][o, :n] = 1.0
    a["mask2d"][o, :n] = True
    return a


def case_2d():
    rng = np.random.default_rng(4)
    gt = np.array([0.2, -0.1, 0.4, 0, 0, 0, 1, 0.5, 0.3, 0.25], np.float32)
    e0 = gt + np.r_[rng.normal(0, 0.1, 3), np.zeros(4),
                    rng.normal(0, 0.05, 3)].astype(np.float32)
    e0[3:7] = [0, 0, 0, 1]
    return _with_2d(_base(e0), gt, 20), {}, None


def case_3d():
    gt = np.array([0.5, 0.3, 0.4, 0, 0, 0, 1, 0.4, 0.3, 0.5], np.float32)
    e0 = gt.copy()
    e0[:3] += [0.2, -0.15, 0.1]
    a = _base(e0)
    n = 10
    poses = orbit_poses(gt[:3], n)
    a["pose3d_wc"][0, :n] = poses
    a["meas3d"][0, :n] = np.stack([np.asarray(jell.transform_to(
        jnp.asarray(gt), jnp.asarray(p))) for p in poses])
    a["prob3d"][0, :n] = 1.0
    a["mask3d"][0, :n] = True
    return a, {}, None


def case_gravity():
    e0 = np.asarray(jell.from_minimal(jnp.asarray(
        np.r_[[0, 0, 0.5], [0.35, 0, 0], [0.4, 0.3, 0.2]].astype(
            np.float32))))
    a = _base(e0)
    a["meas3d"][0, 0] = e0
    a["prob3d"][0, 0] = 1e-6
    a["mask3d"][0, 0] = True
    return a, {}, np.array([0, 0, 1], np.float32)


def case_n2d_gate():
    gt = np.array([0.2, -0.1, 0.4, 0, 0, 0, 1, 0.5, 0.3, 0.25], np.float32)
    e0 = gt + np.r_[0.3, np.zeros(9)].astype(np.float32)
    return _with_2d(_base(e0), gt, 2), {}, None


def case_visibility():
    gt = np.array([0.2, -0.1, 0.4, 0, 0, 0, 1, 0.5, 0.3, 0.25], np.float32)
    e0 = gt.copy()
    e0[0] += 0.2
    a = _base(e0)
    a["est0"][:] = e0
    nb = 5
    a["pose2d_cw"][0, :nb] = [0, 0, -3, 0, 0, 0, 1]    # object behind it
    a["bbox2d"][0, :nb] = [300.0, 220, 340, 260]
    a["prob2d"][0, :nb] = 1.0
    a["mask2d"][0, :nb] = True
    return a, dict(check_visibility=True), None


def case_huber():
    a, cfg, normal = case_2d()
    a["bbox2d"][0, 3] += [40.0, -25.0, 30.0, 20.0]      # one gross outlier
    return a, dict(cfg, huber_delta=5.0), normal


CASES = {"2d": case_2d, "3d": case_3d, "gravity": case_gravity,
         "n2d_gate": case_n2d_gate, "visibility": case_visibility,
         "huber": case_huber}


def _run_port(arrays, cfg, normal, gset):
    obs = observations_from_numpy(arrays, device="cpu")
    est, chi2 = optimize_objects(obs, torch.as_tensor(K),
                                 torch.as_tensor(normal), gset,
                                 LMConfig(**cfg, iters=ITERS))
    return est.numpy(), chi2.numpy()


def _run_jax(arrays, cfg, normal, gset):
    from object_oriented_slam_tpu.backend import ObjectObservations
    obs = ObjectObservations(**{k: jnp.asarray(v) for k, v in arrays.items()})
    est, chi2 = j_opt(obs, jnp.asarray(K), jnp.asarray(normal), gset,
                      JLMConfig(**cfg, iters=ITERS))
    return np.asarray(est), np.asarray(chi2)


@pytest.fixture(scope="module")
def results():
    """Each case through the port and JAX once (shared by the tests); the
    default LMConfig is test_backend_lm's (gravity_scale 100, scale_3d
    1e4), the gravity prior on only where a ground plane is set."""
    out = {}
    for name, make in CASES.items():
        arrays, cfg, normal = make()
        gset = normal is not None
        normal = np.zeros(3, np.float32) if normal is None else normal
        out[name] = (arrays, _run_port(arrays, cfg, normal, gset),
                     _run_jax(arrays, cfg, normal, gset))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_aos_matches_jax(results, name):
    _, (est, chi2), (want_est, want_chi2) = results[name]
    np.testing.assert_allclose(est, want_est, atol=1e-4)
    np.testing.assert_allclose(chi2, want_chi2, rtol=1e-4, atol=2e-4)


def test_gates_keep_est0(results):
    """The n2d gate (2 views < 3) and the visibility gate leave no edge:
    the has_edges gate returns est0 bit for bit; unused slots too."""
    for name in ("n2d_gate", "visibility"):
        arrays, (est, _), _ = results[name]
        np.testing.assert_array_equal(est, arrays["est0"])
    arrays, (est, _), _ = results["2d"]
    np.testing.assert_array_equal(est[1:], arrays["est0"][1:])


def test_huber_downweights_the_outlier(results):
    """With one gross outlier, Huber's estimate lands nearer the clean
    run's than the plain least-squares one does."""
    _, (clean, _), _ = results["2d"]
    arrays, (huber, _), _ = results["huber"]
    plain, _ = _run_port(arrays, {}, np.zeros(3, np.float32), False)
    assert (np.abs(huber[0] - clean[0]).max()
            < np.abs(plain[0] - clean[0]).max())


def test_nonfinite_residual_rows_count_zero():
    """An edge whose measurement is infinite fails the NaN gate at est0;
    its rows are non-finite (inf * 0) and count as 0: the run equals the
    run without the edge, on the port and in JAX."""
    arrays, cfg, normal = case_2d()
    bad = {k: v.copy() for k, v in arrays.items()}
    bad["bbox2d"][0, 20] = [np.inf, 100.0, 200.0, 300.0]
    bad["prob2d"][0, 20] = 1.0
    bad["mask2d"][0, 20] = True
    est_b, chi_b = _run_port(bad, cfg, np.zeros(3, np.float32), False)
    est_a, chi_a = _run_port(arrays, cfg, np.zeros(3, np.float32), False)
    np.testing.assert_array_equal(est_b, est_a)
    np.testing.assert_array_equal(chi_b, chi_a)
    want, _ = _run_jax(bad, cfg, np.zeros(3, np.float32), False)
    np.testing.assert_allclose(est_b, want, atol=1e-4)


def test_whole_vector_du_gate():
    """One non-finite entry of H makes the object's whole du non-finite:
    the step is zeroed and the trial estimate is est itself."""
    e = torch.tensor([[0.1, 0.2, 0.3, 0, 0, 0, 1, 0.5, 0.4, 0.3]] * 2)
    H = torch.eye(9).expand(2, 9, 9).clone()
    H[1, 4, 4] = float("nan")
    g = torch.ones(2, 9)
    e_new, du, _ = lm._solve_step(e, torch.full((2,), -1.0), H, g)
    assert torch.isfinite(du[0]).all() and (du[0] != 0).all()
    assert (du[1] == 0).all()
    torch.testing.assert_close(e_new[1], e[1], rtol=0, atol=1e-7)


def test_nonfinite_tangent_edge_is_dropped():
    """A camera inside the object: its edge's residual is finite (it passes
    the NaN gate) and its tangent is not.  The port leaves that edge out of
    H and g (the kernels' rule, ``lm_soa._drop_nonfinite_edges``): they
    equal those of the input
    with the edge masked out, and the step is finite.  JAX's AoS instead
    gets a non-finite H, and its du gate freezes the whole object (a
    deliberate difference, ROADMAP queue 3)."""
    arrays, cfg, _ = case_2d()
    bad = {k: v.copy() for k, v in arrays.items()}
    m = 20
    bad["pose2d_cw"][0, m] = (*(-arrays["est0"][0, :3]), 0, 0, 0, 1)
    bad["bbox2d"][0, m] = (200.0, 150.0, 400.0, 350.0)
    bad["prob2d"][0, m] = 1.0
    bad["mask2d"][0, m] = True
    masked = {k: v.copy() for k, v in bad.items()}
    masked["mask2d"][0, m] = False
    Kt, zero = torch.as_tensor(K), torch.zeros(3)

    def normal_eq(a):
        obs = observations_from_numpy(a, device="cpu")
        w2d, w3d, wg = lm._edge_weights(obs, Kt, False, LMConfig())
        r_of = lm._plain_problem(obs, Kt, zero, w2d, w3d, wg, LMConfig())
        return w2d, lm._normal_eq_plain(r_of, obs.est0, M2, M3)

    w2d, (H, g) = normal_eq(bad)
    assert float(w2d[0, m]) > 0                     # passes the NaN gate
    _, (H_m, g_m) = normal_eq(masked)
    torch.testing.assert_close(H, H_m, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(g, g_m, rtol=1e-6, atol=1e-6)
    _, du, _ = lm._solve_step(torch.as_tensor(bad["est0"]),
                              torch.full((O,), -1.0), H, g)
    assert torch.isfinite(du).all() and bool((du[0] != 0).any())
    want, _ = _run_jax(bad, cfg, np.zeros(3, np.float32), False)
    np.testing.assert_array_equal(want[0], bad["est0"][0])
