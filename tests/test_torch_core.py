"""Port parity: core/se3, core/ellipsoid and ops/linalg against the JAX
package on the same seeded inputs.

Tolerance: rtol 1e-5 (f32 round-off of the same formulas evaluated by
XLA:CPU and PyTorch), with an absolute floor of 1e-5 for components that
are zero in exact arithmetic.  Projected ellipses and bboxes go through an
ill-conditioned conic inverse (coordinates in pixels): rtol 1e-5 on top of
an absolute 2e-3 px.  The 9x9 Cholesky solve amplifies round-off by the
system's condition number (~1e3 here): rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_oriented_slam_tpu.core import ellipsoid as jell
from object_oriented_slam_tpu.core import se3 as jse3
from object_oriented_slam_tpu.ops import linalg as jlinalg
from object_oriented_slam_tpu_torch.core import ellipsoid as tell
from object_oriented_slam_tpu_torch.core import se3 as tse3
from object_oriented_slam_tpu_torch.ops import linalg as tlinalg

torch.set_num_threads(1)    # the test workers share the CPU

N = 16
RTOL, ATOL = 1e-5, 1e-5
K = np.array([[535.4, 0, 320.1], [0, 539.2, 247.6], [0, 0, 1]], np.float32)


def _rng(seed):
    return np.random.default_rng(seed)


def rand_quat(rng, n=N):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def rand_pose(rng, n=N):
    return np.concatenate([rng.normal(size=(n, 3)), rand_quat(rng, n)],
                          axis=1).astype(np.float32)


def rand_ellipsoid(rng, n=N):
    """Random vec10 (test_ellipsoid.rand_ellipsoid's distribution)."""
    v9 = np.concatenate([rng.normal(size=(n, 3)),
                         rng.uniform(-1.0, 1.0, size=(n, 3)),
                         rng.uniform(0.2, 1.5, size=(n, 3))],
                        axis=1).astype(np.float32)
    return np.array(jax.vmap(jell.from_minimal)(jnp.asarray(v9))), v9


def _jax(fn, *args):
    return np.asarray(jax.vmap(fn)(*[jnp.asarray(a) for a in args]))


def _torch(fn, *args):
    return fn(*[torch.tensor(a) for a in args]).numpy()


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["quat_mul", "quat_rotate", "quat_to_mat",
                                  "se3_mul", "se3_inv", "se3_log",
                                  "so3_log", "quat_to_euler_zyx"])
def test_se3_matches_jax(name):
    rng = _rng(0)
    args = {
        "quat_mul": (rand_quat(rng), rand_quat(rng)),
        "quat_rotate": (rand_quat(rng),
                        rng.normal(size=(N, 3)).astype(np.float32)),
        "quat_to_mat": (rand_quat(rng),),
        "se3_mul": (rand_pose(rng), rand_pose(rng)),
        "se3_inv": (rand_pose(rng),),
        "se3_log": (rand_pose(rng),),
        "so3_log": (rand_quat(rng),),
        "quat_to_euler_zyx": (rand_quat(rng),),
    }[name]
    _close(_torch(getattr(tse3, name), *args),
           _jax(getattr(jse3, name), *args))


@pytest.mark.parametrize("scale", [1e-4, 0.1, 1.0])
def test_se3_exp_matches_jax(scale):
    """test_se3.test_se3_exp_log_roundtrip's tangent scales, including the
    small-angle branch."""
    u = (_rng(1).normal(size=(N, 6)) * scale).astype(np.float32)
    _close(_torch(tse3.se3_exp, u), _jax(jse3.se3_exp, u))
    _close(_torch(tse3.so3_exp_quat, u[:, :3]),
           _jax(jse3.so3_exp_quat, u[:, :3]))


def test_euler_to_quat_matches_jax():
    rpy = _rng(2).uniform(-1.2, 1.2, size=(N, 3)).astype(np.float32)
    got = tse3.zyx_euler_to_quat(*torch.as_tensor(rpy).unbind(-1)).numpy()
    want = np.asarray(jax.vmap(jse3.zyx_euler_to_quat)(
        *[jnp.asarray(rpy[:, i]) for i in range(3)]))
    _close(got, want)


@pytest.mark.parametrize("name", ["exp_update", "transform_from",
                                  "transform_to", "to_minimal"])
def test_ellipsoid_update_and_transforms(name):
    rng = _rng(3)
    e, _ = rand_ellipsoid(rng)
    args = {
        "exp_update": (e, (rng.normal(size=(N, 9)) * 0.2).astype(np.float32)),
        "transform_from": (e, rand_pose(rng)),
        "transform_to": (e, rand_pose(rng)),
        "to_minimal": (e,),
    }[name]
    _close(_torch(getattr(tell, name), *args),
           _jax(getattr(jell, name), *args))


def _in_front(rng):
    e, _ = rand_ellipsoid(rng)
    e[:, 2] += 6.0                         # test_ellipsoid's "push in front"
    pose_cw = np.tile(np.asarray(jse3.se3_identity()), (N, 1))
    pose_cw[:, :3] += rng.normal(0, 0.3, (N, 3)).astype(np.float32)
    return e, pose_cw


def test_project_ellipse_matches_jax():
    e, pose_cw = _in_front(_rng(4))
    got = tell.project_ellipse(torch.as_tensor(e), torch.as_tensor(pose_cw),
                               torch.as_tensor(K)).numpy()
    want = np.asarray(jax.vmap(jell.project_ellipse, (0, 0, None))(
        jnp.asarray(e), jnp.asarray(pose_cw), jnp.asarray(K)))
    _close(got[:, :2], want[:, :2], atol=2e-3)        # centre, px
    _close(got[:, 3:], want[:, 3:], atol=2e-3)        # axes, px
    # the ellipse angle is defined mod pi and ill-conditioned for circles
    d = np.angle(np.exp(2j * (got[:, 2] - want[:, 2]))) / 2
    assert np.all(np.abs(d) < 1e-3), d


def test_project_bbox_matches_jax():
    e, pose_cw = _in_front(_rng(5))
    got = tell.project_bbox(torch.as_tensor(e), torch.as_tensor(pose_cw),
                            torch.as_tensor(K)).numpy()
    want = np.asarray(jax.vmap(jell.project_bbox, (0, 0, None))(
        jnp.asarray(e), jnp.asarray(pose_cw), jnp.asarray(K)))
    _close(got, want, atol=2e-3)
    ell5 = np.asarray(jax.vmap(jell.project_ellipse, (0, 0, None))(
        jnp.asarray(e), jnp.asarray(pose_cw), jnp.asarray(K)))
    _close(tell.ellipse_to_bbox(torch.tensor(ell5)).numpy(),
           np.asarray(jax.vmap(jell.ellipse_to_bbox)(jnp.asarray(ell5))),
           atol=1e-4)


def test_project_sphere_center():
    """test_ellipsoid.test_project_sphere_center on the port."""
    Ks = torch.tensor([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]])
    z, r = 4.0, 0.5
    e = torch.tensor([0, 0, z, 0, 0, 0, 1, r, r, r])
    ellipse = tell.project_ellipse(e, tse3.se3_identity(), Ks).numpy()
    expected_r = 500.0 * r / np.sqrt(z * z - r * r)
    assert np.allclose(ellipse[:2], [320, 240], atol=1e-2)
    assert np.allclose(ellipse[3:], expected_r, rtol=1e-3)


def test_inv3_matches_jax():
    m = _rng(6).normal(size=(N, 3, 3)).astype(np.float32)
    m[0] = 0.0                                   # det == 0 branch
    got = tlinalg.inv3(torch.as_tensor(m)).numpy()
    want = np.asarray(jlinalg.inv3(jnp.asarray(m)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    _close(got[1:], want[1:])


def test_chol_solve_small_matches_jax():
    """SPD 9x9 systems (H + lambda I) plus the degenerate cases the LM's
    du_ok gate sees: a NaN entry and an inf entry must give the same
    non-finite pattern as the JAX solve."""
    rng = _rng(7)
    J = rng.normal(size=(N, 20, 9)).astype(np.float32)
    A = np.einsum("nri,nrj->nij", J, J) + 1e-3 * np.eye(9, dtype=np.float32)
    b = rng.normal(size=(N, 9)).astype(np.float32)
    A[1, 4, 4] = np.nan
    A[2, 0, 3] = A[2, 3, 0] = np.inf
    got = tlinalg.chol_solve_small(torch.as_tensor(A), torch.as_tensor(b))
    want = np.asarray(jlinalg.chol_solve_small(jnp.asarray(A),
                                               jnp.asarray(b)))
    got = got.numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    ok = np.isfinite(want).all(axis=1)
    _close(got[ok], want[ok], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["exp_update_xyzabc", "quadric_Qstar",
                                  "projection_matrix", "project_center",
                                  "project_bbox_dual", "cube_corners",
                                  "project_cube_bbox",
                                  "project_cube_bbox_cwh", "is_observable"])
def test_ellipsoid_completion_matches_jax(name):
    """The functions of core/ellipsoid added to complete the module, on
    test_ellipsoid.py's inputs (ellipsoids pushed in front of cameras near
    the identity); projected pixels within 2e-3 px + rtol 1e-5."""
    rng = _rng(7)
    e, pose_cw = _in_front(rng)
    Kn = np.tile(K, (N, 1, 1))
    args = {
        "exp_update_xyzabc": (e, (rng.normal(size=(N, 6)) * 0.2)
                              .astype(np.float32)),
        "quadric_Qstar": (e,),
        "projection_matrix": (pose_cw, Kn),
        "project_center": (e, pose_cw, Kn),
        "project_bbox_dual": (e, pose_cw, Kn),
        "cube_corners": (e,),
        "project_cube_bbox": (e, pose_cw, Kn),
        "project_cube_bbox_cwh": (e, pose_cw, Kn),
        "is_observable": (e, pose_cw),
    }[name]
    got = _torch(getattr(tell, name), *args)
    want = _jax(getattr(jell, name), *args)
    if name == "is_observable":
        np.testing.assert_array_equal(got, want)
        behind = e.copy()
        behind[:, 2] -= 12.0
        np.testing.assert_array_equal(
            _torch(tell.is_observable, behind, pose_cw),
            _jax(jell.is_observable, behind, pose_cw))
        assert got.all() and not _torch(tell.is_observable, behind,
                                        pose_cw).any()
        return
    pixels = name.startswith("project")
    _close(got, want, atol=2e-3 if pixels else ATOL)


def test_calibrate_measurement_matches_jax():
    """utils.measurement.calibrate_measurement (batch dims (..., 4))
    against JAX's, and row by row against the host version."""
    from object_oriented_slam_tpu.utils import (
        calibrate_measurement as j_cal)
    from object_oriented_slam_tpu_torch.utils import (
        calibrate_measurement, calibrate_measurement_np)
    rng = _rng(8)
    m = rng.uniform(-5, 660, (3, 16, 4)).astype(np.float32)
    m[..., 2:] = m[..., :2] + rng.uniform(-5, 300, (3, 16, 2))
    cal, border = calibrate_measurement(torch.as_tensor(m), 480, 640, 10, 20)
    jcal, jborder = j_cal(jnp.asarray(m), 480, 640, 10, 20)
    np.testing.assert_array_equal(cal.numpy(), np.asarray(jcal))
    np.testing.assert_array_equal(border.numpy(), np.asarray(jborder))
    for row, c, b in zip(m.reshape(-1, 4), cal.numpy().reshape(-1, 4),
                         border.numpy().reshape(-1)):
        want_c, want_b = calibrate_measurement_np(row, 480, 640, 10, 20)
        np.testing.assert_array_equal(c, want_c.astype(np.float32))
        assert b == want_b
