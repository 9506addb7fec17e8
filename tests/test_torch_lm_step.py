"""The two steps of one LM iteration (backend/lm_soa.lm_solve_step and
lm_accept_step): their plain PyTorch versions against an f64 numpy solve,
against the JAX package, against hand-built cases, and composed into the
whole LM.  On CUDA tensors each step is one kernel launch
(csrc/ba_edges.cu with its LM epilogue); tests/test_torch_ba_kernels.py
holds those against the plain versions on a CUDA device, and its case is
collected here as well (it skips without a device).

Tolerances: the solve within 1e-4 of max|du| per object against f64 (f32
Cholesky of SPD matrices with condition numbers up to ~1e3); against the
JAX package 2e-6 relative (the same f32 operation sequence, XLA's
multiply-add contraction aside) and 1e-6 absolute on the updated
estimate; the schedule's lam / nu within 1e-6 relative of the f64 values;
ten composed steps equal ``optimize_objects_soa`` exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_oriented_slam_tpu.backend import lm_soa as jsoa
from object_oriented_slam_tpu.ops.linalg import chol_solve_small as jchol
from object_oriented_slam_tpu_torch.backend import (LMConfig, ba_kernels,
                                                    lm_soa)

# the cuda-marked case (the two step kernels against the plain versions)
# lives in the file that runs where JAX is not installed; it is collected
# here too and skips without a device
from test_torch_ba_kernels import (device,  # noqa: F401
                                   test_step_kernels_match_plain)
from test_torch_lm_soa import K, NORMAL, _mixed_obs, _port_inputs

torch.set_num_threads(1)    # the test workers share the CPU


def _spd_problem(seed, O=6):
    """Seeded SPD H [O,9,9] (condition number <= ~1e3), g [O,9], unit-
    quaternion estimates [O,10] and a damping vector that holds both the
    first-iteration marker (-1) and given values."""
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.normal(size=(O, 9, 9)))[0]
    ev = 10.0 ** rng.uniform(0.0, 3.0, size=(O, 9))
    H = np.einsum("oij,oj,okj->oik", Q, ev, Q)
    H = 0.5 * (H + H.transpose(0, 2, 1))
    g = rng.normal(size=(O, 9)) * 5.0
    est = rng.normal(size=(O, 10))
    est[:, 3:7] /= np.linalg.norm(est[:, 3:7], axis=1, keepdims=True)
    est[:, 7:] = rng.uniform(0.2, 0.6, size=(O, 3))
    lam = np.where(np.arange(O) % 2 == 0, -1.0, rng.uniform(1e-3, 1.0, O))
    return tuple(a.astype(np.float32) for a in (H, g, est, lam))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_solve_matches_f64_numpy(seed):
    H, g, est, lam = _spd_problem(seed)
    est_new, du, lam0 = lm_soa.solve_from_normal_eq(
        *(torch.as_tensor(a) for a in (est, lam, H, g)))
    H64, g64 = H.astype(np.float64), g.astype(np.float64)
    diag_max = np.einsum("oii->oi", H64).max(1)
    lam0_want = np.maximum(np.where(lam < 0, np.float32(1e-5) * diag_max,
                                    lam), 1e-12)
    np.testing.assert_allclose(lam0.numpy(), lam0_want, rtol=1e-6)
    want = -np.linalg.solve(H64 + lam0_want[:, None, None] * np.eye(9),
                            g64[..., None])[..., 0]
    err = np.abs(du.numpy() - want).max(1) / np.abs(want).max(1)
    assert (err <= 1e-4).all(), err
    # the update moves the scales by du[6:] and keeps a unit quaternion
    np.testing.assert_allclose(est_new.numpy()[:, 7:], est[:, 7:] + want[:, 6:],
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(
        np.linalg.norm(est_new.numpy()[:, 3:7], axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 3])
def test_solve_matches_jax(seed):
    """The JAX package's chol_solve_small + exp update on the same arrays."""
    H, g, est, lam = _spd_problem(seed)
    est_new, du, lam0 = lm_soa.solve_from_normal_eq(
        *(torch.as_tensor(a) for a in (est, lam, H, g)))
    jH, jg = jnp.asarray(H), jnp.asarray(g)
    jlam0 = jnp.maximum(jnp.where(
        jnp.asarray(lam) < 0,
        jsoa._TAU * jnp.max(jnp.diagonal(jH, axis1=1, axis2=2), axis=1),
        jnp.asarray(lam)), 1e-12)
    jdu = -jchol(jH + jlam0[:, None, None] * jnp.eye(9, dtype=jnp.float32), jg)
    jest = jsoa.soa_exp_update_flat(jnp.asarray(est), jdu)
    np.testing.assert_allclose(lam0.numpy(), np.asarray(jlam0), rtol=1e-7)
    scale = np.abs(np.asarray(jdu)).max(1, keepdims=True)
    assert (np.abs(du.numpy() - np.asarray(jdu)) <= 2e-6 * scale).all()
    np.testing.assert_allclose(est_new.numpy(), np.asarray(jest), atol=1e-6)


def test_solve_gates_nonfinite_du():
    """A NaN in H makes du non-finite: the object's step is zeroed and its
    estimate stays (to round-off of the quaternion normalisation)."""
    H, g, est, lam = _spd_problem(4, O=3)
    H[1, 2, 1] = np.nan
    est_new, du, _ = lm_soa.solve_from_normal_eq(
        *(torch.as_tensor(a) for a in (est, lam, H, g)))
    assert float(du[1].abs().max()) == 0.0
    assert bool(torch.isfinite(du).all()) and float(du[0].abs().max()) > 0
    np.testing.assert_allclose(est_new.numpy()[1], est[1], atol=1e-6)


# chi2, chi2_new, lam0, nu, du scale, g scale -> hand-built accept cases
_ACCEPT_CASES = {
    "accept": dict(chi2=10.0, chi2_new=4.0, lam0=0.5, nu=2.0),
    "accept_small_gain": dict(chi2=10.0, chi2_new=9.999, lam0=0.5, nu=4.0),
    "reject": dict(chi2=10.0, chi2_new=12.0, lam0=0.5, nu=4.0),
    "reject_equal": dict(chi2=10.0, chi2_new=10.0, lam0=0.5, nu=2.0),
    "chi2_new_nan": dict(chi2=10.0, chi2_new=np.nan, lam0=0.5, nu=2.0),
    "chi2_new_inf": dict(chi2=10.0, chi2_new=np.inf, lam0=0.5, nu=8.0),
    "denom_zero": dict(chi2=10.0, chi2_new=4.0, lam0=0.5, nu=2.0, du=0.0),
    "first_iteration": dict(chi2=10.0, chi2_new=4.0, lam0=None, nu=2.0),
}


@pytest.mark.parametrize("case", sorted(_ACCEPT_CASES))
def test_accept_step_cases(case):
    c = dict(_ACCEPT_CASES[case])
    rng = np.random.default_rng(5)
    du = (rng.normal(size=(1, 9)) * c.get("du", 0.1)).astype(np.float32)
    g = rng.normal(size=(1, 9)).astype(np.float32)
    est = rng.normal(size=(1, 10)).astype(np.float32)
    est_new = est + 1.0
    if c["lam0"] is None:
        # lam < 0 marks the first iteration: lam0 = tau * max diag H
        H, gg, e, _ = _spd_problem(6, O=1)
        _, _, lam0_t = lm_soa.solve_from_normal_eq(
            torch.as_tensor(e), torch.tensor([-1.0]), torch.as_tensor(H),
            torch.as_tensor(gg))
        c["lam0"] = float(lam0_t[0])
        assert c["lam0"] == pytest.approx(
            1e-5 * float(np.einsum("oii->oi", H).max()), rel=1e-6)
    t = lambda x: torch.tensor([x], dtype=torch.float32)
    got_est, got_chi2, got_lam, got_nu, got_acc = lm_soa.accept_from_chi2(
        torch.as_tensor(est), t(c["chi2"]), t(c["nu"]),
        torch.as_tensor(est_new), t(c["chi2_new"]), torch.as_tensor(du),
        torch.as_tensor(g), t(c["lam0"]))

    want_acc = bool(c["chi2_new"] < c["chi2"]) and np.isfinite(c["chi2_new"])
    assert bool(got_acc[0]) == want_acc
    assert want_acc == case.startswith(("accept", "denom", "first"))
    lam0 = np.float64(np.float32(c["lam0"]))
    if want_acc:
        denom = float(np.sum(du.astype(np.float64)
                             * (lam0 * du.astype(np.float64) - g)))
        denom = denom if abs(denom) > 1e-20 else 1e-20
        rho = (c["chi2"] - c["chi2_new"]) / denom
        factor = min(max(1.0 - (2.0 * rho - 1.0) ** 3, 1 / 3), 2 / 3)
        np.testing.assert_allclose(float(got_lam[0]), lam0 * factor, rtol=1e-6)
        assert float(got_nu[0]) == 2.0
        np.testing.assert_array_equal(got_est.numpy(), est_new)
        assert float(got_chi2[0]) == np.float32(c["chi2_new"])
        if case == "denom_zero":     # rho = 6e20: the factor clamps to 1/3
            np.testing.assert_allclose(float(got_lam[0]), lam0 / 3, rtol=1e-6)
    else:
        np.testing.assert_allclose(float(got_lam[0]), lam0 * c["nu"],
                                   rtol=1e-6)
        assert float(got_nu[0]) == 2.0 * c["nu"]
        np.testing.assert_array_equal(got_est.numpy(), est)
        assert float(got_chi2[0]) == np.float32(c["chi2"])


def _mixed_problem(**cfg_kw):
    cfg = LMConfig(**cfg_kw)
    tobs, prep, w2, w3, wg, Kt = _port_inputs(_mixed_obs(), cfg, True)
    return tobs, cfg, (prep, w2, w3, wg, torch.as_tensor(NORMAL), Kt,
                       cfg.huber_delta)


def test_plain_steps_on_the_mixed_batch():
    """lm_solve_step_plain solves its own normal equations; the accept step
    rejects a trial equal to the estimate and accepts the solve's trial for
    at least one object."""
    tobs, _, problem = _mixed_problem(gravity_on=True, gravity_scale=100.0)
    O = tobs.est0.shape[0]
    lam = torch.full((O,), -1.0)
    nu = torch.full((O,), 2.0)
    est_new, du, g, lam0, H = lm_soa.lm_solve_step_plain(
        tobs.est0, lam, *problem, want_H=True)
    assert lm_soa.lm_solve_step_plain(tobs.est0, lam, *problem)[4] is None
    A = H.double().numpy() + lam0.double().numpy()[:, None, None] * np.eye(9)
    want = -np.linalg.solve(A, g.double().numpy()[..., None])[..., 0]
    # H of a few 2D views is worse conditioned than the seeded SPD cases
    scale = np.abs(want).max(1, keepdims=True) + 1e-12
    assert (np.abs(du.numpy() - want) <= 2e-2 * scale).all()

    chi2 = lm_soa.soa_chi2_plain(tobs.est0, *problem)
    same = lm_soa.lm_accept_step_plain(tobs.est0, chi2, lam, nu, tobs.est0,
                                       du, g, lam0, *problem)
    assert not bool(same[4].any())
    np.testing.assert_array_equal(same[3].numpy(), 4.0)
    stepped = lm_soa.lm_accept_step_plain(tobs.est0, chi2, lam, nu, est_new,
                                          du, g, lam0, *problem)
    assert bool(stepped[4].any())
    acc = stepped[4].numpy()
    np.testing.assert_array_equal(stepped[0].numpy()[acc], est_new.numpy()[acc])
    np.testing.assert_array_equal(stepped[0].numpy()[~acc],
                                  tobs.est0.numpy()[~acc])
    assert (stepped[1].numpy()[acc] < chi2.numpy()[acc]).all()
    # nothing was updated in place
    np.testing.assert_array_equal(lam.numpy(), -1.0)


def test_ten_composed_steps_equal_the_lm():
    tobs, cfg, problem = _mixed_problem(gravity_on=True, gravity_scale=100.0)
    O = tobs.est0.shape[0]
    launches = (ba_kernels.NORMAL_EQ.launches, ba_kernels.CHI2.launches)
    est = tobs.est0
    lam = torch.full((O,), -1.0)
    nu = torch.full((O,), 2.0)
    chi2 = lm_soa.soa_chi2(est, *problem)
    accepted = 0
    for _ in range(cfg.iters):
        est_new, du, g, lam0, _ = lm_soa.lm_solve_step(est, lam, *problem)
        est, chi2, lam, nu, acc = lm_soa.lm_accept_step(
            est, chi2, lam, nu, est_new, du, g, lam0, *problem)
        accepted += int(acc.sum())
    # CPU tensors run the plain versions: no kernel launch
    assert (ba_kernels.NORMAL_EQ.launches, ba_kernels.CHI2.launches) \
        == launches
    assert accepted > 0
    want_est, want_chi2 = lm_soa.optimize_objects_soa(
        tobs, torch.as_tensor(K), torch.as_tensor(NORMAL), True, cfg)
    has_edges = (problem[1].sum(1) + problem[2].sum(1)) > 0
    keep = (tobs.obj_mask & has_edges)[:, None]
    np.testing.assert_array_equal(
        torch.where(keep, est, tobs.est0).numpy(), want_est.numpy())
    np.testing.assert_array_equal(chi2.numpy(), want_chi2.numpy())


def test_steps_refuse_other_devices():
    tobs, _, problem = _mixed_problem()
    O = tobs.est0.shape[0]
    meta = tobs.est0.to("meta")
    lam = torch.full((O,), -1.0)
    with pytest.raises(NotImplementedError):
        lm_soa.lm_solve_step(meta, lam, *problem)
    with pytest.raises(NotImplementedError):
        lm_soa.lm_accept_step(meta, lam, lam, lam, meta, lam, lam, lam,
                              *problem)


def test_launch_shape_covers_the_tiers():
    """Every LM tier up to 512 + 256 edge slots gets one edge per thread,
    blocks of 64..128 threads in whole warps and a cluster of at most 8;
    the main tier (512 + 32) spreads an object over several blocks."""
    for m2 in (64, 128, 256, 512):
        for m3 in (32, 64, 128, 256):
            S, T = ba_kernels.launch_shape(m2 + m3)
            assert 1 <= S <= 8 and T in (64, 96, 128)
            assert S * T >= m2 + m3
    assert ba_kernels.launch_shape(512 + 32)[0] > 1
    assert ba_kernels.launch_shape(0)[0] == 1
    S, T = ba_kernels.launch_shape(4096)
    assert (S, T) == (8, 128)
