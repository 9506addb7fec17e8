"""The CUDA BA edge kernels against their plain PyTorch versions.

Needs an NVIDIA GPU (sm_90a) and nvcc; skipped elsewhere.  The machine
with the card has no JAX, so run this file without the JAX test setup:

    python -m pytest tests/test_torch_ba_kernels.py --noconftest -q

Tolerances: H and g within 1e-4 of max|H| per object and chi2 within
rtol 1e-5 -- f32 round-off with other summation orders (a per-thread then
tree reduction against einsum) and FMA contraction in the kernel; the
whole 10-iteration LM within 2e-3, the JAX package's SoA-vs-AoS tolerance
(tests/test_lm_soa.py).  The two LM step entry points: du, est_new and lam0
within 1e-4 of max|.| per object (the 9x9 solve amplifies H's round-off),
accept flags equal, lam / nu / chi2 within 1e-5, repeats bit-equal.
"""
import numpy as np
import pytest
import torch

from object_oriented_slam_tpu_torch.backend import (LMConfig, ba_kernels,
                                                    lm_soa,
                                                    observations_from_numpy,
                                                    optimize_objects,
                                                    optimize_objects_soa)
from object_oriented_slam_tpu_torch.io.synthetic import make_lm_batch

torch.set_num_threads(1)    # the test workers share the CPU

pytestmark = pytest.mark.cuda

NORMAL = np.array([0.05, -0.02, 1.0], np.float32)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _problem(device, O, M2, M3, seed, gravity=True):
    obs = observations_from_numpy(make_lm_batch(O, M2, M3, seed=seed), device)
    K = torch.tensor([[535.4, 0, 320.1], [0, 539.2, 247.6], [0, 0, 1]],
                     device=device)
    n = torch.as_tensor(NORMAL, device=device)
    prep = lm_soa.soa_prepare(obs.pose2d_cw, obs.bbox2d, obs.pose3d_wc,
                              obs.meas3d)
    w2, w3, wg = lm_soa.soa_edge_weights(obs, prep, K, gravity, LMConfig())
    return obs, prep, w2, w3, wg, n, K


def _assert_neq_close(got, want):
    H, g, c = (t.double().cpu().numpy() for t in got)
    Hp, gp, cp = (t.double().cpu().numpy() for t in want)
    assert np.isfinite(Hp).all() and np.isfinite(H).all()
    scale = np.abs(Hp).reshape(len(Hp), -1).max(1)
    tol = 1e-4 * scale + 1e-30
    assert (np.abs(H - Hp).reshape(len(H), -1).max(1) <= tol).all()
    assert (np.abs(g - gp).max(1) <= tol).all()
    np.testing.assert_allclose(c, cp, rtol=1e-5)


@pytest.mark.parametrize("shape", [(6, 64, 32), (24, 512, 256),
                                   (5, 300, 0), (5, 0, 70)])
@pytest.mark.parametrize("huber", [0.0, 5.0])
def test_normal_eq_matches_plain(device, shape, huber):
    obs, prep, w2, w3, wg, n, K = _problem(device, *shape, seed=3)
    before = ba_kernels.NORMAL_EQ.launches
    got = ba_kernels.normal_eq(obs.est0, prep, w2, w3, wg, n, K, huber)
    torch.cuda.synchronize()
    assert ba_kernels.NORMAL_EQ.launches == before + 1
    want = lm_soa.soa_normal_eq_plain(obs.est0, prep, w2, w3, wg, n, K,
                                      huber)
    _assert_neq_close(got, want)


@pytest.mark.parametrize("shape", [(6, 64, 32), (24, 512, 256)])
@pytest.mark.parametrize("huber", [0.0, 5.0])
def test_chi2_matches_plain(device, shape, huber):
    obs, prep, w2, w3, wg, n, K = _problem(device, *shape, seed=4)
    est = obs.est0 + 0.01   # off the data, non-normalized quaternion
    got = ba_kernels.chi2(est, prep, w2, w3, wg, n, K, huber)
    want = lm_soa.soa_chi2_plain(est, prep, w2, w3, wg, n, K, huber)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5)


def test_lm_on_cuda_matches_cpu(device):
    arrays = make_lm_batch(8, 128, 64, seed=5)
    K = torch.tensor([[535.4, 0, 320.1], [0, 539.2, 247.6], [0, 0, 1]])
    n = torch.as_tensor(NORMAL)
    cfg = LMConfig()
    before = (ba_kernels.NORMAL_EQ.launches, ba_kernels.CHI2.launches)
    est_d, chi_d = optimize_objects_soa(
        observations_from_numpy(arrays, device), K.to(device), n.to(device),
        True, cfg)
    assert ba_kernels.NORMAL_EQ.launches == before[0] + cfg.iters
    assert ba_kernels.CHI2.launches == before[1] + cfg.iters + 1
    est_c, chi_c = optimize_objects_soa(
        observations_from_numpy(arrays, device="cpu"), K, n, True, cfg)
    np.testing.assert_allclose(est_d.cpu().numpy(), est_c.numpy(), atol=2e-3)
    np.testing.assert_allclose(chi_d.cpu().numpy(), chi_c.numpy(),
                               rtol=1e-2, atol=1e-3)


def test_aos_on_cuda_matches_cpu_twin(device):
    """backend/lm.optimize_objects (the AoS solver) on the card: one
    ba_normal_eq and one ba_chi2 launch an iteration (+1 chi2 at est0) and
    no plain version; within 1e-4 of its CPU twin (the AoS formulas in the
    JAX package's order) at 3 iterations.  chi2 within rtol 1e-2, atol 1e-3
    (tests/test_lm_soa.py's SoA-against-AoS class): the kernels evaluate
    the projected bbox by the SoA formulas, the twin by the AoS ellipse
    route, which round the pixel residuals differently (1.1e-3 relative
    at the same estimates on the card, H100)."""
    arrays = make_lm_batch(6, 64, 32, seed=5)
    K = torch.tensor([[535.4, 0, 320.1], [0, 539.2, 247.6], [0, 0, 1]])
    n = torch.as_tensor(NORMAL)
    cfg = LMConfig(iters=3)
    before = (ba_kernels.NORMAL_EQ.launches, ba_kernels.CHI2.launches)
    est_d, chi_d = optimize_objects(observations_from_numpy(arrays, device),
                                    K.to(device), n.to(device), True, cfg)
    assert ba_kernels.NORMAL_EQ.launches == before[0] + cfg.iters
    assert ba_kernels.CHI2.launches == before[1] + cfg.iters + 1
    est_c, chi_c = optimize_objects(
        observations_from_numpy(arrays, device="cpu"), K, n, True, cfg)
    np.testing.assert_allclose(est_d.cpu().numpy(), est_c.numpy(), atol=1e-4)
    np.testing.assert_allclose(chi_d.cpu().numpy(), chi_c.numpy(),
                               rtol=1e-2, atol=1e-3)


def _rel_close(got, want, tol):
    """Within tol of max|want| per object (row)."""
    O = want.shape[0]
    a = got.double().cpu().numpy().reshape(O, -1)
    b = want.double().cpu().numpy().reshape(O, -1)
    assert a.shape == b.shape
    assert (np.abs(a - b).max(1) <= tol * np.abs(b).max(1) + 1e-30).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(6, 64, 32), (24, 512, 32),
                                   (24, 512, 256)])
def test_step_kernels_match_plain(device, shape):
    """One LM iteration as two launches: du, est_new, lam0 within 1e-4 of
    max|.| per object, g within 1e-4 of max|H|, equal accept flags, lam /
    nu / chi2 within 1e-5, the state updated in place, equal bits on a
    second launch."""
    obs, prep, w2, w3, wg, n, K = _problem(device, *shape, seed=8)
    problem = (prep, w2, w3, wg, n, K, 0.0)
    O = shape[0]
    lam = torch.full((O,), -1.0, device=device)
    nu = torch.full((O,), 2.0, device=device)
    before = (ba_kernels.NORMAL_EQ.launches, ba_kernels.CHI2.launches)
    got = ba_kernels.lm_solve_step(obs.est0, lam, *problem, want_H=True)
    again = ba_kernels.lm_solve_step(obs.est0, lam, *problem)
    torch.cuda.synchronize()
    assert again[4] is None
    want = lm_soa.lm_solve_step_plain(obs.est0, lam, *problem, want_H=True)
    est_new, du, g, lam0, H = want
    for a, b in zip(got[:4], again[:4]):
        assert torch.equal(a, b)
    _rel_close(got[0], est_new, 1e-4)
    _rel_close(got[1], du, 1e-4)
    _rel_close(got[3][:, None], lam0[:, None], 1e-4)
    scale = H.abs().flatten(1).amax(1, keepdim=True)
    assert bool(((got[2] - g).abs() <= 1e-4 * scale + 1e-30).all())
    assert bool(((got[4] - H).abs().flatten(1) <= 1e-4 * scale + 1e-30).all())

    chi2 = lm_soa.soa_chi2_plain(obs.est0, *problem)
    want = lm_soa.lm_accept_step_plain(obs.est0, chi2, lam, nu, est_new, du,
                                       g, lam0, *problem)
    runs = []
    for _ in range(2):
        state = [t.clone() for t in (obs.est0, chi2, lam, nu)]
        out = ba_kernels.lm_accept_step(*state, est_new, du, g, lam0,
                                        *problem)
        assert all(a is b for a, b in zip(out[:4], state))
        runs.append(out)
    torch.cuda.synchronize()
    assert (ba_kernels.NORMAL_EQ.launches, ba_kernels.CHI2.launches) \
        == (before[0] + 2, before[1] + 2)
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert torch.equal(runs[0][4], want[4])
    assert bool(want[4].any())
    for a, b in zip(runs[0][:4], want[:4]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-5)


def test_nan_tangent_edges_are_left_out_alike(device):
    """An object whose projected conics have no real axes (a 30 m sphere
    around its cameras): every 2D edge has a finite residual and a NaN
    tangent.  The kernel and the plain version leave the same edges out, so
    H stays finite on both sides and agrees; the other objects are
    untouched."""
    arrays = make_lm_batch(6, 64, 32, seed=9)
    arrays["est0"][3, 3:] = (0, 0, 0, 1, 30, 30, 30)
    obs = observations_from_numpy(arrays, device)
    K = torch.tensor([[535.4, 0, 320.1], [0, 539.2, 247.6], [0, 0, 1]],
                     device=device)
    n = torch.as_tensor(NORMAL, device=device)
    prep = lm_soa.soa_prepare(obs.pose2d_cw, obs.bbox2d, obs.pose3d_wc,
                              obs.meas3d)
    w2, w3, wg = lm_soa.soa_edge_weights(obs, prep, K, True, LMConfig())
    assert float(w2[3].sum()) > 0           # the edges pass the NaN gate
    got = ba_kernels.normal_eq(obs.est0, prep, w2, w3, wg, n, K)
    want = lm_soa.soa_normal_eq_plain(obs.est0, prep, w2, w3, wg, n, K)
    _assert_neq_close(got, want)
    # the same sums with those edges masked out by hand
    w2_masked = w2.clone()
    w2_masked[3] = 0.0
    masked = ba_kernels.normal_eq(obs.est0, prep, w2_masked, w3, wg, n, K)
    for a, b in zip(got, masked):
        assert torch.equal(a, b)
    lam = torch.full((6,), -1.0, device=device)
    step = ba_kernels.lm_solve_step(obs.est0, lam, prep, w2, w3, wg, n, K,
                                    0.0)
    assert float(step[1][3].abs().max()) > 0    # the object moves


def test_wrapper_checks_inputs(device):
    obs, prep, w2, w3, wg, n, K = _problem(device, 4, 64, 32, seed=6)
    with pytest.raises(TypeError):
        ba_kernels.chi2(obs.est0.double(), prep, w2, w3, wg, n, K)
    with pytest.raises(ValueError):
        ba_kernels.chi2(obs.est0.cpu(), prep, w2, w3, wg, n, K)
    with pytest.raises(ValueError):
        ba_kernels.chi2(obs.est0, prep, w2[:, :8], w3, wg, n, K)
    with pytest.raises(ValueError):
        ba_kernels.normal_eq(obs.est0, prep, w2.t().contiguous().t(), w3, wg,
                             n, K)
