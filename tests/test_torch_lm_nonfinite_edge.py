"""An edge with a non-finite tangent is left out of the normal equations
(backend/lm_soa.soa_normal_eq_plain; the CUDA kernel does the same and is
held against it by tests/test_torch_ba_kernels.py on a card).

A view from inside the ellipsoid projects to a conic without real axes:
the bbox half-widths are sqrt(max(negative, 0)) = 0, the residual stays
finite (the edge passes the NaN gate at the initial estimate) and its
tangent is NaN.  One such edge used to make the object's H non-finite and
the ``du_ok`` gate then zeroed every step of the object.

Checked here, on seeded numpy batches (io/synthetic.make_lm_batch):
the poisoned input gives the H, g of the same input with that edge masked
out (1e-6 relative); where every tangent is finite, H, g and du carry the
bits of the plain contraction without the edge test (this file keeps its
own copy of that contraction) and a few pinned values of the tree before
the repair (1e-6 relative: another machine's einsum may add in another
order).
"""
import numpy as np
import pytest
import torch

from object_oriented_slam_tpu_torch.backend import (LMConfig, lm_soa,
                                                    observations_from_numpy)
from object_oriented_slam_tpu_torch.io.synthetic import make_lm_batch

torch.set_num_threads(1)    # the test workers share the CPU

K = torch.tensor([[535.4, 0, 320.1], [0, 539.2, 247.6], [0, 0, 1]])
NORMAL = torch.tensor([0.05, -0.02, 1.0])
POISONED = (2, 1)           # object, 2D edge slot


def _problem(arrays, gravity=True):
    obs = observations_from_numpy(arrays, device="cpu")
    prep = lm_soa.soa_prepare(obs.pose2d_cw, obs.bbox2d, obs.pose3d_wc,
                              obs.meas3d)
    w2, w3, wg = lm_soa.soa_edge_weights(obs, prep, K, gravity, LMConfig())
    return obs.est0, (prep, w2, w3, wg, NORMAL, K, 0.0)


def _poison(arrays):
    """Moves one camera into the centre of the object it looks at."""
    o, m = POISONED
    assert arrays["mask2d"][o, m]
    arrays["pose2d_cw"][o, m] = (*(-arrays["est0"][o, :3]), 0, 0, 0, 1)
    arrays["bbox2d"][o, m] = (200.0, 150.0, 400.0, 350.0)


def _contraction_without_the_edge_test(est, prep, w2d, w3d, wg, normal, Kt,
                                       huber_delta):
    """The normal equations as they were before the repair: the jvp per
    tangent direction, then J^T J and J^T r over every row."""
    O = est.shape[0]
    u0 = torch.zeros((O, 9), dtype=est.dtype)

    def f(u):
        return lm_soa.soa_residual_comps(est, u, prep, w2d, w3d, wg, normal,
                                         Kt, huber_delta)

    basis = torch.eye(9, dtype=est.dtype)[:, None, :].expand(9, O, 9)
    r_comps, t_comps = torch.func.vmap(
        lambda t: torch.func.jvp(f, (u0,), (t,)))(basis)
    J = lm_soa.soa_flat_r(t_comps, O)
    r = lm_soa.soa_flat_r(tuple(c[0] for c in r_comps), O)
    return (torch.einsum("kor,lor->okl", J, J),
            torch.einsum("kor,or->ok", J, r), torch.sum(r * r, dim=-1))


def _bits(a, b):
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


def test_poisoned_edge_equals_the_edge_masked_out():
    arrays = make_lm_batch(4, 8, 4, seed=21)
    _poison(arrays)
    est, problem = _problem(arrays)
    o, m = POISONED
    assert float(problem[1][o, m]) > 0          # it passes the NaN gate
    # before the repair: the object's H is not finite
    H_old, g_old, _ = _contraction_without_the_edge_test(est, *problem)
    assert not bool(torch.isfinite(H_old[o]).all())
    assert bool(torch.isfinite(H_old[[0, 1]]).all())

    H, g, c = lm_soa.soa_normal_eq_plain(est, *problem)
    assert bool(torch.isfinite(H).all()) and bool(torch.isfinite(g).all())
    prep, w2, *rest = problem
    w2_masked = w2.clone()
    w2_masked[o, m] = 0.0
    Hm, gm, cm = lm_soa.soa_normal_eq_plain(est, prep, w2_masked, *rest)
    scale = Hm.abs().flatten(1).amax(1)
    assert bool(((H - Hm).abs().flatten(1).amax(1) <= 1e-6 * scale).all())
    assert bool(((g - gm).abs().amax(1) <= 1e-6 * scale).all())
    np.testing.assert_allclose(c.numpy(), cm.numpy(), rtol=1e-6)
    # the other objects do not see the repair at all
    for k in (0, 1, 3):
        assert _bits(H[k], H_old[k]) and _bits(g[k], g_old[k])


def test_poisoned_object_moves_again():
    """The solve step no longer gates the object: du is finite and not
    zero, and ten LM iterations lower its chi2."""
    arrays = make_lm_batch(4, 8, 4, seed=21)
    _poison(arrays)
    est, problem = _problem(arrays)
    o = POISONED[0]
    lam = torch.full((4,), -1.0)
    est_new, du, g, lam0, H = lm_soa.lm_solve_step_plain(est, lam, *problem,
                                                         want_H=True)
    assert bool(torch.isfinite(du).all()) and float(du[o].abs().max()) > 0
    assert not torch.equal(est_new[o], est[o])
    # chi2 and the accept test are as they were: the edge still counts there
    chi2 = lm_soa.soa_chi2_plain(est, *problem)
    out = lm_soa.lm_accept_step_plain(est, chi2, lam, torch.full((4,), 2.0),
                                      est_new, du, g, lam0, *problem)
    assert bool(torch.isfinite(out[1]).all())
    obs = observations_from_numpy(arrays, device="cpu")
    final, chi2_final = lm_soa.optimize_objects_soa(obs, K, NORMAL, True)
    assert float(chi2_final[o]) < float(chi2[o])
    assert not torch.equal(final[o], est[o])


@pytest.mark.parametrize("shape,seed", [((4, 8, 4), 21), ((6, 16, 8), 22),
                                        ((3, 12, 0), 23)])
def test_finite_tangents_keep_their_bits(shape, seed):
    est, problem = _problem(make_lm_batch(*shape, seed=seed))
    want = _contraction_without_the_edge_test(est, *problem)
    got = lm_soa.soa_normal_eq_plain(est, *problem)
    assert bool(torch.isfinite(want[0]).all())
    for a, b in zip(got, want):
        assert _bits(a, b)
    lam = torch.full((shape[0],), -1.0)
    lam[1] = 0.25
    step = lm_soa.lm_solve_step_plain(est, lam, *problem, want_H=True)
    ref = lm_soa.solve_from_normal_eq(est, lam, want[0], want[1])
    assert _bits(step[0], ref[0]) and _bits(step[1], ref[1])
    assert _bits(step[3], ref[2]) and _bits(step[4], want[0])
    assert float(step[1].abs().max()) > 0


# values of soa_normal_eq_plain / solve_from_normal_eq on
# make_lm_batch(4, 8, 4, seed=21) taken on the tree before the repair
PINNED = {
    "H_trace": [554326.0, 260826.0625, 1189615.625, 9999.6357421875],
    "H_01": [-1427.370849609375, -767.37158203125, -4706.41259765625,
             3448.150146484375],
    "g_norm": [9673.5419921875, 6815.0048828125, 29100.677734375,
               537.99609375],
    "r2sum": [1029.25732421875, 1695.738037109375, 4564.625,
              28.945037841796875],
    "du_norm": [0.130129873752594, 0.24455437064170837, 0.18955928087234497,
                0.05380110442638397],
}


def test_pinned_values_of_the_tree_before_the_repair():
    est, problem = _problem(make_lm_batch(4, 8, 4, seed=21))
    H, g, c = lm_soa.soa_normal_eq_plain(est, *problem)
    _, du, _ = lm_soa.solve_from_normal_eq(est, torch.full((4,), -1.0), H, g)
    got = {
        "H_trace": torch.diagonal(H, dim1=1, dim2=2).sum(1).tolist(),
        "H_01": H[:, 0, 1].tolist(),
        "g_norm": g.norm(dim=1).tolist(),
        "r2sum": c.tolist(),
        "du_norm": du.norm(dim=1).tolist(),
    }
    for name, want in PINNED.items():
        np.testing.assert_allclose(got[name], want, rtol=1e-6, err_msg=name)
