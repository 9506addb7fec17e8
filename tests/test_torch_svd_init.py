"""Port parity: init/svd_init (the batch SVD quadric initializer) against
the JAX package on the cases of tests/test_svd_init.py, the same numpy
observations handed to both.

Tolerance: centre and sorted scales within 1e-4, ``ok`` and ``n_planes``
equal (f32 round-off of the same formulas through two SVD
implementations; quaternions are not compared: the eigenvectors of a
near-isotropic block are only defined up to a rotation, ROADMAP queue 3
"Yaw flips").  ``quadric_plane_error`` within rtol 1e-3 of a value near
zero (a sum of squared round-off), with a floor of 1e-9.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_oriented_slam_tpu.init import init_quadric_svd as j_init
from object_oriented_slam_tpu.init import quadric_plane_error as j_err
from object_oriented_slam_tpu_torch.init import (IncrementalQuadricInit,
                                                 init_quadric_svd,
                                                 quadric_plane_error)

from test_svd_init import COLS, K, ROWS, make_observations

torch.set_num_threads(1)    # the test workers share the CPU


def _cases():
    """(name, poses [M, 7], bboxes [M, 4], mask [M]) of test_svd_init.py,
    drawn once from a fresh seed (test_svd_init's module RNG is put back)."""
    import test_svd_init
    saved = test_svd_init.RNG
    test_svd_init.RNG = np.random.default_rng(3)
    try:
        out = []
        sphere = np.array([0.5, -0.2, 0.3, 0, 0, 0, 1, 0.4, 0.4, 0.4],
                          np.float32)
        p, b = make_observations(sphere)
        out.append(("sphere", p, b, np.ones(len(p), bool)))
        aniso = np.array([0.0, 0.0, 0.5, 0, 0, 0, 1, 0.6, 0.3, 0.2],
                         np.float32)
        p, b = make_observations(aniso, n_views=30)
        out.append(("anisotropic", p, b, np.ones(len(p), bool)))
        small = np.array([0.0, 0.0, 0.5, 0, 0, 0, 1, 0.4, 0.4, 0.4],
                         np.float32)
        p, b = make_observations(small, n_views=2)
        out.append(("too_few", p, b, np.ones(len(p), bool)))
        p, b = make_observations(small, n_views=12)
        b[0, 0] = -1.0
        out.append(("border", p, b, np.ones(len(p), bool)))
        p, b = make_observations(small, n_views=20)
        b[10:] = test_svd_init.RNG.uniform(0, 600, b[10:].shape)
        m = np.zeros(20, bool)
        m[:10] = True
        out.append(("masked", p, b, m))
        noisy = np.array([0.4, -0.3, 0.5, 0, 0, 0, 1, 0.45, 0.3, 0.2],
                         np.float32)
        p, b = make_observations(noisy, n_views=18, noise=0.5)
        out.append(("noisy", p, b, np.ones(len(p), bool)))
        return out
    finally:
        test_svd_init.RNG = saved


CASES = _cases()


def _port(p, b, m):
    return init_quadric_svd(torch.as_tensor(p), torch.as_tensor(b),
                            torch.as_tensor(m), torch.as_tensor(K), ROWS,
                            COLS)


def _jax(p, b, m):
    return j_init(jnp.asarray(p), jnp.asarray(b), jnp.asarray(m),
                  jnp.asarray(K), ROWS, COLS)


def _same_ellipsoid(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got[..., :3], want[..., :3], atol=1e-4)
    np.testing.assert_allclose(np.sort(got[..., 7:], axis=-1),
                               np.sort(want[..., 7:], axis=-1), atol=1e-4)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_init_matches_jax(case):
    _, p, b, m = case
    got, want = _port(p, b, m), _jax(p, b, m)
    assert bool(got.ok) == bool(want.ok)
    assert int(got.n_planes) == int(want.n_planes)
    if bool(want.ok):
        _same_ellipsoid(got.ellipsoid.numpy(), np.asarray(want.ellipsoid))
        e = got.ellipsoid
        err = float(quadric_plane_error(
            e, torch.as_tensor(p), torch.as_tensor(b), torch.as_tensor(m),
            torch.as_tensor(K), ROWS, COLS))
        want_err = float(j_err(jnp.asarray(e.numpy()), jnp.asarray(p),
                               jnp.asarray(b), jnp.asarray(m),
                               jnp.asarray(K), ROWS, COLS))
        np.testing.assert_allclose(err, want_err, rtol=1e-3, atol=1e-9)


def test_gates_and_masks():
    """test_svd_init's gates on the port alone: 8 planes are refused, one
    border edge drops one plane, masked-out rows change nothing."""
    few = _port(*CASES[2][1:])
    assert not bool(few.ok) and int(few.n_planes) == 8
    border = _port(*CASES[3][1:])
    assert int(border.n_planes) == 12 * 4 - 1 and bool(border.ok)
    _, p, b, m = CASES[4]
    a = _port(p, b, m)
    c = _port(p[:10], b[:10], np.ones(10, bool))
    assert bool(a.ok) and bool(c.ok)
    # a sphere: its rotation is any (the eigenvectors of an isotropic block)
    ea, ec = a.ellipsoid.numpy(), c.ellipsoid.numpy()
    np.testing.assert_allclose(ea[:3], ec[:3], atol=1e-3)
    np.testing.assert_allclose(np.sort(ea[7:]), np.sort(ec[7:]), atol=1e-3)


def test_batched_over_candidates_matches_jax():
    """Leading batch axes (the JAX package's vmap over candidates)."""
    p = np.stack([CASES[0][1][:15], CASES[5][1][:15]])
    b = np.stack([CASES[0][2][:15], CASES[5][2][:15]])
    m = np.ones((2, 15), bool)
    got = _port(p, b, m)
    want = jax.vmap(lambda pp, bb, mm: j_init(pp, bb, mm, jnp.asarray(K),
                                              ROWS, COLS))(
        jnp.asarray(p), jnp.asarray(b), jnp.asarray(m))
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(want.ok))
    np.testing.assert_array_equal(got.n_planes.numpy(),
                                  np.asarray(want.n_planes))
    _same_ellipsoid(got.ellipsoid.numpy(), np.asarray(want.ellipsoid))


def test_incremental_matches_batch():
    """test_svd_init's case on the port: the host Gram-accumulated init
    equals the batch SVD initializer (f64 host against f32 SVD)."""
    _, p, b, m = CASES[5]
    res = _port(p, b, m)
    assert bool(res.ok)
    batch = res.ellipsoid.numpy().astype(np.float64)
    inc = IncrementalQuadricInit(K, ROWS, COLS)
    for pp, bb in zip(p, b):
        inc.add_observation(0, pp, bb)
    assert inc.n_planes(0) == int(res.n_planes)
    v = inc.try_init(0)
    assert v is not None
    np.testing.assert_allclose(v[:3], batch[:3], atol=2e-3)
    np.testing.assert_allclose(np.sort(v[7:]), np.sort(batch[7:]), atol=5e-3)
