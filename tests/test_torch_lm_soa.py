"""Port parity: backend/lm_soa against the JAX package's SoA backend.

The inputs are tests/test_lm_soa.py's mixed batch (2D + 3D edges, partial
masks, a gated 2-observation object, an empty slot, border-invalidated
coordinates, optionally a NaN bbox) plus a gravity prior, handed to both
packages as the same numpy arrays.

Tolerances: H and g within 1e-4 of max|H| per object, chi2 within rtol
1e-5 (the same f32 formulas with other summation orders); the whole
10-iteration LM within atol 2e-3 and chi2 within rtol 1e-2, the tolerance
of tests/test_lm_soa.py for two implementations of one LM.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_oriented_slam_tpu.backend import LMConfig as JLMConfig
from object_oriented_slam_tpu.backend import lm_soa as jsoa
from object_oriented_slam_tpu_torch.backend import (LMConfig, ba_kernels,
                                                    lm_soa,
                                                    observations_from_numpy)

import test_lm_soa
from test_svd_init import K

torch.set_num_threads(1)    # the test workers share the CPU

NORMAL = np.array([0.05, -0.02, 1.0], np.float32)


def _mixed_obs(with_nan=False):
    """test_lm_soa._mixed_obs on one fixed draw.  That module draws from
    its own RNG, which is put back as it was, so its tests see the same
    draws whether or not this file ran first in the process."""
    saved = test_lm_soa.RNG
    test_lm_soa.RNG = np.random.default_rng(11)
    try:
        return test_lm_soa._mixed_obs(with_nan=with_nan)
    finally:
        test_lm_soa.RNG = saved


def _np(obs):
    return {k: np.array(v) for k, v in obs._asdict().items()}


def _jax_weights(obs, cfg, gset):
    """The gated edge weights exactly as jsoa.optimize_objects_soa builds
    them (inline there)."""
    prep = jsoa.soa_prepare(obs.pose2d_cw, obs.bbox2d, obs.pose3d_wc,
                            obs.meas3d)
    gate = (jnp.sum(obs.mask2d, axis=1) >= cfg.min_2d_obs)[:, None]
    w2d = jnp.where(obs.mask2d & gate,
                    jnp.sqrt(jnp.maximum(obs.prob2d, 0.0)), 0.0)
    w3d = jnp.where(obs.mask3d, jnp.sqrt(jnp.maximum(obs.prob3d, 0.0)
                                         * cfg.scale_3d), 0.0)
    w2d = jnp.where(jsoa.soa_finite2d(obs.est0, prep[0], prep[1], prep[2],
                                      jnp.asarray(K)), w2d, 0.0)
    if cfg.check_visibility:
        w2d = jnp.where(jsoa.soa_visibility2d(
            obs.est0, prep[0], prep[1], jnp.asarray(K), cfg.vis_rows,
            cfg.vis_cols), w2d, 0.0)
    wg = jnp.full((obs.est0.shape[0],),
                  cfg.gravity_scale if (gset and cfg.gravity_on) else 0.0,
                  jnp.float32)
    return prep, w2d, w3d, wg


def _port_inputs(obs, cfg, gset):
    tobs = observations_from_numpy(_np(obs), device="cpu")
    prep = lm_soa.soa_prepare(tobs.pose2d_cw, tobs.bbox2d, tobs.pose3d_wc,
                              tobs.meas3d)
    Kt = torch.as_tensor(K)
    w2, w3, wg = lm_soa.soa_edge_weights(tobs, prep, Kt, gset, cfg)
    return tobs, prep, w2, w3, wg, Kt


@pytest.mark.parametrize("with_nan,huber", [(False, 0.0), (True, 5.0)])
def test_normal_eq_and_chi2_match_jax(with_nan, huber):
    obs = _mixed_obs(with_nan=with_nan)
    jprep, jw2, jw3, jwg = _jax_weights(obs, JLMConfig(), True)
    # eager, as the JAX package calls it outside the LM: jit would let XLA
    # contract multiply-adds, which moves H by ~3e-4 of max|H| here
    H, g, c = (np.asarray(a) for a in jsoa.soa_normal_eq(
        obs.est0, jprep, jw2, jw3, jwg, jnp.asarray(NORMAL), jnp.asarray(K),
        huber))
    chi = np.asarray(jsoa.soa_chi2(obs.est0, jprep, jw2, jw3, jwg,
                                   jnp.asarray(NORMAL), jnp.asarray(K), huber))

    tobs, prep, w2, w3, wg, Kt = _port_inputs(obs, LMConfig(), True)
    np.testing.assert_array_equal(w2.numpy(), np.asarray(jw2))
    np.testing.assert_array_equal(w3.numpy(), np.asarray(jw3))
    n = torch.as_tensor(NORMAL)
    Ht, gt, ct = (a.numpy() for a in lm_soa.soa_normal_eq(
        tobs.est0, prep, w2, w3, wg, n, Kt, huber))
    chit = lm_soa.soa_chi2(tobs.est0, prep, w2, w3, wg, n, Kt, huber).numpy()

    O = H.shape[0]
    tol = 1e-4 * np.abs(H).reshape(O, -1).max(1) + 1e-30
    assert (np.abs(Ht - H).reshape(O, -1).max(1) <= tol).all()
    assert (np.abs(gt - g).max(1) <= tol).all()
    np.testing.assert_allclose(ct, c, rtol=1e-5)
    np.testing.assert_allclose(chit, chi, rtol=1e-5)


def test_visibility_gate_matches_jax():
    obs = _mixed_obs()
    jprep = jsoa.soa_prepare(obs.pose2d_cw, obs.bbox2d, obs.pose3d_wc,
                             obs.meas3d)
    # a tighter image than the cameras see, so the gate drops edges
    want = np.asarray(jsoa.soa_visibility2d(obs.est0, jprep[0], jprep[1],
                                            jnp.asarray(K), 200, 300))
    tobs = observations_from_numpy(_np(obs), device="cpu")
    prep = lm_soa.soa_prepare(tobs.pose2d_cw, tobs.bbox2d, tobs.pose3d_wc,
                              tobs.meas3d)
    got = lm_soa.soa_visibility2d(tobs.est0, prep.tcw, prep.qcw,
                                  torch.as_tensor(K), 200, 300).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want[np.asarray(obs.mask2d)].sum() < np.asarray(obs.mask2d).sum()


@pytest.mark.parametrize("case", ["gravity", "nan_huber_visibility"])
def test_optimize_objects_soa_matches_jax(case):
    obs = _mixed_obs(with_nan=case != "gravity")
    kw = {"gravity": dict(gravity_on=True, gravity_scale=100.0),
          "nan_huber_visibility": dict(gravity_on=False, huber_delta=5.0,
                                       check_visibility=True,
                                       vis_rows=200, vis_cols=300)}[case]
    est_j, chi_j = jsoa.optimize_objects_soa(
        obs, jnp.asarray(K), jnp.asarray(NORMAL), True, JLMConfig(**kw))
    launches = (ba_kernels.NORMAL_EQ.launches, ba_kernels.CHI2.launches)
    est_t, chi_t = lm_soa.optimize_objects_soa(
        observations_from_numpy(_np(obs), device="cpu"), torch.as_tensor(K),
        torch.as_tensor(NORMAL), True, LMConfig(**kw))
    # CPU tensors run the plain versions: no kernel launch
    assert (ba_kernels.NORMAL_EQ.launches, ba_kernels.CHI2.launches) \
        == launches
    np.testing.assert_allclose(est_t.numpy(), np.asarray(est_j), atol=2e-3)
    np.testing.assert_allclose(chi_t.numpy(), np.asarray(chi_j), rtol=1e-2,
                               atol=1e-3)
    # the empty slot keeps its initial estimate exactly
    np.testing.assert_array_equal(est_t.numpy()[3], np.asarray(obs.est0)[3])


def test_observations_from_numpy_types():
    arrays = _np(_mixed_obs())
    tobs = observations_from_numpy(arrays, device="cpu")
    for name, t in tobs._asdict().items():
        assert tuple(t.shape) == arrays[name].shape
        want = torch.bool if arrays[name].dtype == bool else torch.float32
        assert t.dtype == want, name
    del arrays["mask3d"]
    with pytest.raises(KeyError):
        observations_from_numpy(arrays, device="cpu")


def test_unsupported_device_raises():
    tobs, prep, w2, w3, wg, Kt = _port_inputs(_mixed_obs(), LMConfig(), True)
    meta = tobs.est0.to("meta")
    with pytest.raises(NotImplementedError):
        lm_soa.soa_chi2(meta, prep, w2, w3, wg, torch.zeros(3), Kt)


def test_converters_default_to_the_card():
    """observations_from_numpy and slam_ba.graph_from_numpy put their
    tensors on the CUDA device unless the caller names one, as every entry
    point of the port does: without a card the default raises."""
    from object_oriented_slam_tpu_torch.backend import slam_ba
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="not available"):
        observations_from_numpy(_np(_mixed_obs()))
    graph = dict(
        poses_cw=np.tile([0, 0, 0, 0, 0, 0, 1.0], (2, 1)),
        frame_mask=np.ones(2, bool),
        objects=np.array([[0, 0, 3, 0, 0, 0, 1, 0.5, 0.4, 0.3]]),
        obj_mask=np.ones(1, bool), e2_frame=[0], e2_obj=[0],
        e2_bbox=[[250.0, 200, 400, 320]], e2_w=[1.0], e3_frame=[1],
        e3_obj=[0], e3_meas=[[0, 0, 3, 0, 0, 0, 1, 0.5, 0.4, 0.3]],
        e3_w=[1.0], odo_i=[0], odo_j=[1],
        odo_meas=[[0, 0, 0, 0, 0, 0, 1.0]], odo_w=[1.0], grav_w=[0.0])
    with pytest.raises(RuntimeError, match="not available"):
        slam_ba.graph_from_numpy(graph)
    assert slam_ba.graph_from_numpy(graph, device="cpu").e2_w.device.type \
        == "cpu"
