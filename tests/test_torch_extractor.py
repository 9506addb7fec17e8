"""Port parity of the depth frontend against the JAX package, on the CPU:
``estimate_ground_plane`` and ``extract_local_ellipsoids`` on one rendered
frame (the SAME depth array goes to both sides, so the renderers'
differences stay out), stage by stage and as a whole.

Small size: ``cloud_capacity=2048``, ``cluster_min_size=30``, three
detections.  Stage outputs: masks, cells and labels EQUAL, floats 1e-5.
Whole frame: valid flags equal, centre 1e-3, sorted scale 2e-3, the z
axis of the local frame 1e-3 (raw quaternions are not compared: a near
z-symmetric cluster may flip its yaw).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_oriented_slam_tpu.core import plane as jplane
from object_oriented_slam_tpu.core.camera import Camera as JCamera
from object_oriented_slam_tpu.frontend import extractor as jext
from object_oriented_slam_tpu.frontend import ground_plane as jgp
from object_oriented_slam_tpu_torch.core import se3
from object_oriented_slam_tpu_torch.frontend import extractor as text
from object_oriented_slam_tpu_torch.frontend import ground_plane as tgp
from object_oriented_slam_tpu_torch.io import synthetic as tsyn

torch.set_num_threads(1)    # the test workers share the CPU

KW = dict(cloud_capacity=2048, cluster_min_size=30)
TOL = 1e-5


@pytest.fixture(scope="module")
def frame():
    scene = tsyn.make_scene(n_objects=6, seed=7, radius_range=(1.3, 2.2),
                            scale_range=(0.2, 0.4))
    ds = tsyn.SyntheticDataset(scene, n_frames=12, orbit_radius=3.6,
                               height=1.7)
    i, ts, pose, depth, rgb, det = list(ds.frames())[3]
    cam = scene.camera
    jcam = JCamera(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                   scale=cam.scale, width=cam.width, height=cam.height)
    assert len(det) >= 3
    return dict(depth=depth, pose=pose.astype(np.float32),
                bboxes=det[:3, 1:5].astype(np.float32), cam=cam, jcam=jcam,
                plane=np.array([0.0, 0.0, 1.0, 0.0], np.float32))


def test_estimate_ground_plane_matches_jax(frame):
    got, ok = tgp.estimate_ground_plane(torch.from_numpy(frame["depth"]),
                                        frame["cam"],
                                        tgp.GroundPlaneConfig())
    want, jok = jgp.estimate_ground_plane(jnp.asarray(frame["depth"]),
                                          frame["jcam"],
                                          jgp.GroundPlaneConfig())
    assert bool(ok) and bool(jok)
    # the inlier sets may differ by a pixel at the thresholds: 1e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    # and it is the floor z = 0 seen from the camera: to world, 2 deg, 2 cm
    pw = np.asarray(jplane.transform(jnp.asarray(got.numpy()),
                                     jnp.asarray(frame["pose"])))
    assert np.degrees(np.arccos(min(1.0, abs(pw[2])
                                    / np.linalg.norm(pw[:3])))) < 2.0
    assert abs(pw[3]) < 0.02


def test_plane_estimator_adapter(frame):
    est = tgp.make_plane_estimator(frame["cam"], device="cpu")
    plane = est(frame["depth"])
    assert plane.dtype == np.float64 and plane.shape == (4,)
    assert est.resolve(est.dispatch(frame["depth"])) is not None
    # a depth image without a floor gives no plane
    assert est(np.zeros_like(frame["depth"])) is None


def _args(f):
    t = [torch.from_numpy(np.array(f[k])) for k in ("depth", "bboxes")]
    j = [jnp.asarray(f[k]) for k in ("depth", "bboxes")]
    return t, j


def test_stage_outputs_match_jax(frame):
    f = frame
    tcfg, jcfg = text.ExtractorConfig(**KW), jext.ExtractorConfig(**KW)
    (td, tb), (jd, jb) = _args(f)
    pose_t, plane_t = torch.from_numpy(f["pose"]), torch.from_numpy(f["plane"])
    pose_j, plane_j = jnp.asarray(f["pose"]), jnp.asarray(f["plane"])

    # stages (a)-(c)
    a = text._stage_a(td, tb, pose_t, plane_t, f["cam"], tcfg)
    ja = jax.vmap(lambda b: jext._stage_a_one(jd, b, pose_j, plane_j,
                                              f["jcam"], jcfg))(jb)
    names = ("pts_v", "pts_w", "cells_v", "m2", "center_w", "ok_points",
             "ok_center")
    for name, g, w in zip(names, a, ja):
        w = np.asarray(w)
        if g.dtype in (torch.bool, torch.int32):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), w, atol=TOL, err_msg=name)
    pts_w, m2, center_w = a[1], a[3], a[4]
    assert m2.sum(1).min() > 200

    # stage (d), from the port's stage (a) outputs on both sides
    st = {}
    sel, ok = text._cluster_select_batch(pts_w, m2, center_w, a[7], tcfg, st)
    jsel, jok = jext._cluster_select_batch(
        ja[0], jnp.asarray(pts_w.numpy()), ja[2], jnp.asarray(m2.numpy()),
        jnp.asarray(center_w.numpy()), f["jcam"], jcfg)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    assert st["cluster_converged"] and 1 < st["cluster_rounds"] < 96
    # the pass works on each detection's own survivors: the lanes are the
    # largest survivor count
    assert 200 < st["cluster_survivors"] == st["cluster_lanes"] <= 2048

    # stages (e)-(f)
    Two, pts_n, obj_m, _ = text._stage_post(pts_w, sel, plane_t, tcfg)
    jTwo, jpts_n, jobj_m, _ = jax.vmap(lambda p, s: jext._stage_post_one(
        p, s, None, pose_j, plane_j, f["jcam"], jcfg))(
        jnp.asarray(pts_w.numpy()), jnp.asarray(sel.numpy()))
    v = ok.numpy()
    np.testing.assert_array_equal(obj_m.numpy(), np.asarray(jobj_m))
    np.testing.assert_allclose(Two.numpy()[v, :3], np.asarray(jTwo)[v, :3],
                               atol=TOL)
    # the x axis comes from eigh3 of the cluster's covariance: 1e-4
    np.testing.assert_allclose(Two.numpy()[v], np.asarray(jTwo)[v], atol=1e-4)
    np.testing.assert_allclose(pts_n.numpy()[v], np.asarray(jpts_n)[v],
                               atol=1e-4)


def test_extract_local_ellipsoids_matches_jax(frame):
    f = frame
    (td, tb), (jd, jb) = _args(f)
    run = np.array([True, True, True])
    e, p, v, dbg = text.extract_local_ellipsoids(
        td, tb, torch.from_numpy(run), torch.from_numpy(f["pose"]),
        torch.from_numpy(f["plane"]), f["cam"], text.ExtractorConfig(**KW))
    je, jp, jv, _ = jext.extract_local_ellipsoids(
        jd, jb, jnp.asarray(run), jnp.asarray(f["pose"]),
        jnp.asarray(f["plane"]), f["jcam"], jext.ExtractorConfig(**KW))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    assert v.sum() >= 2
    ok = v.numpy()
    e, je = e.numpy()[ok], np.asarray(je)[ok]
    np.testing.assert_allclose(e[:, :3], je[:, :3], atol=1e-3)
    np.testing.assert_allclose(np.sort(e[:, 7:]), np.sort(je[:, 7:]),
                               atol=2e-3)
    z = se3.quat_to_mat(torch.from_numpy(e[:, 3:7]))[:, :, 2].numpy()
    jz = se3.quat_to_mat(torch.from_numpy(je[:, 3:7]))[:, :, 2].numpy()
    np.testing.assert_allclose(z, jz, atol=1e-3)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))


def test_empty_bbox_and_run_mask_are_rejected(frame):
    """A bbox over the sky (no depth) and a detection the run mask turns
    off come back invalid; the others keep their result."""
    f = frame
    bboxes = np.concatenate([f["bboxes"][:2],
                             np.array([[300.0, 5.0, 340.0, 30.0]],
                                      np.float32)])
    assert (f["depth"][5:30, 300:340] == 0).all()
    run = torch.tensor([True, False, True])
    e, p, v, _ = text.extract_local_ellipsoids(
        torch.from_numpy(f["depth"]), torch.from_numpy(bboxes), run,
        torch.from_numpy(f["pose"]), torch.from_numpy(f["plane"]), f["cam"],
        text.ExtractorConfig(**KW))
    assert not v[1] and not v[2]
    assert torch.isfinite(e).all()


def test_monolithic_extractor_packs_pad_by_12(frame):
    f = frame
    ex = text.make_extractor(f["cam"], text.ExtractorConfig(**KW),
                             device="cpu")
    out = ex(f["depth"], f["bboxes"], np.array([56, 57, 58]),
             f["pose"].astype(np.float64), f["plane"].astype(np.float64))
    assert isinstance(out, text.ExtractionHandle)
    rows = out.rows
    assert isinstance(rows, torch.Tensor) and tuple(rows.shape) == (4, 12)
    assert not rows[3, 11] and set(rows[:, 11].tolist()) <= {0.0, 1.0}
    assert ex.stats["cloud_tier"] in (1024, 2048)
    # the clustering counts ride the result's copy: there after the fetch
    assert "cluster_rounds" not in ex.stats
    host = ex.fetch(out)
    np.testing.assert_array_equal(host, rows.numpy().astype(np.float64))
    assert 2 <= ex.stats["cluster_rounds"] < 96 and ex.stats["cluster_converged"]
    assert 200 < ex.stats["cluster_survivors"] == ex.stats["cluster_lanes"]
    assert ex(f["depth"], f["bboxes"], None, f["pose"], None) is None
    e, p, v, _ = text.extract_local_ellipsoids(
        torch.from_numpy(f["depth"]), torch.from_numpy(f["bboxes"]),
        torch.ones(3, dtype=torch.bool), torch.from_numpy(f["pose"]),
        torch.from_numpy(f["plane"]), f["cam"],
        text.ExtractorConfig(**dict(KW, cloud_capacity=ex.stats["cloud_tier"])))
    np.testing.assert_allclose(rows[:3, :10].numpy(), e.numpy(), atol=1e-6)


@pytest.mark.parametrize("bboxes,want", [
    ([[0, 0, 30, 30]], 1024), ([[0, 0, 300, 200]], 8192),
    ([[0, 0, 639, 479]], 16384), ([[10, 10, 100, 100], [0, 0, 200, 150]], 4096)])
def test_cloud_tier_matches_jax(bboxes, want):
    bb = np.asarray(bboxes, np.float64)
    run = np.ones(len(bb), bool)
    got = text._cloud_tier(bb, run, 480, 640, 16384)
    assert got == jext._cloud_tier(bb, run, 480, 640, 16384) == want


@pytest.mark.parametrize("option", [
    dict(open_symmetry=True),
    dict(open_symmetry=True, sym_analytic_grad=False)])
def test_symmetry_options_run(option, frame):
    """Symmetry completion, with the exact gradient and with central
    differences: make_extractor accepts it and a call (label 57 is a
    reflection) returns finite results with a search prob below 1."""
    ex = text.make_extractor(frame["cam"],
                             text.ExtractorConfig(**KW, **option),
                             device="cpu")
    host = ex.fetch(ex(frame["depth"], frame["bboxes"],
                       np.array([56, 57, 58]), frame["pose"].astype(float),
                       frame["plane"].astype(float)))
    assert np.isfinite(host).all() and (host[:3, 11] > 0.5).sum() >= 2
    assert ex.stats["sym_single"] == 1 and ex.stats["sym_dual"] == 0
    assert host[0, 10] == 1 and host[2, 10] == 1 and 0 < host[1, 10] <= 1


@pytest.mark.parametrize("option", [
    dict(grid_cluster=True),
    dict(cluster_chains=2), dict(compact_tiers=False),
    dict(compact_rungs=(8, 16))])
def test_unported_extractor_options_raise(option, frame):
    """The clustering options that raised before they were ported, now
    held against JAX's extractor with the same option on the frame, at the
    whole-frame tolerances of ``test_extract_local_ellipsoids_matches_jax``:
    the grid pass (its gate passes here), interleaved chain passes, and the
    compaction ladder's fields, which the port takes and ignores (at this
    frame's tier 2048 JAX's ladder does not run either; at 4096, where it
    does: tests/test_torch_cluster_options.py).  ``make_extractor`` takes
    each option and its rows are the same call's."""
    f = frame
    cfg = text.ExtractorConfig(**KW, **option)
    jcfg = jext.ExtractorConfig(**KW, **option)
    assert text._grid_clustering_ok(f["cam"], cfg) == \
        jext._grid_clustering_ok(f["jcam"], jcfg) == ("grid_cluster" in option)
    (td, tb), (jd, jb) = _args(f)
    run = np.array([True, True, True])
    e, p, v, _ = text.extract_local_ellipsoids(
        td, tb, torch.from_numpy(run), torch.from_numpy(f["pose"]),
        torch.from_numpy(f["plane"]), f["cam"], cfg)
    je, jp, jv, _ = jext.extract_local_ellipsoids(
        jd, jb, jnp.asarray(run), jnp.asarray(f["pose"]),
        jnp.asarray(f["plane"]), f["jcam"], jcfg)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    assert v.sum() >= 2
    ok = v.numpy()
    e_ok, je_ok = e.numpy()[ok], np.asarray(je)[ok]
    np.testing.assert_allclose(e_ok[:, :3], je_ok[:, :3], atol=1e-3)
    np.testing.assert_allclose(np.sort(e_ok[:, 7:]), np.sort(je_ok[:, 7:]),
                               atol=2e-3)
    z = se3.quat_to_mat(torch.from_numpy(e_ok[:, 3:7]))[:, :, 2].numpy()
    jz = se3.quat_to_mat(torch.from_numpy(je_ok[:, 3:7]))[:, :, 2].numpy()
    np.testing.assert_allclose(z, jz, atol=1e-3)
    ex = text.make_extractor(f["cam"], cfg, device="cpu")
    host = ex.fetch(ex(f["depth"], f["bboxes"], np.array([56, 57, 58]),
                       f["pose"].astype(float), f["plane"].astype(float)))
    assert ex.stats["cloud_tier"] == 2048 and ex.stats["cluster_converged"]
    np.testing.assert_allclose(host[:3, :10], e.numpy(), atol=1e-6)


def test_extractor_config_has_the_jax_fields_and_defaults():
    got = {f.name: f.default for f in
           text.dataclasses.fields(text.ExtractorConfig)}
    want = {f.name: f.default for f in
            jext.dataclasses.fields(jext.ExtractorConfig)}
    assert got == want
    tg = {f.name: f.default for f in
          tgp.dataclasses.fields(tgp.GroundPlaneConfig)}
    jg = {f.name: f.default for f in
          jgp.dataclasses.fields(jgp.GroundPlaneConfig)}
    assert tg == jg


def test_extractor_and_plane_estimator_default_to_cuda(frame):
    """Like System, the two factories run on the card unless the caller
    names a device; without a card they raise, naming the device."""
    cfg = text.ExtractorConfig(**KW)
    if torch.cuda.is_available():
        assert text.make_extractor(frame["cam"], cfg).device.type == "cuda"
        assert tgp.make_plane_estimator(frame["cam"]).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            text.make_extractor(frame["cam"], cfg)
        with pytest.raises(RuntimeError, match="cuda"):
            tgp.make_plane_estimator(frame["cam"])
    assert text.make_extractor(frame["cam"], cfg,
                               device="cpu").device.type == "cpu"


def _z_angle_deg(q1, q2):
    z1 = se3.quat_to_mat(torch.as_tensor(q1, dtype=torch.float32))[:, 2]
    z2 = se3.quat_to_mat(torch.as_tensor(q2, dtype=torch.float32))[:, 2]
    return float(torch.rad2deg(torch.acos((z1 * z2).sum().abs().clamp(max=1))))


@pytest.fixture(scope="module")
def default_extraction(frame):
    """The port's extractor at its defaults (capacity tiered per frame,
    minimum cluster size 100) on the frame's first three detections."""
    ex = text.make_extractor(frame["cam"], text.ExtractorConfig(),
                             device="cpu")
    out = ex(frame["depth"], frame["bboxes"], np.array([56, 57, 58]),
             frame["pose"].astype(np.float64),
             frame["plane"].astype(np.float64))
    out = ex.fetch(out)
    assert (out[:3, 11] > 0.5).sum() >= 2
    return out


@pytest.mark.parametrize("det", [0, 1, 2])
def test_extraction_matches_f64_oracle(frame, default_extraction, det):
    """Second check that needs no framework: the f64 numpy replica of
    EstimateLocalEllipsoid (tests/oracle_frontend.py, PCL-style voxel grid
    and KdTree clustering), with the JAX package's own oracle tolerances
    (tests/test_reference_oracle.py): centre and scales 2 cm, z axis 2 deg,
    the same validity."""
    import oracle_frontend as orc
    res = orc.estimate_local_ellipsoid(
        frame["depth"].astype(np.int64), frame["bboxes"][det], 56,
        frame["pose"].astype(np.float64), frame["jcam"],
        frame["plane"].astype(np.float64), open_symmetry=False)
    got = default_extraction[det]
    assert bool(got[11] > 0.5) == bool(res.ok)
    if not res.ok:
        return
    np.testing.assert_allclose(got[:3], res.e_local[:3], atol=0.02)
    np.testing.assert_allclose(sorted(got[7:9]), sorted(res.e_local[7:9]),
                               atol=0.02)
    assert abs(got[9] - res.e_local[9]) < 0.02
    assert _z_angle_deg(got[3:7], res.e_local[3:7]) < 2.0
    assert got[10] == 1.0


def test_ground_plane_matches_f64_oracle(frame):
    import oracle_frontend as orc
    want = orc.extract_ground_plane_oracle(frame["depth"].astype(np.int64),
                                           frame["jcam"])
    assert want is not None
    got = tgp.make_plane_estimator(frame["cam"], device="cpu")(frame["depth"])
    n_o, n_t = want[:3] / np.linalg.norm(want[:3]), \
        got[:3] / np.linalg.norm(got[:3])
    assert np.degrees(np.arccos(np.clip(n_o @ n_t, -1, 1))) < 3.0
    assert abs(want[3] / np.linalg.norm(want[:3])
               - got[3] / np.linalg.norm(got[:3])) < 0.05
