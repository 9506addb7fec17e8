"""Port parity of the depth-slice ops against the JAX package, on the CPU.

Each op gets the same seeded numpy inputs on both sides.  The JAX
functions take one detection and are ``vmap``-ed; the port's take a
leading detection axis.  Masks, cells and labels must be EQUAL; floats are
held to 1e-5 (f32 round-off: XLA:CPU contracts multiply-adds, and sums run
in another order).  Clustering compares converged labels, never round
counts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_oriented_slam_tpu.core import plane as jplane
from object_oriented_slam_tpu.core.camera import Camera as JCamera
from object_oriented_slam_tpu.ops import backproject as jbp
from object_oriented_slam_tpu.ops import cluster as jcl
from object_oriented_slam_tpu.ops import linalg as jla
from object_oriented_slam_tpu.ops import pca as jpca
from object_oriented_slam_tpu.ops import voxel as jvx
from object_oriented_slam_tpu_torch.core import plane as tplane
from object_oriented_slam_tpu_torch.core.camera import Camera
from object_oriented_slam_tpu_torch.ops import backproject as tbp
from object_oriented_slam_tpu_torch.ops import cluster as tcl
from object_oriented_slam_tpu_torch.ops import linalg as tla
from object_oriented_slam_tpu_torch.ops import pca as tpca
from object_oriented_slam_tpu_torch.ops import voxel as tvx

torch.set_num_threads(1)    # the test workers share the CPU

CAM_KW = dict(fx=535.4, fy=539.2, cx=320.1, cy=247.6, scale=5000.0,
              width=160, height=120)
CAM, JCAM = Camera(**CAM_KW), JCamera(**CAM_KW)
TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _depth(seed=0):
    """A 120x160 depth image: a tilted floor, two boxes, holes and a far
    region beyond the depth range."""
    rng = np.random.RandomState(seed)
    v, u = np.mgrid[0:120, 0:160]
    d = 9000 + 20 * v + 5 * u + rng.randint(0, 40, (120, 160))
    d[30:80, 40:90] = 6000 + rng.randint(0, 60, (50, 50))
    d[60:110, 100:150] = 11000 + rng.randint(0, 200, (50, 50))
    d[rng.rand(120, 160) < 0.05] = 0
    d[:10, :] = 40000
    return d.astype(np.int32)


BBOXES = np.array([[40.6, 30.2, 90.9, 80.4], [95.0, 55.5, 159.0, 119.0],
                   [0.0, 0.0, 159.9, 119.9], [150.0, 100.0, 400.0, 300.0],
                   [20.0, 20.0, 20.0, 20.0]], np.float32)


def test_bbox_point_cloud_matches_jax():
    depth = _depth()
    pts, mask = tbp.bbox_point_cloud_plain(_t(depth), _t(BBOXES), CAM, 6.0)
    jpts, jmask = jax.vmap(lambda b: jbp.bbox_point_cloud(
        jnp.asarray(depth), b, JCAM, 6.0))(jnp.asarray(BBOXES))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), atol=TOL)
    assert mask[:3].sum(1).min() > 100 and not mask[4].any()


def test_center_estimate_matches_jax():
    depth = _depth()
    c, ok = tbp.center_estimate(_t(depth), _t(BBOXES), CAM, 6.0)
    jc, jok = jax.vmap(lambda b: jbp.center_estimate(
        jnp.asarray(depth), b, JCAM, 6.0))(jnp.asarray(BBOXES))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=TOL)
    assert ok[:3].all()


def test_full_point_cloud_matches_jax():
    depth = _depth()
    pts, mask = tbp.full_point_cloud(_t(depth), CAM, stride=4,
                                     depth_range=10.0)
    jpts, jmask = jbp.full_point_cloud(jnp.asarray(depth), JCAM, stride=4,
                                       depth_range=10.0)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), atol=TOL)


def _cloud():
    depth = _depth()
    pts, mask = tbp.bbox_point_cloud_plain(_t(depth), _t(BBOXES), CAM, 6.0)
    return pts.numpy(), mask.numpy()


@pytest.mark.parametrize("leaf,capacity", [(0.01, 2048), (0.01, 256),
                                           (0.1, 64)])
def test_voxel_downsample_cells_matches_jax(leaf, capacity):
    """Capacity 256 drops segments on the big boxes (same rule, same
    order); leaf 0.1 gives long runs (the centroid sums' order)."""
    pts, mask = _cloud()
    out, cells, m = tvx.voxel_downsample_cells(_t(pts), _t(mask), leaf,
                                               capacity)
    jout, jcells, jm = jax.vmap(lambda p, k: jvx.voxel_downsample_cells(
        p, k, leaf, capacity))(jnp.asarray(pts), jnp.asarray(mask))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(cells.numpy(), np.asarray(jcells))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL)
    out2, m2 = tvx.voxel_downsample(_t(pts), _t(mask), leaf, capacity)
    assert torch.equal(out2, out) and torch.equal(m2, m)
    if capacity == 256:
        assert m[2].all()           # truncated at the capacity
    key, cmin = tvx.voxel_keys(_t(pts), _t(mask), leaf)
    jkey, jcmin = jax.vmap(lambda p, k: jvx.voxel_keys(p, k, leaf))(
        jnp.asarray(pts), jnp.asarray(mask))
    np.testing.assert_array_equal(key.numpy(), np.asarray(jkey))
    np.testing.assert_array_equal(cmin.numpy()[:4], np.asarray(jcmin)[:4])


def _blobs(seed, n=384, n_blobs=4):
    """Seeded blobs on a 1.5 cm lattice (neighbours 1.5 cm apart, diagonal
    2.1 cm: no pair near the 2 cm radius), a bridge of lattice points
    between two of them, scattered singles and masked lanes."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((n, 3), np.float32)
    mask = np.zeros(n, bool)
    k = 0
    for b in range(n_blobs):
        origin = np.array([b * 0.5, rng.uniform(-1, 1), rng.uniform(1, 2)])
        side = rng.randint(3, 5)
        g = np.stack(np.meshgrid(*[np.arange(side)] * 3), -1).reshape(-1, 3)
        m = len(g)
        pts[k:k + m] = origin + 0.015 * g
        mask[k:k + m] = True
        if b == 1:                      # a chain reaching toward blob 2
            c = np.arange(1, 12)[:, None] * np.array([0.015, 0, 0])
            pts[k + m:k + m + 11] = origin + 0.015 * (side - 1) + c
            mask[k + m:k + m + 11] = True
            m += 11
        k += m
    pts[k:k + 6] = rng.uniform(3, 4, (6, 3))
    mask[k:k + 6] = True
    perm = rng.permutation(n)
    return pts[perm], mask[perm]


def _batch(seeds):
    p, m = zip(*[_blobs(s) for s in seeds])
    return np.stack(p), np.stack(m)


@pytest.mark.parametrize("chains", [-1, 0])
def test_connected_components_matches_jax(chains):
    pts, mask = _batch([0, 1, 2])
    lab, conv = tcl.connected_components(_t(pts), _t(mask), 0.02,
                                         outer_iters=96, with_converged=True,
                                         chains=chains)
    jlab, jconv = jax.vmap(lambda p, m: jcl.connected_components(
        p, m, 0.02, outer_iters=96, with_converged=True, chains=chains))(
        jnp.asarray(pts), jnp.asarray(mask))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
    assert conv.all() and np.asarray(jconv).all()
    # labels are the least index of each component
    for d in range(len(pts)):
        roots = np.unique(lab[d].numpy()[mask[d]])
        assert 5 <= len(roots) <= 12
        assert (lab[d].numpy()[roots] == roots).all()
        assert (lab[d].numpy()[~mask[d]] == pts.shape[1]).all()


def test_connected_components_reports_truncation():
    """A 60-point chain cannot settle in 2 rounds without seeding: the
    flag is False on both sides, True with the default bound."""
    n = 64
    pts = np.zeros((1, n, 3), np.float32)
    pts[0, :60, 0] = 0.015 * np.random.RandomState(0).permutation(60)
    mask = np.zeros((1, n), bool)
    mask[0, :60] = True
    for iters, want in ((2, False), (96, True)):
        _, conv = tcl.connected_components(_t(pts), _t(mask), 0.02,
                                           outer_iters=iters, jump_iters=1,
                                           with_converged=True, chains=0)
        _, jconv = jcl.connected_components(
            jnp.asarray(pts[0]), jnp.asarray(mask[0]), 0.02,
            outer_iters=iters, jump_iters=1, with_converged=True, chains=0)
        assert bool(conv[0]) == bool(jconv) == want


def test_components_compacted_matches_jax_and_full_width():
    pts, mask = _batch([3, 4])
    cap = 256
    assert mask.sum(1).max() <= cap
    # the port compacts to the survivors there are (no static lane count)
    lab = tcl.connected_components(_t(pts), _t(mask), 0.02, 96, 12)
    jlab = jax.vmap(lambda p, m: jcl.components_compacted(
        p, m, 0.02, 96, 12, cap))(jnp.asarray(pts), jnp.asarray(mask))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
    jfull = jax.vmap(lambda p, m: jcl.connected_components(
        p, m, 0.02, outer_iters=96))(jnp.asarray(pts), jnp.asarray(mask))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jfull))


@pytest.mark.parametrize("min_size,center_dis", [(20, 0.5), (20, 0.05),
                                                 (200, 0.5), (60, 0.01)])
def test_select_cluster_matches_jax(min_size, center_dis):
    """Largest near cluster; nothing near; nothing large enough; the
    single-cluster fallback."""
    pts, mask = _batch([5, 6, 7])
    lab = tcl.connected_components(_t(pts), _t(mask), 0.02, outer_iters=96)
    centers = np.stack([pts[d][mask[d]][0] + 0.02 for d in range(3)]
                       ).astype(np.float32)
    sel, ok = tcl.select_cluster(_t(pts), _t(mask), lab, _t(centers),
                                 min_size, center_dis)
    jsel, jok = jax.vmap(lambda p, m, l, c: jcl.select_cluster(
        p, m, l, c, min_size, center_dis))(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(lab.numpy()),
        jnp.asarray(centers))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))


def test_unported_cluster_options_raise():
    """The two options that raised before they were ported, against JAX on
    one blob cloud: interleaved chain passes (``chains=2``) and the exact
    broadcast pass (``exact=True``); labels and converged equal (the
    full sweep: tests/test_torch_cluster_options.py)."""
    pts, mask = _batch([0])
    for kw in (dict(chains=2), dict(exact=True)):
        lab, conv = tcl.connected_components(_t(pts), _t(mask), 0.02,
                                             outer_iters=96,
                                             with_converged=True, **kw)
        jlab, jconv = jcl.connected_components(
            jnp.asarray(pts[0]), jnp.asarray(mask[0]), 0.02, outer_iters=96,
            with_converged=True, **kw)
        np.testing.assert_array_equal(lab[0].numpy(), np.asarray(jlab))
        assert bool(conv[0]) and bool(jconv)


def _object_cloud(seed, n=600):
    rng = np.random.RandomState(seed)
    R = np.linalg.qr(rng.randn(3, 3))[0]
    pts = (rng.uniform(-1, 1, (n, 3)) * [0.4, 0.25, 0.15]) @ R.T \
        + rng.uniform(-2, 2, 3)
    return pts.astype(np.float32), rng.rand(n) < 0.8


def test_masked_pca_and_rotation_fixes_match_jax():
    pts, mask = (np.stack(x) for x in zip(*[_object_cloud(s)
                                            for s in range(4)]))
    normal = np.array([0.03, -0.02, 1.0], np.float32)
    res = tpca.masked_pca(_t(pts), _t(mask))
    jres = jax.vmap(jpca.masked_pca)(jnp.asarray(pts), jnp.asarray(mask))
    np.testing.assert_allclose(res.center.numpy(), np.asarray(jres.center),
                               atol=TOL)
    np.testing.assert_allclose(res.eigvals.numpy(), np.asarray(jres.eigvals),
                               rtol=1e-4, atol=1e-7)
    # eigenvectors up to the rounding of well-separated eigenvalues
    np.testing.assert_allclose(res.rot.numpy(), np.asarray(jres.rot),
                               atol=1e-4)
    # the covariance itself, on the same selection mask: 1e-5 relative
    w = mask[..., None].astype(np.float32)
    d = (pts - res.center.numpy()[:, None]) * w
    cov = np.einsum("dni,dnj->dij", d, d) / w.sum((1, 2))[:, None, None]
    vals = np.linalg.eigvalsh(cov.astype(np.float64))
    np.testing.assert_allclose(res.eigvals.numpy(), vals, rtol=1e-4)

    # the three rotation fixes, from the JAX side's rotation on both sides
    rot0 = np.asarray(jres.rot)
    vals0 = np.asarray(jres.eigvals)
    a = tpca.adjust_chirality(_t(rot0))
    ja = jax.vmap(jpca.adjust_chirality)(jnp.asarray(rot0))
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=TOL)
    b, bv = tpca.align_z_to_gravity(a, _t(vals0), _t(normal))
    jb, jbv = jax.vmap(lambda r, v: jpca.align_z_to_gravity(
        r, v, jnp.asarray(normal)))(ja, jnp.asarray(vals0))
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), atol=TOL)
    np.testing.assert_array_equal(bv.numpy(), np.asarray(jbv))
    c = tpca.calibrate_to_normal(b, _t(normal))
    jc = jax.vmap(lambda r: jpca.calibrate_to_normal(
        r, jnp.asarray(normal)))(jb)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=TOL)
    z = c.numpy()[:, :, 2]
    np.testing.assert_allclose(z, np.tile(normal / np.linalg.norm(normal),
                                          (4, 1)), atol=1e-5)
    rms, mx = tpca.normalized_frame_stats(_t(pts), _t(mask))
    jrms, jmx = jax.vmap(jpca.normalized_frame_stats)(jnp.asarray(pts),
                                                      jnp.asarray(mask))
    np.testing.assert_allclose(rms.numpy(), np.asarray(jrms), atol=TOL)
    np.testing.assert_array_equal(mx.numpy(), np.asarray(jmx))


def test_calibrate_to_normal_degenerate_is_identity():
    rot = np.eye(3, dtype=np.float32)[None]
    n = np.array([0.0, 0.0, 1.0], np.float32)
    np.testing.assert_array_equal(
        tpca.calibrate_to_normal(_t(rot), _t(n)).numpy(), rot)


def _sym(seed, n=32):
    rng = np.random.RandomState(seed)
    M = rng.randn(n, 3, 3).astype(np.float32)
    A = M @ M.transpose(0, 2, 1)
    A[0] = 2.5 * np.eye(3)                              # isotropic
    A[1] = np.diag([1.0, 1.0, 3.0])                     # repeated low pair
    A[2] = np.diag([1.0, 3.0, 3.0])                     # repeated high pair
    A[3] *= 1e-6                                        # mm-scale covariance
    Q = np.linalg.qr(rng.randn(3, 3))[0].astype(np.float32)
    A[4] = Q @ np.diag([1.0, 1.0, 3.0]).astype(np.float32) @ Q.T
    A[5] = Q @ np.diag([0.5, 2.0, 2.0]).astype(np.float32) @ Q.T
    return A


def test_eigh3_matches_jax_branch_for_branch():
    A = _sym(0)
    vals, vecs = tla.eigh3(_t(A))
    jvals, jvecs = jax.vmap(jla.eigh3)(jnp.asarray(A))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=1e-5,
                               atol=1e-6)
    # generic matrices: same vectors; the degenerate ones (any basis of the
    # repeated eigenspace is valid) are held by A v = lambda v below
    np.testing.assert_allclose(vecs.numpy()[6:], np.asarray(jvecs)[6:],
                               atol=1e-4)
    np.testing.assert_array_equal(vecs.numpy()[0], np.eye(3))
    v = vecs.numpy().astype(np.float64)
    np.testing.assert_allclose(np.einsum("nji,njk->nik", v, v),
                               np.tile(np.eye(3), (len(A), 1, 1)), atol=1e-5)
    scale = np.abs(A).reshape(len(A), -1).max(1)[:, None, None]
    np.testing.assert_allclose(
        np.einsum("nij,njk->nik", A.astype(np.float64), v) / scale,
        v * vals.numpy()[:, None, :] / scale, atol=2e-5)
    ref = np.linalg.eigvalsh(A.astype(np.float64))
    top = np.abs(ref).max(1, keepdims=True)
    np.testing.assert_allclose(vals.numpy() / top, ref / top, atol=1e-5)


def test_small_linalg_matches_jax():
    rng = np.random.RandomState(1)
    m3 = rng.randn(16, 3, 3).astype(np.float32)
    v3 = rng.randn(16, 3).astype(np.float32)
    m4 = rng.randn(16, 4, 4).astype(np.float32)
    np.testing.assert_allclose(tla.det3(_t(m3)).numpy(),
                               np.asarray(jla.det3(jnp.asarray(m3))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tla.solve3(_t(m3), _t(v3)).numpy(),
        np.asarray(jla.solve3(jnp.asarray(m3), jnp.asarray(v3))),
        rtol=1e-4, atol=1e-5)
    inv = tla.inv4(_t(m4)).numpy()
    np.testing.assert_allclose(inv, np.asarray(jla.inv4(jnp.asarray(m4))),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(inv.astype(np.float64) @ m4,
                               np.tile(np.eye(4), (16, 1, 1)), atol=1e-3)
    assert np.isfinite(tla.inv4(torch.zeros(4, 4)).numpy()).all()


PI = np.array([0.1, -0.9, 0.3, 1.2], np.float32)
PTS = np.random.RandomState(2).randn(7, 3).astype(np.float32)
POSE = np.array([0.3, -1.2, 0.8, 0.1, -0.2, 0.3, 0.927], np.float32)
POSE[3:] /= np.linalg.norm(POSE[3:])
V3 = np.array([0.1, 0.2, 0.05], np.float32)


@pytest.mark.parametrize("name,args", [
    ("from_point_normal", (PTS[0], PI[:3])),
    ("from_dis_angle", (np.float32(0.7), np.float32(0.4))),
    ("distance_to_point", (PI, PTS)),
    ("distance_to_point_signed", (PI, PTS)),
    ("distance_to_point_single", (PI, PTS[0])),
    ("transform", (PI, POSE)),
    ("normalize", (PI,)),
    ("azimuth", (PI,)),
    ("distance", (PI,)),
    ("oplus", (PI, V3)),
    ("oplus_2dof", (PI, V3[:2])),
    ("oplus_dual", (PI, np.float32(0.4), V3)),
    ("dual_other_plane", (PI, np.float32(0.4))),
    ("mirror_points", (PI, PTS)),
])
def test_plane_matches_jax(name, args):
    kw = {"keep_flag": True} if name.endswith("_signed") else {}
    fn = name.replace("_signed", "").replace("_single", "")
    got = getattr(tplane, fn)(*[_t(a) for a in args], **kw)
    want = getattr(jplane, fn)(*[jnp.asarray(a) for a in args], **kw)
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        # transform: the closed-form 4x4 inverse against a pivoted solve
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=1e-5)


def test_plane_transform_moves_points_with_the_plane():
    """pi' . (T x) = pi . x for points on the plane."""
    from object_oriented_slam_tpu_torch.core import se3
    pi = _t(PI)
    on = _t(PTS) - (tplane.distance_to_point(pi, _t(PTS), True)[:, None]
                    * pi[:3] / torch.sqrt((pi[:3] ** 2).sum()))
    moved = on @ se3.quat_to_mat(_t(POSE[3:])).T + _t(POSE[:3])
    d = tplane.distance_to_point(tplane.transform(pi, _t(POSE)), moved)
    assert float(d.max()) < 1e-5
