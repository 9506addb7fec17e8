"""Port parity of sparse symmetry and of the map-metric modules against the
JAX package on the CPU.

Sparse symmetry (``ExtractorConfig.sparse_symmetry``, the reference's
``Symmetry::SetBorders``): each back-projected point carries its
depth-border flag (``ops/filters.depth_border_mask``, sampled by
``ops/backproject.bbox_pixel_lookup``), averaged per voxel by both
downsamples (``ops/voxel.voxel_downsample_full`` / ``_attrs``); the object
cells whose mean exceeds 0.3 are the only points mirrored and scored by the
symmetry cost (``frontend/symmetry`` with ``src_mask``), while every live
cell stays the 1-NN reference.  Inputs are made with numpy from a seed (or
rendered once by the port) and go to both sides.

Tolerances: the border map, the pixel lookup, the voxel attribute means,
masks and cells EQUAL (the flags are 0/1 and their sums exact; the port
sums in sorted order like XLA:CPU's scatter-add); the points of the
downsamples 1e-6 and the stage (a)-(c) cloud as tests/test_torch_depth_cloud.py
(1e-5); the cost 1e-5 relative and its gradient 1e-4 relative to its
largest component (tests/test_torch_symmetry.py's); the extractor's outputs
at that file's tolerances (centres 1e-3, sorted scales 2e-3, Two 1e-4, prob
1e-5); the 8-frame run within 2e-3.  The central-difference extraction
meets the open fault of ROADMAP.md queue 3 (the 9-plane LM's f32 Cholesky)
and is marked as tests/test_torch_symmetry.py marks it, with its measured
size.

The metric modules: ``ops/polygon`` (tests/test_polygon.py's cases, 1e-5
against JAX), ``system/metrics`` (``object_map_iou`` 1e-5, ``ate_rmse`` and
``timing_summary`` to the double), ``ops/filters``' two other masks
(tests/test_aux.py's inputs, masks equal).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_oriented_slam_tpu.core import ellipsoid as jell
from object_oriented_slam_tpu.core.camera import Camera as JCamera
from object_oriented_slam_tpu.frontend import extractor as jext
from object_oriented_slam_tpu.frontend import symmetry as jsym
from object_oriented_slam_tpu.ops import backproject as jbp
from object_oriented_slam_tpu.ops import filters as jfl
from object_oriented_slam_tpu.ops import polygon as jpg
from object_oriented_slam_tpu.ops import voxel as jvx
from object_oriented_slam_tpu.system import metrics as jmt
from object_oriented_slam_tpu_torch.core.camera import Camera
from object_oriented_slam_tpu_torch.frontend import (ExtractorConfig,
                                                     make_extractor)
from object_oriented_slam_tpu_torch.frontend import extractor as text
from object_oriented_slam_tpu_torch.frontend import symmetry as tsym
from object_oriented_slam_tpu_torch.io import synthetic as tsyn
from object_oriented_slam_tpu_torch.ops import backproject as tbp
from object_oriented_slam_tpu_torch.ops import depth_cloud as tdc
from object_oriented_slam_tpu_torch.ops import filters as tfl
from object_oriented_slam_tpu_torch.ops import frontend_kernels as fk
from object_oriented_slam_tpu_torch.ops import polygon as tpg
from object_oriented_slam_tpu_torch.ops import voxel as tvx
from object_oriented_slam_tpu_torch.system import metrics as tmt

CAM = Camera(fx=535.4, fy=539.2, cx=320.1, cy=247.6, scale=5000.0)
JCAM = JCamera(fx=535.4, fy=539.2, cx=320.1, cy=247.6, scale=5000.0)
SIGMA = 0.1
PLANE = np.array([0.001, -0.002, 1.0, -0.0005], np.float32)
# the symmetry scene of tests/test_torch_symmetry.py: two dual reflections
# (28), three reflections and one object without a prior
LABELS = [28, 57, 58, 28, 63, 59]


def _t(a):
    return torch.from_numpy(np.array(a))


def _scene(labels=None):
    sc = tsyn.make_scene(n_objects=6, seed=7, radius_range=(1.3, 2.2),
                         scale_range=(0.2, 0.4), labels=labels)
    cam = sc.camera
    jcam = JCamera(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                   scale=cam.scale, width=cam.width, height=cam.height)
    return sc, cam, jcam


@pytest.fixture(scope="module")
def rendered():
    """Frame 3 of the 6-object depth scene's orbit, with its boxes and four
    more: the whole image, a zero box, a box over the sky and one past the
    image's right and bottom edges."""
    sc, cam, jcam = _scene()
    frames = list(tsyn.SyntheticDataset(sc, n_frames=12, orbit_radius=3.6,
                                        height=1.7).frames())
    _, _, pose, depth, _, det = frames[3]
    extra = np.array([[0, 0, 640, 480], [0, 0, 0, 0], [300, 5, 340, 30],
                      [560.3, 380.6, 700, 520]], np.float32)
    bboxes = np.concatenate([det[:, 1:5].astype(np.float32), extra])
    return dict(depth=np.asarray(depth, np.int32), bboxes=bboxes,
                pose=pose.astype(np.float32), cam=cam, jcam=jcam)


def _edge_depth():
    """A 48 x 64 image whose discontinuities touch the edges: the first
    column 1 m nearer than the last (their rows are neighbours through the
    wrap), the top row without depth, a step inside."""
    rng = np.random.default_rng(4)
    d = 10000 + rng.integers(0, 40, (48, 64))
    d[:, 0] -= 5000
    d[0, :] = 0
    d[20:30, 20:40] = 7000
    return d.astype(np.int32)


@pytest.mark.parametrize("which", ["rendered", "edges"])
def test_depth_border_mask_matches_jax(rendered, which):
    depth = rendered["depth"] if which == "rendered" else _edge_depth()
    got = tfl.depth_border_mask(_t(depth), 5000.0).numpy()
    want = np.asarray(jfl.depth_border_mask(jnp.asarray(depth), 5000.0))
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()
    if which == "edges":
        # the wrap: the first and last columns are neighbours, and row 1
        # borders the depthless row 0 and the last row through it
        assert got[5, 0] and got[5, -1] and got[1, 10] and got[-1, 10]
        assert not got[10, 10]


def test_bbox_pixel_lookup_matches_jax(rendered):
    rng = np.random.default_rng(11)
    for attr in (rng.random((480, 640)).astype(np.float32),
                 rng.random((480, 640)) < 0.3):
        got = tbp.bbox_pixel_lookup(_t(attr), _t(rendered["bboxes"]))
        want = np.stack([np.asarray(jbp.bbox_pixel_lookup(
            jnp.asarray(attr), jnp.asarray(b))) for b in rendered["bboxes"]])
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def test_bbox_pixel_lookup_aligns_with_point_grid():
    """tests/test_sparse_symmetry.py's case on the port: the lookup samples
    the same strided pixels as bbox_point_cloud_plain."""
    rng = np.random.default_rng(11)
    depth = np.zeros((480, 640), np.int32)
    depth[50:200, 100:300] = 5000
    attr = rng.random((480, 640)).astype(np.float32)
    bbox = _t(np.array([[100, 50, 300, 200]], np.float32))
    pts, m = tbp.bbox_point_cloud_plain(_t(depth), bbox, CAM, 6.0)
    a = tbp.bbox_pixel_lookup(_t(attr), bbox)[0].numpy()
    pts, m = pts[0].numpy(), m[0].numpy()
    z = pts[m][:, 2]
    u = np.rint(pts[m][:, 0] * CAM.fx / z + CAM.cx).astype(int)
    v = np.rint(pts[m][:, 1] * CAM.fy / z + CAM.cy).astype(int)
    np.testing.assert_allclose(a[m], attr[v, u], rtol=1e-6)


def _stage_a_border(rendered, capacity=4096):
    f = rendered
    got, battr = tdc.depth_cloud_border_plain(
        _t(f["depth"]), _t(f["bboxes"]), _t(f["pose"]), _t(PLANE), f["cam"],
        0.01, 6.0, 0.05, capacity)
    border = jfl.depth_border_mask(jnp.asarray(f["depth"]), f["cam"].scale)
    jcfg = jext.ExtractorConfig(cloud_capacity=capacity)
    want = jax.vmap(lambda b: jext._stage_a_one(
        jnp.asarray(f["depth"]), b, jnp.asarray(f["pose"]),
        jnp.asarray(PLANE), f["jcam"], jcfg, border_map=border))(
        jnp.asarray(f["bboxes"]))
    return got, battr, want


@pytest.mark.parametrize("capacity", [4096, 1024])
def test_stage_a_with_border_matches_jax(rendered, capacity):
    """Stages (a)-(c) with the border attribute (depth_cloud_border_plain)
    against JAX _stage_a_one(border_map=...): the voxels' border means
    equal, the cloud as tests/test_torch_depth_cloud.py holds it;
    capacity 1024 drops segments of the large boxes."""
    got, battr, want = _stage_a_border(rendered, capacity)
    pairs = (("pts_v", got.pts_v, 0), ("pts_w", got.pts_w, 1),
             ("cells_v", got.cells_v, 2), ("m2", got.m2, 3),
             ("center_w", got.center_w, 4), ("ok_points", got.ok_points, 5),
             ("ok_center", got.ok_center, 6), ("battr_v", battr, 7))
    for name, g, k in pairs:
        w = np.asarray(want[k])
        if g.dtype in (torch.bool, torch.int32) or name == "battr_v":
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), w, atol=1e-5, err_msg=name)
    live = got.pts_v[..., 2] > 0
    assert int((battr > 0).sum()) > 50 and bool((battr[live] < 1).any())
    assert not bool(battr[~live].any())
    # without the lane: the same cloud, bit for bit
    plain = tdc.depth_cloud_plain(
        _t(rendered["depth"]), _t(rendered["bboxes"]), _t(rendered["pose"]),
        _t(PLANE), rendered["cam"], 0.01, 6.0, 0.05, capacity)
    for g, w in zip(got, plain):
        assert torch.equal(g, w)


@pytest.mark.parametrize("leaf,capacity", [(0.1, 512), (0.05, 64)])
def test_voxel_downsample_attrs_matches_jax(rendered, leaf, capacity):
    """The object downsample with the voxels' border means as the attribute
    (JAX voxel_downsample_full / _attrs): masks, cells and attribute means
    equal, points 1e-6; capacity 64 drops segments."""
    got, battr, _ = _stage_a_border(rendered)
    pts, mask = got.pts_w, got.m2
    full = tvx.voxel_downsample_full(pts, battr, mask, leaf, capacity)
    short = tvx.voxel_downsample_attrs(pts, battr, mask, leaf, capacity)
    args = (jnp.asarray(pts.numpy()), jnp.asarray(battr.numpy()),
            jnp.asarray(mask.numpy()))
    jfull = jax.vmap(lambda p, a, m: jvx.voxel_downsample_full(
        p, a, m, leaf, capacity))(*args)
    jshort = jax.vmap(lambda p, a, m: jvx.voxel_downsample_attrs(
        p, a, m, leaf, capacity))(*args)
    for g, w in zip(full[1:], jfull[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(full[0].numpy(), np.asarray(jfull[0]),
                               atol=1e-6)
    np.testing.assert_array_equal(short[1].numpy(), np.asarray(jshort[1]))
    np.testing.assert_array_equal(short[2].numpy(), np.asarray(jshort[2]))
    # the points, cells and mask are those of the downsample without it
    bare = tvx.voxel_downsample_cells(pts, mask, leaf, capacity)
    for g, w in zip((full[0], full[2], full[3]), bare):
        assert torch.equal(g, w)
    border = full[3] & (full[1] > 0.3)
    assert bool(border.any()) and bool((full[3] & ~border).any())
    if capacity == 64:
        assert bool(full[3][:, -1].any())


def _sparse_scene(rng, n_border=48, n_interior=96, S=256):
    """tests/test_sparse_symmetry.py's cloud: a border outline symmetric
    about y = 0 and interior points on the y < 0 side only; the sources
    are the border points."""
    half = rng.uniform(-0.25, 0.25, (n_border // 2, 3)).astype(np.float32)
    half[:, 1] = np.abs(half[:, 1]) + 0.02
    border = np.concatenate([half, half * np.array([1, -1, 1], np.float32)])
    interior = rng.uniform(-0.25, 0.25, (n_interior, 3)).astype(np.float32)
    interior[:, 1] = -np.abs(interior[:, 1]) - 0.02
    pts = np.zeros((S, 3), np.float32)
    mask = np.zeros(S, bool)
    src = np.zeros(S, bool)
    n = n_border + n_interior
    pts[:n_border] = border
    pts[n_border:n] = interior
    mask[:n] = True
    src[:n_border] = True
    return pts, mask, src


def _cost_cases():
    """name -> (pts, mask, src, bbox, pose_oc, depth): the sparse scene seen
    from 1.5 m with nothing occluded; a random cloud, scattered lanes and a
    random third of them as sources, under a near camera whose box and wall
    occlude part of its mirror."""
    rng = np.random.default_rng(3)
    pts, mask, src = _sparse_scene(rng)
    free = np.full((480, 640), 50000, np.int32)
    cases = {"outline": (pts, mask, src, np.float32([0, 0, 639, 479]),
                         np.float32([0, 0, -1.5, 0, 0, 0, 1]), free)}
    S = 192
    pts = np.zeros((S, 3), np.float32)
    mask = np.zeros(S, bool)
    idx = rng.permutation(S)[:120]
    pts[idx] = rng.uniform(-0.2, 0.2, (120, 3))
    mask[idx] = True
    src = mask & (rng.random(S) < 0.35)
    depth = np.full((480, 640), 7000, np.int32)
    depth[:, :300] = 0
    cases["occluded"] = (pts, mask, src, np.float32([0, 0, 639, 479]),
                         np.float32([0.1, 0.05, -1.5, 0, 0, 0, 1]), depth)
    return cases


COST_CASES = _cost_cases()
PARAMS = {"true": (0.0, 0.0, 0.02), "off": (0.4, 0.15, -0.05)}


def _jax_cost(case, dual):
    pts, mask, src, bbox, pose_oc, depth = COST_CASES[case]
    pj = jnp.asarray(pts)
    proj = jbp.proj_depth_map(jnp.asarray(depth), JCAM)

    def cost(p):
        p1 = jsym._plane_from_params(p[0], p[1])
        from object_oriented_slam_tpu.core import plane as jpl
        planes = (jnp.stack([p1, jpl.dual_other_plane(p1, p[2])]) if dual
                  else p1[None])
        return jsym._mirror_cost(planes, pj.T, jnp.sum(pj * pj, axis=1),
                                 jnp.asarray(mask), jnp.asarray(bbox),
                                 jnp.asarray(pose_oc), proj, JCAM, SIGMA,
                                 src_mask=jnp.asarray(src))
    return jax.jit(cost), np.asarray(proj)


def _port_clouds(case, proj):
    pts, mask, src, bbox, pose_oc, _ = COST_CASES[case]
    return tsym._clouds(_t(pts)[None], _t(mask)[None], _t(bbox)[None],
                        _t(pose_oc)[None], _t(proj), CAM, SIGMA,
                        _t(src)[None])


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
@pytest.mark.parametrize("case,params", [
    ("outline", "true"), ("outline", "off"), ("occluded", "off")])
def test_mirror_cost_with_sources_matches_jax(case, params, dual):
    jcost, proj = _jax_cost(case, dual)
    par = np.array(PARAMS[params][:3 if dual else 2], np.float32)
    want = float(jcost(jnp.asarray(par)))
    cl = _port_clouds(case, proj)
    got = float(tsym._mirror_eval(_t(par)[None, None], cl, dual))
    assert abs(got - want) <= 1e-5 * abs(want) + 1e-6, (got, want)
    pts, mask, src = COST_CASES[case][:3]
    assert int(cl.ns[0]) == int((mask & src).sum()) < int(cl.n[0])
    if case == "outline" and params == "true" and not dual:
        assert want < 1e-4          # the border outline is symmetric


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
@pytest.mark.parametrize("case,params", [("outline", "off"),
                                         ("occluded", "off")])
def test_gradient_with_sources_matches_jax(case, params, dual):
    """autograd of the plain cost against jax.grad, 1e-4; the hand-written
    gradient (the LM's and the kernel's) against autograd, 1e-5."""
    jcost, proj = _jax_cost(case, dual)
    par = np.array(PARAMS[params][:3 if dual else 2], np.float32)
    want = np.asarray(jax.jit(jax.grad(jcost))(jnp.asarray(par)))
    cl = _port_clouds(case, proj)
    p = _t(par)[None, None].requires_grad_(True)
    auto = torch.autograd.grad(tsym._mirror_eval(p, cl, dual).sum(), p)[0]
    auto = auto[0, 0].numpy()
    _, hand = tsym._mirror_eval(_t(par)[None, None], cl, dual,
                                want_grad=True)
    hand = hand[0, 0].numpy()
    scale = max(np.abs(want).max(), 1e-30)
    assert scale > 1e-3
    assert np.abs(auto - want).max() <= 1e-4 * scale, (auto, want)
    assert np.abs(hand - auto).max() <= 1e-5 * scale, (hand, auto)


def _outline_search(pts, mask, src):
    """tests/test_sparse_symmetry.py's _run on the port: the camera 1.5 m
    behind the object, a ray depth of 10 m everywhere (nothing occluded)."""
    proj = torch.full((CAM.height, CAM.width), 10.0 * CAM.scale)
    return tsym.estimate_symmetry_plain(
        _t(pts)[None], _t(mask)[None], _t(np.float32([[0, 0, 639, 479]])),
        _t(np.float32([[0, 0, -1.5, 0, 0, 0, 1]])), proj,
        torch.ones(1, dtype=torch.int32), torch.ones(1, dtype=torch.bool),
        CAM, src_mask=None if src is None else _t(src)[None])


def test_sparse_recovers_plane_dense_does_not():
    """The border outline is symmetric about y = 0, the one-sided interior
    is not: the sparse search finds the plane, the dense one cannot reach
    its prob."""
    pts, mask, src = _sparse_scene(np.random.default_rng(3))
    dense = _outline_search(pts, mask, None)
    sparse = _outline_search(pts, mask, src)
    plane = sparse.plane[0].numpy()
    plane = plane / np.linalg.norm(plane[:3])
    assert abs(abs(plane[1]) - 1.0) < 0.02
    assert abs(plane[3]) < 0.015
    assert float(sparse.prob[0]) > 0.9
    assert float(dense.prob[0]) < float(sparse.prob[0]) - 0.1


def test_sparse_cost_ignores_non_source_points():
    """Moving a non-source point far away changes nothing: it is only a
    1-NN reference, and nobody's nearest."""
    pts, mask, src = _sparse_scene(np.random.default_rng(7))
    res0 = _outline_search(pts, mask, src)
    pts2 = pts.copy()
    pts2[int(np.argmax(mask & ~src))] = [5.0, 5.0, 5.0]
    res1 = _outline_search(pts2, mask, src)
    np.testing.assert_allclose(float(res0.error[0]), float(res1.error[0]),
                               atol=1e-5)


def test_sources_of_every_live_point_are_the_dense_search():
    """A source mask that holds every live point (and lanes that are not
    live) is the dense search, bit for bit; one that holds none scores
    nothing (cost -0, as the JAX package's empty mean)."""
    cases, proj = COST_CASES["occluded"], None
    pts, mask, _, bbox, pose_oc, depth = cases
    proj = tbp.proj_depth_map(_t(depth), CAM)
    args = (_t(pts)[None], _t(mask)[None], _t(bbox)[None],
            _t(pose_oc)[None], proj, torch.full((1,), 2, dtype=torch.int32),
            torch.ones(1, dtype=torch.bool), CAM)
    dense = tsym.estimate_symmetry_plain(*args)
    every = tsym.estimate_symmetry_plain(*args, src_mask=torch.ones(
        1, len(mask), dtype=torch.bool))
    for a, b in zip(dense, every):
        assert torch.equal(a, b)
    none = tsym.estimate_symmetry_plain(*args, src_mask=torch.zeros(
        1, len(mask), dtype=torch.bool))
    assert not bool(none.inits[..., 3].any())


def test_extractor_sparse_flag_end_to_end():
    """tests/test_sparse_symmetry.py's box scene on the port: the flag runs
    end to end and returns a valid estimate; it no longer raises."""
    depth = np.zeros((480, 640), np.int32)
    depth[100:300, 200:400] = 5000
    cfg = ExtractorConfig(open_symmetry=True, sparse_symmetry=True,
                          cloud_capacity=2048)
    e, p, v, _ = text.extract_local_ellipsoids(
        _t(depth), _t(np.float32([[200, 100, 400, 300]])),
        torch.ones(1, dtype=torch.bool), _t(np.float32([0, 0, 0, 0, 0, 0, 1])),
        _t(np.float32([0, -1, 0, 2.0])), CAM, cfg,
        sym_types=torch.ones(1, dtype=torch.int32), need_single=True,
        need_dual=False)
    assert bool(v[0]) and bool(torch.isfinite(e).all())


@pytest.fixture(scope="module")
def sym_frame():
    """Frame 0 of the 6-object scene with LABELS: a dual reflection, two
    reflections, objects without a prior or out of view."""
    sc, cam, jcam = _scene(LABELS)
    ds = tsyn.SyntheticDataset(sc, n_frames=12, orbit_radius=3.6, height=1.7)
    _, _, pose, depth, _, det = next(iter(ds.frames()))
    labels = det[:, 5].astype(int)
    st = tsym.sym_type_of_labels(labels)
    return dict(depth=np.asarray(depth, np.int32),
                pose=pose.astype(np.float32), cam=cam, jcam=jcam, bboxes=det[:, 1:5].astype(np.float32),
                labels=labels, st=st,
                plane=np.array([0.0, 0.0, 1.0, 0.0], np.float32))


@pytest.mark.parametrize("analytic", [
    True, pytest.param(False, marks=pytest.mark.xfail(strict=False, reason=(
        "fault logged in ROADMAP.md queue 3: the central-difference search "
        "of the dual detection parts from JAX's in the first LM step (f32 "
        "round-off through the Cholesky solve of g g^T + lam0 I); with "
        "sparse symmetry it ends 1.8e-3 from JAX's centre, 2.0e-3 from its "
        "scales and Two, 6.0e-5 from its prob")))],
    ids=["analytic", "central"])
def test_extract_local_ellipsoids_sparse_matches_jax(sym_frame, analytic):
    f = sym_frame
    kw = dict(cloud_capacity=2048, open_symmetry=True, sparse_symmetry=True,
              sym_analytic_grad=analytic)
    n = len(f["bboxes"])
    flags = dict(need_single=bool((f["st"] == 1).any()),
                 need_dual=bool((f["st"] == 2).any()))
    stats = {}
    e, p, v, (pts, m, Two) = text.extract_local_ellipsoids(
        _t(f["depth"]), _t(f["bboxes"]), torch.ones(n, dtype=torch.bool),
        _t(f["pose"]), _t(f["plane"]), f["cam"], text.ExtractorConfig(**kw),
        stats, sym_types=_t(f["st"]), **flags)
    je, jp, jv, (_, jm, jTwo) = jext.extract_local_ellipsoids(
        jnp.asarray(f["depth"]), jnp.asarray(f["bboxes"]),
        jnp.ones(n, bool), jnp.asarray(f["pose"]), jnp.asarray(f["plane"]),
        f["jcam"], jext.ExtractorConfig(**kw),
        sym_types=jnp.asarray(f["st"]), **flags)
    ok = v.numpy()
    np.testing.assert_array_equal(ok, np.asarray(jv))
    assert ok[f["st"] == 2].any() and ok[f["st"] == 1].any()
    np.testing.assert_array_equal(m.numpy()[ok], np.asarray(jm)[ok])
    e, je = e.numpy()[ok], np.asarray(je)[ok]
    np.testing.assert_allclose(e[:, :3], je[:, :3], atol=1e-3)
    np.testing.assert_allclose(np.sort(e[:, 7:]), np.sort(je[:, 7:]),
                               atol=2e-3)
    np.testing.assert_allclose(Two.numpy()[ok], np.asarray(jTwo)[ok],
                               atol=1e-4)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=1e-5)
    # a detection searched over a proper border subset of its cells
    searched = int(((f["st"] > 0)).sum())
    assert int(stats["sym_dense"]) < searched
    assert 0 < int(stats["sym_sources"]) < int(stats["sym_points"])


def test_sparse_differs_from_dense_only_in_the_search(sym_frame):
    """Sparse symmetry changes the searched planes, not the clouds: the
    stage (a)-(f) outputs are the dense extractor's, and a frame without a
    detection to search gives the same result either way."""
    f = sym_frame
    args = (_t(f["depth"]), _t(f["bboxes"]),
            torch.ones(len(f["bboxes"]), dtype=torch.bool), _t(f["pose"]),
            _t(f["plane"]), f["cam"])
    res = {}
    for sparse in (False, True):
        cfg = ExtractorConfig(cloud_capacity=2048, open_symmetry=True,
                              sparse_symmetry=sparse)
        res[sparse] = text.extract_local_ellipsoids(
            *args, cfg, sym_types=torch.zeros(len(f["bboxes"]),
                                              dtype=torch.int32),
            need_single=False, need_dual=False)
    for a, b in zip(res[False][:3], res[True][:3]):
        assert torch.equal(a, b)


def test_monolithic_extractor_reports_the_sources(sym_frame):
    """make_extractor with sparse symmetry on the CPU: the call's result is
    extract_local_ellipsoids', and fetch fills the searched detections'
    source, point and dense counts beside the clustering's."""
    f = sym_frame
    cfg = ExtractorConfig(open_symmetry=True, sparse_symmetry=True)
    ex = make_extractor(f["cam"], cfg, device="cpu")
    before = {k.name: k.launches for k in fk.KERNELS}
    host = ex.fetch(ex(f["depth"], f["bboxes"], f["labels"],
                       f["pose"].astype(float), f["plane"].astype(float)))
    assert {k.name: k.launches for k in fk.KERNELS} == before
    st = ex.stats
    searched = int((f["st"] > 0).sum())
    assert st["sym_single"] + st["sym_dual"] == searched
    assert 0 < st["sym_sources"] < st["sym_points"]
    assert 0 <= st["sym_dense"] < searched
    assert st["cluster_converged"] is True
    assert np.isfinite(host).all() and (host[:, 11] > 0.5).sum() >= 3


def test_whole_run_sparse_matches_jax(monkeypatch):
    """System over 8 frames of the 6-object scene with LABELS and
    configs/synthetic_depth_sym.yaml, the extractor with sparse symmetry
    (no settings key turns it on: the config is built here, as the JAX
    package's tests build it), port (device cpu) against the JAX package on
    the same frames: the same instances and 3D observation frames, centres
    and sorted scales within 2e-3."""
    import os
    from object_oriented_slam_tpu.frontend import ExtractorConfig as JExtCfg
    from object_oriented_slam_tpu.frontend import make_extractor as jmake_ext
    from object_oriented_slam_tpu.frontend import \
        make_plane_estimator as jmake_plane
    from object_oriented_slam_tpu.system import System as JSystem
    from object_oriented_slam_tpu_torch.frontend import make_plane_estimator
    from object_oriented_slam_tpu_torch.system import System, Tracking
    yaml = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "object_oriented_slam_tpu_torch", "configs",
                        "synthetic_depth_sym.yaml")
    monkeypatch.setattr(Tracking, "MAX_OBJECTS", 8)
    sc, cam, jcam = _scene(LABELS)
    frames = list(tsyn.SyntheticDataset(sc, n_frames=8, orbit_radius=3.6,
                                        height=1.7).frames())
    kw = dict(cloud_capacity=2048, open_symmetry=True, sparse_symmetry=True)
    slam = System(yaml, extractor=make_extractor(cam, ExtractorConfig(**kw),
                                                 device="cpu"),
                  plane_estimator=make_plane_estimator(cam, device="cpu"),
                  device="cpu")
    jslam = JSystem(yaml, extractor=jmake_ext(jcam, JExtCfg(**kw)),
                    plane_estimator=jmake_plane(jcam))
    for s in (slam, jslam):
        # eager, so the extractor's stats after a frame are that frame's
        s.tracker.pipeline_depth = 1
        s.open_ground_plane_estimation()
    proper = 0
    for i, ts, pose, depth, rgb, det in frames:
        slam.track_with_objects(ts, pose, det, depth=depth)
        jslam.track_with_objects(ts, pose, det, depth=depth)
        st = slam.tracker.extractor.stats
        proper += st["sym_single"] + st["sym_dual"] - st.get("sym_dense", 0)
    got, want = slam.map_objects, jslam.map_objects
    assert sorted(got) == sorted(want) and len(want) >= 5
    for inst in want:
        np.testing.assert_allclose(got[inst][:3], want[inst][:3], atol=2e-3)
        np.testing.assert_allclose(np.sort(got[inst][7:]),
                                   np.sort(want[inst][7:]), atol=2e-3)
    st, jst = slam.tracker.state, jslam.tracker.state
    for inst, jrec in jst.objects.items():
        assert st.objects[inst].obs3d_frame == jrec.obs3d_frame
    assert proper > 0          # detections searched over border subsets
    iou = tmt.object_map_iou(got, {i: sc.ellipsoids[i] for i in got})
    assert np.median(list(iou.values())) > 0.5


# --- ops/filters: the two masks off the main path (tests/test_aux.py's)


def test_statistical_outlier_mask_matches_jax():
    rng = np.random.default_rng(21)
    cloud = rng.normal(0, 0.05, (200, 3)).astype(np.float32)
    cloud[:5] += 5.0
    mask = np.ones(200, bool)
    mask[7] = False
    for k in (10, 20):
        got = tfl.statistical_outlier_mask(_t(cloud), _t(mask), k=k).numpy()
        want = np.asarray(jfl.statistical_outlier_mask(
            jnp.asarray(cloud), jnp.asarray(mask), k=k))
        np.testing.assert_array_equal(got, want)
        assert not got[:5].any() and not got[7] and got[5:].mean() > 0.9


def test_points_inside_quadric_mask_matches_jax():
    e = np.array([0, 0, 0, 0, 0, 0, 1, 1, 0.5, 0.25], np.float32)
    pts = np.array([[0, 0, 0], [0.9, 0, 0], [0, 0.6, 0], [0, 0, 0.3]],
                   np.float32)
    got = tfl.points_inside_quadric_mask(_t(pts), torch.ones(4, dtype=bool),
                                         _t(e))
    assert got.tolist() == [True, True, False, False]
    rng = np.random.default_rng(8)
    e = np.array([0.3, -0.2, 0.5, 0.1, -0.2, 0.3, 0.927, 0.6, 0.4, 0.3],
                 np.float32)
    e[3:7] /= np.linalg.norm(e[3:7])
    pts = rng.uniform(-0.5, 1.1, (500, 3)).astype(np.float32)
    mask = rng.random(500) < 0.9
    got = tfl.points_inside_quadric_mask(_t(pts), _t(mask), _t(e)).numpy()
    want = np.asarray(jfl.points_inside_quadric_mask(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(e)))
    np.testing.assert_array_equal(got, want)
    assert 20 < got.sum() < 450


# --- ops/polygon and system/metrics: the map's IoU (tests/test_polygon.py)


def _sq(cx, cy, h, mod):
    v = np.zeros((tpg.MAX_VERTS, 2), np.float32)
    v[:4] = [[cx + h, cy - h], [cx + h, cy + h], [cx - h, cy + h],
             [cx - h, cy - h]]
    return (_t(v), 4) if mod is tpg else (jnp.asarray(v), jnp.int32(4))


@pytest.mark.parametrize("a,b,area", [
    ((0, 0, 1), None, 4.0), ((0, 0, 1), (1, 1, 1), 1.0),
    ((0, 0, 1), (5, 5, 1), 0.0), ((0, 0, 2), (0, 0, 0.5), 1.0)],
    ids=["area", "overlapping", "disjoint", "contained"])
def test_polygon_matches_jax(a, b, area):
    got, want = [], []
    for mod, out in ((tpg, got), (jpg, want)):
        pa, na = _sq(*a, mod)
        if b is None:
            out.append(float(mod.polygon_area(pa, na)))
            continue
        pb, nb = _sq(*b, mod)
        iv, ic = mod.intersect_convex(pa, na, pb, nb)
        out.append(float(mod.polygon_area(iv, ic)))
        out.append(int(ic))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert abs(got[0] - area) < 1e-4


def _ell(*v):
    return np.array(v, np.float32)


IOU_CASES = {
    "identical": (_ell(1, 2, 3, 0, 0, 0, 1, 0.5, 0.4, 0.3),
                  _ell(1, 2, 3, 0, 0, 0, 1, 0.5, 0.4, 0.3), 1.0),
    "shifted": (_ell(0, 0, 0, 0, 0, 0, 1, 1, 1, 1),
                _ell(1, 0, 0, 0, 0, 0, 1, 1, 1, 1), 1.0 / 3.0),
    "yaw_90": (_ell(0, 0, 0, 0, 0, 0, 1, 0.6, 0.3, 0.2),
               np.asarray(jell.rotate_yaw(jnp.asarray(
                   _ell(0, 0, 0, 0, 0, 0, 1, 0.6, 0.3, 0.2)), 1)), 1.0),
    "disjoint_z": (_ell(0, 0, 0, 0, 0, 0, 1, 1, 1, 0.2),
                   _ell(0, 0, 1, 0, 0, 0, 1, 1, 1, 0.2), 0.0),
    "rotated": (_ell(0.1, 0.2, 0.3, 0, 0, 0.2588, 0.9659, 0.5, 0.3, 0.2),
                _ell(0.3, 0.1, 0.35, 0, 0, -0.3827, 0.9239, 0.4, 0.35, 0.25),
                None),
}


@pytest.mark.parametrize("case", list(IOU_CASES))
def test_ellipsoid_iou_3d_matches_jax(case):
    e1, e2, want_iou = IOU_CASES[case]
    got = float(tpg.ellipsoid_iou_3d(_t(e1), _t(e2)))
    want = float(jpg.ellipsoid_iou_3d(jnp.asarray(e1), jnp.asarray(e2)))
    assert abs(got - want) < 1e-5, (got, want)
    if want_iou is not None:
        assert abs(got - want_iou) < 1e-3
    else:
        assert 0.05 < got < 0.95


def test_object_map_iou_matches_jax():
    rng = np.random.default_rng(6)
    map_a, map_b = {}, {}
    for inst in range(8):
        q = rng.normal(size=4)
        q[:2] *= 0.05
        q /= np.linalg.norm(q)
        e = np.concatenate([rng.uniform(-2, 2, 3), q,
                            rng.uniform(0.1, 0.5, 3)])
        map_a[inst] = e
        if inst != 3:
            f = e.copy()
            f[:3] += rng.normal(0, 0.05, 3)
            f[7:] *= rng.uniform(0.8, 1.2, 3)
            map_b[inst] = f
    map_b[11] = map_a[0]
    got = tmt.object_map_iou(map_a, map_b)
    want = jmt.object_map_iou(map_a, map_b)
    assert sorted(got) == sorted(want) == [0, 1, 2, 4, 5, 6, 7]
    for inst in want:
        assert abs(got[inst] - want[inst]) < 1e-5, inst
    assert all(0.2 < v <= 1.0 for v in got.values())


def test_ate_rmse_and_timing_summary_match_jax():
    rng = np.random.default_rng(9)
    gt = np.cumsum(rng.normal(0, 0.1, (50, 3)), axis=0)
    th = 0.7
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1]])
    est = gt @ R.T + np.array([1.0, -2.0, 0.5]) + rng.normal(0, 0.01,
                                                            (50, 3))
    for align in (True, False):
        got = tmt.ate_rmse(est, gt, align=align)
        assert got == jmt.ate_rmse(est, gt, align=align)
    assert tmt.ate_rmse(est, gt) < 0.03 < tmt.ate_rmse(est, gt, align=False)
    s, R2, t = tmt.umeyama_alignment(est, gt, with_scale=True)
    for a, b in zip((s, R2, t), jmt.umeyama_alignment(est, gt,
                                                       with_scale=True)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tmt.ate_rmse(est[:10], gt)
    times = {"dispatch": [0.5, 0.01, 0.02, 0.03], "backend": [0.004]}
    assert tmt.timing_summary(times) == jmt.timing_summary(times)


def test_cpu_wrappers_take_the_plain_versions(rendered):
    """On CPU tensors the new lanes' wrappers are their plain versions and
    launch nothing."""
    f = rendered
    args = (_t(f["depth"]), _t(f["bboxes"]), _t(f["pose"]), _t(PLANE),
            f["cam"], 0.01, 6.0, 0.05, 2048)
    before = {k.name: k.launches for k in fk.KERNELS}
    got, battr = tdc.depth_cloud_border(*args)
    want, wattr = tdc.depth_cloud_border_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(battr, wattr)
    full = tvx.voxel_downsample_full(got.pts_w, battr, got.m2, 0.1, 512)
    want = tvx.voxel_downsample_full_plain(got.pts_w, battr, got.m2, 0.1,
                                           512)
    for g, w in zip(full, want):
        assert torch.equal(g, w)
    assert {k.name: k.launches for k in fk.KERNELS} == before
