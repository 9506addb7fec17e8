"""The CUDA depth-frontend kernels against their plain PyTorch versions.

Needs an NVIDIA GPU (sm_90a) and nvcc; skipped elsewhere.  The machine
with the card has no JAX, so run this file without the JAX test setup:

    python -m pytest tests/test_torch_frontend_kernels.py --noconftest -q

Inputs: frames of a seeded synthetic scene rendered by the port
(io/synthetic.py), 640x480, and a seeded depth image valid at every pixel
(a whole-image box of 34,240 live points).  The kernels are built with IEEE
division and without fused multiply-add, in the plain versions' order of
operations, so masks, cells and labels must be EQUAL.  Floats are held bit
for bit against the plain version evaluated on the CPU (whose
``index_add_`` adds in sorted order, like the kernel), and within 1e-6
against the plain version on the card (whose ``index_add_`` adds with
atomics in any order; 5e-6 for the 0.1 m object downsample).
"""
import numpy as np
import pytest
import torch

from object_oriented_slam_tpu_torch.core import se3
from object_oriented_slam_tpu_torch.frontend import (ExtractorConfig,
                                                     extract_local_ellipsoids)
from object_oriented_slam_tpu_torch.io import synthetic as syn
from object_oriented_slam_tpu_torch.ops import backproject as bp
from object_oriented_slam_tpu_torch.ops import cluster as cl
from object_oriented_slam_tpu_torch.ops import depth_cloud as dc
from object_oriented_slam_tpu_torch.ops import frontend_kernels as fk
from object_oriented_slam_tpu_torch.ops import voxel as vx

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _frame(n_objects=8, frame=5, seed=7):
    """(depth int32 [480, 640], bboxes [D, 4] float32, pose [7], camera)."""
    scene = syn.make_scene(n_objects=n_objects, seed=seed,
                           radius_range=(1.3, 2.2), scale_range=(0.2, 0.4))
    pose = syn.orbit_trajectory(40, 3.6, 1.7)[frame]
    depth = syn.render_depth(scene.ellipsoids, pose, scene.camera)
    bbs, vis = syn.project_bboxes(scene.ellipsoids.astype(np.float32),
                                  pose.astype(np.float32), scene.camera)
    # a fractional box, a box running off the image and an empty one ride
    # along with the visible detections
    extra = torch.tensor([[100.7, 50.2, 300.9, 400.5],
                          [500.0, 300.0, 900.0, 700.0],
                          [0.0, 0.0, 0.0, 0.0]])
    return depth, torch.cat([bbs[vis], extra]), pose, scene.camera


def _world(pose, dev):
    pose_t = torch.as_tensor(pose, dtype=torch.float32, device=dev)
    plane = torch.tensor([0.001, -0.002, 1.0, -0.0005], device=dev)
    den = torch.sqrt((plane[:3] ** 2).sum()).clamp_min(1e-8)
    return vx.World(se3.quat_to_mat(pose_t[3:]), pose_t[:3], plane, den, 0.05)


def _world_cpu(w):
    return vx.World(w.R.cpu(), w.t.cpu(), w.plane.cpu(), w.den.cpu(),
                    w.clearance)


def _bits_equal(a, b):
    return torch.equal(a.cpu().contiguous().view(torch.uint8),
                       b.cpu().contiguous().view(torch.uint8))


def test_bbox_cloud_equals_plain(device):
    depth, bboxes, _, cam = _frame()
    n0 = fk.BBOX_CLOUD.launches
    pts, mask = bp.bbox_point_cloud(depth.to(device), bboxes.to(device), cam,
                                    6.0)
    torch.cuda.synchronize()
    assert fk.BBOX_CLOUD.launches == n0 + 1
    assert pts.shape == (len(bboxes), bp.BBOX_GRID_H * bp.BBOX_GRID_W, 3)
    for want in (bp.bbox_point_cloud_plain(depth, bboxes, cam, 6.0),
                 bp.bbox_point_cloud_plain(depth.to(device),
                                           bboxes.to(device), cam, 6.0)):
        assert torch.equal(mask.cpu(), want[1].cpu())
        assert _bits_equal(pts, want[0])
    assert int(mask.sum()) > 10000 and not bool(mask[-1].any())


@pytest.mark.parametrize("capacity", [16384, 2048])
def test_voxel_segment_mean_equals_plain(device, capacity):
    depth, bboxes, pose, cam = _frame()
    pts, mask = bp.bbox_point_cloud_plain(depth, bboxes, cam, 6.0)
    key, cmin = vx.voxel_keys(pts, mask, 0.01)
    key_s, order = torch.sort(key, dim=1, stable=True)
    world = _world(pose, device)
    n0 = fk.VOXEL_SEGMENT_MEAN.launches
    got = vx.voxel_segment_mean(key_s.to(device), order.to(device),
                                pts.to(device), cmin.to(device), capacity,
                                world)
    torch.cuda.synchronize()
    assert fk.VOXEL_SEGMENT_MEAN.launches == n0 + 1
    # bit for bit against the CPU (sequential sums in sorted order)
    want = vx.voxel_segment_mean_plain(key_s, order, pts, cmin, capacity,
                                       _world_cpu(world))
    for g, w in zip(got, want):
        assert _bits_equal(g, w)
    # against the card's plain version: atomics add in any order
    card = vx.voxel_segment_mean_plain(key_s.to(device), order.to(device),
                                       pts.to(device), cmin.to(device),
                                       capacity, world)
    assert torch.equal(got[1], card[1]) and torch.equal(got[2], card[2])
    assert float((got[0] - card[0]).abs().max()) <= 1e-6
    assert float((got[3] - card[3]).abs().max()) <= 1e-6
    # without the world epilogue
    bare = vx.voxel_segment_mean(key_s.to(device), order.to(device),
                                 pts.to(device), cmin.to(device), capacity)
    assert bare[3] is None and bare[4] is None
    assert _bits_equal(bare[0], got[0]) and torch.equal(bare[2], got[2])
    if capacity == 2048:      # the big boxes overflow: segments are dropped
        assert bool(got[2][:, -1].any())


def _cluster_inputs(n_lanes=4096):
    depth, bboxes, pose, cam = _frame()
    pts, mask = bp.bbox_point_cloud_plain(depth, bboxes, cam, 6.0)
    world = _world_cpu(_world(pose, torch.device("cpu")))
    _, _, _, pts_w, m2 = vx._voxel_core(pts, mask, 0.01, n_lanes, world)
    return pts_w, m2


def test_min_label_pass_and_jumps_equal_plain(device):
    pts_w, m2 = _cluster_inputs()
    D, N = m2.shape
    w = m2[..., None]
    c = torch.where(w, pts_w, 0.0).sum(1) / m2.sum(1).clamp_min(1)[:, None]
    pts_c = torch.where(w, pts_w - c[:, None, :], 0.0).contiguous()
    nrm = (pts_c * pts_c).sum(-1)
    labels = torch.where(m2, torch.arange(N, dtype=torch.int32), N)
    tol2 = float(torch.tensor(0.02 * 0.02, dtype=torch.float32))
    args_d = [t.to(device) for t in (pts_c, nrm, m2, labels)]
    for _ in range(3):       # three rounds, each held against the plain one
        n0 = (fk.MIN_LABEL_PASS.launches, fk.POINTER_JUMPS.launches)
        got = cl.min_label_pass(*args_d, tol2)
        want = cl.min_label_pass_plain(pts_c, nrm, m2, labels, tol2)
        assert torch.equal(got.cpu(), want)
        got_j, got_ch = cl.pointer_jumps(got, args_d[3], 12)
        want_j, want_ch = cl.pointer_jumps_plain(want, labels, 12)
        torch.cuda.synchronize()
        assert (fk.MIN_LABEL_PASS.launches, fk.POINTER_JUMPS.launches) \
            == (n0[0] + 1, n0[1] + 1)
        assert torch.equal(got_j.cpu(), want_j)
        assert torch.equal(got_ch.cpu(), want_ch) and bool(want_ch.any())
        labels, args_d[3] = want_j, got_j
    # an odd number of jumps ends in the scratch buffer and is copied back
    odd, _ = cl.pointer_jumps(args_d[3].clone(), args_d[3], 3)
    assert torch.equal(odd.cpu(), cl.pointer_jumps_plain(labels, labels, 3)[0])


def _on(device, args):
    """centre_and_seed's tuple with its tensors moved to ``device``."""
    return tuple(t.to(device) if isinstance(t, torch.Tensor) else t
                 for t in args)


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w.cpu())


@pytest.mark.parametrize("chains", [-1, 0])
def test_cluster_components_equals_plain_and_repeat(device, chains):
    """One launch for all rounds: labels, converged and rounds equal the
    plain version's (same centred points, so no rounding band), a second
    launch gives the same bits, and so does every launch shape."""
    pts_w, m2 = _cluster_inputs()
    args = cl.centre_and_seed(pts_w, m2, 0.02, chains)
    want = cl.cluster_components_plain(*args, 96, 12)
    assert bool(want[1].all()) and int(want[2].max()) > 3
    n0 = fk.CLUSTER_COMPONENTS.launches
    step0 = (fk.MIN_LABEL_PASS.launches, fk.POINTER_JUMPS.launches)
    args_d = _on(device, args)
    for _ in range(2):
        _assert_same(cl.cluster_components(*args_d, 96, 12), want)
    torch.cuda.synchronize()
    assert fk.CLUSTER_COMPONENTS.launches == n0 + 2
    assert (fk.MIN_LABEL_PASS.launches, fk.POINTER_JUMPS.launches) == step0
    P = cl.LAUNCH_SHAPE[2]

    def launch(frame=None, **kw):
        return cl._launch(*args_d, 96, 12, frame, **kw)[:3]

    for shape in ((1, 256, P), (2, 512, P), (4, 128, P), (8, 64, P)):
        _assert_same(launch(shape=shape), want)
    # every pair tested (no far group skipped), and the points streamed
    # through the least shared memory instead of resident
    _assert_same(launch(prune=False), want)
    least = 13 * m2.shape[1] + 16 * 256
    for shape in ((8, 512, P), (3, 256, P)):
        _assert_same(launch(shape=shape, smem=least), want)
    # the sort frame is a hint for the skip and changes nothing: the
    # identity, a slanted rotation, the camera's axes of this frame, and two
    # matrices that are no rotation (ignored: boxes along the world's axes)
    c, sn = float(np.cos(0.7)), float(np.sin(0.7))
    _, _, pose, _ = _frame()
    for frame in (torch.eye(3), torch.tensor([[c, sn, 0.0], [-sn, c, 0.0],
                                              [0.0, 0.0, 1.0]]),
                  _world(pose, device).R.T.contiguous().cpu(),
                  5.0 * torch.eye(3), torch.full((3, 3), float("nan"))):
        for shape in ((8, 512, P), (2, 256, P)):
            _assert_same(launch(frame.to(device), shape=shape), want)
        _assert_same(cl.cluster_components(*args_d, 96, 12,
                                           frame=frame.to(device)), want)
    # an odd number of jumps, and none
    for jumps in (3, 0):
        _assert_same(cl.cluster_components(*args_d, 96, jumps),
                     cl.cluster_components_plain(*args, 96, jumps))
    # the public wrapper launches it too, at any lane count
    lab, conv, rounds = cl.connected_components(
        pts_w.to(device), m2.to(device), 0.02, 96, 12,
        with_converged=True, with_rounds=True, chains=chains)
    torch.cuda.synchronize()
    assert bool(conv.all()) and lab.shape == m2.shape
    assert (lab[~m2.to(device)] == m2.shape[1]).all()


def test_cluster_components_full_lanes_and_truncation(device):
    """Clouds that fill 16384 lanes (streamed: the points do not fit in
    shared memory), an empty detection, one tight blob, odd lane counts;
    and a bound of 2 rounds, which only the detections still changing
    report."""
    rng = np.random.default_rng(3)
    D, N = 4, 16384
    pts = rng.uniform(0.0, 1.0, (D, N, 3)).astype(np.float32)
    pts[..., 2] *= 0.25
    pts[0] = pts[0][np.argsort(pts[0, :, 0], kind="stable")]
    pts[2] = 0.5 + 0.005 * pts[2]
    mask = np.ones((D, N), bool)
    mask[1, rng.permutation(N)[:5000]] = False
    mask[2, 700:] = False
    mask[3] = False
    pts_t, mask_t = torch.from_numpy(pts), torch.from_numpy(mask)
    for n_lanes in (N, 5000 + 13):
        args = cl.centre_and_seed(pts_t[:, :n_lanes].contiguous(),
                                  mask_t[:, :n_lanes].contiguous(), 0.02, 0)
        args_d = _on(device, args)
        for outer in (96, 2):
            # the plain version on the card (72 ms a pass at 16384 lanes)
            want = cl.cluster_components_plain(*args_d, outer, 12)
            got = cl.cluster_components(*args_d, outer, 12)
            _assert_same(got, want)
            _assert_same(cl.cluster_components(*args_d, outer, 12), got)
            conv = got[1].tolist()
            assert conv[2] and conv[3] and int(got[2][3]) == 1
            assert conv[0] == (outer == 96) and int(got[2][2]) == 2
        assert int(got[2][0]) == 2


@pytest.mark.parametrize("min_size,center_dis", [(100, 0.5), (30, 0.05),
                                                 (400, 5.0), (5, 0.5)])
def test_cluster_select_equals_plain(device, min_size, center_dis):
    """The selection epilogue: the chosen cluster's mask and the ok flags
    equal ``select_cluster`` on the plain labels, for the default gates, a
    tight radius, a size only a few clusters reach, and a size almost every
    fragment reaches; labels, converged and rounds as without it."""
    depth, bboxes, pose, cam = _frame()
    pts_w, m2 = _cluster_inputs()
    world = _world_cpu(_world(pose, torch.device("cpu")))
    centre, _ = bp.center_estimate(depth, bboxes, cam, 6.0)
    centre_w = (centre @ world.R.T + world.t).contiguous()
    args = cl.centre_and_seed(pts_w, m2, 0.02, -1)
    want = cl.cluster_select_plain(pts_w, *args[:4], centre_w, args[4], 96,
                                   12, min_size, center_dis)
    n0 = fk.CLUSTER_COMPONENTS.launches
    got = cl.cluster_select(pts_w.to(device), *_on(device, args[:4]),
                            centre_w.to(device), args[4], 96, 12, min_size,
                            center_dis)
    _assert_same(got, want)
    P = cl.LAUNCH_SHAPE[2]
    for shape in ((1, 128, P), (4, 512, P)):
        lab, conv, rounds, sel, ok = cl._launch(
            *_on(device, args[:4]), args[4], 96, 12, None,
            (pts_w.to(device), centre_w.to(device), min_size, center_dis),
            shape=shape)
        _assert_same((sel, ok, lab, conv, rounds), want)
    torch.cuda.synchronize()
    assert fk.CLUSTER_COMPONENTS.launches == n0 + 3
    if (min_size, center_dis) == (100, 0.5):
        assert int(want[1].sum()) >= 3 and not bool(want[1][-1])
    # a truncated run fails the gate for the detections still changing
    cut = cl.cluster_select(pts_w.to(device), *_on(device, args[:4]),
                            centre_w.to(device), args[4], 2, 12, min_size,
                            center_dis)
    _assert_same(cut, cl.cluster_select_plain(
        pts_w, *args[:4], centre_w, args[4], 2, 12, min_size, center_dis))
    assert not bool((cut[1] & ~cut[3]).any())


def test_cluster_components_refuses_what_it_does_not_take(device):
    pts_w, m2 = _cluster_inputs(1024)
    args = _on(device, cl.centre_and_seed(pts_w, m2, 0.02, -1))
    pts_c, nrm, m, labels0, tol2 = args
    with pytest.raises(TypeError):
        cl.cluster_components(pts_c, nrm, m, labels0.long(), tol2, 96, 12)
    with pytest.raises(ValueError):
        cl.cluster_components(pts_c, nrm.cpu(), m, labels0, tol2, 96, 12)
    with pytest.raises(ValueError):
        cl.cluster_components(pts_c[:, :512], nrm, m, labels0, tol2, 96, 12)
    with pytest.raises(ValueError):
        cl.cluster_components(pts_c, nrm, m, labels0, tol2, 0, 12)
    with pytest.raises(ValueError):
        cl.cluster_components(pts_c, nrm, m, labels0, tol2, 96, 12,
                              frame=torch.eye(4, device=device))
    with pytest.raises(ValueError):
        cl.cluster_components(pts_c, nrm, m, labels0, tol2, 96, 12,
                              frame=torch.eye(3))
    # a launch the card refuses raises; nothing falls back: a cluster of
    # 16 blocks, and points a lane other than the build's
    P = cl.LAUNCH_SHAPE[2]
    with pytest.raises(RuntimeError, match="cluster_components"):
        cl._launch(pts_c, nrm, m, labels0, tol2, 96, 12, None,
                   shape=(16, 512, P))
    with pytest.raises(RuntimeError, match="cluster_components"):
        cl._launch(pts_c, nrm, m, labels0, tol2, 96, 12, None,
                   shape=(8, 512, 2 * P))
    with pytest.raises(ValueError, match="lanes"):
        cl.launch_smem(32768)
    centre = torch.zeros((m.shape[0], 3), device=device)
    with pytest.raises(ValueError, match="min_size"):
        cl.cluster_select(pts_c, pts_c, nrm, m, labels0, centre, tol2, 96, 12,
                          0, 0.5)
    with pytest.raises(ValueError):
        cl.cluster_select(pts_c, pts_c, nrm, m, labels0, centre[:, :2], tol2,
                          96, 12, 100, 0.5)
    with pytest.raises(TypeError):
        cl.cluster_select(pts_c.double(), pts_c, nrm, m, labels0, centre,
                          tol2, 96, 12, 100, 0.5)


def test_extraction_on_card_matches_cpu(device):
    depth, bboxes, pose, cam = _frame()
    cfg = ExtractorConfig()
    run = torch.ones(len(bboxes), dtype=torch.bool)
    plane = torch.tensor([0.0, 0.0, 1.0, 0.0])
    pose_t = torch.as_tensor(pose, dtype=torch.float32)
    before = {k.name: k.launches for k in fk.KERNELS}
    got = extract_local_ellipsoids(depth.to(device), bboxes.to(device),
                                   run.to(device), pose_t.to(device),
                                   plane.to(device), cam, cfg)
    torch.cuda.synchronize()
    # three launches; the single-step kernels are not on this path
    assert {k.name: k.launches - before[k.name] for k in fk.KERNELS} == {
        "depth_cloud": 1, "cluster_components": 1, "voxel_downsample": 1,
        "bbox_cloud": 0, "voxel_segment_mean": 0, "min_label_pass": 0,
        "pointer_jumps": 0}
    want = extract_local_ellipsoids(depth, bboxes, run, pose_t, plane, cam,
                                    cfg)
    assert torch.equal(got[2].cpu(), want[2]) and int(want[2].sum()) >= 3
    v = want[2]
    # PCA sums run in another order on the card: centre 1e-4, scale 1e-3
    assert float((got[0].cpu()[v, :3] - want[0][v, :3]).abs().max()) < 1e-4
    assert float((got[0].cpu()[v, 7:].sort(1).values
                  - want[0][v, 7:].sort(1).values).abs().max()) < 1e-3


def test_wrappers_refuse_what_the_kernels_do_not_take(device):
    depth, bboxes, _, cam = _frame()
    with pytest.raises(TypeError):
        bp.bbox_point_cloud(depth.to(device).float(), bboxes.to(device), cam,
                            6.0)
    with pytest.raises(ValueError):
        bp.bbox_point_cloud(depth.to(device), bboxes, cam, 6.0)
    with pytest.raises(ValueError):
        bp.bbox_point_cloud(depth.to(device).T, bboxes.to(device), cam, 6.0)


def _full_depth(seed=11):
    """A 640x480 depth image valid at every pixel: a slanted surface 1-5 m
    away with seeded noise, so a whole-image box has 34,240 live points."""
    rng = np.random.default_rng(seed)
    v, u = np.mgrid[0:480, 0:640]
    d = 5000 + 20 * u + 15 * v + rng.integers(0, 200, (480, 640))
    return torch.from_numpy(d.astype(np.int32))


def _depth_cloud_inputs(whole_image=False):
    depth, bboxes, pose, cam = _frame()
    if whole_image:
        depth = _full_depth()
        bboxes = torch.cat([bboxes[:2], torch.tensor([[0.0, 0.0, 640.0,
                                                       480.0]])])
    return (depth, bboxes, torch.as_tensor(pose, dtype=torch.float32),
            torch.tensor([0.001, -0.002, 1.0, -0.0005]), cam)


def _on_card(args, device):
    return [a.to(device) if isinstance(a, torch.Tensor) else a for a in args]


@pytest.mark.parametrize("capacity,whole_image",
                         [(4096, False), (16384, False), (1024, False),
                          (16384, True)])
def test_depth_cloud_equals_plain(device, capacity, whole_image):
    """Stages (a)-(c) in one launch: masks, cells and flags equal to the
    plain version; floats bit-equal to it on the CPU and within 1e-6 of it
    on the card (its index_add_ adds with atomics); a second launch
    bit-equal.  The frame's boxes include a fractional one, one running off
    the image and a zero one; capacity 1024 drops segments; the whole-image
    box of 34,240 live points is spread over the blocks of its cluster."""
    args = _depth_cloud_inputs(whole_image)
    rest = (0.01, 6.0, 0.05, capacity)
    args_d = _on_card(args, device)
    n0 = {k.name: k.launches for k in fk.KERNELS}
    got = dc.depth_cloud(*args_d, *rest)
    again = dc.depth_cloud(*args_d, *rest)
    torch.cuda.synchronize()
    assert {k.name: k.launches - n0[k.name] for k in fk.KERNELS} == {
        "depth_cloud": 2, "voxel_downsample": 0, "bbox_cloud": 0,
        "voxel_segment_mean": 0, "cluster_components": 0,
        "min_label_pass": 0, "pointer_jumps": 0}
    want = dc.depth_cloud_plain(*args, *rest)
    card = dc.depth_cloud_plain(*args_d, *rest)
    for name, g, a, w, c in zip(dc.DepthCloud._fields, got, again, want,
                                card):
        assert _bits_equal(g, a), name
        assert _bits_equal(g, w), name
        if g.dtype in (torch.bool, torch.int32):
            assert torch.equal(g, c), name
        else:
            assert float((g - c).abs().max()) <= 1e-6, name
    n_live = int((want.pts_v[..., 2] > 0).sum())
    assert n_live > 1000 and int(want.m2.sum()) > 500
    if whole_image:
        pts, m0 = bp.bbox_point_cloud_plain(*args[:2], args[4], 6.0)
        assert int(m0[-1].sum()) == bp.BBOX_GRID_H * bp.BBOX_GRID_W
        assert bool(got.pts_v[-1, -1, 2] > 0)   # more cells than capacity
    if capacity == 1024:        # the large boxes overflow
        assert bool((got.pts_v[:, -1, 2] > 0).any())


@pytest.mark.parametrize("leaf,capacity,dense", [(0.1, 512, 0),
                                                 (0.05, 64, 0),
                                                 (0.01, 8192, 16384),
                                                 (0.01, 4096, 30000),
                                                 (0.01, 4096, 60000)])
def test_voxel_downsample_equals_plain(device, leaf, capacity, dense):
    """The object downsample in one launch: masks and cells equal, floats
    bit-equal to the plain version on the CPU and within 5e-6 of it on the
    card (a 0.1 m cell holds hundreds of points: the card's atomic sums
    move a centroid by a few ulp of 4 m); a second launch bit-equal; a
    capacity that drops segments; every one of ``dense`` lanes live (16384,
    30000, 60000: a cluster of 3, 4 and 8 blocks a detection)."""
    if dense:
        rng = np.random.default_rng(5)
        pts = torch.from_numpy(rng.uniform(-2.0, 2.0, (4, dense, 3))
                               .astype(np.float32))
        mask = torch.ones((4, dense), dtype=torch.bool)
        mask[3] = False
    else:
        pts, mask = _cluster_inputs()
    n0 = fk.VOXEL_DOWNSAMPLE.launches
    pts_d, mask_d = pts.to(device), mask.to(device)
    got = vx.voxel_downsample_cells(pts_d, mask_d, leaf, capacity)
    again = vx.voxel_downsample_cells(pts_d, mask_d, leaf, capacity)
    out, m = vx.voxel_downsample(pts_d, mask_d, leaf, capacity)
    torch.cuda.synchronize()
    assert fk.VOXEL_DOWNSAMPLE.launches == n0 + 3
    want = vx.voxel_downsample_plain(pts, mask, leaf, capacity)
    card = vx.voxel_downsample_plain(pts_d, mask_d, leaf, capacity)
    for g, a, w in zip(got, again, want):
        assert _bits_equal(g, a) and _bits_equal(g, w)
    assert torch.equal(got[1], card[1]) and torch.equal(got[2], card[2])
    assert float((got[0] - card[0]).abs().max()) <= 5e-6
    assert _bits_equal(out, got[0]) and torch.equal(m, got[2])
    assert int(want[2].sum()) > 50
    if capacity == 64 or dense:
        assert bool(want[2][:, -1].any())


def test_fused_wrappers_refuse_what_the_kernels_do_not_take(device):
    depth, bboxes, pose, plane, cam = _on_card(_depth_cloud_inputs(), device)
    rest = (0.01, 6.0, 0.05, 4096)
    with pytest.raises(TypeError):
        dc.depth_cloud(depth.float(), bboxes, pose, plane, cam, *rest)
    with pytest.raises(TypeError):
        dc.depth_cloud(depth, bboxes.double(), pose, plane, cam, *rest)
    with pytest.raises(ValueError):
        dc.depth_cloud(depth, bboxes.cpu(), pose, plane, cam, *rest)
    with pytest.raises(ValueError):
        dc.depth_cloud(depth, bboxes[:, :3], pose, plane, cam, *rest)
    with pytest.raises(ValueError):
        dc.depth_cloud(depth, bboxes, pose[:4], plane, cam, *rest)
    with pytest.raises(ValueError):
        dc.depth_cloud(depth.T, bboxes, pose, plane, cam, *rest)
    with pytest.raises(ValueError):
        dc.depth_cloud(depth, bboxes, pose, plane, cam, 0.01, 6.0, 0.05, 0)
    big = torch.zeros((1200, 1600), dtype=torch.int32, device=device)
    with pytest.raises(ValueError, match="16-bit"):
        dc.depth_cloud(big, bboxes, pose, plane, cam, *rest)
    pts, mask = _on_card(_cluster_inputs(1024), device)
    with pytest.raises(TypeError):
        vx.voxel_downsample(pts.double(), mask, 0.1, 512)
    with pytest.raises(TypeError):
        vx.voxel_downsample(pts, mask.to(torch.uint8), 0.1, 512)
    with pytest.raises(ValueError):
        vx.voxel_downsample(pts, mask.cpu(), 0.1, 512)
    with pytest.raises(ValueError):
        vx.voxel_downsample(pts[:, :512], mask, 0.1, 512)
    with pytest.raises(ValueError):
        vx.voxel_downsample(pts, mask, 0.1, 0)
