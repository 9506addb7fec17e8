"""The CUDA depth-frontend kernels against their plain PyTorch versions.

Needs an NVIDIA GPU (sm_90a) and nvcc; skipped elsewhere.  The machine
with the card has no JAX, so run this file without the JAX test setup:

    python -m pytest tests/test_torch_frontend_kernels.py --noconftest -q

Inputs: frames of a seeded synthetic scene rendered by the port
(io/synthetic.py), 640x480, a seeded depth image valid at every pixel
(a whole-image box of 34,240 live points), and seeded object clouds for
the symmetry search.  The kernels are built with IEEE
division and without fused multiply-add, in the plain versions' order of
operations, so masks, cells and labels must be EQUAL.  Floats are held bit
for bit against the plain version evaluated on the CPU (whose
``index_add_`` adds in sorted order, like the kernel), and within 1e-6
against the plain version on the card (whose ``index_add_`` adds with
atomics in any order; 5e-6 for the 0.1 m object downsample).  The
symmetry search is held bit for bit against its plain version on the card
(the same libdevice functions, every sum in the kernel's order).  Sparse
symmetry's lanes: depth_cloud with the border attribute and
voxel_downsample with an attribute against their plain versions (the
attribute within the same tolerances as the points), their other outputs
bit-equal to the launches without the lane; the symmetry search with a
source mask bit-equal to its plain version, and with every live point as
a source bit-equal to the search without a mask.
"""
import numpy as np
import pytest
import torch

from object_oriented_slam_tpu_torch.core import se3
from object_oriented_slam_tpu_torch.frontend import (ExtractorConfig,
                                                     extract_local_ellipsoids)
from object_oriented_slam_tpu_torch.frontend import symmetry as sym
from object_oriented_slam_tpu_torch.io import synthetic as syn
from object_oriented_slam_tpu_torch.ops import backproject as bp
from object_oriented_slam_tpu_torch.ops import cluster as cl
from object_oriented_slam_tpu_torch.ops import depth_cloud as dc
from object_oriented_slam_tpu_torch.ops import frontend_kernels as fk
from object_oriented_slam_tpu_torch.ops import voxel as vx

torch.set_num_threads(1)    # the test workers share the CPU

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


def _cluster_inputs(n_lanes=4096):
    depth, bboxes, pose, cam = _frame()
    pts, mask = bp.bbox_point_cloud_plain(depth, bboxes, cam, 6.0)
    world = _world_cpu(_world(pose, torch.device("cpu")))
    key, cmin = vx.voxel_keys(pts, mask, 0.01)
    key_s, order = torch.sort(key, dim=1, stable=True)
    _, _, _, pts_w, m2 = vx.voxel_segment_mean_plain(key_s, order, pts, cmin,
                                                     n_lanes, world)
    return pts_w, m2


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
    others0 = {k.name: k.launches for k in fk.KERNELS
               if k is not fk.CLUSTER_COMPONENTS}
    args_d = _on(device, args)
    for _ in range(2):
        _assert_same(cl.cluster_components(*args_d, 96, 12), want)
    torch.cuda.synchronize()
    assert fk.CLUSTER_COMPONENTS.launches == n0 + 2
    assert {k.name: k.launches for k in fk.KERNELS
            if k is not fk.CLUSTER_COMPONENTS} == others0
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


def _grid_inputs(n_lanes=4096):
    """The depth frame's voxel clouds in the camera frame with their cells
    (the grid path's inputs), the world points and the survivor mask."""
    depth, bboxes, pose, cam = _frame()
    pts, mask = bp.bbox_point_cloud_plain(depth, bboxes, cam, 6.0)
    world = _world_cpu(_world(pose, torch.device("cpu")))
    key, cmin = vx.voxel_keys(pts, mask, 0.01)
    key_s, order = torch.sort(key, dim=1, stable=True)
    pts_v, cells_v, _, pts_w, m2 = vx.voxel_segment_mean_plain(
        key_s, order, pts, cmin, n_lanes, world)
    return pts_v, cells_v, pts_w, m2


def _counts():
    return {k.name: k.launches for k in (*fk.KERNELS, *fk.OPTION_KERNELS)}


@pytest.mark.parametrize("lane", ["exact", "chain1", "chain2", "chain3",
                                  "exact_chain"])
def test_cluster_lanes_equal_plain(device, lane):
    """K5's exact and chain lanes: labels, converged and rounds equal the
    plain version's (the same chain orders, the same uncentred points for
    the exact test), a second launch the same bits, every launch shape and
    the streamed branch the same, a bound of 2 rounds too, and the
    selection epilogue; each launch counts on its lane's counter only."""
    pts_w, m2 = _cluster_inputs()
    exact = lane.startswith("exact")
    chains = int(lane[-1]) if lane[-1].isdigit() else (2 if "chain" in lane
                                                       else -1)
    args, orders = cl.centre_and_seed(pts_w, m2, 0.02, chains, exact,
                                      with_orders=True)
    assert (orders is not None) == ("chain" in lane)
    counter = fk.CLUSTER_CHAIN if orders is not None else fk.CLUSTER_EXACT
    args_d = _on(device, args)
    orders_d = None if orders is None else tuple(t.to(device) for t in orders)
    for outer in (96, 2):
        want = cl.cluster_components_plain(*args, outer, 12, exact, orders)
        before = _counts()
        got = [cl.cluster_components(*args_d, outer, 12, exact=exact,
                                     orders=orders_d) for _ in range(2)]
        torch.cuda.synchronize()
        after = _counts()
        assert {k: after[k] - before[k] for k in after if after[k] !=
                before[k]} == {counter.name: 2}
        for g in got:
            _assert_same(g, want)
        if outer == 96:
            assert bool(want[1].all()) and int(want[2].max()) > 2
        else:
            assert not bool(want[1].all())
    P = cl.LAUNCH_SHAPE[2]
    for shape in ((1, 256, P), (4, 128, P), (8, 512, P)):
        _assert_same(cl._launch(*args_d, 96, 12, None, shape=shape,
                                exact=exact, orders=orders_d)[:3],
                     cl.cluster_components_plain(*args, 96, 12, exact,
                                                 orders))
    least = 13 * m2.shape[1] + 16 * 256
    _assert_same(cl._launch(*args_d, 96, 12, None, smem=least, exact=exact,
                            orders=orders_d)[:3],
                 cl.cluster_components_plain(*args, 96, 12, exact, orders))
    centre = pts_w[:, 0].contiguous()
    s_args = (pts_w, *args[:4], centre, args[4], 96, 12, 100, 0.5)
    want = cl.cluster_select_plain(*s_args, exact=exact, orders=orders)
    got = cl.cluster_select(*_on(device, s_args), exact=exact,
                            orders=orders_d)
    _assert_same(got, want)


def test_cluster_lanes_full_lanes(device):
    """The lanes on clouds that fill 16384 lanes (streamed) with the
    bound of 2 rounds as well: equal to the plain version on the card."""
    rng = np.random.default_rng(5)
    D, N = 3, 16384
    pts = rng.uniform(0.0, 1.0, (D, N, 3)).astype(np.float32)
    pts[..., 2] *= 0.25
    pts[0] = pts[0][np.argsort(pts[0, :, 0], kind="stable")]
    mask = np.ones((D, N), bool)
    mask[1, rng.permutation(N)[:6000]] = False
    mask[2] = False
    pts_t, mask_t = torch.from_numpy(pts), torch.from_numpy(mask)
    for exact, chains in ((True, -1), (False, 3)):
        args, orders = cl.centre_and_seed(pts_t, mask_t, 0.02, chains, exact,
                                          with_orders=True)
        args_d = _on(device, args)
        orders_d = None if orders is None else tuple(t.to(device)
                                                     for t in orders)
        for outer in (96, 2):
            want = cl.cluster_components_plain(*args_d, outer, 12, exact,
                                               orders_d)
            got = cl.cluster_components(*args_d, outer, 12, exact=exact,
                                        orders=orders_d)
            _assert_same(got, want)


def test_cluster_grid_equals_plain(device):
    """K13: the grid pass's labels, converged and rounds equal its plain
    version's on the depth frame's voxel clouds (one launch, nothing read
    back between rounds), with the selection epilogue on the world points
    too, a second launch the same bits, other launch shapes the same, a
    bound of 2 rounds the same, lanes given in a shuffled order (the key
    table is then sorted) the same labels mapped, and it counts on
    ``CLUSTER_GRID`` alone."""
    pts_v, cells_v, pts_w, m2 = _grid_inputs()
    labels0 = cl.grid_seed(pts_v, m2, 0.02)
    centre = pts_w[:, 0].contiguous()
    d = lambda *ts: [t.to(device) for t in ts]    # noqa: E731
    for outer in (96, 2):
        want = cl.cluster_grid_select_plain(pts_v, cells_v, m2, labels0,
                                            pts_w, centre, 0.02, 0.01, outer,
                                            12, 100, 0.5)
        before = _counts()
        for _ in range(2):
            got = cl.cluster_grid_select(*d(pts_v, cells_v, m2, labels0,
                                            pts_w, centre), 0.02, 0.01,
                                         outer, 12, 100, 0.5)
            _assert_same(got, want)
        torch.cuda.synchronize()
        after = _counts()
        assert {k: after[k] - before[k] for k in after
                if after[k] != before[k]} == {"cluster_grid": 2}
        if outer == 96:
            settled = want
            assert bool(want[3].all()) and int(want[4].max()) > 2
            _assert_same(cl.cluster_grid(*d(pts_v, cells_v, m2, labels0),
                                         0.02, 0.01, 96, 12), want[2:])
            for shape in ((1, 256), (2, 128), (3, 128), (4, 512), (8, 64)):
                _assert_same(cl._launch_grid(*d(pts_v, cells_v, m2,
                                                 labels0), 0.02, 0.01, 96, 12,
                                              shape=shape)[:3], want[2:])
        else:
            assert not bool(want[3].all())
    # the grid labels are the exact dense pass's
    e_args = cl.centre_and_seed(pts_v, m2, 0.02, 0, exact=True)
    exact = cl.cluster_components_plain(*e_args, 96, 12, True)
    assert torch.equal(settled[2], exact[0])
    # a shuffled lane order: the same components, labels the least lane
    perm = torch.randperm(m2.shape[1], generator=torch.Generator().manual_seed(0))
    inv = torch.argsort(perm)
    sp, sc, sm = pts_v[:, perm], cells_v[:, perm], m2[:, perm]
    lab = cl.cluster_grid(*d(sp.contiguous(), sc.contiguous(),
                             sm.contiguous(), cl.grid_seed(sp, sm, 0.02)),
                          0.02, 0.01, 96, 12)[0].cpu()
    plain = cl.cluster_grid_plain(sp, sc, sm, cl.grid_seed(sp, sm, 0.02),
                                  0.02, 0.01, 96, 12)[0]
    assert torch.equal(lab, plain)
    back = torch.where(lab < m2.shape[1],
                       inv[lab.clamp(max=m2.shape[1] - 1).long()], lab)
    for k in range(m2.shape[0]):
        live = m2[k]
        # the partition is the same: each original root maps to one label
        pairs = set(zip(settled[2][k][live].tolist(),
                        back[k][inv][live].tolist()))
        assert len(pairs) == len({a for a, _ in pairs}) == len(
            {b for _, b in pairs})


def test_cluster_grid_full_tier_and_refusals(device):
    """K13 at 16384 lanes a detection (a dense voxel block, every lane
    live, in cell order and shuffled), under a bound of 2 rounds too, and
    what it refuses."""
    rng = np.random.default_rng(9)
    raw = (rng.uniform(0.0, 0.3, (60000, 3)) + [0, 0, 1.5]).astype(np.float32)
    pts, cells, mask = vx.voxel_downsample_cells(
        torch.from_numpy(raw)[None], torch.ones(1, 60000, dtype=torch.bool),
        0.01, 16384)
    pts, cells, mask = (t.repeat(2, *([1] * (t.dim() - 1)))
                        for t in (pts, cells, mask))
    perm = torch.randperm(16384, generator=torch.Generator().manual_seed(1))
    pts[1], cells[1], mask[1] = pts[1, perm], cells[1, perm], mask[1, perm]
    mask[1, :3000] = False
    labels0 = cl.grid_seed(pts, mask, 0.02)
    d = [t.to(device) for t in (pts, cells, mask, labels0)]
    for outer in (96, 2):
        want = cl.cluster_grid_plain(*d, 0.02, 0.01, outer, 12)
        _assert_same(cl.cluster_grid(*d, 0.02, 0.01, outer, 12), want)
    with pytest.raises(ValueError, match="124"):
        cl.cluster_grid(*d, 0.08, 0.01, 96, 12)
    with pytest.raises(TypeError):
        cl.cluster_grid(d[0], d[1].long(), d[2], d[3], 0.02, 0.01, 96, 12)
    with pytest.raises(ValueError):
        cl.cluster_grid(d[0], d[1].cpu(), d[2], d[3], 0.02, 0.01, 96, 12)
    with pytest.raises(ValueError, match="lanes"):
        cl._launch_grid(*(torch.zeros((1, 20000, 3), device=device),
                          torch.zeros((1, 20000, 3), dtype=torch.int32,
                                      device=device),
                          torch.zeros((1, 20000), dtype=torch.bool,
                                      device=device),
                          torch.zeros((1, 20000), dtype=torch.int32,
                                      device=device)), 0.02, 0.01, 96, 12)
    # a launch the card refuses raises; nothing falls back: a cluster of
    # 16 blocks, more threads than the kernel's bound
    for shape in ((16, 256), (1, 1024)):
        with pytest.raises(RuntimeError, match="cluster_grid"):
            cl._launch_grid(*d, 0.02, 0.01, 96, 12, shape=shape)


def _grid_case(name):
    """Inputs of K13's cases on the card: (pts, cells, mask, outer_iters,
    smem or None).  ``shuffled``: the depth frame's voxel clouds with the
    lanes in random order (the key table is sorted); ``ties``: clouds where
    pairs of survivors share a cell (the least lane takes it), one of them
    shuffled; ``sizes``: detections of 1, 31, 32 and 33 survivors on 6 x 6
    x 2 cm slabs and an all-masked one; ``inside`` / ``past``: one
    detection of 1024 live voxels with exactly the shared memory its lists
    need beside the least K13 takes (the lists take the staged points'
    room), and one byte less (the lists in device memory); ``lanes16384``: voxel surfaces that fill 16384 lanes;
    ``truncated``: the depth frame under a bound of 3 rounds."""
    if name in ("shuffled", "truncated"):
        pts, cells, _, mask = _grid_inputs()
        if name == "truncated":
            return pts, cells, mask, 3, None
        perm = torch.randperm(mask.shape[1],
                              generator=torch.Generator().manual_seed(2))
        return pts[:, perm], cells[:, perm], mask[:, perm], 96, None
    rng = np.random.default_rng(12)
    if name == "ties":
        D, N = 3, 600
        base = rng.uniform(0.0, 0.12, (D, N // 2, 3)).astype(np.float32)
        pts = np.concatenate(
            [base, base + rng.uniform(-0.002, 0.002, base.shape)
             .astype(np.float32)], 1)
        pts[2] = pts[2][rng.permutation(N)]
        pts = torch.from_numpy(pts)
        cells = torch.floor(pts / 0.01).to(torch.int32)
        mask = torch.from_numpy(rng.random((D, N)) > 0.1)
        return pts, cells, mask, 96, None
    if name == "sizes":
        D, N = 5, 128
        pts = (rng.uniform(0.0, 1.0, (D, N, 3)) * [0.06, 0.06, 0.02]
               + [0.0, 0.0, 1.0]).astype(np.float32)
        mask = np.zeros((D, N), bool)
        for k, n in enumerate((1, 31, 32, 33, 0)):
            mask[k, rng.choice(N, n, replace=False)] = True
        pts = torch.from_numpy(pts)
        return (pts, torch.floor(pts / 0.01).to(torch.int32),
                torch.from_numpy(mask), 96, None)
    if name in ("inside", "past"):
        raw = (rng.uniform(0.0, 0.2, (40000, 3)) + [0, 0, 1.5]).astype(
            np.float32)
        pts, cells, mask = vx.voxel_downsample_cells(
            torch.from_numpy(raw)[None],
            torch.ones(1, 40000, dtype=torch.bool), 0.01, 1024)
        assert bool(mask.all())
        nbr = cl.grid_neighbours_plain(pts, cells, mask, 0.02, 0.01)
        hits = int((nbr != torch.arange(1024)[None, :, None]).sum())
        smem = cl.grid_smem_least(1024) + 2 * hits - (name == "past")
        return pts, cells, mask, 96, smem
    assert name == "lanes16384"
    pts, cells, mask = dense_voxel_clouds(3, 16384, 5)
    return pts, cells, mask, 96, None


def dense_voxel_clouds(D, N, seed):
    """Wavy voxel surfaces 1.6 m across (1 cm cells, camera frame) that
    fill N lanes, 10 % of the lanes masked (chip_smoke.dense_voxel_clouds'
    recipe)."""
    rng = np.random.default_rng(seed)
    M = 12 * N
    u = rng.uniform(-0.8, 0.8, (D, M, 2))
    z = 2.0 + 0.05 * np.sin(9 * u[..., 0]) * np.cos(7 * u[..., 1])
    raw = np.concatenate([u, z[..., None]], -1).astype(np.float32)
    pts, cells, mask = vx.voxel_downsample_cells(
        torch.from_numpy(raw), torch.ones((D, M), dtype=torch.bool), 0.01, N)
    mask = mask & torch.from_numpy(rng.random((D, N)) >= 0.1)
    return pts.contiguous(), cells.contiguous(), mask.contiguous()


@pytest.mark.parametrize("case", ["shuffled", "ties", "sizes", "inside",
                                  "past", "lanes16384", "truncated"])
def test_cluster_grid_cases_equal_plain(device, case):
    """K13 against its plain version on each case of ``_grid_case``:
    labels, converged, rounds and the selection's sel and ok equal, a
    second launch bit-equal, at the default launch shape and at clusters of
    1, 2, 4 and 8 blocks."""
    pts, cells, mask, outer, smem = _grid_case(case)
    labels0 = cl.grid_seed(pts, mask, 0.02)
    pts_w = (pts + torch.tensor([0.3, -0.2, 0.1])).contiguous()
    centre = pts_w[:, 0].contiguous()
    args = (pts.contiguous(), cells.contiguous(), mask.contiguous(), labels0,
            pts_w, centre)
    want = cl.cluster_grid_select_plain(*args, 0.02, 0.01, outer, 12, 100,
                                        0.5)
    if case == "truncated":
        assert not bool(want[3].all())
    elif case in ("shuffled", "ties", "sizes", "lanes16384"):
        assert bool(want[3].all()) and int(want[4].max()) > 2
    a = [t.to(device) for t in args]
    runs = [cl.cluster_grid_select(*a, 0.02, 0.01, outer, 12, 100, 0.5)
            for _ in range(2)]
    for shape in ((1, 512), (2, 256), (4, 128), (8, 512)):
        lab, conv, rounds, sel, ok = cl._launch_grid(
            *a[:4], 0.02, 0.01, outer, 12, (a[4], a[5], 100, 0.5),
            shape=shape, smem=smem)
        runs.append((sel, ok, lab, conv, rounds))
    torch.cuda.synchronize()
    for got in runs:
        _assert_same(got, want)
    assert all(_bits_equal(x, y) for x, y in zip(runs[0], runs[1]))


@pytest.mark.parametrize("option", [dict(grid_cluster=True),
                                    dict(cluster_chains=2)])
def test_extraction_with_cluster_options_on_card(device, option):
    """The extraction call with ``grid_cluster`` (K13) or
    ``cluster_chains=2`` (K5's chain lane) on the card: three launches, the
    option's clustering kernel among them and K5 not, and the rows of the
    CPU's plain path (valid flags equal, centre 1e-4, scale 1e-3, as
    ``test_extraction_on_card_matches_cpu``)."""
    depth, bboxes, pose, cam = _frame()
    cfg = ExtractorConfig(**option)
    run = torch.ones(len(bboxes), dtype=torch.bool)
    plane = torch.tensor([0.0, 0.0, 1.0, 0.0])
    pose_t = torch.as_tensor(pose, dtype=torch.float32)
    before = _counts()
    got = extract_local_ellipsoids(depth.to(device), bboxes.to(device),
                                   run.to(device), pose_t.to(device),
                                   plane.to(device), cam, cfg)
    torch.cuda.synchronize()
    after = _counts()
    lane = "cluster_grid" if "grid_cluster" in option else \
        "cluster_components_chain"
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {"depth_cloud": 1, lane: 1,
                                          "voxel_downsample": 1}
    want = extract_local_ellipsoids(depth, bboxes, run, pose_t, plane, cam,
                                    cfg)
    assert torch.equal(got[2].cpu(), want[2]) and int(want[2].sum()) >= 3
    v = want[2]
    assert float((got[0].cpu()[v, :3] - want[0][v, :3]).abs().max()) < 1e-4
    assert float((got[0].cpu()[v, 7:].sort(1).values
                  - want[0][v, 7:].sort(1).values).abs().max()) < 1e-3


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
    # three launches; no symmetry search without open_symmetry
    assert {k.name: k.launches - before[k.name] for k in fk.KERNELS} == {
        "depth_cloud": 1, "cluster_components": 1, "voxel_downsample": 1,
        "symmetry_search": 0}
    want = extract_local_ellipsoids(depth, bboxes, run, pose_t, plane, cam,
                                    cfg)
    assert torch.equal(got[2].cpu(), want[2]) and int(want[2].sum()) >= 3
    v = want[2]
    # PCA sums run in another order on the card: centre 1e-4, scale 1e-3
    assert float((got[0].cpu()[v, :3] - want[0][v, :3]).abs().max()) < 1e-4
    assert float((got[0].cpu()[v, 7:].sort(1).values
                  - want[0][v, 7:].sort(1).values).abs().max()) < 1e-3


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
        "depth_cloud": 2, "voxel_downsample": 0, "cluster_components": 0,
        "symmetry_search": 0}
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


def _sym_inputs(dev, lanes=512, seed=3):
    """Four detections for the symmetry search: a reflection-symmetric cloud
    seen from afar (type 1), a random cloud under a near camera whose box
    and depth occlude part of its mirror (type 2), a cloud of type 0 and
    one off the run mask; live lanes scattered."""
    rng = np.random.default_rng(seed)
    half = rng.uniform(-0.3, 0.3, (200, 3)).astype(np.float32)
    half = half[half[:, 1] > 0.02][:100]
    sym_cloud = np.concatenate([half, half * np.float32([1, -1, 1])])
    rand = rng.uniform(-0.2, 0.2, (lanes, 3)).astype(np.float32)
    pts = np.zeros((4, lanes, 3), np.float32)
    mask = np.zeros((4, lanes), bool)
    for d, cloud in enumerate((sym_cloud, rand, sym_cloud, rand[:50])):
        idx = rng.permutation(lanes)[:len(cloud)]
        pts[d, idx], mask[d, idx] = cloud, True
    bbox = np.array([[0, 0, 1, 1], [0, 0, 639, 479]] * 2, np.float32)
    pose = np.array([[0, 0, -50, 0, 0, 0, 1], [0.1, 0.05, -1.5, 0, 0, 0, 1]]
                    * 2, np.float32)
    depth = np.full((480, 640), 7000, np.int32)
    depth[:, :300] = 0
    types = torch.tensor([1, 2, 0, 1], dtype=torch.int32)
    run = torch.tensor([True, True, True, False])
    return [t.to(dev) for t in (torch.from_numpy(pts), torch.from_numpy(mask),
                                torch.from_numpy(bbox), torch.from_numpy(pose),
                                torch.from_numpy(depth), types, run)]


def _sym_ties(dev):
    """_sym_inputs with three points of each searched cloud repeated three
    times: a mirrored point whose nearest live point is one of them ties
    three ways, so the tie count and the tie sums run past two terms."""
    pts, mask, *rest = _sym_inputs(torch.device("cpu"))
    for d in (0, 1):
        live = mask[d].nonzero().flatten()
        for k in range(3):
            pts[d, live[3 * k + 1:3 * k + 3]] = pts[d, live[3 * k]].clone()
    return [t.to(dev) for t in (pts, mask, *rest)]


def _sym_capacity(dev, D=8, S=512, seed=7):
    """sym_capacity filled: D dual detections of S live points each, half
    of each cloud mirrored across y = 0 and jittered, under a near camera
    over a wall that occludes part of the mirror."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((D, S, 3), np.float32)
    for d in range(D):
        half = rng.uniform(-0.4, 0.4, (S // 2, 3)).astype(np.float32)
        half[:, 1] = np.abs(half[:, 1]) * 0.5 + 0.01
        pts[d] = np.concatenate([half, half * np.float32([1, -1, 1])])
        pts[d] += rng.normal(0, 0.005, (S, 3)).astype(np.float32)
    bbox = np.tile(np.float32([120, 80, 520, 400]), (D, 1))
    pose = np.tile(np.float32([0.1, -0.05, -2.5, 0, 0, 0, 1]), (D, 1))
    depth = np.full((480, 640), 11000, np.int32)
    depth[:, :260] = 0
    return [torch.from_numpy(t).to(dev) for t in (
        pts, np.ones((D, S), bool), bbox, pose, depth)] + [
        torch.full((D,), 2, dtype=torch.int32, device=dev),
        torch.ones(D, dtype=torch.bool, device=dev)]


def _sym_ragged(dev, counts=(1, 255, 257, 511, 2048), types=(2, 1, 2, 1, 2),
                seed=5):
    """Live counts that leave the kernel's tiles of mirrored points partly
    filled, up to SYM_MAX_POINTS (a dual detection of 2048 points mirrors
    4096), single and dual detections mixed, lanes scattered; the near
    camera and the wall of _sym_inputs."""
    rng = np.random.default_rng(seed)
    S = fk.SYM_MAX_POINTS
    pts = np.zeros((len(counts), S, 3), np.float32)
    mask = np.zeros((len(counts), S), bool)
    for d, n in enumerate(counts):
        idx = rng.permutation(S)[:n]
        pts[d, idx] = rng.uniform(-0.25, 0.25, (n, 3)).astype(np.float32)
        mask[d, idx] = True
    D = len(counts)
    bbox = np.tile(np.float32([0, 0, 639, 479]), (D, 1))
    pose = np.tile(np.float32([0.1, 0.05, -1.5, 0, 0, 0, 1]), (D, 1))
    depth = np.full((480, 640), 7000, np.int32)
    depth[:, :300] = 0
    return [torch.from_numpy(t).to(dev) for t in (pts, mask, bbox, pose,
                                                  depth)] + [
        torch.tensor(types, dtype=torch.int32, device=dev),
        torch.ones(D, dtype=torch.bool, device=dev)]


def _sym_sparse(base, dev, seed=13):
    """``base``'s inputs with a source mask: about half of each cloud's live
    points, scattered, and a few lanes that are not live (only the live
    points the mask holds are mirrored).  Returns (inputs, src_mask)."""
    args = base(torch.device("cpu"))
    mask = args[1]
    rng = np.random.default_rng(seed)
    pick = torch.from_numpy(rng.random(tuple(mask.shape)) < 0.5)
    stray = torch.from_numpy(rng.random(tuple(mask.shape)) < 0.05)
    src = (mask & pick) | (~mask & stray)
    return [t.to(dev) for t in args], src.to(dev)


_SYM_SPARSE_CASES = {
    "sparse-path": lambda dev: _sym_sparse(_sym_inputs, dev),
    "sparse-capacity": lambda dev: _sym_sparse(_sym_capacity, dev)}


_SYM_CASES = {"path": _sym_inputs, "ties": _sym_ties,
              "capacity": _sym_capacity, "ragged": _sym_ragged}


@pytest.mark.parametrize("case,analytic,iters", [
    pytest.param("path", True, 5, id="analytic"),
    pytest.param("path", False, 5, id="central"),
    *(pytest.param("path", an, it, id=f"iters{it}-{name}")
      for it in (1, 8) for an, name in ((True, "analytic"),
                                        (False, "central"))),
    pytest.param("ties", True, 5, id="ties-analytic"),
    pytest.param("ties", False, 5, id="ties-central"),
    pytest.param("capacity", True, 5, id="capacity-analytic"),
    pytest.param("capacity", False, 5, id="capacity-central"),
    pytest.param("ragged", True, 5, id="ragged-analytic")])
def test_symmetry_search_equals_plain(device, case, analytic, iters):
    """One launch for every detection, initial plane and LM iteration,
    bit-equal to the plain version on the card and to a second launch;
    no search for type 0 or off the run mask.  The cases: the path's
    clouds (whose plain search rejects some LM steps and accepts others,
    tests/test_torch_symmetry.py), with 1, 5 and 8 iterations; the same
    with three-way ties; sym_capacity filled; ragged live counts up to
    SYM_MAX_POINTS."""
    from object_oriented_slam_tpu_torch.core.camera import Camera
    cam = Camera(fx=535.4, fy=539.2, cx=320.1, cy=247.6, scale=5000.0)
    args = _SYM_CASES[case](device)
    cfg = sym.SymmetryConfig(analytic_grad=analytic, iters=iters)
    n0 = fk.SYMMETRY_SEARCH.launches
    got = sym.estimate_symmetry(*args[:6], args[6], cam, cfg)
    again = sym.estimate_symmetry(*args[:6], args[6], cam, cfg)
    torch.cuda.synchronize()
    assert fk.SYMMETRY_SEARCH.launches == n0 + 2
    want = sym.estimate_symmetry_plain(
        *args[:4], bp.proj_depth_map(args[4], cam), args[5], args[6], cam,
        cfg)
    for name, g, a, w in zip(sym.SymSearch._fields, got, again, want):
        assert _bits_equal(g, a), name
        assert _bits_equal(g, w), (name, float((g - w).abs().max()))
    searched = (args[6] & (args[5] > 0)).cpu()
    prob = got.prob.cpu()
    assert bool((prob[searched] > 0).all() and (prob[searched] <= 1).all())
    assert not bool(prob[~searched].any())
    assert not bool(got.inits.cpu()[~searched].any())
    if case == "path":
        assert float(prob[1]) < 1


def test_symmetry_search_refuses_what_it_does_not_take(device):
    from object_oriented_slam_tpu_torch.core.camera import Camera
    cam = Camera(fx=535.4, fy=539.2, cx=320.1, cy=247.6, scale=5000.0)
    args = _sym_inputs(device)
    with pytest.raises(TypeError):
        sym.estimate_symmetry(args[0].double(), *args[1:], cam)
    with pytest.raises(ValueError):
        sym.estimate_symmetry(*args[:5], args[5].cpu(), args[6], cam)
    big = _sym_inputs(device, lanes=fk.SYM_MAX_POINTS + 1)
    with pytest.raises(ValueError):
        sym.estimate_symmetry(*big, cam)


def test_extraction_with_symmetry_on_card(device):
    """open_symmetry on the card: four launches (the search once, both
    variants), the CPU's valid flags, finite results."""
    scene = syn.make_scene(n_objects=6, seed=7, radius_range=(1.3, 2.2),
                           scale_range=(0.2, 0.4),
                           labels=[28, 57, 58, 28, 63, 59])
    pose = syn.orbit_trajectory(12, 3.6, 1.7)[0]
    depth = syn.render_depth(scene.ellipsoids, pose, scene.camera)
    bbs, vis = syn.project_bboxes(scene.ellipsoids.astype(np.float32),
                                  pose.astype(np.float32), scene.camera)
    types = torch.from_numpy(sym.sym_type_of_labels(scene.labels[vis.numpy()]))
    cfg = ExtractorConfig(open_symmetry=True)
    args = (depth, bbs[vis], torch.ones(len(types), dtype=torch.bool),
            torch.as_tensor(pose, dtype=torch.float32),
            torch.tensor([0.0, 0.0, 1.0, 0.0]))
    before = {k.name: k.launches for k in fk.KERNELS}
    got = extract_local_ellipsoids(*(t.to(device) for t in args),
                                   scene.camera, cfg, sym_types=types.to(
                                       device))
    torch.cuda.synchronize()
    assert {k.name: k.launches - before[k.name] for k in fk.KERNELS} == {
        "depth_cloud": 1, "cluster_components": 1, "voxel_downsample": 1,
        "symmetry_search": 1}
    want = extract_local_ellipsoids(*args, scene.camera, cfg,
                                    sym_types=types)
    assert torch.equal(got[2].cpu(), want[2]) and int(want[2].sum()) >= 3
    assert bool(torch.isfinite(got[0]).all())
    assert bool(((got[1] > 0) & (got[1] <= 1)).all())


@pytest.mark.parametrize("case,analytic", [
    ("sparse-path", True), ("sparse-path", False),
    ("sparse-capacity", True)])
def test_symmetry_search_with_sources_equals_plain(device, case, analytic):
    """Sparse symmetry: the search with a source mask (half the live points
    mirrored, every live point the 1-NN reference) bit-equal to its plain
    version on the card and to a second launch; the mask changes the
    result; with every live point a source it is the search without a
    mask, bit for bit."""
    from object_oriented_slam_tpu_torch.core.camera import Camera
    cam = Camera(fx=535.4, fy=539.2, cx=320.1, cy=247.6, scale=5000.0)
    args, src = _SYM_SPARSE_CASES[case](device)
    cfg = sym.SymmetryConfig(analytic_grad=analytic)
    n0 = fk.SYMMETRY_SEARCH.launches
    got = sym.estimate_symmetry(*args, cam, cfg, src)
    again = sym.estimate_symmetry(*args, cam, cfg, src)
    every = sym.estimate_symmetry(*args, cam, cfg, args[1].clone())
    dense = sym.estimate_symmetry(*args, cam, cfg)
    torch.cuda.synchronize()
    assert fk.SYMMETRY_SEARCH.launches == n0 + 4
    want = sym.estimate_symmetry_plain(
        *args[:4], bp.proj_depth_map(args[4], cam), args[5], args[6], cam,
        cfg, src)
    for name, g, a, w, e, d in zip(sym.SymSearch._fields, got, again, want,
                                   every, dense):
        assert _bits_equal(g, a), name
        assert _bits_equal(g, w), (name, float((g - w).abs().max()))
        assert _bits_equal(e, d), name
    searched = (args[6] & (args[5] > 0)).cpu()
    assert not torch.equal(got.inits.cpu()[searched],
                           dense.inits.cpu()[searched])


def _border_depth():
    """_full_depth with steps that touch the image's edges: the left 4
    columns and the top 2 rows 1 m nearer, a hole at the bottom right
    corner; the border test wraps there (column 0 against column 639, row
    0 against row 479)."""
    d = _full_depth().clone()
    d[:, :4] -= 5000
    d[:2] -= 5000
    d[470:, 630:] = 0
    return d


@pytest.mark.parametrize("capacity,whole_image", [(4096, False),
                                                  (16384, True)])
def test_depth_cloud_border_equals_plain(device, capacity, whole_image):
    """Sparse symmetry's depth_cloud: one launch that also averages each
    voxel's depth-border flag.  The flags' means (battr_v) bit-equal to the
    plain version (the image's border map, sampled at the boxes' pixels,
    averaged per voxel) on the CPU and within 1e-6 of it on the card; the
    other outputs bit-equal to depth_cloud without the lane.  The whole
    image case has discontinuities at the image's edges, where the test
    wraps."""
    args = list(_depth_cloud_inputs(whole_image))
    if whole_image:
        args[0] = _border_depth()
    rest = (0.01, 6.0, 0.05, capacity)
    args_d = _on_card(args, device)
    n0 = fk.DEPTH_CLOUD.launches
    got, battr = dc.depth_cloud_border(*args_d, *rest)
    again, battr2 = dc.depth_cloud_border(*args_d, *rest)
    bare = dc.depth_cloud(*args_d, *rest)
    torch.cuda.synchronize()
    assert fk.DEPTH_CLOUD.launches == n0 + 3
    want, wattr = dc.depth_cloud_border_plain(*args, *rest)
    _, cattr = dc.depth_cloud_border_plain(*args_d, *rest)
    for name, g, b in zip(dc.DepthCloud._fields, got, bare):
        assert _bits_equal(g, b), name
    assert _bits_equal(battr, battr2) and _bits_equal(battr, wattr)
    assert float((battr - cattr).abs().max()) <= 1e-6
    live = want.pts_v[..., 2] > 0
    assert not bool(wattr[~live].any())
    assert int((wattr > 0).sum()) > 50 and bool((wattr[live] < 1).any())
    if whole_image:
        from object_oriented_slam_tpu_torch.ops import filters
        border = filters.depth_border_mask(args[0], args[4].scale)
        assert bool(border[300, 0]) and bool(border[0, 300])


@pytest.mark.parametrize("leaf,capacity", [(0.1, 512), (0.05, 64)])
def test_voxel_downsample_attrs_equals_plain(device, leaf, capacity):
    """The object downsample with sparse symmetry's attribute (the voxels'
    border means from depth_cloud_border_plain): the attribute means
    bit-equal to the plain version on the CPU and within 5e-6 of it on the
    card; points, cells and mask bit-equal to the launch without it."""
    args = _depth_cloud_inputs()
    cloud, battr = dc.depth_cloud_border_plain(*args, 0.01, 6.0, 0.05, 4096)
    pts, mask, attrs = (t.to(device) for t in (cloud.pts_w, cloud.m2, battr))
    n0 = fk.VOXEL_DOWNSAMPLE.launches
    got = vx.voxel_downsample_full(pts, attrs, mask, leaf, capacity)
    again = vx.voxel_downsample_full(pts, attrs, mask, leaf, capacity)
    short = vx.voxel_downsample_attrs(pts, attrs, mask, leaf, capacity)
    bare = vx.voxel_downsample_cells(pts, mask, leaf, capacity)
    torch.cuda.synchronize()
    assert fk.VOXEL_DOWNSAMPLE.launches == n0 + 4
    want = vx.voxel_downsample_full_plain(cloud.pts_w, battr, cloud.m2, leaf,
                                          capacity)
    card = vx.voxel_downsample_full_plain(pts, attrs, mask, leaf, capacity)
    for g, a, w in zip(got, again, want):
        assert _bits_equal(g, a) and _bits_equal(g, w)
    assert float((got[1] - card[1]).abs().max()) <= 5e-6
    for g, b in zip((got[0], got[2], got[3]), bare):
        assert _bits_equal(g, b)
    assert _bits_equal(short[1], got[1]) and _bits_equal(short[0], got[0])
    assert int(((want[1] > 0) & want[3]).sum()) > 5


def test_attribute_lanes_refuse_what_they_do_not_take(device):
    pts, mask = _on_card(_cluster_inputs(1024), device)
    attrs = torch.zeros(mask.shape, device=device)
    with pytest.raises(TypeError):
        vx.voxel_downsample_full(pts, attrs.double(), mask, 0.1, 512)
    with pytest.raises(ValueError):
        vx.voxel_downsample_attrs(pts, attrs[:, :512], mask, 0.1, 512)
    from object_oriented_slam_tpu_torch.core.camera import Camera
    cam = Camera(fx=535.4, fy=539.2, cx=320.1, cy=247.6, scale=5000.0)
    args = _sym_inputs(device)
    with pytest.raises(TypeError):
        sym.estimate_symmetry(*args, cam, sym.SymmetryConfig(),
                              args[1].to(torch.uint8))
    with pytest.raises(ValueError):
        sym.estimate_symmetry(*args, cam, sym.SymmetryConfig(),
                              args[1][:, :100].contiguous())


def test_extraction_with_sparse_symmetry_on_card(device):
    """sparse_symmetry on the card: the same four launches as open_symmetry
    (the border lane rides depth_cloud and voxel_downsample, the sources
    the search), the CPU's valid flags and source counts, finite
    results."""
    scene = syn.make_scene(n_objects=6, seed=7, radius_range=(1.3, 2.2),
                           scale_range=(0.2, 0.4),
                           labels=[28, 57, 58, 28, 63, 59])
    pose = syn.orbit_trajectory(12, 3.6, 1.7)[0]
    depth = syn.render_depth(scene.ellipsoids, pose, scene.camera)
    bbs, vis = syn.project_bboxes(scene.ellipsoids.astype(np.float32),
                                  pose.astype(np.float32), scene.camera)
    types = torch.from_numpy(sym.sym_type_of_labels(scene.labels[vis.numpy()]))
    cfg = ExtractorConfig(open_symmetry=True, sparse_symmetry=True)
    args = (depth, bbs[vis], torch.ones(len(types), dtype=torch.bool),
            torch.as_tensor(pose, dtype=torch.float32),
            torch.tensor([0.0, 0.0, 1.0, 0.0]))
    before = {k.name: k.launches for k in fk.KERNELS}
    st, st_cpu = {}, {}
    got = extract_local_ellipsoids(*(t.to(device) for t in args),
                                   scene.camera, cfg, st,
                                   sym_types=types.to(device))
    torch.cuda.synchronize()
    assert {k.name: k.launches - before[k.name] for k in fk.KERNELS} == {
        "depth_cloud": 1, "cluster_components": 1, "voxel_downsample": 1,
        "symmetry_search": 1}
    want = extract_local_ellipsoids(*args, scene.camera, cfg, st_cpu,
                                    sym_types=types)
    assert torch.equal(got[2].cpu(), want[2]) and int(want[2].sum()) >= 3
    assert bool(torch.isfinite(got[0]).all())
    assert bool(((got[1] > 0) & (got[1] <= 1)).all())
    for k in ("sym_sources", "sym_points", "sym_dense"):
        assert int(st[k]) == int(st_cpu[k]), k
    assert int(st["sym_sources"]) < int(st["sym_points"])


def test_pipelined_frames_wait_only_on_events(device):
    """Eight frames of the depth path at pipeline depth 4 on the card, each
    grab under PyTorch's synchronisation check set to raise: every copy of
    a frame is pinned and asynchronous, and the host waits only on the
    events of the due fetch and the backend drain.  Two frames before them
    latch the plane (the asynchronous plane defers the first to the
    second's grab).  After the flush the map equals the eager run's within
    1e-4 (tests/test_torch_pipeline.py's bound)."""
    import os

    from object_oriented_slam_tpu_torch.frontend import (
        make_extractor, make_plane_estimator)
    from object_oriented_slam_tpu_torch.system import System
    yaml = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "object_oriented_slam_tpu_torch", "configs",
                        "synthetic_depth.yaml")
    scene = syn.make_scene(n_objects=8, seed=7, radius_range=(1.3, 2.2),
                           scale_range=(0.2, 0.4))
    frames = list(syn.SyntheticDataset(scene, n_frames=10, orbit_radius=3.6,
                                       height=1.7,
                                       depth_device=device).frames())

    def run(depth_n, checked):
        cam = scene.camera
        slam = System(yaml, extractor=make_extractor(cam, ExtractorConfig(),
                                                     device),
                      plane_estimator=make_plane_estimator(cam,
                                                           device=device),
                      device=device)
        slam.tracker.pipeline_depth = depth_n
        slam.tracker.adaptive_depth = False
        slam.open_ground_plane_estimation()
        for i, ts, pose, depth, rgb, det in frames:
            if checked and i >= 2:
                assert slam.tracker.state.ground_state == 2
                torch.cuda.set_sync_debug_mode("error")
            try:
                slam.track_with_objects(ts, pose, det, depth=depth)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return slam

    before = fk.DEPTH_CLOUD.launches
    piped = run(4, True)
    assert fk.DEPTH_CLOUD.launches - before == 10
    assert len(piped.tracker._pending_extraction) == 3
    got, want = piped.map_objects, run(1, False).map_objects
    assert sorted(got) == sorted(want) and len(want) >= 6
    for inst in want:
        np.testing.assert_allclose(got[inst], want[inst], atol=1e-4)


def _batch_inputs(B=3):
    """B frames of _frame's scene along the orbit (frames 5, 15, 25 of 40),
    for depth_cloud's frame lane: (depths [B, H, W] int32, boxes [D, 4] of
    every frame flattened, poses [B, 7], frame index [D] int32, camera).
    The middle frame also carries a box along its first rows and one along
    its last rows, where the border test wraps (inside the frame)."""
    depths, boxes, poses, frame = [], [], [], []
    for b, k in enumerate((5, 15, 25)[:B]):
        depth, bboxes, pose, cam = _frame(frame=k)
        if b == 1:
            bboxes = torch.cat([bboxes, torch.tensor([[40.0, 0.0, 600.0, 7.0],
                                                      [40.0, 470.0, 600.0,
                                                       480.0]])])
        depths.append(depth)
        boxes.append(bboxes)
        poses.append(torch.as_tensor(pose, dtype=torch.float32))
        frame.append(torch.full((len(bboxes),), b, dtype=torch.int32))
    return (torch.stack(depths), torch.cat(boxes), torch.stack(poses),
            torch.cat(frame), cam)


@pytest.mark.parametrize("border", [False, True])
def test_depth_cloud_frame_lane_equals_per_frame_launches(device, border):
    """The offline batch mapper's frame lane: ONE launch over the
    detections of three frames (depth [B, H, W], poses [B, 7], each
    detection's frame index), bit-equal to each frame's own launch (R is
    then one rotation a detection, its frame's), masks, cells and flags
    equal to the frame-indexed plain version on the card and floats within
    1e-6 of it (5e-6 on the border means is not needed: 1e-6), bit-equal
    to it on the CPU."""
    depths, boxes, poses, frame, cam = _batch_inputs()
    plane = torch.tensor([0.001, -0.002, 1.0, -0.0005])
    rest = (0.01, 6.0, 0.05, 4096)
    fn = dc.depth_cloud_border if border else dc.depth_cloud
    plain = dc.depth_cloud_border_plain if border else dc.depth_cloud_plain
    args_d = _on_card((depths, boxes, poses, plane, cam), device)
    frame_d = frame.to(device)

    def flat(out):
        return (*out[0], out[1]) if border else tuple(out)
    n0 = fk.DEPTH_CLOUD.launches
    got = flat(fn(*args_d, *rest, frame=frame_d))
    assert fk.DEPTH_CLOUD.launches == n0 + 1
    again = flat(fn(*args_d, *rest, frame=frame_d))
    want = flat(plain(depths, boxes, poses, plane, cam, *rest, frame=frame))
    card = flat(plain(*args_d, *rest, frame=frame_d))
    fields = (*dc.DepthCloud._fields, "battr_v") if border \
        else dc.DepthCloud._fields
    for name, g, a, w, c in zip(fields, got, again, want, card):
        assert _bits_equal(g, a), name
        assert _bits_equal(g, w), name
        if g.dtype in (torch.bool, torch.int32):
            assert torch.equal(g, c), name
        else:
            assert float((g - c).abs().max()) <= 1e-6, name
    assert tuple(got[5].shape) == (len(boxes), 3, 3)
    for b in range(len(depths)):
        rows = (frame == b).nonzero().flatten()
        one = flat(fn(args_d[0][b].contiguous(), args_d[1][rows].contiguous(),
                      args_d[2][b].contiguous(), *args_d[3:], *rest))
        for name, g, o in zip(fields, got, one):
            if name == "R_wc":
                assert all(_bits_equal(g[d], o) for d in rows.tolist())
            else:
                assert _bits_equal(g[rows.to(device)], o), (b, name)
    assert int(got[1].sum()) > 1000
    if border:
        assert int((got[-1] > 0).sum()) > 0


@pytest.mark.parametrize("analytic", [True, False])
def test_symmetry_search_frame_lane_equals_per_frame_launches(device,
                                                              analytic):
    """symmetry_search with the frame lane: _sym_inputs' detections over
    two frames (depth [2, H, W], the second frame's wall moved so that its
    occlusion differs), ONE launch bit-equal to each frame's own launch
    and to the frame-indexed plain version on the card."""
    from object_oriented_slam_tpu_torch.core.camera import Camera
    cam = Camera(fx=535.4, fy=539.2, cx=320.1, cy=247.6, scale=5000.0)
    pts, mask, bbox, pose, depth, types, run = _sym_inputs(device)
    pts, mask = torch.cat([pts, pts]), torch.cat([mask, mask])
    bbox, pose = torch.cat([bbox, bbox]), torch.cat([pose, pose])
    types, run = torch.cat([types, types]), torch.cat([run, run])
    second = depth.clone()
    second[:, 300:420] = 0
    depths = torch.stack([depth, second])
    frame = torch.tensor([0, 1, 0, 1, 1, 0, 1, 0], dtype=torch.int32,
                         device=device)
    cfg = sym.SymmetryConfig(analytic_grad=analytic)
    n0 = fk.SYMMETRY_SEARCH.launches
    got = sym.estimate_symmetry(pts, mask, bbox, pose, depths, types, run,
                                cam, cfg, frame=frame)
    assert fk.SYMMETRY_SEARCH.launches == n0 + 1
    want = sym.estimate_symmetry_plain(
        pts, mask, bbox, pose, bp.proj_depth_map(depths, cam), types, run,
        cam, cfg, frame=frame)
    for name, g, w in zip(sym.SymSearch._fields, got, want):
        assert _bits_equal(g, w), (name, float((g - w).abs().max()))
    for b in range(2):
        rows = (frame == b).nonzero().flatten()
        one = sym.estimate_symmetry(
            pts[rows].contiguous(), mask[rows].contiguous(),
            bbox[rows].contiguous(), pose[rows].contiguous(),
            depths[b].contiguous(), types[rows].contiguous(),
            run[rows].contiguous(), cam, cfg)
        for name, g, o in zip(sym.SymSearch._fields, got, one):
            assert _bits_equal(g[rows], o), (b, name)
    # the second frame's wall moved the dual search there
    assert not _bits_equal(got.inits[1], got.inits[5])
