"""``ops/cluster.cluster_components``: the whole propagation of a frame
(compaction, rounds of one min-label pass and 12 pointer jumps until a
round changes nothing) as one entry point.

On the CPU the wrapper runs ``cluster_components_plain``; this file holds
that plain version against the JAX package on the CPU
(``components_compacted`` and ``connected_components``), its per-detection
``converged`` and ``rounds`` against a loop over one detection at a time,
the truncated case, the seeded start, ``cluster_select`` (the same with the
cluster selection behind it) against the JAX package's ``select_cluster``,
and the extractor's clustering counts after a CPU call.  The CUDA kernel is
held against the same plain version on the card by
tests/test_torch_frontend_kernels.py and chip_smoke.py.

Inputs come from a numpy seed: lattice blobs with 1.5 cm spacing (no pair
near the 2 cm radius, so no rounding decides a link), a shuffled chain, an
empty detection and a detection with every lane live.  Tolerance: equality
(labels, flags and round counts are integers and masks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_oriented_slam_tpu.ops import cluster as jcl
from object_oriented_slam_tpu_torch.frontend import (ExtractorConfig,
                                                     make_extractor)
from object_oriented_slam_tpu_torch.frontend import extractor as text
from object_oriented_slam_tpu_torch.io import synthetic as tsyn
from object_oriented_slam_tpu_torch.ops import cluster as tcl
from object_oriented_slam_tpu_torch.ops import frontend_kernels as fk

from test_torch_ops_depth import _blobs

N = 320
TOL = 0.02


def _chain(n, n_live, seed):
    """A shuffled chain of ``n_live`` points 1.5 cm apart: the slowest
    shape for min-label propagation."""
    pts = np.zeros((n, 3), np.float32)
    mask = np.zeros(n, bool)
    pts[:n_live, 0] = 0.015 * np.random.RandomState(seed).permutation(n_live)
    mask[:n_live] = True
    return pts, mask


def _clouds():
    """Five detections over N lanes: blobs with a bridge and singles, a
    long shuffled chain, no unmasked lane, every lane live (a lattice), and
    blobs again."""
    g = np.stack(np.meshgrid(np.arange(8), np.arange(8), np.arange(5)),
                 -1).reshape(-1, 3)
    every = (0.015 * g).astype(np.float32)
    # two lattice halves 4.5 cm apart: two components, every lane unmasked
    every[g[:, 0] >= 4, 0] += 0.03
    assert len(every) == N
    items = [_blobs(11, n=N), _chain(N, 200, 1),
             (np.zeros((N, 3), np.float32), np.zeros(N, bool)),
             (every[np.random.RandomState(2).permutation(N)],
              np.ones(N, bool)),
             _blobs(12, n=N)]
    pts, mask = zip(*items)
    return np.stack(pts), np.stack(mask)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("chains", [-1, 0])
def test_labels_match_jax(chains):
    pts, mask = _clouds()
    args = tcl.centre_and_seed(_t(pts), _t(mask), TOL, chains)
    lab, conv, rounds = tcl.cluster_components_plain(*args, 96, 12)
    cap = int(mask.sum(1).max())
    jlab, jconv = jax.vmap(lambda p, m: jcl.components_compacted(
        p, m, TOL, 96, 12, cap, with_converged=True, chains=chains))(
        jnp.asarray(pts), jnp.asarray(mask))
    jfull = jax.vmap(lambda p, m: jcl.connected_components(
        p, m, TOL, outer_iters=96, chains=chains))(
        jnp.asarray(pts), jnp.asarray(mask))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jfull))
    assert conv.all() and np.asarray(jconv).all()
    assert lab.dtype == torch.int32 and rounds.dtype == torch.int32
    # masked lanes carry N; each label is the least lane of its component
    assert (lab.numpy()[~mask] == N).all()
    assert (lab.numpy()[2] == N).all() and int(rounds[2]) == 1
    assert len(np.unique(lab.numpy()[3])) == 2
    assert len(np.unique(lab.numpy()[1][mask[1]])) == 1
    for d in range(len(pts)):
        roots = np.unique(lab.numpy()[d][mask[d]])
        assert (lab.numpy()[d][roots] == roots).all()


@pytest.mark.parametrize("chains", [-1, 0])
def test_converged_and_rounds_are_per_detection(chains):
    """``rounds`` and ``converged`` of the batch equal those of a loop of
    the plain pass and jumps over one detection at a time."""
    pts, mask = _clouds()
    args = tcl.centre_and_seed(_t(pts), _t(mask), TOL, chains)
    pts_c, nrm, m, labels0, tol2 = args
    lab, conv, rounds = tcl.cluster_components_plain(*args, 96, 12)
    for d in range(len(pts)):
        cur = labels0[d:d + 1]
        r, quiet = 0, False
        while r < 96 and not quiet:
            new, changed = tcl.pointer_jumps_plain(tcl.min_label_pass_plain(
                pts_c[d:d + 1], nrm[d:d + 1], m[d:d + 1], cur, tol2), cur, 12)
            r += 1
            quiet = not bool(changed[0])
            cur = new
        assert int(rounds[d]) == r and bool(conv[d]) == quiet
        assert torch.equal(lab[d:d + 1], cur)
    # the chain needs the most rounds; the batch does not hold the others
    # to it
    assert int(rounds.argmax()) == 1 and int(rounds[1]) > int(rounds[0]) > 1
    assert rounds.tolist()[2] == 1


def test_truncated_detection_alone_reports_it():
    """A bound of 2 rounds cuts the shuffled chain short; the detections
    that settle within it still report convergence, as in the JAX
    package."""
    pts, mask = _clouds()
    args = tcl.centre_and_seed(_t(pts), _t(mask), TOL, 0)
    lab, conv, rounds = tcl.cluster_components_plain(*args, 2, 1)
    _, jconv = jax.vmap(lambda p, m: jcl.connected_components(
        p, m, TOL, outer_iters=2, jump_iters=1, with_converged=True,
        chains=0))(jnp.asarray(pts), jnp.asarray(mask))
    np.testing.assert_array_equal(conv.numpy(), np.asarray(jconv))
    assert not conv[1] and conv[2] and int(rounds[1]) == 2
    assert int(rounds[2]) == 1
    full = tcl.cluster_components_plain(*args, 96, 1)
    assert full[1].all() and not torch.equal(full[0][1], lab[1])


def test_seeded_start_gives_the_same_labels_in_fewer_rounds():
    pts, mask = _clouds()
    plain = tcl.cluster_components_plain(
        *tcl.centre_and_seed(_t(pts), _t(mask), TOL, 0), 96, 12)
    seeded_args = tcl.centre_and_seed(_t(pts), _t(mask), TOL, -1)
    seeded = tcl.cluster_components_plain(*seeded_args, 96, 12)
    assert torch.equal(plain[0], seeded[0])
    assert (seeded[2] <= plain[2]).all()
    # a seeded label is an unmasked lane no greater than its own
    lab0 = seeded_args[3].numpy()
    lanes = np.broadcast_to(np.arange(N), lab0.shape)
    assert (lab0[mask] <= lanes[mask]).all() and (lab0[~mask] == N).all()
    assert np.take_along_axis(mask, np.minimum(lab0, N - 1), 1)[mask].all()
    assert (lab0[mask] < lanes[mask]).any()


def test_cpu_tensors_run_the_plain_version():
    pts, mask = _clouds()
    args = tcl.centre_and_seed(_t(pts), _t(mask), TOL, -1)
    before = fk.CLUSTER_COMPONENTS.launches
    got = tcl.cluster_components(*args, 96, 12)
    want = tcl.cluster_components_plain(*args, 96, 12)
    assert fk.CLUSTER_COMPONENTS.launches == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    # the public wrapper returns the same, with the flags on request
    lab, conv, rounds = tcl.connected_components(
        _t(pts), _t(mask), TOL, 96, 12, with_converged=True,
        with_rounds=True)
    assert torch.equal(lab, want[0]) and torch.equal(rounds, want[2])
    assert torch.equal(conv, want[1])
    assert torch.equal(tcl.connected_components(_t(pts), _t(mask), TOL, 96),
                       want[0])


def _selection_clouds():
    """Four detections for the selection: (0) two lattice blobs of EQUAL
    size, both near the centre estimate (the tie goes to the least root);
    (1) one blob only, far from the estimate (the single-cluster
    fall-back); (2) two blobs, both far (nothing chosen); (3) a large blob
    far away and a smaller one near (the near one is chosen)."""
    g = np.stack(np.meshgrid(*[np.arange(4)] * 3), -1).reshape(-1, 3) * 0.015
    g5 = np.stack(np.meshgrid(*[np.arange(5)] * 3), -1).reshape(-1, 3) * 0.015
    rng = np.random.RandomState(4)

    def lay(blobs):
        pts = np.zeros((N, 3), np.float32)
        mask = np.zeros(N, bool)
        k = 0
        for origin, grid in blobs:
            pts[k:k + len(grid)] = np.asarray(origin) + grid
            mask[k:k + len(grid)] = True
            k += len(grid)
        perm = rng.permutation(N)
        return pts[perm], mask[perm]

    items = [lay([((0.0, 0.0, 1.0), g), ((0.3, 0.0, 1.0), g)]),
             lay([((2.0, 1.0, 1.0), g)]),
             lay([((2.0, 1.0, 1.0), g), ((-2.0, 1.0, 1.0), g5)]),
             lay([((2.0, 1.0, 1.0), g5), ((0.05, 0.0, 1.0), g)])]
    pts, mask = zip(*items)
    centers = np.tile(np.array([[0.15, 0.02, 1.02]], np.float32), (4, 1))
    return np.stack(pts), np.stack(mask), centers


@pytest.mark.parametrize("min_size,center_dis", [(20, 0.5), (20, 0.05),
                                                 (100, 0.5), (65, 5.0)])
def test_cluster_select_matches_jax(min_size, center_dis):
    """The selection on the port's own labels against the JAX package's
    ``select_cluster``: the tie of equal sizes, the single-cluster
    fall-back, nothing near, nothing large enough; ``ok`` carries the
    convergence flag."""
    pts, mask, centers = _selection_clouds()
    args = tcl.centre_and_seed(_t(pts), _t(mask), TOL, -1)
    sel, ok, labels, conv, rounds = tcl.cluster_select(
        _t(pts), *args[:4], _t(centers), args[4], 96, 12, min_size,
        center_dis)
    assert conv.all()
    jsel, jok = jax.vmap(lambda p, m, l, c: jcl.select_cluster(
        p, m, l, c, min_size, center_dis))(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(labels.numpy()),
        jnp.asarray(centers))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    want, ok_w = tcl.select_cluster(_t(pts), _t(mask), labels, _t(centers),
                                    min_size, center_dis)
    assert torch.equal(sel, want) and torch.equal(ok, ok_w)
    if (min_size, center_dis) == (20, 0.5):
        # the tie: two 64-point blobs, both near; the least root wins
        roots = np.unique(labels.numpy()[0][mask[0]])
        assert len(roots) == 2 and ok.tolist() == [True, True, False, True]
        assert (labels.numpy()[0][sel.numpy()[0]] == roots.min()).all()
        assert [int(sel[d].sum()) for d in (0, 1, 3)] == [64, 64, 64]
    if (min_size, center_dis) == (65, 5.0):
        # only the 125-point blobs count; both are within 5 m
        assert ok.tolist() == [False, False, True, True]
        assert int(sel[3].sum()) == 125


def test_cluster_select_fails_a_truncated_detection():
    """A detection cut short by the round bound is not ok, whatever its
    fragments look like; the others keep their result."""
    pts, mask = _clouds()
    centers = np.stack([pts[d][mask[d]][0] if mask[d].any() else np.zeros(3)
                        for d in range(len(pts))]).astype(np.float32)
    args = tcl.centre_and_seed(_t(pts), _t(mask), TOL, 0)
    sel, ok, labels, conv, _ = tcl.cluster_select_plain(
        _t(pts), *args[:4], _t(centers), args[4], 2, 1, 5, 0.5)
    plain_sel, plain_ok = tcl.select_cluster(_t(pts), _t(mask), labels,
                                             _t(centers), 5, 0.5)
    assert not conv[1] and bool(plain_ok[1]) and not ok[1]
    assert torch.equal(sel, plain_sel)
    assert torch.equal(ok, plain_ok & conv)
    # the launch itself takes CUDA tensors only: nothing falls back
    with pytest.raises(ValueError, match="CUDA device"):
        tcl._launch(*args[:4], args[4], 96, 12, None,
                    (_t(pts), _t(centers), 5, 0.5))


def test_launch_memory_covers_the_lanes():
    """Everything resident up to ~8000 lanes, the fixed part and a tile
    above, and a clear error past what one block can hold."""
    assert tcl.launch_smem(4096) == 29 * 4096
    assert tcl.launch_smem(100) == 13 * 128 + 16 * 256
    big = tcl.launch_smem(16384)
    assert 13 * 16384 + 16 * 256 <= big <= 227 * 1024
    with pytest.raises(ValueError, match="lanes"):
        tcl.launch_smem(20000)
    S, T, P = tcl.LAUNCH_SHAPE
    assert 1 <= S <= 8 and T % 32 == 0 and T <= 512 and P in (2, 4, 8)


def test_extractor_counts_ride_the_fetch():
    """After a CPU call the clustering counts are device values in the
    packed result; ``fetch`` fills the call's ``stats`` from its last row
    (the host's counts are there from the call on)."""
    scene = tsyn.make_scene(n_objects=3, seed=5, radius_range=(1.3, 2.0),
                            scale_range=(0.2, 0.35))
    frames = list(tsyn.SyntheticDataset(scene, n_frames=2, orbit_radius=3.6,
                                        height=1.7).frames())
    _, _, pose, depth, _, det = frames[1]
    cfg = ExtractorConfig(cloud_capacity=2048)
    ex = make_extractor(scene.camera, cfg, device="cpu")
    plane = np.array([0.0, 0.0, 1.0, 0.0])
    out = ex(depth, det[:, 1:5].copy(), det[:, 5].astype(int), pose, plane)
    # before the fetch only what the host knows: the tier and the counts of
    # detections that take the symmetry search (none: symmetry is off)
    assert ex.stats == {"cloud_tier": ex.stats["cloud_tier"], "sym_single": 0,
                        "sym_dual": 0}
    host = ex.fetch(out)
    assert host.shape == (out.rows.shape[0], 12) and host.dtype == np.float64
    np.testing.assert_array_equal(host, out.rows.numpy().astype(np.float64))
    st = ex.stats
    assert st is out.stats
    assert st["cluster_converged"] is True
    assert isinstance(st["cluster_rounds"], int) and 2 <= st["cluster_rounds"]
    assert 100 < st["cluster_survivors"] == st["cluster_lanes"] <= 2048
    # the same counts from the stage itself, as 0-dim tensors
    up = ex.upload(depth, det[:, 1:5].copy(), det[:, 5], pose, plane)
    depth_d, flat_d, pad, cfg_t, _ = up
    a = text._stage_a(depth_d, flat_d[:pad * 4].reshape(pad, 4),
                      flat_d[pad * 6:pad * 6 + 7],
                      flat_d[pad * 6 + 7:pad * 6 + 11], scene.camera, cfg_t)
    dev_stats = {}
    text._cluster_select_batch(a[1], a[3], a[4], a[7], cfg_t, dev_stats)
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0
               for v in dev_stats.values())
    assert int(dev_stats["cluster_rounds"]) == st["cluster_rounds"]
    assert int(dev_stats["cluster_lanes"]) == st["cluster_lanes"] \
        == int(a[3].sum(1).max())
    # the counts ride with their own call's result: fetched after a later
    # call (of another frame), the handle still gives this frame's
    later = ex(frames[0][3], frames[0][5][:, 1:5].copy(),
               frames[0][5][:, 5].astype(int), frames[0][2], plane)
    np.testing.assert_array_equal(ex.fetch(out), host)
    assert ex.stats is out.stats and ex.stats == st
    ex.fetch(later)
    assert ex.stats is later.stats
