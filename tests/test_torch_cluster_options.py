"""The clustering options of stage (d) against the JAX package, on the CPU:
the grid-hash pass (``grid_cluster``), the exact broadcast pass
(``exact=True``), the chain passes (``cluster_chains`` / ``chains``) and
the compaction functions (``components_compacted``,
``connected_components_compact``, the extractor's ``compact_tiers`` /
``compact_rungs``).

On the CPU the port runs the plain versions (``cluster_grid_plain``,
``cluster_components_plain`` with its exact pass and chain passes); the
CUDA kernels (K13 and K5's lanes) are held against the same plain versions
on the card by tests/test_torch_frontend_kernels.py and chip_smoke.py.

* ops level: tests/test_cluster_grid.py's four clouds (blobs with holes,
  two borderline sine chains and a bridge, a dense uniform block with
  holes, tol / leaf = 1.8) through the port's grid path, labels equal to
  JAX's grid labels and to the port's exact labels; the stencil and the
  gate on that file's cases, and K13's stencil rows (``grid_rows``)
  covering exactly JAX's stencil; the grid path against JAX on lanes in
  random order and on cells held by two points (the key table's tie
  rule); K13's host-side choices (launch shape, shared memory, rows) and
  what they refuse; K13's CUDA source built for the CPU with g++
  (examples/torch_cluster_grid_on_cpu.py) against the plain version on
  the depth frame's clouds, truncated, with its points and lists out of
  shared memory, shuffled, tied and tiny; the exact pass on three blob clouds against
  JAX's; every ``chains`` in -3..3 on tests/test_ops.py's zigzag clouds
  (labels and converged against JAX's; at chains = 2 also truncated at 2
  rounds); ``components_compacted`` at two caps against JAX's, and
  ``connected_components_compact`` against it and the full width.
* extractor level: one frame of tests/test_torch_extractor.py's scene at
  tier 4096, where JAX's compaction ladder runs, with
  ``compact_tiers=False`` and ``compact_rungs=(4, 6, 8, 12)`` (the frame
  with ``grid_cluster`` and ``cluster_chains=2`` is in
  tests/test_torch_extractor.py's ``test_unported_extractor_options_raise``);
  one offline batch with ``grid_cluster=True`` against JAX's batch
  extractor.

Tolerance: labels and flags equal; extraction rows at the whole-frame
tolerances of tests/test_torch_extractor.py (valid flags equal, centre
1e-3, sorted scales 2e-3, the local z axis 1e-3).
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_oriented_slam_tpu.core.camera import Camera as JCamera
from object_oriented_slam_tpu.frontend import batch_extractor as jbx
from object_oriented_slam_tpu.frontend import extractor as jext
from object_oriented_slam_tpu.ops import cluster as jcl
from object_oriented_slam_tpu_torch.core import se3
from object_oriented_slam_tpu_torch.frontend import batch_extractor as bx
from object_oriented_slam_tpu_torch.frontend import extractor as text
from object_oriented_slam_tpu_torch.io import synthetic as tsyn
from object_oriented_slam_tpu_torch.ops import cluster as tcl
from object_oriented_slam_tpu_torch.ops import voxel as tvx

from test_torch_ops_depth import _blobs

torch.set_num_threads(1)    # the test workers share the CPU

GRID_N = 4096       # every grid cloud padded to one shape: one JAX compile


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _grid_cloud(name):
    """tests/test_cluster_grid.py's four clouds, their shapes drawn from
    its seed (the holes from a generator of their own): (raw points, leaf,
    tol, capacity, holes)."""
    rng = np.random.default_rng(7)
    blobs = np.concatenate([
        rng.normal([0, 0, 2.0], 0.05, (800, 3)),
        rng.normal([0.5, 0.1, 2.5], 0.03, (600, 3)),
        rng.uniform(-1, 1, (100, 3)) + [0, 0, 4.0]])
    t = np.linspace(0, 1.2, 400)
    c1 = np.stack([t, 0.019 * np.sin(40 * t), np.full_like(t, 2.0)], 1)
    chains = np.concatenate([c1, c1 + [0, 0.5, 0], [[0.6, 0.25, 2.0]]])
    uniform = rng.uniform(0, 0.4, (3000, 3)) + [0, 0, 1.5]
    noninteger = rng.normal([0, 0, 2.0], 0.04, (700, 3))
    return {"blobs": (blobs, 0.01, 0.02, 2048, 60),
            "chains": (chains, 0.01, 0.02, 1024, 0),
            "uniform_dense": (uniform, 0.01, 0.02, 4096, 200),
            "noninteger": (noninteger, 0.01, 0.018, 1024, 0)}[name]


GRID_CASES = ("blobs", "chains", "uniform_dense", "noninteger")


@pytest.fixture(scope="module")
def grid_clouds():
    """Each cloud voxelized by the port (its points and cells equal JAX's,
    tests/test_torch_ops_depth.py), holes knocked in with a seeded
    generator, padded to GRID_N masked lanes; JAX's grid labels of the
    three clouds at tol 2 cm in one vmapped call, the fourth alone."""
    rng = np.random.default_rng(11)
    out = {}
    for name in GRID_CASES:
        raw, leaf, tol, cap, drop = _grid_cloud(name)
        p, c, m = tvx.voxel_downsample_cells(
            _t(raw.astype(np.float32))[None],
            torch.ones(1, len(raw), dtype=torch.bool), leaf, cap)
        p, c, m = p[0].numpy(), c[0].numpy(), m[0].numpy().copy()
        if drop:
            occ = np.flatnonzero(m)
            m[rng.choice(occ, size=min(drop, len(occ)), replace=False)] = False
        pad = GRID_N - cap
        out[name] = dict(
            pts=np.pad(p, ((0, pad), (0, 0))), cells=np.pad(c, ((0, pad),
                                                                (0, 0))),
            mask=np.pad(m, (0, pad)), leaf=leaf, tol=tol)
    same = [n for n in GRID_CASES if out[n]["tol"] == 0.02]
    for names, tol in ((same, 0.02), (["noninteger"], 0.018)):
        lab, conv = jax.vmap(lambda p, c, m: jcl.connected_components_grid(
            p, c, m, tol, 0.01, outer_iters=16, with_converged=True))(
            *(jnp.asarray(np.stack([out[n][k] for n in names]))
              for k in ("pts", "cells", "mask")))
        for i, n in enumerate(names):
            out[n]["jax"] = (np.asarray(lab[i]), bool(conv[i]))
    return out


@pytest.mark.parametrize("name", GRID_CASES)
def test_grid_matches_jax_and_exact(grid_clouds, name):
    g = grid_clouds[name]
    P, C, M = _t(g["pts"])[None], _t(g["cells"])[None], _t(g["mask"])[None]
    lab, conv, rounds = tcl.connected_components_grid(
        P, C, M, g["tol"], g["leaf"], outer_iters=16, with_converged=True,
        with_rounds=True)
    jlab, jconv = g["jax"]
    np.testing.assert_array_equal(lab[0].numpy(), jlab)
    assert bool(conv[0]) == jconv
    # the exact dense pass gives the same labels once both converge
    elab, econv = tcl.connected_components(P, M, g["tol"], outer_iters=96,
                                           exact=True, with_converged=True)
    glab, gconv = tcl.connected_components_grid(P, C, M, g["tol"], g["leaf"],
                                                outer_iters=96,
                                                with_converged=True)
    assert bool(econv[0]) and bool(gconv[0])
    np.testing.assert_array_equal(glab.numpy(), elab.numpy())
    part = collections.Counter(glab[0][M[0]].tolist())
    assert len(part) > 1 and M[0].sum() > 300
    # the selection behind the grid labels is the one on those labels
    centre = P[:, :1].clone()[:, 0]
    args = (P, C, M, tcl.grid_seed(P, M, g["tol"]), P, centre, g["tol"],
            g["leaf"], 96, 12, 30, 0.5)
    sel, ok, l2, c2, r2 = tcl.cluster_grid_select(*args)
    want = tcl.select_cluster(P, M, glab, centre, 30, 0.5)
    assert torch.equal(l2, glab) and torch.equal(sel, want[0])
    assert torch.equal(ok, want[1] & c2)


@pytest.mark.parametrize("tol,leaf,span", [
    (0.02, 0.01, 7.2), (0.08, 0.01, 7.2), (0.02, 0.01, 11.0),
    (0.018, 0.01, 7.2), (0.03, 0.01, 5.0)])
def test_grid_gate_and_stencil_match_jax(tol, leaf, span):
    assert tcl.grid_supported(tol, leaf, span) == jcl.grid_supported(
        tol, leaf, span)
    R, offs = tcl._grid_offsets(tol, leaf)
    assert (R, offs) == jcl._grid_offsets(tol, leaf)
    if len(offs) <= 124:
        # the kernel's enumeration of the stencil from (R, smax) gives the
        # same keys in the same order
        R2, smax = tcl.grid_stencil(tol, leaf)
        m = lambda d: max(abs(d) - 1, 0)    # noqa: E731
        keys = [(dx << 20) + (dy << 10) + dz
                for dx in range(-R2, R2 + 1) for dy in range(-R2, R2 + 1)
                for dz in range(-R2, R2 + 1)
                if (dx, dy, dz) != (0, 0, 0)
                and m(dx) ** 2 + m(dy) ** 2 + m(dz) ** 2 <= smax]
        assert keys == offs
    else:
        with pytest.raises(ValueError, match="124"):
            tcl.grid_stencil(tol, leaf)


@pytest.mark.parametrize("tol,leaf,span", [
    (0.02, 0.01, 7.2), (0.08, 0.01, 7.2), (0.02, 0.01, 11.0),
    (0.018, 0.01, 7.2), (0.03, 0.01, 5.0)])
def test_grid_rows_cover_the_stencil(tol, leaf, span):
    """K13's stencil rows (``grid_rows``, the key intervals the kernel
    walks) cover exactly JAX's ``_grid_offsets`` set, each cell once, with
    the centre cell the only extra key; a stencil over 124 cells raises."""
    _, offs = jcl._grid_offsets(tol, leaf)
    if len(offs) > 124:
        with pytest.raises(ValueError, match="124"):
            tcl.grid_rows(tol, leaf)
        return
    rows = tcl.grid_rows(tol, leaf)
    keys = [k for lo, hi in rows for k in range(lo, hi + 1)]
    assert len(rows) <= 25 and all(lo <= hi for lo, hi in rows)
    assert len(keys) == len(set(keys)) == len(offs) + 1
    assert set(keys) - {0} == set(offs) and 0 in keys


def _grid_variant_clouds(grid_clouds):
    """Three grid inputs at GRID_N lanes (the fixture's JAX call's batch,
    so JAX compiles nothing new): the "blobs" and "uniform_dense" clouds
    with their lanes in a seeded random order, and the "chains" cloud with
    100 padding lanes made live as copies of live cells (a cell held by two
    points, the copy's point 3 mm away), in lane order."""
    b = grid_clouds["blobs"]
    perm = np.random.default_rng(21).permutation(GRID_N)
    shuffled = (b["pts"][perm], b["cells"][perm], b["mask"][perm])
    c = grid_clouds["chains"]
    pts, cells, mask = c["pts"].copy(), c["cells"].copy(), c["mask"].copy()
    live = np.flatnonzero(mask)
    src = np.random.default_rng(22).choice(live, 100, replace=False)
    dst = np.flatnonzero(~mask)[:100]
    pts[dst] = pts[src] + np.float32(0.003)
    cells[dst] = cells[src]
    mask[dst] = True
    u = grid_clouds["uniform_dense"]
    return [shuffled, (pts, cells, mask),
            tuple(u[k][perm] for k in ("pts", "cells", "mask"))]


def test_grid_plain_matches_jax_on_shuffled_and_repeated_cells(grid_clouds):
    """The grid pass's plain version (``grid_neighbours_plain``'s table,
    ``cluster_grid_plain``'s rounds) against JAX's
    ``connected_components_grid`` where the key table's order matters: lanes
    in random order, and a cell held by two points (the least lane takes
    it, as JAX's stable sort gives it): labels and converged equal."""
    clouds = _grid_variant_clouds(grid_clouds)
    jlab, jconv = jax.vmap(lambda p, c, m: jcl.connected_components_grid(
        p, c, m, 0.02, 0.01, outer_iters=16, with_converged=True))(
        *(jnp.asarray(np.stack([v[k] for v in clouds])) for k in range(3)))
    P, C, M = (_t(np.stack([v[k] for v in clouds])) for k in range(3))
    lab, conv = tcl.connected_components_grid(P, C, M, 0.02, 0.01,
                                              outer_iters=16,
                                              with_converged=True)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
    np.testing.assert_array_equal(conv.numpy(), np.asarray(jconv))
    assert bool(conv.all())
    # the repeated cells' copies are nobody's table entry: only the least
    # lane of a key is found
    nbr = tcl.grid_neighbours_plain(P[1:2], C[1:2], M[1:2], 0.02,
                                    0.01)
    dst = np.flatnonzero(~grid_clouds["chains"]["mask"])[:100]
    own = torch.arange(GRID_N)[:, None]
    found = set(nbr[0][(nbr[0] != own) & M[1][:, None]].tolist())
    assert found and not found & set(dst.tolist())


def test_grid_host_choices_refuse_what_does_not_fit():
    """K13's host-side choices: the shape from D and N is one the kernel
    takes, the shared memory holds the 13 bytes a lane up to the most lanes
    and refuses more, the stencil rows refuse a stencil over 124 cells."""
    for D, N in ((1, 32), (32, 4096), (8, 16384), (64, 4096), (128, 4096),
                 (256, 4096), (65535, 32)):
        S, T = tcl.grid_shape(D, N)
        assert 1 <= S <= 8 and 32 <= T <= 512 and T % 32 == 0
    # fewer blocks a detection as the detections grow
    shapes = [tcl.grid_shape(D, 4096)[0] for D in (8, 32, 64, 128, 256)]
    assert shapes == sorted(shapes, reverse=True) and shapes[0] == 8
    most = (tcl._SMEM_MAX - 256) // 13 // 32 * 32
    assert tcl.grid_smem_least(most) == 256 + 13 * most
    assert tcl.grid_smem(most) >= tcl.grid_smem_least(most)
    assert tcl.grid_smem(16384) >= 256 + 13 * 16384
    with pytest.raises(ValueError, match="lanes"):
        tcl.grid_smem(most + 1)
    with pytest.raises(ValueError, match="124"):
        tcl.grid_rows(0.08, 0.01)


@pytest.fixture(scope="module")
def k13_on_cpu(tmp_path_factory):
    """examples/torch_cluster_grid_on_cpu.py: K13's kernel source built
    with g++, a block a detection as std::threads."""
    import importlib.util
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "torch_cluster_grid_on_cpu",
        os.path.join(root, "examples", "torch_cluster_grid_on_cpu.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib = mod.build(os.path.join(root, "object_oriented_slam_tpu_torch",
                                 "csrc", "frontend.cu"),
                    str(tmp_path_factory.mktemp("k13") / "k13.so"))
    return mod, lib, mod.cases()


@pytest.mark.parametrize("case,S", [
    ("path", 1), ("path", 4), ("path-2", 4), ("path-device", 4),
    ("path-window", 1), ("shuffled", 4), ("ties", 4), ("sizes", 1)])
def test_k13_source_built_for_the_cpu_equals_plain(k13_on_cpu, case, S):
    """K13's CUDA source, built for the CPU (S blocks of 64 threads a
    detection, a cluster's distributed shared memory and barriers
    emulated), against its plain version: labels, converged, rounds, sel
    and ok equal, a second call bit-equal.  The key table sorted or taken
    in lane order; the lists and points in shared or device memory; two
    label buffers and a wait before the remote writes, or three; truncated
    rounds, tied cells and tiny detections (the card's cases are the
    cuda-marked tests/test_torch_frontend_kernels.py's)."""
    mod, lib, cases = k13_on_cpu
    pts, cells, mask, outer, smem = cases[case]
    pts, cells, mask = (t.contiguous() for t in (pts, cells, mask))
    labels0 = tcl.grid_seed(pts, mask, 0.02)
    pts_w = (pts + torch.tensor([0.3, -0.2, 0.1])).contiguous()
    centre = pts_w[:, 0].contiguous()
    want = tcl.cluster_grid_select_plain(pts, cells, mask, labels0, pts_w,
                                         centre, 0.02, 0.01, outer, 12, 100,
                                         0.5)
    got = [mod.run(lib, pts, cells, mask, labels0, pts_w, centre, 0.02,
                   0.01, outer, 64, smem, S) for _ in range(2)]
    for g in got:
        for a, b in zip(g, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(want[4].max()) >= 2


def test_exact_matches_jax():
    p, m = zip(*[_blobs(s) for s in (0, 1, 2)])
    pts, mask = np.stack(p), np.stack(m)
    lab, conv = tcl.connected_components(_t(pts), _t(mask), 0.02,
                                         outer_iters=96, exact=True,
                                         with_converged=True)
    jlab, jconv = jax.vmap(lambda p, m: jcl.connected_components(
        p, m, 0.02, outer_iters=96, exact=True, with_converged=True))(
        jnp.asarray(pts), jnp.asarray(mask))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
    np.testing.assert_array_equal(conv.numpy(), np.asarray(jconv))
    assert conv.all()


def _zigzag():
    """tests/test_ops.py's clouds of its chain-variants test: zigzag chains
    (the diffusion worst case), two blobs, noise, 15 % masked."""
    rng = np.random.default_rng(11)
    N = 1024
    t = np.linspace(0, 6, N // 4)
    chain = np.stack([t, 0.4 * np.sin(7 * t), 0.2 * np.cos(11 * t)], 1)
    pts = np.concatenate([
        chain, rng.normal(0, 0.05, (N // 4, 3)) + 4,
        rng.normal(0, 0.04, (N // 4, 3)) - 3,
        rng.uniform(-5, 5, (N // 4, 3))]).astype(np.float32)
    return pts, rng.random(N) > 0.15


@pytest.mark.parametrize("chains", [-3, -2, -1, 0, 1, 2, 3])
def test_chains_match_jax(chains):
    pts, mask = _zigzag()
    jlab, jconv = jcl.connected_components(
        jnp.asarray(pts), jnp.asarray(mask), 0.05, outer_iters=48,
        with_converged=True, chains=chains)
    lab, conv, rounds = tcl.connected_components(
        _t(pts)[None], _t(mask)[None], 0.05, outer_iters=48,
        with_converged=True, chains=chains, with_rounds=True)
    np.testing.assert_array_equal(lab[0].numpy(), np.asarray(jlab))
    assert bool(conv[0]) == bool(jconv) and bool(conv[0])
    if chains != 2:
        return
    # truncated at 2 rounds: still JAX's labels and flag
    jlab2, jconv2 = jcl.connected_components(
        jnp.asarray(pts), jnp.asarray(mask), 0.05, outer_iters=2,
        with_converged=True, chains=chains)
    lab2, conv2 = tcl.connected_components(
        _t(pts)[None], _t(mask)[None], 0.05, outer_iters=2,
        with_converged=True, chains=chains)
    np.testing.assert_array_equal(lab2[0].numpy(), np.asarray(jlab2))
    assert bool(conv2[0]) == bool(jconv2)


def test_chain_orders_are_compacted_permutations():
    """What the kernel's chain lane reads: per order, the survivors'
    compacted indices in chain order (a permutation of [0, n)) and the
    identity past n."""
    pts, mask = _zigzag()
    P, M = _t(pts)[None], _t(mask)[None]
    structs = tcl._chain_structs(P, M, 0.0025, 3)
    order, link = tcl.chain_orders(structs, M)
    n = int(M.sum())
    assert order.shape == (1, 3, 1024) and link.dtype == torch.uint8
    for k in range(3):
        assert sorted(order[0, k, :n].tolist()) == list(range(n))
        assert order[0, k, n:].tolist() == list(range(n, 1024))
        assert not link[0, k, n:].any()


@pytest.mark.parametrize("cap", [768, 1024])
def test_compacted_match_jax(cap):
    pts, mask = _zigzag()
    pts, mask = pts[:1024], mask.copy()
    mask[700:] = False          # 596 survivors fit both caps
    P, M = _t(pts)[None], _t(mask)[None]
    lab = tcl.components_compacted(P, M, 0.05, 48, 12, cap)
    jlab = jcl.components_compacted(jnp.asarray(pts), jnp.asarray(mask),
                                    0.05, 48, 12, cap)
    np.testing.assert_array_equal(lab[0].numpy(), np.asarray(jlab))
    # JAX's connected_components_compact equals its components_compacted
    # whenever the survivors fit (its docstring); the port's, the same
    lab_c = tcl.connected_components_compact(P, M, 0.05, 48, 12, cap)
    np.testing.assert_array_equal(lab_c.numpy(), lab.numpy())
    # a cap the survivors overflow: the full-width labels
    full = tcl.connected_components(P, M, 0.05, 48, 12)
    assert torch.equal(tcl.connected_components_compact(P, M, 0.05, 48, 12,
                                                        256), full)
    assert torch.equal(full, lab)


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
    return dict(depth=depth, pose=pose.astype(np.float32),
                bboxes=det[:3, 1:5].astype(np.float32), cam=cam, jcam=jcam,
                plane=np.array([0.0, 0.0, 1.0, 0.0], np.float32))


def _assert_rows_close(e, v, je, jv):
    np.testing.assert_array_equal(v, jv)
    assert v.sum() >= 2
    e, je = e[v], je[v]
    np.testing.assert_allclose(e[:, :3], je[:, :3], atol=1e-3)
    np.testing.assert_allclose(np.sort(e[:, 7:10]), np.sort(je[:, 7:10]),
                               atol=2e-3)
    z = se3.quat_to_mat(torch.from_numpy(np.ascontiguousarray(
        e[:, 3:7])))[:, :, 2].numpy()
    jz = se3.quat_to_mat(torch.from_numpy(np.ascontiguousarray(
        je[:, 3:7])))[:, :, 2].numpy()
    np.testing.assert_allclose(z, jz, atol=1e-3)


@pytest.mark.parametrize("option", [
    dict(compact_tiers=False), dict(compact_rungs=(4, 6, 8, 12))])
def test_extractor_compaction_options_match_jax(option, frame):
    """At tier 4096 JAX's extractor picks a rung of its compaction ladder
    (``compact_tiers``, ``compact_rungs``); the port takes any value and
    compacts each detection to its own survivors: the same rows, and the
    port's rows equal to its default configuration's."""
    f = frame
    kw = dict(cloud_capacity=4096, cluster_min_size=30)
    run = np.ones(3, bool)
    t_args = (torch.from_numpy(f["depth"]), torch.from_numpy(f["bboxes"]),
              torch.from_numpy(run), torch.from_numpy(f["pose"]),
              torch.from_numpy(f["plane"]), f["cam"])
    e, _, v, _ = text.extract_local_ellipsoids(
        *t_args, text.ExtractorConfig(**kw, **option))
    e0, _, v0, _ = text.extract_local_ellipsoids(*t_args,
                                                 text.ExtractorConfig(**kw))
    assert torch.equal(e, e0) and torch.equal(v, v0)
    je, _, jv, _ = jext.extract_local_ellipsoids(
        jnp.asarray(f["depth"]), jnp.asarray(f["bboxes"]), jnp.asarray(run),
        jnp.asarray(f["pose"]), jnp.asarray(f["plane"]), f["jcam"],
        jext.ExtractorConfig(**kw, **option))
    _assert_rows_close(e.numpy(), v.numpy(), np.asarray(je), np.asarray(jv))
    ex = text.make_extractor(f["cam"], text.ExtractorConfig(**kw, **option),
                             device="cpu")
    host = ex.fetch(ex(f["depth"], f["bboxes"], np.array([56, 57, 58]),
                       f["pose"].astype(float), f["plane"].astype(float)))
    np.testing.assert_allclose(host[:3, :10], e.numpy(), atol=1e-6)


def test_offline_batch_with_grid_matches_jax():
    """One batch of 3 frames (one of them without a detection) with
    ``grid_cluster=True`` against JAX's ``_extract_multi_packed``, and each
    frame's rows bit-equal to the port's one-frame call with the option
    (K13 needs no frame lane: each detection's cells are its own
    camera's)."""
    scene = tsyn.make_scene(n_objects=6, seed=7, radius_range=(1.3, 2.2),
                            scale_range=(0.2, 0.4))
    frames = list(tsyn.SyntheticDataset(scene, n_frames=12, orbit_radius=3.6,
                                        height=1.7).frames())
    cam = scene.camera
    jcam = JCamera(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                   scale=cam.scale, width=cam.width, height=cam.height)
    plane = np.array([0.0, 0.0, 1.0, 0.0], np.float32)

    def rec(k, with_dets=True):
        _, _, pose, depth, _, det = frames[k]
        det = det if with_dets else np.zeros((0, 8))
        return (depth, det[:, 1:5], det[:, 5].astype(int),
                np.ones(len(det), bool), pose)

    packed = [rec(0), rec(3, False), rec(6)]
    cfg = text.ExtractorConfig(cloud_capacity=2048, cluster_min_size=30,
                               grid_cluster=True)
    assert text._grid_clustering_ok(cam, cfg)
    fb = bx.pack_frames_batch(cam, cfg, packed, plane, min_pad=3)
    got = bx.fetch_batch(bx.dispatch_batch(fb, cam, device="cpu"))
    jcfg = jext.ExtractorConfig(cloud_capacity=fb.cfg.cloud_capacity,
                                cluster_min_size=30, grid_cluster=True)
    j = np.asarray(jbx._extract_multi_packed(
        jnp.asarray(fb.depths), jnp.asarray(fb.flat), jcam, jcfg, fb.pad,
        fb.B, fb.need_s, fb.need_d), np.float64)
    assert got.shape == j.shape == (fb.pad, 12)
    _assert_rows_close(got[:, :10], got[:, 11] > 0.5, j[:, :10],
                       j[:, 11] > 0.5)
    ex = text.make_extractor(cam, cfg, device="cpu")
    for b in (0, 2):
        depth, bb, labels, _, pose = packed[b]
        s, n = fb.slices[b]
        one = ex.fetch(ex(depth, bb, labels, pose, plane))[:n]
        np.testing.assert_array_equal(got[s:s + n], one)
    assert fb.slices[1][1] == 0
