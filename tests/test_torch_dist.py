"""The port's distributed backends (object_oriented_slam_tpu_torch/parallel)
on the CPU: two gloo ranks against the JAX package's sharded solvers on a
two-device virtual mesh and against the port's single-device solvers.

One module-scoped run of two rank processes (tests/_torch_dist_worker.py:
a FileStore in a tmp dir, one thread a rank, collectives bounded at 120 s)
computes every scenario once, and the cases read its results; this
process computes the port's single-device references while the ranks run.
The workloads are the JAX tests' (tests/torch_dist_jax.py ``inputs``):
tests/test_dist_lm.py's ``make_workload`` (one object seen 24 times in 2D
and 16 in 3D, three empty slots) and tests/test_slam_ba.py's
``build_graph`` (12 frames, 2 objects, a fresh draw of its seed).  JAX's
sharded solvers take ~10 min to trace and compile on the CPU (their own
tests are ``slow``), so the ranks are held to their results stored by
tests/torch_dist_jax.py with the inputs they were made from (a store made
from other inputs fails every case), and the ``slow`` case runs JAX again
against the store.

The same two processes then run the command line
(examples/torch_run_tum.py) as the ranks of a torchrun launch:
``--distributed --offline --offline-shard`` on the first SPLIT frames of
tests/test_torch_run_tum.py's export, at its settings, while this process
runs the same frames with ``--extractor mono`` unsharded (the reference
of tests/test_torch_run_tum_host.py, where the unsharded offline run is
held to it within 1e-4).  The sharded map, written by rank 0 alone, is
held to it within 1e-3 (the dry run's map tolerance; the sharded LM sums
its normal equations in another order).

Tolerances, the JAX tests' own: the sharded LM within 1e-3 of JAX's
sharded LM (tests/test_dist_lm.py) and within 2e-4 of the port's
single-device LM (the dry run's); the sharded SLAM solve, dense 5e-3
(tests/test_dist_slam.py) and banded 2e-3 (tests/test_slam_banded.py), of
JAX's sharded solve and of the port's ``optimize_slam`` on the padded
graph; the frame-sharded Schur solves within 1e-3 (dense,
tests/test_dist_slam.py) and 5e-4 (banded, tests/test_slam_banded.py) of
the replicated solves on the same equations, the port's and JAX's, lam
within rtol 1e-6; the padding exactly JAX's, and a no-op on the result
within 1e-5 (edges) and 5e-4 (frames); the sharded batch rows within 1e-3
of the unsharded ones.  The replicated outputs are
bit-equal on both ranks.
"""
import json
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_oriented_slam_tpu.backend import slam_ba as jslam
from object_oriented_slam_tpu.parallel import dist_slam as jdist
from object_oriented_slam_tpu_torch.backend import LMConfig, slam_ba
from object_oriented_slam_tpu_torch.backend.lm import (
    ObjectObservations, observations_from_numpy)
from object_oriented_slam_tpu_torch.backend.lm_soa import \
    optimize_objects_soa
from object_oriented_slam_tpu_torch.parallel import dist_slam
from object_oriented_slam_tpu_torch.parallel.collectives import Mesh

import test_slam_ba
import torch_dist_jax
from test_svd_init import K as K_np
from test_torch_run_tum import (CLOUD_CAPACITY, MONO, SPLIT, YAML,
                                _history_rows, _objects, _port_cli, export)
from torch_dist_jax import LM_CFG, SLAM_ITERS, SLAM_VARIANTS, WORLD

torch.set_num_threads(1)    # the test workers share the CPU

HERE = os.path.dirname(os.path.abspath(__file__))
SLAM_TOL = {False: 5e-3, True: 2e-3}         # dense, banded
SCHUR_TOL = {"dense": 1e-3, "banded": 5e-4}
SETTINGS = os.path.join(os.path.dirname(HERE),
                        "object_oriented_slam_tpu_torch", "configs",
                        "synthetic_depth.yaml")
CLI_MAX_OBJECTS = 8       # tests/test_torch_run_tum.py's _port_cli setting


def _graph(arrays, prefix="slam_"):
    return slam_ba.graph_from_numpy(
        {k: arrays[prefix + k] for k in slam_ba.JAX_FIELDS}, device="cpu")


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def dist_run(tmp_path_factory):
    """(each rank's results, the single-device references, the inputs,
    JAX's stored results, each rank's command line run: (log, batch pads),
    the command lines' output directories)."""
    tmp = tmp_path_factory.mktemp("torch_dist")
    inputs = torch_dist_jax.inputs()
    jax_ref = torch_dist_jax.load_store(inputs)
    np.savez(tmp / "inputs.npz", **inputs)
    seq = export(tmp)
    cli_out = {k: str(tmp / k) for k in ("mono", "distributed")}
    argv = [YAML, seq, "--out", cli_out["distributed"], *MONO,
            "--max-frames", str(SPLIT), "--distributed", "--offline",
            "--offline-shard", "--batch", "4", "--offline-per-frame-ba"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    outs = [tmp / f"rank{r}.npz" for r in range(WORLD)]
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_dist_worker.py"),
         str(r), str(WORLD), str(tmp), str(tmp / "inputs.npz"),
         str(outs[r]), str(port), str(CLI_MAX_OBJECTS), str(CLOUD_CAPACITY),
         *argv], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        # the port's single-device references, while the ranks run
        obs = observations_from_numpy(
            {k: inputs["lm_" + k] for k in ObjectObservations._fields},
            device="cpu")
        ref = {"port_lm": optimize_objects_soa(
            obs, torch.as_tensor(K_np), torch.as_tensor(inputs["lm_normal"]),
            True, LMConfig(**LM_CFG))[0].numpy()}
        g = _graph(inputs)
        solved = {}       # by (banded, padded frames): the padded graphs
        for banded, shard_solve in SLAM_VARIANTS:
            gp = dist_slam.pad_graph_edges(g, WORLD)
            if shard_solve:
                gp = dist_slam.pad_graph_frames(gp, WORLD)
            key = (banded, gp.poses_cw.shape[0])
            if key not in solved:
                tp, to, _ = slam_ba.optimize_slam(
                    gp, torch.as_tensor(K_np), torch.zeros(3),
                    LMConfig(iters=SLAM_ITERS), banded=banded)
                solved[key] = (tp.numpy(), to.numpy())
            ref[banded, shard_solve] = solved[key]
        _port_cli([YAML, seq, "--out", cli_out["mono"], *MONO,
                   "--max-frames", str(SPLIT)])
        logs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"RANK_OK {r}" in log, log[-6000:]
    cli = []
    for o, log in zip(outs, logs):
        with open(str(o) + ".cli.json") as f:
            cli.append((log, json.load(f)))
    return ([dict(np.load(o)) for o in outs], ref, inputs, jax_ref, cli,
            cli_out)


def test_ranks_hold_the_same_results(dist_run):
    ranks = dist_run[0]
    skip = ("_shard", "_pads")
    for key in ranks[0]:
        if not key.endswith(skip):
            np.testing.assert_array_equal(ranks[0][key], ranks[1][key],
                                          err_msg=key)


def test_sharded_lm_matches_jax_and_the_port(dist_run):
    ranks, ref, inputs, jax_ref = dist_run[:4]
    est = ranks[0]["lm_est"]
    np.testing.assert_allclose(est[0], jax_ref["lm_est"][0], atol=1e-3)
    np.testing.assert_allclose(est, ref["port_lm"], rtol=2e-4, atol=2e-4)
    # the untouched slots keep est0, and the object converged
    np.testing.assert_allclose(est[1:], inputs["lm_est0"][1:], atol=1e-6)
    assert np.abs(est[0] - inputs["lm_est0"][0]).max() > 1e-2
    # each rank's normal equations ran on its half of each ring, once an
    # iteration
    M2, M3 = inputs["lm_mask2d"].shape[1], inputs["lm_mask3d"].shape[1]
    for r in ranks:
        assert r["lm_shard"].tolist() == [[M2 // WORLD, M3 // WORLD]] * 10


@pytest.mark.parametrize("banded,shard_solve", SLAM_VARIANTS)
def test_sharded_slam_matches_jax_and_the_port(dist_run, banded,
                                               shard_solve):
    ranks, ref, inputs, jax_ref = dist_run[:4]
    key = f"slam_{int(banded)}{int(shard_solve)}"
    got = (ranks[0][key + "_poses"], ranks[0][key + "_objects"])
    tol = SLAM_TOL[banded]
    for which, want in (("jax", (jax_ref[key + "_poses"],
                                 jax_ref[key + "_objects"])),
                        ("port", ref[banded, shard_solve])):
        for a, b in zip(got, want):
            assert a.shape == b.shape, which
            np.testing.assert_allclose(a, b, atol=tol, err_msg=which)
    assert float(ranks[0][key + "_chi2"]) < 1e-2
    # K11's plain version ran on each rank's half of every edge family,
    # once an LM iteration
    E = [len(inputs["slam_" + f]) for f in ("e2_w", "e3_w", "odo_w")]
    half = [-(-e // WORLD) for e in E]
    for r in ranks:
        assert r[key + "_shard"].tolist() == [half] * SLAM_ITERS


@pytest.mark.parametrize("name", ["dense", "banded"])
def test_framesharded_schur_solves_match_replicated(dist_run, name):
    """The frame-sharded solve against the replicated one on the same
    assembled equations, the port's and JAX's (eager), from lam < 0."""
    r = dist_run[0][0]
    eqs = [r[f"schur_{name}_eq{i}"] for i in range(6 if name == "banded"
                                                   else 5)]
    F = eqs[1].shape[0] if name == "dense" else eqs[2].shape[0]
    arrays = dist_run[2]
    free_f = arrays["slam_frame_mask"] & (np.arange(F) > 0)
    jsolve = (jslam.solve_schur_step_banded if name == "banded"
              else jslam.solve_schur_step)
    jres = jsolve(*eqs, jnp.float32(-1.0), free_f, arrays["slam_obj_mask"],
                  48)
    tol = SCHUR_TOL[name]
    got = [r[f"schur_{name}_sharded_{p}"] for p in ("dxp", "dxo", "lam")]
    for want in ([r[f"schur_{name}_single_{p}"] for p in ("dxp", "dxo",
                                                          "lam")],
                 [np.asarray(x) for x in jres]):
        np.testing.assert_allclose(got[0], want[0], atol=tol)
        np.testing.assert_allclose(got[1], want[1], atol=tol)
        np.testing.assert_allclose(got[2], want[2], rtol=1e-6)
    assert np.abs(got[0]).max() > 1e-3 and (got[0][0] == 0).all()


def test_dryrun_and_sharded_batch_match_unsharded(dist_run):
    """parallel/dryrun.dryrun_multichip on the two ranks without its
    offline map (each rank checks the LM, the SLAM solve and the batch
    against their unsharded twins at the JAX dry run's tolerances), and
    from it dispatch_batch(mesh=...) on the probe scene: rows within 1e-3
    of the unsharded call, launched on half of the pad.  On the dry run's
    circle graph the sharded and unsharded SLAM paths do not part, and end
    within the JAX dry run's 5e-4, as each step does."""
    for r in dist_run[0]:
        assert r["batch_err"] <= 1e-3
        assert int(r["slam_paths_part_at"]) == -1
        assert (r["slam_err"] <= 5e-4).all()
        pad = int(r["batch_pads"][0])
        # the sharded call on half the pad, then the unsharded one
        assert r["batch_pads"][1:].tolist() == [pad // WORLD, pad]


@pytest.mark.parametrize("rank", [0, 1])
def test_distributed_cli_ranks_join_and_shard(dist_run, rank):
    """Each of the two gloo ranks starts the group from torchrun's
    environment, shards the backend and the offline batches, and ends its
    run."""
    log = dist_run[4][rank][0]
    assert f"torch.distributed initialized: rank {rank} of 2 (gloo)" in log, \
        log[-4000:]
    assert "backend sharded over 2 rank(s)" in log
    assert "offline detection batches sharded over 2 rank(s)" in log
    assert f"CLI_OK {rank}" in log


def test_distributed_cli_shards_each_offline_batch(dist_run):
    """OfflineMapper(mesh=...): every batch of the command line goes
    through dispatch_batch with the two-rank mesh, and each rank launches
    on half of its pad; the plane's bootstrap frame, then two batches."""
    for _, pads in dist_run[4]:
        batches = pads["batches"]
        assert len(batches) == 2 and all(m == WORLD for _, m in batches)
        assert pads["launch_pads"] == [p // WORLD for p, _ in batches]


def test_distributed_cli_rank0_alone_writes(dist_run):
    """One rank prints the map and writes objects.txt and
    object_history.txt; the other writes nothing."""
    logs = [log for log, _ in dist_run[4]]
    assert ["Objects:" in log for log in logs] == [True, False]
    assert sorted(os.listdir(dist_run[5]["distributed"])) == [
        "object_history.txt", "objects.txt"]


def test_distributed_cli_matches_mono(dist_run):
    """``--distributed --offline --offline-shard`` on two gloo ranks: the
    map is the unsharded mono run's within 1e-3."""
    out = dist_run[5]
    got, want = _objects(out["distributed"]), _objects(out["mono"])
    assert sorted(got) == sorted(want) and len(want) >= 5
    for inst in want:
        np.testing.assert_allclose(got[inst], want[inst], atol=1e-3)


def test_distributed_cli_history_matches_mono(dist_run):
    """The distributed run's object_history.txt: the mono run's rows per
    instance."""
    out = dist_run[5]
    assert _history_rows(out["distributed"]) == _history_rows(out["mono"])


def test_pad_graph_matches_jax_and_is_a_noop():
    rng = test_slam_ba.RNG
    test_slam_ba.RNG = np.random.default_rng(13)
    try:
        jg = test_slam_ba.build_graph(F=6, K=1)[0]
    finally:
        test_slam_ba.RNG = rng
    g = _graph({"slam_" + k: np.asarray(v) for k, v in jg._asdict().items()})
    K, zeros3 = torch.as_tensor(K_np), torch.zeros(3)
    p1, o1, _ = slam_ba.optimize_slam(g, K, zeros3, LMConfig(iters=6))
    for port, jax_fn, tol in ((dist_slam.pad_graph_edges,
                               jdist.pad_graph_edges, 1e-5),
                              (dist_slam.pad_graph_frames,
                               jdist.pad_graph_frames, 5e-4)):
        gp, jgp = port(g, 8), jax_fn(jg, 8)
        for k in slam_ba.JAX_FIELDS:
            a, b = getattr(gp, k).numpy(), np.asarray(getattr(jgp, k))
            assert a.shape == b.shape and np.array_equal(a, b), k
        assert (gp.e2_w.shape[0] % 8 == 0 if port is dist_slam.pad_graph_edges
                else gp.poses_cw.shape[0] == 8)
        p2, o2, _ = slam_ba.optimize_slam(gp, K, zeros3, LMConfig(iters=6))
        np.testing.assert_allclose(p2.numpy()[:6], p1.numpy(), atol=tol)
        np.testing.assert_allclose(o2.numpy(), o1.numpy(), atol=tol)


def test_enable_distributed_turns_lm_fusion_off(monkeypatch):
    """With a mesh set the tracker runs the sharded LM and never fuses it
    into an extraction call, though fuse_lm is on (JAX's rule)."""
    from object_oriented_slam_tpu_torch.frontend import extractor as text
    from object_oriented_slam_tpu_torch.parallel import dist_lm, dryrun
    from object_oriented_slam_tpu_torch.system import Tracking

    monkeypatch.setattr(Tracking, "MAX_OBJECTS", 4)
    fused, sharded = [], []
    monkeypatch.setattr(text.MonolithicExtractor, "dispatch_with_lm",
                        lambda *a, **k: fused.append(1))
    orig = dist_lm.optimize_objects_sharded

    def spy(*a, **k):
        sharded.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(dist_lm, "optimize_objects_sharded", spy)
    cam, scene, cfg = dryrun.probe_camera()
    from object_oriented_slam_tpu_torch.frontend import make_extractor
    from object_oriented_slam_tpu_torch.io.synthetic import SyntheticDataset
    from object_oriented_slam_tpu_torch.system import System
    slam = System(SETTINGS, extractor=make_extractor(cam, cfg, "cpu"), device="cpu")
    tr = slam.tracker
    tr.lm_cfg = tr.lm_cfg._replace(iters=2)
    tr.fuse_lm, tr.pipeline_depth = True, 4
    tr.state.ground_plane = np.array([0, 0, 1, 0.0])
    tr.state.ground_state = 2
    slam.open_distributed_backend(Mesh(None, 0, 1, torch.device("cpu")))
    for _, ts, pose, depth, _, det in SyntheticDataset(
            scene, n_frames=8, orbit_radius=2.6, height=1.2,
            min_bbox_px=3.0).frames():
        slam.track_with_objects(ts, pose, det, depth=depth)
    tr.sync()
    assert tr.fuse_lm and not fused and len(sharded) >= 3
    assert slam.map_objects
    with pytest.raises(ValueError, match="device"):
        tr.enable_distributed(Mesh(None, 0, 1, torch.device("meta")))


@pytest.mark.slow
def test_stored_results_are_jax_sharded_solvers(dist_run):
    """JAX's sharded LM and SLAM solves on a two-device virtual mesh, run
    again (~10 min): the stored results within 1e-4, and the ranks' within
    the JAX tests' tolerances of them."""
    ranks, _, inputs, jax_ref = dist_run[:4]
    fresh = torch_dist_jax.jax_sharded(inputs)
    assert sorted(fresh) == sorted(jax_ref)
    for key, want in fresh.items():
        np.testing.assert_allclose(jax_ref[key], want, atol=1e-4,
                                   err_msg=key)
    np.testing.assert_allclose(ranks[0]["lm_est"][0], fresh["lm_est"][0],
                               atol=1e-3)
    for banded, shard_solve in SLAM_VARIANTS:
        key = f"slam_{int(banded)}{int(shard_solve)}"
        for part in ("_poses", "_objects"):
            np.testing.assert_allclose(ranks[0][key + part],
                                       fresh[key + part],
                                       atol=SLAM_TOL[banded], err_msg=key)
