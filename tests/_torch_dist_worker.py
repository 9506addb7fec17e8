"""One rank of the port's two-rank gloo runs on the CPU.

    python tests/_torch_dist_worker.py RANK WORLD STORE_DIR INPUTS OUT \
        PORT MAX_OBJECTS CLOUD_CAPACITY ARGV...

(tests/test_torch_dist.py) joins the group through a FileStore in
STORE_DIR, runs every scenario of the port's sharded paths on the inputs
(an .npz the test writes from the JAX package's workloads) and saves this
rank's results to OUT.  Each sharded entry point is wrapped to record the
shard it ran on, so the test sees that each rank took its slice.  Then it
ends that group and runs examples/torch_run_tum.py's main on ARGV as a
rank of a torchrun launch would (torchrun's environment, the rendezvous on
localhost:PORT), with the LM batch's first object tier and the
extractor's cloud capacity of the test's CPU settings; the offline batches'
pads go to OUT's ``.cli.json``.

Imports the port and never JAX.
"""
import functools
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from object_oriented_slam_tpu_torch.backend import lm_soa  # noqa: E402
from object_oriented_slam_tpu_torch.backend import slam_ba  # noqa: E402
from object_oriented_slam_tpu_torch.backend.lm import (  # noqa: E402
    LMConfig, ObjectObservations, observations_from_numpy)
from object_oriented_slam_tpu_torch.frontend import \
    batch_extractor as bx  # noqa: E402
from object_oriented_slam_tpu_torch.parallel import (  # noqa: E402
    dist_lm, dist_slam, dryrun, multihost)
from object_oriented_slam_tpu_torch.system import Tracking  # noqa: E402

SLAM_VARIANTS = [(banded, shard_solve) for banded in (False, True)
                 for shard_solve in (False, True)]
SCHUR_CG_ITERS = 48


def _spy(owner, name, record):
    """Wrap owner.name so that each call appends record(*args) to a list;
    returns the list."""
    calls = []
    fn = getattr(owner, name)

    def wrapped(*args, **kw):
        calls.append(record(*args, **kw))
        return fn(*args, **kw)
    setattr(owner, name, wrapped)
    return calls


def run(rank, world, store_dir, inputs, out_path):
    """Every scenario on this rank, the results to out_path; returns the
    (emptied) list that goes on recording each batched launch's pad."""
    torch.set_num_threads(1)
    multihost.initialize(backend="gloo", device="cpu",
                         init_method="file://" + os.path.join(store_dir,
                                                              "store"),
                         world_size=world, rank=rank, timeout_s=120)
    mesh = multihost.observation_mesh("cpu")
    inp = dict(np.load(inputs))
    out = {}
    K = torch.as_tensor(inp["K"])
    zeros3 = torch.zeros(3)

    # the observation-sharded LM
    neq = _spy(lm_soa, "soa_normal_eq", lambda est, prep, w2d, w3d, *a:
               (w2d.shape[1], w3d.shape[1]))
    obs = observations_from_numpy(
        {k: inp["lm_" + k] for k in ObjectObservations._fields},
        device="cpu")
    est, chi2 = dist_lm.optimize_objects_sharded(
        obs, K, torch.as_tensor(inp["lm_normal"]), True, mesh,
        LMConfig(gravity_on=True, gravity_scale=10.0))
    out["lm_est"], out["lm_chi2"] = est.numpy(), chi2.numpy()
    out["lm_shard"] = np.array(neq)

    # the edge-sharded SLAM solve, dense and banded, shard_solve off and on
    terms = _spy(slam_ba, "edge_terms", lambda poses, objs, g, *a:
                 (g.e2_w.shape[0], g.e3_w.shape[0], g.odo_w.shape[0]))
    g = slam_ba.graph_from_numpy(
        {k: inp["slam_" + k] for k in slam_ba.JAX_FIELDS}, device="cpu")
    for banded, shard_solve in SLAM_VARIANTS:
        terms.clear()
        poses, objs, chi2 = dist_slam.optimize_slam_sharded(
            g, K, zeros3, mesh, LMConfig(iters=8), shard_solve=shard_solve,
            banded=banded)
        key = f"slam_{int(banded)}{int(shard_solve)}"
        out[key + "_poses"], out[key + "_objects"] = poses.numpy(), \
            objs.numpy()
        out[key + "_chi2"] = chi2.numpy()
        out[key + "_shard"] = np.array(terms)

    # the two frame-sharded Schur solves on one assembly, and the
    # replicated solves on the same equations
    F = g.poses_cw.shape[0]
    free_f = g.frame_mask & (torch.arange(F) > 0)
    lam = torch.tensor(-1.0)
    dense = slam_ba.build_normal_equations(g.poses_cw, g.objects, g, K,
                                           zeros3)
    banded = slam_ba.build_normal_equations_banded(g.poses_cw, g.objects, g,
                                                   K, zeros3)
    for name, eqs, sharded, single in (
            ("dense", dense, dist_slam.solve_schur_framesharded,
             slam_ba.solve_schur_step),
            ("banded", banded, dist_slam.solve_schur_framesharded_banded,
             slam_ba.solve_schur_step_banded)):
        args = (*eqs, lam, free_f, g.obj_mask, SCHUR_CG_ITERS)
        for tag, res in (("sharded", sharded(*args, mesh)),
                         ("single", single(*args))):
            for part, t in zip(("dxp", "dxo", "lam"), res):
                out[f"schur_{name}_{tag}_{part}"] = t.numpy()
        for i, t in enumerate(eqs):
            out[f"schur_{name}_eq{i}"] = t.numpy()

    # the dry run's LM, SLAM and batch checks at tiny sizes: each batched
    # call's pad, the sharded call's then the unsharded one's
    pads = _spy(bx, "_extract_multi_packed", lambda d, f, cam, cfg, pad, *a:
                pad)
    dry = dryrun.dryrun_multichip(mesh, offline=False)
    out["batch_err"] = dry["batch"]["rows"]
    out["batch_pads"] = np.array([dryrun.probe_batch(world)[0].pad] + pads)
    part = dry["slam"]["paths_part_at"]
    out["slam_paths_part_at"] = np.array(-1 if part is None else part)
    out["slam_err"] = np.array([dry["slam"][k] for k in (
        "step_poses", "step_objects", "poses", "objects")])
    np.savez(out_path, **out)
    multihost.shutdown()
    print(f"RANK_OK {rank}")
    pads.clear()
    return pads


def cli(rank, world, port, max_objects, cloud_capacity, argv, pads,
        out_path):
    """examples/torch_run_tum.py's main on argv as rank ``rank`` of a
    torchrun launch of ``world`` processes; the pads of the offline
    batches (each dispatch_batch call's, then each launch's) to
    out_path."""
    import importlib.util

    import torch.distributed as dist

    import object_oriented_slam_tpu_torch.frontend as tfrontend
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    Tracking.MAX_OBJECTS = max_objects
    tfrontend.ExtractorConfig = functools.partial(
        tfrontend.ExtractorConfig, cloud_capacity=cloud_capacity)
    batches = _spy(bx, "dispatch_batch", lambda batch, cam, mesh=None, **k:
                   (batch.pad, None if mesh is None else mesh.size))
    spec = importlib.util.spec_from_file_location(
        "torch_run_tum", os.path.join(ROOT, "examples", "torch_run_tum.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(argv)
    assert not dist.is_initialized()      # the CLI ended its group
    with open(out_path, "w") as f:
        json.dump({"batches": batches, "launch_pads": pads}, f)
    print(f"CLI_OK {rank}")


if __name__ == "__main__":
    r, w, store, inputs, out_path, port, max_objects, capacity = \
        sys.argv[1:9]
    pads = run(int(r), int(w), store, inputs, out_path)
    cli(int(r), int(w), int(port), int(max_objects), int(capacity),
        sys.argv[9:], pads, out_path + ".cli.json")
