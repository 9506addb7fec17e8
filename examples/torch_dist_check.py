#!/usr/bin/env python
"""The port's sharded paths against their unsharded twins on N ranks.

    python -m torch.distributed.run --standalone --nproc_per_node N \\
        examples/torch_dist_check.py [--backend nccl|gloo] [--device cuda|cpu]

Every rank runs ``parallel/dryrun.py``'s checks on the same inputs (SPMD):
the observation-sharded LM on a seeded batch at ``--lm-tier`` (objects, 2D
ring, 3D ring; default chip_smoke.py's FULL tier), the edge- and
frame-sharded SLAM solve (dense and banded) on the dry run's circle graph
of ``--frames`` frames at the dry run's LM settings (3 iterations, 16 CG
steps), and the probe scene's batch of N frames through
``dispatch_batch(mesh=...)``.  Each check raises past the dry run's
tolerance.  Rank 0 prints the card (``nvidia-smi``), then every rank's
report as one JSON line: each check's largest differences, the kernels the
sharded call launched on that rank and the host seconds of the sharded call
and its twin.  ``--backend`` defaults to NCCL on the card (a GPU per rank)
and gloo on the CPU; every collective is bounded by ``--timeout`` seconds.
On the CPU: ``--device cpu --lm-tier 4 64 32 --frames 16``.
"""
import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lm-tier", type=int, nargs=3, default=(24, 512, 256),
                    metavar=("O", "M2", "M3"))
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--timeout", type=float, default=120.0)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from object_oriented_slam_tpu_torch.backend import LMConfig
    from object_oriented_slam_tpu_torch.backend.lm import \
        observations_from_numpy
    from object_oriented_slam_tpu_torch.io.synthetic import make_lm_batch
    from object_oriented_slam_tpu_torch.parallel import dryrun, multihost

    if not multihost.initialize(backend=args.backend, device=args.device,
                                timeout_s=args.timeout):
        raise SystemExit("no process group: run under torch.distributed.run")
    try:
        mesh = multihost.observation_mesh(args.device)
        dev = mesh.device
        if mesh.rank == 0 and dev.type == "cuda":
            print(subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60).stdout.strip(), flush=True)
        obs = observations_from_numpy(make_lm_batch(*args.lm_tier, seed=7),
                                      dev)
        K = torch.as_tensor(dryrun.K_TUM, device=dev)
        normal = torch.tensor([0.05, -0.02, 1.0], device=dev)
        report = {"rank": mesh.rank, "size": mesh.size,
                  "backend": dist.get_backend(), "device": str(dev),
                  "lm": dryrun.check_lm(obs, K, normal, mesh)}
        g = dryrun.circle_slam_graph(args.frames, dev)
        for banded in (False, True):
            report["slam " + ("banded" if banded else "dense")] = \
                dryrun.check_slam(g, K, torch.zeros(3, device=dev), mesh,
                                  LMConfig(iters=3), 16, shard_solve=True,
                                  banded=banded)
        batch, cam = dryrun.probe_batch(mesh.size)
        report["batch"] = dryrun.check_batch(batch, cam, mesh)
        reports = [None] * mesh.size
        dist.all_gather_object(reports, report)
        if mesh.rank == 0:
            for r in reports:
                print(json.dumps(r), flush=True)
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main()
