#!/usr/bin/env python
"""TUM RGB-D command line of the PyTorch + CUDA port.

Twin of ``examples/run_tum.py`` (the reference's
``Example/interface/rgbd.cpp``):

    python examples/torch_run_tum.py <settings.yaml> <dataset_dir> [options]

Loads the sequence and its bbox detections (``io/tum.py``: the depth PNGs
decoded in numpy, no ``cv2``), runs the full pipeline per frame on the
card (ground-plane estimation, single-frame ellipsoid extraction, with
symmetry when the yaml opens it, data association, SVD / 3D
initialization, global object-graph LM) with the adaptive deferred
pipeline, and saves ``objects.txt`` / ``object_history.txt``.
``--extractor`` picks the extraction architecture as ``run_tum.py`` does:
``auto`` (the default) probes the device's round trip
(``system/probe.py``) and prints its choice, fused-split extraction with
LM fusion on a local device; ``mono`` clusters on the device; ``split`` /
``fused`` cluster on the host between two device phases
(``native/src/cluster.cpp``, built with g++ at first use).  ``--device
cpu`` runs the plain PyTorch versions on the CPU; without CUDA the default
device raises.  ``--offline`` is the throughput mode of ``run_tum.py``
(``system/offline.py``): after the ground plane's bootstrap through the
per-frame path, every ``--batch`` frames (8) are extracted by one batched
call, the global BA runs once a batch (``--offline-per-frame-ba``: once a
frame, the online schedule), and ``--offline-split`` clusters on the host
between two batched device phases (phase A's copy home quantized to u16);
``--extractor`` then picks the bootstrap frames' extractor.
``--slam-mode`` refines the recorded trajectory and map after the run
(``system/slam_mode.py``, the banded Schur LM, 10 iterations; the K11 edge
kernel on the card) and writes ``trajectory_refined.txt`` and
``objects_slam.txt``; with ``--odometry`` the input trajectory is the
odometry's.  ``--distributed`` shards the global BA's observation axis over
the ranks of a torchrun launch (``parallel/dist_lm.py``), and
``--offline-shard`` each offline batch's detection axis
(``batch_extractor.dispatch_batch(mesh=...)``):

    python -m torch.distributed.run --nproc_per_node 2 \
        examples/torch_run_tum.py <yaml> <dir> --distributed [--offline \
        --offline-shard] [--dist-backend nccl|gloo]

``--dist-backend`` defaults to NCCL on the card (a GPU per rank) and gloo
on the CPU; gloo also lets ranks share one GPU.  Without torchrun's
environment they run as one shard.  Every rank runs the same frames and
holds the same map; rank 0 alone writes the output files (and runs
``--slam-mode``).  Flags of
``run_tum.py`` whose subsystem is not ported raise ``NotImplementedError``
naming its item of ``ROADMAP.md``'s queue 1.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

_UNPORTED = (
    # (flag, is it set?, what, ROADMAP.md queue 1 item)
    ("--build-dense", lambda a: a.build_dense, "the dense builder", 9),
    ("--map-format", lambda a: a.map_format != "ply",
     "the dense builder's map export", 9),
    ("--viz", lambda a: a.viz, "the renders (viz/export.py)", 9),
    ("--viz-live", lambda a: a.viz_live, "the live web viewer", 9),
)


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("dataset")
    ap.add_argument("--out", default=".", help="output directory")
    ap.add_argument("--no-depth", action="store_true",
                    help="2D-only pipeline (no ellipsoid extraction)")
    ap.add_argument("--no-symmetry", action="store_true")
    ap.add_argument("--auto-assoc", action="store_true",
                    help="automatic data association instead of column 7")
    ap.add_argument("--odometry", default=None,
                    help="odometry txt (ts x y z qx qy qz qw)")
    ap.add_argument("--map-format", default="ply", choices=["ply", "pcd"])
    ap.add_argument("--build-dense", action="store_true")
    ap.add_argument("--viz", action="store_true")
    ap.add_argument("--viz-live", type=int, default=0, metavar="N")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--extractor", default="auto",
                    choices=["auto", "mono", "split", "fused"],
                    help="extraction architecture: auto = probe the "
                         "device's round trip at start-up and pick "
                         "(default; >= 5 ms -> mono, a local device -> "
                         "fused + LM fusion); mono = the clustering on the "
                         "device; split/fused = the host's grid-hash "
                         "clustering between two device phases (fused: "
                         "one call a frame)")
    ap.add_argument("--checkpoint", default=None,
                    help="save state checkpoint at the end")
    ap.add_argument("--resume", default=None,
                    help="resume from a state checkpoint (skips the "
                         "frames it already processed)")
    ap.add_argument("--slam-mode", action="store_true",
                    help="after the run, jointly refine trajectory + "
                         "objects (the reference's bSLAM_mode, "
                         "Optimizer.cpp:126-158) and save "
                         "trajectory_refined.txt / objects_slam.txt")
    ap.add_argument("--slam-max-frames", type=int, default=None,
                    metavar="F",
                    help="--slam-mode frame window; default unbounded "
                         "(grow-only capacity tiers sized from the run, "
                         "like the reference's unbounded graph loops, "
                         "Optimizer.cpp:126-158)")
    ap.add_argument("--slam-max-objects", type=int, default=None,
                    metavar="K",
                    help="--slam-mode object cap; default unbounded")
    ap.add_argument("--odo-weight", type=float, default=1.0,
                    help="odometry sqrt-information for --slam-mode; the "
                         "reference uses identity information "
                         "(Optimizer.cpp:153-156), which lets pixel-scale "
                         "projection residuals dominate -- raise this "
                         "when the input trajectory is accurate")
    ap.add_argument("--pipeline-depth", type=int, default=0, metavar="N",
                    help="pin the extraction-deferral window (1=eager; "
                         "default: adaptive, 4 deepening to 8 on blocked "
                         "fetches). Pinning disables adaptation.")
    ap.add_argument("--distributed", action="store_true",
                    help="shard the backend BA over the ranks of a torchrun "
                         "launch (MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK/"
                         "LOCAL_RANK); one shard without them")
    ap.add_argument("--offline", action="store_true",
                    help="throughput mode: B frames' extraction in one "
                         "batched call each (system/offline.py); the same "
                         "results as the sequential loop with "
                         "--offline-per-frame-ba. Requires depth (not "
                         "--no-depth).")
    ap.add_argument("--batch", type=int, default=8, metavar="B",
                    help="frames per batched extraction call in --offline "
                         "mode (default 8)")
    ap.add_argument("--offline-shard", action="store_true",
                    help="shard the --offline detection batches over the "
                         "ranks (data parallelism)")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="torch.distributed backend of --distributed / "
                         "--offline-shard (default: nccl on cuda, gloo on "
                         "cpu; gloo lets ranks share one GPU)")
    ap.add_argument("--offline-split", action="store_true",
                    help="--offline with the device-A / host-cluster / "
                         "device-B split protocol")
    ap.add_argument("--offline-per-frame-ba", action="store_true",
                    help="--offline with the reference's per-frame global "
                         "BA schedule instead of one BA per batch")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the extraction and the LM "
                         "(default cuda; cpu runs the plain versions)")
    return ap


def main(argv=None):
    """Run the CLI on ``argv`` (default: the command line); returns the
    System after its outputs are written."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.offline and args.no_depth:
        ap.error("--offline requires the depth pipeline")
    for flag, is_set, what, item in _UNPORTED:
        if is_set(args):
            raise NotImplementedError(
                f"{flag}: {what} is not ported to the torch package "
                f"(ROADMAP.md queue 1, item {item})")

    from object_oriented_slam_tpu_torch.system.tracking import \
        resolve_device

    device = resolve_device(args.device)
    mesh, started = None, False
    if args.distributed or args.offline_shard:
        import torch.distributed as dist
        from object_oriented_slam_tpu_torch.parallel import multihost
        started = not dist.is_initialized() and multihost.initialize(
            backend=args.dist_backend, device=device)
        if started:
            print(f"torch.distributed initialized: rank "
                  f"{dist.get_rank()} of {dist.get_world_size()} "
                  f"({dist.get_backend()})")
        mesh = multihost.observation_mesh(device)
        device = mesh.device
    try:
        return _run(args, device, mesh)
    finally:
        if started:
            multihost.shutdown()


def _run(args, device, mesh):
    from object_oriented_slam_tpu_torch.core.camera import Camera
    from object_oriented_slam_tpu_torch.frontend import (
        ExtractorConfig, make_extractor, make_fused_extractor,
        make_plane_estimator, make_split_extractor)
    from object_oriented_slam_tpu_torch.io import Config
    from object_oriented_slam_tpu_torch.io.tum import TUMDataset
    from object_oriented_slam_tpu_torch.system import System

    cfg = Config(args.settings)
    cam = Camera(fx=cfg.get_float("Camera.fx"), fy=cfg.get_float("Camera.fy"),
                 cx=cfg.get_float("Camera.cx"), cy=cfg.get_float("Camera.cy"),
                 scale=cfg.get_float("Camera.scale"),
                 width=cfg.get_int("Camera.width", 640),
                 height=cfg.get_int("Camera.height", 480))

    extractor = None
    ext_cfg = None
    plane_est = None
    fuse_lm = False
    if not args.no_depth:
        open_sym = (not args.no_symmetry
                    and cfg.get_int("EllipsoidExtraction.Symmetry.Open") == 1)
        ext_cfg = ExtractorConfig(
            depth_range=cfg.read_value("EllipsoidExtractor_DEPTH_RANGE", 6.0),
            cluster_tolerance=cfg.get_float(
                "EllipsoidExtraction.Euclidean.ClusterTolerance", 0.02),
            cluster_min_size=cfg.get_int(
                "EllipsoidExtraction.Euclidean.MinClusterSize", 100),
            cluster_center_dis=cfg.get_float(
                "EllipsoidExtraction.Euclidean.CenterDis", 0.5),
            sym_grid=cfg.get_float("EllipsoidExtraction.Symmetry.GridSize",
                                   0.1),
            open_symmetry=open_sym)
        choice = args.extractor
        if choice == "auto":
            # the probe's rule (JAX system/probe.py): the measured round
            # trip picks mono (a remote link) or fused-split + LM fusion
            from object_oriented_slam_tpu_torch.io.native_loader import (
                cluster_available, cluster_error)
            from object_oriented_slam_tpu_torch.system.probe import (
                choose_architecture, probe_device_rtt_ms)
            rtt = probe_device_rtt_ms(device=device)
            choice, fuse_lm = choose_architecture(rtt)
            print(f"probed device RTT {rtt:.2f} ms -> extractor="
                  f"{choice}, fuse_lm={fuse_lm}")
            if not cluster_available():
                print(f"host clustering library unavailable: "
                      f"{cluster_error()}")
        make = {"mono": make_extractor, "split": make_split_extractor,
                "fused": make_fused_extractor}[choice]
        extractor = make(cam, ext_cfg, device)
        plane_est = make_plane_estimator(cam, device=device)

    slam = System(args.settings, extractor=extractor,
                  plane_estimator=plane_est, device=device)
    if args.pipeline_depth > 0:
        slam.tracker.pipeline_depth = args.pipeline_depth
        slam.tracker.adaptive_depth = False
    if not args.no_depth:
        slam.open_ground_plane_estimation()
        if fuse_lm:
            slam.tracker.fuse_lm = True
    if args.distributed:
        slam.open_distributed_backend(mesh)
        print(f"backend sharded over {mesh.size} rank(s)")

    skip = 0
    if args.resume:
        from object_oriented_slam_tpu_torch.system.checkpoint import \
            load_state
        st = load_state(args.resume)
        slam.tracker.restore_state(st)
        skip = len(st.frames_ts)
        print(f"Resumed from {args.resume}: {skip} frames, "
              f"{len(st.objects)} instances")

    os.makedirs(args.out, exist_ok=True)
    ds = TUMDataset(args.dataset)
    if args.odometry:
        ds.set_odometry(args.odometry)
    try:
        if args.offline:
            _offline(args, slam, ds, cam, ext_cfg, mesh)
        else:
            _online_loop(args, slam, ds, skip)
    finally:
        ds.close()
    if mesh is not None and mesh.rank != 0:
        # the same map as rank 0's, which alone writes the files
        slam.tracker.sync()
    else:
        _save_outputs(args, slam)
    return slam


def _offline(args, slam, ds, cam, ext_cfg, mesh):
    from object_oriented_slam_tpu_torch.system.offline import OfflineMapper

    if args.offline_shard:
        print(f"offline detection batches sharded over {mesh.size} rank(s)")
    mapper = OfflineMapper(slam, cam, ext_cfg, batch_size=args.batch,
                           with_association=not args.auto_assoc,
                           mesh=mesh if args.offline_shard else None,
                           split=args.offline_split,
                           backend_per_batch=not args.offline_per_frame_ba)

    def frames_limited():
        for k, rec in enumerate(ds.frames()):
            if args.max_frames and k >= args.max_frames:
                return
            yield rec

    stats = mapper.run(frames_limited())
    print(f"Offline: {stats['frames']} frames in {stats['seconds']:.1f}s "
          f"({stats['fps']:.2f} fps, {stats['batches']} batched programs of "
          f"{args.batch})")
    return mapper


def _online_loop(args, slam, ds, skip):
    from object_oriented_slam_tpu_torch.system.metrics import timing_summary

    t0 = time.time()
    n = 0
    n_seen = 0
    for i, ts, pose, depth, rgb, det in ds.frames():
        n_seen += 1
        if n_seen <= skip:
            continue
        slam.track_with_objects(ts, pose, det, depth=depth, rgb=rgb,
                                with_association=not args.auto_assoc)
        n += 1
        if n % 10 == 0:
            print(f"frame {n} ({time.time() - t0:.1f}s)", flush=True)
        if args.max_frames and n >= args.max_frames:
            break
    dt = time.time() - t0
    print(f"Processed {n} frames in {dt:.1f}s ({n / max(dt, 1e-9):.2f} fps)")
    print("Timing:", timing_summary(slam.tracker.metrics))
    trace = slam.tracker.depth_trace
    if trace and max(trace) != min(trace):
        print(f"Pipeline depth (adaptive): start {trace[0]} "
              f"final {trace[-1]} max {max(trace)}")
    return n


def _save_outputs(args, slam):
    import numpy as np

    slam.save_objects_to_file(os.path.join(args.out, "objects.txt"))
    slam.save_object_history(os.path.join(args.out, "object_history.txt"))
    print("Objects:")
    for inst, v in slam.map_objects.items():
        print(f"  #{inst}: {np.round(v, 4)}")
    if args.checkpoint:
        # after save_objects_to_file's sync(): no frame is pending
        from object_oriented_slam_tpu_torch.system.checkpoint import \
            save_state
        save_state(slam.tracker.state, args.checkpoint)
        print(f"Saved checkpoint to {args.checkpoint}")

    if args.slam_mode:
        # after the objects' files: SLAM mode reads the state and leaves it
        from object_oriented_slam_tpu_torch.backend.lm import LMConfig
        from object_oriented_slam_tpu_torch.io.writers import save_objects
        from object_oriented_slam_tpu_torch.system.slam_mode import \
            run_slam_mode
        st = slam.tracker.state
        poses_ref, obj_ref, chi2 = run_slam_mode(
            st, slam.tracker.K, LMConfig(iters=10),
            max_frames=args.slam_max_frames,
            max_objects=args.slam_max_objects,
            odo_weight=args.odo_weight, device=slam.tracker.device)
        with open(os.path.join(args.out, "trajectory_refined.txt"),
                  "w") as f:
            for ts, p in zip(st.frames_ts, poses_ref):
                f.write(" ".join([f"{ts:.6f}"] + [f"{v:.9f}" for v in p])
                        + "\n")
        insts = sorted(obj_ref)
        # np.array, not JAX's np.stack: a run without objects writes an
        # empty file instead of raising
        save_objects(os.path.join(args.out, "objects_slam.txt"), insts,
                     np.array([obj_ref[i] for i in insts]).reshape(-1, 10))
        print(f"SLAM mode: refined {len(poses_ref)} poses, "
              f"{len(obj_ref)} objects (chi2 {chi2:.4g})")


if __name__ == "__main__":
    main()
