"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero if any fails):
  1. the card's name and power limit; TF32 off for the plain versions'
     matmuls;
  2. build the BA edge kernels from csrc/ba_edges.cu, the depth-frontend
     kernels from csrc/frontend.cu, the SLAM edge kernel K11 from
     csrc/slam_edges.cu and the dense fuse K12 from csrc/dense_fuse.cu
     (nvcc, sm_90a) and the host clustering
     of the split extractors from native/src/cluster.cpp (g++), all at
     once;
  3. each kernel against its plain PyTorch version on the same card
     tensors, at full capacity (24 objects, 512 2D and 256 3D edges each,
     gravity on) and at the main path's tier (24, 512, 32), with its time
     beside its bound (the card's least time for the same bytes and
     operations); the two LM step entry points (the same kernels with
     their solve and accept epilogues) against their plain versions on
     inputs with accepted, rejected, edgeless and non-finite objects, and
     bit for bit against a second launch; one whole LM call on the card
     (kernels) against the CPU (plain);
  4. the main path: System.track_with_objects over a 600-frame, 24-object
     synthetic 2D-only sequence on the card, with the kernels' launch
     counts, e2e and backend ms/frame, and the map against the ground
     truth; objects.txt is written to a temporary directory; the
     profiler's launch count of one LM call and of one LM iteration (which
     must be exactly two kernel launches);
  5. the depth main path: System with the extractor and the plane
     estimator over a 160-frame orbit of the same 24-object scene with
     rendered depth (ground plane, monolithic extraction, 3D observations
     and initialisation, the LM with live 3D edges), with the launch counts
     of every kernel, e2e / extraction / backend ms per frame, the cloud
     tiers and the clustering rounds; one extraction call under the
     profiler, which must be three frontend launches (depth_cloud,
     cluster_components, voxel_downsample), fewer device operations than
     the four-launch call's 830, and must not make the host wait for the
     device between its argument copies and its result copy;
  6. the symmetry path: the same orbit with synthetic_depth_sym.yaml
     (symmetry completion on) over the scene with four objects labelled 28
     (dual reflection) and the seed's reflections: the plane on frame 0,
     24/24 objects within a median centre error of 0.05 m, symmetry_search
     launched once per frame with a detection of type 1 or 2, e2e /
     extraction / backend ms; one extraction call under the profiler and
     the synchronisation check, which must be four frontend launches;
  6b. the sparse symmetry path: the symmetry path's scene, orbit and
     settings with ExtractorConfig(open_symmetry=True,
     sparse_symmetry=True) (no settings key turns it on): each point's
     depth-border flag rides depth_cloud and voxel_downsample, and
     symmetry_search mirrors the border cells only; objects, centre error,
     map IoU, e2e / extraction / backend ms, per frame the detections
     searched, their sources against their live points and the dense
     fall-backs (it raises if no detection had a proper border subset),
     launches, and one extraction call of four frontend launches without
     host synchronisation;
  7. the depth-frontend kernels (depth_cloud, cluster_components,
     voxel_downsample) against their plain versions at the shapes the depth
     main path gave them on its mid-orbit frame (that frame through the
     extractor's own packing: 32 detection lanes, its cloud tier, its
     survivors; the script raises if the path ran that frame at other
     shapes), at the full tier (8 detections, cloud capacity 16384;
     depth_cloud with a whole-image box among them) and, for
     cluster_components, on dense clouds that fill all 16384 lanes (its
     streamed branch) and under a bound of 2 rounds (truncation): masks,
     cells and labels equal, converged flags and round counts equal, floats
     bit for bit against the plain version on the CPU and within 1e-6
     (5e-6 for the object downsample) against it on the card, repeats
     bit-equal, device time beside the bound and beside a PyTorch yardstick
     (a stable torch.sort, a gather and torch.segment_reduce), and the
     sort's own time; symmetry_search against its plain version at the
     symmetry path's mid-orbit frame (single and dual detections in one
     launch, exact gradient and central differences) and at sym_capacity
     filled (8 dual detections x 512 points): every output bit for bit
     (all 9 initial planes' parameters and costs, the winners, prob,
     error), repeats bit-equal, time and cost passes a search beside the
     bound and the torch.cdist + torch.amin yardstick; sparse symmetry's
     lanes at the sparse path's mid-orbit frame: depth_cloud with the
     border attribute and voxel_downsample with it (the attribute within
     the points' tolerances, the other outputs bit-equal to the launches
     without the lane, the cells whose mean lies within 1e-6 of the 0.3
     threshold counted on the card and in the plain version),
     symmetry_search with the border cells as sources bit-equal to its
     plain version (and with every live point as a source bit-equal to
     the search without a mask), and at sym_capacity filled with about
     half the points as sources;
  6c. the command line ([cli]): the probe's round trip and choice (which
     must be fused-split with LM fusion on the card); one split extraction
     call (phase A, the host middle stage, phase B) under the profiler
     beside the monolithic call; the symmetry path's scene and orbit
     exported as a TUM sequence by examples/torch_make_synthetic_tum.py and
     run by examples/torch_run_tum.py with synthetic_depth_sym.yaml, with
     --extractor mono at --pipeline-depth 1 and at the default (the
     adaptive deferred pipeline, depth 4 to 8, and the asynchronous plane),
     split, fused and the default auto: 24/24 objects within a median
     centre error of 0.05 m of objects_gt.txt, map IoU, each objects.txt
     within 1e-4 of the adaptive mono run's (and whether bit-equal), every
     kernel of the run's path launched (cluster_components never on the
     host-clustered runs), and every frame after the plane latch under
     PyTorch's synchronisation check set to raise (the host waits only on
     the events of the due fetch, the drain, the plane and phase A's
     copy); per run the frames' host ms, frames/s, fetch waits and blocked
     share, the depth trace and launches, and on the host-clustered runs
     the middle stage's host ms and phase A's bytes a frame; the numpy PNG
     decode ms of a depth frame (Up filter), of its Paeth-filtered copy
     and, where cv2 is installed, of the frame as cv2 writes it;
  6d. the offline batch mapper ([offline]): [cli]'s export run by
     examples/torch_run_tum.py --offline in batches of 8 frames with one BA
     a batch, with --offline-per-frame-ba and with --offline-split (the
     u16 phase A): 24/24 objects within a median centre error of 0.05 m,
     map IoU, frames/s and host ms a frame beside the adaptive mono CLI
     run's, the per-frame-BA run's objects.txt within 1e-3 of the adaptive
     mono run's (and whether bit-equal), depth_cloud, voxel_downsample and
     symmetry_search launched once a batch plus once a bootstrap frame
     (cluster_components too, never on the split run), fewer BA launches
     with one BA a batch than one a frame, every batched frame and call
     under the synchronisation check; one batched call of 8 mid-orbit
     frames under the profiler (device operations, busy ms, idle share,
     operations a frame against the online call's); at that batch's
     shapes depth_cloud with the frame lane (and the border lane) and
     symmetry_search with the frame lane against their plain versions and
     bit for bit against the same detections launched one frame at a time,
     and the clustering's sort-frame hint one rotation a detection against
     one for all (labels, rounds and selections equal, device ms);
  6e. SLAM mode ([slam]): [cli]'s export (written with odometry.txt, 1 cm
     of random-walk drift a frame) run by examples/torch_run_tum.py
     --odometry --slam-mode --checkpoint: the online run, then the banded
     Schur LM over every pose and object (10 iterations, the packer's
     tiers: 256 frames, 32 objects, edges from the counts) with K11
     (csrc/slam_edges.cu) launched 10 times for the edge terms and 11 for
     the chi2; 24/24 objects and every pose finite, the ATE of the
     odometry input and of trajectory_refined.txt against the ground
     truth, objects_slam.txt's map beside objects.txt's; at the checkpoint's
     graph K11 against its plain version (every edge's distance from the
     float64 evaluation within 1e-4 of its output's largest entry or 4
     times the plain version's own on that edge, on the card or the CPU;
     the banded normal equations within 1e-4 of the plain version's or
     twice its own CPU-to-card distance; chi2 within 1e-5, repeats
     bit-equal), its time (the profiler held against CUDA events
     around launches enqueued behind a spin) beside its bound (the
     operations counted on this graph's live edges, a 3D edge's tangents
     for its winning yaw candidate alone; every candidate's beside), its
     launch shape, ptxas's registers and spills and the Jacobian
     launch's phase clocks (a -DOSLAM_SLAM_CLOCKS build), one
     optimize_slam call under the synchronisation check set to raise (frame 0 within 1e-7, chi2 down, a repeat bit-equal, the
     CLI's files to their digits) and under the profiler (wall, busy, device operations, idle
     share), and the dense solve against the banded one (each Schur step
     along the banded path within 2e-3, and end to end within 2e-3 unless
     the paths part at an accept test tied within chi2's round-off); then
     the
     same export with --no-depth --odometry --slam-mode (no 3D edges), its
     ATE beside the odometry's;
  6f. the distributed backends ([dist], object_oriented_slam_tpu_torch/
     parallel): NCCL at world size 1 in this process, then two gloo ranks
     sharing the card (spawned processes, every tensor on cuda:0): the
     observation-sharded LM at the FULL tier against optimize_objects_soa,
     the edge- and frame-sharded SLAM solve (dense and banded) at [slam]'s
     graph against optimize_slam on the same padded graph, and (gloo)
     one [offline] batch through dispatch_batch(mesh=...) against the
     unsharded call, at the dry run's tolerances (parallel/dryrun.py),
     each rank's launches of K1-K4, K11 and K5-K8 on its own shard; then
     examples/torch_run_tum.py --distributed --offline --offline-shard
     --batch 8 on [cli]'s export under torch.distributed.run with two
     gloo ranks, rank 0's objects.txt within 1e-3 of [offline]'s unsharded
     run's; every group, rank and launch bounded by DIST_TIMEOUT seconds,
     times printed beside the card's line and claimed nowhere;
  6g. the dense builder ([dense], after [dist]): [cli]'s export run by
     examples/torch_run_tum.py --extractor mono --build-dense (the
     external DenseBuilder, 1 cm leaf, stride 4, 1 << 19 cells): K12
     (csrc/dense_fuse.cu) launched once a frame, map.ply's point count the
     builder's mask count, objects.txt byte for byte the adaptive mono
     run's, frames/s beside that run's, the run's fuses by path (the
     device's tally: the fast merge, the general sort); K12 against its
     plain version on the CPU (bit for bit, or it raises) and on the card
     at the export's first frame into an empty map and at a mid-orbit
     frame into the run's filled map (the fast path, or it raises) and
     into the same map with its rows shuffled (the general path, or it
     raises), repeats
     bit-equal, one device operation a fuse (the profiler's, or it
     raises), device ms of a fuse beside its bound (the map's rows in and
     out and the frame's strided pixels, each byte once) and the design's
     own bytes (printed), the plain version's and the stable sort + gather
     + segment_reduce yardstick's; a builder's fuse of the mid-orbit frame
     under torch.cuda.set_sync_debug_mode("error"), its two-frame map bit
     for bit the plain version's;
  6h. the AoS backend ([aos]): a tracker with use_soa_backend=False
     (its _opt_fn picked again, the JAX package's wiring) and
     use_incremental_init=False over 48 frames of the 2D path's scene:
     the map within a median centre error of 0.05 m, one ba_normal_eq and
     one ba_chi2 launch an iteration of every AoS LM call (+1 chi2 at
     est0), the incremental initializer never fed; one AoS LM call's device
     operations under the profiler; 4 more frames under
     system/profiling.device_trace with an annotate range, whose trace must
     name the range and both BA kernels;
  6i. stage (d)'s options ([clustering], after [aos]): the depth path's
     scene, orbit, lanes and tier with ExtractorConfig(grid_cluster=True)
     (K13, cluster_grid: the grid pass) and with cluster_chains=2
     (K5's chain lane): 24 objects' median centre error <= 0.05 m, the map
     within 1e-4 of a run with the same radius test (the grid's: the path
     with cluster_grid_select_plain as stage (d); the chains': [depth]'s)
     and within 1e-3 of [depth]'s K5 map (each: whether bit-equal), the
     option's kernel launched once a frame and K5 never, every frame after
     the plane latch under the synchronisation check, one extraction call
     under the profiler (three launches); then K13 and K5's exact and chain lanes
     against their plain versions on the card (labels, converged, rounds,
     sel and ok equal, repeats bit-equal) at the path's mid-orbit frame,
     at the full tier with a whole-image box and on dense voxel clouds
     that fill 16384 lanes, each also under a bound of 2 rounds, with
     device ms beside the bound and beside K5's default on the same
     inputs; K13 again with the shared memory cut to the least it takes
     (its neighbour lists in device memory: equal, and timed); whether the
     path's survivors come in the grid key's order (informational: K13
     sorts its key table where they do not); one [offline] batch with
     grid_cluster (one K13 launch), each frame's rows bit for bit against
     its own one-frame extraction with grid_cluster, and K13 on the
     batch's inputs against its plain version and timed beside K5's
     default on the same batch;
  6j. the viewers ([viz]): [cli]'s export run by examples/torch_run_tum.py
     --extractor mono with --viz-live 40, and with --viz where cv2 and
     matplotlib import (which ran is printed): live.html with the map and
     the image panels, or the 160 frame PNGs and map.png; objects.txt byte
     for byte [cli]'s adaptive mono run's; frames/s beside it;
  8. one JSON line with a record per kernel (``launches_cli``: the
     adaptive mono CLI run's count of that kernel, ``launches_cli_split``
     / ``_fused`` / ``_auto`` the host-clustered runs',
     ``launches_offline`` / ``_offline_per_frame_ba`` /
     ``_offline_split`` the offline runs', ``launches_dist_ranks`` /
     ``launches_dist_cli`` [dist]'s per gloo rank, ``launches_aos`` on
     the BA records [aos]'s; K12's records with the --build-dense run's
     launches; the frame lanes' records at the offline batch's shapes, the border lane's with the
     frame lane among
     the shapes no path reached; K13's and K5's lanes' records with the
     option runs' launches, the exact lane's 0: no path runs it), the card
     line, and the result line
     {"ok": true, "device": {...}} last.
Every path prints its map's IoU against the ground truth
(system/metrics.object_map_iou).
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 7
FULL = (24, 512, 256)       # object tier x 2D ring x 3D ring capacities
TIER = (24, 512, 32)        # the 2D-only main path's LM tier
NORMAL = (0.05, -0.02, 1.0)
SOURCE = "object_oriented_slam_tpu_torch/csrc/ba_edges.cu"
# the card's published peaks (H100 SXM): HBM bytes/s, f32 FLOP/s outside
# the tensor cores
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
# f32 operations, counted from csrc/ba_edges.cu: one per + - * / compare,
# sqrt, sin, cos, atan2, acos on a float.  A Dual<9> operation costs 10
# (add, scale), 28 (mul), 40 (div: the value, two reciprocals, 4 per
# tangent), 12 (sqrt, sin, acos, max), 20 (cos), 33 (atan2).  Per active
# edge: the residual chain (15 dual divisions in the 2D chain, 7 per 3D
# candidate), its weighting, and for the normal equations 110 per row (55
# products and sums) and 275 for the lane's part of the shuffle reduction.
OPS = {
    "ba_normal_eq": dict(e2=4030 + 54 + 40 + 4 * 110 + 275,
                         e3=4 * 2564 + 90 + 9 * 110 + 275,
                         obj=2335 + 462 + 389),   # exp update, R, gravity
    "ba_chi2": dict(e2=283 + 4 + 8, e3=4 * 181 + 9 + 18, obj=211),
}
OPS_SOLVE = 675     # lam0, 9x9 Cholesky solve, gate, exp update (float)
OPS_ACCEPT = 50     # denom, rho, accept, schedule
FE_SOURCE = "object_oriented_slam_tpu_torch/csrc/frontend.cu"
FE_TIER = 16384             # the extractor's default cloud capacity
FE_DETECTIONS = 8
N_DEPTH_FRAMES = 160
# f32 / integer operations of one pair test of cluster_components, counted
# from csrc/frontend.cu: 3 multiplies and 2 adds (the dot product), the sum
# of the norms, the doubling, the difference, 2 compares and a select.  The
# bound charges them for the pairs its skip of far groups leaves
# (tested_pairs)
PAIR_OPS = 11
# clustering rounds per frame on the depth path (min, median, max)
PATH_ROUNDS = (16, 24, 44)
# the frontend launches of one extraction call without and with symmetry,
# and the device operations of the four-launch call before depth_cloud and
# voxel_downsample
CALL_LAUNCHES = {"depth_cloud": 1, "cluster_components": 1,
                 "voxel_downsample": 1, "symmetry_search": 0}
SYM_CALL_LAUNCHES = dict(CALL_LAUNCHES, symmetry_search=1)
CALL_OPS_BEFORE = 830
# the clustering options' kernels (K13, K5's exact and chain lanes), whose
# counters the depth-path runs read too: 0 where no option is on
OPTION_NAMES = ("cluster_grid", "cluster_components_exact",
                "cluster_components_chain")
# f32 operations of one pair test of symmetry_search, counted from
# csrc/frontend.cu: the dot product (3 multiplies, 2 adds), the norm sum,
# the doubling, the difference, the compare and the select of the minimum
SYM_PAIR_OPS = 10
# the objects of the symmetry path's scene labelled 28 (dual reflection)
SYM_DUAL_OBJECTS = (0, 6, 12, 18)
# integer / f32 operations the fused downsamples need, counted from
# csrc/frontend.cu: per live point its cell (3 divisions, 3 floors), the
# least cell, its key (3 subtractions, 3 clamps, shifts and ors), three
# radix passes (digit, match, count, offset, scatter: ~10 each), the
# segment test and its share of the mean (3 adds); per output slot the
# mean's 3 divisions and cell decode (9), for depth_cloud the world point
# and plane distance (22)
DS_OPS_POINT, DS_OPS_SLOT, DS_OPS_WORLD = 60, 12, 22
# sparse symmetry's lane: per live point of depth_cloud the border test (5
# divisions, 5 compares, 4 differences and absolutes, the ors: ~25) and per
# point of either downsample the attribute's add; per slot its division
DS_OPS_BORDER, DS_OPS_ATTR = 25, 1
# the functions of the JAX package (left to XLA there) that the frontend
# kernels replace
FE_REPLACES = {
    "depth_cloud": "object_oriented_slam_tpu/frontend/extractor.py:132",
    "voxel_downsample": "object_oriented_slam_tpu/ops/voxel.py:101",
    "cluster_components": "object_oriented_slam_tpu/ops/cluster.py:379",
    "symmetry_search": "object_oriented_slam_tpu/frontend/symmetry.py:72"}
# with sparse symmetry's lanes: the border map, sampled and averaged in
# _stage_a_one (ops/filters.py:54, ops/backproject.py:80, ops/voxel.py:111);
# the attribute downsample; the cost with its src_mask
SPARSE_REPLACES = dict(
    FE_REPLACES, voxel_downsample="object_oriented_slam_tpu/ops/voxel.py:118")
# with the offline batch mapper's frame lane: JAX's batched stages (a)-(c)
# with each detection's row0 (extract_local_ellipsoids_multi's _stage_a_one
# under vmap) and its symmetry with proj_row0 (_sym_finish_one under vmap)
OFFLINE_REPLACES = {
    "depth_cloud": "object_oriented_slam_tpu/frontend/batch_extractor.py:91",
    "symmetry_search":
        "object_oriented_slam_tpu/frontend/batch_extractor.py:126"}
REPLACES = {"K1": "attic/pallas_ba_kernels.py:183",
            "K2": "attic/pallas_ba_kernels.py:202",
            "K3": "attic/pallas_ba_kernels.py:219",
            "K4": "attic/pallas_ba_kernels.py:238"}


def build_cluster():
    """The host clustering library of the split extractors, built from
    native/src/cluster.cpp with g++ (io/native_loader.py); raises with the
    compiler's error."""
    from object_oriented_slam_tpu_torch.io import native_loader
    if not native_loader.cluster_available():
        raise RuntimeError(f"native/src/cluster.cpp does not build: "
                           f"{native_loader.cluster_error()}")


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=2):
    """Mean time of fn() per call, CUDA events around reps calls (for the
    plain versions, whose many kernels keep the card behind the host)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def queued_ms(fn, reps, warmup=2):
    """Mean time the card spends on one fn() call, CUDA events around reps
    back-to-back calls that wait on the card behind a spin
    (``torch.cuda._sleep``): the card starts them only once the host has
    enqueued them all, so a host slower than the kernel adds no gaps.  The
    spin starts at 2^23 cycles and doubles while the host had not finished
    enqueueing when the spin ended (the start event already passed)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 1 << 23
    for _ in range(8):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        waited = not a.query()
        torch.cuda.synchronize()
        if waited:
            return a.elapsed_time(b) / reps
        cycles *= 2
    raise RuntimeError(f"the host took longer to enqueue {reps} calls than "
                       f"a spin of {cycles // 2} cycles")


def profiled(fn, reps=1, expect=None):
    """The profiler's CUDA events (kernels, copies, memsets) of reps fn()
    calls, synchronized.  In a process that has run for a while a trace
    lacks its first launches (one or two, and up to ten once the offline
    phase has run), so 64 random fills go first (a kernel nothing else
    here launches), 8 more after, all left out by name.  A trace that still
    comes back empty, or with fewer than ``expect`` operations, is taken
    again, up to six times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    first = torch.empty(8, device="cuda")
    events = []
    for _ in range(6):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(64):
                first.random_()
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            for _ in range(8):
                first.random_()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and "distribution_elementwise" not in e.key]
        if sum(e.self_device_time_total for e in events) > 0 and sum(
                e.count for e in events) >= (expect or 1):
            break
    return events


def device_ms(fn, reps, warmup=2, name=None, whole=False):
    """Mean time the card spends on one fn() call that launches one kernel,
    from the profiler's kernel events over reps calls.  A BA kernel runs
    for less than the host takes to enqueue its launch, so CUDA events
    around back-to-back launches would time the host.  With ``name`` only
    the events of the kernel of that name count (the wrapper around it may
    copy a few scalars to the card).  ``whole``: returns (that time, the
    time of every device operation of the same calls)."""
    for _ in range(warmup):
        fn()
    for _ in range(6):      # a trace may lack the named kernel's events
        every = events = profiled(fn, reps, expect=reps)
        if name is not None:
            events = [e for e in events if name in e.key]
        if sum(e.count for e in events) == reps:
            break
    else:
        raise RuntimeError(
            f"the profiler shows {sum(e.count for e in events)} device "
            f"operations for {reps} launches")
    ms = sum(e.self_device_time_total for e in events) / 1e3 / reps
    if whole:
        return ms, sum(e.self_device_time_total for e in every) / 1e3 / reps
    return ms


def checked_device_ms(fn, reps, name, whole=False):
    """``device_ms`` of a kernel, held against CUDA events around the same
    back-to-back launches enqueued behind a spin of the card (``queued_ms``:
    the card's time, gaps between launches included, however slow the host
    is): a trace may carry the right count of events and a wrong time.  The
    profiler's time must lie within 0.75 to 1.05 of the events'; else both
    are taken again, up to three times.  ``whole``: the profiler's time of
    every device operation of fn() is the one held against the events (fn
    also fills a buffer, say, which the events time too).  Returns
    (profiler ms of the kernel, events ms)."""
    for _ in range(3):
        ms, all_ms = device_ms(fn, reps, name=name, whole=True)
        ev = queued_ms(fn, reps)
        if 0.75 * ev <= (all_ms if whole else ms) <= 1.05 * ev:
            return ms, ev
    raise RuntimeError(f"{name}: the profiler reads {ms:.4f} ms a launch "
                       f"({all_ms:.4f} ms with every device operation of "
                       f"the call), CUDA events around the same launches "
                       f"{ev:.4f} ms")


def lm_inputs(shape, dev, seed=SEED, edit=None):
    """A seeded LM batch at ``shape`` on ``dev`` (``edit`` may change its
    numpy arrays first): (arrays, observations, the kernels' arguments)."""
    from object_oriented_slam_tpu_torch.backend import (
        LMConfig, lm_soa, observations_from_numpy)
    from object_oriented_slam_tpu_torch.io.synthetic import make_lm_batch
    arrays = make_lm_batch(*shape, seed=seed)
    if edit is not None:
        edit(arrays)
    obs = observations_from_numpy(arrays, dev)
    K = torch.tensor([[535.4, 0, 320.1], [0, 539.2, 247.6], [0, 0, 1]],
                     device=dev)
    n = torch.tensor(NORMAL, device=dev)
    prep = lm_soa.soa_prepare(obs.pose2d_cw, obs.bbox2d, obs.pose3d_wc,
                              obs.meas3d)
    w2, w3, wg = lm_soa.soa_edge_weights(obs, prep, K, True, LMConfig())
    return arrays, obs, (obs.est0, prep, w2, w3, wg, n, K)


def neq_errors(got, want):
    """(max abs error over H, g, r2sum; max over objects of the H/g error
    relative to max|H|; r2sum relative error)."""
    H, g, c = (t.double() for t in got)
    Hp, gp, cp = (t.double() for t in want)
    for t in (H, g, c, Hp, gp, cp):
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError("non-finite normal equations")
    scale = Hp.abs().flatten(1).amax(1).clamp_min(1e-30)
    rel = torch.maximum((H - Hp).abs().flatten(1).amax(1),
                        (g - gp).abs().amax(1)) / scale
    abs_err = max(float((H - Hp).abs().max()), float((g - gp).abs().max()),
                  float((c - cp).abs().max()))
    return abs_err, float(rel.max()), rel_err(c, cp)


def rel_err(got, want):
    """Max relative error; an exact zero must be matched exactly."""
    return float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())


def bound(kernel, args, outputs, extra_ops_per_object=0, extra_inputs=()):
    """(bound_ms, bound_by): the least time the card could take for one
    call on these inputs.  Bytes: every input read once and
    every output written once.  Operations: OPS per edge with a non-zero
    weight (the kernels skip the others) and per object."""
    est, prep, w2, w3 = args[:4]
    tensors = [est, *prep, *args[2:7], *extra_inputs, *outputs]
    n_bytes = sum(t.numel() * t.element_size() for t in tensors)
    ops = OPS[kernel]
    n_ops = (int((w2 != 0).sum()) * ops["e2"] + int((w3 != 0).sum())
             * ops["e3"] + est.shape[0] * (ops["obj"] + extra_ops_per_object))
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_F32 * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def sliced(args, m2, m3):
    """The problem cut to its first m2 2D and m3 3D edge slots (gravity
    goes with the 2D edges)."""
    from object_oriented_slam_tpu_torch.backend import lm_soa
    est, prep, w2, w3, wg, n, K = args
    p = lm_soa.SoaPrep(prep.pose2d_cw[:, :m2].contiguous(),
                       prep.bbox2d[:, :m2].contiguous(),
                       prep.invp3[:, :m3].contiguous(),
                       prep.sc3[:, :m3].contiguous())
    return (est, p, w2[:, :m2].contiguous(), w3[:, :m3].contiguous(),
            wg if m2 else torch.zeros_like(wg), n, K)


def phase_kernels(dev):
    """Kernels vs plain versions; returns the per-K records."""
    from object_oriented_slam_tpu_torch.backend import ba_kernels, lm_soa
    recs = {}

    _, _, full = lm_inputs(FULL, dev)
    O, M2, M3 = FULL
    # K1/K3: the 2D (+ gravity) edges alone, K2/K4: the 3D edges alone
    for k, (m2, m3) in (("K1", (M2, 0)), ("K2", (0, M3))):
        args = sliced(full, m2, m3)
        got = ba_kernels.normal_eq(*args)
        want = lm_soa.soa_normal_eq_plain(*args)
        abs_err, rel, crel = neq_errors(got, want)
        if rel > 1e-4 or crel > 1e-5:
            raise RuntimeError(f"{k} normal_eq disagrees with its plain "
                               f"version: H/g {rel:.3g}, r2sum {crel:.3g}")
        recs[k] = dict(kernel="ba_normal_eq", shape=(O, m2, m3),
                       max_abs_err=abs_err, max_rel_err=rel,
                       bound=bound("ba_normal_eq", args, got),
                       ms=device_ms(lambda: ba_kernels.normal_eq(*args), 20),
                       plain_ms=cuda_ms(
                           lambda: lm_soa.soa_normal_eq_plain(*args), 3, 1))
    for k, (m2, m3) in (("K3", (M2, 0)), ("K4", (0, M3))):
        args = sliced(full, m2, m3)
        got = ba_kernels.chi2(*args).double()
        want = lm_soa.soa_chi2_plain(*args).double()
        rel = rel_err(got, want)
        if not (bool(torch.isfinite(got).all()) and rel <= 1e-5):
            raise RuntimeError(f"{k} chi2 disagrees with its plain version: "
                               f"{rel:.3g}")
        recs[k] = dict(kernel="ba_chi2", shape=(O, m2, m3),
                       bound=bound("ba_chi2", args, [got]),
                       max_abs_err=float((got - want).abs().max()),
                       max_rel_err=rel,
                       ms=device_ms(lambda: ba_kernels.chi2(*args), 20),
                       plain_ms=cuda_ms(lambda: lm_soa.soa_chi2_plain(*args),
                                        5, 1))
    for k, r in recs.items():
        print(f"[kernels] {k} {r['kernel']} at {r['shape']}: max_abs_err "
              f"{r['max_abs_err']:.4g}, rel {r['max_rel_err']:.3g}; kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"{bound_text(r['ms'], r['bound'])}")

    # the fused calls at full capacity and at the main path's tier
    for shape in (FULL, TIER):
        args = full if shape == FULL else sliced(full, *shape[1:])
        abs_err, rel, crel = neq_errors(ba_kernels.normal_eq(*args),
                                        lm_soa.soa_normal_eq_plain(*args))
        got = ba_kernels.chi2(*args).double()
        want = lm_soa.soa_chi2_plain(*args).double()
        c_rel = rel_err(got, want)
        if rel > 1e-4 or crel > 1e-5 or c_rel > 1e-5:
            raise RuntimeError(f"fused kernels disagree at {shape}: H/g "
                               f"{rel:.3g}, r2sum {crel:.3g}, chi2 {c_rel:.3g}")
        t = [device_ms(lambda: ba_kernels.normal_eq(*args), 20),
             cuda_ms(lambda: lm_soa.soa_normal_eq_plain(*args), 3, 1),
             device_ms(lambda: ba_kernels.chi2(*args), 20),
             cuda_ms(lambda: lm_soa.soa_chi2_plain(*args), 5, 1),
             cuda_ms(lambda: ba_kernels.normal_eq(*args), 50),
             cuda_ms(lambda: ba_kernels.chi2(*args), 50)]
        b_neq = bound("ba_normal_eq", args, ba_kernels.normal_eq(*args))
        b_chi = bound("ba_chi2", args, [got])
        S, T = ba_kernels.launch_shape(shape[1] + shape[2])
        print(f"[kernels] fused at {shape}, {shape[0]} x {S} blocks of {T} "
              f"threads: H/g rel err {rel:.3g} of max|H|, "
              f"r2sum rel {crel:.3g}, chi2 rel {c_rel:.3g}; normal_eq kernel "
              f"{t[0]:.4f} ms vs plain {t[1]:.4f} ms, "
              f"{bound_text(t[0], b_neq)}; chi2 kernel {t[2]:.4f} "
              f"ms vs plain {t[3]:.4f} ms, {bound_text(t[2], b_chi)}; "
              f"back-to-back calls (CUDA events, bound by the host's launch "
              f"rate) {t[4]:.4f} and {t[5]:.4f} ms")
        if shape == TIER and not S > 1:
            raise RuntimeError(f"one block per object at the main tier: S={S}")
    return recs


def bound_text(ms, b):
    return (f"bound {b[0] * 1e3:.4g} us by {b[1]}, share of bound "
            f"{b[0] / ms:.4f}")


def same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).contiguous().view(torch.uint8),
        b.reshape(-1).contiguous().view(torch.uint8))


def same_or_both_nan(got, want, tol, scale=None):
    """Largest |got - want| over max|want| per object (or over ``scale``
    [O]); a NaN must be matched by a NaN and an infinity by the same
    infinity.  Raises on a mismatch of either."""
    O = want.shape[0]
    a, b = got.double().reshape(O, -1), want.double().reshape(O, -1)
    if not torch.equal(torch.isnan(a), torch.isnan(b)):
        raise RuntimeError("NaNs in different places")
    inf = torch.isinf(a) | torch.isinf(b)
    if not torch.equal(a[inf], b[inf]):
        raise RuntimeError("infinities in different places")
    a = torch.nan_to_num(a, nan=0.0, posinf=0.0, neginf=0.0)
    b = torch.nan_to_num(b, nan=0.0, posinf=0.0, neginf=0.0)
    if scale is None:
        scale = b.abs().amax(1)
    scale = torch.nan_to_num(scale.double(), posinf=1.0)
    err = float(((a - b).abs().amax(1) / scale.clamp_min(1e-30)).max())
    if not err <= tol:
        raise RuntimeError(f"relative error {err:.3g} over the limit {tol:g}")
    return err


def degenerate_objects(arrays):
    """Gives the LM batch its two degenerate objects.  Object 3's estimate
    becomes a 30 m sphere around its cameras, so its projected conics have
    no real axes: the bbox half-widths are sqrt(max(negative, 0)) = 0 with a
    NaN tangent, while every residual value stays finite (the edges pass the
    NaN gate); such edges are left out of the normal equations, by the
    kernel and by the plain version alike, so its H stays finite.  Object
    4 gets the identity rotation: phase_steps hands it a NaN damping, so
    its du is non-finite, the du_ok gate zeroes the step, and the zero step
    returns the estimate bit for bit."""
    arrays["est0"][3, 3:] = (0, 0, 0, 1, 30, 30, 30)
    arrays["est0"][4, 3:7] = (0, 0, 0, 1)


def phase_steps(dev):
    """lm_solve_step and lm_accept_step (the kernels with their LM
    epilogues) against their plain versions; returns their records."""
    from object_oriented_slam_tpu_torch.backend import ba_kernels, lm_soa
    recs = {}
    for shape in (FULL, TIER):
        # objects 3 and 4 are degenerate, the last object has no edges
        est, *problem = lm_inputs(shape, dev, SEED + 1,
                                  degenerate_objects)[2]
        problem = (*problem, 0.0)
        O = shape[0]
        lam = torch.full((O,), -1.0, device=dev)
        lam[1::2] = 0.25            # given dampings beside first iterations
        lam[4] = float("nan")       # a non-finite du for the du_ok gate
        nu = torch.full((O,), 2.0, device=dev)

        # --- solve step
        got = ba_kernels.lm_solve_step(est, lam, *problem, want_H=True)
        again = ba_kernels.lm_solve_step(est, lam, *problem)
        want = lm_soa.lm_solve_step_plain(est, lam, *problem, want_H=True)
        torch.cuda.synchronize()
        est_new, du, g, lam0, H = want
        if again[4] is not None or not all(
                same_bits(a, b) for a, b in zip(got[:4], again[:4])):
            raise RuntimeError("lm_solve_step: two launches differ in bits")
        gated = ~torch.isfinite(lam0)
        if not (bool(gated[4]) and float(du[4].abs().max()) == 0.0
                and float(got[1][4].abs().max()) == 0.0):
            raise RuntimeError("no object with a non-finite, gated du")
        # object 3: every 2D edge has a NaN tangent and is left out, so H is
        # finite (its 3D edges and gravity) and the object moves
        if not (bool(torch.isfinite(H[3]).all())
                and bool(torch.isfinite(got[4][3]).all())
                and float(du[3].abs().max()) > 0.0
                and float(got[1][3].abs().max()) > 0.0):
            raise RuntimeError("the object with NaN-tangent edges is frozen")
        if float(problem[1][-1].abs().sum() + problem[2][-1].abs().sum()):
            raise RuntimeError("the last object has edges")
        hscale = torch.nan_to_num(H).abs().flatten(1).amax(1)
        errs = dict(
            est_new=same_or_both_nan(got[0], est_new, 1e-4),
            du=same_or_both_nan(got[1], du, 1e-4),
            g=same_or_both_nan(got[2], g, 1e-4, hscale),
            lam0=same_or_both_nan(got[3], lam0, 1e-4),
            H=same_or_both_nan(got[4], H, 1e-4, hscale))
        args = (est, *problem[:6])
        rec = dict(kernel="ba_normal_eq", shape=shape,
                   max_abs_err=float(torch.nan_to_num(got[1] - du).abs().max()),
                   max_rel_err=max(errs.values()),
                   bound=bound("ba_normal_eq", args, got[:4], OPS_SOLVE,
                               [lam]),
                   ms=device_ms(lambda: ba_kernels.lm_solve_step(
                       est, lam, *problem), 20),
                   plain_ms=cuda_ms(lambda: lm_soa.lm_solve_step_plain(
                       est, lam, *problem), 3, 1))
        recs[f"lm_solve_step at {shape}"] = rec
        print(f"[steps] lm_solve_step at {shape}: rel err of max|.| per "
              f"object {errs} (limit 1e-4), non-finite du gated for objects "
              f"{gated.nonzero().flatten().tolist()}, repeat bit-equal; "
              f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
              f"{bound_text(rec['ms'], rec['bound'])}")

        # --- accept step: each side starts from its own chi2 at est; object
        # 5's chi2 is set below any trial's, so its step is rejected
        def state(chi2_fn):
            chi2 = chi2_fn(est, *problem)
            chi2[5] = 0.0
            return [est.clone(), chi2, lam0.clone(), nu.clone()]

        runs = [ba_kernels.lm_accept_step(*state(ba_kernels.chi2), est_new,
                                          du, g, lam0, *problem)
                for _ in range(2)]
        st = state(lm_soa.soa_chi2_plain)
        want = lm_soa.lm_accept_step_plain(*st, est_new, du, g, lam0,
                                           *problem)
        torch.cuda.synchronize()
        if not all(same_bits(a, b) for a, b in zip(*runs)):
            raise RuntimeError("lm_accept_step: two launches differ in bits")
        acc = want[4]
        if not torch.equal(runs[0][4], acc):
            raise RuntimeError(
                f"accept flags differ: kernel {runs[0][4].tolist()}, plain "
                f"{acc.tolist()}")
        if not (bool(acc.any()) and not bool(acc[5]) and not bool(acc[4])):
            raise RuntimeError(f"accept flags lack a case: {acc.tolist()}")
        if not torch.equal(runs[0][0][acc], est_new[acc]) or not torch.equal(
                runs[0][0][~acc], est[~acc]):
            raise RuntimeError("lm_accept_step: est not updated in place "
                               "as the flags say")
        one = torch.ones(O, device=dev)
        errs = dict(
            chi2=same_or_both_nan(runs[0][1][:, None], want[1][:, None], 1e-5),
            lam=same_or_both_nan(runs[0][2][:, None], want[2][:, None], 1e-5),
            nu=same_or_both_nan(runs[0][3], want[3], 1e-5, one))
        scratch = state(ba_kernels.chi2)
        rec = dict(kernel="ba_chi2", shape=shape,
                   max_abs_err=float(torch.nan_to_num(
                       runs[0][2] - want[2]).abs().max()),
                   max_rel_err=max(errs.values()),
                   bound=bound("ba_chi2", (est_new, *problem[:6]),
                               [t for t in runs[0]], OPS_ACCEPT,
                               [du, g, lam0, *st]),
                   ms=device_ms(lambda: ba_kernels.lm_accept_step(
                       *scratch, est_new, du, g, lam0, *problem), 20),
                   plain_ms=cuda_ms(lambda: lm_soa.lm_accept_step_plain(
                       *st, est_new, du, g, lam0, *problem), 5, 1))
        recs[f"lm_accept_step at {shape}"] = rec
        print(f"[steps] lm_accept_step at {shape}: accept flags equal "
              f"({int(acc.sum())} accepted, {int((~acc).sum())} rejected of "
              f"{O}), rel err {errs} (limit 1e-5), repeat bit-equal; kernel "
              f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
              f"{bound_text(rec['ms'], rec['bound'])}")
    return recs


def phase_whole_lm(dev):
    """One optimize_objects_soa call: kernels on the card vs plain on CPU."""
    from object_oriented_slam_tpu_torch.backend import (
        observations_from_numpy, optimize_objects_soa)
    arrays, obs, (_, _, _, _, _, n, K) = lm_inputs(FULL, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est_d, _ = optimize_objects_soa(obs, K, n, True)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    est_c, _ = optimize_objects_soa(observations_from_numpy(arrays, "cpu"),
                                    K.cpu(), n.cpu(), True)
    t_cpu = time.perf_counter() - t0
    err = float((est_d.cpu() - est_c).abs().max())
    print(f"[lm] optimize_objects_soa at {FULL}: card (kernels) vs CPU "
          f"(plain) max |d est| {err:.3g} (limit 2e-3); card {t_dev*1e3:.1f} "
          f"ms, CPU {t_cpu*1e3:.1f} ms (host clock, one call)")
    if not err <= 2e-3:
        raise RuntimeError(f"whole LM disagrees: {err:.3g}")


def write_settings(tmp, name="synthetic_2d.yaml"):
    """The in-repo settings file ``name`` plus Tracking.KeyFrameCheck.Close:
    1 (every observation is stored, so the 2D rings fill to 512 and the 3D
    rings past their 32-slot minimum tier)."""
    import object_oriented_slam_tpu_torch as pkg
    src = os.path.join(os.path.dirname(pkg.__file__), "configs", name)
    path = os.path.join(tmp, "settings_" + name)
    with open(src) as f, open(path, "w") as g:
        g.write(f.read() + "\nTracking.KeyFrameCheck.Close: 1\n")
    return path


def pin_eager(slam):
    """The eager loop (pipeline_depth 1, no adaptation, so no asynchronous
    plane): the paths before [cli] keep measuring the loop they measured
    before the deferred pipeline was ported."""
    slam.tracker.pipeline_depth = 1
    slam.tracker.adaptive_depth = False


def wall_ms(fn, reps):
    """Mean host-clock time of fn() per call, synchronized, after warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def device_busy(fn):
    """(device ms, device operations, top kernels) of one fn() call from
    the profiler's CUDA events (kernels, copies and memsets), or None where
    the profiler sees none."""
    kern = profiled(fn)
    if not kern:
        return None
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:4]
    return busy, sum(e.count for e in kern), [
        (e.key[:60], e.count, round(e.self_device_time_total / 1e3, 3))
        for e in top]


def lm_overhead(tracker):
    """One LM call at the tracker's current tier under the profiler: wall
    time, device busy time, launches, and how many of them are not the
    two BA kernels (the eager remainder: soa_prepare, soa_edge_weights, the
    final where).  Then one LM iteration alone, which must be exactly two
    device operations.  Returns the numbers as a dict."""
    from object_oriented_slam_tpu_torch.backend import (
        lm_soa, optimize_objects_soa)
    prep = tracker._prepare_backend()
    obs = tracker._unpack(prep)
    K = tracker._K_dev
    n = torch.zeros(3, device=K.device)
    cfg = tracker.lm_cfg
    tier = tuple(obs.pose2d_cw.shape[:2]) + (obs.pose3d_wc.shape[1],)

    def call():
        return optimize_objects_soa(obs, K, n, prep["gset"], cfg)

    wall = wall_ms(call, 5)
    prof = device_busy(call)
    if prof is None:
        raise RuntimeError("the profiler shows no device time: the launch "
                           "count of an LM call cannot be checked")
    busy, launches, top = prof
    in_kernels = 1 + 2 * cfg.iters
    print(f"[main] one LM call at tier {tier}: {wall:.3f} ms wall (host "
          f"clock, mean of 5); device busy {busy:.3f} ms over {launches} "
          f"device operations, {in_kernels} of them BA kernel launches (1 + 2 "
          f"x {cfg.iters} iterations) and {launches - in_kernels} eager "
          f"(prepare, edge weights, final select); launch-overhead share "
          f"{1 - busy / wall:.3f}; top kernels (name, launches, ms) {top}")

    sp = lm_soa.soa_prepare(obs.pose2d_cw, obs.bbox2d, obs.pose3d_wc,
                            obs.meas3d)
    w2, w3, wg = lm_soa.soa_edge_weights(obs, sp, K, prep["gset"], cfg)
    problem = (sp, w2, w3, wg, n, K, cfg.huber_delta)
    O = obs.est0.shape[0]
    est = obs.est0.clone()
    lam = torch.full((O,), -1.0, device=K.device)
    nu = torch.full((O,), 2.0, device=K.device)
    chi2 = lm_soa.soa_chi2(est, *problem)

    def iteration():
        est_new, du, g, lam0, _ = lm_soa.lm_solve_step(est, lam, *problem)
        lm_soa.lm_accept_step(est, chi2, lam, nu, est_new, du, g, lam0,
                              *problem)

    iteration()
    reps = 10       # a trace of two events alone may come back empty
    events = profiled(iteration, reps, expect=2 * reps)
    it_ops = sum(e.count for e in events)
    names = sorted((e.key[:48], e.count) for e in events)
    print(f"[main] {reps} LM iterations: {it_ops} device operations, "
          f"{sum(e.self_device_time_total for e in events) / 1e3 / reps:.4f} "
          f"ms busy per iteration: {names}")
    if it_ops != 2 * reps:
        raise RuntimeError(
            f"{reps} LM iterations are {it_ops} device operations, not two "
            "kernel launches each")
    return dict(wall_ms=wall, busy_ms=busy, launches=launches,
                eager=launches - in_kernels)


def phase_main_path(dev, tmp):
    from object_oriented_slam_tpu_torch.backend import ba_kernels
    from object_oriented_slam_tpu_torch.io.synthetic import (
        SyntheticDataset, make_scene)
    from object_oriented_slam_tpu_torch.system import System

    scene = make_scene(n_objects=24, seed=SEED, radius_range=(1.3, 2.2),
                       scale_range=(0.2, 0.4))
    ds = SyntheticDataset(scene, n_frames=600, orbit_radius=3.6, height=1.7,
                          with_depth=False)
    frames = list(ds.frames())           # set-up: detections made up front
    slam = System(write_settings(tmp), device=dev)
    pin_eager(slam)

    for k in ba_kernels.KERNELS:
        k.launches = 0
    e2e = []
    for i, ts, pose, depth, rgb, det in frames:
        t0 = time.perf_counter()
        slam.track_with_objects(ts, pose, det, depth=depth)
        torch.cuda.synchronize()
        e2e.append(time.perf_counter() - t0)
    slam.tracker.sync()
    launches = {k.name: k.launches for k in ba_kernels.KERNELS}

    tr = slam.tracker
    objs = slam.map_objects
    errs = np.array([np.linalg.norm(v[:3] - scene.ellipsoids[i][:3])
                     for i, v in objs.items()])
    e2e_ms = np.array(e2e) * 1e3
    backend_ms = np.array(tr.metrics["backend"]) * 1e3
    m2 = int(min(tr._b_n2.max(), tr.MAX_OBS2D))
    print(f"[main] {len(frames)} frames, {len(objs)}/24 objects initialized, "
          f"2D ring fill {m2}/{tr.MAX_OBS2D}, object tier {tr.max_objects}")
    print(f"[main] e2e ms/frame p50 {np.median(e2e_ms):.3f} mean "
          f"{e2e_ms.mean():.3f} p99 {np.percentile(e2e_ms, 99):.3f} (host "
          f"clock, synchronized per frame); backend ms/frame mean "
          f"{backend_ms.mean():.3f} over all frames, "
          f"{backend_ms.sum() / max(tr._backend_calls, 1):.3f} over the "
          f"{tr._backend_calls} frames with an LM call (host clock around the "
          f"LM call's launches)")
    print(f"[main] kernel launches in the main path: {launches}")
    print(f"[main] centre error vs ground truth: median {np.median(errs):.3g} "
          f"m, max {errs.max():.3g} m; map IoU median %.4f, min %.4f"
          % map_iou(objs, scene))
    out = os.path.join(tmp, "objects.txt")
    slam.save_objects_to_file(out)
    rows = np.loadtxt(out, ndmin=2)
    print(f"[main] wrote {out}: {rows.shape[0]} rows")

    if min(launches.values()) <= 0:
        raise RuntimeError(f"a kernel of the path never launched: {launches}")
    if len(objs) < 16:
        raise RuntimeError(f"only {len(objs)} of 24 objects initialized")
    if not np.median(errs) < 0.05:
        raise RuntimeError(f"median centre error {np.median(errs):.3g} m")
    if rows.shape != (len(objs), 11) or not np.isfinite(rows).all():
        raise RuntimeError("objects.txt is malformed")
    if m2 < tr.MAX_OBS2D:
        raise RuntimeError(f"the 2D rings reached {m2}, not the full tier")
    lm_overhead(tr)
    return launches


def scene24():
    from object_oriented_slam_tpu_torch.io.synthetic import make_scene
    return make_scene(n_objects=24, seed=SEED, radius_range=(1.3, 2.2),
                      scale_range=(0.2, 0.4))


def map_iou(objs, scene):
    """(median, min) 3D IoU of the map's objects against the ground truth
    (system/metrics.object_map_iou)."""
    from object_oriented_slam_tpu_torch.system.metrics import object_map_iou
    iou = np.array(list(object_map_iou(
        objs, {i: scene.ellipsoids[i] for i in objs}).values()))
    if not np.isfinite(iou).all():
        raise RuntimeError("the map's IoU against the ground truth is not "
                           "finite")
    return float(np.median(iou)), float(iou.min())


def bytes_bound(tensors):
    """(bound_ms, "bytes"): every tensor moved once at the card's peak."""
    n = sum(t.numel() * t.element_size() for t in tensors if t is not None)
    return n / PEAK_BYTES * 1e3, "bytes"


def all_bits(a, b):
    return all((x is None and y is None) or same_bits(x.cpu(), y.cpu())
               for x, y in zip(a, b))


def busy_ms(fn, reps=5):
    """Device time of one fn() call that may launch several kernels (and
    copies or memsets): the profiler's CUDA events over reps calls."""
    fn()
    events = profiled(fn, reps)
    if not events:
        raise RuntimeError("the profiler shows no device time")
    return sum(e.self_device_time_total for e in events) / 1e3 / reps


def box_pixels(bboxes, H, W):
    """[D] the strided pixels under each box, clipped as depth_cloud (and
    bbox_point_cloud_plain) clip them."""
    from object_oriented_slam_tpu_torch.ops import backproject as bp
    b = bboxes.to(torch.int32)
    x1, y1 = b[:, 0].clamp(0, W - 1), b[:, 1].clamp(0, H - 1)
    x2, y2 = b[:, 2].clamp(0, W), b[:, 3].clamp(0, H)
    S = bp.STRIDE
    bw = torch.where(x2 > x1, (x2 - x1 + S - 1) // S, 0)
    bh = torch.where(y2 > y1, (y2 - y1 + S - 1) // S, 0)
    return (bw * bh).long()


def library_yardstick(key, pts, capacity):
    """The PyTorch yardstick of a downsample: a stable torch.sort of the
    keys [D, G], a gather of the points [D, G, 3] into that order and
    torch.segment_reduce's mean over the runs (the first ``capacity``, then
    one for everything else; the run lengths are taken beforehand).
    Returns (device ms of sort + gather + segment_reduce, device ms of the
    sort alone, max |mean - the plain version's| over the live slots, or
    None where segment_reduce refuses, with the reason)."""
    from object_oriented_slam_tpu_torch.ops import voxel as vx
    D, G = key.shape
    dev = key.device
    ks, order = torch.sort(key, dim=1, stable=True)
    valid = ks != vx._INVALID
    new = torch.cat([torch.ones((D, 1), dtype=torch.bool, device=dev),
                     ks[:, 1:] != ks[:, :-1]], dim=1) & valid
    seg = torch.cumsum(new, dim=1) - 1
    seg = torch.where(valid & (seg < capacity), seg, capacity)
    lengths = torch.zeros((D, capacity + 1), dtype=torch.int64,
                          device=dev).scatter_add_(1, seg,
                                                   torch.ones_like(seg))

    def call():
        _, o = torch.sort(key, dim=1, stable=True)
        p = torch.gather(pts, 1, o[..., None].expand(-1, -1, 3))
        return torch.segment_reduce(p, "mean", lengths=lengths, axis=1)

    sort_ms = busy_ms(lambda: torch.sort(key, dim=1, stable=True))
    try:
        means = call()
    except RuntimeError as e:
        return None, sort_ms, f"segment_reduce refused: {e}"
    cmin = torch.zeros((D, 3), dtype=torch.int32, device=dev)
    want = vx.voxel_segment_mean_plain(ks, order, pts, cmin, capacity)
    live = want[2]
    err = float((means[:, :capacity][live] - want[0][live]).abs().max()) \
        if bool(live.any()) else 0.0
    return busy_ms(call), sort_ms, err


def near_threshold(attr, mask):
    """The live cells whose border mean lies within 1e-6 of the 0.3 that
    makes a cell a border cell (frontend/extractor._stage_post), where two
    sums in other orders may fall on either side."""
    return int(((attr - 0.3).abs() < 1e-6)[mask].sum())


def depth_cloud_checks(tag, depth, bboxes, pose_wc, plane, cam, cfg,
                       border=False, frame=None):
    """depth_cloud (stages (a)-(c), one launch) against depth_cloud_plain:
    bit for bit against it on the CPU, masks, cells and flags equal to it
    on the card and floats within 1e-6 (its index_add_ adds with atomics);
    a second launch bit-equal.  With ``border`` the same launch with sparse
    symmetry's lane (depth_cloud_border against depth_cloud_border_plain):
    the voxels' border means held as the floats, the other outputs
    bit-equal to the launch without the lane.  With ``frame`` (the offline
    batch mapper's frame lane: depth [B, H, W], pose_wc [B, 7], each
    detection's frame index) the same checks on the lane's launch.
    Returns its record (with ``border``, and the border means)."""
    from object_oriented_slam_tpu_torch.ops import backproject as bp
    from object_oriented_slam_tpu_torch.ops import depth_cloud as dc
    from object_oriented_slam_tpu_torch.ops import voxel as vx
    rest = (cfg.voxel_leaf, cfg.depth_range, cfg.plane_clearance,
            cfg.cloud_capacity)
    args = (depth, bboxes, pose_wc, plane, cam)
    cpu_args = (depth.cpu(), bboxes.cpu(), pose_wc.cpu(), plane.cpu(), cam)
    fr = {"frame": frame}
    cpu_fr = {"frame": None if frame is None else frame.cpu()}
    if border:
        def kernel():
            return tuple(dc.depth_cloud_border(*args, *rest, **fr))

        def plain(*a, **kw):
            return tuple(dc.depth_cloud_border_plain(*a, *rest, **kw))
        fields = (*dc.DepthCloud._fields, "battr_v")
    else:
        def kernel():
            return dc.depth_cloud(*args, *rest, **fr)

        def plain(*a, **kw):
            return dc.depth_cloud_plain(*a, *rest, **kw)
        fields = dc.DepthCloud._fields

    def flat(out):         # (DepthCloud, battr_v) -> one tuple of tensors
        return (*out[0], out[1]) if border else tuple(out)
    got = flat(kernel())
    again = flat(kernel())
    card = flat(plain(*args, **fr))
    cpu = flat(plain(*cpu_args, **cpu_fr))
    n_cloud = len(dc.DepthCloud._fields)
    bare = dc.depth_cloud(*args, *rest, **fr) if border else got
    torch.cuda.synchronize()
    if not all_bits(got, again):
        raise RuntimeError(f"depth_cloud ({tag}): two launches differ")
    if not all_bits(got[:n_cloud], bare):
        raise RuntimeError(f"depth_cloud ({tag}): the launch with the border "
                           "lane differs from the launch without it")
    differ = [f for f, g, w in zip(fields, got, cpu)
              if not same_bits(g.cpu(), w)]
    if differ:
        raise RuntimeError(f"depth_cloud ({tag}) differs from the plain "
                           f"version on the CPU in {differ}")
    err = 0.0
    for f, g, w in zip(fields, got, card):
        if g.dtype in (torch.bool, torch.int32):
            if not torch.equal(g, w):
                raise RuntimeError(f"depth_cloud ({tag}): {f} differs from "
                                   "the plain version on the card")
        else:
            err = max(err, float((g - w).abs().max()))
    if err > 1e-6:
        raise RuntimeError(f"depth_cloud ({tag}) disagrees: {err:.3g}")
    outs, got = got, dc.DepthCloud(*got[:n_cloud])
    # the work: the depth pixels under the boxes, 100 centre samples a box,
    # the boxes, pose and plane read once, the outputs written once; the
    # operations of the live points and the output slots
    H, W = depth.shape[-2:]
    D, cap = got.m2.shape
    n_pix = box_pixels(bboxes, H, W)
    pts_cam, m0 = bp.bbox_point_cloud_plain(depth, bboxes, cam,
                                            cfg.depth_range, frame)
    live = int(m0.sum())
    # with the border lane: each live point's 4 neighbours read (off the
    # strided grid), the border means written; the border test and the
    # attribute's share of the mean
    n_bytes = (int(n_pix.sum()) + 4 * live * border + 100 * D) * 4 + sum(
        t.numel() * t.element_size()
        for t in (bboxes, pose_wc, plane, frame, *outs) if t is not None)
    n_ops = (live * (DS_OPS_POINT + border * (DS_OPS_BORDER + DS_OPS_ATTR))
             + D * cap * (DS_OPS_SLOT + DS_OPS_WORLD + border * DS_OPS_ATTR))
    t_b, t_o = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_F32 * 1e3
    key, _ = vx.voxel_keys(pts_cam, m0, cfg.voxel_leaf)
    lib_ms, sort_ms, lib_err = library_yardstick(key, pts_cam.contiguous(),
                                                 cap)
    r = dict(kernel="depth_cloud", shape=(D, m0.shape[1], cap),
             max_abs_err=err, bound=max((t_b, "bytes"), (t_o, "operations")),
             ms=device_ms(kernel, 20, name="depth_cloud"),
             plain_ms=cuda_ms(lambda: plain(*args, **fr), 5),
             library_ms=lib_ms, sort_ms=sort_ms,
             live_points=live, box_pixels=int(n_pix.sum()))
    lane = ""
    if border:
        battr, m_live = outs[-1], got.pts_v[..., 2] > 0
        r["near_threshold"] = (near_threshold(battr, m_live),
                               near_threshold(card[-1], m_live),
                               near_threshold(cpu[-1].to(battr.device),
                                              m_live))
        lane = (f" With the border lane: {int((battr > 0).sum())} voxels with "
                f"a border point, their means within {err:.3g} of the plain "
                f"version on the card and bit-equal on the CPU, the other "
                f"outputs bit-equal to the launch without the lane; voxels "
                f"within 1e-6 of 0.3 (card, plain on the card, on the CPU): "
                f"{r['near_threshold']}.")
    print(f"[frontend] {tag}: depth_cloud at D={D}, {int(n_pix.sum())} box "
          f"pixels ({int(n_pix.max())} in the largest box), {live} live "
          f"points, capacity {cap}: {int(got.m2.sum())} voxels above the "
          f"plane, ok_points {int(got.ok_points.sum())}, ok_center "
          f"{int(got.ok_center.sum())}; every output bit-equal to the plain "
          f"version on the CPU, masks, cells and flags equal to it on the "
          f"card, max_abs_err there {err:.3g} (limit 1e-6); repeat "
          f"bit-equal; yardstick (sort + gather + segment_reduce) "
          f"{lib_ms} ms, max |mean - plain| {lib_err}; the stable sort "
          f"alone {sort_ms:.4f} ms.{lane}")
    return (r, outs[-1]) if border else r


def voxel_downsample_checks(tag, pts, sel, leaf, capacity):
    """voxel_downsample (keys, sort and means in one launch) against
    voxel_downsample_plain: bit for bit against it on the CPU, masks and
    cells equal to it on the card and floats within 5e-6 (a 0.1 m cell
    holds up to hundreds of points at |coordinate| up to ~4 m: the card's
    atomic sums move a centroid by a few ulp of 4); a second launch
    bit-equal.  Returns (its record, its outputs)."""
    from object_oriented_slam_tpu_torch.ops import voxel as vx
    pts = pts.contiguous()
    got = vx.voxel_downsample_cells(pts, sel, leaf, capacity)
    again = vx.voxel_downsample_cells(pts, sel, leaf, capacity)
    bare = vx.voxel_downsample(pts, sel, leaf, capacity)
    card = vx.voxel_downsample_plain(pts, sel, leaf, capacity)
    cpu = vx.voxel_downsample_plain(pts.cpu(), sel.cpu(), leaf, capacity)
    torch.cuda.synchronize()
    if not (all_bits(got, again) and all_bits(got, cpu)):
        raise RuntimeError(f"voxel_downsample ({tag}): repeats differ or it "
                           "differs from the plain version on the CPU")
    if not (same_bits(bare[0], got[0]) and torch.equal(bare[1], got[2])):
        raise RuntimeError(f"voxel_downsample ({tag}) without cells differs")
    if not (torch.equal(got[1], card[1]) and torch.equal(got[2], card[2])):
        raise RuntimeError(f"voxel_downsample ({tag}): cells or mask differ")
    err = float((got[0] - card[0]).abs().max())
    if err > 5e-6:
        raise RuntimeError(f"voxel_downsample ({tag}) disagrees: {err:.3g}")
    D, N = sel.shape
    live = int(sel.sum())
    n_bytes = sel.numel() + live * 12 + sum(
        t.numel() * t.element_size() for t in bare)
    n_ops = live * DS_OPS_POINT + D * capacity * DS_OPS_SLOT
    t_b, t_o = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_F32 * 1e3
    key, _ = vx.voxel_keys(pts, sel, leaf)
    lib_ms, sort_ms, lib_err = library_yardstick(key, pts, capacity)
    r = dict(kernel="voxel_downsample", shape=(D, N, capacity),
             max_abs_err=err, bound=max((t_b, "bytes"), (t_o, "operations")),
             ms=device_ms(lambda: vx.voxel_downsample(pts, sel, leaf,
                                                      capacity), 20,
                          name="voxel_downsample"),
             plain_ms=cuda_ms(lambda: vx.voxel_downsample_plain(
                 pts, sel, leaf, capacity), 5),
             library_ms=lib_ms, sort_ms=sort_ms, live_points=live)
    print(f"[frontend] {tag}: voxel_downsample at D={D}, {N} lanes, {live} "
          f"live points, capacity {capacity}: {int(got[2].sum())} voxels "
          f"(most in a detection {int(got[2].sum(1).max())}); bit-equal to "
          f"the plain version on the CPU, cells and masks equal to it on the "
          f"card, max_abs_err there {err:.3g} (limit 5e-6); repeat bit-equal; "
          f"yardstick {lib_ms} ms, max |mean - plain| {lib_err}; the stable "
          f"sort alone {sort_ms:.4f} ms")
    return r, got


def voxel_attrs_checks(tag, pts, sel, attrs, leaf, capacity):
    """voxel_downsample with sparse symmetry's attribute (the voxels' border
    means) against voxel_downsample_full_plain: bit for bit against it on
    the CPU, masks and cells equal to it on the card, points and attribute
    means within 5e-6 there; the points, cells and mask bit-equal to the
    launch without the attribute; the main path's variant (no cells)
    bit-equal.  Returns (its record, the attribute variant's outputs)."""
    from object_oriented_slam_tpu_torch.ops import voxel as vx
    pts, attrs = pts.contiguous(), attrs.contiguous()
    got = vx.voxel_downsample_full(pts, attrs, sel, leaf, capacity)
    again = vx.voxel_downsample_full(pts, attrs, sel, leaf, capacity)
    path = vx.voxel_downsample_attrs(pts, attrs, sel, leaf, capacity)
    bare = vx.voxel_downsample_cells(pts, sel, leaf, capacity)
    card = vx.voxel_downsample_full_plain(pts, attrs, sel, leaf, capacity)
    cpu = vx.voxel_downsample_full_plain(pts.cpu(), attrs.cpu(), sel.cpu(),
                                         leaf, capacity)
    torch.cuda.synchronize()
    if not (all_bits(got, again) and all_bits(got, cpu)):
        raise RuntimeError(f"voxel_downsample with attributes ({tag}): "
                           "repeats differ or it differs from the plain "
                           "version on the CPU")
    if not (all_bits((got[0], got[2], got[3]), bare)
            and all_bits(path, (got[0], got[1], got[3]))):
        raise RuntimeError(f"voxel_downsample with attributes ({tag}) "
                           "differs from the launch without them or without "
                           "cells")
    if not (torch.equal(got[2], card[2]) and torch.equal(got[3], card[3])):
        raise RuntimeError(f"voxel_downsample with attributes ({tag}): "
                           "cells or mask differ")
    err = max(float((got[0] - card[0]).abs().max()),
              float((got[1] - card[1]).abs().max()))
    if err > 5e-6:
        raise RuntimeError(f"voxel_downsample with attributes ({tag}) "
                           f"disagrees: {err:.3g}")
    D, N = sel.shape
    live = int(sel.sum())
    n_bytes = sel.numel() + live * 16 + sum(
        t.numel() * t.element_size() for t in path)
    n_ops = (live * (DS_OPS_POINT + DS_OPS_ATTR)
             + D * capacity * (DS_OPS_SLOT + DS_OPS_ATTR))
    t_b, t_o = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_F32 * 1e3
    key, _ = vx.voxel_keys(pts, sel, leaf)
    lib_ms, sort_ms, lib_err = library_yardstick(key, pts, capacity)
    near = (near_threshold(got[1], got[3]), near_threshold(card[1], got[3]),
            near_threshold(cpu[1].to(got[1].device), got[3]))
    r = dict(kernel="voxel_downsample", shape=(D, N, capacity),
             max_abs_err=err, bound=max((t_b, "bytes"), (t_o, "operations")),
             ms=device_ms(lambda: vx.voxel_downsample_attrs(
                 pts, attrs, sel, leaf, capacity), 20,
                 name="voxel_downsample"),
             plain_ms=cuda_ms(lambda: vx.voxel_downsample_full_plain(
                 pts, attrs, sel, leaf, capacity), 5),
             library_ms=lib_ms, sort_ms=sort_ms, live_points=live,
             near_threshold=near)
    border = got[3] & (got[1] > 0.3)
    print(f"[frontend] {tag}: voxel_downsample with the border attribute at "
          f"D={D}, {N} lanes, {live} live points, capacity {capacity}: "
          f"{int(got[3].sum())} cells, {int(border.sum())} of them border "
          f"cells (mean above 0.3); bit-equal to the plain version on the "
          f"CPU, cells and masks equal to it on the card, max_abs_err there "
          f"{err:.3g} (limit 5e-6); points, cells and mask bit-equal to the "
          f"launch without the attribute; cells within 1e-6 of 0.3 (card, "
          f"plain on the card, on the CPU): {near}; yardstick {lib_ms} ms, "
          f"max |mean - plain| {lib_err}")
    return r, path


def frontend_checks(dev, tag, depth, bboxes, pose_wc, plane, cam, cfg,
                    whole_image=False):
    """The depth-frontend kernels against their plain versions on the
    tensors ``extract_local_ellipsoids`` hands them for one frame: depth
    [H, W] int32, bboxes [D, 4] (padded lanes zero), pose_wc [7], plane [4],
    all on the card; ``cfg.cloud_capacity`` is the frame's cloud tier.  The
    stages follow frontend/extractor.py: depth_cloud on the frame's boxes
    (with ``whole_image``, the last box replaced by the whole image), the
    clustering (``cluster_checks``: the whole propagation in one launch) on
    depth_cloud's world clouds of the frame's boxes, and voxel_downsample on
    the selected clusters.  Returns the records and (tier, the largest
    survivor count)."""
    from object_oriented_slam_tpu_torch.ops import depth_cloud as dc
    recs = {}
    tier = cfg.cloud_capacity

    # --- depth_cloud: back-projection, the first downsample with its keys
    # and sort, the world transform, the plane mask and the centre estimate
    # in one launch (the main path's)
    dc_boxes = bboxes
    if whole_image:
        H, W = depth.shape
        dc_boxes = torch.cat([bboxes[:-1], torch.tensor(
            [[0.0, 0.0, float(W), float(H)]], device=dev)])
    recs[f"depth_cloud ({tag})"] = depth_cloud_checks(
        tag, depth, dc_boxes, pose_wc, plane, cam, cfg)

    # --- K5: the whole propagation in one launch (cluster_components, the
    # main path's), on the world clouds of the frame's own boxes
    got = dc.depth_cloud(depth, bboxes, pose_wc, plane, cam, cfg.voxel_leaf,
                         cfg.depth_range, cfg.plane_clearance, tier)
    pts_w, m2 = got.pts_w, got.m2
    k5, sel, ok = cluster_checks(
        dev, tag, pts_w, m2, cfg.cluster_tolerance, cfg.cluster_iters,
        cfg.cluster_chains,
        (got.center_w, cfg.cluster_min_size, cfg.cluster_center_dis),
        frame=got.R_wc.T.contiguous())
    recs.update({f"{k} ({tag})": r for k, r in k5.items()})
    survivors = int(m2.sum(1).max())

    # --- voxel_downsample: the 0.1 m object downsample with its keys and
    # sort in one launch (the main path's)
    r, fused = voxel_downsample_checks(tag, pts_w, sel, cfg.sym_grid,
                                       cfg.sym_capacity)
    if not (int(ok.sum()) >= 1 and int(fused[2].sum()) >= int(ok.sum())):
        raise RuntimeError(f"the object downsample ({tag}) is empty: "
                           f"{int(ok.sum())} clusters selected")
    recs[f"voxel_downsample ({tag})"] = r

    for k, r in recs.items():
        r["max_rel_err"] = r["max_abs_err"]
        print(f"[frontend] {k} at {r['shape']}: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, "
              f"{bound_text(r['ms'], r['bound'])}")
    return recs, (tier, survivors)


def tested_pairs(pts_c, nrm, m, frame, tol2, P):
    """Per detection [D], the pair tests one pass of ``cluster_components``
    needs on these inputs once the groups beyond the radius are skipped, in
    plain torch on the kernel's own boxes: the unmasked points in their
    order, a box per 32 of them in ``frame`` (rows u, v, w), a granule of
    32 * P points i against a group of 32 points j unless their boxes lie
    farther apart than the radius plus the kernel's slack (``far_apart`` in
    csrc/frontend.cu); points of a group that is not skipped all count."""
    from object_oriented_slam_tpu_torch.ops import cluster as cl
    _, m_k, (p_k, n_k) = cl._compact(m, pts_c, nrm)
    D, cap = m_k.shape
    pad = -cap % (32 * P)
    m_k = torch.nn.functional.pad(m_k, (0, pad))
    p_k = torch.nn.functional.pad(p_k, (0, 0, 0, pad))
    n_k = torch.nn.functional.pad(n_k, (0, pad))
    x, y, z = p_k.unbind(-1)
    q = torch.stack([x * f[0] + y * f[1] + z * f[2] for f in frame], -1)
    live = m_k[..., None]
    inf = torch.inf

    def boxes(k):
        """(lo, hi, largest squared norm, points) per k consecutive."""
        return (torch.where(live, q, inf).view(D, -1, k, 3).amin(2),
                torch.where(live, q, -inf).view(D, -1, k, 3).amax(2),
                torch.where(m_k, n_k, 0.0).view(D, -1, k).amax(2),
                m_k.view(D, -1, k).sum(2).double())

    ilo, ihi, iw, ni = boxes(32 * P)
    jlo, jhi, jw, nj = boxes(32)
    gap = torch.maximum(jlo[:, None] - ihi[:, :, None],
                        ilo[:, :, None] - jhi[:, None]).clamp_min(0.0)
    gx, gy, gz = gap.unbind(-1)
    far = (gx * gx + gy * gy + gz * gz
           > 1.01 * tol2 + 2e-6 * (iw[:, :, None] + jw[:, None]))
    return torch.where(far, 0.0, ni[:, :, None] * nj[:, None]).sum((1, 2))


def cluster_checks(dev, tag, pts_w, m2, tol, outer_iters, chains, select,
                   must_converge=True, frame=None):
    """K5 on one frame's world clouds pts_w [D, N, 3] and survivor masks m2
    [D, N]: ``cluster_components`` against ``cluster_components_plain`` on
    the card (labels, converged and rounds equal; two launches equal; the
    streamed branch, forced by the least shared memory, equal too), its
    device time beside its bound; ``cluster_select`` (the same launch with
    the selection epilogue; ``select`` = (centre estimates [D, 3], min_size,
    center_dis)) against ``cluster_select_plain``.  ``frame``: the rotation
    the cloud is sorted in, as the extractor passes it (None: the axes of
    the points' coordinates).  Returns (records by name, the chosen
    clusters' masks, their ok flags)."""
    from object_oriented_slam_tpu_torch.ops import cluster as cl
    recs = {}
    D, N = m2.shape
    args = cl.centre_and_seed(pts_w, m2, tol, chains)
    pts_c, nrm, m, labels0, tol2 = args
    runs = [cl.cluster_components(*args, outer_iters, 12, frame=frame)
            for _ in range(2)]

    def tuned(**kw):    # the launch with the sweep's overrides
        return cl._launch(*args, outer_iters, 12, frame, **kw)[:3]

    streamed = tuned(smem=13 * (-(-N // 32) * 32) + 16 * 256)
    every_pair = tuned(prune=False)
    unhinted = cl.cluster_components(*args, outer_iters, 12)
    want = cl.cluster_components_plain(*args, outer_iters, 12)
    torch.cuda.synchronize()
    for name, got in (("", runs[0]), (" (second launch)", runs[1]),
                      (" (streamed)", streamed),
                      (" (every pair tested)", every_pair),
                      (" (no sort frame given)", unhinted)):
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise RuntimeError(
                f"cluster_components{name} ({tag}) differs from its plain "
                f"version: labels {int((got[0] != want[0]).sum())} lanes, "
                f"converged {got[1].tolist()} vs {want[1].tolist()}, rounds "
                f"{got[2].tolist()} vs {want[2].tolist()}")
    labels, conv, rounds = runs[0]
    if must_converge and not bool(conv.all()):
        raise RuntimeError(f"cluster_components ({tag}): not converged")
    # the work these inputs need: the pair tests that the skip of far
    # groups leaves (``tested_pairs``, in the frame the launch was given),
    # once per round the detection ran; the jumps read and write a label
    # per point; inputs and outputs once.  Beside it, as all_pairs_bound_ms,
    # the figure with every unmasked point of a detection against every
    # other (what a pass without the skip needs)
    n_d = m.sum(1).double()
    r_d = rounds.double()
    eye = torch.eye(3, device=dev)
    pairs = float((tested_pairs(pts_c, nrm, m, eye if frame is None
                                else frame, tol2, cl.LAUNCH_SHAPE[2])
                   * r_d).sum())
    all_pairs = float((n_d * n_d * r_d).sum())
    jump_bytes = float((n_d * r_d).sum()) * 12 * 8
    io = bytes_bound([pts_c, nrm, m, labels0, labels, conv, rounds])[0]
    ops_ms = pairs * PAIR_OPS / PEAK_F32 * 1e3
    bytes_ms = io + jump_bytes / PEAK_BYTES * 1e3
    b_cc = max((ops_ms, "operations"), (bytes_ms, "bytes"))
    all_pairs_ms = max(all_pairs * PAIR_OPS / PEAK_F32 * 1e3, bytes_ms)
    r_max = int(rounds.max())
    cc_ms, cc_events = checked_device_ms(lambda: cl.cluster_components(
        *args, outer_iters, 12, frame=frame), 10, "cluster_components")
    recs["cluster_components (K5)"] = dict(
        kernel="cluster_components", shape=(D, N), max_abs_err=0.0,
        bound=b_cc, ms=cc_ms, events_ms=cc_events,
        all_pairs_bound_ms=all_pairs_ms, tested_pairs=pairs,
        all_pairs=all_pairs,
        plain_ms=cuda_ms(lambda: cl.cluster_components_plain(
            *args, outer_iters, 12), 1, 0),
        every_pair_ms=device_ms(lambda: tuned(prune=False), 5,
                                name="cluster_components"),
        world_axes_ms=device_ms(lambda: cl.cluster_components(
            *args, outer_iters, 12), 5, name="cluster_components"))
    n_comp = [int((labels[d][m[d]]).unique().numel()) for d in range(D)]
    print(f"[frontend] {tag}: cluster_components at D={D}, N={N} lanes "
          f"({int(n_d.max())} survivors at most, {int((n_d > 0).sum())} live "
          f"detections): labels, converged and rounds equal to the plain "
          f"version's on the card, also streamed through the least shared "
          f"memory and with every pair tested; second launch bit-equal; "
          f"rounds per detection {rounds.tolist()}; components per detection "
          f"{n_comp}")

    # --- the same launch with the selection epilogue (the main path's)
    centre_w, min_size, center_dis = select
    s_args = (pts_w.contiguous(), *args[:4], centre_w, tol2, outer_iters, 12,
              min_size, center_dis)
    s_runs = [cl.cluster_select(*s_args, frame=frame) for _ in range(2)]
    s_want = cl.cluster_select_plain(*s_args)
    torch.cuda.synchronize()
    for got in s_runs:
        if not all(torch.equal(g, w) for g, w in zip(got, s_want)):
            raise RuntimeError(
                f"cluster_select ({tag}) differs from its plain version: "
                f"{int((got[0] != s_want[0]).sum())} mask lanes, ok "
                f"{got[1].tolist()} vs {s_want[1].tolist()}")
    sel, ok = s_runs[0][:2]
    s_bytes = bytes_ms + bytes_bound([pts_w, centre_w, sel, ok])[0]
    s_ms, s_events = checked_device_ms(lambda: cl.cluster_select(
        *s_args, frame=frame), 10, "cluster_components")
    # the epilogue is n atomics and three block reductions by one block: the
    # two readings of one kernel, taken in alternation (without, with, ...,
    # five of each), must have medians within a tenth of each other
    turns = [[device_ms(fn, 10, name="cluster_components") for fn in (
        lambda: cl.cluster_components(*args, outer_iters, 12, frame=frame),
        lambda: cl.cluster_select(*s_args, frame=frame))] for _ in range(5)]
    cc_med, s_med = (float(np.median(t)) for t in zip(*turns))
    if abs(s_med - cc_med) > 0.1 * s_med:
        raise RuntimeError(
            f"cluster_components ({tag}) reads a median {cc_med:.4f} ms "
            f"without and {s_med:.4f} ms with the selection epilogue "
            f"(turns {turns})")
    recs["cluster_select (K5)"] = dict(
        kernel="cluster_components", shape=(D, N), max_abs_err=0.0,
        bound=max((ops_ms, "operations"), (s_bytes, "bytes")),
        ms=s_ms, events_ms=s_events,
        all_pairs_bound_ms=max(all_pairs * PAIR_OPS / PEAK_F32 * 1e3,
                               s_bytes),
        tested_pairs=pairs, all_pairs=all_pairs,
        plain_ms=cuda_ms(lambda: cl.cluster_select_plain(*s_args), 1, 0))
    print(f"[frontend] {tag}: cluster_select: the chosen clusters' masks and "
          f"the ok flags ({int(ok.sum())} of {D} ok, {int(sel.sum())} points "
          f"chosen) equal select_cluster's on the plain labels; second "
          f"launch bit-equal; {recs['cluster_select (K5)']['ms']:.4f} ms "
          f"against {cc_ms:.4f} ms without the epilogue; in alternation "
          f"medians {s_med:.4f} / {cc_med:.4f} ms")

    r = recs["cluster_components (K5)"]
    print(f"[frontend] {tag}: cluster_components {cc_ms:.4f} ms by the "
          f"profiler, {cc_events:.4f} ms by CUDA events around the same "
          f"launches; {pairs:.4g} pair tests after the skip of far groups "
          f"of {all_pairs:.4g} in all (bound with every pair "
          f"{all_pairs_ms * 1e3:.2f} us, share {all_pairs_ms / cc_ms:.4f}) "
          f"({r['every_pair_ms']:.4f} ms with every pair tested, "
          f"{r['world_axes_ms']:.4f} ms with the boxes along the world's "
          f"axes: no sort frame given) for "
          f"{r_max} rounds at most, {bound_text(cc_ms, b_cc)}; plain "
          f"version {r['plain_ms']:.3f} ms")
    return recs, sel, ok


def dense_cloud(D, N, seed, dev, shuffled=(3,)):
    """Seeded clouds that fill the lanes, for the kernel's streamed branch:
    detection d holds N points (d = 0, 1), 3N/4, 5N/8, ... uniformly in a slab
    (1 x 1 x 0.25 m at N = 16384), about two neighbours a point within 2 cm
    where every lane is live: many components, some long and winding.  The
    detections are sorted along a slanted direction (like a voxel cloud, by
    the cells of a camera frame turned against the world's), those in
    ``shuffled`` are left in random order (no group of 32 is far from any
    other: every pair is tested); detection D - 1 is empty and D - 2 is one
    tight blob.  Returns (points, masks, the sort frame [3, 3])."""
    rng = np.random.default_rng(seed)
    side = (N / 16384.0) ** (1.0 / 3.0)     # the same density at any N
    pts = rng.uniform(0.0, side, (D, N, 3)).astype(np.float32)
    pts[..., 2] *= 0.25
    mask = np.zeros((D, N), bool)
    for d in range(D):
        n_d = N if d < 2 else max(N * (D - d) // D, 64)
        mask[d, rng.permutation(N)[:n_d]] = True
        if d not in shuffled:
            along = pts[d] @ np.array([0.6, 0.8, 0.0], np.float32)
            pts[d] = pts[d][np.argsort(along, kind="stable")]
    mask[D - 1] = False
    pts[D - 2] = 0.5 + 0.005 * pts[D - 2]
    frame = torch.tensor([[0.6, 0.8, 0.0], [-0.8, 0.6, 0.0], [0.0, 0.0, 1.0]])
    return (torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev),
            frame.to(dev))


def cluster_extremes(dev):
    """cluster_components where the depth scene does not take it: clouds
    that fill all 16384 lanes (the points no longer fit in shared memory
    and are streamed), and a bound of 2 rounds on them, which truncates the
    winding detections and only those."""
    from object_oriented_slam_tpu_torch.ops import cluster as cl
    pts, mask, frame = dense_cloud(FE_DETECTIONS, FE_TIER, SEED, dev)
    centre = pts[:, :1].mean(1).contiguous()    # a point of each cloud
    recs, _, _ = cluster_checks(dev, "dense", pts, mask, 0.02, 96, 0,
                                (centre, 100, 0.5), must_converge=False,
                                frame=frame)
    args = cl.centre_and_seed(pts, mask, 0.02, 0)
    got = cl.cluster_components(*args, 2, 12, frame=frame)
    want = cl.cluster_components_plain(*args, 2, 12)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise RuntimeError("cluster_components truncated at 2 rounds differs "
                           "from its plain version")
    conv = got[1].tolist()
    if conv[0] or not conv[-1] or not conv[-2]:
        raise RuntimeError(f"truncation flags {conv}: the full detection "
                           "should be cut short, the blob and the empty one "
                           "not")
    print(f"[frontend] dense: bound of 2 rounds: converged {conv}, rounds "
          f"{got[2].tolist()}, equal to the plain version's")
    return recs


def phase_frontend_kernels(dev, path):
    """The depth-frontend kernels vs their plain versions: at the shapes the
    depth main path gave them on its mid-orbit frame (``path``: that frame,
    the latched plane and the extractor's stats of it), and at the full
    tier (8 large detections, capacity 16384), which this scene's frames
    never reach.  Returns (path records, full-tier records)."""
    from object_oriented_slam_tpu_torch.frontend import ExtractorConfig
    from object_oriented_slam_tpu_torch.frontend.extractor import _pack_frame
    from object_oriented_slam_tpu_torch.io import synthetic as syn
    scene = scene24()
    cam = scene.camera
    cfg = ExtractorConfig()

    # the main path's shapes: the frame goes through the extractor's own
    # packing (detection lanes padded to a power of two, cloud tier)
    (_, _, pose, depth, _, det), plane, stats = path
    flat, pad, _, cfg_t, _ = _pack_frame(cam, cfg, det[:, 1:5].copy(),
                                         det[:, 5].astype(int), pose, plane)
    flat_d = torch.from_numpy(flat).to(dev)
    depth_d = torch.from_numpy(np.ascontiguousarray(depth, np.int32)).to(dev)
    recs, (tier, lanes) = frontend_checks(
        dev, "path", depth_d, flat_d[:pad * 4].reshape(pad, 4),
        flat_d[pad * 6:pad * 6 + 7], flat_d[pad * 6 + 7:pad * 6 + 11], cam,
        cfg_t)
    if (tier, lanes) != (stats["cloud_tier"], stats["cluster_lanes"]):
        raise RuntimeError(
            f"the kernels were compared at tier {tier} and {lanes} lanes; "
            f"the main path ran this frame at {stats}")
    print(f"[frontend] path: compared at the shapes the main path launched "
          f"on this frame: {pad} detection lanes, cloud tier {tier}, "
          f"{lanes} clustering lanes")

    # the full tier
    pose = syn.orbit_trajectory(N_DEPTH_FRAMES, 3.6, 1.7)[11]
    depth_d = syn.render_depth(scene.ellipsoids, pose, cam, device=dev)
    bbs, vis = syn.project_bboxes(scene.ellipsoids.astype(np.float32),
                                  pose.astype(np.float32), cam)
    area = torch.where(vis, (bbs[:, 2] - bbs[:, 0]) * (bbs[:, 3] - bbs[:, 1]),
                       -1.0)
    bboxes = bbs[torch.argsort(area, descending=True)[:FE_DETECTIONS]].to(dev)
    full, _ = frontend_checks(
        dev, "full tier", depth_d, bboxes,
        torch.as_tensor(pose, dtype=torch.float32, device=dev),
        torch.tensor([0.0, 0.0, 1.0, 0.0], device=dev), cam,
        ExtractorConfig(cloud_capacity=FE_TIER), whole_image=True)
    full.update({f"{k} (dense)": r for k, r in cluster_extremes(dev).items()})
    return recs, full


def extractor_config(settings):
    """ExtractorConfig of a settings file: symmetry completion as its
    EllipsoidExtraction.Symmetry.Open says (examples/run_tum.py reads it so);
    the other keys of the in-repo files are the defaults."""
    from object_oriented_slam_tpu_torch.frontend import ExtractorConfig
    from object_oriented_slam_tpu_torch.io.config import Config
    return ExtractorConfig(open_symmetry=Config(settings).get_int(
        "EllipsoidExtraction.Symmetry.Open") == 1)


def drive_depth_path(dev, tmp, settings_name, scene, cfg=None,
                     check_sync=False):
    """System with the extractor and the plane estimator (both on the card
    by default) over the N_DEPTH_FRAMES orbit of ``scene`` with rendered
    depth, every launch counter set to 0 just before and read just after
    (the clustering options' counters among them).  ``cfg``: the
    ExtractorConfig (None: the settings file's, ``extractor_config``).
    ``check_sync``: every frame after the plane latch runs under PyTorch's
    synchronisation check set to raise.  Returns (System, frames, e2e
    seconds per frame, the extractor's stats per frame, the frame the plane
    latched on, launches)."""
    from object_oriented_slam_tpu_torch.backend import ba_kernels
    from object_oriented_slam_tpu_torch.frontend import (
        make_extractor, make_plane_estimator)
    from object_oriented_slam_tpu_torch.io.synthetic import SyntheticDataset
    from object_oriented_slam_tpu_torch.ops import frontend_kernels as fk
    from object_oriented_slam_tpu_torch.system import System

    cam = scene.camera
    ds = SyntheticDataset(scene, n_frames=N_DEPTH_FRAMES, orbit_radius=3.6,
                          height=1.7, depth_device=dev)
    frames = list(ds.frames())       # set-up: depth rendered up front
    settings = write_settings(tmp, settings_name)
    extractor = make_extractor(cam, cfg if cfg is not None
                               else extractor_config(settings))
    slam = System(settings, extractor=extractor,
                  plane_estimator=make_plane_estimator(cam))
    if slam.tracker.device.type != "cuda" or extractor.device.type != "cuda":
        raise RuntimeError("the depth path does not default to the card")
    pin_eager(slam)
    slam.open_ground_plane_estimation()
    tr = slam.tracker

    all_kernels = (*ba_kernels.KERNELS, *fk.KERNELS, *fk.OPTION_KERNELS)
    for k in all_kernels:
        k.launches = 0
    e2e, stats, latched_at = [], [], None
    for i, ts, pose, depth, rgb, det in frames:
        extractor.stats = {}
        check = check_sync and latched_at is not None
        t0 = time.perf_counter()
        if check:
            torch.cuda.set_sync_debug_mode("error")
        try:
            slam.track_with_objects(ts, pose, det, depth=depth)
        finally:
            if check:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        e2e.append(time.perf_counter() - t0)
        stats.append(dict(extractor.stats))
        if latched_at is None and tr.state.ground_state == 2:
            latched_at = i
    tr.sync()
    launches = {k.name: k.launches for k in all_kernels}
    return slam, frames, e2e, stats, latched_at, launches


def path_times(tr, e2e):
    """e2e, extraction (dispatch + wait + copy) and backend ms per frame."""
    e2e_ms = np.array(e2e) * 1e3
    ext_ms = (np.array(tr.metrics["dispatch"])
              + np.array(tr.metrics["fetch"])) * 1e3
    backend_ms = np.array(tr.metrics["backend"]) * 1e3
    return e2e_ms, ext_ms, backend_ms


def phase_depth_path(dev, tmp):
    """The depth main path on the card; returns every kernel's launches and
    (the mid-orbit frame, the latched plane, the extractor's stats of that
    frame) for the kernel phase, and the busy ms and device operations of
    one extraction call."""
    scene = scene24()
    slam, frames, e2e, stats, latched_at, launches = drive_depth_path(
        dev, tmp, "synthetic_depth.yaml", scene)
    tr = slam.tracker
    extractor = tr.extractor
    objs = slam.map_objects
    st = tr.state
    errs = np.array([np.linalg.norm(v[:3] - scene.ellipsoids[i][:3])
                     for i, v in objs.items()])
    by_3d = sum(st.objects[i].init_by_3d for i in objs)
    n3 = int(min(tr._b_n3.max(), tr.MAX_OBS3D))
    m3_tier = tr._next_pow2(n3, 32, tr.MAX_OBS3D)
    ran = [s for s in stats if s]
    tiers = sorted({s["cloud_tier"] for s in ran})
    rounds = np.array([s["cluster_rounds"] for s in ran])
    lanes = np.array([s["cluster_lanes"] for s in ran])
    unconverged = [i for i, s in enumerate(stats)
                   if s and not s["cluster_converged"]]
    e2e_ms, ext_ms, backend_ms = path_times(tr, e2e)
    plane = st.ground_plane
    if plane is None:
        raise RuntimeError("the ground plane never latched")
    tilt = float(np.degrees(np.arccos(min(1.0, abs(plane[2])
                                          / np.linalg.norm(plane[:3])))))
    print(f"[depth] {len(frames)} frames, ground plane latched at frame "
          f"{latched_at}: {np.round(plane, 5).tolist()} ({tilt:.3f} deg, "
          f"{abs(plane[3]) * 100:.3f} cm from z = 0)")
    print(f"[depth] {len(objs)}/24 objects initialized, {by_3d} of them from "
          f"a 3D estimate; 3D ring fill {n3}/{tr.MAX_OBS3D} (LM tier M3 = "
          f"{m3_tier}), 2D ring fill "
          f"{int(min(tr._b_n2.max(), tr.MAX_OBS2D))}/{tr.MAX_OBS2D}")
    print(f"[depth] e2e ms/frame p50 {np.median(e2e_ms):.3f} mean "
          f"{e2e_ms.mean():.3f} p99 {np.percentile(e2e_ms, 99):.3f}; "
          f"extraction (dispatch + wait + copy) p50 {np.median(ext_ms):.3f} "
          f"mean {ext_ms.mean():.3f} p99 {np.percentile(ext_ms, 99):.3f}; "
          f"backend mean {backend_ms.mean():.3f} over all frames, "
          f"{backend_ms.sum() / max(tr._backend_calls, 1):.3f} over the "
          f"{tr._backend_calls} with an LM call (host clock, synchronized "
          f"per frame); first frame (kernel load, plane) {e2e_ms[0]:.1f} ms")
    print(f"[depth] extraction ran on {len(ran)} frames; cloud tiers hit "
          f"{tiers}; clustering lanes min {lanes.min()} median "
          f"{int(np.median(lanes))} max {lanes.max()}; clustering rounds per "
          f"frame min {rounds.min()} median {int(np.median(rounds))} max "
          f"{rounds.max()}; frames whose clustering did not converge: "
          f"{unconverged}")
    print(f"[depth] kernel launches in the depth path: {launches}")
    print(f"[depth] centre error vs ground truth: median "
          f"{np.median(errs):.3g} m, max {errs.max():.3g} m; map IoU median "
          f"%.4f, min %.4f" % map_iou(objs, scene))
    out = os.path.join(tmp, "objects_depth.txt")
    slam.save_objects_to_file(out)
    rows = np.loadtxt(out, ndmin=2)
    print(f"[depth] wrote {out}: {rows.shape[0]} rows")

    if latched_at is None or latched_at > 2:
        raise RuntimeError(f"ground plane latched at frame {latched_at}")
    if not (tilt < 2.0 and abs(plane[3]) < 0.02):
        raise RuntimeError(f"ground plane off z = 0: {plane}")
    if min(n for k, n in launches.items()
           if k != "symmetry_search" and k not in OPTION_NAMES) <= 0:
        raise RuntimeError(f"a kernel of the path never launched: {launches}")
    if any(launches[k] for k in OPTION_NAMES):
        raise RuntimeError(f"the default path launched a clustering "
                           f"option's kernel: {launches}")
    if launches["symmetry_search"]:
        raise RuntimeError(f"the path without symmetry launched "
                           f"symmetry_search: {launches}")
    if len(objs) < 16 or by_3d < 1:
        raise RuntimeError(f"{len(objs)} of 24 objects initialized, {by_3d} "
                           "from a 3D estimate")
    if not m3_tier > 32:
        raise RuntimeError(f"the LM stayed at the minimum 3D tier: {n3} 3D "
                           "observations at most")
    if not np.median(errs) < 0.05:
        raise RuntimeError(f"median centre error {np.median(errs):.3g} m")
    if rows.shape != (len(objs), 11) or not np.isfinite(rows).all():
        raise RuntimeError("objects.txt is malformed")
    if unconverged:
        raise RuntimeError(f"the clustering did not converge on frames "
                           f"{unconverged}")
    # the rounds are the plain version's: 16 / 24 / 44 on this scene; two
    # rounds of margin for a depth image rendered with another rounding
    got_rounds = (int(rounds.min()), int(np.median(rounds)),
                  int(rounds.max()))
    if any(abs(g - w) > 2 for g, w in zip(got_rounds, PATH_ROUNDS)):
        raise RuntimeError(f"clustering rounds per frame (min, median, max) "
                           f"{got_rounds}, expected {PATH_ROUNDS} +- 2")
    mid = len(frames) // 2
    call = extraction_overhead("depth", extractor, frames[mid],
                               st.ground_plane, CALL_LAUNCHES)
    if not call[1] < CALL_OPS_BEFORE:
        raise RuntimeError(f"an extraction call is {call[1]} device "
                           f"operations, not fewer than {CALL_OPS_BEFORE}")
    return launches, (frames[mid], st.ground_plane, stats[mid]), call, \
        dict(objs=objs, e2e=e2e_ms, ext=ext_ms, rounds=rounds)


def extraction_overhead(tag, extractor, frame, ground_plane, expect,
                        kernels=None):
    """One extraction call (a mid-orbit frame) under the profiler: wall
    time, device busy time, device operations and how many of them are the
    frontend kernels' launches.  Raises unless the call's frontend launches
    are ``expect`` and nothing between its argument copies and its result
    copy makes the host wait for the device.  Returns (busy ms, device
    operations).  ``kernels``: the launch counters (default the frontend
    kernels of the default path)."""
    from object_oriented_slam_tpu_torch.ops import frontend_kernels as fk
    kernels = fk.KERNELS if kernels is None else kernels
    _, _, pose, depth, _, det = frame

    def call():
        return extractor(depth, det[:, 1:5].copy(), det[:, 5].astype(int),
                         pose, ground_plane)

    wall = wall_ms(call, 5)
    before = sum(k.launches for k in kernels)
    prof = device_busy(call)
    if prof is None:
        raise RuntimeError("the profiler shows no device time for an "
                           "extraction call")
    busy, ops, top = prof
    # device_busy may take its trace up to three times.  This call runs
    # with PyTorch's synchronisation check set to raise: an .item(), a
    # .cpu(), a copy from pageable host memory or a stream synchronisation
    # between upload and fetch is an error
    per_call = {k.name: k.launches for k in kernels}
    up = extractor.upload(depth, det[:, 1:5].copy(), det[:, 5].astype(int),
                          pose, ground_plane)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = extractor.run(*up)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    host = extractor.fetch(out)
    per_call = {k.name: k.launches - per_call[k.name] for k in kernels}
    if sum(k.launches for k in kernels) == before:
        raise RuntimeError("the extraction call launched no kernel")
    if per_call != expect:
        raise RuntimeError(f"an extraction call launched {per_call}, not "
                           f"{expect}")
    if host.shape != (out.rows.shape[0], 12) or not np.isfinite(host).all():
        raise RuntimeError("the fetched extraction result is malformed")
    print(f"[{tag}] one extraction call ({len(det)} detections, "
          f"{extractor.stats}): {wall:.3f} ms wall (host clock, mean of 5, "
          f"copies of the depth image and the arguments included); device "
          f"busy {busy:.3f} ms over {ops} device operations, "
          f"{sum(per_call.values())} of them frontend kernel launches "
          f"{per_call}; no host synchronisation between the argument copies "
          f"and the result copy; device idle share {1 - busy / wall:.3f}; "
          f"top kernels (name, launches, ms) {top}")
    return busy, ops


def scene24_sym():
    """scene24 with explicit labels: the seed-7 draw (reflections 57, 59, 62,
    63 and the 56, 58, 60, 61 without a prior) with four objects spread
    round the ring set to 28 (dual reflection).  The labels are drawn after
    the geometry, so the objects are scene24's."""
    from object_oriented_slam_tpu_torch.io.synthetic import make_scene
    labels = scene24().labels.copy()
    labels[list(SYM_DUAL_OBJECTS)] = 28
    return make_scene(n_objects=24, seed=SEED, radius_range=(1.3, 2.2),
                      scale_range=(0.2, 0.4), labels=labels)


def phase_symmetry_path(dev, tmp, depth_call):
    """The depth path with symmetry completion (synthetic_depth_sym.yaml)
    on the card; returns every kernel's launches and the mid-orbit frame,
    the latched plane and the extractor's stats of it for the kernel phase.
    ``depth_call``: (busy ms, device operations) of the three-launch call,
    printed beside this path's four-launch call."""
    from object_oriented_slam_tpu_torch.frontend.symmetry import \
        sym_type_of_labels
    scene = scene24_sym()
    slam, frames, e2e, stats, latched_at, launches = drive_depth_path(
        dev, tmp, "synthetic_depth_sym.yaml", scene)
    tr = slam.tracker
    if not tr.extractor.cfg.open_symmetry:
        raise RuntimeError("synthetic_depth_sym.yaml did not turn symmetry on")
    objs = slam.map_objects
    errs = np.array([np.linalg.norm(v[:3] - scene.ellipsoids[i][:3])
                     for i, v in objs.items()])
    e2e_ms, ext_ms, backend_ms = path_times(tr, e2e)
    ran = [s for s in stats if s]
    searched = sum(1 for s in ran if s["sym_single"] + s["sym_dual"])
    duals = sum(1 for s in ran if s["sym_dual"])
    probs = np.array([p for r in tr.state.objects.values()
                      for p in r.obs3d_prob])
    types = sym_type_of_labels(scene.labels)
    print(f"[symmetry] {len(frames)} frames, labels {scene.labels.tolist()} "
          f"(types: {int((types == 1).sum())} reflections, "
          f"{int((types == 2).sum())} dual, {int((types == 0).sum())} none); "
          f"ground plane latched at frame {latched_at}")
    print(f"[symmetry] {len(objs)}/24 objects initialized; centre error vs "
          f"ground truth: median {np.median(errs):.3g} m, max "
          f"{errs.max():.3g} m; map IoU median %.4f, min %.4f; stored 3D "
          f"observations {len(probs)}, symmetry prob min {probs.min():.4f} "
          f"median {np.median(probs):.4f}" % map_iou(objs, scene))
    print(f"[symmetry] e2e ms/frame p50 {np.median(e2e_ms):.3f} mean "
          f"{e2e_ms.mean():.3f} p99 {np.percentile(e2e_ms, 99):.3f}; "
          f"extraction (dispatch + wait + copy) p50 {np.median(ext_ms):.3f} "
          f"mean {ext_ms.mean():.3f} p99 {np.percentile(ext_ms, 99):.3f}; "
          f"backend mean {backend_ms.mean():.3f} over all frames, "
          f"{backend_ms.sum() / max(tr._backend_calls, 1):.3f} over the "
          f"{tr._backend_calls} with an LM call (host clock, synchronized "
          f"per frame)")
    print(f"[symmetry] extraction ran on {len(ran)} frames, {searched} of "
          f"them with a detection of type 1 or 2 ({duals} with a dual); "
          f"kernel launches in the path: {launches}")
    if latched_at != 0:
        raise RuntimeError(f"ground plane latched at frame {latched_at}")
    if len(objs) != 24:
        raise RuntimeError(f"{len(objs)} of 24 objects initialized")
    if not np.median(errs) <= 0.05:
        raise RuntimeError(f"median centre error {np.median(errs):.3g} m")
    if launches["symmetry_search"] != searched or not duals:
        raise RuntimeError(
            f"symmetry_search launched {launches['symmetry_search']} times "
            f"for {searched} frames with a detection of type 1 or 2 ({duals} "
            "with a dual)")
    if min(n for k, n in launches.items() if k not in OPTION_NAMES) <= 0:
        raise RuntimeError(f"a kernel of the path never launched: {launches}")
    if not (np.isfinite(probs).all() and (probs < 1).any()
            and (probs > 1e-8).all()):
        raise RuntimeError("the stored symmetry probs are not in (1e-8, 1]")
    mid = len(frames) // 2
    busy, ops = extraction_overhead("symmetry", tr.extractor, frames[mid],
                                    tr.state.ground_plane, SYM_CALL_LAUNCHES)
    print(f"[symmetry] the four-launch call: {ops} device operations, busy "
          f"{busy:.3f} ms; the depth path's three-launch call: "
          f"{depth_call[1]} device operations, busy {depth_call[0]:.3f} ms")
    return (launches, (frames[mid], tr.state.ground_plane, stats[mid]),
            (busy, ops))


def sparse_config():
    """The sparse symmetry path's extractor: synthetic_depth_sym.yaml's
    (symmetry on, the other keys the defaults) with sparse_symmetry.  The
    JAX package has no settings key or CLI flag for it; its tests build
    the config, as this does."""
    from object_oriented_slam_tpu_torch.frontend import ExtractorConfig
    return ExtractorConfig(open_symmetry=True, sparse_symmetry=True)


def phase_sparse_path(dev, tmp, sym_call):
    """The symmetry path's scene, orbit and settings with sparse symmetry on
    the card: each point's depth-border flag rides depth_cloud and
    voxel_downsample, symmetry_search mirrors the border cells only.
    Returns every kernel's launches and (the mid-orbit frame, the latched
    plane, the extractor's stats of it) for the kernel phase.
    ``sym_call``: (busy ms, device operations) of the dense symmetry path's
    call, printed beside this one's."""
    scene = scene24_sym()
    slam, frames, e2e, stats, latched_at, launches = drive_depth_path(
        dev, tmp, "synthetic_depth_sym.yaml", scene, sparse_config())
    tr = slam.tracker
    if not tr.extractor.cfg.sparse_symmetry:
        raise RuntimeError("the sparse path's extractor is not sparse")
    objs = slam.map_objects
    errs = np.array([np.linalg.norm(v[:3] - scene.ellipsoids[i][:3])
                     for i, v in objs.items()])
    iou = map_iou(objs, scene)
    e2e_ms, ext_ms, backend_ms = path_times(tr, e2e)
    ran = [s for s in stats if s]
    searched = np.array([s["sym_single"] + s["sym_dual"] for s in ran])
    sources = np.array([s.get("sym_sources", 0) for s in ran])
    points = np.array([s.get("sym_points", 0) for s in ran])
    dense = np.array([s.get("sym_dense", 0) for s in ran])
    proper = int((searched - dense).sum())
    probs = np.array([p for r in tr.state.objects.values()
                      for p in r.obs3d_prob])
    rows = np.array([v for _, v in sorted(objs.items())])
    print(f"[sparse] {len(frames)} frames, ExtractorConfig(open_symmetry="
          f"True, sparse_symmetry=True) over synthetic_depth_sym.yaml's scene "
          f"and orbit; ground plane latched at frame {latched_at}")
    print(f"[sparse] {len(objs)}/24 objects initialized; centre error vs "
          f"ground truth: median {np.median(errs):.3g} m, max "
          f"{errs.max():.3g} m; map IoU median %.4f, min %.4f; stored 3D "
          f"observations {len(probs)}, symmetry prob min {probs.min():.4f} "
          f"median {np.median(probs):.4f}" % iou)
    print(f"[sparse] e2e ms/frame p50 {np.median(e2e_ms):.3f} mean "
          f"{e2e_ms.mean():.3f} p99 {np.percentile(e2e_ms, 99):.3f}; "
          f"extraction (dispatch + wait + copy) p50 {np.median(ext_ms):.3f} "
          f"mean {ext_ms.mean():.3f} p99 {np.percentile(ext_ms, 99):.3f}; "
          f"backend mean {backend_ms.mean():.3f} over all frames, "
          f"{backend_ms.sum() / max(tr._backend_calls, 1):.3f} over the "
          f"{tr._backend_calls} with an LM call (host clock, synchronized "
          f"per frame)")
    print(f"[sparse] per frame: detections searched min {searched.min()} "
          f"median {int(np.median(searched))} max {searched.max()}; their "
          f"sources (border cells) against their live cells: {sources.sum()} "
          f"of {points.sum()} over the run "
          f"({sources.sum() / max(points.sum(), 1):.3f}), "
          f"median a frame {int(np.median(sources))} of "
          f"{int(np.median(points))}; searched with every live cell (the "
          f"dense fall-back, or every cell a border cell) {dense.sum()} of "
          f"{searched.sum()}, on a proper border subset {proper}")
    print(f"[sparse] kernel launches in the path: {launches}")
    if len(objs) < 16:
        raise RuntimeError(f"{len(objs)} of 24 objects initialized")
    if not (np.isfinite(rows).all() and np.isfinite(probs).all()
            and np.isfinite(errs).all()):
        raise RuntimeError("the sparse path's map or probs are not finite")
    if proper <= 0:
        raise RuntimeError("no detection of the sparse path was searched "
                           "over a proper border subset: every one fell "
                           "back to the dense cost")
    if launches["symmetry_search"] != int((searched > 0).sum()) or \
            min(n for k, n in launches.items()
                if k not in OPTION_NAMES) <= 0:
        raise RuntimeError(f"launches {launches} for "
                           f"{int((searched > 0).sum())} frames with a "
                           "detection to search")
    mid = len(frames) // 2
    busy, ops = extraction_overhead("sparse", tr.extractor, frames[mid],
                                    tr.state.ground_plane, SYM_CALL_LAUNCHES)
    print(f"[sparse] its call: {ops} device operations, busy {busy:.3f} ms; "
          f"the dense symmetry path's: {sym_call[1]} device operations, busy "
          f"{sym_call[0]:.3f} ms")
    return launches, (frames[mid], tr.state.ground_plane, stats[mid])


def example(name):
    """A script of examples/ as a module (examples/ is not a package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def decode_times(seq, tmp):
    """ms of the numpy PNG decode (io/png.py) of a depth frame, each a mean
    over repeats on this host: the export's frames (Up filter: the
    whole-row path), one frame re-written with the Paeth filter (the
    anti-diagonal path every Average or Paeth row takes) and, where cv2 is
    installed, the same frame written by cv2 with its default filter and
    with libpng's choice per row (IMWRITE_PNG_ALL_FILTERS), each decode
    checked against cv2.imread.  Returns {what: ms}."""
    import importlib.util
    from object_oriented_slam_tpu_torch.io import png

    def ms(path, reps):
        t0 = time.perf_counter()
        for _ in range(reps):
            got = png.read_png(path)
        return (time.perf_counter() - t0) * 1e3 / reps, got

    files = sorted(os.listdir(os.path.join(seq, "depth")))
    paths = [os.path.join(seq, "depth", f) for f in files[:40]]
    t0 = time.perf_counter()
    for p in paths:
        png.read_png(p)
    out = {"up": (time.perf_counter() - t0) * 1e3 / len(paths)}
    img = png.read_png(paths[len(paths) // 2])
    paeth = os.path.join(tmp, "paeth.png")
    png.write_png(paeth, img, png.PAETH)
    out["paeth"], back = ms(paeth, 5)
    if not np.array_equal(back, img):
        raise RuntimeError("the Paeth round trip of a depth frame differs")
    if importlib.util.find_spec("cv2") is not None:
        import cv2
        every_filter = [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS]
        for name, flags in (("cv2 default", []),
                            ("cv2 all filters", every_filter)):
            path = os.path.join(tmp, name.replace(" ", "_") + ".png")
            cv2.imwrite(path, img, flags)
            out[name], got = ms(path, 5)
            if not np.array_equal(got, cv2.imread(path,
                                                  cv2.IMREAD_UNCHANGED)):
                raise RuntimeError(f"read_png differs from cv2 ({name})")
    return out


def drive_cli(dev, settings, seq, out, extra):
    """examples/torch_run_tum.main on the export ``seq`` with ``extra``
    flags, every launch counter set to 0 just before and read just after.
    Every frame after the plane latch runs under PyTorch's synchronisation
    check set to raise: the host may wait only on the events of the due
    fetch, the backend drain, the plane's resolve and, with a
    host-clustered extractor, phase A's copy.  The split extractors' host
    middle stage, its labelling (io/native_loader.cluster_labels) and
    phase A are wrapped here (the program keeps no metric of them): host
    seconds of each middle stage and of the labelling inside it, bytes of
    each phase A result copied home.  Returns (System, the CLI's printout,
    host seconds of each frame's track_with_objects, frames checked, fetch
    waits of the loop (the final flush left out), launches, [middle-stage
    seconds, labelling seconds] per middle stage, phase-A bytes)."""
    import contextlib
    import io
    from object_oriented_slam_tpu_torch.backend import ba_kernels, slam_kernels
    from object_oriented_slam_tpu_torch.frontend.extractor import \
        SplitExtractor
    from object_oriented_slam_tpu_torch.io import native_loader
    from object_oriented_slam_tpu_torch.ops import frontend_kernels as fk
    from object_oriented_slam_tpu_torch.system import System

    grab = System.track_with_objects
    middle, phase_a = SplitExtractor.middle, SplitExtractor.phase_a
    labels = native_loader.cluster_labels
    e2e, checked, loop_fetches = [], [0], [0]
    middle_s, a_bytes, labels_s = [], [], [0.0]

    def timed_labels(*args):
        t0 = time.perf_counter()
        try:
            return labels(*args)
        finally:
            labels_s[0] += time.perf_counter() - t0

    def timed_middle(self, h):
        labels_s[0] = 0.0
        t0 = time.perf_counter()
        try:
            return middle(self, h)
        finally:
            middle_s.append((time.perf_counter() - t0, labels_s[0]))

    def sized_phase_a(self, *args):
        h = phase_a(self, *args)
        a_bytes.append(h.a_out.numel() * h.a_out.element_size())
        return h

    def track(self, *args, **kwargs):
        if self.tracker.device.type != "cuda":
            raise RuntimeError(f"the CLI runs on {self.tracker.device}")
        check = self.tracker.state.ground_state == 2
        if check:
            torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            return grab(self, *args, **kwargs)
        finally:
            e2e.append(time.perf_counter() - t0)
            if check:
                torch.cuda.set_sync_debug_mode("default")
                checked[0] += 1
            loop_fetches[0] = len(self.tracker.metrics["fetch"])

    from object_oriented_slam_tpu_torch.ops import dense_fuse
    all_kernels = (*ba_kernels.KERNELS, *fk.KERNELS, *slam_kernels.KERNELS,
                   *dense_fuse.KERNELS)
    for k in all_kernels:
        k.launches = 0
    System.track_with_objects = track
    SplitExtractor.middle = timed_middle
    SplitExtractor.phase_a = sized_phase_a
    native_loader.cluster_labels = timed_labels
    try:
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            slam = example("torch_run_tum").main(
                [settings, seq, "--out", out, *extra])
    finally:
        System.track_with_objects = grab
        SplitExtractor.middle, SplitExtractor.phase_a = middle, phase_a
        native_loader.cluster_labels = labels
    launches = {k.name: k.launches for k in all_kernels}
    fetch = np.array(slam.tracker.metrics["fetch"][:loop_fetches[0]])
    return slam, printed.getvalue(), np.array(e2e), checked[0], fetch, \
        launches, np.array(middle_s).reshape(-1, 2), np.array(a_bytes)


CLI_RUNS = (("mono depth 1", ["--extractor", "mono", "--pipeline-depth", "1"]),
            ("mono adaptive", ["--extractor", "mono"]),
            ("split", ["--extractor", "split"]),
            ("fused", ["--extractor", "fused"]),
            ("auto", []))
HOST_CLUSTERED = ("split", "fused", "auto")


def split_call_overhead(settings, frame, ground_plane, mono_call):
    """One split extraction call (phase A, the host middle stage, phase B
    and the fetch) at the symmetry path's mid-orbit frame under the
    profiler: device operations and busy time beside the monolithic
    call's ``mono_call`` (busy ms, operations).  Raises unless it launches
    depth_cloud, voxel_downsample and symmetry_search once each and
    cluster_components never, and unless phase A's and phase B's launches
    run without a host synchronisation (the middle stage waits on phase
    A's copy event only).  Returns (busy ms, device operations)."""
    from object_oriented_slam_tpu_torch.frontend import make_split_extractor
    from object_oriented_slam_tpu_torch.ops import frontend_kernels as fk
    _, _, pose, depth, _, det = frame
    ex = make_split_extractor(scene24_sym().camera,
                              extractor_config(settings))
    args = (depth, det[:, 1:5].copy(), det[:, 5].astype(int), pose,
            ground_plane)

    def call():
        return ex.fetch(ex.midway(ex(*args)))

    wall = wall_ms(call, 5)
    prof = device_busy(call)
    if prof is None:
        raise RuntimeError("the profiler shows no device time for a split "
                           "extraction call")
    busy, ops, top = prof
    before = {k.name: k.launches for k in fk.KERNELS}
    torch.cuda.set_sync_debug_mode("error")
    try:
        h = ex(*args)
        out = ex.midway(h)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    host = ex.fetch(out)
    per_call = {k.name: k.launches - before[k.name] for k in fk.KERNELS}
    want = {"depth_cloud": 1, "voxel_downsample": 1,
            "cluster_components": 0, "symmetry_search": 1}
    if per_call != want:
        raise RuntimeError(f"a split extraction call launched {per_call}, "
                           f"not {want}")
    if not np.isfinite(host).all():
        raise RuntimeError("the split call's result is not finite")
    print(f"[cli] one split extraction call ({len(det)} detections, "
          f"{ex.stats}): {wall:.3f} ms wall (host clock, mean of 5, the "
          f"middle stage included); device busy {busy:.3f} ms over {ops} "
          f"device operations (phase A + phase B, launches {per_call}); the "
          f"monolithic call: {mono_call[1]} device operations, busy "
          f"{mono_call[0]:.3f} ms; phase A's copy home "
          f"{h.a_out.numel() * h.a_out.element_size()} bytes; no host "
          f"synchronisation in phase A or phase B; top kernels {top}")
    return busy, ops


def phase_cli(dev, tmp, sym_path, sym_call):
    """examples/torch_run_tum.py end to end on the card: the symmetry
    path's scene and orbit (24 objects, seed 7, N_DEPTH_FRAMES frames,
    640x480) exported as a TUM sequence by
    examples/torch_make_synthetic_tum.py (depth rendered on the card), run
    with configs/synthetic_depth_sym.yaml once per architecture of
    CLI_RUNS: --extractor mono at --pipeline-depth 1 and at the default
    (adaptive depth 4..8, asynchronous plane), split, fused and the default
    auto (the probe's choice, which must be fused with LM fusion on this
    card).  Raises unless every run maps 24/24 objects within a median
    centre error of 0.05 m of objects_gt.txt, its objects.txt agrees with
    the adaptive mono run's within 1e-4, every kernel of its path launched
    (depth_cloud, voxel_downsample and symmetry_search once a frame;
    cluster_components once a frame on mono and never on the host-clustered
    runs), and no frame after the plane latch made the host wait other
    than on an event.  Also one split call under the profiler at
    ``sym_path``'s frame beside the mono call ``sym_call``.  Returns the
    launches of each run by name."""
    import importlib.util
    import object_oriented_slam_tpu_torch as pkg
    from object_oriented_slam_tpu_torch.io.native_loader import \
        native_available
    from object_oriented_slam_tpu_torch.io.synthetic import SyntheticDataset
    from object_oriented_slam_tpu_torch.io.writers import load_objects
    from object_oriented_slam_tpu_torch.system.metrics import object_map_iou
    from object_oriented_slam_tpu_torch.system.probe import (
        RTT_THRESHOLD_MS, choose_architecture, probe_device_rtt_ms)

    rtt = probe_device_rtt_ms()
    choice = choose_architecture(rtt)
    print(f"[cli] probe: device round trip {rtt:.4f} ms (median of 7, a "
          f"trivial operation and a blocking scalar read; threshold "
          f"{RTT_THRESHOLD_MS} ms) -> extractor={choice[0]}, "
          f"fuse_lm={choice[1]}")
    if choice != ("fused", True):
        raise RuntimeError(f"the probe chose {choice} on this card")

    scene = scene24_sym()
    seq = os.path.join(tmp, "tum_sequence")
    t0 = time.perf_counter()
    # odometry.txt for [slam]: 1 cm of random-walk drift a frame; its draws
    # are the exporter's only ones, so the other files are what they were
    n = example("torch_make_synthetic_tum").export_synthetic_tum(
        seq, scene, SyntheticDataset(scene, n_frames=N_DEPTH_FRAMES,
                                     orbit_radius=3.6, height=1.7,
                                     depth_device=dev), odometry_noise=0.01)
    export_s = time.perf_counter() - t0
    decode = decode_times(seq, tmp)
    print(f"[cli] exported {n} frames (depth rendered on the card, 16-bit "
          f"PNG depth and 8-bit PNG RGB by io/png.py) in {export_s:.1f} s")
    print(f"[cli] numpy decode of a 640x480 depth frame, ms (host clock): "
          f"{ {k: round(v, 3) for k, v in decode.items()} } (up: the "
          f"export's Up filter, mean of 40 frames; paeth: one frame "
          f"Paeth-filtered; cv2 *: written by cv2, each equal to cv2.imread; "
          f"means of 5); cv2 installed: "
          f"{importlib.util.find_spec('cv2') is not None}, "
          f"native/lib/liboslam_native.so loads: {native_available()}")
    gt = {int(r[0]): r[1:] for r in np.loadtxt(
        os.path.join(seq, "objects_gt.txt"), ndmin=2)}
    settings = os.path.join(os.path.dirname(pkg.__file__), "configs",
                            "synthetic_depth_sym.yaml")
    split_call_overhead(settings, sym_path[0], sym_path[1], sym_call)
    maps, cli_launches, rates, cli_rates = {}, {}, {}, {}
    for name, extra in CLI_RUNS:
        out = os.path.join(tmp, "cli_" + name.replace(" ", "_"))
        slam, printed, e2e, checked, fetch, launches, middle, a_bytes = \
            drive_cli(dev, settings, seq, out, extra)
        tr = slam.tracker
        insts, vecs = load_objects(os.path.join(out, "objects.txt"))
        objs = dict(zip(insts, vecs))
        maps[name] = (objs, open(os.path.join(out, "objects.txt")).read())
        errs = np.array([np.linalg.norm(v[:3] - gt[i][:3])
                         for i, v in objs.items()])
        iou = np.array(list(object_map_iou(
            objs, {i: gt[i] for i in objs}).values()))
        trace = tr.depth_trace
        e2e_ms, fetch_ms = e2e * 1e3, fetch * 1e3
        fps = len(e2e) / max(e2e.sum(), 1e-9)
        rates[name] = (fps, e2e_ms.mean())
        cli_rates[name] = cli_fps(printed)
        arch = (type(tr.extractor).__name__, tr.fuse_lm)
        for line in printed.splitlines():
            if line.startswith(("Processed", "Timing", "Pipeline depth",
                                "probed")):
                print(f"[cli] {name}: CLI: {line}")
        print(f"[cli] {name}: {arch[0]}, fuse_lm={arch[1]}; {len(objs)}/24 "
              f"objects; centre error median {np.median(errs):.4g} m, max "
              f"{errs.max():.4g} m; map IoU median {np.median(iou):.4f}, "
              f"min {iou.min():.4f}")
        print(f"[cli] {name}: track_with_objects ms/frame p50 "
              f"{np.median(e2e_ms):.3f} mean {e2e_ms.mean():.3f} p99 "
              f"{np.percentile(e2e_ms, 99):.3f} (host clock, not synchronized "
              f"per frame), {fps:.2f} frames/s over the calls; fetch wait "
              f"p50 {np.median(fetch_ms):.3f} p99 "
              f"{np.percentile(fetch_ms, 99):.3f} ms, blocked (> 3 ms) "
              f"{(fetch_ms > 3).mean():.3f} of {len(fetch_ms)}; plane wait "
              f"{np.round(np.array(tr.metrics['plane_wait']) * 1e3, 3)} ms; "
              f"depth trace start {trace[0]} final {trace[-1]} max "
              f"{max(trace)}; {checked} frames under the synchronisation "
              f"check")
        if name in HOST_CLUSTERED:
            mid_ms, lab_ms = middle[:, 0] * 1e3, middle[:, 1] * 1e3
            print(f"[cli] {name}: host middle stage (labels and selection of "
                  f"every run lane) ms p50 {np.median(mid_ms):.3f} p99 "
                  f"{np.percentile(mid_ms, 99):.3f} mean {mid_ms.mean():.3f} "
                  f"over {len(mid_ms)} calls, of it the labels "
                  f"(cluster.cpp) p50 {np.median(lab_ms):.3f} mean "
                  f"{lab_ms.mean():.3f} and the rest (the copy's wait, "
                  f"slicing, _select_cluster_np) p50 "
                  f"{np.median(mid_ms - lab_ms):.3f}; phase A's copy home "
                  f"bytes a frame mean {a_bytes.mean():.0f} max "
                  f"{a_bytes.max()} over {len(a_bytes)} frames")
            if len(middle) != N_DEPTH_FRAMES or len(a_bytes) != N_DEPTH_FRAMES:
                raise RuntimeError(f"{len(middle)} middle stages and "
                                   f"{len(a_bytes)} phase A calls")
        print(f"[cli] {name}: kernel launches {launches}")
        want_arch = {"mono depth 1": ("MonolithicExtractor", False),
                     "mono adaptive": ("MonolithicExtractor", False),
                     "split": ("SplitExtractor", False),
                     "fused": ("FusedSplitExtractor", False),
                     "auto": ("FusedSplitExtractor", True)}[name]
        if arch != want_arch:
            raise RuntimeError(f"the {name} run used {arch}")
        if name == "auto" and not any(
                line.startswith("probed device RTT")
                and line.endswith("-> extractor=fused, fuse_lm=True")
                for line in printed.splitlines()):
            raise RuntimeError("the auto run did not print its probed choice")
        if len(e2e) != N_DEPTH_FRAMES or len(trace) != N_DEPTH_FRAMES:
            raise RuntimeError(f"the CLI ran {len(e2e)} frames")
        if len(objs) != 24 or not np.median(errs) < 0.05:
            raise RuntimeError(f"{len(objs)} of 24 objects, median centre "
                               f"error {np.median(errs):.4g} m")
        want = {k: N_DEPTH_FRAMES for k in ("depth_cloud", "voxel_downsample",
                                            "symmetry_search")}
        want["cluster_components"] = (0 if name in HOST_CLUSTERED
                                      else N_DEPTH_FRAMES)
        if ({k: launches[k] for k in want} != want
                or min(launches["ba_normal_eq"], launches["ba_chi2"]) <= 0):
            raise RuntimeError(f"the {name} run launched {launches}, the "
                               f"frontend kernels not {want}")
        if checked < N_DEPTH_FRAMES - 2:
            raise RuntimeError(f"only {checked} frames ran under the "
                               "synchronisation check")
        if name != "mono depth 1" and not (
                trace[0] >= 4 and tr.adaptive_depth and tr.async_plane):
            raise RuntimeError(f"the {name} run was not pipelined: {trace}")
        cli_launches[name] = launches
    ref, text_ref = maps["mono adaptive"]
    for name, (objs, text) in maps.items():
        if name == "mono adaptive":
            continue
        diff = max(np.abs(objs[i] - ref[i]).max() for i in ref)
        print(f"[cli] {name} against mono adaptive: objects.txt max |diff| "
              f"{diff:.3g} (limit 1e-4), bit-equal files: {text == text_ref}")
        if sorted(objs) != sorted(ref) or not diff <= 1e-4:
            raise RuntimeError(f"the {name} run's objects.txt differs from "
                               f"the adaptive mono run's by {diff}")
    return cli_launches, dict(seq=seq, settings=settings, gt=gt, ref=maps[
        "mono adaptive"], rates=rates, launches=cli_launches["mono adaptive"],
        cli_rates=cli_rates)


def cli_fps(printed):
    """The frames/s of the CLI's own "Processed N frames in Xs (Y fps)"
    line (its host clock around the whole frame loop)."""
    for line in printed.splitlines():
        if line.startswith("Processed"):
            return float(line.rsplit("(", 1)[1].split()[0])
    raise RuntimeError("the CLI printed no Processed line")


# the offline runs of [offline]: (name, flags); --extractor names the
# bootstrap frames' extractor (the plane's frame goes through the per-frame
# path), the batches are the offline mapper's
OFFLINE_RUNS = (
    ("offline", ["--extractor", "mono", "--offline"]),
    ("offline per-frame BA", ["--extractor", "mono", "--offline",
                              "--offline-per-frame-ba"]),
    ("offline split", ["--extractor", "split", "--offline",
                       "--offline-split"]))
OFFLINE_BATCH = 8
# their records' keys in the JSON line: launches_offline, ...
OFFLINE_KEYS = tuple((name, name.replace(" ", "_").replace("-", "_").lower())
                     for name, _ in OFFLINE_RUNS)


def drive_offline(settings, seq, out, extra):
    """examples/torch_run_tum.main --offline on the export ``seq`` with
    ``extra`` flags, every launch counter set to 0 just before and read just
    after.  The batched frames run under PyTorch's synchronisation check
    set to raise: each grab after the plane latch (it reads its
    precomputed rows, the LM launches, the drains wait on events) and each
    batched call (frontend/batch_extractor: the upload, the launches, the
    host middle stage, the fetch).  OfflineMapper.run is wrapped to keep
    its mapper and its returned counts.  Returns (System, printout, the
    run's counts, the mapper, launches, grabs checked, batched calls
    checked, grabs without precomputed rows)."""
    import contextlib
    import io
    from object_oriented_slam_tpu_torch.backend import ba_kernels, slam_kernels
    from object_oriented_slam_tpu_torch.frontend import batch_extractor as bx
    from object_oriented_slam_tpu_torch.ops import frontend_kernels as fk
    from object_oriented_slam_tpu_torch.system import offline
    from object_oriented_slam_tpu_torch.system.tracking import Tracking

    grab, run = Tracking.grab_pose_and_objects, offline.OfflineMapper.run
    calls = {n: getattr(bx, n) for n in ("dispatch_batch",
                                         "dispatch_batch_phase_a",
                                         "dispatch_batch_phase_b",
                                         "fetch_batch")}
    seen = dict(grabs=0, calls=0, per_frame=0)
    kept = {}

    @contextlib.contextmanager
    def checked():
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def checked_grab(self, *args, **kwargs):
        if kwargs.get("ext_result") is None:
            seen["per_frame"] += 1
        if self.state.ground_state != 2:
            return grab(self, *args, **kwargs)
        with checked():
            out = grab(self, *args, **kwargs)
        seen["grabs"] += 1
        return out

    def wrap(fn):
        def call(*args, **kwargs):
            with checked():
                out = fn(*args, **kwargs)
            seen["calls"] += 1
            return out
        return call

    def kept_run(self, frames, progress=None):
        kept["mapper"] = self
        kept["stats"] = run(self, frames, progress)
        return kept["stats"]

    all_kernels = (*ba_kernels.KERNELS, *fk.KERNELS, *slam_kernels.KERNELS)
    for k in all_kernels:
        k.launches = 0
    Tracking.grab_pose_and_objects = checked_grab
    offline.OfflineMapper.run = kept_run
    for n, fn in calls.items():
        setattr(bx, n, wrap(fn))
    try:
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            slam = example("torch_run_tum").main(
                [settings, seq, "--out", out, *extra])
    finally:
        Tracking.grab_pose_and_objects = grab
        offline.OfflineMapper.run = run
        for n, fn in calls.items():
            setattr(bx, n, fn)
    launches = {k.name: k.launches for k in all_kernels}
    return (slam, printed.getvalue(), kept["stats"], kept["mapper"],
            launches, seen["grabs"], seen["calls"], seen["per_frame"])


def offline_batch(dev, seq, settings, ground_plane, first=76):
    """OFFLINE_BATCH consecutive mid-orbit frames of the export (from
    frame ``first``) packed as the offline mapper packs them, with the
    tracker's run gates.  Returns (FrameBatch, camera, the batch's device
    inputs (depths, bboxes, frame index, run, types, poses, plane), the
    frames as packed: (depth, bboxes, labels, run, pose) each)."""
    from object_oriented_slam_tpu_torch.frontend import batch_extractor as bx
    from object_oriented_slam_tpu_torch.io.config import Config
    from object_oriented_slam_tpu_torch.io.tum import TUMDataset
    from object_oriented_slam_tpu_torch.system.tracking import Tracking
    from object_oriented_slam_tpu_torch.utils.transfer import to_device
    cam = scene24_sym().camera
    tr = Tracking(Config(settings), device=dev)
    ds = TUMDataset(seq)
    packed = []
    try:
        for k, ts, pose, depth, rgb, det in ds.frames():
            if k >= first:
                det = np.asarray(det, np.float64).reshape(-1, 8)
                packed.append((depth, det[:, 1:5], det[:, 5].astype(int),
                               tr.run_gates(det, True), pose))
            if len(packed) == OFFLINE_BATCH:
                break
    finally:
        ds.close()
    fb = bx.pack_frames_batch(cam, extractor_config(settings), packed,
                              ground_plane, min_pad=OFFLINE_BATCH)
    depths_d = to_device(np.asarray(fb.depths, np.int32), dev)
    bb, fi, run, st, poses, plane = bx._unpack(to_device(fb.flat, dev),
                                               fb.pad, fb.B)
    return fb, cam, (depths_d, bb.contiguous(), fi, run, st.to(torch.int32),
                     poses.contiguous(), plane.contiguous()), packed


def batch_call_overhead(dev, fb, cam, online_call):
    """One batched extraction call of OFFLINE_BATCH frames
    (batch_extractor.dispatch_batch + fetch_batch) under the profiler:
    device operations, busy ms and the idle share of its wall, operations
    a frame beside the online call's ``online_call`` (busy ms,
    operations).  Raises unless it launches each frontend kernel exactly
    once, and unless it runs under the synchronisation check.  Returns
    (busy ms, operations, wall ms)."""
    from object_oriented_slam_tpu_torch.frontend import batch_extractor as bx
    from object_oriented_slam_tpu_torch.ops import frontend_kernels as fk

    def call():
        return bx.fetch_batch(bx.dispatch_batch(fb, cam, device=dev))

    wall = wall_ms(call, 5)
    prof = device_busy(call)
    if prof is None:
        raise RuntimeError("the profiler shows no device time for a batched "
                           "extraction call")
    busy, ops, top = prof
    before = {k.name: k.launches for k in fk.KERNELS}
    torch.cuda.set_sync_debug_mode("error")
    try:
        h = bx.dispatch_batch(fb, cam, device=dev)
        rows = bx.fetch_batch(h)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    per_call = {k.name: k.launches - before[k.name] for k in fk.KERNELS}
    if per_call != SYM_CALL_LAUNCHES:
        raise RuntimeError(f"a batched call launched {per_call}, not "
                           f"{SYM_CALL_LAUNCHES}")
    n = sum(n for _, n in fb.slices)
    valid = int((rows[:n, 11] > 0.5).sum())
    if not np.isfinite(rows).all() or not valid:
        raise RuntimeError(f"the batched call's rows: {valid} valid of {n}")
    print(f"[offline] one batched extraction call of {fb.B} frames ({n} "
          f"detections, {valid} valid, in {fb.pad} lanes, tier "
          f"{fb.cfg.cloud_capacity}, "
          f"{h.stats}): {wall:.3f} ms wall (host clock, mean of 5); device "
          f"busy {busy:.3f} ms over {ops} device operations, idle "
          f"{1 - busy / wall:.3f} of the wall; {ops / fb.B:.1f} operations "
          f"and {busy / fb.B:.3f} ms busy a frame against the online call's "
          f"{online_call[1]} and {online_call[0]:.3f} ms; launches "
          f"{per_call}; no host synchronisation; top kernels {top}")
    return busy, ops, wall


def frame_lane_checks(dev, fb, cam, inputs):
    """The two kernels that gained a frame lane, at the batch's shapes:
    depth_cloud (and with the border lane) and symmetry_search against
    their plain versions (depth_cloud_checks / symmetry_checks with the
    frame index) and bit for bit against the same detections launched one
    frame at a time; the clustering kernel's sort-frame hint one rotation
    a detection against one rotation for all (labels, rounds and
    selections equal; device ms of each).  Returns (records, records of
    the border lane, which no offline path launches)."""
    from object_oriented_slam_tpu_torch.core import se3
    from object_oriented_slam_tpu_torch.frontend import extractor as text
    from object_oriented_slam_tpu_torch.frontend import symmetry as sym
    from object_oriented_slam_tpu_torch.ops import cluster as cl
    from object_oriented_slam_tpu_torch.ops import depth_cloud as dc
    depths, bb, fi, run, types, poses, plane = inputs
    cfg = fb.cfg
    rest = (cfg.voxel_leaf, cfg.depth_range, cfg.plane_clearance,
            cfg.cloud_capacity)
    rows = [(fi == b).nonzero().flatten() for b in range(fb.B)]
    live = [r for r in rows if r.numel()]
    recs, border_recs = {}, {}
    recs["depth_cloud (offline batch, frame lane)"] = depth_cloud_checks(
        "offline batch", depths, bb, poses, plane, cam, cfg, frame=fi)
    r_b, _ = depth_cloud_checks("offline batch", depths, bb, poses, plane,
                                cam, cfg, border=True, frame=fi)
    border_recs["depth_cloud (offline batch, frame and border lanes)"] = r_b
    for border in (False, True):
        fn = dc.depth_cloud_border if border else dc.depth_cloud
        got = fn(depths, bb, poses, plane, cam, *rest, frame=fi)
        got = (*got[0], got[1]) if border else tuple(got)
        for r in live:
            b = int(fi[r[0]])
            one = fn(depths[b], bb[r].contiguous(), poses[b].contiguous(),
                     plane, cam, *rest)
            one = (*one[0], one[1]) if border else tuple(one)
            for name, g, o in zip((*dc.DepthCloud._fields, "battr_v"), got,
                                  one):
                same = (all(same_bits(g[d].cpu(), o.cpu()) for d in r.tolist())
                        if name == "R_wc" else same_bits(g[r].cpu(), o.cpu()))
                if not same:
                    raise RuntimeError(
                        f"depth_cloud's frame lane (border {border}): {name} "
                        f"of frame {b} differs from its own launch")
    print(f"[offline] depth_cloud with the frame lane (and with the border "
          f"lane too): every output of the {fb.B} frames' one launch "
          f"bit-equal to each frame's own launch ({len(live)} frames with "
          f"detections)")
    a = text._stage_a(depths, bb, poses, plane, cam, cfg, fi)
    args = cl.centre_and_seed(a[1], a[3], cfg.cluster_tolerance,
                              cfg.cluster_chains)
    hints = {"one rotation a detection": a[7].transpose(-1, -2).contiguous(),
             "the first frame's for all": a[7][0].T.contiguous(),
             "the identity": None}
    outs, hint_ms = {}, {}
    for name, frame in hints.items():
        def select(frame=frame):
            return cl.cluster_select(
                a[1].contiguous(), *args[:4], a[4].contiguous(), args[4],
                cfg.cluster_iters, 12, cfg.cluster_min_size,
                cfg.cluster_center_dis, frame=frame)
        outs[name] = select()
        hint_ms[name] = device_ms(select, 10, name="cluster_components")
    first = next(iter(outs.values()))
    if not all(all_bits(o, first) for o in outs.values()):
        raise RuntimeError("the clustering's sort-frame hint changed a label, "
                           "a round count or a selection")
    print(f"[offline] cluster_select at the batch's shapes ({fb.pad} lanes, "
          f"rounds max {int(first[4].max())}): labels, rounds and selections "
          f"equal under every sort-frame hint; device ms "
          f"{ {k: round(v, 4) for k, v in hint_ms.items()} } (the batch "
          f"passes one rotation a detection)")
    sel, _ = text._cluster_select_batch(a[1], a[3], a[4], a[7], cfg)
    Two, pts_n, obj_m, _ = text._stage_post(a[1], sel, plane, cfg)
    pose_oc = se3.se3_mul(se3.se3_inv(Two), poses[fi.long()])
    s_args = (pts_n.contiguous(), obj_m.contiguous(), bb, pose_oc.contiguous(),
              depths, types, run, cam)
    recs["symmetry_search (offline batch, frame lane)"] = symmetry_checks(
        "offline batch", *s_args, True, frame=fi)
    s_cfg = sym.SymmetryConfig()
    got = sym.estimate_symmetry(*s_args, s_cfg, frame=fi)
    for r in live:
        b = int(fi[r[0]])
        one = sym.estimate_symmetry(*(t[r].contiguous() for t in s_args[:4]),
                                    depths[b].contiguous(),
                                    types[r].contiguous(),
                                    run[r].contiguous(), cam, s_cfg)
        for name, g, o in zip(sym.SymSearch._fields, got, one):
            if not same_bits(g[r].cpu(), o.cpu()):
                raise RuntimeError(f"symmetry_search's frame lane: {name} of "
                                   f"frame {b} differs from its own launch")
    print(f"[offline] symmetry_search with the frame lane: the {fb.B} frames' "
          f"one launch bit-equal to each frame's own launch")
    for r in (*recs.values(), *border_recs.values()):
        r["hint_ms"] = hint_ms
    return recs, border_recs


def phase_offline(dev, tmp, cli, sym_call):
    """examples/torch_run_tum.py --offline on [cli]'s export (24 objects,
    N_DEPTH_FRAMES frames, synthetic_depth_sym.yaml), once per
    OFFLINE_RUNS entry: batches of OFFLINE_BATCH frames with one BA a
    batch, with the per-frame BA, and the split protocol (u16 phase A).
    Raises unless every run maps 24/24 objects within a median centre
    error of 0.05 m of objects_gt.txt, the per-frame-BA run's objects.txt
    is within 1e-3 of the adaptive mono CLI run's, depth_cloud,
    voxel_downsample and symmetry_search launched once a batch plus once a
    bootstrap frame (cluster_components too on the monolithic runs, never
    on the split run), and the batched frames ran under the
    synchronisation check.  Then one batched call under the profiler
    beside the online call ``sym_call`` and the frame lanes
    (frame_lane_checks) at that batch's shapes.  Returns (launches of each
    run by name, records, border-lane records, the batched call's (busy,
    operations, wall), {"batch": that batch and its camera, "objects": the
    one-BA-a-batch run's objects.txt})."""
    from object_oriented_slam_tpu_torch.io.writers import load_objects
    from object_oriented_slam_tpu_torch.system.metrics import object_map_iou
    seq, settings, gt = cli["seq"], cli["settings"], cli["gt"]
    ref, text_ref = cli["ref"]
    fps_ref, host_ref = cli["rates"]["mono adaptive"]
    launches_by_run, ground = {}, None
    for name, extra in OFFLINE_RUNS:
        out = os.path.join(tmp, name.replace(" ", "_"))
        (slam, printed, stats, mapper, launches, grabs, calls,
         per_frame) = drive_offline(settings, seq, out,
                                    [*extra, "--batch", str(OFFLINE_BATCH)])
        ground = slam.tracker.state.ground_plane
        insts, vecs = load_objects(os.path.join(out, "objects.txt"))
        objs = dict(zip(insts, vecs))
        text_out = open(os.path.join(out, "objects.txt")).read()
        errs = np.array([np.linalg.norm(v[:3] - gt[i][:3])
                         for i, v in objs.items()])
        iou = np.array(list(object_map_iou(
            objs, {i: gt[i] for i in objs}).values()))
        batches = stats["batches"]
        host_ms = stats["seconds"] * 1e3 / stats["frames"]
        for line in printed.splitlines():
            if line.startswith("Offline:"):
                print(f"[offline] {name}: CLI: {line}")
        print(f"[offline] {name}: {len(objs)}/24 objects; centre error median "
              f"{np.median(errs):.4g} m, max {errs.max():.4g} m; map IoU "
              f"median {np.median(iou):.4f}, min {iou.min():.4f}; "
              f"{stats['fps']:.2f} frames/s, {host_ms:.3f} host ms a frame "
              f"(host clock around OfflineMapper.run, "
              f"{stats['seconds']:.3f} s for {stats['frames']} frames) "
              f"against the adaptive mono CLI run's {fps_ref:.2f} frames/s "
              f"and {host_ref:.3f} ms a frame (track_with_objects); "
              f"{batches} batches of {OFFLINE_BATCH}, {per_frame} frames "
              f"through the per-frame path; batch counts of the first: "
              f"{mapper.batch_stats[0]}; {grabs} grabs and {calls} batched "
              f"calls under the synchronisation check")
        print(f"[offline] {name}: kernel launches {launches}")
        if stats["frames"] != N_DEPTH_FRAMES or len(objs) != 24 \
                or not np.median(errs) <= 0.05:
            raise RuntimeError(f"{name}: {stats['frames']} frames, "
                               f"{len(objs)} of 24 objects, median centre "
                               f"error {np.median(errs):.4g} m")
        if grabs != N_DEPTH_FRAMES - per_frame or calls < batches:
            raise RuntimeError(f"{name}: {grabs} grabs and {calls} batched "
                               f"calls under the synchronisation check")
        split = "split" in name
        once = batches + per_frame
        want = {"depth_cloud": once, "voxel_downsample": once,
                "symmetry_search": once,
                "cluster_components": 0 if split else once}
        if {k: launches[k] for k in want} != want or per_frame < 1:
            raise RuntimeError(f"{name} launched {launches}, the frontend "
                               f"kernels not {want}")
        if name == "offline per-frame BA":
            diff = max(np.abs(objs[i] - ref[i]).max() for i in ref)
            print(f"[offline] {name} against the adaptive mono CLI run: "
                  f"objects.txt max |diff| {diff:.3g} (limit 1e-3), "
                  f"bit-equal files: {text_out == text_ref}; LM launches "
                  f"{launches['ba_normal_eq']} / {launches['ba_chi2']} "
                  f"against its {cli['launches']['ba_normal_eq']} / "
                  f"{cli['launches']['ba_chi2']}")
            if sorted(objs) != sorted(ref) or not diff <= 1e-3:
                raise RuntimeError(f"the {name} run's objects.txt differs "
                                   f"from the adaptive mono run's by {diff}")
        launches_by_run[name] = launches
    if not (launches_by_run["offline"]["ba_normal_eq"]
            < launches_by_run["offline per-frame BA"]["ba_normal_eq"]):
        raise RuntimeError("one BA a batch launched no fewer BA kernels than "
                           "one a frame")
    fb, cam, inputs, packed = offline_batch(dev, seq, settings, ground)
    busy, ops, wall = batch_call_overhead(dev, fb, cam, sym_call)
    recs, border_recs = frame_lane_checks(dev, fb, cam, inputs)
    kept = {"batch": (fb, cam),
            "grid_batch": (fb, cam, inputs, packed, ground),
            "objects": os.path.join(tmp, "offline", "objects.txt")}
    return launches_by_run, recs, border_recs, (busy, ops, wall), kept


# [slam]: SLAM mode on [cli]'s export with its odometry.txt (1 cm of
# random-walk drift a frame), as the CLI runs it: LMConfig(iters=SLAM_ITERS),
# the banded solve, the packer's grow-only tiers
SLAM_ITERS = 10
SLAM_SOURCE = "object_oriented_slam_tpu_torch/csrc/slam_edges.cu"
# the JAX functions K11's two instantiations replace (left to XLA there)
SLAM_REPLACES = {
    "slam_edge_terms": "object_oriented_slam_tpu/backend/slam_ba.py:79",
    "slam_chi2": "object_oriented_slam_tpu/backend/slam_ba.py:142"}
K11_OUTPUTS = ("r2", "Jp2", "Jo2", "r3", "Jp3", "Jo3", "ro", "Ji", "Jj",
               "rg", "Jg")


def slam_ops(g, K_mat, normal, workdir):
    """The f32 operations K11's two instantiations need on graph ``g``,
    counted on this graph by examples/torch_slam_edges_on_cpu.count_ops:
    the chains built on the host with g++ and an f32 type that counts its
    operations (one per + - * / compare, sqrt, sin, cos, atan2, acos,
    negation), over the live edges only (non-zero weight: the others' r
    and J are zeros), an edge's primal chain once (a 3D edge's: its four
    yaw candidates') and its tangent work once a direction, a 3D edge's
    for its winning candidate alone (the kernel's threads of an edge each
    recompute the primal chain; that is not counted); ``every_candidate``
    beside it, the Jacobian's count with every candidate's tangents."""
    return example("torch_slam_edges_on_cpu").count_ops(
        type(g)(*[t.cpu() for t in g]), K_mat.cpu(), normal.cpu(), workdir)


def slam_bound(kernel, g, K_mat, normal, outputs, ops):
    """(bound_ms, bound_by) of one K11 launch on graph ``g``: every input
    the kernel reads (the poses, objects and every edge array) read once
    and every output written once, against ``ops`` (slam_ops) of the
    instantiation."""
    from object_oriented_slam_tpu_torch.backend import slam_ba
    tensors = [getattr(g, name) for name in slam_ba.JAX_FIELDS
               if name not in ("frame_mask", "obj_mask")]
    tensors += [K_mat, normal, *outputs]
    n_bytes = sum(t.numel() * t.element_size() for t in tensors)
    n_ops = sum(ops[kernel].values())
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_F32 * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def k11_errors(got, want, want64, want_cpu):
    """K11's outputs (r2 ... Jg) against the plain version's, edge by edge:
    (per output the largest |got - want| over the largest |want|, the
    largest absolute error, per output whether every edge is within its
    tolerance, per output the largest edge error over its tolerance).  An
    edge's error is the largest distance of its entries from the float64
    evaluation ``want64``; its tolerance 1e-4 of the output's largest
    entry or, where larger, 4 times the largest distance of the edge's
    entries in the plain version's two f32 evaluations, on the card
    (``want``) and on the CPU (``want_cpu``), from ``want64``: the
    projected-bbox chain (the conic's inverse and the ellipse's axes)
    loses digits on some views, in every f32 evaluation alike, by an
    amount that differs from one evaluation to the next, so the slack an
    edge gets is its own.  NaN must match NaN and an infinity the same
    infinity; raises where they do not."""
    rel, abs_err, ok, worst = {}, 0.0, {}, {}
    for name, a, b, c, p in zip(K11_OUTPUTS, got, want, want64, want_cpu):
        if b.numel() == 0:
            continue
        E = b.shape[0]
        a, b, c = (t.double().reshape(E, -1) for t in (a, b, c))
        p = p.to(a.device).double().reshape(E, -1)
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            raise RuntimeError(f"K11 {name}: NaNs in different places")
        inf = torch.isinf(a) | torch.isinf(b)
        if not torch.equal(a[inf], b[inf]):
            raise RuntimeError(f"K11 {name}: infinities in different places")
        fin = torch.isfinite(b) & torch.isfinite(c) & torch.isfinite(p)
        if not bool(fin.any()):
            continue
        a, b, c, p = (torch.where(fin, t, 0.0) for t in (a, b, c, p))
        scale = float(b.abs().max())
        d = float((a - b).abs().max())
        err = (a - c).abs().amax(1)
        own = torch.maximum((b - c).abs(), (p - c).abs()).amax(1)
        tol = torch.clamp(4 * own, min=1e-4 * scale)
        rel[name] = d / scale if scale > 0 else (0.0 if d == 0 else
                                                 float("inf"))
        worst[name] = float((err / tol).max()) if scale > 0 else (
            0.0 if float(err.max()) == 0 else float("inf"))
        ok[name] = worst[name] <= 1.0
        abs_err = max(abs_err, d)
    return rel, abs_err, ok, worst


def k11_neq_errors(got, want, g):
    """K11 through the normal equations it feeds: the banded assembly's
    blocks from K11's terms and from the plain version's, as neq_errors
    holds K1-K4: per live frame max(|dD|, |dbp|, |dB|) over max|D| of the
    frame, per live object max(|dHoo|, |dbo|) over max|Hoo| of the
    object, and the coupling U over its largest entry.  Returns (largest
    relative error, {part: largest relative error})."""
    from object_oriented_slam_tpu_torch.backend import slam_ba
    F, K = g.poses_cw.shape[0], g.objects.shape[0]
    parts = []
    for terms in (got, want):
        terms = [t.to(g.poses_cw.device).double() for t in terms]
        D, bp = slam_ba._pose_diagonal(terms, g, F)
        B = slam_ba._seg(slam_ba._jtj(terms[7], terms[8]), g.seg_odo_i)
        parts.append((D, bp, B, *slam_ba._object_blocks(terms, g, F, K)))
    (D, bp, B, Hoo, bo, U), (Dp, bpp, Bp, Hoop, bop, Up) = parts
    fm, om = g.frame_mask, g.obj_mask
    s_f = Dp.abs().flatten(1).amax(1).clamp_min(1e-30)
    s_o = Hoop.abs().flatten(1).amax(1).clamp_min(1e-30)
    e_f = torch.stack([(D - Dp).abs().flatten(1).amax(1),
                       (bp - bpp).abs().amax(1),
                       (B - Bp).abs().flatten(1).amax(1)]).amax(0) / s_f
    e_o = torch.maximum((Hoo - Hoop).abs().flatten(1).amax(1),
                        (bo - bop).abs().amax(1)) / s_o
    e_u = float((U - Up).abs().max() / Up.abs().max().clamp_min(1e-30))
    out = {"frames": float(e_f[fm].max()), "objects": float(e_o[om].max()),
           "U": e_u}
    return max(out.values()), out


def as_f64(g, *tensors):
    """The graph and tensors with every float field in float64."""
    g64 = type(g)(*[t.double() if t.is_floating_point() else t for t in g])
    return (g64, *[t.double() for t in tensors])


def nonfinite_tangent_edges(terms):
    """Edges whose residual is finite and some Jacobian entry is not (the
    JAX package gates a SLAM edge on its residual alone, so such an edge
    reaches the normal equations): {kind: count}."""
    out = {}
    for kind, (r, *J) in (("2d", terms[0:3]), ("3d", terms[3:6]),
                          ("odo", terms[6:9]), ("grav", terms[9:11])):
        r_ok = torch.isfinite(r).all(-1)
        J_ok = torch.stack([torch.isfinite(j).flatten(1).all(-1)
                            for j in J]).all(0)
        out[kind] = int((r_ok & ~J_ok).sum())
    return out


def dense_against_banded(g, K_mat, normal, cfg):
    """optimize_slam banded and dense, each on its own path, with their
    traces: (per iteration of the banded path the dense Schur step from
    the same iterate and lambda against the banded one, as (largest
    |d dx_p| over max |dx_p|, the same for the objects); {banded: [(trial
    chi2, current chi2, accepted)]}).  Reads the traces on the host, so it
    is outside the synchronisation check."""
    from object_oriented_slam_tpu_torch.backend import slam_ba
    traces = {True: [], False: []}
    for banded, trace in traces.items():
        slam_ba.optimize_slam(g, K_mat, normal, cfg, 64, banded=banded,
                              trace=trace)
    dense = slam_ba.schur_step(g, K_mat, normal, 64, banded=False)
    steps = []
    for t in traces[True]:
        dx_p, dx_o, _ = dense(t.poses, t.objects, t.lam)
        steps.append(tuple(
            float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            for a, b in ((dx_p, t.dx_p), (dx_o, t.dx_o))))
    trials = {banded: [(float(t.trial_chi2), float(t.chi2), bool(t.accept))
                       for t in trace] for banded, trace in traces.items()}
    return steps, trials


def phase_slam(dev, tmp, cli, keep=None):
    """examples/torch_run_tum.py --odometry SEQ/odometry.txt --slam-mode on
    [cli]'s export (24 objects, N_DEPTH_FRAMES frames, synthetic_depth_sym.
    yaml, --extractor mono, --checkpoint), then the refinement again from
    the checkpoint at the graph the CLI built (build_slam_graph's tiers:
    frames 256, objects 32, edges from the counts).  Raises unless the run
    wrote 24 objects and N_DEPTH_FRAMES poses, all finite, launched K11's
    Jacobian instantiation SLAM_ITERS times and its chi2 one SLAM_ITERS + 1
    times; unless K11 holds against its plain version at the graph (every
    edge within 1e-4 of its output's largest entry of the float64
    evaluation or 4 times the plain version's own f32 distance from it on
    that edge, on the card or on the CPU, the NaN / infinity pattern
    equal, chi2 within 1e-5 or 4 times the plain version's own f32 error;
    k11_errors), gives the banded normal equations within 1e-4 of the
    plain version's or twice the plain version's own distance between the
    CPU and the card (k11_neq_errors), and repeats bit for bit; unless one
    optimize_slam call makes no host synchronisation (checked with the
    synchronisation check set to raise; the final read after), keeps
    frame 0 within 1e-7, ends below its
    initial chi2, repeats bit for bit, gives the CLI's files (to their
    digits), and unless the dense Schur step agrees with the banded one
    from every iterate of the banded path (2e-3 of the step) and the dense
    solve with the banded one end to end (2e-3), or, where it does not,
    the two paths part at an accept test whose trial and current chi2 tie
    within 1e-5 (chi2's f32 round-off: K11's chi2 is held at 1e-5).
    Prints the ATE of
    the odometry input and of trajectory_refined.txt against the ground
    truth, and objects_slam.txt's map beside objects.txt's; then the
    2D-only run (--no-depth) with its ATE.  ``keep``: a directory to copy
    the checkpoint, groundtruth.txt and the run's outputs into, before the
    checks that follow the run.  Returns (launches of the run, K11's
    records, (the checkpoint's graph, K, the ground normal))."""
    from object_oriented_slam_tpu_torch.backend import (LMConfig, slam_ba,
                                                        slam_kernels)
    from object_oriented_slam_tpu_torch.io.writers import load_objects
    from object_oriented_slam_tpu_torch.system.checkpoint import load_state
    from object_oriented_slam_tpu_torch.system.metrics import (
        ate_rmse, object_map_iou)
    from object_oriented_slam_tpu_torch.system.slam_mode import \
        build_slam_graph
    from object_oriented_slam_tpu_torch.system.tracking import _np_se3_inv

    seq, settings, gt = cli["seq"], cli["settings"], cli["gt"]
    out = os.path.join(tmp, "slam")
    ckpt = os.path.join(tmp, "slam_state.npz")
    t0 = time.perf_counter()
    slam, printed, e2e, checked, _, launches, _, _ = drive_cli(
        dev, settings, seq, out,
        ["--extractor", "mono", "--odometry",
         os.path.join(seq, "odometry.txt"), "--slam-mode", "--checkpoint",
         ckpt])
    run_s = time.perf_counter() - t0
    want = {"slam_edge_terms": SLAM_ITERS, "slam_chi2": SLAM_ITERS + 1}
    lines = [ln for ln in printed.splitlines() if ln.startswith("SLAM mode:")]
    print(f"[slam] CLI: {lines[0] if lines else 'no SLAM mode line'}; the "
          f"whole run {run_s:.1f} s (host clock), {len(e2e)} frames, "
          f"{checked} under the synchronisation check; kernel launches "
          f"{launches}")
    if not lines or {k: launches[k] for k in want} != want:
        raise RuntimeError(f"the SLAM-mode run launched {launches}, K11 not "
                           f"{want}")

    if keep:
        import shutil
        os.makedirs(keep, exist_ok=True)
        for src in (ckpt, os.path.join(seq, "groundtruth.txt"),
                    os.path.join(seq, "objects_gt.txt"),
                    *[os.path.join(out, name) for name in (
                        "trajectory_refined.txt", "objects_slam.txt",
                        "objects.txt")]):
            shutil.copy(src, keep)
    traj = np.loadtxt(os.path.join(out, "trajectory_refined.txt"), ndmin=2)
    maps = {}
    for name in ("objects.txt", "objects_slam.txt"):
        insts, vecs = load_objects(os.path.join(out, name))
        maps[name] = dict(zip(insts, vecs))
    state = load_state(ckpt)
    inp = np.stack(state.frames_pose_wc)
    gt_traj = np.loadtxt(os.path.join(seq, "groundtruth.txt"), ndmin=2)[:, 1:]
    if (traj.shape != (N_DEPTH_FRAMES, 8) or len(inp) != N_DEPTH_FRAMES
            or len(maps["objects_slam.txt"]) != len(gt)
            or not np.isfinite(traj).all()
            or not all(np.isfinite(v).all()
                       for v in maps["objects_slam.txt"].values())):
        raise RuntimeError(f"SLAM mode wrote {traj.shape} poses and "
                           f"{len(maps['objects_slam.txt'])} objects")
    ate = {name: (ate_rmse(xyz, gt_traj[:, :3]),
                  ate_rmse(xyz, gt_traj[:, :3], align=False))
           for name, xyz in (("odometry input", inp[:, :3]),
                             ("trajectory_refined.txt", traj[:, 1:4]))}
    for name, (aligned, raw) in ate.items():
        print(f"[slam] ATE of the {name} against groundtruth.txt: "
              f"{aligned * 100:.4f} cm RMSE after the Umeyama alignment, "
              f"{raw * 100:.4f} cm without")
    for name, objs in maps.items():
        errs = np.array([np.linalg.norm(v[:3] - gt[i][:3])
                         for i, v in objs.items()])
        iou = np.array(list(object_map_iou(
            objs, {i: gt[i] for i in objs}).values()))
        print(f"[slam] {name}: {len(objs)}/{len(gt)} objects; centre error "
              f"median {np.median(errs):.4g} m, max {errs.max():.4g} m; map IoU "
              f"median {np.median(iou):.4f}, min {iou.min():.4f}")

    # the same on the 2D-only path (--no-depth: no 3D edges and no ground
    # plane, so no gravity prior), where the JAX package's record has SLAM
    # mode lower the odometry's ATE
    out2 = os.path.join(tmp, "slam_2d")
    _, printed2, _, _, _, launches2, _, _ = drive_cli(
        dev, settings, seq, out2,
        ["--no-depth", "--odometry", os.path.join(seq, "odometry.txt"),
         "--slam-mode"])
    traj2 = np.loadtxt(os.path.join(out2, "trajectory_refined.txt"), ndmin=2)
    insts2, vecs2 = load_objects(os.path.join(out2, "objects_slam.txt"))
    objs2 = dict(zip(insts2, vecs2))
    lines2 = [ln for ln in printed2.splitlines()
              if ln.startswith("SLAM mode:")]
    errs2 = np.array([np.linalg.norm(v[:3] - gt[i][:3])
                      for i, v in objs2.items()] or [np.nan])
    ate2 = ate_rmse(traj2[:, 1:4], gt_traj[:, :3])
    print(f"[slam] 2D-only (--no-depth): CLI: "
          f"{lines2[0] if lines2 else 'no SLAM mode line'}; ATE of the "
          f"refined trajectory {ate2 * 100:.4f} cm (Umeyama-aligned; the "
          f"input's {ate['odometry input'][0] * 100:.4f} cm); "
          f"objects_slam.txt {len(objs2)} objects, centre error median "
          f"{np.median(errs2):.4g} m; K11 launches "
          f"{ {k: launches2[k] for k in want} }")
    if (not lines2 or {k: launches2[k] for k in want} != want
            or traj2.shape != (N_DEPTH_FRAMES, 8)
            or not np.isfinite(traj2).all()):
        raise RuntimeError("the 2D-only SLAM-mode run failed")

    # the graph the CLI refined, rebuilt from its checkpoint
    cfg = LMConfig(iters=SLAM_ITERS)
    g, insts = build_slam_graph(state, cfg, device=dev)
    K_mat = torch.as_tensor(np.asarray(slam.tracker.K, np.float32), device=dev)
    normal = torch.as_tensor(np.asarray(state.ground_plane[:3], np.float32),
                             device=dev)
    E2, E3, Eo = g.e2_w.shape[0], g.e3_w.shape[0], g.odo_w.shape[0]
    F, Ko = g.poses_cw.shape[0], g.objects.shape[0]
    live = [int((w != 0).sum()) for w in (g.e2_w, g.e3_w, g.odo_w, g.grav_w)]
    shape = (F, Ko, E2, E3, Eo)
    print(f"[slam] graph: frames {F} ({int(g.frame_mask.sum())} live), "
          f"objects {Ko} ({int(g.obj_mask.sum())} live), 2D edges {E2} "
          f"({live[0]} live), 3D edges {E3} ({live[1]}), odometry {Eo} "
          f"({live[2]}), gravity priors {live[3]}")

    # K11 against its plain version at the graph's initial estimate
    args = (g.poses_cw, g.objects, g, K_mat, normal)
    got = slam_kernels.edge_terms(*args)
    again = slam_kernels.edge_terms(*args)
    plain = slam_ba.edge_terms_plain(*args)
    g64, p64, o64, K64, n64 = as_f64(g, g.poses_cw, g.objects, K_mat, normal)
    plain64 = slam_ba.edge_terms_plain(p64, o64, g64, K64, n64)
    gc = type(g)(*[t.cpu() for t in g])
    plain_cpu = slam_ba.edge_terms_plain(gc.poses_cw, gc.objects, gc,
                                         K_mat.cpu(), normal.cpu())
    rel, abs_err, ok, worst = k11_errors(got, plain, plain64, plain_cpu)
    neq_rel, neq_parts = k11_neq_errors(got, plain, g)
    neq_cpu, neq_cpu_parts = k11_neq_errors(plain_cpu, plain, g)
    bits = all(same_bits(a, b) for a, b in zip(got, again))
    c_k, c_k2 = slam_kernels.chi2(*args), slam_kernels.chi2(*args)
    c_p = slam_ba._chi2_plain(*args)
    c_64 = float(slam_ba._chi2_plain(p64, o64, g64, K64, n64))
    c_rel = rel_err(c_k.double(), c_p.double())
    c_ok = abs(float(c_k) - float(c_p)) <= max(1e-5 * abs(float(c_p)),
                                               4 * abs(float(c_p) - c_64))
    frozen = nonfinite_tangent_edges(got)
    print(f"[slam] K11 edge terms against the plain version: relative error "
          f"per output {({k: float(f'{v:.3g}') for k, v in rel.items()})}; "
          f"edge by edge, the largest distance from float64 over its "
          f"tolerance (1e-4 of the output's largest entry, or 4 times the "
          f"plain version's distance on the card and on the CPU) "
          f"{({k: float(f'{v:.3g}') for k, v in worst.items()})}, within "
          f"{all(ok.values())}; max abs {abs_err:.3g}; through the banded "
          f"normal equations {neq_rel:.3g} "
          f"{({k: float(f'{v:.3g}') for k, v in neq_parts.items()})}, the "
          f"plain version on the CPU against on the card {neq_cpu:.3g} "
          f"{({k: float(f'{v:.3g}') for k, v in neq_cpu_parts.items()})} "
          f"(limit: 1e-4, or twice that); "
          f"repeat bit-equal {bits}; chi2 {float(c_k):.8g} against "
          f"{float(c_p):.8g} (float64 {c_64:.8g}), rel {c_rel:.3g} (1e-5, "
          f"or 4 times the plain version's float64 distance), repeat "
          f"bit-equal {same_bits(c_k, c_k2)}; edges with a finite residual "
          f"and a non-finite Jacobian entry {frozen}")
    if (not all(ok.values()) or not neq_rel <= max(1e-4, 2 * neq_cpu)
            or not bits or not c_ok or not same_bits(c_k, c_k2)):
        raise RuntimeError("K11 disagrees with its plain version or does not "
                           "repeat")
    bench = example("torch_slam_edges_bench")
    ms, ev = checked_device_ms(lambda: slam_kernels.edge_terms(*args), 20,
                               "slam_edge_terms_kernel")
    ms_c, ev_c = checked_device_ms(lambda: slam_kernels.chi2(*args), 20,
                                   "slam_chi2_kernel")
    plain_ms = cuda_ms(lambda: slam_ba.edge_terms_plain(*args), 3, 1)
    plain_c = cuda_ms(lambda: slam_ba._chi2_plain(*args), 5, 1)
    ops = slam_ops(g, K_mat, normal, tmp)
    b_terms = slam_bound("slam_edge_terms", g, K_mat, normal, got, ops)
    b_chi2 = slam_bound("slam_chi2", g, K_mat, normal, [c_k], ops)
    b_every = slam_bound("every_candidate", g, K_mat, normal, got, ops)
    lanes = slam_kernels.LANES
    threads, blocks, dealt = slam_kernels.launch_shape(E2, E3, Eo, Ko)
    regs = bench.ptxas(slam_kernels.build_log)
    clk = bench.phase_clocks(bench.clocks_build(), *args)
    print(f"[slam] K11's operations on this graph (live edges "
          f"{ops['live']}): the edge terms {ops['slam_edge_terms']} = "
          f"{sum(ops['slam_edge_terms'].values())} (with every yaw "
          f"candidate's tangents, as a design that carries all four in duals "
          f"needs: {ops['every_candidate']} = "
          f"{sum(ops['every_candidate'].values())}, bound "
          f"{b_every[0] * 1e3:.4f} us), the chi2 {ops['slam_chi2']} = "
          f"{sum(ops['slam_chi2'].values())}")
    print(f"[slam] K11's Jacobian launch: {lanes} tangent directions a "
          f"thread, {threads} threads a block, {blocks} blocks, {dealt} "
          f"threads dealt; ptxas (registers, spill stores, spill loads) "
          f"{regs}")
    print(f"[slam] K11's Jacobian launch, phase clocks (cycles a thread, "
          f"mean / largest): {bench.clocks_text(clk)}")
    print(f"[slam] K11 edge terms at {shape}: kernel {ms:.4f} ms (CUDA "
          f"events {ev:.4f}), plain {plain_ms:.4f} ms, "
          f"{bound_text(ms, b_terms)}; chi2 kernel {ms_c:.4f} ms (events "
          f"{ev_c:.4f}), plain {plain_c:.4f} ms, {bound_text(ms_c, b_chi2)}")

    # one optimize_slam call: K11's launches, no host synchronisation
    chi2_0 = float(slam_ba._chi2(*args))

    def call(banded=True):
        return slam_ba.optimize_slam(g, K_mat, normal, cfg, banded=banded)

    for k in slam_kernels.KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    per_call = {k.name: k.launches for k in slam_kernels.KERNELS}
    repeat = all(same_bits(a, b) for a, b in zip(res, call()))
    poses, objs, chi2 = (t.cpu() for t in res)
    gauge = float((poses[0] - g.poses_cw[0].cpu()).abs().max())
    poses_wc = np.stack([_np_se3_inv(p) for p in
                         poses.double().numpy()[:len(inp)]])
    cli_pose = float(np.abs(poses_wc - traj[:, 1:]).max())
    cli_obj = max(float(np.abs(objs[k].double().numpy()
                               - maps["objects_slam.txt"][i]).max())
                  for k, i in enumerate(insts))
    final = nonfinite_tangent_edges(slam_kernels.edge_terms(
        res[0], res[1], g, K_mat, normal))
    print(f"[slam] one optimize_slam call (banded, {SLAM_ITERS} iterations): "
          f"K11 launches {per_call}; no host synchronisation inside; chi2 "
          f"{chi2_0:.8g} -> {float(chi2):.8g}; frame 0 moved {gauge:.3g} "
          f"(limit 1e-7); a second call bit-equal {repeat}; against the "
          f"CLI's files (the same solve, written with 9 and 10 digits): "
          f"poses {cli_pose:.3g}, objects {cli_obj:.3g} (limit 1e-8); edges "
          f"with a finite residual and a non-finite Jacobian entry at the "
          f"result {final}")
    if (per_call != want or not gauge <= 1e-7 or not float(chi2) < chi2_0
            or not bool(torch.isfinite(poses).all()
                        & torch.isfinite(objs).all())
            or not repeat or not cli_pose <= 1e-8 or not cli_obj <= 1e-8):
        raise RuntimeError("optimize_slam on the card failed a check")

    wall = wall_ms(call, 3)
    prof = device_busy(call)
    if prof is None:
        raise RuntimeError("the profiler shows no device time for "
                           "optimize_slam")
    busy, ops, top = prof
    print(f"[slam] one optimize_slam call: {wall:.3f} ms wall (host clock, "
          f"mean of 3), device busy {busy:.3f} ms over {ops} device "
          f"operations, idle {1 - busy / wall:.3f}; top {top}")

    # the dense solve at the same graph: step by step along the banded
    # call's path, then end to end
    steps, trials = dense_against_banded(g, K_mat, normal, cfg)
    p_d, o_d, c_d = (t.cpu() for t in call(banded=False))
    d_p = float((p_d - poses).abs().max())
    d_o = float((o_d - objs).abs().max())
    tie = next(((i, a, b) for i, (a, b) in enumerate(zip(
        trials[True], trials[False])) if a[2] != b[2]), None)
    print(f"[slam] dense Schur step against the banded one from each iterate "
          f"of the banded path: poses {max(s[0] for s in steps):.3g}, objects "
          f"{max(s[1] for s in steps):.3g} of the step's largest entry "
          f"(limit 2e-3); end to end (10 iterations each): poses {d_p:.3g}, "
          f"objects {d_o:.3g}, chi2 {float(c_d):.8g} against "
          f"{float(chi2):.8g}; accept decisions "
          f"{''.join('ar'[not t[2]] for t in trials[True])} banded, "
          f"{''.join('ar'[not t[2]] for t in trials[False])} dense"
          + (f"; they part at iteration {tie[0]}: trial chi2 {tie[1][0]:.9g} "
             f"/ {tie[2][0]:.9g} against the current {tie[1][1]:.9g} / "
             f"{tie[2][1]:.9g}" if tie else ""))
    if not (max(s[0] for s in steps) <= 2e-3
            and max(s[1] for s in steps) <= 2e-3):
        raise RuntimeError("the dense and banded SLAM steps disagree")
    if not (d_p <= 2e-3 and d_o <= 2e-3) and not (
            tie and min(abs(t[0] - t[1]) / t[1] for t in tie[1:]) <= 1e-5):
        raise RuntimeError("the dense and banded SLAM solves disagree, and "
                           "not by an accept test tied within chi2's f32 "
                           "round-off")
    recs = {
        "slam_edge_terms (K11)": dict(
            kernel="slam_edge_terms", shape=shape, max_abs_err=abs_err,
            max_rel_err=max(rel.values()), bound=b_terms, ms=ms,
            events_ms=ev, plain_ms=plain_ms, bits_equal=bits, lanes=lanes,
            threads=threads, blocks=blocks,
            registers=regs.get(f"slam_edge_terms<{lanes}>")),
        "slam_chi2 (K11)": dict(
            kernel="slam_chi2", shape=shape,
            max_abs_err=float((c_k.double() - c_p.double()).abs()),
            max_rel_err=c_rel, bound=b_chi2, ms=ms_c, events_ms=ev_c,
            plain_ms=plain_c, bits_equal=same_bits(c_k, c_k2),
            registers=regs.get("slam_chi2"))}
    return launches, recs, (g, K_mat, normal)


def phase_sparse_kernels(dev, path):
    """Sparse symmetry's three kernel lanes against their plain versions at
    the shapes the sparse path gave them on its mid-orbit frame (the frame
    through the extractor's own packing and stages on the card):
    depth_cloud with the border attribute, voxel_downsample with it and
    symmetry_search with the border cells as sources (exact gradient); then
    symmetry_search at sym_capacity filled with about half the points as
    sources.  Returns (path records, full-shape records)."""
    from object_oriented_slam_tpu_torch.core import se3
    from object_oriented_slam_tpu_torch.frontend import extractor as text
    scene = scene24_sym()
    cam = scene.camera
    (_, _, pose, depth, _, det), plane, stats = path
    cfg = sparse_config()
    flat, pad, _, cfg_t, n_sym = text._pack_frame(
        cam, cfg, det[:, 1:5].copy(), det[:, 5].astype(int), pose, plane)
    if stats["cloud_tier"] != cfg_t.cloud_capacity or \
            (n_sym[0], n_sym[1]) != (stats["sym_single"], stats["sym_dual"]):
        raise RuntimeError(f"the sparse path ran its mid-orbit frame at "
                           f"{stats}, the packing gives tier "
                           f"{cfg_t.cloud_capacity} and {n_sym}")
    flat_d = torch.from_numpy(flat).to(dev)
    depth_d = torch.from_numpy(np.ascontiguousarray(depth, np.int32)).to(dev)
    bb = flat_d[:pad * 4].reshape(pad, 4)
    pose_d = flat_d[pad * 6:pad * 6 + 7]
    plane_d = flat_d[pad * 6 + 7:pad * 6 + 11]
    recs = {}
    r, battr = depth_cloud_checks("sparse path", depth_d, bb, pose_d, plane_d,
                                  cam, cfg_t, border=True)
    recs["depth_cloud (sparse path)"] = r
    a = text._stage_a(depth_d, bb, pose_d, plane_d, cam, cfg_t)
    if not same_bits(a[8], battr):
        raise RuntimeError("the extractor's stage (a) border means differ "
                           "from the checked launch's")
    sel, _ = text._cluster_select_batch(a[1], a[3], a[4], a[7], cfg_t)
    r, _ = voxel_attrs_checks("sparse path", a[1], sel, a[8], cfg_t.sym_grid,
                              cfg_t.sym_capacity)
    recs["voxel_downsample (sparse path)"] = r
    Two, pts_n, obj_m, src = text._stage_post(a[1], sel, plane_d, cfg_t, a[8])
    pose_oc = se3.se3_mul(se3.se3_inv(Two), pose_d.expand(pad, 7))
    types = flat_d[pad * 5:pad * 6].to(torch.int32)
    run = flat_d[pad * 4:pad * 5] > 0.5
    searched = (types > 0) & run
    n_src, n_pts = (src & searched[:, None]).sum(1), (obj_m & searched[:, None]
                                                      ).sum(1)
    if (int(n_src.sum()), int(n_pts.sum())) != (stats["sym_sources"],
                                                 stats["sym_points"]):
        raise RuntimeError(f"the kernel phase's sources {int(n_src.sum())} / "
                           f"{int(n_pts.sum())} differ from the path's "
                           f"{stats}")
    args = (pts_n.contiguous(), obj_m.contiguous(), bb.contiguous(),
            pose_oc.contiguous(), depth_d, types, run, cam)
    recs["symmetry_search (sparse path, analytic)"] = symmetry_checks(
        "sparse path", *args, True, src.contiguous())
    # sym_capacity filled, about half of each cloud's points the sources
    full_args = full_symmetry_inputs(dev)
    rng = np.random.default_rng(SEED)
    half = torch.from_numpy(rng.random(tuple(full_args[1].shape)) < 0.5)
    full = {"symmetry_search (sparse full, analytic)": symmetry_checks(
        "sparse full", *full_args, cam, True,
        (full_args[1] & half.to(dev)).contiguous())}
    return recs, full


def sym_passes(analytic, dual, iters=5):
    """Cost passes of one initial plane's search: 1 + iters with the exact
    gradient (each pass but the last carries the gradient at its
    parameters), 1 + iters (2 n_par + 1) with central differences."""
    n_par = 3 if dual else 2
    return 1 + iters if analytic else 1 + iters * (2 * n_par + 1)


def symmetry_checks(tag, pts, mask, bbox, pose_oc, depth, types, run, cam,
                    analytic, src_mask=None, frame=None):
    """symmetry_search (K8) against estimate_symmetry_plain on the card, on
    the same inputs: every output bit for bit (the plain version sums in
    the kernel's order), and a second launch bit-equal.  With ``src_mask``
    (sparse symmetry: only the live points it holds are mirrored) also the
    search with every live point as a source, which must be the search
    without a mask bit for bit.  Its time beside its bound (the pair tests
    this data needs, SYM_PAIR_OPS each), the plain version's time and the
    yardstick (torch.cdist + torch.amin of one pass, times the passes).
    With ``frame`` (the frame lane: depth [B, H, W], each detection's
    frame index) the same checks on the lane's launch.  Returns its
    record."""
    from object_oriented_slam_tpu_torch.frontend import symmetry as sym
    from object_oriented_slam_tpu_torch.ops import backproject as bp
    cfg = sym.SymmetryConfig(analytic_grad=analytic)
    args = (pts, mask, bbox, pose_oc, depth, types, run, cam, cfg)
    got = sym.estimate_symmetry(*args, src_mask, frame)
    again = sym.estimate_symmetry(*args, src_mask, frame)
    proj = bp.proj_depth_map(depth, cam)
    want = sym.estimate_symmetry_plain(pts, mask, bbox, pose_oc, proj, types,
                                       run, cam, cfg, src_mask, frame)
    if src_mask is not None:
        every = sym.estimate_symmetry(*args, mask.clone())
        dense = sym.estimate_symmetry(*args)
    torch.cuda.synchronize()
    if not all_bits(got, again):
        raise RuntimeError(f"symmetry_search ({tag}): two launches differ")
    if src_mask is not None and not all_bits(every, dense):
        raise RuntimeError(f"symmetry_search ({tag}) with every live point "
                           "as a source differs from the search without a "
                           "source mask")
    bits = all_bits(got, want)
    live = (run & (types > 0)).cpu()
    gi, wi = got.inits.cpu()[live], want.inits.cpu()[live]
    p_err = float((gi[..., :3] - wi[..., :3]).abs().max())
    c_err = rel_err(gi[..., 3], wi[..., 3])
    off = (~live).nonzero().flatten()
    if not bits:
        raise RuntimeError(
            f"symmetry_search ({tag}) is not bit-equal to its plain version: "
            f"params within {p_err:.3g}, costs within {c_err:.3g} relative, "
            f"winners {got.prob.cpu()[live].tolist()} against "
            f"{want.prob.cpu()[live].tolist()}")
    if bool(got.inits.cpu()[off].any()) or bool(got.prob.cpu()[off].any()):
        raise RuntimeError(f"symmetry_search ({tag}) searched a detection of "
                           "type 0 or off the run mask")
    # the work this data needs: each pass tests the P n_src mirrored points
    # against the n live ones
    n = mask.sum(1).cpu()
    n_src = n if src_mask is None else (src_mask & mask).sum(1).cpu()
    pairs, groups = 0.0, {}
    for d in live.nonzero().flatten().tolist():
        dual = int(types[d]) == 2
        P, passes = 1 + dual, sym_passes(analytic, dual)
        pairs += 9 * passes * P * float(n_src[d]) * float(n[d])
        groups.setdefault(dual, []).append(d)
    per_search = {("dual" if dual else "single"): sym_passes(analytic, dual)
                  for dual in groups}
    n_bytes = sum(t.numel() * t.element_size() for t in (
        pts, mask, bbox, pose_oc, types, run, *got)) + (
        0 if src_mask is None else src_mask.numel()) + (
        0 if frame is None else 4 * frame.numel())
    t_o = pairs * SYM_PAIR_OPS / PEAK_F32 * 1e3
    t_b = n_bytes / PEAK_BYTES * 1e3
    # the yardstick: one pass's mirrored points against the live points by
    # torch.cdist and torch.amin, batched over detection and initial plane
    # at the most live points of the group, times the group's passes
    yard = 0.0
    for dual, rows in groups.items():
        m, ms = int(n[rows].max()), max(int(n_src[rows].max()), 1)
        ref = pts[rows][:, None, :m].expand(-1, 9, -1, -1).reshape(
            -1, m, 3).contiguous()
        q = ref[:, :ms].contiguous()
        if dual:
            q = torch.cat([q, q], 1)
        yard += busy_ms(lambda: torch.cdist(q, ref).amin(-1)) * \
            sym_passes(analytic, dual)
    r = dict(kernel="symmetry_search", shape=tuple(pts.shape),
             max_abs_err=max(p_err, float((got.prob - want.prob).abs().max())),
             max_rel_err=c_err, bits_equal=bits,
             bound=max((t_b, "bytes"), (t_o, "operations")),
             ms=device_ms(lambda: sym.estimate_symmetry(*args, src_mask,
                                                        frame), 10,
                          name="symmetry_search"),
             plain_ms=cuda_ms(lambda: sym.estimate_symmetry_plain(
                 pts, mask, bbox, pose_oc, proj, types, run, cam, cfg,
                 src_mask, frame), 1, 1),
             library_ms=yard, pair_tests=pairs,
             searched=int(live.sum()), live_points=int(n[live].sum()))
    sources = ""
    if src_mask is not None:
        r["source_points"] = int(n_src[live].sum())
        sources = (f", sources {n_src.tolist()} (with every live point as "
                   f"a source bit-equal to the search without a mask)")
    print(f"[frontend] symmetry ({tag}, {'analytic' if analytic else 'central'}"
          f"): {int(live.sum())} detections searched (types "
          f"{types.tolist()}), live points {n.tolist()}{sources}: bit-equal "
          f"to the plain version on the card and to a repeat; kernel "
          f"{r['ms']:.4f} ms at "
          f"{', '.join(f'{v} ({k})' for k, v in per_search.items())} cost "
          f"passes a search, "
          f"{bound_text(r['ms'], r['bound'])} ({pairs:.4g} pair tests); "
          f"plain {r['plain_ms']:.3f} ms; yardstick (cdist + amin x passes) "
          f"{yard:.4f} ms")
    return r


def full_symmetry_inputs(dev, D=8, S=512, seed=SEED):
    """sym_capacity filled: D detections of S live points each, all dual,
    half of each cloud mirrored across y = 0 (a symmetric object) and the
    near camera of the path over a wall that occludes part of the mirror."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((D, S, 3), np.float32)
    for d in range(D):
        half = rng.uniform(-0.4, 0.4, (S // 2, 3)).astype(np.float32)
        half[:, 1] = np.abs(half[:, 1]) * 0.5 + 0.01
        pts[d] = np.concatenate([half, half * np.float32([1, -1, 1])])
        pts[d] += rng.normal(0, 0.005, (S, 3)).astype(np.float32)
    mask = np.ones((D, S), bool)
    bbox = np.tile(np.float32([120, 80, 520, 400]), (D, 1))
    pose = np.tile(np.float32([0.1, -0.05, -2.5, 0, 0, 0, 1]), (D, 1))
    depth = np.full((480, 640), 11000, np.int32)
    depth[:, :260] = 0
    return [torch.from_numpy(t).to(dev) for t in (pts, mask, bbox, pose,
                                                  depth)] + [
        torch.full((D,), 2, dtype=torch.int32, device=dev),
        torch.ones(D, dtype=torch.bool, device=dev)]


def phase_symmetry_kernel(dev, path):
    """K8 against its plain version at the shapes the symmetry path gave it
    on its mid-orbit frame (the frame through the extractor's own packing
    and stages (a)-(f) on the card), single and dual detections in one
    launch, with the exact gradient and with central differences; then at
    sym_capacity filled (8 detections x 512 live points, dual).  Returns
    (path records, full-shape records)."""
    from object_oriented_slam_tpu_torch.core import se3
    from object_oriented_slam_tpu_torch.frontend import extractor as text
    scene = scene24_sym()
    cam = scene.camera
    (_, _, pose, depth, _, det), plane, stats = path
    cfg = text.ExtractorConfig(open_symmetry=True)
    flat, pad, _, cfg_t, n_sym = text._pack_frame(
        cam, cfg, det[:, 1:5].copy(), det[:, 5].astype(int), pose, plane)
    if (n_sym[0], n_sym[1]) != (stats["sym_single"], stats["sym_dual"]) \
            or not (n_sym[0] and n_sym[1]):
        raise RuntimeError(f"the mid-orbit frame has {n_sym} single / dual "
                           f"detections, the path's stats {stats}")
    flat_d = torch.from_numpy(flat).to(dev)
    depth_d = torch.from_numpy(np.ascontiguousarray(depth, np.int32)).to(dev)
    bb = flat_d[:pad * 4].reshape(pad, 4)
    pose_d = flat_d[pad * 6:pad * 6 + 7]
    plane_d = flat_d[pad * 6 + 7:pad * 6 + 11]
    a = text._stage_a(depth_d, bb, pose_d, plane_d, cam, cfg_t)
    sel, _ = text._cluster_select_batch(a[1], a[3], a[4], a[7], cfg_t)
    Two, pts_n, obj_m, _ = text._stage_post(a[1], sel, plane_d, cfg_t)
    pose_oc = se3.se3_mul(se3.se3_inv(Two), pose_d.expand(pad, 7))
    types = flat_d[pad * 5:pad * 6].to(torch.int32)
    run = flat_d[pad * 4:pad * 5] > 0.5
    args = (pts_n.contiguous(), obj_m.contiguous(), bb.contiguous(),
            pose_oc.contiguous(), depth_d, types, run, cam)
    recs = {f"symmetry_search (path, {'analytic' if an else 'central'})":
            symmetry_checks("path", *args, an) for an in (True, False)}
    full_args = (*full_symmetry_inputs(dev), cam)
    full = {"symmetry_search (full, analytic)":
            symmetry_checks("full", *full_args, True)}
    return recs, full


# [dist]: the distributed backends (object_oriented_slam_tpu_torch/parallel)
# on the card: NCCL at world size 1 in this process, then DIST_WORLD ranks
# sharing the one card over gloo (spawned processes, every tensor on
# cuda:0), then the command line under torchrun.  Every process group's
# start and collectives, every spawned rank and the torchrun launch are
# bounded by DIST_TIMEOUT seconds; a rank that fails fails the run.
DIST_WORLD = 2
DIST_TIMEOUT = 120
# the kernels each sharded call launches on a rank: K1/K2 and K3/K4 once an
# LM iteration (K3/K4 once more for the initial chi2), K11's two
# instantiations the same way, the batch's frontend kernels once
DIST_LM_LAUNCHES = {"ba_normal_eq": 10, "ba_chi2": 11}
DIST_SLAM_LAUNCHES = {"slam_edge_terms": SLAM_ITERS,
                      "slam_chi2": SLAM_ITERS + 1}
DIST_BATCH_LAUNCHES = {"depth_cloud": 1, "cluster_components": 1,
                       "voxel_downsample": 1, "symmetry_search": 1}


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dist_checks(mesh, lm, slam, batch):
    """The dry run's checks (parallel/dryrun.py) on ``mesh``: the LM at
    ``lm`` (obs, K, normal), the SLAM solve on ``slam`` (graph, K, normal)
    with shard_solve, dense and banded, and the offline batch ``batch``
    (FrameBatch, camera) where given.  Each raises past the dry run's
    tolerance; returns their reports by name."""
    from object_oriented_slam_tpu_torch.backend import LMConfig
    from object_oriented_slam_tpu_torch.parallel import dryrun
    out = {"lm": dryrun.check_lm(*lm, mesh)}
    for banded in (False, True):
        out["slam " + ("banded" if banded else "dense")] = dryrun.check_slam(
            *slam, mesh, LMConfig(iters=SLAM_ITERS), 64, shard_solve=True,
            banded=banded)
    if batch is not None:
        out["batch"] = dryrun.check_batch(*batch, mesh)
    return out


def dist_expected(name):
    return (DIST_LM_LAUNCHES if name == "lm" else DIST_BATCH_LAUNCHES
            if name == "batch" else DIST_SLAM_LAUNCHES)


def dist_report(tag, name, r, card):
    errs = {k: (float(f"{v:.9g}") if k.startswith("chi2") else
                float(f"{v:.3g}")) if isinstance(v, float) else v
            for k, v in r.items() if k not in ("launches", "seconds")}
    print(f"[dist] {tag} {name}: against the unsharded call {errs}; "
          f"launches {r['launches']}; host s sharded {r['seconds'][0]:.4f}, "
          f"unsharded {r['seconds'][1]:.4f} (informational; {card})")
    want = dist_expected(name)
    if r["launches"] != want:
        raise RuntimeError(f"[dist] {tag} {name} launched {r['launches']}, "
                           f"not {want}")


def dist_rank_main(rank, workdir):
    """One of the DIST_WORLD gloo ranks sharing cuda:0 (``chip_smoke.py
    --dist-rank R --dist-dir DIR``): the dry run's checks on the inputs
    phase_dist saved in DIR, the report in DIR/rank{R}.json."""
    import pickle
    from object_oriented_slam_tpu_torch.backend import (
        observations_from_numpy, slam_ba)
    from object_oriented_slam_tpu_torch.parallel import multihost
    dev = torch.device("cuda", 0)
    multihost.initialize(backend="gloo", device=dev,
                         init_method="file://" + os.path.join(workdir,
                                                              "store"),
                         world_size=DIST_WORLD, rank=rank,
                         timeout_s=DIST_TIMEOUT)
    try:
        mesh = multihost.observation_mesh(dev)
        inp = np.load(os.path.join(workdir, "inputs.npz"))
        K = torch.as_tensor(inp["K"], device=dev)
        obs = observations_from_numpy(
            {k[3:]: inp[k] for k in inp.files if k.startswith("lm_")}, dev)
        g = slam_ba.graph_from_numpy(
            {k[5:]: inp[k] for k in inp.files if k.startswith("slam_")}, dev)
        with open(os.path.join(workdir, "batch.pkl"), "rb") as f:
            batch = pickle.load(f)
        out = dist_checks(
            mesh, (obs, K, torch.as_tensor(inp["lm_normal_"], device=dev)),
            (g, torch.as_tensor(inp["slam_K_"], device=dev),
             torch.as_tensor(inp["slam_normal_"], device=dev)), batch)
        with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        multihost.shutdown()
    return 0


def dist_cli_main(argv, workdir):
    """examples/torch_run_tum.main on ``argv`` in one rank of a torchrun
    launch (``chip_smoke.py --dist-dir DIR --dist-cli ARGV``), every launch
    counter set to 0 just before; writes the rank's launches to
    DIR/cli_rank{R}.json.  A file, not a line of output: the ranks share
    torchrun's stdout, where their writes interleave mid-line."""
    from object_oriented_slam_tpu_torch.backend import ba_kernels, slam_kernels
    from object_oriented_slam_tpu_torch.ops import frontend_kernels as fk
    kernels = (*ba_kernels.KERNELS, *fk.KERNELS, *slam_kernels.KERNELS)
    for k in kernels:
        k.launches = 0
    example("torch_run_tum").main(argv)
    rank = int(os.environ["RANK"])
    with open(os.path.join(workdir, f"cli_rank{rank}.json"), "w") as f:
        json.dump({k.name: k.launches for k in kernels}, f)
    return 0


def run_bounded(cmd, what, **kw):
    """A child process bounded by DIST_TIMEOUT (killed past it); raises
    unless it exits 0.  Returns its output."""
    try:
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=DIST_TIMEOUT, **kw)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"[dist] {what} ran past {DIST_TIMEOUT} s: "
                           f"{(e.stdout or '')[-3000:]}") from e
    if p.returncode != 0:
        raise RuntimeError(f"[dist] {what} exited {p.returncode}:\n"
                           f"{(p.stdout + p.stderr)[-6000:]}")
    return p.stdout


def phase_dist(dev, tmp, cli, slam_problem, offline):
    """The distributed backends on the card.

    1. NCCL at world size 1 in this process: optimize_objects_sharded at
       the LM's FULL tier against optimize_objects_soa, and
       optimize_slam_sharded(shard_solve=True), dense and banded, at
       [slam]'s graph against optimize_slam on the same (padded) graph;
       a default System's open_distributed_backend() on the default mesh.
    2. DIST_WORLD ranks sharing the card over gloo (chip_smoke.py
       --dist-rank): the same solvers at the same sizes, each rank half
       the observations or edges and half the frames of the Schur solve,
       and one [offline] batch through dispatch_batch(mesh=...).
    3. examples/torch_run_tum.py --distributed --offline --offline-shard
       --batch 8 on [cli]'s export under torch.distributed.run with
       DIST_WORLD gloo ranks: rank 0's objects.txt against [offline]'s
       unsharded run's (24 objects within 1e-3).

    Each sharded result is held against its unsharded twin at the dry
    run's tolerances (parallel/dryrun.py), and each rank must have
    launched K1-K4, K11 and K5-K8 on its own shard (its launch counters).
    Times are two processes time-slicing one card over gloo: printed with
    the card's line, claimed nowhere.  Returns (the spawned ranks'
    reports, the CLI ranks' launches)."""
    import pickle
    from object_oriented_slam_tpu_torch.io.writers import load_objects
    from object_oriented_slam_tpu_torch.parallel import multihost
    card = card_line()
    arrays, obs, args = lm_inputs(FULL, dev)
    lm = (obs, args[6], args[5])
    g, K_mat, normal = slam_problem

    multihost.initialize(backend="nccl", device=dev,
                         init_method=f"tcp://localhost:{free_port()}",
                         world_size=1, rank=0, timeout_s=DIST_TIMEOUT)
    try:
        nccl = dist_checks(multihost.observation_mesh(dev), lm, slam_problem,
                           None)
        # the user's call: a default System (an unindexed cuda) opens the
        # backend on the default mesh
        from object_oriented_slam_tpu_torch.system import System
        slam = System(cli["settings"])
        slam.open_distributed_backend()
        mesh = slam.tracker._mesh
        print(f"[dist] System(settings).open_distributed_backend(): mesh of "
              f"{mesh.size} rank(s) on {mesh.device}, the tracker on "
              f"{slam.tracker.device}")
    finally:
        multihost.shutdown()
    for name, r in nccl.items():
        dist_report("nccl, world size 1:", name, r, card)

    workdir = os.path.join(tmp, "dist")
    os.makedirs(workdir)
    np.savez(os.path.join(workdir, "inputs.npz"),
             lm_normal_=np.asarray(NORMAL, np.float32),
             K=args[6].cpu().numpy(),
             slam_K_=K_mat.cpu().numpy(), slam_normal_=normal.cpu().numpy(),
             **{"lm_" + k: v for k, v in arrays.items()},
             **{"slam_" + k: getattr(g, k).cpu().numpy()
                for k in type(g)._fields if not k.startswith("seg_")})
    with open(os.path.join(workdir, "batch.pkl"), "wb") as f:
        pickle.dump(offline["batch"], f)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dist-rank", str(r),
         "--dist-dir", workdir], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(DIST_WORLD)]
    try:
        logs = [p.communicate(timeout=DIST_TIMEOUT)[0] for p in procs]
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"[dist] a gloo rank ran past {DIST_TIMEOUT} "
                           "s") from e
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"[dist] gloo rank {r} exited {p.returncode}:"
                               f"\n{log[-6000:]}")
    ranks = []
    for r in range(DIST_WORLD):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
        for name, rep in ranks[-1].items():
            dist_report(f"gloo rank {r} of {DIST_WORLD} on cuda:0:", name,
                        rep, card)

    out = os.path.join(tmp, "dist_cli")
    t0 = time.perf_counter()
    printed = run_bounded(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(DIST_WORLD), os.path.abspath(__file__),
         "--dist-dir", workdir, "--dist-cli", cli["settings"], cli["seq"],
         "--out", out,
         "--extractor", "mono", "--distributed", "--offline",
         "--offline-shard", "--batch", str(OFFLINE_BATCH), "--dist-backend",
         "gloo"], "torchrun of torch_run_tum.py")
    cli_s = time.perf_counter() - t0
    cli_launches = []
    for r in range(DIST_WORLD):
        with open(os.path.join(workdir, f"cli_rank{r}.json")) as f:
            cli_launches.append(json.load(f))
    got = dict(zip(*load_objects(os.path.join(out, "objects.txt"))))
    want = dict(zip(*load_objects(offline["objects"])))
    diff = max((np.abs(got[i] - want[i]).max() for i in want if i in got),
               default=np.inf)
    offline_line = next((ln for ln in printed.splitlines()
                         if "Offline:" in ln), "no Offline line")
    print(f"[dist] torch_run_tum.py --distributed --offline --offline-shard "
          f"--batch {OFFLINE_BATCH} on {DIST_WORLD} gloo ranks sharing the "
          f"card: {len(got)}/24 objects, objects.txt against the unsharded "
          f"offline run's max |diff| {diff:.3g} (limit 1e-3); rank 0: "
          f"{offline_line.strip()}; torchrun wall {cli_s:.1f} s "
          f"(informational; {card}); launches per rank {cli_launches}")
    if sorted(got) != sorted(want) or len(got) != 24 or not diff <= 1e-3:
        raise RuntimeError("[dist] the distributed CLI's objects.txt "
                           "differs from the unsharded offline run's")
    for r, launched in enumerate(cli_launches):
        if not all(launched[k] > 0
                   for k in (*DIST_LM_LAUNCHES, *DIST_BATCH_LAUNCHES)):
            raise RuntimeError(f"[dist] CLI rank {r} launched {launched}")
    return ranks, cli_launches


# ---------------------------------------------------------------------------
# [dense]: the dense builder on the command line, and K12
# ---------------------------------------------------------------------------
DENSE_SOURCE = "object_oriented_slam_tpu_torch/csrc/dense_fuse.cu"
DENSE_REPLACES = ("object_oriented_slam_tpu/system/dense_builder.py:24 "
                  "(_fuse_frame; ops/voxel.py:42 _voxel_core)")
DENSE_FRAMES = (0, N_DEPTH_FRAMES // 2)    # the first frame, a mid-orbit one


def dense_yardstick(key, vals, capacity):
    """K12's PyTorch yardstick: a stable torch.sort of the keys [N], a
    gather of the points and colours [N, 6] into that order and
    torch.segment_reduce's mean over the runs (the first ``capacity``, then
    one for the rest; run lengths taken beforehand).  Returns (device ms,
    device ms of the sort alone)."""
    from object_oriented_slam_tpu_torch.ops import voxel as vx
    ks, _ = torch.sort(key, stable=True)
    valid = ks != vx._INVALID
    new = torch.cat([torch.ones(1, dtype=torch.bool, device=key.device),
                     ks[1:] != ks[:-1]]) & valid
    seg = torch.cumsum(new, dim=0) - 1
    seg = torch.where(valid & (seg < capacity), seg, capacity)
    lengths = torch.zeros(capacity + 1, dtype=torch.int64,
                          device=key.device).scatter_add_(
                              0, seg, torch.ones_like(seg))

    def call():
        _, o = torch.sort(key, stable=True)
        return torch.segment_reduce(vals[o], "mean", lengths=lengths)

    return busy_ms(call), busy_ms(lambda: torch.sort(key, stable=True))


def dense_design_bytes(cap, F, n_live, path):
    """The bytes K12's own design moves, each pass counted (beside the
    contract's bound, which counts each input and output once): the map's
    rows read for their cells (13 bytes), again for their keys (13, from
    L2) with the key written (4), the keys read by the merge's count and
    sums (8), the rows' points and colours (24) and the output written
    (25); a frame pixel's depth and colour (16), its row written (25) and
    read back as the map's are (13 + 4 + 8 + 24), its sorted key and id
    (8).  The general path adds four radix passes over the n_live live
    keys and ids (each read twice, written once: 24 bytes a pass)."""
    n = cap * (13 + 13 + 4 + 8 + 24 + 25) + F * (16 + 25 + 13 + 4 + 8 + 24 + 8)
    return n + (4 * 24 * n_live if path else 0)


def dense_largest_bucket(state, frame, cam, leaf, stride, depth_range):
    """The most live frame pixels in one bucket of K12's frame sort, as
    its frame_buckets and phase_keys make them (the frame's cells less
    their least, a mixed-radix key over the frame's extent, 4,096 ranges),
    0 where a frame cell clips: the fast path sorts buckets of up to 64
    pixels by a warp and of up to 1,024 by the block, and a larger one
    sends the frame's keys to the general sort."""
    from object_oriented_slam_tpu_torch.ops import dense_fuse as df
    from object_oriented_slam_tpu_torch.ops import voxel as vx
    w, _, fm = df.frame_points_plain(*frame, cam, stride, depth_range)
    cells = vx.voxel_cells(torch.cat([state[0], w]), leaf)
    live = torch.cat([state[2], fm])
    cmin = torch.where(live[:, None], cells, 2 ** 30).amin(0)
    fc = cells[state[0].shape[0]:][fm]
    if len(fc) == 0 or bool(((fc - cmin) > 1023).any()):
        return 0
    lo = fc.amin(0)
    n = (fc.amax(0) - lo + 1).tolist()
    rel = (fc - lo).long()
    compact = (rel[:, 0] * n[1] + rel[:, 1]) * n[2] + rel[:, 2]
    mul = (1 << 44) // (n[0] * n[1] * n[2])
    return int(torch.bincount((compact * mul) >> 32).max())


def dense_checks(dev, tag, state, frame, cam, b):
    """K12 at one (map, frame): against its plain version on the CPU (bit
    for bit) and on the card (index_add_'s atomics: points 1e-6, colours 1e-4),
    repeats bit-equal; the path the fuse took (the tally: 0 the fast
    merge, 1 the general sort) and the device operations of one fuse
    (the profiler's); device ms of one fuse (the profiler's events) beside
    CUDA events, each with a reload of the map before each fuse, timed
    alone and taken off (PR 16's way), and beside them a fuse of the map
    from the buffer it was loaded into once (``loaded_ms``), the bound (map
    in and out, the frame's strided pixels, each byte once) and the
    design's own bytes (dense_design_bytes, printed), the plain version's
    ms on the card and the yardstick's.  Raises unless the fuse is bit
    for bit the plain version's on the CPU.  Returns the record."""
    from object_oriented_slam_tpu_torch.ops import dense_fuse as df
    depth, rgb, pose = frame
    H, W = depth.shape
    cap, stride = b.capacity, b.stride
    args = (cam, b.leaf, b.depth_range)
    work = df.FuseWork(cap, H, W, stride, dev)
    work.load(*state)
    a = work.cur

    def fuse():
        # the map stays in buffer a (a fuse reads it and writes the other
        # buffer), so every repeat fuses the same inputs
        work.cur = a
        return work.fuse(depth, rgb, pose, *args)

    def fuse_reload():
        work.load(*state)
        return work.fuse(depth, rgb, pose, *args)

    launched = df.DENSE_FUSE.launches       # comparisons are not the path's
    tally = work.tally.clone()
    got = [t.clone() for t in fuse()]
    path = int(torch.argmax(work.tally - tally))
    again = [t.clone() for t in fuse()]
    torch.cuda.synchronize()
    cpu = [t.cpu() for t in (*state, depth, rgb, pose)]
    want = df.dense_fuse_plain(*cpu, cam, stride, b.leaf, cap, b.depth_range)
    on_card = df.dense_fuse_plain(*state, depth, rgb, pose, cam, stride,
                                  b.leaf, cap, b.depth_range)
    bits = all(same_bits(g.cpu(), w) for g, w in zip(got, want))
    err_p = float((got[0].cpu() - want[0]).abs().max())
    err_c = float((got[1].cpu() - want[1]).abs().max())
    card_p = float((got[0] - on_card[0]).abs().max())
    card_c = float((got[1] - on_card[1]).abs().max())
    masks = (torch.equal(got[2].cpu(), want[2])
             and torch.equal(got[2], on_card[2]))
    repeat = all(same_bits(g.cpu(), a.cpu()) for g, a in zip(got, again))
    live_in, live_out = int(state[2].sum()), int(got[2].sum())
    ops = sum(e.count for e in profiled(fuse))
    loaded_ms = busy_ms(fuse, reps=10)
    # a fuse into the map it reloads each time, so that every repeat sees
    # the same map; the reload (a device copy) is timed alone and taken off
    fuse_ms = busy_ms(fuse_reload, reps=10) - busy_ms(
        lambda: work.load(*state), reps=10)
    ev_ms = cuda_ms(fuse_reload, 10) - cuda_ms(lambda: work.load(*state), 10)
    work.load(*state)
    a = work.cur
    plain_ms = cuda_ms(lambda: df.dense_fuse_plain(
        *state, depth, rgb, pose, cam, stride, b.leaf, cap, b.depth_range), 3)
    hs, ws = df.frame_grid(H, W, stride)
    F = hs * ws
    n_bytes = cap * 25 * 2 + F * (4 + 12) + 28
    bound = (n_bytes / PEAK_BYTES * 1e3, "bytes")
    live_keys = live_in + int(df.frame_points_plain(
        depth, rgb, pose, cam, stride, b.depth_range)[2].sum())
    design = dense_design_bytes(cap, F, live_keys, path)
    bucket = dense_largest_bucket(state, frame, cam, b.leaf, stride,
                                  b.depth_range)
    fuse()                          # its keys and frame rows, buffer a
    lib_ms, sort_ms = dense_yardstick(
        work.keys.clone(), torch.cat([work.pts[a], work.col[a]], dim=1), cap)
    print(f"[dense] K12 {tag}: map {live_in} -> {live_out} cells of {cap}, "
          f"{F} strided pixels, at most {bucket} in a bucket of the frame "
          f"sort; the {('fast', 'general')[path]} path; "
          f"{ops} device operation(s) a fuse; against the plain version on "
          f"the CPU bit-equal {bits} (points {err_p:.3g}, colours "
          f"{err_c:.3g}), on the card points {card_p:.3g} colours "
          f"{card_c:.3g}; masks equal {masks}; repeats bit-equal {repeat}; "
          f"{fuse_ms:.4f} ms a fuse (profiler, a reload taken off; CUDA "
          f"events {ev_ms:.4f}; of the map as loaded once "
          f"{loaded_ms:.4f}), "
          f"bound {bound[0] * 1e3:.2f} us ({n_bytes} bytes), share "
          f"{bound[0] / fuse_ms:.4f}; the design's own bytes {design} "
          f"({design / PEAK_BYTES * 1e6:.2f} us, share "
          f"{design / PEAK_BYTES * 1e3 / fuse_ms:.4f}); plain on the card "
          f"{plain_ms:.3f} ms; yardstick (stable sort + gather + "
          f"segment_reduce) {lib_ms:.4f} ms, its sort {sort_ms:.4f} ms")
    if not (masks and repeat and err_p <= 1e-6 and err_c <= 1e-4
            and card_p <= 1e-6 and card_c <= 1e-4):
        raise RuntimeError(f"K12 {tag} disagrees with its plain version")
    if not bits:
        raise RuntimeError(f"K12 {tag} is not bit for bit its plain version "
                           "on the CPU")
    if ops != 1:
        raise RuntimeError(f"K12 {tag}: {ops} device operations a fuse")
    df.DENSE_FUSE.launches = launched
    return dict(kernel="dense_fuse", shape=(cap, F), max_abs_err=max(
        err_p, err_c), max_rel_err=max(err_p, err_c), ms=fuse_ms,
        events_ms=ev_ms, plain_ms=plain_ms, bound=bound, library_ms=lib_ms,
        sort_ms=sort_ms, bits_equal=bits, live_points=live_out, path=path,
        device_ops=ops, loaded_ms=loaded_ms)


def phase_dense(dev, tmp, cli):
    """examples/torch_run_tum.py --build-dense on [cli]'s export (the
    adaptive mono run with the external DenseBuilder: 1 cm leaf, stride 4,
    1 << 19 cells), then K12 against its plain version at the export's
    first frame into an empty map and at a mid-orbit frame into the run's
    filled map.  Raises unless objects.txt is [cli]'s adaptive mono run's
    byte for byte, K12 launched once a frame, map.ply holds the builder's
    mask count of points, and K12 agrees (dense_checks).  Returns (the
    run's launches, K12's records)."""
    from object_oriented_slam_tpu_torch.io.tum import TUMDataset
    from object_oriented_slam_tpu_torch.system import dense_builder as db
    builders = []
    init = db.DenseBuilder.__init__

    def capture(self, *a, **k):
        init(self, *a, **k)
        builders.append(self)

    out = os.path.join(tmp, "cli_dense")
    db.DenseBuilder.__init__ = capture
    try:
        slam, printed, e2e, checked, _, launches, _, _ = drive_cli(
            dev, cli["settings"], cli["seq"], out,
            ["--extractor", "mono", "--build-dense"])
    finally:
        db.DenseBuilder.__init__ = init
    if len(builders) != 1 or slam.tracker.dense_builder is not None:
        raise RuntimeError(f"{len(builders)} dense builders were made")
    b = builders[0]
    text = open(os.path.join(out, "objects.txt")).read()
    with open(os.path.join(out, "map.ply")) as f:
        head = [next(f) for _ in range(3)]
    n_file = int(head[2].split()[2])
    n_mask = int(b.mask.sum())
    fps, ref_fps = cli_fps(printed), cli["cli_rates"]["mono adaptive"]
    print(f"[dense] --build-dense: {fps:.2f} frames/s (the CLI's line) "
          f"against {ref_fps:.2f} without the builder ([cli] mono adaptive; "
          f"informational); launches {launches}; map.ply {n_file} points, "
          f"the builder's mask {n_mask} of {b.capacity}; objects.txt "
          f"bit-equal to the run without the builder: "
          f"{text == cli['ref'][1]}; {checked} frames under the "
          f"synchronisation check")
    if "Saved dense map.ply" not in printed:
        raise RuntimeError("the CLI did not save its dense map")
    if text != cli["ref"][1]:
        raise RuntimeError("objects.txt differs from the run without the "
                           "builder")
    if launches["dense_fuse"] != N_DEPTH_FRAMES:
        raise RuntimeError(f"K12 launched {launches['dense_fuse']} times "
                           f"over {N_DEPTH_FRAMES} frames")
    if n_file != n_mask or n_mask <= 0:
        raise RuntimeError(f"map.ply holds {n_file} points, the builder's "
                           f"mask {n_mask}")
    tally = b._work.tally.tolist()
    print(f"[dense] --build-dense: K12's paths over the run's "
          f"{N_DEPTH_FRAMES} fuses: fast {tally[0]}, general {tally[1]}")
    if sum(tally) != N_DEPTH_FRAMES:
        raise RuntimeError(f"K12's path tally {tally} over "
                           f"{N_DEPTH_FRAMES} fuses")
    ds = TUMDataset(cli["seq"], with_rgb=True)
    try:
        frames = {i: (depth, rgb, pose)
                  for i, _, pose, depth, rgb, _ in ds.frames()
                  if i in DENSE_FRAMES}
    finally:
        ds.close()

    def on_card(depth, rgb, pose):
        return (torch.as_tensor(depth.astype(np.int32), device=dev),
                torch.as_tensor(rgb, device=dev).float(),
                torch.as_tensor(pose.astype(np.float32), device=dev))

    cap = b.capacity
    empty = (torch.zeros(cap, 3, device=dev), torch.zeros(cap, 3, device=dev),
             torch.zeros(cap, dtype=torch.bool, device=dev))
    filled = (b.pts.clone(), b.rgb.clone(), b.mask.clone())
    perm = torch.randperm(cap, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED))
    mid = on_card(*frames[DENSE_FRAMES[1]])
    recs = {"dense_fuse (first frame, empty map)": dense_checks(
                dev, "first frame", empty, on_card(*frames[0]), b.cam, b),
            "dense_fuse (mid-orbit frame, filled map)": dense_checks(
                dev, "filled map", filled, mid, b.cam, b),
            "dense_fuse (mid-orbit frame, shuffled filled map)": dense_checks(
                dev, "shuffled filled map", tuple(t[perm] for t in filled),
                mid, b.cam, b)}
    paths = [r["path"] for r in recs.values()]
    if paths != [0, 0, 1]:
        raise RuntimeError(f"K12 took the paths {paths} (0 fast, 1 general) "
                           "at the first frame, the filled map and the "
                           "shuffled map")
    dense_sync_check(dev, b, frames)
    return launches, recs


def dense_sync_check(dev, b, frames):
    """A builder like the CLI's fuses the first frame, then the mid-orbit
    one under torch.cuda.set_sync_debug_mode("error") (process_frame:
    the frame's upload and one K12 launch); its map must equal the plain
    version's two fuses on the CPU bit for bit."""
    from object_oriented_slam_tpu_torch.ops import dense_fuse as df
    from object_oriented_slam_tpu_torch.system import dense_builder as db
    launched = df.DENSE_FUSE.launches
    fresh = db.DenseBuilder(b.cam, b.leaf, b.stride, b.capacity,
                            b.depth_range, device=dev)
    state = (torch.zeros(b.capacity, 3), torch.zeros(b.capacity, 3),
             torch.zeros(b.capacity, dtype=torch.bool))
    for i in DENSE_FRAMES:
        depth, rgb, pose = frames[i]
        checked = i == DENSE_FRAMES[1]
        if checked:
            torch.cuda.set_sync_debug_mode("error")
        try:
            fresh.process_frame(rgb, depth, pose)
        finally:
            if checked:
                torch.cuda.set_sync_debug_mode("default")
        state = df.dense_fuse_plain(
            *state, torch.as_tensor(depth.astype(np.int32)),
            torch.as_tensor(rgb).float(),
            torch.as_tensor(pose.astype(np.float32)), b.cam, b.stride,
            b.leaf, b.capacity, b.depth_range)
    torch.cuda.synchronize()
    same = all(same_bits(g.cpu(), w) for g, w in zip(
        (fresh.pts, fresh.rgb, fresh.mask), state))
    print(f"[dense] one fuse through DenseBuilder.process_frame under the "
          f"synchronisation check: passed; the two-frame map bit-equal to "
          f"the plain version's on the CPU: {same}; paths "
          f"{fresh._work.tally.tolist()} (fast, general)")
    if not same:
        raise RuntimeError("the builder's two-frame map differs from the "
                           "plain version's")
    df.DENSE_FUSE.launches = launched


# ---------------------------------------------------------------------------
# [aos]: the AoS backend and the batch SVD initializer on the 2D path
# ---------------------------------------------------------------------------
AOS_FRAMES = 48


def phase_aos(dev, tmp):
    """A Tracking built with use_soa_backend=False and
    use_incremental_init=False (the JAX package's wiring: the flag picks
    ``_opt_fn`` when the tracker is built, so the script picks it again
    after setting it) over AOS_FRAMES frames of the 2D path's scene: the
    AoS LM (K1-K4, one ba_normal_eq and one ba_chi2 launch an iteration)
    and the batch SVD initializer on the card.  Raises unless the map's
    median centre error is within 0.05 m, K1-K4 launched and no attempt
    fed the incremental initializer.  Then 4 more frames under
    system/profiling.device_trace with an annotate range: the trace must
    name the range and both BA kernels.  Returns the launches."""
    from object_oriented_slam_tpu_torch.backend import ba_kernels
    from object_oriented_slam_tpu_torch.io.synthetic import SyntheticDataset
    from object_oriented_slam_tpu_torch.system import System, profiling
    from object_oriented_slam_tpu_torch.system import tracking

    scene = scene24()
    frames = list(SyntheticDataset(scene, n_frames=AOS_FRAMES + 4,
                                   orbit_radius=3.6, height=1.7,
                                   with_depth=False).frames())
    slam = System(write_settings(tmp), device=dev)
    pin_eager(slam)
    tr = slam.tracker
    tr.use_soa_backend = False
    tr._opt_fn = tracking._shared_opt_fn(tr.use_soa_backend)
    tr.use_incremental_init = False
    for k in ba_kernels.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    for i, ts, pose, depth, rgb, det in frames[:AOS_FRAMES]:
        slam.track_with_objects(ts, pose, det)
    tr.sync()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in ba_kernels.KERNELS}
    objs = slam.map_objects
    errs = np.array([np.linalg.norm(v[:3] - scene.ellipsoids[i][:3])
                     for i, v in objs.items()])
    fed = sum(tr._inc_init.n_planes(i) for i in range(64))
    print(f"[aos] {AOS_FRAMES} frames, AoS LM + batch SVD init: "
          f"{len(objs)}/24 objects, centre error median "
          f"{np.median(errs):.4g} m max {errs.max():.4g} m; map IoU median "
          f"%.4f, min %.4f; {tr._backend_calls} LM calls, launches "
          f"{launches}; {wall * 1e3 / AOS_FRAMES:.2f} ms a frame (host "
          f"clock, synchronized at the end)" % map_iou(objs, scene))
    if not objs or not np.median(errs) < 0.05:
        raise RuntimeError(f"{len(objs)} objects, median centre error "
                           f"{np.median(errs) if objs else None}")
    calls = tr._backend_calls
    if (launches["ba_normal_eq"] != calls * tr.lm_cfg.iters
            or launches["ba_chi2"] != calls * (tr.lm_cfg.iters + 1)):
        raise RuntimeError(f"{calls} AoS LM calls launched {launches}")
    if fed:
        raise RuntimeError("the incremental initializer was fed")
    prep = tr._prepare_backend()
    obs = tr._unpack(prep)
    n = torch.zeros(3, device=dev)
    ops = device_busy(lambda: tr._opt_fn(obs, tr._K_dev, n, prep["gset"],
                                         tr.lm_cfg))
    if ops is None:
        raise RuntimeError("the profiler shows no device time for an AoS "
                           "LM call")
    print(f"[aos] one AoS LM call at its tier: device busy {ops[0]:.3f} ms "
          f"over {ops[1]} device operations (top {ops[2]})")
    log_dir = os.path.join(tmp, "aos_trace")
    with profiling.device_trace(log_dir):
        with profiling.annotate("aos_frames"):
            for i, ts, pose, depth, rgb, det in frames[AOS_FRAMES:]:
                slam.track_with_objects(ts, pose, det)
            tr.sync()
    with open(os.path.join(log_dir, "trace.json")) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    want = ("aos_frames", "ba_normal_eq_kernel", "ba_chi2_kernel")
    found = {w: any(w in nm for nm in names) for w in want}
    print(f"[aos] device_trace: {len(names)} event names, {found}")
    if not all(found.values()):
        raise RuntimeError(f"the trace lacks {found}")
    return launches, ops


# [clustering]: stage (d)'s options on the card.  The depth path again with
# each option (the grid pass on K13, interleaved chain passes on K5's chain
# lane), then K13 and K5's exact and chain lanes against their plain
# versions at the path's, the full tier's and dense clouds' shapes
CLUSTER_OPTIONS = (
    ("grid", dict(grid_cluster=True), "cluster_grid"),
    ("chains 2", dict(cluster_chains=2), "cluster_components_chain"))
# each option's map is held to 1e-4 of a run with the same radius test on
# the same frames: the chain passes only speed up K5's propagation to the
# same labels, so [depth]'s K5 run; the grid pass tests the radius exactly
# on the camera-frame points, so the depth path with the grid option whose
# stage (d) is cluster_grid_select_plain (grid_plain_map)
CLUSTER_MAP_TOL = 1e-4
# the grid run against [depth]'s K5 map too: K5 tests the norm expansion on
# centred world points (a band of ~3e-5 m about the radius), a pair in that
# band links on one side only, a component splits or merges and the
# frame's PCA moves (the JAX package holds the two extractions to 1e-3,
# tests/test_cluster_grid.py test_extractor_grid_matches_dense)
GRID_VS_K5_TOL = 1e-3
# the JAX functions (left to XLA there) K13 and the lanes replace
CLUSTER_REPLACES = {
    "cluster_grid": "object_oriented_slam_tpu/ops/cluster.py:320",
    "cluster_components_exact": "object_oriented_slam_tpu/ops/cluster.py:54",
    "cluster_components_chain": "object_oriented_slam_tpu/ops/cluster.py:158"}
# integer / f32 operations counted from csrc/frontend.cu.  K13's table
# build (grid_work counts what these inputs need), in each of its two
# walks: per survivor and stencil row the interval's bounds and the
# position's advance test (GRID_OPS_ROW); per key in a row's interval its
# load, the bound, own-key and run tests, then the radius test's three
# differences, squares, two adds and compare (GRID_OPS_KEY).  A round: per
# listed neighbour its label's load and minimum, per survivor the changed
# test; per survivor a jump's load, compare and store (3).  A chain pass,
# per survivor and order: the aggregate's load, flag test and minimum, the
# two walks' loads, minima and stores (12)
GRID_OPS_ROW, GRID_OPS_KEY, GRID_OPS_NEIGHBOUR = 3, 13, 2
JUMP_OPS, CHAIN_OPS = 3, 12
CLUSTER_TOL, CLUSTER_LEAF = 0.02, 0.01


def same_map(objs, ref):
    """(largest difference of the centres, sorted scales and rotation
    matrices of two maps with the same instances, bit-equal vectors)."""
    from object_oriented_slam_tpu_torch.core import se3
    if sorted(objs) != sorted(ref):
        raise RuntimeError(f"instances {sorted(objs)} against {sorted(ref)}")
    diff = 0.0
    for i in ref:
        a, b = np.asarray(objs[i], np.float64), np.asarray(ref[i], np.float64)
        Ra, Rb = (se3.quat_to_mat(torch.tensor(v[3:7])).numpy()
                  for v in (a, b))
        diff = max(diff, np.abs(a[:3] - b[:3]).max(),
                   np.abs(np.sort(a[7:]) - np.sort(b[7:])).max(),
                   np.abs(Ra - Rb).max())
    return diff, all(np.array_equal(objs[i], ref[i]) for i in ref)


def dense_voxel_clouds(D, N, seed):
    """Voxel clouds (1 cm cells, camera frame) that fill N lanes: each a
    wavy surface 1.6 m across sampled densely, its first N cells taken,
    some lanes masked (holes), detection D - 1 empty.  Returns (points,
    cells, mask) on the CPU."""
    from object_oriented_slam_tpu_torch.ops import voxel as vx
    rng = np.random.default_rng(seed)
    M = 12 * N
    u = rng.uniform(-0.8, 0.8, (D, M, 2))
    z = 2.0 + 0.05 * np.sin(9 * u[..., 0]) * np.cos(7 * u[..., 1])
    raw = np.concatenate([u, z[..., None]], -1).astype(np.float32)
    pts, cells, mask = vx.voxel_downsample_cells(
        torch.from_numpy(raw), torch.ones((D, M), dtype=torch.bool),
        CLUSTER_LEAF, N)
    holes = torch.from_numpy(rng.random((D, N)) < 0.1)
    holes[0] = False
    mask = mask & ~holes
    mask[D - 1] = False
    return pts.contiguous(), cells.contiguous(), mask.contiguous()


def survivors_in_key_order(pts_v, cells_v, m2):
    """Whether each detection's survivors, in lane order, are in the grid
    key's order (the order depth_cloud's sort leaves; K13 takes its key
    table in lane order where they are, and sorts it where not)."""
    from object_oriented_slam_tpu_torch.ops import cluster as cl
    R, _ = cl._grid_offsets(CLUSTER_TOL, CLUSTER_LEAF)
    out = []
    for d in range(m2.shape[0]):
        c = cells_v[d][m2[d]].long()
        if len(c) < 2:
            out.append(True)
            continue
        c = c - c.min(0).values + R
        key = (c[:, 0] << 20) | (c[:, 1] << 10) | c[:, 2]
        out.append(bool((key[1:] > key[:-1]).all()))
    return out


def grid_work(pts_v, cells_v, m2, labels0, outer, jump_iters=12):
    """What K13's launch does on these inputs, counted with the plain
    version's steps: (keys its table walks visit in the stencil rows'
    intervals, a walk; listed neighbours; jumps run, each round's up to the
    first that changes no label, as the kernel stops them) per detection,
    as float64 [D] tensors."""
    from object_oriented_slam_tpu_torch.ops import cluster as cl
    tol, leaf = CLUSTER_TOL, CLUSTER_LEAF
    D, N = m2.shape
    sub, m_c, lab, nbr_c = cl.grid_table_compacted(pts_v, cells_v, m2,
                                                   labels0, tol, leaf)
    cap = sub.shape[1]
    C = nbr_c.shape[1] // cap
    own = torch.arange(cap, device=m2.device)[None, :, None]
    hits = ((nbr_c.view(D, cap, C) != own) & m_c[..., None]).sum(
        (1, 2)).double()
    R, _ = cl._grid_offsets(tol, leaf)
    cmin = torch.where(m2[..., None], cells_v, 2 ** 30).amin(1)
    c = (cells_v - cmin[:, None, :] + R).clamp(0, 1023)
    key = ((c[..., 0] << 20) | (c[..., 1] << 10) | c[..., 2]).to(torch.int64)
    key_s = torch.sort(torch.where(m2, key, 2 ** 40), dim=1).values
    keys = 0
    for lo, hi in cl.grid_rows(tol, leaf):
        keys = keys + torch.where(m2, torch.searchsorted(
            key_s, key + hi, right=True) - torch.searchsorted(
            key_s, key + lo), 0)
    keys = keys.sum(1).double()
    # the rounds of cluster_grid_plain, each round's jumps counted
    jumps = torch.zeros(D, dtype=torch.float64, device=m2.device)
    still = torch.ones(D, dtype=torch.bool, device=m2.device)
    for _ in range(outer):
        got = torch.gather(lab, 1, nbr_c).view(D, cap, C).amin(-1)
        cur = torch.minimum(lab, got)
        changed = (cur != lab).any(1)
        moving = still.clone()
        for _ in range(jump_iters):
            nxt = torch.where(cur < cap, torch.gather(
                cur, 1, cur.clamp(0, cap - 1).long()), cur)
            jumps += moving.double()
            moved = (nxt != cur).any(1) & moving
            changed |= moved
            cur = torch.where(moving[:, None], nxt, cur)
            moving &= moved
            if not bool(moving.any()):
                break
        lab = torch.where(still[:, None], cur, lab)
        still &= changed
        if not bool(still.any()):
            break
    return keys, hits, jumps


def grid_ops(pts_v, cells_v, m2, labels0, rounds, outer):
    """K13's operations on these inputs (GRID_OPS_*; rounds [D] the
    launch's): the table build's two walks, then each round's pass, changed
    test and the jumps it ran."""
    from object_oriented_slam_tpu_torch.ops import cluster as cl
    keys, hits, jumps = grid_work(pts_v, cells_v, m2, labels0, outer)
    n_d = m2.sum(1).double()
    rows = len(cl.grid_rows(CLUSTER_TOL, CLUSTER_LEAF))
    r_d = rounds.double()
    return float((2 * (n_d * rows * GRID_OPS_ROW + keys * GRID_OPS_KEY)
                  + r_d * (hits * GRID_OPS_NEIGHBOUR + n_d)
                  + jumps * n_d * JUMP_OPS).sum()), float(hits.sum())


def option_checks(dev, tag, pts_v, cells_v, pts_w, m2, centre, frame, outer,
                  timed=True):
    """K13 (the grid pass, with the selection epilogue) and K5's exact and
    chain (cluster_chains = 2) lanes on one set of inputs against their
    plain versions on the card: labels, converged, rounds, sel and ok
    equal, a second launch bit-equal.  With ``timed``: each one's device
    ms (profiler, held against CUDA events) beside its bound from these
    inputs and beside K5's default time on the same inputs.  Returns
    records by name."""
    from object_oriented_slam_tpu_torch.ops import cluster as cl
    D, N = m2.shape
    tol, leaf = CLUSTER_TOL, CLUSTER_LEAF
    n_d = m2.sum(1).double()
    eye = torch.eye(3, device=dev)
    recs = {}

    def held(name, runs, want):
        for got in runs:
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise RuntimeError(
                    f"{name} ({tag}, bound {outer}) differs from its plain "
                    f"version: labels {int((got[2] != want[2]).sum())} "
                    f"lanes, sel {int((got[0] != want[0]).sum())}, ok "
                    f"{got[1].tolist()} vs {want[1].tolist()}, converged "
                    f"{got[3].tolist()} vs {want[3].tolist()}, rounds "
                    f"{got[4].tolist()} vs {want[4].tolist()}")

    # K13; and with the shared memory cut to the least it takes, so that
    # its neighbour lists live in device memory
    labels0 = cl.grid_seed(pts_v, m2, tol)
    g_args = (pts_v, cells_v, m2, labels0, pts_w, centre, tol, leaf, outer,
              12, 100, 0.5)
    small = cl.grid_smem_least(N)

    def grid_in_device_memory():
        lab, conv, rounds, sel, ok = cl._launch_grid(
            *g_args[:4], tol, leaf, outer, 12, (pts_w, centre, 100, 0.5),
            smem=small)
        return sel, ok, lab, conv, rounds

    runs = [cl.cluster_grid_select(*g_args) for _ in range(2)]
    runs += [grid_in_device_memory() for _ in range(2)]
    want = cl.cluster_grid_select_plain(*g_args)
    torch.cuda.synchronize()
    held("cluster_grid", runs, want)
    grid_out = runs[0]
    # K5's lanes
    lanes = {}
    for name, chains, exact in (("cluster_components_exact", -1, True),
                                ("cluster_components_chain", 2, False)):
        args, orders = cl.centre_and_seed(pts_w, m2, tol, chains, exact,
                                          with_orders=True)
        s_args = (pts_w, *args[:4], centre, args[4], outer, 12, 100, 0.5)
        runs = [cl.cluster_select(*s_args, frame=frame, exact=exact,
                                  orders=orders) for _ in range(2)]
        want = cl.cluster_select_plain(*s_args, exact=exact, orders=orders)
        torch.cuda.synchronize()
        held(name, runs, want)
        lanes[name] = (args, orders, s_args, runs[0])
    conv = {"cluster_grid": grid_out[3].tolist(),
            **{k: v[3][3].tolist() for k, v in lanes.items()}}
    # the labels against K5's default (the norm expansion's band) and the
    # exact lane's (the grid's test); where all converged
    args = cl.centre_and_seed(pts_w, m2, tol, -1)
    k5 = cl.cluster_select(pts_w, *args[:4], centre, args[4], outer, 12,
                           100, 0.5, frame=frame)
    both = grid_out[3] & k5[3] & lanes["cluster_components_exact"][3][3]
    differ = {k: int(((lab != k5[2]) & both[:, None] & m2).sum())
              for k, lab in (("cluster_grid", grid_out[2]),
                             ("cluster_components_exact",
                              lanes["cluster_components_exact"][3][2]),
                             ("cluster_components_chain",
                              lanes["cluster_components_chain"][3][2]))}
    grid_exact = int(((grid_out[2] != lanes["cluster_components_exact"][3][2])
                      & both[:, None] & m2).sum())
    print(f"[clustering] {tag}: K13 and K5's exact and chain lanes at D={D}, "
          f"N={N} ({int(n_d.max())} survivors at most), bound {outer}: "
          f"labels, converged, rounds, sel and ok equal to their plain "
          f"versions on the card, second launches bit-equal; rounds "
          f"{grid_out[4].tolist()} (grid), "
          f"{lanes['cluster_components_exact'][3][4].tolist()} (exact), "
          f"{lanes['cluster_components_chain'][3][4].tolist()} (chains 2); "
          f"converged {conv}; {int(grid_out[1].sum())} of {D} ok; lanes "
          f"whose label differs from K5's default (detections all three "
          f"converged) {differ}, the grid's from the exact lane's "
          f"{grid_exact} (the grid tests camera-frame points, the lanes "
          f"world points); K13 with its lists in device memory (shared "
          f"memory cut to {small} bytes) equal too")
    if not timed:
        return recs
    # K5's default on the same inputs, the time beside
    args = cl.centre_and_seed(pts_w, m2, tol, -1)
    d_args = (pts_w, *args[:4], centre, args[4], outer, 12, 100, 0.5)
    k5_ms = checked_device_ms(lambda: cl.cluster_select(*d_args, frame=frame),
                              10, "cluster_components")[0]
    # K13: its table build and rounds (GRID_OPS_*, grid_ops), inputs and
    # outputs once
    ops, hits = grid_ops(pts_v, cells_v, m2, labels0, grid_out[4], outer)
    io = bytes_bound([pts_v, cells_v, m2, labels0, pts_w, centre,
                      *grid_out])[0]
    b_grid = max((ops / PEAK_F32 * 1e3, "operations"), (io, "bytes"))
    ms, ev = checked_device_ms(lambda: cl.cluster_grid_select(*g_args), 10,
                               "cluster_grid_kernel")
    dev_ms = checked_device_ms(grid_in_device_memory, 10,
                               "cluster_grid_kernel")[0]
    recs["cluster_grid (K13)"] = dict(
        kernel="cluster_grid", shape=(D, N), max_abs_err=0.0, bound=b_grid,
        ms=ms, events_ms=ev, k5_ms=k5_ms, listed_neighbours=hits,
        device_lists_ms=dev_ms,
        plain_ms=cuda_ms(lambda: cl.cluster_grid_select_plain(*g_args), 1, 0))
    # the lanes: the pair tests their skip leaves (tested_pairs, with the
    # lane's own points and norms), chain passes per survivor and order
    for name, (l_args, orders, s_args, out) in lanes.items():
        pts_c, nrm, m, _, tol2 = l_args
        r_d = out[4].double()
        pairs = float((tested_pairs(pts_c, nrm, m, eye if frame is None
                                    else frame, tol2, cl.LAUNCH_SHAPE[2])
                       * r_d).sum())
        ops = pairs * PAIR_OPS + float((r_d * n_d).sum()) * (
            12 * JUMP_OPS + (CHAIN_OPS * orders[0].shape[1]
                             if orders is not None else 0))
        io = bytes_bound([*l_args[:4], pts_w, centre, *out])[0]
        b = max((ops / PEAK_F32 * 1e3, "operations"), (io, "bytes"))
        exact = name.endswith("exact")
        ms, ev = checked_device_ms(lambda: cl.cluster_select(
            *s_args, frame=frame, exact=exact, orders=orders), 10,
            "cluster_components")
        recs[f"{name} (K5 lane)"] = dict(
            kernel=name, shape=(D, N), max_abs_err=0.0, bound=b, ms=ms,
            events_ms=ev, k5_ms=k5_ms, tested_pairs=pairs,
            plain_ms=cuda_ms(lambda: cl.cluster_select_plain(
                *s_args, exact=exact, orders=orders), 1, 0))
    for k, r in recs.items():
        print(f"[clustering] {tag}: {k} {r['ms']:.4f} ms by the profiler "
              f"({r['events_ms']:.4f} by CUDA events), "
              f"{bound_text(r['ms'], r['bound'])}; K5's default on the same "
              f"inputs {k5_ms:.4f} ms; plain version {r['plain_ms']:.3f} ms"
              + (f"; its lists in device memory {r['device_lists_ms']:.4f} "
                 f"ms" if "device_lists_ms" in r else ""))
    return recs


def grid_plain_map(dev, tmp, scene):
    """The grid run's reference: the depth path with grid_cluster=True
    whose stage (d) calls cluster_grid_select_plain on the card (the same
    exact radius test on the same camera-frame points; its round loop
    reads the host, so no synchronisation check).  Returns the map."""
    from object_oriented_slam_tpu_torch.frontend import ExtractorConfig
    from object_oriented_slam_tpu_torch.ops import cluster as cl
    kernel = cl.cluster_grid_select
    cl.cluster_grid_select = cl.cluster_grid_select_plain
    try:
        slam, *_, launches = drive_depth_path(
            dev, tmp, "synthetic_depth.yaml", scene,
            ExtractorConfig(grid_cluster=True))
    finally:
        cl.cluster_grid_select = kernel
    if launches["cluster_grid"] or launches["cluster_components"]:
        raise RuntimeError(f"the plain grid run launched {launches}")
    return slam.map_objects


def stage_a_on_card(dev, depth, bboxes, pose, plane, cam, cfg):
    """Stages (a)-(c) on the card (one depth_cloud launch): (pts_v, cells_v,
    pts_w, m2, centre estimates, the sort frame the extractor names)."""
    from object_oriented_slam_tpu_torch.frontend import extractor as text
    a = text._stage_a(depth, bboxes, pose, plane, cam, cfg)
    return (a[0].contiguous(), a[2].contiguous(), a[1].contiguous(),
            a[3].contiguous(), a[4].contiguous(),
            a[7].transpose(-1, -2).contiguous())


def phase_clustering(dev, tmp, path, depth_map, offline):
    """[clustering]: the depth path (the scene, orbit, lanes and tier of
    [depth]) with ExtractorConfig(grid_cluster=True) and with
    cluster_chains=2, each against a run with the same radius test and
    against [depth]'s map (``depth_map``) on the same frames, every frame
    after the plane latch under the synchronisation check, one extraction
    call under the profiler; then K13 and K5's lanes against their plain
    versions at the path's mid-orbit frame, the full tier and dense
    clouds, under a bound of 2 rounds too; then one offline batch
    (``offline``'s, from [offline]) with grid_cluster, each frame's rows
    against its own one-frame extraction.  Returns (launches of each run, records at
    the path's shapes, records at the other shapes)."""
    import dataclasses
    from object_oriented_slam_tpu_torch.frontend import ExtractorConfig
    from object_oriented_slam_tpu_torch.frontend import batch_extractor as bx
    from object_oriented_slam_tpu_torch.frontend.extractor import _pack_frame
    from object_oriented_slam_tpu_torch.io import synthetic as syn
    from object_oriented_slam_tpu_torch.ops import frontend_kernels as fk
    scene = scene24()
    refs = {"grid": ("the plain grid path's", grid_plain_map(dev, tmp, scene)),
            "chains 2": ("[depth]'s K5", depth_map["objs"])}
    kernels = (*fk.KERNELS, *fk.OPTION_KERNELS)
    launches_by_run = {}
    for name, option, kernel in CLUSTER_OPTIONS:
        slam, frames, e2e, stats, latched_at, launches = drive_depth_path(
            dev, tmp, "synthetic_depth.yaml", scene, ExtractorConfig(**option),
            check_sync=True)
        tr = slam.tracker
        objs = slam.map_objects
        errs = np.array([np.linalg.norm(v[:3] - scene.ellipsoids[i][:3])
                         for i, v in objs.items()])
        e2e_ms, ext_ms, _ = path_times(tr, e2e)
        ran = [s for s in stats if s]
        rounds = np.array([s["cluster_rounds"] for s in ran])
        unconverged = [i for i, s in enumerate(stats)
                       if s and not s["cluster_converged"]]
        if latched_at is None:
            raise RuntimeError(f"{name}: the ground plane never latched")
        ref_name, ref = refs[name]
        diff, bits = same_map(objs, ref)
        k5_diff, k5_bits = same_map(objs, depth_map["objs"])
        want = {k.name: 0 for k in fk.OPTION_KERNELS}
        want.update(cluster_components=0, symmetry_search=0,
                    depth_cloud=N_DEPTH_FRAMES,
                    voxel_downsample=N_DEPTH_FRAMES)
        want[kernel] = N_DEPTH_FRAMES
        print(f"[clustering] {name}: {len(objs)}/24 objects; centre error "
              f"median {np.median(errs):.4g} m, max {errs.max():.4g} m; "
              f"against {ref_name} map on the same frames: max |diff| "
              f"{diff:.3g} (limit {CLUSTER_MAP_TOL:g}), bit-equal {bits}; "
              f"against [depth]'s K5 map: max |diff| {k5_diff:.3g} "
              f"(limit {GRID_VS_K5_TOL:g}), bit-equal {k5_bits}; "
              f"e2e ms/frame "
              f"p50 {np.median(e2e_ms):.3f} mean {e2e_ms.mean():.3f} "
              f"(default path p50 {np.median(depth_map['e2e']):.3f} mean "
              f"{depth_map['e2e'].mean():.3f}); extraction p50 "
              f"{np.median(ext_ms):.3f} (default "
              f"{np.median(depth_map['ext']):.3f}); clustering rounds per "
              f"frame min {rounds.min()} median {int(np.median(rounds))} "
              f"max {rounds.max()} (default "
              f"{(int(depth_map['rounds'].min()), int(np.median(depth_map['rounds'])), int(depth_map['rounds'].max()))}); "
              f"{len(frames) - latched_at - 1} frames after the plane latch "
              f"under the synchronisation check; launches {launches}")
        if len(objs) < 16 or not np.median(errs) <= 0.05:
            raise RuntimeError(f"{name}: {len(objs)} objects, median centre "
                               f"error {np.median(errs):.4g} m")
        if not (diff <= CLUSTER_MAP_TOL and k5_diff <= GRID_VS_K5_TOL):
            raise RuntimeError(f"{name}: the map is {diff:.3g} from "
                               f"{ref_name}, {k5_diff:.3g} from K5's")
        if unconverged:
            raise RuntimeError(f"{name}: the clustering did not converge on "
                               f"frames {unconverged}")
        if {k: launches[k] for k in want} != want:
            raise RuntimeError(f"{name} launched {launches}, not {want}")
        expect = {k.name: 0 for k in kernels}
        expect.update(depth_cloud=1, voxel_downsample=1)
        expect[kernel] = 1
        extraction_overhead(f"clustering {name}", tr.extractor,
                            frames[len(frames) // 2], tr.state.ground_plane,
                            expect, kernels)
        launches_by_run[name] = launches

    # the kernels at the path's shapes (the mid-orbit frame through the
    # extractor's packing), the full tier, dense clouds, 2 rounds
    cam = scene.camera
    cfg = ExtractorConfig()
    (_, _, pose, depth, _, det), plane, st = path
    flat, pad, _, cfg_t, _ = _pack_frame(cam, cfg, det[:, 1:5].copy(),
                                         det[:, 5].astype(int), pose, plane)
    flat_d = torch.from_numpy(flat).to(dev)
    depth_d = torch.from_numpy(np.ascontiguousarray(depth, np.int32)).to(dev)
    pts_v, cells_v, pts_w, m2, centre, frame = stage_a_on_card(
        dev, depth_d, flat_d[:pad * 4].reshape(pad, 4),
        flat_d[pad * 6:pad * 6 + 7], flat_d[pad * 6 + 7:pad * 6 + 11], cam,
        cfg_t)
    if int(m2.sum(1).max()) != st["cluster_lanes"]:
        raise RuntimeError(f"the kernels' inputs hold {int(m2.sum(1).max())} "
                           f"survivors; the path ran {st}")
    print(f"[clustering] path: the survivors of each detection in lane order "
          f"are in the grid key's order: {survivors_in_key_order(pts_v, cells_v, m2)}")
    recs = option_checks(dev, "path", pts_v, cells_v, pts_w, m2, centre,
                         frame, 96)
    option_checks(dev, "path", pts_v, cells_v, pts_w, m2, centre, frame, 2,
                  timed=False)
    full = {}
    pose = syn.orbit_trajectory(N_DEPTH_FRAMES, 3.6, 1.7)[11]
    depth_d = syn.render_depth(scene.ellipsoids, pose, cam, device=dev)
    bbs, vis = syn.project_bboxes(scene.ellipsoids.astype(np.float32),
                                  pose.astype(np.float32), cam)
    area = torch.where(vis, (bbs[:, 2] - bbs[:, 0]) * (bbs[:, 3] - bbs[:, 1]),
                       -1.0)
    bboxes = bbs[torch.argsort(area, descending=True)[:FE_DETECTIONS]].to(dev)
    bboxes[0] = torch.tensor([0.0, 0.0, 639.0, 479.0], device=dev)
    inputs = stage_a_on_card(
        dev, depth_d, bboxes, torch.as_tensor(pose, dtype=torch.float32,
                                              device=dev),
        torch.tensor([0.0, 0.0, 1.0, 0.0], device=dev), cam,
        ExtractorConfig(cloud_capacity=FE_TIER))
    full.update({f"{k} (full)": r for k, r in option_checks(
        dev, "full tier", *inputs, 96).items()})
    pts, cells, mask = (t.to(dev) for t in dense_voxel_clouds(
        FE_DETECTIONS, FE_TIER, SEED))
    # the dense clouds in the camera frame; their world points a rigid
    # motion away (the selection's distances), the centre a point of each
    R = torch.tensor([[0.6, 0.8, 0.0], [-0.8, 0.6, 0.0], [0.0, 0.0, 1.0]],
                     device=dev)
    pts_w = (pts @ R.T + torch.tensor([0.3, -0.2, 0.1], device=dev))
    pts_w = pts_w.contiguous()
    centre = pts_w[:, 0].contiguous()
    # the camera's axes in the world frame (the rows of R^T), as the
    # extractor names its sort frame
    frame = R.T.contiguous()
    full.update({f"{k} (dense)": r for k, r in option_checks(
        dev, "dense", pts, cells, pts_w, mask, centre, frame, 96).items()})
    option_checks(dev, "dense", pts, cells, pts_w, mask, centre, frame, 2,
                  timed=False)

    # one offline batch with grid_cluster: the batched call launches K13
    # once, and each frame's rows (the detections its run gates pass) are
    # bit for bit those of the frame's own one-frame extraction with the
    # option (the monolithic extractor, at the frame's own cloud tier)
    from object_oriented_slam_tpu_torch.frontend.extractor import \
        make_extractor
    fb, cam_b, _, packed, ground = offline["grid_batch"]
    cfg_g = dataclasses.replace(fb.cfg, grid_cluster=True)
    before = {k.name: k.launches for k in kernels}
    rows = bx.fetch_batch(bx.dispatch_batch(
        dataclasses.replace(fb, cfg=cfg_g), cam_b, device=dev))
    per_call = {k.name: k.launches - before[k.name] for k in kernels}
    if per_call["cluster_grid"] != 1 or per_call["cluster_components"]:
        raise RuntimeError(f"the grid batch launched {per_call}")
    ex = make_extractor(cam_b, cfg_g, device=dev)
    held_rows = 0
    for b, (depth, bb, labels, run, pose) in enumerate(packed):
        s, n = fb.slices[b]
        if not n:
            continue
        one = ex.fetch(ex(depth, bb, labels, pose, ground))[:n]
        r = np.asarray(run[:n], bool)
        got, want = rows[s:s + n][r], one[r]
        if got.dtype != want.dtype or got.tobytes() != want.tobytes():
            diff = np.abs(got.astype(np.float64) - want).max()
            raise RuntimeError(f"the grid batch's rows of frame {b} differ "
                               f"from its own extraction (max |diff| "
                               f"{diff:.3g})")
        held_rows += int(r.sum())
    n = sum(n for _, n in fb.slices)
    print(f"[clustering] offline: one batch of {fb.B} frames ({n} detections, "
          f"{int((rows[:n, 11] > 0.5).sum())} valid, tier "
          f"{fb.cfg.cloud_capacity}) with grid_cluster: launches {per_call}; "
          f"the {held_rows} rows the run gates pass bit-equal to each "
          f"frame's own one-frame extraction with grid_cluster")
    full.update(offline_grid_record(dev, fb, cfg_g, cam_b))
    return launches_by_run, recs, full


def offline_grid_record(dev, fb, cfg_g, cam_b):
    """K13 at [offline]'s batch shapes: the batched call's own K13 and K5
    inputs (each taken from one batched call with the option on / off),
    K13 against its plain version there (equal, a repeat bit-equal) and
    timed beside K5's default on the same batch.  Returns its record."""
    import dataclasses
    from object_oriented_slam_tpu_torch.frontend import batch_extractor as bx
    from object_oriented_slam_tpu_torch.ops import cluster as cl
    taken = {}

    def take(name):
        kernel = getattr(cl, name)

        def grab(*a, **kw):
            taken[name] = (a, kw)
            return kernel(*a, **kw)
        return kernel, grab

    for name, cfg in (("cluster_grid_select", cfg_g),
                      ("cluster_select", fb.cfg)):
        kernel, grab = take(name)
        setattr(cl, name, grab)
        try:
            bx.fetch_batch(bx.dispatch_batch(dataclasses.replace(fb, cfg=cfg),
                                             cam_b, device=dev))
        finally:
            setattr(cl, name, kernel)
    g_args, _ = taken["cluster_grid_select"]
    k_args, k_kw = taken["cluster_select"]
    runs = [cl.cluster_grid_select(*g_args) for _ in range(2)]
    want = cl.cluster_grid_select_plain(*g_args)
    torch.cuda.synchronize()
    if not (all(torch.equal(g, w) for g, w in zip(runs[0], want))
            and all(same_bits(a.cpu(), b.cpu())
                    for a, b in zip(*runs))):
        raise RuntimeError("K13 at the offline batch's shapes differs from "
                           "its plain version or from itself")
    pts_v, cells_v, m2, labels0, pts_w, centre = g_args[:6]
    D, N = m2.shape
    outer = g_args[8]
    ops, hits = grid_ops(pts_v, cells_v, m2, labels0, runs[0][4], outer)
    io = bytes_bound([*g_args[:6], *runs[0]])[0]
    bound = max((ops / PEAK_F32 * 1e3, "operations"), (io, "bytes"))
    ms, ev = checked_device_ms(lambda: cl.cluster_grid_select(*g_args), 10,
                               "cluster_grid_kernel")
    k5_ms = checked_device_ms(lambda: cl.cluster_select(*k_args, **k_kw),
                              10, "cluster_components")[0]
    plain_ms = cuda_ms(lambda: cl.cluster_grid_select_plain(*g_args), 1, 0)
    print(f"[clustering] offline: K13 on the batch's inputs (D={D}, N={N}, "
          f"{int((m2.sum(1) > 0).sum())} live detections, "
          f"{int(m2.sum(1).max())} survivors at most, rounds max "
          f"{int(runs[0][4].max())}): equal to its plain version, a repeat "
          f"bit-equal; {ms:.4f} ms by the profiler ({ev:.4f} by CUDA "
          f"events), {bound_text(ms, bound)}; K5's default on the same batch "
          f"{k5_ms:.4f} ms; plain version {plain_ms:.3f} ms")
    return {"cluster_grid (K13) (offline batch)": dict(
        kernel="cluster_grid", shape=(D, N), max_abs_err=0.0, bound=bound,
        ms=ms, events_ms=ev, k5_ms=k5_ms, listed_neighbours=hits,
        plain_ms=plain_ms)}


def phase_viz(dev, tmp, cli):
    """[viz]: [cli]'s export run by examples/torch_run_tum.py --extractor
    mono with --viz-live 40, and with --viz where cv2 and matplotlib import:
    the files written, objects.txt byte-equal to [cli]'s adaptive mono run
    without the viewers, frames/s beside it."""
    import importlib.util
    import json as _json
    import re
    seq, settings = cli["seq"], cli["settings"]
    ref_objs, ref_text = cli["ref"]
    fps_ref = cli["rates"]["mono adaptive"][0]
    have = [m for m in ("cv2", "matplotlib")
            if importlib.util.find_spec(m) is not None]
    runs = [("viz-live", ["--viz-live", "40"])]
    if len(have) == 2:
        runs.append(("viz", ["--viz"]))
    print(f"[viz] cv2 / matplotlib importable: {have}; runs: "
          f"{[name for name, _ in runs]}")
    for name, extra in runs:
        out = os.path.join(tmp, name)
        slam, printed, e2e, checked, _, launches, _, _ = drive_cli(
            dev, settings, seq, out, ["--extractor", "mono", *extra])
        text = open(os.path.join(out, "objects.txt")).read()
        files = sorted(os.listdir(out))
        if name == "viz-live":
            html = open(os.path.join(out, "live.html")).read()
            data = _json.loads(re.search(r"const DATA = (\{.*?\});\n", html,
                                         re.S).group(1))
            written = (f"live.html ({len(html)} bytes, {len(data['objects'])} "
                       f"objects, title {data['title']!r}, panels "
                       f"{[p['name'] for p in data['panels']]})")
            if len(data["objects"]) != len(ref_objs) or (
                    N_DEPTH_FRAMES >= 40 and not data["panels"]):
                raise RuntimeError(f"[viz] live.html: {written}")
        else:
            pngs = [f for f in files if f.startswith("frame_")]
            written = f"{len(pngs)} frame PNGs and map.png"
            if len(pngs) != N_DEPTH_FRAMES or "map.png" not in files:
                raise RuntimeError(f"[viz] --viz wrote {files}")
        fps = cli_fps(printed)
        print(f"[viz] {name}: wrote {written}; objects.txt byte-equal to the "
              f"run without the viewers: {text == ref_text}; {fps:.2f} "
              f"frames/s against {fps_ref:.2f}; {checked} frames under the "
              f"synchronisation check")
        if text != ref_text:
            raise RuntimeError(f"[viz] {name}: objects.txt differs from the "
                               "run without the viewers")


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--keep", default=None, metavar="DIR",
                    help="copy [slam]'s checkpoint, ground truth and "
                         "refined outputs into DIR (for "
                         "tests/jax_slam_on_checkpoint.py)")
    # [dist]'s child processes (phase_dist starts them)
    ap.add_argument("--dist-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--dist-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dist-cli", nargs=argparse.REMAINDER, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.dist_rank is not None:
        return dist_rank_main(args.dist_rank, args.dist_dir)
    if args.dist_cli is not None:
        return dist_cli_main(args.dist_cli, args.dist_dir)
    from concurrent.futures import ThreadPoolExecutor
    from object_oriented_slam_tpu_torch.backend import ba_kernels, slam_kernels
    from object_oriented_slam_tpu_torch.ops import dense_fuse
    from object_oriented_slam_tpu_torch.ops import frontend_kernels as fk
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[card] {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    # one nvcc per source and g++ for the host clustering, all together
    with ThreadPoolExecutor(6) as pool:
        for job in [pool.submit(ba_kernels.build), pool.submit(fk.build),
                    pool.submit(slam_kernels.build),
                    pool.submit(example("torch_slam_edges_bench")
                                .clocks_build),
                    pool.submit(dense_fuse.build),
                    pool.submit(build_cluster)]:
            job.result()
    print(f"[build] {time.perf_counter() - t0:.1f} s (the host clustering "
          f"library from native/src/cluster.cpp with g++ among them)")
    for line in (ba_kernels.build_log + fk.build_log
                 + slam_kernels.build_log
                 + dense_fuse.build_log).splitlines():
        if ("registers" in line or "spill" in line
                or "entry function '_Z25cluster_components_kernel" in line
                or "entry function '_Z19cluster_grid_kernel" in line):
            print(f"[build] {line.strip()}")

    recs = phase_kernels(dev)
    recs.update(phase_steps(dev))
    phase_whole_lm(dev)
    with tempfile.TemporaryDirectory() as tmp:
        launches_2d = phase_main_path(dev, tmp)
        launches, path, depth_call, depth_map = phase_depth_path(dev, tmp)
        launches_sym, path_sym, sym_call = phase_symmetry_path(dev, tmp,
                                                               depth_call)
        launches_sparse, path_sparse = phase_sparse_path(dev, tmp, sym_call)
        launches_by_run, cli = phase_cli(dev, tmp, path_sym, sym_call)
        (launches_offline, offline_recs, offline_border, _,
         offline) = phase_offline(dev, tmp, cli, sym_call)
        launches_slam, slam_recs, slam_problem = phase_slam(
            dev, tmp, cli, args.keep)
        dist_ranks, dist_cli = phase_dist(dev, tmp, cli, slam_problem,
                                          offline)
        launches_dense, dense_recs = phase_dense(dev, tmp, cli)
        launches_aos, aos_ops = phase_aos(dev, tmp)
        launches_cl, cl_recs, cl_full = phase_clustering(
            dev, tmp, path, depth_map, offline)
        phase_viz(dev, tmp, cli)
    launches_cli = launches_by_run["mono adaptive"]
    fe_recs, fe_full = phase_frontend_kernels(dev, path)
    sym_recs, sym_full = phase_symmetry_kernel(dev, path_sym)
    sparse_recs, sparse_full = phase_sparse_kernels(dev, path_sparse)

    def record(name, r, source, replaces, path_launches=None, **more):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": (path_launches[r["kernel"]]
                             if path_launches is not None else 0),
                "launches_cli": (launches_cli[r["kernel"]]
                                 if path_launches is not None else 0),
                **{"launches_cli_" + run: (launches_by_run[run][r["kernel"]]
                                           if path_launches is not None
                                           else 0)
                   for run in HOST_CLUSTERED},
                **{"launches_" + key: (launches_offline[run][r["kernel"]]
                                       if path_launches is not None else 0)
                   for run, key in OFFLINE_KEYS},
                # [dist]: per gloo rank, the launches of its sharded checks
                # and of its torchrun CLI run
                "launches_dist_ranks": [
                    (sum(rep["launches"].get(r["kernel"], 0)
                         for rep in rank.values())
                     if path_launches is not None else 0)
                    for rank in dist_ranks],
                "launches_dist_cli": [
                    (launched[r["kernel"]] if path_launches is not None
                     else 0) for launched in dist_cli],
                "max_abs_err": r["max_abs_err"],
                "max_rel_err": r.get("max_rel_err", r["max_abs_err"]),
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "share_of_bound": r["bound"][0] / r["ms"],
                "library_ms": r.get("library_ms"), "shape": list(r["shape"]),
                **{k: r[k] for k in (
                    "events_ms", "all_pairs_bound_ms", "tested_pairs",
                    "all_pairs", "every_pair_ms", "world_axes_ms", "sort_ms",
                    "live_points", "box_pixels", "bits_equal", "pair_tests",
                    "searched", "source_points", "near_threshold", "hint_ms",
                    "lanes", "threads", "blocks", "registers")
                   if k in r},
                **more}

    # launches: each path's counts, set to 0 just before it and read just
    # after: the depth path's for K1-K7 (the BA kernels also carry the 2D
    # path's), the symmetry path's for K8 (symmetry_search; the depth path
    # without symmetry launches it 0 times), the sparse path's for the
    # records of sparse symmetry's lanes (the same three kernels).  The
    # frontend records under
    # "kernels" are taken at the shapes those paths launched; the shapes
    # they never reached (the full tier, the dense clouds, sym_capacity
    # filled; launches 0) stand apart.  library_ms: for the downsamples
    # (depth_cloud, voxel_downsample) a stable torch.sort, a gather and
    # torch.segment_reduce's mean, the nearest PyTorch has to them
    # (library_yardstick); for symmetry_search torch.cdist + torch.amin of
    # one cost pass times the passes (no PyTorch call computes the
    # occlusion-aware mirrored 1-NN cost with its LM); null elsewhere: no
    # PyTorch call computes the BA residual chains with their Jacobians and
    # reductions or a radius-graph min-label propagation.
    # cluster_components and cluster_select are one kernel without and with
    # its selection epilogue and share a launch counter, as ba_normal_eq
    # and lm_solve_step do.
    kernels = [record(f"{r['kernel']} ({k})", r, SOURCE, REPLACES.get(
        k, REPLACES["K1" if r["kernel"] == "ba_normal_eq" else "K3"]),
        launches, launches_2d_path=launches_2d[r["kernel"]])
        for k, r in recs.items()]
    kernels += [record(k, r, FE_SOURCE, FE_REPLACES[r["kernel"]], launches)
                for k, r in fe_recs.items()]
    kernels += [record(k, r, FE_SOURCE, FE_REPLACES[r["kernel"]],
                       launches_sym) for k, r in sym_recs.items()]
    kernels += [record(k, r, FE_SOURCE, SPARSE_REPLACES[r["kernel"]],
                       launches_sparse) for k, r in sparse_recs.items()]
    # K11: launches the SLAM-mode CLI run's (each instantiation its counter)
    kernels += [record(k, r, SLAM_SOURCE, SLAM_REPLACES[r["kernel"]],
                       launches_slam) for k, r in slam_recs.items()]
    # the frame lanes: launches the one-BA-a-batch offline run's
    kernels += [record(k, r, FE_SOURCE, OFFLINE_REPLACES[r["kernel"]],
                       launches_offline["offline"])
                for k, r in offline_recs.items()]
    # K12: launches the --build-dense CLI run's (one a frame)
    kernels += [{"name": k, "route": "cuda", "source": DENSE_SOURCE,
                 "replaces": DENSE_REPLACES,
                 "launches": launches_dense["dense_fuse"],
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                 "bound_by": r["bound"][1],
                 "share_of_bound": r["bound"][0] / r["ms"],
                 "library_ms": r["library_ms"], "shape": list(r["shape"]),
                 **{key: r[key] for key in ("events_ms", "sort_ms",
                                             "bits_equal", "live_points",
                                             "path", "device_ops",
                                             "loaded_ms")}}
                for k, r in dense_recs.items()]
    # [clustering]: K13 and K5's exact and chain lanes at the depth path's
    # shapes, launches the option's depth run's (the grid run's for K13, the
    # cluster_chains=2 run's for the chain lane; no path runs the exact
    # lane: 0); their times at the other shapes under kernels_at_full_tier
    def option_record(k, r, launched):
        return {"name": k, "route": "cuda", "source": FE_SOURCE,
                "replaces": CLUSTER_REPLACES[r["kernel"]],
                "launches": launched, "max_abs_err": r["max_abs_err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "share_of_bound": r["bound"][0] / r["ms"],
                "library_ms": None, "shape": list(r["shape"]),
                "events_ms": r["events_ms"], "k5_default_ms": r["k5_ms"]}
    run_of = {kernel: name for name, _, kernel in CLUSTER_OPTIONS}
    kernels += [option_record(k, r, launches_cl[run_of[r["kernel"]]][
        r["kernel"]] if r["kernel"] in run_of else 0)
        for k, r in cl_recs.items()]
    # [aos]: the AoS LM's launches of K1-K4 on its run, beside the records
    for rec in kernels:
        if rec["name"].startswith(("ba_normal_eq", "ba_chi2")):
            rec["launches_aos"] = launches_aos[rec["name"].split()[0]]
    at_full_tier = [record(k, r, FE_SOURCE, FE_REPLACES[r["kernel"]])
                    for k, r in {**fe_full, **sym_full}.items()]
    at_full_tier += [record(k, r, FE_SOURCE, SPARSE_REPLACES[r["kernel"]])
                     for k, r in sparse_full.items()]
    at_full_tier += [record(k, r, FE_SOURCE, OFFLINE_REPLACES[r["kernel"]])
                     for k, r in offline_border.items()]
    at_full_tier += [option_record(k, r, 0) for k, r in cl_full.items()]
    print(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels,
                      "kernels_at_full_tier": at_full_tier}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
