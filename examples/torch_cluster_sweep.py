"""Launch-shape sweeps of the clustering kernels on one NVIDIA GPU.

    python3 examples/torch_cluster_sweep.py [--frame 80] [--reps 5]
    python3 examples/torch_cluster_sweep.py --grid [--root DIR] [--reps 10]
    python3 examples/torch_cluster_sweep.py --lanes [--root DIR]

Times ``ops/cluster.cluster_components`` (csrc/frontend.cu: compaction and
every round of a frame's min-label propagation in one launch, a thread
block cluster per detection) over its launch shapes: blocks per detection S
(the cluster size), threads per block T, points a lane keeps in registers P
(a constant of the build: the library is built once more for each P with
``-DOSLAM_CC_P``), the dynamic shared memory (everything resident, or the
least: the points streamed), and with and without the skip of far groups.
Inputs:

  path   a mid-orbit frame of the 24-object depth scene chip_smoke.py
         drives, through the extractor's own packing and stages (32 padded
         detection lanes, cloud tier 4096);
  full   the 8 largest detections of that scene at cloud capacity 16384;
  dense  seeded clouds that fill 16384 lanes (chip_smoke.dense_cloud),
         sorted along a slanted direction but for one;
  dense-shuffled  the same with every second detection in random order,
         where no group can be skipped.

For each input the table gives the device time of one launch (the
profiler's kernel events, mean of ``--reps``), the time per round of the
detection that ran longest, and the share of the bound (the pair tests that
the skip of far groups leaves at that P, ``chip_smoke.tested_pairs``, once
per round each detection ran, at the card's f32 peak; the header also gives
the bound with every pair of a detection's points).
Every shape's labels, flags and round counts are compared with the default
shape's.  Last, the default shape over frames all around the orbit (the
camera's yaw turns the slabs of the sorted cloud against the world's axes):
device time with the camera's axes as the sort frame, with the boxes along
the world's axes (no frame given), and without the skip, beside the
frame's rounds.  Then what bounds the path frame's launch (``critical_path``):
every launch's time of ten, each live detection alone (the others masked
out), and copies of the heaviest detection side by side, which shows how
many clusters the card holds at once.  The card's name and power limit are
printed first.

``--grid`` times K13 (``ops/cluster.cluster_grid_select``, the grid pass of
``grid_cluster``) instead, on the grid path's inputs (the camera-frame
voxel clouds with their cells, the selection on the world points) at the
path frame, the full tier and dense 16384-lane voxel surfaces
(chip_smoke.dense_voxel_clouds): first the phase clocks of its slowest
block (a build with -DOSLAM_GRID_CLOCKS: clock64 as thread 0 enters each
phase: compaction, the key table, the neighbour lists, the rounds with the
cycles a round, the labels' write-back and the selection), then blocks per
detection S x threads T (each shape's results held against the default
shape's; with the waves of clusters the card holds at once where the
kernel reports them), S against the number of detections (the path
frame's 1 to 8 times over), then what bounds the launch at the path
frame, the full tier and the dense surfaces (every launch's time of ten,
each live detection alone, copies of the heaviest).
``--root DIR`` runs the same against the package and chip_smoke.py of an
older checkout at DIR (a git archive of the parent): its K13 is patched
with the same clocks at the same phases (the hash table's inserts end the
key table) into a copy of its source beside the original.

``--lanes`` runs chip_smoke.py's checks of K13 and K5's exact and chain
lanes (``option_checks``: each against its plain version, timed beside
K5's default on the same inputs) at the path frame, the full tier and the
dense surfaces; with ``--root`` those of the other checkout, so that
``--lanes --root PARENT; --lanes; --lanes; --lanes --root PARENT`` in one
call compares two trees on one card.
"""
import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

# --root DIR: the package and chip_smoke.py of another checkout
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if "--root" in sys.argv:
    _ROOT = os.path.abspath(sys.argv[sys.argv.index("--root") + 1])
sys.path.insert(0, _ROOT)

import chip_smoke as cs  # noqa: E402
from object_oriented_slam_tpu_torch.frontend import ExtractorConfig  # noqa: E402
from object_oriented_slam_tpu_torch.frontend.extractor import (  # noqa: E402
    _pack_frame, _stage_a)
from object_oriented_slam_tpu_torch.io import synthetic as syn  # noqa: E402
from object_oriented_slam_tpu_torch.ops import cluster as cl  # noqa: E402
from object_oriented_slam_tpu_torch.ops import frontend_kernels as fk  # noqa: E402

SHAPES = [(S, T, P) for P in (2, 4, 8) for S in (1, 2, 4, 8)
          for T in (256, 512)]


def build_for(P):
    """Bind the library whose kernel keeps P points a lane."""
    fk.rebuild(*(() if P == cl.LAUNCH_SHAPE[2] else (f"-DOSLAM_CC_P={P}",)))


def path_clouds(dev, frame):
    """World clouds, survivor masks and the sort frame (the camera's axes in
    world coordinates) of one frame of the depth scene, as the extractor's
    stage (a) makes them; and the same frame's 8 largest boxes at the full
    cloud capacity."""
    scene = cs.scene24()
    cam = scene.camera
    pose = syn.orbit_trajectory(cs.N_DEPTH_FRAMES, 3.6, 1.7)[frame]
    depth = syn.render_depth(scene.ellipsoids, pose, cam, device=dev)
    bbs, vis = syn.project_bboxes(scene.ellipsoids.astype(np.float32),
                                  pose.astype(np.float32), cam)
    plane = np.array([0.0, 0.0, 1.0, 0.0])
    out = {}
    cfg = ExtractorConfig()
    flat, pad, _, cfg_t, _ = _pack_frame(
        cam, cfg, bbs[vis].numpy(), scene.labels[vis.numpy()], pose, plane)
    flat_d = torch.from_numpy(flat).to(dev)
    a = _stage_a(depth, flat_d[:pad * 4].reshape(pad, 4),
                 flat_d[pad * 6:pad * 6 + 7],
                 flat_d[pad * 6 + 7:pad * 6 + 11], cam, cfg_t)
    out["path"] = (a[1], a[3], a[7].T.contiguous())
    area = torch.where(vis, (bbs[:, 2] - bbs[:, 0]) * (bbs[:, 3] - bbs[:, 1]),
                       -1.0)
    big = bbs[torch.argsort(area, descending=True)[:cs.FE_DETECTIONS]]
    a = _stage_a(depth, big.to(dev),
                 torch.as_tensor(pose, dtype=torch.float32, device=dev),
                 torch.as_tensor(plane, dtype=torch.float32, device=dev), cam,
                 ExtractorConfig(cloud_capacity=cs.FE_TIER))
    out["full"] = (a[1], a[3], a[7].T.contiguous())
    return out


def sweep(name, pts, mask, frame, chains, reps):
    args = cl.centre_and_seed(pts, mask, 0.02, chains)
    D, N = mask.shape
    build_for(cl.LAUNCH_SHAPE[2])
    want = cl.cluster_components(*args, 96, 12, frame=frame)
    rounds = want[2]
    n_d = mask.sum(1).double()
    all_pairs = float((n_d * n_d * rounds.double()).sum())
    bound_ms = {P: float((cs.tested_pairs(*args[:3], frame, args[4], P)
                          * rounds.double()).sum())
                * cs.PAIR_OPS / cs.PEAK_F32 * 1e3 for P in (2, 4, 8)}
    r_max = int(rounds.max())
    least = 13 * (-(-N // 32) * 32) + 16 * 256
    print(f"[{name}] D={D}, N={N} lanes, survivors {n_d.long().tolist()}, "
          f"rounds {rounds.tolist()}, converged {want[1].tolist()}; bound by "
          f"operations: with every pair "
          f"{all_pairs * cs.PAIR_OPS / cs.PEAK_F32 * 1e6:.2f} us "
          f"({all_pairs:.4g} pair tests), with the pairs the skip leaves at "
          f"P = 2 / 4 / 8 "
          + " / ".join(f"{bound_ms[P] * 1e3:.2f}" for P in (2, 4, 8)) + " us")
    print(f"[{name}] {'S':>2} {'T':>4} {'P':>2} {'smem':>8} {'prune':>5} "
          f"{'ms':>9} {'us/round':>9} {'share':>7}")
    rows = []
    for S, T, P in SHAPES:
        for smem, prune in ((None, True), (None, False), (least, True)):
            if not prune and (T, P) != (512, 4):
                continue        # the skip's effect: at one block shape
            if smem is not None and (S, P) not in ((8, 4), (4, 4)):
                continue        # streaming: at the two likely cluster sizes
            build_for(P)
            kw = dict(shape=(S, T, P), smem=smem, prune=prune)
            got = cl._launch(*args, 96, 12, frame, **kw)[:3]
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise RuntimeError(f"{name}: shape {kw} differs from the "
                                   "default shape's result")
            ms = cs.device_ms(
                lambda: cl._launch(*args, 96, 12, frame, **kw), reps,
                name="cluster_components")
            rows.append((ms, S, T, P, smem, prune))
            print(f"[{name}] {S:>2} {T:>4} {P:>2} "
                  f"{smem or cl.launch_smem(N):>8} {str(prune):>5} "
                  f"{ms:>9.4f} {ms * 1e3 / r_max:>9.2f} "
                  f"{bound_ms[P] / ms:>7.4f}")
    build_for(cl.LAUNCH_SHAPE[2])
    best = min(r for r in rows if r[4] is None and r[5])
    print(f"[{name}] best resident shape with the skip: S={best[1]} "
          f"T={best[2]} P={best[3]}: {best[0]:.4f} ms; the default "
          f"{cl.LAUNCH_SHAPE}")


def orbit_scan(dev, frames, reps):
    """The default launch shape on the path's clouds of several frames."""
    print(f"[orbit] {'frame':>5} {'survivors':>9} {'rounds':>6} {'ms':>9} "
          f"{'world axes ms':>13} {'every pair ms':>13} {'bound us':>9}")
    for frame in frames:
        pts, mask, axes = path_clouds(dev, frame)["path"]
        args = cl.centre_and_seed(pts, mask, 0.02, -1)
        _, conv, rounds = cl.cluster_components(*args, 96, 12, frame=axes)
        n_d = mask.sum(1).double()
        bound_ms = float((cs.tested_pairs(*args[:3], axes, args[4],
                                          cl.LAUNCH_SHAPE[2])
                          * rounds.double()).sum()) \
            * cs.PAIR_OPS / cs.PEAK_F32 * 1e3
        ms = [cs.device_ms(lambda: cl._launch(*args, 96, 12, fr, **kw), reps,
                           name="cluster_components")
              for fr, kw in ((axes, {}), (None, {}),
                             (axes, dict(prune=False)))]
        print(f"[orbit] {frame:>5} {int(n_d.max()):>9} {int(rounds.max()):>6} "
              f"{ms[0]:>9.4f} {ms[1]:>13.4f} {ms[2]:>13.4f} "
              f"{bound_ms * 1e3:>9.2f}"
              + ("" if bool(conv.all()) else "  (not converged)"))


def each_ms(fn, reps, name="cluster_components"):
    """Every launch's device time of ``reps`` fn() calls, one launch of the
    kernel ``name`` each (ms, from the profiler's raw events; the trace is
    retaken if it lacks a launch)."""
    from torch.profiler import ProfilerActivity, profile
    first = torch.empty(8, device="cuda")
    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(8):      # a trace may lack its first launches
                first.random_()
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ms = [e.device_time_total / 1e3 for e in prof.events()
              if name in e.name and e.device_time_total > 0]
        if len(ms) == reps:
            return ms
    raise RuntimeError(f"the trace shows {len(ms)} launches of {reps}")


def critical_path(dev, frame, reps):
    """What bounds the launch on the path's frame: the spread over single
    launches, each live detection alone, and k copies of the heaviest."""
    pts, mask, axes = path_clouds(dev, frame)["path"]
    args = cl.centre_and_seed(pts, mask, 0.02, -1)
    pts_c, nrm, m, labels0, tol2 = args
    N = m.shape[1]
    n_d = m.sum(1)
    rounds = cl.cluster_components(*args, 96, 12, frame=axes)[2]
    centre = pts[:, :1].mean(1).contiguous()
    for name, fn in (
            ("camera axes", lambda: cl.cluster_components(
                *args, 96, 12, frame=axes)),
            ("world axes", lambda: cl.cluster_components(*args, 96, 12)),
            ("with the selection", lambda: cl.cluster_select(
                pts.contiguous(), *args[:4], centre, tol2, 96, 12, 100, 0.5,
                frame=axes))):
        ms = each_ms(fn, 2 * reps)
        print(f"[critical] frame {frame}, {name}: {len(ms)} launches, min "
              f"{min(ms):.4f} max {max(ms):.4f} ms")
    print(f"[critical] {'d':>2} {'survivors':>9} {'rounds':>6} {'alone ms':>9} "
          f"{'us/round':>9}")
    alone = {}
    for d in torch.nonzero(n_d).flatten().tolist():
        m1 = torch.zeros_like(m)
        m1[d] = m[d]
        l1 = torch.where(m1, labels0, N).contiguous()
        alone[d] = min(each_ms(lambda: cl.cluster_components(
            pts_c, nrm, m1, l1, tol2, 96, 12, frame=axes), reps))
        print(f"[critical] {d:>2} {int(n_d[d]):>9} {int(rounds[d]):>6} "
              f"{alone[d]:>9.4f} {alone[d] * 1e3 / int(rounds[d]):>9.2f}")
    heavy = max(alone, key=alone.get)
    print(f"[critical] the slowest detection alone: d={heavy}, "
          f"{alone[heavy]:.4f} ms; the detections one after another would "
          f"take {sum(alone.values()):.4f} ms")
    for k in (1, 8, 12, 14, 15, 16, 17, 24):
        rep = [t[heavy:heavy + 1].expand(k, *t.shape[1:]).contiguous()
               for t in (pts_c, nrm, m, labels0)]
        ms = min(each_ms(lambda: cl.cluster_components(
            *rep, tol2, 96, 12, frame=axes), reps))
        print(f"[critical] {k:>2} copies of detection {heavy}: {ms:.4f} ms")


# K13 ---------------------------------------------------------------------
GRID_SHAPES = [(S, T) for S in (1, 2, 4, 8) for T in (128, 256, 512)]
GRID_TOL, GRID_LEAF = 0.02, 0.01
# the old K13 (a lane of cluster_components, a hash table) where the phase
# clocks go: (anchor, clock inserted before it)
_OLD_CLOCKS = (
    ("    sort_frame += (size_t)frame_stride * d;", 0),
    ("    if (n == 0) {               // every block of the cluster takes",
     1),
    ("        uint16_t* nb = lane_args.nbr", 2),
    ("    int r = 0;\n    bool conv = false;", 3),
    ("    // --- labels back in the original lane numbering", 4),
    ("    if (sel.mask == nullptr || rank != 0) return;", 5),
    ("    if (tid == 0) sel.ok[d] = (chosen_ok && conv) ? 1 : 0;\n}", 5))
_OLD_CLOCK_DEFS = r'''
#define OSLAM_GRID_CLOCK_D 256
__device__ long long oslam_grid_clock[OSLAM_GRID_CLOCK_D][8][6];
#define GRID_CLOCK(i)                                                       \
    if (kPass == OSLAM_PASS_GRID && threadIdx.x == 0 &&                    \
        d < OSLAM_GRID_CLOCK_D)                                             \
        oslam_grid_clock[d][rank][i] = clock64()
extern "C" int oslam_grid_clocks(void* host)
{
    return (int)cudaMemcpyFromSymbol(host, oslam_grid_clock,
                                     sizeof(oslam_grid_clock));
}
extern "C" int oslam_grid_clocks_clear()
{
    void* at = nullptr;
    cudaError_t rc = cudaGetSymbolAddress(&at, oslam_grid_clock);
    if (rc == cudaSuccess) rc = cudaMemset(at, 0, sizeof(oslam_grid_clock));
    return (int)rc;
}
'''


def _new_grid():
    """Whether the package's K13 is a kernel of its own (grid_shape)."""
    return hasattr(cl, "grid_shape")


def grid_kernel_name():
    """The profiler's name of K13's kernel."""
    return "cluster_grid_kernel" if _new_grid() else "cluster_components"


def grid_default_shape(D, N):
    return cl.grid_shape(D, N) if _new_grid() else cl.LAUNCH_SHAPE


def grid_launch(args, outer, shape=None):
    """One K13 launch with the selection: (sel, ok, labels, converged,
    rounds).  ``shape`` (S, T), the old kernel's P its build's."""
    pts, cells, pts_w, mask = args
    labels0 = cl.grid_seed(pts, mask, GRID_TOL)
    centre = pts_w[:, 0].contiguous()
    if shape is not None and not _new_grid():
        shape = (*shape[:2], cl.LAUNCH_SHAPE[2])
    lab, conv, rounds, sel, ok = cl._launch_grid(
        pts, cells, mask, labels0, GRID_TOL, GRID_LEAF, outer, 12,
        (pts_w, centre, 100, 0.5), shape=shape)
    return sel, ok, lab, conv, rounds


def grid_inputs(dev, frame):
    """K13's inputs (camera-frame voxel points, cells, world points, mask,
    and for chip_smoke.option_checks the centre estimates and the sort
    frame) at the path frame (the frame's visible detections through the
    extractor's packing, cloud tier 4096), the full tier (its 8 largest
    boxes, the first the whole image, at capacity 16384), dense voxel
    surfaces filling 16384 lanes and the path frame's detections eight
    times over."""
    scene = cs.scene24()
    cam = scene.camera
    pose = syn.orbit_trajectory(cs.N_DEPTH_FRAMES, 3.6, 1.7)[frame]
    depth = syn.render_depth(scene.ellipsoids, pose, cam, device=dev)
    bbs, vis = syn.project_bboxes(scene.ellipsoids.astype(np.float32),
                                  pose.astype(np.float32), cam)
    plane = np.array([0.0, 0.0, 1.0, 0.0])
    flat, pad, _, cfg_t, _ = _pack_frame(
        cam, ExtractorConfig(), bbs[vis].numpy(), scene.labels[vis.numpy()],
        pose, plane)
    flat_d = torch.from_numpy(flat).to(dev)
    out = {}
    a = cs.stage_a_on_card(dev, depth, flat_d[:pad * 4].reshape(pad, 4),
                           flat_d[pad * 6:pad * 6 + 7],
                           flat_d[pad * 6 + 7:pad * 6 + 11], cam, cfg_t)
    out["path"] = a
    area = torch.where(vis, (bbs[:, 2] - bbs[:, 0]) * (bbs[:, 3] - bbs[:, 1]),
                       -1.0)
    big = bbs[torch.argsort(area, descending=True)[:cs.FE_DETECTIONS]].to(dev)
    big[0] = torch.tensor([0.0, 0.0, 639.0, 479.0], device=dev)
    a = cs.stage_a_on_card(
        dev, depth, big, torch.as_tensor(pose, dtype=torch.float32,
                                         device=dev),
        torch.tensor([0.0, 0.0, 1.0, 0.0], device=dev), cam,
        ExtractorConfig(cloud_capacity=cs.FE_TIER))
    out["full"] = a
    pts, cells, mask = (t.to(dev) for t in cs.dense_voxel_clouds(
        cs.FE_DETECTIONS, cs.FE_TIER, cs.SEED))
    R = torch.tensor([[0.6, 0.8, 0.0], [-0.8, 0.6, 0.0], [0.0, 0.0, 1.0]],
                     device=dev)
    pts_w = (pts @ R.T + torch.tensor([0.3, -0.2, 0.1], device=dev))
    pts_w = pts_w.contiguous()
    out["dense"] = (pts, cells, pts_w, mask, pts_w[:, 0].contiguous(),
                    R.T.contiguous())
    # the path frame's detections eight times over: an offline batch's
    # 256 padded detections at tier 4096
    out["batch"] = tuple(t.repeat(8, *([1] * (t.dim() - 1))).contiguous()
                         for t in out["path"][:4])
    return out


def build_grid_clocks():
    """Bind a build whose K13 records its phase clocks (the old kernel's
    source patched into a copy beside it).  Returns the library."""
    if _new_grid():
        fk.rebuild("-DOSLAM_GRID_CLOCKS")
        return fk._lib
    text = open(fk.SOURCE).read()
    anchor = "template <int P, int kPass, bool kChain>\n__global__"
    text = text.replace(anchor, _OLD_CLOCK_DEFS + anchor, 1)
    for at, i in _OLD_CLOCKS:
        if at not in text:
            raise RuntimeError(f"the old source lacks {at!r}")
        text = text.replace(at, f"    GRID_CLOCK({i});\n" + at, 1)
    patched = os.path.join(os.path.dirname(fk.SOURCE),
                           "frontend_grid_clocks.cu")
    with open(patched, "w") as f:
        f.write(text)
    source, fk.SOURCE = fk.SOURCE, patched
    try:
        fk.rebuild()
    finally:
        fk.SOURCE = source
    return fk._lib


def max_sm_mhz():
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True).stdout
    return float(out.split()[0])


def grid_phases(name, args, lib, mhz, shape=None):
    """The phase clocks of one launch (at ``shape``, else the default):
    the slowest block's cycles per phase (and µs at the card's top SM
    clock), and the rounds of its detection."""
    D, N = args[3].shape
    S = (shape or grid_default_shape(D, N))[0]
    clocks = np.zeros((256, 8, 9 if _new_grid() else 6), np.int64)
    lib.oslam_grid_clocks_clear()
    out = grid_launch(args, 96, shape)
    torch.cuda.synchronize()
    rc = lib.oslam_grid_clocks(ctypes.c_void_p(clocks.ctypes.data))
    if rc:
        raise RuntimeError(f"oslam_grid_clocks returned {rc}")
    rounds = out[4].tolist()
    n_d = args[3].sum(1).tolist()
    best = None
    for d in range(min(D, 256)):
        for r in range(S):
            c = clocks[d, r]
            if n_d[d] == 0 or c[5] == 0 or c[0] == 0:
                continue
            if best is None or c[5] - c[0] > best[2][5] - best[2][0]:
                best = (d, r, c)
    d, r, c = best
    ph = np.diff(c[:6])
    names = ("compaction", "key table", "neighbour lists", "rounds",
             "write-back + selection")
    total = c[5] - c[0]
    print(f"[grid clocks] {name} at {shape or grid_default_shape(D, N)}: "
          f"slowest block d={d} rank {r} "
          f"({n_d[d]} survivors, {rounds[d]} rounds): {total} cycles "
          f"({total / mhz:.2f} us at {mhz:.0f} MHz); "
          + "; ".join(f"{k} {v} ({v / mhz:.2f} us)"
                      for k, v in zip(names, ph))
          + f"; a round {ph[3] / max(rounds[d], 1):.0f} cycles "
          f"({ph[3] / max(rounds[d], 1) / mhz:.3f} us)"
          + ("" if len(c) < 9 else
             "; a round's pass / exchange / changed test and jumps "
             + " / ".join(f"{v / max(rounds[d], 1):.0f}" for v in c[6:9])
             + " cycles"))


def grid_bound_ms(args, out):
    """chip_smoke.py's bound for K13: inputs and outputs once (bytes)."""
    pts, cells, pts_w, mask = args
    labels0 = cl.grid_seed(pts, mask, GRID_TOL)
    return cs.bytes_bound([pts, cells, mask, labels0, pts_w,
                           pts_w[:, 0].contiguous(), *out])[0]


def grid_sweep(name, args, reps):
    """K13 over GRID_SHAPES: ms, µs a round of the longest detection,
    share of the bound, the waves of clusters; every shape's outputs held
    against the default shape's."""
    D, N = args[3].shape
    default = grid_default_shape(D, N)
    want = grid_launch(args, 96)
    torch.cuda.synchronize()
    bound = grid_bound_ms(args, want)
    r_max = int(want[4].max())
    n_d = args[3].sum(1)
    live = int((n_d > 0).sum())
    print(f"[grid {name}] D={D}, N={N}, {live} live detections, survivors "
          f"max {int(n_d.max())}, rounds {want[4].tolist()}; bound "
          f"{bound * 1e3:.3f} us (bytes); default shape {default}")
    print(f"[grid {name}] {'S':>2} {'T':>4} {'ms':>9} {'us/round':>9} "
          f"{'share':>7} {'clusters':>8} {'waves':>5}")
    rows = []
    for S, T in GRID_SHAPES:
        got = grid_launch(args, 96, (S, T))
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise RuntimeError(f"K13 {name}: shape {(S, T)} differs from "
                               "the default shape's result")
        ms = cs.device_ms(lambda: grid_launch(args, 96, (S, T)), reps,
                          name=grid_kernel_name())
        clusters = waves = "-"
        if _new_grid():
            held = ctypes.c_int(0)
            rc = fk._load().oslam_cluster_grid_max_clusters(
                S, T, cl.grid_smem(N), ctypes.byref(held))
            if rc == 0 and held.value:
                clusters = held.value
                waves = -(-D // held.value)
        rows.append((ms, S, T))
        print(f"[grid {name}] {S:>2} {T:>4} {ms:>9.4f} "
              f"{ms * 1e3 / r_max:>9.2f} {bound / ms:>7.4f} "
              f"{clusters:>8} {waves:>5}")
    best = min(rows)
    print(f"[grid {name}] fastest shape S={best[1]} T={best[2]}: "
          f"{best[0]:.4f} ms")


def grid_waves(args, reps):
    """K13 at T = 512 over blocks a detection S and detections D (the
    path frame's 32 detection lanes 1, 2, 4 and 8 times over), with the
    waves of clusters: where the host's choice of S by D turns."""
    print(f"[grid waves] {'D':>4} " + " ".join(f"{'S=' + str(S):>9}"
                                            for S in (1, 2, 4, 8))
          + "   (ms; waves in brackets)")
    for k in (1, 2, 4, 8):
        rep = tuple(t.repeat(k, *([1] * (t.dim() - 1))).contiguous()
                    for t in args)
        D, N = rep[3].shape
        cells = []
        for S in (1, 2, 4, 8):
            ms = cs.device_ms(lambda: grid_launch(rep, 96, (S, 512)), reps,
                              name=grid_kernel_name())
            waves = "-"
            if _new_grid():
                held = ctypes.c_int(0)
                if fk._load().oslam_cluster_grid_max_clusters(
                        S, 512, cl.grid_smem(N), ctypes.byref(held)) == 0:
                    waves = -(-D // max(held.value, 1))
            cells.append(f"{ms:.4f} ({waves})")
        print(f"[grid waves] {D:>4} " + " ".join(f"{c:>12}" for c in cells))


def grid_critical_path(tag, args, reps):
    """What bounds a K13 launch: the spread over single launches, each
    live detection alone, k copies of the heaviest."""
    pts, cells, pts_w, mask = args
    n_d = mask.sum(1)
    rounds = grid_launch(args, 96)[4]
    name = grid_kernel_name()
    ms = each_ms(lambda: grid_launch(args, 96), 2 * reps, name)
    print(f"[grid critical {tag}] {len(ms)} launches, min {min(ms):.4f} "
          f"max {max(ms):.4f} ms")
    print(f"[grid critical {tag}] {'d':>2} {'survivors':>9} {'rounds':>6} "
          f"{'alone ms':>9} {'us/round':>9}")
    alone = {}
    for d in torch.nonzero(n_d).flatten().tolist():
        m1 = torch.zeros_like(mask)
        m1[d] = mask[d]
        alone[d] = min(each_ms(lambda: grid_launch(
            (pts, cells, pts_w, m1.contiguous()), 96), reps, name))
        print(f"[grid critical {tag}] {d:>2} {int(n_d[d]):>9} "
              f"{int(rounds[d]):>6} {alone[d]:>9.4f} "
              f"{alone[d] * 1e3 / int(rounds[d]):>9.2f}")
    heavy = max(alone, key=alone.get)
    print(f"[grid critical {tag}] the slowest detection alone: d={heavy}, "
          f"{alone[heavy]:.4f} ms; one after another "
          f"{sum(alone.values()):.4f} ms")
    for k in (1, 8, 16, 24, 32, 64, 132, 133):
        rep = tuple(t[heavy:heavy + 1].expand(k, *t.shape[1:]).contiguous()
                    for t in args)
        ms = min(each_ms(lambda: grid_launch(rep, 96), reps, name))
        print(f"[grid critical {tag}] {k:>3} copies of detection {heavy}: "
              f"{ms:.4f} ms")


def grid_main(dev, ns):
    """--grid: K13's phase clocks, shape sweep and critical path."""
    print(f"[grid] the package at {_ROOT}: K13 "
          f"{'a kernel of its own' if _new_grid() else 'a lane of cluster_components'}"
          f", profiler name {grid_kernel_name()!r}")
    inputs = {k: v[:4] for k, v in grid_inputs(dev, ns.frame).items()}
    lib = build_grid_clocks()
    mhz = max_sm_mhz()
    for name, args in inputs.items():
        grid_phases(name, args, lib, mhz)
        grid_phases(name, args, lib, mhz, (1, 512))
    fk.rebuild()
    for name, args in inputs.items():
        grid_sweep(name, args, ns.reps)
    grid_waves(inputs["path"], ns.reps)
    for name in ("path", "full", "dense"):
        grid_critical_path(name, inputs[name], ns.reps)
    return 0


def lanes_main(dev, ns):
    """--lanes: chip_smoke.option_checks of the package at hand (K13 and
    K5's exact and chain lanes against their plain versions, each timed
    beside K5's default on the same inputs) at the path frame, the full
    tier and the dense surfaces; run it once per checkout, in turns."""
    inputs = grid_inputs(dev, ns.frame)
    for name in ("path", "full", "dense"):
        cs.option_checks(dev, name, *inputs[name], 96)
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frame", type=int, default=cs.N_DEPTH_FRAMES // 2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--grid", action="store_true",
                    help="K13 (cluster_grid) instead of cluster_components")
    ap.add_argument("--lanes", action="store_true",
                    help="K13 and K5's lanes beside K5's default "
                         "(chip_smoke.option_checks) instead")
    ap.add_argument("--root", default=None,
                    help="with --grid or --lanes: the checkout whose "
                         "package and chip_smoke.py to time")
    ns = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_cluster_sweep: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(f"[card] {cs.card_line()}")
    if ns.grid:
        return grid_main(dev, ns)
    if ns.lanes:
        return lanes_main(dev, ns)
    clouds = path_clouds(dev, ns.frame)
    clouds["dense"] = cs.dense_cloud(cs.FE_DETECTIONS, cs.FE_TIER, cs.SEED,
                                     dev)
    clouds["dense-shuffled"] = cs.dense_cloud(
        cs.FE_DETECTIONS, cs.FE_TIER, cs.SEED, dev, shuffled=(1, 3, 5))
    for name, (pts, mask, frame) in clouds.items():
        sweep(name, pts, mask, frame, 0 if name.startswith("dense") else -1,
              ns.reps)
    orbit_scan(dev, range(4, cs.N_DEPTH_FRAMES, 12), ns.reps)
    critical_path(dev, ns.frame, ns.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
