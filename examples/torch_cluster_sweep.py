"""Launch-shape sweep of the clustering kernel on one NVIDIA GPU.

    python3 examples/torch_cluster_sweep.py [--frame 80] [--reps 5]

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
"""
import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

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


def each_ms(fn, reps):
    """Every launch's device time of ``reps`` fn() calls, one
    ``cluster_components`` launch each (ms, from the profiler's raw events;
    the trace is retaken if it lacks a launch)."""
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
              if "cluster_components" in e.name and e.device_time_total > 0]
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frame", type=int, default=cs.N_DEPTH_FRAMES // 2)
    ap.add_argument("--reps", type=int, default=5)
    ns = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_cluster_sweep: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(f"[card] {cs.card_line()}")
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
