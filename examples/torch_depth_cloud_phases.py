"""Where the time of the fused downsample kernels goes, phase by phase.

    python3 examples/torch_depth_cloud_phases.py

Builds csrc/frontend.cu once more with -DOSLAM_DS_CLOCKS (thread 0 of each
block of a detection's cluster records clock64() at the phase boundaries
of ``depth_cloud`` and ``voxel_downsample``) and runs both kernels on the depth scene's mid-orbit
frame at the extractor's shapes (32 detection lanes, its cloud tier), and
``depth_cloud`` at the full tier (the 7 largest boxes and the whole image,
capacity 16384).  For each launch it prints its device time (the
profiler's kernel events over 20 launches of the default build, which has
no clocks) and the cycles of each phase, of the slowest block (with its
share of the launch) and summed over the live blocks: centre estimate,
compaction (with the cluster's counts and cell range), keys, radix sort,
point layout + segment starts, means + epilogue, the closing flag (each
ends at the cluster barrier after it, so a block's phase includes its
wait for the others).  The clock build's outputs are
held bit for bit against the default build's.  Needs an NVIDIA GPU and nvcc.
"""
import ctypes
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from object_oriented_slam_tpu_torch.frontend import ExtractorConfig  # noqa: E402
from object_oriented_slam_tpu_torch.frontend.extractor import (  # noqa: E402
    _cluster_select_batch, _pack_frame)
from object_oriented_slam_tpu_torch.io import synthetic as syn  # noqa: E402
from object_oriented_slam_tpu_torch.ops import backproject as bp  # noqa: E402
from object_oriented_slam_tpu_torch.ops import depth_cloud as dc  # noqa: E402
from object_oriented_slam_tpu_torch.ops import frontend_kernels as fk  # noqa: E402
from object_oriented_slam_tpu_torch.ops import voxel as vx  # noqa: E402

PHASES = ("centre", "compaction", "keys", "radix sort",
          "layout + segments", "means + epilogue", "flag")


def clocks(D):
    """[D, 8, 8] clock64() stamps of the last launch's first D detections
    (the stamps are cleared before it: cluster ranks past its cluster size
    stay 0)."""
    fn = fk._lib.oslam_ds_clocks
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    buf = np.zeros((64, 8, 8), np.int64)
    torch.cuda.synchronize()
    if fn(buf.ctypes.data) != 0:
        raise RuntimeError("oslam_ds_clocks failed")
    return buf[:D]


def report(name, kernel, launch, live):
    """Times ``launch`` in the default build, then runs it in the clock
    build and prints the phases of the blocks whose detection has a live
    point (``live`` [D, points] bool; the others skip the sort and keep
    stale stamps)."""
    fk.rebuild()
    want = launch()
    ms = cs.device_ms(launch, 20, name=kernel)
    fk.rebuild("-DOSLAM_DS_CLOCKS")
    clear = fk._lib.oslam_ds_clocks_clear
    clear.restype = ctypes.c_int
    if clear() != 0:
        raise RuntimeError("oslam_ds_clocks_clear failed")
    got = launch()
    if not cs.all_bits(got, want):
        raise RuntimeError(f"{name}: the clock build's outputs differ")
    live = live.any(1).cpu().numpy()
    stamps = clocks(len(live))[live].reshape(-1, 8)
    stamps = stamps[stamps[:, -1] != 0]         # the blocks that ran
    spans = np.diff(stamps, axis=1)             # [live blocks, 7]
    slow = int(np.argmax(stamps[:, -1] - stamps[:, 0]))
    total = stamps[slow, -1] - stamps[slow, 0]
    print(f"[phases] {name}: {ms:.4f} ms a launch (profiler, default "
          f"build); {len(stamps)} live blocks; the slowest {total} cycles")
    for k, p in enumerate(PHASES):
        share = spans[slow, k] / total
        print(f"[phases]   {p:18s} slowest block {spans[slow, k]:8d} cycles "
              f"({share:.3f}, ~{share * ms * 1e3:.2f} us); all live blocks "
              f"{spans[:, k].sum():9d}")


def main():
    if not torch.cuda.is_available():
        print("torch_depth_cloud_phases: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(f"[card] {cs.card_line()}")
    scene = cs.scene24()
    cam = scene.camera
    pose = syn.orbit_trajectory(cs.N_DEPTH_FRAMES, 3.6, 1.7)[
        cs.N_DEPTH_FRAMES // 2]
    depth = syn.render_depth(scene.ellipsoids, pose, cam, device=dev)
    bbs, vis = syn.project_bboxes(scene.ellipsoids.astype(np.float32),
                                  pose.astype(np.float32), cam)
    plane = np.array([0.0, 0.0, 1.0, 0.0])
    cfg = ExtractorConfig()
    flat, pad, _, cfg_t, _ = _pack_frame(
        cam, cfg, bbs[vis].numpy(), scene.labels[vis.numpy()], pose, plane)
    flat_d = torch.from_numpy(flat).to(dev)
    boxes = flat_d[:pad * 4].reshape(pad, 4)
    pose_d = flat_d[pad * 6:pad * 6 + 7]
    plane_d = flat_d[pad * 6 + 7:pad * 6 + 11]
    rest = (cfg_t.voxel_leaf, cfg_t.depth_range, cfg_t.plane_clearance)

    def cloud(b, capacity):
        return lambda: tuple(dc.depth_cloud(depth, b, pose_d, plane_d, cam,
                                            *rest, capacity)[:6])

    live = bp.bbox_point_cloud_plain(depth, boxes, cam, cfg.depth_range)[1]
    report(f"depth_cloud, path (D={pad}, tier {cfg_t.cloud_capacity})",
           "depth_cloud", cloud(boxes, cfg_t.cloud_capacity), live)
    out = dc.depth_cloud(depth, boxes, pose_d, plane_d, cam, *rest,
                         cfg_t.cloud_capacity)
    sel, _ = _cluster_select_batch(out.pts_w, out.m2, out.center_w, out.R_wc,
                                   cfg_t)
    report(f"voxel_downsample, path (D={pad}, {sel.shape[1]} lanes, "
           f"{int(sel.sum())} live points)", "voxel_downsample",
           lambda: vx.voxel_downsample(out.pts_w, sel, cfg.sym_grid,
                                       cfg.sym_capacity),
           sel)
    area = torch.where(vis, (bbs[:, 2] - bbs[:, 0]) * (bbs[:, 3] - bbs[:, 1]),
                       -1.0)
    big = bbs[torch.argsort(area, descending=True)[:cs.FE_DETECTIONS - 1]]
    whole = torch.tensor([[0.0, 0.0, float(cam.width), float(cam.height)]])
    full = torch.cat([big, whole]).to(dev)
    report("depth_cloud, full tier (8 boxes, one the whole image, capacity "
           f"{cs.FE_TIER})", "depth_cloud", cloud(full, cs.FE_TIER),
           bp.bbox_point_cloud_plain(depth, full, cam, cfg.depth_range)[1])
    fk.rebuild()
    return 0


if __name__ == "__main__":
    sys.exit(main())
