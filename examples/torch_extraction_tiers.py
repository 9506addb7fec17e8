"""One extraction call at the cloud tier of the depth path and at the top
tier, under the profiler.

    python3 examples/torch_extraction_tiers.py

The depth scene's mid-orbit frame goes through ``make_extractor`` twice:
with its own detections (cloud tier 4096 on this scene), and with a
whole-image detection added (34,240 strided pixels: the tier rises to
16384, where a near object puts it).  For each call it prints the tier,
the wall time (host clock, mean of 5), the device busy time and the device
operations (profiler), the frontend kernel launches and the device time
of each frontend kernel inside the call.  Run it in two checkouts from one
command to compare two versions of the kernels on the same card.  Needs an
NVIDIA GPU and nvcc.
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from object_oriented_slam_tpu_torch.frontend import (  # noqa: E402
    ExtractorConfig, make_extractor)
from object_oriented_slam_tpu_torch.io import synthetic as syn  # noqa: E402
from object_oriented_slam_tpu_torch.ops import frontend_kernels as fk  # noqa: E402

FRONTEND = ("depth_cloud", "voxel_downsample", "cluster_components",
            "symmetry_search")


def profile_call(extractor, depth, det, pose, plane):
    """(tier, wall ms, device busy ms, device operations, frontend launches,
    {frontend kernel: device ms}) of one extraction call."""
    def call():
        return extractor(depth, det[:, 1:5].copy(), det[:, 5].astype(int),
                         pose, plane)

    call()
    tier = extractor.stats["cloud_tier"]
    wall = cs.wall_ms(call, 5)
    before = {k.name: k.launches for k in fk.KERNELS}
    events = cs.profiled(call)
    launches = {k.name: k.launches - before[k.name] for k in fk.KERNELS
                if k.launches > before[k.name]}
    if not events:
        raise RuntimeError("the profiler shows no device time")
    busy = sum(e.self_device_time_total for e in events) / 1e3
    ops = sum(e.count for e in events)
    kernels = {name: round(sum(e.self_device_time_total for e in events
                               if name in e.key) / 1e3, 4)
               for name in FRONTEND}
    return tier, wall, busy, ops, launches, {k: v for k, v in kernels.items()
                                             if v > 0}


def main():
    if not torch.cuda.is_available():
        print("torch_extraction_tiers: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(f"[card] {cs.card_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    scene = cs.scene24()
    cam = scene.camera
    ds = syn.SyntheticDataset(scene, n_frames=cs.N_DEPTH_FRAMES,
                              orbit_radius=3.6, height=1.7, depth_device=dev)
    for i, _, pose, depth, _, det in ds.frames():
        if i == cs.N_DEPTH_FRAMES // 2:
            break
    plane = np.array([0.0, 0.0, 1.0, 0.0])
    whole = det[:1].copy()
    whole[0, 1:5] = (0.0, 0.0, float(cam.width), float(cam.height))
    extractor = make_extractor(cam, ExtractorConfig())
    for tag, d in (("the frame's detections", det),
                   ("with a whole-image detection", np.concatenate(
                       [det, whole]))):
        tier, wall, busy, ops, launches, kernels = profile_call(
            extractor, depth, d, pose, plane)
        print(f"[tiers] {tag} ({len(d)}): cloud tier {tier}; wall "
              f"{wall:.3f} ms (host clock, mean of 5); device busy "
              f"{busy:.4f} ms over {ops} device operations, idle share "
              f"{1 - busy / wall:.3f}; frontend launches {launches}; "
              f"frontend kernels' device ms {kernels}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
