"""The degenerate-seed case of the depth path, on a chosen device.

    python3 examples/torch_fragment_seed.py [--device cuda|cpu]

Runs the 6-object, 12-frame synthetic depth sequence of
tests/test_torch_depth_slice.py at ``cluster_min_size=30`` and
``cloud_capacity=2048``.  On frame 3 a 30-point fragment passes the cluster
gate and seeds object 3 with scales of about (0.104, 0.018, 0.029).  At that
estimate one projected conic's minor semi-axis^2 rounds below zero in the
port's normal equations: its bbox half-width is sqrt(max(., 0)) = 0 with a
NaN tangent.  Such an edge is left out of H and g for the iteration
(backend/lm_soa.soa_normal_eq_plain, and the ``ba_normal_eq`` kernel on a
CUDA device), so H stays finite and the object moves on, as it does in the
JAX package; before that repair H was non-finite and the ``du_ok`` gate
zeroed every step of the object (ROADMAP.md, queue 3).

Prints, per object: whether it was seeded from a 3D estimate, the distinct
estimates in its history, its first and last scales, its centre error; and
for the batch after the last frame whether each object's H is finite (on a
CUDA device that is the ``ba_normal_eq`` kernel's H, on the CPU the plain
version's; on a CUDA device the two are also compared).  The last line
says whether object 3 froze; the script exits non-zero if it did, if an H
is not finite or if kernel and plain version disagree.
"""
import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import object_oriented_slam_tpu_torch as pkg  # noqa: E402
from object_oriented_slam_tpu_torch.backend import lm_soa  # noqa: E402
from object_oriented_slam_tpu_torch.frontend import (  # noqa: E402
    ExtractorConfig, make_extractor, make_plane_estimator)
from object_oriented_slam_tpu_torch.io import synthetic as syn  # noqa: E402
from object_oriented_slam_tpu_torch.system import System  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    yaml = os.path.join(os.path.dirname(pkg.__file__), "configs",
                        "synthetic_depth.yaml")
    scene = syn.make_scene(n_objects=6, seed=3, radius_range=(1.3, 2.2),
                           scale_range=(0.2, 0.4))
    cam = scene.camera
    frames = list(syn.SyntheticDataset(scene, n_frames=12, orbit_radius=3.6,
                                       height=1.7).frames())
    cfg = ExtractorConfig(cloud_capacity=2048, cluster_min_size=30)
    slam = System(yaml, extractor=make_extractor(cam, cfg, device=dev),
                  plane_estimator=make_plane_estimator(cam, device=dev),
                  device=dev)
    slam.open_ground_plane_estimation()
    for i, ts, pose, depth, rgb, det in frames:
        slam.track_with_objects(ts, pose, det, depth=depth)
    tr = slam.tracker
    tr.sync()

    # H of the batch as it stands after the last frame
    prep = tr._prepare_backend()
    obs = tr._unpack(prep)
    K = tr._K_dev
    n = torch.as_tensor(prep["normal"], dtype=torch.float32, device=K.device)
    sp = lm_soa.soa_prepare(obs.pose2d_cw, obs.bbox2d, obs.pose3d_wc,
                            obs.meas3d)
    w2, w3, wg = lm_soa.soa_edge_weights(obs, sp, K, prep["gset"], tr.lm_cfg)
    H, _, _ = lm_soa.soa_normal_eq(obs.est0, sp, w2, w3, wg, n, K,
                                   tr.lm_cfg.huber_delta)
    finite = torch.isfinite(H).flatten(1).all(1).cpu().numpy()
    agree = True
    if dev.type == "cuda":
        # the kernel's H against the plain version's on the same tensors
        Hp, _, _ = lm_soa.soa_normal_eq_plain(obs.est0, sp, w2, w3, wg, n, K,
                                              tr.lm_cfg.huber_delta)
        scale = Hp.abs().flatten(1).amax(1).clamp_min(1e-30)
        rel = float(((H - Hp).abs().flatten(1).amax(1) / scale).max())
        agree = bool(torch.isfinite(Hp).all()) and rel <= 1e-4
        print(f"ba_normal_eq kernel against the plain version on the card: "
              f"max |dH| / max|H| per object {rel:.3g} (limit 1e-4), plain H "
              f"finite {bool(torch.isfinite(Hp).all())}")
    slot_of = {inst: slot for slot, inst in prep["slots"]}

    np.set_printoptions(precision=4, suppress=True)
    frozen = {}
    for inst, rec in sorted(tr.state.objects.items()):
        if not rec.initialized:
            continue
        hist = np.stack(rec.history)[:, 2:]     # vec9 rows: xyz, rpy, scales
        distinct = len(np.unique(hist.round(7), axis=0))
        frozen[inst] = distinct == 1 and len(hist) > 1
        err = np.linalg.norm(rec.vec10[:3] - scene.ellipsoids[inst][:3])
        print(f"object {inst}: init_by_3d {rec.init_by_3d}, {len(hist)} LM "
              f"results, {distinct} distinct; scales first {hist[0][6:]} "
              f"last {hist[-1][6:]}; centre error {err:.4f} m; H finite "
              f"{bool(finite[slot_of[inst]])}")
    bad = [i for i, s in slot_of.items() if not finite[s]]
    print(f"device {dev}: object 3 frozen at its fragment seed: "
          f"{frozen.get(3)}; objects with a non-finite H: {bad}")
    return 1 if frozen.get(3, True) or bad or not agree else 0


if __name__ == "__main__":
    sys.exit(main())
