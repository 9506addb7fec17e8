#!/usr/bin/env python
"""Export a synthetic scene of the PyTorch port as a TUM RGB-D directory.

Twin of ``examples/make_synthetic_tum.py`` over the port's
``io/synthetic.py``: the same layout and rows (``rgb/``, ``depth/``,
``bbox/``, ``groundtruth.txt``, ``associate.txt``,
``associateGroundtruth.txt``, ``objects_gt.txt`` and, with
``--odometry-noise``, ``odometry.txt``) and the same corruption draws, with
no ``cv2``: depth is a 16-bit PNG and RGB an 8-bit PNG, both written by the
port's codec (``io/png.py``, Up filter).

    python examples/torch_make_synthetic_tum.py /tmp/synth_seq \\
        --objects 12 --frames 48
    python examples/torch_run_tum.py \\
        object_oriented_slam_tpu_torch/configs/synthetic_depth.yaml \\
        /tmp/synth_seq --out /tmp/synth_run --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def export_synthetic_tum(out_dir, scene, dataset, odometry_noise=0.0,
                         seed=2, depth_noise=0.0, bbox_jitter=0.0,
                         det_dropout=0.0):
    """Write ``dataset`` (the port's ``io.synthetic.SyntheticDataset`` of
    ``scene``) to ``out_dir``.

    Corruption knobs, drawn from ``np.random.default_rng(seed)`` in the
    JAX exporter's order (per frame: depth, odometry, then each detection
    row's dropout and jitter):
      depth_noise  per-pixel gaussian sigma in METERS on valid depth
      bbox_jitter  gaussian sigma in PIXELS on every bbox corner
      det_dropout  probability of dropping each detection row
    Returns the number of frames written.
    """
    import numpy as np

    from object_oriented_slam_tpu_torch.io.png import write_png

    for sub in ("rgb", "depth", "bbox"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

    rng = np.random.default_rng(seed)
    cam = scene.camera
    gt_rows, assoc_rows, agt_rows, odo_rows = [], [], [], []
    drift = np.zeros(3)
    n = 0
    for i, ts, pose, depth, rgb, det in dataset.frames():
        ts = 1000.0 + i / 30.0
        stem = f"{ts:.4f}"
        ts6 = f"{ts:.6f}"
        depth_arr = np.asarray(depth).astype(np.float64)
        if depth_noise > 0:
            valid = depth_arr > 0
            depth_arr = np.where(
                valid, depth_arr + rng.normal(
                    0, depth_noise * cam.scale, depth_arr.shape), 0.0)
        depth_u16 = np.clip(depth_arr, 0, 65535).astype(np.uint16)
        write_png(os.path.join(out_dir, "depth", stem + ".png"), depth_u16)
        if rgb is None:
            # flat gray with a depth-modulated channel so files are
            # nontrivial; the mapping path never reads rgb
            rgb8 = np.full(depth_u16.shape + (3,), 128, np.uint8)
            rgb8[..., 1] = (depth_u16 >> 8).astype(np.uint8)
        else:
            rgb8 = np.asarray(rgb, np.uint8)
        write_png(os.path.join(out_dir, "rgb", stem + ".png"), rgb8)

        pose_str = " ".join(f"{v:.4f}" for v in pose)
        gt_rows.append(f"{stem} {pose_str}")
        assoc_rows.append(f"{ts6} rgb/{stem}.png {ts6} depth/{stem}.png")
        agt_rows.append(f"{ts6} rgb/{stem}.png {ts6} {pose_str}")
        if odometry_noise > 0:
            drift = drift + rng.normal(0, odometry_noise, 3)
            op = pose.copy()
            op[:3] += drift
            odo_rows.append(f"{stem} " + " ".join(f"{v:.4f}" for v in op))

        with open(os.path.join(out_dir, "bbox", stem + ".txt"), "w") as f:
            for row in np.asarray(det, np.float64).reshape(-1, 8):
                if det_dropout > 0 and rng.random() < det_dropout:
                    continue
                if bbox_jitter > 0:
                    row = row.copy()
                    row[1:5] += rng.normal(0, bbox_jitter, 4)
                    row[1:5] = np.clip(
                        row[1:5], 0, [cam.width - 1, cam.height - 1,
                                      cam.width - 1, cam.height - 1])
                f.write(" ".join(f"{v:.4f}" for v in row) + "\n")
        n += 1

    for name, rows in (("groundtruth.txt", gt_rows),
                       ("associate.txt", assoc_rows),
                       ("associateGroundtruth.txt", agt_rows)):
        with open(os.path.join(out_dir, name), "w") as f:
            f.write("\n".join(rows) + "\n")
    if odo_rows:
        with open(os.path.join(out_dir, "odometry.txt"), "w") as f:
            f.write("\n".join(odo_rows) + "\n")

    with open(os.path.join(out_dir, "objects_gt.txt"), "w") as f:
        for k, e in enumerate(np.asarray(scene.ellipsoids)):
            f.write(f"{k} " + " ".join(f"{v:.6f}" for v in e) + "\n")
    return n


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--objects", type=int, default=12)
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--radius", type=float, default=3.4)
    ap.add_argument("--height", type=float, default=1.6)
    ap.add_argument("--radius-range", type=float, nargs=2,
                    default=(0.4, 1.5), metavar=("LO", "HI"),
                    help="the objects' distance from the orbit's centre (m)")
    ap.add_argument("--scale-range", type=float, nargs=2,
                    default=(0.15, 0.45), metavar=("LO", "HI"),
                    help="the objects' semi-axes (m)")
    ap.add_argument("--odometry-noise", type=float, default=0.0,
                    help="per-frame random-walk translation noise (m); "
                         "writes odometry.txt when > 0")
    args = ap.parse_args(argv)

    from object_oriented_slam_tpu_torch.io.synthetic import (
        SyntheticDataset, default_camera, make_scene)

    scene = make_scene(n_objects=args.objects, seed=args.seed,
                       camera=default_camera(),
                       radius_range=tuple(args.radius_range),
                       scale_range=tuple(args.scale_range))
    ds = SyntheticDataset(scene, n_frames=args.frames,
                          orbit_radius=args.radius, height=args.height)
    n = export_synthetic_tum(args.out_dir, scene, ds,
                             odometry_noise=args.odometry_noise)
    print(f"wrote {n} frames to {args.out_dir}")


if __name__ == "__main__":
    main()
