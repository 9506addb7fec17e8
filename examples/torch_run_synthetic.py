"""The port's online depth path on a generated scene (the counterpart of
``examples/run_tum.py`` for ``object_oriented_slam_tpu_torch``).

    python3 examples/torch_run_synthetic.py --frames 160 --out out/
    python3 examples/torch_run_synthetic.py --device cpu --frames 6 --objects 4
    python3 examples/torch_run_synthetic.py \
        --settings object_oriented_slam_tpu_torch/configs/synthetic_depth_sym.yaml

Builds the extractor and the plane estimator from the settings file's
``EllipsoidExtraction.*`` / ``EllipsoidExtractor_DEPTH_RANGE`` / ``Plane.*``
keys as ``run_tum.py`` does (``EllipsoidExtraction.Symmetry.Open: 1``, as in
synthetic_depth_sym.yaml, turns symmetry completion on), runs ground plane
-> per-frame monolithic extraction -> 3D observations -> LM on ``--device``
(the CUDA device by default; there is no fall-back), writes ``objects.txt``
and prints the per-stage host times and every kernel's launch count.
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from object_oriented_slam_tpu_torch.backend import ba_kernels  # noqa: E402
from object_oriented_slam_tpu_torch.core.camera import Camera  # noqa: E402
from object_oriented_slam_tpu_torch.frontend import (  # noqa: E402
    ExtractorConfig, GroundPlaneConfig, make_extractor, make_plane_estimator)
from object_oriented_slam_tpu_torch.io.config import Config  # noqa: E402
from object_oriented_slam_tpu_torch.io.synthetic import (  # noqa: E402
    SyntheticDataset, make_scene)
from object_oriented_slam_tpu_torch.ops import frontend_kernels  # noqa: E402
from object_oriented_slam_tpu_torch.system import System  # noqa: E402

DEFAULT_SETTINGS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "object_oriented_slam_tpu_torch", "configs", "synthetic_depth.yaml")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--settings", default=DEFAULT_SETTINGS)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--objects", type=int, default=24)
    ap.add_argument("--frames", type=int, default=160)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=".")
    args = ap.parse_args()

    cfg = Config(args.settings)
    cam = Camera(fx=cfg.get_float("Camera.fx"), fy=cfg.get_float("Camera.fy"),
                 cx=cfg.get_float("Camera.cx"), cy=cfg.get_float("Camera.cy"),
                 scale=cfg.get_float("Camera.scale"),
                 width=cfg.get_int("Camera.width", 640),
                 height=cfg.get_int("Camera.height", 480))
    ext_cfg = ExtractorConfig(
        depth_range=cfg.read_value("EllipsoidExtractor_DEPTH_RANGE", 6.0),
        cluster_tolerance=cfg.get_float(
            "EllipsoidExtraction.Euclidean.ClusterTolerance", 0.02),
        cluster_min_size=cfg.get_int(
            "EllipsoidExtraction.Euclidean.MinClusterSize", 100),
        cluster_center_dis=cfg.get_float(
            "EllipsoidExtraction.Euclidean.CenterDis", 0.5),
        sym_grid=cfg.get_float("EllipsoidExtraction.Symmetry.GridSize", 0.1),
        open_symmetry=cfg.get_int("EllipsoidExtraction.Symmetry.Open") == 1)
    plane_cfg = GroundPlaneConfig(
        angle_threshold_deg=cfg.get_float("Plane.AngleThreshold", 5.0),
        distance_threshold=cfg.get_float("Plane.DistanceThreshold", 0.1),
        min_size=cfg.get_int("Plane.MinSize", 200))

    scene = make_scene(n_objects=args.objects, seed=args.seed, camera=cam,
                       radius_range=(1.3, 2.2), scale_range=(0.2, 0.4))
    ds = SyntheticDataset(scene, n_frames=args.frames, orbit_radius=3.6,
                          height=1.7)
    slam = System(args.settings,
                  extractor=make_extractor(cam, ext_cfg, device=args.device),
                  plane_estimator=make_plane_estimator(cam, plane_cfg,
                                                       device=args.device),
                  device=args.device)
    slam.open_ground_plane_estimation()

    t0 = time.perf_counter()
    for i, ts, pose, depth, rgb, det in ds.frames():
        slam.track_with_objects(ts, pose, det, depth=depth)
    objs = slam.map_objects
    wall = time.perf_counter() - t0
    os.makedirs(args.out, exist_ok=True)
    slam.save_objects_to_file(os.path.join(args.out, "objects.txt"))

    m = slam.tracker.metrics
    err = [np.linalg.norm(v[:3] - scene.ellipsoids[i][:3])
           for i, v in objs.items()]
    print(f"{args.frames} frames on {slam.tracker.device} in {wall:.2f} s "
          f"(depth rendering included); {len(objs)}/{args.objects} objects, "
          f"median centre error {np.median(err) if err else float('nan'):.3g}"
          f" m; ground plane {slam.tracker.state.ground_plane}")
    print("Timing (host ms/frame, mean): extraction dispatch "
          f"{1e3 * np.mean(m['dispatch']):.3f}, fetch "
          f"{1e3 * np.mean(m['fetch']):.3f}, backend "
          f"{1e3 * np.mean(m['backend']):.3f}, total "
          f"{1e3 * np.mean(m['total']):.3f}")
    print("Kernel launches:", {k.name: k.launches for k in
                               (*ba_kernels.KERNELS,
                                *frontend_kernels.KERNELS)})


if __name__ == "__main__":
    main()
