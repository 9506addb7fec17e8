"""The JAX package's SLAM mode on a checkpoint the port recorded, on the CPU:
the reference for ``chip_smoke.py``'s ``[slam]`` refinement.

    python3 chip_smoke.py --keep DIR                 # on the card
    python3 tests/jax_slam_on_checkpoint.py DIR      # here, with JAX

DIR holds what ``--keep`` copies: ``slam_state.npz`` (the port's
``save_state`` after the online run), ``groundtruth.txt`` and
``objects_gt.txt`` of the export, and the run's ``trajectory_refined.txt``,
``objects_slam.txt`` and ``objects.txt``.  The script

  * packs the graph with both packages' ``build_slam_graph``, each from
    its own ``load_state``, and exits 1 unless they are equal array for
    array;
  * runs JAX's ``run_slam_mode`` (banded, ``LMConfig(iters=10)``, as
    ``examples/run_tum.py --slam-mode``) with the camera of ``--settings``;
  * prints how far the refined poses (Tcw's translation and quaternion)
    and objects of the files in DIR are from JAX's, the ATE
    (``system/metrics.ate_rmse``, Umeyama-aligned and not) of the input
    trajectory, of DIR's refined one and of JAX's against the ground
    truth, and each map's median centre error and IoU against
    ``objects_gt.txt``.

Not a test: it compiles JAX's SLAM solver (about two minutes on a CPU).
"""
import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from object_oriented_slam_tpu.backend.lm import LMConfig as JLMConfig  # noqa: E402,E501
from object_oriented_slam_tpu.system import checkpoint as jckpt  # noqa: E402
from object_oriented_slam_tpu.system import slam_mode as jmode  # noqa: E402
from object_oriented_slam_tpu_torch.backend import LMConfig, slam_ba  # noqa: E402,E501
from object_oriented_slam_tpu_torch.io import Config  # noqa: E402
from object_oriented_slam_tpu_torch.io.writers import load_objects  # noqa: E402,E501
from object_oriented_slam_tpu_torch.system import checkpoint as tckpt  # noqa: E402,E501
from object_oriented_slam_tpu_torch.system import slam_mode as tmode  # noqa: E402,E501
from object_oriented_slam_tpu_torch.system.metrics import (  # noqa: E402
    ate_rmse, object_map_iou)

SETTINGS = os.path.join(ROOT, "object_oriented_slam_tpu_torch", "configs",
                        "synthetic_depth_sym.yaml")


def camera(settings):
    cfg = Config(settings)
    return np.array([[cfg.get_float("Camera.fx"), 0, cfg.get_float("Camera.cx")],
                     [0, cfg.get_float("Camera.fy"), cfg.get_float("Camera.cy")],
                     [0, 0, 1]])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("dir", help="the directory chip_smoke.py --keep wrote")
    ap.add_argument("--settings", default=SETTINGS,
                    help="the run's settings (its camera)")
    args = ap.parse_args(argv)
    path = lambda name: os.path.join(args.dir, name)  # noqa: E731
    ckpt = path("slam_state.npz")

    jstate = jckpt.load_state(ckpt)
    jg, jinsts = jmode.build_slam_graph(jstate, JLMConfig(iters=10))
    tg, tinsts = tmode.build_slam_graph(tckpt.load_state(ckpt),
                                        LMConfig(iters=10), device="cpu")
    same = tinsts == jinsts and all(
        np.array_equal(getattr(tg, k).numpy(), np.asarray(getattr(jg, k)))
        for k in slam_ba.JAX_FIELDS)
    live = [int((np.asarray(w) != 0).sum())
            for w in (jg.e2_w, jg.e3_w, jg.odo_w, jg.grav_w)]
    print(f"graph: frames {jg.poses_cw.shape[0]}, objects "
          f"{jg.objects.shape[0]}, live 2D / 3D / odometry edges and gravity "
          f"priors {live}; the port's packing equal array for array: {same}")

    t0 = time.perf_counter()
    poses, objs, chi2 = jmode.run_slam_mode(jstate, camera(args.settings),
                                            JLMConfig(iters=10))
    print(f"JAX run_slam_mode (banded, 10 iterations): chi2 {chi2:.8g}, "
          f"{time.perf_counter() - t0:.1f} s on this CPU, compile included")

    traj = np.loadtxt(path("trajectory_refined.txt"), ndmin=2)[:, 1:]
    maps = {}
    for name in ("objects.txt", "objects_slam.txt"):
        insts, vecs = load_objects(path(name))
        maps[name] = dict(zip(insts, vecs))
    d_t = np.abs(traj[:, :3] - poses[:, :3]).max()
    d_q = np.minimum(np.abs(traj[:, 3:] - poses[:, 3:]).max(1),
                     np.abs(traj[:, 3:] + poses[:, 3:]).max(1)).max()
    d_c = max(np.linalg.norm(maps["objects_slam.txt"][i][:3] - v[:3])
              for i, v in objs.items())
    print(f"the card's trajectory_refined.txt against JAX's: translation "
          f"{d_t:.4g} m, quaternion {d_q:.4g} (max); objects_slam.txt's "
          f"centres {d_c:.4g} m (max)")

    gt_traj = np.loadtxt(path("groundtruth.txt"), ndmin=2)[:, 1:4]
    inp = np.stack(jstate.frames_pose_wc)[:, :3]
    for name, xyz in (("input (odometry)", inp),
                      ("card's trajectory_refined.txt", traj[:, :3]),
                      ("JAX's refined", poses[:, :3])):
        print(f"ATE of the {name}: {ate_rmse(xyz, gt_traj) * 100:.4f} cm "
              f"aligned, {ate_rmse(xyz, gt_traj, align=False) * 100:.4f} cm "
              f"not")
    gt = {int(r[0]): r[1:] for r in np.loadtxt(path("objects_gt.txt"),
                                               ndmin=2)}
    for name, m in (("objects.txt", maps["objects.txt"]),
                    ("card's objects_slam.txt", maps["objects_slam.txt"]),
                    ("JAX's refined map", objs)):
        err = [np.linalg.norm(v[:3] - gt[i][:3]) for i, v in m.items()]
        iou = list(object_map_iou(m, {i: gt[i] for i in m}).values())
        print(f"{name}: {len(m)} objects, centre error median "
              f"{np.median(err):.4g} m, IoU median {np.median(iou):.4f}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
