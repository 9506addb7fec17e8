"""K8 (symmetry_search) alone, at the three shapes chip_smoke.py holds it at.

    python3 examples/torch_symmetry_bench.py [--root CHECKOUT] [--reps 20] [--path]

``--root`` names the checkout whose package (and chip_smoke.py) is imported
and whose csrc/frontend.cu is built, so that one command can time two
versions of the kernel on one card: run it once per checkout, in turns.
The shapes: the symmetry path's mid-orbit frame (scene24_sym, frame 80 of
the 160-frame orbit, the true ground plane; 12 detections searched in 32
lanes) with the exact gradient and with central differences, and
sym_capacity filled (8 dual detections x 512 points, exact gradient).  For
each it prints the device time of one launch (the mean of ``--reps``
profiler kernel events) and a digest of the outputs' bits (equal digests:
equal outputs); then the digests of the path frame's depth_cloud and
voxel_downsample outputs (the launches without sparse symmetry's lanes),
the ptxas report of the kernel and one JSON line.
With ``--path`` it first drives chip_smoke's symmetry path (160 frames,
synthetic_depth_sym.yaml) and prints its objects, the median centre error
in full, a digest of the map's bits, the K8 launches and the e2e,
extraction and backend ms per frame.  Needs an NVIDIA GPU and nvcc.
"""
import argparse
import hashlib
import json
import os
import re
import sys

import numpy as np
import torch


def ptxas_report(log):
    """The ptxas lines of the symmetry_search kernel in nvcc's output."""
    lines, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = "symmetry_search" in line
        elif keep and re.search(r"stack frame|registers", line):
            lines.append(line.split(":", 1)[-1].strip())
    return lines


def path_args(cs, dev):
    """The arguments symmetry_search takes on the symmetry path's mid-orbit
    frame: the frame packed by the extractor and stages (a)-(f) run on the
    card, as chip_smoke.phase_symmetry_kernel takes them; and the digests
    of that frame's depth_cloud (stages (a)-(c)) and voxel_downsample (the
    object downsample with cells) outputs."""
    from object_oriented_slam_tpu_torch.core import se3
    from object_oriented_slam_tpu_torch.frontend import extractor as text
    from object_oriented_slam_tpu_torch.io import synthetic as syn
    scene = cs.scene24_sym()
    cam = scene.camera
    ds = syn.SyntheticDataset(scene, n_frames=cs.N_DEPTH_FRAMES,
                              orbit_radius=3.6, height=1.7, depth_device=dev)
    for i, _, pose, depth, _, det in ds.frames():
        if i == cs.N_DEPTH_FRAMES // 2:
            break
    plane = np.array([0.0, 0.0, 1.0, 0.0])
    cfg = text.ExtractorConfig(open_symmetry=True)
    flat, pad, _, cfg_t, n_sym = text._pack_frame(
        cam, cfg, det[:, 1:5].copy(), det[:, 5].astype(int), pose, plane)
    flat_d = torch.from_numpy(flat).to(dev)
    depth_d = torch.from_numpy(np.ascontiguousarray(depth, np.int32)).to(dev)
    bb = flat_d[:pad * 4].reshape(pad, 4)
    pose_d = flat_d[pad * 6:pad * 6 + 7]
    plane_d = flat_d[pad * 6 + 7:pad * 6 + 11]
    a = text._stage_a(depth_d, bb, pose_d, plane_d, cam, cfg_t)
    sel, _ = text._cluster_select_batch(a[1], a[3], a[4], a[7], cfg_t)
    Two, pts_n, obj_m = text._stage_post(a[1], sel, plane_d, cfg_t)[:3]
    from object_oriented_slam_tpu_torch.ops import voxel as vx
    frontend = {"depth_cloud": digest(a[:8]),
                "voxel_downsample": digest(vx.voxel_downsample_cells(
                    a[1], sel, cfg_t.sym_grid, cfg_t.sym_capacity))}
    pose_oc = se3.se3_mul(se3.se3_inv(Two), pose_d.expand(pad, 7))
    types = flat_d[pad * 5:pad * 6].to(torch.int32)
    run = flat_d[pad * 4:pad * 5] > 0.5
    return (pts_n.contiguous(), obj_m.contiguous(), bb.contiguous(),
            pose_oc.contiguous(), depth_d, types, run, cam), frontend


def digest(result):
    h = hashlib.sha256()
    for t in result:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def drive_path(cs, dev):
    """The symmetry path as chip_smoke drives it, the BA kernels built
    first; returns its record."""
    import tempfile
    from object_oriented_slam_tpu_torch.backend import ba_kernels
    ba_kernels.build()
    scene = cs.scene24_sym()
    with tempfile.TemporaryDirectory() as tmp:
        slam, frames, e2e, stats, latched_at, launches = cs.drive_depth_path(
            dev, tmp, "synthetic_depth_sym.yaml", scene)
        objs = slam.map_objects
        errs = np.array([np.linalg.norm(v[:3] - scene.ellipsoids[i][:3])
                         for i, v in sorted(objs.items())])
        h = hashlib.sha256()
        for i, v in sorted(objs.items()):
            h.update(np.asarray(v, np.float64).tobytes())
        e2e_ms, ext_ms, backend_ms = cs.path_times(slam.tracker, e2e)
    return {"objects": len(objs), "median_centre_error": float(
        np.median(errs)), "map_digest": h.hexdigest()[:16],
        "symmetry_search_launches": launches["symmetry_search"],
        "e2e_mean_ms": float(e2e_ms.mean()),
        "extraction_mean_ms": float(ext_ms.mean()),
        "backend_mean_ms": float(backend_ms.mean())}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--path", action="store_true")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_symmetry_bench: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(opts.root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    from object_oriented_slam_tpu_torch.frontend import symmetry as sym
    from object_oriented_slam_tpu_torch.ops import frontend_kernels as fk
    if not fk.__file__.startswith(root):
        raise RuntimeError(f"imported {fk.__file__}, not from {root}")
    dev = torch.device("cuda", 0)
    print(f"[card] {cs.card_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    fk.build()
    report = ptxas_report(fk.build_log)
    path, frontend = path_args(cs, dev)
    full = (*cs.full_symmetry_inputs(dev), cs.scene24_sym().camera)
    shapes = [("path", path, True), ("path", path, False), ("full", full, True)]
    out = {"root": root, "ptxas": report, "shapes": [], "frontend": frontend}
    print(f"[bench] path frame outputs: {frontend}")
    if opts.path:
        out["path"] = drive_path(cs, dev)
        print(f"[path] {out['path']}")
    for tag, args, analytic in shapes:
        cfg = sym.SymmetryConfig(analytic_grad=analytic)
        types, run = args[5], args[6]
        live = (run & (types > 0)).cpu()
        dual = bool((types[live.to(types.device)] == 2).any())
        res = sym.estimate_symmetry(*args, cfg)
        torch.cuda.synchronize()
        ms = cs.device_ms(lambda: sym.estimate_symmetry(*args, cfg),
                          opts.reps, name="symmetry_search")
        rec = {"shape": tag, "analytic": analytic,
               "searched": int(live.sum()), "ms": ms, "digest": digest(res)}
        out["shapes"].append(rec)
        print(f"[bench] {tag} {'analytic' if analytic else 'central'}: "
              f"{int(live.sum())} searched (dual among them: {dual}), "
              f"{ms:.4f} ms a launch (mean of {opts.reps} kernel events), "
              f"outputs {rec['digest']}")
    for line in report:
        print(f"[ptxas] {line}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
