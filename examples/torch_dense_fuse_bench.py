"""K12 (dense_fuse) alone on the card: device time, device operations and
phase clocks of one fuse at the dense builder's shapes.

    python3 examples/torch_dense_fuse_bench.py [--root DIR] [--clocks]
        [--tum] [--reps 10]

A synthetic orbit: a camera at the centre of a 5 x 5 x 2.7 m room with
rippled walls turns once in 160 frames (640 x 480 depth and random BGR,
stride 4: 19,200 strided pixels) while wobbling a few centimetres, and its
first 81 frames are fused at a 1 cm leaf into 1 << 19 cells (the
--build-dense builder's settings; the map stops filling at 352,454 cells).
With ``--tum``, the frames are instead those chip_smoke.py's ``[dense]``
fuses: its ``[cli]`` scene and orbit exported as a TUM sequence by
examples/torch_make_synthetic_tum.py into a temporary directory and read
back, each with its ground-truth pose; frames are fused until the map
fills or ``[dense]``'s mid-orbit frame is reached.
Three fuses are timed: the first frame into an empty map, a mid-orbit
frame into the filled map, and the same into the filled map with its rows
shuffled.  A fuse is timed as chip_smoke.py times it: with a reload of
the map before each fuse, the reload timed alone and taken off; beside it,
a fuse of the map from the buffer it was loaded into once (a fuse writes
the other buffer, so every repeat fuses the same inputs).
For each: ms a fuse (the profiler's device events and CUDA events), the
device operations a fuse and each one's device time by name (for a design
of several kernels, those are its phases), the path the fuse took where
the tree counts paths, the most frame pixels in one bucket of the frame
sort (chip_smoke.dense_largest_bucket), and a digest of the output.  ``--clocks`` builds
csrc/dense_fuse.cu again with -DOSLAM_DF_CLOCKS, launches that build
(``ClockWork``) and prints the cycles of each
phase of the one cooperative launch (block 0's clock64 after each grid
barrier: points, keys, sort, merge counts, sums), the steps within them,
and every block's own work a phase (median and largest over the blocks).
``--root DIR`` runs the package of another checkout (its FuseWork takes
the same calls), so that ``--root PARENT; ; --clocks; --root PARENT`` in
one call compares the two on one card.  Needs a CUDA device.
"""
import argparse
import ctypes
import hashlib
import importlib.util
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if "--root" in sys.argv:
    sys.path.insert(0, os.path.abspath(sys.argv[sys.argv.index("--root") + 1]))
else:
    sys.path.insert(0, HERE)

import torch  # noqa: E402

from object_oriented_slam_tpu_torch.core.camera import Camera  # noqa: E402
from object_oriented_slam_tpu_torch.ops import _cuda_build  # noqa: E402
from object_oriented_slam_tpu_torch.ops import dense_fuse as df  # noqa: E402

CAM = Camera(fx=535.4, fy=539.2, cx=320.1, cy=247.6, scale=5000.0)
CAP, STRIDE, LEAF, RANGE = 1 << 19, 4, 0.01, 6.0
FRAMES, MID = 160, 80


def _smoke():
    """chip_smoke.py of this tree: its timing helpers."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def room_frame(i, rng):
    """Frame i of the orbit: (depth [480, 640] int32, rgb float32 BGR,
    pose [7] float32 Twc).  Depth is the camera's distance along its axis
    to the first of the room's six planes, the walls rippled by 2 cm."""
    yaw = 2.0 * np.pi * i / FRAMES
    t = np.array([0.05 * np.sin(0.7 * i), 0.03 * np.cos(0.5 * i),
                  0.05 * np.cos(0.3 * i)])
    v, u = np.mgrid[0:480, 0:640].astype(np.float64)
    d = np.stack([(u - CAM.cx) / CAM.fx, (v - CAM.cy) / CAM.fy,
                  np.ones_like(u)], -1)
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    w = d @ R.T
    lo, hi = np.array([-2.5, -1.5, -2.5]), np.array([2.5, 1.2, 2.5])
    hit = np.full(u.shape, np.inf)
    for k in range(3):
        with np.errstate(divide="ignore", invalid="ignore"):
            for b in (lo[k], hi[k]):
                tk = (b - t[k]) / w[..., k]
                hit = np.where((tk > 0) & (tk < hit), tk, hit)
    p = t + hit[..., None] * w
    hit = hit * (1.0 + 0.02 * np.sin(7.0 * p[..., 0] + 5.0 * p[..., 2])
                 * np.cos(6.0 * p[..., 1]))
    depth = np.where(np.isfinite(hit), hit * CAM.scale, 0).astype(np.int32)
    depth[rng.random(depth.shape) < 0.03] = 0
    rgb = rng.integers(0, 256, (480, 640, 3)).astype(np.float32)
    q = np.array([0.0, np.sin(yaw / 2), 0.0, np.cos(yaw / 2)])
    return depth, rgb, np.concatenate([t, q]).astype(np.float32)


def clocks_build():
    """csrc/dense_fuse.cu built with -DOSLAM_DF_CLOCKS and bound: (the
    library, nvcc's log)."""
    path, log = _cuda_build.build(
        df.SOURCE, tuple(_cuda_build.NVCC_FLAGS) + ("-DOSLAM_DF_CLOCKS",))
    lib = ctypes.CDLL(path)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.oslam_dense_fuse.argtypes = ([i] * 4 + [f] * 7 + [p] * 11
                                     + [ctypes.c_longlong, p, p])
    lib.oslam_dense_fuse.restype = i
    lib.oslam_df_clocks.argtypes = [p]
    lib.oslam_df_block_marks.argtypes = [p]
    return lib, log or ""


class ClockWork(df.FuseWork):
    """``FuseWork`` whose launch is the clocks build's (``lib``)."""
    lib = None

    def _launch(self, args):
        with torch.cuda.device(self.device):
            rc = self.lib.oslam_dense_fuse(
                *args, torch.cuda.current_stream(self.device).cuda_stream)
        if rc:
            raise RuntimeError(f"the clocks build's launch: CUDA error {rc}")


def tum_frames(sm, dev):
    """chip_smoke.py [cli]'s export as [dense] reads it: (depth int32, rgb
    float32, pose float32) of its frames up to [dense]'s mid-orbit one, and
    that frame's index."""
    from object_oriented_slam_tpu_torch.io.synthetic import SyntheticDataset
    from object_oriented_slam_tpu_torch.io.tum import TUMDataset
    mid = sm.DENSE_FRAMES[1]
    with tempfile.TemporaryDirectory() as tmp:
        seq = os.path.join(tmp, "tum_sequence")
        scene = sm.scene24_sym()
        sm.example("torch_make_synthetic_tum").export_synthetic_tum(
            seq, scene, SyntheticDataset(
                scene, n_frames=sm.N_DEPTH_FRAMES, orbit_radius=3.6,
                height=1.7, depth_device=dev), odometry_noise=0.01)
        ds = TUMDataset(seq, with_rgb=True)
        try:
            frames = [(depth.astype(np.int32), rgb.astype(np.float32),
                       pose.astype(np.float32))
                      for i, _, pose, depth, rgb, _ in ds.frames()
                      if i <= mid]
        finally:
            ds.close()
    return frames, mid


def digest(tensors):
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def clocks_of(fuse, reps=5):
    """Cycles of each phase of one launch (the -DOSLAM_DF_CLOCKS build),
    the median of reps fuses, the path the last took, and the cycles
    between the steps stamped within the phases (block 0's radix passes:
    ranks, the grid barrier, the digit counts, the scan, the scatter, the
    barrier; the merge's splits and staging; the sums' tiles and clearing),
    from the last fuse."""
    host = np.zeros(80, np.int64)
    lib = ClockWork.lib
    rows = []
    for _ in range(reps):
        fuse()
        torch.cuda.synchronize()
        rc = lib.oslam_df_clocks(host.ctypes.data)
        if rc:
            raise RuntimeError(f"oslam_df_clocks: CUDA error {rc}")
        rows.append(np.diff(host[:6]))
    names = ("points", "keys", "sort", "merge counts", "sums")
    steps = host[9:9 + int(host[8])]
    marks = np.zeros((512, 16), np.int64)
    lib.oslam_df_block_marks(marks.ctypes.data)
    used = marks[:, 0] != 0
    m = marks[used]
    spans = {"points": (0, 1), "keys": (2, 3), "keys loop": (2, 13),
             "keys reductions": (13, 3), "dispatch": (4, 14),
             "count loads": (14, 15), "count scans": (15, 5),
             "bucket starts": (4, 5),
             "bucket scatter": (5, 6), "bucket sorts": (7, 8),
             "merge counts": (9, 10), "sums": (11, 12)}
    work = {}
    for k, (a, b) in spans.items():
        span = m[:, b] - m[:, a]
        if (m[:, a] != 0).all() and (m[:, b] != 0).all() and (span >= 0).all():
            work[k] = (int(np.median(span)), int(span.max()))
    print(f"  blocks {int(used.sum())}: work cycles (median, max) {work}")
    return (dict(zip(names, np.median(np.array(rows), 0).tolist())),
            int(host[6]), np.diff(np.concatenate([[host[2]], steps])).tolist())


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--clocks", action="store_true")
    ap.add_argument("--tum", action="store_true")
    ap.add_argument("--reps", type=int, default=10)
    ns = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device")
        return 1
    sm = _smoke()
    dev = torch.device("cuda", 0)
    tag = (os.path.basename(os.path.normpath(ns.root)) if ns.root
           else ("clocks" if ns.clocks else "tree"))
    t0 = time.perf_counter()
    df.build()
    log, Work = df.build_log, df.FuseWork
    if ns.clocks:
        ClockWork.lib, log = clocks_build()
        Work = ClockWork
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[bench {tag}] ptxas: {line.strip()}")
    card = sm.card_line()
    print(f"[bench {tag}] {card}; package {os.path.dirname(df.__file__)}; "
          f"built in {time.perf_counter() - t0:.1f} s")
    if ns.tum:
        frames, mid = tum_frames(sm, dev)
        tag += " tum"
    else:
        rng = np.random.default_rng(19)
        frames, mid = [room_frame(i, rng) for i in range(MID + 1)], MID

    def on_card(depth, rgb, pose):
        return (torch.as_tensor(depth, device=dev),
                torch.as_tensor(rgb, device=dev),
                torch.as_tensor(pose, device=dev))

    work = Work(CAP, 480, 640, STRIDE, dev)
    empty = tuple(t.clone() for t in work.map())
    state, n_fused = work.map(), 0
    for depth, rgb, pose in frames:
        state = work.fuse(*on_card(depth, rgb, pose), CAM, LEAF, RANGE)
        n_fused += 1
        if int(state[2].sum()) == CAP:
            break
    filled = tuple(t.clone() for t in state)
    perm = torch.randperm(CAP, device=dev, generator=torch.Generator(
        device=dev).manual_seed(7))
    shuffled = tuple(t[perm] for t in filled)
    print(f"[bench {tag}] the map filled ({int(filled[2].sum())} cells) "
          f"after {n_fused} frames; digest {digest(filled)}")
    for name, m, frame in (("first frame, empty map", empty, frames[0]),
                           ("filled map", filled, frames[mid]),
                           ("shuffled filled map", shuffled, frames[mid])):
        f = on_card(*frame)
        w = Work(CAP, 480, 640, STRIDE, dev)
        w.load(*m)
        a = w.cur

        def fuse():
            # the map stays in buffer a (a fuse reads it and writes the
            # other buffer), so every repeat fuses the same inputs
            w.cur = a
            return w.fuse(*f, CAM, LEAF, RANGE)

        def fuse_reload():
            w.load(*m)
            return w.fuse(*f, CAM, LEAF, RANGE)

        def load():
            w.load(*m)

        out = digest(fuse())
        rec = {"digest": out, "bucket": sm.dense_largest_bucket(
            m, f, CAM, LEAF, STRIDE, RANGE)}
        if hasattr(w, "tally"):
            before = w.tally.clone()
            fuse()
            rec["path"] = int(torch.argmax(w.tally - before))
        w.cur = a
        events = sm.profiled(fuse)
        rec["device_ops"] = sum(e.count for e in events)
        rec["ops"] = {e.key[:60]: [e.count, e.self_device_time_total / 1e3]
                      for e in events}
        rec["loaded_ms"] = sm.busy_ms(fuse, reps=ns.reps)
        # chip_smoke.py's way: a reload of the map before each fuse, timed
        # alone and taken off
        rec["ms"] = (sm.busy_ms(fuse_reload, reps=ns.reps)
                     - sm.busy_ms(load, reps=ns.reps))
        rec["events_ms"] = (sm.cuda_ms(fuse_reload, ns.reps)
                            - sm.cuda_ms(load, ns.reps))
        w.load(*m)
        a = w.cur
        if ns.clocks:
            rec["cycles"], rec["clock_path"], rec["steps"] = clocks_of(fuse)
        print(f"[bench {tag}] {name}: {rec['ms']:.4f} ms a fuse (profiler, "
              f"a reload taken off; CUDA events {rec['events_ms']:.4f}; of "
              f"the map as loaded once {rec['loaded_ms']:.4f}); "
              f"{rec['device_ops']} device operations: "
              + "; ".join(f"{k} x{c} {t:.4f} ms"
                          for k, (c, t) in rec["ops"].items())
              + (f"; path {rec['path']}" if "path" in rec else "")
              + (f"; phase cycles {rec['cycles']}; steps {rec['steps']}"
                 if ns.clocks else "")
              + f"; at most {rec['bucket']} pixels in a bucket of the frame "
              f"sort; output digest {out}", flush=True)
    sm_clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[bench {tag}] SM clock now, max: {sm_clock.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
