"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero if any fails):
  1. the card's name and power limit; TF32 off for the plain versions'
     matmuls;
  2. build the BA edge kernels from csrc/ba_edges.cu (nvcc, sm_90a);
  3. each kernel against its plain PyTorch version on the same card
     tensors, at full capacity (24 objects, 512 2D and 256 3D edges each,
     gravity on) and at the main path's tier (24, 512, 32), with times;
     one whole LM call on the card (kernels) against the CPU (plain);
  4. the main path: System.track_with_objects over a 600-frame, 24-object
     synthetic 2D-only sequence on the card, with the kernels' launch
     counts, e2e and backend ms/frame, and the map against the ground
     truth; objects.txt is written to a temporary directory;
  5. one JSON line per kernel, the card line, and the result line
     {"ok": true, "device": {...}} last.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 7
FULL = (24, 512, 256)       # object tier x 2D ring x 3D ring capacities
TIER = (24, 512, 32)        # the 2D-only main path's LM tier
NORMAL = (0.05, -0.02, 1.0)
REPLACES = {"K1": "attic/pallas_ba_kernels.py:183",
            "K2": "attic/pallas_ba_kernels.py:202",
            "K3": "attic/pallas_ba_kernels.py:219",
            "K4": "attic/pallas_ba_kernels.py:238"}


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=2):
    """Mean device time of fn() per call, CUDA events around reps calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def lm_inputs(shape, dev, seed=SEED):
    from object_oriented_slam_tpu_torch.backend import (
        LMConfig, lm_soa, observations_from_numpy)
    from object_oriented_slam_tpu_torch.io.synthetic import make_lm_batch
    arrays = make_lm_batch(*shape, seed=seed)
    obs = observations_from_numpy(arrays, dev)
    K = torch.tensor([[535.4, 0, 320.1], [0, 539.2, 247.6], [0, 0, 1]],
                     device=dev)
    n = torch.tensor(NORMAL, device=dev)
    prep = lm_soa.soa_prepare(obs.pose2d_cw, obs.bbox2d, obs.pose3d_wc,
                              obs.meas3d)
    w2, w3, wg = lm_soa.soa_edge_weights(obs, prep, K, True, LMConfig())
    return arrays, obs, (obs.est0, prep, w2, w3, wg, n, K)


def neq_errors(got, want):
    """(max abs error over H, g, r2sum; max over objects of the H/g error
    relative to max|H|; r2sum relative error)."""
    H, g, c = (t.double() for t in got)
    Hp, gp, cp = (t.double() for t in want)
    for t in (H, g, c, Hp, gp, cp):
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError("non-finite normal equations")
    scale = Hp.abs().flatten(1).amax(1).clamp_min(1e-30)
    rel = torch.maximum((H - Hp).abs().flatten(1).amax(1),
                        (g - gp).abs().amax(1)) / scale
    abs_err = max(float((H - Hp).abs().max()), float((g - gp).abs().max()),
                  float((c - cp).abs().max()))
    return abs_err, float(rel.max()), rel_err(c, cp)


def rel_err(got, want):
    """Max relative error; an exact zero must be matched exactly."""
    return float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())


def phase_kernels(dev):
    """Kernels vs plain versions; returns the per-K records."""
    from object_oriented_slam_tpu_torch.backend import ba_kernels, lm_soa
    recs = {}

    def sliced(args, m2, m3):
        est, prep, w2, w3, wg, n, K = args
        p = lm_soa.SoaPrep(prep.pose2d_cw[:, :m2].contiguous(),
                           prep.bbox2d[:, :m2].contiguous(),
                           prep.invp3[:, :m3].contiguous(),
                           prep.sc3[:, :m3].contiguous())
        return (est, p, w2[:, :m2].contiguous(), w3[:, :m3].contiguous(),
                wg if m2 else torch.zeros_like(wg), n, K)

    _, _, full = lm_inputs(FULL, dev)
    O, M2, M3 = FULL
    # K1/K3: the 2D (+ gravity) edges alone, K2/K4: the 3D edges alone
    for k, (m2, m3) in (("K1", (M2, 0)), ("K2", (0, M3))):
        args = sliced(full, m2, m3)
        got = ba_kernels.normal_eq(*args)
        want = lm_soa.soa_normal_eq_plain(*args)
        abs_err, rel, crel = neq_errors(got, want)
        if rel > 1e-4 or crel > 1e-5:
            raise RuntimeError(f"{k} normal_eq disagrees with its plain "
                               f"version: H/g {rel:.3g}, r2sum {crel:.3g}")
        recs[k] = dict(kernel="ba_normal_eq", shape=(O, m2, m3),
                       max_abs_err=abs_err, max_rel_err=rel,
                       ms=cuda_ms(lambda: ba_kernels.normal_eq(*args), 20),
                       plain_ms=cuda_ms(
                           lambda: lm_soa.soa_normal_eq_plain(*args), 3, 1))
    for k, (m2, m3) in (("K3", (M2, 0)), ("K4", (0, M3))):
        args = sliced(full, m2, m3)
        got = ba_kernels.chi2(*args).double()
        want = lm_soa.soa_chi2_plain(*args).double()
        rel = rel_err(got, want)
        if not (bool(torch.isfinite(got).all()) and rel <= 1e-5):
            raise RuntimeError(f"{k} chi2 disagrees with its plain version: "
                               f"{rel:.3g}")
        recs[k] = dict(kernel="ba_chi2", shape=(O, m2, m3),
                       max_abs_err=float((got - want).abs().max()),
                       max_rel_err=rel,
                       ms=cuda_ms(lambda: ba_kernels.chi2(*args), 20),
                       plain_ms=cuda_ms(lambda: lm_soa.soa_chi2_plain(*args),
                                        5, 1))
    for k, r in recs.items():
        print(f"[kernels] {k} {r['kernel']} at {r['shape']}: max_abs_err "
              f"{r['max_abs_err']:.4g}, rel {r['max_rel_err']:.3g}; kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")

    # the fused calls at full capacity and at the main path's tier
    for shape in (FULL, TIER):
        args = full if shape == FULL else sliced(full, *shape[1:])
        abs_err, rel, crel = neq_errors(ba_kernels.normal_eq(*args),
                                        lm_soa.soa_normal_eq_plain(*args))
        got = ba_kernels.chi2(*args).double()
        want = lm_soa.soa_chi2_plain(*args).double()
        c_rel = rel_err(got, want)
        if rel > 1e-4 or crel > 1e-5 or c_rel > 1e-5:
            raise RuntimeError(f"fused kernels disagree at {shape}: H/g "
                               f"{rel:.3g}, r2sum {crel:.3g}, chi2 {c_rel:.3g}")
        t = [cuda_ms(lambda: ba_kernels.normal_eq(*args), 20),
             cuda_ms(lambda: lm_soa.soa_normal_eq_plain(*args), 3, 1),
             cuda_ms(lambda: ba_kernels.chi2(*args), 20),
             cuda_ms(lambda: lm_soa.soa_chi2_plain(*args), 5, 1)]
        print(f"[kernels] fused at {shape}: H/g rel err {rel:.3g} of max|H|, "
              f"r2sum rel {crel:.3g}, chi2 rel {c_rel:.3g}; normal_eq kernel "
              f"{t[0]:.4f} ms vs plain {t[1]:.4f} ms; chi2 kernel {t[2]:.4f} "
              f"ms vs plain {t[3]:.4f} ms")
    return recs


def phase_whole_lm(dev):
    """One optimize_objects_soa call: kernels on the card vs plain on CPU."""
    from object_oriented_slam_tpu_torch.backend import (
        observations_from_numpy, optimize_objects_soa)
    arrays, obs, (_, _, _, _, _, n, K) = lm_inputs(FULL, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est_d, _ = optimize_objects_soa(obs, K, n, True)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    est_c, _ = optimize_objects_soa(observations_from_numpy(arrays),
                                    K.cpu(), n.cpu(), True)
    t_cpu = time.perf_counter() - t0
    err = float((est_d.cpu() - est_c).abs().max())
    print(f"[lm] optimize_objects_soa at {FULL}: card (kernels) vs CPU "
          f"(plain) max |d est| {err:.3g} (limit 2e-3); card {t_dev*1e3:.1f} "
          f"ms, CPU {t_cpu*1e3:.1f} ms (host clock, one call)")
    if not err <= 2e-3:
        raise RuntimeError(f"whole LM disagrees: {err:.3g}")


def write_settings(tmp):
    """The in-repo 2D settings plus Tracking.KeyFrameCheck.Close: 1 (every
    observation is stored, so the 2D rings fill to 512)."""
    import object_oriented_slam_tpu_torch as pkg
    src = os.path.join(os.path.dirname(pkg.__file__), "configs",
                       "synthetic_2d.yaml")
    path = os.path.join(tmp, "settings.yaml")
    with open(src) as f, open(path, "w") as g:
        g.write(f.read() + "\nTracking.KeyFrameCheck.Close: 1\n")
    return path


def wall_ms(fn, reps):
    """Mean host-clock time of fn() per call, synchronized, after warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def device_busy(fn):
    """(device ms, kernel launches, top kernels) of one fn() call from the
    profiler's CUDA kernel events, or None where the profiler sees none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    if busy <= 0:
        return None
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:4]
    return busy, sum(e.count for e in kern), [
        (e.key[:60], e.count, round(e.self_device_time_total / 1e3, 3))
        for e in top]


def lm_overhead(tracker):
    """Wall time of one eager LM call at the tracker's current tier and of
    its unrolled 9x9 Cholesky solve, against the device time of the
    kernels they launch: the launch-overhead share."""
    from object_oriented_slam_tpu_torch.backend import optimize_objects_soa
    from object_oriented_slam_tpu_torch.ops.linalg import chol_solve_small
    prep = tracker._prepare_backend()
    obs = tracker._unpack(prep)
    K = tracker._K_dev
    n = torch.zeros(3, device=K.device)
    O = obs.est0.shape[0]
    A = torch.eye(9, device=K.device).repeat(O, 1, 1) * 2.0 + 0.1
    b = torch.ones((O, 9), device=K.device)
    tier = tuple(obs.pose2d_cw.shape[:2]) + (obs.pose3d_wc.shape[1],)
    for what, fn in (
            (f"one LM call at tier {tier}",
             lambda: optimize_objects_soa(obs, K, n, prep["gset"],
                                          tracker.lm_cfg)),
            (f"one chol_solve_small of [{O}, 9, 9]",
             lambda: chol_solve_small(A, b))):
        wall = wall_ms(fn, 5)
        try:
            prof = device_busy(fn)
        except Exception as exc:   # a measurement, not a check
            print(f"[main] profiler unavailable: {exc!r}")
            prof = None
        if prof is None:
            print(f"[main] {what}: {wall:.3f} ms wall (host clock); device "
                  "busy time not measured")
            continue
        busy, launches, top = prof
        print(f"[main] {what}: {wall:.3f} ms wall (host clock, mean of 5); "
              f"device busy {busy:.3f} ms over {launches} kernel launches; "
              f"launch-overhead share {1 - busy / wall:.3f}; top kernels "
              f"(name, launches, ms) {top}")


def phase_main_path(dev, tmp):
    from object_oriented_slam_tpu_torch.backend import ba_kernels
    from object_oriented_slam_tpu_torch.io.synthetic import (
        SyntheticDataset, make_scene)
    from object_oriented_slam_tpu_torch.system import System

    scene = make_scene(n_objects=24, seed=SEED, radius_range=(1.3, 2.2),
                       scale_range=(0.2, 0.4))
    ds = SyntheticDataset(scene, n_frames=600, orbit_radius=3.6, height=1.7)
    frames = list(ds.frames())           # set-up: detections made up front
    slam = System(write_settings(tmp), device=dev)

    for k in ba_kernels.KERNELS:
        k.launches = 0
    e2e = []
    for i, ts, pose, depth, rgb, det in frames:
        t0 = time.perf_counter()
        slam.track_with_objects(ts, pose, det, depth=depth)
        torch.cuda.synchronize()
        e2e.append(time.perf_counter() - t0)
    slam.tracker.sync()
    launches = {k.name: k.launches for k in ba_kernels.KERNELS}

    tr = slam.tracker
    objs = slam.map_objects
    errs = np.array([np.linalg.norm(v[:3] - scene.ellipsoids[i][:3])
                     for i, v in objs.items()])
    e2e_ms = np.array(e2e) * 1e3
    backend_ms = np.array(tr.metrics["backend"]) * 1e3
    m2 = int(min(tr._b_n2.max(), tr.MAX_OBS2D))
    print(f"[main] {len(frames)} frames, {len(objs)}/24 objects initialized, "
          f"2D ring fill {m2}/{tr.MAX_OBS2D}, object tier {tr.max_objects}")
    print(f"[main] e2e ms/frame p50 {np.median(e2e_ms):.3f} mean "
          f"{e2e_ms.mean():.3f} p99 {np.percentile(e2e_ms, 99):.3f} (host "
          f"clock, synchronized per frame); backend ms/frame mean "
          f"{backend_ms.mean():.3f} over all frames, "
          f"{backend_ms.sum() / max(tr._backend_calls, 1):.3f} over the "
          f"{tr._backend_calls} frames with an LM call (host clock around the "
          f"eager LM's launches)")
    print(f"[main] kernel launches in the main path: {launches}")
    print(f"[main] centre error vs ground truth: median {np.median(errs):.3g} "
          f"m, max {errs.max():.3g} m")
    out = os.path.join(tmp, "objects.txt")
    slam.save_objects_to_file(out)
    rows = np.loadtxt(out, ndmin=2)
    print(f"[main] wrote {out}: {rows.shape[0]} rows")

    if min(launches.values()) <= 0:
        raise RuntimeError(f"a kernel of the path never launched: {launches}")
    if len(objs) < 16:
        raise RuntimeError(f"only {len(objs)} of 24 objects initialized")
    if not np.median(errs) < 0.05:
        raise RuntimeError(f"median centre error {np.median(errs):.3g} m")
    if rows.shape != (len(objs), 11) or not np.isfinite(rows).all():
        raise RuntimeError("objects.txt is malformed")
    if m2 < tr.MAX_OBS2D:
        raise RuntimeError(f"the 2D rings reached {m2}, not the full tier")
    lm_overhead(tr)
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from object_oriented_slam_tpu_torch.backend import ba_kernels
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[card] {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    ba_kernels.build()
    print(f"[build] {time.perf_counter() - t0:.1f} s")
    for line in ba_kernels.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    recs = phase_kernels(dev)
    phase_whole_lm(dev)
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_main_path(dev, tmp)

    src = "object_oriented_slam_tpu_torch/csrc/ba_edges.cu"
    kernels = [{"name": f"{r['kernel']} ({k})", "route": "cuda",
                "source": src, "replaces": REPLACES[k],
                "launches": launches[r["kernel"]],
                "max_abs_err": r["max_abs_err"],
                "max_rel_err": r["max_rel_err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "shape": list(r["shape"])} for k, r in recs.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
