"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero if any fails):
  1. the card's name and power limit; TF32 off for the plain versions'
     matmuls;
  2. build the BA edge kernels from csrc/ba_edges.cu (nvcc, sm_90a);
  3. each kernel against its plain PyTorch version on the same card
     tensors, at full capacity (24 objects, 512 2D and 256 3D edges each,
     gravity on) and at the main path's tier (24, 512, 32), with its time
     beside its bound (the card's least time for the same bytes and
     operations); the two LM step entry points (the same kernels with
     their solve and accept epilogues) against their plain versions on
     inputs with accepted, rejected, edgeless and non-finite objects, and
     bit for bit against a second launch; one whole LM call on the card
     (kernels) against the CPU (plain);
  4. the main path: System.track_with_objects over a 600-frame, 24-object
     synthetic 2D-only sequence on the card, with the kernels' launch
     counts, e2e and backend ms/frame, and the map against the ground
     truth; objects.txt is written to a temporary directory; the
     profiler's launch count of one LM call and of one LM iteration (which
     must be exactly two kernel launches);
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
SOURCE = "object_oriented_slam_tpu_torch/csrc/ba_edges.cu"
# the card's published peaks (H100 SXM): HBM bytes/s, f32 FLOP/s outside
# the tensor cores
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
# f32 operations, counted from csrc/ba_edges.cu: one per + - * / compare,
# sqrt, sin, cos, atan2, acos on a float.  A Dual<9> operation costs 10
# (add, scale), 28 (mul), 40 (div: the value, two reciprocals, 4 per
# tangent), 12 (sqrt, sin, acos, max), 20 (cos), 33 (atan2).  Per active
# edge: the residual chain (15 dual divisions in the 2D chain, 7 per 3D
# candidate), its weighting, and for the normal equations 110 per row (55
# products and sums) and 275 for the lane's part of the shuffle reduction.
OPS = {
    "ba_normal_eq": dict(e2=4030 + 54 + 40 + 4 * 110 + 275,
                         e3=4 * 2564 + 90 + 9 * 110 + 275,
                         obj=2335 + 462 + 389),   # exp update, R, gravity
    "ba_chi2": dict(e2=283 + 4 + 8, e3=4 * 181 + 9 + 18, obj=211),
}
OPS_SOLVE = 675     # lam0, 9x9 Cholesky solve, gate, exp update (float)
OPS_ACCEPT = 50     # denom, rho, accept, schedule
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
    """Mean time of fn() per call, CUDA events around reps calls (for the
    plain versions, whose many kernels keep the card behind the host)."""
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


def profiled(fn, reps=1, expect=None):
    """The profiler's CUDA events (kernels, copies, memsets) of reps fn()
    calls, synchronized.  In a process that has run for a while a trace
    lacks its first one or two launches, so eight random fills go first (a
    kernel nothing else here launches) and are left out by name.  A trace
    that still comes back empty, or with fewer than ``expect`` operations,
    is taken again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    first = torch.empty(8, device="cuda")
    events = []
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                first.random_()
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and "distribution_elementwise" not in e.key]
        if sum(e.self_device_time_total for e in events) > 0 and sum(
                e.count for e in events) >= (expect or 1):
            break
    return events


def device_ms(fn, reps, warmup=2):
    """Mean time the card spends on one fn() call that launches one kernel,
    from the profiler's kernel events over reps calls.  A BA kernel runs
    for less than the host takes to enqueue its launch, so CUDA events
    around back-to-back launches would time the host."""
    for _ in range(warmup):
        fn()
    events = profiled(fn, reps, expect=reps)
    if sum(e.count for e in events) != reps:
        raise RuntimeError(
            f"the profiler shows {sum(e.count for e in events)} device "
            f"operations for {reps} launches")
    return sum(e.self_device_time_total for e in events) / 1e3 / reps


def lm_inputs(shape, dev, seed=SEED, edit=None):
    """A seeded LM batch at ``shape`` on ``dev`` (``edit`` may change its
    numpy arrays first): (arrays, observations, the kernels' arguments)."""
    from object_oriented_slam_tpu_torch.backend import (
        LMConfig, lm_soa, observations_from_numpy)
    from object_oriented_slam_tpu_torch.io.synthetic import make_lm_batch
    arrays = make_lm_batch(*shape, seed=seed)
    if edit is not None:
        edit(arrays)
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


def bound(kernel, args, outputs, extra_ops_per_object=0, extra_inputs=()):
    """(bound_ms, bound_by): the least time the card could take for one
    call on these inputs.  Bytes: every input read once and
    every output written once.  Operations: OPS per edge with a non-zero
    weight (the kernels skip the others) and per object."""
    est, prep, w2, w3 = args[:4]
    tensors = [est, *prep, *args[2:7], *extra_inputs, *outputs]
    n_bytes = sum(t.numel() * t.element_size() for t in tensors)
    ops = OPS[kernel]
    n_ops = (int((w2 != 0).sum()) * ops["e2"] + int((w3 != 0).sum())
             * ops["e3"] + est.shape[0] * (ops["obj"] + extra_ops_per_object))
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_F32 * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def sliced(args, m2, m3):
    """The problem cut to its first m2 2D and m3 3D edge slots (gravity
    goes with the 2D edges)."""
    from object_oriented_slam_tpu_torch.backend import lm_soa
    est, prep, w2, w3, wg, n, K = args
    p = lm_soa.SoaPrep(prep.pose2d_cw[:, :m2].contiguous(),
                       prep.bbox2d[:, :m2].contiguous(),
                       prep.invp3[:, :m3].contiguous(),
                       prep.sc3[:, :m3].contiguous())
    return (est, p, w2[:, :m2].contiguous(), w3[:, :m3].contiguous(),
            wg if m2 else torch.zeros_like(wg), n, K)


def phase_kernels(dev):
    """Kernels vs plain versions; returns the per-K records."""
    from object_oriented_slam_tpu_torch.backend import ba_kernels, lm_soa
    recs = {}

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
                       bound=bound("ba_normal_eq", args, got),
                       ms=device_ms(lambda: ba_kernels.normal_eq(*args), 20),
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
                       bound=bound("ba_chi2", args, [got]),
                       max_abs_err=float((got - want).abs().max()),
                       max_rel_err=rel,
                       ms=device_ms(lambda: ba_kernels.chi2(*args), 20),
                       plain_ms=cuda_ms(lambda: lm_soa.soa_chi2_plain(*args),
                                        5, 1))
    for k, r in recs.items():
        print(f"[kernels] {k} {r['kernel']} at {r['shape']}: max_abs_err "
              f"{r['max_abs_err']:.4g}, rel {r['max_rel_err']:.3g}; kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"{bound_text(r['ms'], r['bound'])}")

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
        t = [device_ms(lambda: ba_kernels.normal_eq(*args), 20),
             cuda_ms(lambda: lm_soa.soa_normal_eq_plain(*args), 3, 1),
             device_ms(lambda: ba_kernels.chi2(*args), 20),
             cuda_ms(lambda: lm_soa.soa_chi2_plain(*args), 5, 1),
             cuda_ms(lambda: ba_kernels.normal_eq(*args), 50),
             cuda_ms(lambda: ba_kernels.chi2(*args), 50)]
        b_neq = bound("ba_normal_eq", args, ba_kernels.normal_eq(*args))
        b_chi = bound("ba_chi2", args, [got])
        S, T = ba_kernels.launch_shape(shape[1] + shape[2])
        print(f"[kernels] fused at {shape}, {shape[0]} x {S} blocks of {T} "
              f"threads: H/g rel err {rel:.3g} of max|H|, "
              f"r2sum rel {crel:.3g}, chi2 rel {c_rel:.3g}; normal_eq kernel "
              f"{t[0]:.4f} ms vs plain {t[1]:.4f} ms, "
              f"{bound_text(t[0], b_neq)}; chi2 kernel {t[2]:.4f} "
              f"ms vs plain {t[3]:.4f} ms, {bound_text(t[2], b_chi)}; "
              f"back-to-back calls (CUDA events, bound by the host's launch "
              f"rate) {t[4]:.4f} and {t[5]:.4f} ms")
        if shape == TIER and not S > 1:
            raise RuntimeError(f"one block per object at the main tier: S={S}")
    return recs


def bound_text(ms, b):
    return (f"bound {b[0] * 1e3:.4g} us by {b[1]}, share of bound "
            f"{b[0] / ms:.4f}")


def same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def same_or_both_nan(got, want, tol, scale=None):
    """Largest |got - want| over max|want| per object (or over ``scale``
    [O]); a NaN must be matched by a NaN.  Raises on a mismatch of NaNs."""
    O = want.shape[0]
    a, b = got.double().reshape(O, -1), want.double().reshape(O, -1)
    if not torch.equal(torch.isnan(a), torch.isnan(b)):
        raise RuntimeError("NaNs in different places")
    a, b = torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0)
    if scale is None:
        scale = b.abs().amax(1)
    err = float(((a - b).abs().amax(1) / scale.double().clamp_min(1e-30)).max())
    if not err <= tol:
        raise RuntimeError(f"relative error {err:.3g} over the limit {tol:g}")
    return err


def degenerate_object_3(arrays):
    """Gives the LM batch an object whose du is non-finite: object 3's
    estimate becomes a 30 m sphere around its cameras, so its projected
    conics have no real axes: the bbox half-widths are sqrt(max(negative,
    0)) = 0 with a NaN tangent, while every residual value stays finite
    (the edges pass the NaN gate).  Its rotation is the identity, so the
    gated zero step returns the estimate bit for bit."""
    arrays["est0"][3, 3:] = (0, 0, 0, 1, 30, 30, 30)


def phase_steps(dev):
    """lm_solve_step and lm_accept_step (the kernels with their LM
    epilogues) against their plain versions; returns their records."""
    from object_oriented_slam_tpu_torch.backend import ba_kernels, lm_soa
    recs = {}
    for shape in (FULL, TIER):
        # object 3 is degenerate, the last object has no edges
        est, *problem = lm_inputs(shape, dev, SEED + 1,
                                  degenerate_object_3)[2]
        problem = (*problem, 0.0)
        O = shape[0]
        lam = torch.full((O,), -1.0, device=dev)
        lam[1::2] = 0.25            # given dampings beside first iterations
        nu = torch.full((O,), 2.0, device=dev)

        # --- solve step
        got = ba_kernels.lm_solve_step(est, lam, *problem, want_H=True)
        again = ba_kernels.lm_solve_step(est, lam, *problem)
        want = lm_soa.lm_solve_step_plain(est, lam, *problem, want_H=True)
        torch.cuda.synchronize()
        est_new, du, g, lam0, H = want
        if again[4] is not None or not all(
                same_bits(a, b) for a, b in zip(got[:4], again[:4])):
            raise RuntimeError("lm_solve_step: two launches differ in bits")
        gated = ~torch.isfinite(H).flatten(1).all(1)
        if not (bool(gated[3]) and float(du[3].abs().max()) == 0.0
                and float(got[1][3].abs().max()) == 0.0):
            raise RuntimeError("no object with a non-finite, gated du")
        if float(problem[1][-1].abs().sum() + problem[2][-1].abs().sum()):
            raise RuntimeError("the last object has edges")
        hscale = torch.nan_to_num(H).abs().flatten(1).amax(1)
        errs = dict(
            est_new=same_or_both_nan(got[0], est_new, 1e-4),
            du=same_or_both_nan(got[1], du, 1e-4),
            g=same_or_both_nan(got[2], g, 1e-4, hscale),
            lam0=same_or_both_nan(got[3], lam0, 1e-4),
            H=same_or_both_nan(got[4], H, 1e-4, hscale))
        args = (est, *problem[:6])
        rec = dict(kernel="ba_normal_eq", shape=shape,
                   max_abs_err=float(torch.nan_to_num(got[1] - du).abs().max()),
                   max_rel_err=max(errs.values()),
                   bound=bound("ba_normal_eq", args, got[:4], OPS_SOLVE,
                               [lam]),
                   ms=device_ms(lambda: ba_kernels.lm_solve_step(
                       est, lam, *problem), 20),
                   plain_ms=cuda_ms(lambda: lm_soa.lm_solve_step_plain(
                       est, lam, *problem), 3, 1))
        recs[f"lm_solve_step at {shape}"] = rec
        print(f"[steps] lm_solve_step at {shape}: rel err of max|.| per "
              f"object {errs} (limit 1e-4), non-finite du gated for objects "
              f"{gated.nonzero().flatten().tolist()}, repeat bit-equal; "
              f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
              f"{bound_text(rec['ms'], rec['bound'])}")

        # --- accept step: each side starts from its own chi2 at est; object
        # 5's chi2 is set below any trial's, so its step is rejected
        def state(chi2_fn):
            chi2 = chi2_fn(est, *problem)
            chi2[5] = 0.0
            return [est.clone(), chi2, lam0.clone(), nu.clone()]

        runs = [ba_kernels.lm_accept_step(*state(ba_kernels.chi2), est_new,
                                          du, g, lam0, *problem)
                for _ in range(2)]
        st = state(lm_soa.soa_chi2_plain)
        want = lm_soa.lm_accept_step_plain(*st, est_new, du, g, lam0,
                                           *problem)
        torch.cuda.synchronize()
        if not all(same_bits(a, b) for a, b in zip(*runs)):
            raise RuntimeError("lm_accept_step: two launches differ in bits")
        acc = want[4]
        if not torch.equal(runs[0][4], acc):
            raise RuntimeError(
                f"accept flags differ: kernel {runs[0][4].tolist()}, plain "
                f"{acc.tolist()}")
        if not (bool(acc.any()) and not bool(acc[5]) and not bool(acc[3])):
            raise RuntimeError(f"accept flags lack a case: {acc.tolist()}")
        if not torch.equal(runs[0][0][acc], est_new[acc]) or not torch.equal(
                runs[0][0][~acc], est[~acc]):
            raise RuntimeError("lm_accept_step: est not updated in place "
                               "as the flags say")
        one = torch.ones(O, device=dev)
        errs = dict(
            chi2=same_or_both_nan(runs[0][1][:, None], want[1][:, None], 1e-5),
            lam=same_or_both_nan(runs[0][2][:, None], want[2][:, None], 1e-5),
            nu=same_or_both_nan(runs[0][3], want[3], 1e-5, one))
        scratch = state(ba_kernels.chi2)
        rec = dict(kernel="ba_chi2", shape=shape,
                   max_abs_err=float(torch.nan_to_num(
                       runs[0][2] - want[2]).abs().max()),
                   max_rel_err=max(errs.values()),
                   bound=bound("ba_chi2", (est_new, *problem[:6]),
                               [t for t in runs[0]], OPS_ACCEPT,
                               [du, g, lam0, *st]),
                   ms=device_ms(lambda: ba_kernels.lm_accept_step(
                       *scratch, est_new, du, g, lam0, *problem), 20),
                   plain_ms=cuda_ms(lambda: lm_soa.lm_accept_step_plain(
                       *st, est_new, du, g, lam0, *problem), 5, 1))
        recs[f"lm_accept_step at {shape}"] = rec
        print(f"[steps] lm_accept_step at {shape}: accept flags equal "
              f"({int(acc.sum())} accepted, {int((~acc).sum())} rejected of "
              f"{O}), rel err {errs} (limit 1e-5), repeat bit-equal; kernel "
              f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
              f"{bound_text(rec['ms'], rec['bound'])}")
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
    """(device ms, device operations, top kernels) of one fn() call from
    the profiler's CUDA events (kernels, copies and memsets), or None where
    the profiler sees none."""
    kern = profiled(fn)
    if not kern:
        return None
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:4]
    return busy, sum(e.count for e in kern), [
        (e.key[:60], e.count, round(e.self_device_time_total / 1e3, 3))
        for e in top]


def lm_overhead(tracker):
    """One LM call at the tracker's current tier under the profiler: wall
    time, device busy time, launches, and how many of them are not the
    two BA kernels (the eager remainder: soa_prepare, soa_edge_weights, the
    final where).  Then one LM iteration alone, which must be exactly two
    device operations.  Returns the numbers as a dict."""
    from object_oriented_slam_tpu_torch.backend import (
        lm_soa, optimize_objects_soa)
    prep = tracker._prepare_backend()
    obs = tracker._unpack(prep)
    K = tracker._K_dev
    n = torch.zeros(3, device=K.device)
    cfg = tracker.lm_cfg
    tier = tuple(obs.pose2d_cw.shape[:2]) + (obs.pose3d_wc.shape[1],)

    def call():
        return optimize_objects_soa(obs, K, n, prep["gset"], cfg)

    wall = wall_ms(call, 5)
    prof = device_busy(call)
    if prof is None:
        raise RuntimeError("the profiler shows no device time: the launch "
                           "count of an LM call cannot be checked")
    busy, launches, top = prof
    in_kernels = 1 + 2 * cfg.iters
    print(f"[main] one LM call at tier {tier}: {wall:.3f} ms wall (host "
          f"clock, mean of 5); device busy {busy:.3f} ms over {launches} "
          f"device operations, {in_kernels} of them BA kernel launches (1 + 2 "
          f"x {cfg.iters} iterations) and {launches - in_kernels} eager "
          f"(prepare, edge weights, final select); launch-overhead share "
          f"{1 - busy / wall:.3f}; top kernels (name, launches, ms) {top}")

    sp = lm_soa.soa_prepare(obs.pose2d_cw, obs.bbox2d, obs.pose3d_wc,
                            obs.meas3d)
    w2, w3, wg = lm_soa.soa_edge_weights(obs, sp, K, prep["gset"], cfg)
    problem = (sp, w2, w3, wg, n, K, cfg.huber_delta)
    O = obs.est0.shape[0]
    est = obs.est0.clone()
    lam = torch.full((O,), -1.0, device=K.device)
    nu = torch.full((O,), 2.0, device=K.device)
    chi2 = lm_soa.soa_chi2(est, *problem)

    def iteration():
        est_new, du, g, lam0, _ = lm_soa.lm_solve_step(est, lam, *problem)
        lm_soa.lm_accept_step(est, chi2, lam, nu, est_new, du, g, lam0,
                              *problem)

    iteration()
    reps = 10       # a trace of two events alone may come back empty
    events = profiled(iteration, reps, expect=2 * reps)
    it_ops = sum(e.count for e in events)
    names = sorted((e.key[:48], e.count) for e in events)
    print(f"[main] {reps} LM iterations: {it_ops} device operations, "
          f"{sum(e.self_device_time_total for e in events) / 1e3 / reps:.4f} "
          f"ms busy per iteration: {names}")
    if it_ops != 2 * reps:
        raise RuntimeError(
            f"{reps} LM iterations are {it_ops} device operations, not two "
            "kernel launches each")
    return dict(wall_ms=wall, busy_ms=busy, launches=launches,
                eager=launches - in_kernels)


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
          f"LM call's launches)")
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
    recs.update(phase_steps(dev))
    phase_whole_lm(dev)
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_main_path(dev, tmp)

    kernels = [{"name": f"{r['kernel']} ({k})", "route": "cuda",
                "source": SOURCE,
                "replaces": REPLACES.get(k, REPLACES[
                    "K1" if r["kernel"] == "ba_normal_eq" else "K3"]),
                "launches": launches[r["kernel"]],
                "max_abs_err": r["max_abs_err"],
                "max_rel_err": r["max_rel_err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "share_of_bound": r["bound"][0] / r["ms"],
                # no PyTorch call computes these residual chains with their
                # Jacobians and reductions
                "library_ms": None,
                "shape": list(r["shape"])} for k, r in recs.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
