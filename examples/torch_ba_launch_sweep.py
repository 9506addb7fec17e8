"""Times the BA edge kernels of the PyTorch + CUDA port over launch shapes.

    python3 examples/torch_ba_launch_sweep.py [--reps 50]

For each LM tier (objects, 2D edge slots, 3D edge slots) and each
candidate (S, T) -- S blocks per object in one thread block cluster, T
threads per block -- it launches ``ba_normal_eq``, ``ba_chi2`` and the two
LM step entry points on a seeded batch and prints the mean device time of
a launch (the profiler's kernel events over ``--reps`` launches), with the
shape that ``backend/ba_kernels.launch_shape`` picks marked.  Needs an
NVIDIA GPU (sm_90a) and nvcc; the card's name and power limit are printed
first.
The kernels are built with ``-DOSLAM_PHASE_CLOCKS``, and for the picked
shape the SM clock cycles between the phase boundaries of one
``lm_solve_step`` launch (block (0, 0)) are printed too: where a launch's
time goes.  The tables in PERF.md come from here.
"""
import argparse
import ctypes
import os
import subprocess
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from object_oriented_slam_tpu_torch.backend import (  # noqa: E402
    LMConfig, ba_kernels, lm_soa, observations_from_numpy)
from object_oriented_slam_tpu_torch.io.synthetic import make_lm_batch  # noqa: E402

PHASES = ("per-object part", "edge chains", "J^T J of the warp",
          "block sums + cluster barrier", "object sums + cluster barrier",
          "solve epilogue")
TIERS = [(24, 64, 32), (24, 128, 32), (24, 256, 32), (24, 512, 32),
         (24, 512, 256), (48, 512, 32)]
SHAPES = [(1, 64), (1, 128), (2, 64), (2, 128), (3, 64), (4, 64), (3, 128),
          (4, 96), (4, 128), (5, 128), (6, 96), (8, 64), (6, 128), (8, 96),
          (8, 128)]


def device_us(fn, reps):
    """Mean time the card spends on the kernels of one fn() call (the
    profiler's CUDA kernel events over reps calls): a launch takes the host
    longer to enqueue than the card to run, so CUDA events around
    back-to-back launches would time the host."""
    for _ in range(3):
        fn()
    first = torch.empty(8, device="cuda")
    for _ in range(3):      # the trace now and then comes back short
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # a trace may lack its first launches: random fills go first
            # and are left out by name
            for _ in range(8):
                first.random_()
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and "distribution_elementwise" not in e.key]
        if sum(e.count for e in events) == reps:
            return sum(e.self_device_time_total for e in events) / reps
    raise RuntimeError("the profiler does not show every launch")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    reps = ap.parse_args().reps
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    ba_kernels.NVCC_FLAGS.append("-DOSLAM_PHASE_CLOCKS")
    lib = ba_kernels._load()
    lib.oslam_set_phase_clocks.argtypes = [ctypes.c_void_p]
    clocks = torch.zeros(8, dtype=torch.int64, device=dev)
    K = torch.tensor([[535.4, 0, 320.1], [0, 539.2, 247.6], [0, 0, 1]],
                     device=dev)
    n = torch.tensor((0.05, -0.02, 1.0), device=dev)
    picked = ba_kernels.launch_shape
    print("device time in us per launch: normal_eq, chi2, lm_solve_step, "
          "lm_accept_step; * = the shape launch_shape picks")
    for tier in TIERS:
        obs = observations_from_numpy(make_lm_batch(*tier, seed=7), dev)
        prep = lm_soa.soa_prepare(obs.pose2d_cw, obs.bbox2d, obs.pose3d_wc,
                                  obs.meas3d)
        w2, w3, wg = lm_soa.soa_edge_weights(obs, prep, K, True, LMConfig())
        if tier[2] == 32:            # the 2D-only path masks its 3D slots
            w3 = torch.zeros_like(w3)
        problem = (prep, w2, w3, wg, n, K, 0.0)
        O, E = tier[0], tier[1] + tier[2]
        lam = torch.full((O,), -1.0, device=dev)
        nu = torch.full((O,), 2.0, device=dev)
        chi2 = ba_kernels.chi2(obs.est0, *problem)
        est_new, du, g, lam0, _ = ba_kernels.lm_solve_step(obs.est0, lam,
                                                           *problem)
        state = [obs.est0.clone(), chi2, lam.clone(), nu]
        print(f"tier {tier}, {E} edge slots per object:")
        for S, T in SHAPES:
            if 2 * S * T < E and S < 8 and (S, T) != picked(E):
                continue            # more than two edges per thread
            if S > 1 and (S - 1) * T >= E:
                continue            # a block of the cluster would be empty
            ba_kernels.launch_shape = lambda _n, st=(S, T): st
            t = [device_us(lambda: ba_kernels.normal_eq(obs.est0, *problem),
                         reps),
                 device_us(lambda: ba_kernels.chi2(obs.est0, *problem), reps),
                 device_us(lambda: ba_kernels.lm_solve_step(obs.est0, lam,
                                                          *problem), reps),
                 device_us(lambda: ba_kernels.lm_accept_step(
                     *state, est_new, du, g, lam0, *problem), reps)]
            mark = "*" if (S, T) == picked(E) else " "
            print(f"  {mark} S={S} T={T:3d} ({O * S:3d} blocks): "
                  + "  ".join(f"{x:8.2f}" for x in t))
        ba_kernels.launch_shape = picked
        lib.oslam_set_phase_clocks(clocks.data_ptr())
        ba_kernels.lm_solve_step(obs.est0, lam, *problem)
        torch.cuda.synchronize()
        lib.oslam_set_phase_clocks(None)
        c = clocks.tolist()
        print(f"    lm_solve_step at {picked(E)}, SM cycles of block (0, 0): "
              + ", ".join(f"{name} {c[i + 1] - c[i]}"
                          for i, name in enumerate(PHASES))
              + f", all {c[6] - c[0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
