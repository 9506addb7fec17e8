"""K11 (csrc/slam_edges.cu) on the card at a SLAM graph: every built count of
tangent directions a thread, timed; the bits held against
each other and against an older tree's source; the Jacobian launch's phase
clocks.

    python3 examples/torch_slam_edges_bench.py [--state STATE.npz]
        [--parent OLD] [--reps 20] [--out FILE.json]

``--state``: a checkpoint whose graph to use (``chip_smoke.py --keep DIR``
writes ``DIR/slam_state.npz``, the graph of its ``[slam]`` phase;
``system/slam_mode.build_slam_graph`` packs it), else the yaw graph of
examples/torch_slam_edges_on_cpu.py.  For each lanes count (1, 2, 3, 5):
the launch shape, the profiler's kernel time and CUDA events around the same launches
enqueued behind a spin of the card (``chip_smoke.checked_device_ms``),
and whether every output is bit-equal to the entry point's launch; the
chi2 launch's time; ptxas's registers and spills per instantiation; the
phase clocks of a ``-DOSLAM_SLAM_CLOCKS`` build (``phase_clocks``).

``--parent``: a tree of the repository (``git archive REV | tar -x -C
OLD``) whose csrc/slam_edges.cu takes the older C interface (one Jacobian
instantiation, a chi2 block of 128 edges): built with nvcc, its outputs on
every live edge and gravity row and its chi2 are held bit for bit against
this tree's on the graph and on the orbit and yaw graphs (exit 1 if they
differ), and both are timed in turns, old, new, new, old.  Needs the card
and nvcc; every number it prints was measured in that run.
"""
import argparse
import ctypes
import json
import os
import re
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from object_oriented_slam_tpu_torch.backend import (  # noqa: E402
    LMConfig, slam_kernels)
from object_oriented_slam_tpu_torch.ops import _cuda_build  # noqa: E402

KINDS = ("2D", "3D", "odometry", "gravity")
PHASES = ("frame and yaw vote", "chain", "store")


def _module(name, path):
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ptxas(log):
    """{kernel: (registers, spill store bytes, spill load bytes)} of the
    K11 instantiations in nvcc's -Xptxas -v output ``log``: the Jacobian
    kernel as "slam_edge_terms<KW>", the chi2 one as "slam_chi2"."""
    out, name, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            lanes = re.search(r"slam_edge_terms_kernelILi(\d+)E", m.group(1))
            name = (f"slam_edge_terms<{lanes.group(1)}>" if lanes
                    else "slam_chi2" if "slam_chi2_kernel" in m.group(1)
                    else "slam_edge_terms" if "slam_edge_terms_kernel"
                    in m.group(1) else None)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out[name] = (int(m.group(1)), *spill)
            name = None
    return out


def clocks_build():
    """csrc/slam_edges.cu built with -DOSLAM_SLAM_CLOCKS and bound: the
    library."""
    path, _ = _cuda_build.build(slam_kernels.SOURCE, tuple(
        slam_kernels.NVCC_FLAGS) + ("-DOSLAM_SLAM_CLOCKS",))
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.oslam_slam_edge_terms.argtypes = ([p] * 17 + [i] * 5 + [p] * 11
                                          + [i, p])
    lib.oslam_slam_edge_terms.restype = i
    lib.oslam_slam_clocks.argtypes = [p, i]
    lib.oslam_slam_clocks.restype = i
    return lib


def phase_clocks(lib, poses, objects, g, K_mat, normal, lanes=None):
    """Cycles of one Jacobian launch of the clocks build ``lib`` at
    ``lanes`` (the entry point's by default), after two launches that warm
    it up, by edge kind and phase (a 3D edge's dual frame and yaw vote,
    the chain, the store): {kind: {"threads": n, phase: (mean,
    largest)}}."""
    tensors, (E2, E3, Eo, K, F) = slam_kernels._check(poses, objects, g,
                                                      K_mat, normal)
    lanes = slam_kernels.LANES if lanes is None else lanes
    shapes = ((E2, 4), (E2, 4, 6), (E2, 4, 9), (E3, 9), (E3, 9, 6),
              (E3, 9, 9), (Eo, 6), (Eo, 6, 6), (Eo, 6, 6), (K, 1), (K, 1, 9))
    outs = [torch.empty(s, device=poses.device) for s in shapes]
    buf = np.zeros((4, 7), np.uint64)
    rc = 0
    for _ in range(3):
        torch.cuda.synchronize()
        rc = rc or lib.oslam_slam_clocks(buf.ctypes.data, 1)
        rc = rc or lib.oslam_slam_edge_terms(
            *[t.data_ptr() for t in tensors], E2, E3, Eo, K, F,
            *[t.data_ptr() for t in outs], lanes,
            torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if rc or lib.oslam_slam_clocks(buf.ctypes.data, 0):
        raise RuntimeError("the clocks build's launch failed")
    out = {}
    for kind, row in zip(KINDS, buf.astype(np.float64)):
        n = max(row[0], 1)
        out[kind] = {"threads": int(row[0]), **{
            ph: (row[1 + i] / n, row[4 + i]) for i, ph in enumerate(PHASES)}}
    return out


def clocks_text(clk):
    return "; ".join(
        f"{kind} ({c['threads']} threads): " + ", ".join(
            f"{ph} {c[ph][0]:.0f} / {c[ph][1]:.0f}" for ph in PHASES)
        for kind, c in clk.items() if c["threads"])


class OldK11:
    """csrc/slam_edges.cu of the tree at ``root``, built with nvcc and
    bound with its own C interface: one Jacobian instantiation, chi2
    blocks of 128 edges."""

    def __init__(self, root):
        src = os.path.join(root, "object_oriented_slam_tpu_torch", "csrc",
                           "slam_edges.cu")
        path, self.log = _cuda_build.build(src, tuple(
            slam_kernels.NVCC_FLAGS))
        lib = ctypes.CDLL(path)
        p, i = ctypes.c_void_p, ctypes.c_int
        graph = [p] * 17 + [i] * 5
        lib.oslam_slam_edge_terms.argtypes = graph + [p] * 12
        lib.oslam_slam_edge_terms.restype = i
        lib.oslam_slam_chi2.argtypes = graph + [p] * 4
        lib.oslam_slam_chi2.restype = i
        self.lib = lib

    def edge_terms(self, poses, objects, g, K_mat, normal):
        tensors, (E2, E3, Eo, K, F) = slam_kernels._check(
            poses, objects, g, K_mat, normal)
        dev = poses.device
        shapes = ((E2, 4), (E2, 4, 6), (E2, 4, 9), (E3, 9), (E3, 9, 6),
                  (E3, 9, 9), (Eo, 6), (Eo, 6, 6), (Eo, 6, 6), (K, 1),
                  (K, 1, 9))
        outs = [torch.empty(s, device=dev) for s in shapes]
        rc = self.lib.oslam_slam_edge_terms(
            *[t.data_ptr() for t in tensors], E2, E3, Eo, K, F,
            *[t.data_ptr() for t in outs],
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"the old Jacobian launch: CUDA error {rc}")
        return tuple(outs)

    def chi2(self, poses, objects, g, K_mat, normal):
        tensors, (E2, E3, Eo, K, F) = slam_kernels._check(
            poses, objects, g, K_mat, normal)
        dev = poses.device
        partial = torch.empty(max(1, -(-(E2 + E3 + Eo + K) // 128)),
                              device=dev)
        done = torch.zeros(1, dtype=torch.int32, device=dev)
        out = torch.empty((), device=dev)
        rc = self.lib.oslam_slam_chi2(
            *[t.data_ptr() for t in tensors], E2, E3, Eo, K, F,
            partial.data_ptr(), done.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"the old chi2 launch: CUDA error {rc}")
        return out


def live_rows(g):
    """Per output r2 ... Jg, the rows the contract holds bit for bit: the
    live edges (non-zero weight) and every gravity row."""
    return [g.e2_w != 0] * 3 + [g.e3_w != 0] * 3 + [g.odo_w != 0] * 3 + [
        torch.ones_like(g.grav_w, dtype=torch.bool)] * 2


def bit_report(got, want, g):
    """(outputs bit-equal on the live rows, on every row): two bools."""
    live = all(torch.equal(a.view(torch.int32)[m], b.view(torch.int32)[m])
               for a, b, m in zip(got, want, live_rows(g)))
    every = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                for a, b in zip(got, want))
    return live, every


def graph_on(dev, state=None):
    """(graph, K, normal) on ``dev``: the checkpoint's, else the yaw
    graph."""
    ex = _module("torch_slam_edges_on_cpu",
                 os.path.join(ROOT, "examples", "torch_slam_edges_on_cpu.py"))
    if state:
        from object_oriented_slam_tpu_torch.system.checkpoint import \
            load_state
        from object_oriented_slam_tpu_torch.system.slam_mode import \
            build_slam_graph
        st = load_state(state)
        g, _ = build_slam_graph(st, LMConfig(), device=dev)
        return (g, torch.tensor(ex.K_MAT, device=dev), torch.as_tensor(
            np.asarray(st.ground_plane[:3], np.float32), device=dev))
    return to_device(ex.yaw_graph(), dev)


def to_device(gkn, dev):
    g, K, n = gkn
    return type(g)(*[t.to(dev) for t in g]), K.to(dev), n.to(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--state", default=None)
    ap.add_argument("--parent", default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_slam_edges_bench: no CUDA device", file=sys.stderr)
        return 1
    sm = _module("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    dev = torch.device("cuda", 0)
    print(f"[card] {sm.card_line()}")
    slam_kernels.build()
    regs = ptxas(slam_kernels.build_log)
    print(f"[ptxas] {regs}")
    g, K, n = graph_on(dev, args.state)
    E2, E3, Eo, Ko = (g.e2_w.shape[0], g.e3_w.shape[0], g.odo_w.shape[0],
                      g.objects.shape[0])
    live = [int((w != 0).sum()) for w in (g.e2_w, g.e3_w, g.odo_w)]
    print(f"[graph] {'checkpoint ' + args.state if args.state else 'yaw'}: "
          f"E2 {E2} ({live[0]} live), E3 {E3} ({live[1]}), Eo {Eo} "
          f"({live[2]}), K {Ko}; the entry point's lanes "
          f"{slam_kernels.LANES}")
    a = (g.poses_cw, g.objects, g, K, n)
    want = slam_kernels.edge_terms(*a)
    rows, ok = [], True
    for lanes in slam_kernels.LANES_BUILT:
        shape = slam_kernels.launch_shape(E2, E3, Eo, Ko, lanes)
        got = slam_kernels.edge_terms_at(*a, lanes)
        same = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                   for x, y in zip(got, want))
        ms, ev = sm.checked_device_ms(
            lambda: slam_kernels.edge_terms_at(*a, lanes), args.reps,
            "slam_edge_terms_kernel")
        ok = ok and same
        r = regs.get(f"slam_edge_terms<{lanes}>", (None, None, None))
        rows.append(dict(lanes=lanes, shape=shape, ms=ms, events_ms=ev,
                         bits_equal=same, registers=r[0], spill=r[1:]))
        print(f"[lanes] {lanes} a thread: {shape[0]} threads x {shape[1]} "
              f"blocks ({shape[2]} dealt): {ms:.4f} ms (events {ev:.4f}), "
              f"bit-equal to the entry point's {same}; registers {r[0]}, "
              f"spill {r[1:]}")
    c_ms, c_ev = sm.checked_device_ms(lambda: slam_kernels.chi2(*a),
                                      args.reps, "slam_chi2_kernel")
    print(f"[chi2] {c_ms:.4f} ms (events {c_ev:.4f}); registers "
          f"{regs.get('slam_chi2')}")
    clk = phase_clocks(clocks_build(), *a)
    print(f"[clocks] cycles, mean / largest: {clocks_text(clk)}")
    result = {"card": sm.card_line(), "rows": rows, "chi2_ms": c_ms,
              "chi2_events_ms": c_ev, "clocks": clk, "ptxas": regs}

    if args.parent:
        old = OldK11(args.parent)
        result["old_ptxas"] = ptxas(old.log)
        ex = _module("torch_slam_edges_on_cpu", os.path.join(
            ROOT, "examples", "torch_slam_edges_on_cpu.py"))
        for name, gkn in (("graph", (g, K, n)),
                          ("orbit", to_device(ex.orbit_graph(), dev)),
                          ("yaw", to_device(ex.yaw_graph(), dev))):
            gg, KK, nn = gkn
            aa = (gg.poses_cw, gg.objects, gg, KK, nn)
            live_eq, all_eq = bit_report(slam_kernels.edge_terms(*aa),
                                         old.edge_terms(*aa), gg)
            c_new, c_old = slam_kernels.chi2(*aa), old.chi2(*aa)
            c_eq = torch.equal(c_new.view(torch.int32),
                               c_old.view(torch.int32))
            ok = ok and live_eq and c_eq
            result[f"old_{name}"] = dict(live_bits=live_eq, all_bits=all_eq,
                                         chi2_bits=c_eq, chi2=float(c_new))
            print(f"[old] {name}: outputs bit-equal to the old source's on "
                  f"the live edges and gravity rows {live_eq} (every row "
                  f"{all_eq}); chi2 {float(c_new):.9g} / {float(c_old):.9g}, "
                  f"bit-equal {c_eq}")
        times = []
        for who in ("old", "new", "new", "old"):
            k = old if who == "old" else slam_kernels
            t = sm.checked_device_ms(lambda: k.edge_terms(*a), args.reps,
                                     "slam_edge_terms_kernel")
            # the old chi2 call also zeroes its ticket counter
            tc = sm.checked_device_ms(lambda: k.chi2(*a), args.reps,
                                      "slam_chi2_kernel", whole=who == "old")
            times.append((who, t, tc))
            print(f"[turns] {who}: edge terms {t[0]:.4f} ms (events "
                  f"{t[1]:.4f}), chi2 {tc[0]:.4f} ms (events {tc[1]:.4f})")
        result["turns"] = times
        print(f"[old] ptxas {result['old_ptxas']}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1, default=str)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
