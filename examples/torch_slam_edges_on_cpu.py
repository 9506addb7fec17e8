"""K11's chains (csrc/slam_edges.cu) built for the CPU, to hold them against
the plain version without a card and to count their operations.

    python3 examples/torch_slam_edges_on_cpu.py [--state STATE.npz] [--count]

The device functions of ``slam_edges.cu`` (and ``dual.cuh``) compile with
g++ when ``OSLAM_HOST_CHAINS`` is defined and the CUDA qualifiers are
defined away (``-ffp-contract=off``: every multiply and add rounds on its
own, as with nvcc's ``-fmad=false``).  A small host loop runs every
thread's chain as the Jacobian kernel deals them (an edge's 15 tangent
directions over 3 threads of ``Dual<5>``, 12 for an odometry edge, 9 for a
gravity prior over 2) and writes the outputs as ``store`` does, and the
float instantiation gives each edge's gated sum of squares.  The graph is
the seeded orbit of ``orbit_graph`` (2 objects, 12 frames, one non-finite
2D edge, one 3D measurement a quarter turn of yaw away), or the one
``system/slam_mode.build_slam_graph`` packs from a checkpoint
(``--state``).  Prints, per output, the largest distance of the chains and
of the plain version (``backend/slam_ba.edge_terms_plain``) from the plain
version in float64, and exits 1 if the chains are further from it than 4
times the plain version or 1e-4 of the output's largest entry, or if their
non-finite entries differ.  The math library is the host's, not the
card's, so this holds the chains' algebra, not the card's bits.

``--count`` builds the chains again with a float type that counts its
operations (one per + - * / negation, compare, sqrt, sin, cos, atan2,
acos), with one and with five tangent directions a thread, and prints the
operations the graph's live edges need (``count_ops``: an edge's primal
chain once, its tangent work once a direction), as ``chip_smoke.py``'s
K11 bound counts them on its graph.  Needs g++ (C++17).
"""
import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from object_oriented_slam_tpu_torch.backend import (  # noqa: E402
    LMConfig, slam_ba)
from object_oriented_slam_tpu_torch.core import ellipsoid as ell  # noqa: E402
from object_oriented_slam_tpu_torch.core import se3  # noqa: E402

CSRC = os.path.join(ROOT, "object_oriented_slam_tpu_torch", "csrc")
K_MAT = np.array([[535.4, 0, 320.1], [0, 539.2, 247.6], [0, 0, 1]],
                 np.float32)
NAMES = ("r2", "Jp2", "Jo2", "r3", "Jp3", "Jo3", "ro", "Ji", "Jj", "rg", "Jg")

PRELUDE = r'''
#include <cmath>
#include <math.h>
using std::isfinite;
using std::isnan;
#define __device__
#define __forceinline__ inline
#define __constant__ static
'''

# a float that counts its operations; every ``float`` of the chains becomes
# one (the literals stay float and convert)
COUNTING = r'''
typedef float real_float;
static long long g_ops = 0;
struct CF {
  real_float x;
  constexpr CF() : x(0.f) {}
  constexpr CF(double v) : x((real_float)v) {}
};
inline CF op(real_float v) { ++g_ops; CF r; r.x = v; return r; }
inline CF operator+(CF a, CF b) { return op(a.x + b.x); }
inline CF operator-(CF a, CF b) { return op(a.x - b.x); }
inline CF operator*(CF a, CF b) { return op(a.x * b.x); }
inline CF operator/(CF a, CF b) { return op(a.x / b.x); }
inline CF operator-(CF a) { return op(-a.x); }
inline CF& operator+=(CF& a, CF b) { a = a + b; return a; }
inline bool operator<(CF a, CF b) { ++g_ops; return a.x < b.x; }
inline bool operator>(CF a, CF b) { ++g_ops; return a.x > b.x; }
inline bool operator>=(CF a, CF b) { ++g_ops; return a.x >= b.x; }
inline bool operator==(CF a, CF b) { ++g_ops; return a.x == b.x; }
inline bool isnan(CF a) { ++g_ops; return std::isnan(a.x); }
inline bool isfinite(CF a) { ++g_ops; return std::isfinite(a.x); }
inline CF sqrtf(CF a) { return op(std::sqrt(a.x)); }
inline CF sinf(CF a) { return op(std::sin(a.x)); }
inline CF cosf(CF a) { return op(std::cos(a.x)); }
inline CF acosf(CF a) { return op(std::acos(a.x)); }
inline CF atan2f(CF a, CF b) { return op(std::atan2(a.x, b.x)); }
#define float CF
'''

HARNESS = r'''
#include "slam_edges.cu"

#ifdef OSLAM_COUNT_OPS
typedef real_float in_t;
static const CF* to_cf(const in_t* p, long long n) {
  CF* out = new CF[n > 0 ? n : 1];
  for (long long i = 0; i < n; ++i) out[i].x = p[i];
  return out;
}
#else
typedef float in_t;
static const float* to_cf(const in_t* p, long long) { return p; }
#endif

static Graph make_graph(const in_t* poses, const in_t* objects,
                        const in_t* K, const in_t* normal,
                        const long long* e2_frame, const long long* e2_obj,
                        const in_t* e2_bbox, const in_t* e2_w,
                        const long long* e3_frame, const long long* e3_obj,
                        const in_t* e3_meas, const in_t* e3_w,
                        const long long* odo_i, const long long* odo_j,
                        const in_t* odo_meas, const in_t* odo_w,
                        const in_t* grav_w, int E2, int E3, int Eo, int Ko,
                        int F) {
  Graph g = {to_cf(poses, 7LL * F), to_cf(objects, 10LL * Ko),
             to_cf(K, 9), to_cf(normal, 3), e2_frame, e2_obj,
             to_cf(e2_bbox, 4LL * E2), to_cf(e2_w, E2), e3_frame, e3_obj,
             to_cf(e3_meas, 10LL * E3), to_cf(e3_w, E3), odo_i, odo_j,
             to_cf(odo_meas, 7LL * Eo), to_cf(odo_w, Eo), to_cf(grav_w, Ko),
             E2, E3, Eo, Ko};
  return g;
}

#define GRAPH_ARGS                                                         \
  const in_t *poses, const in_t *objects, const in_t *K,                  \
      const in_t *normal, const long long *e2_frame,                       \
      const long long *e2_obj, const in_t *e2_bbox, const in_t *e2_w,      \
      const long long *e3_frame, const long long *e3_obj,                  \
      const in_t *e3_meas, const in_t *e3_w, const long long *odo_i,       \
      const long long *odo_j, const in_t *odo_meas, const in_t *odo_w,     \
      const in_t *grav_w, int E2, int E3, int Eo, int Ko, int F
#define GRAPH                                                              \
  make_graph(poses, objects, K, normal, e2_frame, e2_obj, e2_bbox, e2_w,   \
             e3_frame, e3_obj, e3_meas, e3_w, odo_i, odo_j, odo_meas,      \
             odo_w, grav_w, E2, E3, Eo, Ko, F)

extern "C" {

#ifndef OSLAM_COUNT_OPS
// the Jacobian kernel's threads in order, then each edge's chi2 term
void host_edge_terms(GRAPH_ARGS, float* r2, float* Jp2, float* Jo2,
                     float* r3, float* Jp3, float* Jo3, float* ro, float* Ji,
                     float* Jj, float* rg, float* Jg, float* sq) {
  const Graph g = GRAPH;
  for (int e = 0; e < E2; ++e)
    for (int grp = 0; grp < kGroups2; ++grp) {
      DW r[4];
      rows_2d(g, e, kW * grp, r);
      store<4, 6, 9>(r, grp, true, r2 + 4 * e, Jp2 + 24 * e, Jo2 + 36 * e);
    }
  for (int e = 0; e < E3; ++e)
    for (int grp = 0; grp < kGroups3; ++grp) {
      DW r[9];
      rows_3d(g, e, kW * grp, r);
      store<9, 6, 9>(r, grp, true, r3 + 9 * e, Jp3 + 54 * e, Jo3 + 81 * e);
    }
  for (int e = 0; e < Eo; ++e)
    for (int grp = 0; grp < kGroupsO; ++grp) {
      DW r[6];
      rows_odo(g, e, kW * grp, r);
      store<6, 6, 6>(r, grp, true, ro + 6 * e, Ji + 36 * e, Jj + 36 * e);
    }
  for (int k = 0; k < Ko; ++k)
    for (int grp = 0; grp < kGroupsG; ++grp) {
      DW r[1] = {row_grav<DW>(g, k, kW * grp)};
      store<1, 9, 0>(r, grp, false, rg + k, Jg + 9 * k, nullptr);
    }
  int t = 0;
  for (int e = 0; e < E2; ++e, ++t) {
    float r[4];
    rows_2d(g, e, 0, r);
    sq[t] = gated_square_sum(r);
  }
  for (int e = 0; e < E3; ++e, ++t) {
    float r[9];
    rows_3d(g, e, 0, r);
    sq[t] = gated_square_sum(r);
  }
  for (int e = 0; e < Eo; ++e, ++t) {
    float r[6];
    rows_odo(g, e, 0, r);
    sq[t] = gated_square_sum(r);
  }
  for (int k = 0; k < Ko; ++k, ++t) {
    const float r = row_grav<float>(g, k, 0);
    sq[t] = r * r;
  }
}
#else
// operations of one Jacobian thread of each edge (its first kW directions)
// and of each edge's chi2 term, edge by edge in the order E2 E3 Eo K:
// ops[0 .. n) and ops[n .. 2n)
void host_count(GRAPH_ARGS, long long* ops) {
  const Graph g = GRAPH;
  const long long n = (long long)E2 + E3 + Eo + Ko;
  long long* jac = ops;
  long long* sq = ops + n;
  int t = 0;
  for (int e = 0; e < E2; ++e, ++t) {
    long long b = g_ops;
    DW rd[4];
    rows_2d(g, e, 0, rd);
    jac[t] = g_ops - b;
    b = g_ops;
    float r[4];
    rows_2d(g, e, 0, r);
    gated_square_sum(r);
    sq[t] = g_ops - b;
  }
  for (int e = 0; e < E3; ++e, ++t) {
    long long b = g_ops;
    DW rd[9];
    rows_3d(g, e, 0, rd);
    jac[t] = g_ops - b;
    b = g_ops;
    float r[9];
    rows_3d(g, e, 0, r);
    gated_square_sum(r);
    sq[t] = g_ops - b;
  }
  for (int e = 0; e < Eo; ++e, ++t) {
    long long b = g_ops;
    DW rd[6];
    rows_odo(g, e, 0, rd);
    jac[t] = g_ops - b;
    b = g_ops;
    float r[6];
    rows_odo(g, e, 0, r);
    gated_square_sum(r);
    sq[t] = g_ops - b;
  }
  for (int k = 0; k < Ko; ++k, ++t) {
    long long b = g_ops;
    row_grav<DW>(g, k, 0);
    jac[t] = g_ops - b;
    b = g_ops;
    const float r = row_grav<float>(g, k, 0);
    r* r;
    sq[t] = g_ops - b;
  }
}
#endif

}  // extern "C"
'''


def build(count=False, workdir=None, lanes=None):
    """Compile the chains with g++ into ``workdir`` (a temporary directory
    by default); returns the loaded library.  ``count``: the counting
    build; ``lanes``: its tangent directions a thread (the kernel's 5 by
    default)."""
    workdir = workdir or tempfile.mkdtemp(prefix="slam_edges_cpu_")
    fake = os.path.join(workdir, "fake")
    os.makedirs(fake, exist_ok=True)
    open(os.path.join(fake, "cuda_runtime.h"), "w").close()
    tag = f"count{lanes or ''}" if count else "chains"
    src = os.path.join(workdir, f"harness_{tag}.cpp")
    with open(src, "w") as f:
        f.write(PRELUDE + (COUNTING if count else "") + HARNESS)
    lib = os.path.join(workdir, f"libslam_{tag}.so")
    cmd = ["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC",
           "-shared", "-w", "-DOSLAM_HOST_CHAINS", "-I", fake, "-I", CSRC]
    if count:
        cmd.append("-DOSLAM_COUNT_OPS")
    if lanes:
        cmd.append(f"-DOSLAM_LANES={int(lanes)}")
    proc = subprocess.run(cmd + ["-o", lib, src], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on the K11 chains:\n{proc.stderr}")
    return ctypes.CDLL(lib)


def _graph_args(g, K, normal):
    t = [g.poses_cw, g.objects, K, normal, g.e2_frame, g.e2_obj, g.e2_bbox,
         g.e2_w, g.e3_frame, g.e3_obj, g.e3_meas, g.e3_w, g.odo_i, g.odo_j,
         g.odo_meas, g.odo_w, g.grav_w]
    t = [x.contiguous() for x in t]
    sizes = (g.e2_w.shape[0], g.e3_w.shape[0], g.odo_w.shape[0],
             g.objects.shape[0], g.poses_cw.shape[0])
    return t, sizes, ([ctypes.c_void_p(x.data_ptr()) for x in t]
                      + [ctypes.c_int(n) for n in sizes])


def chains(lib, g, K, normal):
    """K11's outputs (r2 ... Jg) and each edge's chi2 term [E2+E3+Eo+K] by
    the host build of its chains."""
    keep, (E2, E3, Eo, Ko, _), args = _graph_args(g, K, normal)
    shapes = ((E2, 4), (E2, 4, 6), (E2, 4, 9), (E3, 9), (E3, 9, 6),
              (E3, 9, 9), (Eo, 6), (Eo, 6, 6), (Eo, 6, 6), (Ko, 1),
              (Ko, 1, 9), (E2 + E3 + Eo + Ko,))
    outs = [torch.full(s, float("nan")) for s in shapes]
    lib.host_edge_terms(*args, *[ctypes.c_void_p(t.data_ptr()) for t in outs])
    return outs[:-1], outs[-1]


# tangent directions of a 2D, 3D and odometry edge and a gravity prior
DIRECTIONS = dict(e2=15, e3=15, odo=12, grav=9)


def count_ops(g, K, normal, workdir=None):
    """The f32 operations K11's two instantiations need on graph ``g``:
    {"slam_edge_terms": {e2, e3, odo, grav}, "slam_chi2": {...}, "live":
    {...}}, totals over the live edges of each kind (non-zero weight; the
    others' r and J are zeros) and their counts.  An edge's Jacobian
    counts its primal chain once and its tangent work once a direction:
    a thread of one direction (``lanes=1``) plus, for each further
    direction, a kW-direction thread's excess over it divided by kW - 1
    (the kernel's threads each recompute the primal chain; that is not
    counted).  The chi2 counts one float chain and its square sum an
    edge.  Builds the two counting libraries in ``workdir``."""
    keep, (E2, E3, Eo, Ko, _), args = _graph_args(g, K, normal)
    n = E2 + E3 + Eo + Ko
    per = {}
    for lanes in (1, 5):
        ops = (ctypes.c_longlong * (2 * n))()
        build(count=True, workdir=workdir, lanes=lanes).host_count(*args,
                                                                   ops)
        per[lanes] = np.array(ops[:], np.float64).reshape(2, n)
    kinds = ("e2", "e3", "odo", "grav")
    ends = np.cumsum([0, E2, E3, Eo, Ko])
    weights = (g.e2_w, g.e3_w, g.odo_w, g.grav_w)
    out = {"slam_edge_terms": {}, "slam_chi2": {}, "live": {}}
    for i, k in enumerate(kinds):
        live = (weights[i] != 0).cpu().numpy()
        x1 = per[1][0, ends[i]:ends[i + 1]][live]
        x5 = per[5][0, ends[i]:ends[i + 1]][live]
        jac = x1 + (DIRECTIONS[k] - 1) * (x5 - x1) / 4
        out["slam_edge_terms"][k] = int(round(jac.sum()))
        out["slam_chi2"][k] = int(per[5][1, ends[i]:ends[i + 1]][live].sum())
        out["live"][k] = int(live.sum())
    return out


def _look_at(t_wc, target):
    z = target - t_wc
    z /= np.linalg.norm(z)
    x = np.cross(np.array([0, 0, 1.0]), z)
    x /= np.linalg.norm(x)
    R = np.stack([x, np.cross(z, x), z], axis=1)
    q = se3.mat_to_quat(torch.tensor(R, dtype=torch.float32))
    return torch.cat([torch.tensor(t_wc, dtype=torch.float32), q])


def orbit_graph(F=12, seed=0):
    """Two ellipsoids seen from an orbit of F cameras: every frame a 2D and
    a 3D edge of each, the chain odometry, gravity priors; the cameras and
    objects perturbed from the measurements' truth.  One 2D measurement is
    infinite (its residual is, so the edge is zeroed) and one 3D
    measurement is turned a quarter turn of yaw with its x/y axes swapped (its error's least-norm
    candidate is a rotated one).  Returns (SlamGraph on the CPU, K,
    normal)."""
    rng = np.random.default_rng(seed)
    gt = torch.tensor([[0.2, -0.1, 0.4, 0, 0, 0.2, 0.98, 0.5, 0.3, 0.25],
                       [-0.6, 0.5, 0.3, 0, 0, -0.3, 0.954, 0.3, 0.2, 0.35]],
                      dtype=torch.float32)
    gt[:, 3:7] = se3.quat_normalize(gt[:, 3:7])
    K = torch.tensor(K_MAT)
    poses_wc = torch.stack([_look_at(np.array(
        [2.8 * np.cos(a), 2.8 * np.sin(a), 1.1]), np.zeros(3))
        for a in 2 * np.pi * np.arange(F) / F])
    poses_cw = se3.se3_inv(poses_wc)
    e2_f, e2_o, e2_b, e3_f, e3_o, e3_m = [], [], [], [], [], []
    for f in range(F):
        for k in range(2):
            e2_f.append(f)
            e2_o.append(k)
            e2_b.append(ell.project_bbox(gt[k], poses_cw[f], K))
            e3_f.append(f)
            e3_o.append(k)
            e3_m.append(ell.transform_to(gt[k], poses_wc[f]))
    e2_b, e3_m = torch.stack(e2_b), torch.stack(e3_m)
    e2_b[5, 2] = float("inf")
    e3_m[7] = ell.rotate_yaw(e3_m[7], 1)
    odo = se3.se3_mul(poses_cw[1:], se3.se3_inv(poses_cw[:-1]))
    init = poses_cw.clone()
    init[1:, :3] += torch.tensor(rng.normal(0, 0.02, (F - 1, 3)),
                                 dtype=torch.float32)
    objs = gt.clone()
    objs[:, :3] += torch.tensor(rng.normal(0, 0.04, (2, 3)),
                                dtype=torch.float32)
    arrays = dict(
        poses_cw=init, frame_mask=np.ones(F, bool), objects=objs,
        obj_mask=np.ones(2, bool), e2_frame=e2_f, e2_obj=e2_o, e2_bbox=e2_b,
        e2_w=np.full(2 * F, 0.9, np.float32), e3_frame=e3_f, e3_obj=e3_o,
        e3_meas=e3_m, e3_w=np.full(2 * F, 3.0, np.float32),
        odo_i=np.arange(F - 1), odo_j=np.arange(1, F), odo_meas=odo,
        odo_w=np.full(F - 1, 2.0, np.float32),
        grav_w=np.full(2, 1.0, np.float32))
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    normal = torch.tensor([0.05, -0.02, 1.0])
    return slam_ba.graph_from_numpy(arrays, device="cpu"), K, normal


def state_graph(path):
    """The graph build_slam_graph packs from the checkpoint ``path``, with
    the synthetic configs' camera."""
    from object_oriented_slam_tpu_torch.system.checkpoint import load_state
    from object_oriented_slam_tpu_torch.system.slam_mode import \
        build_slam_graph
    st = load_state(path)
    g, _ = build_slam_graph(st, LMConfig(), device="cpu")
    normal = torch.tensor(np.asarray(st.ground_plane[:3], np.float32))
    return g, torch.tensor(K_MAT), normal


def compare(lib, g, K, normal):
    """(report lines, ok): the chains against the plain version, both
    against the plain version in float64."""
    got, sq = chains(lib, g, K, normal)
    want = slam_ba.edge_terms_plain(g.poses_cw, g.objects, g, K, normal)
    g64 = type(g)(*[t.double() if t.is_floating_point() else t for t in g])
    want64 = slam_ba.edge_terms_plain(g64.poses_cw, g64.objects, g64,
                                      K.double(), normal.double())
    lines, ok = [], True
    for name, a, b, c in zip(NAMES, got, want, want64):
        if b.numel() == 0:
            continue
        same = torch.equal(torch.isfinite(a), torch.isfinite(b))
        fin = torch.isfinite(b) & torch.isfinite(c)
        d_k = float((a.double() - c)[fin].abs().max())
        d_p = float((b.double() - c)[fin].abs().max())
        scale = float(c[fin].abs().max())
        good = same and d_k <= max(4 * d_p, 1e-4 * scale)
        ok = ok and good
        lines.append(f"{name:4s} {tuple(b.shape)}: chains {d_k:.3g}, plain "
                     f"{d_p:.3g} from float64 (largest entry {scale:.4g}); "
                     f"non-finite entries alike {same}")
    c_k = float(sq.double().sum())
    c_p = float(slam_ba._chi2_plain(g.poses_cw, g.objects, g, K, normal))
    lines.append(f"chi2: chains {c_k:.8g}, plain {c_p:.8g}")
    ok = ok and abs(c_k - c_p) <= 1e-5 * abs(c_p)
    return lines, ok


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--state", default=None,
                    help="a checkpoint (.npz) whose packed graph to use")
    ap.add_argument("--count", action="store_true",
                    help="count the chains' operations per edge")
    args = ap.parse_args(argv)
    g, K, normal = (state_graph(args.state) if args.state
                    else orbit_graph())
    lines, ok = compare(build(), g, K, normal)
    print("\n".join(lines))
    if args.count:
        print(count_ops(g, K, normal))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
