"""K11 (csrc/slam_edges.cu) built for the CPU, to hold it against the plain
version without a card and to count its operations.

    python3 examples/torch_slam_edges_on_cpu.py [--state STATE.npz] [--count]

The source compiles with g++ when ``OSLAM_HOST_CHAINS`` is defined and the
CUDA qualifiers are defined away (``-ffp-contract=off``: every multiply
and add rounds on its own, as with nvcc's ``-fmad=false``); with
``OSLAM_HOST_KERNELS`` its kernels compile too, and ``build()`` runs their
launches as the card would (``chains``): the launch's own shape and
dealing, its blocks one after another, a block's threads as std::threads,
a warp's shuffles between barriers of the warp.  The graph is the seeded
orbit of ``orbit_graph`` (2 objects, 12 frames, one non-finite 2D edge,
one 3D measurement a quarter turn of yaw away), ``yaw_graph``'s (every
branch of the 3D edge's yaw choice) or the one
``system/slam_mode.build_slam_graph`` packs from a checkpoint
(``--state``).  Prints, per output, the largest distance of the kernels
and of the plain version (``backend/slam_ba.edge_terms_plain``) from the
plain version in float64, and exits 1 if the kernels are further from it
than 4 times the plain version or 1e-4 of the output's largest entry, or
if their non-finite entries differ.  The math library is the host's, not
the card's, so this holds the chains' algebra, not the card's bits.

``--count`` builds the chains again with a float type that counts its
operations (one per + - * / negation, compare, sqrt, sin, cos, atan2,
acos), with one and with five tangent directions a thread, and prints the
operations the graph's live edges need (``count_ops``: an edge's primal
chain once, its tangent work once a direction, a 3D edge's tangents for
its winning yaw candidate alone), as ``chip_smoke.py``'s K11 bound counts
them on its graph.  Needs g++ (C++20).
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
    LMConfig, slam_ba, slam_kernels)
from object_oriented_slam_tpu_torch.core import ellipsoid as ell  # noqa: E402
from object_oriented_slam_tpu_torch.core import se3  # noqa: E402

CSRC = os.path.join(ROOT, "object_oriented_slam_tpu_torch", "csrc")
K_MAT = np.array([[535.4, 0, 320.1], [0, 539.2, 247.6], [0, 0, 1]],
                 np.float32)
NAMES = ("r2", "Jp2", "Jo2", "r3", "Jp3", "Jo3", "ro", "Ji", "Jj", "rg", "Jg")

PRELUDE = r"""
#include <cmath>
#include <math.h>
using std::isfinite;
using std::isnan;
#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__ static
"""

# the kernels' CUDA built-ins on the host: a launch runs its blocks one
# after another and a block's threads at once, each a std::thread; a warp's
# shuffle posts every lane's value and reads its source's between two
# barriers of the warp (so a warp whose lanes do not all reach a shuffle
# hangs here as it would misbehave on the card)
EMULATION = r"""
#include <atomic>
#include <barrier>
#include <thread>
#include <vector>
#define __global__
#define __launch_bounds__(...)
#define __shared__ static
struct U3 { unsigned x, y, z; };
thread_local U3 threadIdx, blockIdx;
static U3 blockDim, gridDim;
static std::barrier<>* g_block;
static std::barrier<>* g_warp[32];
static float g_lane[32][32];
inline void __syncthreads() { g_block->arrive_and_wait(); }
inline void __threadfence()
{ std::atomic_thread_fence(std::memory_order_seq_cst); }
inline unsigned atomicAdd(unsigned* p, unsigned v)
{ return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline float __shfl_sync(unsigned, float v, int src)
{
    const int w = threadIdx.x >> 5;
    g_lane[w][threadIdx.x & 31] = v;
    g_warp[w]->arrive_and_wait();
    const float r = g_lane[w][src & 31];
    g_warp[w]->arrive_and_wait();
    return r;
}
inline float __shfl_xor_sync(unsigned m, float v, int mask)
{ return __shfl_sync(m, v, (int)(threadIdx.x & 31) ^ mask); }
template <class F>
static void emu_launch(long long blocks, int threads, F body)
{
    blockDim = {(unsigned)threads, 1, 1};
    gridDim = {(unsigned)blocks, 1, 1};
    for (long long b = 0; b < blocks; ++b) {
        std::barrier<> block(threads);
        g_block = &block;
        std::vector<std::barrier<>*> warps;
        for (int w = 0; w < threads / 32; ++w)
            warps.push_back(g_warp[w] = new std::barrier<>(32));
        std::vector<std::thread> ts;
        for (int i = 0; i < threads; ++i)
            ts.emplace_back([=] {
                threadIdx = {(unsigned)i, 0, 0};
                blockIdx = {(unsigned)b, 0, 0};
                body();
            });
        for (auto& t : ts) t.join();
        for (auto* w : warps) delete w;
    }
}
"""

# a float that counts its operations; every ``float`` of the chains becomes
# one (the literals stay float and convert)
COUNTING = r"""
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
"""

HARNESS = r"""
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

#ifdef OSLAM_COUNT_OPS
using DW = Dual<OSLAM_LANES>;

// the 3D edge's yaw choice as one thread makes it: the object and the
// measurement in the world once, then the four candidates in turn
static int pick_yaw(const Graph& g, int e, float r[9]) {
  Est<float> o;
  Pose<float> mw;
  frame_3d(g, e, 0, o, mw);
  float n[4], err[4][9];
  for (int k = 0; k < 4; ++k) {
    yaw_error(o, mw, g.e3_meas + 10 * e, k, err[k]);
    n[k] = err_norm(err[k]);
  }
  const int k = choice(n);
  for (int c = 0; c < 9; ++c) r[c] = err[k][c];
  return k;
}

// the 3D edge with every candidate's chain in duals, the winner kept (the
// design that took the tangents of all four)
template <int N>
static void rows_3d_every(const Graph& g, int e, int dir0, Dual<N> r[9]) {
  Est<Dual<N>> o;
  Pose<Dual<N>> mw;
  frame_3d(g, e, dir0, o, mw);
  const float* m = g.e3_meas + 10 * e;
  float best = 0.f;
  for (int k = 0; k < 4; ++k) {
    Dual<N> err[9];
    yaw_error(o, mw, m, k, err);
    float v[9];
    for (int c = 0; c < 9; ++c) v[c] = val(err[c]);
    const float n = err_norm(v);
    if (takes(k, n, best)) {
      best = n;
      for (int c = 0; c < 9; ++c) r[c] = err[c];
    }
  }
  const float w = g.e3_w[e];
  for (int c = 0; c < 9; ++c) r[c] = r[c] * w;
}
#endif

extern "C" {

#ifndef OSLAM_COUNT_OPS
// the Jacobian launch at ``lanes`` as the card runs it, its blocks
// emulated; 1 for lanes the launch refuses
int host_edge_terms(GRAPH_ARGS, float* r2, float* Jp2, float* Jo2,
                    float* r3, float* Jp3, float* Jo3, float* ro, float* Ji,
                    float* Jj, float* rg, float* Jg, int lanes) {
  long long shape[3];
  if (!edge_terms_shape(E2, E3, Eo, Ko, lanes, shape)) return 1;
  if (shape[2] == 0) return 0;
  const Graph g = GRAPH;
  const Out o = {r2, Jp2, Jo2, r3, Jp3, Jo3, ro, Ji, Jj, rg, Jg};
  with_lanes(lanes, [&](auto kernel) {
    emu_launch(shape[1], (int)shape[0], [&] { kernel(g, o); });
  });
  return 0;
}

// every 3D edge's four yaw candidates' norms (norms[4 e + k]) and the one
// the kernels take (win[e]), by the kernels' own functions
void host_yaw_choice(GRAPH_ARGS, float* norms, int* win) {
  const Graph g = GRAPH;
  for (int e = 0; e < E3; ++e) {
    float n[4], err[9];
    for (int k = 0; k < 4; ++k) norms[4 * e + k] = n[k] = candidate(g, e, k, err);
    win[e] = choice(n);
  }
}

// the chi2 launch on the ticket counter done, its blocks emulated: chi2
// and each edge's term
void host_chi2(GRAPH_ARGS, float* chi2, float* terms, unsigned* done) {
  const Graph g = GRAPH;
  const long long blocks = chi2_blocks((long long)E2 + E3 + Eo + Ko);
  std::vector<float> partial(blocks);
  host_terms = terms;
  emu_launch(blocks, kChiThreads, [&] {
    slam_chi2_kernel(g, partial.data(), done, chi2);
  });
  host_terms = nullptr;
}
#else
// per edge, in the order E2 E3 Eo K, the operations of: [0, n) one thread
// of its Jacobian with OSLAM_LANES directions (a 3D edge's four candidates
// scored in turn in float, then the winner's chain); [n, 2n) its chi2
// term; [2n, 3n) a 3D edge's winning chain in float (what the Jacobian's
// chain recomputes of the scoring); [3n, 4n) the Jacobian with every
// candidate's chain in duals (rows_3d_every; the others as [0, n))
void host_count(GRAPH_ARGS, long long* ops) {
  const Graph g = GRAPH;
  const long long n = (long long)E2 + E3 + Eo + Ko;
  long long *jac = ops, *sq = ops + n, *pf = ops + 2 * n,
            *every = ops + 3 * n;
  int t = 0;
  for (int e = 0; e < E2; ++e, ++t) {
    long long b = g_ops;
    DW rd[4];
    rows_2d(g, e, 0, rd);
    every[t] = jac[t] = g_ops - b;
    pf[t] = 0;
    b = g_ops;
    float r[4];
    rows_2d(g, e, 0, r);
    gated_square_sum(r);
    sq[t] = g_ops - b;
  }
  for (int e = 0; e < E3; ++e, ++t) {
    long long b = g_ops;
    float r[9];
    const int k = pick_yaw(g, e, r);
    DW rd[9];
    {
      Est<DW> o;
      Pose<DW> mw;
      frame_3d(g, e, 0, o, mw);
      rows_3d_from(g, e, o, mw, k, rd);
    }
    jac[t] = g_ops - b;
    b = g_ops;
    Est<float> o;
    Pose<float> mw;
    frame_3d(g, e, 0, o, mw);
    yaw_error(o, mw, g.e3_meas + 10 * e, k, r);
    pf[t] = g_ops - b;
    b = g_ops;
    rows_3d_every(g, e, 0, rd);
    every[t] = g_ops - b;
    b = g_ops;
    pick_yaw(g, e, r);
    for (int c = 0; c < 9; ++c) r[c] = r[c] * g.e3_w[e];
    gated_square_sum(r);
    sq[t] = g_ops - b;
  }
  for (int e = 0; e < Eo; ++e, ++t) {
    long long b = g_ops;
    DW rd[6];
    rows_odo(g, e, 0, rd);
    every[t] = jac[t] = g_ops - b;
    pf[t] = 0;
    b = g_ops;
    float r[6];
    rows_odo(g, e, 0, r);
    gated_square_sum(r);
    sq[t] = g_ops - b;
  }
  for (int k = 0; k < Ko; ++k, ++t) {
    long long b = g_ops;
    row_grav<DW>(g, k, 0);
    every[t] = jac[t] = g_ops - b;
    pf[t] = 0;
    b = g_ops;
    const float r = row_grav<float>(g, k, 0);
    r* r;
    sq[t] = g_ops - b;
  }
}
#endif

}  // extern "C"
"""


def build(count=False, workdir=None, lanes=None):
    """Compile the chains with g++ into ``workdir`` (a temporary directory
    by default); returns the loaded library.  By default the kernels with
    them, their launches emulated (``host_edge_terms``, ``host_chi2``);
    ``count``: the counting build (``host_count``), ``lanes`` its tangent
    directions a thread (5 by default)."""
    workdir = workdir or tempfile.mkdtemp(prefix="slam_edges_cpu_")
    fake = os.path.join(workdir, "fake")
    os.makedirs(fake, exist_ok=True)
    open(os.path.join(fake, "cuda_runtime.h"), "w").close()
    tag = f"count{lanes or ''}" if count else "kernels"
    src = os.path.join(workdir, f"harness_{tag}.cpp")
    with open(src, "w") as f:
        f.write(PRELUDE + (COUNTING if count else EMULATION) + HARNESS)
    lib = os.path.join(workdir, f"libslam_{tag}.so")
    cmd = ["g++", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-w",
           "-DOSLAM_HOST_CHAINS", "-I", fake, "-I", CSRC]
    if count:
        cmd += ["-std=c++17", "-DOSLAM_COUNT_OPS",
                f"-DOSLAM_LANES={int(lanes or 5)}"]
    else:
        cmd += ["-std=c++20", "-pthread", "-DOSLAM_HOST_KERNELS"]
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


def chains(lib, g, K, normal, lanes=slam_kernels.LANES, ticket=None):
    """K11's outputs (r2 ... Jg), each edge's chi2 term [E2+E3+Eo+K] and
    the chi2 [] by the host build of its kernels (``build()``): the
    Jacobian launch at ``lanes`` tangent directions a thread (the entry
    point's by default), then the chi2 launch on ``ticket``, an int32
    tensor [1] at zero (a new one by default) that it leaves at zero."""
    keep, (E2, E3, Eo, Ko, _), args = _graph_args(g, K, normal)
    shapes = ((E2, 4), (E2, 4, 6), (E2, 4, 9), (E3, 9), (E3, 9, 6),
              (E3, 9, 9), (Eo, 6), (Eo, 6, 6), (Eo, 6, 6), (Ko, 1),
              (Ko, 1, 9), (E2 + E3 + Eo + Ko,), ())
    outs = [torch.full(s, float("nan")) for s in shapes]
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in outs]
    if lib.host_edge_terms(*args, *ptrs[:11], ctypes.c_int(lanes)):
        raise ValueError(f"the Jacobian launch takes no {lanes} lanes")
    if ticket is None:
        ticket = torch.zeros(1, dtype=torch.int32)
    lib.host_chi2(*args, ptrs[12], ptrs[11],
                  ctypes.c_void_p(ticket.data_ptr()))
    return outs[:11], outs[11], outs[12]


def yaw_choice(lib, g, K, normal):
    """(norms [E3, 4], winner [E3]) of every 3D edge's yaw candidates by
    the kernels' own scoring (``build()``)."""
    keep, (E2, E3, Eo, Ko, _), args = _graph_args(g, K, normal)
    norms = torch.empty((E3, 4))
    win = torch.empty(E3, dtype=torch.int32)
    lib.host_yaw_choice(*args, ctypes.c_void_p(norms.data_ptr()),
                        ctypes.c_void_p(win.data_ptr()))
    return norms, win


# tangent directions of a 2D, 3D and odometry edge and a gravity prior
DIRECTIONS = dict(e2=15, e3=15, odo=12, grav=9)


def count_ops(g, K, normal, workdir=None):
    """The f32 operations K11's two instantiations need on graph ``g``:
    {"slam_edge_terms": {e2, e3, odo, grav}, "slam_chi2": {...}, "live":
    {...}, "every_candidate": {...}}, totals over the live edges of each
    kind (non-zero weight; the others' r and J are zeros) and their
    counts.  An edge's Jacobian counts its primal chain once and its
    tangent work once a direction: a thread of one direction
    (``lanes=1``) plus, for each further direction, a kW-direction
    thread's excess over it divided by kW - 1 (the kernel's threads each
    recompute the primal chain; that is not counted); a 3D edge's primal
    is its four yaw candidates', its tangents the winner's alone (the
    winner's float chain, which the thread's dual chain recomputes, is
    taken off).  ``every_candidate``: the Jacobian's count with every
    candidate's tangents (the count of a design that carries all four in
    duals).  The chi2 counts one float chain and its square sum an edge.
    Builds the two counting libraries in ``workdir``."""
    keep, (E2, E3, Eo, Ko, _), args = _graph_args(g, K, normal)
    n = E2 + E3 + Eo + Ko
    per = {}
    for lanes in (1, 5):
        ops = (ctypes.c_longlong * (4 * n))()
        build(count=True, workdir=workdir, lanes=lanes).host_count(*args,
                                                                   ops)
        per[lanes] = np.array(ops[:], np.float64).reshape(4, n)
    kinds = ("e2", "e3", "odo", "grav")
    ends = np.cumsum([0, E2, E3, Eo, Ko])
    weights = (g.e2_w, g.e3_w, g.odo_w, g.grav_w)
    out = {"slam_edge_terms": {}, "slam_chi2": {}, "live": {},
           "every_candidate": {}}
    for i, k in enumerate(kinds):
        live = (weights[i] != 0).cpu().numpy()
        x1, x5 = (per[L][:, ends[i]:ends[i + 1]][:, live] for L in (1, 5))
        more = DIRECTIONS[k] - 1
        jac = x1[0] - x1[2] + more * (x5[0] - x1[0]) / 4
        every = x1[3] + more * (x5[3] - x1[3]) / 4
        out["slam_edge_terms"][k] = int(round(jac.sum()))
        out["every_candidate"][k] = int(round(every.sum()))
        out["slam_chi2"][k] = int(x5[1].sum())
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
    arrays, normal = _orbit_arrays(F, seed, turn=1)
    return slam_ba.graph_from_numpy(arrays, device="cpu"), torch.tensor(
        K_MAT), normal


# the 3D measurements of yaw_graph's origin frame: an ellipsoid at the
# origin whose x/y scales the measurement swaps, and one FAR metres along x
FAR = 2e38
SWAPPED = [0, 0, 0, 0, 0, 0, 1, 0.5, 3.0, 0.25]


def yaw_graph(F=12, seed=1):
    """The 3D edge's yaw choice in each of its branches: orbit_graph's
    scene from ``seed`` with its turned 3D measurement half a turn of yaw
    away (the 180 deg candidate, the last, wins by a strictly smaller
    norm), and one more frame, at the world's origin, that measures two
    more ellipsoids in 3D.  The first sits at the origin, unrotated, with
    scales (3, 0.5, 0.25), and its measurement swaps the x/y scales: the
    -90 and +90 deg candidates turn it by a quarter either way to the same
    norm (each operation of the one is the other's with a sign flipped),
    below the other two, and the first of them is kept.  The second sits
    FAR metres along x, measured where it is: rotating that translation by
    the 180 deg candidate overflows float (2 FAR), the others' do not, so
    that candidate's norm is NaN after three finite ones and is taken (the
    edge is then zeroed).  Returns (SlamGraph on the CPU, K, normal)."""
    arrays, normal = _orbit_arrays(F, seed, turn=2)
    a = arrays
    a["poses_cw"] = np.concatenate([a["poses_cw"],
                                    [[0, 0, 0, 0, 0, 0, 1]]]).astype(
                                        np.float32)
    a["frame_mask"] = np.ones(F + 1, bool)
    near = [0, 0, 0, 0, 0, 0, 1, 3.0, 0.5, 0.25]
    far = [FAR, 0, 0, 0, 0, 0, 1, 3.0, 0.5, 0.25]
    a["objects"] = np.concatenate([a["objects"], [near, far]]).astype(
        np.float32)
    a["obj_mask"] = np.ones(4, bool)
    a["e3_frame"] = np.concatenate([a["e3_frame"], [F, F]])
    a["e3_obj"] = np.concatenate([a["e3_obj"], [2, 3]])
    far_meas = [FAR] + SWAPPED[1:7] + [3.0, 0.5, 0.25]
    a["e3_meas"] = np.concatenate([a["e3_meas"], [SWAPPED, far_meas]]).astype(
        np.float32)
    a["e3_w"] = np.concatenate([a["e3_w"], [3.0, 3.0]]).astype(np.float32)
    a["grav_w"] = np.full(4, 1.0, np.float32)
    return slam_ba.graph_from_numpy(a, device="cpu"), torch.tensor(
        K_MAT), normal


def _orbit_arrays(F, seed, turn):
    """orbit_graph's numpy arrays, its 3D measurement 7 turned ``turn``
    quarter turns of yaw, and the ground normal."""
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
    e3_m[7] = ell.rotate_yaw(e3_m[7], turn)
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
    return arrays, torch.tensor([0.05, -0.02, 1.0])


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
    got, _, chi2 = chains(lib, g, K, normal)
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
    c_k = float(chi2)
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
