"""dense_fuse (K12) built for the CPU, to hold both of its paths against the
plain version without a card.

    python3 examples/torch_dense_fuse_on_cpu.py [--blocks 3] [--threads 128]
        [CASE ...]

The section of ``object_oriented_slam_tpu_torch/csrc/dense_fuse.cu``
between its two "CPU build" marks (the kernel, its device helpers and the
host-side setup of its parameters) is compiled with g++
(``-ffp-contract=off``: every multiply and add rounds on its own, as with
nvcc's ``-fmad=false``; ``-fwrapv``: int32 wraps as on the card) into a
shared library.  A launch runs its ``--blocks`` blocks of ``--threads``
threads all at once as std::threads (the kernel is cooperative): a
std::barrier a block stands for ``__syncthreads`` (and its ``_count`` /
``_or`` forms), one a warp for ``__syncwarp`` and the shuffles, votes,
matches and reductions, one over every thread for the grid's barrier;
each block's dynamic shared memory is a buffer of its own, filled with
garbage first; device memory is host memory.  ``CpuFuseWork`` is
``ops/dense_fuse.FuseWork`` on CPU tensors with this library behind its
launch, so a case runs the wrapper's buffers and ping-pong as the card
does.  Each case's maps are held bit for bit against ``dense_fuse_plain``,
a repeat bit-equal, and each fuse's path (the tally) against the one its
map's keys call for.  CASE names cases (all by default): ``empty``,
``filled`` (three frames, each into the last one's map), ``shuffled`` (a
filled map's rows in random order, then a frame into the result),
``shrink`` (a small map loaded over a buffer that held a larger one),
``seam`` (the map's one descent where two blocks' rows meet),
``wide-still`` / ``wide-moved`` / ``wide-clipped`` (a map over 1,500
cells an axis: the frame inside it, moving the minimum cell, or with
clipped cells), ``ties`` (map rows that
share a key), ``refloor`` (a centroid that floors into the next cell),
``overflow`` / ``overflow-general`` (more segments than ``capacity``),
``frame-limit`` / ``frame-past`` (19,520 strided pixels sorted bucket by
bucket; 21,000 whose keys take the general sort), ``bucket-mid`` /
``bucket-limit`` / ``bucket-large`` (a patch that fills one bucket of the
frame sort with 65 pixels, one past a warp's sort, 1,024, the most the
block ranks, or 1,025, which sends the frame's keys to the general
sort).  Exits 1 if any case
differs.  Needs g++ with C++20.
"""
import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
import time
from fractions import Fraction

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from object_oriented_slam_tpu_torch.core.camera import Camera  # noqa: E402
from object_oriented_slam_tpu_torch.ops import dense_fuse as df  # noqa: E402
from object_oriented_slam_tpu_torch.ops import voxel as vx  # noqa: E402

PRELUDE = r'''
#include <math.h>
#include <stdint.h>
#include <stddef.h>
#include <string.h>
#include <algorithm>
#include <barrier>
#include <thread>
#include <vector>
using std::min;
using std::max;
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
struct int4 { int x, y, z, w; };
struct U3 { unsigned x, y, z; };
thread_local U3 threadIdx, blockIdx;
thread_local int t_gen;
static U3 blockDim, gridDim;
#define EMU_BLOCKS 16
static std::vector<char> g_mem[EMU_BLOCKS];
static std::barrier<>* g_block[EMU_BLOCKS];
static std::barrier<>* g_warp[EMU_BLOCKS][32];
static std::barrier<>* g_grid;
static long long g_x[EMU_BLOCKS][32][32];
static int g_red[EMU_BLOCKS][2];
inline void __syncthreads() { g_block[blockIdx.x]->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu)
{ g_warp[blockIdx.x][threadIdx.x >> 5]->arrive_and_wait(); }
inline int __syncthreads_count(int p)
{
    int* red = g_red[blockIdx.x];
    const int slot = t_gen & 1;
    ++t_gen;
    if (p) __atomic_fetch_add(&red[slot], 1, __ATOMIC_SEQ_CST);
    __syncthreads();
    const int v = __atomic_load_n(&red[slot], __ATOMIC_SEQ_CST);
    __syncthreads();
    if (threadIdx.x == 0) __atomic_store_n(&red[slot], 0, __ATOMIC_SEQ_CST);
    return v;
}
inline int __syncthreads_or(int p) { return __syncthreads_count(p) > 0; }
// the warp's 32 values of v, lane order
inline void warp_values(long long v, long long* out)
{
    long long* x = g_x[blockIdx.x][threadIdx.x >> 5];
    x[threadIdx.x & 31] = v;
    __syncwarp();
    memcpy(out, x, 32 * sizeof(long long));
    __syncwarp();
}
inline int __shfl_up_sync(unsigned, int v, int off)
{
    long long all[32];
    warp_values(v, all);
    const int l = threadIdx.x & 31;
    return (int)all[l >= off ? l - off : l];
}
inline int __shfl_sync(unsigned, int v, int src)
{
    long long all[32];
    warp_values(v, all);
    return (int)all[src & 31];
}
inline int __shfl_down_sync(unsigned, int v, int off)
{
    long long all[32];
    warp_values(v, all);
    const int l = threadIdx.x & 31;
    return (int)all[l + off < 32 ? l + off : l];
}
inline unsigned __ballot_sync(unsigned, int pred)
{
    long long all[32];
    warp_values(pred != 0, all);
    unsigned m = 0;
    for (int i = 0; i < 32; ++i) m |= (all[i] ? 1u : 0u) << i;
    return m;
}
inline int __any_sync(unsigned m, int pred)
{ return __ballot_sync(m, pred) != 0; }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline unsigned __match_any_sync(unsigned, int v)
{
    long long all[32];
    warp_values(v, all);
    unsigned m = 0;
    for (int i = 0; i < 32; ++i) m |= (all[i] == v ? 1u : 0u) << i;
    return m;
}
inline int __reduce_add_sync(unsigned, int v)
{
    long long all[32];
    warp_values(v, all);
    int s = 0;
    for (int i = 0; i < 32; ++i) s += (int)all[i];
    return s;
}
inline int __reduce_min_sync(unsigned, int v)
{
    long long all[32];
    warp_values(v, all);
    int s = (int)all[0];
    for (int i = 1; i < 32; ++i) s = min(s, (int)all[i]);
    return s;
}
inline int __reduce_max_sync(unsigned, int v)
{
    long long all[32];
    warp_values(v, all);
    int s = (int)all[0];
    for (int i = 1; i < 32; ++i) s = max(s, (int)all[i]);
    return s;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int atomicAdd(int* p, int v)
{ return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
template <class V> inline V __ldcg(const V* p) { return *p; }
namespace cg {
struct grid_group { void sync() const { g_grid->arrive_and_wait(); } };
inline grid_group this_grid() { return {}; }
}
'''

POSTLUDE = r'''
extern "C" int emu_stage_max() { return DF_STAGE_MAX; }
extern "C" long long emu_scratch_ints(int cap, int frame)
{ return df_scratch_ints(cap, frame); }

// oslam_dense_fuse's arguments, then the launch's blocks and threads in
// place of the stream
extern "C" int emu_dense_fuse(
    int cap, int height, int width, int stride, float fx, float fy,
    float cx, float cy, float scale, float depth_range, float leaf,
    const void* depth, const void* rgb, const void* pose, void* pts,
    void* col, void* mask, void* out_pts, void* out_col, void* out_mask,
    void* keys, void* scratch, long long scratch_ints, void* tally,
    int G, int T)
{
    FuseParams p;
    if (df_setup(&p, cap, height, width, stride, fx, fy, cx, cy, scale,
                 depth_range, leaf, depth, rgb, pose, pts, col, mask,
                 out_pts, out_col, out_mask, keys, scratch, scratch_ints,
                 tally))
        return 1;
    if (G < 1 || G > EMU_BLOCKS || G > T || T < 32 || T > 1024 || T % 32)
        return 2;
    const int smem = DF_SMEM_BYTES;
    blockDim = {(unsigned)T, 1, 1};
    gridDim = {(unsigned)G, 1, 1};
    std::barrier<> grid(G * T);
    g_grid = &grid;
    for (int b = 0; b < G; ++b) {
        g_mem[b].assign(smem + 64, (char)0xa5);
        g_block[b] = new std::barrier<>(T);
        for (int w = 0; w < T / 32; ++w) g_warp[b][w] = new std::barrier<>(32);
        g_red[b][0] = g_red[b][1] = 0;
    }
    std::vector<std::thread> th;
    for (int b = 0; b < G; ++b)
        for (int t = 0; t < T; ++t)
            th.emplace_back([=]() {
                threadIdx = {(unsigned)t, 0, 0};
                blockIdx = {(unsigned)b, 0, 0};
                t_gen = 0;
                dense_fuse_kernel(p);
            });
    for (auto& x : th) x.join();
    for (int b = 0; b < G; ++b) {
        delete g_block[b];
        for (int w = 0; w < T / 32; ++w) delete g_warp[b][w];
    }
    return 0;
}
'''


def build(source, out):
    """The "CPU build" section of ``source`` as a CPU shared library."""
    text = open(source).read()
    a = text.index("// ---- CPU build: from here ----")
    body = text[a:text.index("// ---- CPU build: to here ----", a)]
    body = body.replace("extern __shared__ int4 df_smem[];",
                        "int4* df_smem = (int4*)g_mem[blockIdx.x].data();")
    cpp = out + ".cpp"
    with open(cpp, "w") as f:
        f.write(PRELUDE + body + POSTLUDE)
    proc = subprocess.run(["g++", "-std=c++20", "-O2", "-ffp-contract=off",
                           "-fwrapv", "-shared", "-fPIC", "-pthread", "-o",
                           out, cpp], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"g++ failed on {source}:\n{proc.stderr}")
    lib = ctypes.CDLL(out)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.emu_dense_fuse.argtypes = ([i] * 4 + [f] * 7 + [p] * 11
                                   + [ctypes.c_longlong, p, i, i])
    lib.emu_dense_fuse.restype = i
    lib.emu_stage_max.restype = i
    lib.emu_scratch_ints.argtypes = [i, i]
    lib.emu_scratch_ints.restype = ctypes.c_longlong
    return lib


class CpuFuseWork(df.FuseWork):
    """``FuseWork`` on CPU tensors, its launch the CPU build's."""

    def __init__(self, lib, capacity, height, width, stride, blocks=3,
                 threads=128):
        super().__init__(capacity, height, width, stride, "cpu")
        self.lib, self.blocks, self.threads = lib, blocks, threads

    def _launch(self, args):
        rc = self.lib.emu_dense_fuse(*args, self.blocks, self.threads)
        if rc:
            raise RuntimeError(f"emu_dense_fuse returned {rc}")


# ---------------------------------------------------------------------------
# The cases
# ---------------------------------------------------------------------------
SMALL = Camera(fx=50.0, fy=50.0, cx=32.0, cy=24.0, scale=5000.0)


def wall(seed, height=48, width=64, holes=0.05, rgb=True):
    """A rippled, tilted wall 1.2 m away with holes and random colours:
    (depth [H, W] int32, rgb [H, W, 3] float32 or None)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    z = 1.2 + 0.003 * xx + 0.08 * np.sin(yy / 7.0 + seed)
    depth = (z * 5000.0).astype(np.int32)
    depth[rng.random(depth.shape) < holes] = 0
    colours = (rng.integers(0, 256, (height, width, 3)).astype(np.float32)
               if rgb else None)
    return depth, colours


def pose(t, yaw=0.0):
    """Twc [7] float32: translation t, a rotation about y."""
    return np.array([*t, 0.0, np.sin(yaw / 2), 0.0, np.cos(yaw / 2)],
                    np.float32)


def empty_map(cap):
    return (np.zeros((cap, 3), np.float32), np.zeros((cap, 3), np.float32),
            np.zeros(cap, bool))


def sorted_map(pts, cap, leaf, rng):
    """Rows at ``pts`` in key order (the keys of their own minimum cell),
    random colours, masked rows after them: an ascending map."""
    m = len(pts)
    key, _ = vx.voxel_keys(torch.from_numpy(pts)[None],
                           torch.ones(1, m, dtype=torch.bool), leaf)
    order = torch.sort(key[0], stable=True)[1].numpy()
    out = empty_map(cap)
    out[0][:m] = pts[order]
    out[1][:m] = rng.integers(0, 256, (m, 3)).astype(np.float32)
    out[2][:m] = True
    return out


def refloor_x(leaf):
    """(cell, x): the first cell with an f32 x below its upper boundary
    (exactly) whose f32 quotient x / leaf rounds up to cell + 1, so that
    floor puts it in the next cell (4 and 0.049999997 at 1 cm): a centroid
    of that cell's points that re-floors."""
    lf = np.float32(leaf)
    for cell in range(1 << 12):
        bound = Fraction(float(lf)) * (cell + 1)
        x = np.float32(float(bound))
        while Fraction(float(x)) >= bound:
            x = np.nextafter(x, np.float32(-np.inf), dtype=np.float32)
        if np.floor(x / lf) == cell + 1:
            return cell, x
    raise ValueError(f"no cell re-floors at leaf {leaf}")


def cases():
    """name -> (capacity, leaf, camera, stride, [(map or None, depth, rgb,
    pose)]): a map of None fuses into the previous step's output without a
    copy (the builder's path), else the map is loaded (copied)."""
    rng = np.random.default_rng(19)
    out = {}
    d1, c1 = wall(1)
    d2, c2 = wall(2)
    d3, c3 = wall(3, rgb=False)
    out["empty"] = (4096, 0.01, SMALL, 1,
                    [(empty_map(4096), d1, c1, pose([0.1, 0.0, 0.02]))])
    out["filled"] = (4096, 0.01, SMALL, 1, [
        (empty_map(4096), d1, c1, pose([0.1, 0.0, 0.02])),
        (None, d2, c2, pose([0.12, 0.01, 0.0], 0.1)),
        (None, d3, None, pose([0.05, -0.02, 0.03], -0.1))])
    # a filled map (two frames of the plain version) with its rows shuffled
    first = plain_chain(out["filled"], steps=2)[-1]
    perm = rng.permutation(4096)
    shuffled = tuple(a[perm] for a in first)
    out["shuffled"] = (4096, 0.01, SMALL, 1, [
        (shuffled, d3, c3, pose([0.08, 0.0, 0.0])),
        (None, d1, c1, pose([0.0, 0.05, 0.0], 0.2))])
    # a small map loaded over a buffer that held a larger one: the rows
    # the older map left past the new one are cleared
    small = sorted_map((rng.uniform(0.0, 1.0, (100, 3)) * [0.2, 0.2, 0.1]
                        + [0.0, 0.0, 1.2]).astype(np.float32), 4096, 0.01,
                       rng)
    ds, cs = wall(7, holes=0.97)
    out["shrink"] = (4096, 0.01, SMALL, 1, [
        (empty_map(4096), d1, c1, pose([0.1, 0.0, 0.02])),
        (None, d2, c2, pose([0.3, 0.0, 0.0])),
        (small, ds, cs, pose([0.0, 0.0, 0.0]))])
    # 1,500 cells along x (more than 1,024): the rows past 1,023 clipped
    wide = sorted_map((rng.uniform(0.0, 1.0, (3000, 3)) * [15.0, 0.5, 0.5]
                       + [0.0, -0.25, 1.0]).astype(np.float32), 4096, 0.01,
                      rng)
    # the map's only descent where two blocks' rows meet (rows 1023 and
    # 1024: a seam for 128 and for 1024 threads a block)
    seam = tuple(a.copy() for a in wide)
    for a in seam:
        a[[1023, 1024]] = a[[1024, 1023]]
    out["seam"] = (4096, 0.01, SMALL, 1,
                   [(seam, d1, c1, pose([1.0, 0.0, 0.0]))])
    out["wide-still"] = (4096, 0.01, SMALL, 1,
                         [(wide, d1, c1, pose([1.0, 0.0, 0.0]))])
    out["wide-moved"] = (4096, 0.01, SMALL, 1,
                         [(wide, d1, c1, pose([-2.0, 0.0, 0.0]))])
    # the frame past 1,023 cells from the minimum: its cells clip, so its
    # keys go through the radix passes, not the buckets
    out["wide-clipped"] = (4096, 0.01, SMALL, 1,
                           [(wide, d1, c1, pose([12.0, 0.0, 0.0]))])
    # two centroids a cell, the frame over the same cells
    base = (rng.uniform(0.0, 1.0, (700, 3)) * [0.6, 0.4, 0.2]
            + [-0.3, -0.2, 1.15]).astype(np.float32)
    twins = np.concatenate([base, base + np.float32(1e-4)])
    out["ties"] = (4096, 0.01, SMALL, 1,
                   [(sorted_map(twins, 4096, 0.01, rng), d1, c1,
                     pose([0.0, 0.0, 0.0]))])
    # row i floors into the next cell on x, above row i + 1's key
    cell, x = refloor_x(0.01)
    rf = empty_map(64)
    rf[0][:4] = [[x, 0.055, 0.005], [(cell + 1.5) * 0.01, 0.005, 0.005],
                 [(cell + 2.5) * 0.01, 0.005, 0.005],
                 [(cell + 3.5) * 0.01, 0.005, 0.005]]
    rf[1][:4] = rng.integers(0, 256, (4, 3))
    rf[2][:4] = True
    small_d, small_c = wall(4, 12, 16)
    out["refloor"] = (64, 0.01, SMALL, 1,
                      [(rf, small_d, small_c, pose([0.3, 0.0, 0.0]))])
    # more segments than capacity: into an empty map, and into a full
    # shuffled one
    out["overflow"] = (512, 0.01, SMALL, 1,
                       [(empty_map(512), d1, c1, pose([0.0, 0.0, 0.0]))])
    full = sorted_map((rng.uniform(0.0, 1.0, (512, 3)) * [0.6, 0.4, 0.3]
                       + [-0.3, -0.2, 1.0]).astype(np.float32), 512, 0.01,
                      rng)
    perm = rng.permutation(512)
    out["overflow-general"] = (512, 0.01, SMALL, 1, [
        (tuple(a[perm] for a in full), d2, c2, pose([0.0, 0.0, 0.0]))])
    # a frame of 19,520 strided pixels (64 x 305, more than 640 x 480 at
    # stride 4) whose buckets all fit a warp's sort, and a flat strip of
    # 21,000 (3 x 7000, ~1,200 pixels a cell), so that its keys take the
    # general sort; a launch of one block cannot stage that sort's first
    # pass in shared memory (DF_STAGE_MAX); over a filled map
    cam_l = Camera(fx=200.0, fy=200.0, cx=152.0, cy=32.0, scale=5000.0)
    cam_p = Camera(fx=48000.0, fy=48000.0, cx=3500.0, cy=1.0, scale=5000.0)
    dl, cl_ = wall(5, 64, 305)
    dp, _ = wall(6, 3, 7000)
    dp[dp > 0] = 6000
    m_l = sorted_map((rng.uniform(0.0, 1.0, (800, 3)) * [0.8, 0.4, 0.3]
                      + [-0.4, -0.2, 1.0]).astype(np.float32), 1024, 0.01,
                     rng)
    out["frame-limit"] = (1024, 0.01, cam_l, 1,
                          [(m_l, dl, cl_, pose([0.0, 0.0, 0.0]))])
    out["frame-past"] = (1024, 0.01, cam_p, 1,
                         [(m_l, dp, None, pose([0.0, 0.005, 0.0]))])
    # the frame sort's limits: a flat patch 5 cm from the camera, faced
    # along x and shifted half a cell, all in one cell, and far pixels 5 m
    # away in cells of their own; the patch holds 65 pixels (one past a
    # warp's sort: the block ranks it), 1,024 (the most the block ranks) or
    # 1,025 (the frame's keys take the general sort)
    shifted = pose([0.0, 0.005, 0.005], np.pi / 2)
    near_9 = Camera(fx=5000.0, fy=5000.0, cx=4.0, cy=4.0, scale=5000.0)
    near_33 = Camera(fx=5000.0, fy=5000.0, cx=16.0, cy=16.0, scale=5000.0)
    out["bucket-mid"] = (1024, 0.01, near_9, 1,
                         [(m_l, *near_patch(9, 8, 9, far=7), shifted)])
    out["bucket-limit"] = (1024, 0.01, near_33, 1,
                           [(m_l, *near_patch(10, 32, 33, far=32), shifted)])
    out["bucket-large"] = (1024, 0.01, near_33, 1,
                           [(m_l, *near_patch(8, 32, 33, far=31), shifted)])
    return out


def near_patch(seed, height, width, far=8):
    """A flat patch 5 cm away with ``far`` pixels of its first row 5 m
    away (depth, rgb)."""
    rng = np.random.default_rng(seed)
    depth = np.full((height, width), 250, np.int32)
    depth[0, :far] = 25000
    return depth, rng.integers(0, 256, (height, width, 3)).astype(np.float32)


def frame_tensors(depth, rgb, pose_wc, device="cpu"):
    return (torch.as_tensor(depth, device=device),
            None if rgb is None else torch.as_tensor(rgb, device=device),
            torch.as_tensor(pose_wc, device=device))


def plain_chain(case, steps=None):
    """The plain version's maps along a case's steps (CPU)."""
    cap, leaf, cam, stride, seq = case
    maps, state = [], None
    for m, depth, rgb, pose_wc in seq[:steps]:
        if m is not None:
            state = tuple(torch.as_tensor(a) for a in m)
        d, c, p = frame_tensors(depth, rgb, pose_wc)
        state = df.dense_fuse_plain(*state, d, c, p, cam, stride, leaf, cap,
                                    6.0)
        maps.append(tuple(t.numpy() for t in state))
    return maps


def expected_paths(case):
    """Each step's path (0 fast, 1 general): 1 where the map's keys,
    under the minimum cell of map and frame, descend somewhere."""
    cap, leaf, cam, stride, seq = case
    paths, state = [], None
    for m, depth, rgb, pose_wc in seq:
        if m is not None:
            state = tuple(torch.as_tensor(a) for a in m)
        d, c, p = frame_tensors(depth, rgb, pose_wc)
        w, _, fm = df.frame_points_plain(d, c, p, cam, stride, 6.0)
        key, _ = vx.voxel_keys(torch.cat([state[0], w])[None],
                               torch.cat([state[2], fm])[None], leaf)
        k = key[0, :cap]
        paths.append(int(bool((k[:-1] > k[1:]).any())))
        state = df.dense_fuse_plain(*state, d, c, p, cam, stride, leaf, cap,
                                    6.0)
    return paths


def run_case(case, make_work):
    """A case through ``make_work(capacity, H, W, stride)``'s FuseWork (the
    CPU build's, or the card's): (its maps as numpy arrays, the path each
    fuse took by the tally)."""
    cap, leaf, cam, stride, seq = case
    H, W = seq[0][1].shape
    assert all(step[1].shape == (H, W) for step in seq)
    work = make_work(cap, H, W, stride)
    dev = work.device
    maps, paths = [], []
    for m, depth, rgb, pose_wc in seq:
        if m is not None:
            work.load(*(torch.as_tensor(a, device=dev) for a in m))
        before = work.tally.clone()
        state = work.fuse(*frame_tensors(depth, rgb, pose_wc, dev), cam, leaf,
                          6.0)
        maps.append(tuple(t.cpu().clone().numpy() for t in state))
        paths.append(int(torch.argmax(work.tally - before)))
    return maps, paths


def on_cpu(lib, blocks=3, threads=128):
    """make_work for run_case: the CPU build's FuseWork."""
    return lambda cap, H, W, stride: CpuFuseWork(lib, cap, H, W, stride,
                                                 blocks, threads)


def check(lib, name, case, blocks=3, threads=128):
    """(ok, a line): every map bit-equal to the plain version's, a repeat
    bit-equal, the paths the expected ones."""
    t0 = time.perf_counter()
    want = plain_chain(case)
    got, paths = run_case(case, on_cpu(lib, blocks, threads))
    again, _ = run_case(case, on_cpu(lib, blocks, threads))
    same = all(np.array_equal(a, b) for g, w in zip(got, want)
               for a, b in zip(g, w))
    repeat = all(np.array_equal(a, b) for g, r in zip(got, again)
                 for a, b in zip(g, r))
    expect = expected_paths(case)
    live = [int(m[2].sum()) for m in want]
    ok = same and repeat and paths == expect
    return ok, (f"{name}: equal to the plain version {same}, repeat "
                f"bit-equal {repeat}; paths {paths} (expected {expect}; 0 "
                f"fast, 1 general); live cells {live} of {case[0]}; "
                f"{time.perf_counter() - t0:.1f} s")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, default=3)
    ap.add_argument("--threads", type=int, default=128)
    ap.add_argument("case", nargs="*")
    ns = ap.parse_args()
    torch.set_num_threads(1)
    source = os.path.join(ROOT, "object_oriented_slam_tpu_torch", "csrc",
                          "dense_fuse.cu")
    bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(source, os.path.join(tmp, "k12.so"))
        for name, case in cases().items():
            if ns.case and name not in ns.case:
                continue
            ok, line = check(lib, name, case, ns.blocks, ns.threads)
            bad += not ok
            print(line, flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
