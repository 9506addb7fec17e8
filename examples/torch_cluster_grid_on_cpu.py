"""cluster_grid (K13) built for the CPU, to hold its logic against the plain
version without a card.

    python3 examples/torch_cluster_grid_on_cpu.py [--threads 64] [CASE ...]

The K13 section of ``object_oriented_slam_tpu_torch/csrc/frontend.cu`` (the
kernel, its device helpers and the steps it shares with
cluster_components: the compaction, the seeding, the output and the
selection epilogue) is compiled with g++ (``-ffp-contract=off``: every
multiply and add rounds on its own, as with nvcc's ``-fmad=false``) into a
shared library.  Each detection's block runs as ``--threads`` std::threads,
one detection after another, with ``--blocks`` blocks a detection (a
cluster; 1 and 4 by default): a std::barrier a block stands for
``__syncthreads`` (and its ``_or`` / ``_and`` forms), one per warp for the
shuffles and ballots, one for the cluster's barrier (and its split arrive /
wait), each block's dynamic shared memory is a buffer of its own that the
others reach through ``map_shared_rank``, ``__shared__`` variables (the
selection's, which one block uses) become statics, device memory is host
memory.  Each case's labels,
converged, rounds and the selection's sel and ok are held against
``ops/cluster.cluster_grid_select_plain``, a second call bit-equal.  CASE
names cases (all by default): ``path`` (a depth frame's voxel clouds, as
tests/test_torch_frontend_kernels.py makes them), ``path-2`` (a bound of 2
rounds), ``path-device`` (the shared memory cut to the least K13 takes:
the points read from device memory, the lists kept there),
``path-window`` (room for the staged points or the lists, not both: the
lists take it),
``shuffled`` (the lanes in random order: the
key table is sorted), ``ties`` (points that share a cell), ``sizes``
(detections of 1, 31, 32, 33 survivors and an all-masked one),
``dense`` (a voxel block filling 16384 lanes, in cell order and shuffled).
Exits 1 if any case differs.  Needs g++ with C++20.
"""
import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from object_oriented_slam_tpu_torch.ops import cluster as cl  # noqa: E402
from object_oriented_slam_tpu_torch.ops import voxel as vx  # noqa: E402

PRELUDE = r'''
#include <math.h>
#include <stdint.h>
#include <stddef.h>
#include <string.h>
#include <algorithm>
#include <atomic>
#include <barrier>
#include <optional>
#include <thread>
#include <vector>
using std::min;
using std::max;
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __shared__ static
struct int4 { int x, y, z, w; };
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d)
{ return {a, b, c, d}; }
struct U3 { unsigned x, y, z; };
thread_local U3 threadIdx, blockIdx;
thread_local int t_rank;
thread_local int t_gen;
thread_local std::optional<std::barrier<>::arrival_token> t_token;
struct D3 { unsigned x, y, z; };
static D3 blockDim;
static int g_S;
static std::vector<char> g_mem[8];
static std::barrier<>* g_block[8];
static std::barrier<>* g_warp[8][16];
static std::barrier<>* g_cluster;
static unsigned long long g_x[8][16][32];
static int g_red[8][2];
inline void __syncthreads() { g_block[t_rank]->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu)
{ g_warp[t_rank][threadIdx.x >> 5]->arrive_and_wait(); }
inline int __syncthreads_count(int p)
{
    int* red = g_red[t_rank];
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
inline int __syncthreads_and(int p)
{ return __syncthreads_count(p) == (int)blockDim.x; }
template <class V>
inline V shfl_from(V v, int src)
{
    unsigned long long* x = g_x[t_rank][threadIdx.x >> 5];
    unsigned long long raw = 0;
    memcpy(&raw, &v, sizeof(V));
    x[threadIdx.x & 31] = raw;
    __syncwarp();
    raw = x[src & 31];
    __syncwarp();
    V r;
    memcpy(&r, &raw, sizeof(V));
    return r;
}
template <class V>
inline V __shfl_xor_sync(unsigned, V v, int off)
{ return shfl_from(v, (threadIdx.x & 31) ^ off); }
template <class V>
inline V __shfl_up_sync(unsigned, V v, int off)
{
    const int l = threadIdx.x & 31;
    return shfl_from(v, l >= off ? l - off : l);
}
template <class V>
inline V __shfl_down_sync(unsigned, V v, int off)
{
    const int l = threadIdx.x & 31;
    return shfl_from(v, l + off < 32 ? l + off : l);
}
inline unsigned __ballot_sync(unsigned, bool p)
{
    unsigned long long* x = g_x[t_rank][threadIdx.x >> 5];
    x[threadIdx.x & 31] = p;
    __syncwarp();
    unsigned b = 0;
    for (int i = 0; i < 32; ++i) b |= (x[i] ? 1u : 0u) << i;
    __syncwarp();
    return b;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int atomicAdd(int* p, int v)
{ return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline int atomicMin(int* p, int v)
{
    int old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
    while (v < old && !__atomic_compare_exchange_n(
               p, &old, v, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST)) {}
    return old;
}
inline float __int_as_float(int i) { float f; memcpy(&f, &i, 4); return f; }
inline int __float_as_int(float f) { int i; memcpy(&i, &f, 4); return i; }
namespace cg {
struct cluster_group {
    unsigned block_rank() const { return (unsigned)t_rank; }
    unsigned num_blocks() const { return (unsigned)g_S; }
    void sync() const { g_cluster->arrive_and_wait(); }
    template <class V> V* map_shared_rank(V* p, int rr) const
    {
        return (V*)((char*)p - g_mem[t_rank].data() + g_mem[rr].data());
    }
};
inline cluster_group this_cluster() { return {}; }
}
inline void cluster_arrive() { t_token.emplace(g_cluster->arrive()); }
inline void cluster_wait() { g_cluster->wait(std::move(*t_token)); }
#define OSLAM_BIG (1 << 30)
'''

POSTLUDE = r'''
extern "C" int emu_cluster_grid(
    const void* pts, const void* cells, const void* mask, const void* labels0,
    int D, int N, float tol2, int R, const int* rows, int outer_iters,
    int jump_iters, int S, int T, int smem_bytes, void* ids, int ids_stride,
    void* nbr, void* out_labels, void* converged, void* rounds,
    const void* pts_w, const void* center, int min_size, float center_dis,
    void* least_d, void* sel_mask, void* sel_ok)
{
    GridRows gr = {};
    gr.n = rows[0];
    for (int r = 0; r < gr.n; ++r) {
        gr.lo[r] = rows[1 + 2 * r];
        gr.hi[r] = rows[2 + 2 * r];
    }
    Selection sel = {};
    if (pts_w != nullptr)
        sel = {(const float*)pts_w, (const float*)center, min_size,
               center_dis, (int*)least_d, (uint8_t*)sel_mask,
               (uint8_t*)sel_ok};
    const GridScratch scratch = {(uint16_t*)ids, ids_stride, (uint16_t*)nbr};
    g_S = S;
    blockDim = {(unsigned)T, 1, 1};
    for (int b = 0; b < S; ++b) g_mem[b].assign(smem_bytes + 64, 0);
    for (int d = 0; d < D; ++d) {
        std::barrier<> cluster(S * T);
        g_cluster = &cluster;
        for (int b = 0; b < S; ++b) {
            g_block[b] = new std::barrier<>(T);
            for (int w = 0; w < T / 32; ++w)
                g_warp[b][w] = new std::barrier<>(32);
            g_red[b][0] = g_red[b][1] = 0;
        }
        std::vector<std::thread> th;
        for (int b = 0; b < S; ++b)
            for (int t = 0; t < T; ++t)
                th.emplace_back([=, &scratch, &gr, &sel]() {
                    threadIdx = {(unsigned)t, 0, 0};
                    blockIdx = {(unsigned)b, (unsigned)d, 0};
                    t_rank = b;
                    t_gen = 0;
                    cluster_grid_kernel(
                        (const float*)pts, (const int*)cells,
                        (const uint8_t*)mask, (const int*)labels0, N, tol2,
                        R, gr, outer_iters, jump_iters, smem_bytes, scratch,
                        (int*)out_labels, (uint8_t*)converged, (int*)rounds,
                        sel);
                });
        for (auto& x : th) x.join();
        for (int b = 0; b < S; ++b) {
            delete g_block[b];
            for (int w = 0; w < T / 32; ++w) delete g_warp[b][w];
        }
    }
    return 0;
}
'''


def _piece(text, start, end):
    a = text.index(start)
    return text[a:text.index(end, a)]


def build(source, out):
    """K13's section of ``source`` with the helpers it calls, as a CPU
    shared library."""
    text = open(source).read()
    body = "\n".join([
        _piece(text, "__device__ __forceinline__ int warp_min(int v)",
               "__device__ __forceinline__ int warp_max(int v)"),
        _piece(text, "template <bool kTrack>\n__device__ __forceinline__ "
               "bool jump_once", "// ----"),
        _piece(text, "struct Selection {", "// The chain lane's extra"),
        _piece(text, "#define OSLAM_GRID_MAXT",
               "// The dynamic shared memory cluster_grid_kernel may ask")])
    body = body.replace("extern __shared__ int4 grid_smem[];",
                        "int4* grid_smem = (int4*)g_mem[t_rank].data();")
    cpp = out + ".cpp"
    with open(cpp, "w") as f:
        f.write(PRELUDE + body + POSTLUDE)
    proc = subprocess.run(["g++", "-std=c++20", "-O2", "-ffp-contract=off",
                           "-shared", "-fPIC", "-pthread", "-o", out, cpp],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"g++ failed on {source}:\n{proc.stderr}")
    lib = ctypes.CDLL(out)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.emu_cluster_grid.argtypes = ([p] * 4 + [i, i, f, i, p] + [i] * 5
                                     + [p, i] + [p] * 4
                                     + [p, p, i, f, p, p, p])
    lib.emu_cluster_grid.restype = i
    return lib


def run(lib, pts, cells, mask, labels0, pts_w, centre, tol, leaf, outer,
        T, smem=None, S=1):
    """One call of the CPU build with the selection (12 jumps, min_size
    100, centre distance 0.5, as chip_smoke.py's checks), S blocks of T
    threads a detection: (sel, ok, labels, converged, rounds) as
    ``cluster_grid_select`` returns them."""
    D, N = mask.shape
    R, _ = cl.grid_stencil(tol, leaf)
    rows = cl.grid_rows(tol, leaf)
    flat = [len(rows)] + [v for row in rows for v in row]
    host_rows = (ctypes.c_int * len(flat))(*flat)
    n2 = 1 << max(0, (N - 1).bit_length())
    ids = torch.full((D, S, n2), -1, dtype=torch.int16)
    nbr = torch.full((D, 124 * N), -1, dtype=torch.int16)
    labels = torch.full((D, N), -7, dtype=torch.int32)
    conv = torch.zeros(D, dtype=torch.bool)
    rounds = torch.zeros(D, dtype=torch.int32)
    sel = torch.zeros((D, N), dtype=torch.bool)
    ok = torch.zeros(D, dtype=torch.bool)
    least = torch.zeros((D, N), dtype=torch.int32)
    tol2 = float(torch.tensor(tol * tol, dtype=torch.float32))
    ts = [t.contiguous() for t in (pts, cells, mask, labels0, pts_w, centre)]
    rc = lib.emu_cluster_grid(
        ts[0].data_ptr(), ts[1].data_ptr(), ts[2].data_ptr(),
        ts[3].data_ptr(), D, N, tol2, R, ctypes.addressof(host_rows), outer,
        12, S, T, smem or cl.grid_smem(N), ids.data_ptr(), n2,
        nbr.data_ptr(),
        labels.data_ptr(), conv.data_ptr(), rounds.data_ptr(),
        ts[4].data_ptr(), ts[5].data_ptr(), 100, 0.5, least.data_ptr(),
        sel.data_ptr(), ok.data_ptr())
    if rc:
        raise RuntimeError(f"emu_cluster_grid returned {rc}")
    return sel, ok, labels, conv, rounds


def path_inputs():
    """The depth frame of tests/test_torch_frontend_kernels.py: its voxel
    clouds (camera frame), cells, world points and mask."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_frontend_kernels as kt
    return kt._grid_inputs()


def ties_inputs():
    """Clouds where several survivors share a cell (the least lane takes
    the cell), in lane order and shuffled."""
    rng = np.random.default_rng(4)
    D, N = 3, 600
    base = rng.uniform(0.0, 0.12, (D, N // 2, 3)).astype(np.float32)
    pts = np.concatenate([base, base + rng.uniform(-0.002, 0.002, base.shape)
                          .astype(np.float32)], 1)
    pts[2] = pts[2][rng.permutation(N)]
    pts = torch.from_numpy(pts)
    cells = torch.floor(pts / 0.01).to(torch.int32)
    mask = torch.from_numpy(rng.random((D, N)) > 0.1)
    return pts, cells, mask


def sizes_inputs():
    """Detections of 1, 31, 32 and 33 survivors and an all-masked one,
    each sprinkled over a 6 x 6 x 2 cm slab in 128 lanes, the 33's lanes
    in random order."""
    rng = np.random.default_rng(6)
    D, N = 5, 128
    pts = (rng.uniform(0.0, 1.0, (D, N, 3)) * [0.06, 0.06, 0.02]
           + [0.0, 0.0, 1.0]).astype(np.float32)
    mask = np.zeros((D, N), bool)
    for d, n in enumerate((1, 31, 32, 33, 0)):
        mask[d, rng.choice(N, n, replace=False)] = True
    cells = np.floor(pts / np.float32(0.01)).astype(np.int32)
    return (torch.from_numpy(pts), torch.from_numpy(cells),
            torch.from_numpy(mask))


def dense_inputs():
    """A voxel block that fills 16384 lanes: in cell order, and shuffled
    with 3000 lanes masked (test_cluster_grid_full_tier_and_refusals')."""
    rng = np.random.default_rng(9)
    raw = (rng.uniform(0.0, 0.3, (60000, 3)) + [0, 0, 1.5]).astype(
        np.float32)
    pts, cells, mask = vx.voxel_downsample_cells(
        torch.from_numpy(raw)[None], torch.ones(1, 60000, dtype=torch.bool),
        0.01, 16384)
    pts, cells, mask = (t.repeat(2, *([1] * (t.dim() - 1))).clone()
                        for t in (pts, cells, mask))
    perm = torch.randperm(16384, generator=torch.Generator().manual_seed(1))
    pts[1], cells[1], mask[1] = pts[1, perm], cells[1, perm], mask[1, perm]
    mask[1, :3000] = False
    return pts, cells, mask


def cases():
    """name -> (pts, cells, mask, outer, smem or None)."""
    out = {}
    pts_v, cells_v, _, m2 = path_inputs()
    out["path"] = (pts_v, cells_v, m2, 96, None)
    out["path-2"] = (pts_v, cells_v, m2, 2, None)
    least = cl.grid_smem_least(m2.shape[1])
    out["path-device"] = (pts_v, cells_v, m2, 96, least)
    out["path-window"] = (pts_v, cells_v, m2, 96, least + 16 * m2.shape[1])
    perm = torch.randperm(m2.shape[1],
                          generator=torch.Generator().manual_seed(0))
    out["shuffled"] = (pts_v[:, perm], cells_v[:, perm], m2[:, perm], 96,
                       None)
    out["ties"] = (*ties_inputs(), 96, None)
    out["sizes"] = (*sizes_inputs(), 96, None)
    out["dense"] = (*dense_inputs(), 96, None)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", type=int, default=64)
    ap.add_argument("--blocks", type=int, nargs="+", default=[1, 4],
                    help="blocks a detection (the cluster's size) to run")
    ap.add_argument("case", nargs="*")
    ns = ap.parse_args()
    source = os.path.join(ROOT, "object_oriented_slam_tpu_torch", "csrc",
                          "frontend.cu")
    bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(source, os.path.join(tmp, "k13.so"))
        for name, (pts, cells, mask, outer, smem) in cases().items():
            if ns.case and name not in ns.case:
                continue
            t0 = time.perf_counter()
            pts, cells, mask = (t.contiguous() for t in (pts, cells, mask))
            labels0 = cl.grid_seed(pts, mask, 0.02)
            pts_w = (pts + torch.tensor([0.3, -0.2, 0.1])).contiguous()
            centre = pts_w[:, 0].contiguous()
            want = cl.cluster_grid_select_plain(pts, cells, mask, labels0,
                                                pts_w, centre, 0.02, 0.01,
                                                outer, 12, 100, 0.5)
            for S in ns.blocks:
                got = [run(lib, pts, cells, mask, labels0, pts_w, centre,
                           0.02, 0.01, outer, ns.threads, smem, S)
                       for _ in range(2)]
                same = all(torch.equal(g, w) for g, w in zip(got[0], want))
                repeat = all(torch.equal(a, b) for a, b in zip(*got))
                bad += not (same and repeat)
                print(f"{name}, S={S}: equal to the plain version {same}, repeat "
                      f"bit-equal {repeat}; rounds {got[0][4].tolist()} "
                      f"(plain {want[4].tolist()}), converged "
                      f"{got[0][3].tolist()}, "
                      f"{int((got[0][2] != want[2]).sum())} labels differ, "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
