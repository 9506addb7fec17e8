"""symmetry_search (K8) built for the CPU, to hold two versions of its source
against each other bit for bit without a card.

    python3 examples/torch_symmetry_search_on_cpu.py OLD.cu [NEW.cu] [CASE ...]

The symmetry_search section of each ``frontend.cu`` (NEW defaults to this
tree's ``object_oriented_slam_tpu_torch/csrc/frontend.cu``) is compiled with
g++ (``-ffp-contract=off``: every multiply and add rounds on its own, as
with nvcc's ``-fmad=false``) into a shared library with the kernel's C
entry point.  Each block runs as 256 std::threads, one after another: a
std::barrier stands for ``__syncthreads``, one per warp for the shuffles and
ballots, ``__shared__`` variables become statics.  The math library is the
host's, not libdevice, so the results are not the card's bits; but two
versions whose sums and operations come in the same order give the same
bits here too, and one that reorders a sum shows.  CASE names cases of
``tests/test_torch_frontend_kernels.py`` (``path``, ``ties``, ``capacity``,
``ragged``, the sparse symmetry cases ``sparse-path`` and
``sparse-capacity`` with their source masks, which both versions must
take, and ``every-live-path`` / ``every-live-capacity``: NEW with a source
mask of every point against OLD without one; or one
``<case>-<analytic|central>-<iters>``); all by default.  Exits 1 if any
case differs.  Needs g++ with C++20; the ragged case takes about a
minute.
"""
import ctypes
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from object_oriented_slam_tpu_torch.core.camera import Camera  # noqa: E402
from object_oriented_slam_tpu_torch.frontend import symmetry as sym  # noqa: E402

PRELUDE = r'''
#include <math.h>
#include <stdint.h>
#include <stddef.h>
#include <string.h>
#include <atomic>
#include <barrier>
#include <cmath>
#include <thread>
#include <vector>
using std::isfinite;
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d)
{ return {a, b, c, d}; }
struct dim3 { unsigned x, y, z;
              dim3(unsigned a, unsigned b = 1, unsigned c = 1)
                  : x(a), y(b), z(c) {} };
struct U3 { unsigned x, y, z; };
thread_local U3 threadIdx, blockIdx;
static void* g_smem;
static std::barrier<>* g_block;
static std::barrier<>* g_warp[8];
static float g_xf[8][32];
static unsigned g_xu[8][32];
inline void __syncthreads() { g_block->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu)
{ g_warp[threadIdx.x >> 5]->arrive_and_wait(); }
inline float __shfl_sync(unsigned, float v, int src)
{
    const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
    g_xf[w][l] = v;
    __syncwarp();
    const float r = g_xf[w][src & 31];
    __syncwarp();
    return r;
}
inline float __shfl_xor_sync(unsigned m, float v, int off)
{ return __shfl_sync(m, v, (threadIdx.x & 31) ^ off); }
inline unsigned __ballot_sync(unsigned, bool p)
{
    const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
    g_xu[w][l] = p;
    __syncwarp();
    unsigned b = 0;
    for (int i = 0; i < 32; ++i) b |= (g_xu[w][i] ? 1u : 0u) << i;
    __syncwarp();
    return b;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline void __threadfence()
{ std::atomic_thread_fence(std::memory_order_seq_cst); }
inline int atomicAdd(int* p, int v)
{ return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline int __float2int_rz(float f)
{
    if (f != f) return 0;
    if (f >= 2147483648.0f) return 2147483647;
    if (f <= -2147483648.0f) return -2147483647 - 1;
    return (int)f;
}
inline float __int_as_float(int i) { float f; memcpy(&f, &i, 4); return f; }
typedef void* cudaStream_t;
enum { cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
template <class F, class A>
void emu_launch(F kernel, dim3 g, size_t smem, const A& a);
'''

POSTLUDE = r'''
template <class F, class A>
void emu_launch(F kernel, dim3 g, size_t smem, const A& a)
{
    std::vector<char> mem(smem + 16);
    g_smem = mem.data();
    for (unsigned by = 0; by < g.y; ++by)
        for (unsigned bx = 0; bx < g.x; ++bx) {
            std::barrier<> blk(256);
            g_block = &blk;
            for (int w = 0; w < 8; ++w) g_warp[w] = new std::barrier<>(32);
            std::vector<std::thread> th;
            for (unsigned t = 0; t < 256; ++t)
                th.emplace_back([=, &a]() {
                    threadIdx = {t, 0, 0};
                    blockIdx = {bx, by, 0};
                    kernel(a);
                });
            for (auto& x : th) x.join();
            for (int w = 0; w < 8; ++w) delete g_warp[w];
        }
}
'''


def build(source, out):
    """The symmetry_search section of ``source`` as a CPU shared library."""
    text = open(source).read()
    body = text[text.index("// symmetry_search.  Replaces"):]
    body = body.replace("extern __shared__ float4 ref[];",
                        "float4* ref = (float4*)g_smem;")
    # room for the sources' 16-bit indices after the live points
    body = re.sub(
        r"\b(symmetry_search_kernel|kernel)\s*<<<[^>]*>>>\s*\(a\);",
        r"emu_launch(\1, grid, (size_t)S * (sizeof(float4) + 2), a);", body,
        flags=re.S)
    cpp = out + ".cpp"
    with open(cpp, "w") as f:
        f.write(PRELUDE + body + POSTLUDE)
    proc = subprocess.run(["g++", "-std=c++20", "-O2", "-ffp-contract=off",
                           "-shared", "-fPIC", "-pthread", "-o", out, cpp],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"g++ failed on {source}:\n{proc.stderr}")
    lib = ctypes.CDLL(out)
    lib.takes_src = "src_mask" in body       # a source with sparse symmetry
    # a source with the offline batch mapper's frame lane
    lib.takes_frame = "const void* frame," in body
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.oslam_symmetry_search.argtypes = ([p] * (7 + lib.takes_src
                                                 + lib.takes_frame)
                                          + [i] * 4 + [f] * 11 + [i, i]
                                          + [p] * 7)
    lib.oslam_symmetry_search.restype = i
    return lib


def search(lib, args, cam, cfg, src_mask=None):
    """One call of the CPU build, the arguments as estimate_symmetry passes
    them (``src_mask`` only to a source that takes one); returns its
    outputs."""
    pts, mask, bbox, pose, depth, types, run = [t.contiguous() for t in args]
    D, S = mask.shape
    H, W = depth.shape
    out = [torch.zeros(D, 4), torch.zeros(D), torch.zeros(D), torch.zeros(D),
           torch.zeros(D, sym.N_INITS, sym.INIT_FIELDS)]
    done = torch.zeros(D, dtype=torch.int32)
    inv = 1.0 / cfg.sigma
    src = [] if not lib.takes_src else [
        None if src_mask is None else src_mask.contiguous().data_ptr()]
    frame = [None] if lib.takes_frame else []     # one frame
    rc = lib.oslam_symmetry_search(
        pts.data_ptr(), mask.data_ptr(), *src, bbox.data_ptr(),
        pose.data_ptr(),
        depth.data_ptr(), *frame, types.data_ptr(), run.data_ptr(), D, S, H,
        W,
        cam.fx, cam.fy, cam.cx, cam.cy, cam.scale, cam.fx * cam.fx,
        -0.5 * inv * inv,
        float(np.float32(np.deg2rad(np.float32(cfg.step_angle_deg)))),
        cfg.step_dis, cfg.num_delta, 2 * cfg.num_delta, cfg.iters,
        int(cfg.analytic_grad), *(t.data_ptr() for t in out),
        done.data_ptr(), None)
    if rc:
        raise RuntimeError(f"oslam_symmetry_search returned {rc}")
    return out


def main():
    paths = [a for a in sys.argv[1:] if a.endswith(".cu")]
    wanted = [a for a in sys.argv[1:] if not a.endswith(".cu")]
    if not paths:
        print(__doc__)
        return 2
    if len(paths) == 1:
        paths.append(os.path.join(ROOT, "object_oriented_slam_tpu_torch",
                                  "csrc", "frontend.cu"))
    import test_torch_frontend_kernels as kt
    cam = Camera(fx=535.4, fy=539.2, cx=320.1, cy=247.6, scale=5000.0)
    cases = [("path", an, it) for it in (5, 1, 8) for an in (True, False)]
    cases += [("ties", True, 5), ("ties", False, 5), ("capacity", True, 5),
              ("capacity", False, 5), ("ragged", True, 5),
              ("sparse-path", True, 5), ("sparse-path", False, 5),
              ("sparse-capacity", True, 5), ("every-live-path", True, 5),
              ("every-live-path", False, 5), ("every-live-capacity", True, 5)]
    bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        libs = [build(p, os.path.join(tmp, f"k{i}.so"))
                for i, p in enumerate(paths)]
        for case, analytic, iters in cases:
            name = f"{case}-{'analytic' if analytic else 'central'}-{iters}"
            if wanted and case not in wanted and name not in wanted:
                continue
            cpu = torch.device("cpu")
            srcs = (None, None)
            if case.startswith("sparse-"):
                if not all(lib.takes_src for lib in libs):
                    print(f"{name}: skipped, a version takes no source mask")
                    continue
                args, src = kt._SYM_SPARSE_CASES[case](cpu)
                srcs = (src, src)
            elif case.startswith("every-live-"):
                args = kt._SYM_CASES[case[len("every-live-"):]](cpu)
                srcs = (None, args[1])
            else:
                args = kt._SYM_CASES[case](cpu)
            cfg = sym.SymmetryConfig(analytic_grad=analytic, iters=iters)
            t0 = time.perf_counter()
            old, new = (search(lib, args, cam, cfg, src)
                        for lib, src in zip(libs, srcs))
            same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(old, new))
            bad += not same
            diff = max(float((a - b).abs().max()) for a, b in zip(old, new))
            print(f"{name}: bits equal {same} (largest difference {diff:.3g}),"
                  f" {time.perf_counter() - t0:.1f} s", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
