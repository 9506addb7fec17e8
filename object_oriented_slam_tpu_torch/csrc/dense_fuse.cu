// K12 dense_fuse for sm_90a: one frame of the dense RGB-D map builder
// (ops/dense_fuse.FuseWork; system/dense_builder.DenseBuilder), in device
// memory, in one cooperative launch.
//
// Replaces the JAX package's system/dense_builder.py:24-39 `_fuse_frame`,
// which XLA compiled (no Pallas kernel): the strided full-image
// back-projection (ops/backproject.py full_point_cloud), the world
// transform and colour gather, the concatenation of the map and the frame,
// and ops/voxel.py:42-86 `_voxel_core` at a 1 cm leaf with the three BGR
// channels as attributes into `capacity` cells (1 << 19 by default).
//
// The plain version (ops/dense_fuse.dense_fuse_plain) sorts the keys of
// [map; frame] stably and sums each run of equal keys in sorted order.
// This kernel gives the same bits without sorting the map.  The map it
// reads came out of the previous fuse in key order, and its keys,
// recomputed from the centroids, still ascend unless a centroid re-floors
// into the next cell under f32 rounding or the minimum cell moved while
// rows sat clipped at 1023 cells an axis.  So the phases, each ended by a
// grid-wide barrier (cooperative groups):
//   (1) points: the frame's strided pixels back-projected, moved to the
//       world and written with their colours after the map's rows; each
//       block's least cell of the live rows and least and largest cell of
//       the frame, written to its own partials (no atomics on shared
//       words: min and max are order-free, so deterministic).
//   (2) keys: every block reduces the partials (gather); every row's key
//       (JAX's clip to 0..1023 an axis, 10 bits each, 2^30 for a masked
//       row); the live counts of map and frame, clipped frame cells, and
//       descents key[i] > key[i + 1] for i < capacity - 1 (a masked row
//       before a live one counts, so a map loaded in any order is caught;
//       pairs split between blocks are tested after the barrier, in
//       gather); each live frame pixel counted in its bucket, a
//       contiguous range of the frame's keys (the lanes of one bucket take
//       one atomic, whose old value is the pixel's place in the bucket).
//   (3) sort.  Fast path (no descent): only the frame's live keys are
//       sorted: each pixel moved to its place in its bucket, then each
//       bucket sorted by (key, pixel), the stable order, in shared memory:
//       by a warp (at most 64 pixels) or by the block's ranks (at most
//       1024; chip_smoke.py's [dense] frames reach 138).  A frame with a
//       larger bucket (the largest count, reduced alike in every block) or
//       with a clipped cell (the buckets' order assumes none) is sorted by
//       the general sort over its keys instead.  General path (a
//       descent): all live keys of map and frame by every block: LSD radix
//       passes of 8 bits, four over the 30 key bits, a pass ranking a
//       warp's run of elements in order (match_any), so stable; masked
//       rows dropped in the first pass.
//   (4) merge: merge-path tiles of (A, B) with ties to A, where A is the
//       map's live prefix in place and B the sorted frame (fast), or A the
//       sorted live keys and B empty (general); a tile's segment starts
//       (keys unlike their predecessor in merged order) counted.
//   (5) sums: a segment's rank is the count of starts before it; a tile's
//       rows read into shared memory at once, then one thread sums each
//       segment below `capacity` in merged order, A's rows first (in place
//       on the fast path, through the int32 permutation on the general
//       one), then B's through the frame's pixels, and writes the
//       centroid, the colour mean and the mask; segments at or past
//       `capacity` are dropped, as _voxel_core drops them; output rows past
//       the new count that an older map left set are cleared (the others
//       are zero already), instead of clearing the whole output.
// The path is picked on the device: no host synchronisation.
//
// Why the merge keeps the bits: a stable sort of [A; B] with A
// non-decreasing puts equal keys in this order: A's rows in index order,
// then B's in index order.  A merge with ties to A, of A and a stably
// sorted B, gives exactly that order, so every segment is summed in the
// plain version's order (its sequential index_add_ on the CPU).
//
// Bound by bytes: the map's rows read and written (25 bytes a row) and the
// frame's strided pixels, ~26 MB a frame at 1 << 19 cells.  The fast path
// reads the map's rows three times (cells, keys, sums; the second from
// L2) and writes them once; the general path adds four radix passes and
// reads the rows through the permutation.  One launch a fuse, where the
// first design made about twenty device operations (three memsets, five
// kernels and a library sort's).
//
// Built with -fmad=false and without fast math: every multiply, add and
// divide rounds on its own (IEEE), in the order of the plain version.
// Plain C interface, bound with ctypes; the launch is on the given stream,
// does not synchronise, allocates nothing and returns its CUDA error.
// examples/torch_dense_fuse_on_cpu.py builds the section between the two
// "CPU build" marks with g++ and runs the blocks as std::threads.
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <stdint.h>

namespace cg = cooperative_groups;

extern "C" const char* oslam_df_error_string(int rc) {
    return cudaGetErrorString((cudaError_t)rc);
}

// ---- CPU build: from here ----
#define OSLAM_BIG (1 << 30)     // the invalid key
#define DF_T 1024               // threads a block on the card
#define DF_PER 4                // merged elements a thread in a tile
#define DF_ROWS 5               // rows a thread loads at once in (1), (2)
#define DF_DIGITS 256           // a radix pass's digits (8 bits)
#define DF_WARPS 32             // warps a block at most
#define DF_GRID_MAX 512         // blocks a launch at most
#define DF_SMEM_MAX 232448      // shared memory a block may have on sm_90
// dynamic shared memory: 64 ints of reduction scratch, the per-warp digit
// counters, two digit arrays, the bounds of DF_BND buckets; after them the
// frame sort's bucket starts, a grid pass's histogram partial sums (8 KB)
// or its staged elements (8 bytes each).  The merge tiles reuse the bytes
// from the counters on.
#define DF_RED 64
#define DF_BND 256
#define DF_FIXED_BYTES                                                      \
    ((DF_RED + DF_WARPS * DF_DIGITS + 2 * DF_DIGITS + 2 * DF_BND) * 4)
#define DF_PART_BYTES (2 * 4 * DF_DIGITS * 4)
// the merge phases' shared memory: three windows of a tile (A's keys,
// B's keys and B's pixels), the tile's keys, kinds and six row values, and
// a round's output rows; the most any phase takes
#define DF_SMEM_BYTES                                                       \
    ((DF_RED + 3 * (DF_PER * DF_T + 1) + 8 * DF_PER * DF_T + 6 * DF_T) * 4)
// the elements a grid pass's block stages in shared memory at most
#define DF_STAGE_MAX ((DF_SMEM_BYTES - DF_FIXED_BYTES) / 8)
// a block's partial results, DF_PART ints (plain stores: atomics from
// every block on a few words would queue at one L2 slice), and the whole
// grid's, which every block reduces from them into shared memory: the
// least cell of the live rows (cmin), the frame's least and largest cells,
// descents, clipped frame cells, live map rows, live frame pixels
#define DF_PART 16
#define DF_CMIN 0
#define DF_FMIN 3
#define DF_FMAX 6
#define DF_DESC 9
#define DF_FCLIP 10
#define DF_NA 11
#define DF_NB 12
// the frame sort's buckets: contiguous ranges of the frame's keys
#define DF_NBUCK 4096
static_assert(DF_SMEM_BYTES <= DF_SMEM_MAX
              && DF_FIXED_BYTES + (DF_NBUCK + 1) * 4 <= DF_SMEM_BYTES
              && DF_FIXED_BYTES + DF_PART_BYTES <= DF_SMEM_BYTES,
              "a phase's shared memory past the launch's");

struct FuseParams {
    int cap, F, hs, ws, width, stride;
    float fx, fy, cx, cy, scale, depth_range, leaf;
    const int* depth;
    const float* rgb;           // null: zero colours
    const float* pose;          // Twc: t, quaternion x y z w
    float* pts;                 // [cap + F, 3] the map's rows, the frame's
    float* col;
    uint8_t* mask;
    float* out_pts;             // [cap, 3] the other buffer's prefix
    float* out_col;
    uint8_t* out_mask;
    int* keys;                  // [cap + F]
    int* sk[2];                 // [cap + F] radix keys, ping-pong
    int* sv[2];                 // [cap + F] their row (or frame pixel) ids
    int* part;                  // [DF_GRID_MAX, DF_PART]
    int* hist;                  // [DF_GRID_MAX, DF_DIGITS]
    int* tile_cnt;              // [tiles] segment starts a merge tile
    int* tile_ia;               // [tiles + 1] a tile's first A element
    int* rk;                    // [cap + F] a grid pass's ranks in a warp
    int* bcount;                // [DF_NBUCK] frame pixels a bucket
    int* boff;                  // [DF_NBUCK + 1] its start
    int* tally;                 // [2] fuses by path: fast, general
};

// The merge tiles' count bound: at least 4 x 32 merged elements a tile,
// plus a block's rounding.
static long long df_tiles(long long n)
{
    return n / (DF_PER * 32) + DF_GRID_MAX + 2;
}

// int32 words of the scratch a fuse of cap + F rows takes: the blocks'
// partials, the
// histograms, the merge tiles' counts and splits, the radix buffers and
// ranks
static long long df_scratch_ints(long long cap, long long F)
{
    const long long n = cap + F;
    return (long long)DF_GRID_MAX * (DF_PART + DF_DIGITS)
        + 2 * df_tiles(n) + 1 + 5 * n + 2 * DF_NBUCK + 1;
}

// FuseParams of one fuse: the map in buffer (pts, col, mask), the output
// into (out_*), scratch carved as df_scratch_ints says; 0 or an error.
static int df_setup(FuseParams* p, int cap, int height, int width,
                    int stride, float fx, float fy, float cx, float cy,
                    float scale, float depth_range, float leaf,
                    const void* depth, const void* rgb, const void* pose,
                    void* pts, void* col, void* mask, void* out_pts,
                    void* out_col, void* out_mask, void* keys,
                    void* scratch, long long scratch_ints, void* tally)
{
    if (cap < 1 || height < 1 || width < 1 || stride < 1 || !(leaf > 0.0f))
        return 1;
    const int hs = (height + stride - 1) / stride;
    const int ws = (width + stride - 1) / stride;
    const long long F = (long long)hs * ws, n = cap + F;
    if (n > 0x7fffffffLL || scratch_ints < df_scratch_ints(cap, F)) return 1;
    *p = FuseParams{};
    p->cap = cap;
    p->F = (int)F;
    p->hs = hs;
    p->ws = ws;
    p->width = width;
    p->stride = stride;
    p->fx = fx;
    p->fy = fy;
    p->cx = cx;
    p->cy = cy;
    p->scale = scale;
    p->depth_range = depth_range;
    p->leaf = leaf;
    p->depth = (const int*)depth;
    p->rgb = (const float*)rgb;
    p->pose = (const float*)pose;
    p->pts = (float*)pts;
    p->col = (float*)col;
    p->mask = (uint8_t*)mask;
    p->out_pts = (float*)out_pts;
    p->out_col = (float*)out_col;
    p->out_mask = (uint8_t*)out_mask;
    p->keys = (int*)keys;
    int* s = (int*)scratch;
    p->part = s;
    s += DF_GRID_MAX * DF_PART;
    p->hist = s;
    s += DF_GRID_MAX * DF_DIGITS;
    const long long tiles = df_tiles(n);
    p->tile_cnt = s;
    s += tiles;
    p->tile_ia = s;
    s += tiles + 1;
    for (int b = 0; b < 2; ++b) {
        p->sk[b] = s;
        s += n;
        p->sv[b] = s;
        s += n;
    }
    p->rk = s;
    s += n;
    p->bcount = s;
    s += DF_NBUCK;
    p->boff = s;
    p->tally = (int*)tally;
    return 0;
}

#ifdef OSLAM_DF_CLOCKS
// clock64 of block 0's thread 0 after each phase (examples/
// torch_dense_fuse_bench.py): 0 start, 1 points, 2 keys, 3 sort, 4 merge
// counts, 5 sums; 6 the path (0 fast, 1 general); 8 the count of the steps
// within phases stamped from 9 on (DF_STEP)
#define DF_CLOCKS 80
__device__ long long oslam_df_clock[DF_CLOCKS];
#define DF_CLOCK(i)                                                         \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                              \
        oslam_df_clock[i] = clock64();                                      \
        if (i == 0) oslam_df_clock[8] = 0;                                  \
    }
#define DF_STEP()                                                           \
    if (blockIdx.x == 0 && threadIdx.x == 0 && oslam_df_clock[8] < 70)      \
        oslam_df_clock[9 + oslam_df_clock[8]++] = clock64()
// every block's clock64 at its marks (its own SM's clock): 0 start, 1 the
// points done, 2 after the barrier, 3 the keys done, 4 after the barrier,
// 5 the buckets' starts, 6 the pixels in their buckets, 7 after the
// barrier, 8 the buckets sorted, 9 after the barrier (the merge counts
// start), 10 the counts done, 11 after the barrier, 12 the sums done; 13
// the keys' rows done (their reductions follow), 14 the frame sort's start,
// 15 its bucket counts loaded
__device__ long long oslam_df_blk[DF_GRID_MAX * 16];
#define DF_MARK(i)                                                          \
    __syncthreads();                                                        \
    if (threadIdx.x == 0) oslam_df_blk[blockIdx.x * 16 + (i)] = clock64()
#else
#define DF_CLOCK(i)
#define DF_STEP()
#define DF_MARK(i)
#endif

__device__ __forceinline__ int cell_of(float p, float leaf)
{
    return (int)floorf(p / leaf);
}

// R of the pose's unit quaternion (x, y, z, w), row-major, in the
// operations and order of core/se3.quat_to_mat.
__device__ __forceinline__ void quat_to_mat(const float* q, float* R)
{
    const float x = q[0], y = q[1], z = q[2], w = q[3];
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, xz = x * z, yz = y * z;
    const float wx = w * x, wy = w * y, wz = w * z;
    R[0] = 1.0f - 2.0f * (yy + zz);
    R[1] = 2.0f * (xy - wz);
    R[2] = 2.0f * (xz + wy);
    R[3] = 2.0f * (xy + wz);
    R[4] = 1.0f - 2.0f * (xx + zz);
    R[5] = 2.0f * (yz - wx);
    R[6] = 2.0f * (xz - wy);
    R[7] = 2.0f * (yz + wx);
    R[8] = 1.0f - 2.0f * (xx + yy);
}

// ---------------------------------------------------------------------------
// block-wide reductions and scans (any multiple of 32 threads up to 1024;
// red: DF_RED ints of shared scratch)
// ---------------------------------------------------------------------------
__device__ __forceinline__ int block_sum(int v, int* red)
{
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    v = __reduce_add_sync(0xffffffffu, v);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    int s = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w];
    __syncthreads();
    return s;
}

__device__ __forceinline__ int block_min(int v, int* red)
{
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    v = __reduce_min_sync(0xffffffffu, v);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    int s = red[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) s = min(s, red[w]);
    __syncthreads();
    return s;
}

// Exclusive scan of one int a thread over the block; *total the sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total,
                                                    int* red)
{
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    int inc = v;
    for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc += o;
    }
    if (lane == 31) red[warp] = inc;
    __syncthreads();
    if (warp == 0) {
        int w = lane < nw ? red[lane] : 0;
        for (int d = 1; d < 32; d <<= 1) {
            const int o = __shfl_up_sync(0xffffffffu, w, d);
            if (lane >= d) w += o;
        }
        if (lane < nw) red[lane] = w;
    }
    __syncthreads();
    const int before = warp > 0 ? red[warp - 1] : 0;
    *total = red[nw - 1];
    __syncthreads();
    return before + inc - v;
}

// Dynamic shared memory, by phase.
struct Smem {
    int* red;                   // [32] reductions' scratch
    int* val;                   // [DF_PART] the grid's values (gather)
    int* wrun;                  // [DF_WARPS, DF_DIGITS]
    int* dig;                   // [DF_DIGITS]
    int* dig2;                  // [DF_DIGITS]
    int* bnd;                   // [2, DF_BND] buckets' starts and sizes
    int* fk;                    // [DF_NBUCK + 1] the buckets' starts,
                                // [2, 1024] a bucket the block ranks, or
                                // [2, DF_STAGE_MAX] a pass's staged keys
                                // and ids
    int* part;                  // [2, 4, DF_DIGITS] over fk's bytes
    int* ta;                    // [DF_PER * blockDim + 1] a merge tile's A
    int* tb;                    // [DF_PER * blockDim + 1] and B windows
    int* tid;                   // [DF_PER * blockDim + 1] B's pixels
    int* rkey;                  // [DF_PER * blockDim] the tile's keys
    int* rkind;                 // [DF_PER * blockDim] 1 an A row, 0 a B one
    float* rval;                // [6, DF_PER * blockDim] their rows' point,
                                // colour
    float* rout;                // [2, 3 blockDim] a round's segments' means
};

// ---------------------------------------------------------------------------
// (1) points and the minimum cell, (2) keys and the descent flag
// ---------------------------------------------------------------------------
// Row i < cap: map row i (its cell if masked); row cap + j: frame pixel j of
// the strided grid (row-major), back-projected as
// ops/backproject.full_point_cloud, moved by pose_wc = (t, q) as
// x R[k,0] + y R[k,1] + z R[k,2] + t[k], written with its colour.  The
// least cell of the live rows (cmin) and the least and largest of the
// live frame pixels: warp reductions, then the block's partials; the
// frame sort's bucket counts zeroed.
__device__ void phase_points(const FuseParams& p, const Smem& s)
{
    const int n = p.cap + p.F, S = gridDim.x * blockDim.x;
    float R[9];
    quat_to_mat(p.pose + 3, R);
    // least over all rows [0, 3), least [3, 6) and largest [6, 9) over the
    // frame's
    int m[9];
    for (int k = 0; k < 6; ++k) m[k] = 0x7fffffff;
    for (int k = 6; k < 9; ++k) m[k] = (int)0x80000000;
    // DF_ROWS rows a thread at once, S apart: the map rows' masks and
    // points (live or not: one round trip), loads all in flight together
    for (int i0 = blockIdx.x * blockDim.x + threadIdx.x; i0 < n;
         i0 += DF_ROWS * S) {
        bool live[DF_ROWS];
        float q[DF_ROWS][3];
#pragma unroll
        for (int g = 0; g < DF_ROWS; ++g) {
            const int i = i0 + g * S;
            live[g] = false;
            if (i < p.cap) {
                live[g] = p.mask[i] != 0;
                for (int k = 0; k < 3; ++k) q[g][k] = p.pts[3 * i + k];
            }
        }
#pragma unroll
        for (int g = 0; g < DF_ROWS; ++g) {
            const int i = i0 + g * S;
            if (i >= p.cap && i < n) {
                const int j = i - p.cap;
                const int r = j / p.ws, c = j - r * p.ws;
                const int py = r * p.stride, px = c * p.stride;
                const float z = (float)p.depth[py * p.width + px] / p.scale;
                const float x = ((float)px - p.cx) * z / p.fx;
                const float y = ((float)py - p.cy) * z / p.fy;
                live[g] = (z > 1e-6f) && (z <= p.depth_range);
                for (int k = 0; k < 3; ++k) {
                    const float w = x * R[3 * k] + y * R[3 * k + 1]
                                  + z * R[3 * k + 2] + p.pose[k];
                    q[g][k] = w;
                    p.pts[3 * i + k] = w;
                    p.col[3 * i + k] = p.rgb != nullptr
                        ? p.rgb[3 * (py * p.width + px) + k] : 0.0f;
                }
                p.mask[i] = live[g] ? 1 : 0;
            }
            if (live[g]) {
                for (int k = 0; k < 3; ++k) {
                    const int c = cell_of(q[g][k], p.leaf);
                    m[k] = min(m[k], c);
                    if (i >= p.cap) {
                        m[3 + k] = min(m[3 + k], c);
                        m[6 + k] = max(m[6 + k], c);
                    }
                }
            }
        }
    }
    int* part = s.wrun;         // [warps, 9]
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int k = 0; k < 9; ++k) {
        const int v = k < 6 ? __reduce_min_sync(0xffffffffu, m[k])
                            : __reduce_max_sync(0xffffffffu, m[k]);
        if (lane == 0) part[warp * 9 + k] = v;
    }
    __syncthreads();
    if (threadIdx.x < 9) {
        const int k = threadIdx.x;
        int v = part[k];
        for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
            v = k < 6 ? min(v, part[w * 9 + k]) : max(v, part[w * 9 + k]);
        p.part[blockIdx.x * DF_PART + k] = v;
    }
    for (int b = blockIdx.x * blockDim.x + threadIdx.x; b < DF_NBUCK;
         b += gridDim.x * blockDim.x)
        p.bcount[b] = 0;
}

// The grid's values [k0, k1) from the blocks' partials, into val (every
// block the same): least for the cells' minima, largest for the maxima,
// sums for the counts; thread t reads block t's.  With seams, also the
// descents where phase (2) left a pair of rows to two blocks (rows
// k blockDim - 1 and k blockDim), their loads beside the partials'; true
// where it found one.
template <int k0, int k1, bool seams>
__device__ bool gather(const FuseParams& p, const Smem& s)
{
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int v[k1 - k0];
#pragma unroll
    for (int k = k0; k < k1; ++k) {
        const int none = k < DF_FMAX ? 0x7fffffff
            : (k < DF_DESC ? (int)0x80000000 : 0);
        v[k - k0] = threadIdx.x < gridDim.x
            ? __ldcg(p.part + threadIdx.x * DF_PART + k) : none;
    }
    bool desc = false;
    if (seams)
        for (int r = (threadIdx.x + 1) * blockDim.x; r < p.cap;
             r += blockDim.x * blockDim.x)
            desc = desc || __ldcg(p.keys + r - 1) > __ldcg(p.keys + r);
#pragma unroll
    for (int k = k0; k < k1; ++k) {
        int x = v[k - k0];
        x = k < DF_FMAX ? __reduce_min_sync(0xffffffffu, x)
            : (k < DF_DESC ? __reduce_max_sync(0xffffffffu, x)
                           : __reduce_add_sync(0xffffffffu, x));
        if (lane == 0) s.wrun[warp * DF_PART + k] = x;
    }
    __syncthreads();
    if (threadIdx.x >= k0 && threadIdx.x < k1) {
        const int k = threadIdx.x;
        int x = s.wrun[k];
        for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
            const int y = s.wrun[w * DF_PART + k];
            x = k < DF_FMAX ? min(x, y) : (k < DF_DESC ? max(x, y) : x + y);
        }
        s.val[k] = x;
    }
    return __syncthreads_or(desc);
}

// The frame's buckets: DF_NBUCK contiguous ranges of the compact key
// (x * ny + y) * nz + z of a live frame pixel's cell (x, y, z) less the
// frame's least cell, (nx, ny, nz) the frame's extent.  While no cell
// clips, keys order cells as compact keys do (both lexicographic).
struct Buckets {
    int lo[3];                  // the frame's least cell less cmin
    int ny, nz;
    unsigned long long mul;     // 2^44 / (nx * ny * nz): compact keys
                                // (< nx ny nz) times it stay under 2^44
    __device__ __forceinline__ int compact(int key) const
    {
        const int x = ((key >> 20) & 1023) - lo[0];
        const int y = ((key >> 10) & 1023) - lo[1];
        return (x * ny + y) * nz + (key & 1023) - lo[2];
    }
    __device__ __forceinline__ int bucket(int key) const
    {
        return (int)(((unsigned long long)compact(key) * mul) >> 32);
    }
};

// False where the frame has no live pixel or one of its cells clips.
__device__ bool frame_buckets(const Smem& s, Buckets* g)
{
    int ext[3];
    for (int k = 0; k < 3; ++k) {
        const int lo = s.val[DF_FMIN + k];
        if (lo == 0x7fffffff) return false;
        ext[k] = s.val[DF_FMAX + k] - lo;
        g->lo[k] = lo - s.val[DF_CMIN + k];
        if (ext[k] > 1023 || g->lo[k] > 1023) return false;
    }
    g->ny = ext[1] + 1;
    g->nz = ext[2] + 1;
    g->mul = (1ull << 44) / ((unsigned long long)(ext[0] + 1) * g->ny * g->nz);
    return true;
}

// The key of a live row at q (JAX's clip to 0..1023 an axis, 10 bits
// each); *clipped where an axis clipped.
__device__ __forceinline__ int key_at(const float* q, float leaf,
                                      const int* cmin, bool* clipped)
{
    int key = 0;
    for (int k = 0; k < 3; ++k) {
        int c = cell_of(q[k], leaf) - cmin[k];
        *clipped = *clipped || c < 0 || c > 1023;
        c = c < 0 ? 0 : (c > 1023 ? 1023 : c);
        key = (key << 10) | c;
    }
    return key;
}

// The same rows as phase_points a thread (it reads back the frame rows it
// wrote there), DF_ROWS at once; the descent test compares a row's key
// with the next lane's, lane 31 with the next warp's first (the block's
// last row with the next block's first: gather, after the barrier); each
// live frame pixel counted in its bucket.
__device__ void phase_keys(const FuseParams& p, const Smem& s)
{
    const int n = p.cap + p.F, S = gridDim.x * blockDim.x;
    int cmin[3];
    for (int k = 0; k < 3; ++k) cmin[k] = s.val[DF_CMIN + k];
    Buckets geo;
    const bool buckets = frame_buckets(s, &geo);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    const unsigned below = (1u << lane) - 1u;
    int* first = s.wrun + DF_WARPS * DF_PART;   // [DF_ROWS, DF_WARPS]
    int na = 0, nb = 0;
    bool desc = false, fclip = false;
    for (int b0 = blockIdx.x * blockDim.x; b0 < n; b0 += DF_ROWS * S) {
        bool live[DF_ROWS];
        float q[DF_ROWS][3];
        int key[DF_ROWS];
#pragma unroll
        for (int g = 0; g < DF_ROWS; ++g) {
            const int i = b0 + g * S + threadIdx.x;
            live[g] = false;
            if (i < n) {        // mask and point in one round trip
                live[g] = p.mask[i] != 0;
                for (int k = 0; k < 3; ++k) q[g][k] = p.pts[3 * i + k];
            }
        }
#pragma unroll
        for (int g = 0; g < DF_ROWS; ++g) {
            const int i = b0 + g * S + threadIdx.x;
            bool clipped = false;
            key[g] = live[g] ? key_at(q[g], p.leaf, cmin, &clipped)
                             : OSLAM_BIG;
            int b = -1;         // a live frame pixel's bucket
            if (i < n) {
                p.keys[i] = key[g];
                if (key[g] != OSLAM_BIG) {
                    if (i < p.cap) {
                        ++na;
                    } else {
                        ++nb;
                        fclip = fclip || clipped;
                        if (buckets && !clipped) b = geo.bucket(key[g]);
                    }
                }
            }
            // the pixel's place in its bucket: the lanes of one bucket
            // take one atomic
            if (__any_sync(0xffffffffu, b >= 0)) {
                const unsigned grp = __match_any_sync(0xffffffffu, b);
                const int lead = __ffs(grp) - 1;
                int start = 0;
                if (b >= 0 && lane == lead)
                    start = atomicAdd(&p.bcount[b], __popc(grp));
                start = __shfl_sync(0xffffffffu, start, lead);
                if (b >= 0) p.rk[i - p.cap] = start + __popc(grp & below);
            }
            if (lane == 0) first[g * DF_WARPS + warp] = key[g];
        }
        __syncthreads();
#pragma unroll
        for (int g = 0; g < DF_ROWS; ++g) {
            const int i = b0 + g * S + threadIdx.x;
            int next = __shfl_down_sync(0xffffffffu, key[g], 1);
            if (lane == 31)
                next = warp + 1 < nw ? first[g * DF_WARPS + warp + 1]
                                     : key[g];
            if (i + 1 < p.cap && key[g] > next) desc = true;
        }
        __syncthreads();
    }
    const bool any = __syncthreads_or(desc);
    const bool any_clip = __syncthreads_or(fclip);
    na = block_sum(na, s.red);
    nb = block_sum(nb, s.red);
    if (threadIdx.x == 0) {
        int* mine = p.part + blockIdx.x * DF_PART;
        mine[DF_DESC] = any ? 1 : 0;
        mine[DF_FCLIP] = any_clip ? 1 : 0;
        mine[DF_NA] = na;
        mine[DF_NB] = nb;
    }
}

// ---------------------------------------------------------------------------
// (3) stable LSD radix passes, 8 bits each
// ---------------------------------------------------------------------------

// A pass's input element i: its key and id, false for a dropped (masked)
// one.  First passes read the keys array (ids are positions); later ones
// the previous pass's output.
struct SrcKeys {
    const int* keys;
    __device__ __forceinline__ bool get(int i, int& k, int& v) const
    {
        k = __ldcg(keys + i);
        v = i;
        return k != OSLAM_BIG;
    }
};
struct SrcBuf {
    const int* sk;
    const int* sv;
    __device__ __forceinline__ bool get(int i, int& k, int& v) const
    {
        k = __ldcg(sk + i);
        v = __ldcg(sv + i);
        return true;
    }
};
struct DstBuf {
    int* sk;
    int* sv;
    __device__ __forceinline__ void put(int pos, int k, int v) const
    {
        sk[pos] = k;
        sv[pos] = v;
    }
};

// The block's elements [lo, hi) in runs of `per`, one a warp, in order.
__device__ __forceinline__ int warp_share(int lo, int hi)
{
    const int nw = blockDim.x >> 5;
    return (hi - lo + nw - 1) / nw;
}

// Each warp walks its run 32 elements at a time, in order: the lanes of one
// digit (match_any) take consecutive ranks from the warp's running count
// of that digit, lower lanes first, so equal digits keep their order (a
// stable pass); rk[i] the element's rank among its warp's elements of its
// digit.  Then, per digit, the warps' exclusive starts in wrun (a scan over
// the warps) and the block's count in dig.
template <class Src>
__device__ void warp_ranks(const Src& src, int lo, int hi, int shift,
                           const Smem& s, int* rk)
{
    const int nw = blockDim.x >> 5, lane = threadIdx.x & 31;
    const unsigned below = (1u << lane) - 1u;
    for (int j = threadIdx.x; j < nw * DF_DIGITS; j += blockDim.x)
        s.wrun[j] = 0;
    __syncthreads();
    const int per = warp_share(lo, hi);
    const int w0 = min(hi, lo + (int)(threadIdx.x >> 5) * per);
    const int w1 = min(hi, w0 + per);
    int* run = s.wrun + (threadIdx.x >> 5) * DF_DIGITS;
    for (int base = w0; base < w1; base += 32) {
        const int i = base + lane;
        int k = 0, v = 0;
        const bool ok = i < w1 && src.get(i, k, v);
        const int d = ok ? (k >> shift) & 255 : DF_DIGITS;
        const unsigned grp = __match_any_sync(0xffffffffu, d);
        const int lead = __ffs(grp) - 1;
        int start = 0;
        if (ok && lane == lead) {
            start = run[d];
            run[d] = start + __popc(grp);
        }
        start = __shfl_sync(0xffffffffu, start, lead);
        if (ok) rk[i] = start + __popc(grp & below);
        __syncwarp();
    }
    __syncthreads();
    for (int d = threadIdx.x; d < DF_DIGITS; d += blockDim.x) {
        int sum = 0;
        for (int w = 0; w < nw; ++w) {
            const int c = s.wrun[w * DF_DIGITS + d];
            s.wrun[w * DF_DIGITS + d] = sum;
            sum += c;
        }
        s.dig[d] = sum;
    }
    __syncthreads();
}

// Each element to its place: its digit's start (dig), its warp's start
// among that digit (wrun), its rank in the warp; all threads, in parallel.
template <class Src>
__device__ void rank_scatter(const Src& src, const DstBuf& dst, int lo,
                             int hi, int shift, const Smem& s, const int* rk)
{
    const int per = warp_share(lo, hi);
    for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
        int k, v;
        if (!src.get(i, k, v)) continue;
        const int d = (k >> shift) & 255;
        dst.put(s.wrun[(i - lo) / per * DF_DIGITS + d] + s.dig[d] + rk[i], k,
                v);
    }
}

// The scatter through shared memory, where the block's chunk fits: each
// element first to its place among the block's elements in digit order
// (bnd: the block's digit starts), then, neighbours on neighbours, to its
// place in dst (a run of one digit goes to consecutive places), so the
// writes to device memory coalesce.
template <class Src>
__device__ void stage_scatter(const Src& src, const DstBuf& dst, int lo,
                              int hi, int shift, const Smem& s, const int* rk)
{
    int* sk = s.fk;             // [DF_STAGE_MAX]
    int* sv = s.fk + (hi - lo);
    const int per = warp_share(lo, hi);
    int kept = 0;
    for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
        int k, v;
        if (!src.get(i, k, v)) continue;
        const int d = (k >> shift) & 255;
        const int at = s.bnd[d] + s.wrun[(i - lo) / per * DF_DIGITS + d]
            + rk[i];
        sk[at] = k;
        sv[at] = v;
        ++kept;
    }
    kept = block_sum(kept, s.red);
    for (int at = threadIdx.x; at < kept; at += blockDim.x) {
        const int k = sk[at], d = (k >> shift) & 255;
        dst.put(s.dig[d] + at - s.bnd[d], k, sv[at]);
    }
}

// In place: a[d] -> the sum of a[d'] for d' < d; returns the sum of all.
__device__ int digits_exclusive_scan(int* a, int* red)
{
    int carry = 0;
    for (int d0 = 0; d0 < DF_DIGITS; d0 += blockDim.x) {
        const int d = d0 + threadIdx.x;
        const int v = d < DF_DIGITS ? a[d] : 0;
        int total;
        const int ex = block_exclusive_scan(v, &total, red);
        if (d < DF_DIGITS) a[d] = carry + ex;
        carry += total;
    }
    __syncthreads();
    return carry;
}

// dig[d] the grid's count of digit d, dig2[d] the blocks' before this one,
// from hist: every thread sums a share of the blocks for one digit, eight
// loads in flight at a time.
__device__ void grid_digit_counts(const FuseParams& p, const Smem& s)
{
    const int G = gridDim.x, b = blockIdx.x;
    const int parts = blockDim.x >= 4 * DF_DIGITS ? 4
        : (blockDim.x >= DF_DIGITS ? (int)blockDim.x / DF_DIGITS : 1);
    for (int t = threadIdx.x; t < parts * DF_DIGITS; t += blockDim.x) {
        const int d = t % DF_DIGITS, q = t / DF_DIGITS;
        int all = 0, before = 0;
        for (int c0 = q * 8; c0 < G; c0 += parts * 8) {
            int h[8];
#pragma unroll
            for (int u = 0; u < 8; ++u)
                h[u] = c0 + u < G ? __ldcg(p.hist + (c0 + u) * DF_DIGITS + d)
                                  : 0;
#pragma unroll
            for (int u = 0; u < 8; ++u) {
                all += h[u];
                before += c0 + u < b ? h[u] : 0;
            }
        }
        s.part[t] = all;
        s.part[parts * DF_DIGITS + t] = before;
    }
    __syncthreads();
    for (int d = threadIdx.x; d < DF_DIGITS; d += blockDim.x) {
        int all = 0, before = 0;
        for (int q = 0; q < parts; ++q) {
            all += s.part[q * DF_DIGITS + d];
            before += s.part[(parts + q) * DF_DIGITS + d];
        }
        s.dig[d] = all;
        s.dig2[d] = before;
    }
    __syncthreads();
}

// One pass over [0, len) by every block, a contiguous chunk each, a
// block's digit-d elements after every smaller digit's and after the
// earlier blocks' digit-d ones (the counts through hist).  Returns the
// elements kept.
template <class Src>
__device__ int radix_pass(const Src& src, const DstBuf& dst, int len,
                          int shift, const FuseParams& p, const Smem& s)
{
    const int chunk = (len + gridDim.x - 1) / gridDim.x;
    const int lo = min(len, (int)blockIdx.x * chunk);
    const int hi = min(len, lo + chunk);
    warp_ranks(src, lo, hi, shift, s, p.rk);
    DF_STEP();
    for (int d = threadIdx.x; d < DF_DIGITS; d += blockDim.x) {
        p.hist[blockIdx.x * DF_DIGITS + d] = s.dig[d];
        s.bnd[d] = s.dig[d];
    }
    cg::this_grid().sync();
    DF_STEP();
    grid_digit_counts(p, s);
    DF_STEP();
    const int total = digits_exclusive_scan(s.dig, s.red);
    for (int d = threadIdx.x; d < DF_DIGITS; d += blockDim.x)
        s.dig[d] += s.dig2[d];
    __syncthreads();
    digits_exclusive_scan(s.bnd, s.red);
    DF_STEP();
    if (hi - lo <= DF_STAGE_MAX)
        stage_scatter(src, dst, lo, hi, shift, s, p.rk);
    else
        rank_scatter(src, dst, lo, hi, shift, s, p.rk);
    DF_STEP();
    cg::this_grid().sync();
    DF_STEP();
    return total;
}

// The live keys among keys[0, len), sorted stably into sk[1] / sv[1] (ids
// are positions in keys[]) by every block; returns their count.
__device__ int grid_sort(const int* keys, int len, const FuseParams& p,
                         const Smem& s)
{
    const DstBuf b0{p.sk[0], p.sv[0]}, b1{p.sk[1], p.sv[1]};
    const int n = radix_pass(SrcKeys{keys}, b0, len, 0, p, s);
    radix_pass(SrcBuf{p.sk[0], p.sv[0]}, b1, n, 8, p, s);
    radix_pass(SrcBuf{p.sk[1], p.sv[1]}, b0, n, 16, p, s);
    radix_pass(SrcBuf{p.sk[0], p.sv[0]}, b1, n, 24, p, s);
    return n;
}

// (key, pixel) pairs compared: a frame's order (a stable sort by key).
__device__ __forceinline__ bool before_pair(int ka, int va, int kb, int vb)
{
    return ka < kb || (ka == kb && va < vb);
}

// A bucket of n <= 64 pairs at sk[0] / sv[0] + o, sorted by (key, pixel)
// into sk[1] / sv[1] + o by one warp: the pairs in the warp's slice of
// shared memory (w: 128 ints), each ranked against all.
__device__ void warp_sort_bucket(const FuseParams& p, int* w, int o, int n)
{
    const int lane = threadIdx.x & 31;
    for (int e = lane; e < n; e += 32) {
        w[e] = __ldcg(p.sk[0] + o + e);
        w[64 + e] = __ldcg(p.sv[0] + o + e);
    }
    __syncwarp();
    for (int e = lane; e < n; e += 32) {
        const int k = w[e], v = w[64 + e];
        int r = 0;
        for (int j = 0; j < n; ++j)
            r += before_pair(w[j], w[64 + j], k, v) ? 1 : 0;
        p.sk[1][o + r] = k;
        p.sv[1][o + r] = v;
    }
    __syncwarp();
}

// A bucket of 64 < n <= 1024 pairs by the block: the pairs in shared
// memory, each ranked against all.
__device__ void block_rank_bucket(const FuseParams& p, const Smem& s, int o,
                                  int n)
{
    int* bk = s.fk;
    int* bv = s.fk + 1024;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        bk[i] = __ldcg(p.sk[0] + o + i);
        bv[i] = __ldcg(p.sv[0] + o + i);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int k = bk[i], v = bv[i];
        int r = 0;
        for (int j = 0; j < n; ++j)
            r += before_pair(bk[j], bv[j], k, v) ? 1 : 0;
        p.sk[1][o + r] = k;
        p.sv[1][o + r] = v;
    }
    __syncthreads();
}

// The fast path's frame sort, where every bucket holds at most 1024
// pixels (false, before any write, where one holds more: every block
// reads the
// same counts, so all return alike): (b) each live pixel into its bucket
// (a contiguous range of keys; the buckets' starts by a scan of their
// counts, which every block makes for itself; a pixel's place within its
// bucket the old value of phase (2)'s atomic, in any order), then (c) each
// bucket sorted by (key, pixel), the stable order: by a warp, or by the
// block where it holds more than 64.  The sorted frame in sk[1] / sv[1].
__device__ bool bucket_sort(const FuseParams& p, const Smem& s,
                            const Buckets& geo)
{
    DF_MARK(14);
    int* off = s.fk;            // [DF_NBUCK + 1]
    int most = 0;
    for (int b = threadIdx.x; b < DF_NBUCK; b += blockDim.x) {
        off[b] = __ldcg(p.bcount + b);
        most = max(most, off[b]);
    }
    if (-block_min(-most, s.red) > 1024) return false;
    DF_MARK(15);
    // a run of `per` counts a thread, one scan over the runs
    const int per = (DF_NBUCK + blockDim.x - 1) / blockDim.x;
    const int b0 = threadIdx.x * per, b1 = min(DF_NBUCK, b0 + per);
    int run = 0;
    for (int b = b0; b < b1; ++b) run += off[b];
    int total;
    run = block_exclusive_scan(run, &total, s.red);
    for (int b = b0; b < b1; ++b) {
        const int c = off[b];
        off[b] = run;
        run += c;
    }
    if (threadIdx.x == 0) off[DF_NBUCK] = total;
    __syncthreads();
    DF_MARK(5);
    for (int b = blockIdx.x * blockDim.x + threadIdx.x; b <= DF_NBUCK;
         b += gridDim.x * blockDim.x)
        p.boff[b] = off[b];
    for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < p.F;
         j += gridDim.x * blockDim.x) {
        const int k = __ldcg(p.keys + p.cap + j);
        if (k == OSLAM_BIG) continue;
        const int pos = off[geo.bucket(k)] + __ldcg(p.rk + j);
        p.sk[0][pos] = k;
        p.sv[0][pos] = j;
    }
    DF_MARK(6);
    cg::this_grid().sync();
    DF_MARK(7);
    DF_STEP();
    // this block's buckets, blockIdx + G t, DF_BND at a time: their bounds
    // in shared memory, then the small ones a warp each, then the others
    const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
    const int mine = (DF_NBUCK - (int)blockIdx.x + gridDim.x - 1) / gridDim.x;
    for (int t0 = 0; t0 < mine; t0 += DF_BND) {
        const int m = min(DF_BND, mine - t0);
        for (int t = threadIdx.x; t < m; t += blockDim.x) {
            const int b = blockIdx.x + (t0 + t) * gridDim.x;
            const int o = __ldcg(p.boff + b);
            s.bnd[t] = o;
            s.bnd[DF_BND + t] = __ldcg(p.boff + b + 1) - o;
        }
        __syncthreads();
        for (int t = warp; t < m; t += nw) {
            const int n = s.bnd[DF_BND + t];
            if (n > 0 && n <= 64)
                warp_sort_bucket(p, s.wrun + warp * 128, s.bnd[t], n);
        }
        __syncthreads();        // the warps' slices are read until here
        for (int t = 0; t < m; ++t) {
            const int o = s.bnd[t], n = s.bnd[DF_BND + t];
            if (n > 64) block_rank_bucket(p, s, o, n);
        }
        __syncthreads();        // bnd is read until here
    }
    DF_STEP();
    DF_MARK(8);
    cg::this_grid().sync();
    return true;
}

// ---------------------------------------------------------------------------
// (4) merge tiles and (5) segment sums
// ---------------------------------------------------------------------------
struct Merge {
    const int* ak;              // [na] non-decreasing
    const int* arow;            // [na] A's rows, or null: row = index
    int na;
    const int* bk;              // [nb] non-decreasing
    const int* bid;             // [nb] B's frame pixels: row cap + id
    int nb;
};

// The merge's tiles: as many as the blocks or a multiple of them, a block
// a contiguous run of them, a tile at most DF_PER elements a thread.
struct Tiles {
    int n, size, first, last;
};

__device__ __forceinline__ Tiles merge_tiles(int total)
{
    const int G = gridDim.x, most = DF_PER * blockDim.x;
    const int per_block = (total + G * most - 1) / (G * most);
    Tiles t;
    t.n = G * per_block;
    t.size = per_block > 0 ? (total + t.n - 1) / t.n : 1;
    t.first = blockIdx.x * per_block;
    t.last = t.first + per_block;
    return t;
}

// A tile [d0, d1) of the merge, its A window [ia0, ia1) and B window
// [ib0, ib1).
struct Tile {
    int d0, d1, ia0, ia1, ib0, ib1;
};

// ta[k] = A[ia0 - 1 + k] for k in [0, ia1 - ia0], tb likewise (-1 before
// the first element): the tile's windows with each one's predecessor; with
// ids, B's pixels beside tb.
__device__ void stage_tile(const Merge& m, const Tile& t, const Smem& s,
                           bool ids)
{
    for (int k = threadIdx.x; k <= t.ia1 - t.ia0; k += blockDim.x)
        s.ta[k] = t.ia0 + k > 0 ? __ldcg(m.ak + t.ia0 - 1 + k) : -1;
    for (int k = threadIdx.x; k <= t.ib1 - t.ib0; k += blockDim.x) {
        s.tb[k] = t.ib0 + k > 0 ? __ldcg(m.bk + t.ib0 - 1 + k) : -1;
        if (ids && t.ib0 + k > 0) s.tid[k] = __ldcg(m.bid + t.ib0 - 1 + k);
    }
    __syncthreads();
}

// Element l of the tile (the thread's l = threadIdx.x + e * blockDim.x):
// its split (a search in the staged windows), key, (ia, ib) merge pointers
// and whether it starts a segment (its key unlike the merged
// predecessor's, max(A[ia - 1], B[ib - 1])).
struct Elem {
    int key, ia, ib;
    bool a, start;              // an element of A; the first of a segment
};

__device__ __forceinline__ Elem tile_element(const Tile& t, int l,
                                             const Smem& s)
{
    Elem x = {OSLAM_BIG, 0, 0, false, false};
    if (t.d0 + l >= t.d1) return x;
    const int na = t.ia1 - t.ia0, nb = t.ib1 - t.ib0;
    int lo = max(0, l - nb), hi = min(l, na);
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s.ta[1 + mid] <= s.tb[l - mid]) lo = mid + 1;
        else hi = mid;
    }
    const int a = lo, b = l - lo;
    const bool take_a = a < na && (b >= nb || s.ta[1 + a] <= s.tb[1 + b]);
    x.key = take_a ? s.ta[1 + a] : s.tb[1 + b];
    x.a = take_a;
    x.ia = t.ia0 + a;
    x.ib = t.ib0 + b;
    x.start = x.key != max(s.ta[a], s.tb[b]);
    return x;
}

// The A elements among the first d merged ones (ties go to A): the least
// ia in [max(0, d - nb), min(d, na)] with A[ia] > B[d - 1 - ia].  For the
// block's tile boundaries d_k = min(total, k size), k in [first, last], up
// to DF_SPLITS at once: the threads in groups, a probe a thread a round,
// the count of true probes narrowing each range; into tile_ia[k].
#define DF_SPLITS 16
__device__ void merge_splits(const Merge& m, const Tiles& tl, int total,
                             const FuseParams& p, const Smem& s)
{
    int* lo = s.bnd;
    int* hi = s.bnd + DF_BND;
    int* cnt = s.dig;
    for (int k0 = tl.first; k0 <= tl.last; k0 += DF_SPLITS) {
        const int K = min(DF_SPLITS, tl.last + 1 - k0);
        const int per = blockDim.x / K;
        const int k = threadIdx.x / per, r = threadIdx.x - k * per;
        const int d = min(total, (k0 + min(k, K - 1)) * tl.size);
        if (threadIdx.x < K) {
            const int dk = min(total, (k0 + (int)threadIdx.x) * tl.size);
            lo[threadIdx.x] = max(0, dk - m.nb);
            hi[threadIdx.x] = min(dk, m.na);
            cnt[threadIdx.x] = 0;
        }
        __syncthreads();
        bool open = threadIdx.x < K && lo[threadIdx.x] < hi[threadIdx.x];
        while (__syncthreads_or(open)) {
            if (k < K) {
                const int L = lo[k], H = hi[k];
                const int step = (H - L + per - 1) / per;
                const int q = L + r * step;
                if (L < H && q < H
                    && __ldcg(m.ak + q) <= __ldcg(m.bk + d - 1 - q))
                    atomicAdd(&cnt[k], 1);
            }
            __syncthreads();
            if (threadIdx.x < K) {
                const int L = lo[threadIdx.x], H = hi[threadIdx.x];
                const int step = (H - L + per - 1) / per;
                const int c = cnt[threadIdx.x];
                if (c == 0) {   // probes 0..c-1 true, probe c false
                    hi[threadIdx.x] = L;
                } else {
                    lo[threadIdx.x] = L + (c - 1) * step + 1;
                    hi[threadIdx.x] = min(H, L + c * step);
                }
                cnt[threadIdx.x] = 0;
                open = lo[threadIdx.x] < hi[threadIdx.x];
            }
        }
        if (threadIdx.x < K) p.tile_ia[k0 + threadIdx.x] = lo[threadIdx.x];
        __syncthreads();
    }
}

__device__ void phase_count(const Merge& m, const FuseParams& p,
                            const Smem& s)
{
    const int total = m.na + m.nb;
    const Tiles tl = merge_tiles(total);
    if (tl.first < tl.last) merge_splits(m, tl, total, p, s);
    for (int i = tl.first; i < tl.last; ++i) {
        Tile t;
        t.d0 = min(total, i * tl.size);
        t.d1 = min(total, t.d0 + tl.size);
        t.ia0 = p.tile_ia[i];
        t.ia1 = p.tile_ia[i + 1];
        DF_STEP();
        t.ib0 = t.d0 - t.ia0;
        t.ib1 = t.d1 - t.ia1;
        stage_tile(m, t, s, false);
        DF_STEP();
        int starts = 0;
        for (int l = threadIdx.x; l < t.d1 - t.d0; l += blockDim.x)
            starts += tile_element(t, l, s).start ? 1 : 0;
        const int c = block_sum(starts, s.red);
        if (threadIdx.x == 0) p.tile_cnt[i] = c;
    }
}

// A row's point and colour added to a segment's sums (the rows go through
// L1: the map's are this launch's input, and a frame row, written in phase
// (1), was read since only by its own writer).
__device__ __forceinline__ void add_row(const FuseParams& p, int r, float* sp,
                                        float* sc)
{
    for (int k = 0; k < 3; ++k) {
        sp[k] = sp[k] + p.pts[3 * r + k];
        sc[k] = sc[k] + p.col[3 * r + k];
    }
}

// The means of the segment that starts at tile element l: its rows summed
// in merged order from the tile's staged rows (A's, then B's) and, where
// the segment runs on past the tile, from device memory (A from ia, B from
// ib on, while the keys match); into mp[3] (point) and mc[3] (colour).
__device__ void segment_means(const Merge& m, const FuseParams& p,
                              const Tile& t, const Smem& s, int l, int size,
                              float* mp, float* mc)
{
    const int tm = DF_PER * blockDim.x, key = s.rkey[l];
    float sp[3] = {0.0f, 0.0f, 0.0f}, sc[3] = {0.0f, 0.0f, 0.0f};
    float c = 0.0f;
    int j = l, na = 0;
    for (; j < size && s.rkey[j] == key; ++j) {
        for (int k = 0; k < 3; ++k) {
            sp[k] = sp[k] + s.rval[k * tm + j];
            sc[k] = sc[k] + s.rval[(3 + k) * tm + j];
        }
        na += s.rkind[j];
        c = c + 1.0f;
    }
    if (j == size) {
        const Elem x = tile_element(t, l, s);
        for (int a = x.ia + na; a < m.na; ++a) {
            if (__ldcg(m.ak + a) != key) break;
            add_row(p, m.arow != nullptr ? __ldcg(m.arow + a) : a, sp, sc);
            c = c + 1.0f;
        }
        for (int b = x.ib + (j - l - na); b < m.nb; ++b) {
            if (__ldcg(m.bk + b) != key) break;
            add_row(p, p.cap + __ldcg(m.bid + b), sp, sc);
            c = c + 1.0f;
        }
    }
    for (int k = 0; k < 3; ++k) {
        mp[k] = sp[k] / c;
        mc[k] = sc[k] / c;
    }
}

// A tile's rows are read into shared memory at once, all threads together
// (element l by thread l % blockDim); the thread of a segment's first
// element then takes its means (segment_means), and a round's means go to
// out rows `rank` on through shared memory, so that the writes are whole
// sectors; segments at or past `capacity` are dropped.
__device__ void phase_sums(const Merge& m, const FuseParams& p, const Smem& s,
                           int path)
{
    const int total = m.na + m.nb, T = blockDim.x;
    const Tiles tl = merge_tiles(total);
    int before = 0, all = 0;
    for (int i = threadIdx.x; i < tl.n; i += T) {
        const int c = __ldcg(p.tile_cnt + i);
        all += c;
        before += i < tl.first ? c : 0;
    }
    before = block_sum(before, s.red);
    all = block_sum(all, s.red);
    DF_STEP();
    const int tm = DF_PER * T;
    for (int i = tl.first; i < tl.last; ++i) {
        Tile t;
        t.d0 = min(total, i * tl.size);
        t.d1 = min(total, t.d0 + tl.size);
        t.ia0 = __ldcg(p.tile_ia + i);
        t.ia1 = __ldcg(p.tile_ia + i + 1);
        t.ib0 = t.d0 - t.ia0;
        t.ib1 = t.d1 - t.ia1;
        const int size = t.d1 - t.d0;
        stage_tile(m, t, s, true);
        unsigned starts = 0;    // bit e: element threadIdx + e T starts
        for (int e = 0; e < DF_PER; ++e) {
            const int l = threadIdx.x + e * T;
            if (l >= size) break;
            const Elem x = tile_element(t, l, s);
            starts |= (x.start ? 1u : 0u) << e;
            s.rkey[l] = x.key;
            s.rkind[l] = x.a ? 1 : 0;
            const int r = x.a
                ? (m.arow != nullptr ? __ldcg(m.arow + x.ia) : x.ia)
                : p.cap + s.tid[1 + x.ib - t.ib0];
            for (int k = 0; k < 3; ++k) {
                s.rval[k * tm + l] = p.pts[3 * r + k];
                s.rval[(3 + k) * tm + l] = p.col[3 * r + k];
            }
        }
        __syncthreads();
        for (int e = 0; e * T < size; ++e) {
            const int l = threadIdx.x + e * T;
            const bool start = (starts >> e) & 1;
            int count;
            const int rank = before
                + block_exclusive_scan(start ? 1 : 0, &count, s.red);
            if (start && rank < p.cap)
                segment_means(m, p, t, s, l, size,
                              s.rout + 3 * (rank - before),
                              s.rout + 3 * (T + rank - before));
            __syncthreads();
            const int rows = max(0, min(count, p.cap - before));
            for (int q = threadIdx.x; q < 3 * rows; q += T) {
                p.out_pts[3 * before + q] = s.rout[q];
                p.out_col[3 * before + q] = s.rout[3 * T + q];
            }
            for (int q = threadIdx.x; q < rows; q += T)
                p.out_mask[before + q] = 1;
            before += count;
        }
        __syncthreads();        // the tile's rows are read until here
        DF_STEP();
    }
    // rows past the new map that an older one left set (unset rows hold
    // zeros: every output and every loaded map keeps them so)
    for (int r = min(all, p.cap) + blockIdx.x * T + threadIdx.x;
         r < p.cap; r += gridDim.x * T) {
        if (p.out_mask[r]) {
            for (int k = 0; k < 3; ++k) {
                p.out_pts[3 * r + k] = 0.0f;
                p.out_col[3 * r + k] = 0.0f;
            }
            p.out_mask[r] = 0;
        }
    }
    DF_STEP();
    if (blockIdx.x == 0 && threadIdx.x == 0) p.tally[path] += 1;
}

__global__ void __launch_bounds__(DF_T, 1) dense_fuse_kernel(FuseParams p)
{
    extern __shared__ int4 df_smem[];
    int* base = (int*)df_smem;
    Smem s;
    s.red = base;
    s.val = base + 32;
    s.wrun = base + DF_RED;
    s.dig = s.wrun + DF_WARPS * DF_DIGITS;
    s.dig2 = s.dig + DF_DIGITS;
    s.bnd = s.dig2 + DF_DIGITS;
    s.fk = s.bnd + 2 * DF_BND;
    s.part = s.fk;
    s.ta = s.wrun;
    s.tb = s.ta + DF_PER * blockDim.x + 1;
    s.tid = s.tb + DF_PER * blockDim.x + 1;
    s.rkey = s.tid + DF_PER * blockDim.x + 1;
    s.rkind = s.rkey + DF_PER * blockDim.x;
    s.rval = (float*)(s.rkind + DF_PER * blockDim.x);
    s.rout = s.rval + 6 * DF_PER * blockDim.x;

    DF_CLOCK(0);
    DF_MARK(0);
    phase_points(p, s);
    DF_MARK(1);
    cg::this_grid().sync();
    DF_CLOCK(1);
    DF_MARK(2);
    gather<0, DF_DESC, false>(p, s);
    phase_keys(p, s);
    DF_MARK(3);
    cg::this_grid().sync();
    DF_CLOCK(2);
    DF_MARK(4);
    const bool across = gather<DF_DESC, DF_NB + 1, true>(p, s);
    const int general = s.val[DF_DESC] != 0 || across ? 1 : 0;
    const int na = s.val[DF_NA], nb = s.val[DF_NB];
    if (general) {
        grid_sort(p.keys, p.cap + p.F, p, s);
    } else {
        Buckets geo = {};
        frame_buckets(s, &geo);
        if (s.val[DF_FCLIP] != 0 || !bucket_sort(p, s, geo))
            grid_sort(p.keys + p.cap, p.F, p, s);
    }
    DF_CLOCK(3);
    const Merge m = general
        ? Merge{p.sk[1], p.sv[1], na + nb, p.sk[1], p.sv[1], 0}
        : Merge{p.keys, nullptr, na, p.sk[1], p.sv[1], nb};
    DF_MARK(9);
    phase_count(m, p, s);
    DF_MARK(10);
    cg::this_grid().sync();
    DF_CLOCK(4);
    DF_MARK(11);
    phase_sums(m, p, s, general);
    DF_MARK(12);
    DF_CLOCK(5);
#ifdef OSLAM_DF_CLOCKS
    if (blockIdx.x == 0 && threadIdx.x == 0) oslam_df_clock[6] = general;
#endif
}
// ---- CPU build: to here ----

// ---------------------------------------------------------------------------
// C interface
// ---------------------------------------------------------------------------
#ifdef OSLAM_DF_CLOCKS
extern "C" int oslam_df_clocks(void* host)
{
    return (int)cudaMemcpyFromSymbol(host, oslam_df_clock,
                                     sizeof(long long) * DF_CLOCKS);
}

extern "C" int oslam_df_block_marks(void* host)
{
    return (int)cudaMemcpyFromSymbol(host, oslam_df_blk,
                                     sizeof(long long) * DF_GRID_MAX * 16);
}
#endif

// pts / col [cap + F, 3] float32 and mask [cap + F] uint8 of the map's
// buffer: its rows in the prefix (read), the frame's written at the tail;
// out_pts / out_col / out_mask the other buffer (its prefix written);
// depth [H, W] int32, rgb [H, W, 3] float32 or null (zeros); pose [7]
// float32 Twc (t, quaternion x y z w); keys [cap + F] int32; scratch
// int32 of df_scratch_ints words (ops/dense_fuse.scratch_ints); tally [2]
// int32.  One cooperative launch of min(co-resident blocks,
// ceil((cap + F) / 4096)) blocks of 1024 threads.
extern "C" int oslam_dense_fuse(
    int cap, int height, int width, int stride, float fx, float fy,
    float cx, float cy, float scale, float depth_range, float leaf,
    const void* depth, const void* rgb, const void* pose, void* pts,
    void* col, void* mask, void* out_pts, void* out_col, void* out_mask,
    void* keys, void* scratch, long long scratch_ints, void* tally,
    void* stream)
{
    FuseParams p;
    if (df_setup(&p, cap, height, width, stride, fx, fy, cx, cy, scale,
                 depth_range, leaf, depth, rgb, pose, pts, col, mask,
                 out_pts, out_col, out_mask, keys, scratch, scratch_ints,
                 tally))
        return (int)cudaErrorInvalidValue;
    const int smem = DF_SMEM_BYTES;
    cudaError_t rc = cudaFuncSetAttribute(
        dense_fuse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return (int)rc;
    int dev = 0, sms = 0, per_sm = 0;
    rc = cudaGetDevice(&dev);
    if (rc == cudaSuccess)
        rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess)
        rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, dense_fuse_kernel, DF_T, smem);
    if (rc != cudaSuccess) return (int)rc;
    const long long n = (long long)cap + p.F;
    long long grid = (n + DF_T * DF_PER - 1) / (DF_T * DF_PER);
    if (grid > (long long)per_sm * sms) grid = (long long)per_sm * sms;
    if (grid > DF_GRID_MAX) grid = DF_GRID_MAX;
    if (grid > DF_T) grid = DF_T;       // gather: a block's partials a thread
    if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    void* args[] = {&p};
    return (int)cudaLaunchCooperativeKernel(
        (const void*)dense_fuse_kernel, dim3((unsigned)grid), dim3(DF_T),
        args, (size_t)smem, (cudaStream_t)stream);
}
