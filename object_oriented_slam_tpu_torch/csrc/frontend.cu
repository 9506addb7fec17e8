// Depth-frontend kernels for sm_90a: the per-frame extraction stages that
// the JAX package (object_oriented_slam_tpu/) left to XLA, written by hand.
//
//   depth_cloud          ops/depth_cloud.depth_cloud: stages (a)-(c) of an
//                        extraction call (back-projection, voxel keys, the
//                        stable key sort, voxel means, world transform,
//                        plane mask, centre estimate), all D detections of a
//                        frame in one launch
//   voxel_downsample     ops/voxel.voxel_downsample: keys, sort and means of
//                        the object downsample in one launch
//   cluster_components   ops/cluster.components_compacted: compaction and
//                        every round (pass + jumps) of a frame's
//                        propagation in one launch, a thread block cluster
//                        per detection
//   symmetry_search      frontend/symmetry.estimate_symmetry: the 9-plane
//                        symmetry search of stage (g), every initial plane
//                        with all its LM iterations, a block per
//                        (detection, initial plane), in one launch
//
// Built with -fmad=false and without fast math: every multiply, add and
// divide rounds on its own (IEEE), in the order the plain PyTorch versions
// (same module names under ops/) write them, so cells, masks and labels
// come out the same as on the CPU.  Plain C interface, bound with ctypes;
// every function launches on the given stream, does not synchronise,
// allocates nothing and returns cudaGetLastError().
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

namespace cg = cooperative_groups;

#define OSLAM_BIG (1 << 30)        // invalid key / "no neighbour" label
#define OSLAM_STRIDE 3             // bbox scan stride (PointCloudFilter.cpp:31-32)

extern "C" const char* oslam_fe_error_string(int rc) {
    return cudaGetErrorString((cudaError_t)rc);
}

// ---------------------------------------------------------------------------
// depth_cloud and voxel_downsample: a whole voxel downsample of a detection
// in one thread block cluster, from its points to its cell means.
// depth_cloud replaces the back-projection, the key and sort operations,
// the segment means with the world epilogue, center_estimate and the world
// transform of the centre (JAX: ops/backproject.py:28
// bbox_point_cloud, ops/voxel.py voxel_keys and _voxel_core,
// frontend/extractor.py:155-167); voxel_downsample replaces the same
// operations of the 0.1 m object downsample (JAX: frontend/extractor.py:204,
// ops/voxel.py voxel_downsample).
//
// Bound by bytes: the depth pixels under the boxes (or the input points),
// the centre samples and the outputs, each moved once, against a sort of a
// few thousand keys a detection.  What held the earlier single-step
// kernels (a launch per step, since deleted) back was what lay between them: every detection's whole (160 x 214) grid of
// points and masks written to device memory and read back by the keys, the
// sort and the means, the sort itself (a finished segmented sort over every
// lane, padding included), ~130 small eager operations, and in the
// segment means one thread walking a whole run of gathered points.
// Here a cluster of S blocks of OSLAM_DS_T threads takes one detection
// (grid S x D; S from the largest input the launch can hold, see ds_shape:
// 3 for a 640 x 480 image, 1 for an object cloud of 4,096 lanes).  The
// detection's points are spread over the S blocks in contiguous chunks and
// its working arrays live in their shared memory; the blocks meet through
// distributed shared memory at a cluster barrier between the steps:
//  (1) the live points in the plain version's order (for a box its strided
//      pixels row by row, g = i * gw + j restricted to the box: the stable
//      sort's tie order), compacted with one block scan a block (a thread
//      takes a contiguous run of at most 128 candidates and keeps their
//      flags in registers) and the blocks' counts in rank order, and the
//      least and greatest cell of each axis (floor(p / leaf), as
//      ops/voxel.voxel_cells);
//  (2) each live point's id written to its place in the compacted list
//      (position p lives in block p / pc, pc = ceil(live / S)), then beside
//      it, a point a thread, its 30-bit key: cell - least cell clamped to
//      [0, 1023] per axis as ops/voxel.voxel_keys packs them (clamp
//      collisions included);
//  (3) a stable LSD radix sort of (key, id) over the cells the cloud spans:
//      z, y and x in mixed radix, as many neighbouring axes a pass as fit
//      1024 digits (one pass for an object at 0.1 m, three at 1 cm; a pass
//      of one digit is skipped).  A pass gives each warp a contiguous run of
//      its block's chunk, counts digits per warp (the lanes of a digit found
//      by one ballot per digit bit; one shared-memory add per distinct digit
//      of 32 points; four groups of 32 loaded before they are counted),
//      turns the counts into offsets (column prefix over the warps, the
//      blocks before this one in rank order, then a block scan over the
//      digits' totals) and scatters to the owner of each new position, so
//      that equal digits keep their order;
//  (4) the points' data in sorted order (a box pixel's raw depth, an input
//      point's coordinates) beside the final list, and the segment starts,
//      by one block scan of "key differs from the one before" (the one
//      before a chunk's first is the previous block's last);
//  (5) the means, a segment a thread, dealt round-robin in rank order (every
//      lane of a warp has a run of its own, of a length known before the
//      walk), summed in sorted order from 0 (a run that crosses into the
//      next block's chunk reads on there): the plain version's index_add_
//      on the CPU, bit for bit.  The first `capacity` segments of the
//      detection are written, by rank.
// The chunks and the arithmetic do not depend on S, so neither do cells
// and sums.
//
// Sparse symmetry adds an attribute lane (JAX ops/voxel.py _voxel_core's
// attrs, :80-86): a value a point, staged in (4) beside the point's data and
// summed in (5) beside its coordinates, in the same order, divided by the
// same count.  depth_cloud<true> stages each pixel's depth-border flag
// (ops/filters.depth_border_mask: a jump above `jump` metres against one of
// its 4 neighbours, with indices wrapped across the image edge as jnp.roll
// has them, or a neighbour without depth), read from the depth image at the
// staging of a live point: no border map of the image is written.
// voxel_downsample<true> stages the attribute it is given.  Without the
// lane (the template's false) the code and the bits are those of the
// kernels before it.
// ---------------------------------------------------------------------------
#define OSLAM_DS_T 512              // threads of a downsample block
#define OSLAM_DS_W (OSLAM_DS_T / 32)
#define OSLAM_RADIX 1024            // values of one digit (an axis of a key)
#define OSLAM_DS_MAX_IDS 65535      // point ids are 16-bit
#define OSLAM_DS_RUN 128            // candidates a thread compacts, at most
#define OSLAM_DS_U 4                // groups of 32 a warp loads at once
#define OSLAM_DS_MAX_S 8            // blocks of a detection's cluster

static_assert(2 * OSLAM_DS_T == OSLAM_RADIX, "a thread scans two digits");
static_assert(OSLAM_DS_T * OSLAM_DS_RUN > OSLAM_DS_MAX_IDS,
              "a thread's run of candidates fits its flag words");

// A block's bookkeeping; the fields marked "read across" are read by the
// other blocks of the cluster through distributed shared memory.
struct DsShared {
    uint16_t cnt[OSLAM_DS_W * OSLAM_RADIX];  // per warp and digit
    int base[OSLAM_RADIX];      // per digit: its first position
    int btot[OSLAM_RADIX];      // per digit: its count here (read across)
    int warp_tmp[32];
    int total;
    int cmin[3], cmax[3];       // this block's cell range (read across)
    int live;                   // this block's live points (read across)
    int segs, first;            // its segment starts and the first of them
                                // (read across)
    int gmin[3], gmax[3];       // the detection's cell range
    int n, off;                 // the detection's live points; this block's first
    int n_seg, seg_off, end;    // the detection's segments; this block's
                                // first rank; where its last segment ends
    int any;                    // rank 0: a voxel survives the plane test
};

// The block's rank in its detection's cluster, the way to the other
// blocks' shared memory (the block's own through the local window) and the
// barrier between the steps: the cluster's, or the block's where the
// cluster is one block (a cluster barrier costs more).
struct Cl {
    cg::cluster_group g;
    int rank, S;
    template <class T>
    __device__ __forceinline__ T* at(T* p, int r) const
    {
        return r == rank ? p : (T*)g.map_shared_rank((void*)p, r);
    }
    __device__ __forceinline__ void sync() const
    {
        if (S == 1)
            __syncthreads();
        else
            g.sync();
    }
};

// Exclusive prefix of v over the block's threads in thread order; the sum
// lands in ws.total (valid until the next call's first barrier).
__device__ int block_scan(int v, DsShared& ws)
{
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int incl = v;
    for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += up;
    }
    if (lane == 31) ws.warp_tmp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        const int mine = lane < OSLAM_DS_W ? ws.warp_tmp[lane] : 0;
        int w_incl = mine;
        for (int o = 1; o < 32; o <<= 1) {
            const int up = __shfl_up_sync(0xffffffffu, w_incl, o);
            if (lane >= o) w_incl += up;
        }
        ws.warp_tmp[lane] = w_incl - mine;
        if (lane == 31) ws.total = w_incl;
    }
    __syncthreads();
    const int r = ws.warp_tmp[warp] + incl - v;
    __syncthreads();            // warp_tmp is rewritten by the next call
    return r;
}

__device__ __forceinline__ int warp_sum(int v)
{
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ int warp_min(int v)
{
    for (int o = 16; o > 0; o >>= 1)
        v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ int warp_max(int v)
{
    for (int o = 16; o > 0; o >>= 1)
        v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// The lanes of the warp whose digit equals this lane's, among the lanes
// with `real` set: one ballot per bit of the digits below nb (nbits of
// them), as a warp-level multisplit ranks keys.  (The first design used
// match_any; its radix passes took 60 % of a block's cycles.)
__device__ __forceinline__ unsigned digit_peers(int dig, bool real, int nbits)
{
    unsigned peers = __ballot_sync(0xffffffffu, real);
    for (int b = 0; b < nbits; ++b) {
        const bool bit = (dig >> b) & 1;
        const unsigned on = __ballot_sync(0xffffffffu, bit);
        peers &= bit ? on : ~on;
    }
    return peers;
}

// The digit of a key for a group of neighbouring axes in mixed radix: the
// axes' 10-bit fields (x, y, z) weighted by m = (m0, m1, m2), 0 for an axis
// outside the group; lexicographic in the group's fields.
__device__ __forceinline__ int mixed_digit(int key, int3 m)
{
    return ((key >> 20) & 1023) * m.x + ((key >> 10) & 1023) * m.y
           + (key & 1023) * m.z;
}

// A detection's working arrays in a block's dynamic shared memory, C
// elements each: the (key, id) list and its double buffer, and the sorted
// points' data (Src::Staged).
template <class Staged>
struct DsMem {
    int* key[2];
    uint16_t* id[2];
    Staged* stage;
};

template <class Staged>
__device__ __forceinline__ DsMem<Staged> ds_mem(char* smem, int C)
{
    DsMem<Staged> m;
    m.key[0] = reinterpret_cast<int*>(smem);
    m.key[1] = m.key[0] + C;
    m.stage = reinterpret_cast<Staged*>(m.key[1] + C);
    m.id[0] = reinterpret_cast<uint16_t*>(m.stage + C);
    m.id[1] = m.id[0] + C;
    return m;
}

// One stable counting pass of the list `in` (the len entries of this
// block's chunk, pc a block) into the other list by mixed_digit(., m);
// every digit is below nb <= 1024.  Two cluster barriers: after the digit
// counts are published, and after the scatter.
template <class Staged>
__device__ void radix_pass(const DsMem<Staged>& mem, int in, int len, int pc,
                           int3 m, int nb, DsShared& ws, const Cl& cl)
{
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const unsigned below = (1u << lane) - 1u;
    const int nbits = 32 - __clz(nb - 1);
    const int* kin = mem.key[in];
    const uint16_t* iin = mem.id[in];
    int* kout = mem.key[in ^ 1];
    uint16_t* iout = mem.id[in ^ 1];
    for (int k = tid; k < OSLAM_DS_W * OSLAM_RADIX; k += OSLAM_DS_T)
        if ((k & (OSLAM_RADIX - 1)) < nb) ws.cnt[k] = 0;
    __syncthreads();
    const int per = (len + OSLAM_DS_W - 1) / OSLAM_DS_W;
    const int lo = min(len, warp * per), hi = min(len, lo + per);
    uint16_t* mine = ws.cnt + warp * OSLAM_RADIX;
    for (int c0 = lo; c0 < hi; c0 += 32 * OSLAM_DS_U) {
        int dig[OSLAM_DS_U];
#pragma unroll
        for (int u = 0; u < OSLAM_DS_U; ++u) {
            const int c = c0 + 32 * u + lane;
            dig[u] = c < hi ? mixed_digit(kin[c], m) : 0;
        }
#pragma unroll
        for (int u = 0; u < OSLAM_DS_U; ++u) {
            const bool real = c0 + 32 * u + lane < hi;
            const unsigned peers = digit_peers(dig[u], real, nbits);
            if (real && (peers & below) == 0)
                mine[dig[u]] = (uint16_t)(mine[dig[u]] + __popc(peers));
            __syncwarp();
        }
    }
    __syncthreads();
    // per digit: the warps' offsets inside the block's share of the digit,
    // and that share
    for (int b = tid; b < OSLAM_RADIX; b += OSLAM_DS_T) {
        int run = 0;
        if (b < nb)
            for (int w = 0; w < OSLAM_DS_W; ++w) {
                const int v = ws.cnt[w * OSLAM_RADIX + b];
                ws.cnt[w * OSLAM_RADIX + b] = (uint16_t)run;
                run += v;
            }
        ws.btot[b] = run;
    }
    cl.sync();
    // digit b starts where the digits below it end, after the share of the
    // blocks before this one
    const int b0 = 2 * tid, b1 = 2 * tid + 1;
    int tot0 = 0, tot1 = 0, pre0 = 0, pre1 = 0;
    for (int r = 0; r < cl.S; ++r) {
        const int* bt = cl.at(ws.btot, r);
        const int v0 = bt[b0], v1 = bt[b1];
        tot0 += v0;
        tot1 += v1;
        if (r < cl.rank) {
            pre0 += v0;
            pre1 += v1;
        }
    }
    const int pre = block_scan(tot0 + tot1, ws);
    ws.base[b0] = pre + pre0;
    ws.base[b1] = pre + tot0 + pre1;
    __syncthreads();
    for (int c0 = lo; c0 < hi; c0 += 32 * OSLAM_DS_U) {
        int id[OSLAM_DS_U], key[OSLAM_DS_U], dig[OSLAM_DS_U];
#pragma unroll
        for (int u = 0; u < OSLAM_DS_U; ++u) {
            const int c = c0 + 32 * u + lane;
            id[u] = c < hi ? iin[c] : 0;
            key[u] = c < hi ? kin[c] : 0;
            dig[u] = mixed_digit(key[u], m);
        }
#pragma unroll
        for (int u = 0; u < OSLAM_DS_U; ++u) {
            const bool real = c0 + 32 * u + lane < hi;
            const unsigned peers = digit_peers(dig[u], real, nbits);
            if (real) {
                const int p = ws.base[dig[u]] + mine[dig[u]]
                              + __popc(peers & below);
                const int r = p / pc, k = p - r * pc;
                cl.at(kout, r)[k] = key[u];
                cl.at(iout, r)[k] = (uint16_t)id[u];
            }
            __syncwarp();
            if (real && (peers & below) == 0)
                mine[dig[u]] = (uint16_t)(mine[dig[u]] + __popc(peers));
            __syncwarp();
        }
    }
    cl.sync();
}

__device__ __forceinline__ int cell_of(float v, float leaf)
{
    return (int)floorf(v / leaf);
}

__device__ __forceinline__ int key_axis(int cell, int least)
{
    return min(max(cell - least, 0), 1023);
}

// A staged point with its attribute lane (4-byte aligned: the staged array
// starts 8 C bytes into a block's working arrays, C any count)
struct RawFlag {
    int raw, flag;
};
struct PointAttr {
    float x, y, z, a;
};

// The strided pixels of one detection's box as points: id p is the pixel
// (y1 + 3 (p / bw), x1 + 3 (p % bw)), row by row; the arithmetic of
// ops/backproject.bbox_point_cloud_plain.
// A sorted point keeps its raw depth and, with kBorder, its border flag.
template <bool kBorder>
struct BoxPixels {
    typedef typename std::conditional<kBorder, RawFlag, int>::type Staged;
    static constexpr bool kAttr = kBorder;
    const int* depth;
    int W, x1, y1, bw;
    float scale, fx, fy, cx, cy, depth_range;
    int H;
    float jump;                 // the border's depth jump (kBorder)
    __device__ __forceinline__ int pixel(int p) const
    {
        const int i = p / bw, j = p - i * bw;
        return (y1 + OSLAM_STRIDE * i) * W + x1 + OSLAM_STRIDE * j;
    }
    // filters.depth_border_mask at the point's pixel: z = raw / scale, valid
    // above 1e-6; the 4 neighbours' indices wrap across the image edge
    __device__ __forceinline__ int border(int p) const
    {
        const int i = p / bw, j = p - i * bw;
        const int px = x1 + OSLAM_STRIDE * j, py = y1 + OSLAM_STRIDE * i;
        const float z = (float)depth[py * W + px] / scale;
        const bool valid = z > 1e-6f;
        const int up = (py == 0 ? H - 1 : py - 1) * W + px;
        const int down = (py == H - 1 ? 0 : py + 1) * W + px;
        const int left = py * W + (px == 0 ? W - 1 : px - 1);
        const int right = py * W + (px == W - 1 ? 0 : px + 1);
        const int nb[4] = {up, down, left, right};
        bool b = false;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const float zn = (float)depth[nb[k]] / scale;
            const bool vn = zn > 1e-6f;
            b = b || (valid && vn && fabsf(z - zn) > jump) || (valid && !vn);
        }
        return b ? 1 : 0;
    }
    __device__ __forceinline__ Staged stage(int p) const
    {
        if constexpr (kBorder)
            return RawFlag{depth[pixel(p)], border(p)};
        else
            return depth[pixel(p)];
    }
    __device__ __forceinline__ void from_raw(int p, int raw, float& x,
                                             float& y, float& z) const
    {
        const int i = p / bw, j = p - i * bw;
        const int px = x1 + OSLAM_STRIDE * j, py = y1 + OSLAM_STRIDE * i;
        z = (float)raw / scale;
        x = ((float)px - cx) * z / fx;
        y = ((float)py - cy) * z / fy;
    }
    __device__ __forceinline__ void from_stage(int p, Staged s, float& x,
                                               float& y, float& z) const
    {
        if constexpr (kBorder)
            from_raw(p, s.raw, x, y, z);
        else
            from_raw(p, s, x, y, z);
    }
    __device__ __forceinline__ float attr(Staged s) const   // kBorder only
    {
        return (float)s.flag;
    }
    __device__ __forceinline__ bool point(int p, float& x, float& y,
                                          float& z) const
    {
        from_raw(p, depth[pixel(p)], x, y, z);
        return (z > 0.1f) && (z <= depth_range);
    }
};

// A detection's points [N, 3] and their mask [N] (with kAttr_, one f32
// attribute a point [N]); a sorted point keeps its coordinates and
// attribute.
template <bool kAttr_>
struct MaskedPoints {
    typedef typename std::conditional<kAttr_, PointAttr, float3>::type Staged;
    static constexpr bool kAttr = kAttr_;
    const float* pts;
    const uint8_t* mask;
    const float* attrs;
    __device__ __forceinline__ Staged stage(int i) const
    {
        if constexpr (kAttr_)
            return PointAttr{pts[3 * i], pts[3 * i + 1], pts[3 * i + 2],
                             attrs[i]};
        else
            return make_float3(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2]);
    }
    __device__ __forceinline__ void from_stage(int, Staged s, float& x,
                                               float& y, float& z) const
    {
        x = s.x;
        y = s.y;
        z = s.z;
    }
    __device__ __forceinline__ float attr(Staged s) const   // kAttr_ only
    {
        return s.a;
    }
    __device__ __forceinline__ bool point(int i, float& x, float& y,
                                          float& z) const
    {
        x = pts[3 * i];
        y = pts[3 * i + 1];
        z = pts[3 * i + 2];
        return mask[i] != 0;
    }
};

// Phase clocks of a downsample block (a build with -DOSLAM_DS_CLOCKS, for
// examples/torch_depth_cloud_phases.py): thread 0 of each block of the
// first 64 detections records clock64() at the phase boundaries.
#ifdef OSLAM_DS_CLOCKS
__device__ long long oslam_ds_clock[64][OSLAM_DS_MAX_S][8];
#define DS_CLOCK(i) \
    if (threadIdx.x == 0 && blockIdx.y < 64) \
        oslam_ds_clock[blockIdx.y][blockIdx.x][i] = clock64()
extern "C" int oslam_ds_clocks(void* host)
{
    return (int)cudaMemcpyFromSymbol(host, oslam_ds_clock,
                                     sizeof(oslam_ds_clock));
}
extern "C" int oslam_ds_clocks_clear()
{
    void* at = nullptr;
    cudaError_t rc = cudaGetSymbolAddress(&at, oslam_ds_clock);
    if (rc == cudaSuccess) rc = cudaMemset(at, 0, sizeof(oslam_ds_clock));
    return (int)rc;
}
#else
#define DS_CLOCK(i)
#endif

// The downsample of one detection's n_src candidate points, steps (1)-(5)
// above, by the cluster's blocks; sink(slot, mean x, y, z, cell x, y, z,
// live, mean attribute) writes each of the `capacity` output slots (slots
// past the segments with zeros and live = false; the attribute is 0 unless
// Src::kAttr).  Phase clocks 2-6.
template <class Src, class Sink>
__device__ void downsample_cluster(const Src& src, int n_src, float leaf,
                                   int capacity,
                                   const DsMem<typename Src::Staged>& mem,
                                   DsShared& ws, const Cl& cl, Sink& sink)
{
    const int tid = threadIdx.x, lane = tid & 31;
    const int S = cl.S, rank = cl.rank;
    if (tid < 3) {
        ws.cmin[tid] = OSLAM_BIG;
        ws.cmax[tid] = -OSLAM_BIG;
    }
    // (1) this block's chunk of the candidates, a contiguous run a thread,
    // their flags in registers, one block scan
    const int cc = (n_src + S - 1) / S;
    const int c_lo = min(n_src, rank * cc), c_hi = min(n_src, c_lo + cc);
    const int per = (c_hi - c_lo + OSLAM_DS_T - 1) / OSLAM_DS_T;
    const int lo = min(c_hi, c_lo + tid * per), hi = min(c_hi, lo + per);
    unsigned flags[OSLAM_DS_RUN / 32];
    int mine = 0;
    int l0 = OSLAM_BIG, l1 = OSLAM_BIG, l2 = OSLAM_BIG;
    int g0 = -OSLAM_BIG, g1 = -OSLAM_BIG, g2 = -OSLAM_BIG;
#pragma unroll
    for (int w = 0; w < OSLAM_DS_RUN / 32; ++w) {
        flags[w] = 0u;
        for (int j = 0; j < 32; ++j) {
            const int id = lo + 32 * w + j;
            if (id >= hi) break;
            float x, y, z;
            if (src.point(id, x, y, z)) {
                flags[w] |= 1u << j;
                ++mine;
                const int c0 = cell_of(x, leaf), c1 = cell_of(y, leaf),
                          c2 = cell_of(z, leaf);
                l0 = min(l0, c0);
                l1 = min(l1, c1);
                l2 = min(l2, c2);
                g0 = max(g0, c0);
                g1 = max(g1, c1);
                g2 = max(g2, c2);
            }
        }
    }
    int pos = block_scan(mine, ws);     // its barriers order the init above
    if (tid == 0) ws.live = ws.total;
    l0 = warp_min(l0);
    l1 = warp_min(l1);
    l2 = warp_min(l2);
    g0 = warp_max(g0);
    g1 = warp_max(g1);
    g2 = warp_max(g2);
    if (lane == 0 && l0 != OSLAM_BIG) {
        atomicMin(&ws.cmin[0], l0);
        atomicMin(&ws.cmin[1], l1);
        atomicMin(&ws.cmin[2], l2);
        atomicMax(&ws.cmax[0], g0);
        atomicMax(&ws.cmax[1], g1);
        atomicMax(&ws.cmax[2], g2);
    }
    cl.sync();
    // the detection's count and cell range, this block's first position
    if (tid < 32) {
        int live = 0;
        int a0 = OSLAM_BIG, a1 = OSLAM_BIG, a2 = OSLAM_BIG;
        int b0 = -OSLAM_BIG, b1 = -OSLAM_BIG, b2 = -OSLAM_BIG;
        if (lane < S) {
            const DsShared* o = cl.at(&ws, lane);
            live = o->live;
            a0 = o->cmin[0];
            a1 = o->cmin[1];
            a2 = o->cmin[2];
            b0 = o->cmax[0];
            b1 = o->cmax[1];
            b2 = o->cmax[2];
        }
        const int n = warp_sum(live);
        const int off = warp_sum(lane < rank ? live : 0);
        a0 = warp_min(a0);
        a1 = warp_min(a1);
        a2 = warp_min(a2);
        b0 = warp_max(b0);
        b1 = warp_max(b1);
        b2 = warp_max(b2);
        if (lane == 0) {
            ws.n = n;
            ws.off = off;
            ws.gmin[0] = a0;
            ws.gmin[1] = a1;
            ws.gmin[2] = a2;
            ws.gmax[0] = b0;
            ws.gmax[1] = b1;
            ws.gmax[2] = b2;
        }
    }
    __syncthreads();
    DS_CLOCK(2);

    const int n = ws.n;
    const int pc = (n + S - 1) / S;     // list positions a block holds
    const int len = min(pc, max(0, n - rank * pc));
    int n_out = 0;
    int fin = 0;                        // the list that ends sorted
    if (n > 0) {
        // (2) the ids to their place in the list, then the keys of this
        // block's chunk, a point a thread
        pos += ws.off;
#pragma unroll
        for (int w = 0; w < OSLAM_DS_RUN / 32; ++w)
            for (unsigned f = flags[w]; f != 0u; f &= f - 1u) {
                const int r = pos / pc, k = pos - r * pc;
                cl.at(mem.id[0], r)[k] = (uint16_t)(lo + 32 * w + __ffs(f) - 1);
                ++pos;
            }
        cl.sync();
        const int m0 = ws.gmin[0], m1 = ws.gmin[1], m2 = ws.gmin[2];
        for (int k = tid; k < len; k += OSLAM_DS_T) {
            float x, y, z;
            src.point(mem.id[0][k], x, y, z);
            mem.key[0][k] = (key_axis(cell_of(x, leaf), m0) << 20)
                            | (key_axis(cell_of(y, leaf), m1) << 10)
                            | key_axis(cell_of(z, leaf), m2);
        }
        cl.sync();
        DS_CLOCK(3);
        // (3) stable by key, between the two lists: a pass per group of
        // neighbouring axes whose digits together take at most 1024 values
        // (an object at 0.1 m: one pass), from z up
        int nbs[3];
        for (int axis = 0; axis < 3; ++axis) {
            const long long span = (long long)ws.gmax[axis] - ws.gmin[axis];
            nbs[axis] = span > 1023 ? 1024 : (int)span + 1;
        }
        int mult[3] = {0, 0, 0}, nb = 1;
        for (int axis = 2; axis >= 0; --axis) {
            mult[axis] = nb;            // below it, the group's axes
            nb *= nbs[axis];
            if (axis > 0 && nb * nbs[axis - 1] <= OSLAM_RADIX) continue;
            if (nb > 1) {               // one digit: the order stays
                radix_pass(mem, fin, len, pc,
                           make_int3(mult[0], mult[1], mult[2]), nb, ws, cl);
                fin ^= 1;
            }
            mult[0] = mult[1] = mult[2] = 0;
            nb = 1;
        }
        DS_CLOCK(4);
        const int* key = mem.key[fin];
        const uint16_t* ids = mem.id[fin];
        uint16_t* starts = mem.id[fin ^ 1];     // free after the sort
        // the sorted points' data, every thread loading at once (the walk
        // below then reads a run of consecutive entries)
        for (int k = tid; k < len; k += OSLAM_DS_T)
            mem.stage[k] = src.stage(ids[k]);
        // (4) the segment starts of this chunk: starts[j] = where its j-th
        // begins, ws.first the first of them (list position)
        if (tid == 0) ws.first = 0x7fffffff;
        const int prev = (rank > 0 && len > 0)
                         ? cl.at(mem.key[fin], rank - 1)[pc - 1] : 0;
        const int per2 = (len + OSLAM_DS_T - 1) / OSLAM_DS_T;
        const int lo2 = min(len, tid * per2), hi2 = min(len, lo2 + per2);
        unsigned news[OSLAM_DS_RUN / 32];
        int mine2 = 0;
#pragma unroll
        for (int w = 0; w < OSLAM_DS_RUN / 32; ++w) {
            news[w] = 0u;
            for (int j = 0; j < 32; ++j) {
                const int k = lo2 + 32 * w + j;
                if (k >= hi2) break;
                const bool first = k == 0 ? (rank == 0 || key[0] != prev)
                                          : key[k] != key[k - 1];
                if (first) {
                    news[w] |= 1u << j;
                    ++mine2;
                }
            }
        }
        int r = block_scan(mine2, ws);      // orders ws.first's init
        if (tid == 0) ws.segs = ws.total;
#pragma unroll
        for (int w = 0; w < OSLAM_DS_RUN / 32; ++w)
            for (unsigned f = news[w]; f != 0u; f &= f - 1u) {
                const int k = lo2 + 32 * w + __ffs(f) - 1;
                if (r == 0) ws.first = rank * pc + k;
                starts[r++] = (uint16_t)k;
            }
        cl.sync();
        // the detection's segments, this block's first rank, and where its
        // last segment ends: at the next block's first start, or at n
        if (tid < 32) {
            int segs = 0, first = 0x7fffffff;
            if (lane < S) {
                const DsShared* o = cl.at(&ws, lane);
                segs = o->segs;
                if (lane > rank) first = o->first;
            }
            const int n_seg = warp_sum(segs);
            const int seg_off = warp_sum(lane < rank ? segs : 0);
            first = warp_min(first);
            if (lane == 0) {
                ws.n_seg = n_seg;
                ws.seg_off = seg_off;
                ws.end = first == 0x7fffffff ? n : first;
            }
        }
        __syncthreads();
        DS_CLOCK(5);

        // (5) the means in sorted order
        const int n_loc = ws.segs, seg_off = ws.seg_off, c0 = rank * pc;
        n_out = min(ws.n_seg, capacity);
        for (int j = tid; j < n_loc && seg_off + j < capacity;
             j += OSLAM_DS_T) {
            const int k0 = c0 + starts[j];
            const int k1 = j + 1 < n_loc ? c0 + starts[j + 1] : ws.end;
            float sx = 0.0f, sy = 0.0f, sz = 0.0f, sa = 0.0f;
            for (int k = k0; k < k1;) {         // a chunk at a time
                const int b = k / pc, kb = b * pc, stop = min(k1, kb + pc);
                const uint16_t* bid = cl.at(ids, b);
                const typename Src::Staged* bst = cl.at(
                    (const typename Src::Staged*)mem.stage, b);
#pragma unroll 4
                for (; k < stop; ++k) {
                    float x, y, z;
                    src.from_stage(bid[k - kb], bst[k - kb], x, y, z);
                    sx += x;
                    sy += y;
                    sz += z;
                    if constexpr (Src::kAttr) sa += src.attr(bst[k - kb]);
                }
            }
            const float c = (float)(k1 - k0);
            const int kk = key[starts[j]];
            sink(seg_off + j, sx / c, sy / c, sz / c,
                 ((kk >> 20) & 1023) + ws.gmin[0],
                 ((kk >> 10) & 1023) + ws.gmin[1], (kk & 1023) + ws.gmin[2],
                 true, Src::kAttr ? sa / c : 0.0f);
        }
    } else {
        DS_CLOCK(3);
        DS_CLOCK(4);
        DS_CLOCK(5);
    }
    // the empty slots, spread over the cluster
    for (int s = n_out + rank * OSLAM_DS_T + tid; s < capacity;
         s += S * OSLAM_DS_T)
        sink(s, 0.0f, 0.0f, 0.0f, 0, 0, 0, false, 0.0f);
    DS_CLOCK(6);
}

// The world epilogue of depth_cloud: the voxel means and cells in the
// camera frame, the world point p R^T + t and the supporting-plane mask
// (n . p_w + d) / den > clearance (ops/voxel.world_points_plain's order);
// with battr, the voxels' mean border flags.
// w: R row-major [9], t [3], plane [4], den, clearance.
struct CloudSink {
    const float* w;
    float* pts_w;
    uint8_t* m2;
    float* pts_v;
    int* cells_v;
    float* battr;               // may be null
    bool any;
    __device__ void operator()(int r, float mx, float my, float mz, int c0,
                               int c1, int c2, bool live, float a)
    {
        if (battr != nullptr) battr[r] = a;
        pts_v[3 * r] = mx;
        pts_v[3 * r + 1] = my;
        pts_v[3 * r + 2] = mz;
        cells_v[3 * r] = c0;
        cells_v[3 * r + 1] = c1;
        cells_v[3 * r + 2] = c2;
        const float wx = mx * w[0] + my * w[1] + mz * w[2] + w[9];
        const float wy = mx * w[3] + my * w[4] + mz * w[5] + w[10];
        const float wz = mx * w[6] + my * w[7] + mz * w[8] + w[11];
        pts_w[3 * r] = wx;
        pts_w[3 * r + 1] = wy;
        pts_w[3 * r + 2] = wz;
        const float dist = (wx * w[12] + wy * w[13] + wz * w[14] + w[15])
                           / w[16];
        const bool keep = live && dist > w[17];
        m2[r] = keep ? 1 : 0;
        any = any || keep;
    }
};

struct PointsSink {
    float* out;
    uint8_t* out_mask;
    int* cells;                 // may be null
    float* out_attrs;           // may be null
    __device__ void operator()(int r, float mx, float my, float mz, int c0,
                               int c1, int c2, bool live, float a)
    {
        if (out_attrs != nullptr) out_attrs[r] = a;
        out[3 * r] = mx;
        out[3 * r + 1] = my;
        out[3 * r + 2] = mz;
        out_mask[r] = live ? 1 : 0;
        if (cells != nullptr) {
            cells[3 * r] = c0;
            cells[3 * r + 1] = c1;
            cells[3 * r + 2] = c2;
        }
    }
};

struct CameraArgs {
    float scale, fx, fy, cx, cy, depth_range;
};

// Grid (S, max(D, 1)), clusters of S; C list entries a block.  kBorder:
// the voxels' mean border flags into battr_v (sparse symmetry).  kFrames
// (the offline batch mapper): the detections come from a batch of frames,
// depth [B, H, W] and pose [B, 7], detection d from frame frame[d]; R_out
// is then one rotation a detection [D, 3, 3].  Without it the launch is a
// frame's (depth [H, W], pose [7], R_out [3, 3]), instruction for
// instruction.
template <bool kBorder, bool kFrames>
__global__ void __launch_bounds__(OSLAM_DS_T, 1) depth_cloud_kernel(
    const int* __restrict__ depth, int H, int W, int D,
    const float* __restrict__ bboxes, const float* __restrict__ pose,
    const float* __restrict__ plane, const CameraArgs cam, float leaf,
    float clearance, int capacity, int C, float* __restrict__ pts_w,
    uint8_t* __restrict__ m2, float* __restrict__ center_w,
    uint8_t* __restrict__ ok_points, uint8_t* __restrict__ ok_center,
    float* __restrict__ R_out, float* __restrict__ pts_v,
    int* __restrict__ cells_v, float* __restrict__ battr_v, float jump,
    const int* __restrict__ frame)
{
    __shared__ DsShared ws;
    __shared__ float w[18];
    __shared__ float4 samples[100];
    __shared__ float centre[4];
    extern __shared__ __align__(16) char ds_smem[];
    const Cl cl = {cg::this_cluster(), (int)cg::this_cluster().block_rank(),
                   (int)gridDim.x};
    const int d = blockIdx.y, tid = threadIdx.x;
    DS_CLOCK(0);
    // the detection's frame: its depth image and its pose (a size_t offset:
    // B H W pixels pass 2^31 at 7,000 frames of 640 x 480)
    int f = 0;
    if constexpr (kFrames) f = frame[d];
    depth += (size_t)f * H * W;
    pose += 7 * f;

    // R from the quaternion in se3.quat_to_mat's order; t; the plane and its
    // den = max(|n|, 1e-8) as the extractor takes them
    if (tid == 0) {
        const float qx = pose[3], qy = pose[4], qz = pose[5], qw = pose[6];
        const float xx = qx * qx, yy = qy * qy, zz = qz * qz;
        const float xy = qx * qy, xz = qx * qz, yz = qy * qz;
        const float wx = qw * qx, wy = qw * qy, wz = qw * qz;
        w[0] = 1.0f - 2.0f * (yy + zz);
        w[1] = 2.0f * (xy - wz);
        w[2] = 2.0f * (xz + wy);
        w[3] = 2.0f * (xy + wz);
        w[4] = 1.0f - 2.0f * (xx + zz);
        w[5] = 2.0f * (yz - wx);
        w[6] = 2.0f * (xz - wy);
        w[7] = 2.0f * (yz + wx);
        w[8] = 1.0f - 2.0f * (xx + yy);
        for (int k = 0; k < 3; ++k) w[9 + k] = pose[k];
        for (int k = 0; k < 4; ++k) w[12 + k] = plane[k];
        const float nn = sqrtf(plane[0] * plane[0] + plane[1] * plane[1]
                               + plane[2] * plane[2]);
        w[16] = nn < 1e-8f ? 1e-8f : nn;    // a NaN stays NaN, as clamp_min
        w[17] = clearance;
        ws.any = 0;
        if constexpr (kFrames) {
            if (cl.rank == 0)
                for (int k = 0; k < 9; ++k) R_out[9 * d + k] = w[k];
        } else if (d == 0 && cl.rank == 0) {
            for (int k = 0; k < 9; ++k) R_out[k] = w[k];
        }
    }
    if (d >= D) return;         // the launch for no detection writes R only
    const float* bb = bboxes + 4 * d;

    // (c) the centre estimate, by the cluster's first block: 10 x 10
    // samples around the box centre, center_estimate's truncating casts and
    // ordered divisions, summed in sample order from 0 by four threads, one
    // an axis and one the count
    if (cl.rank == 0) {
        if (tid < 100) {
            const int xc = (int)((bb[0] + bb[2]) / 2.0f);
            const int yc = (int)((bb[1] + bb[3]) / 2.0f);
            const int x_delta = (int)(fabsf(bb[0] - bb[2]) / 4.0f / 10.0f);
            const int y_delta = (int)(fabsf(bb[1] - bb[3]) / 4.0f / 10.0f);
            const int px = min(max(xc + (tid % 10 - 5) * x_delta, 0), W - 1);
            const int py = min(max(yc + (tid / 10 - 5) * y_delta, 0), H - 1);
            const float z = (float)depth[py * W + px] / cam.scale;
            const float v = (z > 0.1f && z <= cam.depth_range) ? 1.0f : 0.0f;
            const float x = ((float)px - cam.cx) * z / cam.fx;
            const float y = ((float)py - cam.cy) * z / cam.fy;
            samples[tid] = make_float4(x * v, y * v, z * v, v);
        }
        __syncthreads();
        if (tid < 4) {
            float acc = 0.0f;
            for (int s = 0; s < 100; ++s) {
                const float4 q = samples[s];
                acc = acc + (tid == 0 ? q.x : tid == 1 ? q.y
                             : tid == 2 ? q.z : q.w);
            }
            centre[tid] = acc;  // the count is exact in any order
        }
        __syncthreads();
        if (tid == 0) {
            const float count = centre[3];
            const float c = fmaxf(count, 1.0f);
            const float cx = centre[0] / c, cy = centre[1] / c,
                        cz = centre[2] / c;
            for (int i = 0; i < 3; ++i)
                center_w[3 * d + i] = cx * w[3 * i] + cy * w[3 * i + 1]
                                      + cz * w[3 * i + 2] + w[9 + i];
            ok_center[d] = count >= 2.0f ? 1 : 0;
        }
    }
    DS_CLOCK(1);

    // (a) the box's strided pixels, clipped as bbox_point_cloud_plain clips
    const int x1 = min(max((int)bb[0], 0), W - 1);
    const int y1 = min(max((int)bb[1], 0), H - 1);
    const int x2 = min(max((int)bb[2], 0), W);
    const int y2 = min(max((int)bb[3], 0), H);
    const int bw = x2 > x1 ? (x2 - x1 + OSLAM_STRIDE - 1) / OSLAM_STRIDE : 0;
    const int bh = y2 > y1 ? (y2 - y1 + OSLAM_STRIDE - 1) / OSLAM_STRIDE : 0;
    const BoxPixels<kBorder> src = {depth, W, x1, y1, bw, cam.scale, cam.fx,
                                    cam.fy, cam.cx, cam.cy, cam.depth_range,
                                    H, jump};
    const size_t o = (size_t)d * capacity;
    CloudSink sink = {w, pts_w + 3 * o, m2 + o, pts_v + 3 * o,
                      cells_v + 3 * o, kBorder ? battr_v + o : nullptr, false};
    // (a, b) downsample, world transform, plane mask; ok_points is the OR
    // of the blocks' planes tests, gathered in the first block
    downsample_cluster(
        src, bw * bh, leaf, capacity,
        ds_mem<typename BoxPixels<kBorder>::Staged>(ds_smem, C), ws, cl,
        sink);
    if (__syncthreads_or(sink.any ? 1 : 0) && tid == 0)
        atomicOr(cl.at(&ws.any, 0), 1);
    cl.sync();                // nothing reads a block's memory after this
    if (cl.rank == 0 && tid == 0) ok_points[d] = ws.any ? 1 : 0;
    DS_CLOCK(7);
}

// Grid (S, D), clusters of S; C list entries a block.  kAttr: the
// attributes [D, N] averaged per cell into out_attrs [D, capacity].
template <bool kAttr>
__global__ void __launch_bounds__(OSLAM_DS_T, 1) voxel_downsample_kernel(
    const float* __restrict__ pts, const uint8_t* __restrict__ mask, int N,
    float leaf, int capacity, int C, float* __restrict__ out,
    uint8_t* __restrict__ out_mask, int* __restrict__ cells,
    const float* __restrict__ attrs, float* __restrict__ out_attrs)
{
    __shared__ DsShared ws;
    extern __shared__ __align__(16) char ds_smem[];
    const Cl cl = {cg::this_cluster(), (int)cg::this_cluster().block_rank(),
                   (int)gridDim.x};
    const int d = blockIdx.y;
    const size_t o = (size_t)d * capacity;
    const MaskedPoints<kAttr> src = {pts + (size_t)d * N * 3,
                                     mask + (size_t)d * N,
                                     kAttr ? attrs + (size_t)d * N : nullptr};
    PointsSink sink = {out + 3 * o, out_mask + o,
                       cells != nullptr ? cells + 3 * o : nullptr,
                       kAttr ? out_attrs + o : nullptr};
    DS_CLOCK(0);
    DS_CLOCK(1);
    downsample_cluster(
        src, N, leaf, capacity,
        ds_mem<typename MaskedPoints<kAttr>::Staged>(ds_smem, C), ws, cl,
        sink);
    cl.sync();                // nothing reads a block's memory after this
    DS_CLOCK(7);
}

// The launch shape of a downsample kernel for detections of up to n
// candidate points at `per` bytes of working arrays each: the fewest blocks
// S (at most OSLAM_DS_MAX_S) whose shared memory holds C = ceil(n / S)
// entries a block beside the kernel's static part.  The room a block has
// is read, and the kernel's limit raised to it, at the first launch on a
// device.
struct DsKernel {
    const void* fn;
    int dev;                    // the device `room` was read on, or -1
    int room;                   // dynamic shared memory a block can have
};

static int ds_shape(DsKernel& k, long long n, int per, int* S, int* C)
{
    int dev = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc != cudaSuccess) return (int)rc;
    if (k.dev != dev) {
        cudaFuncAttributes attr = {};
        int optin = 0;
        rc = cudaFuncGetAttributes(&attr, k.fn);
        if (rc == cudaSuccess)
            rc = cudaDeviceGetAttribute(
                &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (rc == cudaSuccess)
            rc = cudaFuncSetAttribute(
                k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                optin - (int)attr.sharedSizeBytes);
        if (rc != cudaSuccess) return (int)rc;
        k.dev = dev;
        k.room = optin - (int)attr.sharedSizeBytes;
    }
    const long long most = k.room / per;        // entries a block holds
    const long long s = n < 1 ? 1 : (n + most - 1) / most;
    if (most < 1 || s > OSLAM_DS_MAX_S) return (int)cudaErrorInvalidValue;
    *S = (int)s;
    *C = (int)(n < 1 ? 1 : (n + s - 1) / s);
    return 0;
}

template <class... Params, class... Args>
static int ds_launch(void (*kernel)(Params...), int S, int blocks, int smem,
                     void* stream, Args... args)
{
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(S, blocks, 1);
    cfg.blockDim = dim3(OSLAM_DS_T, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = S;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (rc == cudaSuccess) rc = cudaGetLastError();
    return (int)rc;
}

// depth_cloud_kernel<kBorder, kFrames> at ds_cloud[kBorder][kFrames]
static DsKernel ds_cloud[2][2] = {
    {{(const void*)depth_cloud_kernel<false, false>, -1, 0},
     {(const void*)depth_cloud_kernel<false, true>, -1, 0}},
    {{(const void*)depth_cloud_kernel<true, false>, -1, 0},
     {(const void*)depth_cloud_kernel<true, true>, -1, 0}}};
static DsKernel ds_object = {(const void*)voxel_downsample_kernel<false>, -1,
                             0};
static DsKernel ds_object_attr = {(const void*)voxel_downsample_kernel<true>,
                                  -1, 0};

template <bool kBorder, bool kFrames>
static int depth_cloud_launch(
    long long G, const int* depth, int H, int W, const float* bboxes, int D,
    const float* pose, const float* plane, const CameraArgs cam, float leaf,
    float clearance, int capacity, float* pts_w, uint8_t* m2,
    float* center_w, uint8_t* ok_points, uint8_t* ok_center, float* R_out,
    float* pts_v, int* cells_v, float* battr_v, float jump, const int* frame,
    void* stream)
{
    const int per = 12 + (int)sizeof(typename BoxPixels<kBorder>::Staged);
    int S = 0, C = 0;
    const int rc = ds_shape(ds_cloud[kBorder][kFrames], G, per, &S, &C);
    if (rc != 0) return rc;
    return ds_launch(depth_cloud_kernel<kBorder, kFrames>, S, D > 0 ? D : 1,
                     C * per, stream, depth, H, W, D, bboxes, pose, plane,
                     cam, leaf, clearance, capacity, C, pts_w, m2, center_w,
                     ok_points, ok_center, R_out, pts_v, cells_v, battr_v,
                     jump, frame);
}

// A cluster of S blocks per detection (and one cluster for D = 0, which
// writes R only), S from the whole image's G = ceil(H / 3) * ceil(W / 3)
// <= 65535 strided pixels (16-bit point ids): every box fits.  battr_v
// [D, capacity] may be null: without it the kernel does not test borders.
// frame [D] int32 may be null: one frame (depth [H, W], pose [7], R_out
// [3, 3]); given, a batch of frames (depth [B, H, W], pose [B, 7], R_out
// [D, 3, 3]), each detection's own frame index in [0, B), and D >= 1.
extern "C" int oslam_depth_cloud(
    const void* depth, int H, int W, const void* bboxes, int D,
    const void* pose, const void* plane, float scale, float fx, float fy,
    float cx, float cy, float depth_range, float leaf, float clearance,
    int capacity, void* pts_w, void* m2, void* center_w, void* ok_points,
    void* ok_center, void* R_out, void* pts_v, void* cells_v, void* battr_v,
    float jump, const void* frame, void* stream)
{
    const long long G = (long long)((H + OSLAM_STRIDE - 1) / OSLAM_STRIDE)
                        * ((W + OSLAM_STRIDE - 1) / OSLAM_STRIDE);
    if (H < 1 || W < 1 || D < 0 || D > 65535 || capacity < 1 ||
        G > OSLAM_DS_MAX_IDS || (D > 0 && (pts_v == nullptr ||
                                           cells_v == nullptr)) ||
        (frame != nullptr && D < 1))
        return (int)cudaErrorInvalidValue;
    const CameraArgs cam = {scale, fx, fy, cx, cy, depth_range};
    auto launch = battr_v != nullptr
                      ? (frame != nullptr ? depth_cloud_launch<true, true>
                                          : depth_cloud_launch<true, false>)
                      : (frame != nullptr ? depth_cloud_launch<false, true>
                                          : depth_cloud_launch<false, false>);
    return launch(G, (const int*)depth, H, W, (const float*)bboxes, D,
                  (const float*)pose, (const float*)plane, cam, leaf,
                  clearance, capacity, (float*)pts_w, (uint8_t*)m2,
                  (float*)center_w, (uint8_t*)ok_points, (uint8_t*)ok_center,
                  (float*)R_out, (float*)pts_v, (int*)cells_v,
                  (float*)battr_v, jump, (const int*)frame, stream);
}

template <bool kAttr>
static int voxel_downsample_launch(
    const float* pts, const uint8_t* mask, int D, int N, float leaf,
    int capacity, float* out, uint8_t* out_mask, int* cells,
    const float* attrs, float* out_attrs, void* stream)
{
    const int per = 12 + (int)sizeof(typename MaskedPoints<kAttr>::Staged);
    int S = 0, C = 0;
    const int rc = ds_shape(kAttr ? ds_object_attr : ds_object, N, per, &S,
                            &C);
    if (rc != 0) return rc;
    return ds_launch(voxel_downsample_kernel<kAttr>, S, D, C * per, stream,
                     pts, mask, N, leaf, capacity, C, out, out_mask, cells,
                     attrs, out_attrs);
}

// A cluster of S blocks per detection, S from N <= 65535 (16-bit point
// ids; more than ~63,000 do not fit 8 blocks); cells may be null; attrs
// [D, N] and out_attrs [D, capacity] both null or both given.
extern "C" int oslam_voxel_downsample(
    const void* pts, const void* mask, int D, int N, float leaf, int capacity,
    void* out, void* out_mask, void* cells, const void* attrs,
    void* out_attrs, void* stream)
{
    if (D < 1 || D > 65535 || N < 0 || N > OSLAM_DS_MAX_IDS || capacity < 1
        || (attrs == nullptr) != (out_attrs == nullptr))
        return (int)cudaErrorInvalidValue;
    auto launch = attrs != nullptr ? voxel_downsample_launch<true>
                                   : voxel_downsample_launch<false>;
    return launch((const float*)pts, (const uint8_t*)mask, D, N, leaf,
                  capacity, (float*)out, (uint8_t*)out_mask, (int*)cells,
                  (const float*)attrs, (float*)out_attrs, stream);
}

// ---------------------------------------------------------------------------
// Device functions of cluster_components.
// ---------------------------------------------------------------------------
// The radius test of one pair: point i (xi, yi, zi, squared norm ni)
// against the staged point p = (x, y, z, squared norm) carrying label l;
// returns the lesser of `best` and l if the pair is within the radius.  The
// operations and their order are ops/cluster.min_label_pass_plain's.
__device__ __forceinline__ int closer_label(
    float xi, float yi, float zi, float ni, const float4 p, int l, float tol2,
    int best)
{
    const float cross = xi * p.x + yi * p.y + zi * p.z;
    const float d2 = ni + p.w - 2.0f * cross;
    return (d2 <= tol2 && l < best) ? l : best;
}

// The exact lane's radius test: the direct difference on the uncentred
// points, ((dx*dx + dy*dy) + dz*dz) <= tol2, each operation rounded on its
// own (ops/cluster.min_label_pass_exact_plain, JAX _min_label_pass).
__device__ __forceinline__ int closer_label_exact(
    float xi, float yi, float zi, const float4 p, int l, float tol2,
    int best)
{
    const float dx = xi - p.x, dy = yi - p.y, dz = zi - p.z;
    const float d2 = (dx * dx + dy * dy) + dz * dz;
    return (d2 <= tol2 && l < best) ? l : best;
}

// The carry into this thread of a segmented minimum over the block's
// threads, in thread order (kRev: from the last thread down): each thread
// gives the pair (v, has) of its chunk, has = a segment starts inside it,
// v = the minimum since its last start (or over the whole chunk); the pair
// of the chunks before it, combined, is returned as its value (2^30 where
// none).  sv / sh: 32 ints of scratch each.  All threads call it.
template <bool kRev>
__device__ int block_seg_carry(int v, bool has, int* sv, int* sh)
{
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int W = blockDim.x >> 5;
    int iv = v;
    int ih = has ? 1 : 0;
    for (int o = 1; o < 32; o <<= 1) {
        const int ov = kRev ? __shfl_down_sync(0xffffffffu, iv, o)
                            : __shfl_up_sync(0xffffffffu, iv, o);
        const int oh = kRev ? __shfl_down_sync(0xffffffffu, ih, o)
                            : __shfl_up_sync(0xffffffffu, ih, o);
        if (kRev ? lane + o < 32 : lane >= o) {
            if (!ih) iv = min(iv, ov);
            ih |= oh;
        }
    }
    // the lanes before this one in the warp (inclusive of the one before)
    int ev = kRev ? __shfl_down_sync(0xffffffffu, iv, 1)
                  : __shfl_up_sync(0xffffffffu, iv, 1);
    int eh = kRev ? __shfl_down_sync(0xffffffffu, ih, 1)
                  : __shfl_up_sync(0xffffffffu, ih, 1);
    if (kRev ? lane == 31 : lane == 0) {
        ev = OSLAM_BIG;
        eh = 0;
    }
    __syncthreads();            // sv / sh may still be read
    if (kRev ? lane == 0 : lane == 31) {
        sv[warp] = iv;
        sh[warp] = ih;
    }
    __syncthreads();
    // the warps before this one, in scan order
    int cv = OSLAM_BIG;
    if (kRev) {
        for (int w = W - 1; w > warp; --w) cv = sh[w] ? sv[w] : min(cv, sv[w]);
    } else {
        for (int w = 0; w < warp; ++w) cv = sh[w] ? sv[w] : min(cv, sv[w]);
    }
    return eh ? ev : min(cv, ev);
}

// One chain pass (JAX ops/cluster.py _chain_apply) over the n labels a
// into b, by all threads of the block: along the order (compacted lanes,
// a permutation of [0, n)), a forward and a backward segmented minimum of
// the labels, a segment a run of linked points (link[k]: the point at k is
// linked to the one before it), and b at each point the lesser of the two.
// A thread takes a contiguous chunk of the order; the carries between
// chunks are block scans.  Returns whether a label of this thread's
// changed.  The caller separates passes with __syncthreads().
__device__ bool chain_pass(const int* a, int* b, int n,
                           const int* __restrict__ order,
                           const uint8_t* __restrict__ link, int* sv, int* sh)
{
    const int T = blockDim.x;
    const int L = (n + T - 1) / T;
    const int lo = min(n, (int)threadIdx.x * L), hi = min(n, lo + L);
    int fv = OSLAM_BIG, bv = OSLAM_BIG;
    bool fh = false, bh = false;
    for (int k = lo; k < hi; ++k) {
        const int l = a[order[k]];
        if (link[k] == 0) {
            fv = l;
            fh = true;
        } else {
            fv = min(fv, l);
        }
        if (!bh) {
            bv = min(bv, l);
            bh = k + 1 >= n || link[k + 1] == 0;
        }
    }
    const int fc = block_seg_carry<false>(fv, fh, sv, sh);
    const int bc = block_seg_carry<true>(bv, bh, sv, sh);
    int v = fc;
    for (int k = lo; k < hi; ++k) {
        const int o = order[k];
        const int l = a[o];
        v = link[k] == 0 ? l : min(v, l);
        b[o] = v;
    }
    bool diff = false;
    v = bc;
    for (int k = hi - 1; k >= lo; --k) {
        const int o = order[k];
        const int l = a[o];
        v = (k + 1 >= n || link[k + 1] == 0) ? l : min(v, l);
        const int r = min(b[o], v);
        b[o] = r;
        diff = diff || (r != l);
    }
    return diff;
}

// One synchronous jump over n labels: b_i = a_{a_i} (a label >= n, a
// masked point's, stays), by all threads of the block; with kTrack it returns whether a
// label of this thread's changed.  The caller separates jumps with
// __syncthreads().
template <bool kTrack>
__device__ __forceinline__ bool jump_once(const int* a, int* b, int n)
{
    bool diff = false;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int l = a[i];
        const int v = (l < n) ? a[l] : l;
        b[i] = v;
        if (kTrack) diff = diff || (v != l);
    }
    return diff;
}

// ---------------------------------------------------------------------------
// cluster_components.  Replaces ops/cluster.components_compacted of the JAX
// package (compaction, then _propagate's rounds of one min-label pass and
// `jump_iters` pointer jumps until a round changes no label): the whole
// propagation of a frame in ONE launch, no host read between rounds.
//
// Bound by operations (the pair tests, ~11 f32 / integer operations each,
// against 17 bytes a point).  The earlier one-pass kernel already ran its
// pair tests at the card's instruction rate; what the loop of the two
// single-step kernels (a pass, the jumps; since deleted) lost was two
// launches and a fraction of a host read per round, pair tests against
// every lane of the frame's cap and against points far beyond the radius,
// and every detection held to the rounds of the slowest.  What the design
// does about it:
//  - One thread block cluster per detection (grid S x D, cluster dimension
//    S).  Every block scans the detection's mask (ballot + warp totals)
//    into the list of unmasked lanes in their
//    original order, so the least compacted index is the least original
//    index, and from there on works on the detection's own n points.  A
//    detection without an unmasked point leaves at once.
//  - Resident state in dynamic shared memory, for all rounds: the lane
//    list, two label buffers, a bounding box per 32 points, and the points
//    as float4 (x, y, z, squared norm), 29 bytes a point in all.  Where the
//    points do not fit beside the rest (13 bytes a point) they are streamed
//    through the remaining room tile by tile, from global memory through
//    the lane list: the same code with a tile shorter than n.
//  - Register tiling: a warp owns 32 * P consecutive points i, P a lane, in
//    registers, so one broadcast read of a point j and its label serves P
//    pair tests.  Each block owns a contiguous slice of the i; when a slice
//    has fewer 32 * P granules than the block has warps, several warps
//    share a granule, each taking every JS-th group of 32 j, and the
//    results meet in a shared-memory atomicMin (a minimum has no order:
//    deterministic).
//  - Skipping far groups: the voxel cloud arrives sorted by cell, so 32
//    consecutive points are a thin slab.  A group of j whose bounding box
//    (taken in the frame the cloud was sorted in, which the caller names)
//    lies farther from the granule's box than the radius (plus a slack
//    that covers the f32 rounding of the norm expansion, see `far_apart`)
//    holds no neighbour and is skipped whole; the pairs that are tested,
//    and so the labels, are the plain version's.  This, not the register
//    tiling, is where the pass's time goes down: a pass that tests every
//    pair runs at ~11 instructions a pair with or without the tiling.
//  - Labels cross the cluster through distributed shared memory: after its
//    part of a pass a block writes its slice into every block's copy, then
//    one cluster barrier.  The jumps need every label at random and cost
//    little, so every block runs all of them on its own copy (a
//    __syncthreads() apart, each reading the jump before: two buffers).
//    Every block therefore sees the same labels and takes the same decision
//    to stop; the flag "a label changed" is taken per step (labels only
//    ever decrease, so a round changed something iff one of its steps did).
//    A second barrier, split into its arrive (after the jumps) and its wait
//    (before the next round's remote writes), keeps a fast block from
//    writing into a buffer a slow one still jumps through.
// Precondition: labels0 of an unmasked lane is an unmasked lane of index
// <= its own (the identity, or ops/cluster._chain_seed's output).
//
// Lanes (template parameters; without them the code and the bits are
// those of the kernel before them):
//  - kPass = OSLAM_PASS_EXACT (connected_components(exact=True), JAX
//    _min_label_pass :54): the pair test is the direct difference on the
//    uncentred points the caller passes, the squared norms only feeding
//    the boxes' slack (`far_apart`, which holds for this test too).
//  - kChain (cluster_chains > 0, JAX _chain_apply :158 in _propagate
//    :196): after each pass and before the jumps every block runs, on its
//    own copy of the labels, a forward and a backward segmented minimum
//    along each of up to three spatial orders (`chain_pass`).  The orders
//    and their link flags come from torch in compacted numbering
//    (ops/cluster.chain_orders).  A minimum has no order: deterministic.
// ---------------------------------------------------------------------------
#define OSLAM_CC_MAXT 512
#define OSLAM_PASS_DENSE 0
#define OSLAM_PASS_EXACT 1
#ifndef OSLAM_CC_P
#define OSLAM_CC_P 2            // points a lane keeps in registers
#endif

__device__ __forceinline__ void cluster_arrive()
{
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait()
{
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Whether no point of box i can pass the radius test against a point of box
// j.  lo.xyz / hi.xyz are the boxes' corners (in the rotated frame of the
// kernel's prologue), hi.w the largest squared norm inside.  The test
// computes d2 = |x_i - x_j|^2 + e in f32 with |e| < 7 ulp-halves of
// (nrm_i + nrm_j), under 5e-7 (nrm_i + nrm_j): a pair passes only if its
// true squared distance is below tol2 plus that, and the boxes' gap bounds
// the distance from below.  The slack here is four times that, for the
// rounding of the rotation as well (a few ulp of a coordinate, so of the
// same order against the gap), and 1 % on tol2 for the frame's own
// departure from a rotation.
// The exact lane's direct test rounds within 5 ulp-halves of d2 itself: a
// pair passes only if its true squared distance is below tol2 (1 + 3e-7).
// The rotation moves a rotated coordinate by under 4e-7 |p| (p uncentred
// there, so hi.w their largest squared norm), the gap by under
// e = 4e-7 (|p_i| + |p_j|), the squared gap by under 2 e tol + e^2 <=
// 4e-7 (2 tol2 + w_i + w_j) + e^2 near the radius.  1.01 tol2 + 2e-6
// (w_i + w_j) covers both: the same slack serves both tests.
__device__ __forceinline__ bool far_apart(
    const float4 ilo, const float4 ihi, const float4 jlo, const float4 jhi,
    float tol2)
{
    const float dx = fmaxf(0.0f, fmaxf(jlo.x - ihi.x, ilo.x - jhi.x));
    const float dy = fmaxf(0.0f, fmaxf(jlo.y - ihi.y, ilo.y - jhi.y));
    const float dz = fmaxf(0.0f, fmaxf(jlo.z - ihi.z, ilo.z - jhi.z));
    const float gap2 = dx * dx + dy * dy + dz * dz;
    return gap2 > 1.01f * tol2 + 2e-6f * (ihi.w + jhi.w);
}

// cluster_select's extra arguments: ops/cluster.select_cluster as the
// kernel's epilogue (EllipsoidExtractor.cpp:675-736), taken by the cluster's
// first block while the labels are still in its shared memory.  Per root:
// the size of its component (an integer count) and the least distance of
// its points to the centre estimate, sqrtf((dx*dx + dy*dy) + dz*dz) in IEEE
// arithmetic on the UNcentred points, as the plain version has it; then
// the largest component of at least min_size points whose least distance
// is under center_dis (the first of equal sizes: the least root, as
// torch.argmax gives it), or the only component of that size whatever its
// distance.  mask == nullptr: no selection (cluster_components).
struct Selection {
    const float* pts;       // [D, N, 3] the points the distances are taken on
    const float* center;    // [D, 3]
    int min_size;
    float center_dis;
    int* least_d;           // [D, N] scratch: a root's least distance (bits)
    uint8_t* mask;          // [D, N] out: the chosen component's points
    uint8_t* ok;            // [D] out: one was chosen and the rounds settled
};

// the larger of two (size, root) keys over the block; every thread gets it
__device__ __forceinline__ unsigned long long block_max_key(
    unsigned long long key, unsigned long long* scratch32)
{
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, o);
        key = other > key ? other : key;
    }
    __syncthreads();            // scratch32 may still be read
    if (lane == 0) scratch32[warp] = key;
    __syncthreads();
    key = scratch32[0];
    for (int k = 1; k < (int)(blockDim.x >> 5); ++k)
        key = scratch32[k] > key ? scratch32[k] : key;
    return key;
}

// The steps cluster_components (K5) and cluster_grid (K13) share.
// The compaction of detection d: idx[c] = the c-th unmasked lane, in lane
// order, by every block of the cluster.  Masked lanes get their label N
// here (chunk by chunk over the ranks); unmasked lanes are written at the
// end.  warp_off (32 ints) and chunk_total are shared scratch; mask and
// out_labels point at the detection's lanes.  Returns n, the unmasked
// lanes.
__device__ __forceinline__ int compact_lanes(
    const uint8_t* __restrict__ mask, int N, int S, int rank, int d,
    int* idx, int* warp_off, int& chunk_total, int* __restrict__ out_labels,
    const Selection& sel)
{
    const int tid = threadIdx.x, T = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5, W = T >> 5;
    int n = 0;
    for (int start = 0; start < N; start += T) {
        const int i = start + tid;
        const bool m = i < N && mask[i] != 0;
        const unsigned ballot = __ballot_sync(0xffffffffu, m);
        const int before = __popc(ballot & ((1u << lane) - 1u));
        if (lane == 0) warp_off[warp] = __popc(ballot);
        __syncthreads();
        if (warp == 0) {
            const int mine = lane < W ? warp_off[lane] : 0;
            int incl = mine;
            for (int o = 1; o < 32; o <<= 1) {
                const int up = __shfl_up_sync(0xffffffffu, incl, o);
                if (lane >= o) incl += up;
            }
            warp_off[lane] = incl - mine;
            if (lane == 31) chunk_total = incl;
        }
        __syncthreads();
        if (m)
            idx[n + warp_off[warp] + before] = i;
        else if (i < N && (start / T) % S == rank) {
            out_labels[i] = N;
            if (sel.mask != nullptr) sel.mask[(size_t)d * N + i] = 0;
        }
        n += chunk_total;
        __syncthreads();        // warp_off and chunk_total are reused
    }
    return n;
}

// The starting labels in compacted numbering (a seeded label is found in
// the sorted lane list); the padding up to n_pad carries 2^30, which never
// wins.  The caller synchronises after.
__device__ __forceinline__ void seed_compacted(
    const int* idx, const int* __restrict__ labels0, int n, int n_pad,
    int* cur, int* nxt)
{
    const int tid = threadIdx.x, T = blockDim.x;
    for (int c = tid; c < n_pad; c += T) {
        int lc = OSLAM_BIG;
        if (c < n) {
            const int o = idx[c];
            const int l0 = labels0[o];
            lc = c;
            if (l0 != o) {
                int lo = 0, hi = c;
                while (lo < hi) {
                    const int mid = (lo + hi) >> 1;
                    if (idx[mid] < l0) lo = mid + 1; else hi = mid;
                }
                lc = lo;
            }
        }
        cur[c] = lc;
        nxt[c] = lc;
    }
}

// The labels back in the original lane numbering (each rank a slice), the
// flag and the round count.
__device__ __forceinline__ void write_labels(
    const int* idx, const int* cur, int n, int S, int rank, int d, bool conv,
    int r, int* __restrict__ out_labels, uint8_t* __restrict__ converged,
    int* __restrict__ rounds)
{
    const int tid = threadIdx.x, T = blockDim.x;
    const int per = (n + S - 1) / S;
    const int c_hi = min(n, (rank + 1) * per);
    for (int c = rank * per + tid; c < c_hi; c += T)
        out_labels[idx[c]] = idx[cur[c]];
    if (rank == 0 && tid == 0) {
        converged[d] = conv ? 1 : 0;
        rounds[d] = r;
    }
}

// The selection epilogue (Selection above), by one block that holds the
// detection's n settled labels `cur` in compacted numbering.
__device__ __forceinline__ void select_epilogue(
    const int* idx, const int* cur, int* nxt, int n, int N, int d, bool conv,
    const Selection& sel)
{
    const int tid = threadIdx.x, T = blockDim.x;
    // n atomics and three block reductions.  `nxt` is free: sizes per
    // root; the least distances go through global scratch (this block's
    // own writes)
    __shared__ unsigned long long keys32[32];
    __shared__ int counts[2];
    const float* wpts = sel.pts + (size_t)d * N * 3;
    int* least = sel.least_d + (size_t)d * N;
    uint8_t* smask = sel.mask + (size_t)d * N;
    const float cx = sel.center[3 * d], cy = sel.center[3 * d + 1],
                cz = sel.center[3 * d + 2];
    if (tid < 2) counts[tid] = 0;
    for (int c = tid; c < n; c += T) {
        nxt[c] = 0;
        least[c] = 0x7f800000;  // +inf
    }
    __syncthreads();
    for (int c = tid; c < n; c += T) {
        const int root = cur[c];
        const int o = idx[c];
        const float dx = wpts[3 * o] - cx, dy = wpts[3 * o + 1] - cy,
                    dz = wpts[3 * o + 2] - cz;
        const float dist = sqrtf((dx * dx + dy * dy) + dz * dz);
        atomicAdd(&nxt[root], 1);
        // distances are >= 0: their bits order as they do
        atomicMin(&least[root], __float_as_int(dist));
    }
    __syncthreads();
    // keys: the size above the complement of the root, so the greater key
    // is the larger component and, of equal sizes, the lesser root
    unsigned long long near_key = 0, any_key = 0;
    int n_clusters = 0, n_near = 0;
    for (int c = tid; c < n; c += T) {
        const int size = nxt[c];
        if (size < sel.min_size || size == 0) continue;
        const unsigned long long key =
            ((unsigned long long)size << 32) | (unsigned)(0x7fffffff - c);
        ++n_clusters;
        any_key = key > any_key ? key : any_key;
        if (__int_as_float(least[c]) < sel.center_dis) {
            ++n_near;
            near_key = key > near_key ? key : near_key;
        }
    }
    if (n_clusters) atomicAdd(&counts[0], n_clusters);
    if (n_near) atomicAdd(&counts[1], n_near);
    near_key = block_max_key(near_key, keys32);
    any_key = block_max_key(any_key, keys32);
    __syncthreads();            // counts are complete
    const bool fallback = counts[0] == 1 && counts[1] == 0;
    const bool chosen_ok = counts[1] > 0 || fallback;
    const int chosen =
        0x7fffffff - (int)((fallback ? any_key : near_key) & 0xffffffffu);
    for (int c = tid; c < n; c += T)
        smask[idx[c]] = (chosen_ok && cur[c] == chosen) ? 1 : 0;
    if (tid == 0) sel.ok[d] = (chosen_ok && conv) ? 1 : 0;
}

// The chain lane's extra arguments: the orders [D, n_orders, N] (compacted
// lanes; entry k < n a permutation of [0, n)) and link flags
// [D, n_orders, N].
struct ClusterLane {
    const int* chain_order;
    const uint8_t* chain_link;
    int n_orders;
};

template <int P, int kPass, bool kChain>
__global__ void __launch_bounds__(OSLAM_CC_MAXT, 1) cluster_components_kernel(
    const float* __restrict__ pts_c, const float* __restrict__ nrm,
    const uint8_t* __restrict__ mask, const int* __restrict__ labels0, int N,
    float tol2, int outer_iters, int jump_iters, int smem_bytes, int prune,
    const float* __restrict__ sort_frame, int frame_stride,
    int* __restrict__ out_labels, uint8_t* __restrict__ converged,
    int* __restrict__ rounds, const Selection sel, const ClusterLane lane_args)
{
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int S = (int)cluster.num_blocks();
    const int d = blockIdx.y;
    const int tid = threadIdx.x, T = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5, W = T >> 5;
    sort_frame += (size_t)frame_stride * d;     // 0: one frame for all
    pts_c += (size_t)d * N * 3;
    nrm += (size_t)d * N;
    mask += (size_t)d * N;
    labels0 += (size_t)d * N;
    out_labels += (size_t)d * N;

    extern __shared__ float4 cc_smem[];
    __shared__ int warp_off[32];
    __shared__ int chunk_total;
    __shared__ float frame[9];  // rows u, v, w of the boxes' frame
    // chain_pass's scratch: only the chain lane allocates it
    __shared__ int scan_vh[kChain ? 64 : 1];

    // --- compaction (compact_lanes)
    int* idx = reinterpret_cast<int*>(cc_smem);
    const int n = compact_lanes(mask, N, S, rank, d, idx, warp_off,
                                chunk_total, out_labels, sel);
    if (n == 0) {               // every block of the cluster takes this exit
        if (rank == 0 && tid == 0) {
            converged[d] = 1;
            rounds[d] = 1;      // the first round changes nothing
            if (sel.mask != nullptr) sel.ok[d] = 0;
        }
        return;
    }

    // --- the layout behind the lane list, now that n is known
    const int n_sub = (n + 31) >> 5, n_pad = n_sub << 5;
    int* cur = idx + n_pad;
    int* nxt = cur + n_pad;
    float4* box = reinterpret_cast<float4*>(nxt + n_pad);
    float4* tile = box + 2 * n_sub;
    const int tile_cap = ((smem_bytes - 12 * n_pad - 32 * n_sub) / 16) & ~31;
    const bool resident = tile_cap >= n_pad;

    seed_compacted(idx, labels0, n, n_pad, cur, nxt);
    __syncthreads();
    for (int c = n + tid; c < n_pad; c += T) idx[c] = idx[0];

    // --- the frame the boxes are taken in.  A voxel cloud is sorted by
    // the cells of the camera frame (x, then y, then z), so 32 consecutive
    // points are a strip of a thin slab across the camera's x axis, which
    // in world coordinates may point anywhere: an axis-aligned box of a
    // slanted strip is fat.  The caller names the frame the cloud was
    // sorted in (`sort_frame`, rows u, v, w); it is taken if it is a
    // rotation to 1e-3, else the boxes are taken along the axes of the
    // points' own coordinates (the identity).  Any rotation keeps
    // distances, so the skip stays exact whatever the frame is; a cloud in
    // no order just gets boxes that skip nothing.
    {
        float f[9];
        for (int k = 0; k < 9; ++k) f[k] = sort_frame[k];
        bool rotation = true;
        for (int a = 0; a < 3; ++a)
            for (int b = a; b < 3; ++b) {
                const float dot = f[3 * a] * f[3 * b]
                                  + f[3 * a + 1] * f[3 * b + 1]
                                  + f[3 * a + 2] * f[3 * b + 2];
                // written so that a NaN fails it
                if (!(fabsf(dot - (a == b ? 1.0f : 0.0f)) <= 1e-3f))
                    rotation = false;
            }
        if (tid < 9)
            frame[tid] = rotation ? f[tid] : (tid % 4 == 0 ? 1.0f : 0.0f);
    }
    __syncthreads();
    // a box per 32 points (in that frame), and the points themselves where
    // they fit
    for (int s = warp; s < n_sub; s += W) {
        const int c = (s << 5) + lane;
        const bool real = c < n;
        float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (real) {
            const int o = idx[c];
            q = make_float4(pts_c[3 * o], pts_c[3 * o + 1], pts_c[3 * o + 2],
                            nrm[o]);
        }
        if (resident) tile[c] = q;
        const float inf = __int_as_float(0x7f800000);
        const float ru = q.x * frame[0] + q.y * frame[1] + q.z * frame[2];
        const float rv = q.x * frame[3] + q.y * frame[4] + q.z * frame[5];
        const float rw = q.x * frame[6] + q.y * frame[7] + q.z * frame[8];
        float lx = real ? ru : inf, ly = real ? rv : inf,
              lz = real ? rw : inf;
        float hx = real ? ru : -inf, hy = real ? rv : -inf,
              hz = real ? rw : -inf, hn = q.w;
        for (int o = 16; o > 0; o >>= 1) {
            lx = fminf(lx, __shfl_xor_sync(0xffffffffu, lx, o));
            ly = fminf(ly, __shfl_xor_sync(0xffffffffu, ly, o));
            lz = fminf(lz, __shfl_xor_sync(0xffffffffu, lz, o));
            hx = fmaxf(hx, __shfl_xor_sync(0xffffffffu, hx, o));
            hy = fmaxf(hy, __shfl_xor_sync(0xffffffffu, hy, o));
            hz = fmaxf(hz, __shfl_xor_sync(0xffffffffu, hz, o));
            hn = fmaxf(hn, __shfl_xor_sync(0xffffffffu, hn, o));
        }
        if (lane == 0) {
            box[2 * s] = make_float4(lx, ly, lz, 0.0f);
            box[2 * s + 1] = make_float4(hx, hy, hz, hn);
        }
    }

    // --- this block's slice of the i: granules of 32 * P points
    const int n_gran = (n_sub + P - 1) / P;
    const int gpb = (n_gran + S - 1) / S;
    const int g_lo = min(rank * gpb, n_gran);
    const int n_ig = min(n_gran, g_lo + gpb) - g_lo;
    const int own_lo = g_lo * 32 * P;
    const int own_hi = min(n, (g_lo + n_ig) * 32 * P);
    int JS = 1;                 // warps that share a granule
    if (n_ig > 0 && n_ig < W) JS = min(W / n_ig, n_sub);
    const int units = n_ig * JS;

    // every block's buffers are laid out before any remote write
    cluster.sync();

    int r = 0;
    bool conv = false;
    for (;;) {
        ++r;
        // --- the pass over this block's slice: nxt_i = min(cur_i, cur_j of
        // the neighbours j)
        for (int i = own_lo + tid; i < own_hi; i += T) nxt[i] = cur[i];
        __syncthreads();
        for (int u0 = 0; u0 < units; u0 += W) {
            const int u = u0 + warp;
            const bool active = u < units;
            const int g = active ? g_lo + u / JS : 0;
            const int jp = active ? u % JS : 0;
            float x[P], y[P], z[P], w[P];
            int best[P], li[P];
            const float inf = __int_as_float(0x7f800000);
            float4 ilo = make_float4(inf, inf, inf, 0.0f);
            float4 ihi = make_float4(-inf, -inf, -inf, 0.0f);
#pragma unroll
            for (int m = 0; m < P; ++m) {
                const int s = g * P + m;
                const int i = (s << 5) + lane;
                x[m] = y[m] = z[m] = w[m] = 0.0f;
                li[m] = 0;
                best[m] = OSLAM_BIG;
                if (active && i < n) {
                    const int o = idx[i];
                    x[m] = pts_c[3 * o];
                    y[m] = pts_c[3 * o + 1];
                    z[m] = pts_c[3 * o + 2];
                    w[m] = nrm[o];
                    li[m] = cur[i];
                }
                if (active && s < n_sub) {
                    const float4 a = box[2 * s], b = box[2 * s + 1];
                    ilo = make_float4(fminf(ilo.x, a.x), fminf(ilo.y, a.y),
                                      fminf(ilo.z, a.z), 0.0f);
                    ihi = make_float4(fmaxf(ihi.x, b.x), fmaxf(ihi.y, b.y),
                                      fmaxf(ihi.z, b.z), fmaxf(ihi.w, b.w));
                }
            }
            for (int t0 = 0; t0 < n_pad; t0 += tile_cap) {
                if (!resident) {
                    __syncthreads();
                    for (int c = tid; c < tile_cap && t0 + c < n_pad;
                         c += T) {
                        const int o = idx[t0 + c];
                        tile[c] = make_float4(pts_c[3 * o], pts_c[3 * o + 1],
                                              pts_c[3 * o + 2], nrm[o]);
                    }
                    __syncthreads();
                }
                if (!active) continue;
                const int s_lo = t0 >> 5;
                const int s_hi = min(n_sub, (t0 + tile_cap) >> 5);
                int s = s_lo + (jp - s_lo % JS + JS) % JS;
                for (; s < s_hi; s += JS) {
                    if (prune && far_apart(ilo, ihi, box[2 * s],
                                           box[2 * s + 1], tol2))
                        continue;
                    const float4* tp = tile + ((s << 5) - t0);
                    const int* lp = cur + (s << 5);
#pragma unroll 8
                    for (int k = 0; k < 32; ++k) {
                        const float4 q = tp[k];
                        const int l = lp[k];
#pragma unroll
                        for (int m = 0; m < P; ++m) {
                            if constexpr (kPass == OSLAM_PASS_EXACT)
                                best[m] = closer_label_exact(
                                    x[m], y[m], z[m], q, l, tol2, best[m]);
                            else
                                best[m] = closer_label(x[m], y[m], z[m],
                                                       w[m], q, l, tol2,
                                                       best[m]);
                        }
                    }
                }
            }
            if (active) {
#pragma unroll
                for (int m = 0; m < P; ++m)
                    if (best[m] < li[m])
                        atomicMin(&nxt[((g * P + m) << 5) + lane], best[m]);
            }
        }
        __syncthreads();

        // --- this slice's new labels into every block's copy.  Not before
        // every block is through the jumps of the round before
        if (r > 1) cluster_wait();
        for (int rr = 0; rr < S; ++rr) {
            if (rr == rank) continue;
            int* remote = cluster.map_shared_rank(nxt, rr);
            for (int i = own_lo + tid; i < own_hi; i += T) remote[i] = nxt[i];
        }
        cluster.sync();

        // --- did the pass change a label; then the chain passes (chain
        // lane) and the jumps, on all n labels
        bool chg = false;
        for (int i = tid; i < n; i += T) chg = chg || (nxt[i] != cur[i]);
        int* a = nxt;
        int* b = cur;
        if constexpr (kChain) {
            for (int o = 0; o < lane_args.n_orders; ++o) {
                const size_t off = ((size_t)d * lane_args.n_orders + o) * N;
                chg = chain_pass(a, b, n, lane_args.chain_order + off,
                                 lane_args.chain_link + off, scan_vh,
                                 scan_vh + 32)
                      || chg;
                __syncthreads();
                int* t = a;
                a = b;
                b = t;
            }
        }
        for (int it = 0; it < jump_iters; ++it) {
            chg = jump_once<true>(a, b, n) || chg;
            __syncthreads();
            int* t = a;
            a = b;
            b = t;
        }
        cur = a;
        nxt = b;
        if (!__syncthreads_or(chg)) {
            conv = true;
            break;
        }
        if (r >= outer_iters) break;
        cluster_arrive();
    }

    // --- labels back in the original lane numbering
    write_labels(idx, cur, n, S, rank, d, conv, r, out_labels, converged,
                 rounds);
    if (sel.mask == nullptr || rank != 0) return;

    select_epilogue(idx, cur, nxt, n, N, d, conv, sel);
}

// The dynamic shared memory a block of an instantiation may ask for is
// raised to all the room it has once per device (cudaFuncSetAttribute
// costs a runtime call; a graph capture wants none between launches).
struct CcKernel {
    int dev;                    // the device the limit was raised on, or -1
    int room;                   // dynamic shared memory a block can have
};

template <int P, int kPass, bool kChain>
static int launch_cluster_components(
    const float* pts_c, const float* nrm, const uint8_t* mask,
    const int* labels0, int D, int N, float tol2, int outer_iters,
    int jump_iters, int S, int T, int smem_bytes, int prune,
    const float* sort_frame, int frame_stride, int* out_labels,
    uint8_t* converged, int* rounds, const Selection& sel,
    const ClusterLane& lane_args, cudaStream_t stream)
{
    static CcKernel state = {-1, 0};
    auto kernel = cluster_components_kernel<P, kPass, kChain>;
    int dev = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc != cudaSuccess) return (int)rc;
    if (state.dev != dev) {
        cudaFuncAttributes fattr = {};
        int optin = 0;
        rc = cudaFuncGetAttributes(&fattr, (const void*)kernel);
        if (rc == cudaSuccess)
            rc = cudaDeviceGetAttribute(
                &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (rc == cudaSuccess)
            rc = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                optin - (int)fattr.sharedSizeBytes);
        if (rc != cudaSuccess) return (int)rc;
        state.dev = dev;
        state.room = optin - (int)fattr.sharedSizeBytes;
    }
    if (smem_bytes > state.room) return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(S, D, 1);
    cfg.blockDim = dim3(T, 1, 1);
    cfg.dynamicSmemBytes = smem_bytes;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = S;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    rc = cudaLaunchKernelEx(&cfg, kernel, pts_c, nrm, mask, labels0, N, tol2,
                            outer_iters, jump_iters, smem_bytes, prune,
                            sort_frame, frame_stride, out_labels, converged,
                            rounds, sel, lane_args);
    if (rc == cudaSuccess) rc = cudaGetLastError();
    return (int)rc;
}

// S blocks of T threads per detection, smem_bytes of dynamic shared memory
// a block (ops/cluster.LAUNCH_SHAPE, launch_smem); P, the points a lane
// keeps in registers, must be the build's OSLAM_CC_P (one instantiation is
// built; examples/torch_cluster_sweep.py rebuilds with -DOSLAM_CC_P=4 or 8
// to time the others); prune = 0 tests every pair (for timing the skip);
// sort_frame is 9 floats, the rows of the rotation the cloud was sorted in
// (the identity: the axes of the points' coordinates), or with
// frame_stride = 9 one such rotation a detection [D, 9] (the offline batch
// mapper's detections come from frames of B poses); 0 takes the one
// rotation for all.  The rotation changes no result.  Needs
// smem_bytes >= 13 bytes a lane (rounded up to 32 lanes) plus a tile of at
// least 256 points.  exact: the exact lane; chain_order / chain_link with
// n_orders in [1, 3]: the chain lane (else null and 0).
static int cluster_launch(
    const void* pts_c, const void* nrm, const void* mask, const void* labels0,
    int D, int N, float tol2, int outer_iters, int jump_iters, int S, int T,
    int P, int smem_bytes, int prune, const void* sort_frame,
    int frame_stride, void* out_labels, void* converged, void* rounds,
    const Selection& sel, int exact, const ClusterLane& lane_args,
    void* stream)
{
    const int n_pad = (N + 31) & ~31;
    const bool chain = lane_args.chain_order != nullptr;
    if (D < 1 || D > 65535 || N < 1 || S < 1 || S > 8 || T < 32 ||
        T > OSLAM_CC_MAXT || T % 32 != 0 || P != OSLAM_CC_P ||
        outer_iters < 1 || jump_iters < 0 ||
        smem_bytes < 13 * n_pad + 16 * 256)
        return (int)cudaErrorInvalidConfiguration;
    if (sort_frame == nullptr || (frame_stride != 0 && frame_stride != 9))
        return (int)cudaErrorInvalidValue;
    if (chain && (lane_args.chain_link == nullptr ||
                  lane_args.n_orders < 1 || lane_args.n_orders > 3))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const float* p = (const float*)pts_c;
    const float* nm = (const float*)nrm;
    const uint8_t* m = (const uint8_t*)mask;
    const int* l0 = (const int*)labels0;
    const float* sf = (const float*)sort_frame;
    int* ol = (int*)out_labels;
    uint8_t* cv = (uint8_t*)converged;
    int* rd = (int*)rounds;
#define OSLAM_CC_LAUNCH(PASS, CHAIN)                                        \
    launch_cluster_components<OSLAM_CC_P, PASS, CHAIN>(                     \
        p, nm, m, l0, D, N, tol2, outer_iters, jump_iters, S, T,            \
        smem_bytes, prune, sf, frame_stride, ol, cv, rd, sel, lane_args, st)
    if (exact)
        return chain ? OSLAM_CC_LAUNCH(OSLAM_PASS_EXACT, true)
                     : OSLAM_CC_LAUNCH(OSLAM_PASS_EXACT, false);
    return chain ? OSLAM_CC_LAUNCH(OSLAM_PASS_DENSE, true)
                 : OSLAM_CC_LAUNCH(OSLAM_PASS_DENSE, false);
#undef OSLAM_CC_LAUNCH
}

extern "C" int oslam_cluster_components(
    const void* pts_c, const void* nrm, const void* mask, const void* labels0,
    int D, int N, float tol2, int outer_iters, int jump_iters, int S, int T,
    int P, int smem_bytes, int prune, const void* sort_frame,
    int frame_stride, void* out_labels, void* converged, void* rounds,
    int exact, const void* chain_order, const void* chain_link, int n_orders,
    void* stream)
{
    Selection none = {};
    ClusterLane lane_args = {};
    lane_args.chain_order = (const int*)chain_order;
    lane_args.chain_link = (const uint8_t*)chain_link;
    lane_args.n_orders = n_orders;
    return cluster_launch(pts_c, nrm, mask, labels0, D, N, tol2, outer_iters,
                          jump_iters, S, T, P, smem_bytes, prune, sort_frame,
                          frame_stride, out_labels, converged, rounds, none,
                          exact, lane_args, stream);
}

// cluster_components with ops/cluster.select_cluster as its epilogue: the
// same launch, plus the chosen component's point mask and the per-detection
// ok flag (already ANDed with `converged`).
extern "C" int oslam_cluster_select(
    const void* pts_c, const void* nrm, const void* mask, const void* labels0,
    int D, int N, float tol2, int outer_iters, int jump_iters, int S, int T,
    int P, int smem_bytes, int prune, const void* sort_frame,
    int frame_stride, void* out_labels, void* converged, void* rounds,
    int exact, const void* chain_order, const void* chain_link, int n_orders,
    const void* pts,
    const void* center, int min_size, float center_dis, void* least_d,
    void* sel_mask, void* sel_ok, void* stream)
{
    Selection sel = {(const float*)pts, (const float*)center, min_size,
                     center_dis, (int*)least_d, (uint8_t*)sel_mask,
                     (uint8_t*)sel_ok};
    if (sel.pts == nullptr || sel.center == nullptr ||
        sel.least_d == nullptr || sel.mask == nullptr || sel.ok == nullptr)
        return (int)cudaErrorInvalidValue;
    ClusterLane lane_args = {};
    lane_args.chain_order = (const int*)chain_order;
    lane_args.chain_link = (const uint8_t*)chain_link;
    lane_args.n_orders = n_orders;
    return cluster_launch(pts_c, nrm, mask, labels0, D, N, tol2, outer_iters,
                          jump_iters, S, T, P, smem_bytes, prune, sort_frame,
                          frame_stride, out_labels, converged, rounds, sel,
                          exact, lane_args, stream);
}

// ---------------------------------------------------------------------------
// cluster_grid (K13).  Replaces ops/cluster.connected_components_grid of the
// JAX package (:320: the stencil _grid_offsets :291, the stable argsort
// :352, searchsorted side left :359; the extractor's grid_cluster path,
// extractor.py:245-250, left to XLA there): a frame's compaction, neighbour
// lists, every round and the selection in ONE launch, a thread block
// cluster of S blocks per detection (S = 1: a block).
//
// What bounds it is neither the bytes (inputs and outputs once, ~2 us on
// the path frame) nor the operations but the chain of dependent steps in a
// detection's block: the table build, then ~20 rounds of a pass, jumps and
// barriers.  The design:
//  - The neighbour set is JAX's: each survivor's stencil cells around its
//    packed cell key (the cell less the survivors' least cell plus R, 10
//    bits an axis), of each cell's key the first survivor in (key, lane)
//    order, kept where the exact test (dx*dx + dy*dy) + dz*dz <= tol2 on
//    the points passes.  The host passes the stencil as rows
//    (ops/cluster.grid_rows): for one (dx, dy) the cells dz in [-h, h],
//    whose keys are one interval of key offsets; the survivor's own key,
//    inside the middle row's interval, is left out.
//  - A sorted key table in shared memory, not a hash table: every block
//    computes the survivors' keys in lane order.  Where they already
//    ascend (a voxel cloud arrives sorted by cell: depth_cloud's sort) the
//    table is the lane order itself; else the (key, compacted id) pairs
//    are sorted in shared memory (a bitonic sort: on distinct pairs it
//    gives the order of JAX's stable argsort).
//  - Each thread takes a chunk of consecutive sorted survivors.  Their
//    targets ascend with them, so a stencil row costs one search at the
//    chunk's start (the rows ascend too: each row's search gallops on from
//    the row before) and then a forward walk (the row's position in a
//    register): at most 25 searches a chunk.  Two walks: the first counts
//    each survivor's neighbours, a block scan places the chunks, the second
//    writes the lists (16-bit compacted ids).  A walk is a chain of
//    dependent loads per thread, so the points it tests (the window of
//    sorted positions between the block's slice's first key less the
//    stencil's reach and its last key plus it) are staged in shared memory
//    as float4 where they fit: a test then waits on shared memory, not L2.
//  - The lists stay in the block's shared memory beside the labels where
//    they fit (decided on the device from their counted size), else in
//    device memory, through the same code (generic pointers); where they
//    fit, a round reads no L2.
//  - A round is the pass nxt_i = min(cur_i, cur_j over i's list) over the
//    block's slice, with S > 1 the slice and the flag "it changed a label"
//    into every other block's copy through distributed shared memory and
//    one cluster barrier, then up to jump_iters synchronous jumps on the
//    block's own copy.  The jumps stop at the first that changes no label:
//    a jump is a function of the labels, so every later one would change
//    nothing either, and labels, converged and rounds stay those of
//    jump_iters jumps.  The flag is taken per step (labels only decrease).
//    Where a third label buffer fits, the rounds' new labels alternate
//    between two of them, so a block writes into the others' copies
//    without waiting for them to finish the round before (else a split
//    cluster barrier keeps it from writing into a copy still being read).
//  - The launch shape is K13's own (ops/cluster.grid_shape, from the
//    sweep in examples/torch_cluster_sweep.py --grid): clusters of 8 blocks
//    of 512 threads for a frame's detections, fewer blocks where there are
//    so many detections that the clusters run in many waves.
// Precondition: labels0 of an unmasked lane is an unmasked lane of index
// <= its own (ops/cluster.grid_seed).  The plain version is
// ops/cluster.cluster_grid_plain.
// ---------------------------------------------------------------------------
#define OSLAM_GRID_MAXT 512
#define OSLAM_GRID_MAX_ROWS 25      // stencil rows, at most (R <= 2)
#define OSLAM_GRID_MAX_C 124        // stencil cells, at most

// the stencil's rows: row r holds the key offsets [lo[r], hi[r]], the rows
// in ascending order
struct GridRows {
    int n;
    int lo[OSLAM_GRID_MAX_ROWS];
    int hi[OSLAM_GRID_MAX_ROWS];
};

// device memory for what a block's shared memory has no room for: the
// sort's compacted ids (ids_stride a block) and the neighbour lists
// (OSLAM_GRID_MAX_C * N a detection, a block's from its slice's start)
struct GridScratch {
    uint16_t* ids;              // [D, S, ids_stride]
    int ids_stride;             // >= the power of two at or above N
    uint16_t* nbr;              // [D, OSLAM_GRID_MAX_C * N]
};

#ifdef OSLAM_GRID_CLOCKS
// clock64 as thread 0 of each block enters each phase
// (examples/torch_cluster_sweep.py): 0 start, 1 compacted, 2 the key table
// sorted, 3 the lists built, 4 the rounds done, 5 the end; and the cycles
// of all rounds' passes (6), exchanges between the cluster's blocks (7)
// and changed tests and jumps (8)
#define OSLAM_GRID_CLOCK_D 256
__device__ long long oslam_grid_clock[OSLAM_GRID_CLOCK_D][8][9];
#define GRID_CLOCK(i)                                                       \
    if (threadIdx.x == 0 && d < OSLAM_GRID_CLOCK_D)                         \
        oslam_grid_clock[d][rank][i] = clock64()
#define GRID_SPAN(i)                                                        \
    if (threadIdx.x == 0 && d < OSLAM_GRID_CLOCK_D) {                       \
        const long long now = clock64();                                    \
        oslam_grid_clock[d][rank][i] += now - span_at;                      \
        span_at = now;                                                      \
    }
extern "C" int oslam_grid_clocks(void* host)
{
    return (int)cudaMemcpyFromSymbol(host, oslam_grid_clock,
                                     sizeof(oslam_grid_clock));
}
extern "C" int oslam_grid_clocks_clear()
{
    void* at = nullptr;
    cudaError_t rc = cudaGetSymbolAddress(&at, oslam_grid_clock);
    if (rc == cudaSuccess) rc = cudaMemset(at, 0, sizeof(oslam_grid_clock));
    return (int)rc;
}
#else
#define GRID_CLOCK(i)
#define GRID_SPAN(i)
#endif

// a survivor's packed key: its cell less the least cell plus R, each axis
// clamped to 10 bits (JAX's packing)
__device__ __forceinline__ int grid_key(const int* cells, int o, int cx,
                                        int cy, int cz, int R)
{
    const int kx = min(max(cells[3 * o] - cx + R, 0), 1023);
    const int ky = min(max(cells[3 * o + 1] - cy + R, 0), 1023);
    const int kz = min(max(cells[3 * o + 2] - cz + R, 0), 1023);
    return (kx << 20) | (ky << 10) | kz;
}

// the first of the n ascending keys that is >= v (n if none)
__device__ __forceinline__ int lower_bound_key(const int* keys, int n, int v)
{
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (keys[mid] < v) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// the first of the n ascending keys from position `from` on that is >= v,
// where keys[from - 1] < v: an exponential search from `from`
__device__ __forceinline__ int gallop_key(const int* keys, int n, int from,
                                          int v)
{
    int lo = from, hi = from, step = 1;
    while (hi < n && keys[hi] < v) {
        lo = hi + 1;
        hi = lo + step;
        step <<= 1;
    }
    hi = min(hi, n);
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (keys[mid] < v) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// each row's first position for a chunk whose first key is k0: the rows
// ascend, so each row's search starts where the row before it ended
__device__ __forceinline__ void grid_walk_start(
    const int* keys, int n, int k0, const GridRows& rows,
    int (&pos)[OSLAM_GRID_MAX_ROWS])
{
    pos[0] = lower_bound_key(keys, n, k0 + rows.lo[0]);
#pragma unroll
    for (int r = 1; r < OSLAM_GRID_MAX_ROWS; ++r)
        if (r < rows.n)
            pos[r] = gallop_key(keys, n, pos[r - 1], k0 + rows.lo[r]);
}

// The point at sorted position q: from the block's staged window of
// sorted positions [w_lo, ...) where there is one (win not null), else
// through the lane list from device memory.
__device__ __forceinline__ float4 grid_point(
    int q, const float4* win, int w_lo, const uint16_t* ids, const int* idx,
    const float* __restrict__ pts)
{
    if (win != nullptr) return win[q - w_lo];
    const int o = idx[ids != nullptr ? ids[q] : q];
    return make_float4(pts[3 * o], pts[3 * o + 1], pts[3 * o + 2], 0.0f);
}

// The neighbours of the survivor at sorted position s (ids: sorted position
// -> compacted id, null for the identity): per row, the keys in the row's
// interval, of each the first position but for s's own key, kept if the
// exact radius test on the points passes.  pos holds each row's lower bound
// for the chunk's survivor before s (advanced here).  kFill: written to
// out.  Returns their count.
template <bool kFill>
__device__ __forceinline__ int grid_walk(
    const int* keys, const uint16_t* ids, int n, int s, const GridRows& rows,
    int (&pos)[OSLAM_GRID_MAX_ROWS], const float4* win, int w_lo,
    const float* __restrict__ pts, const int* idx, float tol2, uint16_t* out)
{
    const int ks = keys[s];
    const float4 pi = grid_point(s, win, w_lo, ids, idx, pts);
    int hits = 0;
#pragma unroll
    for (int r = 0; r < OSLAM_GRID_MAX_ROWS; ++r) {
        if (r < rows.n) {
            const int lo = ks + rows.lo[r], hi = ks + rows.hi[r];
            int p = pos[r];
            while (p < n && keys[p] < lo) ++p;
            pos[r] = p;
            for (int q = p; q < n; ++q) {
                const int kq = keys[q];
                if (kq > hi) break;
                if (kq == ks || (q > p && keys[q - 1] == kq)) continue;
                const float4 pj = grid_point(q, win, w_lo, ids, idx, pts);
                const float dx = pi.x - pj.x;
                const float dy = pi.y - pj.y;
                const float dz = pi.z - pj.z;
                if ((dx * dx + dy * dy) + dz * dz <= tol2) {
                    if (kFill) out[hits] = (uint16_t)(ids != nullptr ? ids[q]
                                                                     : q);
                    ++hits;
                }
            }
        }
    }
    return hits;
}

// The exclusive prefix sum of v over the block's threads in thread order;
// *total (shared) gets the sum.  warp_tot: 32 ints of shared scratch.  All
// threads call it.
__device__ __forceinline__ int block_exclusive_sum(int v, int* warp_tot,
                                                   int* total)
{
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int W = blockDim.x >> 5;
    int incl = v;
    for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += up;
    }
    __syncthreads();            // warp_tot may still be read
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        const int mine = lane < W ? warp_tot[lane] : 0;
        int wincl = mine;
        for (int o = 1; o < 32; o <<= 1) {
            const int up = __shfl_up_sync(0xffffffffu, wincl, o);
            if (lane >= o) wincl += up;
        }
        warp_tot[lane] = wincl - mine;
        if (lane == 31) *total = wincl;
    }
    __syncthreads();
    return warp_tot[warp] + incl - v;
}

// A block's scalars and scratch, at the start of its dynamic shared memory
// (OSLAM_GRID_HEAD bytes): one per block, also where the CPU build runs a
// cluster's blocks side by side
struct GridHead {
    int warp_off[32];
    int chunk_total;
    int gmin[3];
    int block_hits;
    int chg_in[2][8];   // per round parity, each block's "its pass changed
                        // a label", written by that block (rank)
};
#define OSLAM_GRID_HEAD 256
static_assert(sizeof(GridHead) <= OSLAM_GRID_HEAD, "GridHead outgrew");
// the room a third label buffer leaves for the rest (the sort's ids, the
// staged points and the lists) at the least
#define OSLAM_GRID_KEEP (64 * 1024)

__global__ void __launch_bounds__(OSLAM_GRID_MAXT, 1) cluster_grid_kernel(
    const float* __restrict__ pts, const int* __restrict__ cells,
    const uint8_t* __restrict__ mask, const int* __restrict__ labels0, int N,
    float tol2, int R, const GridRows rows, int outer_iters, int jump_iters,
    int smem_bytes, const GridScratch scratch, int* __restrict__ out_labels,
    uint8_t* __restrict__ converged, int* __restrict__ rounds,
    const Selection sel)
{
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int S = (int)cluster.num_blocks();
    const int d = blockIdx.y;
    const int tid = threadIdx.x, T = blockDim.x;
    const int lane = tid & 31;
    GRID_CLOCK(0);
    pts += (size_t)d * N * 3;
    cells += (size_t)d * N * 3;
    mask += (size_t)d * N;
    labels0 += (size_t)d * N;
    out_labels += (size_t)d * N;

    extern __shared__ int4 grid_smem[];
    GridHead& head = *reinterpret_cast<GridHead*>(grid_smem);

    // --- compaction (compact_lanes): after the head idx, two label
    // buffers and each sorted survivor's neighbour count, 13 bytes a lane;
    // the rest of the room takes a third label buffer, the sort's ids, the
    // lists and the staged points
    int* idx = reinterpret_cast<int*>(reinterpret_cast<char*>(grid_smem)
                                      + OSLAM_GRID_HEAD);
    const int n = compact_lanes(mask, N, S, rank, d, idx, head.warp_off,
                                head.chunk_total, out_labels, sel);
    GRID_CLOCK(1);
    if (n == 0) {               // every block of the cluster takes this exit
        if (rank == 0 && tid == 0) {
            converged[d] = 1;
            rounds[d] = 1;      // the first round changes nothing
            if (sel.mask != nullptr) sel.ok[d] = 0;
        }
        return;
    }
    const int n_pad = (n + 31) & ~31;
    int* lab0 = idx + n_pad;
    int* lab1 = lab0 + n_pad;
    uint8_t* cnt = reinterpret_cast<uint8_t*>(lab1 + n_pad);
    char* free_at = reinterpret_cast<char*>(cnt + n_pad);
    const char* smem_end = reinterpret_cast<const char*>(grid_smem)
                           + smem_bytes;
    // with S > 1, a third label buffer where it leaves room: the rounds'
    // new labels then alternate between two buffers, and no block waits
    // for the others before writing into their copies (a choice from n
    // alone: every block of the cluster makes it alike)
    int* lab2 = nullptr;
    if (S > 1 && free_at + 4 * (size_t)n_pad + OSLAM_GRID_KEEP <= smem_end) {
        lab2 = reinterpret_cast<int*>(free_at);
        free_at += 4 * (size_t)n_pad;
    }

    // --- the key table: the least cell, the keys in lane order (in the
    // labels' room, 2 n_pad ints, which the rounds only need later), and
    // whether they already ascend; else the (key, id) pairs sorted
    if (tid < 3) head.gmin[tid] = 0x7fffffff;
    __syncthreads();
    {
        int mx = 0x7fffffff, my = 0x7fffffff, mz = 0x7fffffff;
        for (int c = tid; c < n; c += T) {
            const int o = idx[c];
            mx = min(mx, cells[3 * o]);
            my = min(my, cells[3 * o + 1]);
            mz = min(mz, cells[3 * o + 2]);
        }
        mx = warp_min(mx);
        my = warp_min(my);
        mz = warp_min(mz);
        if (lane == 0) {
            atomicMin(&head.gmin[0], mx);
            atomicMin(&head.gmin[1], my);
            atomicMin(&head.gmin[2], mz);
        }
    }
    __syncthreads();
    int* keys = lab0;
    for (int c = tid; c < n; c += T)
        keys[c] = grid_key(cells, idx[c], head.gmin[0], head.gmin[1],
                           head.gmin[2], R);
    __syncthreads();
    bool ascend = true;
    for (int c = tid; c + 1 < n; c += T)
        ascend = ascend && keys[c] <= keys[c + 1];
    uint16_t* ids = nullptr;    // sorted position -> compacted id (null:
                                // the identity)
    if (!__syncthreads_and(ascend)) {
        int n2 = 1;
        while (n2 < n) n2 <<= 1;
        const int room = (2 * n2 + 15) & ~15;
        if (free_at + room <= smem_end) {
            ids = reinterpret_cast<uint16_t*>(free_at);
            free_at += room;
        } else {
            ids = scratch.ids + ((size_t)d * S + rank) * scratch.ids_stride;
        }
        for (int c = tid; c < n2; c += T) {
            if (c >= n) keys[c] = 0x7fffffff;
            ids[c] = (uint16_t)(c < n ? c : 0xffff);
        }
        __syncthreads();
        for (int k = 2; k <= n2; k <<= 1)
            for (int j = k >> 1; j > 0; j >>= 1) {
                for (int a = tid; a < n2; a += T) {
                    const int b = a ^ j;
                    if (b <= a) continue;
                    const int ka = keys[a], kb = keys[b];
                    const int ia = ids[a], ib = ids[b];
                    const bool gt = ka > kb || (ka == kb && ia > ib);
                    if (gt == ((a & k) == 0)) {
                        keys[a] = kb;
                        keys[b] = ka;
                        ids[a] = (uint16_t)ib;
                        ids[b] = (uint16_t)ia;
                    }
                }
                __syncthreads();
            }
    }
    GRID_CLOCK(2);

    // --- this block's slice of the sorted survivors, this thread's chunk
    // of it, and the chunk's neighbour lists: counted, placed, written
    const int per = (n + S - 1) / S;
    const int b_lo = min(n, rank * per), b_hi = min(n, b_lo + per);
    const int L = (b_hi - b_lo + T - 1) / T;
    const int s0 = min(b_hi, b_lo + tid * L), s1 = min(b_hi, s0 + L);
    // the window of sorted positions the slice's walks reach (the rows
    // come in the order of their offsets), staged at the end of the room
    // where it fits
    int w_lo = 0, w_hi = 0;
    if (b_lo < b_hi) {
        w_lo = lower_bound_key(keys, n, keys[b_lo] + rows.lo[0]);
        w_hi = lower_bound_key(keys, n, keys[b_hi - 1] + rows.hi[rows.n - 1]
                                        + 1);
    }
    const float4* win = nullptr;
    const char* lists_end = smem_end;
    {
        char* at = reinterpret_cast<char*>(
            reinterpret_cast<size_t>(smem_end - 16 * (size_t)(w_hi - w_lo))
            & ~(size_t)15);
        if (w_lo < w_hi && at >= free_at) {
            float4* w = reinterpret_cast<float4*>(at);
            for (int q = w_lo + tid; q < w_hi; q += T) {
                const int o = idx[ids != nullptr ? ids[q] : q];
                w[q - w_lo] = make_float4(pts[3 * o], pts[3 * o + 1],
                                          pts[3 * o + 2], 0.0f);
            }
            win = w;
            lists_end = at;
        }
    }
    __syncthreads();
    int pos[OSLAM_GRID_MAX_ROWS], pos0[OSLAM_GRID_MAX_ROWS];
    int hits = 0;
    if (s0 < s1) {
        grid_walk_start(keys, n, keys[s0], rows, pos0);
#pragma unroll
        for (int r = 0; r < OSLAM_GRID_MAX_ROWS; ++r) pos[r] = pos0[r];
        for (int s = s0; s < s1; ++s) {
            const int h = grid_walk<false>(keys, ids, n, s, rows, pos, win,
                                           w_lo, pts, idx, tol2, nullptr);
            cnt[s] = (uint8_t)h;
            hits += h;
        }
    }
    const int off0 = block_exclusive_sum(hits, head.warp_off,
                                         &head.block_hits);
    // the lists where they fit beside the staged points, else in the
    // points' room (the second walk then reads the points from device
    // memory), else in device memory
    uint16_t* nbr = reinterpret_cast<uint16_t*>(free_at);
    const char* lists_at = free_at + 2 * (size_t)head.block_hits;
    if (lists_at > smem_end)
        nbr = scratch.nbr + ((size_t)d * N + b_lo) * OSLAM_GRID_MAX_C;
    else if (lists_at > lists_end)
        win = nullptr;
    if (s0 < s1) {
#pragma unroll
        for (int r = 0; r < OSLAM_GRID_MAX_ROWS; ++r) pos[r] = pos0[r];
        int o = off0;
        for (int s = s0; s < s1; ++s)
            o += grid_walk<true>(keys, ids, n, s, rows, pos, win, w_lo, pts,
                                 idx, tol2, nbr + o);
    }
    __syncthreads();            // the keys' room becomes the labels'
    GRID_CLOCK(3);
    seed_compacted(idx, labels0, n, n_pad, lab0, lab1);
    __syncthreads();
    // every block's labels are laid out before any remote write
    if (S > 1) cluster.sync();

    // --- the rounds.  cur: a round's labels.  The pass writes the new
    // labels of the block's slice into `in` (with S > 1 into every block's
    // copy too), the jumps go between `in` and `out`.  Two buffers: in is
    // the one cur is not, and out is cur; a block then waits, before it
    // writes into the others' copies, until every block is through the
    // jumps of the round before.  Three: in alternates between lab1 and
    // lab2 by round, out is lab0, so the copy a round writes into is one
    // no block reads any more
    int* cur = lab0;
    int r = 0;
    bool conv = false;
#ifdef OSLAM_GRID_CLOCKS
    long long span_at = clock64();
#endif
    for (;;) {
        ++r;
        int* in = lab2 != nullptr ? ((r & 1) ? lab2 : lab1)
                                  : (cur == lab0 ? lab1 : lab0);
        int* out = lab2 != nullptr ? lab0 : cur;
        // --- the pass over this thread's chunk
        bool moved = false;
        int k = off0;
        for (int s = s0; s < s1; ++s) {
            const int i = ids != nullptr ? ids[s] : s;
            const int li = cur[i];
            int best = li;
            const int k_end = k + cnt[s];
#pragma unroll 4
            for (; k < k_end; ++k) best = min(best, cur[nbr[k]]);
            in[i] = best;
            moved = moved || best != li;
        }
        bool chg = __syncthreads_or(moved);
        GRID_SPAN(6);
        if (S > 1) {
            // this slice's new labels and its flag into every other
            // block's copy
            if (lab2 == nullptr && r > 1) cluster_wait();
            for (int rr = 0; rr < S; ++rr) {
                if (rr == rank) continue;
                int* remote = cluster.map_shared_rank(in, rr);
                for (int s = b_lo + tid; s < b_hi; s += T) {
                    const int i = ids != nullptr ? ids[s] : s;
                    remote[i] = in[i];
                }
                if (tid == 0)
                    cluster.map_shared_rank(&head, rr)->chg_in[r & 1][rank] =
                        chg;
            }
            if (tid == 0) head.chg_in[r & 1][rank] = chg;
            cluster.sync();
            chg = false;
            for (int rr = 0; rr < S; ++rr) chg = chg || head.chg_in[r & 1][rr];
        }
        GRID_SPAN(7);

        // --- the jumps on all n labels, up to the first that changes none
        int* a = in;
        int* b = out;
        for (int it = 0; it < jump_iters; ++it) {
            const bool jumped = jump_once<true>(a, b, n);
            int* t = a;
            a = b;
            b = t;
            if (!__syncthreads_or(jumped)) break;
            chg = true;
        }
        cur = a;
        GRID_SPAN(8);
        if (!chg) {
            conv = true;
            break;
        }
        if (r >= outer_iters) break;
        if (S > 1 && lab2 == nullptr) cluster_arrive();
    }
    GRID_CLOCK(4);

    write_labels(idx, cur, n, S, rank, d, conv, r, out_labels, converged,
                 rounds);
    if (sel.mask != nullptr && rank == 0)
        select_epilogue(idx, cur, cur == lab0 ? lab1 : lab0, n, N, d, conv,
                        sel);
    GRID_CLOCK(5);
}

// The dynamic shared memory cluster_grid_kernel may ask for, raised to all
// its room once per device (see CcKernel).
static int grid_room(int* room)
{
    static CcKernel state = {-1, 0};
    int dev = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc != cudaSuccess) return (int)rc;
    if (state.dev != dev) {
        cudaFuncAttributes fattr = {};
        int optin = 0;
        rc = cudaFuncGetAttributes(&fattr, (const void*)cluster_grid_kernel);
        if (rc == cudaSuccess)
            rc = cudaDeviceGetAttribute(
                &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (rc == cudaSuccess)
            rc = cudaFuncSetAttribute(
                cluster_grid_kernel,
                cudaFuncAttributeMaxDynamicSharedMemorySize,
                optin - (int)fattr.sharedSizeBytes);
        if (rc != cudaSuccess) return (int)rc;
        state.dev = dev;
        state.room = optin - (int)fattr.sharedSizeBytes;
    }
    *room = state.room;
    return 0;
}

static cudaLaunchConfig_t grid_config(int S, int D, int T, int smem_bytes,
                                      cudaLaunchAttribute* attr,
                                      cudaStream_t stream)
{
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(S, D, 1);
    cfg.blockDim = dim3(T, 1, 1);
    cfg.dynamicSmemBytes = smem_bytes;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = S;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

// cluster_grid (K13): pts [D, N, 3] the points the cells were computed from
// (camera frame on the extraction path), cells [D, N, 3] int32, mask, labels0
// (chain-seeded on pts), R the stencil's rings and rows its rows (host
// ints: their count, then each row's lo and hi; ops/cluster.grid_rows);
// ids [D, S, ids_stride] and nbr [D, 124 N] uint16 device scratch
// (ops/cluster._launch_grid); with pts_w (not null) the selection epilogue
// on those points and center [D, 3] (else center, min_size, center_dis,
// least_d, sel_mask and sel_ok are not read).  S blocks of T threads a
// detection, smem_bytes of dynamic shared memory a block (at least the
// head and 13 bytes a lane, rounded up to 32 lanes; ops/cluster.grid_smem).
extern "C" int oslam_cluster_grid(
    const void* pts, const void* cells, const void* mask, const void* labels0,
    int D, int N, float tol2, int R, const int* rows, int outer_iters,
    int jump_iters, int S, int T, int smem_bytes, void* ids, int ids_stride,
    void* nbr, void* out_labels, void* converged, void* rounds,
    const void* pts_w, const void* center, int min_size, float center_dis,
    void* least_d, void* sel_mask, void* sel_ok, void* stream)
{
    const int n_pad = (N + 31) & ~31;
    int n2 = 1;
    while (n2 < N) n2 <<= 1;
    if (D < 1 || D > 65535 || N < 1 || N > 65535 || S < 1 || S > 8 ||
        T < 32 || T > OSLAM_GRID_MAXT || T % 32 != 0 || outer_iters < 1 ||
        jump_iters < 0 || smem_bytes < OSLAM_GRID_HEAD + 13 * n_pad)
        return (int)cudaErrorInvalidConfiguration;
    if (pts == nullptr || cells == nullptr || rows == nullptr ||
        ids == nullptr || nbr == nullptr || ids_stride < n2 || R < 1 ||
        rows[0] < 1 || rows[0] > OSLAM_GRID_MAX_ROWS)
        return (int)cudaErrorInvalidValue;
    GridRows gr = {};
    gr.n = rows[0];
    for (int r = 0; r < gr.n; ++r) {
        gr.lo[r] = rows[1 + 2 * r];
        gr.hi[r] = rows[2 + 2 * r];
        // each an interval, in ascending order (the window of a slice's
        // walks runs from the first row's lo to the last row's hi)
        if (gr.lo[r] > gr.hi[r] || (r > 0 && gr.lo[r] <= gr.hi[r - 1]))
            return (int)cudaErrorInvalidValue;
    }
    Selection sel = {};
    if (pts_w != nullptr) {
        sel = {(const float*)pts_w, (const float*)center, min_size,
               center_dis, (int*)least_d, (uint8_t*)sel_mask,
               (uint8_t*)sel_ok};
        if (sel.center == nullptr || sel.least_d == nullptr ||
            sel.mask == nullptr || sel.ok == nullptr)
            return (int)cudaErrorInvalidValue;
    }
    int room = 0;
    int rc = grid_room(&room);
    if (rc != 0) return rc;
    if (smem_bytes > room) return (int)cudaErrorInvalidValue;
    const GridScratch scratch = {(uint16_t*)ids, ids_stride, (uint16_t*)nbr};
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = grid_config(S, D, T, smem_bytes, attr,
                                               (cudaStream_t)stream);
    cudaError_t err = cudaLaunchKernelEx(
        &cfg, cluster_grid_kernel, (const float*)pts, (const int*)cells,
        (const uint8_t*)mask, (const int*)labels0, N, tol2, R, gr,
        outer_iters, jump_iters, smem_bytes, scratch, (int*)out_labels,
        (uint8_t*)converged, (int*)rounds, sel);
    if (err == cudaSuccess) err = cudaGetLastError();
    return (int)err;
}

// How many clusters of S blocks of T threads with smem_bytes of dynamic
// shared memory the card holds at once (cudaOccupancyMaxActiveClusters):
// a launch of more detections runs in waves.
extern "C" int oslam_cluster_grid_max_clusters(int S, int T, int smem_bytes,
                                               int* out)
{
    int room = 0;
    int rc = grid_room(&room);
    if (rc != 0) return rc;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = grid_config(S, 1, T, smem_bytes, attr,
                                               nullptr);
    return (int)cudaOccupancyMaxActiveClusters(out, cluster_grid_kernel,
                                               &cfg);
}

// ---------------------------------------------------------------------------
// symmetry_search.  Replaces frontend/symmetry.py _mirror_cost (:72) inside
// _optimize_one_init (:156) and estimate_symmetry (:217) of the JAX package
// (left to XLA there): for every detection of a frame whose symmetry type is
// 1 (one plane) or 2 (a dual pair) and each of its 9 initial planes, the
// 5-iteration LM over the plane parameters, then the pick of the winner.
//
// Bound by operations: a cost pass tests every mirrored point against every
// live point of the cloud (P n x n pair tests of ~10 f32 operations, P = 1
// or 2 planes, n <= 2048 live points), and a search runs 1 + iters passes
// with the exact gradient (a trial pass carries the gradient at its
// parameters, kept on a reject), 1 + iters (2 n_par + 1) with central
// differences; the bytes are a few KB a detection.  At the path's shapes
// (tens of live points) that is little work: what bounds a launch is the
// chain of dependent passes in each block, each ending in a block
// reduction and a small solve by one thread.  The design:
//  - one block of OSLAM_SYM_T threads per (initial plane, detection); a
//    detection of type 0 or off the run mask leaves at once (the JAX
//    package computes it and throws it away), and a detection's own type
//    picks one plane or two, so one launch serves both variants;
//  - the live points compacted into shared memory in index order as float4
//    (x, y, z, |p|^2): the 1-NN loop runs over them only;
//  - with a source mask (sparse symmetry, JAX's src_mask): the mirrored
//    points are the live points it holds, kept as 16-bit indices into the
//    live points (2 bytes a point beside the 16 of a float4: 36 KB at 2048
//    points, under the 48 KB a block has without an opt-in), compacted in
//    index order in the same pass; every live point stays the 1-NN
//    reference and the cost is the mean over P n_src mirrored points.
//    Without one the sources are the live points themselves, read as
//    before;
//  - the mirrored points strided over the block, up to OSLAM_SYM_R a
//    thread at once: one scan over the live points feeds a 1-NN chain per
//    point (sym_tile), one shared-memory load a step for all of them; a
//    chain keeps the least squared distance by the norm expansion
//    q + r - 2 m.p (JAX's cost is defined by it) and, for the gradient, how
//    many points lie at that distance and their sum (jnp.min splits its
//    gradient evenly over equal minima); max(d2, 0) passes 1 above 0, 1/2
//    at 0 (jnp.maximum) and 0 below; the occlusion, box and mask tests are
//    piecewise constant;
//  - the gradient by hand in the same pass: dd2/dm = 2 m - 2 p_nn, through
//    m = p - 2 s n, s = (n.p + d) / max(|n|^2, 1e-8) to (n0, n1, d) of each
//    plane, then to (angle, distance[, dual distance]); the dual plane's
//    azimuth goes through atan2;
//  - the pixel of a mirrored point truncates toward zero (astype(int32));
//    the ray depth d sqrt(xi^2 + f^2 + yi^2) / f of ops/backproject.
//    proj_depth_map is computed at the looked-up pixel, so no map is
//    written;
//  - the sums of a pass in a fixed order (a thread's points in order, the
//    lanes by a fixed xor pattern, the warps in rank order, lane c of warp
//    0 adding sum c): repeats are bit-equal;
//  - thread 0 runs the LM between passes and computes the planes of the
//    next pass once for the block (frontend/symmetry.
//    optimize_inits_plain: the 2x2 / 3x3 Cholesky solve in ops/linalg.
//    chol_solve_small's order, the finite-step gate, the accept test, the
//    damping);
//  - the nine blocks of a detection count themselves in on a counter (zero
//    at the launch); the last one picks the winner, the first maximum of
//    exp(-cost) as jnp.argmax.
// The plain arithmetic (the mirror, the projection, the pair test) is
// written in frontend/symmetry._mirror_cost's order.
// ---------------------------------------------------------------------------
#define OSLAM_SYM_T 256
#define OSLAM_SYM_W (OSLAM_SYM_T / 32)
#define OSLAM_SYM_MAX_S 2048        // ops/frontend_kernels.SYM_MAX_POINTS
#define OSLAM_SYM_INITS 9
#define OSLAM_SYM_FIELDS 5          // angle, distance, dual distance, cost, prob
#define OSLAM_SYM_SUMS 7            // cost sum, (dn0, dn1, dd) of each plane
#define OSLAM_SYM_R 4               // mirrored points a thread scans at once

struct SymArgs {
    const float* pts;       // [D, S, 3] normalized object clouds
    const uint8_t* mask;    // [D, S]
    const uint8_t* src_mask;    // [D, S] the points mirrored, or null: all
    const float* bbox;      // [D, 4]
    const float* pose_oc;   // [D, 7] the camera in the normalized frame
    const int* depth;       // [H, W] raw depth, or [B, H, W] with frame
    const int* frame;       // [D] each detection's frame of the batch, or
                            // null: one frame
    const int* types;       // [D] 0 none, 1 reflection, 2 dual reflection
    const uint8_t* run;     // [D]
    int S, H, W;
    float fx, fy, cx, cy, scale;
    float ff;               // fx * fx rounded once from double
    float coef;             // -0.5 / sigma^2
    float ang_step, step_dis, h, two_h;
    int iters, analytic;
    float* plane;           // [D, 4]
    float* dual_dis;        // [D]
    float* prob;            // [D]
    float* error;           // [D]
    float* inits;           // [D, 9, 5]
    int* done;              // [D] blocks finished, zero at the launch
};

// max that propagates a NaN, as torch.clamp_min / jnp.maximum
__device__ __forceinline__ float max_nan(float a, float b)
{
    return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

// The planes of the parameters (angle, distance[, dual distance]):
// (sin a, -cos a, 0, -dis) and, for the dual type, the plane of the same
// azimuth atan2(n1, n0) at the dual distance.  n2 = max(|n|^2, 1e-8).
struct SymPlanes {
    float n0[2], n1[2], d[2], n2[2];
    float az;
};

__device__ __forceinline__ SymPlanes sym_planes(const float* par, bool dual)
{
    SymPlanes pl;
    pl.n0[0] = sinf(par[0]);
    pl.n1[0] = -cosf(par[0]);
    pl.d[0] = -par[1];
    pl.n2[0] = max_nan(pl.n0[0] * pl.n0[0] + pl.n1[0] * pl.n1[0]
                       + 0.0f * 0.0f, 1e-8f);
    pl.az = 0.0f;
    pl.n0[1] = pl.n1[1] = pl.d[1] = pl.n2[1] = 0.0f;
    if (dual) {
        pl.az = atan2f(pl.n1[0], pl.n0[0]);
        pl.n0[1] = sinf(pl.az);
        pl.n1[1] = -cosf(pl.az);
        pl.d[1] = -par[2];
        pl.n2[1] = max_nan(pl.n0[1] * pl.n0[1] + pl.n1[1] * pl.n1[1]
                           + 0.0f * 0.0f, 1e-8f);
    }
    return pl;
}

// A tile of mirrored points: slot r of a thread holds mirrored point
// i = base + r T + tid (T = OSLAM_SYM_T) if i < M, plane 0's points
// (source i < ns: ref[sidx[i]] with kSparse, else ref[i]) first, then
// plane 1's.  One scan over the reference
// points feeds RR independent 1-NN chains, one float4 load a step for all
// of them; each chain keeps its minimum, the count of points at it and
// their sum in reference order (jnp.min splits its gradient evenly over
// equal minima), so the slots' terms, added to acc in increasing i, carry
// the bits of a scan per point.  `pose` holds R (9) and t (3) of T_c<-o and
// the camera centre (3); `gd2` is d cost / d d2 of a scored point.
template <bool kGrad, int RR, bool kSparse>
__device__ __forceinline__ void sym_tile(
    const SymArgs& a, const uint16_t* sidx, int ns, const float4* ref, int nr,
    int M, int base, const SymPlanes& pl, const float* pose, const float* bb,
    const int* depth, float gd2, float* acc)
{
    float mx[RR], my[RR], mz[RR], qn[RR], sv[RR];
    bool on[RR], second[RR], occ[RR];
#pragma unroll
    for (int r = 0; r < RR; ++r) {
        const int i = base + r * OSLAM_SYM_T + (int)threadIdx.x;
        on[r] = i < M;
        second[r] = i >= ns;
        const int k = on[r] ? (second[r] ? i - ns : i) : 0;
        float4 p;
        if constexpr (kSparse)
            p = ref[sidx[k]];
        else
            p = ref[k];
        const float n0 = second[r] ? pl.n0[1] : pl.n0[0];
        const float n1 = second[r] ? pl.n1[1] : pl.n1[0];
        const float n2 = second[r] ? pl.n2[1] : pl.n2[0];
        const float dq = second[r] ? pl.d[1] : pl.d[0];
        const float s = (n0 * p.x + n1 * p.y + 0.0f * p.z + dq) / n2;
        sv[r] = s;
        mx[r] = p.x - 2.0f * s * n0;
        my[r] = p.y - 2.0f * s * n1;
        mz[r] = p.z - 2.0f * s * 0.0f;

        // into the image: occluded where it falls strictly inside the box
        // on a zero ray depth or one nearer than the point
        const float pcx = pose[0] * mx[r] + pose[1] * my[r] + pose[2] * mz[r]
                          + pose[9];
        const float pcy = pose[3] * mx[r] + pose[4] * my[r] + pose[5] * mz[r]
                          + pose[10];
        const float pcz = pose[6] * mx[r] + pose[7] * my[r] + pose[8] * mz[r]
                          + pose[11];
        const float den = max_nan(pcz, 1e-6f);
        const float u = a.fx * pcx / den + a.cx;
        const float v = a.fy * pcy / den + a.cy;
        const int xi = __float2int_rz(u), yi = __float2int_rz(v);
        const float xf = (float)xi, yf = (float)yi;
        const bool inside = xi >= 0 && xi < a.W && yi >= 0 && yi < a.H
                            && pcz > 0.0f;
        occ[r] = false;
        if (on[r] && bb[0] < xf && xf < bb[2] && bb[1] < yf && yf < bb[3]
            && inside) {
            const float rx = (float)xi - a.cx, ry = (float)yi - a.cy;
            const float ray = (float)depth[yi * a.W + xi]
                              * (sqrtf(rx * rx + a.ff + ry * ry) / a.fx);
            const float dm = ray / a.scale;
            const float ex = mx[r] - pose[12], ey = my[r] - pose[13],
                        ez = mz[r] - pose[14];
            const float dis = sqrtf(ex * ex + ey * ey + ez * ez);
            occ[r] = dm <= 1e-9f || dis > dm;
        }
        qn[r] = mx[r] * mx[r] + my[r] * my[r] + mz[r] * mz[r];
    }

    // the least squared distance to the reference points, by selects
    float best[RR], sx[RR], sy[RR], sz[RR];
    int cnt[RR];
#pragma unroll
    for (int r = 0; r < RR; ++r) {
        best[r] = 1e30f;
        sx[r] = sy[r] = sz[r] = 0.0f;
        cnt[r] = 0;
    }
#pragma unroll 8
    for (int j = 0; j < nr; ++j) {
        const float4 q = ref[j];
#pragma unroll
        for (int r = 0; r < RR; ++r) {
            const float cross = mx[r] * q.x + my[r] * q.y + mz[r] * q.z;
            const float d2 = qn[r] + q.w - 2.0f * cross;
            if (kGrad) {
                const bool lt = d2 < best[r], eq = d2 == best[r];
                best[r] = lt ? d2 : best[r];
                cnt[r] = lt ? 1 : (eq ? cnt[r] + 1 : cnt[r]);
                sx[r] = lt ? q.x : (eq ? sx[r] + q.x : sx[r]);
                sy[r] = lt ? q.y : (eq ? sy[r] + q.y : sy[r]);
                sz[r] = lt ? q.z : (eq ? sz[r] + q.z : sz[r]);
            } else {
                best[r] = fminf(best[r], d2);
            }
        }
    }

#pragma unroll
    for (int r = 0; r < RR; ++r) {
        if (!on[r]) continue;
        const float nn2 = max_nan(best[r], 0.0f);
        acc[0] += a.coef * (occ[r] ? 0.0f : nn2);
        if (kGrad && !occ[r]) {
            const float w = best[r] > 0.0f ? gd2
                            : (best[r] == 0.0f ? 0.5f * gd2 : 0.0f);
            if (w != 0.0f && cnt[r] > 0) {
                const float n0 = second[r] ? pl.n0[1] : pl.n0[0];
                const float n1 = second[r] ? pl.n1[1] : pl.n1[0];
                const float n2 = second[r] ? pl.n2[1] : pl.n2[0];
                // d cost / dm = w (2 m - 2 mean of the nearest points)
                const float wc = w / (float)cnt[r];
                const float gx = 2.0f * (mx[r] * w) - 2.0f * (wc * sx[r]);
                const float gy = 2.0f * (my[r] * w) - 2.0f * (wc * sy[r]);
                const float gz = 2.0f * (mz[r] * w) - 2.0f * (wc * sz[r]);
                // m = p - 2 s n, s = (n.p + d) / n2: d/ds, then (n0, n1, d)
                const float gsn = -2.0f * (gx * n0 + gy * n1 + gz * 0.0f) / n2;
                const float e0 = -2.0f * sv[r] * gx + gsn * mx[r];
                const float e1 = -2.0f * sv[r] * gy + gsn * my[r];
                if (second[r]) {
                    acc[4] += e0;
                    acc[5] += e1;
                    acc[6] += gsn;
                } else {
                    acc[1] += e0;
                    acc[2] += e1;
                    acc[3] += gsn;
                }
            }
        }
    }
}

// One cost pass of a block at the planes `spl` (thread 0 computes them once
// a pass and publishes them in shared memory): the mirrored points (the ns
// sources, ref[sidx[.]] with kSparse, else ref[0, ns), across each plane)
// are scored against the reference points ref[0, nr) (the live points), a
// tile of up to OSLAM_SYM_R points a thread at a time; the partial sums go
// to red[warp][.] (cost sum and, with kGrad, d cost / d(n0, n1, d) of each
// plane), then one barrier.
template <bool kGrad, bool kSparse>
__device__ void sym_pass(const SymArgs& a, const uint16_t* sidx, int ns,
                         const float4* ref, int nr, bool dual,
                         const SymPlanes* spl, const float* pose,
                         const float* bb, const int* depth, float gd2,
                         float (*red)[OSLAM_SYM_SUMS])
{
    const SymPlanes pl = *spl;
    const int M = (dual ? 2 : 1) * ns;
    float acc[OSLAM_SYM_SUMS];
#pragma unroll
    for (int c = 0; c < OSLAM_SYM_SUMS; ++c) acc[c] = 0.0f;
    // a tile's rows for the warp: the slots that hold a point for its
    // lane 0 (the most of any lane), warp-uniform
    const int lane0 = threadIdx.x & ~31;
    for (int base = 0; base < M; base += OSLAM_SYM_R * OSLAM_SYM_T) {
        const int left = M - base - lane0;
        if (left <= 0) break;
        const int rows = (left + OSLAM_SYM_T - 1) / OSLAM_SYM_T;
        if (rows >= 3)
            sym_tile<kGrad, 4, kSparse>(a, sidx, ns, ref, nr, M, base, pl,
                                        pose, bb, depth, gd2, acc);
        else if (rows == 2)
            sym_tile<kGrad, 2, kSparse>(a, sidx, ns, ref, nr, M, base, pl,
                                        pose, bb, depth, gd2, acc);
        else
            sym_tile<kGrad, 1, kSparse>(a, sidx, ns, ref, nr, M, base, pl,
                                        pose, bb, depth, gd2, acc);
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int c = 0; c < OSLAM_SYM_SUMS; ++c) {
        if (!kGrad && c > 0) break;
        float v = acc[c];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) red[warp][c] = v;
    }
    __syncthreads();
}

// The totals of a pass for thread 0, called by all of warp 0: lane c adds
// partial c over the warps in rank order, lane 0 gathers them.
template <int kSums>
__device__ __forceinline__ void sym_totals(float (*red)[OSLAM_SYM_SUMS],
                                           float* tot)
{
    const int lane = threadIdx.x & 31;
    float s = 0.0f;
    if (lane < kSums) {
        s = red[0][lane];
        for (int w = 1; w < OSLAM_SYM_W; ++w) s += red[w][lane];
    }
#pragma unroll
    for (int c = 0; c < kSums; ++c) tot[c] = __shfl_sync(0xffffffffu, s, c);
}

// The gradient over the parameters from a kGrad pass's totals at the
// parameters whose planes are pl: cos and sin of the angle and of the
// azimuth are read off the planes (n0 = sin, n1 = -cos).
__device__ __forceinline__ void sym_grad(const float* tot, const SymPlanes& pl,
                                         bool dual, float* g)
{
    float g_n0 = tot[1], g_n1 = tot[2];
    if (dual) {
        // the second plane's azimuth is atan2(n1, n0) of the first
        const float g_az = tot[4] * -pl.n1[1] + tot[5] * pl.n0[1];
        const float r2 = pl.n0[0] * pl.n0[0] + pl.n1[0] * pl.n1[0];
        g_n0 += g_az * (-pl.n1[0] / r2);
        g_n1 += g_az * (pl.n0[0] / r2);
        g[2] = -tot[6];
    }
    g[0] = g_n0 * -pl.n1[0] + g_n1 * pl.n0[0];
    g[1] = -tot[3];
}

// kSparse: a.src_mask is given (the sources are kept as indices); without
// it the kernel is the dense search, instruction for instruction.  kFrames:
// a.frame is given (the offline batch mapper: each detection looks its
// pixels up in its own frame's depth image); without it the launch is a
// frame's, instruction for instruction.
template <bool kSparse, bool kFrames>
__global__ void __launch_bounds__(OSLAM_SYM_T) symmetry_search_kernel(
    const SymArgs a)
{
    extern __shared__ float4 ref[];     // the detection's live points, then
                                        // with a source mask the sources
    __shared__ float red[OSLAM_SYM_W][OSLAM_SYM_SUMS];
    __shared__ SymPlanes spl;           // the planes of the next pass
    __shared__ int wcount[OSLAM_SYM_W], scount[OSLAM_SYM_W];
    __shared__ int last;
    const int k = blockIdx.x, d = blockIdx.y, tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int type = a.types[d];
    const bool dual = type == 2;
    float* ini = a.inits + ((size_t)d * OSLAM_SYM_INITS + k)
                           * OSLAM_SYM_FIELDS;
    if (a.run[d] == 0 || (type != 1 && type != 2)) {
        if (tid < OSLAM_SYM_FIELDS) ini[tid] = 0.0f;
        if (k == 0 && tid == 0) {
            a.plane[4 * d + 0] = 0.0f;
            a.plane[4 * d + 1] = -1.0f;
            a.plane[4 * d + 2] = 0.0f;
            a.plane[4 * d + 3] = 0.0f;
            a.dual_dis[d] = 0.0f;
            a.prob[d] = 0.0f;
            a.error[d] = 0.0f;
        }
        return;
    }

    // the live points, in index order; with a source mask the indices of
    // the sources among them, in index order too
    const float* pts = a.pts + (size_t)d * a.S * 3;
    const uint8_t* msk = a.mask + (size_t)d * a.S;
    const uint8_t* smsk = kSparse ? a.src_mask + (size_t)d * a.S : nullptr;
    uint16_t* sidx = kSparse ? (uint16_t*)(ref + a.S) : nullptr;
    int n = 0, ns = 0;
    for (int c0 = 0; c0 < a.S; c0 += OSLAM_SYM_T) {
        const int i = c0 + tid;
        const bool live = i < a.S && msk[i] != 0;
        const unsigned bal = __ballot_sync(0xffffffffu, live);
        bool src = false;
        unsigned sbal = 0u;
        if constexpr (kSparse) {
            src = live && smsk[i] != 0;
            sbal = __ballot_sync(0xffffffffu, src);
        }
        if (lane == 0) {
            wcount[warp] = __popc(bal);
            if constexpr (kSparse) scount[warp] = __popc(sbal);
        }
        __syncthreads();
        int off = n, total = n, soff = ns, stotal = ns;
        for (int w = 0; w < OSLAM_SYM_W; ++w) {
            if (w < warp) {
                off += wcount[w];
                if constexpr (kSparse) soff += scount[w];
            }
            total += wcount[w];
            if constexpr (kSparse) stotal += scount[w];
        }
        if (live) {
            const int at = off + __popc(bal & ((1u << lane) - 1u));
            const float x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
            ref[at] = make_float4(x, y, z, x * x + y * y + z * z);
            if constexpr (kSparse)
                if (src)
                    sidx[soff + __popc(sbal & ((1u << lane) - 1u))] =
                        (uint16_t)at;
        }
        n = total;
        ns = stotal;
        __syncthreads();        // wcount and scount are reused
    }
    if constexpr (!kSparse) ns = n;

    // T_c<-o = inv(pose_oc) as core/se3.se3_inv and quat_to_mat write it
    float pose[15];
    {
        const float* po = a.pose_oc + 7 * d;
        const float qx = -po[3], qy = -po[4], qz = -po[5], qw = po[6];
        const float vx = po[0], vy = po[1], vz = po[2];
        const float t2x = 2.0f * (qy * vz - qz * vy);
        const float t2y = 2.0f * (qz * vx - qx * vz);
        const float t2z = 2.0f * (qx * vy - qy * vx);
        pose[9] = -(vx + qw * t2x + (qy * t2z - qz * t2y));
        pose[10] = -(vy + qw * t2y + (qz * t2x - qx * t2z));
        pose[11] = -(vz + qw * t2z + (qx * t2y - qy * t2x));
        const float xx = qx * qx, yy = qy * qy, zz = qz * qz;
        const float xy = qx * qy, xz = qx * qz, yz = qy * qz;
        const float wx = qw * qx, wy = qw * qy, wz = qw * qz;
        pose[0] = 1.0f - 2.0f * (yy + zz);
        pose[1] = 2.0f * (xy - wz);
        pose[2] = 2.0f * (xz + wy);
        pose[3] = 2.0f * (xy + wz);
        pose[4] = 1.0f - 2.0f * (xx + zz);
        pose[5] = 2.0f * (yz - wx);
        pose[6] = 2.0f * (xz - wy);
        pose[7] = 2.0f * (yz + wx);
        pose[8] = 1.0f - 2.0f * (xx + yy);
        pose[12] = po[0];
        pose[13] = po[1];
        pose[14] = po[2];
    }
    const float* bb = a.bbox + 4 * d;
    const int* depth = a.depth;
    if constexpr (kFrames) depth += (size_t)a.frame[d] * a.H * a.W;
    const int n_par = dual ? 3 : 2;
    const float nv = fmaxf((float)((dual ? 2 : 1) * ns), 1.0f);
    const float gd2 = -(1.0f / nv) * a.coef;    // d cost / d d2

    // thread 0's LM state: params, cost, damping, the gradient at p
    float p[3], p_new[3], c = 0.0f, lam = -1.0f, nu = 2.0f;
    float g[3] = {0.0f, 0.0f, 0.0f};
    {
        const float steps[3] = {-1.0f, 0.0f, 1.0f};
        p_new[0] = p[0] = steps[k / 3] * a.ang_step;
        p_new[1] = p[1] = steps[k % 3] * a.step_dis;
        p_new[2] = p[2] = 0.0f;
    }

    // Pass it = -1 scores p0, pass it >= 0 the trial p_new of LM iteration
    // it.  With the exact gradient a pass carries the gradient at its
    // parameters too, all but the last trial: on accept it is the next
    // iteration's gradient, on reject p stays and so does g.  That is
    // 1 + iters passes a search; central differences add 2 n_par.
    for (int it = -1; it < a.iters; ++it) {
        float lam0 = lam;
        if (it >= 0 && !a.analytic) {
            // central differences, step h
            float cp[3], cm[3];
            for (int kk = 0; kk < n_par; ++kk) {
                for (int sgn = 0; sgn < 2; ++sgn) {
                    if (tid == 0) {
                        float q[3];
                        for (int j = 0; j < 3; ++j) {
                            const float step = j == kk ? a.h : 0.0f;
                            q[j] = sgn == 0 ? p[j] + step : p[j] - step;
                        }
                        spl = sym_planes(q, dual);
                    }
                    __syncthreads();
                    sym_pass<false, kSparse>(a, sidx, ns, ref, n, dual,
                                             &spl, pose, bb, depth, gd2,
                                             red);
                    if (warp == 0) {
                        float tot[1];
                        sym_totals<1>(red, tot);
                        const float ck = -tot[0] / nv;
                        if (sgn == 0) cp[kk] = ck; else cm[kk] = ck;
                    }
                }
            }
            if (tid == 0)
                for (int kk = 0; kk < n_par; ++kk)
                    g[kk] = (cp[kk] - cm[kk]) / a.two_h;
        }

        if (it >= 0 && tid == 0) {
            // the LM step: H = g g^T, b = g c, A = H + lam0 I
            float A[3][3], b[3];
            float mdiag = g[0] * g[0] * 1.0f;
            for (int i = 0; i < n_par; ++i) {
                for (int j = 0; j < n_par; ++j) A[i][j] = g[i] * g[j] * 1.0f;
                b[i] = g[i] * c;
                if (i > 0) mdiag = max_nan(mdiag, A[i][i]);
            }
            if (lam < 0.0f) lam0 = 1e-5f * max_nan(mdiag, 1e-6f);
            for (int i = 0; i < n_par; ++i)
                for (int j = 0; j < n_par; ++j)
                    A[i][j] = A[i][j] + lam0 * (i == j ? 1.0f : 0.0f);
            // Cholesky, forward and back substitution
            float L[3][3], y[3], x[3];
            for (int i = 0; i < n_par; ++i)
                for (int j = 0; j <= i; ++j) {
                    float s = A[i][j];
                    for (int q = 0; q < j; ++q) s = s - L[i][q] * L[j][q];
                    L[i][j] = i == j ? sqrtf(max_nan(s, 1e-20f)) : s / L[j][j];
                }
            for (int i = 0; i < n_par; ++i) {
                float s = b[i];
                for (int q = 0; q < i; ++q) s = s - L[i][q] * y[q];
                y[i] = s / L[i][i];
            }
            bool finite = true;
            for (int i = n_par - 1; i >= 0; --i) {
                float s = y[i];
                for (int q = i + 1; q < n_par; ++q) s = s - L[q][i] * x[q];
                x[i] = s / L[i][i];
                finite = finite && isfinite(x[i]);
            }
            for (int i = 0; i < 3; ++i) p_new[i] = p[i];
            for (int i = 0; i < n_par; ++i)
                p_new[i] = p[i] + (finite ? -x[i] : 0.0f);
        }
        if (tid == 0) spl = sym_planes(p_new, dual);
        __syncthreads();
        const bool grad = a.analytic && it + 1 < a.iters;
        float tot[OSLAM_SYM_SUMS];
        if (grad) {
            sym_pass<true, kSparse>(a, sidx, ns, ref, n, dual, &spl, pose,
                                    bb, depth, gd2, red);
            if (warp == 0) sym_totals<OSLAM_SYM_SUMS>(red, tot);
        } else {
            sym_pass<false, kSparse>(a, sidx, ns, ref, n, dual, &spl, pose,
                                     bb, depth, gd2, red);
            if (warp == 0) sym_totals<1>(red, tot);
        }
        if (tid == 0) {
            const float c_new = -tot[0] / nv;
            const bool accept = it < 0 || (c_new < c && isfinite(c_new));
            if (accept) {
                p[0] = p_new[0];
                p[1] = p_new[1];
                p[2] = p_new[2];
                c = c_new;
                if (grad) sym_grad(tot, spl, dual, g);     // p_new's planes
            }
            if (it >= 0) {
                lam = accept ? lam0 / 3.0f : lam0 * nu;
                nu = accept ? 2.0f : nu * 2.0f;
            }
        }
    }

    // this init's result; the last block of the detection picks the winner
    if (tid == 0) {
        ini[0] = p[0];
        ini[1] = p[1];
        ini[2] = dual ? p[2] : 0.0f;
        ini[3] = c;
        ini[4] = expf(-c);
        __threadfence();
        last = atomicAdd(a.done + d, 1) == OSLAM_SYM_INITS - 1;
    }
    __syncthreads();
    if (!last || tid != 0) return;
    __threadfence();
    const volatile float* all = a.inits + (size_t)d * OSLAM_SYM_INITS
                                          * OSLAM_SYM_FIELDS;
    int bi = 0;
    float bp = all[4];
    for (int q = 1; q < OSLAM_SYM_INITS; ++q) {
        const float pq = all[q * OSLAM_SYM_FIELDS + 4];
        if (pq > bp || (pq != pq && bp == bp)) {
            bi = q;
            bp = pq;
        }
    }
    a.plane[4 * d + 0] = sinf(all[bi * OSLAM_SYM_FIELDS]);
    a.plane[4 * d + 1] = -cosf(all[bi * OSLAM_SYM_FIELDS]);
    a.plane[4 * d + 2] = 0.0f;
    a.plane[4 * d + 3] = -all[bi * OSLAM_SYM_FIELDS + 1];
    a.dual_dis[d] = all[bi * OSLAM_SYM_FIELDS + 2];
    a.prob[d] = bp;
    a.error[d] = all[bi * OSLAM_SYM_FIELDS + 3];
}

// src_mask may be null (dense: every live point is mirrored).  frame [D]
// int32 may be null (depth [H, W], one frame); given, depth is [B, H, W]
// and detection d looks its pixels up in frame frame[d], in [0, B).
extern "C" int oslam_symmetry_search(
    const void* pts, const void* mask, const void* src_mask,
    const void* bbox, const void* pose_oc, const void* depth,
    const void* frame,
    const void* types, const void* run, int D, int S, int H, int W, float fx,
    float fy, float cx, float cy, float scale, float ff, float coef,
    float ang_step, float step_dis, float h, float two_h, int iters,
    int analytic, void* plane, void* dual_dis, void* prob, void* error,
    void* inits, void* done, void* stream)
{
    if (S < 1 || S > OSLAM_SYM_MAX_S) return (int)cudaErrorInvalidValue;
    const SymArgs a = {
        (const float*)pts, (const uint8_t*)mask, (const uint8_t*)src_mask,
        (const float*)bbox,
        (const float*)pose_oc, (const int*)depth, (const int*)frame,
        (const int*)types,
        (const uint8_t*)run, S, H, W, fx, fy, cx, cy, scale, ff, coef,
        ang_step, step_dis, h, two_h, iters, analytic, (float*)plane,
        (float*)dual_dis, (float*)prob, (float*)error, (float*)inits,
        (int*)done};
    const dim3 grid(OSLAM_SYM_INITS, D);
    const size_t smem = (size_t)S * sizeof(float4)
                        + (src_mask != nullptr ? (size_t)S * 2 : 0);
    void (*kernel)(const SymArgs) =
        src_mask != nullptr
            ? (frame != nullptr ? symmetry_search_kernel<true, true>
                                : symmetry_search_kernel<true, false>)
            : (frame != nullptr ? symmetry_search_kernel<false, true>
                                : symmetry_search_kernel<false, false>);
    kernel<<<grid, OSLAM_SYM_T, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
