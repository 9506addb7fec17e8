// Depth-frontend kernels for sm_90a: the per-frame extraction stages that
// the JAX package (object_oriented_slam_tpu/) left to XLA, written by hand.
//
//   bbox_cloud           ops/backproject.bbox_point_cloud, all D detections
//                        of a frame in one launch
//   voxel_segment_mean   the segment part of ops/voxel._voxel_core (after
//                        the key sort), optionally with the extractor's
//                        world transform and supporting-plane mask
//   min_label_pass       ops/cluster._min_label_pass_mm, one neighbour
//                        min-label pass of the radius graph
//   pointer_jumps        ops/cluster._propagate's `jumps`, plus the
//                        "did any label change this round" flag
//   cluster_components   ops/cluster.components_compacted: compaction and
//                        every round (pass + jumps) of a frame's
//                        propagation in one launch, a thread block cluster
//                        per detection
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

namespace cg = cooperative_groups;

#define OSLAM_BIG (1 << 30)        // invalid key / "no neighbour" label
#define OSLAM_STRIDE 3             // bbox scan stride (PointCloudFilter.cpp:31-32)

extern "C" const char* oslam_fe_error_string(int rc) {
    return cudaGetErrorString((cudaError_t)rc);
}

// ---------------------------------------------------------------------------
// bbox_cloud.  Replaces ops/backproject.bbox_point_cloud.
// Bound by bytes: D * gh * gw * 13 bytes written, the depth pixels under the
// boxes read once.  One thread per grid position and detection; the depth
// read is a strided gather (every third pixel of every third row), the
// writes are contiguous.  The truncating casts, the window's zero padding,
// z = d / scale and x = (px - cx) * z / fx keep the reference order.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256) bbox_cloud_kernel(
    const int* __restrict__ depth, const float* __restrict__ bboxes,
    int H, int W, int gh, int gw, float scale, float fx, float fy, float cx,
    float cy, float depth_range, float* __restrict__ pts,
    uint8_t* __restrict__ mask)
{
    const int g = blockIdx.x * blockDim.x + threadIdx.x;
    const int d = blockIdx.y;
    const int G = gh * gw;
    if (g >= G) return;
    const int i = g / gw, j = g - i * gw;
    const float* bb = bboxes + 4 * d;
    const int x1 = min(max((int)bb[0], 0), W - 1);
    const int y1 = min(max((int)bb[1], 0), H - 1);
    const int x2 = min(max((int)bb[2], 0), W);
    const int y2 = min(max((int)bb[3], 0), H);
    const int px = x1 + OSLAM_STRIDE * j;
    const int py = y1 + OSLAM_STRIDE * i;
    const bool in_box = (px < x2) && (py < y2);
    // the window may run past the image: those positions read 0
    const int dv = (px < W && py < H) ? depth[py * W + px] : 0;
    const float z = (float)dv / scale;
    const bool valid = in_box && (z > 0.1f) && (z <= depth_range);
    const int pxc = min(px, W - 1), pyc = min(py, H - 1);
    const float x = ((float)pxc - cx) * z / fx;
    const float y = ((float)pyc - cy) * z / fy;
    float* o = pts + ((size_t)d * G + g) * 3;
    o[0] = x;
    o[1] = y;
    o[2] = z;
    mask[(size_t)d * G + g] = valid ? 1 : 0;
}

extern "C" int oslam_bbox_cloud(
    const void* depth, const void* bboxes, int D, int H, int W, float scale,
    float fx, float fy, float cx, float cy, float depth_range, void* pts,
    void* mask, void* stream)
{
    const int gh = (H + OSLAM_STRIDE - 1) / OSLAM_STRIDE;
    const int gw = (W + OSLAM_STRIDE - 1) / OSLAM_STRIDE;
    dim3 grid((gh * gw + 255) / 256, D);
    bbox_cloud_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const int*)depth, (const float*)bboxes, H, W, gh, gw, scale, fx, fy,
        cx, cy, depth_range, (float*)pts, (uint8_t*)mask);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// voxel_segment_mean.  Replaces the segment part of ops/voxel._voxel_core.
// Bound by bytes (keys, sort order and points read once, the capacity-sized
// outputs written once).  Given the keys sorted stably and the sort order,
// one block per detection scans the sorted keys in chunks of 1024: a thread
// whose key starts a segment gets the segment's rank from a block-wide
// exclusive scan (ballot + one warp over the 32 warp totals), walks its run
// and adds the points in sorted order, so the centroid's sum has the order
// of the plain version's sequential index_add_ on the CPU: deterministic,
// no atomics.  Segments of rank >= capacity are dropped; unused slots are
// zeroed.  With `world` (R row-major [9], t [3], plane [4], den, clearance)
// it also writes the slot's world point p R^T + t and the supporting-plane
// mask (n . p_w + d) / den > clearance.
// ---------------------------------------------------------------------------
#define OSLAM_VT 1024

__device__ __forceinline__ void write_slot(
    int slot, float mx, float my, float mz, int c0, int c1, int c2, bool live,
    float* out_pts, int* out_cells, uint8_t* out_mask,
    const float* world, float* pts_w, uint8_t* m2)
{
    out_pts[3 * slot + 0] = mx;
    out_pts[3 * slot + 1] = my;
    out_pts[3 * slot + 2] = mz;
    out_cells[3 * slot + 0] = c0;
    out_cells[3 * slot + 1] = c1;
    out_cells[3 * slot + 2] = c2;
    out_mask[slot] = live ? 1 : 0;
    if (world != nullptr) {
        const float wx = mx * world[0] + my * world[1] + mz * world[2] + world[9];
        const float wy = mx * world[3] + my * world[4] + mz * world[5] + world[10];
        const float wz = mx * world[6] + my * world[7] + mz * world[8] + world[11];
        pts_w[3 * slot + 0] = wx;
        pts_w[3 * slot + 1] = wy;
        pts_w[3 * slot + 2] = wz;
        const float dist = (wx * world[12] + wy * world[13] + wz * world[14]
                            + world[15]) / world[16];
        m2[slot] = (live && dist > world[17]) ? 1 : 0;
    }
}

__global__ void __launch_bounds__(OSLAM_VT) voxel_segment_mean_kernel(
    const int* __restrict__ key_s, const long long* __restrict__ order,
    const float* __restrict__ pts, const int* __restrict__ cmin, int G,
    int capacity, float* __restrict__ out_pts, int* __restrict__ out_cells,
    uint8_t* __restrict__ out_mask, const float* __restrict__ world,
    float* __restrict__ pts_w, uint8_t* __restrict__ m2)
{
    const int d = blockIdx.x;
    key_s += (size_t)d * G;
    order += (size_t)d * G;
    pts += (size_t)d * G * 3;
    cmin += 3 * d;
    out_pts += (size_t)d * capacity * 3;
    out_cells += (size_t)d * capacity * 3;
    out_mask += (size_t)d * capacity;
    if (world != nullptr) {
        pts_w += (size_t)d * capacity * 3;
        m2 += (size_t)d * capacity;
    }
    __shared__ int warp_off[32];
    __shared__ int chunk_total;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int base = 0;       // segments started in earlier chunks
    for (int start = 0; start < G; start += OSLAM_VT) {
        const int i = start + threadIdx.x;
        int key = OSLAM_BIG;
        bool is_new = false;
        if (i < G) {
            key = key_s[i];
            is_new = key != OSLAM_BIG && (i == 0 || key != key_s[i - 1]);
        }
        const unsigned ballot = __ballot_sync(0xffffffffu, is_new);
        const int before = __popc(ballot & ((1u << lane) - 1u));
        if (lane == 0) warp_off[warp] = __popc(ballot);
        __syncthreads();
        if (warp == 0) {
            const int mine = warp_off[lane];
            int incl = mine;
            for (int o = 1; o < 32; o <<= 1) {
                const int up = __shfl_up_sync(0xffffffffu, incl, o);
                if (lane >= o) incl += up;
            }
            warp_off[lane] = incl - mine;
            if (lane == 31) chunk_total = incl;
        }
        __syncthreads();
        const int slot = base + warp_off[warp] + before;
        if (is_new && slot < capacity) {
            float sx = 0.0f, sy = 0.0f, sz = 0.0f;
            int n = 0;
            for (int k = i; k < G && key_s[k] == key; ++k) {
                const float* p = pts + 3 * order[k];
                sx += p[0];
                sy += p[1];
                sz += p[2];
                ++n;
            }
            const float c = fmaxf((float)n, 1.0f);
            write_slot(slot, sx / c, sy / c, sz / c,
                       ((key >> 20) & 1023) + cmin[0],
                       ((key >> 10) & 1023) + cmin[1], (key & 1023) + cmin[2],
                       true, out_pts, out_cells, out_mask, world, pts_w, m2);
        }
        base += chunk_total;
        __syncthreads();        // warp_off and chunk_total are reused
    }
    for (int slot = base + threadIdx.x; slot < capacity; slot += OSLAM_VT)
        write_slot(slot, 0.0f, 0.0f, 0.0f, 0, 0, 0, false, out_pts, out_cells,
                   out_mask, world, pts_w, m2);
}

extern "C" int oslam_voxel_segment_mean(
    const void* key_s, const void* order, const void* pts, const void* cmin,
    int D, int G, int capacity, void* out_pts, void* out_cells,
    void* out_mask, const void* world, void* pts_w, void* m2, void* stream)
{
    voxel_segment_mean_kernel<<<D, OSLAM_VT, 0, (cudaStream_t)stream>>>(
        (const int*)key_s, (const long long*)order, (const float*)pts,
        (const int*)cmin, G, capacity, (float*)out_pts, (int*)out_cells,
        (uint8_t*)out_mask, (const float*)world, (float*)pts_w, (uint8_t*)m2);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// min_label_pass.  Replaces ops/cluster._min_label_pass_mm.
// Bound by operations: D * N^2 pair tests of ~10 f32 operations each against
// 17 bytes per point.  For every point i of every detection: the least
// label_j over the j with  nrm_i + nrm_j - 2 (x_i . x_j) <= tol2  and both
// unmasked.  Grid (ceil(N / 256), D); a thread owns one point i and keeps it
// in registers; the j points are staged 256 at a time in shared memory as
// (x, y, z, nrm) + label (a masked j carries the label 2^30, which never
// wins), and every thread of the block reads the same staged j, a broadcast.
// A block none of whose points is unmasked copies its labels and leaves:
// after compaction (ops/cluster._compact) the unmasked points
// are in front, so the tail blocks cost nothing.
// ---------------------------------------------------------------------------
#define OSLAM_PT 256

// The radius test of one pair, shared by min_label_pass and
// cluster_components: point i (xi, yi, zi, squared norm ni) against the
// staged point p = (x, y, z, squared norm) carrying label l; returns the
// lesser of `best` and l if the pair is within the radius.  The operations
// and their order are ops/cluster.min_label_pass_plain's.
__device__ __forceinline__ int closer_label(
    float xi, float yi, float zi, float ni, const float4 p, int l, float tol2,
    int best)
{
    const float cross = xi * p.x + yi * p.y + zi * p.z;
    const float d2 = ni + p.w - 2.0f * cross;
    return (d2 <= tol2 && l < best) ? l : best;
}

__global__ void __launch_bounds__(OSLAM_PT) min_label_pass_kernel(
    const float* __restrict__ pts_c, const float* __restrict__ nrm,
    const uint8_t* __restrict__ mask, const int* __restrict__ labels, int N,
    float tol2, int* __restrict__ out)
{
    const int d = blockIdx.y;
    pts_c += (size_t)d * N * 3;
    nrm += (size_t)d * N;
    mask += (size_t)d * N;
    labels += (size_t)d * N;
    out += (size_t)d * N;
    __shared__ float4 sp[OSLAM_PT];
    __shared__ int sl[OSLAM_PT];
    const int i = blockIdx.x * OSLAM_PT + threadIdx.x;
    float xi = 0.0f, yi = 0.0f, zi = 0.0f, ni = 0.0f;
    int li = 0;
    bool mi = false;
    if (i < N) {
        xi = pts_c[3 * i];
        yi = pts_c[3 * i + 1];
        zi = pts_c[3 * i + 2];
        ni = nrm[i];
        li = labels[i];
        mi = mask[i] != 0;
    }
    if (!__syncthreads_or(mi)) {
        if (i < N) out[i] = li;
        return;
    }
    int best = OSLAM_BIG;
    for (int j0 = 0; j0 < N; j0 += OSLAM_PT) {
        const int j = j0 + threadIdx.x;
        float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        int lj = OSLAM_BIG;
        if (j < N) {
            q = make_float4(pts_c[3 * j], pts_c[3 * j + 1], pts_c[3 * j + 2],
                            nrm[j]);
            if (mask[j] != 0) lj = labels[j];
        }
        sp[threadIdx.x] = q;
        sl[threadIdx.x] = lj;
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < OSLAM_PT; ++k) {
            best = closer_label(xi, yi, zi, ni, sp[k], sl[k], tol2, best);
        }
        __syncthreads();
    }
    if (i < N) out[i] = mi ? min(li, best) : li;
}

extern "C" int oslam_min_label_pass(
    const void* pts_c, const void* nrm, const void* mask, const void* labels,
    int D, int N, float tol2, void* out, void* stream)
{
    dim3 grid((N + OSLAM_PT - 1) / OSLAM_PT, D);
    min_label_pass_kernel<<<grid, OSLAM_PT, 0, (cudaStream_t)stream>>>(
        (const float*)pts_c, (const float*)nrm, (const uint8_t*)mask,
        (const int*)labels, N, tol2, (int*)out);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// pointer_jumps.  Replaces `jumps` of ops/cluster._propagate: `iters` times
// label_i <- label_{label_i} (labels >= N, the masked points', stay), every
// jump reading the labels of the jump before (two buffers, swapped), then
// changed[d] = any(label != prev).  Bound by latency: one block per
// detection, so that a __syncthreads() separates the jumps.
// ---------------------------------------------------------------------------
// One synchronous jump over n labels, shared by pointer_jumps and
// cluster_components: b_i = a_{a_i} (a label >= n, a masked point's,
// stays), by all threads of the block; with kTrack it returns whether a
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

__global__ void __launch_bounds__(1024) pointer_jumps_kernel(
    int* lab, int* tmp, const int* prev, int N, int iters, int* __restrict__ changed)
{
    const int d = blockIdx.x;
    lab += (size_t)d * N;
    tmp += (size_t)d * N;
    prev += (size_t)d * N;
    int* a = lab;
    int* b = tmp;
    for (int it = 0; it < iters; ++it) {
        jump_once<false>(a, b, N);
        __syncthreads();
        int* t = a;
        a = b;
        b = t;
    }
    if (a != lab) {
        for (int i = threadIdx.x; i < N; i += blockDim.x) lab[i] = a[i];
        __syncthreads();
    }
    __shared__ int any;
    if (threadIdx.x == 0) any = 0;
    __syncthreads();
    bool diff = false;
    for (int i = threadIdx.x; i < N; i += blockDim.x)
        diff = diff || (lab[i] != prev[i]);
    if (diff) any = 1;
    __syncthreads();
    if (threadIdx.x == 0) changed[d] = any;
}

extern "C" int oslam_pointer_jumps(
    void* lab, void* tmp, const void* prev, int D, int N, int iters,
    void* changed, void* stream)
{
    pointer_jumps_kernel<<<D, 1024, 0, (cudaStream_t)stream>>>(
        (int*)lab, (int*)tmp, (const int*)prev, N, iters, (int*)changed);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// cluster_components.  Replaces ops/cluster.components_compacted of the JAX
// package (compaction, then _propagate's rounds of one min-label pass and
// `jump_iters` pointer jumps until a round changes no label): the whole
// propagation of a frame in ONE launch, no host read between rounds.
//
// Bound by operations (the pair tests, ~11 f32 / integer operations each,
// against 17 bytes a point).  The single-step min_label_pass already runs
// its pair tests at the card's instruction rate; what the loop of the two
// single-step kernels lost was two launches and a fraction of a host read
// per round, pair tests against every lane of the frame's cap and against
// points far beyond the radius, and every detection held to the rounds of
// the slowest.  What the design does about it:
//  - One thread block cluster per detection (grid S x D, cluster dimension
//    S).  Every block scans the detection's mask (ballot + warp totals, as
//    voxel_segment_mean does) into the list of unmasked lanes in their
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
// ---------------------------------------------------------------------------
#define OSLAM_CC_MAXT 512
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

template <int P>
__global__ void __launch_bounds__(OSLAM_CC_MAXT, 1) cluster_components_kernel(
    const float* __restrict__ pts_c, const float* __restrict__ nrm,
    const uint8_t* __restrict__ mask, const int* __restrict__ labels0, int N,
    float tol2, int outer_iters, int jump_iters, int smem_bytes, int prune,
    const float* __restrict__ sort_frame, int* __restrict__ out_labels,
    uint8_t* __restrict__ converged, int* __restrict__ rounds,
    const Selection sel)
{
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int S = (int)cluster.num_blocks();
    const int d = blockIdx.y;
    const int tid = threadIdx.x, T = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5, W = T >> 5;
    pts_c += (size_t)d * N * 3;
    nrm += (size_t)d * N;
    mask += (size_t)d * N;
    labels0 += (size_t)d * N;
    out_labels += (size_t)d * N;

    extern __shared__ float4 cc_smem[];
    __shared__ int warp_off[32];
    __shared__ int chunk_total;
    __shared__ float frame[9];  // rows u, v, w of the boxes' frame

    // --- compaction: idx[c] = the c-th unmasked lane.  Masked lanes get
    // their label N here (chunk by chunk over the ranks); unmasked lanes
    // are written at the end
    int* idx = reinterpret_cast<int*>(cc_smem);
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

    // labels in compacted numbering (a seeded label is found in the sorted
    // lane list); the padding up to n_pad carries 2^30, which never wins
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
                        for (int m = 0; m < P; ++m)
                            best[m] = closer_label(x[m], y[m], z[m], w[m], q,
                                                   l, tol2, best[m]);
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

        // --- did the pass change a label; then the jumps, on all n labels
        bool chg = false;
        for (int i = tid; i < n; i += T) chg = chg || (nxt[i] != cur[i]);
        int* a = nxt;
        int* b = cur;
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
    const int per = (n + S - 1) / S;
    const int c_hi = min(n, (rank + 1) * per);
    for (int c = rank * per + tid; c < c_hi; c += T)
        out_labels[idx[c]] = idx[cur[c]];
    if (rank == 0 && tid == 0) {
        converged[d] = conv ? 1 : 0;
        rounds[d] = r;
    }
    if (sel.mask == nullptr || rank != 0) return;

    // --- the selection, by the first block alone (n atomics and three
    // block reductions).  `nxt` is free: sizes per root; the least
    // distances go through global scratch (this block's own writes)
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

template <int P>
static int launch_cluster_components(
    const float* pts_c, const float* nrm, const uint8_t* mask,
    const int* labels0, int D, int N, float tol2, int outer_iters,
    int jump_iters, int S, int T, int smem_bytes, int prune,
    const float* sort_frame, int* out_labels, uint8_t* converged, int* rounds,
    const Selection& sel, cudaStream_t stream)
{
    auto kernel = cluster_components_kernel<P>;
    cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (rc != cudaSuccess) return (int)rc;
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
                            sort_frame, out_labels, converged, rounds, sel);
    if (rc == cudaSuccess) rc = cudaGetLastError();
    return (int)rc;
}

// S blocks of T threads per detection, smem_bytes of dynamic shared memory
// a block (ops/cluster.LAUNCH_SHAPE, launch_smem); P, the points a lane
// keeps in registers, must be the build's OSLAM_CC_P (one instantiation is
// built; examples/torch_cluster_sweep.py rebuilds with -DOSLAM_CC_P=4 or 8
// to time the others); prune = 0 tests every pair (for timing the skip);
// sort_frame is 9 floats, the rows of the rotation the cloud was sorted in
// (the identity: the axes of the points' coordinates).  Needs
// smem_bytes >= 13 bytes a lane (rounded up to 32 lanes) plus a tile of at
// least 256 points.
static int cluster_launch(
    const void* pts_c, const void* nrm, const void* mask, const void* labels0,
    int D, int N, float tol2, int outer_iters, int jump_iters, int S, int T,
    int P, int smem_bytes, int prune, const void* sort_frame,
    void* out_labels, void* converged, void* rounds, const Selection& sel,
    void* stream)
{
    const int n_pad = (N + 31) & ~31;
    if (D < 1 || D > 65535 || N < 1 || S < 1 || S > 8 || T < 32 ||
        T > OSLAM_CC_MAXT || T % 32 != 0 || P != OSLAM_CC_P ||
        outer_iters < 1 || jump_iters < 0 ||
        smem_bytes < 13 * n_pad + 16 * 256)
        return (int)cudaErrorInvalidConfiguration;
    if (sort_frame == nullptr) return (int)cudaErrorInvalidValue;
    return launch_cluster_components<OSLAM_CC_P>(
        (const float*)pts_c, (const float*)nrm, (const uint8_t*)mask,
        (const int*)labels0, D, N, tol2, outer_iters, jump_iters, S, T,
        smem_bytes, prune, (const float*)sort_frame, (int*)out_labels,
        (uint8_t*)converged, (int*)rounds, sel, (cudaStream_t)stream);
}

extern "C" int oslam_cluster_components(
    const void* pts_c, const void* nrm, const void* mask, const void* labels0,
    int D, int N, float tol2, int outer_iters, int jump_iters, int S, int T,
    int P, int smem_bytes, int prune, const void* sort_frame,
    void* out_labels, void* converged, void* rounds, void* stream)
{
    Selection none = {};
    return cluster_launch(pts_c, nrm, mask, labels0, D, N, tol2, outer_iters,
                          jump_iters, S, T, P, smem_bytes, prune, sort_frame,
                          out_labels, converged, rounds, none, stream);
}

// cluster_components with ops/cluster.select_cluster as its epilogue: the
// same launch, plus the chosen component's point mask and the per-detection
// ok flag (already ANDed with `converged`).
extern "C" int oslam_cluster_select(
    const void* pts_c, const void* nrm, const void* mask, const void* labels0,
    int D, int N, float tol2, int outer_iters, int jump_iters, int S, int T,
    int P, int smem_bytes, int prune, const void* sort_frame,
    void* out_labels, void* converged, void* rounds, const void* pts,
    const void* center, int min_size, float center_dis, void* least_d,
    void* sel_mask, void* sel_ok, void* stream)
{
    Selection sel = {(const float*)pts, (const float*)center, min_size,
                     center_dis, (int*)least_d, (uint8_t*)sel_mask,
                     (uint8_t*)sel_ok};
    if (sel.pts == nullptr || sel.center == nullptr ||
        sel.least_d == nullptr || sel.mask == nullptr || sel.ok == nullptr)
        return (int)cudaErrorInvalidValue;
    return cluster_launch(pts_c, nrm, mask, labels0, D, N, tol2, outer_iters,
                          jump_iters, S, T, P, smem_bytes, prune, sort_frame,
                          out_labels, converged, rounds, sel, stream);
}
