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
//
// Built with -fmad=false and without fast math: every multiply, add and
// divide rounds on its own (IEEE), in the order the plain PyTorch versions
// (same module names under ops/) write them, so cells, masks and labels
// come out the same as on the CPU.  Plain C interface, bound with ctypes;
// every function launches on the given stream, does not synchronise,
// allocates nothing and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

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
// after compaction (ops/cluster.components_compacted) the unmasked points
// are in front, so the tail blocks cost nothing.
// ---------------------------------------------------------------------------
#define OSLAM_PT 256

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
            const float4 p = sp[k];
            const float cross = xi * p.x + yi * p.y + zi * p.z;
            const float d2 = ni + p.w - 2.0f * cross;
            const int l = sl[k];
            best = (d2 <= tol2 && l < best) ? l : best;
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
        for (int i = threadIdx.x; i < N; i += blockDim.x) {
            const int l = a[i];
            b[i] = (l < N) ? a[l] : l;
        }
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
