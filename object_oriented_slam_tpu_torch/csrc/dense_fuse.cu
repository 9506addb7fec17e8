// K12 dense_fuse for sm_90a: one frame of the dense RGB-D map builder
// (ops/dense_fuse.dense_fuse; system/dense_builder.DenseBuilder), in device
// memory.
//
// Replaces the JAX package's system/dense_builder.py:24-39 `_fuse_frame`,
// which XLA compiled (no Pallas kernel): the strided full-image
// back-projection (ops/backproject.py full_point_cloud), the world
// transform and colour gather, the concatenation of the map and the frame,
// and ops/voxel.py:42-86 `_voxel_core` at a 1 cm leaf with the three BGR
// channels as attributes into `capacity` cells (1 << 19 by default).
//
// Why not voxel_downsample (csrc/frontend.cu): that kernel keeps a
// detection's working arrays in one cluster's shared memory, with 16-bit
// point ids (65,535 points) and one attribute.  A fuse holds the map's
// 524,288 rows and a frame's 19,200 strided pixels (640 x 480 at stride 4)
// with three attributes: ~17 MB, so everything lives in device memory.
//
// A fuse is two calls around a stable key sort (torch.sort, as JAX's
// argsort is XLA's):
//   oslam_dense_fuse_points    (i) the masked minimum cell (integer
//       atomicMin: order-free, so deterministic) over the map's rows and the
//       frame's points, which it back-projects, transforms to the world and
//       writes with their colours into the tail of the [capacity + F]
//       buffer after the map's rows; then every point's key (JAX's clip to
//       0..1023 an axis, 10 bits each, the 2^30 sentinel for a masked one).
//   oslam_dense_fuse_segments  (ii) from the sorted keys: the segment starts
//       of each tile of 1024 sorted keys, their exclusive scan over the
//       tiles, then each segment's rank, and each segment summed by one
//       thread walking it in sorted order (the bits of the plain version's
//       sequential index_add_ on the CPU), its centroid, colour mean and
//       mask written into the output buffer's capacity prefix; segments at
//       or past `capacity` are dropped, as _voxel_core drops them.
//
// Bound by bytes: the map's rows read and written (25 bytes a row) and the
// frame's strided pixels, ~26 MB a frame at 1 << 19 cells, against no
// arithmetic to speak of.  This first design reads the map twice (cells,
// then the segment sums through the sort's permutation, a gather) and
// leaves the sort to the library; ROADMAP queue 2 P10 replaces the sort
// and merges the frame into the already sorted map.
//
// Built with -fmad=false and without fast math: every multiply, add and
// divide rounds on its own (IEEE), in the order of the plain version.
// Plain C interface, bound with ctypes; every function launches on the
// given stream, does not synchronise, allocates nothing and returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#define OSLAM_BIG (1 << 30)     // the invalid key
#define DF_T 256                // threads a block
#define DF_PER 4                // sorted keys a thread in the segment pass
#define DF_TILE (DF_T * DF_PER) // sorted keys a block

extern "C" const char* oslam_df_error_string(int rc) {
    return cudaGetErrorString((cudaError_t)rc);
}

// ---------------------------------------------------------------------------
// (i) points, cells and keys
// ---------------------------------------------------------------------------
struct FrameParams {
    int cap, hs, ws, width, stride;
    float fx, fy, cx, cy, scale, depth_range, leaf;
};

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

// Thread i < cap: map row i (its cell if masked); thread cap + j: frame
// pixel j of the strided grid (row-major), back-projected as
// ops/backproject.full_point_cloud, moved by pose_wc = (t, q) as
// x R[k,0] + y R[k,1] + z R[k,2] + t[k], written with its colour at row
// cap + j.  The masked minimum cell: a min over the block, then one
// atomicMin an axis.
__global__ void __launch_bounds__(DF_T) dense_points_kernel(
    FrameParams fp, const int* __restrict__ depth,
    const float* __restrict__ rgb, const float* __restrict__ pose,
    float* __restrict__ pts, float* __restrict__ col,
    uint8_t* __restrict__ mask, int* __restrict__ cmin)
{
    const int n = fp.cap + fp.hs * fp.ws;
    const int i = blockIdx.x * DF_T + threadIdx.x;
    bool live = false;
    float p[3];
    if (i < fp.cap) {
        live = mask[i] != 0;
        if (live)
            for (int k = 0; k < 3; ++k) p[k] = pts[3 * i + k];
    } else if (i < n) {
        const int j = i - fp.cap;
        const int r = j / fp.ws, c = j - r * fp.ws;
        const int py = r * fp.stride, px = c * fp.stride;
        const float z = (float)depth[py * fp.width + px] / fp.scale;
        const float x = ((float)px - fp.cx) * z / fp.fx;
        const float y = ((float)py - fp.cy) * z / fp.fy;
        live = (z > 1e-6f) && (z <= fp.depth_range);
        float R[9];
        quat_to_mat(pose + 3, R);
        for (int k = 0; k < 3; ++k) {
            const float w = x * R[3 * k] + y * R[3 * k + 1]
                          + z * R[3 * k + 2] + pose[k];
            p[k] = w;
            pts[3 * i + k] = w;
            col[3 * i + k] = rgb != nullptr
                ? rgb[3 * (py * fp.width + px) + k] : 0.0f;
        }
        mask[i] = live ? 1 : 0;
    }
    // the block's minimum by warp reductions, then one atomicMin an axis
    __shared__ int wmin[DF_T / 32][3];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int k = 0; k < 3; ++k) {
        const int m = __reduce_min_sync(
            0xffffffffu, live ? cell_of(p[k], fp.leaf) : 0x7fffffff);
        if (lane == 0) wmin[warp][k] = m;
    }
    __syncthreads();
    if (threadIdx.x < 3) {
        int m = wmin[0][threadIdx.x];
        for (int w = 1; w < DF_T / 32; ++w) m = min(m, wmin[w][threadIdx.x]);
        if (m != 0x7fffffff) atomicMin(&cmin[threadIdx.x], m);
    }
}

__global__ void __launch_bounds__(DF_T) dense_keys_kernel(
    int n, float leaf, const float* __restrict__ pts,
    const uint8_t* __restrict__ mask, const int* __restrict__ cmin,
    int* __restrict__ keys)
{
    const int i = blockIdx.x * DF_T + threadIdx.x;
    if (i >= n) return;
    int key = OSLAM_BIG;
    if (mask[i]) {
        key = 0;
        for (int k = 0; k < 3; ++k) {
            int c = cell_of(pts[3 * i + k], leaf) - cmin[k];
            c = c < 0 ? 0 : (c > 1023 ? 1023 : c);
            key = (key << 10) | c;
        }
    }
    keys[i] = key;
}

// ---------------------------------------------------------------------------
// (ii) segments
// ---------------------------------------------------------------------------
__device__ __forceinline__ bool starts(const int* key_s, int i)
{
    const int k = key_s[i];
    return k != OSLAM_BIG && (i == 0 || key_s[i - 1] != k);
}

// Exclusive scan of one int a thread over the block (DF_T threads);
// returns the thread's prefix, *total the block's sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total)
{
    __shared__ int warp_sums[DF_T / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int inc = v;
    for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc += o;
    }
    if (lane == 31) warp_sums[warp] = inc;
    __syncthreads();
    if (warp == 0) {
        int w = lane < DF_T / 32 ? warp_sums[lane] : 0;
        for (int d = 1; d < DF_T / 32; d <<= 1) {
            const int o = __shfl_up_sync(0xffffffffu, w, d);
            if (lane >= d) w += o;
        }
        if (lane < DF_T / 32) warp_sums[lane] = w;
    }
    __syncthreads();
    const int before = warp > 0 ? warp_sums[warp - 1] : 0;
    *total = warp_sums[DF_T / 32 - 1];
    __syncthreads();
    return before + inc - v;
}

__global__ void __launch_bounds__(DF_T) dense_seg_count_kernel(
    int n, const int* __restrict__ key_s, int* __restrict__ tiles)
{
    const int base = blockIdx.x * DF_TILE + threadIdx.x * DF_PER;
    int cnt = 0;
    for (int q = 0; q < DF_PER; ++q)
        if (base + q < n && starts(key_s, base + q)) ++cnt;
    int total;
    block_exclusive_scan(cnt, &total);
    if (threadIdx.x == 0) tiles[blockIdx.x] = total;
}

// One block: the tiles' counts -> their exclusive offsets, in place.
__global__ void __launch_bounds__(DF_T) dense_seg_scan_kernel(
    int ntiles, int* __restrict__ tiles)
{
    int carry = 0;
    for (int b0 = 0; b0 < ntiles; b0 += DF_T) {
        const int b = b0 + threadIdx.x;
        const int v = b < ntiles ? tiles[b] : 0;
        int total;
        const int ex = block_exclusive_scan(v, &total);
        if (b < ntiles) tiles[b] = carry + ex;
        carry += total;
    }
}

// Each segment start: its rank (the tile's offset + the starts before it
// in the tile) and, below `cap`, the sums of its run in sorted order.
__global__ void __launch_bounds__(DF_T) dense_seg_sum_kernel(
    int n, int cap, const int* __restrict__ key_s,
    const long long* __restrict__ order, const float* __restrict__ pts,
    const float* __restrict__ col, const int* __restrict__ tiles,
    float* __restrict__ out_pts, float* __restrict__ out_col,
    uint8_t* __restrict__ out_mask)
{
    const int base = blockIdx.x * DF_TILE + threadIdx.x * DF_PER;
    bool st[DF_PER];
    int cnt = 0;
    for (int q = 0; q < DF_PER; ++q) {
        st[q] = base + q < n && starts(key_s, base + q);
        cnt += st[q] ? 1 : 0;
    }
    int total;
    int seg = tiles[blockIdx.x] + block_exclusive_scan(cnt, &total);
    for (int q = 0; q < DF_PER; ++q) {
        if (!st[q]) continue;
        if (seg < cap) {
            const int i0 = base + q, key = key_s[i0];
            float sp[3] = {0.0f, 0.0f, 0.0f}, sc[3] = {0.0f, 0.0f, 0.0f};
            float c = 0.0f;
            for (int i = i0; i < n && key_s[i] == key; ++i) {
                const long long r = order[i];
                for (int k = 0; k < 3; ++k) {
                    sp[k] = sp[k] + pts[3 * r + k];
                    sc[k] = sc[k] + col[3 * r + k];
                }
                c = c + 1.0f;
            }
            for (int k = 0; k < 3; ++k) {
                out_pts[3 * seg + k] = sp[k] / c;
                out_col[3 * seg + k] = sc[k] / c;
            }
            out_mask[seg] = 1;
        }
        ++seg;
    }
}

// ---------------------------------------------------------------------------
// C interface
// ---------------------------------------------------------------------------
static int blocks_for(long long n, int per)
{
    return (int)((n + per - 1) / per);
}

// pts / col [cap + F, 3] float32 and mask [cap + F] uint8: the map's rows in
// the prefix (read), the frame's rows written at the tail; depth [H, W]
// int32, rgb [H, W, 3] float32 or null (zeros); pose [7] float32 Twc
// (t, quaternion x y z w); cmin [3] int32 scratch; keys [cap + F] int32 out.
extern "C" int oslam_dense_fuse_points(
    int cap, int height, int width, int stride, float fx, float fy,
    float cx, float cy, float scale, float depth_range, float leaf,
    const void* depth, const void* rgb, const void* pose, void* pts,
    void* col, void* mask, void* cmin, void* keys, void* stream)
{
    if (cap < 1 || height < 1 || width < 1 || stride < 1 || !(leaf > 0.0f))
        return (int)cudaErrorInvalidValue;
    FrameParams fp{cap, (height + stride - 1) / stride,
                   (width + stride - 1) / stride, width, stride,
                   fx, fy, cx, cy, scale, depth_range, leaf};
    const long long n = (long long)cap + (long long)fp.hs * fp.ws;
    if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    // 0x7f7f7f7f: above every cell floor(p / leaf) of a finite point
    cudaError_t rc = cudaMemsetAsync(cmin, 0x7f, 3 * sizeof(int), s);
    if (rc != cudaSuccess) return (int)rc;
    dense_points_kernel<<<blocks_for(n, DF_T), DF_T, 0, s>>>(
        fp, (const int*)depth, (const float*)rgb, (const float*)pose,
        (float*)pts, (float*)col, (uint8_t*)mask, (int*)cmin);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
    dense_keys_kernel<<<blocks_for(n, DF_T), DF_T, 0, s>>>(
        (int)n, leaf, (const float*)pts, (const uint8_t*)mask,
        (const int*)cmin, (int*)keys);
    return (int)cudaGetLastError();
}

// key_s [n] int32 sorted keys, order [n] int64 the stable sort's
// permutation, pts / col [n, 3] the points in their original order; tiles
// [ceil(n / 1024)] int32 scratch; out_pts / out_col [cap, 3], out_mask
// [cap] uint8 (zeroed here first).
extern "C" int oslam_dense_fuse_segments(
    int n, int cap, const void* key_s, const void* order, const void* pts,
    const void* col, void* tiles, void* out_pts, void* out_col,
    void* out_mask, void* stream)
{
    if (n < 1 || cap < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t rc = cudaMemsetAsync(out_pts, 0, (size_t)cap * 12, s);
    if (rc == cudaSuccess) rc = cudaMemsetAsync(out_col, 0, (size_t)cap * 12, s);
    if (rc == cudaSuccess) rc = cudaMemsetAsync(out_mask, 0, (size_t)cap, s);
    if (rc != cudaSuccess) return (int)rc;
    const int ntiles = blocks_for(n, DF_TILE);
    dense_seg_count_kernel<<<ntiles, DF_T, 0, s>>>(n, (const int*)key_s,
                                                   (int*)tiles);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
    dense_seg_scan_kernel<<<1, DF_T, 0, s>>>(ntiles, (int*)tiles);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
    dense_seg_sum_kernel<<<ntiles, DF_T, 0, s>>>(
        n, cap, (const int*)key_s, (const long long*)order,
        (const float*)pts, (const float*)col, (const int*)tiles,
        (float*)out_pts, (float*)out_col, (uint8_t*)out_mask);
    return (int)cudaGetLastError();
}
