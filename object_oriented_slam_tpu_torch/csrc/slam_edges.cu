// K11: SLAM mode's edge kernel for Hopper (sm_90a).
//
// Computes what the JAX package's backend/slam_ba.py _edge_terms_2d,
// _edge_terms_3d, _edge_terms_odo and _edge_terms_grav compute (there with
// jax.jacfwd under vmap, left to XLA), for every edge of a SLAM graph in
// one launch: the sqrt-info-weighted residual of each edge and its
// Jacobians at the zero tangent with respect to the left-multiplied camera
// pose(s) (Tcw' = exp(u) Tcw, g2o VertexSE3Expmap) and the object's 9-DoF
// tangent (ellipsoid.exp_update):
//   2D edge  (frame, object): r [4], dr/du_pose [4,6], dr/du_obj [4,9]
//            residual_proj(exp_update(obj, uo), exp(up) pose, K, bbox)
//   3D edge  (frame, object): r [9], [9,6], [9,9]
//            min_log_error_9dof(obj', transform_from(meas, inv(exp(up) pose)))
//   odometry (frame i, frame i+1): r [6], dr/du_i [6,6], dr/du_j [6,6]
//            log(meas * (exp(ui) pose_i) * (exp(uj) pose_j)^-1)
//   gravity  (object): r [1], dr/du_obj [1,9]
// An edge with a non-finite residual component is written as zeros, r and
// J alike; the gravity rows are not gated (the JAX package's rules: the
// tangents are not tested).  A second instantiation of the same chains in
// float gives the graph's chi2 (the sum of the gated rows' squares), so an
// LM iteration of backend/slam_ba.optimize_slam is two launches.
//
// Forward mode, as in ba_edges.cu: the chains are written once, templated
// on the scalar type (float or Dual<kW>, dual.cuh), every branch selects on
// the primal value and each derivative rule copies the JAX rule it
// replaces.  The operations follow the JAX package's SLAM functions (core/
// se3.py, core/ellipsoid.py project_bbox, min_log_error_9dof), not the
// mapping kernels' forms: the pose is a dual here, and the 3D candidate is
// picked by the norm (jnp.linalg.norm), where ba_edges.cu's residual_3d
// picks it by the squared norm.
//
// Layout.  An edge has up to 15 tangent directions (6 pose + 9 object);
// Dual<15> chains would not fit the register file, so each edge's
// directions are dealt over threads, kW = 5 a thread: a 2D or 3D edge is 3
// threads, an odometry edge (12 directions) 3, a gravity prior (9) 2.  The
// tangent components of a dual operation do not mix, so every thread of an
// edge computes the same primal bits and its own columns of J; thread 0 of
// the edge writes r.  Every output element is written by one thread: the
// launch repeats bit for bit.  The chi2 instantiation runs one edge a
// thread; each block adds its threads' sums by a fixed xor-shuffle pattern
// and its warps in order, and the last block to finish (a ticket on a
// counter the caller zeroes) adds the blocks' sums in block order: no
// floating-point atomics, equal inputs give equal bits.  Built without
// --use_fast_math and with -fmad=false, as ba_edges.cu.
//
// What bounds it: neither bytes nor operations.  At chip_smoke.py's [slam]
// graph (1,024 2D, 512 3D and 255 odometry edges, 32 objects; 994 / 434 /
// 159 live, 24 gravity priors) a launch moves ~1 MB, and the work it must
// do is 39.0 M f32 operations (counted on that graph's live edges by
// examples/torch_slam_edges_on_cpu.py's count_ops, an edge's primal chain
// once and its tangent work once a direction), 0.58 us of the card's
// peak; it takes ~0.040 ms: each thread runs one long dependent chain of
// IEEE div / sqrt / atan2 (a 3D edge's four candidates, ~15,000 operations
// in Dual<5>), and ~7,000 threads make one wave.  Latency, then; the
// design keeps one chain a thread in registers (255, 4 bytes of spill) and
// widens the wave by dealing an edge's directions over threads.

#include <cuda_runtime.h>
#include <math.h>

#include "dual.cuh"

namespace {

constexpr int kThreads = 128;             // threads of a block
#ifndef OSLAM_LANES
#define OSLAM_LANES 5                     // (a host build may count others)
#endif
constexpr int kW = OSLAM_LANES;           // tangent directions a thread
constexpr int kGroups2 = 3;               // threads a 2D edge: 15 directions
constexpr int kGroups3 = 3;               // a 3D edge: 15
constexpr int kGroupsO = 3;               // an odometry edge: 12
constexpr int kGroupsG = 2;               // a gravity prior: 9
constexpr unsigned kFullWarp = 0xffffffffu;
using DW = Dual<kW>;

// sin / cos of half of k * 90 deg of yaw, k = -1, 0, 1, 2 (ellipsoid.
// rotate_yaw: the host's double values rounded to float)
__constant__ float kYawSin[4] = {(float)-0.7071067811865475, 0.f,
                                 (float)0.7071067811865475, 1.f};
__constant__ float kYawCos[4] = {(float)0.7071067811865476, 1.f,
                                 (float)0.7071067811865476,
                                 (float)6.123233995736766e-17};

struct Graph {
  const float* poses;       // [F,7] Tcw
  const float* objects;     // [K,10]
  const float* K;           // [3,3]
  const float* normal;      // [3]
  const long long* e2_frame;
  const long long* e2_obj;
  const float* e2_bbox;     // [E2,4]
  const float* e2_w;
  const long long* e3_frame;
  const long long* e3_obj;
  const float* e3_meas;     // [E3,10]
  const float* e3_w;
  const long long* odo_i;
  const long long* odo_j;
  const float* odo_meas;    // [Eo,7]
  const float* odo_w;
  const float* grav_w;      // [K]
  int E2, E3, Eo, Ko;
};

struct Out {
  float *r2, *Jp2, *Jo2, *r3, *Jp3, *Jo3, *ro, *Ji, *Jj, *rg, *Jg;
};

template <class S>
struct Pose {
  S t[3];
  S q[4];
};

// ---------------------------------------------------------------------------
// SE(3) in the JAX package's order of operations (core/se3.py)
// ---------------------------------------------------------------------------

// se3_exp(u): [V(omega) upsilon, so3_exp_quat(omega)]
template <class S>
__device__ void se3_exp(const S* u, Pose<S>& o) {
  const S &ox = u[0], &oy = u[1], &oz = u[2];
  S theta2 = ox * ox + oy * oy + oz * oz;
  S theta = sqrt_(theta2 + kEps2);
  S half = 0.5f * theta;
  S k = val(theta2) > 1e-10f ? sin_(half) / theta : 0.5f - theta2 / 48.f;
  o.q[0] = ox * k;
  o.q[1] = oy * k;
  o.q[2] = oz * k;
  o.q[3] = cos_(half);
  S a = val(theta2) > 1e-10f
            ? (1.f - cos_(theta)) / maxc(theta2, kEps)
            : 0.5f - theta2 / 24.f;
  S b = val(theta2) > 1e-10f
            ? (theta - sin_(theta)) / maxc(theta2 * theta, kEps)
            : (float)(1.0 / 6.0) - theta2 / 120.f;
  S o00 = -(oz * oz + oy * oy);
  S o01 = oy * ox;
  S o02 = oz * ox;
  S o11 = -(oz * oz + ox * ox);
  S o12 = oz * oy;
  S o22 = -(oy * oy + ox * ox);
  S v00 = 1.f + b * o00, v01 = -a * oz + b * o01, v02 = a * oy + b * o02;
  S v10 = a * oz + b * o01, v11 = 1.f + b * o11, v12 = -a * ox + b * o12;
  S v20 = -a * oy + b * o02, v21 = a * ox + b * o12, v22 = 1.f + b * o22;
  const S &ux = u[3], &uy = u[4], &uz = u[5];
  o.t[0] = v00 * ux + v01 * uy + v02 * uz;
  o.t[1] = v10 * ux + v11 * uy + v12 * uz;
  o.t[2] = v20 * ux + v21 * uy + v22 * uz;
}

// se3_mul(a, b) = [a.t + R(a.q) b.t, normalize(a.q b.q)]
template <class A, class B, class R>
__device__ void se3_mul(const A* at, const A* aq, const B* bt, const B* bq,
                        Pose<R>& o) {
  R rt[3];
  qrotate(aq, bt, rt);
  o.t[0] = at[0] + rt[0];
  o.t[1] = at[1] + rt[1];
  o.t[2] = at[2] + rt[2];
  qmul(aq, bq, o.q);
  qnormalize(o.q);
}

// se3_inv(a) = [-R(conj(a.q)) a.t, conj(a.q)]
template <class S>
__device__ void se3_inv(const Pose<S>& a, Pose<S>& o) {
  o.q[0] = -a.q[0];
  o.q[1] = -a.q[1];
  o.q[2] = -a.q[2];
  o.q[3] = a.q[3];
  S rt[3];
  qrotate(o.q, a.t, rt);
  o.t[0] = -rt[0];
  o.t[1] = -rt[1];
  o.t[2] = -rt[2];
}

// se3_log(a) = [so3_log(a.q), V^-1 a.t]
template <class S>
__device__ void se3_log(const Pose<S>& a, S* out) {
  so3_log(a.q, out);
  vinv_apply(out, a.t, out + 3);
}

// the left update of a camera: exp(u) * pose
template <class S>
__device__ void camera(const float* pose, const S* u, Pose<S>& o) {
  Pose<S> d;
  se3_exp(u, d);
  se3_mul(d.t, d.q, pose, pose + 3, o);
}

// the 6 or 9 tangent components of an argument, seeded for the thread's
// directions dir0 .. dir0 + kW - 1 of the edge's list (its first argument
// takes directions 0 .. 5, its second from 6 on)
template <class S, int N>
__device__ __forceinline__ void seeds(S (&u)[N], int first, int dir0) {
#pragma unroll
  for (int i = 0; i < N; ++i) u[i] = Scalar<S>::seed(first + i, dir0);
}

// ---------------------------------------------------------------------------
// Residuals, weighted
// ---------------------------------------------------------------------------

// residuals.residual_proj: ellipsoid.project_bbox (the dual conic in closed
// form, ops/linalg.inv3, the conic -> ellipse -> bbox of Ellipsoid.cpp)
// minus the measured bbox, coordinates measured < 5 contributing 0
template <class S>
__device__ void rows_2d(const Graph& g, int e, int dir0, S r[4]) {
  S up[6], uo[9];
  seeds(up, 0, dir0);
  seeds(uo, 6, dir0);
  Pose<S> pc;
  camera(g.poses + 7 * g.e2_frame[e], up, pc);
  Est<S> o;
  exp_update(g.objects + 10 * g.e2_obj[e], uo, o);
  const float* Km = g.K;
  S R[3][3], Rc[3][3];
  qtomat(o.q, R);
  qtomat(pc.q, Rc);
  S A[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      A[i][j] = Km[3 * i] * Rc[0][j] + Km[3 * i + 1] * Rc[1][j] +
                Km[3 * i + 2] * Rc[2][j];
  S WS[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      WS[i][j] = (A[i][0] * R[0][j] + A[i][1] * R[1][j] + A[i][2] * R[2][j]) *
                 o.s[j];
  S v[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    v[i] = (A[i][0] * o.t[0] + A[i][1] * o.t[1] + A[i][2] * o.t[2]) +
           (Km[3 * i] * pc.t[0] + Km[3 * i + 1] * pc.t[1] +
            Km[3 * i + 2] * pc.t[2]);
  auto cs = [&](int i, int j) -> S {
    return (WS[i][0] * WS[j][0] + WS[i][1] * WS[j][1] + WS[i][2] * WS[j][2]) -
           v[i] * v[j];
  };
  // inv3 of the symmetric C* = [[a b c] [b e f] [c f i]]
  S a_ = cs(0, 0), b_ = cs(0, 1), c_ = cs(0, 2);
  S e_ = cs(1, 1), f_ = cs(1, 2), i_ = cs(2, 2);
  S adjA = e_ * i_ - f_ * f_;
  S adjB = -(b_ * i_ - f_ * c_);
  S adjC = b_ * f_ - e_ * c_;
  S adjD = -(b_ * i_ - c_ * f_);
  S adjE = a_ * i_ - c_ * c_;
  S adjF = -(a_ * f_ - b_ * c_);
  S adjG = b_ * f_ - c_ * e_;
  S adjI = a_ * e_ - b_ * b_;
  S det = a_ * adjA + b_ * adjB + c_ * adjC;
  det = det + (val(det) == 0.f ? 1e-30f : 0.f);
  S c00 = adjA / det, c01 = adjD / det, c11 = adjE / det;
  S c02 = adjG / det, c21 = adjF / det, c22 = adjI / det;
  S ca = c00 / c22;
  S cb = (c01 / c22) * 2.f;
  S cc = c11 / c22;
  S cd = (c02 / c22) * 2.f;
  S ce = (c21 / c22) * 2.f;

  S theta = 0.5f * atan2_(cb, ca - cc);
  S den = 4.f * ca * cc - cb * cb;
  S x_c = (cb * ce - 2.f * cc * cd) / den;
  S y_c = (cb * cd - 2.f * ca * ce) / den;
  S quad = ca * x_c * x_c + cc * y_c * y_c + cb * x_c * y_c - 1.f;
  S root = sqrt_((ca - cc) * (ca - cc) + cb * cb);
  S a2 = 2.f * quad / (ca + cc + root);
  S b2 = 2.f * quad / (ca + cc - root);
  S ax1 = sqrt_(maxc(a2, 0.f));
  S ax2 = sqrt_(maxc(b2, 0.f));
  S c2t = square_(cos_(theta));
  S s2t = 1.f - c2t;
  S x_lim = sqrt_(ax1 * ax1 * c2t + ax2 * ax2 * s2t);
  S y_lim = sqrt_(ax1 * ax1 * s2t + ax2 * ax2 * c2t);
  const S proj[4] = {x_c - x_lim, y_c - y_lim, x_c + x_lim, y_c + y_lim};
  const float* bb = g.e2_bbox + 4 * e;
  const float w = g.e2_w[e];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    r[k] = (bb[k] >= 5.f ? proj[k] - bb[k] : Scalar<S>::zero()) * w;
}

// residuals.residual_3d: ellipsoid.min_log_error_9dof of the estimate to
// the measured local ellipsoid in the world, transform_from(meas,
// se3_inv(exp(up) pose)): the log error to each of its 4 yaw rotations
// (-90, 0, 90, 180 deg), the one of least norm (first NaN, else first
// minimum, like jnp.argmin of jnp.linalg.norm)
template <class S>
__device__ void rows_3d(const Graph& g, int e, int dir0, S r[9]) {
  S up[6], uo[9];
  seeds(up, 0, dir0);
  seeds(uo, 6, dir0);
  Pose<S> pc, pw;
  camera(g.poses + 7 * g.e3_frame[e], up, pc);
  se3_inv(pc, pw);
  Est<S> o;
  exp_update(g.objects + 10 * g.e3_obj[e], uo, o);
  const float* m = g.e3_meas + 10 * e;
  Pose<S> mw;
  se3_mul(pw.t, pw.q, m, m + 3, mw);
  float best = 0.f;
#pragma unroll 1
  for (int k = 0; k < 4; ++k) {
    const float zt[3] = {0.f, 0.f, 0.f};
    const float rq[4] = {0.f, 0.f, kYawSin[k], kYawCos[k]};
    Pose<S> rot, inv, diff;
    se3_mul(mw.t, mw.q, zt, rq, rot);
    se3_inv(rot, inv);
    se3_mul(inv.t, inv.q, o.t, o.q, diff);
    S err[9];
    se3_log(diff, err);
    const bool odd = k == 0 || k == 2;    // k = -1 or 1: x and y swap
    err[6] = o.s[0] - m[odd ? 8 : 7];
    err[7] = o.s[1] - m[odd ? 7 : 8];
    err[8] = o.s[2] - m[9];
    float n = val(err[0]) * val(err[0]);
#pragma unroll
    for (int c = 1; c < 9; ++c) n = n + val(err[c]) * val(err[c]);
    n = sqrtf(n);
    const bool take = k == 0 || (isnan(n) && !isnan(best)) || n < best;
    if (take) {
      best = n;
#pragma unroll
      for (int c = 0; c < 9; ++c) r[c] = err[c];
    }
  }
  const float w = g.e3_w[e];
#pragma unroll
  for (int c = 0; c < 9; ++c) r[c] = r[c] * w;
}

// slam_ba._odo_residual: log(meas * Tcw_i * Tcw_j^-1), both cameras free
template <class S>
__device__ void rows_odo(const Graph& g, int e, int dir0, S r[6]) {
  S ui[6], uj[6];
  seeds(ui, 0, dir0);
  seeds(uj, 6, dir0);
  Pose<S> pi, pj, pji, a, delta;
  camera(g.poses + 7 * g.odo_i[e], ui, pi);
  camera(g.poses + 7 * g.odo_j[e], uj, pj);
  const float* m = g.odo_meas + 7 * e;
  se3_mul(m, m + 3, pi.t, pi.q, a);
  se3_inv(pj, pji);
  se3_mul(a.t, a.q, pji.t, pji.q, delta);
  se3_log(delta, r);
  const float w = g.odo_w[e];
#pragma unroll
  for (int c = 0; c < 6; ++c) r[c] = r[c] * w;
}

// residuals.residual_gravity of exp_update(obj, uo)
template <class S>
__device__ S row_grav(const Graph& g, int k, int dir0) {
  S uo[9];
  seeds(uo, 0, dir0);
  Est<S> o;
  exp_update(g.objects + 10 * k, uo, o);
  S R[3][3];
  qtomat(o.q, R);
  return residual_gravity(R, g.normal) * g.grav_w[k];
}

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

// an edge's NR rows r and this thread's columns of [J_a (NA) | J_b (NB)];
// with ``gate`` a non-finite residual component zeroes the edge
template <int NR, int NA, int NB>
__device__ void store(const DW (&r)[NR], int grp, bool gate, float* rout,
                      float* Ja, float* Jb) {
  bool bad = false;
  if (gate) {
#pragma unroll
    for (int c = 0; c < NR; ++c) bad = bad || !isfinite(r[c].v);
  }
  if (grp == 0) {
#pragma unroll
    for (int c = 0; c < NR; ++c) rout[c] = bad ? 0.f : r[c].v;
  }
#pragma unroll
  for (int c = 0; c < NR; ++c)
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      const int col = kW * grp + j;
      const float x = bad ? 0.f : r[c].d[j];
      if (col < NA)
        Ja[NA * c + col] = x;
      else if (col < NA + NB)
        Jb[NB * c + col - NA] = x;
    }
}

// the sum of an edge's squared rows behind the non-finite gate
template <int NR>
__device__ __forceinline__ float gated_square_sum(const float (&r)[NR]) {
  bool bad = false;
#pragma unroll
  for (int c = 0; c < NR; ++c) bad = bad || !isfinite(r[c]);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < NR; ++c) s = s + r[c] * r[c];
  return bad ? 0.f : s;
}

}  // namespace

// Without a card the chains above compile alone with a host C++ compiler
// (-DOSLAM_HOST_CHAINS and definitions of the CUDA qualifiers), which lets
// them be held against the plain version off the card.
#ifndef OSLAM_HOST_CHAINS

// thread t: (edge, direction group) over the 2D, 3D, odometry and gravity
// lists in turn
static __global__ void __launch_bounds__(kThreads) slam_edge_terms_kernel(
    const Graph g, const Out o) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n2 = (long long)g.E2 * kGroups2;
  const long long n3 = (long long)g.E3 * kGroups3;
  const long long no = (long long)g.Eo * kGroupsO;
  const long long ng = (long long)g.Ko * kGroupsG;
  if (t < n2) {
    const int e = (int)(t / kGroups2), grp = (int)(t % kGroups2);
    DW r[4];
    rows_2d(g, e, kW * grp, r);
    store<4, 6, 9>(r, grp, true, o.r2 + 4 * e, o.Jp2 + 24 * e, o.Jo2 + 36 * e);
    return;
  }
  t -= n2;
  if (t < n3) {
    const int e = (int)(t / kGroups3), grp = (int)(t % kGroups3);
    DW r[9];
    rows_3d(g, e, kW * grp, r);
    store<9, 6, 9>(r, grp, true, o.r3 + 9 * e, o.Jp3 + 54 * e, o.Jo3 + 81 * e);
    return;
  }
  t -= n3;
  if (t < no) {
    const int e = (int)(t / kGroupsO), grp = (int)(t % kGroupsO);
    DW r[6];
    rows_odo(g, e, kW * grp, r);
    store<6, 6, 6>(r, grp, true, o.ro + 6 * e, o.Ji + 36 * e, o.Jj + 36 * e);
    return;
  }
  t -= no;
  if (t < ng) {
    const int k = (int)(t / kGroupsG), grp = (int)(t % kGroupsG);
    DW r[1] = {row_grav<DW>(g, k, kW * grp)};
    store<1, 9, 0>(r, grp, false, o.rg + k, o.Jg + 9 * k, nullptr);
  }
}

// one edge a thread; the block's sum, then the last block's sum of blocks
static __global__ void __launch_bounds__(kThreads) slam_chi2_kernel(
    const Graph g, float* partial, unsigned int* done, float* chi2) {
  __shared__ float sh_warp[kThreads / 32];
  __shared__ bool sh_last;
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  float s = 0.f;
  if (t < g.E2) {
    float r[4];
    rows_2d(g, t, 0, r);
    s = gated_square_sum(r);
  } else if ((t -= g.E2) < g.E3) {
    float r[9];
    rows_3d(g, t, 0, r);
    s = gated_square_sum(r);
  } else if ((t -= g.E3) < g.Eo) {
    float r[6];
    rows_odo(g, t, 0, r);
    s = gated_square_sum(r);
  } else if ((t -= g.Eo) < g.Ko) {
    const float r = row_grav<float>(g, t, 0);
    s = r * r;
  }
  // lanes by a fixed xor pattern, warps in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(kFullWarp, s, off);
  const int tid = threadIdx.x;
  if ((tid & 31) == 0) sh_warp[tid >> 5] = s;
  __syncthreads();
  if (tid == 0) {
    float b = sh_warp[0];
    for (int w = 1; w < kThreads / 32; ++w) b += sh_warp[w];
    partial[blockIdx.x] = b;
    __threadfence();
    sh_last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (sh_last && tid == 0) {
    __threadfence();
    const volatile float* vp = partial;
    float total = vp[0];
    for (unsigned b = 1; b < gridDim.x; ++b) total += vp[b];
    *chi2 = total;
  }
}

static Graph graph(const float* poses, const float* objects, const float* K,
            const float* normal, const long long* e2_frame,
            const long long* e2_obj, const float* e2_bbox, const float* e2_w,
            const long long* e3_frame, const long long* e3_obj,
            const float* e3_meas, const float* e3_w, const long long* odo_i,
            const long long* odo_j, const float* odo_meas, const float* odo_w,
            const float* grav_w, int E2, int E3, int Eo, int Ko) {
  Graph g;
  g.poses = poses;
  g.objects = objects;
  g.K = K;
  g.normal = normal;
  g.e2_frame = e2_frame;
  g.e2_obj = e2_obj;
  g.e2_bbox = e2_bbox;
  g.e2_w = e2_w;
  g.e3_frame = e3_frame;
  g.e3_obj = e3_obj;
  g.e3_meas = e3_meas;
  g.e3_w = e3_w;
  g.odo_i = odo_i;
  g.odo_j = odo_j;
  g.odo_meas = odo_meas;
  g.odo_w = odo_w;
  g.grav_w = grav_w;
  g.E2 = E2;
  g.E3 = E3;
  g.Eo = Eo;
  g.Ko = Ko;
  return g;
}

static int blocks(long long items) {
  return (int)((items + kThreads - 1) / kThreads);
}

// Every function returns the CUDA error code of its launch (0 = launched).
// The indices are int64 and the caller guarantees them inside [0, F) and
// [0, K) (slam_mode.build_slam_graph emits them so).
extern "C" {

#define OSLAM_GRAPH_ARGS                                                   \
  const float *poses, const float *objects, const float *K,                \
      const float *normal, const long long *e2_frame,                      \
      const long long *e2_obj, const float *e2_bbox, const float *e2_w,    \
      const long long *e3_frame, const long long *e3_obj,                  \
      const float *e3_meas, const float *e3_w, const long long *odo_i,     \
      const long long *odo_j, const float *odo_meas, const float *odo_w,   \
      const float *grav_w, int E2, int E3, int Eo, int Ko, int F
#define OSLAM_GRAPH                                                        \
  graph(poses, objects, K, normal, e2_frame, e2_obj, e2_bbox, e2_w,        \
        e3_frame, e3_obj, e3_meas, e3_w, odo_i, odo_j, odo_meas, odo_w,    \
        grav_w, E2, E3, Eo, Ko)

int oslam_slam_edge_terms(OSLAM_GRAPH_ARGS, float* r2, float* Jp2,
                          float* Jo2, float* r3, float* Jp3, float* Jo3,
                          float* ro, float* Ji, float* Jj, float* rg,
                          float* Jg, void* stream) {
  if (E2 < 0 || E3 < 0 || Eo < 0 || Ko < 0 || F < 1)
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)E2 * kGroups2 + (long long)E3 * kGroups3 +
                          (long long)Eo * kGroupsO + (long long)Ko * kGroupsG;
  if (items == 0) return 0;
  Out o = {r2, Jp2, Jo2, r3, Jp3, Jo3, ro, Ji, Jj, rg, Jg};
  slam_edge_terms_kernel<<<blocks(items), kThreads, 0,
                           (cudaStream_t)stream>>>(OSLAM_GRAPH, o);
  return (int)cudaGetLastError();
}

// partial: one float a block (blocks of kThreads threads over E2 + E3 +
// Eo + Ko edges, at least one); done: a zeroed counter
int oslam_slam_chi2(OSLAM_GRAPH_ARGS, float* partial, unsigned int* done,
                    float* chi2, void* stream) {
  if (E2 < 0 || E3 < 0 || Eo < 0 || Ko < 0 || F < 1)
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)E2 + E3 + Eo + Ko;
  const int n_blocks = items > 0 ? blocks(items) : 1;
  slam_chi2_kernel<<<n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      OSLAM_GRAPH, partial, done, chi2);
  return (int)cudaGetLastError();
}

const char* oslam_slam_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

#endif  // OSLAM_HOST_CHAINS
