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
// on the scalar type (float or Dual<N>, dual.cuh), every branch selects on
// the primal value and each derivative rule copies the JAX rule it
// replaces.  The operations follow the JAX package's SLAM functions (core/
// se3.py, core/ellipsoid.py project_bbox, min_log_error_9dof), not the
// mapping kernels' forms: the pose is a dual here, and the 3D candidate is
// picked by the norm (jnp.linalg.norm), where ba_edges.cu's residual_3d
// picks it by the squared norm.
//
// Layout.  An edge has up to 15 tangent directions (6 pose + 9 object),
// dealt over consecutive threads, KW a thread: the Jacobian kernel is a
// template on KW, built at 1, 2, 3 and 5, and the entry point launches
// KW = 1 (backend/slam_kernels.LANES) at 128 threads a block, as many
// blocks as the graph's counts deal (211 at chip_smoke.py's [slam] graph,
// over the card's 132 SMs).  On an H100 at that graph KW = 1 beat 2, 3
// and 5, and 128 threads a block beat 32 and 64 at KW = 1, 2 and 3
// (examples/torch_slam_edges_bench.py).  Every thread of an edge computes
// the same primal bits and its own columns of J (the tangent components
// of a dual operation never mix, so J's bits do not depend on KW); thread
// 0 of the edge writes r.  A 3D edge's group (padded to a power of 2, at
// least 4; the 3D edges dealt in whole warps) computes the object and the
// measurement in the world in duals; thread j < 4 scores yaw candidate j
// in float from their primal values (a Dual computes its primal by the
// float chain's own operations, so these are the float chain's bits);
// every thread reads the four norms by shuffles in candidate order and
// takes the winner (the first NaN, else the first least), and only the
// winner's chain runs in duals.  Every output element is written by one
// thread: the launch repeats bit for bit.
//
// The chi2 instantiation runs 32 edges a block on four lanes each: a 3D
// edge scores candidate j on lane j and its winner's lane forms the gated
// sum of squares, any other edge runs its chain on lane 0.  The edges'
// sums are added in a fixed tree: 128 edges in order by a fixed
// xor-shuffle pattern over each 32 and the four 32s in order, then those
// in order; the last block to finish, by a ticket on a counter, adds the
// blocks' sums and sets the counter back to zero, so the caller zeroes it
// once and a launch is one device operation.  No floating-point atomics:
// equal inputs give equal bits.  Built without --use_fast_math and with -fmad=false, as
// ba_edges.cu.
//
// What bounds it: neither bytes nor operations.  At chip_smoke.py's [slam]
// graph (1,024 2D, 512 3D and 255 odometry edges, 32 objects; 994 / 434 /
// 159 live, 24 gravity priors) a launch moves ~1 MB, and the work it must
// do (examples/torch_slam_edges_on_cpu.py's count_ops on the live edges:
// an edge's primal chain once, a 3D edge's four candidates' primals, and
// the tangent work of its winner alone) is well under a microsecond of the
// card's peak.  Each thread runs one long dependent chain of IEEE div /
// sqrt / atan2 / sin / cos: latency, then.  The design shortens the
// longest chain (the 3D edge's: four candidates in float over four
// threads, then one dual chain in place of four) and spreads the chains
// over more threads and SMs (79 registers a thread at KW = 1, no spill).

#include <cuda_runtime.h>
#include <math.h>

#include "dual.cuh"

namespace {

constexpr unsigned kFullWarp = 0xffffffffu;
// tangent directions of a 2D, 3D and odometry edge and of a gravity prior
constexpr int kDirs2 = 15, kDirs3 = 15, kDirsO = 12, kDirsG = 9;
constexpr int kThreads = 128;             // threads of a Jacobian block
constexpr int kChiEdges = 32;             // edges of a chi2 block, 4 lanes each
constexpr int kChiThreads = 4 * kChiEdges;

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
// directions dir0 .. dir0 + N - 1 of the edge's list (its first argument
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
// minimum, like jnp.argmin of jnp.linalg.norm).  The choice reads primal
// values alone, and a Dual's primal is the float chain's bits (dual.cuh:
// every rule computes the value by the float operation), so the four
// candidates are scored in float (pick_yaw) and only the winner's chain
// carries tangents.

// the 3D edge's object after its update and the measurement in the world
template <class S>
__device__ void frame_3d(const Graph& g, int e, int dir0, Est<S>& o,
                         Pose<S>& mw) {
  S up[6], uo[9];
  seeds(up, 0, dir0);
  seeds(uo, 6, dir0);
  Pose<S> pc, pw;
  camera(g.poses + 7 * g.e3_frame[e], up, pc);
  se3_inv(pc, pw);
  exp_update(g.objects + 10 * g.e3_obj[e], uo, o);
  const float* m = g.e3_meas + 10 * e;
  se3_mul(pw.t, pw.q, m, m + 3, mw);
}

// the log error to the measurement turned by yaw candidate k
template <class S>
__device__ void yaw_error(const Est<S>& o, const Pose<S>& mw, const float* m,
                          int k, S err[9]) {
  const float zt[3] = {0.f, 0.f, 0.f};
  const float rq[4] = {0.f, 0.f, kYawSin[k], kYawCos[k]};
  Pose<S> rot, inv, diff;
  se3_mul(mw.t, mw.q, zt, rq, rot);
  se3_inv(rot, inv);
  se3_mul(inv.t, inv.q, o.t, o.q, diff);
  se3_log(diff, err);
  const bool odd = k == 0 || k == 2;      // k = -1 or 1: x and y swap
  err[6] = o.s[0] - m[odd ? 8 : 7];
  err[7] = o.s[1] - m[odd ? 7 : 8];
  err[8] = o.s[2] - m[9];
}

__device__ __forceinline__ float err_norm(const float* err) {
  float n = err[0] * err[0];
#pragma unroll
  for (int c = 1; c < 9; ++c) n = n + err[c] * err[c];
  return sqrtf(n);
}

// whether candidate k, of norm n, replaces the best so far
__device__ __forceinline__ bool takes(int k, float n, float best) {
  return k == 0 || (isnan(n) && !isnan(best)) || n < best;
}

// candidate k's error of 3D edge e in float (err) and its norm
__device__ float candidate(const Graph& g, int e, int k, float err[9]) {
  Est<float> o;
  Pose<float> mw;
  frame_3d(g, e, 0, o, mw);
  yaw_error(o, mw, g.e3_meas + 10 * e, k, err);
  return err_norm(err);
}

// the winner among the candidates of norms n[0 .. 3]: the first NaN, else
// the first least
__device__ __forceinline__ int choice(const float (&n)[4]) {
  float best = n[0];
  int win = 0;
#pragma unroll
  for (int k = 1; k < 4; ++k)
    if (takes(k, n[k], best)) {
      best = n[k];
      win = k;
    }
  return win;
}

// the norm of candidate k's error from the primal values of 3D edge e's
// dual frame (frame_3d): the float chain's bits
template <int N>
__device__ float primal_norm(const Graph& g, int e, const Est<Dual<N>>& o,
                             const Pose<Dual<N>>& mw, int k) {
  Est<float> of;
  Pose<float> mf;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    of.t[i] = o.t[i].v;
    of.s[i] = o.s[i].v;
    mf.t[i] = mw.t[i].v;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    of.q[i] = o.q[i].v;
    mf.q[i] = mw.q[i].v;
  }
  float err[9];
  yaw_error(of, mf, g.e3_meas + 10 * e, k, err);
  return err_norm(err);
}

// a 3D edge's weighted rows by candidate k's chain from its frame
template <class S>
__device__ void rows_3d_from(const Graph& g, int e, const Est<S>& o,
                             const Pose<S>& mw, int k, S r[9]) {
  yaw_error(o, mw, g.e3_meas + 10 * e, k, r);
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

// an edge's NR rows r and this thread's KW columns of [J_a (NA) | J_b
// (NB)]; with ``gate`` a non-finite residual component zeroes the edge
template <int NR, int NA, int NB, int KW>
__device__ void store(const Dual<KW> (&r)[NR], int grp, bool gate,
                      float* rout, float* Ja, float* Jb) {
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
    for (int j = 0; j < KW; ++j) {
      const int col = KW * grp + j;
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

// ---------------------------------------------------------------------------
// The Jacobian launch's dealing
// ---------------------------------------------------------------------------

// threads of an edge of ``dirs`` tangent directions, kw a thread
__host__ __device__ constexpr int groups(int dirs, int kw) {
  return (dirs + kw - 1) / kw;
}
// threads of a 3D edge: its groups, and at least one a yaw candidate, to a
// power of 2 (a group then never straddles a warp)
__host__ __device__ constexpr int groups3(int kw) {
  return groups(kDirs3, kw) <= 4 ? 4 : groups(kDirs3, kw) <= 8 ? 8 : 16;
}
__host__ __device__ constexpr long long warps32(long long n) {
  return (n + 31) / 32 * 32;
}

// where each kind's threads start: the 2D edges' at 0, the 3D edges' at s3
// (whole warps: every lane reaches the candidates' shuffles), then the
// odometry edges', the gravity priors', and the end
struct Deal {
  long long s3, so, sg, end;
};
__host__ __device__ inline Deal deal(int E2, int E3, int Eo, int Ko,
                                     int kw) {
  Deal d;
  d.s3 = warps32((long long)E2 * groups(kDirs2, kw));
  d.so = d.s3 + warps32((long long)E3 * groups3(kw));
  d.sg = d.so + (long long)Eo * groups(kDirsO, kw);
  d.end = d.sg + (long long)Ko * groups(kDirsG, kw);
  return d;
}

}  // namespace

// Without a card the chains above compile alone with a host C++ compiler
// (-DOSLAM_HOST_CHAINS and definitions of the CUDA qualifiers), which lets
// them be held against the plain version off the card; with
// -DOSLAM_HOST_KERNELS too the kernels below compile as well, for a host
// that runs their blocks' threads with the warps' shuffles emulated.
#if !defined(OSLAM_HOST_CHAINS) || defined(OSLAM_HOST_KERNELS)

namespace {

// the winning yaw candidate of a 3D edge whose group starts at lane
// ``base`` of the warp, lane base + j holding candidate j's norm n (j <
// 4): every lane reads the four in candidate order.  Every lane of the
// warp calls it.
__device__ __forceinline__ int vote(float n, int base) {
  float nk[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) nk[c] = __shfl_sync(kFullWarp, n, base + c);
  return choice(nk);
}

#ifdef OSLAM_SLAM_CLOCKS
// cycles of the Jacobian launch's threads by kind (2D, 3D, odometry,
// gravity) and phase (0 a 3D edge's dual frame and yaw vote, 1 the chain
// (the winner's), 2 the store): [kind]
// [0 threads, 1 + phase: sum, 4 + phase: largest]
__device__ unsigned long long oslam_slam_clock[4][7];
#define SLAM_CLOCK(v) const long long v = clock64()
__device__ __forceinline__ void slam_clocks(int kind, long long c0,
                                            long long c1, long long c2,
                                            long long c3) {
  unsigned long long* a = oslam_slam_clock[kind];
  const unsigned long long d[3] = {(unsigned long long)(c1 - c0),
                                   (unsigned long long)(c2 - c1),
                                   (unsigned long long)(c3 - c2)};
  atomicAdd(a, 1ull);
  for (int i = 0; i < 3; ++i) {
    atomicAdd(a + 1 + i, d[i]);
    atomicMax(a + 4 + i, d[i]);
  }
}
#define SLAM_CLOCKS(kind, c0, c1, c2, c3) slam_clocks(kind, c0, c1, c2, c3)
#else
#define SLAM_CLOCK(v)
#define SLAM_CLOCKS(kind, c0, c1, c2, c3)
#endif

#ifdef OSLAM_HOST_KERNELS
// the host build's chi2 launch also writes each edge's gated sum of
// squares here where it is set (its tests hold the sums bit for bit)
static float* host_terms = nullptr;
#define SLAM_TERM(g, e, s)                                           \
  if (host_terms != nullptr && (e) < (long long)(g).E2 + (g).E3 +    \
                                         (g).Eo + (g).Ko)            \
  host_terms[e] = (s)
#else
#define SLAM_TERM(g, e, s)
#endif

// thread t of the Jacobian launch at KW tangent directions a thread: an
// edge's threads are consecutive lanes, thread grp of the edge computes
// the primal chain and the tangents of directions KW grp .. KW grp + KW - 1
// and writes those columns of J, thread 0 also r
template <int KW>
__device__ void edge_terms_thread(const Graph& g, const Out& o,
                                  long long t) {
  using D = Dual<KW>;
  constexpr int G2 = groups(kDirs2, KW), G3 = groups(kDirs3, KW);
  constexpr int P3 = groups3(KW), GO = groups(kDirsO, KW);
  constexpr int GG = groups(kDirsG, KW);
  const Deal d = deal(g.E2, g.E3, g.Eo, g.Ko, KW);
  SLAM_CLOCK(c0);
  if (t < d.s3) {
    const int e = (int)(t / G2), grp = (int)(t % G2);
    if (e >= g.E2) return;
    D r[4];
    rows_2d(g, e, KW * grp, r);
    SLAM_CLOCK(c2);
    store<4, 6, 9>(r, grp, true, o.r2 + 4 * e, o.Jp2 + 24 * e,
                   o.Jo2 + 36 * e);
    SLAM_CLOCK(c3);
    SLAM_CLOCKS(0, c0, c0, c2, c3);
  } else if (t < d.so) {
    // thread j of the edge's group: its dual frame, from whose primal
    // values (j < 4) candidate j's norm; then the winner's chain
    const long long u = t - d.s3;
    const int e = (int)(u / P3), j = (int)(u % P3);
    Est<D> ob;
    Pose<D> mw;
    float n = 0.f;
    if (e < g.E3 && (j < 4 || j < G3)) {
      frame_3d(g, e, KW * j, ob, mw);
      if (j < 4) n = primal_norm(g, e, ob, mw, j);
    }
    const int k = vote(n, (int)(u & 31) - j);
    if (e >= g.E3 || j >= G3) return;
    SLAM_CLOCK(c1);
    D r[9];
    rows_3d_from(g, e, ob, mw, k, r);
    SLAM_CLOCK(c2);
    store<9, 6, 9>(r, j, true, o.r3 + 9 * e, o.Jp3 + 54 * e,
                   o.Jo3 + 81 * e);
    SLAM_CLOCK(c3);
    SLAM_CLOCKS(1, c0, c1, c2, c3);
  } else if (t < d.sg) {
    const long long u = t - d.so;
    const int e = (int)(u / GO), grp = (int)(u % GO);
    D r[6];
    rows_odo(g, e, KW * grp, r);
    SLAM_CLOCK(c2);
    store<6, 6, 6>(r, grp, true, o.ro + 6 * e, o.Ji + 36 * e,
                   o.Jj + 36 * e);
    SLAM_CLOCK(c3);
    SLAM_CLOCKS(2, c0, c0, c2, c3);
  } else if (t < d.end) {
    const long long u = t - d.sg;
    const int k = (int)(u / GG), grp = (int)(u % GG);
    D r[1] = {row_grav<D>(g, k, KW * grp)};
    SLAM_CLOCK(c2);
    store<1, 9, 0>(r, grp, false, o.rg + k, o.Jg + 9 * k, nullptr);
    SLAM_CLOCK(c3);
    SLAM_CLOCKS(3, c0, c0, c2, c3);
  }
}

template <int KW>
static __global__ void __launch_bounds__(kThreads)
    slam_edge_terms_kernel(const Graph g, const Out o) {
  edge_terms_thread<KW>(g, o, (long long)blockIdx.x * blockDim.x +
                                  threadIdx.x);
}

// a block of kChiEdges consecutive edges of the list (2D, 3D, odometry,
// gravity), four lanes an edge: a 3D edge scores its yaw candidate j on
// lane j and its winner's lane forms the gated sum of squares, any other
// edge runs its float chain on lane 0.  Warp 0 adds the block's kChiEdges
// sums by a fixed xor-shuffle pattern; the last block to finish (a ticket
// on a counter at zero, which it sets back to zero) adds the blocks' sums
// four at a time in block order, then those in order: the sum tree of 128
// edges a block of one lane each, its four warps in order, the blocks in
// order.  No floating-point atomics; equal inputs give equal bits.
static __global__ void __launch_bounds__(kChiThreads) slam_chi2_kernel(
    const Graph g, float* partial, unsigned int* done, float* chi2) {
  __shared__ float sh_sum[kChiEdges];
  __shared__ bool sh_last;
  const int tid = threadIdx.x, i = tid >> 2, j = tid & 3;
  long long t = (long long)blockIdx.x * kChiEdges + i;
  const bool is3 = t >= g.E2 && t < (long long)g.E2 + g.E3;
  float err[9];
  const int k = vote(is3 ? candidate(g, (int)(t - g.E2), j, err) : 0.f,
                     (tid & 31) - j);
  float s = 0.f;
  bool mine = j == 0;                     // the lane that forms the sum
  if (is3) {
    mine = j == k;
    if (mine) {
      const float w = g.e3_w[t - g.E2];
#pragma unroll
      for (int c = 0; c < 9; ++c) err[c] = err[c] * w;
      s = gated_square_sum(err);
    }
  } else if (mine) {
    if (t < g.E2) {
      float r[4];
      rows_2d(g, (int)t, 0, r);
      s = gated_square_sum(r);
    } else if ((t -= (long long)g.E2 + g.E3) < g.Eo) {
      float r[6];
      rows_odo(g, (int)t, 0, r);
      s = gated_square_sum(r);
    } else if ((t -= g.Eo) < g.Ko) {
      const float r = row_grav<float>(g, (int)t, 0);
      s = r * r;
    }
  }
  if (mine) {
    sh_sum[i] = s;
    SLAM_TERM(g, (long long)blockIdx.x * kChiEdges + i, s);
  }
  __syncthreads();
  if (tid < 32) {
    float v = sh_sum[tid];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(kFullWarp, v, off);
    if (tid == 0) {
      partial[blockIdx.x] = v;
      __threadfence();
      sh_last = atomicAdd(done, 1u) == gridDim.x - 1;
    }
  }
  __syncthreads();
  if (sh_last && tid == 0) {
    __threadfence();
    const volatile float* vp = partial;
    float total = 0.f;
    for (unsigned b = 0; b < gridDim.x; b += 4) {
      float sum = vp[b];
      for (unsigned w = 1; w < 4; ++w) sum += vp[b + w];
      total = b == 0 ? sum : total + sum;
    }
    *chi2 = total;
    *done = 0u;           // every other block has taken its ticket
  }
}

// the launch shape of the Jacobian instantiation at ``lanes`` (1, 2, 3 or
// 5): out = (threads a block, blocks, threads dealt); false for other
// lanes
inline bool edge_terms_shape(int E2, int E3, int Eo, int Ko, int lanes,
                             long long out[3]) {
  if (lanes != 1 && lanes != 2 && lanes != 3 && lanes != 5) return false;
  const long long items = deal(E2, E3, Eo, Ko, lanes).end;
  out[0] = kThreads;
  out[1] = (items + kThreads - 1) / kThreads;
  out[2] = items;
  return true;
}

// calls launch(kernel) with the Jacobian kernel at ``lanes``
template <class L>
inline void with_lanes(int lanes, L launch) {
  switch (lanes) {
    case 1: launch(slam_edge_terms_kernel<1>); break;
    case 2: launch(slam_edge_terms_kernel<2>); break;
    case 3: launch(slam_edge_terms_kernel<3>); break;
    case 5: launch(slam_edge_terms_kernel<5>); break;
  }
}

// blocks of a chi2 launch over n edges: four for each 128 edges, at
// least four
inline long long chi2_blocks(long long n) {
  return 4 * (n > 0 ? (n + 127) / 128 : 1);
}

}  // namespace

#endif  // kernels

#ifndef OSLAM_HOST_CHAINS

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

// (threads a block, blocks, threads dealt) of a Jacobian launch at
// ``lanes``; 0, or cudaErrorInvalidValue for lanes it does not take
int oslam_slam_edge_terms_shape(int E2, int E3, int Eo, int Ko, int lanes,
                                long long* out) {
  if (E2 < 0 || E3 < 0 || Eo < 0 || Ko < 0 ||
      !edge_terms_shape(E2, E3, Eo, Ko, lanes, out))
    return (int)cudaErrorInvalidValue;
  return 0;
}

int oslam_slam_edge_terms(OSLAM_GRAPH_ARGS, float* r2, float* Jp2,
                          float* Jo2, float* r3, float* Jp3, float* Jo3,
                          float* ro, float* Ji, float* Jj, float* rg,
                          float* Jg, int lanes, void* stream) {
  long long shape[3];
  if (E2 < 0 || E3 < 0 || Eo < 0 || Ko < 0 || F < 1 ||
      !edge_terms_shape(E2, E3, Eo, Ko, lanes, shape))
    return (int)cudaErrorInvalidValue;
  if (shape[2] == 0) return 0;
  const Graph g = OSLAM_GRAPH;
  const Out o = {r2, Jp2, Jo2, r3, Jp3, Jo3, ro, Ji, Jj, rg, Jg};
  with_lanes(lanes, [&](auto kernel) {
    kernel<<<(unsigned)shape[1], (unsigned)shape[0], 0,
             (cudaStream_t)stream>>>(g, o);
  });
  return (int)cudaGetLastError();
}

// partial: chi2_blocks(E2 + E3 + Eo + Ko) floats; done: a counter at zero,
// which the launch leaves at zero (launches that share it run in turn)
int oslam_slam_chi2(OSLAM_GRAPH_ARGS, float* partial, unsigned int* done,
                    float* chi2, void* stream) {
  if (E2 < 0 || E3 < 0 || Eo < 0 || Ko < 0 || F < 1)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)E2 + E3 + Eo + Ko;
  slam_chi2_kernel<<<(unsigned)chi2_blocks(n), kChiThreads, 0,
                     (cudaStream_t)stream>>>(OSLAM_GRAPH, partial, done,
                                             chi2);
  return (int)cudaGetLastError();
}

#ifdef OSLAM_SLAM_CLOCKS
int oslam_slam_clocks(void* host, int reset) {
  int rc = (int)cudaMemcpyFromSymbol(host, oslam_slam_clock,
                                     sizeof(oslam_slam_clock));
  if (rc == 0 && reset) {
    static const unsigned long long zero[4][7] = {};
    rc = (int)cudaMemcpyToSymbol(oslam_slam_clock, zero, sizeof(zero));
  }
  return rc;
}
#endif

const char* oslam_slam_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

#endif  // OSLAM_HOST_CHAINS
