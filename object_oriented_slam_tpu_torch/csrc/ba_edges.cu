// Mapping-mode bundle-adjustment edge kernels for Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of attic/pallas_ba_kernels.py:
//   K1 edge2d_normal_eq (:183) + K2 edge3d_normal_eq (:202) -> ba_normal_eq
//   K3 edge2d_chi2      (:219) + K4 edge3d_chi2      (:238) -> ba_chi2
// and computes exactly what backend/lm_soa.py's soa_normal_eq and soa_chi2
// compute: for every object, the sqrt-info-weighted residuals of its 2D
// projected-bbox edges, its 9-DoF 3D edges (least error over 4
// yaw-symmetric rotations) and its gravity prior, at the estimate
// exp_update(est, u) with u = 0, and from them
//   ba_normal_eq: H = sum J^T J [O,9,9], g = sum J^T r [O,9], sum r^2 [O]
//                 (an edge with a non-finite tangent is left out of all three)
//   ba_chi2:      sum r^2 [O]
// The weights arrive with every gate folded in (zero = inactive edge; such
// an edge contributes exact zeros and its chain is skipped).
//
// Each kernel has a second entry point that goes on, in the block that
// holds an object's reduced sums, with the per-object part of one LM
// iteration, in lm_soa's order of operations:
//   ba_normal_eq + solve:  lam0, A = H + lam0 I, the unrolled 9x9 Cholesky
//     solve of ops/linalg.chol_solve_small, du = -x behind the all-finite
//     gate, est_new = exp_update(est, du)      (lm_soa.lm_solve_step_plain)
//   ba_chi2 + accept:  chi2 at est_new, rho, the accept test and the
//     lambda / nu schedule, with est, chi2, lam and nu updated in place
//                                             (lm_soa.lm_accept_step_plain)
// so one LM iteration is two launches with nothing in between.
//
// The residual chain is written once, templated on the scalar type S.
// ba_chi2 instantiates it with float; ba_normal_eq with Dual<9>, a
// forward-mode dual number carrying the value and its derivative along the
// 9 tangent directions, seeded at u = 0 -- what jax.linearize does in the
// JAX package.  Every branch (small-angle Taylor forms, the argmin over the
// 4 rotations, the NaN/inf gate, the Huber weight) selects on the primal
// value, as jnp.where does, and only the selected branch is evaluated; each
// derivative rule copies the JAX rule it replaces, including the JAX tie
// rule of max/min, so NaN/inf tangents appear where they appear in the JAX
// package (the LM's du_ok gate depends on them).
//
// What bounds the kernels, and what the design does about it.  Neither
// memory nor arithmetic throughput: an edge reads 48 bytes (2D) or 172
// bytes (3D) and costs a few thousand f32 operations in Dual<9>, so a whole
// call is under two microseconds of the card's peak either way.  What
// costs is latency: one long dependent chain of IEEE div / sqrt / atan2 per
// edge, run once by a warp that has its scheduler to itself, then the
// reduction, then the serial per-object epilogue.  (On an H100 at the main
// tier, 24 objects x 544 edge slots, a launch of ba_normal_eq with its
// solve epilogue spends most of its time in three serial stretches: the
// per-object part, one edge chain, the solve epilogue;
// examples/torch_ba_launch_sweep.py prints the phases' clocks.)
//  - Filling the card: one thread block cluster per object (grid S x O,
//    cluster dimension S <= 8).  The edges of both kinds are one list dealt
//    over the S x T threads, so that at the main shapes a thread runs one
//    chain and O x S blocks are in flight.  The host picks S and T from
//    M2 + M3 (backend/ba_kernels.launch_shape).
//  - Registers: a thread keeps no accumulators over its chain.  When the
//    chain is done its rows (r, dr/du_0..8), 4 for a 2D edge and 9 for a 3D
//    edge, are all it holds (the 3D chain writes its best candidate
//    straight into shared memory, so no second set of nine duals stays
//    live), and the warp takes its J^T J there and then: each of the
//    45 + 9 + 1 products is summed over the lane's rows, reduced over the
//    lanes with a fixed xor-shuffle pattern and kept by one lane -- in f32
//    on the CUDA cores (TF32 would not hold H to 1e-4), with no barrier
//    between the chains and the sums.  One shared-memory step adds the
//    warps.  The part of the chain that depends on the estimate alone (exp
//    update, rotation matrix, gravity residual) is computed once per block
//    into shared memory by nine lanes, one tangent direction each
//    (Dual<1>): the tangent components of a dual operation do not mix, so
//    the nine lanes give the bits of one Dual<9>.  ptxas: 255 registers,
//    no spills.
//  - Divisions: the nine tangent quotients of a dual division share one
//    IEEE reciprocal instead of nine IEEE divisions.
//  - The reduction is deterministic, with no floating-point atomics: fixed
//    row and lane order inside a warp, warps added in order, and cluster
//    rank 0 adds the S blocks' partial sums in rank order out of their
//    shared memory (distributed shared memory).  ba_chi2 keeps one float
//    per thread and reduces with the same shuffle pattern, one shared step
//    across the warps, then the same walk over the ranks.  chi2 decides
//    the LM's accept test, so equal inputs give equal bits.
//  - The solve epilogue runs the Cholesky factorisation with one lane per
//    matrix row (the operands travel by warp shuffle), each entry with the
//    plain version's own sequence of operations; its inputs (est, lam) are
//    fetched at the start of the kernel.
// The dual numbers and the quaternion / SE3 helpers are in dual.cuh, shared
// with slam_edges.cu.  The 3D-measurement precompute (invp3, sc3) is
// estimate-independent and done once per LM call by the caller.  Built
// without --use_fast_math and
// with -fmad=false: the constants, the IEEE sqrt/div/sin/cos/atan2/acos and
// the per-operation rounding of the JAX package and of the plain PyTorch
// version are kept.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "dual.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 128;          // threads of a block, at most
constexpr int kN = 9;                     // tangent directions
constexpr int kNH = kN * (kN + 1) / 2;    // unique entries of H
constexpr int kNAcc = kNH + kN + 1;       // chi2, g, H
constexpr int kRow = kN + 1;              // floats of a staged row: r, dr/du
constexpr int kSlot3 = 9 * kRow + 1;      // a 3D edge's 9 staged rows; the
                                          //   odd stride keeps banks apart
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr float kTau = 1e-5f;             // lm_soa._TAU

using D9 = Dual<kN>;   // all 9 directions: the per-edge chain
using D1 = Dual<1>;    // one direction: a lane of the per-object part

// ---------------------------------------------------------------------------
// Residuals
// ---------------------------------------------------------------------------

// lm_soa._proj_residual_soa for one edge: projected ellipse bbox minus the
// measured bbox, border coordinates (< 5) skipped
template <class S>
__device__ void residual_2d(const Est<S>& e, const S (&Ro)[3][3],
                            const float* pose, const float* bb, float fx,
                            float fy, float cx, float cy, S r[4]) {
  const float qc[4] = {pose[3], pose[4], pose[5], pose[6]};
  float Rc[3][3];
  qtomat(qc, Rc);
  const float A[3][3] = {
      {fx * Rc[0][0] + cx * Rc[2][0], fx * Rc[0][1] + cx * Rc[2][1],
       fx * Rc[0][2] + cx * Rc[2][2]},
      {fy * Rc[1][0] + cy * Rc[2][0], fy * Rc[1][1] + cy * Rc[2][1],
       fy * Rc[1][2] + cy * Rc[2][2]},
      {Rc[2][0], Rc[2][1], Rc[2][2]}};
  S WS[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      WS[i][j] = (A[i][0] * Ro[0][j] + A[i][1] * Ro[1][j] +
                  A[i][2] * Ro[2][j]) * e.s[j];
  const float kt[3] = {fx * pose[0] + cx * pose[2],
                       fy * pose[1] + cy * pose[2], pose[2]};
  S v[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    v[i] = A[i][0] * e.t[0] + A[i][1] * e.t[1] + A[i][2] * e.t[2] + kt[i];

  auto cs = [&](int i, int j) -> S {
    return (WS[i][0] * WS[j][0] + WS[i][1] * WS[j][1] + WS[i][2] * WS[j][2]) -
           v[i] * v[j];
  };
  S a_ = cs(0, 0), b_ = cs(0, 1), c_ = cs(0, 2);
  S e_ = cs(1, 1), f_ = cs(1, 2);
  S i_ = cs(2, 2);

  S adjA = e_ * i_ - f_ * f_;
  S adjD = -(b_ * i_ - c_ * f_);
  S adjE = a_ * i_ - c_ * c_;
  S adjG = b_ * f_ - c_ * e_;
  S adjH = -(a_ * f_ - c_ * b_);
  S adjI = a_ * e_ - b_ * b_;
  S det = a_ * adjA + b_ * (-(b_ * i_ - f_ * c_)) + c_ * (b_ * f_ - e_ * c_);
  det = det + (val(det) == 0.f ? 1e-30f : 0.f);
  S c00 = adjA / det;
  S c01 = adjD / det;
  S c11 = adjE / det;
  S c02 = adjG / det;
  S c21 = adjH / det;
  S c22 = adjI / det;
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
#pragma unroll
  for (int k = 0; k < 4; ++k)
    r[k] = bb[k] >= 5.f ? proj[k] - bb[k] : Scalar<S>::zero();
}

// lm_soa._res3d_soa for one edge: log error to the measured ellipsoid,
// least over the 4 yaw candidates (argmin on values; first NaN, else first
// minimum, like jnp.argmin).  The chosen candidate is written to out as it
// is found: for Dual<9> out is the edge's rows in shared memory, so no
// second set of nine duals stays live in registers.
template <class S>
__device__ void residual_3d(const Est<S>& e, const float* invp,
                            const float* sc, S* out) {
  float best = 0.f;
#pragma unroll 1
  for (int k = 0; k < 4; ++k) {
    const float* p = invp + 7 * k;
    const float* s = sc + 3 * k;
    S err[9];
    S dt[3], dq[4];
    qrotate(p + 3, e.t, dt);
    dt[0] = p[0] + dt[0];
    dt[1] = p[1] + dt[1];
    dt[2] = p[2] + dt[2];
    qmul(p + 3, e.q, dq);
    qnormalize(dq);
    so3_log(dq, err);
    vinv_apply(err, dt, err + 3);
    err[6] = e.s[0] - s[0];
    err[7] = e.s[1] - s[1];
    err[8] = e.s[2] - s[2];
    float n = val(err[0]) * val(err[0]);
#pragma unroll
    for (int c = 1; c < 9; ++c) n = n + val(err[c]) * val(err[c]);
    const bool take = k == 0 || (isnan(n) && !isnan(best)) || n < best;
    if (take) {
      best = n;
#pragma unroll
      for (int c = 0; c < 9; ++c) out[c] = err[c];
    }
  }
}

// ---------------------------------------------------------------------------
// Weighting
// ---------------------------------------------------------------------------

// an edge's N residual components, in place: the sqrt-info weight, the
// Huber weight (lm_soa._huber_w, taken on values: no tangent), _finite0
template <int N, class S>
__device__ __forceinline__ void weigh(S* r, float w, float delta,
                                      float delta2) {
#pragma unroll
  for (int c = 0; c < N; ++c) r[c] = r[c] * w;
  if (delta > 0.f) {
    float s = val(r[0]) * val(r[0]);
#pragma unroll
    for (int c = 1; c < N; ++c) s = s + val(r[c]) * val(r[c]);
    const float h = s > delta2 ? sqrtf(delta / maxc(sqrtf(s), 1e-12f)) : 1.f;
#pragma unroll
    for (int c = 0; c < N; ++c) r[c] = r[c] * h;
  }
#pragma unroll
  for (int c = 0; c < N; ++c) r[c] = finite0(r[c]);
}

// lm_soa._drop_nonfinite_edges: whether every tangent component of an
// edge's N weighted rows is finite.  An edge that fails (the sqrt of a
// projected conic's semi-axis^2 that rounded to zero or below) is left out
// of the launch's sums, rows and residual alike, so one degenerate view does
// not make the object's H non-finite.
template <int N>
__device__ __forceinline__ bool tangents_finite(const D9* r) {
  bool ok = true;
#pragma unroll
  for (int c = 0; c < N; ++c)
#pragma unroll
    for (int k = 0; k < kN; ++k) ok = ok && isfinite(r[c].d[k]);
  return ok;
}

// ---------------------------------------------------------------------------
// The part that depends on the estimate alone, once per block
// ---------------------------------------------------------------------------

// the scalar a lane of the per-object part computes with, and how many
// lanes share the work: one float lane, or nine Dual<1> lanes whose
// directions make up the Dual<9>
template <class S> struct Lane;
template <> struct Lane<float> {
  using type = float;
  static constexpr int n = 1;
};
template <> struct Lane<D9> {
  using type = D1;
  static constexpr int n = kN;
};

__device__ __forceinline__ void put(float& dst, float src, int) { dst = src; }
__device__ __forceinline__ void put(D9& dst, const D1& src, int lane) {
  if (lane == 0) dst.v = src.v;
  dst.d[lane] = src.d[0];
}

// the updated estimate at u = 0, its rotation matrix and (where asked) the
// weighted gravity residual, into shared memory; run by lanes < Lane<S>::n
template <class S>
__device__ void per_object(const float* est, const float* normal, float wg,
                           bool with_gravity, int lane, Est<S>& sh_e,
                           S (&sh_R)[3][3], S& sh_grav) {
  using P = typename Lane<S>::type;
  P u[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) u[i] = Scalar<P>::seed(i, lane);
  Est<P> e;
  exp_update(est, u, e);
  P R[3][3];
  qtomat(e.q, R);
#pragma unroll
  for (int i = 0; i < 3; ++i) put(sh_e.t[i], e.t[i], lane);
#pragma unroll
  for (int i = 0; i < 4; ++i) put(sh_e.q[i], e.q[i], lane);
#pragma unroll
  for (int i = 0; i < 3; ++i) put(sh_e.s[i], e.s[i], lane);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) put(sh_R[i][j], R[i][j], lane);
  if (with_gravity)
    put(sh_grav, finite0(residual_gravity(R, normal) * wg), lane);
}

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

struct Params {
  // the problem (lm_soa.soa_normal_eq's arguments)
  const float* est;       // [O,10] where the edges are evaluated
  const float* pose2d;    // [O,M2,7]
  const float* bbox2d;    // [O,M2,4]
  const float* w2d;       // [O,M2]
  const float* invp3;     // [O,M3,4,7]
  const float* sc3;       // [O,M3,4,3]
  const float* w3d;       // [O,M3]
  const float* wg;        // [O]
  const float* normal;    // [3]
  const float* K;         // [3,3]
  float huber_delta, huber_delta2;
  int M2, M3;
  // sums out (each may be null)
  float* H;               // [O,9,9]
  float* g;               // [O,9]
  float* chi2;            // [O]
  // solve step: lam in; est_new, du, lam0 out (g above)
  const float* lam;       // [O]
  float* est_new;         // [O,10]
  float* du;              // [O,9]
  float* lam0;            // [O]
  // accept step: du, g, lam0 in; est, chi2, lam, nu updated in place
  const float* du_in;
  const float* g_in;
  const float* lam0_in;
  float* est_io;          // [O,10]
  float* chi2_io;         // [O]
  float* lam_io;          // [O]
  float* nu_io;           // [O]
  unsigned char* accept;  // [O]
  long long* clocks;      // [8] phase clocks of ba_normal_eq, or null
};

// Where a launch's time goes, without a kernel profiler: built with
// -DOSLAM_PHASE_CLOCKS, thread 0 of block (0, 0) of ba_normal_eq writes
// clock64() at its phase boundaries into the buffer handed to
// oslam_set_phase_clocks (examples/torch_ba_launch_sweep.py prints them).
#ifdef OSLAM_PHASE_CLOCKS
#define PHASE_CLOCK(i)                                                  \
  if (p.clocks && blockIdx.x == 0 && blockIdx.y == 0 && tid == 0)      \
    p.clocks[i] = clock64();
long long* g_phase_clocks = nullptr;
#else
#define PHASE_CLOCK(i)
#endif

// index of H[k][l], k >= l, among the kNAcc sums: chi2, g[0..8], then H's
// lower triangle row by row
__device__ __forceinline__ int h_index(int k, int l) {
  return 1 + kN + k * (k + 1) / 2 + l;
}

// the two columns of a row (r, dr/du_0..8) whose product sum p is
__device__ __forceinline__ void columns_of(int p, int& a, int& b) {
  if (p == 0) {
    a = b = 0;
  } else if (p <= kN) {
    a = p;
    b = 0;
  } else {
    int idx = p - 1 - kN;
    int k = 0;
    while (idx > k) {
      idx -= k + 1;
      ++k;
    }
    a = 1 + k;
    b = 1 + idx;
  }
}

// column a of a row (r, dr/du_0..8)
__device__ __forceinline__ float column(const D9& x, int a) {
  return a == 0 ? x.v : x.d[a - 1];
}

// J^T J of a warp's rows.  Every lane holds the NR rows of its edge (zeros
// for no edge).  Sum p of the kNAcc, columns a and b, is taken over the
// lane's rows in order, then over the lanes by a fixed xor-shuffle
// pattern; lane p mod 32 adds the warp's total to its acc0 (p < 32) or
// acc1.  All indices are constants once the loops are unrolled.
template <int NR>
__device__ __forceinline__ void warp_jtj(const D9 (&r)[NR], int lane,
                                         float& acc0, float& acc1) {
  auto sum = [&](int p, int a, int b) {
    float s = column(r[0], a) * column(r[0], b);
#pragma unroll
    for (int c = 1; c < NR; ++c) s += column(r[c], a) * column(r[c], b);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(kFullWarp, s, off);
    if (lane == (p & 31)) {
      if (p < 32)
        acc0 += s;
      else
        acc1 += s;
    }
  };
  sum(0, 0, 0);
#pragma unroll
  for (int k = 0; k < kN; ++k) sum(1 + k, 1 + k, 0);
#pragma unroll
  for (int k = 0; k < kN; ++k)
#pragma unroll
    for (int l = 0; l <= k; ++l) sum(h_index(k, l), 1 + k, 1 + l);
}

// lm_soa.lm_solve_step_plain after the sums, by the lanes of one warp:
// lane i < 9 holds row i of A = H + lam0 I (the other lanes repeat row 8);
// est_lam holds the estimate's 10 floats and lam
__device__ void solve_epilogue(const float* tot, const float* est_lam,
                               const Params& p, int o, int lane) {
  // lam0 = max(where(lam < 0, tau * max diag H, lam), 1e-12)
  float m = tot[h_index(0, 0)];
#pragma unroll
  for (int k = 1; k < kN; ++k) m = maxc(tot[h_index(k, k)], m);
  const float lam = est_lam[10];
  const float lam0 = maxc(lam < 0.f ? kTau * m : lam, 1e-12f);

  const int i = lane < kN ? lane : kN - 1;
  float a[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j)
    a[j] = tot[h_index(i > j ? i : j, i > j ? j : i)] +
           lam0 * (i == j ? 1.f : 0.f);
  const float b = tot[1 + i];

  // ops/linalg.chol_solve_small: L[j] is L[i][j] of this lane's row
  float L[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    float s = a[j];
#pragma unroll
    for (int k = 0; k < j; ++k)
      s = s - L[k] * __shfl_sync(kFullWarp, L[k], j);
    const float d = sqrtf(maxc(s, 1e-20f));
    const float djj = __shfl_sync(kFullWarp, d, j);
    L[j] = i == j ? d : s / djj;
  }
  float y[kN];
#pragma unroll
  for (int r = 0; r < kN; ++r) {
    float s = b;
#pragma unroll
    for (int k = 0; k < r; ++k) s = s - L[k] * y[k];
    y[r] = __shfl_sync(kFullWarp, s / L[r], r);
  }
  float x[kN];
#pragma unroll
  for (int r = kN - 1; r >= 0; --r) {
    float s = y[r];
#pragma unroll
    for (int k = r + 1; k < kN; ++k)
      s = s - __shfl_sync(kFullWarp, L[r], k) * x[k];
    x[r] = s / __shfl_sync(kFullWarp, L[r], r);
  }

  // du = -x behind the all-finite gate, then the vertex update
  bool ok = true;
#pragma unroll
  for (int k = 0; k < kN; ++k) ok = ok && isfinite(x[k]);
  float du[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) du[k] = ok ? -x[k] : 0.f;
  Est<float> e;
  exp_update(est_lam, du, e);
  if (lane == 0) {
    float* out = p.est_new + 10 * o;
#pragma unroll
    for (int k = 0; k < 3; ++k) out[k] = e.t[k];
#pragma unroll
    for (int k = 0; k < 4; ++k) out[3 + k] = e.q[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) out[7 + k] = e.s[k];
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      p.du[kN * o + k] = du[k];
      p.g[kN * o + k] = tot[1 + k];
    }
    p.lam0[o] = lam0;
  }
}

// lm_soa.lm_accept_step_plain after chi2 at the trial estimate, one thread
__device__ void accept_epilogue(float chi2_new, const Params& p, int o) {
  const float chi2 = p.chi2_io[o];
  const float lam0 = p.lam0_in[o];
  const float nu = p.nu_io[o];
  const float* du = p.du_in + kN * o;
  const float* g = p.g_in + kN * o;
  float denom = du[0] * (lam0 * du[0] - g[0]);
#pragma unroll
  for (int k = 1; k < kN; ++k) denom = denom + du[k] * (lam0 * du[k] - g[k]);
  const float rho =
      (chi2 - chi2_new) / (fabsf(denom) > 1e-20f ? denom : 1e-20f);
  const bool accept = chi2_new < chi2 && isfinite(chi2_new);
  const float t = 2.f * rho - 1.f;
  const float factor =
      minc(maxc(1.f - t * t * t, (float)(1.0 / 3.0)), (float)(2.0 / 3.0));
  p.lam_io[o] = accept ? lam0 * factor : lam0 * nu;
  p.nu_io[o] = accept ? 2.f : nu * 2.f;
  p.accept[o] = accept ? 1 : 0;
  if (accept) {
    p.chi2_io[o] = chi2_new;
#pragma unroll
    for (int k = 0; k < 10; ++k) p.est_io[10 * o + k] = p.est[10 * o + k];
  }
}

// grid (S, O), cluster (S, 1, 1): the S blocks of a cluster share object
// blockIdx.y; edge j of the object's M2 + M3 goes to thread j mod (S * T)
template <bool kStep>
__global__ void __launch_bounds__(kMaxThreads) ba_normal_eq_kernel(
    const Params p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nranks = (int)cluster.num_blocks();
  const int o = blockIdx.y;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  PHASE_CLOCK(0)

  extern __shared__ float stage[];      // a 3D edge's rows, kSlot3 a thread
  __shared__ Est<D9> sh_e;
  __shared__ D9 sh_R[3][3];
  __shared__ D9 sh_grav;
  __shared__ float sh_part[kMaxThreads / 32][kNAcc];
  __shared__ float sh_sum[kNAcc];       // this block's sums (read by rank 0)
  __shared__ float sh_tot[kNAcc];       // the object's sums (rank 0)
  __shared__ float sh_est_lam[11];      // est and lam for the epilogue

  const float fx = p.K[0], fy = p.K[4], cx = p.K[2], cy = p.K[5];
  if (tid < Lane<D9>::n)
    per_object<D9>(p.est + 10 * o, p.normal, p.wg[o], rank == 0, tid, sh_e,
                   sh_R, sh_grav);
  if (kStep && rank == 0 && warp == 1 && lane < 11)
    sh_est_lam[lane] = lane < 10 ? p.est[10 * o + lane] : p.lam[o];

  // lane l of each warp keeps the warp's sums l (acc0) and l + 32 (acc1)
  float acc0 = 0.f, acc1 = 0.f;
  __syncthreads();
  PHASE_CLOCK(1)                        // the per-object part is done

  const int M2 = p.M2, M3 = p.M3;
  const int E = M2 + M3;
  D9* rows3 = reinterpret_cast<D9*>(stage + tid * kSlot3);
  for (int j0 = rank * T; j0 < E; j0 += nranks * T) {
    // this round's edges j0 .. j0 + nslots - 1: first n2 2D, then 3D
    const int nslots = E - j0 < T ? E - j0 : T;
    const int left2 = M2 - j0;
    const int n2 = left2 < 0 ? 0 : (left2 < nslots ? left2 : nslots);
    D9 r[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) r[c] = Scalar<D9>::zero();
    bool staged3 = false;
    if (tid < n2) {
      const size_t i = (size_t)o * M2 + j0 + tid;
      const float w = p.w2d[i];
      if (w != 0.f) {
        residual_2d(sh_e, sh_R, p.pose2d + 7 * i, p.bbox2d + 4 * i, fx, fy,
                    cx, cy, r);
        weigh<4>(r, w, p.huber_delta, p.huber_delta2);
        if (!tangents_finite<4>(r)) {
#pragma unroll
          for (int c = 0; c < 4; ++c) r[c] = Scalar<D9>::zero();
        }
      }
    } else if (tid < nslots) {
      const size_t i = (size_t)o * M3 + (j0 + tid - M2);
      const float w = p.w3d[i];
      if (w != 0.f) {
        residual_3d(sh_e, p.invp3 + 28 * i, p.sc3 + 12 * i, rows3);
        weigh<9>(rows3, w, p.huber_delta, p.huber_delta2);
        staged3 = tangents_finite<9>(rows3);
      }
    }
    PHASE_CLOCK(2)                      // this thread's edge chain is done

    // the warp's J^T J: 4 rows a lane where no lane has a 3D edge, else 9
    // (a 2D edge's 4 rows and 5 of zeros)
    if (!__any_sync(kFullWarp, staged3)) {
      if (__any_sync(kFullWarp, tid < n2)) warp_jtj(r, lane, acc0, acc1);
    } else {
      D9 r9[9];
#pragma unroll
      for (int c = 0; c < 9; ++c)
        r9[c] = staged3 ? rows3[c] : (c < 4 ? r[c] : Scalar<D9>::zero());
      warp_jtj(r9, lane, acc0, acc1);
    }
  }

  PHASE_CLOCK(3)                        // the warp's J^T J is done
  // warps in order, then the cluster's blocks in rank order
  sh_part[warp][lane] = acc0;
  if (lane + 32 < kNAcc) sh_part[warp][lane + 32] = acc1;
  __syncthreads();
  if (tid < kNAcc) {
    float s = sh_part[0][tid];
    for (int k = 1; k < T / 32; ++k) s += sh_part[k][tid];
    sh_sum[tid] = s;
  }
  cluster.sync();
  PHASE_CLOCK(4)                        // every block's sums are there
  if (rank == 0 && tid < kNAcc) {
    float s = sh_sum[tid];
    for (int r = 1; r < nranks; ++r)
      s += cluster.map_shared_rank(sh_sum, r)[tid];
    int ca, cb;
    columns_of(tid, ca, cb);
    const float* grav = reinterpret_cast<const float*>(&sh_grav);
    if (tangents_finite<1>(&sh_grav)) s += grav[ca] * grav[cb];
    sh_tot[tid] = s;
    if (tid == 0) {
      if (p.chi2) p.chi2[o] = s;
    } else if (tid <= kN) {
      if (!kStep && p.g) p.g[kN * o + tid - 1] = s;
    } else if (p.H) {
      // columns 1 + k, 1 + l  ->  H[k][l] and H[l][k]
      p.H[kN * kN * o + kN * (ca - 1) + (cb - 1)] = s;
      p.H[kN * kN * o + kN * (cb - 1) + (ca - 1)] = s;
    }
  }
  // no block leaves while rank 0 reads its shared memory
  cluster.sync();
  PHASE_CLOCK(5)                        // the object's sums are written
  if (kStep && rank == 0 && warp == 0)
    solve_epilogue(sh_tot, sh_est_lam, p, o, lane);
  PHASE_CLOCK(6)                        // the solve epilogue is done
}

template <bool kStep>
__global__ void __launch_bounds__(kMaxThreads) ba_chi2_kernel(
    const Params p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nranks = (int)cluster.num_blocks();
  const int o = blockIdx.y;
  const int tid = threadIdx.x;
  const int T = blockDim.x;

  __shared__ Est<float> sh_e;
  __shared__ float sh_R[3][3];
  __shared__ float sh_grav;
  __shared__ float sh_warp[kMaxThreads / 32];
  __shared__ float sh_sum;              // this block's sum (read by rank 0)

  const float fx = p.K[0], fy = p.K[4], cx = p.K[2], cy = p.K[5];
  if (tid < Lane<float>::n)
    per_object<float>(p.est + 10 * o, p.normal, p.wg[o], rank == 0, tid,
                      sh_e, sh_R, sh_grav);
  __syncthreads();

  const int M2 = p.M2, M3 = p.M3;
  const int E = M2 + M3;
  float acc = 0.f;
  for (int j = rank * T + tid; j < E; j += nranks * T) {
    if (j < M2) {
      const size_t i = (size_t)o * M2 + j;
      const float w = p.w2d[i];
      if (w != 0.f) {
        float r[4];
        residual_2d(sh_e, sh_R, p.pose2d + 7 * i, p.bbox2d + 4 * i, fx, fy,
                    cx, cy, r);
        weigh<4>(r, w, p.huber_delta, p.huber_delta2);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc += r[c] * r[c];
      }
    } else {
      const size_t i = (size_t)o * M3 + (j - M2);
      const float w = p.w3d[i];
      if (w != 0.f) {
        float r[9];
        residual_3d(sh_e, p.invp3 + 28 * i, p.sc3 + 12 * i, r);
        weigh<9>(r, w, p.huber_delta, p.huber_delta2);
#pragma unroll
        for (int c = 0; c < 9; ++c) acc += r[c] * r[c];
      }
    }
  }

  // lanes by a fixed xor pattern, warps in order, blocks in rank order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFullWarp, acc, off);
  if ((tid & 31) == 0) sh_warp[tid >> 5] = acc;
  __syncthreads();
  if (tid == 0) {
    float s = sh_warp[0];
    for (int k = 1; k < T / 32; ++k) s += sh_warp[k];
    sh_sum = s;
  }
  cluster.sync();
  float total = 0.f;
  if (rank == 0 && tid == 0) {
    total = sh_sum;
    for (int r = 1; r < nranks; ++r)
      total += *cluster.map_shared_rank(&sh_sum, r);
    total += sh_grav * sh_grav;
  }
  // no block leaves while rank 0 reads its shared memory
  cluster.sync();
  if (rank == 0 && tid == 0) {
    if (kStep)
      accept_epilogue(total, p, o);
    else
      p.chi2[o] = total;
  }
}

template <class Kernel>
int launch(Kernel kernel, const Params& p, int O, int S, int T,
           size_t shared_bytes, void* stream) {
  if (O < 1 || O > 65535 || S < 1 || S > 8 || T < 32 || T > kMaxThreads ||
      T % 32 != 0)
    return (int)cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, O, 1);
  cfg.blockDim = dim3(T, 1, 1);
  cfg.dynamicSmemBytes = shared_bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, p);
  if (rc == cudaSuccess) rc = cudaGetLastError();
  return (int)rc;
}

Params problem(const float* est, const float* pose2d, const float* bbox2d,
               const float* w2d, const float* invp3, const float* sc3,
               const float* w3d, const float* wg, const float* normal,
               const float* K, float huber_delta, float huber_delta2, int M2,
               int M3) {
  Params p = {};
  p.est = est;
  p.pose2d = pose2d;
  p.bbox2d = bbox2d;
  p.w2d = w2d;
  p.invp3 = invp3;
  p.sc3 = sc3;
  p.w3d = w3d;
  p.wg = wg;
  p.normal = normal;
  p.K = K;
  p.huber_delta = huber_delta;
  p.huber_delta2 = huber_delta2;
  p.M2 = M2;
  p.M3 = M3;
#ifdef OSLAM_PHASE_CLOCKS
  p.clocks = g_phase_clocks;
#endif
  return p;
}

size_t stage_bytes(int T) { return (size_t)T * kSlot3 * sizeof(float); }

}  // namespace

// S blocks of T threads per object (backend/ba_kernels.launch_shape); every
// function returns the CUDA error code of its launch (0 = launched).
extern "C" {

int oslam_ba_normal_eq(const float* est, const float* pose2d,
                       const float* bbox2d, const float* w2d,
                       const float* invp3, const float* sc3, const float* w3d,
                       const float* wg, const float* normal, const float* K,
                       float huber_delta, float huber_delta2, int O, int M2,
                       int M3, int S, int T, float* H, float* g, float* chi2,
                       void* stream) {
  Params p = problem(est, pose2d, bbox2d, w2d, invp3, sc3, w3d, wg, normal, K,
                     huber_delta, huber_delta2, M2, M3);
  p.H = H;
  p.g = g;
  p.chi2 = chi2;
  return launch(ba_normal_eq_kernel<false>, p, O, S, T, stage_bytes(T),
                stream);
}

int oslam_ba_chi2(const float* est, const float* pose2d, const float* bbox2d,
                  const float* w2d, const float* invp3, const float* sc3,
                  const float* w3d, const float* wg, const float* normal,
                  const float* K, float huber_delta, float huber_delta2, int O,
                  int M2, int M3, int S, int T, float* chi2, void* stream) {
  Params p = problem(est, pose2d, bbox2d, w2d, invp3, sc3, w3d, wg, normal, K,
                     huber_delta, huber_delta2, M2, M3);
  p.chi2 = chi2;
  return launch(ba_chi2_kernel<false>, p, O, S, T, 0, stream);
}

// ba_normal_eq at est, then the solve epilogue; H may be null
int oslam_lm_solve_step(const float* est, const float* pose2d,
                        const float* bbox2d, const float* w2d,
                        const float* invp3, const float* sc3,
                        const float* w3d, const float* wg,
                        const float* normal, const float* K,
                        float huber_delta, float huber_delta2, int O, int M2,
                        int M3, int S, int T, const float* lam,
                        float* est_new, float* du, float* g, float* lam0,
                        float* H, void* stream) {
  Params p = problem(est, pose2d, bbox2d, w2d, invp3, sc3, w3d, wg, normal, K,
                     huber_delta, huber_delta2, M2, M3);
  p.lam = lam;
  p.est_new = est_new;
  p.du = du;
  p.g = g;
  p.lam0 = lam0;
  p.H = H;
  return launch(ba_normal_eq_kernel<true>, p, O, S, T, stage_bytes(T),
                stream);
}

// ba_chi2 at est_new, then the accept epilogue: est, chi2, lam and nu are
// updated in place
int oslam_lm_accept_step(const float* est_new, const float* pose2d,
                         const float* bbox2d, const float* w2d,
                         const float* invp3, const float* sc3,
                         const float* w3d, const float* wg,
                         const float* normal, const float* K,
                         float huber_delta, float huber_delta2, int O, int M2,
                         int M3, int S, int T, const float* du,
                         const float* g, const float* lam0, float* est,
                         float* chi2, float* lam, float* nu,
                         unsigned char* accept, void* stream) {
  Params p = problem(est_new, pose2d, bbox2d, w2d, invp3, sc3, w3d, wg,
                     normal, K, huber_delta, huber_delta2, M2, M3);
  p.du_in = du;
  p.g_in = g;
  p.lam0_in = lam0;
  p.est_io = est;
  p.chi2_io = chi2;
  p.lam_io = lam;
  p.nu_io = nu;
  p.accept = accept;
  return launch(ba_chi2_kernel<true>, p, O, S, T, 0, stream);
}

#ifdef OSLAM_PHASE_CLOCKS
void oslam_set_phase_clocks(long long* clocks) { g_phase_clocks = clocks; }
#endif

const char* oslam_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
