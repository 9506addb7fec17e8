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
//   ba_chi2:      sum r^2 [O]
// The weights arrive with every gate folded in (zero = inactive edge).
//
// Design.  The residual chain is written once, templated on the scalar
// type S.  ba_chi2 instantiates it with float; ba_normal_eq with Dual<9>,
// a forward-mode dual number carrying the value and its derivative along
// the 9 tangent directions, seeded at u = 0 -- what jax.linearize does in
// the JAX package.  Every branch (small-angle Taylor forms, the argmin
// over the 4 rotations, the NaN/inf gate, the Huber weight) selects on
// the primal value, as jnp.where does, and only the selected branch is
// evaluated; each derivative rule copies the JAX rule it replaces,
// including the JAX tie rule of max/min, so NaN/inf tangents appear where
// they appear in the JAX package (the LM's du_ok gate depends on them).
//
// One thread block per object.  Block-wide quantities that depend only on
// the estimate (the updated pose and scales and its rotation matrix) are
// computed once by thread 0 into shared memory.  Threads stride over the
// M2 2D edges and the M3 3D edges, keeping the 45 + 9 + 1 partial sums in
// registers; a fixed-order tree reduction in shared memory follows, so the
// result is deterministic (no atomics).  The 3D-measurement precompute
// (invp3, sc3) is estimate-independent and done once per LM call by the
// caller.
//
// What bounds it: arithmetic and registers, not memory.  An edge reads
// 48 bytes (2D) or 124 bytes (3D) and costs a few hundred dual operations
// (10 flops each); a Dual<9> chain keeps far more live values than the
// 255-register limit, so the compiler spills to local memory (L1).  At the
// main path's O = 24 objects only 24 of the 132 SMs get a block; splitting
// the edge axis over several blocks per object is the first thing to do
// for speed.  Built without --use_fast_math and with -fmad=false: the
// constants, the IEEE sqrt/div/sin/cos/atan2/acos and the per-operation
// rounding of the JAX package and of the plain PyTorch version are kept.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kN = 9;                     // tangent directions
constexpr int kNH = kN * (kN + 1) / 2;    // unique entries of H
constexpr int kNAcc = kNH + kN + 1;       // H, g, chi2
constexpr float kEps = 1e-8f;             // lm_soa._EPS
constexpr float kEps2 = 1e-16f;           // _EPS * _EPS

struct D9 {
  float v;
  float d[kN];
};

// ---------------------------------------------------------------------------
// Scalar interface shared by float and D9
// ---------------------------------------------------------------------------

__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ float val(const D9& x) { return x.v; }

template <class S> __device__ __forceinline__ S zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ D9 zero<D9>() {
  D9 r;
  r.v = 0.f;
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = 0.f;
  return r;
}

// u_i at u = 0: value 0, unit derivative along direction i
template <class S> __device__ __forceinline__ S seed(int i);
template <> __device__ __forceinline__ float seed<float>(int) { return 0.f; }
template <> __device__ __forceinline__ D9 seed<D9>(int i) {
  D9 r = zero<D9>();
  r.d[i] = 1.f;
  return r;
}

__device__ __forceinline__ D9 operator+(const D9& a, const D9& b) {
  D9 r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}
__device__ __forceinline__ D9 operator+(const D9& a, float b) {
  D9 r = a;
  r.v = a.v + b;
  return r;
}
__device__ __forceinline__ D9 operator+(float a, const D9& b) {
  D9 r = b;
  r.v = a + b.v;
  return r;
}
__device__ __forceinline__ D9 operator-(const D9& a) {
  D9 r;
  r.v = -a.v;
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = -a.d[i];
  return r;
}
__device__ __forceinline__ D9 operator-(const D9& a, const D9& b) {
  D9 r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}
__device__ __forceinline__ D9 operator-(const D9& a, float b) {
  D9 r = a;
  r.v = a.v - b;
  return r;
}
__device__ __forceinline__ D9 operator-(float a, const D9& b) {
  D9 r;
  r.v = a - b.v;
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = -b.d[i];
  return r;
}
// mul: g_x * y + x * g_y
__device__ __forceinline__ D9 operator*(const D9& a, const D9& b) {
  D9 r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}
__device__ __forceinline__ D9 operator*(const D9& a, float b) {
  D9 r;
  r.v = a.v * b;
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = a.d[i] * b;
  return r;
}
__device__ __forceinline__ D9 operator*(float a, const D9& b) {
  D9 r;
  r.v = a * b.v;
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = a * b.d[i];
  return r;
}
// div: g_x / y + (-g_y * x) * y^-2
__device__ __forceinline__ D9 operator/(const D9& a, const D9& b) {
  D9 r;
  r.v = a.v / b.v;
  const float ib2 = 1.f / (b.v * b.v);
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = a.d[i] / b.v + (-b.d[i] * a.v) * ib2;
  return r;
}
__device__ __forceinline__ D9 operator/(const D9& a, float b) {
  D9 r;
  r.v = a.v / b;
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = a.d[i] / b;
  return r;
}
__device__ __forceinline__ D9 operator/(float a, const D9& b) {
  D9 r;
  r.v = a / b.v;
  const float ib2 = 1.f / (b.v * b.v);
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = (-b.d[i] * a) * ib2;
  return r;
}

__device__ __forceinline__ D9 scaled(const D9& a, float v, float k) {
  D9 r;
  r.v = v;
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = a.d[i] * k;
  return r;
}

// sqrt: g * (0.5 / ans)
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ D9 sqrt_(const D9& a) {
  const float s = sqrtf(a.v);
  return scaled(a, s, 0.5f / s);
}
// sin: g * cos(x);  cos: -(g * sin(x))
__device__ __forceinline__ float sin_(float x) { return sinf(x); }
__device__ __forceinline__ D9 sin_(const D9& a) {
  return scaled(a, sinf(a.v), cosf(a.v));
}
__device__ __forceinline__ float cos_(float x) { return cosf(x); }
__device__ __forceinline__ D9 cos_(const D9& a) {
  D9 r;
  r.v = cosf(a.v);
  const float s = sinf(a.v);
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = -(a.d[i] * s);
  return r;
}
// acos: g * -rsqrt(1 - x^2)
__device__ __forceinline__ float acos_(float x) { return acosf(x); }
__device__ __forceinline__ D9 acos_(const D9& a) {
  return scaled(a, acosf(a.v), -(1.f / sqrtf(1.f - a.v * a.v)));
}
// atan2(y, x): g_y * (x / (y^2 + x^2)) + g_x * (-y / (y^2 + x^2))
__device__ __forceinline__ float atan2_(float y, float x) {
  return atan2f(y, x);
}
__device__ __forceinline__ D9 atan2_(const D9& y, const D9& x) {
  D9 r;
  r.v = atan2f(y.v, x.v);
  const float den = y.v * y.v + x.v * x.v;
  const float ky = x.v / den;
  const float kx = -y.v / den;
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = y.d[i] * ky + x.d[i] * kx;
  return r;
}
// x^2 (integer_pow): g * (2 x)
__device__ __forceinline__ float square_(float x) { return x * x; }
__device__ __forceinline__ D9 square_(const D9& a) {
  return scaled(a, a.v * a.v, 2.f * a.v);
}
// max/min against a constant, NaN-propagating like XLA; the tangent
// follows JAX's balanced rule: 1 where x is the result alone, 0.5 on a tie
__device__ __forceinline__ float maxc(float x, float c) {
  return (isnan(x) || x > c) ? x : c;
}
__device__ __forceinline__ float minc(float x, float c) {
  return (isnan(x) || x < c) ? x : c;
}
__device__ __forceinline__ float balanced(float x, float ans, float c) {
  return (x == ans ? 1.f : 0.f) / (c == ans ? 2.f : 1.f);
}
__device__ __forceinline__ D9 maxc(const D9& a, float c) {
  const float ans = maxc(a.v, c);
  return scaled(a, ans, balanced(a.v, ans, c));
}
__device__ __forceinline__ D9 minc(const D9& a, float c) {
  const float ans = minc(a.v, c);
  return scaled(a, ans, balanced(a.v, ans, c));
}

// ---------------------------------------------------------------------------
// Quaternion / SE3 helpers (lm_soa._qmul, _qrotate, _qtomat, ...)
// ---------------------------------------------------------------------------

template <class A, class B, class R>
__device__ __forceinline__ void qmul(const A* q1, const B* q2, R* o) {
  const A &x1 = q1[0], &y1 = q1[1], &z1 = q1[2], &w1 = q1[3];
  const B &x2 = q2[0], &y2 = q2[1], &z2 = q2[2], &w2 = q2[3];
  o[0] = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2;
  o[1] = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2;
  o[2] = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2;
  o[3] = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2;
}

template <class S>
__device__ __forceinline__ void qnormalize(S* q) {
  S n = sqrt_(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  n = maxc(n, kEps);
  q[0] = q[0] / n;
  q[1] = q[1] / n;
  q[2] = q[2] / n;
  q[3] = q[3] / n;
}

// R(q) @ v with t = 2 (qv x v), v + w t + qv x t
template <class A, class B, class R>
__device__ __forceinline__ void qrotate(const A* q, const B* v, R* o) {
  R t0 = 2.f * (q[1] * v[2] - q[2] * v[1]);
  R t1 = 2.f * (q[2] * v[0] - q[0] * v[2]);
  R t2 = 2.f * (q[0] * v[1] - q[1] * v[0]);
  R c0 = q[1] * t2 - q[2] * t1;
  R c1 = q[2] * t0 - q[0] * t2;
  R c2 = q[0] * t1 - q[1] * t0;
  o[0] = v[0] + q[3] * t0 + c0;
  o[1] = v[1] + q[3] * t1 + c1;
  o[2] = v[2] + q[3] * t2 + c2;
}

template <class S>
__device__ __forceinline__ void qtomat(const S* q, S r[3][3]) {
  const S &x = q[0], &y = q[1], &z = q[2], &w = q[3];
  S xx = x * x, yy = y * y, zz = z * z;
  S xy = x * y, xz = x * z, yz = y * z;
  S wx = w * x, wy = w * y, wz = w * z;
  r[0][0] = 1.f - 2.f * (yy + zz);
  r[0][1] = 2.f * (xy - wz);
  r[0][2] = 2.f * (xz + wy);
  r[1][0] = 2.f * (xy + wz);
  r[1][1] = 1.f - 2.f * (xx + zz);
  r[1][2] = 2.f * (yz - wx);
  r[2][0] = 2.f * (xz - wy);
  r[2][1] = 2.f * (yz + wx);
  r[2][2] = 1.f - 2.f * (xx + yy);
}

// the estimate after the vertex update: pose, scales
template <class S>
struct Est {
  S t[3];
  S q[4];
  S s[3];
};

// lm_soa._exp_update(est, u) at u = 0, with u seeded for the Jacobian
template <class S>
__device__ void exp_update(const float* est, Est<S>& out) {
  S u[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) u[i] = seed<S>(i);
  const S &ox = u[0], &oy = u[1], &oz = u[2];
  // se3_exp: quaternion of omega (lm_soa._so3_exp_quat)
  S theta2 = ox * ox + oy * oy + oz * oz;
  S theta = sqrt_(theta2 + kEps2);
  S half = 0.5f * theta;
  S k = val(theta2) > 1e-10f ? sin_(half) / theta : 0.5f - theta2 / 48.f;
  S dq[4] = {ox * k, oy * k, oz * k, cos_(half)};
  // V = I + a Om + b Om^2
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
  S dt[3] = {v00 * ux + v01 * uy + v02 * uz,
             v10 * ux + v11 * uy + v12 * uz,
             v20 * ux + v21 * uy + v22 * uz};
  // pose * d
  const float et[3] = {est[0], est[1], est[2]};
  const float eq[4] = {est[3], est[4], est[5], est[6]};
  S r[3];
  qrotate(eq, dt, r);
  out.t[0] = et[0] + r[0];
  out.t[1] = et[1] + r[1];
  out.t[2] = et[2] + r[2];
  qmul(eq, dq, out.q);
  qnormalize(out.q);
  out.s[0] = est[7] + u[6];
  out.s[1] = est[8] + u[7];
  out.s[2] = est[9] + u[8];
}

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
    r[k] = bb[k] >= 5.f ? proj[k] - bb[k] : zero<S>();
}

// lm_soa._so3_log
template <class S>
__device__ __forceinline__ void so3_log(const S* q, S* o) {
  const float sgn = val(q[3]) < 0.f ? -1.f : 1.f;
  S x = q[0] * sgn, y = q[1] * sgn, z = q[2] * sgn, w = q[3] * sgn;
  S n = sqrt_(x * x + y * y + z * z);
  S k = val(n) > 1e-7f ? (2.f * atan2_(n, w)) / maxc(n, kEps)
                       : 2.f / maxc(w, kEps);
  o[0] = x * k;
  o[1] = y * k;
  o[2] = z * k;
}

// lm_soa._vinv_apply: (V^-1 of the SE3 log) @ t
template <class S>
__device__ __forceinline__ void vinv_apply(const S* om, const S* t, S* o) {
  const S &ox = om[0], &oy = om[1], &oz = om[2];
  S theta2 = ox * ox + oy * oy + oz * oz;
  S c;
  if (val(theta2) > 1e-10f) {
    S theta = sqrt_(theta2 + kEps2);
    S half = 0.5f * theta;
    S cot_term = half * cos_(half) / maxc(sin_(half), kEps);
    c = (1.f - cot_term) / maxc(theta2, kEps);
  } else {
    c = (float)(1.0 / 12.0) + theta2 / 720.f;
  }
  S o00 = -(oz * oz + oy * oy);
  S o01 = oy * ox;
  S o02 = oz * ox;
  S o11 = -(oz * oz + ox * ox);
  S o12 = oz * oy;
  S o22 = -(oy * oy + ox * ox);
  S v00 = 1.f + c * o00, v01 = 0.5f * oz + c * o01, v02 = -0.5f * oy + c * o02;
  S v10 = -0.5f * oz + c * o01, v11 = 1.f + c * o11, v12 = 0.5f * ox + c * o12;
  S v20 = 0.5f * oy + c * o02, v21 = -0.5f * ox + c * o12, v22 = 1.f + c * o22;
  o[0] = v00 * t[0] + v01 * t[1] + v02 * t[2];
  o[1] = v10 * t[0] + v11 * t[1] + v12 * t[2];
  o[2] = v20 * t[0] + v21 * t[1] + v22 * t[2];
}

// lm_soa._res3d_soa for one edge: log error to the measured ellipsoid,
// least over the 4 yaw candidates (argmin on values; first NaN, else first
// minimum, like jnp.argmin)
template <class S>
__device__ void residual_3d(const Est<S>& e, const float* invp,
                            const float* sc, S out[9]) {
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

// lm_soa._gravity_residual_soa from the rotation matrix of the estimate
template <class S>
__device__ S residual_gravity(const S (&R)[3][3], const float* normal) {
  const S &zx = R[0][2], &zy = R[1][2], &zz = R[2][2];
  const float nx = normal[0], ny = normal[1], nz = normal[2];
  S dot = zx * nx + zy * ny + zz * nz;
  S zn = sqrt_(zx * zx + zy * zy + zz * zz);
  const float nn = sqrtf(nx * nx + ny * ny + nz * nz);
  S cosang = dot / (zn * maxc(nn, 1e-8f));
  cosang = minc(maxc(cosang, (float)(-1.0 + 1e-4)), (float)(1.0 - 1e-4));
  return acos_(cosang);
}

// ---------------------------------------------------------------------------
// Weighting and accumulation
// ---------------------------------------------------------------------------

__device__ __forceinline__ D9 scale_by(const D9& a, float w) { return a * w; }
__device__ __forceinline__ float scale_by(float a, float w) { return a * w; }

// lm_soa._huber_w on values (the weight carries no tangent)
template <class S, int N>
__device__ __forceinline__ void huber(S (&r)[N], float delta, float delta2) {
  float s = val(r[0]) * val(r[0]);
#pragma unroll
  for (int c = 1; c < N; ++c) s = s + val(r[c]) * val(r[c]);
  const float h = s > delta2 ? sqrtf(delta / maxc(sqrtf(s), 1e-12f)) : 1.f;
#pragma unroll
  for (int c = 0; c < N; ++c) r[c] = scale_by(r[c], h);
}

// lm_soa._finite0: a non-finite value drops value and tangent
template <class S>
__device__ __forceinline__ S finite0(const S& x) {
  return isfinite(val(x)) ? x : zero<S>();
}

__device__ __forceinline__ void accumulate(float* acc, float r) {
  acc[0] += r * r;
}
__device__ __forceinline__ void accumulate(float* acc, const D9& r) {
  acc[0] += r.v * r.v;
#pragma unroll
  for (int k = 0; k < kN; ++k) acc[1 + k] += r.d[k] * r.v;
  int idx = 1 + kN;
#pragma unroll
  for (int k = 0; k < kN; ++k)
#pragma unroll
    for (int l = 0; l <= k; ++l) acc[idx++] += r.d[k] * r.d[l];
}

template <class S> struct NAcc;
template <> struct NAcc<float> { static constexpr int n = 1; };
template <> struct NAcc<D9> { static constexpr int n = kNAcc; };

template <class S>
__global__ void __launch_bounds__(kThreads) ba_edges_kernel(
    const float* __restrict__ est, const float* __restrict__ pose2d,
    const float* __restrict__ bbox2d, const float* __restrict__ w2d,
    const float* __restrict__ invp3, const float* __restrict__ sc3,
    const float* __restrict__ w3d, const float* __restrict__ wg,
    const float* __restrict__ normal, const float* __restrict__ K,
    float huber_delta, float huber_delta2, int M2, int M3,
    float* __restrict__ H, float* __restrict__ g, float* __restrict__ chi2) {
  constexpr int NA = NAcc<S>::n;
  __shared__ Est<S> sh_e;
  __shared__ S sh_R[3][3];
  __shared__ float sh_red[NA][kThreads];

  const int o = blockIdx.x;
  const int tid = threadIdx.x;
  const float fx = K[0], fy = K[4], cx = K[2], cy = K[5];

  if (tid == 0) {
    Est<S> e;
    exp_update(est + 10 * o, e);
    S R[3][3];
    qtomat(e.q, R);
    sh_e = e;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) sh_R[i][j] = R[i][j];
  }
  __syncthreads();

  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;

  for (int m = tid; m < M2; m += kThreads) {
    const size_t i = (size_t)o * M2 + m;
    S r[4];
    residual_2d(sh_e, sh_R, pose2d + 7 * i, bbox2d + 4 * i, fx, fy, cx, cy,
                r);
    const float w = w2d[i];
#pragma unroll
    for (int c = 0; c < 4; ++c) r[c] = scale_by(r[c], w);
    if (huber_delta > 0.f) huber(r, huber_delta, huber_delta2);
#pragma unroll
    for (int c = 0; c < 4; ++c) accumulate(acc, finite0(r[c]));
  }

  for (int m = tid; m < M3; m += kThreads) {
    const size_t i = (size_t)o * M3 + m;
    S r[9];
    residual_3d(sh_e, invp3 + 28 * i, sc3 + 12 * i, r);
    const float w = w3d[i];
#pragma unroll
    for (int c = 0; c < 9; ++c) r[c] = scale_by(r[c], w);
    if (huber_delta > 0.f) huber(r, huber_delta, huber_delta2);
#pragma unroll
    for (int c = 0; c < 9; ++c) accumulate(acc, finite0(r[c]));
  }

  if (tid == 0)
    accumulate(acc, finite0(scale_by(residual_gravity(sh_R, normal), wg[o])));

  // fixed-order tree reduction over the block
#pragma unroll
  for (int i = 0; i < NA; ++i) sh_red[i][tid] = acc[i];
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
      for (int i = 0; i < NA; ++i) sh_red[i][tid] += sh_red[i][tid + stride];
    }
    __syncthreads();
  }
  if (tid < NA) {
    const float s = sh_red[tid][0];
    if (tid == 0) {
      chi2[o] = s;
    } else if (tid <= kN) {
      g[kN * o + tid - 1] = s;
    } else {
      // acc index 1 + kN + k(k+1)/2 + l  ->  H[k][l] and H[l][k]
      int idx = tid - 1 - kN;
      int k = 0;
      while (idx > k) {
        idx -= k + 1;
        ++k;
      }
      H[kN * kN * o + kN * k + idx] = s;
      H[kN * kN * o + kN * idx + k] = s;
    }
  }
}

}  // namespace

extern "C" {

int oslam_ba_normal_eq(const float* est, const float* pose2d,
                       const float* bbox2d, const float* w2d,
                       const float* invp3, const float* sc3, const float* w3d,
                       const float* wg, const float* normal, const float* K,
                       float huber_delta, float huber_delta2, int O, int M2,
                       int M3, float* H, float* g, float* chi2,
                       void* stream) {
  ba_edges_kernel<D9><<<O, kThreads, 0, (cudaStream_t)stream>>>(
      est, pose2d, bbox2d, w2d, invp3, sc3, w3d, wg, normal, K, huber_delta,
      huber_delta2, M2, M3, H, g, chi2);
  return (int)cudaGetLastError();
}

int oslam_ba_chi2(const float* est, const float* pose2d, const float* bbox2d,
                  const float* w2d, const float* invp3, const float* sc3,
                  const float* w3d, const float* wg, const float* normal,
                  const float* K, float huber_delta, float huber_delta2, int O,
                  int M2, int M3, float* chi2, void* stream) {
  ba_edges_kernel<float><<<O, kThreads, 0, (cudaStream_t)stream>>>(
      est, pose2d, bbox2d, w2d, invp3, sc3, w3d, wg, normal, K, huber_delta,
      huber_delta2, M2, M3, nullptr, nullptr, chi2);
  return (int)cudaGetLastError();
}

const char* oslam_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
