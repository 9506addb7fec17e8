// Forward-mode dual numbers and the SE(3) / quaternion helpers shared by
// the hand kernels of the object graph (ba_edges.cu: the mapping-mode BA
// edges; slam_edges.cu: SLAM mode's edges with the pose free).
//
// A Dual<N> carries a value and its derivative along N tangent directions;
// every helper is templated on the scalar type S (float or Dual<N>), every
// branch selects on the primal value (as jnp.where does) and each
// derivative rule copies the JAX rule it replaces, so NaN/inf tangents
// appear where they appear in the JAX package.  The helpers follow
// backend/lm_soa.py's order of operations (_qmul, _qrotate, _qtomat,
// _exp_update, _so3_log, _vinv_apply, _gravity_residual_soa, _finite0).
#pragma once

#include <math.h>

namespace {

constexpr float kEps = 1e-8f;             // lm_soa._EPS
constexpr float kEps2 = 1e-16f;           // _EPS * _EPS


template <int N>
struct Dual {
  float v;
  float d[N];
};

// ---------------------------------------------------------------------------
// Scalar interface shared by float and Dual<N>
// ---------------------------------------------------------------------------

__device__ __forceinline__ float val(float x) { return x; }
template <int N>
__device__ __forceinline__ float val(const Dual<N>& x) { return x.v; }

// zero(), and u_i at u = 0: value 0, unit derivative along direction i
// (a Dual<N> carries the directions dir0 .. dir0 + N - 1)
template <class S> struct Scalar;
template <> struct Scalar<float> {
  static __device__ __forceinline__ float zero() { return 0.f; }
  static __device__ __forceinline__ float seed(int, int) { return 0.f; }
};
template <int N> struct Scalar<Dual<N>> {
  static __device__ __forceinline__ Dual<N> zero() {
    Dual<N> r;
    r.v = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) r.d[i] = 0.f;
    return r;
  }
  static __device__ __forceinline__ Dual<N> seed(int i, int dir0) {
    Dual<N> r;
    r.v = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) r.d[j] = (i == dir0 + j) ? 1.f : 0.f;
    return r;
  }
};

template <int N>
__device__ __forceinline__ Dual<N> operator+(const Dual<N>& a,
                                             const Dual<N>& b) {
  Dual<N> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator+(const Dual<N>& a, float b) {
  Dual<N> r = a;
  r.v = a.v + b;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator+(float a, const Dual<N>& b) {
  Dual<N> r = b;
  r.v = a + b.v;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator-(const Dual<N>& a) {
  Dual<N> r;
  r.v = -a.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = -a.d[i];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator-(const Dual<N>& a,
                                             const Dual<N>& b) {
  Dual<N> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator-(const Dual<N>& a, float b) {
  Dual<N> r = a;
  r.v = a.v - b;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator-(float a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a - b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = -b.d[i];
  return r;
}
// mul: g_x * y + x * g_y
template <int N>
__device__ __forceinline__ Dual<N> operator*(const Dual<N>& a,
                                             const Dual<N>& b) {
  Dual<N> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator*(const Dual<N>& a, float b) {
  Dual<N> r;
  r.v = a.v * b;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * b;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator*(float a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a * b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a * b.d[i];
  return r;
}
// div: g_x / y + (-g_y * x) * y^-2.  The N quotients g_x / y share one
// IEEE reciprocal (g_x * (1 / y): one rounding more, the same inf / NaN
// pattern for any normal y); the value is a true division.
template <int N>
__device__ __forceinline__ Dual<N> operator/(const Dual<N>& a,
                                             const Dual<N>& b) {
  Dual<N> r;
  r.v = a.v / b.v;
  const float ib = 1.f / b.v;
  const float ib2 = 1.f / (b.v * b.v);
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * ib + (-b.d[i] * a.v) * ib2;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator/(const Dual<N>& a, float b) {
  Dual<N> r;
  r.v = a.v / b;
  const float ib = 1.f / b;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * ib;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator/(float a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a / b.v;
  const float ib2 = 1.f / (b.v * b.v);
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = (-b.d[i] * a) * ib2;
  return r;
}

template <int N>
__device__ __forceinline__ Dual<N> scaled(const Dual<N>& a, float v,
                                          float k) {
  Dual<N> r;
  r.v = v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * k;
  return r;
}

// sqrt: g * (0.5 / ans)
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
template <int N>
__device__ __forceinline__ Dual<N> sqrt_(const Dual<N>& a) {
  const float s = sqrtf(a.v);
  return scaled(a, s, 0.5f / s);
}
// sin: g * cos(x);  cos: -(g * sin(x))
__device__ __forceinline__ float sin_(float x) { return sinf(x); }
template <int N>
__device__ __forceinline__ Dual<N> sin_(const Dual<N>& a) {
  return scaled(a, sinf(a.v), cosf(a.v));
}
__device__ __forceinline__ float cos_(float x) { return cosf(x); }
template <int N>
__device__ __forceinline__ Dual<N> cos_(const Dual<N>& a) {
  Dual<N> r;
  r.v = cosf(a.v);
  const float s = sinf(a.v);
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = -(a.d[i] * s);
  return r;
}
// acos: g * -rsqrt(1 - x^2)
__device__ __forceinline__ float acos_(float x) { return acosf(x); }
template <int N>
__device__ __forceinline__ Dual<N> acos_(const Dual<N>& a) {
  return scaled(a, acosf(a.v), -(1.f / sqrtf(1.f - a.v * a.v)));
}
// atan2(y, x): g_y * (x / (y^2 + x^2)) + g_x * (-y / (y^2 + x^2))
__device__ __forceinline__ float atan2_(float y, float x) {
  return atan2f(y, x);
}
template <int N>
__device__ __forceinline__ Dual<N> atan2_(const Dual<N>& y,
                                          const Dual<N>& x) {
  Dual<N> r;
  r.v = atan2f(y.v, x.v);
  const float den = y.v * y.v + x.v * x.v;
  const float ky = x.v / den;
  const float kx = -y.v / den;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = y.d[i] * ky + x.d[i] * kx;
  return r;
}
// x^2 (integer_pow): g * (2 x)
__device__ __forceinline__ float square_(float x) { return x * x; }
template <int N>
__device__ __forceinline__ Dual<N> square_(const Dual<N>& a) {
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
template <int N>
__device__ __forceinline__ Dual<N> maxc(const Dual<N>& a, float c) {
  const float ans = maxc(a.v, c);
  return scaled(a, ans, balanced(a.v, ans, c));
}
template <int N>
__device__ __forceinline__ Dual<N> minc(const Dual<N>& a, float c) {
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

// lm_soa._exp_update(est, u): pose * se3_exp(u[:6]), scales + u[6:]
template <class S>
__device__ void exp_update(const float* est, const S* u, Est<S>& out) {
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

// lm_soa._finite0: a non-finite value drops value and tangent
template <class S>
__device__ __forceinline__ S finite0(const S& x) {
  return isfinite(val(x)) ? x : Scalar<S>::zero();
}

}  // namespace
