// K_nu(x) building blocks as device templates (float and double).
//
// The same recurrences as cokriging_tpu_torch/kernels/bessel.py and the
// reference cokriging_tpu/kernels/bessel.py, one thread per entry:
//   - temme_series: K_mu, K_{mu+1} for x < 2 (Temme's power series);
//   - steed_cf2:    K_mu, K_{mu+1} for x >= 2 (Steed's continued fraction);
//   - order_recurrence: K_{r+1} = (2r/x) K_r + K_{r-1} up to nu = mu + nl.
// Trip counts are fixed per type (float 12/18, double 40/80), as in the
// reference. A CF2 lane that converges stops after the converging step,
// which is what the reference's per-lane freeze computes; half-integer
// orders (a1 = 0.25 - mu^2 == 0) run every trip.
//
// Every function is written once over a number type V that is either the
// scalar T (values only, the forward kernel) or Dual<T> (value and d/dmu,
// the gradient kernel): the dual pass is the exact forward tangent in mu of
// the same operations, with nl pinned, which is how the reference takes
// dK/dnu (pallas_ops.py::_kv_triple_dnu_tile). Branches and the CF2
// convergence test read the value part only, so a dual lane leaves its loop
// at the same trip as the value lane and its tangent stops there too.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

namespace ckt {

template <typename T> struct KvIters;
template <> struct KvIters<float> {
  static constexpr int series = 12;
  static constexpr int cf2 = 18;
};
template <> struct KvIters<double> {
  static constexpr int series = 40;
  static constexpr int cf2 = 80;
};

template <typename T> struct Eps;
template <> struct Eps<float> {
  static constexpr float value = 1.1920928955078125e-07f;
};
template <> struct Eps<double> {
  static constexpr double value = 2.220446049250313e-16;
};

constexpr double kPi = 3.141592653589793238462643383279502884;
constexpr double kLn2 = 0.6931471805599453;

// ---- dual numbers: (value, d/dmu) ----------------------------------------

template <typename T> struct Dual {
  T v, d;
  __host__ __device__ __forceinline__ Dual() : v(T(0)), d(T(0)) {}
  __host__ __device__ __forceinline__ Dual(T value) : v(value), d(T(0)) {}
  __host__ __device__ __forceinline__ Dual(T value, T tangent) : v(value), d(tangent) {}
};

#define CKT_FN template <typename T> __host__ __device__ __forceinline__

CKT_FN Dual<T> operator-(Dual<T> a) { return Dual<T>(-a.v, -a.d); }
CKT_FN Dual<T> operator+(Dual<T> a, Dual<T> b) { return Dual<T>(a.v + b.v, a.d + b.d); }
CKT_FN Dual<T> operator+(Dual<T> a, T b) { return Dual<T>(a.v + b, a.d); }
CKT_FN Dual<T> operator+(T a, Dual<T> b) { return Dual<T>(a + b.v, b.d); }
CKT_FN Dual<T> operator-(Dual<T> a, Dual<T> b) { return Dual<T>(a.v - b.v, a.d - b.d); }
CKT_FN Dual<T> operator-(Dual<T> a, T b) { return Dual<T>(a.v - b, a.d); }
CKT_FN Dual<T> operator-(T a, Dual<T> b) { return Dual<T>(a - b.v, -b.d); }
CKT_FN Dual<T> operator*(Dual<T> a, Dual<T> b) {
  return Dual<T>(a.v * b.v, a.d * b.v + a.v * b.d);
}
CKT_FN Dual<T> operator*(Dual<T> a, T b) { return Dual<T>(a.v * b, a.d * b); }
CKT_FN Dual<T> operator*(T a, Dual<T> b) { return Dual<T>(a * b.v, a * b.d); }
CKT_FN Dual<T> operator/(Dual<T> a, Dual<T> b) {
  const T q = a.v / b.v;
  return Dual<T>(q, (a.d - q * b.d) / b.v);
}
CKT_FN Dual<T> operator/(Dual<T> a, T b) { return Dual<T>(a.v / b, a.d / b); }
CKT_FN Dual<T> operator/(T a, Dual<T> b) {
  const T q = a / b.v;
  return Dual<T>(q, -q * b.d / b.v);
}

// exp and sin over either number type (named apart from ::exp and ::sin,
// which a same-named overload in this namespace would hide)
__host__ __device__ __forceinline__ float vexp(float a) { return ::expf(a); }
__host__ __device__ __forceinline__ double vexp(double a) { return ::exp(a); }
__host__ __device__ __forceinline__ float vsin(float a) { return ::sinf(a); }
__host__ __device__ __forceinline__ double vsin(double a) { return ::sin(a); }
__host__ __device__ __forceinline__ float vcos(float a) { return ::cosf(a); }
__host__ __device__ __forceinline__ double vcos(double a) { return ::cos(a); }
CKT_FN Dual<T> vexp(Dual<T> a) {
  const T e = vexp(a.v);
  return Dual<T>(e, e * a.d);
}
CKT_FN Dual<T> vsin(Dual<T> a) { return Dual<T>(vsin(a.v), vcos(a.v) * a.d); }

#undef CKT_FN

// the value part, which every branch and convergence test reads
__host__ __device__ __forceinline__ float val(float a) { return a; }
__host__ __device__ __forceinline__ double val(double a) { return a; }
template <typename T> __host__ __device__ __forceinline__ T val(Dual<T> a) { return a.v; }

// (gam1, gam2, 1/Gamma(1+mu), 1/Gamma(1-mu)): computed by the wrapper with
// the plain path's torch functions (as Dual<T>, with their d/dmu).
template <typename V> struct GamConsts {
  V gam1, gam2, inv_gp, inv_gm;
};

// ---- K_mu, K_{mu+1} ---------------------------------------------------------

template <typename T, typename V>
__host__ __device__ __forceinline__ void temme_series(V mu, T x, const GamConsts<V>& g,
                                                      V& k_mu, V& k_mu1) {
  const T x2 = T(0.5) * x;
  const V mu2 = mu * mu;
  const T d = -log(x2);
  const V e = mu * d;
  const V pimu = T(kPi) * mu;
  const V fact =
      (fabs(val(pimu)) < T(1e-4)) ? T(1) + pimu * pimu / T(6) : pimu / vsin(pimu);
  const V e_exp = vexp(e);
  const V sinh_e = T(0.5) * (e_exp - T(1) / e_exp);
  const V cosh_e = T(0.5) * (e_exp + T(1) / e_exp);
  const V fact2 = (fabs(val(e)) < T(1e-4)) ? T(1) + e * e / T(6) : sinh_e / e;
  V ff = fact * (g.gam1 * cosh_e + g.gam2 * fact2 * d);
  V p = T(0.5) * e_exp / g.inv_gp;
  V q = T(0.5) / (e_exp * g.inv_gm);
  T c = T(1);
  const T dd = x2 * x2;
  V ksum = ff;
  V ksum1 = p;
#pragma unroll 4
  for (int i = 1; i <= KvIters<T>::series; ++i) {
    const T fi = T(i);
    ff = (fi * ff + p + q) / (fi * fi - mu2);
    c = c * dd / fi;
    p = p / (fi - mu);
    q = q / (fi + mu);
    ksum = ksum + c * ff;
    ksum1 = ksum1 + c * (p - fi * ff);
  }
  k_mu = ksum;
  k_mu1 = ksum1 * (T(2) / x);
}

template <typename T, typename V>
__host__ __device__ __forceinline__ void steed_cf2(V mu, T x, V& k_mu, V& k_mu1) {
  const V a1 = T(0.25) - mu * mu;
  T b = T(2) * (T(1) + x);
  V d = V(T(1) / b);
  V h = d;
  V delh = d;
  V q1 = V(T(0));
  V q2 = V(T(1));
  V q = a1;
  V c = a1;
  V a = -a1;
  V s = T(1) + q * delh;
  const bool not_degenerate = val(a1) != T(0);
  for (int i = 2; i < KvIters<T>::cf2 + 2; ++i) {
    const T fi = T(i);
    const V a_n = a - T(2) * (fi - T(1));
    const V c_n = -a_n * c / fi;
    const V qnew = (q1 - b * q2) / a_n;
    const V q_n = q + c_n * qnew;
    const T b_n = b + T(2);
    const V d_n = T(1) / (b_n + a_n * d);
    const V delh_n = (b_n * d_n - T(1)) * delh;
    const V h_n = h + delh_n;
    const V dels = q_n * delh_n;
    const V s_n = s + dels;
    const bool converged =
        not_degenerate && fabs(val(dels) / val(s_n)) < Eps<T>::value;
    // renormalize (q1, q2, c): only c*qnew and q1:q2 enter the result, so
    // the scale is a plain number (its tangent would cancel)
    const T aq = fabs(val(qnew));
    const T scale = aq > T(1e-30) ? aq : T(1e-30);
    q1 = q2 / scale;
    q2 = qnew / scale;
    c = c_n * scale;
    a = a_n;
    b = b_n;
    d = d_n;
    h = h_n;
    delh = delh_n;
    q = q_n;
    s = s_n;
    if (converged) break;
  }
  h = a1 * h;
  k_mu = (sqrt(T(kPi) / (T(2) * x)) * vexp(-x)) / s;
  k_mu1 = k_mu * (mu + x + T(0.5) - h) / x;
}

template <typename T, typename V>
__host__ __device__ __forceinline__ void order_recurrence(V mu, int nl, T x, V& k_mu,
                                                          V& k_mu1) {
  const T two_over_x = T(2) / x;
  for (int i = 1; i <= nl; ++i) {
    const V k_next = (mu + T(i)) * two_over_x * k_mu1 + k_mu;
    k_mu = k_mu1;
    k_mu1 = k_next;
  }
}

// (K_mu, K_{mu+1}) for x > 0: the branch is chosen per thread.
template <typename T, typename V>
__host__ __device__ __forceinline__ void kv_pair(V mu, const GamConsts<V>& g, T x,
                                                 V& k_mu, V& k_mu1) {
  if (x < T(2)) {
    temme_series(mu, x, g, k_mu, k_mu1);
  } else {
    steed_cf2(mu, x, k_mu, k_mu1);
  }
}

// K_{mu+nl}(x) for x > 0.
template <typename T>
__host__ __device__ __forceinline__ T kv_from_munl(T mu, int nl, const GamConsts<T>& g,
                                                   T x) {
  T k_mu, k_mu1;
  kv_pair(mu, g, x, k_mu, k_mu1);
  order_recurrence(mu, nl, x, k_mu, k_mu1);
  return k_mu;
}

// (K_{nu-1}, K_nu, K_{nu+1}) and dK_nu/dnu at nu = mu + nl for x > 0, from
// one dual (K_mu, K_{mu+1}) pair: the upward recurrence to order nl - 1,
// then one step up, or one step down when nl == 0
// (kernels/bessel.py::kv_triple_from_pair).
template <typename T>
__host__ __device__ __forceinline__ void kv_triple_dnu(T mu, int nl,
                                                       const GamConsts<Dual<T>>& g, T x,
                                                       T& k_prev, T& k_mid, T& k_next,
                                                       T& dk_dnu) {
  const Dual<T> m(mu, T(1));
  Dual<T> km, km1;
  kv_pair(m, g, x, km, km1);
  order_recurrence(m, nl > 0 ? nl - 1 : 0, x, km, km1);
  if (nl == 0) {
    k_prev = km1.v - (T(2) * mu / x) * km.v;
    k_mid = km.v;
    k_next = km1.v;
    dk_dnu = km.d;
  } else {
    k_prev = km.v;
    k_mid = km1.v;
    k_next = (T(2) * (mu + T(nl)) / x) * km1.v + km.v;
    dk_dnu = km1.d;
  }
}

// ---- the Matern correlation of one entry -----------------------------------

// M = 2^{1-nu} / Gamma(nu) * a^nu * K_nu(a), a = sqrt(2 nu) h / ls;
// h == 0 -> 1, non-finite -> 0, clamped >= 0 (cov/matern.py::matern_correlation).
// mu, nl, g and lgamma_nu are the caller's per-(nu, ls) constants.
template <typename T>
__host__ __device__ __forceinline__ T matern_value(T h, T nu, T ls, T sqrt2nu, T mu, int nl,
                                                   const GamConsts<T>& g, T lgamma_nu) {
  h = fabs(h);
  if (!(h > T(0))) return T(1);
  const T arg = sqrt2nu * (h / ls);
  const T kv = kv_from_munl(mu, nl, g, arg);
  const T log_pref = (T(1) - nu) * T(kLn2) - lgamma_nu + nu * log(arg);
  T corr = vexp(log_pref) * kv;
  if (!isfinite(corr)) corr = T(0);
  return corr > T(0) ? corr : T(0);
}

// M and its partials dM/dnu, dM/dls at one entry with h > 0, from one dual
// series/CF2 pass (kv_triple_dnu): dK/dx = -(K_{nu-1} + K_{nu+1}) / 2 and the
// exact dK/dnu with nl pinned. Returns false where M is not finite and > 0:
// M counts as 0 there and the entry has no nu or ls term.
template <typename T>
__host__ __device__ __forceinline__ bool matern_partials(T h, T nu, T ls, T sqrt2nu, T mu,
                                                         int nl, const GamConsts<Dual<T>>& g,
                                                         T lgamma_nu, T digamma_nu, T& m,
                                                         T& dm_dnu, T& dm_dls) {
  const T a = sqrt2nu * (h / ls);
  T k_prev, k_mid, k_next, dk_dnu;
  kv_triple_dnu(mu, nl, g, a, k_prev, k_mid, k_next, dk_dnu);
  const T log_a = log(a);
  const T lp = (T(1) - nu) * T(kLn2) - lgamma_nu + nu * log_a;
  const T elp = vexp(lp);
  m = elp * k_mid;
  if (!(isfinite(m) && m > T(0))) return false;
  const T dk_dx = T(-0.5) * (k_prev + k_next);
  const T da_dnu = a / (T(2) * nu);
  const T da_dls = -a / ls;
  const T dlp_dnu = -T(kLn2) - digamma_nu + log_a + T(0.5);
  dm_dnu = m * dlp_dnu + elp * (dk_dnu + dk_dx * da_dnu);
  dm_dls = m * (-nu / ls) + elp * dk_dx * da_dls;
  return true;
}

// ---- table-driven forms -----------------------------------------------------
//
// The same series, CF2 and recurrence with every factor that depends on mu
// alone read from a per-(nu, ls) table row built on the card
// (kernels/cuda_ops.py::recurrence_table), so no trip divides except CF2's
// 1/(b_n + a_n d):
//   series trip i (1..S): 1/(i^2 - mu^2), 1/(i - mu), 1/(i + mu); 1/i folds
//                         into a constant once the loop is unrolled;
//   CF2 trip i (2..C+1):  a_n = -a1 - i (i - 1), 1/a_n, -a_n / i;
//   setup:                pi mu / sin(pi mu), 0.5 Gamma(1 + mu),
//                         0.5 Gamma(1 - mu), a1 = 0.25 - mu^2.
// CF2 converges where |dels| < eps |s_n| (no quotient) and renormalizes
// (q1, q2, c) by the power of two of qnew's exponent, which is exact. A dual
// table holds each column with its d/dmu (mu's own tangent is 1), so the
// dual pass reads the tangents of the reciprocals instead of forming dual
// quotients. Trip counts, the value-lane exit of a converged dual lane and
// the degenerate lanes (a1 == 0) that never freeze are as above. In the
// value-only pass a degenerate lane may leave CF2 after its setup: with
// c = a1 = 0 every trip adds exactly 0 to s, and h enters only as a1 h = 0,
// so the result is bit for bit the full loop's.

namespace tab {
constexpr int kNu = 0, kLs = 1, kSqrt2Nu = 2, kMu = 3, kNl = 4, kGam1 = 5, kGam2 = 6,
              kHalfGp = 7, kHalfGm = 8, kLgamma = 9, kDigamma = 10, kFact = 11, kA1 = 12,
              kHead = 13;
}  // namespace tab

// Column offsets of a table row (in values; a dual row has two per column).
template <typename T> struct TabLayout {
  static constexpr int series = tab::kHead;
  static constexpr int cf2 = series + 3 * KvIters<T>::series;
  static constexpr int width = cf2 + 3 * KvIters<T>::cf2;
};

// A row of the value table: one T per column.
template <typename T_> struct ValueRow {
  using T = T_;
  using V = T_;
  const T* r;
  __host__ __device__ __forceinline__ V at(int c) const { return r[c]; }
  __host__ __device__ __forceinline__ T scalar(int c) const { return r[c]; }
};

// A row of the dual table: (value, d/dmu) per column.
template <typename T_> struct DualRow {
  using T = T_;
  using V = Dual<T_>;
  const T* r;
  __host__ __device__ __forceinline__ V at(int c) const { return V(r[2 * c], r[2 * c + 1]); }
  __host__ __device__ __forceinline__ T scalar(int c) const { return r[2 * c]; }
};

// 1/a with one division for either number type
__host__ __device__ __forceinline__ float recip(float a) { return 1.0f / a; }
__host__ __device__ __forceinline__ double recip(double a) { return 1.0 / a; }
template <typename T> __host__ __device__ __forceinline__ Dual<T> recip(Dual<T> a) {
  const T q = T(1) / a.v;
  return Dual<T>(q, -q * q * a.d);
}

// (2^e, 2^-e) for e the binary exponent of v, clamped to [-100, 100]
__host__ __device__ __forceinline__ void pow2_scale(double v, double& s, double& inv) {
  long long bits;
#ifdef __CUDA_ARCH__
  bits = __double_as_longlong(v);
#else
  memcpy(&bits, &v, sizeof bits);
#endif
  int e = static_cast<int>((bits >> 52) & 0x7ff) - 1023;
  e = e < -100 ? -100 : (e > 100 ? 100 : e);
  const long long sb = static_cast<long long>(e + 1023) << 52;
  const long long ib = static_cast<long long>(1023 - e) << 52;
#ifdef __CUDA_ARCH__
  s = __longlong_as_double(sb);
  inv = __longlong_as_double(ib);
#else
  memcpy(&s, &sb, sizeof s);
  memcpy(&inv, &ib, sizeof inv);
#endif
}
__host__ __device__ __forceinline__ void pow2_scale(float v, float& s, float& inv) {
  int bits;
#ifdef __CUDA_ARCH__
  bits = __float_as_int(v);
#else
  memcpy(&bits, &v, sizeof bits);
#endif
  int e = ((bits >> 23) & 0xff) - 127;
  e = e < -100 ? -100 : (e > 100 ? 100 : e);
  const int sb = (e + 127) << 23;
  const int ib = (127 - e) << 23;
#ifdef __CUDA_ARCH__
  s = __int_as_float(sb);
  inv = __int_as_float(ib);
#else
  memcpy(&s, &sb, sizeof s);
  memcpy(&inv, &ib, sizeof inv);
#endif
}

template <typename Row>
__host__ __device__ __forceinline__ void temme_series_tab(const Row& t, typename Row::T x,
                                                          typename Row::V& k_mu,
                                                          typename Row::V& k_mu1) {
  using T = typename Row::T;
  using V = typename Row::V;
  const T x2 = T(0.5) * x;
  const T d = -log(x2);
  const V e = t.at(tab::kMu) * d;
  const V e_exp = vexp(e);
  const V e_inv = recip(e_exp);
  const V sinh_e = T(0.5) * (e_exp - e_inv);
  const V cosh_e = T(0.5) * (e_exp + e_inv);
  const V fact2 =
      (fabs(val(e)) < T(1e-4)) ? T(1) + e * e * T(1.0 / 6.0) : sinh_e * recip(e);
  V ff = t.at(tab::kFact) * (t.at(tab::kGam1) * cosh_e + t.at(tab::kGam2) * fact2 * d);
  V p = t.at(tab::kHalfGp) * e_exp;
  V q = t.at(tab::kHalfGm) * e_inv;
  T c = T(1);
  const T dd = x2 * x2;
  V ksum = ff;
  V ksum1 = p;
#pragma unroll
  for (int i = 1; i <= KvIters<T>::series; ++i) {
    const int col = TabLayout<T>::series + 3 * (i - 1);
    const T fi = T(i);
    ff = (fi * ff + p + q) * t.at(col);
    c = c * dd * (T(1) / fi);
    p = p * t.at(col + 1);
    q = q * t.at(col + 2);
    ksum = ksum + c * ff;
    ksum1 = ksum1 + c * (p - fi * ff);
  }
  k_mu = ksum;
  k_mu1 = ksum1 * (T(2) / x);
}

template <typename Row>
__host__ __device__ __forceinline__ void steed_cf2_tab(const Row& t, typename Row::T x,
                                                       bool early_exit, typename Row::V& k_mu,
                                                       typename Row::V& k_mu1) {
  using T = typename Row::T;
  using V = typename Row::V;
  const V a1 = t.at(tab::kA1);
  T b = T(2) * (T(1) + x);
  V d = V(T(1) / b);
  V h = d;
  V delh = d;
  V q1 = V(T(0));
  V q2 = V(T(1));
  V q = a1;
  V c = a1;
  V s = T(1) + q * delh;
  const bool not_degenerate = val(a1) != T(0);
  if (not_degenerate || !early_exit) {
    for (int i = 2; i < KvIters<T>::cf2 + 2; ++i) {
      const int col = TabLayout<T>::cf2 + 3 * (i - 2);
      const V a_n = t.at(col);
      const V c_n = c * t.at(col + 2);
      const V qnew = (q1 - b * q2) * t.at(col + 1);
      q = q + c_n * qnew;
      b = b + T(2);
      d = recip(b + a_n * d);
      delh = (b * d - T(1)) * delh;
      h = h + delh;
      const V dels = q * delh;
      s = s + dels;
      const bool converged =
          not_degenerate && fabs(val(dels)) < Eps<T>::value * fabs(val(s));
      T scale, inv;
      pow2_scale(val(qnew), scale, inv);
      q1 = q2 * inv;
      q2 = qnew * inv;
      c = c_n * scale;
      if (converged) break;
    }
  }
  h = a1 * h;
  k_mu = (sqrt(T(kPi) / (T(2) * x)) * vexp(-x)) * recip(s);
  k_mu1 = k_mu * (t.at(tab::kMu) + x + T(0.5) - h) * (T(1) / x);
}

// (K_mu, K_{mu+1}) for x > 0 from a table row: the branch is chosen per thread.
template <typename Row>
__host__ __device__ __forceinline__ void kv_pair_tab(const Row& t, typename Row::T x,
                                                     bool early_exit, typename Row::V& k_mu,
                                                     typename Row::V& k_mu1) {
  if (x < typename Row::T(2)) {
    temme_series_tab(t, x, k_mu, k_mu1);
  } else {
    steed_cf2_tab(t, x, early_exit, k_mu, k_mu1);
  }
}

// M at x = sqrt(2 nu) h / ls > 0 from a value-table row (matern_value's
// result past its h == 0 test): non-finite -> 0, clamped >= 0.
// early_exit = false runs a degenerate lane's CF2 trips all the same.
template <typename T>
__host__ __device__ __forceinline__ T matern_value_tab(T x, const ValueRow<T>& t,
                                                       bool early_exit = true) {
  T k_mu, k_mu1;
  kv_pair_tab(t, x, early_exit, k_mu, k_mu1);
  order_recurrence(t.at(tab::kMu), static_cast<int>(t.at(tab::kNl)), x, k_mu, k_mu1);
  const T nu = t.at(tab::kNu);
  const T log_pref = (T(1) - nu) * T(kLn2) - t.at(tab::kLgamma) + nu * log(x);
  T corr = vexp(log_pref) * k_mu;
  if (!isfinite(corr)) corr = T(0);
  return corr > T(0) ? corr : T(0);
}

// matern_partials at a = sqrt(2 nu) h / ls > 0 from a dual-table row.
template <typename T>
__host__ __device__ __forceinline__ bool matern_partials_tab(T a, const DualRow<T>& t, T& m,
                                                             T& dm_dnu, T& dm_dls) {
  const T mu = t.scalar(tab::kMu);
  const int nl = static_cast<int>(t.scalar(tab::kNl));
  Dual<T> km, km1;
  kv_pair_tab(t, a, false, km, km1);
  order_recurrence(t.at(tab::kMu), nl > 0 ? nl - 1 : 0, a, km, km1);
  T k_prev, k_mid, k_next, dk_dnu;
  if (nl == 0) {
    k_prev = km1.v - (T(2) * mu / a) * km.v;
    k_mid = km.v;
    k_next = km1.v;
    dk_dnu = km.d;
  } else {
    k_prev = km.v;
    k_mid = km1.v;
    k_next = (T(2) * (mu + T(nl)) / a) * km1.v + km.v;
    dk_dnu = km1.d;
  }
  const T nu = t.scalar(tab::kNu);
  const T ls = t.scalar(tab::kLs);
  const T log_a = log(a);
  const T lp = (T(1) - nu) * T(kLn2) - t.scalar(tab::kLgamma) + nu * log_a;
  const T elp = vexp(lp);
  m = elp * k_mid;
  if (!(isfinite(m) && m > T(0))) return false;
  const T dk_dx = T(-0.5) * (k_prev + k_next);
  const T da_dnu = a / (T(2) * nu);
  const T da_dls = -a / ls;
  const T dlp_dnu = -T(kLn2) - t.scalar(tab::kDigamma) + log_a + T(0.5);
  dm_dnu = m * dlp_dnu + elp * (dk_dnu + dk_dx * da_dnu);
  dm_dls = m * (-nu / ls) + elp * dk_dx * da_dls;
  return true;
}

}  // namespace ckt
