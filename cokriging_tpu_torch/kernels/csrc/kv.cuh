// K_nu(x) and the Matern correlation of one entry as device templates
// (float and double), shared by every Matern kernel of the port.
//
// The same recurrences as cokriging_tpu_torch/kernels/bessel.py and the
// reference cokriging_tpu/kernels/bessel.py, one thread per entry:
//   - temme_series_tab: K_mu, K_{mu+1} for x < 2 (Temme's power series);
//   - steed_cf2_tab:    K_mu, K_{mu+1} for x >= 2 (Steed's continued fraction);
//   - order_recurrence: K_{r+1} = (2r/x) K_r + K_{r-1} up to nu = mu + nl.
// Trip counts are fixed per type (float 12/18, double 40/80), as in the
// reference. A CF2 lane that converges stops after the converging step,
// which is what the reference's per-lane freeze computes; half-integer
// orders (a1 = 0.25 - mu^2 == 0) run every trip.
//
// Every function is written once over a number type V that is either the
// scalar T (values only, the forward kernels), Dual<T> (value and d/dmu,
// the gradient kernels and the block tangent) or Dual2<T> (value, d/dmu and
// d^2/dmu^2, the Hessian sums): the dual pass is the exact forward tangent in
// mu of the same operations, with nl pinned, which is how the reference takes
// dK/dnu (pallas_ops.py::_kv_triple_dnu_tile), and the second-order pass its
// tangent once more. Branches and the CF2
// convergence test read the value part only, so a dual lane leaves its loop
// at the same trip as the value lane and its tangent stops there too.
//
// The per-entry steps at the end (entry_x, matern_entry_tab,
// pairs_grad_term, tangent_entry, hess_terms) are the kernels' own, and
// tests/test_torch_kv_host.py compiles them with g++ for the host.
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

// out of line on the card: a branch few lanes take keeps its registers apart
#ifdef __CUDACC__
#define CKT_NOINLINE __noinline__
#else
#define CKT_NOINLINE __attribute__((noinline))
#endif

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
// exp over either number type (named apart from ::exp, which a same-named
// overload in this namespace would hide)
__host__ __device__ __forceinline__ float vexp(float a) { return ::expf(a); }
__host__ __device__ __forceinline__ double vexp(double a) { return ::exp(a); }
CKT_FN Dual<T> vexp(Dual<T> a) {
  const T e = vexp(a.v);
  return Dual<T>(e, e * a.d);
}

// ---- second-order numbers: (value, d/dmu, d^2/dmu^2) -----------------------
//
// The dual of a dual in one direction, held as three values: the number type
// of the second-order pass (matern_hess.cu's Hessian sums), whose d^2/dmu^2
// of K_nu is the nu-nu term of the block's second order.

template <typename T> struct Dual2 {
  T v, d, dd;
  __host__ __device__ __forceinline__ Dual2() : v(T(0)), d(T(0)), dd(T(0)) {}
  __host__ __device__ __forceinline__ Dual2(T value) : v(value), d(T(0)), dd(T(0)) {}
  __host__ __device__ __forceinline__ Dual2(T value, T tangent, T tangent2)
      : v(value), d(tangent), dd(tangent2) {}
};

CKT_FN Dual2<T> operator-(Dual2<T> a) { return Dual2<T>(-a.v, -a.d, -a.dd); }
CKT_FN Dual2<T> operator+(Dual2<T> a, Dual2<T> b) {
  return Dual2<T>(a.v + b.v, a.d + b.d, a.dd + b.dd);
}
CKT_FN Dual2<T> operator+(Dual2<T> a, T b) { return Dual2<T>(a.v + b, a.d, a.dd); }
CKT_FN Dual2<T> operator+(T a, Dual2<T> b) { return Dual2<T>(a + b.v, b.d, b.dd); }
CKT_FN Dual2<T> operator-(Dual2<T> a, Dual2<T> b) {
  return Dual2<T>(a.v - b.v, a.d - b.d, a.dd - b.dd);
}
CKT_FN Dual2<T> operator-(Dual2<T> a, T b) { return Dual2<T>(a.v - b, a.d, a.dd); }
CKT_FN Dual2<T> operator-(T a, Dual2<T> b) { return Dual2<T>(a - b.v, -b.d, -b.dd); }
CKT_FN Dual2<T> operator*(Dual2<T> a, Dual2<T> b) {
  return Dual2<T>(a.v * b.v, a.d * b.v + a.v * b.d,
                  a.dd * b.v + T(2) * (a.d * b.d) + a.v * b.dd);
}
CKT_FN Dual2<T> operator*(Dual2<T> a, T b) { return Dual2<T>(a.v * b, a.d * b, a.dd * b); }
CKT_FN Dual2<T> operator*(T a, Dual2<T> b) { return Dual2<T>(a * b.v, a * b.d, a * b.dd); }
CKT_FN Dual2<T> vexp(Dual2<T> a) {
  const T e = vexp(a.v);
  return Dual2<T>(e, e * a.d, e * (a.dd + a.d * a.d));
}

#undef CKT_FN

// the value part, which every branch and convergence test reads
__host__ __device__ __forceinline__ float val(float a) { return a; }
__host__ __device__ __forceinline__ double val(double a) { return a; }
template <typename T> __host__ __device__ __forceinline__ T val(Dual<T> a) { return a.v; }
template <typename T> __host__ __device__ __forceinline__ T val(Dual2<T> a) { return a.v; }

// ---- the order recurrence ----------------------------------------------------

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
// the degenerate lanes (a1 == 0) that never freeze are as the reference's. In the
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

// A row of the second-order table: (value, d/dmu, d^2/dmu^2) per column. Its
// nu-only columns carry their true derivatives in nu = mu + nl (lgamma's are
// digamma and trigamma), which the second-order Matern entry reads.
template <typename T_> struct Dual2Row {
  using T = T_;
  using V = Dual2<T_>;
  const T* r;
  __host__ __device__ __forceinline__ V at(int c) const {
    return V(r[3 * c], r[3 * c + 1], r[3 * c + 2]);
  }
  __host__ __device__ __forceinline__ T scalar(int c) const { return r[3 * c]; }
  __host__ __device__ __forceinline__ T tangent(int c) const { return r[3 * c + 1]; }
};

// 1/a with one division for either number type
__host__ __device__ __forceinline__ float recip(float a) { return 1.0f / a; }
__host__ __device__ __forceinline__ double recip(double a) { return 1.0 / a; }
template <typename T> __host__ __device__ __forceinline__ Dual<T> recip(Dual<T> a) {
  const T q = T(1) / a.v;
  return Dual<T>(q, -q * q * a.d);
}
template <typename T> __host__ __device__ __forceinline__ Dual2<T> recip(Dual2<T> a) {
  const T q = T(1) / a.v;
  const T q2 = q * q;
  return Dual2<T>(q, -q2 * a.d, T(2) * q2 * q * (a.d * a.d) - q2 * a.dd);
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

// one_trip, when given, is set where the lane converged on CF2's first trip.
template <typename Row>
__host__ __device__ __forceinline__ void steed_cf2_tab(const Row& t, typename Row::T x,
                                                       bool early_exit, typename Row::V& k_mu,
                                                       typename Row::V& k_mu1,
                                                       bool* one_trip = nullptr) {
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
      if (converged) {
        if (one_trip) *one_trip = i == 2;
        break;
      }
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
                                                     typename Row::V& k_mu1,
                                                     bool* one_trip = nullptr) {
  if (x < typename Row::T(2)) {
    temme_series_tab(t, x, k_mu, k_mu1);
  } else {
    steed_cf2_tab(t, x, early_exit, k_mu, k_mu1, one_trip);
  }
}

// M at x = sqrt(2 nu) h / ls > 0 from a value-table row: non-finite -> 0,
// clamped >= 0 (cov/matern.py::matern_correlation past its h == 0 test).
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

// M and its partials dM/dnu, dM/dls at a = sqrt(2 nu) h / ls > 0 from a
// dual-table row, from one dual series/CF2 pass: K_{nu-1}, K_nu, K_{nu+1}
// (dK/dx = -(K_{nu-1} + K_{nu+1}) / 2) and the exact dK/dnu with nl pinned.
// Returns false where M is not finite and > 0: M counts as 0 there and the
// entry has no nu or ls term.
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

// ---- the x-derivative of the mu-tangent, where the reference's differs ------
//
// The reference differentiates K_nu twice by AD of its first-order rule: its
// d/dx of dK/dnu is the x-derivative of the mu-tangent as computed, and its
// d2K/dx2 the x-derivative of -(K_{nu-1} + K_{nu+1}) / 2 as computed, both
// through the branch clamps min(x, 2) / max(x, 2) and the order recurrence.
// On two kinds of CF2 lane that is not the true mixed partial that
// matern_second_tab takes everywhere else (d/dnu of dK/dx, and d2K/dx2 from
// Bessel's equation):
//   - a lane that converges on CF2's first trip (a1 = 0.25 - mu^2 tiny but
//     not 0, nu within a few ulp of a half-integer) truncates the tangent,
//     and the reference then takes d/dx of the truncated tangent;
//   - at x == 2 exactly the clamps pass half of x's gradient each, so the
//     pair's share of every x-derivative is halved.
// There the entry carries (value, d/dmu) pairs with their x-derivatives
// through the pair and the recurrence: the pair's from CF2's setup and one
// trip (first-trip lanes) or from K_mu' = (mu / x) K_mu - K_{mu+1} and
// K_{mu+1}' = -K_mu - ((mu + 1) / x) K_{mu+1} (a converged pair), weighted
// 1/2 at x == 2; the recurrence's own x-dependence at full weight.

// x-derivatives (as (value, d/dmu) pairs) of (K_mu, K_{mu+1}) from CF2 stopped
// after its first trip: the operations of steed_cf2_tab's setup and first trip,
// each with its x-derivative.
template <typename T>
__host__ __device__ __forceinline__ void cf2_first_trip_dx(const Dual2Row<T>& t, T x,
                                                           Dual<T>& k0_x, Dual<T>& k1_x) {
  using D = Dual<T>;
  const D a1(t.scalar(tab::kA1), t.tangent(tab::kA1));
  const D mu(t.scalar(tab::kMu), t.tangent(tab::kMu));
  const int col = TabLayout<T>::cf2;
  const D a_n(t.scalar(col), t.tangent(col));
  const D r_a(t.scalar(col + 1), t.tangent(col + 1));
  const D r_c(t.scalar(col + 2), t.tangent(col + 2));
  // setup: b = 2 (1 + x), d = h = delh = 1 / b, q = c = a1, s = 1 + a1 d
  const T b = T(2) * (T(1) + x);
  const T d = T(1) / b;
  const T d_x = T(-2) * d * d;
  const D s0 = T(1) + a1 * d;
  const D s0_x = a1 * d_x;
  // trip 2: q1 = 0, q2 = 1
  const D c_n = a1 * r_c;
  const D qnew = -b * r_a;
  const D qnew_x = T(-2) * r_a;
  const D q = a1 + c_n * qnew;
  const D q_x = c_n * qnew_x;
  const T b2 = b + T(2);
  const D den = b2 + a_n * d;
  const D den_x = T(2) + a_n * d_x;
  const D d2 = recip(den);
  const D d2_x = -(d2 * d2) * den_x;
  const D delh = (b2 * d2 - T(1)) * d;
  const D delh_x = (T(2) * d2 + b2 * d2_x) * d + (b2 * d2 - T(1)) * d_x;
  const D h_x = d_x + delh_x;
  const D h = d + delh;
  const D s = s0 + q * delh;
  const D s_x = s0_x + q_x * delh + q * delh_x;
  // K_mu = F(x) / s, F = sqrt(pi / (2 x)) exp(-x); K_{mu+1} = K_mu g / x,
  // g = mu + x + 1/2 - a1 h
  const T inv_x = T(1) / x;
  const T f = sqrt(T(kPi) / (T(2) * x)) * vexp(-x);
  const T f_x = f * (T(-0.5) * inv_x - T(1));
  const D inv_s = recip(s);
  const D inv_s_x = -(inv_s * inv_s) * s_x;
  const D k0 = f * inv_s;
  k0_x = f_x * inv_s + f * inv_s_x;
  const D g = mu + x + T(0.5) - a1 * h;
  const D g_x = T(1) - a1 * h_x;
  k1_x = (k0_x * g + k0 * g_x) * inv_x - (k0 * g) * (inv_x * inv_x);
}

// (d2K/dx2, d/dx of dK/dnu) as the reference takes them at nu = mu + nl, from
// the pair (k0, k1) = (K_mu, K_{mu+1}) with its mu-tangents, the pair's
// x-derivatives (k0_x, k1_x) and their weight w (1/2 at x == 2, else 1).
template <typename T>
__host__ __device__ __forceinline__ void reference_x_partials(Dual<T> mu, int nl, T x,
                                                              Dual<T> k0, Dual<T> k1,
                                                              Dual<T> k0_x, Dual<T> k1_x, T w,
                                                              T& k_xx, T& k_xn) {
  using D = Dual<T>;
  const T two_over_x = T(2) / x;
  const T two_over_x_x = -two_over_x / x;
  k0_x = w * k0_x;
  k1_x = w * k1_x;
  for (int i = 1; i <= (nl > 0 ? nl - 1 : 0); ++i) {
    const D coef = mu + T(i);
    const D next = coef * two_over_x * k1 + k0;
    const D next_x = coef * (two_over_x * k1_x + two_over_x_x * k1) + k0_x;
    k0 = k1;
    k0_x = k1_x;
    k1 = next;
    k1_x = next_x;
  }
  D prev_x, mid_x, next_x;
  if (nl == 0) {
    prev_x = k1_x - (two_over_x * mu) * k0_x - (two_over_x_x * mu) * k0;
    mid_x = k0_x;
    next_x = k1_x;
  } else {
    const D coef = mu + T(nl);
    prev_x = k0_x;
    mid_x = k1_x;
    next_x = (two_over_x * coef) * k1_x + (two_over_x_x * coef) * k1 + k0_x;
  }
  k_xx = T(-0.5) * (prev_x.v + next_x.v);
  k_xn = mid_x.d;
}

// The reference's (d2K/dx2, d/dx of dK/dnu) on a lane where they differ from
// the true partials, from the pair (km, km1) with its mu-tangents: the pair's
// x-derivatives from CF2's first trip (one_trip) or from the converged
// pair's identities, weighted 1/2 at x == 2.
template <typename T>
__host__ __device__ CKT_NOINLINE void reference_x_lane(const Dual2Row<T>& t, T a, int nl,
                                                       bool one_trip, Dual2<T> km, Dual2<T> km1,
                                                       T& k_xx, T& k_xn) {
  const Dual<T> mu(t.scalar(tab::kMu), t.tangent(tab::kMu)), p0(km.v, km.d), p1(km1.v, km1.d);
  Dual<T> p0_x, p1_x;
  if (one_trip) {
    cf2_first_trip_dx(t, a, p0_x, p1_x);
  } else {
    const T inv_a = T(1) / a;
    p0_x = (mu * inv_a) * p0 - p1;
    p1_x = -p0 - ((mu + T(1)) * inv_a) * p1;
  }
  reference_x_partials(mu, nl, a, p0, p1, p0_x, p1_x, a == T(2) ? T(0.5) : T(1), k_xx, k_xn);
}

// M and its first and second partials in (nu, ls) at a = sqrt(2 nu) h / ls > 0
// from a second-order table row, from one second-order series/CF2 pass with
// nl pinned: K_{nu-1}, K_nu, K_{nu+1} with their mu-tangents and K_nu's second
// mu-tangent. With K_n = dK/dnu, K_x = -(K_{nu-1} + K_{nu+1}) / 2,
// K_nx = dK_x/dnu, K_nn = d^2K/dnu^2 and K_xx = (1 + nu^2/a^2) K - K_x / a
// (Bessel's equation), G = K_nu(a(nu, ls)) has
//   G_n = K_n + K_x a_n,  G_l = K_x a_l,
//   G_nn = K_nn + 2 K_nx a_n + K_xx a_n^2 + K_x a_nn,
//   G_nl = K_nx a_l + K_xx a_n a_l + K_x a_nl,  G_ll = K_xx a_l^2 + K_x a_ll,
// with a_n = a / (2 nu), a_l = -a / ls, a_nn = -a / (4 nu^2),
// a_nl = -a / (2 nu ls), a_ll = 2 a / ls^2; and M = E G, E = exp(lp),
// lp = (1 - nu) ln 2 - lgamma(nu) + nu ln a, so
//   M_ij = E (lp_i lp_j G + lp_ij G + lp_i G_j + lp_j G_i + G_ij),
// lp_n = -ln 2 - psi(nu) + ln a + 1/2, lp_l = -nu / ls,
// lp_nn = -psi'(nu) + 1 / (2 nu), lp_nl = -1 / ls, lp_ll = nu / ls^2.
// Returns false where M is not finite and > 0 (no terms), as
// matern_partials_tab does.
template <typename T>
__host__ __device__ __forceinline__ bool matern_second_tab(T a, const Dual2Row<T>& t, T& m,
                                                           T& m_n, T& m_l, T& m_nn, T& m_nl,
                                                           T& m_ll) {
  using V = Dual2<T>;
  const int nl = static_cast<int>(t.scalar(tab::kNl));
  const V mu = t.at(tab::kMu);
  V km, km1;
  bool one_trip = false;
  kv_pair_tab(t, a, false, km, km1, &one_trip);
  // the lanes where the reference's x-derivatives part from the true ones
  // (see cf2_first_trip_dx): they take the pair's x-derivatives here
  const bool ref_x = one_trip || a == T(2);
  T k_xx_ref = T(0), k_xn_ref = T(0);
  if (ref_x) reference_x_lane(t, a, nl, one_trip, km, km1, k_xx_ref, k_xn_ref);
  order_recurrence(mu, nl > 0 ? nl - 1 : 0, a, km, km1);
  const T two_over_a = T(2) / a;
  V k_prev, k_mid, k_next;
  if (nl == 0) {
    k_prev = km1 - (two_over_a * mu) * km;
    k_mid = km;
    k_next = km1;
  } else {
    k_prev = km;
    k_mid = km1;
    k_next = (two_over_a * (mu + T(nl))) * km1 + km;
  }
  const T nu = t.scalar(tab::kNu);
  const T ls = t.scalar(tab::kLs);
  const T log_a = log(a);
  const T e = vexp((T(1) - nu) * T(kLn2) - t.scalar(tab::kLgamma) + nu * log_a);
  const T g = k_mid.v;
  m = e * g;
  if (!(isfinite(m) && m > T(0))) return false;
  const T k_x = T(-0.5) * (k_prev.v + k_next.v);
  // d/dnu of dK/dx; d/dx of dK/dnu, which equals it but where ref_x holds
  const T k_nx = T(-0.5) * (k_prev.d + k_next.d);
  const T k_xn = ref_x ? k_xn_ref : k_nx;
  const T inv_a = T(1) / a;
  const T k_xx = ref_x ? k_xx_ref : (T(1) + (nu * inv_a) * (nu * inv_a)) * g - k_x * inv_a;
  const T a_n = a / (T(2) * nu);
  const T a_l = -a / ls;
  const T a_nn = -a_n / (T(2) * nu);
  const T a_nl = a_l / (T(2) * nu);
  const T a_ll = T(-2) * a_l / ls;
  const T g_n = k_mid.d + k_x * a_n;
  const T g_l = k_x * a_l;
  const T g_nn = k_mid.dd + (k_nx + k_xn) * a_n + k_xx * a_n * a_n + k_x * a_nn;
  const T g_nl = k_xn * a_l + k_xx * a_n * a_l + k_x * a_nl;
  const T g_ll = k_xx * a_l * a_l + k_x * a_ll;
  const T lp_n = -T(kLn2) - t.scalar(tab::kDigamma) + log_a + T(0.5);
  const T lp_l = -nu / ls;
  const T lp_nn = -t.tangent(tab::kDigamma) + T(1) / (T(2) * nu);
  const T lp_nl = T(-1) / ls;
  const T lp_ll = nu / (ls * ls);
  m_n = e * (lp_n * g + g_n);
  m_l = e * (lp_l * g + g_l);
  m_nn = e * ((lp_n * lp_n + lp_nn) * g + T(2) * lp_n * g_n + g_nn);
  m_nl = e * ((lp_n * lp_l + lp_nl) * g + lp_n * g_l + lp_l * g_n + g_nl);
  m_ll = e * ((lp_l * lp_l + lp_ll) * g + T(2) * lp_l * g_l + g_ll);
  return true;
}

// ---- the kernels' per-entry steps -------------------------------------------

// x = sqrt(2 nu) |h| / ls of one entry, formed as every Matern kernel forms
// it from its row; false where |h| is not > 0 (zero or NaN): M is 1 there
// and the entry has no nu or ls term.
template <typename Row>
__host__ __device__ __forceinline__ bool entry_x(typename Row::T h, const Row& t,
                                                 typename Row::T& x) {
  using T = typename Row::T;
  h = fabs(h);
  if (!(h > T(0))) return false;
  x = t.scalar(tab::kSqrt2Nu) * (h / t.scalar(tab::kLs));
  return true;
}

// The block forward's entry: M(nu, ls, h) = 1 where |h| is not > 0, else
// matern_value_tab at entry_x (the pairs forward runs these two steps apart,
// around its tile sort).
template <typename T>
__host__ __device__ __forceinline__ T matern_entry_tab(T h, const ValueRow<T>& t,
                                                       bool early_exit = true) {
  T x;
  return entry_x(h, t, x) ? matern_value_tab(x, t, early_exit) : T(1);
}

// The pairs gradient's entry at x = entry_x(h) > 0 with cotangent w: its
// terms (w dM/dnu, w dM/dls), each 0 where it is not finite; false where M
// is not finite and > 0 (no terms).
template <typename T>
__host__ __device__ __forceinline__ bool pairs_grad_term(T x, T w, const DualRow<T>& t,
                                                        T& g_nu, T& g_ls) {
  T m, dm_dnu, dm_dls;
  if (!matern_partials_tab(x, t, m, dm_dnu, dm_dls)) return false;
  g_nu = w * dm_dnu;
  g_ls = w * dm_dls;
  if (!isfinite(g_nu)) g_nu = T(0);
  if (!isfinite(g_ls)) g_ls = T(0);
  return true;
}

// The block tangent's entry (matern_hess.cu's tangent kernel): with weights
// ws, wn and the products s wnu, s wls, the entry's
//   ws M + wn [h == 0] + s (wnu dM/dnu + wls dM/dls),
// M = 1 and no nu, ls term where |h| is not > 0; where M is not finite and
// > 0 it counts as 0 with no terms; a term that is not finite counts 0.
template <typename T>
__host__ __device__ __forceinline__ T tangent_entry(T h, const DualRow<T>& t, T ws, T wn,
                                                    T s_wnu, T s_wls) {
  T x;
  if (!entry_x(h, t, x)) return h == T(0) ? ws + wn : ws;
  T m, dm_dnu, dm_dls;
  if (!matern_partials_tab(x, t, m, dm_dnu, dm_dls)) return T(0);
  T g_nu = s_wnu * dm_dnu;
  T g_ls = s_wls * dm_dls;
  if (!isfinite(g_nu)) g_nu = T(0);
  if (!isfinite(g_ls)) g_ls = T(0);
  return ws * m + g_nu + g_ls;
}

// The Hessian sums' entry at x = entry_x(h) > 0 with cotangent w (matern_hess.cu's
// hess kernel): terms w dM/dnu, w dM/dls, w d2M/dnu2, w d2M/dnu dls,
// w d2M/dls2 into out[0..4], each 0 where it is not finite; false where M is
// not finite and > 0 (no terms).
template <typename T>
__host__ __device__ __forceinline__ bool hess_terms(T x, T w, const Dual2Row<T>& t, T* out) {
  T m, d[5];
  if (!matern_second_tab(x, t, m, d[0], d[1], d[2], d[3], d[4])) return false;
  for (int k = 0; k < 5; ++k) {
    const T term = w * d[k];
    out[k] = isfinite(term) ? term : T(0);
  }
  return true;
}

}  // namespace ckt
