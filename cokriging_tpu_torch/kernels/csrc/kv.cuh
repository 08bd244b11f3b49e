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
#pragma once

#include <cuda_runtime.h>
#include <math.h>

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

// (gam1, gam2, 1/Gamma(1+mu), 1/Gamma(1-mu)): host-computed per call.
template <typename T> struct GamConsts {
  T gam1, gam2, inv_gp, inv_gm;
};

template <typename T>
__device__ __forceinline__ void temme_series(T mu, T x, const GamConsts<T>& g,
                                             T& k_mu, T& k_mu1) {
  const T x2 = T(0.5) * x;
  const T mu2 = mu * mu;
  const T d = -log(x2);
  const T e = mu * d;
  const T pimu = T(kPi) * mu;
  const T fact =
      (fabs(pimu) < T(1e-4)) ? T(1) + pimu * pimu / T(6) : pimu / sin(pimu);
  const T e_exp = exp(e);
  const T sinh_e = T(0.5) * (e_exp - T(1) / e_exp);
  const T cosh_e = T(0.5) * (e_exp + T(1) / e_exp);
  const T fact2 = (fabs(e) < T(1e-4)) ? T(1) + e * e / T(6) : sinh_e / e;
  T ff = fact * (g.gam1 * cosh_e + g.gam2 * fact2 * d);
  T p = T(0.5) * e_exp / g.inv_gp;
  T q = T(0.5) / (e_exp * g.inv_gm);
  T c = T(1);
  const T dd = x2 * x2;
  T ksum = ff;
  T ksum1 = p;
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

template <typename T>
__device__ __forceinline__ void steed_cf2(T mu, T x, T& k_mu, T& k_mu1) {
  const T a1 = T(0.25) - mu * mu;
  T b = T(2) * (T(1) + x);
  T d = T(1) / b;
  T h = d;
  T delh = d;
  T q1 = T(0);
  T q2 = T(1);
  T q = a1;
  T c = a1;
  T a = -a1;
  T s = T(1) + q * delh;
  const bool not_degenerate = a1 != T(0);
  for (int i = 2; i < KvIters<T>::cf2 + 2; ++i) {
    const T fi = T(i);
    const T a_n = a - T(2) * (fi - T(1));
    const T c_n = -a_n * c / fi;
    const T qnew = (q1 - b * q2) / a_n;
    const T q_n = q + c_n * qnew;
    const T b_n = b + T(2);
    const T d_n = T(1) / (b_n + a_n * d);
    const T delh_n = (b_n * d_n - T(1)) * delh;
    const T h_n = h + delh_n;
    const T dels = q_n * delh_n;
    const T s_n = s + dels;
    const bool converged = not_degenerate && fabs(dels / s_n) < Eps<T>::value;
    // renormalize (q1, q2, c): only c*qnew and q1:q2 enter the result
    const T aq = fabs(qnew);
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
  k_mu = sqrt(T(kPi) / (T(2) * x)) * exp(-x) / s;
  k_mu1 = k_mu * (mu + x + T(0.5) - h) / x;
}

template <typename T>
__device__ __forceinline__ void order_recurrence(T mu, int nl, T x, T& k_mu,
                                                 T& k_mu1) {
  const T two_over_x = T(2) / x;
  for (int i = 1; i <= nl; ++i) {
    const T k_next = (mu + T(i)) * two_over_x * k_mu1 + k_mu;
    k_mu = k_mu1;
    k_mu1 = k_next;
  }
}

// K_{mu+nl}(x) for x > 0: the branch is chosen per thread.
template <typename T>
__device__ __forceinline__ T kv_from_munl(T mu, int nl, const GamConsts<T>& g,
                                          T x) {
  T k_mu, k_mu1;
  if (x < T(2)) {
    temme_series(mu, x, g, k_mu, k_mu1);
  } else {
    steed_cf2(mu, x, k_mu, k_mu1);
  }
  order_recurrence(mu, nl, x, k_mu, k_mu1);
  return k_mu;
}

}  // namespace ckt
