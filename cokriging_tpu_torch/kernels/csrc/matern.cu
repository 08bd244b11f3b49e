// Matern correlation over a distance block, on the card.
//
// Replaces cokriging_tpu/kernels/pallas_ops.py::matern_correlation_pallas
// (pallas_call at :310; _matern_kernel :272, _matern_kernel_sym :277,
// _matern_tile :243):
//     M = 2^{1-nu} / Gamma(nu) * a^nu * K_nu(a),  a = sqrt(2 nu) h / ls,
// h == 0 -> 1, non-finite -> 0, clamped >= 0.
//
// What bounds it: operations. Each entry reads 4 or 8 bytes and writes as
// many, but runs a serial Temme series (12 / 40 trips) or Steed CF2 (up to
// 18 / 80 trips) plus the order recurrence: hundreds of dependent
// multiply-adds, divisions and a few transcendentals per entry. Far above
// the card's operations-per-byte line, so memory traffic is not the limit.
//
// Design: one thread per entry, in 32 x 32 tiles of 32 x 8 threads. A warp
// runs along one row, so its 32 neighbouring (spatially coherent) entries
// mostly take the same series/CF2 branch and run in step. The scalar
// constants (mu, nl, gamma terms, lgamma nu) are computed once by the
// caller, as the TPU wrapper does. The symmetric mode launches only the
// lower-triangle tiles and writes each computed entry twice: directly to
// (i, j), and through a shared-memory transpose to (j, i), so the mirrored
// writes stay coalesced and no separate mirror pass exists.
#include <cuda_runtime.h>

#include "kv.cuh"

namespace {

constexpr int TILE = 32;
constexpr int ROWS = 8;

template <typename T> struct MaternConsts {
  T nu, ls, sqrt2nu, mu;
  int nl;
  ckt::GamConsts<T> gam;
  T lgamma_nu;
};

template <typename T>
__device__ __forceinline__ T matern_entry(T h, const MaternConsts<T>& k) {
  return ckt::matern_value(h, k.nu, k.ls, k.sqrt2nu, k.mu, k.nl, k.gam, k.lgamma_nu);
}

template <typename T>
__global__ void matern_full_kernel(const T* __restrict__ h, T* __restrict__ out,
                                   int n, int m, int tiles_m,
                                   MaternConsts<T> k) {
  const long long t = blockIdx.x;
  const int ti = static_cast<int>(t / tiles_m);
  const int tj = static_cast<int>(t % tiles_m);
  const int col = tj * TILE + threadIdx.x;
  if (col >= m) return;
  for (int r = threadIdx.y; r < TILE; r += ROWS) {
    const int row = ti * TILE + r;
    if (row < n) {
      const size_t idx = static_cast<size_t>(row) * m + col;
      out[idx] = matern_entry(h[idx], k);
    }
  }
}

template <typename T>
__global__ void matern_sym_kernel(const T* __restrict__ h, T* __restrict__ out,
                                  int n, MaternConsts<T> k) {
  __shared__ T tile[TILE][TILE + 1];
  // linear index over the lower-triangle tiles (tj <= ti)
  const long long t = blockIdx.x;
  int ti = static_cast<int>((sqrt(8.0 * static_cast<double>(t) + 1.0) - 1.0) * 0.5);
  while (static_cast<long long>(ti) * (ti + 1) / 2 > t) --ti;
  while (static_cast<long long>(ti + 1) * (ti + 2) / 2 <= t) ++ti;
  const int tj = static_cast<int>(t - static_cast<long long>(ti) * (ti + 1) / 2);

  const int col = tj * TILE + threadIdx.x;
  for (int r = threadIdx.y; r < TILE; r += ROWS) {
    const int row = ti * TILE + r;
    T v = T(0);
    if (row < n && col < n && col <= row) {
      const size_t idx = static_cast<size_t>(row) * n + col;
      v = matern_entry(h[idx], k);
      out[idx] = v;
    }
    tile[r][threadIdx.x] = v;
  }
  __syncthreads();
  // mirror: entry (row = ti*TILE + x, col = tj*TILE + y) goes to (col, row)
  const int mcol = ti * TILE + threadIdx.x;
  for (int y = threadIdx.y; y < TILE; y += ROWS) {
    const int mrow = tj * TILE + y;
    if (mcol < n && mrow < mcol) {
      out[static_cast<size_t>(mrow) * n + mcol] = tile[threadIdx.x][y];
    }
  }
}

template <typename T>
int launch(const T* h, T* out, int n, int m, int symmetric,
           const MaternConsts<T>& k, cudaStream_t stream) {
  const dim3 block(TILE, ROWS);
  const long long tn = (n + TILE - 1) / TILE;
  const long long tm = (m + TILE - 1) / TILE;
  if (symmetric) {
    matern_sym_kernel<T><<<static_cast<unsigned>(tn * (tn + 1) / 2), block, 0,
                           stream>>>(h, out, n, k);
  } else {
    matern_full_kernel<T><<<static_cast<unsigned>(tn * tm), block, 0, stream>>>(
        h, out, n, m, static_cast<int>(tm), k);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
MaternConsts<T> consts(T nu, T ls, T sqrt2nu, T mu, int nl, T gam1, T gam2,
                       T inv_gp, T inv_gm, T lgamma_nu) {
  MaternConsts<T> k;
  k.nu = nu;
  k.ls = ls;
  k.sqrt2nu = sqrt2nu;
  k.mu = mu;
  k.nl = nl;
  k.gam = ckt::GamConsts<T>{gam1, gam2, inv_gp, inv_gm};
  k.lgamma_nu = lgamma_nu;
  return k;
}

}  // namespace

extern "C" {

int matern_f32(const float* h, float* out, int n, int m, int symmetric,
               float nu, float ls, float sqrt2nu, float mu, int nl, float gam1,
               float gam2, float inv_gp, float inv_gm, float lgamma_nu,
               void* stream) {
  return launch<float>(h, out, n, m, symmetric,
                       consts<float>(nu, ls, sqrt2nu, mu, nl, gam1, gam2,
                                     inv_gp, inv_gm, lgamma_nu),
                       static_cast<cudaStream_t>(stream));
}

int matern_f64(const double* h, double* out, int n, int m, int symmetric,
               double nu, double ls, double sqrt2nu, double mu, int nl,
               double gam1, double gam2, double inv_gp, double inv_gm,
               double lgamma_nu, void* stream) {
  return launch<double>(h, out, n, m, symmetric,
                        consts<double>(nu, ls, sqrt2nu, mu, nl, gam1, gam2,
                                       inv_gp, inv_gm, lgamma_nu),
                        static_cast<cudaStream_t>(stream));
}

const char* matern_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
