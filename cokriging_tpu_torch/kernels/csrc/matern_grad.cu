// Backward of one Matern covariance block against a cotangent, on the card.
//
// Replaces cokriging_tpu/kernels/pallas_ops.py::matern_block_grad_pallas
// (pallas_call at :470; _matern_grad_kernel :431, _matern_grad_kernel_sym
// :443, _matern_grad_tile :376, _kv_triple_dnu_tile :343). For the block
//     C = scale * M(nu, ls, h) + nugget * [h == 0]
// and a cotangent ct it returns the four scalars
//     sum ct * M,  sum ct[h == 0],  scale * sum ct * dM/dnu,
//     scale * sum ct * dM/dls
// (the cotangents of scale, nugget, nu and ls; h is data and gets none).
// Per entry, a = sqrt(2 nu) h / ls and one dual-number series/CF2 pass
// (kv.cuh::kv_triple_dnu) gives K_{nu-1}, K_nu, K_{nu+1} and the exact
// dK_nu/dnu with nl pinned; dK/dx = -(K_{nu-1} + K_{nu+1}) / 2. Masks as in
// the reference: M is 1 at h == 0, 0 where non-finite, clamped >= 0; the nu
// and ls terms count only where M is finite and > 0, h > 0 and the term is
// finite.
//
// What bounds it: operations. An entry reads h and ct (8 or 16 bytes) and
// writes nothing, but runs the forward kernel's serial series or CF2 with
// every carried quantity doubled by its tangent: several hundred dependent
// operations per entry, far above the card's operations-per-byte line.
//
// Design: one thread per entry in 32 x 32 tiles of 32 x 8 threads, a warp
// along a row (neighbouring distances, mostly one branch). Each thread adds
// its four entries' terms in the working type; the block adds its threads'
// sums in double in a fixed order (warp shuffles, then warp 0 over the
// eight warp sums) into one partial per tile, and a second launch adds the
// per-tile partials in a fixed order: no floating-point atomics, so a
// gradient is the same from run to run. The TPU kernel carried its sums
// across a sequential grid and read a cotangent folded beforehand into the
// lower triangle, tril(ct + ct^T) - diag(ct); blocks here run in no order
// and the symmetric mode launches only the lower-triangle tiles, reads
// ct[i, j] directly and ct[j, i] through a shared-memory transpose of the
// mirrored tile (coalesced both ways), and counts the diagonal once: no
// n^2 temporary. h and ct are read through their row strides with bounds
// checks, so neither is padded or copied.
#include <cuda_runtime.h>

#include "kv.cuh"

namespace {

constexpr int TILE = 32;
constexpr int ROWS = 8;
constexpr int RED_THREADS = 256;
constexpr int N_OUT = 4;

template <typename T> struct GradConsts {
  T nu, ls, sqrt2nu, mu;
  int nl;
  ckt::GamConsts<ckt::Dual<T>> gam;
  T lgamma_nu, digamma_nu;
};

// The four terms of one entry with weight w (the entry's cotangent), added
// to acc: [w M, w [h == 0], w dM/dnu, w dM/dls].
template <typename T>
__host__ __device__ __forceinline__ void grad_entry(T h, T w, const GradConsts<T>& k,
                                                    T* acc) {
  h = fabs(h);
  if (!(h > T(0))) {
    acc[0] += w;  // M = 1
    if (h == T(0)) acc[1] += w;
    return;
  }
  T m, dm_dnu, dm_dls;
  if (!ckt::matern_partials(h, k.nu, k.ls, k.sqrt2nu, k.mu, k.nl, k.gam, k.lgamma_nu,
                            k.digamma_nu, m, dm_dnu, dm_dls)) {
    return;  // M counts as 0; no nu, ls terms
  }
  acc[0] += w * m;
  if (isfinite(dm_dnu)) acc[2] += w * dm_dnu;
  if (isfinite(dm_dls)) acc[3] += w * dm_dls;
}

// Block sum of each thread's four sums, in double and in a fixed order;
// thread 0 writes the tile's partial.
template <typename T>
__device__ __forceinline__ void block_partial(const T* acc, double* __restrict__ part) {
  __shared__ double warp_sum[ROWS][N_OUT];
  const int lane = threadIdx.x;  // blockDim.x == 32: one warp per threadIdx.y
  for (int k = 0; k < N_OUT; ++k) {
    double v = static_cast<double>(acc[k]);
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) warp_sum[threadIdx.y][k] = v;
  }
  __syncthreads();
  if (threadIdx.y == 0 && lane < N_OUT) {
    double v = 0.0;
    for (int w = 0; w < ROWS; ++w) v += warp_sum[w][lane];
    part[static_cast<size_t>(blockIdx.x) * N_OUT + lane] = v;
  }
}

template <typename T>
__global__ void grad_full_kernel(const T* __restrict__ h, const T* __restrict__ ct,
                                 int n, int m, long long ld_h, long long ld_ct,
                                 int tiles_m, GradConsts<T> k,
                                 double* __restrict__ part) {
  const long long t = blockIdx.x;
  const int ti = static_cast<int>(t / tiles_m);
  const int tj = static_cast<int>(t % tiles_m);
  const int col = tj * TILE + threadIdx.x;
  T acc[N_OUT] = {T(0), T(0), T(0), T(0)};
  if (col < m) {
    for (int r = threadIdx.y; r < TILE; r += ROWS) {
      const int row = ti * TILE + r;
      if (row < n) {
        grad_entry(h[row * ld_h + col], ct[row * ld_ct + col], k, acc);
      }
    }
  }
  block_partial(acc, part);
}

template <typename T>
__global__ void grad_sym_kernel(const T* __restrict__ h, const T* __restrict__ ct,
                                int n, long long ld_h, long long ld_ct,
                                GradConsts<T> k, double* __restrict__ part) {
  __shared__ T mirror[TILE][TILE + 1];
  // linear index over the lower-triangle tiles (tj <= ti)
  const long long t = blockIdx.x;
  int ti = static_cast<int>((sqrt(8.0 * static_cast<double>(t) + 1.0) - 1.0) * 0.5);
  while (static_cast<long long>(ti) * (ti + 1) / 2 > t) --ti;
  while (static_cast<long long>(ti + 1) * (ti + 2) / 2 <= t) ++ti;
  const int tj = static_cast<int>(t - static_cast<long long>(ti) * (ti + 1) / 2);

  // the mirrored tile (tj, ti) of ct, read along its rows:
  // mirror[y][x] = ct[tj*TILE + y, ti*TILE + x]
  const int mcol = ti * TILE + threadIdx.x;
  for (int y = threadIdx.y; y < TILE; y += ROWS) {
    const int mrow = tj * TILE + y;
    mirror[y][threadIdx.x] = (mrow < n && mcol < n) ? ct[mrow * ld_ct + mcol] : T(0);
  }
  __syncthreads();

  const int col = tj * TILE + threadIdx.x;
  T acc[N_OUT] = {T(0), T(0), T(0), T(0)};
  for (int r = threadIdx.y; r < TILE; r += ROWS) {
    const int row = ti * TILE + r;
    if (row < n && col <= row) {
      // ct[row, col] + ct[col, row] below the diagonal, ct[row, row] on it
      T w = ct[row * ld_ct + col];
      if (col < row) w += mirror[threadIdx.x][r];
      grad_entry(h[row * ld_h + col], w, k, acc);
    }
  }
  block_partial(acc, part);
}

// One block per output adds the per-tile partials in a fixed order;
// outputs 2 and 3 are scaled.
__global__ void grad_reduce_kernel(const double* __restrict__ part, long long n_parts,
                                   double scale, double* __restrict__ out) {
  __shared__ double ss[RED_THREADS];
  const int k = blockIdx.x;
  double s = 0.0;
  for (long long p = threadIdx.x; p < n_parts; p += RED_THREADS) s += part[p * N_OUT + k];
  ss[threadIdx.x] = s;
  __syncthreads();
  for (int w = RED_THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) ss[threadIdx.x] += ss[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[k] = (k >= 2 ? scale : 1.0) * ss[0];
}

long long num_tiles(int n, int m, int symmetric) {
  const long long tn = (n + TILE - 1) / TILE;
  const long long tm = (m + TILE - 1) / TILE;
  return symmetric ? tn * (tn + 1) / 2 : tn * tm;
}

template <typename T>
int launch(const T* h, const T* ct, int n, int m, long long ld_h, long long ld_ct,
           int symmetric, const GradConsts<T>& k, double scale, double* part,
           double* out, cudaStream_t stream) {
  const dim3 block(TILE, ROWS);
  const long long n_tiles = num_tiles(n, m, symmetric);
  if (symmetric) {
    grad_sym_kernel<T><<<static_cast<unsigned>(n_tiles), block, 0, stream>>>(
        h, ct, n, ld_h, ld_ct, k, part);
  } else {
    grad_full_kernel<T><<<static_cast<unsigned>(n_tiles), block, 0, stream>>>(
        h, ct, n, m, ld_h, ld_ct, static_cast<int>((m + TILE - 1) / TILE), k, part);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  grad_reduce_kernel<<<N_OUT, RED_THREADS, 0, stream>>>(part, n_tiles, scale, out);
  return static_cast<int>(cudaGetLastError());
}

// c: [nu, ls, sqrt(2 nu), mu, gam1, gam2, inv_gp, inv_gm, dgam1, dgam2,
//     dinv_gp, dinv_gm, lgamma(nu), digamma(nu)]
template <typename T> GradConsts<T> consts(const T* c, int nl) {
  GradConsts<T> k;
  k.nu = c[0];
  k.ls = c[1];
  k.sqrt2nu = c[2];
  k.mu = c[3];
  k.nl = nl;
  k.gam.gam1 = ckt::Dual<T>(c[4], c[8]);
  k.gam.gam2 = ckt::Dual<T>(c[5], c[9]);
  k.gam.inv_gp = ckt::Dual<T>(c[6], c[10]);
  k.gam.inv_gm = ckt::Dual<T>(c[7], c[11]);
  k.lgamma_nu = c[12];
  k.digamma_nu = c[13];
  return k;
}

}  // namespace

extern "C" {

long long matern_grad_num_tiles(int n, int m, int symmetric) {
  return num_tiles(n, m, symmetric);
}

// h, ct: (n, m) device arrays with unit column stride and row strides ld_h,
// ld_ct (in elements); consts: 14 host scalars (see consts()); part:
// 4 * matern_grad_num_tiles doubles of scratch; out: 4 doubles.
int matern_grad_f32(const float* h, const float* ct, int n, int m, long long ld_h,
                    long long ld_ct, int symmetric, const float* consts_host, int nl,
                    double scale, double* part, double* out, void* stream) {
  return launch<float>(h, ct, n, m, ld_h, ld_ct, symmetric,
                       consts<float>(consts_host, nl), scale, part, out,
                       static_cast<cudaStream_t>(stream));
}

int matern_grad_f64(const double* h, const double* ct, int n, int m, long long ld_h,
                    long long ld_ct, int symmetric, const double* consts_host, int nl,
                    double scale, double* part, double* out, void* stream) {
  return launch<double>(h, ct, n, m, ld_h, ld_ct, symmetric,
                        consts<double>(consts_host, nl), scale, part, out,
                        static_cast<cudaStream_t>(stream));
}

const char* matern_grad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
