// The second order of one Matern covariance block, on the card: the backward
// of the block-gradient kernel (matern_grad.cu), which a Hessian of the
// likelihood runs through.
//
// No TPU kernel is replaced: the reference takes the block's second order by
// XLA's AD of the elementwise model (cokriging_tpu/cov/matern.py::
// _matern_corr_raw; its Pallas kernels serve f32 blocks only, and its
// Hessian, cokriging_tpu/estimate/uncertainty.py, runs in f64). For the block
//     C = scale * M(nu, ls, h) + nugget * [h == 0]
// matern_block_grad returns g = (sum ct M, sum ct [h == 0],
// scale sum ct dM/dnu, scale sum ct dM/dls). Its backward, for a cotangent
// v of g, needs
//   - to ct: the tangent matrix  v_s M + v_n [h == 0]
//                                + scale (v_nu dM/dnu + v_ls dM/dls)
//     (tangent_kernel, an n x m output);
//   - to (scale, nu, ls): the sums sum ct dM/dnu, sum ct dM/dls,
//     sum ct d2M/dnu2, sum ct d2M/dnu dls, sum ct d2M/dls2, which close the
//     4 x 4 contraction with v (hess_kernel, five doubles).
// Per entry, the tangent kernel runs kv.cuh's first-order dual pass
// (matern_partials_tab over a dual row, as matern_grad.cu does) and the Hessian
// kernel its second-order pass (matern_second_tab over a Dual2Row: K_nu with
// its first and second mu-tangents with nl pinned, K_{nu+-1} with their
// first; d2K/dx2 from Bessel's equation). Masks as matern_grad.cu's: M is 1
// where |h| is not > 0, and the nu and ls terms count only where M is finite
// and > 0 and the term is finite.
//
// What bounds them: operations. The Hessian kernel reads h and ct and
// writes nothing per entry, but carries every quantity of the serial series
// or CF2 with two tangents (a second-order product is 9 operations against a
// value's 1); the tangent kernel reads h and writes one value per entry
// after a dual pass. Both sit far above the card's operations-per-byte line.
//
// Design: 64 x 64 tiles of 256 threads each (tile_sum.cuh). The tangent
// kernel loads the tile's h with coalesced row reads; entries whose |h| is
// not > 0 take their constant value at once, the rest are keyed by series
// or CF2 half-octave of x and sorted stably (partition.cuh), and thread t
// evaluates sorted slots t, t + 256, ...; the dual row sits in shared
// memory. It puts each value back at its entry's slot and stores the tile
// with one coalesced pass; its symmetric mode launches the lower-triangle
// tiles and stores (j, i) through the shared tile read transposed, as
// matern.cu does. The Hessian sums are tile_sum.cuh's tiled weighted sum
// with HessStep below as its per-entry step, as the block gradient is with
// its own: w = ct[i, j] + ct[j, i] below the diagonal in the symmetric mode,
// per-tile partials in double and a fixed-order second launch, no atomics,
// the same sums from run to run. scale and the weights are device values:
// nothing is read back.
#include <cuda_runtime.h>

#include "kv.cuh"
#include "tile_sum.cuh"

namespace {

constexpr int TILE = ckt::kTile;
constexpr int PITCH = ckt::kPitch;
constexpr int THREADS = ckt::kTileThreads;
constexpr int WARPS = ckt::kTileWarps;
constexpr int ITEMS = ckt::kTileItems;
constexpr int CF2_BINS = ckt::kCf2Bins;
constexpr int N_KEYS = ckt::kTileKeys;

// ---- the tangent ---------------------------------------------------------------

// Dynamic shared memory of a tangent block: the dual row, h (then the
// tangent) per entry in the padded tile, the partition's counts and total,
// the sorted indices, the keys.
template <typename T> size_t tangent_smem() {
  return sizeof(T) * (2 * ckt::TabLayout<T>::width + TILE * PITCH) +
         sizeof(int) * (WARPS * N_KEYS + 4) + sizeof(unsigned short) * TILE * TILE +
         TILE * TILE;
}

// sw: the device doubles (scale, w_s, w_n, w_nu, w_ls).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    tangent_kernel(const T* __restrict__ h, int n, int m, int symmetric, int tiles_m,
                   const T* __restrict__ table, const double* __restrict__ sw,
                   T* __restrict__ out) {
  constexpr int W2 = 2 * ckt::TabLayout<T>::width;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_tab = reinterpret_cast<T*>(smem);
  T* s_val = s_tab + W2;
  int* s_cnt = reinterpret_cast<int*>(s_val + TILE * PITCH);
  int* s_total = s_cnt + WARPS * N_KEYS;
  unsigned short* s_perm = reinterpret_cast<unsigned short*>(s_total + 4);
  unsigned char* s_key = reinterpret_cast<unsigned char*>(s_perm + TILE * TILE);
  for (int t = threadIdx.x; t < W2; t += THREADS) s_tab[t] = table[t];
  int ti, tj;
  ckt::tile_of(blockIdx.x, symmetric, tiles_m, ti, tj);
  const T ws = static_cast<T>(sw[1]);
  const T wn = static_cast<T>(sw[2]);
  const T s_wnu = static_cast<T>(sw[0] * sw[3]);
  const T s_wls = static_cast<T>(sw[0] * sw[4]);
  __syncthreads();
  const ckt::DualRow<T> row{s_tab};

  for (int e = threadIdx.x; e < TILE * TILE; e += THREADS) {
    const int r = e / TILE, c = e % TILE;
    const int i = ti * TILE + r, j = tj * TILE + c;
    unsigned char key = ckt::kNoKey;
    if (i < n && j < m && (!symmetric || j <= i)) {
      const T hv = h[static_cast<size_t>(i) * m + j];
      T x;
      if (ckt::entry_x(hv, row, x)) {
        s_val[r * PITCH + c] = hv;
        key = static_cast<unsigned char>(ckt::x_bucket<CF2_BINS>(x));
      } else {
        s_val[r * PITCH + c] = hv == T(0) ? ws + wn : ws;
      }
    }
    s_key[e] = key;
  }
  const int n_sorted =
      ckt::stable_partition<WARPS, ITEMS>(s_key, TILE * TILE, N_KEYS, s_perm, s_cnt, s_total);
  for (int slot = threadIdx.x; slot < n_sorted; slot += THREADS) {
    const int e = s_perm[slot];
    T& v = s_val[(e / TILE) * PITCH + e % TILE];
    v = ckt::tangent_entry(v, row, ws, wn, s_wnu, s_wls);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < TILE * TILE; e += THREADS) {
    const int r = e / TILE, c = e % TILE;
    const int i = ti * TILE + r, j = tj * TILE + c;
    if (i < n && j < m && (!symmetric || j <= i)) {
      out[static_cast<size_t>(i) * m + j] = s_val[r * PITCH + c];
    }
  }
  if (symmetric) {
    // entry (x, y) of the tile also goes to (tj*TILE + y, ti*TILE + x)
    for (int e = threadIdx.x; e < TILE * TILE; e += THREADS) {
      const int x = e % TILE, y = e / TILE;
      const int i = ti * TILE + x, j = tj * TILE + y;
      if (i < n && j < i) out[static_cast<size_t>(j) * n + i] = s_val[x * PITCH + y];
    }
  }
}

// ---- the Hessian sums ----------------------------------------------------------

// The five terms of an entry: dM/dnu, dM/dls, d2M/dnu2, d2M/dnu dls,
// d2M/dls2; none where |h| is not > 0 (M = 1 there).
template <typename T> struct HessStep {
  static constexpr int kOut = 5;
  static constexpr int kRows = 3;
  using Row = ckt::Dual2Row<T>;
  __device__ __forceinline__ static void constant(bool, T, T*) {}
  __device__ __forceinline__ static void entry(T x, T w, const Row& row, T* acc) {
    T terms[kOut];
    if (ckt::hess_terms(x, w, row, terms)) {
      for (int k = 0; k < kOut; ++k) acc[k] += terms[k];
    }
  }
};

template <typename T>
int launch_tangent(const T* h, int n, int m, int symmetric, const T* table, const double* sw,
                   T* out, cudaStream_t stream) {
  const size_t smem = tangent_smem<T>();
  cudaError_t err = ckt::allow_smem<tangent_kernel<T>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tangent_kernel<T><<<static_cast<unsigned>(ckt::num_tiles(n, m, symmetric)), THREADS, smem,
                      stream>>>(h, n, m, symmetric, static_cast<int>((m + TILE - 1) / TILE),
                                table, sw, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hess(const T* h, const T* ct, int n, int m, long long ld_h, long long ld_ct,
                int symmetric, const T* table, double* part, double* out, cudaStream_t stream) {
  return ckt::launch_tile_sum<T, HessStep<T>>(h, ct, n, m, ld_h, ld_ct, symmetric, table,
                                              nullptr, 0, part, out, stream);
}

}  // namespace

extern "C" {

long long hess_num_tiles(int n, int m, int symmetric) { return ckt::num_tiles(n, m, symmetric); }

// h, out: contiguous (n, m) device arrays (square when symmetric); table: one
// row of kv.cuh's dual table (2 x TabLayout width device values,
// kernels/cuda_ops.py::recurrence_table(order=1)); sw: the device doubles
// (scale, w_s, w_n, w_nu, w_ls).
int tangent_f32(const float* h, int n, int m, int symmetric, const float* table,
                const double* sw, float* out, void* stream) {
  return launch_tangent<float>(h, n, m, symmetric, table, sw, out,
                               static_cast<cudaStream_t>(stream));
}

int tangent_f64(const double* h, int n, int m, int symmetric, const double* table,
                const double* sw, double* out, void* stream) {
  return launch_tangent<double>(h, n, m, symmetric, table, sw, out,
                                static_cast<cudaStream_t>(stream));
}

// h, ct: (n, m) device arrays with unit column stride and row strides ld_h,
// ld_ct (in elements); table: one row of kv.cuh's second-order table (3 x
// TabLayout width device values, recurrence_table(order=2)); part:
// 5 * hess_num_tiles doubles of scratch; out: 5 doubles.
int hess_f32(const float* h, const float* ct, int n, int m, long long ld_h, long long ld_ct,
             int symmetric, const float* table, double* part, double* out, void* stream) {
  return launch_hess<float>(h, ct, n, m, ld_h, ld_ct, symmetric, table, part, out,
                            static_cast<cudaStream_t>(stream));
}

int hess_f64(const double* h, const double* ct, int n, int m, long long ld_h, long long ld_ct,
             int symmetric, const double* table, double* part, double* out, void* stream) {
  return launch_hess<double>(h, ct, n, m, ld_h, ld_ct, symmetric, table, part, out,
                             static_cast<cudaStream_t>(stream));
}

const char* hess_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
