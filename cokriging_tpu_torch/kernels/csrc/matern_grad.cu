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
// (kv.cuh::matern_partials_tab) gives K_{nu-1}, K_nu, K_{nu+1} and the exact
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
// Design: one block of 256 threads per 64 x 64 tile. The block loads the
// tile's h (as x = sqrt(2 nu) h / ls) and its weight w into shared memory
// with coalesced row reads; entries at h == 0 (or not > 0) add their M = 1
// terms at once, the rest are keyed by series or CF2 half-octave of x and
// sorted stably by key (partition.cuh), and thread t evaluates sorted slots
// t, t + 256, ...: a warp runs one branch with like CF2 trip counts, where
// the unsorted points of a month left nearly every warp with both. The dual
// pass is kv.cuh's table-driven one (matern_partials_tab): the per-(nu, ls)
// dual table, built on the card by the wrapper, sits in shared memory and no
// series or CF2 trip divides by a function of mu. Each thread adds its terms
// in the working type; the block adds its threads' sums in double in a
// fixed order (warp shuffles, then the warps in order) into one partial per
// tile, and a second launch adds the per-tile partials in a fixed order: no
// floating-point atomics, and the sum order is a fixed function of the
// tile's contents, so a gradient is the same from run to run. The TPU
// kernel carried its sums across a sequential grid and read a cotangent
// folded beforehand into the lower triangle, tril(ct + ct^T) - diag(ct);
// blocks here run in no order and the symmetric mode launches only the
// lower-triangle tiles, takes w = ct[i, j] + ct[j, i] below the diagonal
// (ct[j, i] read along the mirrored tile's rows and added at the transposed
// slot of a padded shared array) and ct[i, i] on it: no n^2 temporary. h and
// ct are read through their row strides with bounds checks, so neither is
// padded or copied.
#include <cuda_runtime.h>

#include "kv.cuh"
#include "partition.cuh"

namespace {

constexpr int TILE = 64;
constexpr int PITCH = TILE + 1;  // the weights' row pitch: transposed adds miss bank conflicts
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = TILE * TILE / THREADS;
constexpr int CF2_BINS = 8;
constexpr int N_KEYS = 1 + CF2_BINS;
// keys of the entries that skip K_nu (all >= N_KEYS, so left out of the sort)
constexpr unsigned char KEY_ZERO = 0xfd;     // h == 0: M = 1 and the nugget term
constexpr unsigned char KEY_NOT_POS = 0xfe;  // h not > 0 otherwise (NaN): M = 1
constexpr int RED_THREADS = 256;
constexpr int N_OUT = 4;

// Block sum of each thread's four sums, in double and in a fixed order;
// thread 0 .. 3 write the tile's partial.
template <typename T>
__device__ __forceinline__ void block_partial(const T* acc, double* __restrict__ part) {
  __shared__ double warp_sum[WARPS][N_OUT];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int k = 0; k < N_OUT; ++k) {
    double v = static_cast<double>(acc[k]);
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) warp_sum[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < N_OUT) {
    double v = 0.0;
    for (int w = 0; w < WARPS; ++w) v += warp_sum[w][threadIdx.x];
    part[static_cast<size_t>(blockIdx.x) * N_OUT + threadIdx.x] = v;
  }
}

// Dynamic shared memory of a block: the dual table row, x and the keys per
// entry, the padded weights, the partition's counts and total, the sorted
// indices.
template <typename T> size_t grad_smem() {
  return sizeof(T) * (2 * ckt::TabLayout<T>::width + TILE * TILE + TILE * PITCH) +
         sizeof(int) * (WARPS * N_KEYS + 4) + sizeof(unsigned short) * TILE * TILE +
         TILE * TILE;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    grad_kernel(const T* __restrict__ h, const T* __restrict__ ct, int n, int m,
                long long ld_h, long long ld_ct, int symmetric, int tiles_m,
                const T* __restrict__ table, double* __restrict__ part) {
  constexpr int W2 = 2 * ckt::TabLayout<T>::width;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_tab = reinterpret_cast<T*>(smem);
  T* s_x = s_tab + W2;
  T* s_w = s_x + TILE * TILE;
  int* s_cnt = reinterpret_cast<int*>(s_w + TILE * PITCH);
  int* s_total = s_cnt + WARPS * N_KEYS;
  unsigned short* s_perm = reinterpret_cast<unsigned short*>(s_total + 4);
  unsigned char* s_key = reinterpret_cast<unsigned char*>(s_perm + TILE * TILE);
  for (int t = threadIdx.x; t < W2; t += THREADS) s_tab[t] = table[t];

  const long long t = blockIdx.x;
  int ti, tj;
  if (symmetric) {  // linear index over the lower-triangle tiles (tj <= ti)
    ti = static_cast<int>((sqrt(8.0 * static_cast<double>(t) + 1.0) - 1.0) * 0.5);
    while (static_cast<long long>(ti) * (ti + 1) / 2 > t) --ti;
    while (static_cast<long long>(ti + 1) * (ti + 2) / 2 <= t) ++ti;
    tj = static_cast<int>(t - static_cast<long long>(ti) * (ti + 1) / 2);
  } else {
    ti = static_cast<int>(t / tiles_m);
    tj = static_cast<int>(t % tiles_m);
  }
  __syncthreads();
  const T sqrt2nu = s_tab[2 * ckt::tab::kSqrt2Nu];
  const T ls = s_tab[2 * ckt::tab::kLs];

  // entry e = (r, c): row ti*TILE + r, column tj*TILE + c, read along rows
  for (int e = threadIdx.x; e < TILE * TILE; e += THREADS) {
    const int r = e / TILE, c = e % TILE;
    const int row = ti * TILE + r, col = tj * TILE + c;
    unsigned char key = ckt::kNoKey;
    if (row < n && col < m && (!symmetric || col <= row)) {
      const T hv = fabs(h[row * ld_h + col]);
      s_w[r * PITCH + c] = ct[row * ld_ct + col];
      if (hv > T(0)) {
        const T x = sqrt2nu * (hv / ls);
        s_x[e] = x;
        key = static_cast<unsigned char>(ckt::x_bucket<CF2_BINS>(x));
      } else {
        key = hv == T(0) ? KEY_ZERO : KEY_NOT_POS;
      }
    }
    s_key[e] = key;
  }
  if (symmetric) {
    // ct[j, i] of the entries below the diagonal, read along the mirrored
    // tile's rows: ct[tj*TILE + y, ti*TILE + x] belongs to entry (x, y)
    __syncthreads();
    for (int e = threadIdx.x; e < TILE * TILE; e += THREADS) {
      const int x = e % TILE, y = e / TILE;
      const int row = ti * TILE + x, col = tj * TILE + y;
      if (row < n && col < row) s_w[x * PITCH + y] += ct[col * ld_ct + row];
    }
  }
  __syncthreads();

  T acc[N_OUT] = {T(0), T(0), T(0), T(0)};
  for (int e = threadIdx.x; e < TILE * TILE; e += THREADS) {
    const unsigned char k = s_key[e];
    if (k == KEY_ZERO || k == KEY_NOT_POS) {
      const T w = s_w[(e / TILE) * PITCH + e % TILE];
      acc[0] += w;  // M = 1
      if (k == KEY_ZERO) acc[1] += w;
    }
  }
  const int n_sorted = ckt::stable_partition<WARPS, ITEMS>(s_key, TILE * TILE, N_KEYS, s_perm,
                                                           s_cnt, s_total);
  const ckt::DualRow<T> row{s_tab};
  for (int slot = threadIdx.x; slot < n_sorted; slot += THREADS) {
    const int e = s_perm[slot];
    const T w = s_w[(e / TILE) * PITCH + e % TILE];
    T mv, dm_dnu, dm_dls;
    if (ckt::matern_partials_tab(s_x[e], row, mv, dm_dnu, dm_dls)) {
      acc[0] += w * mv;
      if (isfinite(dm_dnu)) acc[2] += w * dm_dnu;
      if (isfinite(dm_dls)) acc[3] += w * dm_dls;
    }  // else M counts as 0 and the entry has no nu, ls terms
  }
  block_partial(acc, part);
}

// One block per output adds the per-tile partials in a fixed order;
// outputs 2 and 3 are scaled by the device value *scale.
__global__ void grad_reduce_kernel(const double* __restrict__ part, long long n_parts,
                                   const double* __restrict__ scale, double* __restrict__ out) {
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
  if (threadIdx.x == 0) out[k] = (k >= 2 ? *scale : 1.0) * ss[0];
}

long long num_tiles(int n, int m, int symmetric) {
  const long long tn = (n + TILE - 1) / TILE;
  const long long tm = (m + TILE - 1) / TILE;
  return symmetric ? tn * (tn + 1) / 2 : tn * tm;
}

template <typename T>
int launch(const T* h, const T* ct, int n, int m, long long ld_h, long long ld_ct,
           int symmetric, const T* table, const double* scale, double* part, double* out,
           cudaStream_t stream) {
  const long long n_tiles = num_tiles(n, m, symmetric);
  const size_t smem = grad_smem<T>();
  cudaError_t err = ckt::allow_smem<grad_kernel<T>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  grad_kernel<T><<<static_cast<unsigned>(n_tiles), THREADS, smem, stream>>>(
      h, ct, n, m, ld_h, ld_ct, symmetric, static_cast<int>((m + TILE - 1) / TILE), table,
      part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  grad_reduce_kernel<<<N_OUT, RED_THREADS, 0, stream>>>(part, n_tiles, scale, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

long long matern_grad_num_tiles(int n, int m, int symmetric) {
  return num_tiles(n, m, symmetric);
}

// h, ct: (n, m) device arrays with unit column stride and row strides ld_h,
// ld_ct (in elements); table: one row of kv.cuh's dual table (2 x TabLayout
// width device values, kernels/cuda_ops.py::recurrence_table); scale: one
// device double; part: 4 * matern_grad_num_tiles doubles of scratch; out: 4
// doubles.
int matern_grad_f32(const float* h, const float* ct, int n, int m, long long ld_h,
                    long long ld_ct, int symmetric, const float* table, const double* scale,
                    double* part, double* out, void* stream) {
  return launch<float>(h, ct, n, m, ld_h, ld_ct, symmetric, table, scale, part, out,
                       static_cast<cudaStream_t>(stream));
}

int matern_grad_f64(const double* h, const double* ct, int n, int m, long long ld_h,
                    long long ld_ct, int symmetric, const double* table, const double* scale,
                    double* part, double* out, void* stream) {
  return launch<double>(h, ct, n, m, ld_h, ld_ct, symmetric, table, scale, part, out,
                        static_cast<cudaStream_t>(stream));
}

const char* matern_grad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
