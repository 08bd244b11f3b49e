// The tiling of a Matern block and the tiled weighted sum over it: the
// skeleton that the block-gradient kernel (matern_grad.cu) and the Hessian
// sums (matern_hess.cu) share; the block forward (matern.cu) and the block
// tangent (matern_hess.cu) take its tile index.
//
// A block is cut into 64 x 64 tiles, one thread block of 256 threads each;
// the symmetric mode launches only the lower-triangle tiles (tj <= ti).
//
// tile_sum_kernel<T, Step> computes per tile the Step::kOut sums
// sum_ij w_ij * term_k(h_ij) of a cotangent ct against per-entry terms of
// the Matern model. The block loads the tile's h (as x = sqrt(2 nu) h / ls)
// and its weight w into shared memory with coalesced row reads; entries at
// h == 0, or not > 0 (NaN), add their constant terms at once
// (Step::constant), the rest are keyed by series or CF2 half-octave of x
// and sorted stably by key (partition.cuh), and thread t evaluates sorted
// slots t, t + 256, ... (Step::entry over a table row of Step::Row in
// shared memory). The symmetric mode takes w = ct[i, j] + ct[j, i] below the
// diagonal (ct[j, i] read along the mirrored tile's rows and added at the
// transposed slot of a padded shared array) and ct[i, i] on it: no n^2
// temporary. Each thread adds its terms in the working type; the block adds
// its threads' sums in double in a fixed order (warp shuffles, then the
// warps in order) into one partial per tile, and tile_reduce_kernel adds the
// per-tile partials in a fixed order: no floating-point atomics, and the
// same sums from run to run. h and ct are read through their row strides
// with bounds checks, so neither is padded or copied.
//
// A Step<T> provides kOut (sums per entry), kRows (values per table column:
// 2 for a dual row, 3 for a second-order row), Row (the row type over
// shared memory), constant(at_zero, w, acc) and entry(x, w, row, acc).
#pragma once

#include <cuda_runtime.h>

#include "kv.cuh"
#include "partition.cuh"

namespace ckt {

constexpr int kTile = 64;
constexpr int kPitch = kTile + 1;  // padded row pitch: transposed accesses miss bank conflicts
constexpr int kTileThreads = 256;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kTileItems = kTile * kTile / kTileThreads;
constexpr int kCf2Bins = 8;
constexpr int kTileKeys = 1 + kCf2Bins;
constexpr int kReduceThreads = 256;
// keys of the entries that skip K_nu (all >= kTileKeys, so left out of the sort)
constexpr unsigned char kKeyZero = 0xfd;    // h == 0
constexpr unsigned char kKeyNotPos = 0xfe;  // h not > 0 otherwise (NaN)

// Tile (ti, tj) of linear block index t: row-major over tiles_m tile
// columns, or over the lower-triangle tiles (tj <= ti) when symmetric.
__device__ __forceinline__ void tile_of(long long t, int symmetric, int tiles_m, int& ti,
                                        int& tj) {
  if (symmetric) {
    ti = static_cast<int>((sqrt(8.0 * static_cast<double>(t) + 1.0) - 1.0) * 0.5);
    while (static_cast<long long>(ti) * (ti + 1) / 2 > t) --ti;
    while (static_cast<long long>(ti + 1) * (ti + 2) / 2 <= t) ++ti;
    tj = static_cast<int>(t - static_cast<long long>(ti) * (ti + 1) / 2);
  } else {
    ti = static_cast<int>(t / tiles_m);
    tj = static_cast<int>(t % tiles_m);
  }
}

inline long long num_tiles(int n, int m, int symmetric) {
  const long long tn = (n + kTile - 1) / kTile;
  const long long tm = (m + kTile - 1) / kTile;
  return symmetric ? tn * (tn + 1) / 2 : tn * tm;
}

// Block sum of each thread's N sums, in double and in a fixed order;
// threads 0 .. N - 1 write the tile's partial.
template <int N, typename T>
__device__ __forceinline__ void block_partial(const T* acc, double* __restrict__ part) {
  __shared__ double warp_sum[kTileWarps][N];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int k = 0; k < N; ++k) {
    double v = static_cast<double>(acc[k]);
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) warp_sum[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    double v = 0.0;
    for (int w = 0; w < kTileWarps; ++w) v += warp_sum[w][threadIdx.x];
    part[static_cast<size_t>(blockIdx.x) * N + threadIdx.x] = v;
  }
}

// Dynamic shared memory of a tile-sum block: the table row, x and the keys
// per entry, the padded weights, the partition's counts and total, the
// sorted indices.
template <typename T, class Step> size_t tile_sum_smem() {
  return sizeof(T) * (Step::kRows * TabLayout<T>::width + kTile * kTile + kTile * kPitch) +
         sizeof(int) * (kTileWarps * kTileKeys + 4) + sizeof(unsigned short) * kTile * kTile +
         kTile * kTile;
}

template <typename T, class Step>
__global__ void __launch_bounds__(kTileThreads)
    tile_sum_kernel(const T* __restrict__ h, const T* __restrict__ ct, int n, int m,
                    long long ld_h, long long ld_ct, int symmetric, int tiles_m,
                    const T* __restrict__ table, double* __restrict__ part) {
  constexpr int W = Step::kRows * TabLayout<T>::width;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_tab = reinterpret_cast<T*>(smem);
  T* s_x = s_tab + W;
  T* s_w = s_x + kTile * kTile;
  int* s_cnt = reinterpret_cast<int*>(s_w + kTile * kPitch);
  int* s_total = s_cnt + kTileWarps * kTileKeys;
  unsigned short* s_perm = reinterpret_cast<unsigned short*>(s_total + 4);
  unsigned char* s_key = reinterpret_cast<unsigned char*>(s_perm + kTile * kTile);
  for (int t = threadIdx.x; t < W; t += kTileThreads) s_tab[t] = table[t];
  int ti, tj;
  tile_of(blockIdx.x, symmetric, tiles_m, ti, tj);
  __syncthreads();
  const typename Step::Row row{s_tab};
  const T sqrt2nu = row.scalar(tab::kSqrt2Nu);
  const T ls = row.scalar(tab::kLs);

  // entry e = (r, c): row ti*kTile + r, column tj*kTile + c, read along rows
  for (int e = threadIdx.x; e < kTile * kTile; e += kTileThreads) {
    const int r = e / kTile, c = e % kTile;
    const int i = ti * kTile + r, j = tj * kTile + c;
    unsigned char key = kNoKey;
    if (i < n && j < m && (!symmetric || j <= i)) {
      const T hv = fabs(h[i * ld_h + j]);
      s_w[r * kPitch + c] = ct[i * ld_ct + j];
      if (hv > T(0)) {
        const T x = sqrt2nu * (hv / ls);
        s_x[e] = x;
        key = static_cast<unsigned char>(x_bucket<kCf2Bins>(x));
      } else {
        key = hv == T(0) ? kKeyZero : kKeyNotPos;
      }
    }
    s_key[e] = key;
  }
  if (symmetric) {
    // ct[j, i] of the entries below the diagonal, read along the mirrored
    // tile's rows: ct[tj*kTile + y, ti*kTile + x] belongs to entry (x, y)
    __syncthreads();
    for (int e = threadIdx.x; e < kTile * kTile; e += kTileThreads) {
      const int x = e % kTile, y = e / kTile;
      const int i = ti * kTile + x, j = tj * kTile + y;
      if (i < n && j < i) s_w[x * kPitch + y] += ct[j * ld_ct + i];
    }
  }
  __syncthreads();

  T acc[Step::kOut];
  for (int k = 0; k < Step::kOut; ++k) acc[k] = T(0);
  for (int e = threadIdx.x; e < kTile * kTile; e += kTileThreads) {
    const unsigned char k = s_key[e];
    if (k == kKeyZero || k == kKeyNotPos) {
      Step::constant(k == kKeyZero, s_w[(e / kTile) * kPitch + e % kTile], acc);
    }
  }
  const int n_sorted = stable_partition<kTileWarps, kTileItems>(s_key, kTile * kTile, kTileKeys,
                                                                s_perm, s_cnt, s_total);
  for (int slot = threadIdx.x; slot < n_sorted; slot += kTileThreads) {
    const int e = s_perm[slot];
    Step::entry(s_x[e], s_w[(e / kTile) * kPitch + e % kTile], row, acc);
  }
  block_partial<Step::kOut>(acc, part);
}

// One block per output adds the per-tile partials in a fixed order; with a
// device value *scale, outputs from scaled_from on are multiplied by it.
template <int N>
__global__ void tile_reduce_kernel(const double* __restrict__ part, long long n_parts,
                                   const double* __restrict__ scale, int scaled_from,
                                   double* __restrict__ out) {
  __shared__ double ss[kReduceThreads];
  const int k = blockIdx.x;
  double s = 0.0;
  for (long long p = threadIdx.x; p < n_parts; p += kReduceThreads) s += part[p * N + k];
  ss[threadIdx.x] = s;
  __syncthreads();
  for (int w = kReduceThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) ss[threadIdx.x] += ss[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[k] = (scale != nullptr && k >= scaled_from) ? *scale * ss[0] : ss[0];
}

// The tile sums and their reduce on `stream`: part holds Step::kOut *
// num_tiles doubles of scratch, out Step::kOut doubles.
template <typename T, class Step>
int launch_tile_sum(const T* h, const T* ct, int n, int m, long long ld_h, long long ld_ct,
                    int symmetric, const T* table, const double* scale, int scaled_from,
                    double* part, double* out, cudaStream_t stream) {
  const long long n_tiles = num_tiles(n, m, symmetric);
  const size_t smem = tile_sum_smem<T, Step>();
  cudaError_t err = allow_smem<tile_sum_kernel<T, Step>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_sum_kernel<T, Step><<<static_cast<unsigned>(n_tiles), kTileThreads, smem, stream>>>(
      h, ct, n, m, ld_h, ld_ct, symmetric, static_cast<int>((m + kTile - 1) / kTile), table,
      part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_reduce_kernel<Step::kOut><<<Step::kOut, kReduceThreads, 0, stream>>>(
      part, n_tiles, scale, scaled_from, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ckt
