// Matern correlation over gathered entries whose (nu, ls) is one of a few
// process pairs, and its per-pair gradient sums, on the card.
//
// Replaces cokriging_tpu/kernels/pallas_ops.py::matern_corr_pairs_pallas
// (pallas_call at :587; _make_pairs_kernel :569, _sel_pairs :560,
// _pairs_table_fwd :602) and ::matern_corr_pairs_grad_pallas (pallas_call at
// :735; _make_pairs_grad_kernel :646, _pairs_table_bwd :751). Entry e of a
// flat array h takes pair k = idx[e] (idx a float plane of values
// 0 .. n_pairs - 1; any other value selects pair 0, as _sel_pairs does):
//   forward:  out[e] = M(nu_k, ls_k, h[e])   (kv.cuh::matern_value_tab)
//   gradient: for every pair k, sum over its entries of ct[e] dM/dnu and
//             ct[e] dM/dls (kv.cuh::matern_partials), the (n_pairs, 2)
//             cotangents of nu_pairs and ls_pairs; h and idx are data.
// Masks as in the reference: M is 1 at h == 0, 0 where non-finite, clamped
// >= 0; a gradient term counts only where h > 0, M is finite and > 0 and the
// term itself is finite.
//
// What bounds it: operations. An entry reads h and idx (and ct) and writes
// one value (or nothing), but runs a serial Temme series or Steed CF2 plus
// the order recurrence: hundreds of dependent operations, far above the
// card's operations-per-byte line.
//
// Forward design. The arrays are read flat and contiguous, at any length,
// with no padding or copies. The per-pair recurrence tables (n_pairs <=
// MAX_PAIRS rows of kv.cuh's TabLayout, built on the card by the wrapper)
// go to shared memory, so no series or CF2 trip divides by a function of mu.
// One block of 256 threads takes a tile of 2,048 contiguous entries: it
// loads h and idx with coalesced reads, writes M = 1 at once where h is not
// > 0, keeps x = sqrt(2 nu) h / ls of the rest in shared memory and keys
// each by (pair, series or CF2 half-octave of x); partition.cuh sorts the
// tile's local indices by key, stably; thread t then evaluates sorted slots
// t, t + 256, ..., so each warp runs 32 entries of one pair and one branch
// with like CF2 trip counts (the TPU kernels padded (PM, PN) tiles and
// selected the constants per entry by an unrolled compare; unsorted points
// left every warp with both branches). Each value goes back to its entry's
// slot in shared memory and leaves with one coalesced store. An entry's
// value depends only on its own h and pair, so the output is the same bit
// for bit under any permutation of the entries.
// The gradient gives each thread ITEMS entries, strided by the block width so
// the loads coalesce; each thread adds its terms per pair in the working type
// into its own column of a shared-memory table (no races, no atomics, no
// runtime-indexed per-thread arrays in local memory); the block then sums
// each column of that table in double, in a fixed order (warp shuffles, then
// the warps in order), into one partial per block, and a second launch adds
// the partials in a fixed order. A gradient is the same from run to run.
#include <cuda_runtime.h>

#include "kv.cuh"
#include "partition.cuh"

namespace {

constexpr int MAX_PAIRS = 10;
constexpr int THREADS = 256;
constexpr int ITEMS = 4;
constexpr int WARPS = THREADS / 32;
constexpr int RED_THREADS = 256;
// the forward's tile: FWD_ITEMS entries per thread
constexpr int FWD_ITEMS = 8;
constexpr int FWD_TILE = THREADS * FWD_ITEMS;
// sort buckets per pair: the series and CF2_BINS half-octaves of CF2
constexpr int CF2_BINS = 8;
constexpr int BUCKETS = 1 + CF2_BINS;
// gradient table row: |nu|, ls, sqrt(2|nu|), mu, gam1, gam2, 1/Gamma(1+mu),
// 1/Gamma(1-mu), their four d/dmu, lgamma(|nu|), digamma(|nu|), nl
constexpr int BWD_COLS = 15;

// the pair of an index value: k where the value equals k (1 <= k < n_pairs),
// else 0
template <typename T>
__device__ __forceinline__ int pair_of(T v, int n_pairs) {
  if (v >= T(1) && v < T(n_pairs)) {
    const int k = static_cast<int>(v);
    if (T(k) == v) return k;
  }
  return 0;
}

// this entry's (ct dM/dnu, ct dM/dls); false where it has no terms
template <typename T>
__device__ __forceinline__ bool grad_entry(T h, T w, const T* c, T& g_nu, T& g_ls) {
  h = fabs(h);
  if (!(h > T(0))) return false;
  const ckt::GamConsts<ckt::Dual<T>> g{ckt::Dual<T>(c[4], c[8]), ckt::Dual<T>(c[5], c[9]),
                                       ckt::Dual<T>(c[6], c[10]), ckt::Dual<T>(c[7], c[11])};
  T m, dm_dnu, dm_dls;
  if (!ckt::matern_partials(h, c[0], c[1], c[2], c[3], static_cast<int>(c[14]), g, c[12],
                            c[13], m, dm_dnu, dm_dls)) {
    return false;
  }
  g_nu = isfinite(dm_dnu) ? w * dm_dnu : T(0);
  g_ls = isfinite(dm_dls) ? w * dm_dls : T(0);
  return true;
}

// Dynamic shared memory of a forward block: the tables, x (then M) per
// entry, the partition's counts and total, the sorted indices, the keys.
template <typename T> size_t fwd_smem(int n_pairs) {
  return sizeof(T) * (n_pairs * ckt::TabLayout<T>::width + FWD_TILE) +
         sizeof(int) * (WARPS * n_pairs * BUCKETS + 4) + sizeof(unsigned short) * FWD_TILE +
         FWD_TILE;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    pairs_fwd_kernel(const T* __restrict__ h, const T* __restrict__ idx, long long n,
                     const T* __restrict__ table, int n_pairs, int early_exit,
                     T* __restrict__ out) {
  constexpr int W = ckt::TabLayout<T>::width;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_tab = reinterpret_cast<T*>(smem);
  T* s_val = s_tab + n_pairs * W;
  int* s_cnt = reinterpret_cast<int*>(s_val + FWD_TILE);
  int* s_total = s_cnt + WARPS * n_pairs * BUCKETS;
  unsigned short* s_perm = reinterpret_cast<unsigned short*>(s_total + 4);
  unsigned char* s_key = reinterpret_cast<unsigned char*>(s_perm + FWD_TILE);
  for (int t = threadIdx.x; t < n_pairs * W; t += THREADS) s_tab[t] = table[t];
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * FWD_TILE;
  const int n_tile = static_cast<int>(n - base < FWD_TILE ? n - base : FWD_TILE);
  for (int e = threadIdx.x; e < FWD_TILE; e += THREADS) {
    unsigned char key = ckt::kNoKey;
    if (e < n_tile) {
      const T hv = fabs(h[base + e]);
      if (hv > T(0)) {
        const int k = pair_of(idx[base + e], n_pairs);
        const T* row = s_tab + k * W;
        const T x = row[ckt::tab::kSqrt2Nu] * (hv / row[ckt::tab::kLs]);
        s_val[e] = x;
        key = static_cast<unsigned char>(k * BUCKETS + ckt::x_bucket<CF2_BINS>(x));
      } else {
        s_val[e] = T(1);
      }
    }
    s_key[e] = key;
  }
  const int n_sorted = ckt::stable_partition<WARPS, FWD_ITEMS>(
      s_key, n_tile, n_pairs * BUCKETS, s_perm, s_cnt, s_total);
  for (int slot = threadIdx.x; slot < n_sorted; slot += THREADS) {
    const int e = s_perm[slot];
    const ckt::ValueRow<T> row{s_tab + (s_key[e] / BUCKETS) * W};
    s_val[e] = ckt::matern_value_tab(s_val[e], row, early_exit != 0);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n_tile; e += THREADS) out[base + e] = s_val[e];
}

template <typename T>
__global__ void pairs_grad_kernel(const T* __restrict__ h, const T* __restrict__ idx,
                                  const T* __restrict__ ct, long long n,
                                  const T* __restrict__ table, int n_pairs,
                                  double* __restrict__ part) {
  __shared__ T s_table[MAX_PAIRS * BWD_COLS];
  // s_acc[2 k + {0, 1}][thread]: this thread's (nu, ls) sums of pair k
  __shared__ T s_acc[2 * MAX_PAIRS][THREADS];
  __shared__ double s_warp[WARPS][2 * MAX_PAIRS];
  const int n_out = 2 * n_pairs;
  for (int t = threadIdx.x; t < n_pairs * BWD_COLS; t += THREADS) s_table[t] = table[t];
  for (int o = 0; o < n_out; ++o) s_acc[o][threadIdx.x] = T(0);
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * (THREADS * ITEMS);
  for (int r = 0; r < ITEMS; ++r) {
    const long long e = base + r * THREADS + threadIdx.x;
    if (e < n) {
      const int k = pair_of(idx[e], n_pairs);
      T g_nu, g_ls;
      if (grad_entry(h[e], ct[e], s_table + k * BWD_COLS, g_nu, g_ls)) {
        s_acc[2 * k][threadIdx.x] += g_nu;
        s_acc[2 * k + 1][threadIdx.x] += g_ls;
      }
    }
  }
  // each thread reads only its own column above, so no barrier is needed
  // before the block sums
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 0; o < n_out; ++o) {
    double v = static_cast<double>(s_acc[o][threadIdx.x]);
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) s_warp[warp][o] = v;
  }
  __syncthreads();
  if (threadIdx.x < n_out) {
    double v = 0.0;
    for (int w = 0; w < WARPS; ++w) v += s_warp[w][threadIdx.x];
    part[static_cast<size_t>(blockIdx.x) * n_out + threadIdx.x] = v;
  }
}

// One block per output adds the per-block partials in a fixed order.
__global__ void pairs_reduce_kernel(const double* __restrict__ part, long long n_parts,
                                    int n_out, double* __restrict__ out) {
  __shared__ double ss[RED_THREADS];
  const int o = blockIdx.x;
  double s = 0.0;
  for (long long p = threadIdx.x; p < n_parts; p += RED_THREADS) s += part[p * n_out + o];
  ss[threadIdx.x] = s;
  __syncthreads();
  for (int w = RED_THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) ss[threadIdx.x] += ss[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[o] = ss[0];
}

long long grad_blocks(long long n) { return (n + THREADS * ITEMS - 1) / (THREADS * ITEMS); }

template <typename T>
int launch_fwd(const T* h, const T* idx, long long n, const T* table, int n_pairs,
               int early_exit, T* out, cudaStream_t stream) {
  if (n_pairs < 1 || n_pairs > MAX_PAIRS) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fwd_smem<T>(n_pairs);
  cudaError_t err = ckt::allow_smem<pairs_fwd_kernel<T>>(fwd_smem<T>(MAX_PAIRS));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + FWD_TILE - 1) / FWD_TILE;
  pairs_fwd_kernel<T><<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      h, idx, n, table, n_pairs, early_exit, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_grad(const T* h, const T* idx, const T* ct, long long n, const T* table,
                int n_pairs, double* part, double* out, cudaStream_t stream) {
  if (n_pairs < 1 || n_pairs > MAX_PAIRS) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = grad_blocks(n);
  pairs_grad_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      h, idx, ct, n, table, n_pairs, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pairs_reduce_kernel<<<2 * n_pairs, RED_THREADS, 0, stream>>>(part, blocks, 2 * n_pairs, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

long long pairs_grad_blocks(long long n) { return grad_blocks(n); }

int pairs_table_width(int f64) {
  return f64 ? ckt::TabLayout<double>::width : ckt::TabLayout<float>::width;
}

// h, idx, out: n contiguous device values; table: n_pairs rows of
// pairs_table_width device values (kv.cuh's TabLayout); early_exit = 0 runs
// a degenerate lane's CF2 trips all the same (checks that it changes no bit).
int pairs_fwd_f32(const float* h, const float* idx, long long n, const float* table,
                  int n_pairs, int early_exit, float* out, void* stream) {
  return launch_fwd<float>(h, idx, n, table, n_pairs, early_exit, out,
                           static_cast<cudaStream_t>(stream));
}

int pairs_fwd_f64(const double* h, const double* idx, long long n, const double* table,
                  int n_pairs, int early_exit, double* out, void* stream) {
  return launch_fwd<double>(h, idx, n, table, n_pairs, early_exit, out,
                            static_cast<cudaStream_t>(stream));
}

// h, idx, ct: n contiguous device values; table: n_pairs x 15 device values
// (see BWD_COLS); part: 2 n_pairs * pairs_grad_blocks(n) doubles of scratch;
// out: 2 n_pairs doubles, (g_nu, g_ls) of pair 0, then pair 1, ...
int pairs_grad_f32(const float* h, const float* idx, const float* ct, long long n,
                   const float* table, int n_pairs, double* part, double* out, void* stream) {
  return launch_grad<float>(h, idx, ct, n, table, n_pairs, part, out,
                            static_cast<cudaStream_t>(stream));
}

int pairs_grad_f64(const double* h, const double* idx, const double* ct, long long n,
                   const double* table, int n_pairs, double* part, double* out, void* stream) {
  return launch_grad<double>(h, idx, ct, n, table, n_pairs, part, out,
                             static_cast<cudaStream_t>(stream));
}

const char* pairs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
