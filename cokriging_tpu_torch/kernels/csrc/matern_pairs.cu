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
//             ct[e] dM/dls (kv.cuh::pairs_grad_term), the (n_pairs, 2)
//             cotangents of nu_pairs and ls_pairs; h and idx are data.
// Masks as in the reference: M is 1 where |h| is not > 0, 0 where
// non-finite, clamped >= 0; a gradient term counts only where h > 0, M is
// finite and > 0 and the term itself is finite.
//
// What bounds it: operations. An entry reads h and idx (and ct) and writes
// one value (or nothing), but runs a serial Temme series or Steed CF2 plus
// the order recurrence: hundreds of dependent operations, far above the
// card's operations-per-byte line.
//
// Design, both kernels. The arrays are read flat and contiguous, at any
// length, with no padding or copies. The per-pair recurrence tables
// (n_pairs <= MAX_PAIRS rows of kv.cuh's TabLayout, built on the card by the
// wrapper: value rows for the forward, dual rows holding each column beside
// its d/dmu for the gradient) go to shared memory, so no series or CF2 trip
// divides by a function of mu except CF2's 1/(b + a d). One block of 256
// threads takes a tile of 2,048 contiguous entries: it loads h and idx (and
// ct) with coalesced reads, keeps x = sqrt(2 nu) h / ls (kv.cuh::entry_x)
// of the entries with |h| > 0 in shared memory (and the weight w = ct) and
// keys each by (pair, series or CF2 half-octave of x); partition.cuh sorts
// the tile's local indices by key, stably; thread t then evaluates sorted
// slots t, t + 256, ..., so each warp runs 32 entries of one pair and one
// branch with like CF2 trip counts (the TPU kernels padded (PM, PN) tiles
// and selected the constants per entry by an unrolled compare; unsorted
// points left every warp with both branches and all pairs).
// The forward's values go back to their entries' slots in shared memory and
// leave with one coalesced store (an entry with |h| not > 0 gets M = 1 at
// once). An entry's value depends only on its own h and pair, so the output
// is the same bit for bit under any permutation of the entries.
// The gradient's thread meets its sorted slots in order of pair, so it adds
// one pair's terms in registers, in the working type, and writes the sums
// into its own columns of a shared-memory table when the pair changes
// (each column once: no races, no atomics, no runtime-indexed per-thread
// arrays in local memory); the block then sums each column of that table in
// double, in a fixed order (warp shuffles, then the warps in order), into
// one partial per tile, and a second launch adds the partials in a fixed
// order. The sorted order is a fixed function of the tile's contents, so a
// gradient is the same from run to run.
#include <cuda_runtime.h>

#include "kv.cuh"
#include "partition.cuh"

namespace {

constexpr int MAX_PAIRS = 10;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RED_THREADS = 256;
// a tile: TILE_ITEMS entries per thread
constexpr int TILE_ITEMS = 8;
constexpr int TILE = THREADS * TILE_ITEMS;
// sort buckets per pair: the series and CF2_BINS half-octaves of CF2
constexpr int CF2_BINS = 8;
constexpr int BUCKETS = 1 + CF2_BINS;

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

// Shared memory of the partition: its counts and total, the sorted indices,
// the keys.
size_t sort_smem(int n_pairs) {
  return sizeof(int) * (WARPS * n_pairs * BUCKETS + 4) + sizeof(unsigned short) * TILE + TILE;
}

// Dynamic shared memory of a forward block: the value tables, x (then M) per
// entry, then the partition's.
template <typename T> size_t fwd_smem(int n_pairs) {
  return sizeof(T) * (n_pairs * ckt::TabLayout<T>::width + TILE) + sort_smem(n_pairs);
}

// Dynamic shared memory of a gradient block: the dual tables, x and w per
// entry, each thread's (nu, ls) sums per pair, then the partition's.
template <typename T> size_t grad_smem(int n_pairs) {
  return sizeof(T) * (n_pairs * 2 * ckt::TabLayout<T>::width + 2 * TILE +
                      2 * n_pairs * THREADS) +
         sort_smem(n_pairs);
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
  int* s_cnt = reinterpret_cast<int*>(s_val + TILE);
  int* s_total = s_cnt + WARPS * n_pairs * BUCKETS;
  unsigned short* s_perm = reinterpret_cast<unsigned short*>(s_total + 4);
  unsigned char* s_key = reinterpret_cast<unsigned char*>(s_perm + TILE);
  for (int t = threadIdx.x; t < n_pairs * W; t += THREADS) s_tab[t] = table[t];
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * TILE;
  const int n_tile = static_cast<int>(n - base < TILE ? n - base : TILE);
  for (int e = threadIdx.x; e < TILE; e += THREADS) {
    unsigned char key = ckt::kNoKey;
    if (e < n_tile) {
      const int k = pair_of(idx[base + e], n_pairs);
      T x;
      if (ckt::entry_x(h[base + e], ckt::ValueRow<T>{s_tab + k * W}, x)) {
        s_val[e] = x;
        key = static_cast<unsigned char>(k * BUCKETS + ckt::x_bucket<CF2_BINS>(x));
      } else {
        s_val[e] = T(1);
      }
    }
    s_key[e] = key;
  }
  const int n_sorted = ckt::stable_partition<WARPS, TILE_ITEMS>(
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
__global__ void __launch_bounds__(THREADS)
    pairs_grad_kernel(const T* __restrict__ h, const T* __restrict__ idx,
                      const T* __restrict__ ct, long long n, const T* __restrict__ table,
                      int n_pairs, double* __restrict__ part) {
  constexpr int W2 = 2 * ckt::TabLayout<T>::width;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_tab = reinterpret_cast<T*>(smem);
  T* s_x = s_tab + n_pairs * W2;
  T* s_w = s_x + TILE;
  // s_acc[(2 k + {0, 1}) THREADS + thread]: this thread's (nu, ls) sums of pair k
  T* s_acc = s_w + TILE;
  int* s_cnt = reinterpret_cast<int*>(s_acc + 2 * n_pairs * THREADS);
  int* s_total = s_cnt + WARPS * n_pairs * BUCKETS;
  unsigned short* s_perm = reinterpret_cast<unsigned short*>(s_total + 4);
  unsigned char* s_key = reinterpret_cast<unsigned char*>(s_perm + TILE);
  __shared__ double s_warp[WARPS][2 * MAX_PAIRS];
  const int n_out = 2 * n_pairs;
  for (int t = threadIdx.x; t < n_pairs * W2; t += THREADS) s_tab[t] = table[t];
  for (int o = 0; o < n_out; ++o) s_acc[o * THREADS + threadIdx.x] = T(0);
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * TILE;
  const int n_tile = static_cast<int>(n - base < TILE ? n - base : TILE);
  for (int e = threadIdx.x; e < TILE; e += THREADS) {
    unsigned char key = ckt::kNoKey;
    if (e < n_tile) {
      const int k = pair_of(idx[base + e], n_pairs);
      T x;
      if (ckt::entry_x(h[base + e], ckt::DualRow<T>{s_tab + k * W2}, x)) {
        s_x[e] = x;
        s_w[e] = ct[base + e];
        key = static_cast<unsigned char>(k * BUCKETS + ckt::x_bucket<CF2_BINS>(x));
      }  // else no terms
    }
    s_key[e] = key;
  }
  const int n_sorted = ckt::stable_partition<WARPS, TILE_ITEMS>(
      s_key, n_tile, n_pairs * BUCKETS, s_perm, s_cnt, s_total);
  int cur = -1;
  T a_nu = T(0), a_ls = T(0);
  for (int slot = threadIdx.x; slot < n_sorted; slot += THREADS) {
    const int e = s_perm[slot];
    const int k = s_key[e] / BUCKETS;
    if (k != cur) {  // the sorted pairs only grow: each column is written once
      if (cur >= 0) {
        s_acc[2 * cur * THREADS + threadIdx.x] = a_nu;
        s_acc[(2 * cur + 1) * THREADS + threadIdx.x] = a_ls;
      }
      cur = k;
      a_nu = a_ls = T(0);
    }
    T g_nu, g_ls;
    if (ckt::pairs_grad_term(s_x[e], s_w[e], ckt::DualRow<T>{s_tab + k * W2}, g_nu, g_ls)) {
      a_nu += g_nu;
      a_ls += g_ls;
    }
  }
  if (cur >= 0) {
    s_acc[2 * cur * THREADS + threadIdx.x] = a_nu;
    s_acc[(2 * cur + 1) * THREADS + threadIdx.x] = a_ls;
  }
  // each thread reads only its own column below, so no barrier is needed
  // before the block sums
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 0; o < n_out; ++o) {
    double v = static_cast<double>(s_acc[o * THREADS + threadIdx.x]);
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

long long num_tiles(long long n) { return (n + TILE - 1) / TILE; }

template <typename T>
int launch_fwd(const T* h, const T* idx, long long n, const T* table, int n_pairs,
               int early_exit, T* out, cudaStream_t stream) {
  if (n_pairs < 1 || n_pairs > MAX_PAIRS) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = ckt::allow_smem<pairs_fwd_kernel<T>>(fwd_smem<T>(MAX_PAIRS));
  if (err != cudaSuccess) return static_cast<int>(err);
  pairs_fwd_kernel<T><<<static_cast<unsigned>(num_tiles(n)), THREADS, fwd_smem<T>(n_pairs),
                        stream>>>(h, idx, n, table, n_pairs, early_exit, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_grad(const T* h, const T* idx, const T* ct, long long n, const T* table,
                int n_pairs, double* part, double* out, cudaStream_t stream) {
  if (n_pairs < 1 || n_pairs > MAX_PAIRS) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = ckt::allow_smem<pairs_grad_kernel<T>>(grad_smem<T>(MAX_PAIRS));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = num_tiles(n);
  pairs_grad_kernel<T><<<static_cast<unsigned>(blocks), THREADS, grad_smem<T>(n_pairs),
                         stream>>>(h, idx, ct, n, table, n_pairs, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pairs_reduce_kernel<<<2 * n_pairs, RED_THREADS, 0, stream>>>(part, blocks, 2 * n_pairs, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

long long pairs_grad_blocks(long long n) { return num_tiles(n); }

// h, idx, out: n contiguous device values; table: n_pairs rows of
// matern_table_width (matern.cu) device values (kv.cuh's TabLayout);
// early_exit = 0 runs a degenerate lane's CF2 trips all the same (checks that
// it changes no bit).
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

// h, idx, ct: n contiguous device values; table: n_pairs rows of
// 2 matern_table_width device values (kv.cuh's dual rows); part:
// 2 n_pairs * pairs_grad_blocks(n) doubles of scratch;
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
