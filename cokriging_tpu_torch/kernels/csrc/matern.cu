// Matern correlation over a distance block, on the card.
//
// Replaces cokriging_tpu/kernels/pallas_ops.py::matern_correlation_pallas
// (pallas_call at :310; _matern_kernel :272, _matern_kernel_sym :277,
// _matern_tile :243):
//     M = 2^{1-nu} / Gamma(nu) * a^nu * K_nu(a),  a = sqrt(2 nu) h / ls,
// 1 where |h| is not > 0 (zero or NaN), 0 where non-finite, clamped >= 0.
//
// What bounds it: operations. Each entry reads 4 or 8 bytes and writes as
// many, but runs a serial Temme series (12 / 40 trips) or Steed CF2 (up to
// 18 / 80 trips) plus the order recurrence: hundreds of dependent
// multiply-adds per entry, far above the card's operations-per-byte line.
//
// Design: one block of 256 threads per 64 x 64 tile. The block loads the
// tile's h with coalesced row reads into a padded shared array; entries
// whose |h| is not > 0 get M = 1 at once, the rest a key, series or CF2
// half-octave of their x = sqrt(2 nu) h / ls (kv.cuh::entry_x).
// partition.cuh sorts the tile's local indices by key, stably, and thread t
// evaluates sorted slots t, t + 256, ...: a warp runs one branch with like
// CF2 trip counts, where the spatially unsorted points of a month left most
// warps with both branches. The arithmetic is kv.cuh's per-entry
// matern_entry_tab (entry_x, then the table-driven matern_value_tab) over
// the per-(nu, ls) value row (built on the card by the wrapper,
// kernels/cuda_ops.py::recurrence_table, read into shared memory), so no
// series or CF2 trip divides except CF2's 1/(b + a d);
// half-integer orders leave CF2 after its setup, which changes no bit. Each
// value goes back to its entry's slot and leaves with one coalesced store.
// An entry's value depends only on its own h, so the output is the same bit
// for bit under any permutation of h's rows and columns taken together.
// The symmetric mode launches only the lower-triangle tiles and stores
// each value at (i, j) and, through the shared tile read transposed (its
// padded pitch spares the transposed reads bank conflicts), at (j, i): both
// stores coalesce, no mirror pass or n^2 temporary exists, and the output is
// exactly symmetric and equal bit for bit to the full mode's lower triangle
// (one kernel serves both modes, so both run one compiled entry step).
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

// Dynamic shared memory of a block: the value row, h (then M) per entry in
// the padded tile, the partition's counts and total, the sorted indices,
// the keys.
template <typename T> size_t fwd_smem() {
  return sizeof(T) * (ckt::TabLayout<T>::width + TILE * PITCH) +
         sizeof(int) * (WARPS * N_KEYS + 4) + sizeof(unsigned short) * TILE * TILE +
         TILE * TILE;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    matern_kernel(const T* __restrict__ h, int n, int m, int symmetric, int tiles_m,
                  const T* __restrict__ table, int early_exit, T* __restrict__ out) {
  constexpr int W = ckt::TabLayout<T>::width;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_tab = reinterpret_cast<T*>(smem);
  T* s_val = s_tab + W;
  int* s_cnt = reinterpret_cast<int*>(s_val + TILE * PITCH);
  int* s_total = s_cnt + WARPS * N_KEYS;
  unsigned short* s_perm = reinterpret_cast<unsigned short*>(s_total + 4);
  unsigned char* s_key = reinterpret_cast<unsigned char*>(s_perm + TILE * TILE);
  for (int t = threadIdx.x; t < W; t += THREADS) s_tab[t] = table[t];

  int ti, tj;
  ckt::tile_of(blockIdx.x, symmetric, tiles_m, ti, tj);
  __syncthreads();
  const ckt::ValueRow<T> row{s_tab};

  // entry e = (r, c): row ti*TILE + r, column tj*TILE + c, read along rows
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
        s_val[r * PITCH + c] = T(1);
      }
    }
    s_key[e] = key;
  }
  const int n_sorted =
      ckt::stable_partition<WARPS, ITEMS>(s_key, TILE * TILE, N_KEYS, s_perm, s_cnt, s_total);
  for (int slot = threadIdx.x; slot < n_sorted; slot += THREADS) {
    const int e = s_perm[slot];
    T& v = s_val[(e / TILE) * PITCH + e % TILE];
    v = ckt::matern_entry_tab(v, row, early_exit != 0);
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
    // entry (x, y) of the tile, row ti*TILE + x and column tj*TILE + y, also
    // goes to (tj*TILE + y, ti*TILE + x): consecutive threads take
    // consecutive x, so the store runs along a row of out
    for (int e = threadIdx.x; e < TILE * TILE; e += THREADS) {
      const int x = e % TILE, y = e / TILE;
      const int i = ti * TILE + x, j = tj * TILE + y;
      if (i < n && j < i) out[static_cast<size_t>(j) * n + i] = s_val[x * PITCH + y];
    }
  }
}

template <typename T>
int launch(const T* h, int n, int m, int symmetric, const T* table, int early_exit, T* out,
           cudaStream_t stream) {
  const size_t smem = fwd_smem<T>();
  cudaError_t err = ckt::allow_smem<matern_kernel<T>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  matern_kernel<T><<<static_cast<unsigned>(ckt::num_tiles(n, m, symmetric)), THREADS, smem,
                     stream>>>(h, n, m, symmetric, static_cast<int>((m + TILE - 1) / TILE),
                               table, early_exit, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int matern_table_width(int f64) {
  return f64 ? ckt::TabLayout<double>::width : ckt::TabLayout<float>::width;
}

// h, out: contiguous (n, m) device arrays (square when symmetric); table: one
// row of kv.cuh's value table (matern_table_width device values,
// kernels/cuda_ops.py::recurrence_table); early_exit = 0 runs a degenerate
// lane's CF2 trips all the same (checks that it changes no bit).
int matern_f32(const float* h, int n, int m, int symmetric, const float* table, int early_exit,
               float* out, void* stream) {
  return launch<float>(h, n, m, symmetric, table, early_exit, out,
                       static_cast<cudaStream_t>(stream));
}

int matern_f64(const double* h, int n, int m, int symmetric, const double* table,
               int early_exit, double* out, void* stream) {
  return launch<double>(h, n, m, symmetric, table, early_exit, out,
                        static_cast<cudaStream_t>(stream));
}

const char* matern_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
