// Per-pair arithmetic of the variogram pair passes (csrc/variogram.cu):
// the distance surrogate h, the bin of a pair without a scan over the
// edges, its cloud value, and the upper-triangle tile map. Every function is
// __host__ __device__, so tests/test_torch_vario_host.py compiles this header
// with g++ (a stub cuda_runtime.h defines the qualifiers away) and holds it
// against the plain torch versions in kernels/cuda_ops.py.
//
// The bin of a pair is searchsorted(edges, h, side="left") - 1 over one
// window of at most MAX_BINS bins, clipped into the first / last bin of all,
// found by a lookup (`bin_count`): the top bits of h (exponent and `m`
// mantissa bits, a monotone function of h >= 0) pick a cell; the host stores
// per cell the number of window edges in earlier cells, which are all < h,
// and `k_cmp` exact compares count the edges inside the cell (each cell holds
// at most k_cmp edges; the host chooses m so that k_cmp is 1 where it can).
// Later cells' edges are >= h. So the count is exact for any h, on an edge
// and one ulp either side included, with no scan.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

namespace ckv {

constexpr int MAX_BINS = 24;                   // bins of one window
constexpr int EDGE_CAP = 2 * (MAX_BINS + 1);   // a window's edges, then +inf
constexpr int MAX_CELLS = 1024;                // lookup cells of one window
constexpr int SLOT_CAP = 32;                   // slot per count 0 .. n_win + 1

// One pair's lookup record for one window, built by the host
// (kernels/cuda_ops.py::_bin_record): an int32 header {shift, cell_lo,
// n_cells, k_cmp}, EDGE_CAP edges of type T, SLOT_CAP bytes `slot` (per
// count of edges < h, the pair's histogram slot: its bin in the window, or
// n_win for a pair that belongs to another window) and MAX_CELLS bytes
// `below` (per cell, the window edges in earlier cells), padded to 16 bytes.
// `below` comes last, so a kernel copies only the first `used(n_cells)`.
template <typename T> struct Record {
  static constexpr int header = 16;
  static constexpr int edges = header;
  static constexpr int slot = edges + EDGE_CAP * static_cast<int>(sizeof(T));
  static constexpr int below = slot + SLOT_CAP;
  static constexpr int bytes = (below + MAX_CELLS + 15) / 16 * 16;
  static constexpr int used(int n_cells) { return (below + n_cells + 15) / 16 * 16; }
};

template <typename T> struct BinLookup {
  const T* edges;
  const unsigned char* below;
  const unsigned char* slot;
  int shift, cell_lo, n_cells, k_cmp;
};

template <typename T>
__host__ __device__ __forceinline__ BinLookup<T> lookup_of(const unsigned char* rec) {
  int head[4];
  memcpy(head, rec, sizeof(head));
  return BinLookup<T>{reinterpret_cast<const T*>(rec + Record<T>::edges), rec + Record<T>::below,
                      rec + Record<T>::slot, head[0], head[1], head[2], head[3]};
}

// ---- explicitly rounded arithmetic ---------------------------------------
// No fused multiply-add: h equals the plain version's h bit for bit, so the
// pair counts of the kernel and the plain version agree exactly.

__host__ __device__ __forceinline__ float mul_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}
__host__ __device__ __forceinline__ double mul_rn(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dmul_rn(a, b);
#else
  return a * b;
#endif
}
__host__ __device__ __forceinline__ float add_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}
__host__ __device__ __forceinline__ double add_rn(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dadd_rn(a, b);
#else
  return a + b;
#endif
}
__host__ __device__ __forceinline__ float sub_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}
__host__ __device__ __forceinline__ double sub_rn(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dsub_rn(a, b);
#else
  return a - b;
#endif
}

// Geodesic features [sin(lat/2), cos(lat/2), sin(lon/2), cos(lon/2), cos(lat)]
// give h = x^2 + cos(lat_a) cos(lat_b) y^2 with x = sin(dlat/2), y = sin(dlon/2);
// Euclidean features [x, y] give the squared distance. h >= +0 or NaN.
template <typename T, bool GEO>
__host__ __device__ __forceinline__ T h_pair(const T* fa, const T* fb) {
  if (GEO) {
    const T x = sub_rn(mul_rn(fa[0], fb[1]), mul_rn(fa[1], fb[0]));
    const T y = sub_rn(mul_rn(fa[2], fb[3]), mul_rn(fa[3], fb[2]));
    return add_rn(mul_rn(x, x), mul_rn(mul_rn(fa[4], fb[4]), mul_rn(y, y)));
  }
  const T dx = sub_rn(fa[0], fb[0]);
  const T dy = sub_rn(fa[1], fb[1]);
  return add_rn(mul_rn(dx, dx), mul_rn(dy, dy));
}

// The cloud of a pair: 0.5 (a - b)^2, or a b for a covariogram.
template <typename T, bool COV>
__host__ __device__ __forceinline__ T cloud(T a, T b) {
  if (COV) return mul_rn(a, b);
  const T d = sub_rn(a, b);
  return mul_rn(mul_rn(T(0.5), d), d);
}

// ---- the bin of a pair ----------------------------------------------------

// The top 32 bits of h: for h >= +0 a non-decreasing function of h.
__host__ __device__ __forceinline__ unsigned key_bits(float h) {
  unsigned u;
  memcpy(&u, &h, sizeof(u));
  return u;
}
__host__ __device__ __forceinline__ unsigned key_bits(double h) {
  unsigned long long u;
  memcpy(&u, &h, sizeof(u));
  return static_cast<unsigned>(u >> 32);
}

// #(window edges < h), for h >= +0. K > 0: exactly K compares (the kernels'
// common case, K = 1); K == 0: L.k_cmp compares.
template <int K, typename T>
__host__ __device__ __forceinline__ int bin_count(T h, const BinLookup<T>& L) {
  const int last = L.n_cells - 1;
  int c = static_cast<int>(key_bits(h) >> L.shift) - L.cell_lo;
  c = c > 0 ? c : 0;
  c = c < last ? c : last;
  const int base = L.below[c];
  int count = base;
  const int k_cmp = K > 0 ? K : L.k_cmp;
#pragma unroll
  for (int t = 0; t < k_cmp; ++t) count += L.edges[base + t] < h ? 1 : 0;
  return count;
}

// The histogram slot of a pair: its bin in the window, or n_win (never read)
// for a pair that is not valid or belongs to another window.
template <int K, typename T>
__host__ __device__ __forceinline__ int bin_slot(T h, bool valid, const BinLookup<T>& L,
                                                 int n_win) {
  const int s = L.slot[bin_count<K>(h, L)];
  return valid ? s : n_win;
}

// ---- the upper-triangle tile map ------------------------------------------

// Tile t of a marginal pair's nr x nr tile grid, row by row over the tiles
// with cb >= rb: row rb starts at off(rb) = rb nr - rb (rb - 1) / 2. The
// closed form, then at most a step either way for the rounding of sqrt.
__host__ __device__ __forceinline__ void tri_coords(long long t, int nr, int& rb, int& cb) {
  const double b = 2.0 * nr + 1.0;
  int r = static_cast<int>(0.5 * (b - sqrt(b * b - 8.0 * static_cast<double>(t))));
  r = r < 0 ? 0 : (r > nr - 1 ? nr - 1 : r);
  const long long n = nr;
  while (r > 0 && r * n - static_cast<long long>(r) * (r - 1) / 2 > t) --r;
  while (r + 1 < nr && (r + 1) * n - static_cast<long long>(r + 1) * r / 2 <= t) ++r;
  rb = r;
  cb = r + static_cast<int>(t - (r * n - static_cast<long long>(r) * (r - 1) / 2));
}

}  // namespace ckv
