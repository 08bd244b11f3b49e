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

// ---- the replicate-batched pass's walk -------------------------------------
//
// variogram.cu's batched pass bins a strip of BATCH_STRIP rows against
// chunks of BATCH_CHUNK columns. Its slot pass sorts each chunk's pairs of
// slot < n_win by slot (pair index e = r BATCH_CHUNK + c, row-major within a
// slot) into `perm`, with slot s at perm[seg[s] .. seg[s + 1]); the dropped
// slot takes no entry.

constexpr int BATCH_STRIP = 64;                         // rows of a strip
constexpr int BATCH_CHUNK = 64;                         // columns of a chunk
constexpr int BATCH_PAIRS = BATCH_STRIP * BATCH_CHUNK;  // pairs of a chunk
constexpr int BATCH_SEG = 32;                           // seg offsets kept per chunk
constexpr int BATCH_RATIO = BATCH_STRIP / BATCH_CHUNK;   // chunks of a strip's height
constexpr int BATCH_SPAN = 8;           // chunks of a strip per walk block
constexpr long long BATCH_LIST = 8192;  // chunks of sorted entries per round (64 MB)
constexpr long long BATCH_SLOTS = 2048; // (strip, span) partials per round

// (x, y) = (p[0], p[1]): on the card one vector load (p is 2-aligned).
__host__ __device__ __forceinline__ void load2(const float* p, float& x, float& y) {
#ifdef __CUDA_ARCH__
  const float2 v = *reinterpret_cast<const float2*>(p);
  x = v.x;
  y = v.y;
#else
  x = p[0];
  y = p[1];
#endif
}
__host__ __device__ __forceinline__ void load2(const double* p, double& x, double& y) {
#ifdef __CUDA_ARCH__
  const double2 v = *reinterpret_cast<const double2*>(p);
  x = v.x;
  y = v.y;
#else
  x = p[0];
  y = p[1];
#endif
}

// One thread's sums over one chunk for the two adjacent replicates pos and
// pos + 1 (pos even): for each slot s < n_win, the clouds of the entries
// perm[seg[s] + first], perm[seg[s] + first + step], ..., with the row values
// row_v[r * width + pos + j] and the column values col_v[c * width + pos + j],
// added in that order in double into one register per replicate and then
// into hist[j][s]. NB >= n_win: hist's length, a constant, so hist stays in
// registers. Every lane of a warp walks the same entries, so the loop bounds
// and the slot are the warp's own.
template <typename T, bool COV, int NB>
__host__ __device__ __forceinline__ void walk_chunk(const unsigned short* perm,
                                                    const unsigned short* seg, int n_win,
                                                    int first, int step, const T* row_v,
                                                    const T* col_v, int pos, int width,
                                                    double (&hist)[2][NB]) {
#pragma unroll
  for (int s = 0; s < NB; ++s) {
    if (s < n_win) {
      double acc0 = 0.0, acc1 = 0.0;
      for (int q = seg[s] + first; q < seg[s + 1]; q += step) {
        const int e = perm[q];
        T a0, a1, v0, v1;
        load2(row_v + (e / BATCH_CHUNK) * width + pos, a0, a1);
        load2(col_v + (e % BATCH_CHUNK) * width + pos, v0, v1);
        acc0 += static_cast<double>(cloud<T, COV>(a0, v0));
        acc1 += static_cast<double>(cloud<T, COV>(a1, v1));
      }
      hist[0][s] += acc0;
      hist[1][s] += acc1;
    }
  }
}

// ---- the batched pass's rounds ---------------------------------------------
//
// The pass runs over the strips of all its variograms in flat order
// (variogram by variogram; dims holds {n, m, marginal, first strip} per
// variogram) in rounds: a round's slot pass writes the sorted entries of its
// strips' chunks to a list that the next round reuses, so the list's scratch
// stays within BATCH_LIST chunks however many points there are, and its walk
// writes one partial per (strip, span of BATCH_SPAN chunks, replicate, slot),
// within BATCH_SLOTS (strip, span) places. A round takes strips in order
// while both fit (the first always), so the rounds, and with them the order
// in which a replicate's partials are added, depend on the strips' shapes
// only, not on the number of replicates or the card.

// Chunks of strip s of a variogram of nc column chunks (from the strip's
// first row for a marginal one), and the chunks of its earlier strips.
__host__ __device__ __forceinline__ void strip_chunks(long long nc, bool marginal, long long s,
                                                      int& count, long long& before) {
  if (marginal) {
    count = static_cast<int>(nc - BATCH_RATIO * s);
    before = s * nc - BATCH_RATIO * s * (s - 1) / 2;
  } else {
    count = static_cast<int>(nc);
    before = s * nc;
  }
}

struct BatchRound {
  long long s_lo, s_hi;  // flat strips [s_lo, s_hi)
  long long c_lo, c_hi;  // their chunks, flat
  int max_chunks;        // the most chunks of one of its strips
  int max_spans;         // the most spans of one of its strips
};

// The round from flat strip s_lo (< the strips of all variograms).
inline BatchRound batch_round(int count, const long long* dims, long long s_lo,
                              long long list_cap, long long slot_cap) {
  BatchRound R{s_lo, s_lo, 0, 0, 0, 0};
  long long strip0 = 0, chunk0 = 0;
  bool started = false;
  for (int p = 0; p < count; ++p) {
    const long long ns = (dims[4 * p] + BATCH_STRIP - 1) / BATCH_STRIP;
    const long long nc = (dims[4 * p + 1] + BATCH_CHUNK - 1) / BATCH_CHUNK;
    const bool marginal = dims[4 * p + 2] != 0;
    for (long long s = s_lo > strip0 ? s_lo - strip0 : 0; s < ns; ++s) {
      int c;
      long long before;
      strip_chunks(nc, marginal, s, c, before);
      const int spans = (c + BATCH_SPAN - 1) / BATCH_SPAN;
      const int max_spans = spans > R.max_spans ? spans : R.max_spans;
      if (!started) {
        R.c_lo = R.c_hi = chunk0 + before;
        started = true;
      } else if (R.c_hi + c - R.c_lo > list_cap ||
                 (R.s_hi - R.s_lo + 1) * max_spans > slot_cap) {
        return R;
      }
      R.s_hi = strip0 + s + 1;
      R.c_hi += c;
      R.max_chunks = c > R.max_chunks ? c : R.max_chunks;
      R.max_spans = max_spans;
    }
    strip0 += ns;
    chunk0 += marginal ? ns * nc - BATCH_RATIO * ns * (ns - 1) / 2 : ns * nc;
  }
  return R;
}

// The list chunks and partial places that the rounds of these variograms
// take at the most (written to out[0], out[1]; at least 1 each).
inline void batch_scratch(int count, const long long* dims, long long* out) {
  long long strips = 0;
  for (int p = 0; p < count; ++p) strips += (dims[4 * p] + BATCH_STRIP - 1) / BATCH_STRIP;
  out[0] = out[1] = 1;
  for (long long s = 0; s < strips;) {
    const BatchRound R = batch_round(count, dims, s, BATCH_LIST, BATCH_SLOTS);
    const long long slots = (R.s_hi - R.s_lo) * R.max_spans;
    if (R.c_hi - R.c_lo > out[0]) out[0] = R.c_hi - R.c_lo;
    if (slots > out[1]) out[1] = slots;
    s = R.s_hi;
  }
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
