// Empirical (cross-)variogram pair passes, on the card: one launch per pass
// over every pair of variograms of a call.
//
// Replaces cokriging_tpu/kernels/pallas_ops.py::variogram_bin_pallas
// (pallas_call at :117, _make_kernel :58), built to the contract of
// cokriging_tpu/estimate/empirical.py::_all_pairs_program (:240-406), which
// is one program over all the variograms: all comparisons run on the
// monotone distance surrogate h (haversine sin^2-term or squared Euclidean
// distance) formed from per-point features, with the thresholds moved into
// h once on the host.
//   - minmax: per variogram, min of h over valid pairs with h > h_snap and
//     max of h over valid pairs (pass 1, :308-340);
//   - bin: the cloud 0.5 (va - vb)^2 or va vb, bin = #(h_edges < h) - 1
//     clipped (searchsorted side="left", :381-383), per-bin sums (double)
//     and counts (int64) (pass 2, :363-398).
// A pair is valid when row < n, col < m, h <= h_max and, for a marginal
// variogram, row < col. The per-pair arithmetic lives in vario.cuh.
//
// Design. The grid is one flat index over the tiles of all the call's
// variograms (`Pairs::tile0`, prefix sums from the host); a block finds its
// variogram and, for a marginal one, its upper-triangle tile in closed form
// (`tri_coords`). A tile is TILE x TILE pairs: each of the block's NT
// threads owns CPT columns in registers, and the tile's rows sit in shared
// memory (features and value; pass 2 stages STAGE rows at a time), so one
// broadcast load of a row serves CPT pairs. No pair branches: rows past n
// and columns past m are NaN points (h is NaN, not <= h_max), a pair beyond
// h_max or outside the window goes to histogram slot n_win, which is never
// read, and only the diagonal tiles of a marginal variogram test row < col.
// The bin comes from `bin_count`'s lookup (the cell of h's top bits, then
// one exact compare in the common case) instead of a compare per edge. h is
// formed with explicitly rounded operations (no fused multiply-add), so it
// equals the plain torch version's h bit for bit and the counts agree
// exactly.
//
// Sums go into per-thread columns of a shared-memory histogram (no atomics;
// double sums, 16-bit counts: a thread bins at most TILE x CPT pairs of a
// tile), and each tile adds its columns up in a fixed order; a second launch
// adds each variogram's tile partials in a fixed order. So the sums are the
// same from run to run, and so is the fit built on them. The histogram holds
// one window of at most MAX_BINS bins (plus the dropped slot); the caller
// walks the windows, one bin launch per window.
//
// The replicate-batched bin pass (bin_batch_kernel) bins B value replicates
// over one set of pairs: the parametric bootstrap's re-estimate, which the
// reference runs as jnp (cokriging_tpu/estimate/bootstrap.py::
// _batched_bin_program, :93-176). A block takes a strip of STRIP rows of one
// variogram and a group of BNT replicates, one per thread. Per chunk of
// CHUNK columns its threads first compute each pair's h and histogram slot
// once, into shared memory (and, in the first replicate group, its count);
// then every thread walks the chunk's pairs for its own replicate: the row
// value from device memory (values are (n, B), so a warp's loads are
// contiguous), the column values in registers, the pair's slot a broadcast
// read, and the cloud added into the thread's own histogram column (no
// atomics; all lanes of a warp share the slot, so the column reads and
// writes are contiguous). Each thread's column is its replicate's partial of
// the strip; a second launch adds each variogram's strip partials in a fixed
// order. What bounds it: the shared-memory read-modify-write of a double per
// pair and replicate, beside ~9 instructions for the cloud and the slot.
//
// What bounds it: instruction issue, and in pass 2 the shared-memory pipe
// beside it. No pair reads device memory (a block reads 2 x TILE points). A
// pair costs 11 explicitly rounded operations for h; pass 1 adds ~6 compares
// and selects, pass 2 ~25 instructions: the lookup and its compare, the
// slot, the cloud and its conversion to double, and a read-modify-write of
// a double and a count in shared memory (with the lookup's three loads, ~9
// shared-memory wavefronts per warp of pairs). The floating-point rate is
// not the limit: a bound taken at 67 TFLOP/s counts a fused multiply-add as
// two operations, and these passes have none.
#include "vario.cuh"

namespace {

using ckv::BinLookup;
using ckv::Record;

constexpr int NT = 64;            // threads per block
constexpr int CPT = 4;            // columns per thread
constexpr int TILE = NT * CPT;    // rows and columns of a tile
constexpr int STAGE = 128;        // rows staged in shared memory at a time
constexpr int RED_THREADS = 256;
constexpr int MAX_PAIRS = 32;     // variograms per launch

template <typename T> struct Pairs {
  const T* fa[MAX_PAIRS];
  const T* fb[MAX_PAIRS];
  const T* va[MAX_PAIRS];
  const T* vb[MAX_PAIRS];
  int n[MAX_PAIRS];
  int m[MAX_PAIRS];
  int marginal[MAX_PAIRS];
  long long tile0[MAX_PAIRS + 1];  // first tile of each variogram; then the total
  int count;
};

template <typename T> __device__ __forceinline__ T nan_of();
template <> __device__ __forceinline__ float nan_of<float>() { return __int_as_float(0x7fc00000); }
template <> __device__ __forceinline__ double nan_of<double>() {
  return __longlong_as_double(0x7ff8000000000000ll);
}

struct Tile {
  int pair, r0, c0, diag;
};

// The variogram, first row and first column of flat tile t.
template <typename T>
__device__ __forceinline__ Tile tile_at(const Pairs<T>& P, long long t) {
  int p = 0;
  while (p + 1 < P.count && P.tile0[p + 1] <= t) ++p;
  const long long local = t - P.tile0[p];
  const int nr = (P.n[p] + TILE - 1) / TILE;
  int rb, cb;
  if (P.marginal[p]) {
    ckv::tri_coords(local, nr, rb, cb);
  } else {
    const int nc = (P.m[p] + TILE - 1) / TILE;
    rb = static_cast<int>(local / nc);
    cb = static_cast<int>(local % nc);
  }
  return Tile{p, rb * TILE, cb * TILE, P.marginal[p] && rb == cb};
}

// Stages rows r0 .. r0 + STAGE - 1 at srow[r * RS]: F features, then the
// value when `va` is given (RS >= F + 1 then); rows past n are NaN points.
template <typename T, int F, int RS>
__device__ __forceinline__ void stage_rows(T* srow, const T* fa, const T* va, int n, int r0) {
  for (int r = threadIdx.x; r < STAGE; r += NT) {
    const int row = r0 + r;
    const bool in = row < n;
#pragma unroll
    for (int f = 0; f < F; ++f)
      srow[r * RS + f] = in ? fa[static_cast<size_t>(row) * F + f] : nan_of<T>();
    if (va != nullptr) srow[r * RS + F] = in ? va[row] : T(0);
  }
}

// This thread's CPT columns c0 + threadIdx.x + k NT: features (NaN past m)
// and values.
template <typename T, int F>
__device__ __forceinline__ void load_cols(T (&cf)[CPT][F], T (&cv)[CPT], const T* fb,
                                          const T* vb, int m, int c0) {
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int col = c0 + threadIdx.x + k * NT;
    const bool in = col < m;
#pragma unroll
    for (int f = 0; f < F; ++f)
      cf[k][f] = in ? fb[static_cast<size_t>(col) * F + f] : nan_of<T>();
    cv[k] = (in && vb != nullptr) ? vb[col] : T(0);
  }
}

template <typename T> __device__ __forceinline__ T warp_min(T v) {
  for (int o = 16; o > 0; o >>= 1) v = fmin(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}
template <typename T> __device__ __forceinline__ T warp_max(T v) {
  for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// ---- pass 1 ---------------------------------------------------------------

// acc = max(acc, v) / min(acc, v) where `take`: fmax / fmin for float; a
// compare and select for double, whose fmin / fmax cost a NaN fix-up each.
__device__ __forceinline__ float take_max(float acc, float v, bool take) {
  return fmaxf(acc, take ? v : -INFINITY);
}
__device__ __forceinline__ double take_max(double acc, double v, bool take) {
  return (take && v > acc) ? v : acc;
}
__device__ __forceinline__ float take_min(float acc, float v, bool take) {
  return fminf(acc, take ? v : INFINITY);
}
__device__ __forceinline__ double take_min(double acc, double v, bool take) {
  return (take && v < acc) ? v : acc;
}

// The tile's first `rows` rows, staged at srow[r * RS].
template <typename T, bool GEO, bool DIAG, int RS>
__device__ __forceinline__ void minmax_rows(const T* srow, const T (&cf)[CPT][GEO ? 5 : 2],
                                            int rows, T h_max, T h_snap, T& hmin, T& hmax) {
  constexpr int F = GEO ? 5 : 2;
  for (int r = 0; r < rows; ++r) {
    T rf[F];
#pragma unroll
    for (int f = 0; f < F; ++f) rf[f] = srow[r * RS + f];
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const T h = ckv::h_pair<T, GEO>(rf, cf[k]);
      bool valid = h <= h_max;
      if (DIAG) valid = valid && r < static_cast<int>(threadIdx.x) + k * NT;
      hmax = take_max(hmax, h, valid);
      hmin = take_min(hmin, h, valid && h > h_snap);
    }
  }
}

template <typename T, bool GEO>
__global__ void __launch_bounds__(NT) minmax_kernel(const __grid_constant__ Pairs<T> P, T h_max,
                                                    T h_snap, T* __restrict__ part_min,
                                                    T* __restrict__ part_max) {
  constexpr int F = GEO ? 5 : 2;
  constexpr int RS = GEO ? 8 : 2;  // 16-byte rows: one vector load of 4 features
  __shared__ __align__(16) T srow[TILE * RS];  // the whole tile's rows
  __shared__ T wmin[NT / 32];
  __shared__ T wmax[NT / 32];
  const Tile at = tile_at(P, blockIdx.x);
  const int n = P.n[at.pair];
  for (int r0 = 0; r0 < TILE; r0 += STAGE)
    stage_rows<T, F, RS>(srow + r0 * RS, P.fa[at.pair], nullptr, n, at.r0 + r0);
  T cf[CPT][F];
  T cv[CPT];
  load_cols<T, F>(cf, cv, P.fb[at.pair], nullptr, P.m[at.pair], at.c0);
  __syncthreads();
  const int rows = n - at.r0 < TILE ? n - at.r0 : TILE;
  T hmin = INFINITY;
  T hmax = -INFINITY;
  if (at.diag) {
    minmax_rows<T, GEO, true, RS>(srow, cf, rows, h_max, h_snap, hmin, hmax);
  } else {
    minmax_rows<T, GEO, false, RS>(srow, cf, rows, h_max, h_snap, hmin, hmax);
  }
  hmin = warp_min(hmin);
  hmax = warp_max(hmax);
  const int tid = threadIdx.x;
  if ((tid & 31) == 0) {
    wmin[tid >> 5] = hmin;
    wmax[tid >> 5] = hmax;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < NT / 32; ++w) {
      hmin = fmin(hmin, wmin[w]);
      hmax = fmax(hmax, wmax[w]);
    }
    part_min[blockIdx.x] = hmin;
    part_max[blockIdx.x] = hmax;
  }
}

// One block per variogram: [min, max] of its tiles' partials into out[2 p],
// out[2 p + 1] (inf / -inf for a variogram without tiles).
template <typename T>
__global__ void minmax_reduce_kernel(const __grid_constant__ Pairs<T> P,
                                     const T* __restrict__ part_min,
                                     const T* __restrict__ part_max, T* __restrict__ out) {
  __shared__ T smin[RED_THREADS / 32];
  __shared__ T smax[RED_THREADS / 32];
  const int p = blockIdx.x;
  T hmin = INFINITY;
  T hmax = -INFINITY;
  for (long long k = P.tile0[p] + threadIdx.x; k < P.tile0[p + 1]; k += RED_THREADS) {
    hmin = fmin(hmin, part_min[k]);
    hmax = fmax(hmax, part_max[k]);
  }
  hmin = warp_min(hmin);
  hmax = warp_max(hmax);
  if ((threadIdx.x & 31) == 0) {
    smin[threadIdx.x >> 5] = hmin;
    smax[threadIdx.x >> 5] = hmax;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < RED_THREADS / 32; ++w) {
      hmin = fmin(hmin, smin[w]);
      hmax = fmax(hmax, smax[w]);
    }
    out[2 * p] = hmin;
    out[2 * p + 1] = hmax;
  }
}

// ---- pass 2 ---------------------------------------------------------------

// Rows [r_lo, r_hi) of the tile, staged from r_lo at srow; hsum / hcnt: this
// thread's histogram column, slot s at [s * NT].
template <typename T, bool GEO, bool COV, bool DIAG, int K>
__device__ __forceinline__ void bin_rows(const T* srow, const T (&cf)[CPT][GEO ? 5 : 2],
                                         const T (&cv)[CPT], int r_lo, int r_hi, T h_max,
                                         const BinLookup<T>& L, int n_win,
                                         double* __restrict__ hsum,
                                         unsigned short* __restrict__ hcnt) {
  constexpr int F = GEO ? 5 : 2;
  const int tid = threadIdx.x;
  for (int r = r_lo; r < r_hi; ++r) {
    T rf[F + 1];
#pragma unroll
    for (int f = 0; f <= F; ++f) rf[f] = srow[(r - r_lo) * (F + 1) + f];
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const T h = ckv::h_pair<T, GEO>(rf, cf[k]);
      bool valid = h <= h_max;
      if (DIAG) valid = valid && r < tid + k * NT;
      const int s = ckv::bin_slot<K>(h, valid, L, n_win) * NT;
      hsum[s] += static_cast<double>(ckv::cloud<T, COV>(rf[F], cv[k]));
      hcnt[s] += 1;
    }
  }
}

template <typename T, bool GEO, bool COV, int K>
__global__ void __launch_bounds__(NT) bin_kernel(const __grid_constant__ Pairs<T> P,
                                                 const unsigned char* __restrict__ records,
                                                 int rec_used, int n_win, T h_max,
                                                 double* __restrict__ part_sums,
                                                 long long* __restrict__ part_counts) {
  // records: one Record<T> per variogram for this window, of which the
  // first rec_used bytes are read. Dynamic shared memory: the histogram's
  // sums [n_win + 1][NT], the record, the counts [n_win + 1][NT] (16 bits:
  // a thread bins at most TILE x CPT pairs of a tile)
  constexpr int F = GEO ? 5 : 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* hsum = reinterpret_cast<double*>(smem_raw);
  unsigned char* srec = smem_raw + (n_win + 1) * NT * sizeof(double);
  unsigned short* hcnt = reinterpret_cast<unsigned short*>(srec + rec_used);
  __shared__ __align__(16) T srow[STAGE * (F + 1)];

  const Tile at = tile_at(P, blockIdx.x);
  const int tid = threadIdx.x;
  const int n = P.n[at.pair];
  const uint4* rec = reinterpret_cast<const uint4*>(records + static_cast<size_t>(at.pair) *
                                                                  Record<T>::bytes);
  for (int k = tid; k < rec_used / 16; k += NT) reinterpret_cast<uint4*>(srec)[k] = rec[k];
  for (int k = tid; k < (n_win + 1) * NT; k += NT) {
    hsum[k] = 0.0;
    hcnt[k] = 0;
  }
  T cf[CPT][F];
  T cv[CPT];
  load_cols<T, F>(cf, cv, P.fb[at.pair], P.vb[at.pair], P.m[at.pair], at.c0);
  __syncthreads();
  const BinLookup<T> L = ckv::lookup_of<T>(srec);
  const int rows = n - at.r0 < TILE ? n - at.r0 : TILE;
  for (int r_lo = 0; r_lo < rows; r_lo += STAGE) {
    __syncthreads();
    stage_rows<T, F, F + 1>(srow, P.fa[at.pair], P.va[at.pair], n, at.r0 + r_lo);
    __syncthreads();
    const int r_hi = rows - r_lo < STAGE ? rows : r_lo + STAGE;
    if (at.diag) {
      bin_rows<T, GEO, COV, true, K>(srow, cf, cv, r_lo, r_hi, h_max, L, n_win, hsum + tid,
                                     hcnt + tid);
    } else {
      bin_rows<T, GEO, COV, false, K>(srow, cf, cv, r_lo, r_hi, h_max, L, n_win, hsum + tid,
                                      hcnt + tid);
    }
  }
  __syncthreads();
  // per-bin tile sums in a fixed order: warp w takes bins w, w + NT / 32, ...
  const int lane = tid & 31;
  for (int b = tid >> 5; b < n_win; b += NT / 32) {
    double s = 0.0;
    long long c = 0;
    for (int k = lane; k < NT; k += 32) {
      s += hsum[b * NT + k];
      c += hcnt[b * NT + k];
    }
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, o);
      c += __shfl_down_sync(0xffffffffu, c, o);
    }
    if (lane == 0) {
      part_sums[static_cast<size_t>(blockIdx.x) * n_win + b] = s;
      part_counts[static_cast<size_t>(blockIdx.x) * n_win + b] = c;
    }
  }
}

// Block (b, p) adds variogram p's tile partials of window bin b in a fixed
// order into sums / counts [p * stride + b] (0 for a variogram without tiles).
template <typename T>
__global__ void bin_reduce_kernel(const __grid_constant__ Pairs<T> P,
                                  const double* __restrict__ part_sums,
                                  const long long* __restrict__ part_counts, int n_win,
                                  double* __restrict__ sums, long long* __restrict__ counts,
                                  int stride) {
  __shared__ double ss[RED_THREADS];
  __shared__ long long sc[RED_THREADS];
  const int b = blockIdx.x;
  const int p = blockIdx.y;
  double s = 0.0;
  long long c = 0;
  for (long long k = P.tile0[p] + threadIdx.x; k < P.tile0[p + 1]; k += RED_THREADS) {
    s += part_sums[k * n_win + b];
    c += part_counts[k * n_win + b];
  }
  ss[threadIdx.x] = s;
  sc[threadIdx.x] = c;
  __syncthreads();
  for (int w = RED_THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) {
      ss[threadIdx.x] += ss[threadIdx.x + w];
      sc[threadIdx.x] += sc[threadIdx.x + w];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    sums[static_cast<size_t>(p) * stride + b] = ss[0];
    counts[static_cast<size_t>(p) * stride + b] = sc[0];
  }
}


// ---- replicate-batched pass 2 ---------------------------------------------

constexpr int BNT = 64;     // threads, one replicate each, per block of the batched pass
constexpr int STRIP = 64;   // rows of a strip
constexpr int CHUNK = 32;   // columns of a chunk (two 16-byte rows of slots)

// The variogram and first row of flat strip s (`tile0` holds first strips).
template <typename T>
__device__ __forceinline__ int2 strip_at(const Pairs<T>& P, long long s) {
  int p = 0;
  while (p + 1 < P.count && P.tile0[p + 1] <= s) ++p;
  return make_int2(p, static_cast<int>((s - P.tile0[p]) * STRIP));
}

template <typename T, bool GEO, bool COV, int K>
__global__ void __launch_bounds__(BNT) bin_batch_kernel(const __grid_constant__ Pairs<T> P,
                                                        const unsigned char* __restrict__ records,
                                                        int rec_used, int n_win, T h_max,
                                                        int n_rep,
                                                        double* __restrict__ part_sums,
                                                        long long* __restrict__ part_counts) {
  // Dynamic shared memory: the histogram's sums [n_win + 1][BNT], its counts
  // [n_win + 1][BNT] (the first replicate group only), the record. va / vb
  // are (n, n_rep) / (m, n_rep) row-major.
  constexpr int F = GEO ? 5 : 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* hsum = reinterpret_cast<double*>(smem_raw);
  unsigned* hcnt = reinterpret_cast<unsigned*>(hsum + (n_win + 1) * BNT);
  unsigned char* srec = reinterpret_cast<unsigned char*>(hcnt + (n_win + 1) * BNT);
  __shared__ __align__(16) T srow[STRIP * F];
  __shared__ __align__(16) T scol[CHUNK * F];
  __shared__ __align__(16) unsigned char sslot[STRIP * CHUNK];

  const int2 at = strip_at(P, blockIdx.x);
  const int pair = at.x, r0 = at.y;
  const int tid = threadIdx.x;
  const int n = P.n[pair], m = P.m[pair];
  const bool marginal = P.marginal[pair] != 0;
  const bool counting = blockIdx.y == 0;
  const int b = blockIdx.y * BNT + tid;
  const bool live = b < n_rep;
  const T* __restrict__ fa = P.fa[pair];
  const T* __restrict__ fb = P.fb[pair];
  const T* __restrict__ va = P.va[pair];
  const T* __restrict__ vb = P.vb[pair];

  const uint4* rec = reinterpret_cast<const uint4*>(records + static_cast<size_t>(pair) *
                                                                  Record<T>::bytes);
  for (int k = tid; k < rec_used / 16; k += BNT) reinterpret_cast<uint4*>(srec)[k] = rec[k];
  for (int k = tid; k < (n_win + 1) * BNT; k += BNT) {
    hsum[k] = 0.0;
    hcnt[k] = 0;
  }
  for (int k = tid; k < STRIP * F; k += BNT) {
    const int row = r0 + k / F;
    srow[k] = row < n ? fa[static_cast<size_t>(row) * F + k % F] : nan_of<T>();
  }
  __syncthreads();
  const BinLookup<T> L = ckv::lookup_of<T>(srec);
  const int rows = n - r0 < STRIP ? n - r0 : STRIP;
  // a marginal strip's pairs lie right of its first row (STRIP is a
  // multiple of CHUNK, so its chunks start there)
  for (int c0 = marginal ? r0 : 0; c0 < m; c0 += CHUNK) {
    __syncthreads();  // the previous chunk's slots are consumed
    for (int k = tid; k < CHUNK * F; k += BNT) {
      const int col = c0 + k / F;
      scol[k] = col < m ? fb[static_cast<size_t>(col) * F + k % F] : nan_of<T>();
    }
    __syncthreads();
    // each pair's slot, once for all replicates
    for (int q = tid; q < STRIP * CHUNK; q += BNT) {
      const int r = q / CHUNK, c = q % CHUNK;
      const T h = ckv::h_pair<T, GEO>(srow + r * F, scol + c * F);
      bool valid = h <= h_max;
      if (marginal) valid = valid && r0 + r < c0 + c;
      const int s = ckv::bin_slot<K>(h, valid, L, n_win);
      sslot[q] = static_cast<unsigned char>(s);
      if (counting) hcnt[s * BNT + tid] += 1;
    }
    __syncthreads();
    T cv[CHUNK];
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) {
      const int col = c0 + c;
      cv[c] = (live && col < m) ? vb[static_cast<size_t>(col) * n_rep + b] : T(0);
    }
    for (int r = 0; r < rows; ++r) {
      const T a = live ? va[static_cast<size_t>(r0 + r) * n_rep + b] : T(0);
      const uint4* slots = reinterpret_cast<const uint4*>(sslot + r * CHUNK);
#pragma unroll
      for (int w = 0; w < CHUNK / 16; ++w) {
        const uint4 pk = slots[w];
        const unsigned word[4] = {pk.x, pk.y, pk.z, pk.w};
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const int s = (word[k / 4] >> (8 * (k % 4))) & 0xff;
          hsum[s * BNT + tid] += static_cast<double>(ckv::cloud<T, COV>(a, cv[w * 16 + k]));
        }
      }
    }
  }
  __syncthreads();
  if (live) {
    for (int k = 0; k < n_win; ++k)
      part_sums[(static_cast<size_t>(blockIdx.x) * n_rep + b) * n_win + k] = hsum[k * BNT + tid];
  }
  if (counting) {
    // per-bin strip counts in a fixed order: warp w takes bins w, w + BNT / 32, ...
    const int lane = tid & 31;
    for (int k = tid >> 5; k < n_win; k += BNT / 32) {
      long long c = 0;
      for (int t = lane; t < BNT; t += 32) c += hcnt[k * BNT + t];
      for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
      if (lane == 0) part_counts[static_cast<size_t>(blockIdx.x) * n_win + k] = c;
    }
  }
}

// One thread per output (p, b, bin of the window): variogram p's strip
// partials of replicate b added in a fixed order into sums[(p n_rep + b)
// stride + bin]; the b == 0 threads add the counts into counts[p stride + bin].
template <typename T>
__global__ void bin_batch_reduce_kernel(const __grid_constant__ Pairs<T> P,
                                        const double* __restrict__ part_sums,
                                        const long long* __restrict__ part_counts, int n_win,
                                        int n_rep, double* __restrict__ sums,
                                        long long* __restrict__ counts, int stride) {
  const long long o = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= static_cast<long long>(P.count) * n_rep * n_win) return;
  const int k = static_cast<int>(o % n_win);
  const int b = static_cast<int>((o / n_win) % n_rep);
  const int p = static_cast<int>(o / (static_cast<long long>(n_win) * n_rep));
  double s = 0.0;
  long long c = 0;
  for (long long st = P.tile0[p]; st < P.tile0[p + 1]; ++st) {
    s += part_sums[(st * n_rep + b) * n_win + k];
    if (b == 0) c += part_counts[st * n_win + k];
  }
  sums[(static_cast<size_t>(p) * n_rep + b) * stride + k] = s;
  if (b == 0) counts[static_cast<size_t>(p) * stride + k] = c;
}

// ---- host side ------------------------------------------------------------

// Fills the launch descriptor from the caller's arrays: ptrs holds `per`
// device pointers per variogram, dims {n, m, marginal, first tile} per
// variogram. Checks the caller's tile offsets against this file's TILE.
template <typename T>
cudaError_t make_pairs(Pairs<T>& P, int count, const void* const* ptrs, int per,
                       const long long* dims) {
  if (count < 1 || count > MAX_PAIRS) return cudaErrorInvalidValue;
  P.count = count;
  long long tiles = 0;
  for (int p = 0; p < count; ++p) {
    const T* const* q = reinterpret_cast<const T* const*>(ptrs + static_cast<size_t>(p) * per);
    P.fa[p] = q[0];
    P.fb[p] = q[1];
    P.va[p] = per > 2 ? q[2] : nullptr;
    P.vb[p] = per > 2 ? q[3] : nullptr;
    const long long n = dims[4 * p], m = dims[4 * p + 1];
    P.n[p] = static_cast<int>(n);
    P.m[p] = static_cast<int>(m);
    P.marginal[p] = static_cast<int>(dims[4 * p + 2]);
    P.tile0[p] = dims[4 * p + 3];
    const long long nr = (n + TILE - 1) / TILE, nc = (m + TILE - 1) / TILE;
    if (P.tile0[p] != tiles || (P.marginal[p] && n != m)) return cudaErrorInvalidValue;
    tiles += P.marginal[p] ? nr * (nr + 1) / 2 : nr * nc;
  }
  P.tile0[count] = tiles;
  return tiles < (1ll << 31) ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T>
int minmax(int count, const void* const* ptrs, const long long* dims, int geodesic, T h_max,
           T h_snap, T* part_min, T* part_max, T* out, cudaStream_t stream) {
  Pairs<T> P;
  cudaError_t err = make_pairs(P, count, ptrs, 2, dims);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(P.tile0[count]);
  if (grid > 0) {
    if (geodesic) {
      minmax_kernel<T, true><<<grid, NT, 0, stream>>>(P, h_max, h_snap, part_min, part_max);
    } else {
      minmax_kernel<T, false><<<grid, NT, 0, stream>>>(P, h_max, h_snap, part_min, part_max);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  minmax_reduce_kernel<T><<<count, RED_THREADS, 0, stream>>>(P, part_min, part_max, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool GEO, bool COV>
void launch_bin(const Pairs<T>& P, unsigned grid, size_t smem, cudaStream_t stream,
                const unsigned char* records, int rec_used, int n_win, int k_cmp, T h_max,
                double* part_sums, long long* part_counts) {
  if (k_cmp == 1) {
    bin_kernel<T, GEO, COV, 1><<<grid, NT, smem, stream>>>(P, records, rec_used, n_win, h_max,
                                                            part_sums, part_counts);
  } else {
    bin_kernel<T, GEO, COV, 0><<<grid, NT, smem, stream>>>(P, records, rec_used, n_win, h_max,
                                                            part_sums, part_counts);
  }
}

// Bins one window of n_win <= MAX_BINS bins, starting at bin0, of every
// variogram; records: the variograms' lookup records for this window;
// sums / counts: (count, stride) arrays of all the bins.
template <typename T>
int bin(int count, const void* const* ptrs, const long long* dims,
        const unsigned char* records, int max_cells, int n_win, int max_k_cmp, int geodesic,
        int covariogram, T h_max, double* part_sums, long long* part_counts, double* sums,
        long long* counts, int stride, int bin0, cudaStream_t stream) {
  if (n_win < 1 || n_win > ckv::MAX_BINS || bin0 < 0 || bin0 + n_win > stride ||
      max_cells < 1 || max_cells > ckv::MAX_CELLS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rec_used = Record<T>::used(max_cells);
  Pairs<T> P;
  cudaError_t err = make_pairs(P, count, ptrs, 4, dims);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(P.tile0[count]);
  if (grid > 0) {
    const size_t smem = static_cast<size_t>(n_win + 1) * NT *
                            (sizeof(double) + sizeof(unsigned short)) + rec_used;
    if (geodesic && covariogram) {
      launch_bin<T, true, true>(P, grid, smem, stream, records, rec_used, n_win, max_k_cmp,
                                h_max, part_sums, part_counts);
    } else if (geodesic) {
      launch_bin<T, true, false>(P, grid, smem, stream, records, rec_used, n_win, max_k_cmp,
                                 h_max, part_sums, part_counts);
    } else if (covariogram) {
      launch_bin<T, false, true>(P, grid, smem, stream, records, rec_used, n_win, max_k_cmp,
                                 h_max, part_sums, part_counts);
    } else {
      launch_bin<T, false, false>(P, grid, smem, stream, records, rec_used, n_win, max_k_cmp,
                                  h_max, part_sums, part_counts);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  bin_reduce_kernel<T><<<dim3(n_win, count), RED_THREADS, 0, stream>>>(
      P, part_sums, part_counts, n_win, sums + bin0, counts + bin0, stride);
  return static_cast<int>(cudaGetLastError());
}

// The batched pass's descriptor: as make_pairs, but `tile0` holds each
// variogram's first strip of STRIP rows.
template <typename T>
cudaError_t make_strips(Pairs<T>& P, int count, const void* const* ptrs, const long long* dims) {
  if (count < 1 || count > MAX_PAIRS) return cudaErrorInvalidValue;
  P.count = count;
  long long strips = 0;
  for (int p = 0; p < count; ++p) {
    const T* const* q = reinterpret_cast<const T* const*>(ptrs + static_cast<size_t>(p) * 4);
    P.fa[p] = q[0];
    P.fb[p] = q[1];
    P.va[p] = q[2];
    P.vb[p] = q[3];
    const long long n = dims[4 * p], m = dims[4 * p + 1];
    P.n[p] = static_cast<int>(n);
    P.m[p] = static_cast<int>(m);
    P.marginal[p] = static_cast<int>(dims[4 * p + 2]);
    P.tile0[p] = dims[4 * p + 3];
    if (P.tile0[p] != strips || (P.marginal[p] && n != m)) return cudaErrorInvalidValue;
    strips += (n + STRIP - 1) / STRIP;
  }
  P.tile0[count] = strips;
  return strips < (1ll << 31) ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, bool GEO, bool COV>
void launch_bin_batch(const Pairs<T>& P, dim3 grid, size_t smem, cudaStream_t stream,
                      const unsigned char* records, int rec_used, int n_win, int k_cmp, T h_max,
                      int n_rep, double* part_sums, long long* part_counts) {
  if (k_cmp == 1) {
    bin_batch_kernel<T, GEO, COV, 1><<<grid, BNT, smem, stream>>>(
        P, records, rec_used, n_win, h_max, n_rep, part_sums, part_counts);
  } else {
    bin_batch_kernel<T, GEO, COV, 0><<<grid, BNT, smem, stream>>>(
        P, records, rec_used, n_win, h_max, n_rep, part_sums, part_counts);
  }
}

// Bins one window of every variogram for n_rep replicates; part_sums /
// part_counts: (strips, n_rep, n_win) / (strips, n_win) scratch; sums /
// counts: (count, n_rep, stride) / (count, stride) arrays of all the bins.
template <typename T>
int bin_batch(int count, const void* const* ptrs, const long long* dims,
              const unsigned char* records, int max_cells, int n_win, int max_k_cmp,
              int geodesic, int covariogram, T h_max, int n_rep, double* part_sums,
              long long* part_counts, double* sums, long long* counts, int stride, int bin0,
              cudaStream_t stream) {
  if (n_win < 1 || n_win > ckv::MAX_BINS || bin0 < 0 || bin0 + n_win > stride ||
      max_cells < 1 || max_cells > ckv::MAX_CELLS || n_rep < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rec_used = Record<T>::used(max_cells);
  Pairs<T> P;
  cudaError_t err = make_strips(P, count, ptrs, dims);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long strips = P.tile0[count];
  if (strips > 0) {
    const dim3 grid(static_cast<unsigned>(strips), static_cast<unsigned>((n_rep + BNT - 1) / BNT));
    const size_t smem = static_cast<size_t>(n_win + 1) * BNT * (sizeof(double) + sizeof(unsigned)) +
                        rec_used;
    if (geodesic && covariogram) {
      launch_bin_batch<T, true, true>(P, grid, smem, stream, records, rec_used, n_win, max_k_cmp,
                                      h_max, n_rep, part_sums, part_counts);
    } else if (geodesic) {
      launch_bin_batch<T, true, false>(P, grid, smem, stream, records, rec_used, n_win,
                                       max_k_cmp, h_max, n_rep, part_sums, part_counts);
    } else if (covariogram) {
      launch_bin_batch<T, false, true>(P, grid, smem, stream, records, rec_used, n_win,
                                       max_k_cmp, h_max, n_rep, part_sums, part_counts);
    } else {
      launch_bin_batch<T, false, false>(P, grid, smem, stream, records, rec_used, n_win,
                                        max_k_cmp, h_max, n_rep, part_sums, part_counts);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long outs = static_cast<long long>(count) * n_rep * n_win;
  bin_batch_reduce_kernel<T><<<static_cast<unsigned>((outs + RED_THREADS - 1) / RED_THREADS),
                               RED_THREADS, 0, stream>>>(P, part_sums, part_counts, n_win, n_rep,
                                                         sums + bin0, counts + bin0, stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int vario_minmax_f32(int count, const void* const* ptrs, const long long* dims, int geodesic,
                     float h_max, float h_snap, float* part_min, float* part_max, float* out,
                     void* stream) {
  return minmax<float>(count, ptrs, dims, geodesic, h_max, h_snap, part_min, part_max, out,
                       static_cast<cudaStream_t>(stream));
}

int vario_minmax_f64(int count, const void* const* ptrs, const long long* dims, int geodesic,
                     double h_max, double h_snap, double* part_min, double* part_max,
                     double* out, void* stream) {
  return minmax<double>(count, ptrs, dims, geodesic, h_max, h_snap, part_min, part_max, out,
                        static_cast<cudaStream_t>(stream));
}

int vario_bin_f32(int count, const void* const* ptrs, const long long* dims,
                  const unsigned char* records, int max_cells, int n_win, int max_k_cmp,
                  int geodesic, int covariogram, float h_max, double* part_sums,
                  long long* part_counts, double* sums, long long* counts, int stride, int bin0,
                  void* stream) {
  return bin<float>(count, ptrs, dims, records, max_cells, n_win, max_k_cmp, geodesic,
                    covariogram, h_max, part_sums, part_counts, sums, counts, stride, bin0,
                    static_cast<cudaStream_t>(stream));
}

int vario_bin_f64(int count, const void* const* ptrs, const long long* dims,
                  const unsigned char* records, int max_cells, int n_win, int max_k_cmp,
                  int geodesic, int covariogram, double h_max, double* part_sums,
                  long long* part_counts, double* sums, long long* counts, int stride, int bin0,
                  void* stream) {
  return bin<double>(count, ptrs, dims, records, max_cells, n_win, max_k_cmp, geodesic,
                     covariogram, h_max, part_sums, part_counts, sums, counts, stride, bin0,
                     static_cast<cudaStream_t>(stream));
}

int vario_bin_batch_f32(int count, const void* const* ptrs, const long long* dims,
                        const unsigned char* records, int max_cells, int n_win, int max_k_cmp,
                        int geodesic, int covariogram, float h_max, int n_rep,
                        double* part_sums, long long* part_counts, double* sums,
                        long long* counts, int stride, int bin0, void* stream) {
  return bin_batch<float>(count, ptrs, dims, records, max_cells, n_win, max_k_cmp, geodesic,
                          covariogram, h_max, n_rep, part_sums, part_counts, sums, counts,
                          stride, bin0, static_cast<cudaStream_t>(stream));
}

int vario_bin_batch_f64(int count, const void* const* ptrs, const long long* dims,
                        const unsigned char* records, int max_cells, int n_win, int max_k_cmp,
                        int geodesic, int covariogram, double h_max, int n_rep,
                        double* part_sums, long long* part_counts, double* sums,
                        long long* counts, int stride, int bin0, void* stream) {
  return bin_batch<double>(count, ptrs, dims, records, max_cells, n_win, max_k_cmp, geodesic,
                           covariogram, h_max, n_rep, part_sums, part_counts, sums, counts,
                           stride, bin0, static_cast<cudaStream_t>(stream));
}

const char* vario_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
