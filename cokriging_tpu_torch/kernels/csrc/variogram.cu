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
// What bounds it: instruction issue, and in pass 2 the shared-memory pipe
// beside it. No pair reads device memory (a block reads 2 x TILE points). A
// pair costs 11 explicitly rounded operations for h; pass 1 adds ~6 compares
// and selects, pass 2 ~25 instructions: the lookup and its compare, the
// slot, the cloud and its conversion to double, and a read-modify-write of
// a double and a count in shared memory (with the lookup's three loads, ~9
// shared-memory wavefronts per warp of pairs). The floating-point rate is
// not the limit: a bound taken at 67 TFLOP/s counts a fused multiply-add as
// two operations, and these passes have none.
//
// The replicate-batched bin pass bins B value replicates over one set of
// pairs: the parametric bootstrap's re-estimate, which the reference runs as
// jnp (cokriging_tpu/estimate/bootstrap.py::_batched_bin_program, :93-176;
// no TPU kernel). What bounds it on this card: each binned pair costs ~5
// operations per replicate (the cloud, its conversion and its add), but only
// ~21% of the pairs are binned at the bootstrap's h_max (6.7e7 of 3.1e8 in
// chip_smoke (i)), and a pair's slot is the same for every replicate. The
// earlier design (one block of 64 replicates per strip, every thread adding
// every pair's cloud into its shared-memory histogram column) spent its time
// on a read-modify-write of a double per pair and replicate, dropped pairs
// included, each waiting on the store before it: 60.4 / 26.1 / 54.8 ms f64
// at 200 replicates / f32 at 50 / f32 at 200, as slow in f32 as in f64.
// The design now (batch_slot_kernel, batch_walk_kernel, the reduces), in
// rounds of strips (vario.cuh batch_round: a round takes strips in order
// while its chunks fit one list of BATCH_LIST = 8,192 chunks and its
// (strip, span) places BATCH_SLOTS = 2,048), each round:
//   - the slot pass, once per (strip, chunk) for all replicates: a chunk's
//     pairs get their slot; those of slot < n_win are sorted by slot with
//     partition.cuh's stable counting sort and written to the chunk's list
//     with the slot offsets (the dropped slot takes no entry; the counts are
//     the offsets' differences);
//   - the walk, per (strip, span of BATCH_SPAN = 8 chunks, 64 replicates):
//     the strip's row values in shared memory, per chunk its column values
//     and its list; each of the block's four warps adds the clouds of every
//     fourth entry of each slot into registers (two adjacent replicates per
//     thread, vector loads), so no replicate touches a dropped pair and no
//     add waits on a store; the warps' sums are added in warp order into
//     the block's partial;
//   - fixed-order sums: per strip over its spans, then per variogram over
//     its strips onto the earlier rounds' sum; and the counts.
// The rounds, and so the order in which a replicate's partials are added,
// depend on the strips' shapes only: a replicate's sums are the same bits
// whatever the number of replicates or the card. Scratch: the list (8 KB of
// u16 entries and 64 B of offsets per chunk, at most 64.5 MB) and the
// partials (at most 2,048 x 8 B per replicate and bin), reused by every
// round; chip_smoke (i)'s 77,028 chunks take ten rounds.
// Measured (tools/torch_bin_batch_timing.py, NVIDIA H100 80GB HBM3 at 700 W,
// (i)'s shapes, parent in the same call): 16.5-16.7 / 5.0-5.2 / 12.8-13.0 ms
// f64 at 200 replicates / f32 at 50 / f32 at 200 against 59.6-59.9 / 26.0-26.3
// / 54.5-54.7; of the device time the slot pass 1.2 ms, the walk 14.3 / 2.9
// / 10.6 ms at about half of the shared-memory pipe's rate (two values and
// one list entry read per binned pair and pair of replicates), the sums and
// counts 0.15-0.23 ms. Shared memory per walk block: (64 + 64) x 64 values
// (64 / 32 KB f64 / f32), 8 KB of list and 64 B of offsets, the warps' sums
// over the values at the end; 128 threads, at most 128 registers (four
// blocks by registers, three by shared memory in f64). Slot blocks: 256
// threads, 14-18 KB static.
#include "partition.cuh"
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
  long long chunk0[MAX_PAIRS + 1];  // the batched pass: first chunk of each variogram
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

using ckv::BATCH_CHUNK;
using ckv::BATCH_PAIRS;
using ckv::BATCH_SEG;
using ckv::BATCH_SPAN;
using ckv::BATCH_STRIP;

constexpr int BST = 256;  // threads of a slot block
constexpr int BRW = 64;   // replicates of a walk block, two per lane of a warp
constexpr int WT = 128;   // threads of a walk block
constexpr int BSPLIT = WT / 32;  // walkers per replicate (the warps), each a share of every slot

// Chunks of strip s of variogram p and the chunks of its earlier strips.
template <typename T>
__device__ __forceinline__ void strip_chunks(const Pairs<T>& P, int p, int s, int& count,
                                             long long& before) {
  ckv::strip_chunks((P.m[p] + BATCH_CHUNK - 1) / BATCH_CHUNK, P.marginal[p] != 0, s, count,
                    before);
}

// The variogram, its strip number and the strip's first row of flat strip
// t (`tile0` holds first strips).
template <typename T>
__device__ __forceinline__ int3 strip_at(const Pairs<T>& P, long long t) {
  int p = 0;
  while (p + 1 < P.count && P.tile0[p + 1] <= t) ++p;
  const int s = static_cast<int>(t - P.tile0[p]);
  return make_int3(p, s, s * BATCH_STRIP);
}

// The slot pass of a round (ckv::batch_round) from flat strip s_lo and
// chunk c_lo: block (strip s_lo + x, k) finds the histogram slot of each
// pair of the strip's k-th chunk once for every replicate, sorts the pairs
// of slot < n_win by slot (partition.cuh's stable counting sort; the dropped
// slot takes no key) and writes them to the chunk's entries of `list`
// and its slot offsets to `seg` (BATCH_PAIRS and BATCH_SEG per chunk from
// c_lo; seg[n_win] is the chunk's binned count).
template <typename T, bool GEO, int K>
__global__ void __launch_bounds__(BST) batch_slot_kernel(const __grid_constant__ Pairs<T> P,
                                                         long long s_lo, long long c_lo,
                                                         const unsigned char* __restrict__ records,
                                                         int rec_used, int n_win, T h_max,
                                                         unsigned short* __restrict__ list,
                                                         unsigned short* __restrict__ seg) {
  constexpr int F = GEO ? 5 : 2;
  extern __shared__ __align__(16) unsigned char srec[];
  __shared__ __align__(16) T srow[BATCH_STRIP * F];
  __shared__ __align__(16) T scol[BATCH_CHUNK * F];
  __shared__ unsigned char skey[BATCH_PAIRS];
  __shared__ unsigned short sperm[BATCH_PAIRS];
  __shared__ int scnt[(BST / 32) * ckv::MAX_BINS];
  __shared__ int stotal[4];

  const int3 at = strip_at(P, s_lo + blockIdx.x);
  const int pair = at.x, r0 = at.z;
  int count;
  long long before;
  strip_chunks(P, pair, at.y, count, before);
  const int k = blockIdx.y;
  if (k >= count) return;
  const int tid = threadIdx.x;
  const int n = P.n[pair], m = P.m[pair];
  const bool marginal = P.marginal[pair] != 0;
  const int c0 = (marginal ? r0 : 0) + k * BATCH_CHUNK;
  const long long chunk = P.chunk0[pair] + before + k - c_lo;
  const T* __restrict__ fa = P.fa[pair];
  const T* __restrict__ fb = P.fb[pair];

  const uint4* rec = reinterpret_cast<const uint4*>(records + static_cast<size_t>(pair) *
                                                                  Record<T>::bytes);
  for (int i = tid; i < rec_used / 16; i += BST) reinterpret_cast<uint4*>(srec)[i] = rec[i];
  for (int i = tid; i < BATCH_STRIP * F; i += BST) {
    const int row = r0 + i / F;
    srow[i] = row < n ? fa[static_cast<size_t>(row) * F + i % F] : nan_of<T>();
  }
  for (int i = tid; i < BATCH_CHUNK * F; i += BST) {
    const int col = c0 + i / F;
    scol[i] = col < m ? fb[static_cast<size_t>(col) * F + i % F] : nan_of<T>();
  }
  __syncthreads();
  const BinLookup<T> L = ckv::lookup_of<T>(srec);
  for (int q = tid; q < BATCH_PAIRS; q += BST) {
    const int r = q / BATCH_CHUNK, c = q % BATCH_CHUNK;
    const T h = ckv::h_pair<T, GEO>(srow + r * F, scol + c * F);
    bool valid = h <= h_max;
    if (marginal) valid = valid && r0 + r < c0 + c;
    const int sl = ckv::bin_slot<K>(h, valid, L, n_win);
    skey[q] = sl < n_win ? static_cast<unsigned char>(sl) : ckt::kNoKey;
  }
  const int total = ckt::stable_partition<BST / 32, BATCH_PAIRS / BST>(skey, BATCH_PAIRS, n_win,
                                                                      sperm, scnt, stotal);
  unsigned short* out = list + chunk * BATCH_PAIRS;
  for (int q = tid; q < total; q += BST) out[q] = sperm[q];
  // warp 0's row of the partition's counts holds each slot's first entry
  if (tid < n_win) seg[chunk * BATCH_SEG + tid] = static_cast<unsigned short>(scnt[tid]);
  if (tid == 0) seg[chunk * BATCH_SEG + n_win] = static_cast<unsigned short>(total);
}

// The walk of a round: block (strip s_lo + x, span y, replicate group z of
// BRW) keeps the strip's row values of its replicates in shared memory, and
// per chunk of its span (chunks y BATCH_SPAN .. + BATCH_SPAN - 1 of the
// strip) stages the column values and the chunk's sorted entries; lane l of
// warp w adds the clouds of every BSPLIT-th entry of each slot from the w-th
// into its registers for the replicates z BRW + 2 l and + 1
// (ckv::walk_chunk). At the end the warps' sums are added in warp order in
// shared memory into the block's partial per replicate and slot, written to
// part_sums[((x max_spans + y) n_rep + replicate) n_win + slot]. va / vb are
// (n, n_rep) / (m, n_rep) row-major.
template <typename T, bool COV, int NB>
__global__ void __launch_bounds__(WT, 4) batch_walk_kernel(const __grid_constant__ Pairs<T> P,
                                                         long long s_lo, long long c_lo,
                                                         const unsigned short* __restrict__ list,
                                                         const unsigned short* __restrict__ seg,
                                                         int n_win, int n_rep, int max_spans,
                                                         double* __restrict__ part_sums) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* srow_v = reinterpret_cast<T*>(smem_raw);
  T* scol_v = srow_v + BATCH_STRIP * BRW;
  unsigned short* sperm = reinterpret_cast<unsigned short*>(scol_v + BATCH_CHUNK * BRW);
  unsigned short* sseg = sperm + BATCH_PAIRS;
  double* sred = reinterpret_cast<double*>(smem_raw);  // BRW x NB, over srow_v at the end

  const int3 at = strip_at(P, s_lo + blockIdx.x);
  const int pair = at.x, r0 = at.z;
  int count;
  long long before;
  strip_chunks(P, pair, at.y, count, before);
  const int k_lo = blockIdx.y * BATCH_SPAN;
  if (k_lo >= count) return;
  const int k_hi = count < k_lo + BATCH_SPAN ? count : k_lo + BATCH_SPAN;
  const int tid = threadIdx.x;
  const int pos = 2 * (tid % 32), split = tid / 32;
  const int g0 = blockIdx.z * BRW;
  const int n = P.n[pair], m = P.m[pair];
  const bool marginal = P.marginal[pair] != 0;
  const T* __restrict__ va = P.va[pair];
  const T* __restrict__ vb = P.vb[pair];

  for (int i = tid; i < BATCH_STRIP * BRW; i += WT) {
    const int row = r0 + i / BRW, bb = g0 + i % BRW;
    srow_v[i] = (row < n && bb < n_rep) ? va[static_cast<size_t>(row) * n_rep + bb] : T(0);
  }
  double hist[2][NB];
#pragma unroll
  for (int s = 0; s < NB; ++s) hist[0][s] = hist[1][s] = 0.0;
  for (int k = k_lo; k < k_hi; ++k) {
    const int c0 = (marginal ? r0 : 0) + k * BATCH_CHUNK;
    const long long chunk = P.chunk0[pair] + before + k - c_lo;
    const int total = seg[chunk * BATCH_SEG + n_win];
    __syncthreads();  // the previous chunk's values and entries are consumed
    for (int i = tid; i < BATCH_CHUNK * BRW; i += WT) {
      const int col = c0 + i / BRW, bb = g0 + i % BRW;
      scol_v[i] = (col < m && bb < n_rep) ? vb[static_cast<size_t>(col) * n_rep + bb] : T(0);
    }
    for (int i = tid; i <= n_win; i += WT) sseg[i] = seg[chunk * BATCH_SEG + i];
    const unsigned short* entries = list + chunk * BATCH_PAIRS;
    for (int i = tid; i < total; i += WT) sperm[i] = entries[i];
    __syncthreads();
    ckv::walk_chunk<T, COV, NB>(sperm, sseg, n_win, split, BSPLIT, srow_v, scol_v, pos, BRW,
                                hist);
  }
  for (int w = 0; w < BSPLIT; ++w) {
    __syncthreads();  // w == 0: every walker is done with the values
    if (split == w) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int s = 0; s < NB; ++s) {
          if (s < n_win) {
            double& r = sred[(pos + j) * n_win + s];
            r = w == 0 ? hist[j][s] : r + hist[j][s];
          }
        }
      }
    }
  }
  __syncthreads();
  double* out = part_sums +
      ((static_cast<size_t>(blockIdx.x) * max_spans + blockIdx.y) * n_rep + g0) * n_win;
  const int width = (n_rep - g0 < BRW ? n_rep - g0 : BRW) * n_win;
  for (int i = tid; i < width; i += WT) out[i] = sred[i];
}

// One thread per (strip s_lo + t, replicate b, bin of the window): the
// strip's span partials added in span order, written over its first span's.
template <typename T>
__global__ void batch_strip_sum_kernel(const __grid_constant__ Pairs<T> P, long long s_lo,
                                       int n_strips, int max_spans,
                                       double* __restrict__ part_sums, int n_win, int n_rep) {
  const long long per = static_cast<long long>(n_rep) * n_win;
  const long long o = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= n_strips * per) return;
  const long long t = o / per, rest = o % per;
  const int3 at = strip_at(P, s_lo + t);
  int count;
  long long before;
  strip_chunks(P, at.x, at.y, count, before);
  const int spans = (count + BATCH_SPAN - 1) / BATCH_SPAN;
  double* first = part_sums + t * max_spans * per + rest;
  double s = *first;
  for (int y = 1; y < spans; ++y) s += first[y * per];
  *first = s;
}

// One thread per output (p, b, bin of the window): variogram p's strip
// partials of replicate b in the round's strips [s_lo, s_hi), in strip
// order, added into sums[(p n_rep + b) stride + bin]: from 0 in the round
// that holds p's first strip, else onto the earlier rounds' sum; the first
// round also writes 0 for a variogram whose strips come later or that has
// none.
template <typename T>
__global__ void batch_sum_kernel(const __grid_constant__ Pairs<T> P, long long s_lo,
                                 long long s_hi, int max_spans,
                                 const double* __restrict__ part_sums, int n_win, int n_rep,
                                 double* __restrict__ sums, int stride) {
  const long long o = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= static_cast<long long>(P.count) * n_rep * n_win) return;
  const int k = static_cast<int>(o % n_win);
  const int b = static_cast<int>((o / n_win) % n_rep);
  const int p = static_cast<int>(o / (static_cast<long long>(n_win) * n_rep));
  const long long lo = s_lo > P.tile0[p] ? s_lo : P.tile0[p];
  const long long hi = s_hi < P.tile0[p + 1] ? s_hi : P.tile0[p + 1];
  if (lo >= hi && s_lo > 0) return;
  double* out = sums + (static_cast<size_t>(p) * n_rep + b) * stride + k;
  double s = P.tile0[p] >= s_lo ? 0.0 : *out;
  for (long long t = lo; t < hi; ++t)
    s += part_sums[((t - s_lo) * max_spans * n_rep + b) * n_win + k];
  *out = s;
}

// Block (bin, p): variogram p's pair count of the window's bin over the
// round's chunks [c_lo, c_hi), the sum of the slot pass's segment lengths
// (integers: exact), into counts[p stride + bin] as batch_sum_kernel does.
template <typename T>
__global__ void batch_count_kernel(const __grid_constant__ Pairs<T> P, long long s_lo,
                                   long long s_hi, long long c_lo, long long c_hi,
                                   const unsigned short* __restrict__ seg,
                                   long long* __restrict__ counts, int stride) {
  __shared__ long long sc[RED_THREADS];
  const int k = blockIdx.x;
  const int p = blockIdx.y;
  const long long lo = s_lo > P.tile0[p] ? s_lo : P.tile0[p];
  const long long hi = s_hi < P.tile0[p + 1] ? s_hi : P.tile0[p + 1];
  if (lo >= hi && s_lo > 0) return;
  const long long ch_lo = c_lo > P.chunk0[p] ? c_lo : P.chunk0[p];
  const long long ch_hi = c_hi < P.chunk0[p + 1] ? c_hi : P.chunk0[p + 1];
  long long c = 0;
  for (long long ch = ch_lo + threadIdx.x; ch < ch_hi; ch += RED_THREADS)
    c += seg[(ch - c_lo) * BATCH_SEG + k + 1] - seg[(ch - c_lo) * BATCH_SEG + k];
  sc[threadIdx.x] = c;
  __syncthreads();
  for (int w = RED_THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) sc[threadIdx.x] += sc[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    long long& out = counts[static_cast<size_t>(p) * stride + k];
    out = (P.tile0[p] >= s_lo ? 0 : out) + sc[0];
  }
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
// variogram's first strip of BATCH_STRIP rows and `chunk0` its first chunk
// (ckv::strip_chunks' count per strip).
template <typename T>
cudaError_t make_strips(Pairs<T>& P, int count, const void* const* ptrs, const long long* dims) {
  if (count < 1 || count > MAX_PAIRS) return cudaErrorInvalidValue;
  P.count = count;
  long long strips = 0, chunks = 0;
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
    P.chunk0[p] = chunks;
    if (P.tile0[p] != strips || (P.marginal[p] && n != m)) return cudaErrorInvalidValue;
    const long long ns = (n + BATCH_STRIP - 1) / BATCH_STRIP;
    const long long nc = (m + BATCH_CHUNK - 1) / BATCH_CHUNK;
    strips += ns;
    chunks += P.marginal[p] ? ns * nc - ckv::BATCH_RATIO * ns * (ns - 1) / 2 : ns * nc;
  }
  P.tile0[count] = strips;
  P.chunk0[count] = chunks;
  return strips < (1ll << 31) ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, bool GEO>
void launch_batch_slot(const Pairs<T>& P, const ckv::BatchRound& R, size_t smem,
                       cudaStream_t stream, const unsigned char* records, int rec_used,
                       int n_win, int k_cmp, T h_max, unsigned short* list,
                       unsigned short* seg) {
  const dim3 grid(static_cast<unsigned>(R.s_hi - R.s_lo), static_cast<unsigned>(R.max_chunks));
  if (k_cmp == 1) {
    batch_slot_kernel<T, GEO, 1><<<grid, BST, smem, stream>>>(P, R.s_lo, R.c_lo, records,
                                                              rec_used, n_win, h_max, list, seg);
  } else {
    batch_slot_kernel<T, GEO, 0><<<grid, BST, smem, stream>>>(P, R.s_lo, R.c_lo, records,
                                                              rec_used, n_win, h_max, list, seg);
  }
}

template <typename T, bool COV, int NB>
cudaError_t launch_batch_walk(const Pairs<T>& P, const ckv::BatchRound& R, cudaStream_t stream,
                              const unsigned short* list, const unsigned short* seg, int n_win,
                              int n_rep, double* part_sums) {
  constexpr size_t smem = sizeof(T) * (BATCH_STRIP + BATCH_CHUNK) * BRW +
                          sizeof(unsigned short) * (BATCH_PAIRS + BATCH_SEG);
  static_assert(sizeof(double) * BRW * NB <= sizeof(T) * (BATCH_STRIP + BATCH_CHUNK) * BRW,
                "the walkers' reduce fits over the staged values");
  const cudaError_t err = ckt::allow_smem<batch_walk_kernel<T, COV, NB>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(R.s_hi - R.s_lo), static_cast<unsigned>(R.max_spans),
                  static_cast<unsigned>((n_rep + BRW - 1) / BRW));
  batch_walk_kernel<T, COV, NB><<<grid, WT, smem, stream>>>(P, R.s_lo, R.c_lo, list, seg, n_win,
                                                             n_rep, R.max_spans, part_sums);
  return cudaGetLastError();
}

template <typename T, bool COV>
cudaError_t launch_batch_walk(const Pairs<T>& P, const ckv::BatchRound& R, cudaStream_t stream,
                              const unsigned short* list, const unsigned short* seg, int n_win,
                              int n_rep, double* part_sums) {
  return n_win <= 16 ? launch_batch_walk<T, COV, 16>(P, R, stream, list, seg, n_win, n_rep,
                                                     part_sums)
                     : launch_batch_walk<T, COV, ckv::MAX_BINS>(P, R, stream, list, seg, n_win,
                                                                n_rep, part_sums);
}

// Bins one window of every variogram for n_rep replicates, round by round
// (ckv::batch_round). list / seg: list_cap * BATCH_PAIRS / BATCH_SEG unsigned
// shorts of scratch and part_sums slot_cap * n_rep * n_win doubles, at least
// what ckv::batch_scratch gives; sums / counts: (count, n_rep, stride) /
// (count, stride) arrays of all the bins.
template <typename T>
int bin_batch(int count, const void* const* ptrs, const long long* dims,
              const unsigned char* records, int max_cells, int n_win, int max_k_cmp,
              int geodesic, int covariogram, T h_max, int n_rep, long long list_cap,
              long long slot_cap, unsigned short* list, unsigned short* seg, double* part_sums,
              double* sums, long long* counts, int stride, int bin0, cudaStream_t stream) {
  if (n_win < 1 || n_win > ckv::MAX_BINS || bin0 < 0 || bin0 + n_win > stride ||
      max_cells < 1 || max_cells > ckv::MAX_CELLS || n_rep < 1 || n_win + 1 > BATCH_SEG)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rec_used = Record<T>::used(max_cells);
  Pairs<T> P;
  cudaError_t err = make_strips(P, count, ptrs, dims);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long strips = P.tile0[count];
  const long long outs = static_cast<long long>(count) * n_rep * n_win;
  long long s_lo = 0;
  do {
    ckv::BatchRound R{0, 0, 0, 0, 0, 0};
    if (strips > 0) {
      R = ckv::batch_round(count, dims, s_lo, ckv::BATCH_LIST, ckv::BATCH_SLOTS);
      if (R.c_hi - R.c_lo > list_cap || (R.s_hi - R.s_lo) * R.max_spans > slot_cap)
        return static_cast<int>(cudaErrorInvalidValue);
      if (geodesic) {
        launch_batch_slot<T, true>(P, R, rec_used, stream, records, rec_used, n_win, max_k_cmp,
                                   h_max, list, seg);
      } else {
        launch_batch_slot<T, false>(P, R, rec_used, stream, records, rec_used, n_win, max_k_cmp,
                                    h_max, list, seg);
      }
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      err = covariogram
                ? launch_batch_walk<T, true>(P, R, stream, list, seg, n_win, n_rep, part_sums)
                : launch_batch_walk<T, false>(P, R, stream, list, seg, n_win, n_rep, part_sums);
      if (err != cudaSuccess) return static_cast<int>(err);
      const int n_strips = static_cast<int>(R.s_hi - R.s_lo);
      const long long strip_outs = static_cast<long long>(n_strips) * n_rep * n_win;
      batch_strip_sum_kernel<T><<<static_cast<unsigned>((strip_outs + RED_THREADS - 1) /
                                                        RED_THREADS),
                                  RED_THREADS, 0, stream>>>(P, R.s_lo, n_strips, R.max_spans,
                                                            part_sums, n_win, n_rep);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    batch_sum_kernel<T><<<static_cast<unsigned>((outs + RED_THREADS - 1) / RED_THREADS),
                          RED_THREADS, 0, stream>>>(P, R.s_lo, R.s_hi, R.max_spans, part_sums,
                                                    n_win, n_rep, sums + bin0, stride);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    batch_count_kernel<T><<<dim3(n_win, count), RED_THREADS, 0, stream>>>(
        P, R.s_lo, R.s_hi, R.c_lo, R.c_hi, seg, counts + bin0, stride);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    s_lo = R.s_hi;
  } while (s_lo < strips);
  return cudaSuccess;
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

// out[0], out[1]: the list chunks and partial places that vario_bin_batch_*
// needs for these variograms (dims as it takes them).
void vario_batch_scratch(int count, const long long* dims, long long* out) {
  ckv::batch_scratch(count, dims, out);
}

int vario_bin_batch_f32(int count, const void* const* ptrs, const long long* dims,
                        const unsigned char* records, int max_cells, int n_win, int max_k_cmp,
                        int geodesic, int covariogram, float h_max, int n_rep, long long list_cap,
                        long long slot_cap, unsigned short* list, unsigned short* seg,
                        double* part_sums, double* sums, long long* counts, int stride, int bin0,
                        void* stream) {
  return bin_batch<float>(count, ptrs, dims, records, max_cells, n_win, max_k_cmp, geodesic,
                          covariogram, h_max, n_rep, list_cap, slot_cap, list, seg, part_sums, sums,
                          counts, stride, bin0, static_cast<cudaStream_t>(stream));
}

int vario_bin_batch_f64(int count, const void* const* ptrs, const long long* dims,
                        const unsigned char* records, int max_cells, int n_win, int max_k_cmp,
                        int geodesic, int covariogram, double h_max, int n_rep, long long list_cap,
                        long long slot_cap, unsigned short* list, unsigned short* seg,
                        double* part_sums, double* sums, long long* counts, int stride, int bin0,
                        void* stream) {
  return bin_batch<double>(count, ptrs, dims, records, max_cells, n_win, max_k_cmp, geodesic,
                           covariogram, h_max, n_rep, list_cap, slot_cap, list, seg, part_sums, sums,
                           counts, stride, bin0, static_cast<cudaStream_t>(stream));
}

const char* vario_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
