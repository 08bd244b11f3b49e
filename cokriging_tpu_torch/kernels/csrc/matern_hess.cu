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
//                                + scale (v_nu dM/dnu + v_ls dM/dls),
//     an n x m output for each of a Hessian's rows (one v each);
//   - to (scale, nu, ls): the sums sum ct dM/dnu, sum ct dM/dls,
//     sum ct d2M/dnu2, sum ct d2M/dnu dls, sum ct d2M/dls2, which close the
//     4 x 4 contraction with v (hess_kernel, five doubles).
// M, dM/dnu and dM/dls depend on (nu, ls, h) alone, fixed for a Hessian; v
// enters through four scalars. So the tangent is two kernels: partials_kernel
// runs kv.cuh's first-order dual pass (tangent_partials: matern_partials_tab
// over a dual row, as matern_grad.cu does) once per block and Hessian and
// stores M, dM/dnu, dM/dls raw (three n x m fields, codes where |h| is not
// > 0 or M is not finite and > 0); tangent_combine_kernel turns them into
// one row's tangent (kv.cuh's tangent_combine, which applies the masks that
// hang on the weights). The Hessian kernel runs the second-order pass
// (matern_second_tab over a Dual2Row: K_nu with its first and second
// mu-tangents with nl pinned, K_{nu+-1} with their first; d2K/dx2 from
// Bessel's equation, or where the reference's AD takes other x-derivatives,
// on CF2 lanes that stop after their first trip and at x == 2, those:
// kv.cuh's reference_x_lane). Masks as matern_grad.cu's: M is 1 where |h|
// is not > 0, and the nu and ls terms count only where M is finite and > 0
// and the term is finite.
//
// What bounds them: the partials and the Hessian sums, operations (the
// serial series or CF2 with one or two tangents; a second-order product is
// 9 operations against a value's 1; the partials write three values per
// entry, far below their operations); the combine, bytes: it reads three
// fields and writes one, with a handful of operations an entry.
//
// Design: the partials and the Hessian sums take 64 x 64 tiles of 256
// threads each (tile_sum.cuh's tiling). The partials kernel walks its tile
// in two bands of 32 rows: it loads the band's h with coalesced row reads;
// entries whose |h| is not > 0 take their codes at once, the rest are keyed
// by series or CF2 half-octave of x and sorted stably (partition.cuh), and
// thread t evaluates sorted slots t, t + 256, ...; the dual row sits in
// shared memory. Each result goes back to its entry's slot in three padded
// shared fields (a band, not the tile, so that the three fit beside the
// sort at the old tangent kernel's occupancy), stored with one coalesced
// pass per field; its symmetric mode launches the lower-triangle tiles and
// also stores (j, i) through the shared fields read transposed, so the
// buffer is whole and the combine has no transposed pass. The combine is a
// grid-stride pass over the n m entries, 16 bytes a load and a store
// (float4 / double2) from the three fields to the output, no shared
// memory, one resident wave of blocks (the SM count queried once per
// device); scale and the weights are device doubles, read in place (no
// host-side packing), s w formed in double and cast as the fused kernel
// did. The Hessian sums are tile_sum.cuh's tiled weighted sum with HessStep
// below as its per-entry step, as the block gradient is with its own:
// w = ct[i, j] + ct[j, i] below the diagonal in the symmetric mode,
// per-tile partials in double and a fixed-order second launch, no atomics,
// the same sums from run to run. Nothing is read back.
//
// The tangent on this card (tools/torch_hess_timing.py at chip_smoke phase
// (j)'s three 2,500^2 blocks and 11 rows, NVIDIA H100 80GB HBM3 at 700 W,
// f32 / f64): a Hessian's tangent work takes 1.8 / 4.5 ms at nu = 1.37
// (2.0 / 6.1 at nu = 1.5), where the fused kernel it replaces, one dual
// pass per row and block, took 5.7 / 24.7 (8.3 / 39.5). The three partials
// launches take 0.56 / 2.27 ms, about one row of the fused launches; a
// combine 0.036 / 0.068 ms of the card's time, 82% / 88% of its bytes bound
// (0.030 / 0.060 ms), and the 33 of a Hessian take within 5% of that as
// the Hessian launches them. The partials hold 3 n m values per block for
// the Hessian's life (+217 / +431 MiB at (j)). Registers: partials 72 / 80
// (28 B of spills in f64; unbounded, 64 / 124 and two f64 blocks per SM:
// 3-17% slower in f64), combine 32.
//
// The Hessian sums on this card (chip_smoke phase (j)'s three 2,500^2
// blocks, NVIDIA H100 80GB HBM3 at 700 W): alone they take 0.85 / 3.48 ms
// f32 / f64, 4.9x / 2.7x the operations bound there (0.174 / 1.280 ms),
// with about half of the FP32 / FP64 pipe's issue slots used
// (tools/torch_hess_timing.py: 0.78 / 3.81-3.85 ms at nu = 1.37). Each
// launch used to build its own second-order row, ~700-1,400 small torch
// operations launched from the host (19-33 ms a build), which was most of
// the 47 / 56 ms the three launches took. Now the caller builds the rows of
// all a covariance's pairs once per Hessian (cov.matern.SecondRows; closed
// forms in place of autograd, 5-14 ms a build) and hands each launch its
// row. The kernel itself is unchanged: its row stays in shared memory,
// where every lane of a warp reads the same column (a broadcast). Measured
// and not kept: the row in constant memory (copied on the launch's stream;
// float32 the same time, float64 30% slower at 166 registers); x re-formed
// from h instead of kept in shared memory, so that a float64 block takes
// 55 KB and three fit on an SM, with a launch bound of three blocks (80
// registers, 256 B of spills): float64 3-4% slower with either bound, and
// float32 at four or five blocks (64 or 48 registers) 4-8% slower;
// kv.cuh's reference_x_lane returning its pair by value instead of through
// references: the same time, 128 / 64 registers with 4 / 24 B of spills
// (f64 / f32), and other bits in the d2M/dnu dls sums (the compiler
// contracts that term differently). The registers, which the Dual2 state of
// the series and CF2 needs (124 / 64 in float64 / float32: two / four
// blocks of 256 threads per SM), bound the occupancy, and more resident
// warps bought with spills do not pay.
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

// ---- the tangent: partials once per Hessian, then one combine per row ----------

constexpr int BAND = 32;  // tile rows a partials block sorts and stores at a time
constexpr int BAND_ITEMS = BAND * TILE / THREADS;
constexpr int FIELD = BAND * PITCH;  // one field of the band in shared memory
constexpr int COMBINE_THREADS = 256;

// Dynamic shared memory of a partials block: the dual row, the band's three
// fields (h, then M, in the first) in padded rows, the partition's counts
// and total, the sorted indices, the keys.
template <typename T> size_t partials_smem() {
  return sizeof(T) * (2 * ckt::TabLayout<T>::width + 3 * FIELD) +
         sizeof(int) * (WARPS * N_KEYS + 4) + sizeof(unsigned short) * BAND * TILE + BAND * TILE;
}

// out: the three fields M, dM/dnu, dM/dls of kv.cuh's tangent_partials, each
// (n, m) row-major, field k at out + k * ld. Bounded to three blocks per SM
// (at most 85 registers; unbounded, float64 takes 124 and two blocks).
template <typename T>
__global__ void __launch_bounds__(THREADS, 3)
    partials_kernel(const T* __restrict__ h, int n, int m, int symmetric, int tiles_m,
                    const T* __restrict__ table, long long ld, T* __restrict__ out) {
  constexpr int W2 = 2 * ckt::TabLayout<T>::width;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_tab = reinterpret_cast<T*>(smem);
  T* s_f = s_tab + W2;
  int* s_cnt = reinterpret_cast<int*>(s_f + 3 * FIELD);
  int* s_total = s_cnt + WARPS * N_KEYS;
  unsigned short* s_perm = reinterpret_cast<unsigned short*>(s_total + 4);
  unsigned char* s_key = reinterpret_cast<unsigned char*>(s_perm + BAND * TILE);
  for (int t = threadIdx.x; t < W2; t += THREADS) s_tab[t] = table[t];
  int ti, tj;
  ckt::tile_of(blockIdx.x, symmetric, tiles_m, ti, tj);
  __syncthreads();
  const ckt::DualRow<T> row{s_tab};

  for (int r0 = 0; r0 < TILE; r0 += BAND) {
    // entry e = (r, c): row ti*TILE + r0 + r, column tj*TILE + c
    for (int e = threadIdx.x; e < BAND * TILE; e += THREADS) {
      const int r = e / TILE, c = e % TILE;
      const int i = ti * TILE + r0 + r, j = tj * TILE + c;
      unsigned char key = ckt::kNoKey;
      if (i < n && j < m && (!symmetric || j <= i)) {
        const T hv = h[static_cast<size_t>(i) * m + j];
        T* f = s_f + r * PITCH + c;
        T x;
        if (ckt::entry_x(hv, row, x)) {
          f[0] = hv;
          key = static_cast<unsigned char>(ckt::x_bucket<CF2_BINS>(x));
        } else {
          ckt::tangent_partials(hv, row, f[0], f[FIELD], f[2 * FIELD]);
        }
      }
      s_key[e] = key;
    }
    const int n_sorted =
        ckt::stable_partition<WARPS, BAND_ITEMS>(s_key, BAND * TILE, N_KEYS, s_perm, s_cnt,
                                                 s_total);
    for (int slot = threadIdx.x; slot < n_sorted; slot += THREADS) {
      const int e = s_perm[slot];
      T* f = s_f + (e / TILE) * PITCH + e % TILE;
      const T hv = f[0];
      ckt::tangent_partials(hv, row, f[0], f[FIELD], f[2 * FIELD]);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < BAND * TILE; e += THREADS) {
      const int r = e / TILE, c = e % TILE;
      const int i = ti * TILE + r0 + r, j = tj * TILE + c;
      if (i < n && j < m && (!symmetric || j <= i)) {
        const size_t at = static_cast<size_t>(i) * m + j;
        for (int k = 0; k < 3; ++k) out[k * ld + at] = s_f[k * FIELD + r * PITCH + c];
      }
    }
    if (symmetric) {
      // entry (x, y) of the band also goes to (tj*TILE + y, ti*TILE + r0 + x):
      // BAND consecutive columns of one row per warp
      for (int e = threadIdx.x; e < BAND * TILE; e += THREADS) {
        const int x = e % BAND, y = e / BAND;
        const int i = ti * TILE + r0 + x, j = tj * TILE + y;
        if (i < n && j < i) {
          const size_t at = static_cast<size_t>(j) * n + i;
          for (int k = 0; k < 3; ++k) out[k * ld + at] = s_f[k * FIELD + x * PITCH + y];
        }
      }
    }
    __syncthreads();  // the next band reuses the fields and the keys
  }
}

// 16 bytes of T: the combine's loads and stores
template <typename T> struct Pack;
template <> struct Pack<float> {
  using V = float4;
  static constexpr int kN = 4;
};
template <> struct Pack<double> {
  using V = double2;
  static constexpr int kN = 2;
};
template <typename T> union Lanes {
  typename Pack<T>::V v;
  T s[Pack<T>::kN];
};

// out[e] = tangent_combine of the three fields at e, e < count; scale and w:
// the device doubles scale and (w_s, w_n, w_nu, w_ls). With vec, p + k * ld
// and out are 16-byte aligned and the pass runs 16 bytes a load; the rest
// (all of it without vec) one entry at a time.
template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS)
    tangent_combine_kernel(const T* __restrict__ p, long long ld, long long count, int vec,
                           const double* __restrict__ scale, const double* __restrict__ w,
                           T* __restrict__ out) {
  using V = typename Pack<T>::V;
  constexpr int N = Pack<T>::kN;
  const T ws = static_cast<T>(w[0]);
  const T wn = static_cast<T>(w[1]);
  const T s_wnu = static_cast<T>(scale[0] * w[2]);
  const T s_wls = static_cast<T>(scale[0] * w[3]);
  const long long stride = static_cast<long long>(gridDim.x) * COMBINE_THREADS;
  const long long first = static_cast<long long>(blockIdx.x) * COMBINE_THREADS + threadIdx.x;
  const long long n_vec = vec ? count / N : 0;
  const V* pm = reinterpret_cast<const V*>(p);
  const V* pnu = reinterpret_cast<const V*>(p + ld);
  const V* pls = reinterpret_cast<const V*>(p + 2 * ld);
  for (long long k = first; k < n_vec; k += stride) {
    Lanes<T> a, b, c, o;
    a.v = pm[k];
    b.v = pnu[k];
    c.v = pls[k];
#pragma unroll
    for (int q = 0; q < N; ++q) {
      o.s[q] = ckt::tangent_combine(a.s[q], b.s[q], c.s[q], ws, wn, s_wnu, s_wls);
    }
    reinterpret_cast<V*>(out)[k] = o.v;
  }
  for (long long e = n_vec * N + first; e < count; e += stride) {
    out[e] = ckt::tangent_combine(p[e], p[ld + e], p[2 * ld + e], ws, wn, s_wnu, s_wls);
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
int launch_partials(const T* h, int n, int m, int symmetric, const T* table, long long ld, T* out,
                    cudaStream_t stream) {
  const size_t smem = partials_smem<T>();
  cudaError_t err = ckt::allow_smem<partials_kernel<T>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  partials_kernel<T><<<static_cast<unsigned>(ckt::num_tiles(n, m, symmetric)), THREADS, smem,
                       stream>>>(h, n, m, symmetric, static_cast<int>((m + TILE - 1) / TILE),
                                 table, ld, out);
  return static_cast<int>(cudaGetLastError());
}

// The current device's SM count, queried once per device (a combine runs
// once per Hessian row and block, a few microseconds of card time in f32).
constexpr int MAX_DEVICES = 64;
int sm_count(int& sms) {
  static int cached[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < MAX_DEVICES && cached[dev] > 0) {
    sms = cached[dev];
    return 0;
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < MAX_DEVICES) cached[dev] = sms;
  return 0;
}

// A grid of at most 8 blocks of 256 threads per SM (one resident wave),
// each thread striding through the entries.
template <typename T>
int launch_combine(const T* p, long long ld, long long count, int vec, const double* scale,
                   const double* w, T* out, cudaStream_t stream) {
  if (count <= 0) return 0;
  int sms = 0;
  const int rc = sm_count(sms);
  if (rc != 0) return rc;
  const long long work = vec ? (count + Pack<T>::kN - 1) / Pack<T>::kN : count;
  const long long need = (work + COMBINE_THREADS - 1) / COMBINE_THREADS;
  const long long cap = 8LL * sms;
  tangent_combine_kernel<T><<<static_cast<unsigned>(need < cap ? need : cap), COMBINE_THREADS, 0,
                              stream>>>(p, ld, count, vec, scale, w, out);
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

// h: a contiguous (n, m) device array (square when symmetric); table: one
// row of kv.cuh's dual table (2 x TabLayout width device values,
// kernels/cuda_ops.py::recurrence_table(order=1)); out: three (n, m)
// row-major fields at out, out + ld, out + 2 ld (the symmetric mode writes
// both triangles).
int partials_f32(const float* h, int n, int m, int symmetric, const float* table, long long ld,
                 float* out, void* stream) {
  return launch_partials<float>(h, n, m, symmetric, table, ld, out,
                                static_cast<cudaStream_t>(stream));
}

int partials_f64(const double* h, int n, int m, int symmetric, const double* table,
                 long long ld, double* out, void* stream) {
  return launch_partials<double>(h, n, m, symmetric, table, ld, out,
                                 static_cast<cudaStream_t>(stream));
}

// p: the three fields of partials_*, count entries each, field k at p + k ld;
// scale, w: the device doubles scale and (w_s, w_n, w_nu, w_ls); out: count
// entries. vec: p, p + ld, p + 2 ld and out are all 16-byte aligned.
int combine_f32(const float* p, long long ld, long long count, int vec, const double* scale,
                const double* w, float* out, void* stream) {
  return launch_combine<float>(p, ld, count, vec, scale, w, out,
                               static_cast<cudaStream_t>(stream));
}

int combine_f64(const double* p, long long ld, long long count, int vec, const double* scale,
                const double* w, double* out, void* stream) {
  return launch_combine<double>(p, ld, count, vec, scale, w, out,
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
