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
// Design: tile_sum.cuh's tiled weighted sum, one block of 256 threads per
// 64 x 64 tile, with GradStep below as its per-entry step: entries at
// h == 0 (or not > 0) add their M = 1 terms at once, the rest are sorted by
// series or CF2 half-octave of x, so a warp runs one branch with like CF2
// trip counts, where the unsorted points of a month left nearly every warp
// with both. The dual pass is kv.cuh's table-driven one
// (matern_partials_tab): the per-(nu, ls) dual table, built on the card by
// the wrapper, sits in shared memory and no series or CF2 trip divides by a
// function of mu. Per-tile partials in double and a fixed-order second
// launch: no floating-point atomics, and a gradient is the same from run to
// run. The TPU kernel carried its sums across a sequential grid and read a
// cotangent folded beforehand into the lower triangle,
// tril(ct + ct^T) - diag(ct); blocks here run in no order and the symmetric
// mode launches only the lower-triangle tiles with w = ct[i, j] + ct[j, i]
// below the diagonal and ct[i, i] on it.
#include <cuda_runtime.h>

#include "kv.cuh"
#include "tile_sum.cuh"

namespace {

// The four terms of an entry: M, [h == 0], dM/dnu, dM/dls.
template <typename T> struct GradStep {
  static constexpr int kOut = 4;
  static constexpr int kRows = 2;
  using Row = ckt::DualRow<T>;
  __device__ __forceinline__ static void constant(bool at_zero, T w, T* acc) {
    acc[0] += w;  // M = 1
    if (at_zero) acc[1] += w;
  }
  __device__ __forceinline__ static void entry(T x, T w, const Row& row, T* acc) {
    T mv, dm_dnu, dm_dls;
    if (ckt::matern_partials_tab(x, row, mv, dm_dnu, dm_dls)) {
      acc[0] += w * mv;
      if (isfinite(dm_dnu)) acc[2] += w * dm_dnu;
      if (isfinite(dm_dls)) acc[3] += w * dm_dls;
    }  // else M counts as 0 and the entry has no nu, ls terms
  }
};

// outputs 2 and 3 are scaled by the device value *scale
template <typename T>
int launch(const T* h, const T* ct, int n, int m, long long ld_h, long long ld_ct,
           int symmetric, const T* table, const double* scale, double* part, double* out,
           cudaStream_t stream) {
  return ckt::launch_tile_sum<T, GradStep<T>>(h, ct, n, m, ld_h, ld_ct, symmetric, table,
                                              scale, 2, part, out, stream);
}

}  // namespace

extern "C" {

long long matern_grad_num_tiles(int n, int m, int symmetric) {
  return ckt::num_tiles(n, m, symmetric);
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
