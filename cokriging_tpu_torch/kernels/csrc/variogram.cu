// Empirical (cross-)variogram pair pass, on the card.
//
// Replaces cokriging_tpu/kernels/pallas_ops.py::variogram_bin_pallas
// (pallas_call at :117, _make_kernel :58), built to the contract of
// cokriging_tpu/estimate/empirical.py::_all_pairs_program (:240-406): all
// comparisons run on the monotone distance surrogate h (haversine
// sin^2-term or squared Euclidean distance) formed from per-point features
// by multiply-adds only, with the thresholds transformed once on the host.
//   - minmax: min of h over valid pairs with h > h_snap, max of h over
//     valid pairs (pass 1, :308-340);
//   - bin: the cloud 0.5 (va - vb)^2 or va vb, bin = #(h_edges < h) - 1
//     clipped (searchsorted side="left", :381-383), per-bin sums (double)
//     and counts (int64) (pass 2, :363-398).
// A pair is valid when row < n, col < m, h <= h_max and, for a marginal
// (i == j) variogram, row < col.
//
// What bounds it: operations. A pair costs ~11 multiply-adds for h, a
// compare per bin edge and a shared-memory add, against no per-pair memory
// traffic at all (each block reads 128 + 128 points).
//
// Design: a block owns a 128 x 128 tile of pairs, one thread per column;
// the tile's 128 row points sit in shared memory and every thread walks
// them. Marginal pairs launch only the tiles with col-block >= row-block.
// Sums go into per-thread slots of a shared-memory histogram (no atomics),
// which the block adds up in a fixed order into one partial per tile. The
// TPU kernel carried its sum across a sequential grid; blocks here run in
// no order, so a second launch adds the per-tile partials in a fixed order:
// the result is the same from run to run, and so is the fit built on it.
// The histogram holds at most MAX_BINS bins; a call bins one window of at
// most that many consecutive bins (its n_win + 1 sorted edges place every
// pair below, inside or above the window), and the caller walks the windows.
// h is formed with explicitly rounded operations (no fused multiply-add) so
// it equals, bit for bit, the plain torch version's h: the pair counts of
// the two agree exactly.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int VT = 128;          // tile edge (rows and columns); threads per block
constexpr int MAX_BINS = 24;     // per-thread histogram slots in shared memory
constexpr int RED_THREADS = 256;

template <typename T> __device__ __forceinline__ T mul_rn(T a, T b);
template <> __device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
template <> __device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
template <typename T> __device__ __forceinline__ T add_rn(T a, T b);
template <> __device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
template <> __device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
template <typename T> __device__ __forceinline__ T sub_rn(T a, T b);
template <> __device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
template <> __device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// Geodesic features [sin(lat/2), cos(lat/2), sin(lon/2), cos(lon/2), cos(lat)]
// give h = x^2 + cos(lat_a) cos(lat_b) y^2 with x = sin(dlat/2), y = sin(dlon/2);
// Euclidean features [x, y] give the squared distance.
template <typename T, bool GEO>
__device__ __forceinline__ T h_pair(const T* fa, const T* fb) {
  if (GEO) {
    const T x = sub_rn(mul_rn(fa[0], fb[1]), mul_rn(fa[1], fb[0]));
    const T y = sub_rn(mul_rn(fa[2], fb[3]), mul_rn(fa[3], fb[2]));
    return add_rn(mul_rn(x, x), mul_rn(mul_rn(fa[4], fb[4]), mul_rn(y, y)));
  }
  const T dx = sub_rn(fa[0], fb[0]);
  const T dy = sub_rn(fa[1], fb[1]);
  return add_rn(mul_rn(dx, dx), mul_rn(dy, dy));
}

__host__ __device__ inline void tile_grid(int n, int m, int marginal, int& nr,
                                          int& nc, long long& n_tiles) {
  nr = (n + VT - 1) / VT;
  nc = (m + VT - 1) / VT;
  n_tiles = marginal ? static_cast<long long>(nr) * (nr + 1) / 2
                     : static_cast<long long>(nr) * nc;
}

// Linear tile index -> (row block, col block); marginal tiles have cb >= rb.
__device__ __forceinline__ void tile_coords(int t, int nr, int nc, int marginal,
                                            int& rb, int& cb) {
  if (!marginal) {
    rb = t / nc;
    cb = t % nc;
    return;
  }
  rb = 0;
  int rem = t;
  while (rem >= nr - rb) {
    rem -= nr - rb;
    ++rb;
  }
  cb = rb + rem;
}

template <typename T> __device__ __forceinline__ T warp_min(T v) {
  for (int o = 16; o > 0; o >>= 1) {
    const T w = __shfl_down_sync(0xffffffffu, v, o);
    v = w < v ? w : v;
  }
  return v;
}
template <typename T> __device__ __forceinline__ T warp_max(T v) {
  for (int o = 16; o > 0; o >>= 1) {
    const T w = __shfl_down_sync(0xffffffffu, v, o);
    v = w > v ? w : v;
  }
  return v;
}

template <typename T, bool GEO, int F>
__global__ void minmax_kernel(const T* __restrict__ fa, const T* __restrict__ fb,
                              int n, int m, int nr, int nc, int marginal, T h_max,
                              T h_snap, T* __restrict__ part_min,
                              T* __restrict__ part_max) {
  __shared__ T sfa[VT * F];
  __shared__ T wmin[VT / 32];
  __shared__ T wmax[VT / 32];
  int rb, cb;
  tile_coords(blockIdx.x, nr, nc, marginal, rb, cb);
  const int tid = threadIdx.x;
  const int r0 = rb * VT;
  if (r0 + tid < n) {
    for (int f = 0; f < F; ++f) sfa[tid * F + f] = fa[static_cast<size_t>(r0 + tid) * F + f];
  }
  __syncthreads();
  const int col = cb * VT + tid;
  T hmin = INFINITY;
  T hmax = -INFINITY;
  if (col < m) {
    T fbr[F];
    for (int f = 0; f < F; ++f) fbr[f] = fb[static_cast<size_t>(col) * F + f];
    int rows = n - r0 < VT ? n - r0 : VT;
    if (marginal && col - r0 < rows) rows = col - r0;  // row < col
    for (int r = 0; r < rows; ++r) {
      const T h = h_pair<T, GEO>(&sfa[r * F], fbr);
      if (h <= h_max) {
        hmax = h > hmax ? h : hmax;
        if (h > h_snap) hmin = h < hmin ? h : hmin;
      }
    }
  }
  hmin = warp_min(hmin);
  hmax = warp_max(hmax);
  if ((tid & 31) == 0) {
    wmin[tid >> 5] = hmin;
    wmax[tid >> 5] = hmax;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < VT / 32; ++w) {
      hmin = wmin[w] < hmin ? wmin[w] : hmin;
      hmax = wmax[w] > hmax ? wmax[w] : hmax;
    }
    part_min[blockIdx.x] = hmin;
    part_max[blockIdx.x] = hmax;
  }
}

template <typename T>
__global__ void minmax_reduce_kernel(const T* __restrict__ part_min,
                                     const T* __restrict__ part_max,
                                     long long n_parts, T* __restrict__ out) {
  __shared__ T smin[RED_THREADS / 32];
  __shared__ T smax[RED_THREADS / 32];
  T hmin = INFINITY;
  T hmax = -INFINITY;
  for (long long k = threadIdx.x; k < n_parts; k += RED_THREADS) {
    hmin = part_min[k] < hmin ? part_min[k] : hmin;
    hmax = part_max[k] > hmax ? part_max[k] : hmax;
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
      hmin = smin[w] < hmin ? smin[w] : hmin;
      hmax = smax[w] > hmax ? smax[w] : hmax;
    }
    out[0] = hmin;
    out[1] = hmax;
  }
}

template <typename T, bool GEO, int F>
__global__ void bin_kernel(const T* __restrict__ fa, const T* __restrict__ fb,
                           const T* __restrict__ va, const T* __restrict__ vb,
                           const T* __restrict__ h_edges, int n_bins, int first,
                           int last, int n, int m, int nr, int nc, int marginal,
                           int covariogram, T h_max,
                           double* __restrict__ part_sums,
                           long long* __restrict__ part_counts) {
  // n_bins, h_edges: this window's bins and its n_bins + 1 edges; first /
  // last: the window holds the first / last bin of all, which take the
  // pairs clipped from below / above
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* hist_sum = reinterpret_cast<double*>(smem_raw);     // [n_bins][VT]
  int* hist_cnt = reinterpret_cast<int*>(hist_sum + n_bins * VT);  // [n_bins][VT]
  __shared__ T sfa[VT * F];
  __shared__ T sva[VT];
  __shared__ T sedge[MAX_BINS + 1];

  int rb, cb;
  tile_coords(blockIdx.x, nr, nc, marginal, rb, cb);
  const int tid = threadIdx.x;
  const int r0 = rb * VT;
  for (int b = 0; b < n_bins; ++b) {
    hist_sum[b * VT + tid] = 0.0;
    hist_cnt[b * VT + tid] = 0;
  }
  if (r0 + tid < n) {
    for (int f = 0; f < F; ++f) sfa[tid * F + f] = fa[static_cast<size_t>(r0 + tid) * F + f];
    sva[tid] = va[r0 + tid];
  }
  if (tid <= n_bins) sedge[tid] = h_edges[tid];
  __syncthreads();

  const int col = cb * VT + tid;
  if (col < m) {
    T fbr[F];
    for (int f = 0; f < F; ++f) fbr[f] = fb[static_cast<size_t>(col) * F + f];
    const T vbc = vb[col];
    int rows = n - r0 < VT ? n - r0 : VT;
    if (marginal && col - r0 < rows) rows = col - r0;  // row < col
    for (int r = 0; r < rows; ++r) {
      const T h = h_pair<T, GEO>(&sfa[r * F], fbr);
      if (!(h <= h_max)) continue;
      int idx = -1;
      for (int k = 0; k <= n_bins; ++k) idx += sedge[k] < h ? 1 : 0;
      if (idx < 0) {
        if (!first) continue;  // a lower window's pair
        idx = 0;
      } else if (idx > n_bins - 1) {
        if (!last) continue;  // a higher window's pair
        idx = n_bins - 1;
      }
      T cloud;
      if (covariogram) {
        cloud = mul_rn(sva[r], vbc);
      } else {
        const T diff = sub_rn(sva[r], vbc);
        cloud = mul_rn(mul_rn(T(0.5), diff), diff);
      }
      hist_sum[idx * VT + tid] += static_cast<double>(cloud);
      hist_cnt[idx * VT + tid] += 1;
    }
  }
  __syncthreads();
  // per-bin block sums in a fixed order: warp w takes bins w, w + 4, ...
  const int lane = tid & 31;
  for (int b = tid >> 5; b < n_bins; b += VT / 32) {
    double s = 0.0;
    long long c = 0;
    for (int k = lane; k < VT; k += 32) {
      s += hist_sum[b * VT + k];
      c += hist_cnt[b * VT + k];
    }
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, o);
      c += __shfl_down_sync(0xffffffffu, c, o);
    }
    if (lane == 0) {
      part_sums[static_cast<size_t>(blockIdx.x) * n_bins + b] = s;
      part_counts[static_cast<size_t>(blockIdx.x) * n_bins + b] = c;
    }
  }
}

// One block per bin adds the per-tile partials in a fixed order.
__global__ void bin_reduce_kernel(const double* __restrict__ part_sums,
                                  const long long* __restrict__ part_counts,
                                  long long n_parts, int n_bins,
                                  double* __restrict__ sums,
                                  long long* __restrict__ counts) {
  __shared__ double ss[RED_THREADS];
  __shared__ long long sc[RED_THREADS];
  const int b = blockIdx.x;
  double s = 0.0;
  long long c = 0;
  for (long long k = threadIdx.x; k < n_parts; k += RED_THREADS) {
    s += part_sums[k * n_bins + b];
    c += part_counts[k * n_bins + b];
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
    sums[b] = ss[0];
    counts[b] = sc[0];
  }
}

template <typename T>
int minmax(const T* fa, const T* fb, int n, int m, int geodesic, int marginal,
           T h_max, T h_snap, T* part_min, T* part_max, T* out,
           cudaStream_t stream) {
  int nr, nc;
  long long n_tiles;
  tile_grid(n, m, marginal, nr, nc, n_tiles);
  const unsigned grid = static_cast<unsigned>(n_tiles);
  if (geodesic) {
    minmax_kernel<T, true, 5><<<grid, VT, 0, stream>>>(
        fa, fb, n, m, nr, nc, marginal, h_max, h_snap, part_min, part_max);
  } else {
    minmax_kernel<T, false, 2><<<grid, VT, 0, stream>>>(
        fa, fb, n, m, nr, nc, marginal, h_max, h_snap, part_min, part_max);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  minmax_reduce_kernel<T><<<1, RED_THREADS, 0, stream>>>(part_min, part_max,
                                                         n_tiles, out);
  return static_cast<int>(cudaGetLastError());
}

// Bins the window of at most MAX_BINS bins that starts at bin0; h_edges,
// sums and counts are the arrays of all n_bins bins.
template <typename T>
int bin(const T* fa, const T* fb, const T* va, const T* vb, const T* h_edges,
        int n_bins, int bin0, int n, int m, int geodesic, int marginal,
        int covariogram, T h_max, double* part_sums, long long* part_counts,
        double* sums, long long* counts, cudaStream_t stream) {
  if (n_bins < 1 || bin0 < 0 || bin0 >= n_bins) return static_cast<int>(cudaErrorInvalidValue);
  const int n_win = n_bins - bin0 < MAX_BINS ? n_bins - bin0 : MAX_BINS;
  const int first = bin0 == 0;
  const int last = bin0 + n_win == n_bins;
  h_edges += bin0;
  sums += bin0;
  counts += bin0;
  int nr, nc;
  long long n_tiles;
  tile_grid(n, m, marginal, nr, nc, n_tiles);
  const unsigned grid = static_cast<unsigned>(n_tiles);
  const size_t smem = static_cast<size_t>(n_win) * VT * (sizeof(double) + sizeof(int));
  if (geodesic) {
    bin_kernel<T, true, 5><<<grid, VT, smem, stream>>>(
        fa, fb, va, vb, h_edges, n_win, first, last, n, m, nr, nc, marginal,
        covariogram, h_max, part_sums, part_counts);
  } else {
    bin_kernel<T, false, 2><<<grid, VT, smem, stream>>>(
        fa, fb, va, vb, h_edges, n_win, first, last, n, m, nr, nc, marginal,
        covariogram, h_max, part_sums, part_counts);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bin_reduce_kernel<<<n_win, RED_THREADS, 0, stream>>>(part_sums, part_counts,
                                                       n_tiles, n_win, sums,
                                                       counts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

long long vario_num_tiles(int n, int m, int marginal) {
  int nr, nc;
  long long n_tiles;
  tile_grid(n, m, marginal, nr, nc, n_tiles);
  return n_tiles;
}

int vario_max_bins() { return MAX_BINS; }

int vario_minmax_f32(const float* fa, const float* fb, int n, int m,
                     int geodesic, int marginal, float h_max, float h_snap,
                     float* part_min, float* part_max, float* out,
                     void* stream) {
  return minmax<float>(fa, fb, n, m, geodesic, marginal, h_max, h_snap,
                       part_min, part_max, out,
                       static_cast<cudaStream_t>(stream));
}

int vario_minmax_f64(const double* fa, const double* fb, int n, int m,
                     int geodesic, int marginal, double h_max, double h_snap,
                     double* part_min, double* part_max, double* out,
                     void* stream) {
  return minmax<double>(fa, fb, n, m, geodesic, marginal, h_max, h_snap,
                        part_min, part_max, out,
                        static_cast<cudaStream_t>(stream));
}

int vario_bin_f32(const float* fa, const float* fb, const float* va,
                  const float* vb, const float* h_edges, int n_bins, int bin0,
                  int n, int m, int geodesic, int marginal, int covariogram,
                  float h_max, double* part_sums, long long* part_counts,
                  double* sums, long long* counts, void* stream) {
  return bin<float>(fa, fb, va, vb, h_edges, n_bins, bin0, n, m, geodesic,
                    marginal, covariogram, h_max, part_sums, part_counts, sums,
                    counts, static_cast<cudaStream_t>(stream));
}

int vario_bin_f64(const double* fa, const double* fb, const double* va,
                  const double* vb, const double* h_edges, int n_bins, int bin0,
                  int n, int m, int geodesic, int marginal, int covariogram,
                  double h_max, double* part_sums, long long* part_counts,
                  double* sums, long long* counts, void* stream) {
  return bin<double>(fa, fb, va, vb, h_edges, n_bins, bin0, n, m, geodesic,
                     marginal, covariogram, h_max, part_sums, part_counts,
                     sums, counts, static_cast<cudaStream_t>(stream));
}

const char* vario_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
