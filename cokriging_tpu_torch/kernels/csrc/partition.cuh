// A stable counting sort of one tile's entries by a small key, in shared
// memory: the branch partition of every Matern kernel (matern.cu, the
// tiled sums of tile_sum.cuh, matern_hess.cu's tangent, and the
// gathered-pairs forward and gradient in matern_pairs.cu).
//
// The Matern entry runs a serial Temme series or Steed CF2 whose length
// depends on its pair and on x; unsorted points put both branches and many
// CF2 lengths in one warp, which then pays for all of them. Sorting a tile's
// local indices by (pair, branch, CF2 bin of x) makes 32 consecutive sorted
// slots one pair and one branch, apart from at most one boundary warp per
// bucket. The order inside a bucket is the tile's, so the sorted order is a
// fixed function of the tile's contents.
#pragma once

#include <cuda_runtime.h>

namespace ckt {

// keys at or above a partition's n_keys are left out of it
constexpr unsigned char kNoKey = 0xff;

// Sorts the local indices e in [0, n) by key[e] into perm (keys >= n_keys
// are left out) and returns how many were placed. WARPS warps; warp w ranks
// the entries [w SEG, (w + 1) SEG), SEG = 32 ITEMS, in order: per round of 32
// a lane's rank among equal keys comes from __match_any_sync, and the warp's
// running count per key sits in its own row of cnt. Warp 0 then turns the
// (warp, key) counts into offsets: per key across the warps, then an
// exclusive scan across the keys. cnt holds WARPS * n_keys ints of shared
// scratch, total one int; key and perm hold WARPS * SEG entries. Starts and
// ends with a barrier, so key may be written just before.
template <int WARPS, int ITEMS>
__device__ __forceinline__ int stable_partition(const unsigned char* key, int n, int n_keys,
                                                unsigned short* perm, int* cnt, int* total) {
  constexpr int SEG = 32 * ITEMS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  for (int i = threadIdx.x; i < WARPS * n_keys; i += WARPS * 32) cnt[i] = 0;
  __syncthreads();
  int* mine = cnt + warp * n_keys;
  int rank[ITEMS];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int e = warp * SEG + r * 32 + lane;
    const int k = e < n ? key[e] : kNoKey;
    const unsigned same = __match_any_sync(0xffffffffu, k);
    rank[r] = k < n_keys ? mine[k] + __popc(same & lower) : 0;
    __syncwarp();
    if (k < n_keys && (same & lower) == 0) mine[k] += __popc(same);
    __syncwarp();
  }
  __syncthreads();
  if (warp == 0) {
    int carry = 0;
    for (int k0 = 0; k0 < n_keys; k0 += 32) {
      const int k = k0 + lane;
      int run = 0;
      if (k < n_keys) {
        for (int w = 0; w < WARPS; ++w) {
          const int c = cnt[w * n_keys + k];
          cnt[w * n_keys + k] = run;
          run += c;
        }
      }
      int inc = run;
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += v;
      }
      const int start = carry + inc - run;
      if (k < n_keys) {
        for (int w = 0; w < WARPS; ++w) cnt[w * n_keys + k] += start;
      }
      carry += __shfl_sync(0xffffffffu, inc, 31);
    }
    if (lane == 0) *total = carry;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int e = warp * SEG + r * 32 + lane;
    const int k = e < n ? key[e] : kNoKey;
    if (k < n_keys) perm[mine[k] + rank[r]] = static_cast<unsigned short>(e);
  }
  __syncthreads();
  return *total;
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current device
// (above 48 KB it must be asked for), once per device and kernel.
template <auto kernel>
inline cudaError_t allow_smem(size_t bytes) {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

// The bucket of an entry at x = sqrt(2 nu) h / ls: 0 for the series (x < 2),
// 1 .. CF2_BINS for CF2 by half-octaves of x from 2 (its trip count falls
// as x grows); NaN goes to bucket 1.
template <int CF2_BINS, typename T>
__device__ __forceinline__ int x_bucket(T x) {
  if (x < T(2)) return 0;
  const float b = fminf(fmaxf(2.0f * __log2f(static_cast<float>(x)) - 2.0f, 0.0f),
                        static_cast<float>(CF2_BINS - 1));
  return 1 + static_cast<int>(b);
}

}  // namespace ckt
