// Scatter-accumulate of sparse top-k payloads, for Hopper (sm_90a):
//
//     out[i] = sum_m beta[m] * v      over the (i, v) pairs of row m
//     idx: (M, k) int32, vals: (M, k) fp32, beta: (M,) fp32, out: (n,) fp32
//
// The JAX package has no Pallas kernel for this: src/repro/kernels/ops.py
// sends every dispatch mode of topk_fedagg to src/repro/kernels/ref.py:55,
// a lax.scan over m of out.at[idx[m]].add(beta[m] * vals[m]) from zeros.
// This kernel keeps that contract bit for bit: every touched output is the
// left fold acc = acc + beta[m] * v over m = 0..M-1 in order, from exact
// zero, each product and each sum rounded once (__fmul_rn, __fadd_rn, so
// nvcc contracts nothing into an FMA); untouched outputs are exactly 0.
// No atomics: an atomic add would reorder the fold across participants.
//
// Bound: memory.  Each pair costs one multiply and one add for 8 bytes
// read, so the least time is
//     bytes / 3.35 TB/s,   bytes = 8*M*k + 4*n + 4*M.
// Design: one cooperative launch of at most as many 256-thread blocks as
// the card holds at once, in three phases split by grid-wide barriers:
//   0. zero the per-row flags;
//   1. check every row (strictly ascending, every index in [0, n): what
//      TopKCodec sends) and flag the rows that are not, and record where
//      each row enters each tile of kTile outputs (the row's offsets,
//      M * (n_tiles + 1) ints): position j starts the tiles after the one
//      of index j - 1 up to its own.  A warp reads 256 consecutive indices
//      of the flattened rows at a time, lane l the indices l + 32 i, so the
//      loads coalesce, and takes each index's neighbours from the next and
//      previous lanes.  On a flagged row the offsets are not read (an
//      unsorted row may write up to k * n_tiles / 2 of them);
//   2. each block takes tiles of kTile outputs in turn and accumulates a
//      tile in shared memory.  It stages the tile's (index, value) pairs of
//      as many consecutive rows as fit in kStage into shared memory with
//      cp.async, all copies in flight at once (a sorted row has at most
//      kTile pairs in a tile), then folds them: for m in order its threads
//      add row m's pairs, then __syncthreads().  A row holds each index
//      once, so no two threads add into one slot.  A flagged row is scanned
//      whole by every block, which adds the pairs that fall in its tile:
//      slow, but the sum stays right.  An index outside [0, n) falls in no
//      tile and is dropped: nothing is written out of bounds.  The tile is
//      written to out once.
// So every (index, value) pair of a sorted row is read once in phase 2 (and
// its index once more in phase 1), and out is written once.
//
// C interface (bound with ctypes): topk_fedagg_f32(idx, vals, betas, out,
// work, M, k, n, work_ints, stream) with work an int32 scratch of
// M * (n_tiles + 2) ints, n_tiles = ceil(n / kTile); returns a CUDA error
// code (cudaErrorInvalidValue for bad sizes, a workspace too small
// included).  kTile is ops.TOPK_TILE on the Python side.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;                  // outputs per tile
constexpr int kStage = 4096;                 // pairs staged at once, >= kTile
constexpr int kRowChunk = kThreads;          // row offsets staged at once

// the tile of index a: -1 below 0, n_tiles from n on
__device__ __forceinline__ int tile_of(int a, int n, int n_tiles) {
  return a < 0 ? -1 : (a >= n ? n_tiles : a / kTile);
}

__global__ void __launch_bounds__(kThreads)
    topk_fedagg_kernel(const int* __restrict__ idx,
                       const float* __restrict__ vals,
                       const float* __restrict__ betas,
                       float* __restrict__ out, int* flags, int* offs,
                       int M, int k, int n, int n_tiles) {
  __shared__ float acc[kTile];
  __shared__ int s_idx[kStage];
  __shared__ float s_val[kStage];
  __shared__ int lo_s[kRowChunk], len_s[kRowChunk];   // len -1: flagged
  __shared__ float beta_s[kRowChunk];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int64_t gtid = static_cast<int64_t>(blockIdx.x) * kThreads + tid;
  const int64_t gstride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t row_offs = static_cast<int64_t>(n_tiles) + 1;

  // phase 0
  for (int64_t m = gtid; m < M; m += gstride) flags[m] = 0;
  grid.sync();

  // phase 1: flag rows that are not strictly ascending in [0, n), and
  // find where each row enters each tile
  const int lane = tid & 31;
  const int64_t Mk = static_cast<int64_t>(M) * k;
  for (int64_t base = gtid / 32 * 256; base < Mk; base += gstride / 32 * 256) {
    int v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t p = base + lane + 32 * i;
      v[i] = p < Mk ? idx[p] : 0;
    }
    const int after = __shfl_sync(
        0xffffffffu, lane == 0 && base + 256 < Mk ? idx[base + 256] : 0, 0);
    const int before = __shfl_sync(
        0xffffffffu, lane == 0 && base > 0 ? idx[base - 1] : 0, 0);
    const int64_t m0 = base / k, j0 = base - m0 * k;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      // index p + 1 (lane 31: lane 0's next one) and p - 1
      const int nx_wrap = __shfl_sync(0xffffffffu, v[i < 7 ? i + 1 : 7], 0);
      const int pv_wrap = __shfl_sync(0xffffffffu, v[i > 0 ? i - 1 : 0], 31);
      int nx = __shfl_down_sync(0xffffffffu, v[i], 1);
      int pv = __shfl_up_sync(0xffffffffu, v[i], 1);
      if (lane == 31) nx = i < 7 ? nx_wrap : after;
      if (lane == 0) pv = i > 0 ? pv_wrap : before;
      const int64_t p = base + lane + 32 * i;
      if (p >= Mk) continue;
      int64_t m = m0, j = j0 + lane + 32 * i;   // p's row and position
      if (k < 256) {
        m = p / k;
        j = p - m * k;
      } else if (j >= k) {
        j -= k;
        ++m;
      }
      const int a = v[i];
      const bool last = j == k - 1;
      if (a < 0 || a >= n || (!last && a >= nx)) flags[m] = 1;
      int* off = offs + m * row_offs;
      const int tc = tile_of(a, n, n_tiles);
      const int tp = j == 0 ? -1 : tile_of(pv, n, n_tiles);
      for (int t = tp + 1; t <= tc && t <= n_tiles; ++t)
        off[t] = static_cast<int>(j);
      if (last)
        for (int t = tc + 1 > 0 ? tc + 1 : 0; t <= n_tiles; ++t) off[t] = k;
    }
  }
  grid.sync();

  // phase 2
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int t0 = tile * kTile;
    const int len = n - t0 < kTile ? n - t0 : kTile;
    for (int i = tid; i < kTile; i += kThreads) acc[i] = 0.f;
    for (int r0 = 0; r0 < M; r0 += kRowChunk) {
      const int rows = M - r0 < kRowChunk ? M - r0 : kRowChunk;
      __syncthreads();  // the tile is zeroed; the last chunk's offsets used
      if (tid < rows) {
        const int64_t m = r0 + tid;
        const int64_t o = m * row_offs + tile;
        lo_s[tid] = offs[o];
        len_s[tid] = flags[m] != 0 ? -1 : offs[o + 1] - offs[o];
        beta_s[tid] = betas[m];
      }
      __syncthreads();
      for (int r = 0; r < rows;) {
        if (len_s[r] < 0 || len_s[r] > kStage) {  // flagged: scan it whole
          const int* row = idx + static_cast<int64_t>(r0 + r) * k;
          const float* vrow = vals + static_cast<int64_t>(r0 + r) * k;
          const float c = beta_s[r];
          for (int j = tid; j < k; j += kThreads) {
            const int a = row[j];
            if (a >= t0 && a - t0 < len)
              acc[a - t0] = __fadd_rn(acc[a - t0], __fmul_rn(c, vrow[j]));
          }
          __syncthreads();  // row r is in before row r + 1 adds
          ++r;
          continue;
        }
        // the group [r, g1): consecutive sorted rows whose pairs fit
        int g1 = r, total = 0;
        while (g1 < rows && len_s[g1] >= 0 && total + len_s[g1] <= kStage)
          total += len_s[g1++];
        int base = 0;
        for (int q = r; q < g1; ++q) {
          const int64_t src = static_cast<int64_t>(r0 + q) * k + lo_s[q];
          for (int j = tid; j < len_s[q]; j += kThreads) {
            hopper::cp_async4(&s_idx[base + j], idx + src + j);
            hopper::cp_async4(&s_val[base + j], vals + src + j);
          }
          base += len_s[q];
        }
        hopper::cp_async_commit();
        hopper::cp_async_wait<0>();
        __syncthreads();
        base = 0;
        for (int q = r; q < g1; ++q) {
          const float c = beta_s[q];
          for (int j = tid; j < len_s[q]; j += kThreads) {
            const int a = s_idx[base + j] - t0;
            if (a >= 0 && a < len)
              acc[a] = __fadd_rn(acc[a], __fmul_rn(c, s_val[base + j]));
          }
          base += len_s[q];
          __syncthreads();  // row q is in before row q + 1 adds; the last
                            // sync also frees the stage for the next group
        }
        r = g1;
      }
    }
    for (int i = tid; i < len; i += kThreads) out[t0 + i] = acc[i];
    __syncthreads();  // the tile is read before the next one zeroes it
  }
}

int max_grid() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, topk_fedagg_kernel, kThreads, 0) != cudaSuccess)
      return 0;
    cached[dev] = sms * per_sm;
  }
  return cached[dev];
}

}  // namespace

extern "C" {

int topk_fedagg_f32(const void* idxv, const void* valsv, const void* betasv,
                    void* outv, void* workv, int64_t M, int64_t k, int64_t n,
                    int64_t work_ints, void* streamv) {
  if (M <= 0 || k <= 0 || n <= 0 || M > INT32_MAX || k > INT32_MAX ||
      n > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  if (work_ints < M * (n_tiles + 2)) return static_cast<int>(cudaErrorInvalidValue);
  const int cap = max_grid();
  if (cap <= 0) return static_cast<int>(cudaGetLastError());
  // enough blocks for the tiles and for phase 1's M*k checks (8 a thread),
  // at most as many as the card holds at once (a cooperative launch needs
  // them all)
  const int64_t checks = M * k / (8 * kThreads);
  int64_t want = n_tiles > checks ? n_tiles : checks;
  if (want < 1) want = 1;
  const int grid = static_cast<int>(want < cap ? want : cap);
  const int* idx = static_cast<const int*>(idxv);
  const float* vals = static_cast<const float*>(valsv);
  const float* betas = static_cast<const float*>(betasv);
  float* out = static_cast<float*>(outv);
  int* flags = static_cast<int*>(workv);
  int* offs = flags + M;
  int Mi = static_cast<int>(M), ki = static_cast<int>(k),
      ni = static_cast<int>(n), ti = static_cast<int>(n_tiles);
  void* args[] = {&idx, &vals, &betas, &out, &flags, &offs,
                  &Mi, &ki, &ni, &ti};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(topk_fedagg_kernel), dim3(grid),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(streamv));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
