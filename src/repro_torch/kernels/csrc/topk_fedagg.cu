// Scatter-accumulate of sparse top-k payloads, for Hopper (sm_90a), over
// every leaf of a flush at once:
//
//     acc_l[i] = acc_l[i] + fold_l[i],   fold_l[i] = sum_m beta[m] * v
//                                         over the (i, v) pairs of row (m, l)
//
// Row (m, l) is participant m's leaf l: k_l int32 indices and k_l fp32
// values, each a tensor of its own, read where it lies through a table of
// row pointers (or, for one leaf, the rows of two (M, k) matrices).  With
// `accumulate` 0 the kernel writes fold_l itself (the one-leaf entry
// ops.topk_fedagg, into a fresh output).
//
// The JAX package has no Pallas kernel for this: src/repro/kernels/ops.py
// sends every dispatch mode of topk_fedagg to src/repro/kernels/ref.py:55,
// a lax.scan over m of out.at[idx[m]].add(beta[m] * vals[m]) from zeros, and
// its StreamAccumulator adds that to the accumulator leaf by leaf.  This
// kernel keeps that contract bit for bit: every touched output of fold_l is
// the left fold f = f + beta[m] * v over m = 0..M-1 in order, from exact
// zero, each product and each sum rounded once (__fmul_rn, __fadd_rn, so
// nvcc contracts nothing into an FMA); untouched outputs of fold_l are +0;
// then acc + fold is one more __fadd_rn (acc.add_(part)).  No atomics: an
// atomic add would reorder the fold across participants.
//
// Bound: memory.  Each pair costs one multiply and one add for 8 bytes read,
// so the least time of a flush is
//     bytes / 3.35 TB/s,   bytes = 8 * M * sum(k_l) + 8 * sum(n_l)
// (4 * sum(n_l) with accumulate 0).  This design reads the indices twice, so
// its own floor is 12 * M * sum(k_l) + 8 * sum(n_l) bytes.
//
// Design: two ordinary launches on the caller's stream, no grid barrier,
// one launch count.  The leaves share one space of tiles of kTile outputs (a
// leaf table gives each leaf's n, k, first tile, first offset and first
// check unit), so the small leaves of a model (GroupNorm scales, biases)
// share waves with the large ones instead of paying a launch each.
//   1. topk_check_kernel: a warp takes kCheck consecutive positions of one
//      row, a lane four at a time as one int4 (the row's 16-byte grid: a
//      row may start off 16 bytes), neighbours by shuffles.  It stamps the
//      row's flag with this flush's `epoch` if the row is not strictly
//      ascending in [0, n), and records where the row enters each tile (its
//      offsets, n_tiles + 1 ints a row: position j starts the tiles after
//      the one of index j - 1 up to its own).  A row spans many warps and
//      only the warps that see a fault write its flag, so flags hold the
//      epoch of the flush that found the row bad and are never cleared (the
//      workspace is zeroed once, when allocated).  The stream orders this
//      kernel before the next, in place of a grid barrier.
//   2. topk_fold_kernel: persistent blocks (as many as the card holds at
//      once) take tiles blockIdx.x, + gridDim.x, ..  Warp 0 plans each
//      (tile, kRows rows): lane q reads row q's offsets, flag, pointers and
//      beta one unit ahead; a prefix sum and a ballot cut the rows into
//      groups of consecutive sorted rows whose segments of the tile fit one
//      stage buffer, each segment placed at its source's offset mod 16
//      bytes.  Groups run through two stage buffers: while the block
//      folds one, warp 0 stages the next, the 16-byte-aligned middle of each
//      segment as one 1-D bulk copy (cp.async.bulk, completing on the
//      buffer's mbarrier) and the ragged ends (at most 3 elements a side) by
//      4-byte cp.async.  The block folds a group row after row, thread t the
//      row's pairs t, t + kThreads, ..; a row holds each index once, so no
//      two threads add into one slot, and one block barrier between rows
//      keeps participant order (a warp-per-slice fold with __syncwarp
//      between rows was slower: its per-row overhead is paid by 8 warps).
//      A flagged row is its own group: every thread scans the whole row from
//      device memory and adds the pairs that fall in the tile (slow, but the
//      sum stays right); an index outside [0, n) falls in no tile and is
//      dropped.  The tile is written once: acc + fold (or fold).
//
// C interface (bound with ctypes):
//   topk_fedagg_geometry(which): kTile (0), kCheck (1), so that ops.py sizes
//     the leaf table and the workspace from this file;
//   topk_fedagg_flush(table, rows, betas, work, idx, vals, out, L, M, T, C,
//     S, work_ints, epoch, accumulate, stream): table the int32 leaf table
//     (n[L], k[L], tile_base[L], off_base[L], unit_base[L], tile_leaf[T],
//     unit_leaf[C]), rows the int64 row table (idx rows m * L + l, then
//     value rows, then the L outputs) or null with L = 1 and the (M, k)
//     matrices idx, vals and the output out, betas M fp32, work L * M flags
//     then M * S offsets (S = sum(n_tiles + 1)); returns a CUDA error code
//     (cudaErrorInvalidValue for bad sizes, a workspace too small included).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kCheckThreads = 256;        // check kernel: a block's threads
constexpr int kCheckWarps = kCheckThreads / 32;
constexpr int kThreads = 128;             // fold kernel: a block's threads
constexpr int kTile = 1024;               // outputs per tile
constexpr int kTileShift = 10;            // log2(kTile)
static_assert(kTile == 8 * kThreads, "a fold thread writes 2 float4 of a tile");
constexpr int kStage = kTile + 8;         // pairs per stage buffer: a sorted
                                          // row's segment and its pads
constexpr int kRows = 32;                 // rows planned at once (a warp)
constexpr int kCheck = 1024;              // positions a warp checks at once
constexpr int kVecs = kCheck / 128;       // int4 a lane reads per unit

struct Leaf {
  int n, k, tile_base, off_base, unit_base;
};

__device__ __forceinline__ Leaf leaf_of(const int* __restrict__ table, int L,
                                        int l) {
  return {__ldg(table + l), __ldg(table + L + l), __ldg(table + 2 * L + l),
          __ldg(table + 3 * L + l), __ldg(table + 4 * L + l)};
}

// where the rows and outputs lie: a table of pointers (idx rows m * L + l,
// then value rows, then the L outputs), or for one leaf (rows == nullptr)
// two (M, k) matrices and one output (ops.topk_fedagg: no row table to
// build and copy, which keeps its host time under its device time)
struct Rows {
  const int64_t* rows;
  const int* mat_idx;
  const float* mat_val;
  float* mat_out;
  int L, M;
  __device__ __forceinline__ const int* idx(int m, int l, int k) const {
    return rows ? reinterpret_cast<const int*>(rows[static_cast<int64_t>(m) * L + l])
                : mat_idx + static_cast<int64_t>(m) * k;
  }
  __device__ __forceinline__ const float* val(int m, int l, int k) const {
    return rows ? reinterpret_cast<const float*>(
                      rows[static_cast<int64_t>(M + m) * L + l])
                : mat_val + static_cast<int64_t>(m) * k;
  }
  __device__ __forceinline__ float* out(int l) const {
    return rows ? reinterpret_cast<float*>(rows[2 * static_cast<int64_t>(M) * L + l])
                : mat_out;
  }
};

// ---------------------------------------------------------------------------
// kernel 1: check the rows, record where each enters each tile
// ---------------------------------------------------------------------------
__device__ __forceinline__ int tile_clamped(int a, int n_tiles) {
  const int t = a >> kTileShift;             // negative a: negative
  return t < -1 ? -1 : (t > n_tiles ? n_tiles : t);
}

// positions j .. j + 3 of a row (indices a[0..3], the next one a[4], the
// one before pv): where one enters a tile past its predecessor's, it starts
// the tiles in between; the row's last position also ends the tiles after
// its own.  Positions outside [0, k) are skipped; with `check` the four are
// also tested (strictly ascending, in [0, n)).  Few lanes take it (a tile
// boundary, the ends of a row), so its loops stay rolled.
__device__ __forceinline__ bool enter4(int* off, int j, const int4 x, int nx,
                                       int pv, int n, int k, int n_tiles,
                                       bool check) {
  const int a[5] = {x.x, x.y, x.z, x.w, nx};
  int sp = j <= 0 ? -1 : tile_clamped(pv, n_tiles);
  bool bad = false;
#pragma unroll 1
  for (int i = 0; i < 4; ++i) {
    const int ji = j + i;
    if (ji < 0 || ji >= k) continue;
    if (check)
      bad |= static_cast<unsigned>(a[i]) >= static_cast<unsigned>(n) ||
             (ji < k - 1 && a[i] >= a[i + 1]);
    const int s = tile_clamped(a[i], n_tiles);
#pragma unroll 1
    for (int t = (ji == 0 ? -1 : sp) + 1; t <= s; ++t) off[t] = ji;
    if (ji == k - 1) {
#pragma unroll 1
      for (int t = s + 1 > 0 ? s + 1 : 0; t <= n_tiles; ++t) off[t] = k;
    }
    sp = s;
  }
  return bad;
}

__global__ void __launch_bounds__(kCheckThreads, 4)
    topk_check_kernel(const int* __restrict__ table, const Rows rs,
                      int* flags, int* offs, int L, int M, int T, int C,
                      int epoch) {
  const int lane = threadIdx.x & 31;
  const int* unit_leaf = table + 5 * L + T;
  const int units = M * C;
  const int warps = gridDim.x * kCheckWarps;
  for (int u = blockIdx.x * kCheckWarps + threadIdx.x / 32; u < units;
       u += warps) {
    const int m = u / C, c = u - m * C;
    const int l = __ldg(unit_leaf + c);
    const Leaf f = leaf_of(table, L, l);
    const int n_tiles = (f.n + kTile - 1) / kTile;
    const int* row = rs.idx(m, l, f.k);
    int* off = offs + static_cast<int64_t>(M) * f.off_base +
               static_cast<int64_t>(m) * (n_tiles + 1);
    // positions on the 16-byte grid of the row: position j sits at
    // v = j + r, r the row's offset in int32s past a 16-byte boundary; a
    // lane reads v0 + 128 h + 4 lane .. + 3 as one int4, h < kVecs
    const int r = static_cast<int>((reinterpret_cast<uintptr_t>(row) >> 2) & 3);
    const int* base = row - r;
    const int v0 = (c - f.unit_base) * kCheck;
    int4 x[kVecs];
#pragma unroll
    for (int h = 0; h < kVecs; ++h) {
      const int v = v0 + 128 * h + 4 * lane;
      // a 16-byte block holding a position of the row lies in its allocation
      x[h] = v + 3 >= r && v < f.k + r
                 ? __ldg(reinterpret_cast<const int4*>(base + v))
                 : make_int4(0, 0, 0, 0);
    }
    const int jb = v0 - r - 1, ja = v0 + kCheck - r;  // just outside the unit
    const int before = __shfl_sync(
        0xffffffffu, lane == 0 && jb >= 0 && jb < f.k ? row[jb] : 0, 0);
    const int after = __shfl_sync(
        0xffffffffu, lane == 0 && ja >= 0 && ja < f.k ? row[ja] : 0, 0);
    const unsigned n = static_cast<unsigned>(f.n);
    // a unit whose positions all lie in the row with a next one after each
    // (the common case) skips the per-position bounds
    const bool interior = v0 - r - 1 >= 0 && v0 + kCheck - r < f.k;
    bool bad = false;
#pragma unroll
    for (int h = 0; h < kVecs; ++h) {
      // the index after this lane's four (lane 31: lane 0's of h + 1) and
      // the one before them (lane 0: lane 31's of h - 1)
      const int nx_wrap =
          __shfl_sync(0xffffffffu, x[h + 1 < kVecs ? h + 1 : h].x, 0);
      const int pv_wrap = __shfl_sync(0xffffffffu, x[h > 0 ? h - 1 : 0].w, 31);
      int nx = __shfl_down_sync(0xffffffffu, x[h].x, 1);
      int pv = __shfl_up_sync(0xffffffffu, x[h].w, 1);
      if (lane == 31) nx = h + 1 < kVecs ? nx_wrap : after;
      if (lane == 0) pv = h > 0 ? pv_wrap : before;
      const int j = v0 + 128 * h + 4 * lane - r;   // position of x[h].x
      const int4 y = x[h];
      if (interior) {
        // all four and the next are positions of the row, none its last
        bad |= (static_cast<unsigned>(y.x) >= n) | (y.x >= y.y) |
               (static_cast<unsigned>(y.y) >= n) | (y.y >= y.z) |
               (static_cast<unsigned>(y.z) >= n) | (y.z >= y.w) |
               (static_cast<unsigned>(y.w) >= n) | (y.w >= nx);
        // a sorted row enters a tile here only if its tile grows
        if ((y.w >> kTileShift) != (pv >> kTileShift) || y.w < 0 || pv < 0)
          enter4(off, j, y, nx, pv, f.n, f.k, n_tiles, false);
      } else if (j + 3 >= 0 && j < f.k) {
        bad |= enter4(off, j, y, nx, pv, f.n, f.k, n_tiles, true);
      }
    }
    if (__any_sync(0xffffffffu, bad) && lane == 0)
      flags[static_cast<int64_t>(l) * M + m] = epoch;
  }
}

// ---------------------------------------------------------------------------
// kernel 2: fold the tiles
// ---------------------------------------------------------------------------
__device__ __forceinline__ int residue(const void* p, int lo) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) / 4 + lo) & 3);
}

// one (tile, chunk of up to kRows rows) planned: the rows' segments of the
// tile cut into groups that fit a stage buffer
struct Plan {
  const int* p_idx[kRows];
  const float* p_val[kRows];
  float beta[kRows];
  int4 seg[kRows];                 // the row's positions lo, hi in the tile;
                                   // position j stages at di + j, dv + j
  int gstart[kRows + 1], scan[kRows];    // group g: a flagged row, scanned
  int ng, t0, len, k;
  float* out;
};

// a lane's row of the next (tile, chunk) and the tile, read by warp 0 a
// step ahead
struct Meta {
  const int* p_idx;
  const float* p_val;
  float* out;
  float beta;
  int lo, hi, flag, t0, len, k;
};

struct Unit {  // the u-th (tile, chunk) of this block
  int tile, r0;
};

__device__ __forceinline__ Meta read_meta(const int* __restrict__ table,
                                          const Rows& rs,
                                          const float* __restrict__ betas,
                                          const int* flags, const int* offs,
                                          int L, int M, int epoch, Unit un,
                                          int lane) {
  Meta mt{nullptr, nullptr, nullptr, 0.f, 0, 0, 1, 0, 0, 0};
  const int l = __ldg(table + 5 * L + un.tile);
  const Leaf f = leaf_of(table, L, l);
  mt.t0 = (un.tile - f.tile_base) * kTile;
  mt.len = f.n - mt.t0 < kTile ? f.n - mt.t0 : kTile;
  mt.k = f.k;
  mt.out = rs.out(l) + mt.t0;
  const int m = un.r0 + lane;
  if (m >= M) return mt;
  const int n_tiles = (f.n + kTile - 1) / kTile;
  const int64_t o = static_cast<int64_t>(M) * f.off_base +
                    static_cast<int64_t>(m) * (n_tiles + 1) + un.tile - f.tile_base;
  mt.lo = offs[o], mt.hi = offs[o + 1];
  mt.flag = flags[static_cast<int64_t>(l) * M + m] == epoch;
  mt.p_idx = rs.idx(m, l, f.k), mt.p_val = rs.val(m, l, f.k);
  mt.beta = betas[m];
  return mt;
}

// warp 0, lane q with row q's meta: plan groups of consecutive sorted rows
// whose segments fit a stage buffer (a greedy cut, found by a prefix sum
// and a ballot per group); a flagged row (or a segment that cannot be a
// sorted row's) alone
__device__ __forceinline__ void plan_rows(Plan& P, const Meta& mt, int rows,
                                          int lane) {
  const int q = lane, n_q = mt.hi - mt.lo;
  int need = 0, ri = 0, rv = 0;
  const bool scan = q < rows && (mt.flag || n_q < 0 || n_q > kTile);
  if (q < rows) {
    if (!scan && n_q > 0) {
      ri = residue(mt.p_idx, mt.lo), rv = residue(mt.p_val, mt.lo);
      need = ((ri > rv ? ri : rv) + n_q + 3) & ~3;
    }
    P.p_idx[q] = mt.p_idx, P.p_val[q] = mt.p_val, P.beta[q] = mt.beta;
    P.seg[q] = make_int4(mt.lo, mt.hi, 0, 0);
  }
  const unsigned scans = __ballot_sync(0xffffffffu, scan);
  int g = 0;
  for (int first = 0; first < rows;) {
    if ((scans >> first) & 1) {
      if (lane == 0) P.gstart[g] = first, P.scan[g] = 1;
      ++g, ++first;
      continue;
    }
    const unsigned later = scans & (0xffffffffu << first);
    const int stop = later ? __ffs(later) - 1 : rows;
    const bool in = q >= first && q < stop;
    int pn = in ? need : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, pn, d);
      if (lane >= d) pn += t;
    }
    const bool fits = in && pn <= kStage;
    const int end = first + __popc(__ballot_sync(0xffffffffu, fits));
    if (fits) {
      const int slot = pn - need;
      P.seg[q].z = slot + ri - mt.lo, P.seg[q].w = slot + rv - mt.lo;
    }
    if (lane == 0) P.gstart[g] = first, P.scan[g] = 0;
    ++g, first = end;
  }
  if (lane == 0) {
    P.gstart[g] = rows, P.ng = g;
    P.t0 = mt.t0, P.len = mt.len, P.k = mt.k, P.out = mt.out;
  }
}

__global__ void __launch_bounds__(kThreads, 8)
    topk_fold_kernel(const int* __restrict__ table, const Rows rs,
                     const float* __restrict__ betas, const int* flags,
                     const int* offs, int L, int M, int T, int epoch,
                     int accumulate) {
  __shared__ __align__(16) float acc[kTile];
  __shared__ __align__(16) int s_idx[2][kStage];
  __shared__ __align__(16) float s_val[2][kStage];
  __shared__ Plan plans[2];
  __shared__ __align__(8) uint64_t bars[2];   // a stage buffer's bulk copies

  const int tid = threadIdx.x, lane = tid & 31, warp = tid / 32;
  const int chunks = (M + kRows - 1) / kRows;
  const int my_tiles = (T - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int n_units = my_tiles * chunks;
  auto unit = [&](int u) {
    return Unit{static_cast<int>(blockIdx.x + (u / chunks) * gridDim.x),
                (u % chunks) * kRows};
  };
  // the tile's outputs this thread writes: i0(h) + c, c < 4
  auto i0 = [&](int h) { return h * (kTile / 2) + 4 * tid; };
  float o[8];
  auto load_out = [&](const float* out, int len) {
    const bool vec = len == kTile && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!accumulate) {
        o[4 * h] = o[4 * h + 1] = o[4 * h + 2] = o[4 * h + 3] = 0.f;
      } else if (vec) {
        const float4 x = *reinterpret_cast<const float4*>(out + i0(h));
        o[4 * h] = x.x, o[4 * h + 1] = x.y, o[4 * h + 2] = x.z, o[4 * h + 3] = x.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          o[4 * h + c] = i0(h) + c < len ? out[i0(h) + c] : 0.f;
      }
    }
  };

  // zero the tile, load the first tile of acc
  for (int i = tid; i < kTile; i += kThreads) acc[i] = 0.f;
  if (n_units == 0) return;
  if (tid == 0) {
    hopper::mbar_init(&bars[0], 1);
    hopper::mbar_init(&bars[1], 1);
    hopper::fence_barrier_init();
  }
  {
    const int l = __ldg(table + 5 * L + blockIdx.x);
    const Leaf f = leaf_of(table, L, l);
    const int t0 = (static_cast<int>(blockIdx.x) - f.tile_base) * kTile;
    load_out(rs.out(l) + t0, f.n - t0 < kTile ? f.n - t0 : kTile);
  }

  Meta next{};
  if (warp == 0) {
    const Unit u0 = unit(0);
    const Meta m0 = read_meta(table, rs, betas, flags, offs, L, M, epoch, u0, lane);
    plan_rows(plans[0], m0, M - u0.r0 < kRows ? M - u0.r0 : kRows, lane);
    if (n_units > 1)
      next = read_meta(table, rs, betas, flags, offs, L, M, epoch, unit(1), lane);
  }
  __syncthreads();

  // stage group g of plan P into buffer b (warp 0, lane r row r of the
  // group): the 16-byte-aligned middle of each of its segments as one bulk
  // copy on the buffer's mbarrier, the ragged ends (at most 3 elements on
  // each side) by 4-byte cp.async
  auto issue = [&](const Plan& P, int g, int b) {
    if (warp != 0) return;
    const int q0 = P.gstart[g], nr = P.gstart[g + 1] - q0;
    const bool scan = P.scan[g];
    const int q = q0 + lane;
    const bool mine = !scan && lane < nr;
    int lo = 0, n_q = 0, hi_i = 0, nv_i = 0, hi_v = 0, nv_v = 0;
    const int* si = nullptr;
    const float* sv = nullptr;
    const int4 sg = mine ? P.seg[q] : make_int4(0, 0, 0, 0);
    if (mine) {
      lo = sg.x, n_q = sg.y - lo;
      si = P.p_idx[q] + lo, sv = P.p_val[q] + lo;
      hi_i = (4 - residue(si, 0)) & 3, hi_i = hi_i < n_q ? hi_i : n_q;
      hi_v = (4 - residue(sv, 0)) & 3, hi_v = hi_v < n_q ? hi_v : n_q;
      nv_i = (n_q - hi_i) >> 2, nv_v = (n_q - hi_v) >> 2;
    }
    int bytes = 16 * (nv_i + nv_v);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) bytes += __shfl_xor_sync(0xffffffffu, bytes, d);
    if (lane == 0) hopper::mbar_expect_tx(&bars[b], static_cast<uint32_t>(bytes));
    __syncwarp();
    if (!mine || n_q == 0) return;
    int* di = &s_idx[b][sg.z + lo];
    float* dv = &s_val[b][sg.w + lo];
    // the buffer's last reads (generic proxy) come before these writes
    hopper::fence_proxy_async();
    if (nv_i) hopper::bulk_load(di + hi_i, si + hi_i, 16 * nv_i, &bars[b]);
    if (nv_v) hopper::bulk_load(dv + hi_v, sv + hi_v, 16 * nv_v, &bars[b]);
    for (int e = 0; e < hi_i; ++e) hopper::cp_async4(di + e, si + e);
    for (int e = hi_i + 4 * nv_i; e < n_q; ++e) hopper::cp_async4(di + e, si + e);
    for (int e = 0; e < hi_v; ++e) hopper::cp_async4(dv + e, sv + e);
    for (int e = hi_v + 4 * nv_v; e < n_q; ++e) hopper::cp_async4(dv + e, sv + e);
  };

  issue(plans[0], 0, 0);
  hopper::cp_async_commit();
  // the pipeline over items (unit u, group g): item k folds from buffer
  // k & 1 while item k + 1 loads into the other
  int u = 0, g = 0;
  for (int k = 0;; ++k) {
    const Plan& P = plans[u & 1];
    const bool last_group = g + 1 == P.ng;
    // the next item; the next unit is planned first (warp 0)
    const bool plan_next = last_group && u + 1 < n_units;
    if (plan_next) {
      if (warp == 0) {
        const Unit un = unit(u + 1);
        plan_rows(plans[(u + 1) & 1], next,
                  M - un.r0 < kRows ? M - un.r0 : kRows, lane);
        __syncwarp();
        issue(plans[(u + 1) & 1], 0, (k + 1) & 1);
        if (u + 2 < n_units)   // the unit after next, read while item k lands
          next = read_meta(table, rs, betas, flags, offs, L, M, epoch,
                           unit(u + 2), lane);
      }
    } else if (!last_group) {
      issue(P, g + 1, (k + 1) & 1);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    const int b = k & 1;
    hopper::mbar_wait(&bars[b], (k >> 1) & 1);
    __syncthreads();  // item k has landed for every thread

    // the tile, read before the barrier after which warp 0 may plan over
    // this buffer
    const int t0 = P.t0, len = P.len;
    float* const out = P.out;
    if (P.scan[g]) {
      // a flagged row: scan it whole
      const int q = P.gstart[g];
      const int* row = P.p_idx[q];
      const float* vrow = P.p_val[q];
      const float c = P.beta[q];
      for (int j = tid; j < P.k; j += kThreads) {
        const int a = row[j];
        if (a >= t0 && a - t0 < len)
          acc[a - t0] = __fadd_rn(acc[a - t0], __fmul_rn(c, vrow[j]));
      }
    } else {
      // the block folds row after row, thread t the row's pairs t, t + 256,
      // ..; a row holds each index once, so no two threads add into one
      // slot, and a block barrier puts row q in before row q + 1
      const int q0 = P.gstart[g], q1 = P.gstart[g + 1];
      const int* si = s_idx[b];
      const float* sv = s_val[b];
      for (int q = q0; q < q1; ++q) {
        const int4 sg = P.seg[q];
        const float c = P.beta[q];
        for (int j = sg.x + tid; j < sg.y; j += kThreads) {
          const int a = si[sg.z + j] - t0;
          if (static_cast<unsigned>(a) < static_cast<unsigned>(len))
            acc[a] = __fadd_rn(acc[a], __fmul_rn(c, sv[sg.w + j]));
        }
        if (q + 1 < q1) __syncthreads();
      }
    }
    __syncthreads();  // every warp is done with buffer b and with acc

    if (last_group && (u + 1) % chunks == 0) {
      // the tile is done: write acc + fold, zero it, load the next one's acc
      const bool vec = len == kTile && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0(h);
        if (vec) {
          const float4 x = *reinterpret_cast<const float4*>(&acc[i]);
          float4 y = x;
          if (accumulate) {
            y.x = __fadd_rn(o[4 * h], x.x);
            y.y = __fadd_rn(o[4 * h + 1], x.y);
            y.z = __fadd_rn(o[4 * h + 2], x.z);
            y.w = __fadd_rn(o[4 * h + 3], x.w);
          }
          *reinterpret_cast<float4*>(out + i) = y;
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (i + c < len)
              out[i + c] = accumulate ? __fadd_rn(o[4 * h + c], acc[i + c])
                                      : acc[i + c];
        }
        *reinterpret_cast<float4*>(&acc[i]) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      if (u + 1 < n_units) load_out(plans[(u + 1) & 1].out, plans[(u + 1) & 1].len);
    }
    if (last_group) {
      if (++u == n_units) break;
      g = 0;
    } else {
      ++g;
    }
  }
  hopper::cp_async_wait<0>();
}

int occupancy(const void* kernel, int threads, int* cached) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, 0) != cudaSuccess)
      return 0;
    cached[dev] = sms * per_sm;
  }
  return cached[dev];
}

}  // namespace

extern "C" {

int topk_fedagg_geometry(int64_t which) {
  return which == 0 ? kTile : which == 1 ? kCheck : 0;
}

int topk_fedagg_flush(const void* tablev, const void* rowsv,
                      const void* betasv, void* workv, const void* mat_idx,
                      const void* mat_val, void* mat_out, int64_t L, int64_t M,
                      int64_t T, int64_t C, int64_t S, int64_t work_ints,
                      int64_t epoch, int64_t accumulate, void* streamv) {
  if (L <= 0 || M <= 0 || T <= 0 || C <= 0 || S <= 0 || L > INT32_MAX ||
      M > INT32_MAX || T > INT32_MAX || C > INT32_MAX || epoch <= 0 ||
      epoch > INT32_MAX || M * C > INT32_MAX || work_ints < L * M + M * S ||
      (rowsv == nullptr && (L != 1 || !mat_idx || !mat_val || !mat_out)))
    return static_cast<int>(cudaErrorInvalidValue);
  static int check_cap[64] = {0}, fold_cap[64] = {0};
  const int cap1 = occupancy(reinterpret_cast<const void*>(topk_check_kernel),
                             kCheckThreads, check_cap);
  const int cap2 = occupancy(reinterpret_cast<const void*>(topk_fold_kernel),
                             kThreads, fold_cap);
  if (cap1 <= 0 || cap2 <= 0) return static_cast<int>(cudaGetLastError());
  const int* table = static_cast<const int*>(tablev);
  const Rows rs{static_cast<const int64_t*>(rowsv),
                static_cast<const int*>(mat_idx),
                static_cast<const float*>(mat_val), static_cast<float*>(mat_out),
                static_cast<int>(L), static_cast<int>(M)};
  const float* betas = static_cast<const float*>(betasv);
  int* flags = static_cast<int*>(workv);
  int* offs = flags + L * M;
  const int Li = static_cast<int>(L), Mi = static_cast<int>(M),
            Ti = static_cast<int>(T), Ci = static_cast<int>(C),
            ep = static_cast<int>(epoch), acc = accumulate != 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(streamv);
  const int64_t want = (M * C + kCheckWarps - 1) / kCheckWarps;
  const int grid1 = static_cast<int>(want < cap1 ? want : cap1);
  topk_check_kernel<<<grid1, kCheckThreads, 0, stream>>>(table, rs, flags, offs,
                                                    Li, Mi, Ti, Ci, ep);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid2 = static_cast<int>(T < cap2 ? T : cap2);
  topk_fold_kernel<<<grid2, kThreads, 0, stream>>>(table, rs, betas, flags, offs,
                                                  Li, Mi, Ti, ep, acc);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
