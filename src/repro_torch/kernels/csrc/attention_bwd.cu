// The backward of flash_attention for Hopper (sm_90a).
//
// flash_attention_bwd: q (B,Sq,H,hd), k/v (B,Sk,KV,hd), the forward's out
//     (B,Sq,H,hd) and lse (B,H,Sq) fp32 (natural log, attention.cu), and
//     dout (B,Sq,H,hd) -> dq, dk, dv in the inputs' dtype (fp32 or bf16),
//     by the FlashAttention-2 algorithm:
//       D  = rowsum(dO o O)                        flash_bwd_dot
//       P  = exp(S - lse), dP = dO V^T, dS = P o (dP - D)
//       dV = P^T dO, dK = dS^T Q * scale           dK/dV blocks
//       dQ = dS K * scale                          dQ blocks
//     with the mask of the forward (causal: key j <= query i; windowed:
//     j > i - window).  A masked pair has dS = 0 (the mask is a where); a
//     row with no valid key at all (lse <= kNegInf / 2, possible only with
//     a window and Sq > Sk + window - 1) averaged every key in the forward,
//     so it has P = 1/Sk and dS = 0, as kernels/ref.py's plain version.
//   Replaces the gradient of src/repro/kernels/flash_attention.py::
//   flash_attention (:82).  The TPU kernel has no backward: the JAX package
//   differentiates its jnp path, models/attention.py::_sdpa.
//   Bound: bytes at the train shape (B=8, S=256, H=16, KV=8, hd=128,
//   causal: q, k, v, o, dO, dq, dk, dv, lse and D once, ~50 MB, 0.015 ms),
//   operations at qwen3's forward shape (B=4, S=4096: 10*hd flops per
//   unmasked pair, 0.69 ms at 989 TFLOP/s) and at gemma-7b's hd 256 (B=4,
//   S=4096, 16/16 heads: 1.39 ms).
//   What the design does:
//     * bf16 (the model's path) runs every product on the tensor cores
//       (wgmma), after the row dot: one launch of two kinds of block, built
//       like the forward's warp-specialised kernel.  Each block has a
//       producer warpgroup (one thread issues TMA loads through an mbarrier
//       ring; the others give their registers away) and two consumer
//       warpgroups.  Up to HD 128:
//       - dK/dV blocks, one per (128 keys, KV head, batch row), 64 keys a
//         consumer: K and V arrive once; (Q, dO) tiles of 64 queries with
//         their lse and D rows stream through the ring for each of the g
//         query heads of the group, over only the query tiles the mask lets
//         see the keys (and the tiles of rows with no valid key).  A
//         consumer computes S^T = K Q^T and dP^T = V dO^T with both
//         operands in shared memory, forms P^T and dS^T in registers (each
//         accumulator column is a query, whose lse and D it reads from
//         shared memory), packs them in place into bf16 A fragments and
//         runs dV += P^T dO and dK += dS^T Q with dO, Q read N-major through
//         the transpose bit.  The group's sum stays in the registers;
//         dK * scale and dV leave once through shared memory by TMA stores.
//       - dQ blocks, one per (128 query rows, head, batch row): Q and dO
//         arrive once and stay in registers as the A fragments of S = Q K^T
//         and dP = dO V^T, so those products read only K and V tiles (64
//         keys) from the ring, over the keys the rows may see; dS is
//         formed in registers as the A operand of dQ += dS K (K N-major);
//         dQ * scale leaves by a TMA store.
//       At HD 256 (gemma-7b) a block owns 64 rows and the ring has two
//       stages (the wgb namespace's notes): in a dK/dV block one consumer
//       sums dV and the other dK over the same keys, the first handing P^T
//       to the second through shared memory; in a dQ block each consumer
//       takes every other key tile and the two sums meet in shared memory
//       in a fixed order.
//       exp2 of log2e-scaled scores against lse * log2e, which the row dot
//       writes with D; the mask only on tiles that cross the diagonal, a
//       window edge, Sk or the rows with no valid key; a warpgroup skips a
//       tile whose pairs are all masked for its rows.  The dK/dV blocks
//       come first, heaviest key tiles first, then the lighter dQ blocks,
//       heaviest query tiles first, which fill the SMs as the dK/dV blocks
//       end.  No atomics: each output is written once, so the result
//       repeats bit for bit; the price is S and dP computed in both kinds
//       of block, 7 products of 2 hd flops a pair instead of 5.  P and dS
//       enter their products in bf16, as the forward's P does;
//     * fp32 (off the model's path: the agreement checks) runs on the FMA
//       pipes: a block owns 64 rows and streams the other side in tiles of
//       64 rows (32 at HD 256), in shared memory as fp32 rows padded by 4
//       floats; 256 threads, each owning a 4x4 (4x2) micro-tile of a score
//       tile and a 4 x hd/16 micro-tile of an accumulator; a dK/dV kernel
//       per 64-key tile over the same tile lists, then a dQ kernel per
//       64-query tile;
//     * head dims: the forward's rule, any multiple of 8 in [8, 256] on the
//       next of HD = 32, 64, 128, 256 up, the columns past hd zero-filled
//       on the loads (TMA's extent, or masked loads) and never stored;
//     * S and P are recomputed from lse, never stored.
//
// C interface (bound with ctypes): flash_attention_bwd_{f32,bf16} launch
// the kernels on the stream and return the first CUDA error, or
// cudaErrorInvalidValue for a head dim that is not a multiple of 8 in
// [8, 256].  `work` is a workspace of 2 * B * H * ceil(Sq / 128) * 128
// floats: D (and, for bf16, lse * log2e) per row, rows padded to a multiple
// of 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention.cuh"
#include "hopper.cuh"

namespace {

constexpr int kDotWarps = 8;
constexpr int kPad = 128;   // rows of the workspace are padded to this

__device__ __forceinline__ bool masked(int r, int c, int causal, int window) {
  return (causal && c > r) || (window > 0 && c <= r - window);
}

// D[b, h, i] = sum_d dO . O in fp32 for every (b, i, h) row, i < Sq_pad,
// into delta (rows Sq_pad apart; 0 past Sq) and, when lse2 is not null,
// the row's lse * log2e into lse2: -inf for a row with no valid key (lse <=
// kNegInf / 2), +inf past Sq, so such a row's P is 0.  HD / 8 lanes share a
// row (hd <= HD its true length), each loading 8 elements of O and of dO
// below hd.
template <typename T, int HD>
__global__ void __launch_bounds__(kDotWarps * 32)
    flash_bwd_dot(const T* __restrict__ out, const T* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ delta,
                  float* __restrict__ lse2, int64_t rows, int Sq, int Sq_pad,
                  int H, int hd) {
  constexpr int kLanes = HD / 8;   // per row
  const int64_t r = (static_cast<int64_t>(blockIdx.x) * kDotWarps * 32 +
                     threadIdx.x) / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int64_t h = r % H;
  const int64_t i = (r / H) % Sq_pad;
  const int64_t b = r / (static_cast<int64_t>(H) * Sq_pad);
  float acc = 0.f;
  if (r < rows && i < Sq && lane * 8 < hd) {
    const int64_t at = ((b * Sq + i) * H + h) * hd + lane * 8;
    float o[8], d[8];
    load8(out + at, o);
    load8(dout + at, d);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc = fmaf(d[e], o[e], acc);
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < rows && lane == 0) {
    const int64_t at = (b * H + h) * Sq_pad + i;
    delta[at] = acc;
    if (lse2 != nullptr) {
      const float l = i < Sq ? lse[(b * H + h) * Sq + i] : INFINITY;
      lse2[at] = l <= 0.5f * kNegInf ? -INFINITY : l * kLog2e;
    }
  }
}

template <int HD>
unsigned dot_blocks(int64_t rows) {
  constexpr int64_t kRowsPerBlock = kDotWarps * 32 / (HD / 8);
  return static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
}

// The query tiles (of `rows` rows) a key tile [k0, k_last] needs: the
// range [tA0, tA0 + nA) of rows that see some of its keys, then the range
// [tB0, tB0 + nB) of rows with no valid key at all (every row >= Sk +
// window - 1), which average every key.
struct QueryTiles {
  int tA0, nA, tB0, nB;
  __device__ __forceinline__ int tile(int i) const {
    return i < nA ? tA0 + i : tB0 + i - nA;
  }
};

__device__ __forceinline__ QueryTiles query_tiles(int k0, int k_last, int Sq,
                                                  int Sk, int causal,
                                                  int window, int rows) {
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq - 1, k_last + window - 1) : Sq - 1;
  const int e0 = window > 0 ? Sk + window - 1 : Sq;
  QueryTiles t;
  t.tA0 = q_lo / rows;
  t.nA = q_lo <= q_hi ? q_hi / rows - t.tA0 + 1 : 0;
  t.tB0 = max(t.nA > 0 ? t.tA0 + t.nA : 0, e0 / rows);
  t.nB = e0 < Sq ? max(0, (Sq - 1) / rows - t.tB0 + 1) : 0;
  return t;
}

// ---------------------------------------------------------------------------
// fp32: the FMA-pipe kernels (bf16 takes the wgmma kernels below).  A block
// owns kT rows (keys, or query rows) and streams the other side's tiles of
// kTs rows: 64 up to HD 128, 32 at HD 256, where four (64, 256) fp32 tiles
// alone would be 266 KB.
// ---------------------------------------------------------------------------
constexpr int kT = 64;          // a block's own rows
constexpr int kThreads = 256;   // 16 x 16

template <int HD>
struct BwdSmem {
  static constexpr int kStride = HD + 4;   // floats per row of a tile
  static constexpr int kTs = HD > 128 ? 32 : 64;   // streamed rows a tile
  static constexpr int kJ = kTs / 16;      // streamed columns a thread
  static constexpr int kPStride = kTs + 4;
  // two own (kT, HD) tiles, two streamed (kTs, HD) tiles, two (kT, kTs)
  // score tiles, lse and D of kTs rows: 218 KB at HD 256
  static constexpr size_t kDkdvBytes =
      sizeof(float) * (2 * (kT + kTs) * kStride + 2 * kT * kPStride +
                       2 * kTs);
  // the same with one score tile, lse and D of kT rows
  static constexpr size_t kDqBytes =
      sizeof(float) * (2 * (kT + kTs) * kStride + kT * kPStride + 2 * kT);
};

// lse and D of query rows q0 .. q0 + n - 1 of head h into shared memory;
// rows past Sq get lse = +inf, so their P is 0
__device__ __forceinline__ void load_row_stats(const float* lse,
                                               const float* delta,
                                               int64_t base, int q0, int Sq,
                                               int n, float* lse_s,
                                               float* d_s) {
  if (threadIdx.x < n) {
    const int r = q0 + threadIdx.x;
    lse_s[threadIdx.x] = r < Sq ? lse[base + r] : INFINITY;
    d_s[threadIdx.x] = r < Sq ? delta[base + r] : 0.f;
  }
}

// s[i][j] += A[ra + 16i] . B[rb + 16j] over HD (A the kT own rows, B the
// kTs streamed ones), both from shared rows of stride kStride, for two
// pairs of tiles at once
template <int HD>
__device__ __forceinline__ void two_products(
    const float* A0, const float* B0, const float* A1, const float* B1,
    int ra, int rb, float (&s0)[4][BwdSmem<HD>::kJ],
    float (&s1)[4][BwdSmem<HD>::kJ]) {
  constexpr int kS = BwdSmem<HD>::kStride;
  constexpr int kJ = BwdSmem<HD>::kJ;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j) s0[i][j] = s1[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 a0[4], b0[kJ], a1[4], b1[kJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a0[i] = *reinterpret_cast<const float4*>(A0 + (ra + 16 * i) * kS + d);
      a1[i] = *reinterpret_cast<const float4*>(A1 + (ra + 16 * i) * kS + d);
    }
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      b0[j] = *reinterpret_cast<const float4*>(B0 + (rb + 16 * j) * kS + d);
      b1[j] = *reinterpret_cast<const float4*>(B1 + (rb + 16 * j) * kS + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        float x = s0[i][j], y = s1[i][j];
        x = fmaf(a0[i].x, b0[j].x, x);
        x = fmaf(a0[i].y, b0[j].y, x);
        x = fmaf(a0[i].z, b0[j].z, x);
        x = fmaf(a0[i].w, b0[j].w, x);
        y = fmaf(a1[i].x, b1[j].x, y);
        y = fmaf(a1[i].y, b1[j].y, y);
        y = fmaf(a1[i].z, b1[j].z, y);
        y = fmaf(a1[i].w, b1[j].w, y);
        s0[i][j] = x;
        s1[i][j] = y;
      }
  }
}

// acc[i][jj] += sum_e P[ty + 16i][e] * X[e][out_col(jj)] over the kTs
// columns of P (shared, stride kPStride) and rows of X (stride kStride)
template <int HD>
__device__ __forceinline__ void accumulate(const float* P, const float* X,
                                           int tx, int ty,
                                           float (&acc)[4][HD / 16]) {
  constexpr int kS = BwdSmem<HD>::kStride;
  constexpr int kTs = BwdSmem<HD>::kTs;
  constexpr int kPS = BwdSmem<HD>::kPStride;
  constexpr int kCols = HD / 16;
#pragma unroll 2
  for (int kk = 0; kk < kTs; kk += 4) {
    float pa[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 t =
          *reinterpret_cast<const float4*>(P + (ty + 16 * i) * kPS + kk);
      pa[i][0] = t.x; pa[i][1] = t.y; pa[i][2] = t.z; pa[i][3] = t.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* xrow = X + (kk + e) * kS;
      float xv[kCols];
      if constexpr (HD >= 64) {
#pragma unroll
        for (int g4 = 0; g4 < kCols / 4; ++g4) {
          const float4 t =
              *reinterpret_cast<const float4*>(xrow + g4 * 64 + tx * 4);
          xv[4 * g4] = t.x; xv[4 * g4 + 1] = t.y;
          xv[4 * g4 + 2] = t.z; xv[4 * g4 + 3] = t.w;
        }
      } else {
        const float2 t = *reinterpret_cast<const float2*>(xrow + tx * 2);
        xv[0] = t.x; xv[1] = t.y;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj)
          acc[i][jj] = fmaf(pa[i][e], xv[jj], acc[i][jj]);
    }
  }
}

// the thread's rows ty + 16i of a (kT, HD) accumulator, times `mult`, to
// rows r0 + ty + 16i (< rows) and columns below hd of dst (row stride in
// elements)
template <int HD>
__device__ __forceinline__ void store_rows(float* dst, int64_t row_stride,
                                           int r0, int rows, int hd, int tx,
                                           int ty,
                                           const float (&acc)[4][HD / 16],
                                           float mult) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= rows) continue;
    float* row = dst + r * row_stride;
#pragma unroll
    for (int jj = 0; jj < HD / 16; ++jj) {
      const int c = out_col<HD>(tx, jj);
      if (c < hd) row[c] = acc[i][jj] * mult;
    }
  }
}

// One block per (key tile, KV head, batch row): dK and dV of kT keys over
// the g query heads of the group.  HD is the instantiation, hd <= HD the
// tensors' head dim: the tiles' columns hd.. are zeros and never stored.
template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int Sq, int Sk, int H, int KV,
                   int hd, int causal, int window, float scale) {
  using L = BwdSmem<HD>;
  constexpr int kS = L::kStride;
  constexpr int kTs = L::kTs;
  constexpr int kJ = L::kJ;
  constexpr int kCols = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + kT * kS;
  float* Qs = Vs + kT * kS;
  float* dOs = Qs + kTs * kS;
  float* Pt = dOs + kTs * kS;         // P^T: (keys, queries)
  float* dSt = Pt + kT * L::kPStride; // dS^T
  float* lse_s = dSt + kT * L::kPStride;
  float* d_s = lse_s + kTs;

  const int k0 = blockIdx.x * kT;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int g = H / KV;
  const int k_last = min(k0 + kT, Sk) - 1;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int64_t kv_stride = static_cast<int64_t>(KV) * hd;
  const int64_t kv_base = static_cast<int64_t>(b) * Sk * kv_stride +
                          static_cast<int64_t>(kvh) * hd + k0 * kv_stride;
  load_tile<HD>(k + kv_base, kv_stride, Sk - k0, Ks, kS, kT, hd);
  load_tile<HD>(v + kv_base, kv_stride, Sk - k0, Vs, kS, kT, hd);

  const QueryTiles qt = query_tiles(k0, k_last, Sq, Sk, causal, window, kTs);
  const int n_tiles = qt.nA + qt.nB;
  const float inv_sk = 1.f / static_cast<float>(Sk);
  const int64_t q_stride = static_cast<int64_t>(H) * hd;

  float acc_k[4][kCols], acc_v[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) acc_k[i][jj] = acc_v[i][jj] = 0.f;

  for (int hh = 0; hh < g; ++hh) {
    const int h = kvh * g + hh;
    const int64_t stat_base = (static_cast<int64_t>(b) * H + h) * Sq;
    for (int n = 0; n < n_tiles; ++n) {
      const int q0 = qt.tile(n) * kTs;
      const int64_t q_base = (static_cast<int64_t>(b) * Sq + q0) * q_stride +
                             static_cast<int64_t>(h) * hd;
      __syncthreads();   // the previous tile's Qs, dOs, Pt, dSt are consumed
      load_tile<HD>(q + q_base, q_stride, Sq - q0, Qs, kS, kTs, hd);
      load_tile<HD>(dout + q_base, q_stride, Sq - q0, dOs, kS, kTs, hd);
      load_row_stats(lse, delta, stat_base, q0, Sq, kTs, lse_s, d_s);
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: keys ty + 16i, queries tx + 16j
      float st[4][kJ], dpt[4][kJ];
      two_products<HD>(Ks, Qs, Vs, dOs, ty, tx, st, dpt);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const int c = k0 + ty + 16 * i;
          const int r = q0 + tx + 16 * j;
          const float l = lse_s[tx + 16 * j];
          float p = 0.f, ds = 0.f;
          if (c < Sk && r < Sq) {
            if (l <= 0.5f * kNegInf) {
              p = inv_sk;
            } else if (!masked(r, c, causal, window)) {
              p = expf(st[i][j] * scale - l);
              ds = p * (dpt[i][j] - d_s[tx + 16 * j]);
            }
          }
          Pt[(ty + 16 * i) * L::kPStride + tx + 16 * j] = p;
          dSt[(ty + 16 * i) * L::kPStride + tx + 16 * j] = ds;
        }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q on the thread's 4 x hd/16 micro-tiles
      accumulate<HD>(Pt, dOs, tx, ty, acc_v);
      accumulate<HD>(dSt, Qs, tx, ty, acc_k);
    }
  }
  const int64_t out_base = static_cast<int64_t>(b) * Sk * kv_stride +
                           static_cast<int64_t>(kvh) * hd;
  store_rows<HD>(dk + out_base, kv_stride, k0, Sk, hd, tx, ty, acc_k, scale);
  store_rows<HD>(dv + out_base, kv_stride, k0, Sk, hd, tx, ty, acc_v, 1.f);
}

// One block per (query tile, head, batch row): dQ of kT rows, over key
// tiles of kTs keys.
template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 int Sq, int Sk, int H, int KV, int hd, int causal,
                 int window, float scale) {
  using L = BwdSmem<HD>;
  constexpr int kS = L::kStride;
  constexpr int kTs = L::kTs;
  constexpr int kJ = L::kJ;
  constexpr int kCols = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + kT * kS;
  float* Ks = dOs + kT * kS;
  float* Vs = Ks + kTs * kS;
  float* dS = Vs + kTs * kS;          // (queries, keys)
  float* lse_s = dS + kT * L::kPStride;
  float* d_s = lse_s + kT;

  const int q0 = blockIdx.x * kT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q_last = min(q0 + kT, Sq) - 1;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int64_t q_stride = static_cast<int64_t>(H) * hd;
  const int64_t q_base = (static_cast<int64_t>(b) * Sq + q0) * q_stride +
                         static_cast<int64_t>(h) * hd;
  load_tile<HD>(q + q_base, q_stride, Sq - q0, Qs, kS, kT, hd);
  load_tile<HD>(dout + q_base, q_stride, Sq - q0, dOs, kS, kT, hd);
  const int64_t stat_base = (static_cast<int64_t>(b) * H + h) * Sq;
  load_row_stats(lse, delta, stat_base, q0, Sq, kT, lse_s, d_s);

  // the keys the tile's rows may see; a row with no valid key has dS = 0
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(Sk - 1, q_last) : Sk - 1;
  const int64_t kv_stride = static_cast<int64_t>(KV) * hd;
  const int64_t kv_base = static_cast<int64_t>(b) * Sk * kv_stride +
                          static_cast<int64_t>(kvh) * hd;

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) acc[i][jj] = 0.f;

  for (int kt = lo / kTs; lo <= hi && kt <= hi / kTs; ++kt) {
    const int k0 = kt * kTs;
    __syncthreads();   // the previous tile's Ks, Vs, dS are consumed
    load_tile<HD>(k + kv_base + k0 * kv_stride, kv_stride, Sk - k0, Ks, kS,
                  kTs, hd);
    load_tile<HD>(v + kv_base + k0 * kv_stride, kv_stride, Sk - k0, Vs, kS,
                  kTs, hd);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: queries ty + 16i, keys tx + 16j
    float s[4][kJ], dp[4][kJ];
    two_products<HD>(Qs, Ks, dOs, Vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      const float l = lse_s[ty + 16 * i];
      const bool row_ok = r < Sq && l > 0.5f * kNegInf;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int c = k0 + tx + 16 * j;
        float ds = 0.f;
        if (row_ok && c < Sk && !masked(r, c, causal, window)) {
          const float p = expf(s[i][j] * scale - l);
          ds = p * (dp[i][j] - d_s[ty + 16 * i]);
        }
        dS[(ty + 16 * i) * L::kPStride + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
    accumulate<HD>(dS, Ks, tx, ty, acc);   // dQ += dS K
  }
  const int64_t out_base = static_cast<int64_t>(b) * Sq * q_stride +
                           static_cast<int64_t>(h) * hd;
  store_rows<HD>(dq + out_base, q_stride, q0, Sq, hd, tx, ty, acc, scale);
}

template <int HD>
int launch_f32(const void* q_, const void* k_, const void* v_,
               const void* out, const void* dout_, const float* lse,
               float* work, void* dq, void* dk, void* dv, int64_t B,
               int64_t Sq, int64_t Sk, int64_t H, int64_t KV, int64_t hd,
               int64_t causal, int64_t window, float scale,
               cudaStream_t stream) {
  using L = BwdSmem<HD>;
  const float* q = static_cast<const float*>(q_);
  const float* k = static_cast<const float*>(k_);
  const float* v = static_cast<const float*>(v_);
  const float* dout = static_cast<const float*>(dout_);
  const int64_t rows = B * Sq * H;
  flash_bwd_dot<float, HD><<<dot_blocks<HD>(rows), kDotWarps * 32, 0,
                             stream>>>(
      static_cast<const float*>(out), dout, lse, work, nullptr, rows,
      static_cast<int>(Sq), static_cast<int>(Sq), static_cast<int>(H),
      static_cast<int>(hd));
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dkdv<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(L::kDkdvBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv(static_cast<unsigned>((Sk + kT - 1) / kT),
                     static_cast<unsigned>(KV), static_cast<unsigned>(B));
  flash_bwd_dkdv<HD><<<grid_kv, kThreads, L::kDkdvBytes, stream>>>(
      q, k, v, dout, lse, work, static_cast<float*>(dk),
      static_cast<float*>(dv), static_cast<int>(Sq),
      static_cast<int>(Sk), static_cast<int>(H), static_cast<int>(KV),
      static_cast<int>(hd), static_cast<int>(causal),
      static_cast<int>(window), scale);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(L::kDqBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q(static_cast<unsigned>((Sq + kT - 1) / kT),
                    static_cast<unsigned>(H), static_cast<unsigned>(B));
  flash_bwd_dq<HD><<<grid_q, kThreads, L::kDqBytes, stream>>>(
      q, k, v, dout, lse, work, static_cast<float*>(dq), static_cast<int>(Sq),
      static_cast<int>(Sk), static_cast<int>(H), static_cast<int>(KV),
      static_cast<int>(hd), static_cast<int>(causal),
      static_cast<int>(window), scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: TMA, mbarrier rings and wgmma, warp-specialised.  Warpgroup 0 is the
// producer (one thread issues every TMA load; the others give their
// registers away by setmaxnreg), warpgroups 1 and 2 the consumers.  Every
// tile in shared memory is 64 rows of HD, written by TMA in boxes of
// 128-byte rows with the 128-byte swizzle (64-byte rows and swizzle at HD
// 32), as the forward's.  A block's own tiles (K and V of its keys, or Q
// and dO of its rows) arrive once; the other side's tiles (Q and dO, or K
// and V) stream through a ring of stages, each with a "full" barrier (TMA
// bytes) and an "empty" barrier (the consumer threads that read it).
//
// Head dims.  The instantiations are HD = 32, 64, 128 and 256, a head dim
// hd <= HD that is a multiple of 8 runs on the next HD up: the tensor maps
// carry the true hd as the extent of the innermost dimension, so TMA fills
// the columns past hd with zeros on every load (they add nothing to the
// scores, and make zero columns of dQ, dK and dV) and drops them on the
// stores; the row dot reads hd columns.
//   Up to HD 128 a block owns 128 rows, 64 for each consumer (each holds
// two accumulators of 64 x HD), and the ring has three stages.
//   HD 256 takes its own shape: a 64 x 256 tile is 32 KB, so two consumers'
// own tiles and a ring of three would need 320 KB, and dK and dV of 64 x
// 256 in fp32 are 128 registers each a thread, more than a consumer's 240
// together.  A block owns 64 rows and the ring has two stages (192 KB, and
// 32 KB for P^T).  In a dK/dV block both consumers take the same 64 keys
// and every stage: the first forms P^T from S^T = K Q^T, hands it to the
// second through shared memory and runs dV += P^T dO; the second forms
// dP^T = V dO^T, then dS^T from the P^T it is handed, and runs dK += dS^T
// Q.  In a dQ block each consumer takes every other key tile, always from
// its own stage, with Q and dO read from shared memory; the second hands
// its sum to the first through the idle ring, which adds it in a fixed
// order.
// ---------------------------------------------------------------------------
namespace wgb {

constexpr int kRows = 64;             // rows of every tile
constexpr int kThreads = 384;         // 3 warpgroups
constexpr uint32_t kProducerRegs = 24;
constexpr uint32_t kConsumerRegs = 240;

template <int HD>
struct Layout {
  static constexpr bool kWide = HD > 128;                 // HD 256's shape
  static constexpr int kRowBytes = HD >= 64 ? 128 : 64;   // one TMA box row
  static constexpr int kSwizzle = kRowBytes;              // 128- or 64-byte
  static constexpr int kBoxCols = kRowBytes / 2;          // hd columns a box
  static constexpr int kBoxes = HD / kBoxCols;            // boxes across hd
  static constexpr int kBoxBytes = kRows * kRowBytes;     // 64 rows of a box
  static constexpr int kTileBytes = kBoxes * kBoxBytes;   // a 64 x hd tile
  static constexpr int kOwn = kWide ? 1 : 2;     // own tiles of an operand
  static constexpr int kBlockRows = kOwn * kRows;         // a block's rows
  static constexpr int kStages = kWide ? 2 : 3;           // ring depth
  // own tiles: A1 of consumer c at kA1 + c * tile, A2 at kA2 + c * tile
  // (HD 256: one of each, shared by both consumers)
  static constexpr int kA1 = 0;
  static constexpr int kA2 = kOwn * kTileBytes;
  // stage s: B1 at kB + 2 s tile, B2 one tile further
  static constexpr int kB = 2 * kOwn * kTileBytes;
  // stage s's lse * log2e and D of its 64 query rows (dK/dV blocks)
  static constexpr int kStats = kB + 2 * kStages * kTileBytes;
  // HD 256's dK/dV blocks: two buffers of a 64 x 64 fp32 P^T tile that
  // the dV consumer hands the dK consumer
  static constexpr int kXchg = kStats + kStages * 2 * kRows * 4;
  static constexpr int kBars = kXchg + (kWide ? 2 * kRows * kRows * 4 : 0);
  static constexpr int kNumBars = 1 + 2 * kStages;
  static constexpr size_t kSmemBytes = kBars + 8 * kNumBars + 1024;  // + align
  static_assert(kSmemBytes <= 232448, "one block's shared memory");
};

// what both kinds of block take besides the tensor maps
struct Args {
  const float* lse2;    // lse * log2e of the rows, Sq_pad apart
  const float* delta;   // D of the rows, Sq_pad apart
  int B, Sq, Sq_pad, Sk, H, KV, causal, window;
  float scale, scale_log2;
};

template <int HD>
__device__ __forceinline__ void rs_step(float (&d)[HD / 2],
                                        const uint32_t (&a)[4], uint64_t b) {
  if constexpr (HD == 32) {
    hopper::wgmma_rs_m64n32k16_nmajor(d, a, b);
  } else if constexpr (HD == 64) {
    hopper::wgmma_rs_m64n64k16_nmajor(d, a, b);
  } else if constexpr (HD == 128) {
    hopper::wgmma_rs_m64n128k16_nmajor(d, a, b);
  } else {
    hopper::wgmma_rs_m64n256k16_nmajor(d, a, b);
  }
}

// x = A B^T (64 x 64, fp32) over HD, both operands 64 x HD tiles K-major in
// shared memory: HD in steps of 16 (32 bytes along a swizzled row; the next
// box after kRowBytes); issued, not fenced or committed
template <int HD>
__device__ __forceinline__ void score_steps(float (&x)[32], uint32_t a,
                                            uint32_t b) {
  using L = Layout<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk * 32) / L::kRowBytes * L::kBoxBytes +
                         (kk * 32) % L::kRowBytes;
    hopper::wgmma_ss_m64n64k16(
        x, hopper::wgmma_desc(a + off, 16, 8 * L::kRowBytes, L::kSwizzle),
        hopper::wgmma_desc(b + off, 16, 8 * L::kRowBytes, L::kSwizzle),
        kk > 0);
  }
}

// x = A1 B1^T and y = A2 B2^T (score_steps), issued as one group
template <int HD>
__device__ __forceinline__ void issue_scores(float (&x)[32], float (&y)[32],
                                             uint32_t a1, uint32_t b1,
                                             uint32_t a2, uint32_t b2) {
  hopper::fence_regs(x);
  hopper::fence_regs(y);
  hopper::wgmma_fence();
  score_steps<HD>(x, a1, b1);
  score_steps<HD>(y, a2, b2);
  hopper::wgmma_commit();
}

// x = A B^T alone, issued as one group
template <int HD>
__device__ __forceinline__ void issue_score(float (&x)[32], uint32_t a,
                                            uint32_t b) {
  hopper::fence_regs(x);
  hopper::wgmma_fence();
  score_steps<HD>(x, a, b);
  hopper::wgmma_commit();
}

// rows 16 warp + lane / 4 (and + 8) of a 64 x hd tile in shared memory
// (the TMA boxes' swizzle) as the A fragments of the hd / 16 steps of a
// product: step kk's hold columns 16 kk + 2 (lane % 4) (+ 1, + 8, + 9), in
// the accumulator's pair layout (hopper.cuh)
template <int HD>
__device__ __forceinline__ void tile_frags(const unsigned char* tile,
                                           uint32_t (&f)[HD / 16][4],
                                           int warp, int lane) {
  using L = Layout<HD>;
  constexpr uint32_t kSwzMask = L::kRowBytes == 128 ? 7 : 3;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * warp + lane / 4 + (e & 1 ? 8 : 0);
      const int byte = (16 * kk + 2 * (lane % 4) + (e & 2 ? 8 : 0)) * 2;
      uint32_t off = byte / L::kRowBytes * L::kBoxBytes + r * L::kRowBytes +
                     byte % L::kRowBytes;
      off ^= ((off >> 7) & kSwzMask) << 4;
      f[kk][e] = *reinterpret_cast<const uint32_t*>(tile + off);
    }
}

// x = A1 B1^T and y = A2 B2^T (64 x 64, fp32) over hd as issue_scores, with
// A1 and A2 as register fragments (tile_frags)
template <int HD>
__device__ __forceinline__ void issue_scores_rs(
    float (&x)[32], float (&y)[32], const uint32_t (&a1)[HD / 16][4],
    uint32_t b1, const uint32_t (&a2)[HD / 16][4], uint32_t b2) {
  using L = Layout<HD>;
  hopper::fence_regs(x);
  hopper::fence_regs(y);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk * 32) / L::kRowBytes * L::kBoxBytes +
                         (kk * 32) % L::kRowBytes;
    hopper::wgmma_rs_m64n64k16(
        x, a1[kk],
        hopper::wgmma_desc(b1 + off, 16, 8 * L::kRowBytes, L::kSwizzle),
        kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk * 32) / L::kRowBytes * L::kBoxBytes +
                         (kk * 32) % L::kRowBytes;
    hopper::wgmma_rs_m64n64k16(
        y, a2[kk],
        hopper::wgmma_desc(b2 + off, 16, 8 * L::kRowBytes, L::kSwizzle),
        kk > 0);
  }
  hopper::wgmma_commit();
}

// acc += A X: A (64 x 64 bf16) as register fragments, X a 64 x hd tile in
// shared memory read N-major (its 64 rows are the contraction, in steps of
// 16 rows; the boxes across hd are LBO apart); not committed
template <int HD>
__device__ __forceinline__ void rs_products(float (&acc)[HD / 2],
                                            uint32_t (&a)[4][4], uint32_t x) {
  using L = Layout<HD>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    rs_step<HD>(acc, a[kk],
                hopper::wgmma_desc(x + kk * 16 * L::kRowBytes, L::kBoxBytes,
                                   8 * L::kRowBytes, L::kSwizzle));
}

// a 64 x 64 fp32 accumulator in bf16 as the A fragments of the next product
__device__ __forceinline__ void to_frags(const float (&x)[32],
                                         uint32_t (&f)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f[kk][e] = hopper::pack_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
}

// acc += A X (rs_products) with A from a 64 x 64 fp32 accumulator, issued
// as one group and waited for
template <int HD>
__device__ __forceinline__ void accumulate_rs(float (&acc)[HD / 2],
                                              const float (&x)[32],
                                              uint32_t tile) {
  uint32_t f[4][4];
  to_frags(x, f);
  hopper::fence_regs(acc);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(f[kk]);
  hopper::wgmma_fence();
  rs_products<HD>(acc, f, tile);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
}

// P^T and, with kGrad, dS^T of a (64 keys, 64 queries) score tile, in place
// of S^T (st) and dP^T (dpt; with kGrad false it is not read or written):
// accumulator column 8j + colq + (e & 1) is a query of the stage's stats
// (ls: lse * log2e, dd: D); key0 is the thread's key (and + 8).  `edge`
// turns on the mask: keys past Sk and masked pairs get P = dS = 0, rows
// with no valid key (lse * log2e = -inf) P = 1 / Sk and dS = 0.
template <bool kGrad>
__device__ __forceinline__ void key_probs(float (&st)[32], float (&dpt)[32],
                                          const float* ls, const float* dd,
                                          int colq, int key0, int q0,
                                          bool edge, const Args& a) {
  const float inv_sk = 1.f / static_cast<float>(a.Sk);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int cq = 8 * j + colq;
    const float2 l = *reinterpret_cast<const float2*>(ls + cq);
    float2 d = make_float2(0.f, 0.f);
    if constexpr (kGrad) d = *reinterpret_cast<const float2*>(dd + cq);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lv = (e & 1) ? l.y : l.x;
      float p = ex2(fmaf(st[4 * j + e], a.scale_log2, -lv));
      float ds = 0.f;
      if constexpr (kGrad) ds = p * (dpt[4 * j + e] - ((e & 1) ? d.y : d.x));
      if (edge) {
        const int key = key0 + (e & 2 ? 8 : 0);
        const int row = q0 + cq + (e & 1);
        if (lv == -INFINITY) {
          p = inv_sk;
          ds = 0.f;
        } else if (key >= a.Sk || masked(row, key, a.causal, a.window)) {
          p = 0.f;
          ds = 0.f;
        }
      }
      st[4 * j + e] = p;
      if constexpr (kGrad) dpt[4 * j + e] = ds;
    }
  }
}

// dS^T of a (64 keys, 64 queries) tile in place of dP^T (dpt), from the P^T
// that key_probs<false> formed (the masked pairs' P already 0): the same
// layout and arguments as key_probs; rows with no valid key get dS = 0.
__device__ __forceinline__ void key_ds(float (&dpt)[32], const float (&pt)[32],
                                       const float* ls, const float* dd,
                                       int colq, int key0, int q0, bool edge,
                                       const Args& a) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int cq = 8 * j + colq;
    const float2 d = *reinterpret_cast<const float2*>(dd + cq);
    const float2 l = *reinterpret_cast<const float2*>(ls + cq);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float ds = pt[4 * j + e] * (dpt[4 * j + e] - ((e & 1) ? d.y : d.x));
      if (edge && ((e & 1) ? l.y : l.x) == -INFINITY) ds = 0.f;
      dpt[4 * j + e] = ds;
    }
  }
}

// dS of a (64 rows, 64 keys) score tile in place of S (sc), from dP (dp):
// accumulator column 8j + colk + (e & 1) is a key of the tile at k0; row0
// is the thread's row (and + 8), with lse * log2e l0, l1 (+inf for a row
// with no valid key, so P = 0) and D d0, d1.  `edge` turns on the mask.
__device__ __forceinline__ void row_ds(float (&sc)[32], const float (&dp)[32],
                                       float l0, float l1, float d0, float d1,
                                       int k0, int colk, int row0, bool edge,
                                       const Args& a) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lv = (e & 2) ? l1 : l0;
      const float p = ex2(fmaf(sc[4 * j + e], a.scale_log2, -lv));
      float ds = p * (dp[4 * j + e] - ((e & 2) ? d1 : d0));
      if (edge) {
        const int key = k0 + 8 * j + colk + (e & 1);
        const int row = row0 + (e & 2 ? 8 : 0);
        if (key >= a.Sk || masked(row, key, a.causal, a.window)) ds = 0.f;
      }
      sc[4 * j + e] = ds;
    }
}

// a (64 x hd) accumulator times `mult` in bf16 into a tile in shared memory
// (the TMA boxes' swizzle), thread (warp, lane)'s rows and columns
template <int HD>
__device__ __forceinline__ void acc_to_tile(unsigned char* tile,
                                            const float (&acc)[HD / 2],
                                            float mult, int warp, int lane) {
  using L = Layout<HD>;
  constexpr uint32_t kSwzMask = L::kRowBytes == 128 ? 7 : 3;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * warp + lane / 4 + 8 * half;
      const int byte = (8 * j + 2 * (lane % 4)) * 2;
      uint32_t off = byte / L::kRowBytes * L::kBoxBytes + r * L::kRowBytes +
                     byte % L::kRowBytes;
      off ^= ((off >> 7) & kSwzMask) << 4;
      *reinterpret_cast<uint32_t*>(tile + off) = hopper::pack_bf16(
          acc[4 * j + 2 * half] * mult, acc[4 * j + 2 * half + 1] * mult);
    }
}

// a 64 x hd tile (rows r0.. of head `head`, batch row b) into shared memory,
// completing on `bar`
template <int HD>
__device__ __forceinline__ void fetch_tile(unsigned char* dst,
                                           const CUtensorMap* map,
                                           uint64_t* bar, int head, int r0,
                                           int b) {
  using L = Layout<HD>;
#pragma unroll
  for (int j = 0; j < L::kBoxes; ++j)
    hopper::tma_load_4d(dst + j * L::kBoxBytes, map, bar, j * L::kBoxCols,
                        head, r0, b);
}

// the reverse: a 64 x hd tile in shared memory to rows r0.. (TMA drops rows
// past the tensor's end)
template <int HD>
__device__ __forceinline__ void put_tile(const CUtensorMap* map,
                                         const unsigned char* src, int head,
                                         int r0, int b) {
  using L = Layout<HD>;
#pragma unroll
  for (int j = 0; j < L::kBoxes; ++j)
    hopper::tma_store_4d(map, src + j * L::kBoxBytes, j * L::kBoxCols, head,
                         r0, b);
}

// the own-tiles barrier, then `stages` full and empty barriers; an empty
// barrier completes when `readers` consumer threads have arrived
__device__ __forceinline__ void init_bars(uint64_t* bars, int stages,
                                          uint32_t readers) {
  if (threadIdx.x == 0) {
    hopper::mbar_init(&bars[0], 1);                        // own tiles
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&bars[1 + s], 1);                  // full
      hopper::mbar_init(&bars[1 + stages + s], readers);   // empty
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
}

// The producer of a dK/dV block: its keys' K and V once (kOwn tiles each),
// then (Q, dO, lse, D) of each query tile of each head of the group
template <int HD>
__device__ __forceinline__ void dkdv_producer(
    const CUtensorMap* tm_q, const CUtensorMap* tm_do, const CUtensorMap* tm_k,
    const CUtensorMap* tm_v, const Args& args, unsigned char* smem,
    uint64_t* bars, const QueryTiles& qt, int k0, int kvh, int b) {
  using L = Layout<HD>;
  uint64_t* own = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + L::kStages;
  const int g = args.H / args.KV;
  const int n_tiles = qt.nA + qt.nB;
  hopper::mbar_expect_tx(own, 2 * L::kOwn * L::kTileBytes);
  for (int c = 0; c < L::kOwn; ++c) {
    fetch_tile<HD>(smem + L::kA1 + c * L::kTileBytes, tm_k, own, kvh,
                   k0 + c * kRows, b);
    fetch_tile<HD>(smem + L::kA2 + c * L::kTileBytes, tm_v, own, kvh,
                   k0 + c * kRows, b);
  }
  int n = 0;
  for (int hh = 0; hh < g; ++hh) {
    const int h = kvh * g + hh;
    const int64_t row = (static_cast<int64_t>(b) * args.H + h) * args.Sq_pad;
    for (int i = 0; i < n_tiles; ++i, ++n) {
      const int q0 = qt.tile(i) * kRows;
      const int s = n % L::kStages;
      hopper::mbar_wait(&empty[s], ((n / L::kStages) & 1) ^ 1);
      hopper::mbar_expect_tx(&full[s], 2 * L::kTileBytes + 2 * kRows * 4);
      unsigned char* stage = smem + L::kB + 2 * s * L::kTileBytes;
      fetch_tile<HD>(stage, tm_q, &full[s], h, q0, b);
      fetch_tile<HD>(stage + L::kTileBytes, tm_do, &full[s], h, q0, b);
      float* stats = reinterpret_cast<float*>(smem + L::kStats) +
                     s * 2 * kRows;
      hopper::bulk_load(stats, args.lse2 + row + q0, kRows * 4, &full[s]);
      hopper::bulk_load(stats + kRows, args.delta + row + q0, kRows * 4,
                        &full[s]);
    }
  }
}

// The producer of a dQ block: its rows' Q and dO once (kOwn tiles each),
// then (K, V) of `count` key tiles from `first`
template <int HD>
__device__ __forceinline__ void dq_producer(
    const CUtensorMap* tm_q, const CUtensorMap* tm_do, const CUtensorMap* tm_k,
    const CUtensorMap* tm_v, unsigned char* smem, uint64_t* bars, int q0,
    int h, int kvh, int b, int first, int count) {
  using L = Layout<HD>;
  uint64_t* own = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + L::kStages;
  hopper::mbar_expect_tx(own, 2 * L::kOwn * L::kTileBytes);
  for (int c = 0; c < L::kOwn; ++c) {
    fetch_tile<HD>(smem + L::kA1 + c * L::kTileBytes, tm_q, own, h,
                   q0 + c * kRows, b);
    fetch_tile<HD>(smem + L::kA2 + c * L::kTileBytes, tm_do, own, h,
                   q0 + c * kRows, b);
  }
  for (int n = 0; n < count; ++n) {
    const int s = n % L::kStages;
    hopper::mbar_wait(&empty[s], ((n / L::kStages) & 1) ^ 1);
    hopper::mbar_expect_tx(&full[s], 2 * L::kTileBytes);
    unsigned char* stage = smem + L::kB + 2 * s * L::kTileBytes;
    fetch_tile<HD>(stage, tm_k, &full[s], kvh, (first + n) * kRows, b);
    fetch_tile<HD>(stage + L::kTileBytes, tm_v, &full[s], kvh,
                   (first + n) * kRows, b);
  }
}

// whether a consumer's 64 keys from c0 are all masked (or past Sk) for the
// 64 query rows from q0, and whether the tile crosses a mask edge
__device__ __forceinline__ void key_tile_state(int c0, int q0, const Args& a,
                                               bool* dead, bool* edge) {
  const int e0 = a.window > 0 ? a.Sk + a.window - 1 : a.Sq;
  // rows with no valid key see every key
  const bool no_valid = a.window > 0 && q0 + kRows - 1 >= e0;
  *dead = c0 >= a.Sk ||
          (!no_valid && ((a.causal && c0 > q0 + kRows - 1) ||
                         (a.window > 0 && c0 + kRows - 1 <= q0 - a.window)));
  *edge = no_valid || c0 + kRows - 1 >= a.Sk ||
          (a.causal && c0 + kRows - 1 > q0) ||
          (a.window > 0 && c0 <= q0 + kRows - 1 - a.window);
}

// whether a consumer's 64 rows from r0 see none of the 64 keys from k0, and
// whether the tile crosses a mask edge
__device__ __forceinline__ void row_tile_state(int r0, int k0, const Args& a,
                                               bool* dead, bool* edge) {
  *dead = r0 >= a.Sq || (a.causal && k0 > r0 + kRows - 1) ||
          (a.window > 0 && k0 + kRows - 1 <= r0 - a.window);
  *edge = k0 + kRows - 1 >= a.Sk || (a.causal && k0 + kRows - 1 > r0) ||
          (a.window > 0 && k0 <= r0 + kRows - 1 - a.window);
}

// Block `blk` of the dK/dV blocks of HD <= 128, one per (128 keys, KV head,
// batch row), heaviest key tiles first: dK and dV of the keys over the g
// query heads of the group, 64 keys for each consumer.
template <int HD>
__device__ __forceinline__ void dkdv_block(
    const CUtensorMap* tm_q, const CUtensorMap* tm_do, const CUtensorMap* tm_k,
    const CUtensorMap* tm_v, const CUtensorMap* tm_dk,
    const CUtensorMap* tm_dv, const Args& args, unsigned char* smem,
    int blk) {
  using L = Layout<HD>;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* own = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + L::kStages;

  const int kt = blk / (args.KV * args.B);
  const int kvh = blk % args.KV;
  const int b = (blk / args.KV) % args.B;
  const int k0 = kt * L::kBlockRows;
  const int g = args.H / args.KV;
  const QueryTiles qt =
      query_tiles(k0, min(k0 + L::kBlockRows, args.Sk) - 1, args.Sq, args.Sk,
                  args.causal, args.window, kRows);
  const int n_tiles = qt.nA + qt.nB;
  init_bars(bars, L::kStages, 256);

  if (threadIdx.x < 128) {
    hopper::regs_release<kProducerRegs>();
    if (threadIdx.x == 0)
      dkdv_producer<HD>(tm_q, tm_do, tm_k, tm_v, args, smem, bars, qt, k0,
                        kvh, b);
  } else {
    // ---- consumers: 64 keys each ----
    hopper::regs_claim<kConsumerRegs>();
    const int c = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int c0 = k0 + c * kRows;              // the warpgroup's keys
    const int key0 = c0 + 16 * warp + lane / 4; // this thread's: key0, +8
    const int colq = 2 * (lane % 4);            // its first query of 8
    unsigned char* own_k = smem + L::kA1 + c * L::kTileBytes;
    unsigned char* own_v = smem + L::kA2 + c * L::kTileBytes;
    const uint32_t a1 = hopper::smem_addr(own_k);
    const uint32_t a2 = hopper::smem_addr(own_v);

    float dk[HD / 2], dv[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
    hopper::mbar_wait(own, 0);
    int n = 0;
    for (int hh = 0; hh < g; ++hh) {
      for (int i = 0; i < n_tiles; ++i, ++n) {
        const int q0 = qt.tile(i) * kRows;
        const int s = n % L::kStages;
        hopper::mbar_wait(&full[s], (n / L::kStages) & 1);
        bool dead, edge;
        key_tile_state(c0, q0, args, &dead, &edge);
        if (!dead) {
          const uint32_t bq = hopper::smem_addr(smem + L::kB) +
                              2 * s * L::kTileBytes;
          const uint32_t bdo = bq + L::kTileBytes;
          const float* ls = reinterpret_cast<const float*>(smem + L::kStats) +
                            s * 2 * kRows;
          float st[32], dpt[32];
          issue_scores<HD>(st, dpt, a1, bq, a2, bdo);   // S^T, dP^T
          hopper::wgmma_wait<0>();
          hopper::fence_regs(st);
          hopper::fence_regs(dpt);
          key_probs<true>(st, dpt, ls, ls + kRows, colq, key0, q0, edge,
                          args);
          uint32_t pf[4][4], sf[4][4];
          to_frags(st, pf);
          to_frags(dpt, sf);
          // dV += P^T dO and dK += dS^T Q
          hopper::fence_regs(dv);
          hopper::fence_regs(dk);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            hopper::fence_regs(pf[kk]);
            hopper::fence_regs(sf[kk]);
          }
          hopper::wgmma_fence();
          rs_products<HD>(dv, pf, bdo);
          rs_products<HD>(dk, sf, bq);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(dv);
          hopper::fence_regs(dk);
        }
        hopper::mbar_arrive(&empty[s]);
      }
    }

    // epilogue: dK * scale and dV in bf16 over the warpgroup's own K and V
    // tiles (no product reads them any more), then TMA stores, which drop
    // keys past Sk and columns past hd
    hopper::named_barrier_sync(1 + c, 128);
    acc_to_tile<HD>(own_k, dk, args.scale, warp, lane);
    acc_to_tile<HD>(own_v, dv, 1.f, warp, lane);
    hopper::fence_proxy_async();
    hopper::named_barrier_sync(1 + c, 128);
    if (tid == 0 && c0 < args.Sk) {
      put_tile<HD>(tm_dk, own_k, kvh, c0, b);
      put_tile<HD>(tm_dv, own_v, kvh, c0, b);
      hopper::tma_store_commit();
      hopper::tma_store_wait_read();
    }
  }
}

// Block `blk` of the dK/dV blocks of HD 256, one per (64 keys, KV head,
// batch row), heaviest key tiles first: both consumers take the keys and
// every stage, the first summing dV, the second dK.  Per query tile the
// first computes S^T = K Q^T, forms P^T and hands it (fp32) to the second
// through one of two shared-memory buffers, then runs dV += P^T dO; the
// second computes dP^T = V dO^T meanwhile, takes P^T, forms dS^T and runs
// dK += dS^T Q: two products each.  Named barriers order the hand-off:
// kReady + b (the first arrives once P^T is written, the second waits)
// and kFree + b (the second arrives once it has read it, the first waits
// before writing buffer b again), matched one for one by the end.
template <int HD>
__device__ __forceinline__ void dkdv_block_wide(
    const CUtensorMap* tm_q, const CUtensorMap* tm_do, const CUtensorMap* tm_k,
    const CUtensorMap* tm_v, const CUtensorMap* tm_dk,
    const CUtensorMap* tm_dv, const Args& args, unsigned char* smem,
    int blk) {
  using L = Layout<HD>;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* own = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + L::kStages;

  const int kt = blk / (args.KV * args.B);
  const int kvh = blk % args.KV;
  const int b = (blk / args.KV) % args.B;
  const int k0 = kt * kRows;
  const int g = args.H / args.KV;
  const QueryTiles qt = query_tiles(k0, min(k0 + kRows, args.Sk) - 1, args.Sq,
                                    args.Sk, args.causal, args.window, kRows);
  const int n_tiles = qt.nA + qt.nB;
  init_bars(bars, L::kStages, 256);

  if (threadIdx.x < 128) {
    hopper::regs_release<kProducerRegs>();
    if (threadIdx.x == 0)
      dkdv_producer<HD>(tm_q, tm_do, tm_k, tm_v, args, smem, bars, qt, k0,
                        kvh, b);
  } else {
    // ---- consumers: 0 sums dV, 1 sums dK, of the same 64 keys ----
    hopper::regs_claim<kConsumerRegs>();
    const int c = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int key0 = k0 + 16 * warp + lane / 4;  // this thread's: key0, +8
    const int colq = 2 * (lane % 4);             // its first query of 8
    unsigned char* own_k = smem + L::kA1;
    unsigned char* own_v = smem + L::kA2;
    const uint32_t a1 = hopper::smem_addr(own_k);
    const uint32_t a2 = hopper::smem_addr(own_v);

    constexpr uint32_t kReady = 4, kFree = 6;   // named barriers, + buffer
    float* xchg = reinterpret_cast<float*>(smem + L::kXchg);
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    hopper::mbar_wait(own, 0);
    int n = 0, m = 0;   // tiles, and tiles not dead (the hand-offs)
    for (int hh = 0; hh < g; ++hh) {
      for (int i = 0; i < n_tiles; ++i, ++n) {
        const int q0 = qt.tile(i) * kRows;
        const int s = n % L::kStages;
        hopper::mbar_wait(&full[s], (n / L::kStages) & 1);
        bool dead, edge;
        key_tile_state(k0, q0, args, &dead, &edge);
        if (!dead) {
          const uint32_t bq = hopper::smem_addr(smem + L::kB) +
                              2 * s * L::kTileBytes;
          const uint32_t bdo = bq + L::kTileBytes;
          const float* ls = reinterpret_cast<const float*>(smem + L::kStats) +
                            s * 2 * kRows;
          const int b = m & 1;
          float* x = xchg + b * kRows * kRows;
          if (c == 0) {
            float st[32];
            issue_score<HD>(st, a1, bq);   // S^T
            hopper::wgmma_wait<0>();
            hopper::fence_regs(st);
            key_probs<false>(st, st, ls, ls + kRows, colq, key0, q0, edge,
                             args);
            if (m >= 2) hopper::named_barrier_sync(kFree + b, 256);
#pragma unroll
            for (int e = 0; e < 32; ++e) x[e * 128 + tid] = st[e];
            __threadfence_block();
            hopper::named_barrier_arrive(kReady + b, 256);
            accumulate_rs<HD>(acc, st, bdo);   // dV += P^T dO
          } else {
            float dpt[32], pt[32];
            issue_score<HD>(dpt, a2, bdo);   // dP^T
            hopper::wgmma_wait<0>();
            hopper::fence_regs(dpt);
            hopper::named_barrier_sync(kReady + b, 256);
#pragma unroll
            for (int e = 0; e < 32; ++e) pt[e] = x[e * 128 + tid];
            hopper::named_barrier_arrive(kFree + b, 256);
            key_ds(dpt, pt, ls, ls + kRows, colq, key0, q0, edge, args);
            accumulate_rs<HD>(acc, dpt, bq);   // dK += dS^T Q
          }
          ++m;
        }
        hopper::mbar_arrive(&empty[s]);
      }
    }
    // the last (up to) two hand-offs' kFree arrivals, matched
    if (c == 0)
      for (int r = m < 2 ? 0 : m - 2; r < m; ++r)
        hopper::named_barrier_sync(kFree + (r & 1), 256);

    // epilogue: once both consumers are past their last product, dV in
    // bf16 over V's tile and dK * scale over K's, then TMA stores, which
    // drop keys past Sk and columns past hd
    hopper::named_barrier_sync(1, 256);
    unsigned char* tile = c == 0 ? own_v : own_k;
    acc_to_tile<HD>(tile, acc, c == 0 ? 1.f : args.scale, warp, lane);
    hopper::fence_proxy_async();
    hopper::named_barrier_sync(2 + c, 128);
    if (tid == 0 && k0 < args.Sk) {
      put_tile<HD>(c == 0 ? tm_dv : tm_dk, tile, kvh, k0, b);
      hopper::tma_store_commit();
      hopper::tma_store_wait_read();
    }
  }
}

// The keys [lo, hi] that rows [q0, q0 + rows) may see, as key tiles
// [first, first + count); a row with no valid key has dS = 0
__device__ __forceinline__ void key_tiles(int q0, int rows, const Args& a,
                                          int* first, int* count) {
  const int lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int hi = a.causal ? min(a.Sk - 1, min(q0 + rows, a.Sq) - 1)
                          : a.Sk - 1;
  *first = lo / kRows;
  *count = lo <= hi ? hi / kRows - *first + 1 : 0;
}

// Block `blk` of the dQ blocks of HD <= 128, one per (128 query rows, head,
// batch row), heaviest query tiles first: dQ of the rows, 64 for each
// consumer.
template <int HD>
__device__ __forceinline__ void dq_block(
    const CUtensorMap* tm_q, const CUtensorMap* tm_do, const CUtensorMap* tm_k,
    const CUtensorMap* tm_v, const CUtensorMap* tm_dq, const Args& args,
    unsigned char* smem, int blk) {
  using L = Layout<HD>;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* own = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + L::kStages;

  const int H = args.H, B = args.B;
  const int n_q = (args.Sq + L::kBlockRows - 1) / L::kBlockRows;
  const int qt = n_q - 1 - blk / (H * B);
  const int h = blk % H;
  const int b = (blk / H) % B;
  const int kvh = h / (H / args.KV);
  const int q0 = qt * L::kBlockRows;
  int first, count;
  key_tiles(q0, L::kBlockRows, args, &first, &count);
  init_bars(bars, L::kStages, 256);

  if (threadIdx.x < 128) {
    hopper::regs_release<kProducerRegs>();
    if (threadIdx.x == 0)
      dq_producer<HD>(tm_q, tm_do, tm_k, tm_v, smem, bars, q0, h, kvh, b,
                      first, count);
  } else {
    // ---- consumers: 64 query rows each ----
    hopper::regs_claim<kConsumerRegs>();
    const int c = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int r_lo = q0 + c * kRows;                // the warpgroup's rows
    const int row0 = r_lo + 16 * warp + lane / 4;   // this thread's: row0, +8
    const int colk = 2 * (lane % 4);                // its first key of 8
    unsigned char* own_q = smem + L::kA1 + c * L::kTileBytes;
    // lse * log2e and D of the two rows (rows are padded to Sq_pad, a
    // multiple of 128); a row with no valid key gets +inf, so P = dS = 0
    const int64_t stat = (static_cast<int64_t>(b) * H + h) * args.Sq_pad;
    float l0 = args.lse2[stat + row0], l1 = args.lse2[stat + row0 + 8];
    l0 = l0 == -INFINITY ? INFINITY : l0;
    l1 = l1 == -INFINITY ? INFINITY : l1;
    const float d0 = args.delta[stat + row0];
    const float d1 = args.delta[stat + row0 + 8];

    float dq[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
    hopper::mbar_wait(own, 0);
    // Q and dO stay in registers as the A fragments of S and dP
    uint32_t qf[HD / 16][4], dof[HD / 16][4];
    tile_frags<HD>(own_q, qf, warp, lane);
    tile_frags<HD>(smem + L::kA2 + c * L::kTileBytes, dof, warp, lane);
    for (int n = 0; n < count; ++n) {
      const int k0 = (first + n) * kRows;
      const int s = n % L::kStages;
      hopper::mbar_wait(&full[s], (n / L::kStages) & 1);
      bool dead, edge;
      row_tile_state(r_lo, k0, args, &dead, &edge);
      if (!dead) {
        const uint32_t bk = hopper::smem_addr(smem + L::kB) +
                            2 * s * L::kTileBytes;
        const uint32_t bv = bk + L::kTileBytes;
        float sc[32], dp[32];
        issue_scores_rs<HD>(sc, dp, qf, bk, dof, bv);   // S, dP
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
        hopper::fence_regs(dp);
        row_ds(sc, dp, l0, l1, d0, d1, k0, colk, row0, edge, args);
        accumulate_rs<HD>(dq, sc, bk);   // dQ += dS K
      }
      hopper::mbar_arrive(&empty[s]);
    }

    // epilogue: dQ * scale in bf16 over the warpgroup's own Q tile, then a
    // TMA store, which drops rows past Sq and columns past hd
    hopper::named_barrier_sync(1 + c, 128);
    acc_to_tile<HD>(own_q, dq, args.scale, warp, lane);
    hopper::fence_proxy_async();
    hopper::named_barrier_sync(1 + c, 128);
    if (tid == 0 && r_lo < args.Sq) {
      put_tile<HD>(tm_dq, own_q, h, r_lo, b);
      hopper::tma_store_commit();
      hopper::tma_store_wait_read();
    }
  }
}

// Block `blk` of the dQ blocks of HD 256, one per (64 query rows, head,
// batch row), heaviest first: consumer c takes key tiles c, c + 2, ... from
// stage c, with Q and dO read from shared memory, and the second's sum
// joins the first's through the ring's buffers.
template <int HD>
__device__ __forceinline__ void dq_block_wide(
    const CUtensorMap* tm_q, const CUtensorMap* tm_do, const CUtensorMap* tm_k,
    const CUtensorMap* tm_v, const CUtensorMap* tm_dq, const Args& args,
    unsigned char* smem, int blk) {
  using L = Layout<HD>;
  static_assert(L::kStages == 2, "a stage for each consumer");
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* own = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + L::kStages;

  const int H = args.H, B = args.B;
  const int n_q = (args.Sq + kRows - 1) / kRows;
  const int qt = n_q - 1 - blk / (H * B);
  const int h = blk % H;
  const int b = (blk / H) % B;
  const int kvh = h / (H / args.KV);
  const int q0 = qt * kRows;
  int first, count;
  key_tiles(q0, kRows, args, &first, &count);
  init_bars(bars, L::kStages, 128);

  if (threadIdx.x < 128) {
    hopper::regs_release<kProducerRegs>();
    if (threadIdx.x == 0)
      dq_producer<HD>(tm_q, tm_do, tm_k, tm_v, smem, bars, q0, h, kvh, b,
                      first, count);
  } else {
    hopper::regs_claim<kConsumerRegs>();
    const int c = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int row0 = q0 + 16 * warp + lane / 4;   // this thread's: row0, +8
    const int colk = 2 * (lane % 4);              // its first key of 8
    const int64_t stat = (static_cast<int64_t>(b) * H + h) * args.Sq_pad;
    float l0 = args.lse2[stat + row0], l1 = args.lse2[stat + row0 + 8];
    l0 = l0 == -INFINITY ? INFINITY : l0;
    l1 = l1 == -INFINITY ? INFINITY : l1;
    const float d0 = args.delta[stat + row0];
    const float d1 = args.delta[stat + row0 + 8];
    const uint32_t aq = hopper::smem_addr(smem + L::kA1);
    const uint32_t ado = hopper::smem_addr(smem + L::kA2);

    float dq[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
    hopper::mbar_wait(own, 0);
    for (int n = c; n < count; n += 2) {
      const int k0 = (first + n) * kRows;
      hopper::mbar_wait(&full[c], (n / 2) & 1);
      bool dead, edge;
      row_tile_state(q0, k0, args, &dead, &edge);
      if (!dead) {
        const uint32_t bk = hopper::smem_addr(smem + L::kB) +
                            2 * c * L::kTileBytes;
        const uint32_t bv = bk + L::kTileBytes;
        float sc[32], dp[32];
        issue_scores<HD>(sc, dp, aq, bk, ado, bv);   // S, dP
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
        hopper::fence_regs(dp);
        row_ds(sc, dp, l0, l1, d0, d1, k0, colk, row0, edge, args);
        accumulate_rs<HD>(dq, sc, bk);   // dQ += dS K
      }
      hopper::mbar_arrive(&empty[c]);
    }

    // epilogue: every load has landed and been read, so the ring is idle;
    // the second consumer's sum goes there (thread-major fp32) and the
    // first adds it to its own, then dQ * scale in bf16 over Q's tile and
    // a TMA store, which drops rows past Sq and columns past hd
    float* red = reinterpret_cast<float*>(smem + L::kB);
    hopper::named_barrier_sync(1, 256);
    if (c == 1) {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) red[i * 128 + tid] = dq[i];
    }
    hopper::named_barrier_sync(1, 256);
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) dq[i] += red[i * 128 + tid];
      unsigned char* own_q = smem + L::kA1;
      acc_to_tile<HD>(own_q, dq, args.scale, warp, lane);
      hopper::fence_proxy_async();
      hopper::named_barrier_sync(2, 128);
      if (tid == 0) {
        put_tile<HD>(tm_dq, own_q, h, q0, b);
        hopper::tma_store_commit();
        hopper::tma_store_wait_read();
      }
    }
  }
}

// The dK/dV blocks, then the dQ blocks, in one grid (both read only D and
// lse of the row dot): the lighter dQ blocks fill the SMs as the dK/dV
// blocks finish, instead of two launches each ending in a partial wave.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_dq,
                    const __grid_constant__ CUtensorMap tm_dk,
                    const __grid_constant__ CUtensorMap tm_dv, const Args args,
                    int kv_blocks) {
  extern __shared__ unsigned char smem_raw[];
  // TMA's 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int blk = static_cast<int>(blockIdx.x);
  if constexpr (Layout<HD>::kWide) {
    if (blk < kv_blocks)
      dkdv_block_wide<HD>(&tm_q, &tm_do, &tm_k, &tm_v, &tm_dk, &tm_dv, args,
                          smem, blk);
    else
      dq_block_wide<HD>(&tm_q, &tm_do, &tm_k, &tm_v, &tm_dq, args, smem,
                        blk - kv_blocks);
  } else {
    if (blk < kv_blocks)
      dkdv_block<HD>(&tm_q, &tm_do, &tm_k, &tm_v, &tm_dk, &tm_dv, args, smem,
                     blk);
    else
      dq_block<HD>(&tm_q, &tm_do, &tm_k, &tm_v, &tm_dq, args, smem,
                   blk - kv_blocks);
  }
}

// hd: the tensors' head dim, at most HD and a multiple of 8 (the tensor
// maps' extent, so TMA zero-fills and drops the columns past it)
template <int HD>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, float* work, void* dq,
           void* dk, void* dv, int64_t B, int64_t Sq, int64_t Sk, int64_t H,
           int64_t KV, int64_t hd, int64_t causal, int64_t window,
           float scale, cudaStream_t stream) {
  using L = Layout<HD>;
  const int64_t Sq_pad = (Sq + kPad - 1) / kPad * kPad;
  float* lse2 = work;
  float* delta = work + B * H * Sq_pad;
  const int64_t rows = B * Sq_pad * H;
  flash_bwd_dot<__nv_bfloat16, HD>
      <<<dot_blocks<HD>(rows), kDotWarps * 32, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(out),
          static_cast<const __nv_bfloat16*>(dout), lse, delta, lse2, rows,
          static_cast<int>(Sq), static_cast<int>(Sq_pad),
          static_cast<int>(H), static_cast<int>(hd));
  int err = static_cast<int>(cudaGetLastError());
  CUtensorMap tm_q, tm_do, tm_k, tm_v, tm_dq, tm_dk, tm_dv;
  const void* qs[3] = {q, dout, dq};
  CUtensorMap* qm[3] = {&tm_q, &tm_do, &tm_dq};
  const void* ks[4] = {k, v, dk, dv};
  CUtensorMap* km[4] = {&tm_k, &tm_v, &tm_dk, &tm_dv};
  for (int i = 0; i < 3 && !err; ++i)
    err = hopper::encode_bshd_bf16(qm[i], qs[i], B, Sq, H, hd, L::kBoxCols,
                                   kRows, L::kSwizzle);
  for (int i = 0; i < 4 && !err; ++i)
    err = hopper::encode_bshd_bf16(km[i], ks[i], B, Sk, KV, hd, L::kBoxCols,
                                   kRows, L::kSwizzle);
  if (!err)
    err = static_cast<int>(cudaFuncSetAttribute(
        flash_bwd_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::kSmemBytes)));
  if (err) return err;
  const int64_t kv_blocks =
      (Sk + L::kBlockRows - 1) / L::kBlockRows * KV * B;
  const int64_t q_blocks = (Sq + L::kBlockRows - 1) / L::kBlockRows * H * B;
  if (kv_blocks + q_blocks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args args{lse2, delta, static_cast<int>(B), static_cast<int>(Sq),
                  static_cast<int>(Sq_pad), static_cast<int>(Sk),
                  static_cast<int>(H), static_cast<int>(KV),
                  static_cast<int>(causal), static_cast<int>(window), scale,
                  scale * kLog2e};
  flash_bwd_wgmma<HD><<<static_cast<unsigned>(kv_blocks + q_blocks), kThreads,
                        L::kSmemBytes, stream>>>(
      tm_q, tm_do, tm_k, tm_v, tm_dq, tm_dk, tm_dv, args,
      static_cast<int>(kv_blocks));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wgb

using BwdLaunch = int (*)(const void*, const void*, const void*, const void*,
                          const void*, const float*, float*, void*, void*,
                          void*, int64_t, int64_t, int64_t, int64_t, int64_t,
                          int64_t, int64_t, int64_t, float, cudaStream_t);

constexpr BwdLaunch kBwdF32[4] = {launch_f32<32>, launch_f32<64>,
                                  launch_f32<128>, launch_f32<256>};
constexpr BwdLaunch kBwdBf16[4] = {wgb::launch<32>, wgb::launch<64>,
                                   wgb::launch<128>, wgb::launch<256>};

// one launcher per instantiation (kHeadDims)
int bwd(const BwdLaunch* by_hd, const void* q, const void* k, const void* v,
        const void* out, const void* dout, const void* lse, void* work,
        void* dq, void* dk, void* dv, int64_t B, int64_t Sq, int64_t Sk,
        int64_t H, int64_t KV, int64_t hd, int64_t causal, int64_t window,
        float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 ||
      B > 65535 || H > 65535 || KV > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int i = head_dim_index(hd);
  if (i < 0) return static_cast<int>(cudaErrorInvalidValue);
  return by_hd[i](q, k, v, out, dout, static_cast<const float*>(lse),
                  static_cast<float*>(work), dq, dk, dv, B, Sq, Sk, H, KV, hd,
                  causal, window, scale, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                            const void* out, const void* dout, const void* lse,
                            void* work, void* dq, void* dk, void* dv,
                            int64_t B, int64_t Sq, int64_t Sk, int64_t H,
                            int64_t KV, int64_t hd, int64_t causal,
                            int64_t window, float scale, void* stream) {
  return bwd(kBwdF32, q, k, v, out, dout, lse, work, dq, dk, dv, B, Sq, Sk,
             H, KV, hd, causal, window, scale, stream);
}

int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* out, const void* dout,
                             const void* lse, void* work, void* dq, void* dk,
                             void* dv, int64_t B, int64_t Sq, int64_t Sk,
                             int64_t H, int64_t KV, int64_t hd, int64_t causal,
                             int64_t window, float scale, void* stream) {
  return bwd(kBwdBf16, q, k, v, out, dout, lse, work, dq, dk, dv, B, Sq, Sk,
             H, KV, hd, causal, window, scale, stream);
}

}  // extern "C"
