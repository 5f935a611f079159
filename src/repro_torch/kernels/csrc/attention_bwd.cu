// The backward of flash_attention for Hopper (sm_90a).
//
// flash_attention_bwd: q (B,Sq,H,hd), k/v (B,Sk,KV,hd), the forward's out
//     (B,Sq,H,hd) and lse (B,H,Sq) fp32 (natural log, attention.cu), and
//     dout (B,Sq,H,hd) -> dq, dk, dv in the inputs' dtype (fp32 or bf16),
//     by the FlashAttention-2 algorithm:
//       D  = rowsum(dO o O)                        flash_bwd_dot
//       P  = exp(S - lse), dP = dO V^T, dS = P o (dP - D)
//       dV = P^T dO, dK = dS^T Q * scale           flash_bwd_dkdv
//       dQ = dS K * scale                          flash_bwd_dq
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
//   unmasked pair, 0.69 ms at 989 TFLOP/s).
//   What the design does (a first kernel, right and simple):
//     * fp32 FMA pipes for both dtypes: tiles of 64 queries by 64 keys in
//       shared memory as fp32 rows padded by 4 floats (16-byte loads, banks
//       spread); 256 threads, each owning a 4x4 micro-tile of a score tile
//       (rows ty+16i, columns tx+16j) and a 4 x hd/16 micro-tile of an
//       accumulator, as the fp32 forward kernel;
//     * S and P are recomputed from lse, never stored;
//     * flash_bwd_dkdv: one block per (key tile, KV head, batch row) walks
//       the g query heads of its GQA group and only the query tiles that
//       the mask lets see its keys (and the tiles holding rows with no
//       valid key), accumulates dK and dV in registers and writes each
//       once: the group's sum stays in the block, with no atomics, so the
//       result repeats bit for bit;
//     * flash_bwd_dq: one block per (query tile, head, batch row) walks the
//       key tiles its rows may see and writes dQ once.
//   Tensor cores (mma.sync or wgmma) and TMA are later work.
//
// C interface (bound with ctypes): flash_attention_bwd_{f32,bf16} launch
// the three kernels on the stream and return the first cudaGetLastError()
// that is not cudaSuccess, or cudaErrorInvalidValue for a head dim other
// than 32, 64, 128.  delta is a (B,H,Sq) fp32 workspace for D.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention.cuh"

namespace {

constexpr int kT = 64;          // queries or keys per tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kPStride = kT + 4;
constexpr int kDotWarps = 8;

template <int HD>
struct BwdSmem {
  static constexpr int kStride = HD + 4;   // floats per row of a tile
  // four (kT, HD) tiles, two (kT, kT) score tiles, lse and D of kT rows
  static constexpr size_t kDkdvBytes =
      sizeof(float) * (4 * kT * kStride + 2 * kT * kPStride + 2 * kT);
  // four (kT, HD) tiles, one (kT, kT) score tile, lse and D
  static constexpr size_t kDqBytes =
      sizeof(float) * (4 * kT * kStride + kT * kPStride + 2 * kT);
};

__device__ __forceinline__ bool masked(int r, int c, int causal, int window) {
  return (causal && c > r) || (window > 0 && c <= r - window);
}

// D[b, h, i] = sum_d dO . O in fp32: one warp per (b, i, h) row
template <typename T, int HD>
__global__ void __launch_bounds__(kDotWarps * 32)
    flash_bwd_dot(const T* __restrict__ out, const T* __restrict__ dout,
                  float* __restrict__ delta, int64_t rows, int Sq, int H) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kDotWarps +
                    threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const T* o = out + r * HD;
  const T* d = dout + r * HD;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < HD; c += 32)
    acc = fmaf(to_f32(d[c]), to_f32(o[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int64_t h = r % H;
    const int64_t i = (r / H) % Sq;
    const int64_t b = r / (static_cast<int64_t>(H) * Sq);
    delta[(b * H + h) * Sq + i] = acc;
  }
}

// lse and D of query rows q0 .. q0 + kT - 1 of head h into shared memory;
// rows past Sq get lse = +inf, so their P is 0
__device__ __forceinline__ void load_row_stats(const float* lse,
                                               const float* delta,
                                               int64_t base, int q0, int Sq,
                                               float* lse_s, float* d_s) {
  if (threadIdx.x < kT) {
    const int r = q0 + threadIdx.x;
    lse_s[threadIdx.x] = r < Sq ? lse[base + r] : INFINITY;
    d_s[threadIdx.x] = r < Sq ? delta[base + r] : 0.f;
  }
}

// s[i][j] += A[ra + 16i] . B[rb + 16j] over HD, both from shared rows of
// stride kStride, for two pairs of tiles at once
template <int HD>
__device__ __forceinline__ void two_products(const float* A0, const float* B0,
                                             const float* A1, const float* B1,
                                             int ra, int rb, float (&s0)[4][4],
                                             float (&s1)[4][4]) {
  constexpr int kS = BwdSmem<HD>::kStride;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s0[i][j] = s1[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 a0[4], b0[4], a1[4], b1[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a0[i] = *reinterpret_cast<const float4*>(A0 + (ra + 16 * i) * kS + d);
      a1[i] = *reinterpret_cast<const float4*>(A1 + (ra + 16 * i) * kS + d);
      b0[i] = *reinterpret_cast<const float4*>(B0 + (rb + 16 * i) * kS + d);
      b1[i] = *reinterpret_cast<const float4*>(B1 + (rb + 16 * i) * kS + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
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

// acc[i][jj] += sum_e P[ty + 16i][e] * X[e][out_col(jj)] over the kT
// columns of P (shared, stride kPStride) and rows of X (stride kStride)
template <int HD>
__device__ __forceinline__ void accumulate(const float* P, const float* X,
                                           int tx, int ty,
                                           float (&acc)[4][HD / 16]) {
  constexpr int kS = BwdSmem<HD>::kStride;
  constexpr int kCols = HD / 16;
#pragma unroll 2
  for (int kk = 0; kk < kT; kk += 4) {
    float pa[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 t =
          *reinterpret_cast<const float4*>(P + (ty + 16 * i) * kPStride + kk);
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
// rows r0 + ty + 16i (< rows) of dst (row stride in elements)
template <typename T, int HD>
__device__ __forceinline__ void store_rows(T* dst, int64_t row_stride, int r0,
                                           int rows, int tx, int ty,
                                           const float (&acc)[4][HD / 16],
                                           float mult) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= rows) continue;
    T* row = dst + r * row_stride;
#pragma unroll
    for (int jj = 0; jj < HD / 16; ++jj)
      row[out_col<HD>(tx, jj)] = from_f32<T>(acc[i][jj] * mult);
  }
}

// One block per (key tile, KV head, batch row): dK and dV of kT keys over
// the g query heads of the group.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk,
                   T* __restrict__ dv, int Sq, int Sk, int H, int KV,
                   int causal, int window, float scale) {
  constexpr int kS = BwdSmem<HD>::kStride;
  constexpr int kCols = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + kT * kS;
  float* Qs = Vs + kT * kS;
  float* dOs = Qs + kT * kS;
  float* Pt = dOs + kT * kS;          // P^T: (keys, queries)
  float* dSt = Pt + kT * kPStride;    // dS^T
  float* lse_s = dSt + kT * kPStride;
  float* d_s = lse_s + kT;

  const int k0 = blockIdx.x * kT;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int g = H / KV;
  const int k_last = min(k0 + kT, Sk) - 1;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int64_t kv_stride = static_cast<int64_t>(KV) * HD;
  const int64_t kv_base = static_cast<int64_t>(b) * Sk * kv_stride +
                          static_cast<int64_t>(kvh) * HD + k0 * kv_stride;
  load_tile<HD>(k + kv_base, kv_stride, Sk - k0, Ks, kS, kT);
  load_tile<HD>(v + kv_base, kv_stride, Sk - k0, Vs, kS, kT);

  // the query rows that see some key of the tile, then the rows with no
  // valid key at all (every row >= e0), which average every key
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq - 1, k_last + window - 1) : Sq - 1;
  const int e0 = window > 0 ? Sk + window - 1 : Sq;
  const int tA0 = q_lo / kT;
  const int nA = q_lo <= q_hi ? q_hi / kT - tA0 + 1 : 0;
  const int tB0 = max(nA > 0 ? tA0 + nA : 0, e0 / kT);
  const int nB = e0 < Sq ? max(0, (Sq - 1) / kT - tB0 + 1) : 0;
  const int n_tiles = nA + nB;
  const float inv_sk = 1.f / static_cast<float>(Sk);
  const int64_t q_stride = static_cast<int64_t>(H) * HD;

  float acc_k[4][kCols], acc_v[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) acc_k[i][jj] = acc_v[i][jj] = 0.f;

  for (int hh = 0; hh < g; ++hh) {
    const int h = kvh * g + hh;
    const int64_t stat_base = (static_cast<int64_t>(b) * H + h) * Sq;
    for (int n = 0; n < n_tiles; ++n) {
      const int q0 = (n < nA ? tA0 + n : tB0 + n - nA) * kT;
      const int64_t q_base = (static_cast<int64_t>(b) * Sq + q0) * q_stride +
                             static_cast<int64_t>(h) * HD;
      __syncthreads();   // the previous tile's Qs, dOs, Pt, dSt are consumed
      load_tile<HD>(q + q_base, q_stride, Sq - q0, Qs, kS, kT);
      load_tile<HD>(dout + q_base, q_stride, Sq - q0, dOs, kS, kT);
      load_row_stats(lse, delta, stat_base, q0, Sq, lse_s, d_s);
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: keys ty + 16i, queries tx + 16j
      float st[4][4], dpt[4][4];
      two_products<HD>(Ks, Qs, Vs, dOs, ty, tx, st, dpt);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
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
          Pt[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
          dSt[(ty + 16 * i) * kPStride + tx + 16 * j] = ds;
        }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q on the thread's 4 x hd/16 micro-tiles
      accumulate<HD>(Pt, dOs, tx, ty, acc_v);
      accumulate<HD>(dSt, Qs, tx, ty, acc_k);
    }
  }
  const int64_t out_base = static_cast<int64_t>(b) * Sk * kv_stride +
                           static_cast<int64_t>(kvh) * HD;
  store_rows<T, HD>(dk + out_base, kv_stride, k0, Sk, tx, ty, acc_k, scale);
  store_rows<T, HD>(dv + out_base, kv_stride, k0, Sk, tx, ty, acc_v, 1.f);
}

// One block per (query tile, head, batch row): dQ of kT rows.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq, int Sq,
                 int Sk, int H, int KV, int causal, int window, float scale) {
  constexpr int kS = BwdSmem<HD>::kStride;
  constexpr int kCols = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + kT * kS;
  float* Ks = dOs + kT * kS;
  float* Vs = Ks + kT * kS;
  float* dS = Vs + kT * kS;           // (queries, keys)
  float* lse_s = dS + kT * kPStride;
  float* d_s = lse_s + kT;

  const int q0 = blockIdx.x * kT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q_last = min(q0 + kT, Sq) - 1;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int64_t q_stride = static_cast<int64_t>(H) * HD;
  const int64_t q_base = (static_cast<int64_t>(b) * Sq + q0) * q_stride +
                         static_cast<int64_t>(h) * HD;
  load_tile<HD>(q + q_base, q_stride, Sq - q0, Qs, kS, kT);
  load_tile<HD>(dout + q_base, q_stride, Sq - q0, dOs, kS, kT);
  load_row_stats(lse, delta, (static_cast<int64_t>(b) * H + h) * Sq, q0, Sq,
                 lse_s, d_s);

  // the keys the tile's rows may see; a row with no valid key has dS = 0
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(Sk - 1, q_last) : Sk - 1;
  const int64_t kv_stride = static_cast<int64_t>(KV) * HD;
  const int64_t kv_base = static_cast<int64_t>(b) * Sk * kv_stride +
                          static_cast<int64_t>(kvh) * HD;

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) acc[i][jj] = 0.f;

  for (int kt = lo / kT; lo <= hi && kt <= hi / kT; ++kt) {
    const int k0 = kt * kT;
    __syncthreads();   // the previous tile's Ks, Vs, dS are consumed
    load_tile<HD>(k + kv_base + k0 * kv_stride, kv_stride, Sk - k0, Ks, kS,
                  kT);
    load_tile<HD>(v + kv_base + k0 * kv_stride, kv_stride, Sk - k0, Vs, kS,
                  kT);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: queries ty + 16i, keys tx + 16j
    float s[4][4], dp[4][4];
    two_products<HD>(Qs, Ks, dOs, Vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      const float l = lse_s[ty + 16 * i];
      const bool row_ok = r < Sq && l > 0.5f * kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        float ds = 0.f;
        if (row_ok && c < Sk && !masked(r, c, causal, window)) {
          const float p = expf(s[i][j] * scale - l);
          ds = p * (dp[i][j] - d_s[ty + 16 * i]);
        }
        dS[(ty + 16 * i) * kPStride + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
    accumulate<HD>(dS, Ks, tx, ty, acc);   // dQ += dS K
  }
  const int64_t out_base = static_cast<int64_t>(b) * Sq * q_stride +
                           static_cast<int64_t>(h) * HD;
  store_rows<T, HD>(dq + out_base, q_stride, q0, Sq, tx, ty, acc, scale);
}

template <typename T, int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int64_t B, int64_t Sq, int64_t Sk,
               int64_t H, int64_t KV, int64_t causal, int64_t window,
               float scale, cudaStream_t stream) {
  using L = BwdSmem<HD>;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const int64_t rows = B * Sq * H;
  flash_bwd_dot<T, HD><<<static_cast<unsigned>((rows + kDotWarps - 1) /
                                               kDotWarps),
                         kDotWarps * 32, 0, stream>>>(
      static_cast<const T*>(out), tdo, delta, rows, static_cast<int>(Sq),
      static_cast<int>(H));
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dkdv<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(L::kDkdvBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv(static_cast<unsigned>((Sk + kT - 1) / kT),
                     static_cast<unsigned>(KV), static_cast<unsigned>(B));
  flash_bwd_dkdv<T, HD><<<grid_kv, kThreads, L::kDkdvBytes, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<int>(Sq), static_cast<int>(Sk), static_cast<int>(H),
      static_cast<int>(KV), static_cast<int>(causal),
      static_cast<int>(window), scale);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(L::kDqBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q(static_cast<unsigned>((Sq + kT - 1) / kT),
                    static_cast<unsigned>(H), static_cast<unsigned>(B));
  flash_bwd_dq<T, HD><<<grid_q, kThreads, L::kDqBytes, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), static_cast<int>(Sq),
      static_cast<int>(Sk), static_cast<int>(H), static_cast<int>(KV),
      static_cast<int>(causal), static_cast<int>(window), scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const void* q, const void* k, const void* v, const void* out,
        const void* dout, const void* lse, void* delta, void* dq, void* dk,
        void* dv, int64_t B, int64_t Sq, int64_t Sk, int64_t H, int64_t KV,
        int64_t hd, int64_t causal, int64_t window, float scale,
        void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 ||
      B > 65535 || H > 65535 || KV > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch_bwd<T, 32>(q, k, v, out, dout, l, d, dq, dk, dv, B, Sq,
                               Sk, H, KV, causal, window, scale, s);
    case 64:
      return launch_bwd<T, 64>(q, k, v, out, dout, l, d, dq, dk, dv, B, Sq,
                               Sk, H, KV, causal, window, scale, s);
    case 128:
      return launch_bwd<T, 128>(q, k, v, out, dout, l, d, dq, dk, dv, B, Sq,
                                Sk, H, KV, causal, window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                            const void* out, const void* dout, const void* lse,
                            void* delta, void* dq, void* dk, void* dv,
                            int64_t B, int64_t Sq, int64_t Sk, int64_t H,
                            int64_t KV, int64_t hd, int64_t causal,
                            int64_t window, float scale, void* stream) {
  return bwd<float>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H,
                    KV, hd, causal, window, scale, stream);
}

int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* out, const void* dout,
                             const void* lse, void* delta, void* dq, void* dk,
                             void* dv, int64_t B, int64_t Sq, int64_t Sk,
                             int64_t H, int64_t KV, int64_t hd, int64_t causal,
                             int64_t window, float scale, void* stream) {
  return bwd<__nv_bfloat16>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq,
                            Sk, H, KV, hd, causal, window, scale, stream);
}

}  // extern "C"
