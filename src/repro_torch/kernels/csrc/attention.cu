// Attention kernels for Hopper (sm_90a): the prefill/score forward and the
// one-token decode of the LLM serving path.
//
// flash_attention: causal / sliding-window / non-causal GQA attention
//     q (B,Sq,H,hd), k/v (B,Sk,KV,hd) -> out (B,Sq,H,hd) in q's dtype;
//     query head h reads KV head h / (H/KV); query i and key j are
//     positions i and j (mask: j <= i when causal, j > i - window when
//     windowed).
//   Replaces src/repro/kernels/flash_attention.py::flash_attention (the
//   Pallas kernel behind models/attention.py::gqa_forward).
//   Bound: operations.  4*hd flops per unmasked (query, key) pair against
//   (2*Sq*H + 2*Sk*KV)*hd elements moved; at qwen3-1.7b's prefill shape
//   (B=4, S=4096, H=16, KV=8, hd=128, causal) that is ~1,400 flops per byte,
//   far above the card's ~295 bf16 flops per byte, so the least time is
//   flops / 989 TFLOP/s (bf16) or / 67 TFLOP/s (fp32, no tensor cores).
//   What the design does:
//     * one block per (q tile of 64 rows, head, batch); K/V tiles of 64 keys
//       of KV head h / (H/KV) stream through shared memory and the block
//       keeps an fp32 running max, sum and accumulator per row (online
//       softmax), writing the output once;
//     * K tiles that the causal/window structure rules out for every row of
//       the q tile are never loaded (half the work when causal), as
//       flash_attention.py:66-72 prunes them;
//     * bf16 (the model's path) runs both products on the tensor cores with
//       mma.sync m16n8k16, 4 warps of 16 query rows each: Q's fragments stay
//       in registers, K and V fragments come by ldmatrix from padded shared
//       rows, P goes from the S accumulators to bf16 A fragments in
//       registers.  wgmma, TMA and a pipelined K loop are later work;
//     * fp32 runs on the FMA pipes: 256 threads, each owning a 4x4
//       micro-tile of the 64x64 score tile (rows ty+16i, keys tx+16j) and a
//       4 x hd/16 micro-tile of the output, read with 16-byte shared-memory
//       loads from padded, bank-conflict-free rows;
//     * the model's (B,S,heads,hd) layout is read in place: no padding of
//       hd to 128 lanes, no padding of S, no transposes (the TPU kernel's
//       host-side jnp.pad / transpose are TPU layout constraints).
//
// decode_attention: one query token per sequence against a ring-buffer cache
//     q (B,1,H,hd), k/v (B,S,KV,hd), valid (S,) bool shared by the batch ->
//     out (B,1,H,hd) in q's dtype.
//   Replaces src/repro/kernels/decode_attention.py::decode_attention (the
//   Pallas kernel behind models/attention.py::gqa_decode).
//   Bound: memory.  2*g*hd flops per cache row of 2*hd elements (g = H/KV),
//   so the least time is the K/V bytes / 3.35 TB/s.  What the design does:
//     * one 256-thread block per (KV head, batch) keeps the whole GQA group's
//       queries in shared memory and streams that head's K/V rows once, in
//       tiles of 64 keys: every cache byte serves all g heads;
//     * K rows are read with 16-byte loads by hd/8 lanes per key; V columns
//       by consecutive threads (coalesced rows);
//     * fp32 online softmax per head across tiles.
//   At B=4, KV=8 that is 32 blocks on 132 SMs: splitting S across blocks
//   (flash-decoding) is later work.
//
// Masking follows the JAX package's reference exactly: a masked key inside
// the sequence gets the finite score -1e30 (so a row with no valid key
// averages every key uniformly, never NaN), and the output is
// acc / max(l, 1e-30) cast to q's dtype.  Keys past the end of the sequence
// (the last ragged tile) get -inf and weigh nothing.
//
// C interface (bound with ctypes): flash_attention_{f32,bf16} and
// decode_attention_{f32,bf16}; each returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a head dim other than 32, 64, 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 8 consecutive elements (16-byte aligned) -> 8 floats
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// ---------------------------------------------------------------------------
// flash_attention, fp32: the FMA-pipe kernel (bf16 takes the tensor-core
// kernel below)
// ---------------------------------------------------------------------------
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kFlashThreads = 256;   // 16 x 16

// The keys [lo, hi] that the q tile [q0, q_last] needs.  A row with no valid
// key at all (possible only without causality or with Sq > Sk) must average
// every key, as the plain version does, so such a tile visits all of them.
// Every thread of the block calls it (it synchronises).
__device__ __forceinline__ void key_range(int q0, int q_last, int Sk,
                                          int causal, int window, int* lo,
                                          int* hi) {
  *lo = window > 0 ? max(0, q0 - window + 1) : 0;
  *hi = causal ? min(Sk - 1, q_last) : Sk - 1;
  int empty = 0;
  for (int r = q0 + threadIdx.x; r <= q_last; r += blockDim.x) {
    const int rlo = window > 0 ? max(0, r - window + 1) : 0;
    const int rhi = causal ? min(r, Sk - 1) : Sk - 1;
    empty |= rlo > rhi;
  }
  if (__syncthreads_or(empty)) {
    *lo = 0;
    *hi = Sk - 1;
  }
}

// score of key c for query row r before the softmax: -inf past the end of
// the sequence, the finite -1e30 where the mask rules the pair out
__device__ __forceinline__ float masked_score(float dot, int r, int c, int Sk,
                                              int causal, int window,
                                              float scale) {
  if (c >= Sk) return -INFINITY;
  if ((causal && c > r) || (window > 0 && c <= r - window)) return kNegInf;
  return dot * scale;
}

template <int HD>
struct FlashSmem {
  static constexpr int kQStride = HD + 4;   // floats; float4 rows, banks spread
  static constexpr int kKStride = HD + 4;
  static constexpr int kVStride = HD;
  static constexpr int kPStride = kBK + 4;
  static constexpr size_t kBytes =
      sizeof(float) * (kBQ * kQStride + kBK * kKStride + kBK * kVStride +
                       kBQ * kPStride);
};

// rows x HD floats at base (row stride in elements) -> shared memory rows
// of stride sstride; rows at or past rows_valid are zero.
template <int HD>
__device__ __forceinline__ void load_tile(const float* base, int64_t row_stride,
                                          int rows_valid, float* s,
                                          int sstride, int rows) {
  constexpr int kChunks = HD / 8;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += blockDim.x) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    float x[8];
    if (r < rows_valid) {
      load8(base + r * row_stride + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.f;
    }
    float4* dst = reinterpret_cast<float4*>(s + r * sstride + c);
    dst[0] = make_float4(x[0], x[1], x[2], x[3]);
    dst[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
}

// output column of a thread's jj-th accumulator: two float4 groups per 64
// columns (hd 64, 128), or a float2 (hd 32)
template <int HD>
__device__ __forceinline__ int out_col(int tx, int jj) {
  if constexpr (HD >= 64) {
    return (jj / 4) * 64 + tx * 4 + (jj % 4);
  } else {
    return tx * 2 + jj;
  }
}

template <int HD>
__global__ void __launch_bounds__(kFlashThreads)
    flash_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out,
                           int Sq, int Sk, int H, int KV, int causal,
                           int window, float scale) {
  using L = FlashSmem<HD>;
  constexpr int kCols = HD / 16;   // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * L::kQStride;
  float* Vs = Ks + kBK * L::kKStride;
  float* Ps = Vs + kBK * L::kVStride;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  int lo, hi;
  key_range(q0, q_last, Sk, causal, window, &lo, &hi);

  const int64_t q_stride = static_cast<int64_t>(H) * HD;
  load_tile<HD>(q + (static_cast<int64_t>(b) * Sq + q0) * q_stride +
                       static_cast<int64_t>(h) * HD,
                   q_stride, Sq - q0, Qs, L::kQStride, kBQ);

  const int64_t kv_stride = static_cast<int64_t>(KV) * HD;
  const int64_t kv_base = static_cast<int64_t>(b) * Sk * kv_stride +
                          static_cast<int64_t>(kvh) * HD;

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) acc[i][jj] = 0.f;
  }

  for (int kt = lo / kBK; kt <= hi / kBK; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile's Ks, Vs, Ps are consumed
    load_tile<HD>(k + kv_base + k0 * kv_stride, kv_stride, Sk - k0, Ks,
                     L::kKStride, kBK);
    load_tile<HD>(v + kv_base + k0 * kv_stride, kv_stride, Sk - k0, Vs,
                     L::kVStride, kBK);
    __syncthreads();

    // S = Q K^T on the thread's 4x4 micro-tile
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(
            Qs + (ty + 16 * i) * L::kQStride + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(
            Ks + (tx + 16 * j) * L::kKStride + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qa[i].x, kb[j].x, a);
          a = fmaf(qa[i].y, kb[j].y, a);
          a = fmaf(qa[i].z, kb[j].z, a);
          a = fmaf(qa[i].w, kb[j].w, a);
          s[i][j] = a;
        }
    }

    // mask, then the online-softmax update of each of the thread's rows;
    // a row's 16 owners are the 16 lanes of one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = masked_score(s[i][j], r, k0 + tx + 16 * j, Sk, causal,
                               window, scale);
        tmax = fmaxf(tmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m[i], tmax);
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * L::kPStride + tx + 16 * j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * corr + psum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) acc[i][jj] *= corr;
    }
    __syncthreads();

    // O += P V on the thread's 4 x hd/16 micro-tile
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float pa[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t = *reinterpret_cast<const float4*>(
            Ps + (ty + 16 * i) * L::kPStride + kk);
        pa[i][0] = t.x; pa[i][1] = t.y; pa[i][2] = t.z; pa[i][3] = t.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = Vs + (kk + e) * L::kVStride;
        float vv[kCols];
        if constexpr (HD >= 64) {
#pragma unroll
          for (int g4 = 0; g4 < kCols / 4; ++g4) {
            const float4 t =
                *reinterpret_cast<const float4*>(vrow + g4 * 64 + tx * 4);
            vv[4 * g4] = t.x; vv[4 * g4 + 1] = t.y;
            vv[4 * g4 + 2] = t.z; vv[4 * g4 + 3] = t.w;
          }
        } else {
          const float2 t = *reinterpret_cast<const float2*>(vrow + tx * 2);
          vv[0] = t.x; vv[1] = t.y;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < kCols; ++jj)
            acc[i][jj] = fmaf(pa[i][e], vv[jj], acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = out + (static_cast<int64_t>(b) * Sq + r) * q_stride +
                  static_cast<int64_t>(h) * HD;
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj)
      orow[out_col<HD>(tx, jj)] = acc[i][jj] / denom;
  }
}

template <int HD>
int launch_flash(const void* q, const void* k, const void* v, void* out,
                 int64_t B, int64_t Sq, int64_t Sk, int64_t H, int64_t KV,
                 int64_t causal, int64_t window, float scale,
                 cudaStream_t stream) {
  const size_t smem = FlashSmem<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((Sq + kBQ - 1) / kBQ),
                  static_cast<unsigned>(H), static_cast<unsigned>(B));
  flash_attention_kernel<HD><<<grid, kFlashThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<int>(Sq), static_cast<int>(Sk), static_cast<int>(H),
      static_cast<int>(KV), static_cast<int>(causal),
      static_cast<int>(window), scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// flash_attention, bf16: the same tiling on the tensor cores.  Four warps
// each own 16 query rows of the 64-row q tile.  S = Q K^T and O += P V run
// as mma.sync m16n8k16 (bf16 in, fp32 accumulate); Q's fragments stay in
// registers for the whole K loop, K and V fragments come from shared memory
// by ldmatrix (V transposed on the fly), and the fp32 scores of S become
// P's bf16 A fragments without touching shared memory.  The softmax
// statistics of a row live in the 4 lanes that share it.
// ---------------------------------------------------------------------------
constexpr int kMmaThreads = 128;

template <int HD>
struct MmaSmem {
  static constexpr int kStride = HD + 8;   // bf16; 16-byte pad: ldmatrix rows
                                           // fall in distinct bank groups
  static constexpr size_t kBytes =
      sizeof(__nv_bfloat16) * (kBQ + 2 * kBK) * kStride;
};

// rows x HD bf16 at base (row stride in elements) -> shared rows of the
// padded stride; rows at or past rows_valid are zero
template <int HD>
__device__ __forceinline__ void copy_tile_bf16(const __nv_bfloat16* base,
                                               int64_t row_stride,
                                               int rows_valid,
                                               __nv_bfloat16* s, int rows) {
  constexpr int kChunks = HD / 8;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += blockDim.x) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid)
      x = *reinterpret_cast<const uint4*>(base + r * row_stride + c);
    *reinterpret_cast<uint4*>(s + r * MmaSmem<HD>::kStride + c) = x;
  }
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
    flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               __nv_bfloat16* __restrict__ out, int Sq, int Sk,
                               int H, int KV, int causal, int window,
                               float scale) {
  constexpr int kS = MmaSmem<HD>::kStride;
  constexpr int kKSteps = HD / 16;   // k-steps of Q K^T
  constexpr int kDTiles = HD / 8;    // 8-wide column tiles of O
  constexpr int kNTiles = kBK / 8;   // 8-key column tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBQ * kS;
  __nv_bfloat16* Vs = Ks + kBK * kS;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4;        // the fragment row of this lane
  const int cid = lane % 4;        // its column pair
  const int mi = lane / 8;         // the ldmatrix matrix this lane addresses
  const int ri = lane % 8;         // and the row within it
  int lo, hi;
  key_range(q0, q_last, Sk, causal, window, &lo, &hi);

  const int64_t q_stride = static_cast<int64_t>(H) * HD;
  copy_tile_bf16<HD>(q + (static_cast<int64_t>(b) * Sq + q0) * q_stride +
                         static_cast<int64_t>(h) * HD,
                     q_stride, Sq - q0, Qs, kBQ);
  __syncthreads();
  uint32_t qa[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk)
    ldsm_x4(Qs + (warp * 16 + (mi % 2) * 8 + ri) * kS + kk * 16 + (mi / 2) * 8,
            qa[kk]);

  const int64_t kv_stride = static_cast<int64_t>(KV) * HD;
  const int64_t kv_base = static_cast<int64_t>(b) * Sk * kv_stride +
                          static_cast<int64_t>(kvh) * HD;
  const int rows[2] = {q0 + warp * 16 + gid, q0 + warp * 16 + gid + 8};
  float o[kDTiles][4];
#pragma unroll
  for (int nt = 0; nt < kDTiles; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  for (int kt = lo / kBK; kt <= hi / kBK; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile's Ks, Vs are consumed
    copy_tile_bf16<HD>(k + kv_base + k0 * kv_stride, kv_stride, Sk - k0, Ks,
                       kBK);
    copy_tile_bf16<HD>(v + kv_base + k0 * kv_stride, kv_stride, Sk - k0, Vs,
                       kBK);
    __syncthreads();

    // S = Q K^T: s[j] is the 16x8 tile of keys k0 + 8j .. k0 + 8j + 7
    float s[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk)
#pragma unroll
      for (int jp = 0; jp < kNTiles / 2; ++jp) {
        uint32_t kb[4];
        ldsm_x4(Ks + ((2 * jp + mi / 2) * 8 + ri) * kS + kk * 16 + (mi % 2) * 8,
                kb);
        mma_bf16(s[2 * jp], qa[kk], kb[0], kb[1]);
        mma_bf16(s[2 * jp + 1], qa[kk], kb[2], kb[3]);
      }

    // mask and the online-softmax update; s becomes P
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kNTiles; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][2 * half + e];
          x = masked_score(x, rows[half], k0 + 8 * j + 2 * cid + e, Sk,
                           causal, window, scale);
          tmax = fmaxf(tmax, x);
        }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m[half], tmax);
      const float corr = expf(m[half] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kNTiles; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][2 * half + e];
          x = expf(x - m_new);
          psum += x;
        }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      l[half] = l[half] * corr + psum;
      m[half] = m_new;
#pragma unroll
      for (int nt = 0; nt < kDTiles; ++nt) {
        o[nt][2 * half] *= corr;
        o[nt][2 * half + 1] *= corr;
      }
    }

    // O += P V: the accumulators of two 8-key tiles are one A fragment
#pragma unroll
    for (int t = 0; t < kNTiles / 2; ++t) {
      const uint32_t pa[4] = {pack_bf16(s[2 * t][0], s[2 * t][1]),
                              pack_bf16(s[2 * t][2], s[2 * t][3]),
                              pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]),
                              pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kDTiles / 2; ++dp) {
        uint32_t vb[4];
        ldsm_x4_trans(Vs + (t * 16 + (mi % 2) * 8 + ri) * kS + dp * 16 +
                          (mi / 2) * 8,
                      vb);
        mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = rows[half];
    if (r >= Sq) continue;
    const float denom = fmaxf(l[half], 1e-30f);
    __nv_bfloat16* orow = out + (static_cast<int64_t>(b) * Sq + r) * q_stride +
                          static_cast<int64_t>(h) * HD;
#pragma unroll
    for (int nt = 0; nt < kDTiles; ++nt)
      *reinterpret_cast<uint32_t*>(orow + nt * 8 + 2 * cid) =
          pack_bf16(o[nt][2 * half] / denom, o[nt][2 * half + 1] / denom);
  }
}

template <int HD>
int launch_flash_mma(const void* q, const void* k, const void* v, void* out,
                     int64_t B, int64_t Sq, int64_t Sk, int64_t H, int64_t KV,
                     int64_t causal, int64_t window, float scale,
                     cudaStream_t stream) {
  const size_t smem = MmaSmem<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_mma_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((Sq + kBQ - 1) / kBQ),
                  static_cast<unsigned>(H), static_cast<unsigned>(B));
  flash_attention_mma_kernel<HD><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<int>(Sq), static_cast<int>(Sk), static_cast<int>(H),
      static_cast<int>(KV), static_cast<int>(causal),
      static_cast<int>(window), scale);
  return static_cast<int>(cudaGetLastError());
}

using FlashLaunch = int (*)(const void*, const void*, const void*, void*,
                            int64_t, int64_t, int64_t, int64_t, int64_t,
                            int64_t, int64_t, float, cudaStream_t);

// one launcher per head dim 32, 64, 128
int flash(const FlashLaunch* by_hd, const void* q, const void* k,
          const void* v, void* out, int64_t B, int64_t Sq, int64_t Sk,
          int64_t H, int64_t KV, int64_t hd, int64_t causal, int64_t window,
          float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int i = hd == 32 ? 0 : hd == 64 ? 1 : hd == 128 ? 2 : -1;
  if (i < 0) return static_cast<int>(cudaErrorInvalidValue);
  return by_hd[i](q, k, v, out, B, Sq, Sk, H, KV, causal, window, scale,
                  static_cast<cudaStream_t>(stream));
}

constexpr FlashLaunch kFlashF32[3] = {launch_flash<32>, launch_flash<64>,
                                      launch_flash<128>};
constexpr FlashLaunch kFlashBf16[3] = {launch_flash_mma<32>,
                                       launch_flash_mma<64>,
                                       launch_flash_mma<128>};

// ---------------------------------------------------------------------------
// decode_attention
// ---------------------------------------------------------------------------
constexpr int kDecThreads = 256;
constexpr int kDecTS = 64;       // keys per tile
constexpr int kDecMaxOut = 8;    // outputs per thread: g * hd <= 2048

template <typename T, int HD>
__global__ void __launch_bounds__(kDecThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const uint8_t* __restrict__ valid,
                            T* __restrict__ out, int S, int H, int KV,
                            float scale) {
  constexpr int kLanesPerKey = HD / 8;   // each lane takes 8 dims of a key
  constexpr int kKeysPerPass = kDecThreads / kLanesPerKey;
  static_assert(kDecTS % kKeysPerPass == 0, "uniform passes per tile");
  static_assert(kDecTS == 64, "phase 2 gives each lane two keys");
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int g = H / KV;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // (g, HD) queries of the group
  float* sc = qs + g * HD;           // (g, kDecTS) scores, then weights
  float* m_s = sc + g * kDecTS;      // (g,) running max
  float* l_s = m_s + g;              // (g,) running sum
  float* c_s = l_s + g;              // (g,) this tile's rescale factor

  const T* qg = q + (static_cast<int64_t>(b) * H +
                     static_cast<int64_t>(kvh) * g) * HD;
  for (int i = threadIdx.x; i < g * HD; i += blockDim.x) qs[i] = to_f32(qg[i]);
  for (int i = threadIdx.x; i < g; i += blockDim.x) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }

  const int64_t row_stride = static_cast<int64_t>(KV) * HD;
  const int64_t base = static_cast<int64_t>(b) * S * row_stride +
                       static_cast<int64_t>(kvh) * HD;
  const T* kb = k + base;
  const T* vb = v + base;
  const int lane_k = threadIdx.x % kLanesPerKey;
  const int key_in_pass = threadIdx.x / kLanesPerKey;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  float acc[kDecMaxOut];
#pragma unroll
  for (int u = 0; u < kDecMaxOut; ++u) acc[u] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < S; t0 += kDecTS) {
    // 1. scores of the tile's keys for every head of the group
    for (int j = key_in_pass; j < kDecTS; j += kKeysPerPass) {
      const int t = t0 + j;
      float kv8[8];
      if (t < S) {
        load8(kb + t * row_stride + lane_k * 8, kv8);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kv8[e] = 0.f;
      }
      for (int hh = 0; hh < g; ++hh) {
        const float* qh = qs + hh * HD + lane_k * 8;
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) part = fmaf(qh[e], kv8[e], part);
#pragma unroll
        for (int off = kLanesPerKey / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (lane_k == 0)
          sc[hh * kDecTS + j] =
              t >= S ? -INFINITY : (valid[t] ? part * scale : kNegInf);
      }
    }
    __syncthreads();

    // 2. online-softmax update, one warp per head
    for (int hh = warp; hh < g; hh += kDecThreads / 32) {
      float* row = sc + hh * kDecTS;
      const float x0 = row[lane];
      const float x1 = row[lane + 32];
      float tmax = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_old = m_s[hh];
      const float m_new = fmaxf(m_old, tmax);
      const float p0 = expf(x0 - m_new);
      const float p1 = expf(x1 - m_new);
      row[lane] = p0;
      row[lane + 32] = p1;
      float psum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[hh] = corr;
        l_s[hh] = l_s[hh] * corr + psum;
        m_s[hh] = m_new;
      }
    }
    __syncthreads();

    // 3. acc(h, d) = corr(h) * acc(h, d) + sum_j p(h, j) V(t0 + j, d)
    const int n = min(kDecTS, S - t0);
#pragma unroll
    for (int u = 0; u < kDecMaxOut; ++u) {
      const int o = threadIdx.x + u * kDecThreads;
      if (o < g * HD) {
        const int hh = o / HD;
        const int d = o % HD;
        const float* p = sc + hh * kDecTS;
        const T* vcol = vb + t0 * row_stride + d;
        float a = acc[u] * c_s[hh];
#pragma unroll 8
        for (int j = 0; j < n; ++j)
          a = fmaf(p[j], to_f32(vcol[j * row_stride]), a);
        acc[u] = a;
      }
    }
    __syncthreads();   // sc is rewritten by the next tile
  }

#pragma unroll
  for (int u = 0; u < kDecMaxOut; ++u) {
    const int o = threadIdx.x + u * kDecThreads;
    if (o < g * HD) {
      const int hh = o / HD;
      const int d = o % HD;
      out[(static_cast<int64_t>(b) * H + static_cast<int64_t>(kvh) * g + hh) *
              HD + d] = from_f32<T>(acc[u] / fmaxf(l_s[hh], 1e-30f));
    }
  }
}

template <typename T, int HD>
int launch_decode(const void* q, const void* k, const void* v,
                  const void* valid, void* out, int64_t B, int64_t S,
                  int64_t H, int64_t KV, float scale, cudaStream_t stream) {
  const int64_t g = H / KV;
  const size_t smem = sizeof(float) * (g * HD + g * kDecTS + 3 * g);
  const dim3 grid(static_cast<unsigned>(KV), static_cast<unsigned>(B));
  decode_attention_kernel<T, HD><<<grid, kDecThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(valid),
      static_cast<T*>(out), static_cast<int>(S), static_cast<int>(H),
      static_cast<int>(KV), scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int decode(const void* q, const void* k, const void* v, const void* valid,
           void* out, int64_t B, int64_t S, int64_t H, int64_t KV, int64_t hd,
           float scale, void* streamv) {
  cudaStream_t stream = static_cast<cudaStream_t>(streamv);
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 ||
      (H / KV) * hd > kDecThreads * kDecMaxOut)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 32:
      return launch_decode<T, 32>(q, k, v, valid, out, B, S, H, KV, scale,
                                  stream);
    case 64:
      return launch_decode<T, 64>(q, k, v, valid, out, B, S, H, KV, scale,
                                  stream);
    case 128:
      return launch_decode<T, 128>(q, k, v, valid, out, B, S, H, KV, scale,
                                   stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int flash_attention_f32(const void* q, const void* k, const void* v,
                        void* out, int64_t B, int64_t Sq, int64_t Sk,
                        int64_t H, int64_t KV, int64_t hd, int64_t causal,
                        int64_t window, float scale, void* stream) {
  return flash(kFlashF32, q, k, v, out, B, Sq, Sk, H, KV, hd, causal, window,
               scale, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, int64_t B, int64_t Sq, int64_t Sk,
                         int64_t H, int64_t KV, int64_t hd, int64_t causal,
                         int64_t window, float scale, void* stream) {
  return flash(kFlashBf16, q, k, v, out, B, Sq, Sk, H, KV, hd, causal, window,
               scale, stream);
}

int decode_attention_f32(const void* q, const void* k, const void* v,
                         const void* valid, void* out, int64_t B, int64_t S,
                         int64_t H, int64_t KV, int64_t hd, float scale,
                         void* stream) {
  return decode<float>(q, k, v, valid, out, B, S, H, KV, hd, scale, stream);
}

int decode_attention_bf16(const void* q, const void* k, const void* v,
                          const void* valid, void* out, int64_t B, int64_t S,
                          int64_t H, int64_t KV, int64_t hd, float scale,
                          void* stream) {
  return decode<__nv_bfloat16>(q, k, v, valid, out, B, S, H, KV, hd, scale,
                               stream);
}

}  // extern "C"
