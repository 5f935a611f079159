// Attention kernels for Hopper (sm_90a): the prefill/score forward and the
// one-token decode of the LLM serving path.
//
// flash_attention: causal / sliding-window / non-causal GQA attention
//     q (B,Sq,H,hd), k/v (B,Sk,KV,hd) -> out (B,Sq,H,hd) in q's dtype;
//     query head h reads KV head h / (H/KV); query i and key j are
//     positions i and j (mask: j <= i when causal, j > i - window when
//     windowed).
//   Replaces src/repro/kernels/flash_attention.py::flash_attention (:82,
//   pl.pallas_call at :106; the Pallas kernel behind
//   models/attention.py::gqa_forward).
//   Bound: operations.  4*hd flops per unmasked (query, key) pair against
//   (2*Sq*H + 2*Sk*KV)*hd elements moved; at qwen3-1.7b's prefill shape
//   (B=4, S=4096, H=16, KV=8, hd=128, causal) that is ~1,400 flops per byte,
//   far above the card's ~295 bf16 flops per byte, so the least time is
//   flops / 989 TFLOP/s (bf16: 0.278 ms there) or / 67 TFLOP/s (fp32, no
//   tensor cores).
//   What the design does:
//     * bf16 (the model's path) is a warp-specialised Hopper kernel: one
//       block per (head, batch row, 128 query rows), a producer warpgroup
//       whose one thread keeps TMA loads of K and V tiles (128 keys) in
//       flight through an mbarrier ring, and two consumer warpgroups of 64
//       rows each that run both products as wgmma (S = Q K^T from shared
//       memory; O += P V with P in registers and V read N-major through the
//       transpose bit), so loads overlap the tensor cores and one tile's
//       softmax overlaps the previous tile's P V.  exp2 of log2e-scaled
//       scores; the mask only on tiles that cross the causal diagonal, the
//       window edge or Sk; the heaviest causal q tiles launch first; the
//       output leaves through shared memory by TMA stores;
//     * K tiles that the causal/window structure rules out for every row of
//       the q tile are never loaded (half the work when causal), as
//       flash_attention.py:66-72 prunes them;
//     * fp32 (off the model's path: the agreement checks) runs on the FMA
//       pipes: blocks of 64 query rows, 256 threads, each owning a 4x4
//       micro-tile of the 64x64 score tile (rows ty+16i, keys tx+16j) and a
//       4 x hd/16 micro-tile of the output, read with 16-byte shared-memory
//       loads from padded, bank-conflict-free rows;
//     * the model's (B,S,heads,hd) layout is read in place: no padding of
//       hd to 128 lanes, no padding of S, no transposes (the TPU kernel's
//       host-side jnp.pad / transpose are TPU layout constraints); TMA's
//       rank-4 tensor maps (hd, heads, S, B) zero-fill rows past S per batch
//       row and drop them on the store;
//     * head dims: instantiations at HD = 32, 64, 128 and 256 (gemma-7b);
//       any hd that is a multiple of 8 in [8, 256] runs on the next HD up,
//       its columns past hd zero-filled inside the kernel (TMA's
//       out-of-bounds fill in bf16, masked loads in fp32) and never stored.
//       HD = 256 in bf16 takes 64-key tiles and stores O from registers
//       (see namespace wg).
//
// decode_attention: one query token per sequence against a ring-buffer cache
//     q (B,1,H,hd), k/v (B,S,KV,hd), valid (S,) bool shared by the batch ->
//     out (B,1,H,hd) in q's dtype.
//   Replaces src/repro/kernels/decode_attention.py::decode_attention (the
//   Pallas kernel behind models/attention.py::gqa_decode).
//   Bound: memory.  2*g*hd flops per cache row of 2*hd elements (g = H/KV),
//   so the least time is the K/V bytes of the valid slots / 3.35 TB/s
//   (qwen3-1.7b, B=4, S=32,768 all valid: 537 MB, 0.160 ms).  What the
//   design does (flash-decoding):
//     * the cache is split over blocks: one 128-thread block per (split of
//       S, KV head, up to 4 heads of its GQA group, batch row), enough
//       splits to fill every SM's resident blocks once (12 at qwen3's B=4
//       and S=32,768: 384 blocks, where one block per (KV head, batch) gave
//       32 on 132 SMs); each writes its partial max, sum and fp32 acc to a
//       workspace and a combine kernel merges the splits;
//     * each split streams its K and V tiles (32 keys) through a 3-4 stage
//       shared-memory ring by cp.async, so 48 KB per block are in flight
//       while one tile is computed; V is read as rows from shared memory;
//     * tiles with no valid key are not read when the row has a valid key
//       (their weight is exactly 0), so a ring cache's hole costs nothing;
//     * fp32 on the FMA pipes (g <= 8 query rows would leave a tensor-core
//       tile almost empty): 8 dims of a key per lane, xor shuffles over the
//       key's lanes, one exp2 per (thread, head, tile) of log2e-scaled
//       scores; every cache byte serves all the block's heads;
//     * head dims as the forward's: HD = 32, 64, 128, 256, a multiple of 8
//       below HD zero-filled by cp.async (a source size of 0) and the
//       combine writing only its columns; the workspace is laid out in the
//       true hd.
//
// Masking follows the JAX package's reference exactly: a masked key inside
// the sequence gets the finite score -1e30 (so a row with no valid key
// averages every key uniformly, never NaN), and the output is
// acc / max(l, 1e-30) cast to q's dtype.  Keys past the end of the sequence
// (the last ragged tile) get -inf and weigh nothing.
//
// C interface (bound with ctypes): flash_attention_{f32,bf16} and
// decode_attention_{f32,bf16}; each returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a head dim that is not a multiple of
// 8 in [8, 256].
// flash_attention_* take an fp32 lse (B, H, Sq) pointer: when it is not
// null the epilogue writes each row's log-sum-exp of its scaled, masked
// scores in natural-log units (kNegInf for a row with no valid key), which
// the backward of attention_bwd.cu consumes; the serve and score paths
// pass null.
// decode_attention_splits gives the number of splits for a shape, which
// sizes the workspace the caller allocates (B*KV*n_split*g*(hd+2) floats).
// decode_attention_partial_{f32,bf16} run the same two kernels on one rank's
// slice of a sequence-sharded cache and write, in place of out, the
// slice's unnormalised fp32 (m, l, o) (see decode_attention_combine); the
// caller rescales them by exp(m - max over ranks) and sums over the ranks.

#include <algorithm>
#include <atomic>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention.cuh"
#include "hopper.cuh"

namespace {

constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// flash_attention, fp32: the FMA-pipe kernel (bf16 takes the wgmma kernel
// below)
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

// HD is the instantiation (32, 64, 128, 256); hd <= HD the tensors' head
// dim: columns hd.. of the shared-memory tiles are zeros and never stored
template <int HD>
__global__ void __launch_bounds__(kFlashThreads)
    flash_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out,
                           float* __restrict__ lse,
                           int Sq, int Sk, int H, int KV, int hd, int causal,
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

  const int64_t q_stride = static_cast<int64_t>(H) * hd;
  load_tile<HD>(q + (static_cast<int64_t>(b) * Sq + q0) * q_stride +
                       static_cast<int64_t>(h) * hd,
                   q_stride, Sq - q0, Qs, L::kQStride, kBQ, hd);

  const int64_t kv_stride = static_cast<int64_t>(KV) * hd;
  const int64_t kv_base = static_cast<int64_t>(b) * Sk * kv_stride +
                          static_cast<int64_t>(kvh) * hd;

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
                     L::kKStride, kBK, hd);
    load_tile<HD>(v + kv_base + k0 * kv_stride, kv_stride, Sk - k0, Vs,
                     L::kVStride, kBK, hd);
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
                  static_cast<int64_t>(h) * hd;
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) {
      const int c = out_col<HD>(tx, jj);
      if (c < hd) orow[c] = acc[i][jj] / denom;
    }
    // m + ln l; a row with no valid key keeps m = kNegInf, and so lse
    if (lse != nullptr && tx == 0)
      lse[(static_cast<int64_t>(b) * H + h) * Sq + r] = m[i] + logf(l[i]);
  }
}

template <int HD>
int launch_flash(const void* q, const void* k, const void* v, void* out,
                 float* lse, int64_t B, int64_t Sq, int64_t Sk, int64_t H,
                 int64_t KV, int64_t hd,
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
      static_cast<const float*>(v), static_cast<float*>(out), lse,
      static_cast<int>(Sq), static_cast<int>(Sk), static_cast<int>(H),
      static_cast<int>(KV), static_cast<int>(hd), static_cast<int>(causal),
      static_cast<int>(window), scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// flash_attention, bf16: TMA, mbarrier rings and wgmma, warp-specialised and
// persistent.  One block per SM (at most) walks a list of work tiles, each
// 128 query rows of one (head, batch row).  It runs three warpgroups:
// warpgroup 0 is the producer (one thread issues every TMA load; the others
// give their registers away by setmaxnreg), warpgroups 1 and 2 each own 64
// of a tile's rows.  Q arrives once per tile into one buffer; K and V tiles
// of kKeys keys stream through rings of kKStages and kVStages stages, each
// stage with a "full" barrier (TMA bytes) and an "empty" barrier (every
// consumer thread), K one tile ahead of V.  Per key tile a consumer
// warpgroup computes S = Q K^T (wgmma, both operands from shared memory),
// the online softmax in registers (exp2 of log2e-scaled scores; the mask only
// on tiles that cross the causal diagonal, the window edge or Sk), turns S
// into bf16 A fragments, and accumulates O += P V (wgmma with A from
// registers, V read N-major through the transpose bit).  S of the next key
// tile is issued with P V of this one, so a tile's softmax runs under the
// previous tile's P V, and the two warpgroups take turns issuing (named
// barriers), so one's softmax runs under the other's products.  The
// epilogue normalises O into an output buffer in shared memory (the same
// swizzle) and stores it with TMA, which drops rows past Sq, while the
// producer already loads the next work tile.  The work list pairs each
// (b, h)'s causal q tiles heaviest with lightest and deals the pairs to
// the blocks round-robin (work_tile, dealt_tile).
//
// Head dims.  The instantiations are HD = 32, 64, 128 and 256; a head dim
// hd <= HD that is a multiple of 8 runs on the next HD up.  The tensor maps
// carry the true hd as the extent of the innermost dimension (and hd * 2
// bytes as the row stride, a multiple of 16 when hd % 8 == 0), so TMA
// fills the box columns past hd with zeros on every load (they add nothing
// to Q K^T, and V's zero columns make O's zero columns) and drops them on
// the store.  HD = 256 takes its own tile shape: a 128 x 256 tile is 64 KB,
// so with 128-key tiles Q, O and the rings would need 448 KB, and o[128]
// with 128-key scores would exceed the consumers' 240 registers.  Its key
// tiles are 64 keys (S is m64n64, P V m64n256k16, half the scores and P
// fragments), its K and V rings two stages of 32 KB each, and O goes from
// registers straight to global memory (rows below Sq, columns below hd), so
// no output buffer: Q + 4 stages = 192 KB.
// ---------------------------------------------------------------------------
namespace wg {

constexpr int kRows = 128;            // q rows per work tile
constexpr int kThreads = 384;         // 3 warpgroups
constexpr uint32_t kProducerRegs = 24;
constexpr uint32_t kConsumerRegs = 240;

template <int HD>
struct Layout {
  static constexpr int kRowBytes = HD >= 64 ? 128 : 64;   // one TMA box row
  static constexpr int kSwizzle = kRowBytes;              // 128- or 64-byte
  static constexpr int kBoxCols = kRowBytes / 2;          // hd columns a box
  static constexpr int kBoxes = HD / kBoxCols;            // boxes across hd
  static constexpr bool kWide = HD > 128;                 // hd 256's shape
  static constexpr int kKeys = kWide ? 64 : 128;          // keys per K tile
  static constexpr int kKStages = kWide ? 2 : 3;          // K ring depth
  static constexpr int kVStages = 2;                      // V ring depth
  static constexpr int kS = kKeys / 2;                    // S floats a thread
  static constexpr int kQBoxBytes = kRows * kRowBytes;    // 128 rows of a box
  static constexpr int kQTileBytes = kBoxes * kQBoxBytes;   // a Q or O tile
  static constexpr int kKVBoxBytes = kKeys * kRowBytes;
  static constexpr int kKVTileBytes = kBoxes * kKVBoxBytes;  // a K or V tile
  static constexpr int kQ = 0;
  static constexpr int kO = kQ + kQTileBytes;             // unused when wide
  static constexpr int kK = kO + (kWide ? 0 : kQTileBytes);  // + stage * tile
  static constexpr int kV = kK + kKStages * kKVTileBytes;
  static constexpr int kBars = kV + kVStages * kKVTileBytes;
  static constexpr int kNumBars = 2 + 2 * (kKStages + kVStages);
  static constexpr size_t kSmemBytes = kBars + 8 * kNumBars + 1024;  // + align
  static_assert(kSmemBytes <= 232448, "one block's shared memory");
};

template <int HD>
__device__ __forceinline__ void pv_step(float (&o)[HD / 2],
                                        const uint32_t (&a)[4], uint64_t b) {
  if constexpr (HD == 32) {
    hopper::wgmma_rs_m64n32k16_nmajor(o, a, b);
  } else if constexpr (HD == 64) {
    hopper::wgmma_rs_m64n64k16_nmajor(o, a, b);
  } else if constexpr (HD == 128) {
    hopper::wgmma_rs_m64n128k16_nmajor(o, a, b);
  } else {
    hopper::wgmma_rs_m64n256k16_nmajor(o, a, b);
  }
}

// S = Q K^T for one key tile: hd in steps of 16 (32 bytes along a
// swizzled row; the next box after kRowBytes), issued and committed
template <int HD>
__device__ __forceinline__ void issue_qk(float (&sc)[Layout<HD>::kS],
                                         uint32_t q_base, uint32_t k_base) {
  using L = Layout<HD>;
  hopper::fence_regs(sc);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int box = (kk * 32) / L::kRowBytes, col = (kk * 32) % L::kRowBytes;
    const uint64_t a = hopper::wgmma_desc(q_base + box * L::kQBoxBytes + col,
                                          16, 8 * L::kRowBytes, L::kSwizzle);
    const uint64_t b = hopper::wgmma_desc(k_base + box * L::kKVBoxBytes + col,
                                          16, 8 * L::kRowBytes, L::kSwizzle);
    if constexpr (L::kKeys == 128) {
      hopper::wgmma_ss_m64n128k16(sc, a, b, kk > 0);
    } else {
      hopper::wgmma_ss_m64n64k16(sc, a, b, kk > 0);
    }
  }
  hopper::wgmma_commit();
  hopper::fence_regs(sc);
}

// O += P V for one key tile: its keys in steps of 16 (16 rows of V, read
// N-major: the boxes across hd are LBO apart), issued and committed
template <int HD>
__device__ __forceinline__ void issue_pv(
    float (&o)[HD / 2], uint32_t (&p)[Layout<HD>::kKeys / 16][4],
    uint32_t v_base) {
  using L = Layout<HD>;
  hopper::fence_regs(o);
#pragma unroll
  for (int kk = 0; kk < L::kKeys / 16; ++kk) hopper::fence_regs(p[kk]);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < L::kKeys / 16; ++kk)
    pv_step<HD>(o, p[kk],
                hopper::wgmma_desc(v_base + kk * 16 * L::kRowBytes,
                                   L::kKVBoxBytes, 8 * L::kRowBytes,
                                   L::kSwizzle));
  hopper::wgmma_commit();
  hopper::fence_regs(o);
#pragma unroll
  for (int kk = 0; kk < L::kKeys / 16; ++kk) hopper::fence_regs(p[kk]);
}

// P in bf16: the S accumulator's pairs are the A fragments of P V
template <int N>
__device__ __forceinline__ void to_bf16_pairs(const float (&sc)[N],
                                              uint32_t (&p)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p[kk][e] = hopper::pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
}

// The online softmax of one key tile's scores, in place: sc becomes
// exp2(score * scale * log2e - m) with the rows' new running maxima m, the
// thread's parts of the row sums l are rescaled and added to, and corr is
// what O must be multiplied by.  The mask is applied only on an edge tile
// (one that crosses the causal diagonal, a window edge or Sk): there the
// scores are scaled first and multiplied by 1 after.
struct RowState {
  float m0, m1;   // running maxima of the two rows, log2e-scaled
  float l0, l1;   // this thread's parts of their sums
};

template <int N>
__device__ __forceinline__ void softmax_tile(float (&sc)[N], RowState& st,
                                             float& corr0, float& corr1,
                                             bool edge, int k0, int row0,
                                             int col, int Sk, int causal,
                                             int window, float scale_log2) {
  float mult = scale_log2;
  if (edge) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + (e < 2 ? 0 : 8);
        const int key = k0 + 8 * j + col + (e & 1);
        float& x = sc[4 * j + e];
        x = key >= Sk ? -INFINITY
            : ((causal && key > r) || (window > 0 && key <= r - window))
                ? kNegInf : x * scale_log2;
      }
    mult = 1.f;
  }
  // row maxima over the 4 lanes that share a row
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float n0 = fmaxf(st.m0, mx0 * mult);
  const float n1 = fmaxf(st.m1, mx1 * mult);
  corr0 = ex2(st.m0 - n0);
  corr1 = ex2(st.m1 - n1);
  st.m0 = n0;
  st.m1 = n1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    sc[4 * j] = ex2(fmaf(sc[4 * j], mult, -n0));
    sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], mult, -n0));
    sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], mult, -n1));
    sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], mult, -n1));
    sum0 += sc[4 * j] + sc[4 * j + 1];
    sum1 += sc[4 * j + 2] + sc[4 * j + 3];
  }
  st.l0 = st.l0 * corr0 + sum0;
  st.l1 = st.l1 * corr1 + sum1;
}

// The work list: tile `t` of B * H * ceil(Sq / 128) is q tile qt of the
// (b, h) pair t / n_q, whose q tiles run in the order last, first, last but
// one, second, ...: a causal tile with the most keys then one with the
// fewest, so consecutive pairs of tiles carry about the same work.
// Returns (b, h, q0) and the key tiles of kKeys keys [first, first + count)
// it needs.
struct Work {
  int b, h, q0, first, count;
};

template <int kKeys>
__device__ __forceinline__ Work work_tile(int t, int H, int n_q, int Sq,
                                          int Sk, int causal, int window) {
  const int bh = t / n_q;
  const int r = t % n_q;
  Work w;
  w.b = bh / H;
  w.h = bh % H;
  w.q0 = ((r & 1) ? r / 2 : n_q - 1 - r / 2) * kRows;
  // the keys [lo, hi] the q tile needs: a row with no valid key at all
  // (window > 0 and row >= Sk + window - 1) averages every key
  const int q_last = min(w.q0 + kRows, Sq) - 1;
  int lo = window > 0 ? max(0, w.q0 - window + 1) : 0;
  int hi = causal ? min(Sk - 1, q_last) : Sk - 1;
  if (window > 0 && q_last >= Sk + window - 1) {
    lo = 0;
    hi = Sk - 1;
  }
  w.first = lo / kKeys;
  w.count = hi / kKeys - w.first + 1;
  return w;
}

// The k-th work tile of block p of G (-1: none left).  The pairs of tiles
// (2i, 2i + 1) are dealt round-robin, so each block gets pairs of about
// equal work and the blocks running at one time share few (b, h) pairs,
// whose K and V stay in L2.
__device__ __forceinline__ int dealt_tile(int k, int p, int G, int tiles) {
  const int t = 2 * (p + (k / 2) * G) + (k & 1);
  return t < tiles ? t : -1;
}

// the producer's load of a K or V tile (keys k0.. of KV head kvh, batch row
// b) into the next stage of a ring of kStages, once its consumers have
// released it; n counts the ring's loads
template <int HD, int kStages>
__device__ __forceinline__ void load_stage(unsigned char* ring, uint64_t* full,
                                           uint64_t* empty, int& n,
                                           const CUtensorMap* map, int kvh,
                                           int k0, int b) {
  using L = Layout<HD>;
  const int s = n % kStages;
  hopper::mbar_wait(&empty[s], ((n / kStages) & 1) ^ 1);
  hopper::mbar_expect_tx(&full[s], L::kKVTileBytes);
#pragma unroll
  for (int j = 0; j < L::kBoxes; ++j)
    hopper::tma_load_4d(ring + s * L::kKVTileBytes + j * L::kKVBoxBytes, map,
                        &full[s], j * L::kBoxCols, kvh, k0, b);
  ++n;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                 const __grid_constant__ CUtensorMap tm_k,
                                 const __grid_constant__ CUtensorMap tm_v,
                                 const __grid_constant__ CUtensorMap tm_o,
                                 __nv_bfloat16* __restrict__ out,
                                 float* __restrict__ lse,
                                 int B, int Sq, int Sk, int H, int KV, int hd,
                                 int causal, int window, float scale_log2) {
  using L = Layout<HD>;
  constexpr int kKeys = L::kKeys, kKStages = L::kKStages;
  constexpr int kVStages = L::kVStages;
  extern __shared__ unsigned char smem_raw[];
  // TMA's 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 1;
  uint64_t* k_full = bars + 2;
  uint64_t* k_empty = k_full + kKStages;
  uint64_t* v_full = k_empty + kKStages;
  uint64_t* v_empty = v_full + kVStages;

  const int n_q = (Sq + kRows - 1) / kRows;
  const int tiles = B * H * n_q;
  const int G = gridDim.x;
  const int p = blockIdx.x;
  const int g = H / KV;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init(q_empty, 2 * 128);   // every consumer thread
    for (int s = 0; s < kKStages; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&k_empty[s], 2 * 128);
    }
    for (int s = 0; s < kVStages; ++s) {
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&v_empty[s], 2 * 128);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every load, K one key
    // tile ahead of V ----
    hopper::regs_release<kProducerRegs>();
    if (threadIdx.x == 0) {
      int nk = 0, nv = 0;   // K and V tiles loaded so far
      int t;
      for (int k = 0; (t = dealt_tile(k, p, G, tiles)) >= 0; ++k) {
        const Work w = work_tile<kKeys>(t, H, n_q, Sq, Sk, causal, window);
        hopper::mbar_wait(q_empty, (k & 1) ^ 1);
        hopper::mbar_expect_tx(q_full, L::kQTileBytes);
#pragma unroll
        for (int j = 0; j < L::kBoxes; ++j)
          hopper::tma_load_4d(smem + L::kQ + j * L::kQBoxBytes, &tm_q, q_full,
                              j * L::kBoxCols, w.h, w.q0, w.b);
        const int kvh = w.h / g;
        load_stage<HD, kKStages>(smem + L::kK, k_full, k_empty, nk, &tm_k, kvh,
                                 w.first * kKeys, w.b);
        for (int i = 0; i < w.count; ++i) {
          if (i + 1 < w.count)
            load_stage<HD, kKStages>(smem + L::kK, k_full, k_empty, nk, &tm_k,
                                     kvh, (w.first + i + 1) * kKeys, w.b);
          load_stage<HD, kVStages>(smem + L::kV, v_full, v_empty, nv, &tm_v,
                                   kvh, (w.first + i) * kKeys, w.b);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows of each work tile ----
    hopper::regs_claim<kConsumerRegs>();
    const int c = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int col = 2 * (lane % 4);   // this thread's first column of 8
    const uint32_t q_base = hopper::smem_addr(smem + L::kQ) +
                            64 * c * L::kRowBytes;
    const uint32_t k_base = hopper::smem_addr(smem + L::kK);
    const uint32_t v_base = hopper::smem_addr(smem + L::kV);
    constexpr uint32_t kSwzMask = L::kRowBytes == 128 ? 7 : 3;
    // The warpgroups take turns issuing their products (named barriers 3
    // and 4): warpgroup 1 lets warpgroup 0 go first, and skips its very
    // last hand-over, which no turn of warpgroup 0 waits for.
    const uint32_t my_turn = 3 + c, their_turn = 4 - c;
    if (c == 1) hopper::named_barrier_arrive(their_turn, 256);

    int nk = 0, nv = 0;   // K and V tiles consumed so far
    int t;
    for (int k = 0; (t = dealt_tile(k, p, G, tiles)) >= 0; ++k) {
      const Work w = work_tile<kKeys>(t, H, n_q, Sq, Sk, causal, window);
      const bool last_work = dealt_tile(k + 1, p, G, tiles) < 0;
      const int r_lo = w.q0 + 64 * c;                 // the warpgroup's rows
      const int row0 = r_lo + 16 * warp + lane / 4;   // this thread's: row0
      // an edge key tile needs the mask for some row of this warpgroup
      auto edge = [&](int k0) {
        return k0 + kKeys > Sk || (causal && k0 + kKeys - 1 > r_lo) ||
               (window > 0 && k0 <= r_lo + 63 - window);
      };

      float o[HD / 2];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
      RowState st{kNegInf, kNegInf, 0.f, 0.f};
      float sc[L::kS], corr0, corr1;
      uint32_t p_frag[kKeys / 16][4];

      // key tile 0's scores; then per key tile i: S of tile i + 1 and P V
      // of tile i are issued in one turn, tile i + 1's softmax runs while
      // P V does, and O takes tile i + 1's correction once P V is done.
      // The last key tile is peeled off, so the loop's issues and waits are
      // unconditional.  Q is released after the last S.
      hopper::named_barrier_sync(my_turn, 256);
      hopper::mbar_wait(q_full, k & 1);
      int sk = nk % kKStages;
      hopper::mbar_wait(&k_full[sk], (nk / kKStages) & 1);
      issue_qk<HD>(sc, q_base, k_base + sk * L::kKVTileBytes);
      hopper::named_barrier_arrive(their_turn, 256);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::mbar_arrive(&k_empty[sk]);
      ++nk;
      if (w.count == 1) hopper::mbar_arrive(q_empty);
      softmax_tile(sc, st, corr0, corr1, edge(w.first * kKeys),
                   w.first * kKeys, row0, col, Sk, causal, window, scale_log2);
      for (int i = 0; i + 1 < w.count; ++i) {
        to_bf16_pairs(sc, p_frag);
        sk = nk % kKStages;
        const int sv = nv % kVStages;
        hopper::named_barrier_sync(my_turn, 256);
        hopper::mbar_wait(&k_full[sk], (nk / kKStages) & 1);
        issue_qk<HD>(sc, q_base, k_base + sk * L::kKVTileBytes);
        hopper::mbar_wait(&v_full[sv], (nv / kVStages) & 1);
        issue_pv<HD>(o, p_frag, v_base + sv * L::kKVTileBytes);
        hopper::named_barrier_arrive(their_turn, 256);
        hopper::wgmma_wait<1>();       // S of tile i + 1 (committed first)
        hopper::fence_regs(sc);
        hopper::mbar_arrive(&k_empty[sk]);
        ++nk;
        if (i + 2 == w.count) hopper::mbar_arrive(q_empty);
        const int k1 = (w.first + i + 1) * kKeys;
        softmax_tile(sc, st, corr0, corr1, edge(k1), k1, row0, col, Sk,
                     causal, window, scale_log2);
        hopper::wgmma_wait<0>();       // P V of tile i
        hopper::fence_regs(o);
        hopper::mbar_arrive(&v_empty[sv]);
        ++nv;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          o[4 * j] *= corr0;
          o[4 * j + 1] *= corr0;
          o[4 * j + 2] *= corr1;
          o[4 * j + 3] *= corr1;
        }
      }
      {
        to_bf16_pairs(sc, p_frag);
        const int sv = nv % kVStages;
        hopper::named_barrier_sync(my_turn, 256);
        hopper::mbar_wait(&v_full[sv], (nv / kVStages) & 1);
        issue_pv<HD>(o, p_frag, v_base + sv * L::kKVTileBytes);
        if (c == 0 || !last_work)
          hopper::named_barrier_arrive(their_turn, 256);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(o);
        hopper::mbar_arrive(&v_empty[sv]);
        ++nv;
      }

      // epilogue: O / l in bf16, and lse
      float l0 = st.l0, l1 = st.l1;
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = 1.f / fmaxf(l0, 1e-30f);
      const float inv1 = 1.f / fmaxf(l1, 1e-30f);
      // lse in natural-log units, (m + log2 l) ln 2; a row with no valid
      // key keeps m = kNegInf and gets lse = kNegInf, as the plain version
      if (lse != nullptr && (lane & 3) == 0) {
        float* lrow = lse + (static_cast<int64_t>(w.b) * H + w.h) * Sq;
        if (row0 < Sq)
          lrow[row0] =
              st.m0 <= kNegInf ? kNegInf : (st.m0 + log2f(l0)) * kLn2;
        if (row0 + 8 < Sq)
          lrow[row0 + 8] =
              st.m1 <= kNegInf ? kNegInf : (st.m1 + log2f(l1)) * kLn2;
      }
      // HD 256 has no room for an output buffer; below it the TMA store is
      // kept: storing from registers at HD 128 took 2-7% longer on an H100
      // at qwen3-1.7b's forward (B=4 x S=4096, timed in turns)
      if constexpr (L::kWide) {
        // straight from the registers: the thread's two rows, 8-column
        // groups below hd (each pair of columns one 4-byte store)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = row0 + 8 * half;
          if (r >= Sq) continue;
          __nv_bfloat16* orow =
              out + ((static_cast<int64_t>(w.b) * Sq + r) * H + w.h) * hd;
          const float inv = half ? inv1 : inv0;
#pragma unroll
          for (int j = 0; j < HD / 8; ++j)
            if (8 * j < hd)
              *reinterpret_cast<uint32_t*>(orow + 8 * j + col) =
                  hopper::pack_bf16(o[4 * j + 2 * half] * inv,
                                    o[4 * j + 2 * half + 1] * inv);
        }
      } else {
        // once the previous store has read the output buffer, O / l into
        // this warpgroup's rows of it (the TMA boxes' swizzle), then one TMA
        // store per box
        if (tid == 0) hopper::tma_store_wait_read();
        hopper::named_barrier_sync(1 + c, 128);
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = 64 * c + 16 * warp + lane / 4 + 8 * half;   // row
            const int byte = (8 * j + col) * 2;                        // hd
            uint32_t off = byte / L::kRowBytes * L::kQBoxBytes +
                           r * L::kRowBytes + byte % L::kRowBytes;
            off ^= ((off >> 7) & kSwzMask) << 4;
            const float inv = half ? inv1 : inv0;
            *reinterpret_cast<uint32_t*>(smem + L::kO + off) =
                hopper::pack_bf16(o[4 * j + 2 * half] * inv,
                                  o[4 * j + 2 * half + 1] * inv);
          }
        hopper::fence_proxy_async();
        hopper::named_barrier_sync(1 + c, 128);
        if (tid == 0 && r_lo < Sq) {
#pragma unroll
          for (int j = 0; j < L::kBoxes; ++j)
            hopper::tma_store_4d(&tm_o,
                                 smem + L::kO + j * L::kQBoxBytes +
                                     64 * c * L::kRowBytes,
                                 j * L::kBoxCols, w.h, r_lo, w.b);
          hopper::tma_store_commit();
        }
      }
    }
    if (tid == 0) hopper::tma_store_wait_read();
  }
}

// hd: the tensors' head dim, at most HD and a multiple of 8 (the tensor
// maps' extent and row stride; the box stays HD wide)
template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int64_t B, int64_t Sq, int64_t Sk, int64_t H, int64_t KV,
           int64_t hd, int64_t causal,
           int64_t window, float scale, cudaStream_t stream) {
  using L = Layout<HD>;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  int err = hopper::encode_bshd_bf16(&tm_q, q, B, Sq, H, hd, L::kBoxCols,
                                     kRows, L::kSwizzle);
  if (!err) err = hopper::encode_bshd_bf16(&tm_k, k, B, Sk, KV, hd,
                                           L::kBoxCols, L::kKeys, L::kSwizzle);
  if (!err) err = hopper::encode_bshd_bf16(&tm_v, v, B, Sk, KV, hd,
                                           L::kBoxCols, L::kKeys, L::kSwizzle);
  if (!err) err = hopper::encode_bshd_bf16(&tm_o, out, B, Sq, H, hd,
                                           L::kBoxCols, 64, L::kSwizzle);
  if (err) return err;
  int device = 0, sms = 0;
  cudaError_t cerr = cudaGetDevice(&device);
  if (cerr == cudaSuccess)
    cerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  device);
  if (cerr == cudaSuccess)
    cerr = cudaFuncSetAttribute(flash_attention_wgmma_kernel<HD>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(L::kSmemBytes));
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int64_t tiles = B * H * ((Sq + kRows - 1) / kRows);
  if (tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  // every block gets at least one pair of work tiles
  const unsigned blocks =
      static_cast<unsigned>(std::min<int64_t>(sms, (tiles + 1) / 2));
  flash_attention_wgmma_kernel<HD><<<blocks, kThreads, L::kSmemBytes, stream>>>(
      tm_q, tm_k, tm_v, tm_o, static_cast<__nv_bfloat16*>(out), lse,
      static_cast<int>(B), static_cast<int>(Sq), static_cast<int>(Sk),
      static_cast<int>(H), static_cast<int>(KV), static_cast<int>(hd),
      static_cast<int>(causal), static_cast<int>(window), scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

using FlashLaunch = int (*)(const void*, const void*, const void*, void*,
                            float*, int64_t, int64_t, int64_t, int64_t,
                            int64_t, int64_t, int64_t, int64_t, float,
                            cudaStream_t);

// one launcher per instantiation (kHeadDims)
int flash(const FlashLaunch* by_hd, const void* q, const void* k,
          const void* v, void* out, void* lse, int64_t B, int64_t Sq,
          int64_t Sk,
          int64_t H, int64_t KV, int64_t hd, int64_t causal, int64_t window,
          float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int i = head_dim_index(hd);
  if (i < 0) return static_cast<int>(cudaErrorInvalidValue);
  return by_hd[i](q, k, v, out, static_cast<float*>(lse), B, Sq, Sk, H, KV,
                  hd, causal, window, scale,
                  static_cast<cudaStream_t>(stream));
}

constexpr FlashLaunch kFlashF32[4] = {launch_flash<32>, launch_flash<64>,
                                      launch_flash<128>, launch_flash<256>};
constexpr FlashLaunch kFlashBf16[4] = {wg::launch<32>, wg::launch<64>,
                                       wg::launch<128>, wg::launch<256>};

// ---------------------------------------------------------------------------
// decode_attention: the cache split over blocks, then a combine
// ---------------------------------------------------------------------------
namespace dec {

constexpr int kThreads = 128;
constexpr int kTK = 32;          // keys per tile: one validity bit per lane
constexpr int kMaxTiles = 256;   // tiles per split (the split's mask table)
constexpr int kMinTiles = 2;     // tiles per split at least

// One block per (split, KV head, G heads of its group, batch row), G = 1, 2
// or 4.  Each lane owns 8 of a key's HD dims, so kL lanes share a key and
// the block takes kStreams keys per pass; thread (stream, lane) meets keys
// stream, stream + kStreams, ... of every tile.  The ring holds kStages K+V
// tiles: 4 in bf16 (64 KB at HD 128), 3 in fp32; at HD 256 3 in bf16 (96 KB,
// so two blocks fit an SM) and 3 in fp32 (192 KB, one block).
template <typename T, int HD, int G>
struct Shape {
  static constexpr int kL = HD / 8;
  static constexpr int kStreams = kThreads / kL;
  static constexpr int kPasses = kTK / kStreams;
  static constexpr int kStages = sizeof(T) == 2 && HD <= 128 ? 4 : 3;
  static constexpr int kTileElems = kTK * HD;              // one of K or V
  static constexpr size_t kRingBytes =
      static_cast<size_t>(kStages) * 2 * kTileElems * sizeof(T);
  // after the ring drains: each stream's acc (G, HD), then m and l
  static constexpr size_t kMergeBytes =
      sizeof(float) * kStreams * G * (HD + 2);
  static constexpr size_t kTablesAt =
      kRingBytes > kMergeBytes ? kRingBytes : kMergeBytes;
  // per tile of the split: its validity bits, and the list of tiles to visit
  static constexpr size_t kSmemBytes =
      kTablesAt + kMaxTiles * (sizeof(uint32_t) + sizeof(uint16_t));
  static_assert(kTK % kStreams == 0, "whole passes per tile");
  static_assert((2 * kTileElems * sizeof(T) / 16) % kThreads == 0,
                "whole copy rounds per tile");
  static_assert(kSmemBytes <= 232448, "one block's shared memory");
};

// dims of a row that lane lk owns: bf16 8lk .. 8lk+7 (one 16-byte load);
// fp32 4lk .. 4lk+3 and HD/2 + 4lk .. +3 (two 16-byte loads, each
// contiguous across the lanes)
template <typename T, int HD>
__device__ __forceinline__ int lane_dim(int lk, int e) {
  if constexpr (sizeof(T) == 2) {
    return 8 * lk + e;
  } else {
    return e < 4 ? 4 * lk + e : HD / 2 + 4 * lk + e - 4;
  }
}

template <typename T, int HD>
__device__ __forceinline__ void lane8(const T* row, int lk, float (&o)[8]) {
  if constexpr (sizeof(T) == 2) {
    load8(row + 8 * lk, o);
  } else {
    const float4 a = *reinterpret_cast<const float4*>(row + 4 * lk);
    const float4 b = *reinterpret_cast<const float4*>(row + HD / 2 + 4 * lk);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  }
}

// lane8 of a row of hd <= HD elements in global memory: the lane's dims at
// or past hd are zeros (hd % 8 == 0, so each group of 4 or 8 is all in or
// all out)
template <typename T, int HD>
__device__ __forceinline__ void lane8_row(const T* row, int lk, int hd,
                                          float (&o)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) o[e] = 0.f;
  if constexpr (sizeof(T) == 2) {
    if (8 * lk < hd) load8(row + 8 * lk, o);
  } else {
    if (4 * lk < hd) {
      const float4 a = *reinterpret_cast<const float4*>(row + 4 * lk);
      o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    }
    if (HD / 2 + 4 * lk < hd) {
      const float4 b =
          *reinterpret_cast<const float4*>(row + HD / 2 + 4 * lk);
      o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
    }
  }
}

// bit i: byte i of x is nonzero
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  const uint32_t y = __vcmpne4(x, 0u);
  return (y & 1u) | (y >> 7 & 2u) | (y >> 14 & 4u) | (y >> 21 & 8u);
}

// bit j: key t + j (< S) is valid, for j < 16; t is a multiple of 16
__device__ __forceinline__ uint32_t valid_bits16(const uint8_t* valid, int t,
                                                 int S) {
  uint32_t bits = 0;
  if (t + 16 <= S && (reinterpret_cast<uintptr_t>(valid + t) & 15u) == 0) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(valid + t));
    bits = nonzero_bytes(u.x) | nonzero_bytes(u.y) << 4 |
           nonzero_bytes(u.z) << 8 | nonzero_bytes(u.w) << 12;
  } else {
    for (int j = 0; j < 16 && t + j < S; ++j)
      bits |= static_cast<uint32_t>(valid[t + j] != 0) << j;
  }
  return bits;
}

// Partial attention of one split: the running max m (log2 units), sum l and
// unnormalised acc of G query heads over the split's keys, into the
// workspace: acc (B, KV, n_split, g, hd), then (m, l) (B, KV, n_split, g, 2).
// hd <= HD is the tensors' head dim: the ring's columns hd.. are zeros.
//   1. The split's validity bits go to shared memory.  When the split has a
//      valid key, only tiles with one are visited: a skipped key would weigh
//      exp(-1e30 - m) = 0 exactly.  When it has none but another split has,
//      it writes m = -1e30, l = 0, acc = 0 (weight 0 in the combine).  When
//      no key is valid at all, every tile is visited: -1e30 everywhere
//      gives the uniform average, as the plain version does; but a partial
//      (``partial``) writes the empty record then too.
//   2. The visited tiles stream through a kStages ring of K and V tiles
//      (cp.async, 16 bytes a thread, zeros past S): kStages - 1 tiles are
//      in flight while one is computed, one barrier per tile.
//   3. Per tile and pass, a thread dots its 8 dims of one key with its G
//      queries (registers) and sums over the key's kL lanes by xor shuffles;
//      scores are log2e-scaled, -1e30 where masked, -inf past S.  One max,
//      rescale and exp2 per (thread, head, tile), then P V from the same
//      tile's V rows in shared memory, all in fp32.
//   4. The kStreams streams merge through shared memory into the record.
template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads)
    decode_attention_split(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const uint8_t* __restrict__ valid,
                           float* __restrict__ work, int S, int H, int KV,
                           int hd, int tiles_per_split, float scale2,
                           int partial) {
  using Sh = Shape<T, HD, G>;
  constexpr int kL = Sh::kL, kStreams = Sh::kStreams, kStages = Sh::kStages;
  const int split = blockIdx.x, n_split = gridDim.x;
  const int g = H / KV, chunks = g / G;
  const int kvh = blockIdx.y / chunks;
  const int h0 = (blockIdx.y % chunks) * G;   // first head within the group
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int lk = tid % kL, stream = tid / kL;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  uint32_t* tmask = reinterpret_cast<uint32_t*>(smem + Sh::kTablesAt);
  uint16_t* tlist = reinterpret_cast<uint16_t*>(tmask + kMaxTiles);
  __shared__ int n_visit;

  // this block's G records: heads h0 .. h0 + G - 1 of (b, kvh, split)
  const int64_t rec =
      ((static_cast<int64_t>(b) * KV + kvh) * n_split + split) * g + h0;
  float* wacc = work + rec * hd;
  float* wml = work + static_cast<int64_t>(gridDim.z) * KV * n_split * g * hd +
               rec * 2;

  float qr[G][8];
  const T* qb = q + (static_cast<int64_t>(b) * H + kvh * g + h0) * hd;
#pragma unroll
  for (int hh = 0; hh < G; ++hh)
    lane8_row<T, HD>(qb + hh * hd, lk, hd, qr[hh]);

  // 1. validity of the split's tiles; what to visit
  const int n_tiles = (S + kTK - 1) / kTK;
  const int tile0 = split * tiles_per_split;
  const int tiles = max(0, min(tiles_per_split, n_tiles - tile0));
  const int key0 = tile0 * kTK;
  uint16_t* hmask = reinterpret_cast<uint16_t*>(tmask);   // half-tile words
  int any = 0;
  for (int c = tid; c < 2 * tiles; c += kThreads) {
    const uint32_t bits = valid_bits16(valid, key0 + 16 * c, S);
    hmask[c] = static_cast<uint16_t>(bits);
    any |= bits != 0;
  }
  const bool split_any = __syncthreads_or(any);
  if (!split_any) {
    // a partial (one rank's slice of a sequence-sharded cache) leaves a
    // slice with no valid key to the combine across ranks: m = -1e30, l = 0
    bool elsewhere = partial != 0;
    if (!elsewhere) {
      int other = 0;
#pragma unroll 4
      for (int t = 16 * tid; t < S; t += 16 * kThreads)
        other |= valid_bits16(valid, t, S) != 0;
      elsewhere = __syncthreads_or(other);
    }
    if (elsewhere) {
      for (int o = tid; o < G * hd; o += kThreads) wacc[o] = 0.f;
      if (tid < G) {
        wml[2 * tid] = kNegInf;
        wml[2 * tid + 1] = 0.f;
      }
      return;
    }
  }
  if (warp == 0) {   // compact the tiles to visit, in order
    int count = 0;
    for (int i0 = 0; i0 < tiles; i0 += 32) {
      const int i = i0 + lane;
      const bool take = i < tiles && (!split_any || tmask[i] != 0);
      const uint32_t ballot = __ballot_sync(0xffffffffu, take);
      if (take) tlist[count + __popc(ballot & ((1u << lane) - 1u))] = i;
      count += __popc(ballot);
    }
    if (lane == 0) n_visit = count;
  }
  __syncthreads();
  const int nv = n_visit;

  // 2. the ring
  const int64_t row_stride = static_cast<int64_t>(KV) * hd;
  const int64_t head0 = static_cast<int64_t>(b) * S * row_stride +
                        static_cast<int64_t>(kvh) * hd;
  const T* kb = k + head0;
  const T* vb = v + head0;
  constexpr int kRowChunks = HD * static_cast<int>(sizeof(T)) / 16;
  constexpr int kChunkElems = 16 / static_cast<int>(sizeof(T));
  constexpr int kTileChunks = kTK * kRowChunks;
  auto issue = [&](int slot, int stage) {
    const int t0 = key0 + kTK * tlist[slot];
    T* dst = ring + stage * 2 * Sh::kTileElems;
#pragma unroll
    for (int c0 = 0; c0 < 2 * kTileChunks; c0 += kThreads) {
      const int c = c0 + tid;
      const bool is_v = c >= kTileChunks;
      const int rc = is_v ? c - kTileChunks : c;
      const int r = rc / kRowChunks;
      const int col = (rc % kRowChunks) * kChunkElems;
      const int t = t0 + r;
      const bool in = t < S && col < hd;   // else zeros: no source bytes
      const T* src = (is_v ? vb : kb) +
                     (in ? static_cast<int64_t>(t) * row_stride + col : 0);
      hopper::cp_async16(dst + (is_v ? Sh::kTileElems : 0) + r * HD + col, src,
                         in ? 16 : 0);
    }
  };

  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int hh = 0; hh < G; ++hh) {
    m[hh] = kNegInf;   // not -inf: exp2(m - m_new) is never inf - inf
    l[hh] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[hh][e] = 0.f;
  }
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nv) issue(st, st);
    hopper::cp_async_commit();
  }
  for (int it = 0; it < nv; ++it) {
    hopper::cp_async_wait<kStages - 2>();   // this thread's copies of `it`
    __syncthreads();                        // everyone's; stage it-1 is free
    if (it + kStages - 1 < nv)
      issue(it + kStages - 1, (it + kStages - 1) % kStages);
    hopper::cp_async_commit();

    // 3. scores, online softmax, P V
    const int i = tlist[it];
    const int t0 = key0 + kTK * i;
    const uint32_t vmask = tmask[i];
    const T* ks = ring + (it % kStages) * 2 * Sh::kTileElems;
    const T* vs = ks + Sh::kTileElems;
    float s[Sh::kPasses][G];
#pragma unroll
    for (int p = 0; p < Sh::kPasses; ++p) {
      const int j = p * kStreams + stream;
      float kx[8];
      lane8<T, HD>(ks + j * HD, lk, kx);
#pragma unroll
      for (int hh = 0; hh < G; ++hh) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(qr[hh][e], kx[e], d);
#pragma unroll
        for (int off = kL / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        s[p][hh] = t0 + j >= S ? -INFINITY
                               : ((vmask >> j) & 1u) ? d * scale2 : kNegInf;
      }
    }
#pragma unroll
    for (int hh = 0; hh < G; ++hh) {
      float mx = s[0][hh];
#pragma unroll
      for (int p = 1; p < Sh::kPasses; ++p) mx = fmaxf(mx, s[p][hh]);
      const float mn = fmaxf(m[hh], mx);
      const float corr = ex2(m[hh] - mn);
      m[hh] = mn;
      l[hh] *= corr;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[hh][e] *= corr;
#pragma unroll
      for (int p = 0; p < Sh::kPasses; ++p) {
        s[p][hh] = ex2(s[p][hh] - mn);
        l[hh] += s[p][hh];
      }
    }
#pragma unroll
    for (int p = 0; p < Sh::kPasses; ++p) {
      float vx[8];
      lane8<T, HD>(vs + (p * kStreams + stream) * HD, lk, vx);
#pragma unroll
      for (int hh = 0; hh < G; ++hh)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[hh][e] = fmaf(s[p][hh], vx[e], acc[hh][e]);
    }
  }
  hopper::cp_async_wait<0>();
  __syncthreads();   // the ring is free for the merge

  // 4. merge the streams: (m, l, acc) of each stream scaled to the max
  float* red = reinterpret_cast<float*>(smem);   // (kStreams, G, HD)
  float* ms = red + kStreams * G * HD;           // (kStreams, G)
  float* ls = ms + kStreams * G;
  if (lk == 0) {
#pragma unroll
    for (int hh = 0; hh < G; ++hh) ms[stream * G + hh] = m[hh];
  }
  __syncthreads();
#pragma unroll
  for (int hh = 0; hh < G; ++hh) {
    float mx = ms[hh];
    for (int r = 1; r < kStreams; ++r) mx = fmaxf(mx, ms[r * G + hh]);
    const float f = ex2(m[hh] - mx);
    float* row = red + (stream * G + hh) * HD;
    *reinterpret_cast<float4*>(row + lane_dim<T, HD>(lk, 0)) = make_float4(
        acc[hh][0] * f, acc[hh][1] * f, acc[hh][2] * f, acc[hh][3] * f);
    *reinterpret_cast<float4*>(row + lane_dim<T, HD>(lk, 4)) = make_float4(
        acc[hh][4] * f, acc[hh][5] * f, acc[hh][6] * f, acc[hh][7] * f);
    if (lk == 0) ls[stream * G + hh] = l[hh] * f;
  }
  __syncthreads();
  for (int o = tid; o < G * hd; o += kThreads) {
    const int hh = o / hd;
    float a = 0.f;
    for (int r = 0; r < kStreams; ++r) a += red[(r * G + hh) * HD + o % hd];
    wacc[o] = a;
  }
  if (tid < G) {
    float mx = ms[tid], sum = 0.f;
    for (int r = 1; r < kStreams; ++r) mx = fmaxf(mx, ms[r * G + tid]);
    for (int r = 0; r < kStreams; ++r) sum += ls[r * G + tid];
    wml[2 * tid] = mx;
    wml[2 * tid + 1] = sum;
  }
}

// out(b, h) = sum_i e^(m_i - M) acc_i / max(sum_i e^(m_i - M) l_i, 1e-30),
// M = max_i m_i over the splits: one warp per (b, h), lanes over the hd <=
// HD columns (lane + 32u below hd).  Lane
// i of a round of 32 splits loads (m_i, l_i) and makes the weight; the
// shuffled weights then scale the splits' acc rows, loads unrolled so
// several are in flight.
//
// With pm != null (decode_attention_partial) it writes the unnormalised
// triple instead of out: pm(b, h) = M in natural-log units (-1e30 where the
// slice has no valid key), pl(b, h) = sum_i e^(m_i - M) l_i and po(b, h, :)
// = sum_i e^(m_i - M) acc_i, fp32, for the combine across ranks.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    decode_attention_combine(const float* __restrict__ work,
                             T* __restrict__ out, float* __restrict__ pm,
                             float* __restrict__ pl, float* __restrict__ po,
                             int B, int H, int KV, int hd, int n_split) {
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (bh >= B * H) return;
  const int b = bh / H, h = bh % H, g = H / KV;
  const int64_t rec0 =
      (static_cast<int64_t>(b) * KV + h / g) * n_split * g + h % g;
  const float* acc = work + rec0 * hd + lane;       // split i: + i * g * hd
  const float* ml = work + static_cast<int64_t>(B) * KV * n_split * g * hd +
                    rec0 * 2;                        // split i: + i * g * 2
  const int64_t acc_step = static_cast<int64_t>(g) * hd;
  float mx = -INFINITY;
  for (int i = lane; i < n_split; i += 32) mx = fmaxf(mx, ml[2 * i * g]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  constexpr int kPer = HD / 32;
  float o[kPer], sum = 0.f;
#pragma unroll
  for (int u = 0; u < kPer; ++u) o[u] = 0.f;
  for (int i0 = 0; i0 < n_split; i0 += 32) {
    float w = 0.f;
    if (i0 + lane < n_split) {
      const float* mli = ml + 2 * (i0 + lane) * g;
      w = ex2(mli[0] - mx);
      sum = fmaf(w, mli[1], sum);
    }
    const int n = min(32, n_split - i0);
    const float* a = acc + i0 * acc_step;
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float wj = __shfl_sync(0xffffffffu, w, j);
#pragma unroll
      for (int u = 0; u < kPer; ++u)
        if (lane + 32 * u < hd)
          o[u] = fmaf(wj, a[j * acc_step + 32 * u], o[u]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (pm != nullptr) {
    if (lane == 0) {
      pm[bh] = mx <= kNegInf ? kNegInf : mx * kLn2;
      pl[bh] = sum;
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      if (lane + 32 * u < hd)
        po[static_cast<int64_t>(bh) * hd + lane + 32 * u] = o[u];
    return;
  }
  const float denom = fmaxf(sum, 1e-30f);
#pragma unroll
  for (int u = 0; u < kPer; ++u)
    if (lane + 32 * u < hd)
      out[static_cast<int64_t>(bh) * hd + lane + 32 * u] =
          from_f32<T>(o[u] / denom);
}

struct Args {
  const void *q, *k, *v, *valid;
  void *work, *out;
  int64_t B, S, H, KV, hd, n_split;
  float scale;
  cudaStream_t stream;
  void *pm = nullptr, *pl = nullptr, *po = nullptr;   // a partial's triple
};

// the split kernel's dynamic shared memory, allowed once per device (the
// attribute is per device; a call per launch costs host time on the serve
// path's short caches)
template <typename T, int HD, int G>
cudaError_t allow_smem() {
  static std::atomic<uint64_t> done{0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(decode_attention_split<T, HD, G>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Shape<T, HD, G>::kSmemBytes));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// The number of splits: as many blocks as the card holds at once, one wave
// with no tail (the blocks of this kernel an SM holds, from cudaOccupancy,
// x 132 SMs, over the (b, KV head, G heads) units, rounded down), at least
// kMinTiles tiles per split, at most kMaxTiles.  qwen3-1.7b at B=4 (KV=8,
// g=2, hd 128, bf16: 65.5 KB of shared memory, 3 blocks per SM, 396 slots
// over 32 units): 12 splits of 86 tiles at S=32,768 (384 blocks), 4 of 2
// tiles at S=256.  zamba2-1.2b's shared attention at B=4 (KV=32, g=1, hd
// 64: 33.5 KB, 6 per SM, 792 slots over 128 units): 4 splits of 2 tiles at
// S=256.  Returns the count, or minus a cudaError_t.
template <typename T, int HD, int G>
int splits(const Args& a) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = allow_smem<T, HD, G>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, decode_attention_split<T, HD, G>, kThreads,
        Shape<T, HD, G>::kSmemBytes);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int64_t units = a.B * a.H / G;   // (b, KV head, chunk of G heads)
  const int64_t n_tiles = cdiv(a.S, kTK);
  int64_t n = static_cast<int64_t>(std::max(per_sm, 1)) * sms / units;
  n = std::min(n, cdiv(n_tiles, kMinTiles));
  n = std::max<int64_t>({n, cdiv(n_tiles, kMaxTiles), 1});
  n = cdiv(n_tiles, cdiv(n_tiles, n));   // no split without a tile
  return n > INT32_MAX ? -static_cast<int>(cudaErrorInvalidValue)
                       : static_cast<int>(n);
}

template <typename T, int HD, int G>
int launch(const Args& a) {
  using Sh = Shape<T, HD, G>;
  if (a.n_split < 1 || cdiv(cdiv(a.S, kTK), a.n_split) > kMaxTiles ||
      a.H / G > 65535 || a.B > 65535 || a.S > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles_per_split = cdiv(cdiv(a.S, kTK), a.n_split);
  cudaError_t err = allow_smem<T, HD, G>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(a.n_split),
                  static_cast<unsigned>(a.H / G), static_cast<unsigned>(a.B));
  decode_attention_split<T, HD, G>
      <<<grid, kThreads, Sh::kSmemBytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const uint8_t*>(a.valid),
      static_cast<float*>(a.work), static_cast<int>(a.S),
      static_cast<int>(a.H), static_cast<int>(a.KV), static_cast<int>(a.hd),
      static_cast<int>(tiles_per_split), a.scale * kLog2e,
      static_cast<int>(a.pm != nullptr));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t warps = kThreads / 32;
  decode_attention_combine<T, HD>
      <<<static_cast<unsigned>(cdiv(a.B * a.H, warps)), kThreads, 0,
         a.stream>>>(
      static_cast<const float*>(a.work), static_cast<T*>(a.out),
      static_cast<float*>(a.pm), static_cast<float*>(a.pl),
      static_cast<float*>(a.po), static_cast<int>(a.B), static_cast<int>(a.H), static_cast<int>(a.KV),
      static_cast<int>(a.hd), static_cast<int>(a.n_split));
  return static_cast<int>(cudaGetLastError());
}

// G: the widest of 4, 2, 1 heads that divides the group
template <typename T, int HD>
int by_group(const Args& a, bool count_splits) {
  const int64_t g = a.H / a.KV;
  if (g % 4 == 0)
    return count_splits ? splits<T, HD, 4>(a) : launch<T, HD, 4>(a);
  if (g % 2 == 0)
    return count_splits ? splits<T, HD, 2>(a) : launch<T, HD, 2>(a);
  return count_splits ? splits<T, HD, 1>(a) : launch<T, HD, 1>(a);
}

// count_splits: the number of splits for the shape (or minus an error);
// else the launch's cudaError_t.  a.hd runs on the next instantiation up
// (head_dim_index).
template <typename T>
int run(const Args& a, bool count_splits) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (a.B <= 0 || a.S <= 0 || a.KV <= 0 || a.H % a.KV != 0)
    return count_splits ? -bad : bad;
  switch (head_dim_index(a.hd)) {
    case 0: return by_group<T, 32>(a, count_splits);
    case 1: return by_group<T, 64>(a, count_splits);
    case 2: return by_group<T, 128>(a, count_splits);
    case 3: return by_group<T, 256>(a, count_splits);
    default: return count_splits ? -bad : bad;
  }
}

}  // namespace dec

}  // namespace

extern "C" {

int flash_attention_f32(const void* q, const void* k, const void* v,
                        void* out, void* lse, int64_t B, int64_t Sq,
                        int64_t Sk, int64_t H, int64_t KV, int64_t hd,
                        int64_t causal, int64_t window, float scale,
                        void* stream) {
  return flash(kFlashF32, q, k, v, out, lse, B, Sq, Sk, H, KV, hd, causal,
               window, scale, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, void* lse, int64_t B, int64_t Sq,
                         int64_t Sk, int64_t H, int64_t KV, int64_t hd,
                         int64_t causal, int64_t window, float scale,
                         void* stream) {
  return flash(kFlashBf16, q, k, v, out, lse, B, Sq, Sk, H, KV, hd, causal,
               window, scale, stream);
}

int decode_attention_splits(int64_t B, int64_t S, int64_t H, int64_t KV,
                            int64_t hd, int64_t bf16) {
  dec::Args a{};
  a.B = B;
  a.S = S;
  a.H = H;
  a.KV = KV;
  a.hd = hd;
  return bf16 ? dec::run<__nv_bfloat16>(a, true) : dec::run<float>(a, true);
}

int decode_attention_f32(const void* q, const void* k, const void* v,
                         const void* valid, void* work, void* out, int64_t B,
                         int64_t S, int64_t H, int64_t KV, int64_t hd,
                         int64_t n_split, float scale, void* stream) {
  const dec::Args a{q, k, v, valid, work, out, B, S, H, KV, hd, n_split, scale,
                    static_cast<cudaStream_t>(stream)};
  return dec::run<float>(a, false);
}

int decode_attention_bf16(const void* q, const void* k, const void* v,
                          const void* valid, void* work, void* out, int64_t B,
                          int64_t S, int64_t H, int64_t KV, int64_t hd,
                          int64_t n_split, float scale, void* stream) {
  const dec::Args a{q, k, v, valid, work, out, B, S, H, KV, hd, n_split, scale,
                    static_cast<cudaStream_t>(stream)};
  return dec::run<__nv_bfloat16>(a, false);
}

// the unnormalised (m, l, o) of one rank's slice of a sequence-sharded
// cache: m and l (B, KV, g), o (B, KV, g, hd), fp32 (out is not written)
int decode_attention_partial_f32(const void* q, const void* k, const void* v,
                                 const void* valid, void* work, void* m,
                                 void* l, void* o, int64_t B, int64_t S,
                                 int64_t H, int64_t KV, int64_t hd,
                                 int64_t n_split, float scale, void* stream) {
  dec::Args a{q, k, v, valid, work, nullptr, B, S, H, KV, hd, n_split, scale,
              static_cast<cudaStream_t>(stream)};
  a.pm = m;
  a.pl = l;
  a.po = o;
  return dec::run<float>(a, false);
}

int decode_attention_partial_bf16(const void* q, const void* k,
                                  const void* v, const void* valid,
                                  void* work, void* m, void* l, void* o,
                                  int64_t B, int64_t S, int64_t H, int64_t KV,
                                  int64_t hd, int64_t n_split, float scale,
                                  void* stream) {
  dec::Args a{q, k, v, valid, work, nullptr, B, S, H, KV, hd, n_split, scale,
              static_cast<cudaStream_t>(stream)};
  a.pm = m;
  a.pl = l;
  a.po = o;
  return dec::run<__nv_bfloat16>(a, false);
}

}  // extern "C"
