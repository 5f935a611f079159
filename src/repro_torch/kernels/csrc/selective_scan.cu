// The Mamba2 SSD selective scan for Hopper (sm_90a), fp32 in and out.
//
// selective_scan: per (batch b, head h), from a zero state,
//     h_t = exp(a_log_t) * h_{t-1} + xdt_t (x) B_t,   y_t = C_t . h_t
//   xdt (B,S,H,dh), a_log (B,S,H), B/C (B,S,n) -> y (B,S,H,dh), all fp32.
//   B and C have no head axis: every head of a batch row reads the same
//   rows (the TPU kernel's index map bh // H).
//   Replaces src/repro/kernels/selective_scan.py::selective_scan (the Pallas
//   kernel whose body is _kernel; models/ssm.py::mamba2_forward computes the
//   same function through this kernel in the port).
//   Bound: bytes.  The recurrence does 4*dh*n flops per step per (b, h);
//   on the tensor cores in TF32 with the 3x split below that is about 0.1
//   ms at zamba2-1.2b's layer (B=4, S=4096, H=32, dh=128, n=64), under the
//   0.16 ms it takes to read xdt, a_log, B, C and write y once.
//
// The chunked (SSD) algorithm, in chunks of kQ = 32 steps:
//   W = G o L,  G = C.B^T (t x s),  L_ts = exp(cum_t - cum_s) for t >= s,
//   y = W.X + diag(exp(cum)).C.H^T,   H <- exp(cum_Q) H + (dend o X)^T.B,
// with cum the in-chunk inclusive cumsum of a_log and dend_s =
// exp(cum_Q - cum_s).  Every product runs on the tensor cores in TF32 with
// the 3xTF32 split: a = hi + lo, hi = tf32(a), lo = a - hi (the tensor
// cores read its TF32 bits), a.b ~ hi.hi + hi.lo + lo.hi in fp32 (single
// TF32 keeps ~3 digits: ~70x the 2e-4 (1 + |y|) limit against the
// sequential recurrence at the JAX test's inputs, tests/test_torch_ssm.py).
// Two kernels:
//   * selective_scan_gram_kernel, once per (b, chunk), into a workspace the
//     wrapper allocates: G in exact fp32 FMAs (2 kQ^2 n flops per chunk,
//     under 1% of the work), and C and B^T split into TF32 hi and lo parts
//     in the K-major, 128-byte-swizzled layout wgmma reads.  Every head
//     then loads them from L2: neither is recomputed or split per head;
//   * selective_scan_chunk_kernel: one block per (128 head-dim rows, head,
//     batch) (64 rows for n > 64) walks the chunks in order and keeps its
//     (rows x n) state in registers for the whole walk, so device memory
//     sees each input once and y once.  Warp-specialised:
//     - a producer warpgroup keeps the next chunks' X, C and B^T tiles, G
//       and a_log in flight (cp.async into a ring of 3 stages, 2 for
//       n > 64; full/empty named barriers per stage) and, as each chunk
//       lands, takes the in-chunk cumsum in fp64 (within a chunk cum falls
//       to tens below zero, and fp32 rounding of it becomes relative error
//       of exp(cum_t - cum_s)), makes W (L masked before the exponential:
//       above the diagonal the difference is positive and may overflow)
//       split and swizzled, and writes exp(cum_t), exp(cum_Q - cum_t).
//       Decays are always differences of cumsums;
//     - each consumer warpgroup owns 64 head-dim rows d and works in the
//       transposed frame, M = d, by wgmma with A from registers (split
//       there) and B from the stage:
//         Y^T (d x t) = X^T.W^T + (H.C^T) diag(exp(cum))
//         H   (d x k) = exp(cum_Q) H + (dend o X)^T.B
//       so H is a wgmma accumulator that stays in registers and is the A
//       operand of the next chunk's H.C^T (the accumulator's column pair
//       (2c, 2c+1) is read as the A fragment's k slots (c, c+4); the Gram
//       kernel stores C's columns in that order).  A chunk's sums stay in
//       the tensor cores' accumulators; the state is carried from chunk to
//       chunk by an fp32 FMA, since the tensor cores round their sums toward
//       zero and a state kept in their accumulator drifts by an ulp of
//       itself per product.  setmaxnreg gives the producers 128 registers
//       and the consumers 184;
//   * no padding in memory: rows past S load as zeros (a_log = 0 and
//     xdt = B = C = 0 leave the state unchanged) and y is stored only for
//     t < S; head-dim rows past dh and state columns past n load as zeros
//     and are not stored.
//
// For the backward (selective_scan_bwd.cu), when `states` is not null the
// chunk kernel also writes the state at the start of every chunk but the
// first, (B, H, ceil(S / 32) - 1, dh, n) fp32.  The state update sums its
// hi.lo and lo.hi products first and its hi.hi ones apart: the tensor
// cores' round-toward-zero sums through all three would cost the state,
// and so y and the backward's state-dependent gradients, ~2.8x fp32's
// error (emulated).
//
// C interface (bound with ctypes): selective_scan_f32 launches both kernels
// on the stream and returns cudaGetLastError(), or cudaErrorInvalidValue
// for a state size outside [1, 128], an empty or too large grid, no y, or
// a workspace smaller than B * ceil(S / 32) * 32 * (32 + 4 *
// n_pad) floats (n_pad = 64 for n <= 64, else 128).
// The backward runs the Gram kernel's body (selective_scan.cuh) with B and
// C swapped.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "selective_scan.cuh"

namespace {

using scan::kQ;
using scan::kMaxN;
using scan::kdesc;
using scan::split;
using scan::swz;
using scan::tile_bytes;
using scan::wgmma_n32;
using scan::wgmma_n64;

// ---- the Gram kernel: per (b, chunk) G = C.B^T and the tiles of C, B^T ----
using scan::kGramThreads;

__global__ void __launch_bounds__(kGramThreads)
selective_scan_gram_kernel(const float* __restrict__ Bm,
                           const float* __restrict__ Cm, float* __restrict__ G,
                           unsigned char* __restrict__ P, int S, int n,
                           int kN) {
  scan::gram(Bm, Cm, G, P, S, n, kN);
}

// ---- cp.async ---------------------------------------------------------------
// `bytes` < the copy's size fills the rest with zeros; 0 reads nothing
using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(hopper::smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

// kQ rows of `cols` floats (a multiple of 4) into dst (row stride ld), by
// kThreads threads of which this is number tid:
// global row r at src + r * gstride, valid for r < rows_ok and columns
// < cols_ok, zeros elsewhere.  16-byte copies when `vec` (every valid row
// start and cols_ok a multiple of 4 floats), else 4-byte ones.
template <int kThreads>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          int64_t gstride, int rows_ok,
                                          int cols_ok, int cols, bool vec,
                                          int tid) {
  if (vec) {
    const int cv = cols >> 2;
    for (int i = tid; i < kQ * cv; i += kThreads) {
      const int r = i / cv, c = (i - r * cv) << 2;
      const bool ok = r < rows_ok && c < cols_ok;
      cp_async16(dst + r * ld + c, ok ? src + r * gstride + c : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < kQ * cols; i += kThreads) {
      const int r = i / cols, c = i - r * cols;
      const bool ok = r < rows_ok && c < cols_ok;
      cp_async4(dst + r * ld + c, ok ? src + r * gstride + c : src,
                ok ? 4 : 0);
    }
  }
}

// ---- the chunk kernel ---------------------------------------------------------
// Shared memory of the chunk kernel.  Per stage (chunk), 1024-aligned: W's
// TF32 hi and lo parts (t x s, K-major, swizzled), the C and B^T tiles as
// the Gram kernel made them, X as loaded, exp(cum_t), exp(cum_Q - cum_t).
// Then the producers' staging of G and a_log.
template <int kWG, int kNT>
struct Tiles {
  static constexpr int kRows = 64 * kWG;      // head-dim rows per block
  static constexpr int kXLd = kRows + 8;      // = 8 (mod 32)
  static constexpr int kN = 8 * kNT;          // state columns, zeros past n
  static constexpr int kWh = 0, kWl = 4096, kCh = 8192,
                       kCl = kCh + tile_bytes(kN), kBh = kCl + tile_bytes(kN),
                       kBl = kBh + tile_bytes(kN), kX = kBl + tile_bytes(kN),
                       kDec = kX + 4 * kQ * kXLd, kDend = kDec + 4 * kQ,
                       kStage = (kDend + 4 * kQ + 1023) / 1024 * 1024;
  static constexpr int kRawG = 0, kRawA = kQ * kQ, kRaw = 4 * (kRawA + kQ);
  static constexpr int kStages = kNT <= 8 ? 3 : 2;
  static constexpr size_t kSmemBytes =
      static_cast<size_t>(kStages) * (kStage + kRaw) + 1024;
  static_assert(kSmemBytes <= 232448, "over the 227 KB a block can use");
};

constexpr int kProducerThreads = 128;         // one warpgroup
// with two consumer warpgroups the 384 threads share 64K registers
constexpr uint32_t kProducerRegs = 128, kConsumerRegs2 = 184;

// The producers' loads of chunk c (one cp.async group): X and the Gram
// kernel's C and B^T tiles (pc) into its stage, G and a_log into staging.
template <int kWG, int kNT>
__device__ __forceinline__ void load_chunk(
    unsigned char* stage, float* raw, int c, const float* xb, const float* ab,
    const unsigned char* pc, const float* gc, int S, int H, int dh, int d0,
    int64_t step, bool vec_x, int pt) {
  using T = Tiles<kWG, kNT>;
  const int c0 = c * kQ, q = min(kQ, S - c0);
  load_rows<kProducerThreads>(reinterpret_cast<float*>(stage + T::kX),
                              T::kXLd, xb + c0 * step, step, q, dh - d0,
                              T::kRows, vec_x, pt);
  constexpr int kChunks = 4 * tile_bytes(T::kN) / 16;
  for (int i = pt; i < kChunks; i += kProducerThreads)
    cp_async16(reinterpret_cast<float*>(stage + T::kCh) + 4 * i,
               reinterpret_cast<const float*>(pc) + 4 * i, 16);
  load_rows<kProducerThreads>(raw + T::kRawG, kQ, gc, kQ, kQ, kQ, kQ, true,
                              pt);
  if (pt < kQ)
    cp_async4(raw + T::kRawA + pt,
              pt < q ? ab + static_cast<int64_t>(c0 + pt) * H : ab,
              pt < q ? 4 : 0);
}

// The producers' math for a chunk that has landed: the in-chunk cumsum of
// a_log (each producer warp its own copy, fp64; lane l holds step l),
// W = G o L (masked before the exponential) split into TF32 hi and lo,
// K-major and swizzled, and the decays.  Warp pw takes rows pw, pw + 4, ...
template <int kWG, int kNT>
__device__ __forceinline__ void make_w(unsigned char* stage, const float* raw,
                                       int pt) {
  using T = Tiles<kWG, kNT>;
  static_assert(kQ == 32, "one step per lane");
  const int lane = pt & 31, pw = pt >> 5;
  double cum = raw[T::kRawA + lane];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double up = __shfl_up_sync(0xffffffffu, cum, off);
    if (lane >= off) cum += up;
  }
  const double last = __shfl_sync(0xffffffffu, cum, 31);
  if (pw == 0) {
    reinterpret_cast<float*>(stage + T::kDec)[lane] =
        expf(static_cast<float>(cum));
    reinterpret_cast<float*>(stage + T::kDend)[lane] =
        expf(static_cast<float>(last - cum));
  }
#pragma unroll 2
  for (int t = pw; t < kQ; t += 4) {
    const double ct = __shfl_sync(0xffffffffu, cum, t);
    const float w = t >= lane ? raw[T::kRawG + t * kQ + lane] *
                                    expf(static_cast<float>(ct - cum))
                              : 0.f;
    uint32_t hi, lo;
    split(w, hi, lo);
    const int o = swz(t, lane);
    *reinterpret_cast<uint32_t*>(stage + T::kWh + o) = hi;
    *reinterpret_cast<uint32_t*>(stage + T::kWl + o) = lo;
  }
}

template <int kWG, int kNT>
__global__ void __launch_bounds__(128 * (kWG + 1), 1)
selective_scan_chunk_kernel(const float* __restrict__ xdt,
                            const float* __restrict__ a_log,
                            const float* __restrict__ G,
                            const unsigned char* __restrict__ P,
                            float* __restrict__ y, float* __restrict__ states,
                            int S, int H, int dh, int n, bool vec_x) {
  using T = Tiles<kWG, kNT>;
  constexpr int kStages = T::kStages;
  constexpr int kAll = 128 * (kWG + 1);
  // named barriers: stage s full (1 + s), empty (1 + kStages + s), the
  // producers among themselves (1 + 2 kStages)
  constexpr uint32_t kBarFull = 1, kBarEmpty = 1 + kStages,
                     kBarProducers = 1 + 2 * kStages;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* staging = reinterpret_cast<float*>(smem + kStages * T::kStage);
  const int h = blockIdx.y, b = blockIdx.z;
  const int d0 = blockIdx.x * T::kRows;
  const int nc = (S + kQ - 1) / kQ;
  const int64_t step = static_cast<int64_t>(H) * dh;         // one time step
  const float* xb = xdt + static_cast<int64_t>(b) * S * step + h * dh + d0;

  if (threadIdx.x < kProducerThreads) {
    // ---- producers: kStages - 1 chunks in flight, then W ----
    if constexpr (kWG == 2) hopper::regs_release<kProducerRegs>();
    const int pt = threadIdx.x;
    const float* ab = a_log + static_cast<int64_t>(b) * S * H + h;
    auto load = [&](int c) {
      load_chunk<kWG, kNT>(
          smem + (c % kStages) * T::kStage, staging + (c % kStages) * (T::kRaw / 4),
          c, xb, ab,
          P + (static_cast<int64_t>(b) * nc + c) * 4 * tile_bytes(T::kN),
          G + (static_cast<int64_t>(b) * nc + c) * kQ * kQ, S, H, dh, d0,
          step, vec_x, pt);
    };
    for (int c = 0; c < kStages - 1; ++c) {
      if (c < nc) load(c);
      cp_async_commit();
    }
    for (int c = 0; c < nc; ++c) {
      cp_async_wait<kStages - 2>();   // chunk c has landed (this thread's)
      hopper::named_barrier_sync(kBarProducers, kProducerThreads);
      const int s = c % kStages;
      make_w<kWG, kNT>(smem + s * T::kStage, staging + s * (T::kRaw / 4), pt);
      hopper::fence_proxy_async();    // W, for wgmma
      hopper::named_barrier_arrive(kBarFull + s, kAll);
      // refill the stage of chunk c - 1 once the consumers are done with it
      const int cn = c + kStages - 1;
      if (cn < nc) {
        if (c >= 1)
          hopper::named_barrier_sync(kBarEmpty + cn % kStages, kAll);
        load(cn);
      }
      cp_async_commit();
    }
    return;
  }

  // ---- consumers: warpgroup g owns head-dim rows 64 g .. 64 g + 63; warp
  // w (of all consumer warps) rows 16 w .. 16 w + 15 ----
  if constexpr (kWG == 2) hopper::regs_claim<kConsumerRegs2>();
  const int ct = threadIdx.x - kProducerThreads;
  const int lane = ct & 31, warp = ct >> 5;
  const int gid = lane >> 2, cid = lane & 3;
  const int r0 = 16 * warp;
  float* yb = y + static_cast<int64_t>(b) * S * step + h * dh + d0;
  // with states: the state at the start of chunk c >= 1 into slot c - 1
  // of (b, h), (dh, n) row-major (for the backward)
  float* sb = states == nullptr
      ? nullptr
      : states + (static_cast<int64_t>(b) * H + h) * (nc - 1) *
                     static_cast<int64_t>(dh) * n;

  // the state rows r0 + {gid, gid + 8}, columns 8j + 2cid + {0, 1}
  float hacc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
    hacc[j][0] = hacc[j][1] = hacc[j][2] = hacc[j][3] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const int s = c % kStages;
    const unsigned char* st = smem + s * T::kStage;
    const float* Xs = reinterpret_cast<const float*>(st + T::kX);
    const float* dec = reinterpret_cast<const float*>(st + T::kDec);
    const float* dend = reinterpret_cast<const float*>(st + T::kDend);
    const uint32_t sa = hopper::smem_addr(st);
    hopper::named_barrier_sync(kBarFull + s, kAll);
    const float dq = dec[kQ - 1];

    // X^T (A of X^T.W^T) and (dend o X)^T (A of the state update): k-step
    // ks is steps 8 ks + cid (+4) of rows r0 + gid (+8)
    uint32_t xh[kQ / 8][4], xl[kQ / 8][4], eh[kQ / 8][4], el[kQ / 8][4];
#pragma unroll
    for (int ks = 0; ks < kQ / 8; ++ks) {
      const float* xr = Xs + (8 * ks + cid) * T::kXLd + r0 + gid;
      const float x[4] = {xr[0], xr[8], xr[4 * T::kXLd], xr[4 * T::kXLd + 8]};
      const float e0 = dend[8 * ks + cid], e1 = dend[8 * ks + cid + 4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        split(x[e], xh[ks][e], xl[ks][e]);
        split((e < 2 ? e0 : e1) * x[e], eh[ks][e], el[ks][e]);
      }
    }
    float dH[kNT][4], yacc[16], ycar[16];
#pragma unroll
    for (int j = 0; j < kNT; ++j) dH[j][0] = dH[j][1] = dH[j][2] = dH[j][3] = 0.f;
#pragma unroll
    for (int e = 0; e < 16; ++e) yacc[e] = ycar[e] = 0.f;

    // ---- dH = (dend o X)^T.B (per 64 state columns) and Y^T = X^T.W^T in
    // one batch.  dH sums its hi.lo and lo.hi products first and its hi.hi
    // ones into two accumulators by turns (one for n > 64, for want of
    // registers): the tensor cores round each sum toward zero, and a running
    // sum that all 12 products pass drifts ~2.8x as far from the exact sum
    // as fp32 FMAs (emulated), which the state carries into y and the
    // backward's state-dependent gradients ----
    constexpr int kNT2 = kNT == 8 ? kNT : 1;
    float dH2[kNT2][4];
#pragma unroll
    for (int j = 0; j < kNT2; ++j)
      dH2[j][0] = dH2[j][1] = dH2[j][2] = dH2[j][3] = 0.f;
    hopper::fence_regs(yacc);
#pragma unroll
    for (int j = 0; j < kNT; ++j) hopper::fence_regs(dH[j]);
#pragma unroll
    for (int j = 0; j < kNT2; ++j) hopper::fence_regs(dH2[j]);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kQ / 8; ++ks) {
#pragma unroll
      for (int hf = 0; hf < kNT / 8; ++hf) {
        const uint32_t bh = sa + T::kBh + hf * 8192 + 32 * ks;
        const uint32_t bl = sa + T::kBl + hf * 8192 + 32 * ks;
        wgmma_n64(&dH[8 * hf][0], el[ks], kdesc(bh));
        wgmma_n64(&dH[8 * hf][0], eh[ks], kdesc(bl));
      }
      wgmma_n32(yacc, xl[ks], kdesc(sa + T::kWh + 32 * ks));
      wgmma_n32(yacc, xh[ks], kdesc(sa + T::kWl + 32 * ks));
      wgmma_n32(yacc, xh[ks], kdesc(sa + T::kWh + 32 * ks));
    }
#pragma unroll
    for (int ks = 0; ks < kQ / 8; ++ks)
#pragma unroll
      for (int hf = 0; hf < kNT / 8; ++hf) {
        const uint32_t bh = sa + T::kBh + hf * 8192 + 32 * ks;
        // ks is a constant: the accumulator is chosen at compile time
        wgmma_n64(kNT == 8 && (ks & 1) ? &dH2[0][0] : &dH[8 * hf][0],
                  eh[ks], kdesc(bh));
      }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int ks = 0; ks < kQ / 8; ++ks) {
      hopper::fence_regs(xh[ks]);
      hopper::fence_regs(xl[ks]);
      hopper::fence_regs(eh[ks]);
      hopper::fence_regs(el[ks]);
    }
    hopper::fence_regs(yacc);
#pragma unroll
    for (int j = 0; j < kNT; ++j) hopper::fence_regs(dH[j]);
#pragma unroll
    for (int j = 0; j < kNT2; ++j) hopper::fence_regs(dH2[j]);
    if constexpr (kNT == 8) {
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dH[j][e] += dH2[j][e];
    }

    // ---- carried: H.C^T, the state accumulator as the A operand, its
    // column pair (2c, 2c + 1) read as the k slots (c, c + 4) ----
    hopper::fence_regs(ycar);
#pragma unroll
    for (int j0 = 0; j0 < kNT; j0 += 8) {
      uint32_t ah[8][4], al[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        split(hacc[j0 + j][0], ah[j][0], al[j][0]);
        split(hacc[j0 + j][2], ah[j][1], al[j][1]);
        split(hacc[j0 + j][1], ah[j][2], al[j][2]);
        split(hacc[j0 + j][3], ah[j][3], al[j][3]);
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = j0 + j;        // k-step: columns 8k .. 8k + 7
        const uint32_t off = (k >> 2) * 4096 + 32 * (k & 3);
        wgmma_n32(ycar, al[j], kdesc(sa + T::kCh + off));
        wgmma_n32(ycar, ah[j], kdesc(sa + T::kCl + off));
        wgmma_n32(ycar, ah[j], kdesc(sa + T::kCh + off));
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        hopper::fence_regs(ah[j]);
        hopper::fence_regs(al[j]);
      }
    }
    hopper::fence_regs(ycar);
    hopper::fence_regs(yacc);
#pragma unroll
    for (int j = 0; j < kNT; ++j) hopper::fence_regs(dH[j]);
    // every read of the stage is done: the producers may refill it
    if (c + kStages < nc)
      hopper::named_barrier_arrive(kBarEmpty + s, kAll);

    // ---- H <- exp(cum_Q) H + dH and y = Y^T + carried diag(exp(cum)),
    // in fp32 ----
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[j][e] = fmaf(dq, hacc[j][e], dH[j][e]);
    const int c0 = c * kQ, q = min(kQ, S - c0);
    const int da = r0 + gid, db = da + 8;
    if (sb != nullptr && c + 1 < nc) {
      float* st = sb + static_cast<int64_t>(c) * dh * n;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int d = d0 + (hr ? db : da), k = 8 * j + 2 * cid;
          float* o = st + static_cast<int64_t>(d) * n + k;
          if (d >= dh || k >= n) continue;
          if (n % 2 == 0)
            *reinterpret_cast<float2*>(o) =
                make_float2(hacc[j][2 * hr], hacc[j][2 * hr + 1]);
          else {
            o[0] = hacc[j][2 * hr];
            if (k + 1 < n) o[1] = hacc[j][2 * hr + 1];
          }
        }
    }
#pragma unroll
    for (int nt = 0; nt < kQ / 8; ++nt) {
      const int t = 8 * nt + 2 * cid;
      const float2 dv = *reinterpret_cast<const float2*>(dec + t);
      const float y0 = fmaf(ycar[4 * nt], dv.x, yacc[4 * nt]);
      const float y1 = fmaf(ycar[4 * nt + 1], dv.y, yacc[4 * nt + 1]);
      const float y2 = fmaf(ycar[4 * nt + 2], dv.x, yacc[4 * nt + 2]);
      const float y3 = fmaf(ycar[4 * nt + 3], dv.y, yacc[4 * nt + 3]);
      float* yt = yb + static_cast<int64_t>(c0 + t) * step;
      if (t < q) {
        if (d0 + da < dh) __stcs(yt + da, y0);
        if (d0 + db < dh) __stcs(yt + db, y2);
      }
      if (t + 1 < q) {
        if (d0 + da < dh) __stcs(yt + step + da, y1);
        if (d0 + db < dh) __stcs(yt + step + db, y3);
      }
    }
  }
}

template <int kWG, int kNT>
cudaError_t launch_chunks(const float* xdt, const float* a_log, const float* G,
                          const unsigned char* P, float* y, float* states,
                          int B, int S, int H, int dh, int n,
                          cudaStream_t stream) {
  using T = Tiles<kWG, kNT>;
  auto kernel = selective_scan_chunk_kernel<kWG, kNT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::kSmemBytes));
  if (err != cudaSuccess) return err;
  const bool vec_x = dh % 4 == 0 && reinterpret_cast<uintptr_t>(xdt) % 16 == 0;
  const dim3 grid(static_cast<unsigned>((dh + T::kRows - 1) / T::kRows),
                  static_cast<unsigned>(H), static_cast<unsigned>(B));
  kernel<<<grid, 128 * (kWG + 1), T::kSmemBytes, stream>>>(
      xdt, a_log, G, P, y, states, S, H, dh, n, vec_x);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int selective_scan_f32(const void* xdt, const void* a_log, const void* Bm,
                       const void* Cm, void* work, void* y, void* states,
                       int64_t B, int64_t S, int64_t H, int64_t dh, int64_t n,
                       int64_t work_floats, void* streamv) {
  const int64_t nc = (S + kQ - 1) / kQ;
  const int kN = n <= 64 ? 64 : 128;             // the tiles' state columns
  if (B <= 0 || S <= 0 || H <= 0 || dh <= 0 || n < 1 || n > kMaxN ||
      B > 65535 || H > 65535 || nc > 2147483647 ||
      work_floats < scan::gram_floats(B, S, kN) ||
      reinterpret_cast<uintptr_t>(work) % 16 != 0 ||
      y == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(streamv);
  const float* xf = static_cast<const float*>(xdt);
  const float* af = static_cast<const float*>(a_log);
  float* g = static_cast<float*>(work);          // G: (B, nc, kQ, kQ)
  // then the tiles: (B, nc, 4 tiles of tile_bytes(kN))
  unsigned char* p = reinterpret_cast<unsigned char*>(g + B * nc * kQ * kQ);
  const size_t gsmem = scan::gram_smem(static_cast<int>(n));
  cudaError_t err = cudaFuncSetAttribute(
      selective_scan_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(gsmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  selective_scan_gram_kernel<<<dim3(static_cast<unsigned>(nc),
                                    static_cast<unsigned>(B)),
                               kGramThreads, gsmem, stream>>>(
      static_cast<const float*>(Bm), static_cast<const float*>(Cm), g, p,
      static_cast<int>(S), static_cast<int>(n), kN);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // n <= 64: 128 head-dim rows per block (two consumer warpgroups), 3
  // stages; wider states: 64 rows, 2 stages, to fit shared memory.  The
  // states, when asked for, are written beside y
  const int Bi = static_cast<int>(B), Si = static_cast<int>(S),
            Hi = static_cast<int>(H), dhi = static_cast<int>(dh),
            ni = static_cast<int>(n);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(states);
  err = kN == 64 ? launch_chunks<2, 8>(xf, af, g, p, yf, sf, Bi, Si, Hi, dhi,
                                        ni, stream)
                 : launch_chunks<1, 16>(xf, af, g, p, yf, sf, Bi, Si, Hi, dhi,
                                        ni, stream);
  return static_cast<int>(err);
}

}  // extern "C"
