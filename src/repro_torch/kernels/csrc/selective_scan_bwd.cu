// The gradient of the Mamba2 SSD selective scan for Hopper (sm_90a), fp32.
//
// selective_scan_bwd: given the forward's inputs xdt (B,S,H,dh), a_log
// (B,S,H), B/C (B,S,n) (zero initial state), the states the forward wrote
// beside y (selective_scan.cu: the state at the start of every chunk but
// the first, (B, H, ceil(S/32) - 1, dh, n)) and dy (B,S,H,dh), writes
// dxdt (B,S,H,dh), da_log (B,S,H) and dB, dC (B,S,n), the last two summed
// over the heads.
//   Replaces the gradient of src/repro/kernels/selective_scan.py::
//   selective_scan (the Pallas kernel has no backward; the JAX package
//   differentiates its chunked jnp scan, repro/models/ssm.py::_ssd_chunked).
//   Bound: operations, the sequential backward's 10 dh n flops a step and
//   head on the TF32 tensor cores three times over (the 3xTF32 split), as
//   the forward is counted; bytes (xdt, dy read and dxdt written once, the
//   rest small) come close below it.
//
// By chunks of kQ = 32 steps (cum the in-chunk cumsum of a_log in fp64,
// L_ts = exp(cum_t - cum_s) for t >= s, e_t = exp(cum_t), dend_s =
// exp(cum_Q - cum_s), eq = exp(cum_Q)), with H0 the state at the chunk's
// start, G the gradient of the state at its end, W = L o C.B^T, M_ts =
// dy_t . x_s (summed over d) and P = W o M:
//   dX^T = dY^T.W + (G.B^T) diag(dend)                      (d x s)
//   G   <- eq G + (diag(e) dY)^T.C                          (d x k)
//   dB   = sum_h (L o M)^T.C + diag(dend) X.G               (s x k)
//   dC   = sum_h (L o M).B + diag(e) dY.H0                  (t x k)
//   da_t = sum_{t'>=t>s} P_t's + sum_{t'>=t} q_t' + sum_{s<t} p_s + eq <G, H0>
//          q_t = e_t <C_t, (dY.H0)_t>,  p_s = dend_s <B_s, (X.G)_s>
// da_log_t is a_t <g_t, h_{t-1}> term by term (g the adjoint state), so no
// sum cancels: the other exact form, sum_{k>=t} (<dy_k, y_k> - <x_k,
// dx_k>), adds large terms that cancel (to an exact 0 at t = 0), and its
// fp32 rounding came to 1.2x the 2e-4 (1 + |want|) limit at zamba2's train
// shape (read on an H100).  The pair sum is taken in fp64 as
// sum_{v<t} (colsum_v - rowsum_v) of P's strictly lower triangle.
//
// The design follows the forward (selective_scan.cu), whose H0 it reads
// from the states rather than recomputing them (ops.py's autograd Function
// keeps them from the forward it saves).  Launches:
//   * scan_bwd_gram_kernel, the forward's Gram kernel with B and C swapped,
//     once per (b, chunk): B.C^T (= (C.B^T)^T, s x t) in fp32, B in the
//     permuted s x k layout of the forward's C tile and C^T in the k x t
//     layout of its B^T tile, split into TF32 hi and lo and swizzled for
//     wgmma.  Every head reads them from L2: C.B^T is not recomputed per
//     head;
//   * scan_bwd_chunk_kernel: one block per (128 head-dim rows, 64 state
//     columns, head, batch) walks the chunks in reverse with G (128 x 64)
//     in the consumers' registers.  Warp-specialised, 384 threads:
//     - a producer warpgroup (warps 8-11) loads by cp.async: the next
//       chunk's X, dY, Gram tiles, B.C^T and a_log into a ring of 2 stages,
//       and H0 into a buffer of its own, both as soon as the consumers are
//       done with the chunk before (one barrier, after their dB and dC);
//       as a stage lands it takes the cumsum in fp64 and makes L^T (in
//       place of B.C^T; L masked before the exponential), W^T split and
//       swizzled for wgmma, and e, dend, eq;
//     - two consumer warpgroups of 64 head-dim rows each work in the
//       transposed frame, M = d, on 3xTF32 wgmma with A from registers:
//       dX^T (dY^T and G as A; W^T and the B tile as B) and the update of
//       G (diag(e) dY^T as A, the C^T tile as B).  G is the accumulator
//       turned A operand, as the forward's H; it is carried from chunk to
//       chunk by an fp32 FMA;
//     - then all eight consumer warps run the products that sum over d or
//       t on 3xTF32 mma.sync (m16n8k8), operands from shared memory split
//       in registers: M (a 16 x 8 tile a warp, all 128 rows of d; with it,
//       P's column and row sums), then dB (warpgroup 0: X.G, with G as
//       written to shared memory at the chunk's start, and (L o M)^T.C)
//       and dC (warpgroup 1: dY.H0 and (L o M).B), p and q from their
//       accumulators, <G, H0>; one warp sums da_t in fp64;
//     - accuracy: the tensor cores round each sum toward zero, so every
//       product sums its hi.lo and lo.hi terms apart from its hi.hi ones
//       (mma3; on wgmma two hi.hi accumulators by turns): one running sum
//       through all three came to 2.8-5.7x fp32's RMS error (emulated),
//       and the no-decay regime's gradients to 1.9-3.8x the fp32 plain
//       backward's (an H100).  With no decay <G, H0> is ~0.98 of da, so it
//       is summed in fp64 and G is carried as a two-float sum (carry()):
//       there the readings are 0.62-1.00x the fp32 plain backward's RMS
//       error over 8 seeds (an H100);
//     - raw fp32 tiles in shared memory (X, dY, H0, G, L o M) are
//       swizzled by 16-byte chunk (chunk XOR f(row)) so that the fragment
//       reads are free of bank conflicts or at most 2-way;
//     - shared memory: 2 stages of 77 KB, H0 and G 32 KB each, 8 KB of
//       L o M and sums: 226.5 KB, one block an SM; setmaxnreg gives the
//       consumers 216 registers;
//   * scan_bwd_reduce_kernel: dB and dC summed over (head, row tile), and
//     da_log (dxdt) over row tiles and 64-column slices (slices of n) when
//     there are several, in that fixed order: no atomics, so two runs are
//     bitwise equal.
// Rows past S are identity steps (a_log = 0, xdt = B = C = dy = 0) and are
// not stored; head-dim rows past dh and state columns past n load as zeros
// and are not stored: no padding in memory.
//
// Workspace (floats, the wrapper allocates it): the Gram kernel's,
// B ceil(S/32) (32^2 + 128 n_pad) (n_pad 64 for n <= 64, else 128); the
// partial dB and dC, 2 B S H tiles n (tiles = ceil(dh / 128)); partial
// da_log, B S H tiles slices when tiles slices > 1 (slices = ceil(n / 64));
// partial dxdt, slices B S H dh when slices > 1.  At zamba2-1.2b's train
// shape (B=8 S=256 H=32 dh=128 n=64): 2.36 + 33.55 MB; the forward's
// states it reads are 58.72 MB there.
//
// C interface (bound with ctypes): selective_scan_bwd_f32 launches the
// kernels on the stream and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a state size outside [1, 128], an empty or too
// large grid, no states where S > 32, or a workspace smaller than the
// above.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "selective_scan.cuh"

namespace {

using scan::kMaxN;
using scan::kQ;
using scan::kdesc;
using scan::perm8;
using scan::split;
using scan::swz;
using scan::tile_bytes;
using scan::wgmma_n32;
using scan::wgmma_n64;

constexpr int kRows = 128;       // head-dim rows per block
constexpr int kN = 64;           // state columns per block
// two consumer warpgroups, then a producer warpgroup; setmaxnreg moves
// registers from the producers (72) to the consumers (216).  A claim waits
// for registers that others released: the two sums must stay within the
// 168 a thread the block was launched with, or the claim never returns
constexpr int kProducerThreads = 128;
constexpr int kConsumerThreads = 256;
constexpr int kAll = kProducerThreads + kConsumerThreads;
constexpr uint32_t kProducerRegs = 72, kConsumerRegs = 216;
static_assert(kProducerRegs * kProducerThreads +
                  kConsumerRegs * kConsumerThreads <= 168 * kAll,
              "setmaxnreg would wait forever");

// named barriers: stage s full (1 + s); the consumers done with a chunk's
// stage and H0 (free); the consumers among themselves; H0 landed; the
// producers among themselves
constexpr uint32_t kBarFull = 1, kBarFree = 3, kBarConsumers = 4,
                   kBarH0Full = 5, kBarProducers = 6;

// ---- shared memory ----------------------------------------------------------
// raw fp32 tiles of `len`-float rows (len >= 32): the float at (row, col),
// its 16-byte chunk XOR xr(row).  Across 8 consecutive rows, or 4 rows
// of even (odd) row & 7, xr takes distinct values, so the fragment reads
// below hit distinct banks
__device__ __forceinline__ int xr(int row) {
  return ((row & 3) << 1) | ((row >> 2) & 1);
}

__device__ __forceinline__ int raw(int row, int col, int len) {
  return row * len + ((((col >> 2) ^ xr(row)) << 2) | (col & 3));
}

// Per stage (chunk), 1024-aligned: the Gram tiles of the block's 64 state
// columns (B: s x k permuted, C^T: k x t; hi and lo), W^T's hi and lo parts
// (s x t, K-major along t, swizzled), X and dY (raw, t x 128), L^T (raw,
// s x t: first B.C^T as loaded, then L^T), a_log, e, dend, eq.
// Then, once: H0 and G (raw, d x 64), L o M (raw, t x s) and sums (the
// column and row sums of P's strictly lower triangle, in fp64, per warp,
// two sets by turns: warpgroup 1 writes the next chunk's while warp 0 may
// still read this one's).
struct Smem {
  static constexpr int kBh = 0, kBl = 8192, kCh = 16384, kCl = 24576,
                       kWh = 32768, kWl = 36864, kX = 40960,
                       kDY = kX + 4 * kQ * kRows, kL = kDY + 4 * kQ * kRows,
                       kA = kL + 4 * kQ * kQ, kE = kA + 4 * kQ,
                       kDend = kE + 4 * kQ, kEq = kDend + 4 * kQ,
                       kStage = (kEq + 16 + 1023) / 1024 * 1024;
  static constexpr int kH0 = 2 * kStage, kG = kH0 + 4 * kRows * kN,
                       kLM = kG + 4 * kRows * kN, kCol = kLM + 4 * kQ * kQ,
                       kRow = kCol + 2 * 8 * 2 * kQ,
                       kQp = kRow + 2 * 8 * 4 * kQ,
                       kPp = kQp + 4 * 2 * kQ, kRed = kPp + 4 * 2 * kQ,
                       kEnd = kRed + 8 * 8;
  static constexpr size_t kBytes = kEnd + 1024;
  static_assert(kBytes <= 232448, "over the 227 KB a block can use");
};

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(hopper::smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

// `rows` x `len` floats into a raw tile: global row r at src + r * gstride,
// valid for r < rows_ok and columns < cols_ok, zeros elsewhere; 16-byte
// copies when `vec` (every valid row start and cols_ok a multiple of 4
// floats), else 4-byte ones
__device__ __forceinline__ void load_raw(float* dst, int rows, int len,
                                         const float* src, int64_t gstride,
                                         int rows_ok, int cols_ok, bool vec,
                                         int tid) {
  if (vec) {
    const int cv = len >> 2;
    for (int i = tid; i < rows * cv; i += kProducerThreads) {
      const int r = i / cv, c = (i - r * cv) << 2;
      const bool ok = r < rows_ok && c < cols_ok;
      cp_async16(dst + raw(r, c, len), ok ? src + r * gstride + c : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < rows * len; i += kProducerThreads) {
      const int r = i / len, c = i - r * len;
      const bool ok = r < rows_ok && c < cols_ok;
      cp_async4(dst + raw(r, c, len), ok ? src + r * gstride + c : src,
                ok ? 4 : 0);
    }
  }
}

__device__ __forceinline__ double warp_prefix(double v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

__device__ __forceinline__ double warp_suffix(double v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_down_sync(0xffffffffu, v, o);
    if (lane + o < 32) v += u;
  }
  return v;
}

// (g, gl) <- q (g + gl) + a + b, g + gl an unevaluated sum of two floats:
// the product's and the sums' rounding errors (fma, TwoSum) go to gl, then
// g + gl is renormalised (Fast2Sum).  The _rn intrinsics keep the compiler
// from fusing a product into a sum whose rounding error is taken
__device__ __forceinline__ float two_sum(float a, float b, float& err) {
  const float s = __fadd_rn(a, b), bb = __fsub_rn(s, a);
  err = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
  return s;
}

__device__ __forceinline__ void carry(float& g, float& gl, float q, float a,
                                      float b) {
  const float p = __fmul_rn(q, g), ep = fmaf(q, g, -p);
  float ed, es;
  const float d = two_sum(a, b, ed);
  const float s = two_sum(p, d, es);
  const float lo = fmaf(q, gl, __fadd_rn(ep, __fadd_rn(ed, es)));
  g = __fadd_rn(s, lo);
  gl = __fsub_rn(lo, __fsub_rn(g, s));
}

// mma.sync m16n8k8 TF32: d (16 x 8, fp32) += A (16 x 8) B (8 x 8); a0..a3
// at rows g, g + 8, g, g + 8 and columns c, c, c + 4, c + 4 (g = lane / 4,
// c = lane % 4), b0, b1 at rows c, c + 4 and column g, d0..d3 at rows g,
// g, g + 8, g + 8 and columns 2c, 2c + 1, 2c, 2c + 1
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = A B (no accumulator)
__device__ __forceinline__ void mma0(float (&d)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// A k-step of a 3xTF32 product: the small terms hi.lo and lo.hi summed on
// the tensor cores into x, the hi.hi product taken on its own and added to
// tot in fp32.  The tensor cores round each sum toward zero, so a running
// sum that every product passes through drifts toward zero by about half an
// ulp a product: K = 128 summed that way came to ~5.7x the RMS error of
// fp32 FMAs (N(0, 1) operands, emulated), this way to ~0.6x
__device__ __forceinline__ void mma3(float (&tot)[4], float (&x)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  float hh[4];
  mma(x, ah, bl0, bl1);
  mma(x, al, bh0, bh1);
  mma0(hh, ah, bh0, bh1);
#pragma unroll
  for (int r = 0; r < 4; ++r) tot[r] += hh[r];
}

// an A fragment (rows r, r + 8; columns k, k + 4) of a raw tile, split
__device__ __forceinline__ void frag_a(const float* t, int len, int r, int k,
                                       uint32_t (&h)[4], uint32_t (&l)[4]) {
  split(t[raw(r, k, len)], h[0], l[0]);
  split(t[raw(r + 8, k, len)], h[1], l[1]);
  split(t[raw(r, k + 4, len)], h[2], l[2]);
  split(t[raw(r + 8, k + 4, len)], h[3], l[3]);
}

// the same from the transposed tile: element (row, col) at t[col][row]
__device__ __forceinline__ void frag_at(const float* t, int len, int r, int k,
                                        uint32_t (&h)[4], uint32_t (&l)[4]) {
  split(t[raw(k, r, len)], h[0], l[0]);
  split(t[raw(k, r + 8, len)], h[1], l[1]);
  split(t[raw(k + 4, r, len)], h[2], l[2]);
  split(t[raw(k + 4, r + 8, len)], h[3], l[3]);
}

// B (s x k) and C^T (k x t) of the Gram tiles: byte offsets of element
// (s, k) and (k, t), k < 64
__device__ __forceinline__ int b_off(int s, int k) {
  const int kp = perm8(k);
  return (kp >> 5) * 4096 + swz(s, kp & 31);
}

__device__ __forceinline__ float tile_val(const unsigned char* st, int hi,
                                          int lo, int off) {
  return *reinterpret_cast<const float*>(st + hi + off) +
         *reinterpret_cast<const float*>(st + lo + off);
}

__device__ __forceinline__ uint32_t tile_bits(const unsigned char* st, int o) {
  return *reinterpret_cast<const uint32_t*>(st + o);
}

struct Args {
  const float* xdt;
  const float* a_log;
  const float* dy;
  const float* states;           // (B, H, nc - 1, dh, n)
  const float* gram;             // B.C^T (B, nc, 32, 32)
  const unsigned char* gtiles;   // the Gram tiles (B, nc, 4 tiles)
  float* dx;                     // dxdt, or the partials (slices, B,S,H,dh)
  int64_t dx_slice;              // floats between two slices' partials
  float* dBp;                    // (H tiles, B, S, n): per (head, row tile)
  float* dCp;
  float* da;                     // da_log, or (B, S, H, tiles slices)
  int S, H, dh, n, nc, tiles, slices, kNg;
  bool vec_x, vec_dy, vec_h;
};

// ---- the producers ----------------------------------------------------------
// chunk c's stage loads: the Gram tiles of the block's columns, B.C^T into
// the L^T slot, X, dY, a_log
__device__ __forceinline__ void load_stage(const Args& a, unsigned char* st,
                                           int b, int h, int c, int d0,
                                           int ks, int pt) {
  const int c0 = c * kQ, q = min(kQ, a.S - c0);
  const int64_t nc = a.nc;
  const float* g = a.gram + (static_cast<int64_t>(b) * nc + c) * kQ * kQ;
  const unsigned char* pc =
      a.gtiles + (static_cast<int64_t>(b) * nc + c) * 4 * tile_bytes(a.kNg) +
      ks * 8192;
  // B hi, B lo, C^T hi, C^T lo: 8192 bytes each
  for (int i = pt; i < 4 * 512; i += kProducerThreads) {
    const int tl = i >> 9, o = (i & 511) << 4;
    cp_async16(st + tl * 8192 + o, pc + tl * tile_bytes(a.kNg) + o, 16);
  }
  load_raw(reinterpret_cast<float*>(st + Smem::kL), kQ, kQ, g, kQ, kQ, kQ,
           true, pt);
  const int64_t step = static_cast<int64_t>(a.H) * a.dh;
  const int64_t base = (static_cast<int64_t>(b) * a.S + c0) * step + h * a.dh + d0;
  load_raw(reinterpret_cast<float*>(st + Smem::kX), kQ, kRows, a.xdt + base,
           step, q, a.dh - d0, a.vec_x, pt);
  load_raw(reinterpret_cast<float*>(st + Smem::kDY), kQ, kRows, a.dy + base,
           step, q, a.dh - d0, a.vec_dy, pt);
  if (pt < kQ) {
    const float* src =
        a.a_log + (static_cast<int64_t>(b) * a.S + c0 + pt) * a.H + h;
    cp_async4(reinterpret_cast<float*>(st + Smem::kA) + pt,
              pt < q ? src : a.a_log, pt < q ? 4 : 0);
  }
}

// H0 of chunk c: zeros for the first chunk, else the states' slot c - 1
__device__ __forceinline__ void load_h0(const Args& a, float* h0, int b,
                                        int h, int c, int d0, int ks,
                                        int pt) {
  if (c == 0) {
    for (int i = pt; i < kRows * kN / 4; i += kProducerThreads)
      reinterpret_cast<float4*>(h0)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const float* src = a.states +
      ((static_cast<int64_t>(b) * a.H + h) * (a.nc - 1) + c - 1) *
          static_cast<int64_t>(a.dh) * a.n +
      static_cast<int64_t>(d0) * a.n + ks * kN;
  load_raw(h0, kRows, kN, src, a.n, a.dh - d0, a.n - ks * kN, a.vec_h, pt);
}

// the math of a chunk that has landed: cum in fp64 (lane l holds step l),
// e, dend, eq, then for every row s (lane = t): L^T in place of B.C^T, W^T
// split and swizzled
__device__ __forceinline__ void make_w(unsigned char* st, int pt) {
  const int lane = pt & 31, pw = pt >> 5;
  constexpr int kWarps = kProducerThreads / 32;
  double cum = reinterpret_cast<const float*>(st + Smem::kA)[lane];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double up = __shfl_up_sync(0xffffffffu, cum, off);
    if (lane >= off) cum += up;
  }
  const double last = __shfl_sync(0xffffffffu, cum, 31);
  if (pw == 0) {
    reinterpret_cast<float*>(st + Smem::kE)[lane] = expf(static_cast<float>(cum));
    reinterpret_cast<float*>(st + Smem::kDend)[lane] =
        expf(static_cast<float>(last - cum));
    if (lane == 0)
      *reinterpret_cast<float*>(st + Smem::kEq) = expf(static_cast<float>(last));
  }
  float* lt = reinterpret_cast<float*>(st + Smem::kL);
#pragma unroll 2
  for (int s = pw; s < kQ; s += kWarps) {
    const double cs = __shfl_sync(0xffffffffu, cum, s);
    const int o = raw(s, lane, kQ);
    const bool on = lane >= s;                  // t >= s
    const float L = on ? expf(static_cast<float>(cum - cs)) : 0.f;
    const float w = on ? L * lt[o] : 0.f;
    lt[o] = L;
    uint32_t hi, lo;
    split(w, hi, lo);
    *reinterpret_cast<uint32_t*>(st + Smem::kWh + swz(s, lane)) = hi;
    *reinterpret_cast<uint32_t*>(st + Smem::kWl + swz(s, lane)) = lo;
  }
}

// ---- the chunk kernel -------------------------------------------------------
__global__ void __launch_bounds__(kAll, 1)
scan_bwd_chunk_kernel(const Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int h = blockIdx.y, b = blockIdx.z;
  const int tile = blockIdx.x / a.slices, ks = blockIdx.x % a.slices;
  const int d0 = tile * kRows, nc = a.nc;
  float* h0s = reinterpret_cast<float*>(smem + Smem::kH0);

  if (threadIdx.x >= kConsumerThreads) {
    // ---- the producers (warps 8-11): chunk it + 1's stage and chunk it's
    // H0 are loaded once the consumers are done with chunk it - 1 (free);
    // H0 is handed over as soon as it lands, the stage once its W is made
    // ----
    hopper::regs_release<kProducerRegs>();
    const int pt = threadIdx.x - kConsumerThreads;
    load_stage(a, smem, b, h, nc - 1, d0, ks, pt);
    cp_async_commit();
    cp_async_wait<0>();
    hopper::named_barrier_sync(kBarProducers, kProducerThreads);
    make_w(smem, pt);
    hopper::fence_proxy_async();
    hopper::named_barrier_arrive(kBarFull, kAll);
    for (int it = 0; it < nc; ++it) {
      if (it >= 1) hopper::named_barrier_sync(kBarFree, kAll);
      load_h0(a, h0s, b, h, nc - 1 - it, d0, ks, pt);
      cp_async_commit();
      const int nx = it + 1;
      unsigned char* st = smem + (nx & 1) * Smem::kStage;
      if (nx < nc) load_stage(a, st, b, h, nc - 1 - nx, d0, ks, pt);
      cp_async_commit();
      cp_async_wait<1>();
      hopper::named_barrier_arrive(kBarH0Full, kAll);
      if (nx < nc) {
        cp_async_wait<0>();
        hopper::named_barrier_sync(kBarProducers, kProducerThreads);
        make_w(st, pt);
        hopper::fence_proxy_async();
        hopper::named_barrier_arrive(kBarFull + (nx & 1), kAll);
      }
    }
    cp_async_wait<0>();
    return;
  }

  // ---- consumers: warp w (0..7) owns head-dim rows 16 w .. 16 w + 15 of
  // the wgmma products (warpgroup w / 4 rows 64 (w / 4) ..) ----
  hopper::regs_claim<kConsumerRegs>();
  const int ct = threadIdx.x;
  const int lane = ct & 31, warp = ct >> 5;
  const int gid = lane >> 2, cid = lane & 3;
  const int r0 = 16 * warp;
  float* gs = reinterpret_cast<float*>(smem + Smem::kG);
  float* lms = reinterpret_cast<float*>(smem + Smem::kLM);
  double* colp = reinterpret_cast<double*>(smem + Smem::kCol);
  double* rowp = reinterpret_cast<double*>(smem + Smem::kRow);
  float* qp = reinterpret_cast<float*>(smem + Smem::kQp);
  float* pp = reinterpret_cast<float*>(smem + Smem::kPp);
  double* red = reinterpret_cast<double*>(smem + Smem::kRed);
  const int64_t step = static_cast<int64_t>(a.H) * a.dh;
  const int P = a.H * a.tiles, p = h * a.tiles + tile;
  const int parts = a.tiles * a.slices, part = tile * a.slices + ks;
  const int kcol = ks * kN;                     // the block's first column

  for (int i = ct; i < kRows * kN; i += kConsumerThreads) gs[i] = 0.f;

  // G: rows r0 + gid (+8), columns 8j + 2cid + {0, 1}
  // G is carried as an unevaluated sum G + Gl of two floats (carry()),
  // whose rounding is ~2^-48 of G: an fp32 carry rounds G once a chunk, and
  // with no decay those roundings, not the chunk products', are most of G's
  // error (as of the plain backward's), which <G, H0> (most of da there)
  // and dX inherit
  float G[8][4], Gl[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) G[j][r] = Gl[j][r] = 0.f;

  for (int it = 0; it < nc; ++it) {
    const int c = nc - 1 - it, s = it & 1, c0 = c * kQ;
    const unsigned char* st = smem + s * Smem::kStage;
    const float* xs = reinterpret_cast<const float*>(st + Smem::kX);
    const float* dys = reinterpret_cast<const float*>(st + Smem::kDY);
    const float* lts = reinterpret_cast<const float*>(st + Smem::kL);
    double* cols = colp + s * 2 * kQ;
    double* rows = rowp + s * 4 * kQ;
    const float* e = reinterpret_cast<const float*>(st + Smem::kE);
    const float* dend = reinterpret_cast<const float*>(st + Smem::kDend);
    const uint32_t sa = hopper::smem_addr(st);
    hopper::named_barrier_sync(kBarFull + s, kAll);
    const float eq = *reinterpret_cast<const float*>(st + Smem::kEq);

    // ---- dX^T = dY^T.W + (G.B^T) diag(dend), on wgmma.  Each 3xTF32
    // product sums its hi.lo and lo.hi terms first and its hi.hi terms
    // into two accumulators by turns, added in fp32 (see mma3) ----
    float accw[16], accg[16];
    {
      // dY^T as A: k-step kq is steps 8 kq + cid (+4) of rows r0 + gid (+8)
      uint32_t yh[kQ / 8][4], yl[kQ / 8][4];
#pragma unroll
      for (int kq = 0; kq < kQ / 8; ++kq) {
        const int t = 8 * kq + cid, d = r0 + gid;
        split(dys[raw(t, d, kRows)], yh[kq][0], yl[kq][0]);
        split(dys[raw(t, d + 8, kRows)], yh[kq][1], yl[kq][1]);
        split(dys[raw(t + 4, d, kRows)], yh[kq][2], yl[kq][2]);
        split(dys[raw(t + 4, d + 8, kRows)], yh[kq][3], yl[kq][3]);
      }
      float acc1[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) accw[i] = acc1[i] = 0.f;
      if (ks == 0) {        // dY^T.W sums over t only: the first slice's
        hopper::fence_regs(accw);
        hopper::fence_regs(acc1);
        hopper::wgmma_fence();
#pragma unroll
        for (int kq = 0; kq < kQ / 8; ++kq) {
          wgmma_n32(accw, yl[kq], kdesc(sa + Smem::kWh + 32 * kq));
          wgmma_n32(accw, yh[kq], kdesc(sa + Smem::kWl + 32 * kq));
        }
#pragma unroll
        for (int kq = 0; kq < kQ / 8; ++kq) {
          const uint64_t w = kdesc(sa + Smem::kWh + 32 * kq);
          if (kq & 1)
            wgmma_n32(acc1, yh[kq], w);
          else
            wgmma_n32(accw, yh[kq], w);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int kq = 0; kq < kQ / 8; ++kq) {
          hopper::fence_regs(yh[kq]);
          hopper::fence_regs(yl[kq]);
        }
        hopper::fence_regs(accw);
        hopper::fence_regs(acc1);
#pragma unroll
        for (int i = 0; i < 16; ++i) accw[i] += acc1[i];
      }
    }
    {
      // G.B^T: G's column pair (2c, 2c + 1) read as the k slots (c, c + 4)
      uint32_t ah[8][4], al[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        split(G[j][0], ah[j][0], al[j][0]);
        split(G[j][2], ah[j][1], al[j][1]);
        split(G[j][1], ah[j][2], al[j][2]);
        split(G[j][3], ah[j][3], al[j][3]);
      }
      float acc1[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) accg[i] = acc1[i] = 0.f;
      hopper::fence_regs(accg);
      hopper::fence_regs(acc1);
      hopper::wgmma_fence();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t off = (j >> 2) * 4096 + 32 * (j & 3);
        wgmma_n32(accg, al[j], kdesc(sa + Smem::kBh + off));
        wgmma_n32(accg, ah[j], kdesc(sa + Smem::kBl + off));
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t off = (j >> 2) * 4096 + 32 * (j & 3);
        if (j & 1)
          wgmma_n32(acc1, ah[j], kdesc(sa + Smem::kBh + off));
        else
          wgmma_n32(accg, ah[j], kdesc(sa + Smem::kBh + off));
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        hopper::fence_regs(ah[j]);
        hopper::fence_regs(al[j]);
      }
      hopper::fence_regs(accg);
      hopper::fence_regs(acc1);
#pragma unroll
      for (int i = 0; i < 16; ++i) accg[i] += acc1[i];
    }
    {
      const int q = min(kQ, a.S - c0);
      const int da = d0 + r0 + gid, db = da + 8;
      float* xb = a.dx + ks * a.dx_slice +
                  static_cast<int64_t>(b) * a.S * step + h * a.dh;
#pragma unroll
      for (int nt = 0; nt < kQ / 8; ++nt) {
        const int t = 8 * nt + 2 * cid;
        const float e0 = dend[t], e1 = dend[t + 1];
        float* xt = xb + static_cast<int64_t>(c0 + t) * step;
        if (t < q) {
          if (da < a.dh) __stcs(xt + da, fmaf(accg[4 * nt], e0, accw[4 * nt]));
          if (db < a.dh)
            __stcs(xt + db, fmaf(accg[4 * nt + 2], e0, accw[4 * nt + 2]));
        }
        if (t + 1 < q) {
          if (da < a.dh)
            __stcs(xt + step + da, fmaf(accg[4 * nt + 1], e1, accw[4 * nt + 1]));
          if (db < a.dh)
            __stcs(xt + step + db, fmaf(accg[4 * nt + 3], e1, accw[4 * nt + 3]));
        }
      }
    }

    // ---- G <- eq G + (diag(e) dY)^T.C, the sum on wgmma, the carry in
    // fp32 ----
    {
      uint32_t eh[kQ / 8][4], el[kQ / 8][4];
#pragma unroll
      for (int kq = 0; kq < kQ / 8; ++kq) {
        const int t = 8 * kq + cid, d = r0 + gid;
        const float e0 = e[t], e1 = e[t + 4];
        split(e0 * dys[raw(t, d, kRows)], eh[kq][0], el[kq][0]);
        split(e0 * dys[raw(t, d + 8, kRows)], eh[kq][1], el[kq][1]);
        split(e1 * dys[raw(t + 4, d, kRows)], eh[kq][2], el[kq][2]);
        split(e1 * dys[raw(t + 4, d + 8, kRows)], eh[kq][3], el[kq][3]);
      }
      float dG[8][4], dG1[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) dG[j][r] = dG1[j][r] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        hopper::fence_regs(dG[j]);
        hopper::fence_regs(dG1[j]);
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int kq = 0; kq < kQ / 8; ++kq) {
        wgmma_n64(&dG[0][0], el[kq], kdesc(sa + Smem::kCh + 32 * kq));
        wgmma_n64(&dG[0][0], eh[kq], kdesc(sa + Smem::kCl + 32 * kq));
      }
#pragma unroll
      for (int kq = 0; kq < kQ / 8; ++kq)
        wgmma_n64(kq & 1 ? &dG1[0][0] : &dG[0][0], eh[kq],
                  kdesc(sa + Smem::kCh + 32 * kq));   // kq is a constant
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int kq = 0; kq < kQ / 8; ++kq) {
        hopper::fence_regs(eh[kq]);
        hopper::fence_regs(el[kq]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        hopper::fence_regs(dG[j]);
        hopper::fence_regs(dG1[j]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          carry(G[j][r], Gl[j][r], eq, dG[j][r], dG1[j][r]);
      }
    }

    // ---- M = dY.X^T (t x s, over all 128 rows d) on mma.sync, a 16 x 8
    // tile a warp; then L o M (t x s) and, of P = W o M's strictly lower
    // triangle, the warp's column and row sums in fp64 ----
    {
      const int ti = 16 * (warp >> 2), sj = 8 * (warp & 3);
      float m[4] = {0.f, 0.f, 0.f, 0.f}, mx[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int kk = 0; kk < kRows / 8; ++kk) {
        const int d = 8 * kk + cid;
        uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
        frag_a(dys, kRows, ti + gid, d, ah, al);
        split(xs[raw(sj + gid, d, kRows)], bh0, bl0);
        split(xs[raw(sj + gid, d + 4, kRows)], bh1, bl1);
        mma3(m, mx, ah, al, bh0, bh1, bl0, bl1);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) m[r] += mx[r];
      double pv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = ti + gid + (r >= 2 ? 8 : 0), sc = sj + 2 * cid + (r & 1);
        const float w = tile_val(st, Smem::kWh, Smem::kWl, swz(sc, t));
        lms[raw(t, sc, kQ)] = lts[raw(sc, t, kQ)] * m[r];
        pv[r] = t > sc ? static_cast<double>(w * m[r]) : 0.0;
      }
      if (ks == 0) {        // the pair sums of da: the first slice's
        double c0s = pv[0] + pv[2], c1s = pv[1] + pv[3];   // columns
        double r0s = pv[0] + pv[1], r1s = pv[2] + pv[3];   // rows
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          c0s += __shfl_xor_sync(0xffffffffu, c0s, o);
          c1s += __shfl_xor_sync(0xffffffffu, c1s, o);
        }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          r0s += __shfl_xor_sync(0xffffffffu, r0s, o);
          r1s += __shfl_xor_sync(0xffffffffu, r1s, o);
        }
        if (gid == 0) {
          cols[(ti >> 4) * kQ + sj + 2 * cid] = c0s;
          cols[(ti >> 4) * kQ + sj + 2 * cid + 1] = c1s;
        }
        if (cid == 0) {
          rows[(warp & 3) * kQ + ti + gid] = r0s;
          rows[(warp & 3) * kQ + ti + gid + 8] = r1s;
        }
      }
    }
    hopper::named_barrier_sync(kBarConsumers, kConsumerThreads);
    hopper::named_barrier_sync(kBarH0Full, kAll);

    // ---- dB (warpgroup 0) and dC (warpgroup 1) on mma.sync: warp w's 16
    // rows (s or t) 16 (w / 2 % 2) .. and 32 columns 32 (w % 2) .. ----
    {
      const bool isb = warp < 4;
      const int ri = 16 * ((warp >> 1) & 1), nh = 32 * (warp & 1);
      const float* av = isb ? xs : dys;             // X (s x d) or dY (t x d)
      const float* bv = isb ? gs : h0s;             // G or H0 (d x k)
      float accd[4][4], accl[4][4], xd[4][4], xl[4][4];
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          accd[jn][r] = accl[jn][r] = xd[jn][r] = xl[jn][r] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < kRows / 8; ++kk) {
        const int d = 8 * kk + cid;
        uint32_t ah[4], al[4];
        frag_a(av, kRows, ri + gid, d, ah, al);
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) {
          const int k = nh + 8 * jn + gid;
          uint32_t bh0, bl0, bh1, bl1;
          split(bv[raw(d, k, kN)], bh0, bl0);
          split(bv[raw(d + 4, k, kN)], bh1, bl1);
          mma3(accd[jn], xd[jn], ah, al, bh0, bh1, bl0, bl1);
        }
      }
      // (L o M)^T.C for dB, (L o M).B for dC: the tiles' own hi and lo
#pragma unroll
      for (int kk = 0; kk < kQ / 8; ++kk) {
        const int u = 8 * kk + cid;
        uint32_t ah[4], al[4];
        if (isb)
          frag_at(lms, kQ, ri + gid, u, ah, al);
        else
          frag_a(lms, kQ, ri + gid, u, ah, al);
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) {
          const int k = nh + 8 * jn + gid;
          const int o0 = isb ? swz(k, u) : b_off(u, k);
          const int o1 = isb ? swz(k, u + 4) : b_off(u + 4, k);
          const int hi = isb ? Smem::kCh : Smem::kBh;
          const int lo = isb ? Smem::kCl : Smem::kBl;
          mma3(accl[jn], xl[jn], ah, al, tile_bits(st, hi + o0),
               tile_bits(st, hi + o1), tile_bits(st, lo + o0),
               tile_bits(st, lo + o1));
        }
      }
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          accd[jn][r] += xd[jn][r];
          accl[jn][r] += xl[jn][r];
        }
      // dB_s = dend_s (X.G)_s + ..., p_s = dend_s <B_s, (X.G)_s>; dC_t =
      // e_t (dY.H0)_t + ..., q_t = e_t <C_t, (dY.H0)_t>
      const float* sc = isb ? dend : e;
      float* part = isb ? a.dBp : a.dCp;
      float* sums = isb ? pp : qp;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = ri + gid + 8 * hr, gr = c0 + row;
        const float f = sc[row];
        float dot = 0.f;
        float* out =
            part + ((static_cast<int64_t>(p) * gridDim.z + b) * a.S + gr) * a.n;
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) {
          const int k = nh + 8 * jn + 2 * cid;
          float v[2];
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            v[e1] = f * accd[jn][2 * hr + e1];
            const float w =
                isb ? tile_val(st, Smem::kBh, Smem::kBl, b_off(row, k + e1))
                    : tile_val(st, Smem::kCh, Smem::kCl, swz(k + e1, row));
            dot = fmaf(w, v[e1], dot);
            v[e1] += accl[jn][2 * hr + e1];
          }
          if (gr < a.S && kcol + k < a.n) {
            if (a.n % 2 == 0)           // k even: an aligned pair
              *reinterpret_cast<float2*>(out + kcol + k) = make_float2(v[0], v[1]);
            else {
              out[kcol + k] = v[0];
              if (kcol + k + 1 < a.n) out[kcol + k + 1] = v[1];
            }
          }
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        if (cid == 0) sums[(warp & 1) * kQ + row] = dot;
      }
      // <G, H0> over the thread's positions of G (the chunk-end G, as
      // written to shared memory), in fp64: with no decay this term is
      // most of da (~0.98 of |da| at S=4096) and its fp32 sums were the
      // largest part of da's error
      double gh = 0.0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int o = raw(r0 + gid + 8 * hr, 8 * j + 2 * cid, kN);
          const float2 gv = *reinterpret_cast<const float2*>(gs + o);
          const float2 hv = *reinterpret_cast<const float2*>(h0s + o);
          gh = __fma_rn(static_cast<double>(gv.x), static_cast<double>(hv.x),
                        __fma_rn(static_cast<double>(gv.y),
                                 static_cast<double>(hv.y), gh));
        }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) gh += __shfl_xor_sync(0xffffffffu, gh, o);
      if (lane == 0) red[warp] = gh;
    }
    hopper::named_barrier_sync(kBarConsumers, kConsumerThreads);
    // the stage and H0 are read: the producer may load the next ones
    if (it + 1 < nc) hopper::named_barrier_arrive(kBarFree, kAll);

    // ---- da_t in fp64, one lane a step ----
    if (warp == 0) {
      const int t = lane;
      double pairs = 0.0;
      if (ks == 0) {        // sum_{v<t} (colsum_v - rowsum_v)
        const double dv = (cols[t] + cols[kQ + t]) -
                          (((rows[t] + rows[kQ + t]) + rows[2 * kQ + t]) +
                           rows[3 * kQ + t]);
        pairs = warp_prefix(dv, lane) - dv;
      }
      const double qv = static_cast<double>(qp[t]) + qp[kQ + t];
      const double pv = static_cast<double>(pp[t]) + pp[kQ + t];
      double base = 0.0;
#pragma unroll
      for (int w = 0; w < 8; ++w) base += red[w];
      const double v = pairs + warp_suffix(qv, lane) +
                       (warp_prefix(pv, lane) - pv) +
                       static_cast<double>(eq) * base;
      if (c0 + t < a.S)
        a.da[(static_cast<int64_t>(b) * a.S + c0 + t) * a.H * parts +
             h * parts + part] = static_cast<float>(v);
    }

    // G at the end of the next chunk into shared memory
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<float2*>(gs + raw(r0 + gid + 8 * hr, 8 * j + 2 * cid,
                                            kN)) =
            make_float2(G[j][2 * hr], G[j][2 * hr + 1]);
  }
}

// ---- B.C^T and the B, C^T tiles: the forward's Gram kernel, B and C
// swapped ----------------------------------------------------------------------
__global__ void __launch_bounds__(scan::kGramThreads)
scan_bwd_gram_kernel(const float* __restrict__ Bm,
                     const float* __restrict__ Cm, float* __restrict__ G,
                     unsigned char* __restrict__ P, int S, int n, int kN) {
  scan::gram(Cm, Bm, G, P, S, n, kN);
}

// ---- the sums over (head, row tile) and slices -----------------------------
constexpr int kReduceThreads = 256;

__global__ void __launch_bounds__(kReduceThreads)
scan_bwd_reduce_kernel(const float* __restrict__ dBp,
                       const float* __restrict__ dCp,
                       const float* __restrict__ dap,
                       const float* __restrict__ dxp, float* __restrict__ dB,
                       float* __restrict__ dC, float* __restrict__ da,
                       float* __restrict__ dx, int64_t rows, int64_t nda,
                       int64_t ndx, int P, int n, int parts, int slices) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kReduceThreads +
                    threadIdx.x;
  const int64_t nbc = rows * n;
  if (i < nbc) {
    float sb = 0.f, sc = 0.f;
    for (int q = 0; q < P; ++q) {
      sb += dBp[q * nbc + i];
      sc += dCp[q * nbc + i];
    }
    dB[i] = sb;
    dC[i] = sc;
  } else if (i < nbc + nda) {
    const int64_t j = i - nbc;
    float s = 0.f;
    for (int q = 0; q < parts; ++q) s += dap[j * parts + q];
    da[j] = s;
  } else if (i < nbc + nda + ndx) {
    const int64_t j = i - nbc - nda;
    float s = 0.f;
    for (int q = 0; q < slices; ++q) s += dxp[q * ndx + j];
    dx[j] = s;
  }
}

}  // namespace

extern "C" {

int selective_scan_bwd_f32(const void* xdt, const void* a_log, const void* Bm,
                           const void* Cm, const void* dy, const void* states,
                           void* work, void* dxdt, void* da_log, void* dB,
                           void* dC, int64_t B, int64_t S, int64_t H,
                           int64_t dh, int64_t n, int64_t work_floats,
                           void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n < 1 || n > kMaxN || B < 1 || S < 1 || H < 1 || dh < 1 ||
      B > 65535 || H > 65535 || S > (int64_t{1} << 30))
    return cudaErrorInvalidValue;
  const int64_t nc = (S + kQ - 1) / kQ;
  const int tiles = static_cast<int>((dh + kRows - 1) / kRows);
  const int slices = static_cast<int>((n + kN - 1) / kN);
  const int parts = tiles * slices;
  const int kNg = n <= 64 ? 64 : 128;
  // the sums' grid: one thread per element of dB, dC, and of da_log and
  // dxdt where they have partials
  const int64_t nda = parts > 1 ? B * S * H : 0;
  const int64_t ndx = slices > 1 ? B * S * H * dh : 0;
  const int64_t blocks = (B * S * n + nda + ndx + kReduceThreads - 1) /
                         kReduceThreads;
  if (blocks > 0x7fffffff || tiles * slices > 65535)
    return cudaErrorInvalidValue;
  // the workspace: the Gram kernel's, partial dB, dC, da_log, dxdt
  const int64_t n_gram = scan::gram_floats(B, S, kNg);
  const int64_t n_bc = B * S * H * tiles * n;
  if (work_floats < n_gram + 2 * n_bc + nda * parts + ndx * slices ||
      (nc > 1 && states == nullptr))
    return cudaErrorInvalidValue;
  float* gram = static_cast<float*>(work);
  float* dBp = gram + n_gram;
  float* dCp = dBp + n_bc;
  float* dap = dCp + n_bc;
  float* dxp = dap + nda * parts;
  const float* st = static_cast<const float*>(states);
  const size_t gsmem = scan::gram_smem(static_cast<int>(n));
  cudaError_t cerr = cudaFuncSetAttribute(
      scan_bwd_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(gsmem));
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  scan_bwd_gram_kernel<<<dim3(static_cast<unsigned>(nc),
                              static_cast<unsigned>(B)),
                         scan::kGramThreads, gsmem, stream>>>(
      static_cast<const float*>(Bm), static_cast<const float*>(Cm), gram,
      reinterpret_cast<unsigned char*>(gram + B * nc * kQ * kQ),
      static_cast<int>(S), static_cast<int>(n), kNg);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return static_cast<int>(cerr);

  Args a;
  a.xdt = static_cast<const float*>(xdt);
  a.a_log = static_cast<const float*>(a_log);
  a.dy = static_cast<const float*>(dy);
  a.states = st;
  a.gram = gram;
  a.gtiles = reinterpret_cast<const unsigned char*>(gram + B * nc * kQ * kQ);
  a.dx = slices > 1 ? dxp : static_cast<float*>(dxdt);
  a.dx_slice = ndx;
  a.dBp = dBp;
  a.dCp = dCp;
  a.da = parts > 1 ? dap : static_cast<float*>(da_log);
  a.S = static_cast<int>(S);
  a.H = static_cast<int>(H);
  a.dh = static_cast<int>(dh);
  a.n = static_cast<int>(n);
  a.nc = static_cast<int>(nc);
  a.tiles = tiles;
  a.slices = slices;
  a.kNg = kNg;
  a.vec_x = dh % 4 == 0 && reinterpret_cast<uintptr_t>(xdt) % 16 == 0;
  a.vec_dy = dh % 4 == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  a.vec_h = n % 4 == 0 && reinterpret_cast<uintptr_t>(st) % 16 == 0;
  cerr = cudaFuncSetAttribute(
      scan_bwd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Smem::kBytes));
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  scan_bwd_chunk_kernel<<<dim3(static_cast<unsigned>(tiles * slices),
                               static_cast<unsigned>(H),
                               static_cast<unsigned>(B)),
                          kAll, Smem::kBytes, stream>>>(a);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  scan_bwd_reduce_kernel<<<static_cast<unsigned>(blocks), kReduceThreads, 0,
                           stream>>>(
      dBp, dCp, dap, dxp, static_cast<float*>(dB), static_cast<float*>(dC),
      static_cast<float*>(da_log), static_cast<float*>(dxdt), B * S, nda, ndx,
      static_cast<int>(H * tiles), static_cast<int>(n), parts, slices);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
