// The Mamba2 SSD selective scan for Hopper (sm_90a), fp32.
//
// selective_scan: per (batch b, head h), from a zero state,
//     h_t = exp(a_log_t) * h_{t-1} + xdt_t (x) B_t,   y_t = C_t . h_t
//   xdt (B,S,H,dh), a_log (B,S,H), B/C (B,S,n) -> y (B,S,H,dh), all fp32.
//   B and C have no head axis: every head of a batch row reads the same
//   rows (the TPU kernel's index map bh // H).
//   Replaces src/repro/kernels/selective_scan.py::selective_scan (the Pallas
//   kernel whose body is _kernel; models/ssm.py::mamba2_forward computes the
//   same function through this kernel in the port).
//   Bound: operations.  The recurrence does 4*dh*n flops per step per
//   (b, h) against (2*dh + 1)*4 bytes of x/y/a_log per step per (b, h) and
//   2*n*4 bytes of B/C per step per b, about 30 flops per byte at
//   zamba2-1.2b's shape (H=32, dh=128, n=64), above the card's ~20 fp32
//   flops per byte: the least time is flops / 67 TFLOP/s.  The chunked
//   algorithm below does about 2.5x those flops (C.B^T is recomputed per
//   block, the in-chunk product is quadratic in the chunk).
//   What the design does:
//     * one block per (32 state rows, head, batch): rows of the (dh, n)
//       state are independent (h[d, :] needs only xdt[:, d]), so dh = 128
//       gives 4 blocks per head, 512 blocks at B=4, H=32 on 132 SMs, where
//       the TPU grid has 128 (b, h) programs;
//     * the block walks S in chunks of kQ = 64 steps and keeps its (32, n)
//       state tile on chip for the whole walk (registers, mirrored in
//       shared memory for the carried term), as the TPU kernel carries it
//       in VMEM scratch along its sequential grid axis; every input byte is
//       read once per block, the output written once;
//     * per chunk: the inclusive cumsum of a_log (one warp, shuffles); the
//       in-chunk product W = (C.B^T) o L with L_ts = exp(cum_t - cum_s)
//       taken only where t >= s (above the diagonal the difference is
//       positive and may overflow); y = W.xdt + exp(cum_t) * C_t.h; then
//       h <- exp(cum_Q) h + xdt^T.(exp(cum_Q - cum) o B).  Decays are
//       always differences of cumsums, never exp(cum_t) / exp(cum_s);
//     * the cumsum and its differences are taken in fp64: within a chunk
//       cum grows to tens below zero, the absolute rounding error of an
//       fp32 cumsum becomes relative error of exp(cum_t - cum_s), and
//       terms that cancel to a small y keep it in full (at zamba2's shape
//       an fp32 cumsum came close to the 2e-4 (1 + |y|) limit against the
//       sequential recurrence; 128 doubles per chunk cost nothing);
//     * the math runs in fp32 on the FMA pipes, each thread owning a 4x4
//       micro-tile of C.B^T, 8 rows of y and n/8 state columns, with
//       odd-stride shared rows (no bank conflicts).  Tensor cores (TF32 or
//       3xTF32) and overlapping the next chunk's loads are later work;
//     * no padding in memory: a ragged last chunk loads zeros past S
//       (a_log = 0 and xdt = B = C = 0 leave the state unchanged) and
//       stores only t < S; head dims that are not a multiple of 32 mask
//       their lanes.  The TPU wrapper's padding of dh and n to 128 lanes
//       and of S to the chunk is gone.
//
// C interface (bound with ctypes): selective_scan_f32 returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a state
// size outside [1, 128] or an empty grid.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;           // steps per chunk
constexpr int kDT = 32;          // state rows (head-dim entries) per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 128;
constexpr int kMaxCols = kMaxN / kWarps;   // state columns per thread
constexpr int kRows = kQ / kWarps;         // y rows per thread
constexpr int kWStride = kQ + 1;

__host__ __device__ inline int state_stride(int n) { return n | 1; }

inline size_t smem_floats(int n) {
  const int ns = state_stride(n);
  return 4 * kQ + 2 * static_cast<size_t>(kQ) * ns + kQ * kWStride +
         kQ * kDT + kDT * ns;
}

__global__ void __launch_bounds__(kThreads, 2)   // two blocks per SM
selective_scan_kernel(const float* __restrict__ xdt,
                      const float* __restrict__ a_log,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm, float* __restrict__ y,
                      int S, int H, int dh, int n) {
  extern __shared__ __align__(16) float smem[];
  const int ns = state_stride(n);
  double* cum = reinterpret_cast<double*>(smem);   // (kQ) cumsum of a_log
  float* dec = smem + 2 * kQ;        // (kQ) exp(cum_t)
  float* dend = dec + kQ;            // (kQ) exp(cum_Q - cum_s)
  float* Bs = dend + kQ;             // (kQ, ns)
  float* Cs = Bs + kQ * ns;          // (kQ, ns)
  float* Ws = Cs + kQ * ns;          // (kQ, kWStride)
  float* Xs = Ws + kQ * kWStride;    // (kQ, kDT)
  float* Hs = Xs + kQ * kDT;         // (kDT, ns) the state tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.y, b = blockIdx.z;
  const int d = blockIdx.x * kDT + lane;
  const bool d_ok = d < dh;
  const int64_t step = static_cast<int64_t>(H) * dh;       // one time step
  const int64_t xoff = static_cast<int64_t>(b) * S * step +
                       static_cast<int64_t>(h) * dh + d;
  const float* xb = xdt + xoff;
  float* yb = y + xoff;
  const float* ab = a_log + static_cast<int64_t>(b) * S * H + h;
  const float* Bb = Bm + static_cast<int64_t>(b) * S * n;
  const float* Cb = Cm + static_cast<int64_t>(b) * S * n;
  const int ty = tid >> 4, tx = tid & 15;      // the C.B^T micro-tile

  float hreg[kMaxCols];                        // h[d, warp + kWarps * j]
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) hreg[j] = 0.f;
  for (int i = tid; i < kDT * ns; i += kThreads) Hs[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += kQ) {
    const int q = min(kQ, S - c0);             // valid steps in the chunk
    // ---- loads, zeros past S ----
    for (int i = tid; i < kQ * n; i += kThreads) {
      const int s = i / n, k = i - s * n;
      const bool ok = s < q;
      const int64_t g = static_cast<int64_t>(c0) * n + i;
      Bs[s * ns + k] = ok ? Bb[g] : 0.f;
      Cs[s * ns + k] = ok ? Cb[g] : 0.f;
    }
    for (int s = warp; s < kQ; s += kWarps)
      Xs[s * kDT + lane] =
          (s < q && d_ok) ? xb[static_cast<int64_t>(c0 + s) * step] : 0.f;
    if (warp == 0) {
      // inclusive cumsum over the chunk: lane l holds steps 2l and 2l+1
      const int s0 = 2 * lane;
      const double a0 = s0 < q ? ab[static_cast<int64_t>(c0 + s0) * H] : 0.0;
      const double a1 =
          s0 + 1 < q ? ab[static_cast<int64_t>(c0 + s0 + 1) * H] : 0.0;
      double incl = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double t = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += t;
      }
      double excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.0;
      const double c_0 = excl + a0, c_1 = c_0 + a1;
      const double last = __shfl_sync(0xffffffffu, c_1, 31);
      cum[s0] = c_0;
      cum[s0 + 1] = c_1;
      dec[s0] = expf(static_cast<float>(c_0));
      dec[s0 + 1] = expf(static_cast<float>(c_1));
      dend[s0] = expf(static_cast<float>(last - c_0));
      dend[s0 + 1] = expf(static_cast<float>(last - c_1));
    }
    __syncthreads();

    // ---- W = (C.B^T) o L, masked before the exponential ----
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int k = 0; k < n; ++k) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * ns + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * ns + k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = tx + 16 * j;
          Ws[t * kWStride + s] =
              t >= s ? acc[i][j] * expf(static_cast<float>(cum[t] - cum[s]))
                     : 0.f;
        }
      }
    }
    __syncthreads();

    // ---- y_t = sum_s W_ts xdt_s + exp(cum_t) C_t . h, rows warp + 8i ----
    {
      float yacc[kRows], cacc[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) yacc[i] = cacc[i] = 0.f;
      for (int s = 0; s < kQ; ++s) {
        const float xv = Xs[s * kDT + lane];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          yacc[i] = fmaf(Ws[(warp + kWarps * i) * kWStride + s], xv, yacc[i]);
      }
      for (int k = 0; k < n; ++k) {
        const float hv = Hs[lane * ns + k];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          cacc[i] = fmaf(Cs[(warp + kWarps * i) * ns + k], hv, cacc[i]);
      }
      if (d_ok) {
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int t = warp + kWarps * i;
          if (t < q)
            yb[static_cast<int64_t>(c0 + t) * step] = yacc[i] + dec[t] * cacc[i];
        }
      }
    }
    __syncthreads();            // every read of the old state is done

    // ---- h <- exp(cum_Q) h + sum_s exp(cum_Q - cum_s) xdt_s (x) B_s ----
    {
      const float dq = dec[kQ - 1];
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j) hreg[j] *= dq;
      for (int s = 0; s < q; ++s) {
        const float xv = Xs[s * kDT + lane] * dend[s];
#pragma unroll
        for (int j = 0; j < kMaxCols; ++j) {
          const int k = warp + kWarps * j;
          if (k < n) hreg[j] = fmaf(xv, Bs[s * ns + k], hreg[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j) {
        const int k = warp + kWarps * j;
        if (k < n) Hs[lane * ns + k] = hreg[j];
      }
    }
    __syncthreads();            // the state tile is whole; tiles are free
  }
}

}  // namespace

extern "C" {

int selective_scan_f32(const void* xdt, const void* a_log, const void* Bm,
                       const void* Cm, void* y, int64_t B, int64_t S,
                       int64_t H, int64_t dh, int64_t n, void* streamv) {
  if (B <= 0 || S <= 0 || H <= 0 || dh <= 0 || n < 1 || n > kMaxN ||
      B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * smem_floats(static_cast<int>(n));
  cudaError_t err = cudaFuncSetAttribute(
      selective_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((dh + kDT - 1) / kDT),
                  static_cast<unsigned>(H), static_cast<unsigned>(B));
  selective_scan_kernel<<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(streamv)>>>(
      static_cast<const float*>(xdt), static_cast<const float*>(a_log),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<float*>(y), static_cast<int>(S), static_cast<int>(H),
      static_cast<int>(dh), static_cast<int>(n));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
