// The gradient of the Mamba2 SSD selective scan for Hopper (sm_90a), fp32.
//
// selective_scan_bwd: given the forward's inputs xdt (B,S,H,dh), a_log
// (B,S,H), B/C (B,S,n) (zero initial state) and dy (B,S,H,dh), writes
// dxdt (B,S,H,dh), da_log (B,S,H) and dB, dC (B,S,n), the last two summed
// over the heads.
//   Replaces the gradient of src/repro/kernels/selective_scan.py::
//   selective_scan (the Pallas kernel has no backward; the JAX package
//   differentiates its chunked jnp scan, repro/models/ssm.py::_ssd_chunked).
//   Bound: operations (the sequential backward's 10 dh n flops a step and
//   head at the fp32 rate) over bytes (xdt, dy read and dxdt written once).
//
// By chunks of kQ = 32 steps (cum the in-chunk cumsum of a_log in fp64,
// L_ts = exp(cum_t - cum_s) for t >= s, e_t = exp(cum_t), dend_s =
// exp(cum_Q - cum_s)), with H0 the state at the chunk's start, G the
// gradient of the state at its end, M_ts = dy_t . x_s and
// P = L o C.B^T o M:
//   dX = (L o C.B^T)^T.dY + diag(dend).B.G^T
//   dB = sum_h (L o M)^T.C + diag(dend).X.G
//   dC = sum_h (L o M).B + diag(e).dY.H0
//   da_t = sum_{t'>=t>s} P_t's + sum_{t'>=t} q_t' + sum_{s<t} p_s
//          + exp(cum_Q) <G, H0>,  q_t = e_t <dy_t, H0.C_t>,
//          p_s = dend_s <G.B_s, x_s>
//   G <- exp(cum_Q) G + (diag(e).dY)^T.C
// da_log_t is a_t <g_t, h_{t-1}> term by term (g the adjoint state), so no
// sum cancels: the other exact form, sum_{k>=t} (<dy_k, y_k> - <x_k,
// dx_k>), adds large terms that cancel (to an exact 0 at t = 0), and its
// fp32 rounding came to 1.2x the 2e-4 (1 + |want|) limit at zamba2's train
// shape (read on an H100).  Three kernels, in fp32 FMAs from shared
// memory (no tensor cores, no atomics):
//   * scan_bwd_states_kernel: one block per (64 head-dim rows, head,
//     batch) walks the chunks forward and writes the state at the start of
//     every chunk but the first into the workspace: B*H*tiles*(nc-1)*64*n
//     floats (at zamba2-1.2b's train shape, B=8 S=256 H=32 dh=128 n=64:
//     58.7 MB);
//   * scan_bwd_chunk_kernel: one block per (64 rows, head, batch) walks the
//     chunks in reverse with G in shared memory; writes dxdt (complete: it
//     sums over n only), and per (row tile, head) partial dB, dC and da_log
//     into the workspace: 2*B*S*H*tiles*n + B*S*H*tiles floats;
//   * scan_bwd_reduce_kernel: sums the partials over (head, row tile) in
//     that fixed order, so two runs are bitwise equal.
// Rows past S are identity steps (a_log = 0, xdt = B = C = dy = 0) and are
// not stored; head-dim rows past dh load as zeros.
//
// C interface (bound with ctypes): selective_scan_bwd_f32 launches the
// three kernels on the stream and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a state size outside [1, 128], an empty or too
// large grid, or a workspace smaller than the states and partials above.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQ = 32;         // steps per chunk
constexpr int kR = 64;         // head-dim rows per block
constexpr int kMaxN = 128;
constexpr int kThreads = 256;
constexpr int kPer = kR * kMaxN / kThreads;   // state elements per thread
constexpr int kXS = kR + 1;    // odd strides: no bank conflicts
constexpr int kWS = kQ + 1;

__device__ __forceinline__ double warp_prefix(double v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

__device__ __forceinline__ double warp_suffix(double v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_down_sync(0xffffffffu, v, o);
    if (lane + o < 32) v += u;
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the chunk's decays, by warp 0 (lane t = step t): cum (fp64), e_t,
// dend_t and exp(cum_Q) into shared memory
__device__ __forceinline__ void chunk_decays(const float* __restrict__ a_log,
                                             int b, int h, int c0, int S,
                                             int H, double* cum, float* e,
                                             float* dend, float* eq) {
  const int t = threadIdx.x;
  const float la = c0 + t < S
      ? a_log[(static_cast<int64_t>(b) * S + c0 + t) * H + h] : 0.f;
  const double ct = warp_prefix(static_cast<double>(la));
  const double cq = __shfl_sync(0xffffffffu, ct, 31);
  if (cum) cum[t] = ct;
  if (e) e[t] = expf(static_cast<float>(ct));
  dend[t] = expf(static_cast<float>(cq - ct));
  if (t == 0) *eq = expf(static_cast<float>(cq));
}

// rows [0, kQ) x [0, kR) of a (B,S,H,dh) tensor at (b, c0, h, d0) into a
// kQ x kXS tile, zeros past S and dh
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int b, int c0, int h, int d0, int S,
                                          int H, int dh) {
  for (int i = threadIdx.x; i < kQ * kR; i += kThreads) {
    const int t = i / kR, r = i % kR;
    float v = 0.f;
    if (c0 + t < S && d0 + r < dh)
      v = src[((static_cast<int64_t>(b) * S + c0 + t) * H + h) * dh + d0 + r];
    dst[t * kXS + r] = v;
  }
}

// rows [0, kQ) of a (B,S,n) tensor at (b, c0) into a kQ x (n + 1) tile
__device__ __forceinline__ void load_bc(float* dst,
                                        const float* __restrict__ src, int b,
                                        int c0, int S, int n) {
  const int ns = n + 1;
  for (int i = threadIdx.x; i < kQ * n; i += kThreads) {
    const int t = i / n, k = i % n;
    dst[t * ns + k] = c0 + t < S
        ? src[(static_cast<int64_t>(b) * S + c0 + t) * n + k] : 0.f;
  }
}

__host__ __device__ inline int64_t state_slab(int b, int h, int tile, int c,
                                              int H, int tiles, int nc,
                                              int n) {
  // the state at the start of chunk c >= 1 of (b, h, row tile)
  return (((static_cast<int64_t>(b) * H + h) * tiles + tile) * (nc - 1) +
          (c - 1)) * kR * n;
}

// ---- the states: H at the start of every chunk after the first ------------
__global__ void __launch_bounds__(kThreads)
scan_bwd_states_kernel(const float* __restrict__ xdt,
                       const float* __restrict__ a_log,
                       const float* __restrict__ Bm, float* __restrict__ states,
                       int S, int H, int dh, int n, int nc) {
  extern __shared__ __align__(16) float sm[];
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tiles = gridDim.x, d0 = tile * kR, ns = n + 1, E = kR * n;
  float* xs = sm;                      // kQ x kXS, scaled by dend
  float* Bs = xs + kQ * kXS;           // kQ x ns
  float* dend = Bs + kQ * ns;          // kQ
  float* eq = dend + kQ;               // 1
  const int tid = threadIdx.x;
  float st[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) st[j] = 0.f;
  for (int c = 0; c + 1 < nc; ++c) {
    const int c0 = c * kQ;
    load_rows(xs, xdt, b, c0, h, d0, S, H, dh);
    load_bc(Bs, Bm, b, c0, S, n);
    if (tid < 32)
      chunk_decays(a_log, b, h, c0, S, H, nullptr, nullptr, dend, eq);
    __syncthreads();
    for (int i = tid; i < kQ * kR; i += kThreads) {
      const int t = i / kR, r = i % kR;
      xs[t * kXS + r] *= dend[t];
    }
    __syncthreads();
    float* dst = states + state_slab(b, h, tile, c + 1, H, tiles, nc, n);
    const float q = *eq;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = tid + j * kThreads;
      if (e < E) {
        const int r = e / n, k = e % n;
        float acc = 0.f;
#pragma unroll 8
        for (int t = 0; t < kQ; ++t)
          acc = fmaf(xs[t * kXS + r], Bs[t * ns + k], acc);
        st[j] = fmaf(q, st[j], acc);
        dst[e] = st[j];
      }
    }
    __syncthreads();
  }
}

// ---- the reverse walk over the chunks ------------------------------------
__global__ void __launch_bounds__(kThreads)
scan_bwd_chunk_kernel(const float* __restrict__ xdt,
                      const float* __restrict__ a_log,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ dy,
                      const float* __restrict__ states,
                      float* __restrict__ dxdt, float* __restrict__ dBp,
                      float* __restrict__ dCp, float* __restrict__ dap, int S,
                      int H, int dh, int n, int nc) {
  extern __shared__ __align__(16) float sm[];
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tiles = gridDim.x, d0 = tile * kR, ns = n + 1, E = kR * n;
  const int P = H * tiles, p = h * tiles + tile;
  double* cum = reinterpret_cast<double*>(sm);   // kQ
  float* xs = sm + 2 * kQ;             // kQ x kXS each
  float* dys = xs + kQ * kXS;
  float* Bs = dys + kQ * kXS;          // kQ x ns each
  float* Cs = Bs + kQ * ns;
  float* QK = Cs + kQ * ns;            // C_t[k] (dY.H0)[t][k]
  float* PK = QK + kQ * ns;            // B_s[k] (X.G)[s][k]
  float* G = PK + kQ * ns;             // kR x ns each
  float* H0 = G + kR * ns;
  float* W = H0 + kR * ns;             // kQ x kWS each, (t, s)
  float* LM = W + kQ * kWS;
  float* PP = LM + kQ * kWS;           // P, then Z[t'][t] = sum_{s<t} P[t'][s]
  float* e = PP + kQ * kWS;            // kQ each
  float* dend = e + kQ;
  float* qq = dend + kQ;
  float* pq = qq + kQ;
  float* red = pq + kQ;                // kThreads / 32
  float* eq = red + kThreads / 32;     // 1
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < kR * ns; i += kThreads) G[i] = 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const int c0 = c * kQ;
    load_rows(xs, xdt, b, c0, h, d0, S, H, dh);
    load_rows(dys, dy, b, c0, h, d0, S, H, dh);
    load_bc(Bs, Bm, b, c0, S, n);
    load_bc(Cs, Cm, b, c0, S, n);
    if (c > 0) {
      const float* src = states + state_slab(b, h, tile, c, H, tiles, nc, n);
      for (int i = tid; i < E; i += kThreads)
        H0[(i / n) * ns + i % n] = src[i];
    } else {
      for (int i = tid; i < kR * ns; i += kThreads) H0[i] = 0.f;
    }
    if (tid < 32) chunk_decays(a_log, b, h, c0, S, H, cum, e, dend, eq);
    __syncthreads();

    // W = L o C.B^T, LM = L o M and P = W o M, zero above the diagonal;
    // the thread's share of <G, H0>
    for (int i = tid; i < kQ * kQ; i += kThreads) {
      const int t = i / kQ, s = i % kQ;
      float w = 0.f, lm = 0.f, pr = 0.f;
      if (t >= s) {
        const float L = expf(static_cast<float>(cum[t] - cum[s]));
        float cb = 0.f, m = 0.f;
        for (int k = 0; k < n; ++k)
          cb = fmaf(Cs[t * ns + k], Bs[s * ns + k], cb);
#pragma unroll 8
        for (int r = 0; r < kR; ++r)
          m = fmaf(dys[t * kXS + r], xs[s * kXS + r], m);
        w = L * cb;
        lm = L * m;
        pr = w * m;
      }
      W[t * kWS + s] = w;
      LM[t * kWS + s] = lm;
      PP[t * kWS + s] = pr;
    }
    float cp = 0.f;
    for (int i = tid; i < E; i += kThreads) {
      const int o = (i / n) * ns + i % n;
      cp = fmaf(G[o], H0[o], cp);
    }
    cp = warp_sum(cp);
    if (lane == 0) red[warp] = cp;
    __syncthreads();

    // dx (complete for these rows), partial dB and dC of this (tile, head)
    // with the products of q and p; each row of P turned into its
    // exclusive prefix sums Z, one warp a row
    for (int i = tid; i < kQ * kR; i += kThreads) {
      const int s = i / kR, r = i % kR;
      float acc = 0.f, gb = 0.f;
      for (int t = s; t < kQ; ++t)
        acc = fmaf(W[t * kWS + s], dys[t * kXS + r], acc);
      for (int k = 0; k < n; ++k) gb = fmaf(G[r * ns + k], Bs[s * ns + k], gb);
      if (c0 + s < S && d0 + r < dh)
        dxdt[((static_cast<int64_t>(b) * S + c0 + s) * H + h) * dh + d0 + r] =
            fmaf(dend[s], gb, acc);
    }
    for (int i = tid; i < kQ * n; i += kThreads) {
      const int s = i / n, k = i % n;       // s is also the dC row t
      float db = 0.f, gx = 0.f, dc = 0.f, yh = 0.f;
      for (int t = s; t < kQ; ++t)
        db = fmaf(LM[t * kWS + s], Cs[t * ns + k], db);
      for (int u = 0; u <= s; ++u)
        dc = fmaf(LM[s * kWS + u], Bs[u * ns + k], dc);
#pragma unroll 8
      for (int r = 0; r < kR; ++r) {
        gx = fmaf(G[r * ns + k], xs[s * kXS + r], gx);
        yh = fmaf(dys[s * kXS + r], H0[r * ns + k], yh);
      }
      QK[s * ns + k] = Cs[s * ns + k] * yh;
      PK[s * ns + k] = Bs[s * ns + k] * gx;
      if (c0 + s < S) {
        const int64_t o =
            ((static_cast<int64_t>(b) * S + c0 + s) * P + p) * n + k;
        dBp[o] = fmaf(dend[s], gx, db);
        dCp[o] = fmaf(e[s], yh, dc);
      }
    }
    for (int t = warp; t < kQ; t += kThreads / 32) {
      const float v = PP[t * kWS + lane];
      const double z = warp_prefix(static_cast<double>(v)) - v;
      __syncwarp();
      PP[t * kWS + lane] = lane <= t ? static_cast<float>(z) : 0.f;
    }
    __syncthreads();

    // q_t and p_s, one warp a step; G <- exp(cum_Q) G + (diag(e) dY)^T C
    for (int t = warp; t < kQ; t += kThreads / 32) {
      float vq = 0.f, vp = 0.f;
      for (int k = lane; k < n; k += 32) {
        vq += QK[t * ns + k];
        vp += PK[t * ns + k];
      }
      vq = warp_sum(vq);
      vp = warp_sum(vp);
      if (lane == 0) {
        qq[t] = e[t] * vq;
        pq[t] = dend[t] * vp;
      }
    }
    const float q = *eq;
    for (int i = tid; i < E; i += kThreads) {
      const int r = i / n, k = i % n;
      float acc = 0.f;
#pragma unroll 8
      for (int t = 0; t < kQ; ++t)
        acc = fmaf(e[t] * dys[t * kXS + r], Cs[t * ns + k], acc);
      G[r * ns + k] = fmaf(q, G[r * ns + k], acc);
    }
    __syncthreads();

    // da_t = sum_{t'>=t} Z[t'][t] + sum_{t'>=t} q_t' + sum_{s<t} p_s
    //        + exp(cum_Q) <G, H0>, in fp64, one lane a step
    if (warp == 0) {
      double pairs = 0.0, base = 0.0;
      for (int u = lane; u < kQ; ++u) pairs += PP[u * kWS + lane];
      for (int w = 0; w < kThreads / 32; ++w) base += red[w];
      const double pv = pq[lane];
      const double v = pairs + warp_suffix(static_cast<double>(qq[lane])) +
                       (warp_prefix(pv) - pv) + static_cast<double>(q) * base;
      if (c0 + lane < S)
        dap[((static_cast<int64_t>(b) * S + c0 + lane) * H + h) * tiles +
            tile] = static_cast<float>(v);
    }
    __syncthreads();
  }
}

// ---- the sums over (head, row tile) ----------------------------------------
__global__ void __launch_bounds__(kThreads)
scan_bwd_reduce_kernel(const float* __restrict__ dBp,
                       const float* __restrict__ dCp,
                       const float* __restrict__ dap, float* __restrict__ dB,
                       float* __restrict__ dC, float* __restrict__ da,
                       int64_t rows, int P, int n, int H, int tiles) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t nbc = rows * n;
  if (i < nbc) {
    const int64_t row = i / n;
    const int k = static_cast<int>(i % n);
    const float* pb = dBp + row * P * n + k;
    const float* pc = dCp + row * P * n + k;
    float sb = 0.f, sc = 0.f;
    for (int q = 0; q < P; ++q) {
      sb += pb[static_cast<int64_t>(q) * n];
      sc += pc[static_cast<int64_t>(q) * n];
    }
    dB[i] = sb;
    dC[i] = sc;
  } else if (i < nbc + rows * H) {
    const int64_t j = i - nbc;
    const float* pa = dap + j * tiles;
    float s = 0.f;
    for (int q = 0; q < tiles; ++q) s += pa[q];
    da[j] = s;
  }
}

size_t states_smem(int n) {
  return sizeof(float) * (kQ * kXS + kQ * (n + 1) + kQ + 4);
}

size_t chunk_smem(int n) {
  return sizeof(float) * (2 * kQ + 2 * kQ * kXS + 4 * kQ * (n + 1) +
                          2 * kR * (n + 1) + 3 * kQ * kWS + 4 * kQ +
                          kThreads / 32 + 4);
}

}  // namespace

extern "C" {

int selective_scan_bwd_f32(const void* xdt, const void* a_log, const void* Bm,
                           const void* Cm, const void* dy,
                           void* work, void* dxdt, void* da_log, void* dB,
                           void* dC, int64_t B, int64_t S, int64_t H,
                           int64_t dh, int64_t n, int64_t work_floats,
                           void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n < 1 || n > kMaxN || B < 1 || S < 1 || H < 1 || dh < 1 ||
      B > 65535 || H > 65535 || S > (int64_t{1} << 30))
    return cudaErrorInvalidValue;
  // the sums' grid: one thread per element of dB, dC and da_log
  const int64_t blocks = (B * S * (n + H) + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const int nc = static_cast<int>((S + kQ - 1) / kQ);
  const int tiles = static_cast<int>((dh + kR - 1) / kR);
  // the workspace: the states, then partial dB, dC and da_log
  const int64_t n_states = nc > 1 ? B * H * tiles * (nc - 1) * kR * n : 0;
  if (work_floats < n_states + B * S * H * tiles * (2 * n + 1))
    return cudaErrorInvalidValue;
  float* states = static_cast<float*>(work);
  float* dBp = states + n_states;
  float* dCp = dBp + B * S * H * tiles * n;
  float* dap = dCp + B * S * H * tiles * n;
  const dim3 grid(tiles, static_cast<unsigned>(H), static_cast<unsigned>(B));
  const float* x = static_cast<const float*>(xdt);
  const float* al = static_cast<const float*>(a_log);
  const float* bm = static_cast<const float*>(Bm);
  const float* cm = static_cast<const float*>(Cm);
  if (nc > 1) {
    const size_t smem = states_smem(static_cast<int>(n));
    cudaFuncSetAttribute(scan_bwd_states_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    scan_bwd_states_kernel<<<grid, kThreads, smem, stream>>>(
        x, al, bm, states, static_cast<int>(S), static_cast<int>(H),
        static_cast<int>(dh), static_cast<int>(n), nc);
  }
  const size_t smem = chunk_smem(static_cast<int>(n));
  cudaFuncSetAttribute(scan_bwd_chunk_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  scan_bwd_chunk_kernel<<<grid, kThreads, smem, stream>>>(
      x, al, bm, cm, static_cast<const float*>(dy), states,
      static_cast<float*>(dxdt), dBp, dCp, dap, static_cast<int>(S),
      static_cast<int>(H), static_cast<int>(dh), static_cast<int>(n), nc);
  scan_bwd_reduce_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           stream>>>(
      dBp, dCp, dap, static_cast<float*>(dB), static_cast<float*>(dC),
      static_cast<float*>(da_log), B * S, static_cast<int>(H * tiles),
      static_cast<int>(n), static_cast<int>(H), tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
