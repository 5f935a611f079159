// Fused LoRA matmul for Hopper (sm_90a):
//
//     out = x @ W + s * (x @ A) @ B
//     x (T, d), W (d, o), A (d, r), B (r, o), all row-major, one dtype
//     (fp32 or bf16); out (T, o) in that dtype; fp32 accumulation throughout.
//
// Replaces src/repro/kernels/lora_matmul.py::lora_matmul (the Pallas kernel
// behind repro/fl/lora.py::lora_matmul).
//
// Bound: operations at the LLM shapes.  2*T*d*(o + r) + 2*T*r*o flops
// against (T*d + d*o + d*r + r*o + T*o) elements moved: at qwen3-1.7b's
// wq (T = 16384, d = o = 2048, r = 8, bf16) that is ~970 flops per byte,
// above the card's ~295 bf16 flops per byte, so the least time is
// flops / 989 TFLOP/s (bf16) or / 67 TFLOP/s (fp32, no tensor cores).
// What the design does:
//   * one block per (T tile, o tile); a K loop over d brings each x tile
//     into shared memory once and uses it twice: for the base tile x.W and
//     for the rank-r side product x.A of the block's rows, both accumulated
//     in fp32 registers in the same loop (the TPU kernel's one pass over x);
//   * the epilogue adds s * (xa . B_tile) in fp32 from shared memory (xa is
//     never rounded to bf16) and writes the tile once in x's dtype;
//   * bf16 runs both products on the tensor cores with mma.sync m16n8k16:
//     a 128 x 128 tile, 8 warps of 64 x 32, x fragments by ldmatrix, W and A
//     fragments by ldmatrix.trans from their k-major rows (mma.cuh).  The
//     side product's 16-column pairs of A go to the warps of each row half
//     in turn, so r = 64 spreads over all four;
//   * fp32 runs on the FMA pipes: a 64 x 64 tile, 256 threads with a 4 x 4
//     micro-tile each, and up to 16 of the 64 x r side-product entries;
//   * the edges of T, d, o and r are masked in the kernel: out-of-range
//     elements load as zero and are never stored.  16-byte loads where a
//     tensor's rows keep 16-byte alignment, element loads elsewhere.  No
//     host-side padding (the TPU wrapper pads to its blocks and r to 128
//     lanes; both are TPU layout constraints).
//   r is at most kMaxRank = 64.  One tile in flight per block: wgmma, TMA
//   and a pipelined K loop are later work.
//
// C interface (bound with ctypes): lora_matmul_{f32,bf16}(x, w, a, b, out,
// T, d, o, r, scaling, stream), returning cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for shapes the kernel does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kMaxRank = 64;

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr int kBT = 128;            // rows of x per block
constexpr int kBO = 128;            // output columns per block
constexpr int kBK = 32;             // depth of one K step (two k16 mma steps)
constexpr int kThreads = 256;       // 8 warps: 2 row halves x 4 column quarters
constexpr int kXS = kBK + 8;        // bf16 strides, each row 16-byte aligned
constexpr int kWS = kBO + 8;        // and 8 ldmatrix rows on distinct banks

__host__ __device__ constexpr int rank_pad(int r) { return (r + 15) / 16 * 16; }

struct Bf16Smem {
  int a_stride, xa_stride, b_stride;
  size_t loop_bytes, epilogue_bytes;
  __host__ __device__ explicit Bf16Smem(int r) {
    const int rp = rank_pad(r);
    a_stride = rp + 8;
    xa_stride = rp + 4;
    b_stride = kBO + 4;
    loop_bytes = sizeof(__nv_bfloat16) *
                 (kBT * kXS + kBK * kWS + kBK * a_stride);
    epilogue_bytes = sizeof(float) * (kBT * xa_stride + rp * b_stride);
  }
  __host__ __device__ size_t bytes() const {
    return loop_bytes > epilogue_bytes ? loop_bytes : epilogue_bytes;
  }
};

// 8 consecutive bf16 of a row-major (rows, cols) matrix at (row, col) ->
// shared memory, zero past the edges; a 16-byte load when vec
__device__ __forceinline__ void load8_bf16(const __nv_bfloat16* g, int64_t rows,
                                           int64_t cols, int64_t row,
                                           int64_t col, bool vec,
                                           __nv_bfloat16* s) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (row < rows) {
    const __nv_bfloat16* p = g + row * cols + col;
    if (vec && col + 8 <= cols) {
      v = *reinterpret_cast<const uint4*>(p);
    } else {
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (col + i < cols) e[i] = p[i];
    }
  }
  *reinterpret_cast<uint4*>(s) = v;
}

__global__ void __launch_bounds__(kThreads)
    lora_matmul_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ w,
                            const __nv_bfloat16* __restrict__ a,
                            const __nv_bfloat16* __restrict__ b,
                            __nv_bfloat16* __restrict__ out, int64_t T,
                            int64_t D, int64_t O, int R, float scaling) {
  const Bf16Smem L(R);
  const int rp = rank_pad(R);
  const int n_pairs = rp / 16;       // 16-column pairs of A's n8 tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ws = Xs + kBT * kXS;
  __nv_bfloat16* As = Ws + kBK * kWS;

  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kBO;
  const int64_t t0 = static_cast<int64_t>(blockIdx.y) * kBT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / 4;           // row half: rows wm*64 .. +63
  const int wn = warp % 4;           // column quarter: cols wn*32 .. +31
  const int gid = lane / 4;
  const int cid = lane % 4;
  const int mi = lane / 8;           // the ldmatrix matrix this lane addresses
  const int ri = lane % 8;           // and its row within it
  const bool vec_x = D % 8 == 0 && aligned16(x);
  const bool vec_w = O % 8 == 0 && aligned16(w);
  const bool vec_a = R % 8 == 0 && aligned16(a);

  float acc[4][4][4];                // [m16 tile][n8 tile][fragment]
  float xa[4][2][4];                 // [m16 tile][n8 tile of pair wn][fragment]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) xa[i][j][e] = 0.f;
  }

  for (int64_t k0 = 0; k0 < D; k0 += kBK) {
    __syncthreads();                 // the previous step's tiles are consumed
    for (int c = threadIdx.x; c < kBT * (kBK / 8); c += kThreads) {
      const int row = c / (kBK / 8), col = (c % (kBK / 8)) * 8;
      load8_bf16(x, T, D, t0 + row, k0 + col, vec_x, Xs + row * kXS + col);
    }
    for (int c = threadIdx.x; c < kBK * (kBO / 8); c += kThreads) {
      const int row = c / (kBO / 8), col = (c % (kBO / 8)) * 8;
      load8_bf16(w, D, O, k0 + row, n0 + col, vec_w, Ws + row * kWS + col);
    }
    for (int c = threadIdx.x; c < kBK * (rp / 8); c += kThreads) {
      const int row = c / (rp / 8), col = (c % (rp / 8)) * 8;
      load8_bf16(a, D, R, k0 + row, col, vec_a, As + row * L.a_stride + col);
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldsm_x4(Xs + (wm * 64 + i * 16 + (mi % 2) * 8 + ri) * kXS + kk * 16 +
                    (mi / 2) * 8,
                af[i]);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t bf[4];
        ldsm_x4_trans(Ws + (kk * 16 + (mi % 2) * 8 + ri) * kWS + wn * 32 +
                          jp * 16 + (mi / 2) * 8,
                      bf);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mma_bf16(acc[i][2 * jp], af[i], bf[0], bf[1]);
          mma_bf16(acc[i][2 * jp + 1], af[i], bf[2], bf[3]);
        }
      }
      if (wn < n_pairs) {            // x . A for the pair of A columns wn
        uint32_t ab[4];
        ldsm_x4_trans(As + (kk * 16 + (mi % 2) * 8 + ri) * L.a_stride +
                          wn * 16 + (mi / 2) * 8,
                      ab);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mma_bf16(xa[i][0], af[i], ab[0], ab[1]);
          mma_bf16(xa[i][1], af[i], ab[2], ab[3]);
        }
      }
    }
  }

  // epilogue: xa and the B tile in fp32 shared memory (the loop's tiles are
  // consumed), then acc + s * (xa . B) per output
  __syncthreads();
  float* XAs = reinterpret_cast<float*>(smem_raw);
  float* Bs = XAs + kBT * L.xa_stride;
  if (wn < n_pairs) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          XAs[(wm * 64 + i * 16 + gid + (e / 2) * 8) * L.xa_stride + wn * 16 +
              h * 8 + 2 * cid + (e % 2)] = xa[i][h][e];
  }
  for (int c = threadIdx.x; c < R * kBO; c += kThreads) {
    const int q = c / kBO, col = c % kBO;
    Bs[q * L.b_stride + col] =
        n0 + col < O ? __bfloat162float(b[q * O + n0 + col]) : 0.f;
  }
  __syncthreads();

  const bool pairs_out = O % 2 == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r0 = wm * 64 + i * 16 + gid;     // and r0 + 8
    float d[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
    for (int q = 0; q < R; ++q) {
      const float x0 = XAs[r0 * L.xa_stride + q];
      const float x1 = XAs[(r0 + 8) * L.xa_stride + q];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* bq = Bs + q * L.b_stride + wn * 32 + j * 8 + 2 * cid;
        d[j][0] = fmaf(x0, bq[0], d[j][0]);
        d[j][1] = fmaf(x0, bq[1], d[j][1]);
        d[j][2] = fmaf(x1, bq[0], d[j][2]);
        d[j][3] = fmaf(x1, bq[1], d[j][3]);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t t = t0 + r0 + half * 8;
      if (t >= T) continue;
      __nv_bfloat16* orow = out + t * O;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t n = n0 + wn * 32 + j * 8 + 2 * cid;
        const float v0 = acc[i][j][2 * half] + scaling * d[j][2 * half];
        const float v1 = acc[i][j][2 * half + 1] + scaling * d[j][2 * half + 1];
        if (pairs_out && n + 1 < O) {
          *reinterpret_cast<uint32_t*>(orow + n) = hopper::pack_bf16(v0, v1);
        } else {
          if (n < O) orow[n] = __float2bfloat16(v0);
          if (n + 1 < O) orow[n + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 on the FMA pipes
// ---------------------------------------------------------------------------
constexpr int kFT = 64;             // rows of x per block
constexpr int kFO = 64;             // output columns per block
constexpr int kFK = 32;             // depth of one K step
constexpr int kFXS = kFK + 4;       // float strides (float4-aligned rows)
constexpr int kFWS = kFO + 4;
constexpr int kFBS = kFO + 4;
constexpr int kXaPerThread = kFT * kMaxRank / kThreads;   // 16

struct F32Smem {
  int xa_stride;
  size_t loop_bytes, epilogue_bytes;
  __host__ __device__ explicit F32Smem(int r) {
    xa_stride = r + 1;
    loop_bytes = sizeof(float) * (kFT * kFXS + kFK * kFWS + kFK * r);
    epilogue_bytes = sizeof(float) * (kFT * xa_stride + r * kFBS);
  }
  __host__ __device__ size_t bytes() const {
    return loop_bytes > epilogue_bytes ? loop_bytes : epilogue_bytes;
  }
};

// 4 consecutive floats of a row-major (rows, cols) matrix at (row, col) ->
// shared memory, zero past the edges; a 16-byte load when vec
__device__ __forceinline__ void load4_f32(const float* g, int64_t rows,
                                          int64_t cols, int64_t row,
                                          int64_t col, bool vec, float* s) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row < rows) {
    const float* p = g + row * cols + col;
    if (vec && col + 4 <= cols) {
      v = *reinterpret_cast<const float4*>(p);
    } else {
      if (col < cols) v.x = p[0];
      if (col + 1 < cols) v.y = p[1];
      if (col + 2 < cols) v.z = p[2];
      if (col + 3 < cols) v.w = p[3];
    }
  }
  *reinterpret_cast<float4*>(s) = v;
}

__global__ void __launch_bounds__(kThreads)
    lora_matmul_f32_kernel(const float* __restrict__ x,
                           const float* __restrict__ w,
                           const float* __restrict__ a,
                           const float* __restrict__ b,
                           float* __restrict__ out, int64_t T, int64_t D,
                           int64_t O, int R, float scaling) {
  const F32Smem L(R);
  extern __shared__ __align__(16) float fsmem[];
  float* Xs = fsmem;
  float* Ws = Xs + kFT * kFXS;
  float* As = Ws + kFK * kFWS;       // (kFK, R), unpadded

  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kFO;
  const int64_t t0 = static_cast<int64_t>(blockIdx.y) * kFT;
  const int tx = threadIdx.x % 16;   // cols tx + 16j
  const int ty = threadIdx.x / 16;   // rows ty + 16i
  const bool vec_x = D % 4 == 0 && aligned16(x);
  const bool vec_w = O % 4 == 0 && aligned16(w);

  float acc[4][4], xa[kXaPerThread];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int u = 0; u < kXaPerThread; ++u) xa[u] = 0.f;

  for (int64_t k0 = 0; k0 < D; k0 += kFK) {
    __syncthreads();
    for (int c = threadIdx.x; c < kFT * (kFK / 4); c += kThreads) {
      const int row = c / (kFK / 4), col = (c % (kFK / 4)) * 4;
      load4_f32(x, T, D, t0 + row, k0 + col, vec_x, Xs + row * kFXS + col);
    }
    for (int c = threadIdx.x; c < kFK * (kFO / 4); c += kThreads) {
      const int row = c / (kFO / 4), col = (c % (kFO / 4)) * 4;
      load4_f32(w, D, O, k0 + row, n0 + col, vec_w, Ws + row * kFWS + col);
    }
    for (int c = threadIdx.x; c < kFK * R; c += kThreads) {
      const int64_t k = k0 + c / R;
      As[c] = k < D ? a[k * R + c % R] : 0.f;
    }
    __syncthreads();

#pragma unroll 8
    for (int k = 0; k < kFK; ++k) {
      float xv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = Xs[(ty + 16 * i) * kFXS + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = Ws[k * kFWS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }
    // the side product: entry (row, col) = u * 256 + thread of the 64 x R
    // tile
#pragma unroll
    for (int u = 0; u < kXaPerThread; ++u) {
      const int idx = u * kThreads + threadIdx.x;
      if (idx < kFT * R) {
        const float* xr = Xs + (idx / R) * kFXS;
        const float* ac = As + idx % R;
        float s = xa[u];
#pragma unroll 8
        for (int k = 0; k < kFK; ++k) s = fmaf(xr[k], ac[k * R], s);
        xa[u] = s;
      }
    }
  }

  __syncthreads();
  float* XAs = fsmem;
  float* Bs = XAs + kFT * L.xa_stride;
#pragma unroll
  for (int u = 0; u < kXaPerThread; ++u) {
    const int idx = u * kThreads + threadIdx.x;
    if (idx < kFT * R) XAs[(idx / R) * L.xa_stride + idx % R] = xa[u];
  }
  for (int c = threadIdx.x; c < R * kFO; c += kThreads) {
    const int q = c / kFO, col = c % kFO;
    Bs[q * kFBS + col] = n0 + col < O ? b[q * O + n0 + col] : 0.f;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t t = t0 + ty + 16 * i;
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    for (int q = 0; q < R; ++q) {
      const float xq = XAs[(ty + 16 * i) * L.xa_stride + q];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        d[j] = fmaf(xq, Bs[q * kFBS + tx + 16 * j], d[j]);
    }
    if (t >= T) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t n = n0 + tx + 16 * j;
      if (n < O) out[t * O + n] = acc[i][j] + scaling * d[j];
    }
  }
}

bool shapes_ok(int64_t T, int64_t D, int64_t O, int64_t R) {
  return T >= 1 && D >= 0 && O >= 1 && R >= 1 && R <= kMaxRank &&
         (T + kFT - 1) / kFT <= 65535;
}

}  // namespace

extern "C" {

int lora_matmul_bf16(const void* x, const void* w, const void* a,
                     const void* b, void* out, int64_t T, int64_t D, int64_t O,
                     int64_t R, float scaling, void* stream) {
  if (!shapes_ok(T, D, O, R)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = Bf16Smem(static_cast<int>(R)).bytes();
  cudaError_t err = cudaFuncSetAttribute(
      lora_matmul_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((O + kBO - 1) / kBO),
                  static_cast<unsigned>((T + kBT - 1) / kBT));
  lora_matmul_bf16_kernel<<<grid, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(out),
      T, D, O, static_cast<int>(R), scaling);
  return static_cast<int>(cudaGetLastError());
}

int lora_matmul_f32(const void* x, const void* w, const void* a,
                    const void* b, void* out, int64_t T, int64_t D, int64_t O,
                    int64_t R, float scaling, void* stream) {
  if (!shapes_ok(T, D, O, R)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = F32Smem(static_cast<int>(R)).bytes();
  cudaError_t err = cudaFuncSetAttribute(
      lora_matmul_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((O + kFO - 1) / kFO),
                  static_cast<unsigned>((T + kFT - 1) / kFT));
  lora_matmul_f32_kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out), T, D, O, static_cast<int>(R), scaling);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
