// Helpers that the attention forward (attention.cu) and backward
// (attention_bwd.cu) share: the finite mask score, log2(e) and exp2,
// conversions to and from fp32, 16-byte loads of 8 elements, the FMA
// kernels' tile loads into padded shared-memory rows, the head dims'
// instantiations, and the FMA micro-tiles' output columns.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the score of a masked (query, key) pair: finite, so a row with no valid
// key averages every key, as the JAX package's reference does
constexpr float kNegInf = -1e30f;

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

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

// rows x HD elements at base (row stride in elements) -> fp32 shared memory
// rows of stride sstride; rows at or past rows_valid, and columns at or past
// cols (a multiple of 8: the tensor's head dim under a wider HD), are zero.
template <int HD, typename T>
__device__ __forceinline__ void load_tile(const T* base, int64_t row_stride,
                                          int rows_valid, float* s,
                                          int sstride, int rows,
                                          int cols = HD) {
  constexpr int kChunks = HD / 8;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += blockDim.x) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    float x[8];
    if (r < rows_valid && c < cols) {
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

// The instantiation a head dim runs on, forward and backward: the next of
// 32, 64, 128 and 256 up for a multiple of 8 in [8, 256] (its index in
// kHeadDims), else -1
constexpr int64_t kHeadDims[4] = {32, 64, 128, 256};

inline int head_dim_index(int64_t hd) {
  if (hd < 8 || hd > 256 || hd % 8 != 0) return -1;
  int i = 0;
  while (kHeadDims[i] < hd) ++i;
  return i;
}

// output column of a thread's jj-th accumulator in a 16 x 16 thread block's
// (rows, HD) micro-tiles: two float4 groups per 64 columns (hd 64, 128,
// 256), or a float2 (hd 32)
template <int HD>
__device__ __forceinline__ int out_col(int tx, int jj) {
  if constexpr (HD >= 64) {
    return (jj / 4) * 64 + tx * 4 + (jj % 4);
  } else {
    return tx * 2 + jj;
  }
}

}  // namespace
