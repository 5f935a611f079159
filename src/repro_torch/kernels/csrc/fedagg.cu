// Coefficient-weighted reductions over stacked participant vectors, for
// Hopper (sm_90a):
//
//     out[p] = sum_m c[m] * x[m, p]          x: (M, P) row-major, c: (M,) fp32
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   * src/repro/kernels/dequant_agg.py::_coef_reduce (behind float_fedagg and
//     dequant_fedagg): fp32/fp16/int8 payloads -> fp32 accumulator.  For
//     int8 the kernel folds c[m] = beta[m] * scale[m] (one fp32 product)
//     while it fills its shared coefficients, where dequant_agg.py's
//     dequant_fedagg folds them in a separate op before its kernel: one
//     launch per call.
//   * src/repro/kernels/fedagg.py::fedagg (Eq. 7 aggregation): fp32/bf16
//     parameters -> output in the input dtype, accumulated in fp32.
//
// Bound: memory.  Each element costs one multiply-add for 1 (int8), 2
// (fp16/bf16) or 4 (fp32) bytes read, far below the card's ~20 FLOP/byte
// balance point for fp32 FMA, so the least time is
//     bytes / 3.35 TB/s,   bytes = M*P*sizeof(x) + P*sizeof(out) + 4*M.
// What the design does about it:
//   * every input byte is read exactly once and every output written once:
//     a thread owns VEC consecutive outputs, loops m = 0..M-1 with an fp32
//     register accumulator per output, and stores once.  No cross-block
//     reduction, so no atomics and a deterministic result;
//   * loads are as wide as the layout allows: 16 bytes (4 fp32, 8 fp16/bf16,
//     16 int8) when every row start stays aligned, i.e. P*sizeof(x) % 16 == 0,
//     else the widest power-of-two width that keeps every row aligned (the
//     host picks VEC so that VEC divides P: no ragged tail);
//   * the M coefficients sit in shared memory, read by every thread (for
//     int8 each is formed there as beta * scale);
//   * a grid-stride loop over P with enough 256-thread blocks to fill all
//     SMs (8 resident blocks each), so a leaf of any size streams at once;
//   * 64-bit offsets: M*P reaches 64 * 11.2M when a whole model is flattened.
// The TPU kernels' 32-row int8 sublane tiles, 2048-lane blocks and host-side
// padding are TPU layout constraints and are not carried over.
//
// C interface (bound with ctypes): one entry per input dtype family, each
// taking (x, coef, out, M, P, stream), and dequant_fedagg_i8 taking (q,
// scales, betas, out, M, P, stream); each returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename OutT>
__device__ __forceinline__ OutT from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, typename OutT, int VEC>
__global__ void __launch_bounds__(kThreads)
    coef_reduce_kernel(const T* __restrict__ x, const float* __restrict__ coef,
                       const float* __restrict__ scale, OutT* __restrict__ out,
                       int64_t M, int64_t P) {
  extern __shared__ float c_s[];
  for (int64_t i = threadIdx.x; i < M; i += blockDim.x)
    c_s[i] = scale != nullptr ? coef[i] * scale[i] : coef[i];
  __syncthreads();

  const int64_t n_vec = P / VEC;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       v < n_vec; v += stride) {
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    const T* px = x + v * VEC;
#pragma unroll 4
    for (int64_t m = 0; m < M; ++m) {
      const Pack<T, VEC> pk = *reinterpret_cast<const Pack<T, VEC>*>(px + m * P);
      const float c = c_s[m];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = fmaf(c, to_f32(pk.v[j]), acc[j]);
    }
    Pack<OutT, VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) o.v[j] = from_f32<OutT>(acc[j]);
    *reinterpret_cast<Pack<OutT, VEC>*>(out + v * VEC) = o;
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 132;
  return sms;
}

template <typename T, typename OutT, int VEC>
void launch_vec(const T* x, const float* coef, const float* scale, OutT* out,
                int64_t M, int64_t P, cudaStream_t stream) {
  const int64_t n_vec = P / VEC;
  int64_t blocks = (n_vec + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sm_count()) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const size_t smem = static_cast<size_t>(M) * sizeof(float);
  coef_reduce_kernel<T, OutT, VEC>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
          x, coef, scale, out, M, P);
}

bool aligned(const void* p, int64_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes) == 0;
}

// Widest VEC (elements per load) with VEC*sizeof(T) <= 16 bytes that divides
// P and keeps x and out aligned, then launch.  coef[m] is the coefficient,
// or coef[m] * scale[m] where scale is not null.
template <typename T, typename OutT>
int coef_reduce(const void* xv, const void* coefv, const void* scalev,
                void* outv, int64_t M, int64_t P, void* streamv) {
  const T* x = static_cast<const T*>(xv);
  const float* coef = static_cast<const float*>(coefv);
  const float* scale = static_cast<const float*>(scalev);
  OutT* out = static_cast<OutT*>(outv);
  cudaStream_t stream = static_cast<cudaStream_t>(streamv);
  if (M <= 0 || P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int vec = 16 / static_cast<int>(sizeof(T));
  while (vec > 1 && (P % vec != 0 || !aligned(x, vec * sizeof(T)) ||
                     !aligned(out, vec * sizeof(OutT))))
    vec >>= 1;
  switch (vec) {
    case 16:
      if constexpr (sizeof(T) == 1)
        launch_vec<T, OutT, 16>(x, coef, scale, out, M, P, stream);
      break;
    case 8:
      if constexpr (sizeof(T) <= 2)
        launch_vec<T, OutT, 8>(x, coef, scale, out, M, P, stream);
      break;
    case 4:
      launch_vec<T, OutT, 4>(x, coef, scale, out, M, P, stream);
      break;
    case 2:
      launch_vec<T, OutT, 2>(x, coef, scale, out, M, P, stream);
      break;
    default:
      launch_vec<T, OutT, 1>(x, coef, scale, out, M, P, stream);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int coef_reduce_f32(const void* x, const void* coef, void* out, int64_t M,
                    int64_t P, void* stream) {
  return coef_reduce<float, float>(x, coef, nullptr, out, M, P, stream);
}

int coef_reduce_f16(const void* x, const void* coef, void* out, int64_t M,
                    int64_t P, void* stream) {
  return coef_reduce<__half, float>(x, coef, nullptr, out, M, P, stream);
}

// Σ_m (betas[m] * scales[m]) * q[m]: the fold happens in the kernel
int dequant_fedagg_i8(const void* q, const void* scales, const void* betas,
                      void* out, int64_t M, int64_t P, void* stream) {
  return coef_reduce<int8_t, float>(q, betas, scales, out, M, P, stream);
}

int fedagg_f32(const void* x, const void* coef, void* out, int64_t M,
               int64_t P, void* stream) {
  return coef_reduce<float, float>(x, coef, nullptr, out, M, P, stream);
}

int fedagg_bf16(const void* x, const void* coef, void* out, int64_t M,
                int64_t P, void* stream) {
  return coef_reduce<__nv_bfloat16, __nv_bfloat16>(x, coef, nullptr, out, M,
                                                   P, stream);
}

}  // extern "C"
