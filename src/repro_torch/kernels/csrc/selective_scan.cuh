// What the Mamba2 scan's forward (selective_scan.cu) and backward
// (selective_scan_bwd.cu) share: the chunk length, the 3xTF32 split, the
// 128-byte swizzle of the K-major tiles wgmma reads, the Gram kernel's
// body and the TF32 wgmma products with A from registers.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace scan {

constexpr int kQ = 32;           // steps per chunk
constexpr int kMaxN = 128;

// x = hi + lo: hi is x rounded to TF32 (to nearest, ties away from zero,
// as cvt.rna.tf32.f32 does, in two integer operations instead of that
// conversion's slower path); lo = x - hi, exact in fp32, whose bits past
// TF32 the tensor cores ignore
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// K-major 128-byte-swizzled tile of 32-column (128-byte) rows: the byte
// offset of (row r, column k < 32), as wgmma reads it (8-row atoms of 1024
// bytes; the 16-byte chunk index XOR the row within the atom)
__device__ __forceinline__ int swz(int r, int k) {
  return (r >> 3) * 1024 + (r & 7) * 128 + (((k >> 2) ^ (r & 7)) << 4) +
         (k & 3) * 4;
}

// the Gram kernel's tiles of one (b, chunk) for kN state columns (zeros
// past n), each split into TF32 hi and lo (see selective_scan.cu):
//   C hi, C lo: t x k, kN / 32 column atoms of 4096 bytes, columns
//     permuted within each 8 (even ones first) so that k slot c (c + 4)
//     holds column 2c (2c + 1), as a state's A fragments read them;
//   B^T hi, B^T lo: k x s.
__host__ __device__ constexpr int tile_bytes(int kN) { return 128 * kN; }

// the position of state column k in a C tile's row (the permutation above)
__host__ __device__ constexpr int perm8(int k) {
  return (k & ~7) | ((k & 1) ? 4 + ((k & 7) >> 1) : ((k & 7) >> 1));
}

// the floats of the Gram kernel's workspace: per (b, chunk) kQ x kQ of
// C.B^T, then the four tiles
inline int64_t gram_floats(int64_t B, int64_t S, int kN) {
  return B * ((S + kQ - 1) / kQ) * (kQ * kQ + tile_bytes(kN));
}

// ---- the Gram kernel: per (b, chunk) G = C.B^T and the tiles of C, B^T ----
// (the body of the forward's selective_scan_gram_kernel and of the
// backward's scan_bwd_gram_kernel; grid (chunks, B), kGramThreads threads,
// gram_smem(n) bytes of dynamic shared memory)
constexpr int kGramThreads = 256;

inline size_t gram_smem(int n) { return 2 * sizeof(float) * kQ * (n | 1); }

__device__ __forceinline__ void gram(const float* __restrict__ Bm,
                                     const float* __restrict__ Cm,
                                     float* __restrict__ G,
                                     unsigned char* __restrict__ P, int S,
                                     int n, int kN) {
  extern __shared__ __align__(16) float gsm[];
  const int ns = n | 1;                      // odd stride: no bank conflicts
  float* Bs = gsm;                           // (kQ, ns)
  float* Cs = gsm + kQ * ns;                 // (kQ, ns)
  const int c = blockIdx.x, b = blockIdx.y, nc = gridDim.x;
  const int c0 = c * kQ, q = min(kQ, S - c0);
  const int64_t base = (static_cast<int64_t>(b) * S + c0) * n;
  for (int i = threadIdx.x; i < kQ * n; i += kGramThreads) {
    const int s = i / n, k = i - s * n;
    const bool ok = s < q;
    Bs[s * ns + k] = ok ? Bm[base + i] : 0.f;
    Cs[s * ns + k] = ok ? Cm[base + i] : 0.f;
  }
  __syncthreads();
  unsigned char* pc =
      P + (static_cast<int64_t>(b) * nc + c) * 4 * tile_bytes(kN);
  for (int i = threadIdx.x; i < kQ * kN; i += kGramThreads) {
    const int r = i / kN, k = i - r * kN;    // row of C (t) and of B (s)
    uint32_t hi, lo;
    const int kp = scan::perm8(k);
    const int oc = (kp >> 5) * 4096 + swz(r, kp & 31);
    split(k < n ? Cs[r * ns + k] : 0.f, hi, lo);
    *reinterpret_cast<uint32_t*>(pc + oc) = hi;
    *reinterpret_cast<uint32_t*>(pc + tile_bytes(kN) + oc) = lo;
    const int ob = swz(k, r);
    split(k < n ? Bs[r * ns + k] : 0.f, hi, lo);
    *reinterpret_cast<uint32_t*>(pc + 2 * tile_bytes(kN) + ob) = hi;
    *reinterpret_cast<uint32_t*>(pc + 3 * tile_bytes(kN) + ob) = lo;
  }
  constexpr int kM = kQ / 16;                // each thread a kM x kM tile
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float acc[kM][kM] = {};
  for (int k = 0; k < n; ++k) {
    float cv[kM], bv[kM];
#pragma unroll
    for (int i = 0; i < kM; ++i) cv[i] = Cs[(ty + 16 * i) * ns + k];
#pragma unroll
    for (int j = 0; j < kM; ++j) bv[j] = Bs[(tx + 16 * j) * ns + k];
#pragma unroll
    for (int i = 0; i < kM; ++i)
#pragma unroll
      for (int j = 0; j < kM; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
  }
  float* out = G + (static_cast<int64_t>(b) * nc + c) * kQ * kQ;
#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int j = 0; j < kM; ++j)
      out[(ty + 16 * i) * kQ + tx + 16 * j] = acc[i][j];
}

// wgmma m64nNk8 TF32: d (64 x N, fp32) += A B, A (64 x 8) in registers
// (four per thread: rows 16 w + l/4 (+8), columns l%4 (+4), as mma.sync's
// m16n8k8 A), B (8 x N) K-major in shared memory (descriptor b)
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t* a,
                                          uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

__device__ __forceinline__ void wgmma_n64(float* d, const uint32_t* a,
                                          uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// the descriptor of a swizzled K-major tile at shared address addr
__device__ __forceinline__ uint64_t kdesc(uint32_t addr) {
  return hopper::wgmma_desc(addr, 16, 1024, 128);
}

}  // namespace scan
