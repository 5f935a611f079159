// Tensor-core fragment helpers of the mma.sync bf16 kernel (lora_matmul.cu):
// ldmatrix loads from shared memory and the mma.sync m16n8k16 bf16 product
// with fp32 accumulators (shared-memory addresses and bf16 packing come from
// hopper.cuh, the wgmma kernels' header).
//
// Fragment layout of mma.sync m16n8k16 (lane = 4 * gid + cid):
//   A (16x16, row):  a[0] rows 0-7 / k 0-7, a[1] rows 8-15 / k 0-7,
//                    a[2] rows 0-7 / k 8-15, a[3] rows 8-15 / k 8-15;
//   B (16x8, col):   b0 k 0-7, b1 k 8-15, each k pair (2cid, 2cid+1) of col gid;
//   C (16x8, fp32):  c[0], c[1] row gid, cols 2cid, 2cid+1; c[2], c[3] row
//                    gid + 8.
// An x4 ldmatrix whose lane l addresses row (l % 8) of matrix l / 8 fills
// those registers in that order; with .trans it turns k-major rows of a
// (k, n) tile into B fragments.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(const void* p, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_addr(p)));
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace
