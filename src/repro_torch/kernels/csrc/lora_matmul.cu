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
//
// bf16: TMA, an mbarrier ring and wgmma, warp-specialised and persistent.
// One block per SM (at most) walks the 128 x 256 output tiles: it visits
// u = block, block + grid, ... of the (row tile, pair of column tiles)
// pairs, and a pair's two tiles in turn (row tiles outer, so the blocks
// running at one time share x rows and all of W in L2).  Warpgroup 0 is
// the producer: it keeps a ring of 4 stages (3 for r > 16) in flight, each
// holding, for 64 of d, the tile's 128 rows of x (K-major), its 64 x 256
// slice of W (N-major: four 64-column boxes, read by wgmma through the
// transpose bit) and the same 64 of d of A^T (K-major, r rounded up to
// r_pad = 16, 32, 48 or 64 rows), all with the 128-byte swizzle.
// Warpgroups 1 and 2 each own 64 of the tile's rows and, per stage, issue
// four k16 steps of
//   acc (64 x 256, fp32 registers) += x . W   (wgmma m64n256k16, SS)
//   xa (64 x r_pad, fp32 registers) += x . A  (wgmma m64n{r_pad}k16, SS,
//                                              A^T as the K-major operand)
// on the x tile already in shared memory: the side product rides on the
// loads of the base product.  It runs with a pair's first tile only and
// stays in registers for the second (kGroup): an m64n16 product rereads
// its 64 x 16 slice of x for 1/16 of the n256 product's work, so it costs
// more time than its flops (~10% of a tile at r <= 16).  With the hi + lo
// epilogue below, the kernel runs 2*T*d*o + 2*T*d*r_pad*ceil(o/512) +
// 4*T*r_pad*o flops: at qwen3's wq 143.9 G against the bound's 138.5 at
// r = 8 (+4%), 163.2 G against 146.0 at r = 64 (+12%).  One group of
// products stays in
// flight while the next stage's are issued; a stage goes back to the
// producer when its products finish.
// The epilogue never rounds x.A to bf16 alone: s*xa is split into bf16
// hi + lo parts (16 significant bits), which are already the RS form's A
// fragments, and acc += hi . B + lo . B runs as wgmma m64n256k16 with B's
// r_pad x 256 tile (N-major, loaded once per output tile, rows past r
// zero) from shared memory.  acc is rounded to bf16 once, written to a
// 64 x 64 box per consumer warpgroup in shared memory (the same swizzle,
// so the writes do not conflict on banks) and stored by TMA, which drops
// rows and columns past T and o.  The producer loads the next tile's
// stages meanwhile.
//
// A^T: A's rows are r * 2 bytes, down to 2, too narrow for a swizzled TMA
// box of A itself, so the launcher first transposes A into A^T (r rows of
// d rounded up to 8, a workspace the wrapper allocates): 2*d*r bytes each
// way, against the 2*d*r_pad*(T/128)*(o/256) bytes the blocks read of it.
//
// Two routes, one kernel template (kTma), the same consumers:
//   * TMA (d and o multiples of 8, x, W, B and out 16-byte aligned): one
//     producer thread issues every load; the other producer threads exit;
//   * cp.async (any other shape or base, e.g. d = 300 or a row slice of x):
//     the 128 producer threads fill the same swizzled layouts with 16-byte
//     cp.async where the source is aligned (zeros past the edges) and
//     element loads elsewhere, arrive on a stage's barrier once its copies
//     have landed (one stage behind the issue), and the consumers store
//     the output from registers, masked at the edges.
// The host picks the route from the shapes and pointers (ops.lora_route).
//
// fp32 runs on the FMA pipes (TF32 stays off, as the plain version's
// semantics require): a 64 x 64 tile, 256 threads with a 4 x 4
// micro-tile each, and up to 16 of the 64 x r side-product entries; the
// epilogue adds s * (xa . B) in fp32 from shared memory.  16-byte loads
// where a tensor's rows keep 16-byte alignment, element loads elsewhere;
// no host-side padding.  r is at most kMaxRank = 64.
//
// C interface (bound with ctypes): lora_matmul_bf16(x, w, a, b, at, out, T,
// d, o, r, scaling, tma, stream) and lora_matmul_f32(x, w, a, b, out, T, d,
// o, r, scaling, stream), returning cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for shapes (or a TMA route) the kernel does not
// take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kMaxRank = 64;
constexpr int kThreads = 256;       // the fp32 kernel's block

__host__ __device__ constexpr int rank_pad(int r) { return (r + 15) / 16 * 16; }

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma, warp-specialised
// ---------------------------------------------------------------------------
namespace wg {

constexpr int kBM = 128;              // rows of x per output tile
constexpr int kBN = 256;              // output columns per tile
constexpr int kBK = 64;               // d per stage: one 128-byte row of x
constexpr int kThreads = 384;         // 3 warpgroups
constexpr uint32_t kProducerRegs = 40;
constexpr uint32_t kConsumerRegs = 232;
constexpr int kBoxBytes = 64 * 128;   // a box of 64 rows of 64 bf16
constexpr int kGroup = 2;             // column tiles that share one x.A

template <int RP>
struct Layout {
  static constexpr int kStages = RP == 16 ? 4 : 3;
  static constexpr int kXBytes = kBM * 128;              // x: 128 rows
  static constexpr int kWBytes = kBN / 64 * kBoxBytes;   // W: 4 boxes
  static constexpr int kABytes = RP * 128;               // A^T: r_pad rows
  static constexpr int kStageBytes = kXBytes + kWBytes + kABytes;
  static constexpr int kBBox = RP * 128;                 // B: r_pad rows of 64
  static constexpr int kBBytes = kBN / 64 * kBBox;
  static constexpr int kB = kStages * kStageBytes;
  static constexpr int kOut = kB + kBBytes;              // a box per consumer
  static constexpr int kBars = kOut + 2 * kBoxBytes;
  static constexpr int kNumBars = 2 * kStages + 2;
  static constexpr size_t kSmemBytes = kBars + 8 * kNumBars + 1024;  // + align
};

// the 128-byte swizzle of a byte offset from a 1024-byte aligned base
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  return off ^ (((off >> 7) & 7) << 4);
}

// xa (64 x r_pad) += x (64 x 16) . A (16 x r_pad), x and A^T K-major
template <int RP>
__device__ __forceinline__ void xa_step(float (&xa)[RP / 2], uint64_t a,
                                        uint64_t b);
template <>
__device__ __forceinline__ void xa_step<16>(float (&xa)[8], uint64_t a,
                                            uint64_t b) {
  hopper::wgmma_ss_m64n16k16(xa, a, b, 1);
}
template <>
__device__ __forceinline__ void xa_step<32>(float (&xa)[16], uint64_t a,
                                            uint64_t b) {
  hopper::wgmma_ss_m64n32k16(xa, a, b, 1);
}
template <>
__device__ __forceinline__ void xa_step<48>(float (&xa)[24], uint64_t a,
                                            uint64_t b) {
  hopper::wgmma_ss_m64n48k16(xa, a, b, 1);
}
template <>
__device__ __forceinline__ void xa_step<64>(float (&xa)[32], uint64_t a,
                                            uint64_t b) {
  hopper::wgmma_ss_m64n64k16(xa, a, b, 1);
}

// 8 bf16 of row `row` of a row-major (rows, cols) matrix whose rows lie
// `stride` elements apart, from column `col`, into 16 bytes of shared
// memory: a cp.async where the source is 16-byte aligned (zeros past
// cols), element loads elsewhere, zeros past rows
__device__ __forceinline__ void load8(const __nv_bfloat16* g, int64_t rows,
                                      int64_t cols, int64_t stride,
                                      int64_t row, int64_t col,
                                      unsigned char* dst) {
  const int64_t left = cols - col;
  const int n = row >= rows || left <= 0 ? 0 : left < 8 ? static_cast<int>(left)
                                                         : 8;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (n > 0) {
    const __nv_bfloat16* p = g + row * stride + col;
    if (aligned16(p)) {
      hopper::cp_async16(dst, p, static_cast<int>(n * 2));
      return;
    }
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < n) e[i] = p[i];
  }
  *reinterpret_cast<uint4*>(dst) = v;
}

struct Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;
  const __nv_bfloat16* at;
  const __nv_bfloat16* b;
  __nv_bfloat16* out;
  int T, D, O, R, Dp;
  float scaling;
};

template <int RP, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
    lora_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                             const __grid_constant__ CUtensorMap tm_w,
                             const __grid_constant__ CUtensorMap tm_at,
                             const __grid_constant__ CUtensorMap tm_b,
                             const __grid_constant__ CUtensorMap tm_out,
                             const Args args) {
  using L = Layout<RP>;
  constexpr int S = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + S;
  uint64_t* b_full = empty + S;
  uint64_t* b_empty = b_full + 1;

  const int T = args.T, D = args.D, O = args.O;
  // the block visits u = block, block + grid, ... of the (row tile, group
  // of kGroup column tiles) pairs, and a group's tiles in turn
  const int n_tiles_n = (O + kBN - 1) / kBN;
  const int n_groups = (n_tiles_n + kGroup - 1) / kGroup;
  const int visits = (T + kBM - 1) / kBM * n_groups;
  const int nk = (D + kBK - 1) / kBK;
  const uint32_t producers = kTma ? 1 : 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], producers);
      hopper::mbar_init(&empty[s], 2 * 128);   // every consumer thread
    }
    hopper::mbar_init(b_full, producers);
    hopper::mbar_init(b_empty, 2 * 128);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup ----
    hopper::regs_release<kProducerRegs>();
    if (kTma && threadIdx.x != 0) return;
    const int pt = threadIdx.x;
    int n = 0;                 // stages loaded so far
    int pending = -1;          // cp.async route: the stage not yet arrived on
    auto arrive_pending = [&]() {
      if (pending < 0) return;
      hopper::cp_async_wait<0>();
      hopper::fence_proxy_async();
      hopper::mbar_arrive(&full[pending]);
      pending = -1;
    };
    // B's r_pad x 256 tile for the epilogue, once the last tile's is used
    auto load_b = [&](int n0, int it) {
      unsigned char* bb = smem + L::kB;
      if constexpr (kTma) {
        hopper::mbar_wait(b_empty, (it & 1) ^ 1);
        hopper::mbar_expect_tx(b_full, L::kBBytes);
#pragma unroll
        for (int j = 0; j < kBN / 64; ++j)
          hopper::tma_load_2d(bb + j * L::kBBox, &tm_b, b_full, n0 + 64 * j, 0);
      } else {
        arrive_pending();
        hopper::mbar_wait(b_empty, (it & 1) ^ 1);
        for (int ch = pt; ch < kBN / 64 * RP * 8; ch += 128) {
          const int j = ch / (RP * 8), q = ch / 8 % RP, c = ch % 8;
          load8(args.b, args.R, O, O, q, n0 + 64 * j + 8 * c,
                bb + j * L::kBBox + swz(q * 128 + c * 16));
        }
        hopper::cp_async_commit();
        hopper::cp_async_wait<0>();
        hopper::fence_proxy_async();
        hopper::mbar_arrive(b_full);
      }
    };
    int it = 0;
    for (int u = blockIdx.x; u < visits; u += gridDim.x)
    for (int nt = u % n_groups * kGroup;
         nt < min(u % n_groups * kGroup + kGroup, n_tiles_n); ++nt, ++it) {
      const int t0 = u / n_groups * kBM, n0 = nt * kBN;
      if (nk == 0) load_b(n0, it);
      for (int kb = 0; kb < nk; ++kb, ++n) {
        const int s = n % S;
        const int k0 = kb * kBK;
        unsigned char* st = smem + s * L::kStageBytes;
        hopper::mbar_wait(&empty[s], ((n / S) & 1) ^ 1);
        if constexpr (kTma) {
          hopper::mbar_expect_tx(&full[s], L::kStageBytes);
          hopper::tma_load_2d(st, &tm_x, &full[s], k0, t0);
#pragma unroll
          for (int j = 0; j < kBN / 64; ++j)
            hopper::tma_load_2d(st + L::kXBytes + j * kBoxBytes, &tm_w,
                                &full[s], n0 + 64 * j, k0);
          hopper::tma_load_2d(st + L::kXBytes + L::kWBytes, &tm_at, &full[s],
                              k0, 0);
        } else {
          for (int ch = pt; ch < kBM * 8; ch += 128) {
            const int row = ch / 8, c = ch % 8;
            load8(args.x, T, D, D, t0 + row, k0 + 8 * c,
                  st + swz(row * 128 + c * 16));
          }
          for (int ch = pt; ch < kBN / 64 * 64 * 8; ch += 128) {
            const int j = ch / 512, k = ch / 8 % 64, c = ch % 8;
            load8(args.w, D, O, O, k0 + k, n0 + 64 * j + 8 * c,
                  st + L::kXBytes + j * kBoxBytes + swz(k * 128 + c * 16));
          }
          for (int ch = pt; ch < RP * 8; ch += 128) {
            const int q = ch / 8, c = ch % 8;
            load8(args.at, args.R, D, args.Dp, q, k0 + 8 * c,
                  st + L::kXBytes + L::kWBytes + swz(q * 128 + c * 16));
          }
          hopper::cp_async_commit();
          if (pending >= 0) {      // the previous stage's copies have landed
            hopper::cp_async_wait<1>();
            hopper::fence_proxy_async();
            hopper::mbar_arrive(&full[pending]);
          }
          pending = s;
        }
        // B once the first stages are queued: the consumers release the
        // last tile's B only after that tile's products
        if (kb == min(S, nk) - 1) load_b(n0, it);
      }
      if constexpr (!kTma) arrive_pending();
    }
  } else {
    // ---- consumer warpgroups: 64 rows of each tile ----
    hopper::regs_claim<kConsumerRegs>();
    const int c = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const uint32_t base = hopper::smem_addr(smem);
    const uint32_t b_base = base + L::kB;
    unsigned char* obox = smem + L::kOut + c * kBoxBytes;
    const bool pairs =
        O % 2 == 0 && (reinterpret_cast<uintptr_t>(args.out) & 3) == 0;
    float acc[kBN / 2];
    float xa[RP / 2];
    int n = 0, it = 0;
    for (int u = blockIdx.x; u < visits; u += gridDim.x)
    for (int nt = u % n_groups * kGroup;
         nt < min(u % n_groups * kGroup + kGroup, n_tiles_n); ++nt, ++it) {
      const int t0 = u / n_groups * kBM, n0 = nt * kBN;
      // x.A of the tile's rows: computed with a group's first tile, used
      // by all of them
      const bool first = nt == u % n_groups * kGroup;
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
      if (first) {
#pragma unroll
        for (int i = 0; i < RP / 2; ++i) xa[i] = 0.f;
      }
      // the K loop, with the x.A products (kXa) or without: two straight
      // paths, so the compiler sees every wgmma's registers in each
      auto k_loop = [&](auto with_xa) {
        constexpr bool kXa = decltype(with_xa)::value;
        for (int kb = 0; kb < nk; ++kb, ++n) {
          const int s = n % S;
          const uint32_t st = base + s * L::kStageBytes;
          const uint32_t x_base = st + c * 64 * 128;
          const uint32_t w_base = st + L::kXBytes;
          const uint32_t a_base = st + L::kXBytes + L::kWBytes;
          hopper::mbar_wait(&full[s], (n / S) & 1);
          hopper::fence_regs(acc);
          hopper::fence_regs(xa);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk) {
            const uint64_t dx =
                hopper::wgmma_desc(x_base + kk * 32, 16, 1024, 128);
            hopper::wgmma_ss_m64n256k16_nmajor(
                acc, dx,
                hopper::wgmma_desc(w_base + kk * 16 * 128, kBoxBytes, 1024,
                                   128),
                1);
            if constexpr (kXa)
              xa_step<RP>(xa, dx,
                          hopper::wgmma_desc(a_base + kk * 32, 16, 1024, 128));
          }
          hopper::wgmma_commit();
          hopper::fence_regs(acc);
          hopper::fence_regs(xa);
          hopper::wgmma_wait<1>();   // the previous stage's products are done
          if (kb > 0) hopper::mbar_arrive(&empty[(n + S - 1) % S]);
        }
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        hopper::fence_regs(xa);
        if (nk > 0) hopper::mbar_arrive(&empty[(n + S - 1) % S]);
      };
      if (first)
        k_loop(std::true_type{});
      else
        k_loop(std::false_type{});

      // epilogue: acc += hi . B + lo . B with s * xa = hi + lo in bf16
      uint32_t hi[RP / 16][4], lo[RP / 16][4];
#pragma unroll
      for (int k = 0; k < RP / 16; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v0 = args.scaling * xa[8 * k + 2 * e];
          const float v1 = args.scaling * xa[8 * k + 2 * e + 1];
          hi[k][e] = hopper::pack_bf16(v0, v1);
          const float2 h = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&hi[k][e]));
          lo[k][e] = hopper::pack_bf16(v0 - h.x, v1 - h.y);
        }
      hopper::mbar_wait(b_full, it & 1);
      hopper::fence_regs(acc);
#pragma unroll
      for (int k = 0; k < RP / 16; ++k) {
        hopper::fence_regs(hi[k]);
        hopper::fence_regs(lo[k]);
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < RP / 16; ++k) {
        const uint64_t db =
            hopper::wgmma_desc(b_base + k * 16 * 128, L::kBBox, 1024, 128);
        hopper::wgmma_rs_m64n256k16_nmajor(acc, hi[k], db);
        hopper::wgmma_rs_m64n256k16_nmajor(acc, lo[k], db);
      }
      hopper::wgmma_commit();
      hopper::fence_regs(acc);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::mbar_arrive(b_empty);

      if constexpr (kTma) {
        // one 64 x 64 box at a time through shared memory and TMA
        const int r_lo = t0 + 64 * c;
#pragma unroll
        for (int j = 0; j < kBN / 64; ++j) {
          if (tid == 0) hopper::tma_store_wait_read();
          hopper::named_barrier_sync(1 + c, 128);
#pragma unroll
          for (int g = 0; g < 8; ++g)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int row = 16 * warp + lane / 4 + 8 * half;
              const int col = 8 * g + 2 * (lane % 4);
              const int i = 4 * (8 * j + g) + 2 * half;
              *reinterpret_cast<uint32_t*>(obox + swz(row * 128 + col * 2)) =
                  hopper::pack_bf16(acc[i], acc[i + 1]);
            }
          hopper::fence_proxy_async();
          hopper::named_barrier_sync(1 + c, 128);
          if (tid == 0 && r_lo < T && n0 + 64 * j < O) {
            hopper::tma_store_2d(&tm_out, obox, n0 + 64 * j, r_lo);
            hopper::tma_store_commit();
          }
        }
      } else {
#pragma unroll
        for (int g = 0; g < kBN / 8; ++g)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int64_t row = t0 + 64 * c + 16 * warp + lane / 4 + 8 * half;
            const int64_t col = n0 + 8 * g + 2 * (lane % 4);
            if (row >= T) continue;
            __nv_bfloat16* o = args.out + row * O;
            const float v0 = acc[4 * g + 2 * half];
            const float v1 = acc[4 * g + 2 * half + 1];
            if (pairs && col + 1 < O) {
              *reinterpret_cast<uint32_t*>(o + col) = hopper::pack_bf16(v0, v1);
            } else {
              if (col < O) o[col] = __float2bfloat16(v0);
              if (col + 1 < O) o[col + 1] = __float2bfloat16(v1);
            }
          }
      }
    }
    if (kTma && tid == 0) hopper::tma_store_wait_read();
  }
}

// A (D, R) -> A^T (R, Dp), zeros in the columns past D
__global__ void transpose_a_kernel(const __nv_bfloat16* __restrict__ a,
                                   __nv_bfloat16* __restrict__ at, int64_t D,
                                   int64_t R, int64_t Dp) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= R * Dp) return;
  const int64_t q = i / Dp, k = i % Dp;
  at[i] = k < D ? a[k * R + q] : __float2bfloat16(0.f);
}

template <int RP, bool kTma>
int launch(const Args& args, cudaStream_t stream) {
  using L = Layout<RP>;
  CUtensorMap tm_x{}, tm_w{}, tm_at{}, tm_b{}, tm_out{};
  if constexpr (kTma) {
    int err = hopper::encode_2d_bf16(&tm_x, args.x, args.T, args.D, args.D,
                                     64, kBM);
    if (!err) err = hopper::encode_2d_bf16(&tm_w, args.w, args.D, args.O,
                                           args.O, 64, 64);
    if (!err) err = hopper::encode_2d_bf16(&tm_at, args.at, args.R, args.D,
                                           args.Dp, 64, RP);
    if (!err) err = hopper::encode_2d_bf16(&tm_b, args.b, args.R, args.O,
                                           args.O, 64, RP);
    if (!err) err = hopper::encode_2d_bf16(&tm_out, args.out, args.T, args.O,
                                           args.O, 64, 64);
    if (err) return err;
  }
  int device = 0, sms = 0;
  cudaError_t cerr = cudaGetDevice(&device);
  if (cerr == cudaSuccess)
    cerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  device);
  if (cerr == cudaSuccess)
    cerr = cudaFuncSetAttribute(lora_matmul_wgmma_kernel<RP, kTma>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(L::kSmemBytes));
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int64_t n_tiles_n = (args.O + kBN - 1) / kBN;
  const int64_t visits = (static_cast<int64_t>(args.T) + kBM - 1) / kBM *
                         ((n_tiles_n + kGroup - 1) / kGroup);
  lora_matmul_wgmma_kernel<RP, kTma>
      <<<static_cast<unsigned>(std::min<int64_t>(sms, visits)), kThreads,
         L::kSmemBytes, stream>>>(tm_x, tm_w, tm_at, tm_b, tm_out, args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

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

// the bf16 kernel's coordinates and tile count fit in 32 bits
bool wg_shapes_ok(int64_t T, int64_t D, int64_t O, int64_t R) {
  return T >= 1 && D >= 0 && O >= 1 && R >= 1 && R <= kMaxRank &&
         T <= INT32_MAX && D <= INT32_MAX - 64 && O <= INT32_MAX - 256 &&
         (T + wg::kBM - 1) / wg::kBM * ((O + wg::kBN - 1) / wg::kBN) <=
             INT32_MAX;
}

template <bool kTma>
int launch_rank(const wg::Args& args, cudaStream_t stream) {
  switch (rank_pad(args.R)) {
    case 16: return wg::launch<16, kTma>(args, stream);
    case 32: return wg::launch<32, kTma>(args, stream);
    case 48: return wg::launch<48, kTma>(args, stream);
    default: return wg::launch<64, kTma>(args, stream);
  }
}

}  // namespace

extern "C" {

// at: the A^T workspace, r * roundup(d, 8) bf16; tma: 1 for the TMA route
// (d, o multiples of 8 and 16-byte aligned x, w, b, at, out), 0 for the
// cp.async route
int lora_matmul_bf16(const void* x, const void* w, const void* a,
                     const void* b, void* at, void* out, int64_t T, int64_t D,
                     int64_t O, int64_t R, float scaling, int64_t tma,
                     void* stream) {
  if (!wg_shapes_ok(T, D, O, R)) return static_cast<int>(cudaErrorInvalidValue);
  if (tma && !(D > 0 && D % 8 == 0 && O % 8 == 0 && aligned16(x) &&
               aligned16(w) && aligned16(b) && aligned16(at) &&
               aligned16(out)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t Dp = (D + 7) / 8 * 8;
  if (R * Dp > 0) {
    wg::transpose_a_kernel<<<static_cast<unsigned>((R * Dp + 255) / 256), 256,
                             0, st>>>(static_cast<const __nv_bfloat16*>(a),
                                      static_cast<__nv_bfloat16*>(at), D, R,
                                      Dp);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const wg::Args args{static_cast<const __nv_bfloat16*>(x),
                      static_cast<const __nv_bfloat16*>(w),
                      static_cast<const __nv_bfloat16*>(at),
                      static_cast<const __nv_bfloat16*>(b),
                      static_cast<__nv_bfloat16*>(out),
                      static_cast<int>(T),
                      static_cast<int>(D),
                      static_cast<int>(O),
                      static_cast<int>(R),
                      static_cast<int>(Dp),
                      scaling};
  return tma ? launch_rank<true>(args, st) : launch_rank<false>(args, st);
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
