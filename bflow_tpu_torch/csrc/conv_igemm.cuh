// Odd-window SAME convolution plus bias as an implicit GEMM on Hopper's
// warpgroup tensor-core instruction (wgmma, sm_90a). Shared by conv3x3.cu
// (stride 1) and stem_conv.cu (stride 2).
//
// The function: out[b, y, x, o] = bf16( sum_{ky, kx, c} bf16 x[b, S*y -
// kh/2 + ky, S*x - kw/2 + kx, c] * bf16 w[o, ky, kx, c] (f32 sums, zero
// outside the image) + f32 bias[o] ), optionally through a ReLU before the
// one rounding. Layouts: x (N, H, W, Cp) and out (N, Ho, Wo, O) are
// channels-last, the weight is (O, kh, kw, Cp), all bf16 and dense, with the
// input channels zero-padded to Cp, a multiple of 8; the bias is (O,) f32.
// The wrapper hands a channels-last activation over as it lies in memory
// and returns the output as a channels-last (N, O, Ho, Wo) tensor, so a
// chain of convs moves no layout.
//
// As a matrix product: M = N * Ho * Wo output pixels, N_ = O output
// channels, K = kh * kw * Cp ordered (ky, kx, c). Both operands are K-major
// as they lie: an A row is a pixel's taps, a B row is one output channel's
// weights. A is never materialised: each block gathers its (BM x 64) slice
// of the im2col patch from x, 8 channels of one tap (16 bytes) per
// cp.async, zero-filled where the tap falls outside the image, the row is
// past M or the column past K.
//
// Which launches run this loop: the stride-2 stems (stem_conv.cu), and of
// the stride-1 convs (conv3x3.cu) those that conv_pipe.cuh's persistent
// TMA pipeline does not take: launches of few 128-pixel tiles and inputs
// whose padded channels are not a multiple of 32 (convf1's 8). What bounds
// them on this card (H100 SXM: 132 SMs, 989 TFLOP/s bf16, 3.35 TB/s):
//   * the stems (M up to 384,000) and the encoders' convs of few tiles at
//     batch 1 (M = 9,600 to 38,400, K = 576 to 1,152) sit near the ridge:
//     their byte and operation bounds are within 2x of each other. In an
//     implicit GEMM every input byte is gathered kh*kw times and B is read
//     again by every block, so what the kernel feels is the L2-to-SM
//     traffic. The design: 128-pixel tiles (two warpgroups, each a 64-row
//     wgmma) that cover all output channels (BN = 64, 96 or 128), so A is
//     gathered once and B is read once per 128 pixels; two blocks per SM,
//     so one block's epilogue overlaps the other's loads.
//   * the update block's convs at 60x80 and batch 1 (M = 4,800, O = 64 to
//     384, K = 392 to 2,304) are 38 to 75 tiles for 132 SMs and a serial K
//     loop of up to 36 steps: bound by the latency of that chain and by
//     how many SMs take part. The design: 64-pixel tiles (one warpgroup)
//     with a deeper ring, output channels split over grid.y in the tile
//     width that gives the most blocks within one wave, and where SMs are
//     still idle, K split over the 2 or 4 blocks of a thread-block cluster
//     whose partial sums the first block adds up in rank order through
//     distributed shared memory (no atomics: the result is bitwise
//     repeatable).
// The host-side tile plan (kernels/conv_common.py:tile_plan) picks the
// variant from (M, O, K), launch_plan the loop.
//
// The pipeline: a ring of STAGES (A, B) tile pairs in dynamic shared
// memory, each row 64 bf16 = 128 bytes, written by the copies at
// 128-byte-swizzled addresses (16-byte chunk c of row r at chunk c ^ (r %
// 8)), which is what the wgmma shared-memory descriptors read without bank
// conflicts. All threads copy and all start MMAs: per K step one
// cp.async wait, one proxy fence, one __syncthreads, four m64nBNk16 wgmma
// per warpgroup (committed as one group, the previous group still in
// flight), then the copies of the tile STAGES - 2 steps ahead. Each thread
// copies one 16-byte column of four pixel rows and of BN / 16 or BN / 32
// weight rows; the rows' window origins are worked out once, and the
// column's tap (ky, kx, c) advances with the K step without a division
// (the divisions in the loop cost 8 to 15% of the kernel's time). The
// accumulators (BN / 2 f32 per thread) stay in registers; the epilogue
// adds the f32 bias, applies the ReLU, rounds once and stores two adjacent
// channels per thread straight from registers into the channels-last
// output.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace conv_igemm {

namespace cg = cooperative_groups;

constexpr int BK = 64;          // K step: one 128-byte swizzled row
constexpr int VEC = 8;          // bf16 per 16-byte copy
constexpr int CHUNKS = BK / VEC;
constexpr int ROW_BYTES = BK * 2;

struct Shape {
  int n, c, h, w;   // input, c = Cp (a multiple of 8)
  int o, ho, wo;    // output channels and size
  int kh, kw;       // window (odd), padding kh/2, kw/2
};

// 16 bytes from global to shared memory, zeros where !valid, past L1 (.cg)
// or through it (.ca)
__device__ __forceinline__ void cp_async16_cg(uint32_t smem, const void* gmem,
                                              bool valid) {
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async16_ca(uint32_t smem, const void* gmem,
                                              bool valid) {
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// orders the copies' (generic-proxy) writes to shared memory before the
// tensor cores' (async-proxy) reads of them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor of a K-major tile of 128-byte rows in
// the 128-byte swizzle: start address and strides in 16-byte units; the
// leading offset is unused for a swizzled K-major tile, the stride
// between 8-row groups is 1,024 bytes; bits 62-63 = 1 name the swizzle.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// D (64 x N, f32, registers) += A (64 x 16, shared) * B (N x 16, shared),
// both K-major bf16

__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                  uint64_t db) {
  asm volatile(
    "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
    "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
    "%27, %28, %29, %30, %31}, "
    "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n96k16(float (&d)[48], uint64_t da,
                                                  uint64_t db) {
  asm volatile(
    "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
    "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
    "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
    "%40, %41, %42, %43, %44, %45, %46, %47}, "
    "%48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                  uint64_t db) {
  asm volatile(
    "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
    "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
    "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
    "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
    "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
    "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
struct Mma;
template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    wgmma_m64n64k16(d, a, b);
  }
};
template <>
struct Mma<96> {
  static __device__ __forceinline__ void run(float (&d)[48], uint64_t a,
                                             uint64_t b) {
    wgmma_m64n96k16(d, a, b);
  }
};
template <>
struct Mma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a,
                                             uint64_t b) {
    wgmma_m64n128k16(d, a, b);
  }
};

template <int BM, int BN, int STAGES>
constexpr int smem_bytes() {
  // the ring, plus room to align its base to the swizzle's 1,024 bytes
  return STAGES * (BM + BN) * ROW_BYTES + 1024;
}

// A (BM x BN) output tile per block, BM = 64 or 128: one warpgroup per 64
// output pixels, each running a 64-row wgmma tile; gridDim = (M tiles, N
// tiles, K splits), with the K splits one cluster. A 256-pixel tile (two
// wgmma tiles per warpgroup, B read once per 256 pixels) was no faster on
// an H100 at any flagship shape: it leaves one block per SM.
template <int S, int BM, int BN, int STAGES>
__global__ void __launch_bounds__(2 * BM, BM == 64 ? 3 : 2)
conv_igemm_kernel(const uint16_t* __restrict__ x,
                  const uint16_t* __restrict__ wt,
                  const float* __restrict__ bias,
                  __nv_bfloat16* __restrict__ out, Shape s, int relu) {
  constexpr int THREADS = 2 * BM;
  constexpr int ROWS_PER_PASS = THREADS / CHUNKS;  // a multiple of 8
  constexpr int A_PASSES = BM / ROWS_PER_PASS;
  constexpr int B_PASSES = BN / ROWS_PER_PASS;
  constexpr int A_BYTES = BM * ROW_BYTES;
  constexpr int STAGE_BYTES = (BM + BN) * ROW_BYTES;
  constexpr int ACC = BN / 2;
  static_assert(BM == 64 || BM == 128, "one or two warpgroups");
  static_assert(BN % ROWS_PER_PASS == 0 && BN % 8 == 0, "B rows per thread");
  static_assert(ACC * THREADS * 4 <= STAGES * STAGE_BYTES,
                "the split-K partial sums reuse the ring");

  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;

  const int K = s.kh * s.kw * s.c;
  const int hw_out = s.ho * s.wo;
  const int M = s.n * hw_out;  // the launch refuses 2^31 pixels and more
  const int m_base = blockIdx.x * BM;
  const int n_base = blockIdx.y * BN;
  const int tid = threadIdx.x;

  // this block's K steps
  const int k_tiles = (K + BK - 1) / BK;
  const int per_split = (k_tiles + (int)gridDim.z - 1) / (int)gridDim.z;
  const int t_begin = (int)blockIdx.z * per_split;
  const int steps = max(0, min(k_tiles, t_begin + per_split) - t_begin);

  // copies of this thread: the 16-byte chunk kv of rows r0 + ROWS_PER_PASS
  // * j of A (pixels) and of B (output channels); r0 % 8 is every such
  // row's swizzle phase
  const int kv = tid % CHUNKS;
  const int r0 = tid / CHUNKS;
  const uint32_t chunk_off = r0 * ROW_BYTES + ((kv ^ (r0 & 7)) << 4);
  const uint16_t* xrow[A_PASSES];  // the row's window origin in x
  int iy0[A_PASSES], ix0[A_PASSES];
#pragma unroll
  for (int j = 0; j < A_PASSES; ++j) {
    const int gm = m_base + r0 + ROWS_PER_PASS * j;
    const bool m_ok = gm < M;
    const int b = m_ok ? gm / hw_out : 0;
    const int p = m_ok ? gm - b * hw_out : 0;
    const int oy = p / s.wo;
    const int ox = p - oy * s.wo;
    iy0[j] = m_ok ? oy * S - s.kh / 2 : -(1 << 20);  // never inside
    ix0[j] = ox * S - s.kw / 2;
    xrow[j] = x + (((int64_t)b * s.h + iy0[j]) * s.w + ix0[j]) * s.c;
  }
  const uint16_t* wrow = wt + (int64_t)(n_base + r0) * K + kv * VEC;

  // with fewer than 64 channels a K step spans several taps, whose
  // windows overlap: L1 serves the repeats (1.2x to 1.3x faster on the 7x7
  // stems, H100); with 64 or more it only costs (5 to 10% on the 3x3s)
  const bool through_l1 = s.c < BK;

  // this thread's chunk of the next tile to load, as (ky, kx, c): tiles
  // are loaded in order, so it advances by one K step per load_stage
  int ky, kx, kc;
  {
    const int k = t_begin * BK + kv * VEC;
    const int tap = k / s.c;
    kc = k - tap * s.c;
    ky = tap / s.kw;
    kx = tap - ky * s.kw;
  }

  auto load_stage = [&](int stage, int t) {
    const bool k_ok = ky < s.kh;  // K is a multiple of 8: all 8 in or out
    const int off = (ky * s.w + kx) * s.c + kc;
    const uint32_t a_dst = ring + stage * STAGE_BYTES + chunk_off;
#pragma unroll
    for (int j = 0; j < A_PASSES; ++j) {
      const bool ok = k_ok && (unsigned)(iy0[j] + ky) < (unsigned)s.h &&
                      (unsigned)(ix0[j] + kx) < (unsigned)s.w;
      const void* src = ok ? (const void*)(xrow[j] + off) : (const void*)x;
      if (through_l1)
        cp_async16_ca(a_dst + j * ROWS_PER_PASS * ROW_BYTES, src, ok);
      else
        cp_async16_cg(a_dst + j * ROWS_PER_PASS * ROW_BYTES, src, ok);
    }
    const uint32_t b_dst = a_dst + A_BYTES;
#pragma unroll
    for (int j = 0; j < B_PASSES; ++j) {
      const int row = ROWS_PER_PASS * j;
      const bool ok = k_ok && n_base + r0 + row < s.o;
      cp_async16_cg(b_dst + row * ROW_BYTES,
                    ok ? (const void*)(wrow + (int64_t)row * K + t * BK)
                       : (const void*)wt,
                    ok);
    }
    // one K step on: with 64 channels or more at most one tap further
    kc += BK;
    if (s.c >= BK) {
      if (kc >= s.c) {
        kc -= s.c;
        if (++kx == s.kw) {
          kx = 0;
          ++ky;
        }
      }
    } else {
      const int taps_on = kc / s.c;
      kc -= taps_on * s.c;
      kx += taps_on;
      const int rows_on = kx / s.kw;
      kx -= rows_on * s.kw;
      ky += rows_on;
    }
  };

  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

  const int wg = tid / 128;
#pragma unroll
  for (int st = 0; st < STAGES - 2; ++st) {
    if (st < steps) load_stage(st, t_begin + st);
    cp_async_commit();
  }
  for (int i = 0; i < steps; ++i) {
    // tile i has landed (one group per step, the newest STAGES - 3 may
    // still fly) and, past the barrier, is visible to every warpgroup;
    // every warpgroup has also finished the MMAs of step i - 2, whose
    // stage the copies below refill
    cp_async_wait<STAGES - 3>();
    fence_proxy_async();
    __syncthreads();
    const uint32_t stage = ring + (i % STAGES) * STAGE_BYTES;
    const uint64_t da = smem_desc(stage + wg * 64 * ROW_BYTES);
    const uint64_t db = smem_desc(stage + A_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)  // 16 bf16 = 32 bytes = 2 units
      Mma<BN>::run(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    const int ahead = i + STAGES - 2;
    if (ahead < steps) load_stage(ahead % STAGES, t_begin + ahead);
    cp_async_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(acc[i])::"memory");

  if (gridDim.z > 1) {
    // split K: ranks 1.. park their partial sums in their own shared
    // memory, rank 0 adds them in rank order and writes the tile
    cg::cluster_group cluster = cg::this_cluster();
    float* part = reinterpret_cast<float*>(
        smem_raw + (ring - (uint32_t)__cvta_generic_to_shared(smem_raw)));
    const unsigned rank = cluster.block_rank();
    __syncthreads();  // every warpgroup is done reading the ring
    if (rank != 0) {
#pragma unroll
      for (int i = 0; i < ACC; ++i) part[i * THREADS + tid] = acc[i];
    }
    cluster.sync();
    if (rank == 0) {
      for (unsigned r = 1; r < cluster.num_blocks(); ++r) {
        const float* remote = cluster.map_shared_rank(part, r);
#pragma unroll
        for (int i = 0; i < ACC; ++i) acc[i] += remote[i * THREADS + tid];
      }
    }
    cluster.sync();  // ranks 1.. stay until rank 0 has read them
    if (rank != 0) return;
  }

  // epilogue: accumulator 4 * j + {0, 1} is row lane / 4 of the warp's 16
  // rows, columns 8 * j + 2 * (lane % 4) + {0, 1}; 4 * j + {2, 3} the
  // same columns 8 rows below
  const int lane = tid % 32;
  const int row0 = (tid / 32) * 16 + lane / 4;  // in the block's tile
  const int col0 = n_base + 2 * (lane % 4);
  const bool pair = s.o % 2 == 0;  // 4-byte stores stay aligned
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = m_base + row0 + 8 * half;
    if (m >= M) continue;
    __nv_bfloat16* dst = out + (int64_t)m * s.o;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = col0 + 8 * j;
      if (col >= s.o) continue;
      const bool two = col + 1 < s.o;
      float v0 = acc[4 * j + 2 * half] + __ldg(bias + col);
      float v1 = acc[4 * j + 2 * half + 1] + (two ? __ldg(bias + col + 1) : 0.f);
      if (relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      if (pair && two) {
        *reinterpret_cast<__nv_bfloat162*>(dst + col) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        dst[col] = __float2bfloat16(v0);
        if (two) dst[col + 1] = __float2bfloat16(v1);
      }
    }
  }
}

template <int S, int BM, int BN, int STAGES>
int launch_variant(const void* x, const void* w, const void* bias, void* out,
                   const Shape& s, int relu, int split, cudaStream_t stream) {
  auto kern = conv_igemm_kernel<S, BM, BN, STAGES>;
  constexpr int smem = smem_bytes<BM, BN, STAGES>();
  static int configured_device = -1;  // the attribute is per device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device != configured_device) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured_device = device;
  }
  const int64_t M = (int64_t)s.n * s.ho * s.wo;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((M + BM - 1) / BM),
                     (unsigned)((s.o + BN - 1) / BN), (unsigned)split);
  cfg.blockDim = dim3(2 * BM);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = (unsigned)split;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kern, (const uint16_t*)x,
                           (const uint16_t*)w, (const float*)bias,
                           (__nv_bfloat16*)out, s, relu);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// x (n, h, w, cp) bf16 with cp a multiple of 8, w (o, kh, kw, cp) bf16,
// bias (o,) f32, out (n, ho, wo, o) bf16 with ho = (h - 1) / S + 1,
// wo = (w - 1) / S + 1 (SAME padding kh/2, kw/2 with odd windows), all
// dense and 16-byte aligned. The tile variant: bm output pixels (64 or 128)
// and bn output channels (64, 96 or 128) per block, split blocks of a
// cluster sharing K (1, 2 or 4). Returns a cudaError_t: an unknown
// variant or shape is cudaErrorInvalidValue, a refused launch its error.
template <int S>
int launch(const void* x, const void* w, const void* bias, void* out, int n,
           int cp, int h, int wd, int o, int kh, int kw, int relu, int bm,
           int bn, int split, void* stream) {
  if (kh % 2 == 0 || kw % 2 == 0 || kh < 1 || kw < 1 || cp % VEC != 0 ||
      (split != 1 && split != 2 && split != 4))
    return (int)cudaErrorInvalidValue;
  const Shape s{n, cp, h, wd, o, (h - 1) / S + 1, (wd - 1) / S + 1, kh, kw};
  const int64_t M = (int64_t)n * s.ho * s.wo;
  if (M >= (1ll << 31) - 128) return (int)cudaErrorInvalidValue;
  if (M == 0 || o == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  switch (bm * 1000 + bn) {
    case 64064:
      return launch_variant<S, 64, 64, 6>(x, w, bias, out, s, relu, split, st);
    case 64096:
      return launch_variant<S, 64, 96, 5>(x, w, bias, out, s, relu, split, st);
    case 64128:
      return launch_variant<S, 64, 128, 4>(x, w, bias, out, s, relu, split,
                                           st);
    case 128064:
      return launch_variant<S, 128, 64, 4>(x, w, bias, out, s, relu, split,
                                           st);
    case 128096:
      return launch_variant<S, 128, 96, 4>(x, w, bias, out, s, relu, split,
                                           st);
    case 128128:
      return launch_variant<S, 128, 128, 3>(x, w, bias, out, s, relu, split,
                                            st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace conv_igemm
