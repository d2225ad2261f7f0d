// The motion encoder's convc1 over the correlation lookups, for Hopper
// (sm_90a): out[m, o] = bf16( relu( sum_k bf16 x[m, k] * bf16 w[o, k] (f32
// sums) + f32 bias[o] ) ), with x the lookup kernel's (N, h1, w1, K) bf16
// map as it lies (M = N * h1 * w1 rows of K channels, row pitch K) and the
// output (M, 256) bf16, which the wrapper returns as the channels-last
// (N, 256, h1, w1) view that convc2's conv kernel reads in place. ReLU
// comes before the one rounding, which it commutes with.
//
// Replaces no TPU kernel: the JAX package leaves this einsum, bf16 operands
// with f32 accumulation (bflow_tpu/models/update.py, fuse_corr_conv), to
// XLA, which runs it on the TPU's matrix unit. PyTorch has no bf16-operand
// product with an f32 bias and f32 output in one call, so the port ran it
// as an f32 addmm of the bf16-rounded operands: cuBLAS's FFMA SGEMM, near
// the 67 TFLOP/s f32 rate, plus an f32 copy of the map and casts around it.
//
// Bound: bytes. At the flagship's B=16 (M = 76,800, K = 891) a launch
// reads the map once (136.9 MB) and the weight (0.46 MB) and writes the
// output (39.3 MB): 0.0527 ms at 3.35 TB/s, against 0.0354 ms of
// operations at 989 TFLOP/s.
//
// Design:
// - One tile is 128 rows and all 256 output channels, so the map is read
//   from device memory exactly once: two consumer warpgroups of 64 rows,
//   each running two m64n128k16 wgmma per 16 columns of K (128 f32
//   accumulators a thread, 232 registers by setmaxnreg), and a producer
//   warpgroup (40 registers) whose two threads keep two rings full with
//   TMA: the map's K steps (freed as soon as the fragments are in
//   registers, so 6 steps stay in flight) and the weight's (freed once the
//   MMAs that read them are done). The grid is persistent, one block per
//   SM, tiles strided over the blocks, and sized so that every block takes
//   the same number of tiles or one fewer (B=16: 600 tiles on 120 blocks,
//   not 132 blocks with a last round on 72); the producers load the next
//   tile while the consumers run the last tile's epilogue.
// - The map's row pitch (K = 891 bf16, 1,782 bytes) is only 2-byte
//   aligned, and TMA starts a box only at a 16-byte aligned column, so no
//   tensor map addresses a row's K window directly. But 8 consecutive rows
//   are one contiguous, 16-byte aligned span: the map is described to TMA
//   as (M / 8) super-rows of 8 K elements (pitch 16 K bytes), and a K step
//   of sub-row j (0..7) is the box of 72 elements starting at column
//   j K + 64 t rounded down to a multiple of 8, for 16 consecutive
//   super-rows: the step's 64 elements sit at element d_j = j K mod 8 of
//   each 144-byte box row. Eight boxes fill a tile's 128 rows in the order
//   (j, super-row); warp w of the block holds box j = w, so d_j is the
//   same for every lane of a warp. No padding copy of the map is made, and
//   TMA reads nothing past it (the overhang is out of bounds: zero-filled).
//   The map's boxes carry no L2 eviction hint: consecutive K steps of a
//   row share the 256-byte sectors that the L2 promotes (evict-first cost
//   12% in re-reads, H100).
// - A goes to the tensor cores from registers (wgmma's A-in-registers
//   form): each thread reads its fragment with 32-bit shared loads and
//   byte permutes, which undo the odd offset d_j. The K columns of every 16
//   are permuted (once, in the prepared weight) so that the four values a
//   thread holds for a row are 4 adjacent elements: 3 loads and 2 permutes
//   a row and 16 columns. In the last K step the columns past K (the next
//   row's elements, or TMA's zeros) are masked to exactly 0. Two sets of
//   fragments alternate: one feeds the MMAs while the next step's loads.
// - B, the weight, is prepared once per parameter value
//   (kernels/corr_proj.py) as (256, Kp) bf16, zero-padded to a multiple of
//   64 columns and permuted as above, and streamed by K step from the L2
//   in the 128-byte swizzle the wgmma descriptors read (0.46 MB, kept
//   there with an evict-last hint).
// - Epilogue: the f32 bias, the ReLU and one rounding in registers, then
//   through a 2 KB staging area a warp, swizzled so that neither its
//   writes nor its reads conflict on banks, into 16-byte stores of whole
//   256-byte row segments (the direct 4-byte stores of rows 8 apart cost
//   a third of the kernel's time). Rows past M are zero-filled by TMA and
//   not stored.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_igemm.cuh"
#include "sm90.cuh"

namespace {

using conv_igemm::smem_desc;
using conv_igemm::wgmma_commit;
using conv_igemm::wgmma_fence;
using conv_igemm::wgmma_wait;
using sm90::l2_policy_evict_last;
using sm90::lds128;
using sm90::lds32;
using sm90::make_map;
using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::regs_dec;
using sm90::regs_inc;
using sm90::Ring;
using sm90::smem_u32;
using sm90::sts32;
using sm90::tma_load_2d;

constexpr int O = 256;              // output channels, all in one tile
constexpr int BK = conv_igemm::BK;  // K step: 64 bf16
constexpr int B_ROW = 2 * BK;       // bytes of a weight row in shared memory
constexpr int SUB = 8;              // map rows per super-row
constexpr int BM = 128;             // map rows per tile
constexpr int BOX = BM / SUB;       // super-rows per box
constexpr int BOX_COLS = BK + 8;    // a K step and its offset within 16 bytes
constexpr int A_ROW = 2 * BOX_COLS;  // bytes of a box row in shared memory
constexpr int CONSUMERS = BM / 64;  // warpgroups, 64 rows each
constexpr int THREADS = (CONSUMERS + 1) * 128;  // + the producer warpgroup
// registers a thread: the producer's warpgroup gives its own to the
// consumers' 128 accumulators and two sets of A fragments
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
static_assert(128 * PRODUCER_REGS + CONSUMERS * 128 * CONSUMER_REGS <= 65536,
              "the register file");
// two rings: the map's K steps, freed once the fragments are in registers,
// and the weight's, freed once the MMAs that read them are done
constexpr int A_STAGES = 6;
constexpr int B_STAGES = 3;
constexpr int A_BYTES = BM * A_ROW;
constexpr int B_BYTES = O * B_ROW;
// the epilogue's staging: per consumer warp 8 rows of 128 output channels
constexpr int OUT_ROW = 2 * 128;
constexpr int STAGING = 8 * OUT_ROW;
// the weight's ring first, aligned to the swizzle's 1,024 bytes, then the
// map's, the staging and the barriers
constexpr int SMEM_BYTES = 1024 + B_STAGES * B_BYTES + A_STAGES * A_BYTES +
                           4 * CONSUMERS * STAGING +
                           2 * (A_STAGES + B_STAGES) * 8;
static_assert(B_BYTES % 1024 == 0, "the swizzle's 1,024 bytes");

// 8 bytes of shared memory at a 2-byte aligned address, as two words
__device__ __forceinline__ void lds64_any(uint32_t addr, uint32_t& lo,
                                          uint32_t& hi) {
  const uint32_t base = addr & ~3u;
  const uint32_t sel = (addr & 2u) ? 0x5432u : 0x3210u;
  const uint32_t w0 = lds32(base), w1 = lds32(base + 4), w2 = lds32(base + 8);
  lo = __byte_perm(w0, w1, sel);
  hi = __byte_perm(w1, w2, sel);
}

// the two bf16 of v whose columns are col and col + 1, zero past k
__device__ __forceinline__ uint32_t keep_below(uint32_t v, int col, int k) {
  return col + 1 < k ? v : (col < k ? v & 0xFFFFu : 0u);
}

// D (64 x 128, f32, registers) += A (64 x 16, registers: this thread's
// a0..a3) * B (128 x 16, shared, K-major)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
    "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
    "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
    "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
    "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
    "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
    "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// this thread's A fragments of one K step (t of k_tiles) from the stage at
// at: a0, a2 of row i, a1, a3 of row i + 8 (at + 8 box rows), per 16
// columns; in the last step the columns past k are zero
__device__ __forceinline__ void load_frags(uint32_t (&f)[BK / 16][4],
                                           uint32_t at, int t, int k_tiles,
                                           int k, int quad) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    lds64_any(at + 32 * kk, f[kk][0], f[kk][2]);
    lds64_any(at + 32 * kk + 8 * A_ROW, f[kk][1], f[kk][3]);
  }
  if (t == k_tiles - 1 && k % BK != 0) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const int col = t * BK + 16 * kk + 4 * quad;
      f[kk][0] = keep_below(f[kk][0], col, k);
      f[kk][1] = keep_below(f[kk][1], col, k);
      f[kk][2] = keep_below(f[kk][2], col + 2, k);
      f[kk][3] = keep_below(f[kk][3], col + 2, k);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
corr_proj_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_w,
                 const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, int m, int k) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t b_ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t a_ring = b_ring + B_STAGES * B_BYTES;
  const uint32_t staging = a_ring + A_STAGES * A_BYTES;
  const uint32_t bars = staging + 4 * CONSUMERS * STAGING;
  // full: the stage's bytes have landed; empty: every consumer warp is done
  // with it
  Ring a_ring_bars{bars, A_STAGES};
  Ring b_ring_bars{bars + 16u * A_STAGES, B_STAGES};

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int k_tiles = (k + BK - 1) / BK;
  const int tiles = (m + BM - 1) / BM;

  if (tid == 0) {
    a_ring_bars.init(4 * CONSUMERS);
    b_ring_bars.init(4 * CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * CONSUMERS) {  // the producers: one thread for each ring
    regs_dec<PRODUCER_REGS>();
    if (lane != 0 || warp > 4 * CONSUMERS + 1) return;
    const bool map = warp == 4 * CONSUMERS;
    Ring r = map ? a_ring_bars : b_ring_bars;
    const uint64_t keep = l2_policy_evict_last();
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      for (int t = 0; t < k_tiles; ++t) {
        // a fresh barrier passes the wait on the phase before its first
        mbar_wait(r.empty(), r.phase ^ 1);
        if (map) {
          const uint32_t a = a_ring + r.stage * A_BYTES;
          mbar_expect_tx(r.full(), A_BYTES);
#pragma unroll
          for (int j = 0; j < SUB; ++j)
            tma_load_2d(a + j * BOX * A_ROW, &map_x, (j * k + t * BK) & ~7,
                        tile * BOX, r.full());
        } else {
          mbar_expect_tx(r.full(), B_BYTES);
          tma_load_2d(b_ring + r.stage * B_BYTES, &map_w, t * BK, 0,
                      r.full(), keep);
        }
        r.next();
      }
    }
    return;
  }

  // the consumers: warp w (warpgroup w / 4) holds box j = w, the tile's
  // rows 8 i + j for i = 0..15; lane holds rows i = lane / 4 and + 8, and
  // the four permuted columns 4 (lane % 4) .. + 3 of every 16
  regs_inc<CONSUMER_REGS>();
  const int j = warp;
  const int quad = lane % 4;
  const int lead = (j * k) & 7;  // the step's first element in a box row
  const uint32_t a_off =
      j * BOX * A_ROW + (lane / 4) * A_ROW + 2 * lead + 8 * quad;
  float acc[2][64];
  uint32_t frag[2][BK / 16][4];  // two K steps: one in the MMAs, one loading
  Ring ra = a_ring_bars, rb = b_ring_bars;
  // the fragments of step t into f; the map's stage is free once every
  // lane has them
  auto load = [&](uint32_t (&f)[BK / 16][4], int t) {
    mbar_wait(ra.full(), ra.phase);
    load_frags(f, a_ring + ra.stage * A_BYTES + a_off, t, k_tiles, k, quad);
    __syncwarp();
    if (lane == 0) mbar_arrive(ra.empty());
    ra.next();
  };
  // the MMAs of step t (fragments f) with its weight stage; while they
  // run, step t + 1's fragments are loaded into g, once step t - 1's MMAs,
  // which read g, are done and have freed their weight stage
  auto step = [&](int t, uint32_t (&f)[BK / 16][4], uint32_t (&g)[BK / 16][4]) {
    mbar_wait(rb.full(), rb.phase);
    const uint32_t st = b_ring + rb.stage * B_BYTES;
    const uint64_t db0 = smem_desc(st);
    const uint64_t db1 = smem_desc(st + 128 * B_ROW);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {  // 16 bf16 = 2 descriptor units
      wgmma_m64n128k16_rs(acc[0], f[kk], db0 + 2 * kk);
      wgmma_m64n128k16_rs(acc[1], f[kk], db1 + 2 * kk);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (t > 0 && lane == 0) mbar_arrive(rb.empty_before());
    rb.next();
    if (t + 1 < k_tiles) load(g, t + 1);
  };
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[n][i] = 0.f;
    load(frag[0], 0);
    int t = 0;
    for (; t + 1 < k_tiles; t += 2) {
      step(t, frag[0], frag[1]);
      step(t + 1, frag[1], frag[0]);
    }
    if (t < k_tiles) step(t, frag[0], frag[1]);
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(rb.empty_before());
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(acc[n][i])::"memory");

    // epilogue, in four rounds of 8 rows and 128 channels through the
    // warp's staging: accumulator 4 jj + {0, 1} of half n is row i =
    // lane / 4, channels 128 n + 8 jj + 2 (lane % 4) + {0, 1}; 4 jj + {2, 3}
    // the same channels of row i + 8; map row tile * BM + 8 i + j. A lane
    // writes its bf16 pairs into 16-byte chunk jj ^ (i % 8) of staging row
    // i % 8 (no bank conflicts), then the warp stores whole 256-byte runs
    // of two rows at a time, 16 bytes a lane
    const uint32_t mine = staging + warp * STAGING;
    const int g = lane / 4;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __syncwarp();  // the last round's reads are done
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          const int col = 128 * n + 8 * jj + 2 * quad;
          const float2 b = __ldg(reinterpret_cast<const float2*>(bias + col));
          const float v0 = fmaxf(acc[n][4 * jj + 2 * h] + b.x, 0.f);
          const float v1 = fmaxf(acc[n][4 * jj + 2 * h + 1] + b.y, 0.f);
          const __nv_bfloat162 pair = __floats2bfloat162_rn(v0, v1);
          sts32(mine + g * OUT_ROW + ((jj ^ g) << 4) + 4 * quad,
                *reinterpret_cast<const uint32_t*>(&pair));
        }
        __syncwarp();
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = lane / 16 + 2 * r;  // staging row
          const int c = lane % 16;          // 16-byte chunk: channels 8 c ..
          const uint4 v = lds128(mine + i * OUT_ROW + ((c ^ i) << 4));
          const int row = tile * BM + SUB * (i + 8 * h) + j;
          if (row < m)
            *reinterpret_cast<uint4*>(out + (int64_t)row * O + 128 * n +
                                      8 * c) = v;
        }
      }
    }
  }
}

}  // namespace

// x (m, k) bf16, dense, 16-byte aligned, m a multiple of 8; w (256, kp) bf16
// with kp = k rounded up to a multiple of 64, the columns past k zero and
// the columns of every 16 permuted (kernels/corr_proj.py:_prepare); bias
// (256,) f32; out (m, 256) bf16. Returns a cudaError_t: an argument the
// kernel does not take is cudaErrorInvalidValue, a refused launch its
// error.
extern "C" int corr_proj_bf16(const void* x, const void* w, const void* bias,
                              void* out, int m, int k, int kp, void* stream) {
  if (m < 0 || m % SUB != 0 || k < 1 || kp != (k + BK - 1) / BK * BK ||
      (uintptr_t)x % 16 != 0 || (uintptr_t)w % 16 != 0 ||
      (uintptr_t)bias % 8 != 0 || (uintptr_t)out % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  static int configured_device = -1;  // the attribute is per device
  static int sms = 0;
  if (device != configured_device) {
    err = cudaFuncSetAttribute(corr_proj_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return (int)err;
    configured_device = device;
  }
  CUtensorMap map_x, map_w;
  if (!make_map(&map_x, x, (uint64_t)m / SUB, (uint64_t)SUB * k, BOX,
                BOX_COLS, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B) ||
      !make_map(&map_w, w, O, (uint64_t)kp, O, BK,
                CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B))
    return (int)cudaErrorInvalidValue;
  // as few rounds of tiles as the SMs allow, and as few blocks as give
  // that: every block takes the same number of tiles, or one fewer
  const int tiles = (m + BM - 1) / BM;
  const int rounds = (tiles + sms - 1) / sms;
  const int grid = (tiles + rounds - 1) / rounds;
  corr_proj_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      map_x, map_w, (const float*)bias, (__nv_bfloat16*)out, m, k);
  return (int)cudaGetLastError();
}
