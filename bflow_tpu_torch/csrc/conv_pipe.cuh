// The stride-1 conv's main loop for launches of many 128-pixel tiles: a
// TMA-fed, warp-specialised, persistent wgmma pipeline (sm_90a). Included
// by conv3x3.cu beside conv_igemm.cuh's loop, which keeps the launches of
// few tiles (the update block at batch 1, where the latency of a short
// serial chain on few SMs bounds them), inputs whose padded channels are
// not a multiple of 32 (convf1's 8) and the stride-2 stems.
//
// The function is conv_igemm.cuh's: out[b, y, x, o] = bf16( sum_{ky, kx, c}
// x[b, y - kh/2 + ky, x - kw/2 + kx, c] * w[o, ky, kx, c] (f32 sums, zero
// outside the image) + f32 bias[o] ), with an optional ReLU before the one
// rounding; x (N, H, W, Cp), w (O, kh, kw, Cp) and out (N, H, W, O) bf16
// channels-last, bias (O,) f32. The products are issued in the same order,
// the k16 slices of K = (ky, kx, c) one after another into one f32
// accumulator per output, so the output is bit-equal to that loop's
// without a K split.
//
// What bounds it (H100 SXM: 132 SMs, 989 TFLOP/s bf16, 3.35 TB/s): the
// encoders' 64->64 convs at 240x320 sit on the ridge (their operation and
// byte bounds within 3% of each other), the update block's at 60x80 are
// bound by operations. What is left over the bound is shared-memory
// traffic: an m64nBNk16 wgmma reads its A and B slices from shared memory
// (4 KB for 64 output channels, as much as the tensor cores' time for it
// allows), TMA writes every K step's A (each input pixel kh*kw times) and
// B there, and the epilogue passes the output through it. Taking turns
// between the consumer warpgroups, so that one's epilogue overlaps the
// other's MMAs, did not pay (64->64: no faster; 128 channels: 1.5x
// slower).
//
// Design:
// - An output tile is 128 pixels by BN channels: two 4-row x 16-column
//   patches of one image, one a consumer warpgroup (a 64-row m64nBNk16
//   wgmma tile), so that a tap's rows of A are one 4-D TMA box over the
//   NHWC input, (64 channels, 16, 4, 1) at (c0, x0 + kx - kw/2, y0 + ky -
//   kh/2, b): the TMA unit writes it in the 128-byte swizzle that the wgmma
//   descriptors read, and zero-fills what lies outside the image, so no
//   border is masked. Patches are numbered over (b, H / 4, W / 16) rounded
//   up: 60 rows are 15 patches; a patch past the image's edge is stored in
//   part. A K step is 64 channels of one tap; where Cp is 32 more than a
//   multiple of 64 (96), a tap's last step is 32 channels in the 64-byte
//   swizzle (boxes of 32 channels, half a stage).
// - Where Cp is 64, the output channels are at most 64 and W is a multiple
//   of 64 (the encoders' 64->64 3x3s), a tile is two 64-pixel strips of an
//   image row instead and a stage one window row ky: one (64, 64 + kw - 1,
//   1, 1) box a strip, which the kw taps read from row kx on (descriptors
//   started kx rows later: TMA's swizzle follows the address, so the
//   descriptors' base offset stays 0). A is read from the L2 kh times
//   instead of kh*kw.
// - A producer warp (one thread) keeps a ring of STAGES K steps in flight,
//   each (A of both patches, B's (BN x 64) slice by a 2-D TMA box, kept in
//   the L2 with an evict-last hint); full and empty mbarriers a stage, no
//   block barrier in the loop. Where the whole weight of a conv with O <= 64
//   fits beside the ring (the 64->64 3x3s: 72 KB), it is loaded once for
//   the block's life and only A streams.
// - Two consumer warpgroups (setmaxnreg moves the producer's registers to
//   them) run 4 wgmma a K step and free the stage of the step before once
//   its MMAs are done: one group stays in flight behind the next.
// - Persistent: a grid of at most one block per SM walks the tiles in a
//   static order (tile = blockIdx.x + i * gridDim.x, output channels
//   fastest so that tiles that share A run together); no atomics. The
//   producer runs ahead across tiles, so tile i's epilogue overlaps tile
//   i + 1's loads.
// - Epilogue: the f32 bias, the ReLU and one rounding in registers, each
//   warp's 16 pixels (one image row of its patch) through its own padded
//   staging rows in shared memory (no bank conflicts), then stored as
//   whole channel runs, 16 bytes a lane where O is a multiple of 8 (8, 4 or
//   2 bytes otherwise).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_igemm.cuh"
#include "sm90.cuh"

namespace conv_pipe {

using namespace sm90;

constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory a block may use
constexpr int BK = 64;              // channels a K step (a 128-byte row)
constexpr int ROW = 2 * BK;
constexpr int PATCH_H = 4;          // a consumer warpgroup's output patch
constexpr int PATCH_W = 16;
constexpr int STRIP_W = 64;         // its output strip (STRIP)
constexpr int STRIP_BYTES = 9216;   // a strip's window: 72 rows of 128 bytes
constexpr int CONSUMERS = 2;
constexpr int THREADS = (CONSUMERS + 1) * 128;  // + the producer warpgroup
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
static_assert(128 * PRODUCER_REGS + CONSUMERS * 128 * CONSUMER_REGS <= 65536,
              "the register file");

struct Geometry {
  int n, h, w, c;        // input (N, H, W, Cp)
  int o, kh, kw;         // output channels, window
  int px, py, patches;   // patches (strips) across W, down H, in all
  int n_tiles, tiles;    // channel tiles, tiles
  int full, steps;       // a tap's 64-channel steps, and with the 32 left
  int stages;            // stages a tile: kh kw steps, or kh (STRIP)
  int vw;                // bf16 a store: 8, 4, 2 or 1 (O's alignment)
};

// shared memory of a variant: the ring, the staging, the barriers, then
// (RESIDENT) the whole weight, each aligned to the swizzle's 1,024 bytes
template <int BN, bool RESIDENT, bool STRIP>
struct Layout {
  static_assert(!STRIP || RESIDENT, "a strip reads the weight resident");
  // one patch's A, or a strip's window of 64 + kw - 1 input pixels
  static constexpr int PATCH = STRIP ? STRIP_BYTES : 64 * ROW;
  static constexpr int A_BYTES = CONSUMERS * PATCH;
  static constexpr int B_BYTES = BN * ROW;  // one K step of B
  static constexpr int STAGE = A_BYTES + (RESIDENT ? 0 : B_BYTES);
  static constexpr int SROW = 2 * BN + 16;  // a staging row, padded
  static constexpr int STAGING = 4 * CONSUMERS * 16 * SROW;
  static constexpr int FIXED = 1024 + STAGING + 1024;  // align, barriers
  static constexpr int MOST = STRIP ? 6 : 8;
  static constexpr int FIT = (SMEM_LIMIT - FIXED) / STAGE;
  static constexpr int STAGES = FIT < MOST ? FIT : MOST;
  static constexpr int BASE = FIXED + STAGES * STAGE;  // without the weight
  static_assert(STAGE % 1024 == 0 && STAGING % 1024 == 0, "alignment");
  static_assert(STAGES >= 4, "a ring of four stages at least");
};

// Shared-memory descriptor of a K-major tile of R-byte rows in the R-byte
// swizzle: start address and the stride between 8-row groups in 16-byte
// units, the leading offset unused; bits 62-63 name the swizzle (1: 128
// bytes, 2: 64 bytes).
template <int R>
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  static_assert(R == 128 || R == 64, "a swizzled row");
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(8 * R / 16) << 32) | ((R == 128 ? 1ull : 2ull) << 62);
}

// patch (strip) p's image and its top-left output pixel; past the last
// patch the image index is n, whose boxes read zeros
template <bool STRIP>
__device__ __forceinline__ void patch_origin(const Geometry& g, int p, int& b,
                                             int& y0, int& x0) {
  const int per = g.px * g.py;
  b = p / per;
  const int r = p - b * per;
  const int yy = r / g.px;
  y0 = yy * (STRIP ? 1 : PATCH_H);
  x0 = (r - yy * g.px) * (STRIP ? STRIP_W : PATCH_W);
}

// a warp's 16 pixels of one image row from its staging rows to out (row:
// the first pixel's first channel of this tile), VW bf16 a store
template <int VW, int BN>
__device__ __forceinline__ void store_row(__nv_bfloat16* row, int o,
                                          uint32_t stg, int pixels, int cols,
                                          int lane) {
  constexpr int PER = BN / VW;  // stores a pixel
  constexpr int SROW = 2 * BN + 16;
  for (int s = lane; s < PATCH_W * PER; s += 32) {
    const int px = s / PER;
    const int cv = s - px * PER;
    if (px >= pixels || cv * VW >= cols) continue;
    const uint32_t src = stg + px * SROW + cv * VW * 2;
    __nv_bfloat16* dst = row + (int64_t)px * o + cv * VW;
    if constexpr (VW == 8) {
      *reinterpret_cast<uint4*>(dst) = lds128(src);
    } else if constexpr (VW == 4) {
      *reinterpret_cast<uint2*>(dst) = lds64(src);
    } else if constexpr (VW == 2) {
      *reinterpret_cast<uint32_t*>(dst) = lds32(src);
    } else {
      *reinterpret_cast<uint16_t*>(dst) = lds16(src);
    }
  }
}

// S is the stride (1 only): the template's first argument, as for
// conv_igemm.cuh's loop, so that a trace names both loops of the kernel
// alike (conv_igemm_kernel<1, ...>). map_x and map_w read 64-channel
// boxes, map_x32 and map_w32 the 32 channels a tap's last step may have.
template <int S, int BN, bool RESIDENT, bool STRIP, int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
conv_igemm_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_w,
                  const __grid_constant__ CUtensorMap map_x32,
                  const __grid_constant__ CUtensorMap map_w32,
                  const float* __restrict__ bias,
                  __nv_bfloat16* __restrict__ out, Geometry g, int relu) {
  static_assert(S == 1, "stride 1");
  using L = Layout<BN, RESIDENT, STRIP>;
  static_assert(STAGES == L::STAGES, "the layout's ring");
  constexpr int ACC = BN / 2;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t staging = ring + STAGES * L::STAGE;
  const uint32_t bars = staging + L::STAGING;
  const uint32_t weight = bars + 1024;  // RESIDENT: every K step's B
  const uint32_t weight_bar = bars + 16u * STAGES;
  Ring stages{bars, STAGES};

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  if (tid == 0) {
    stages.init(4 * CONSUMERS);
    mbar_init(weight_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * CONSUMERS) {  // the producer: one thread
    regs_dec<PRODUCER_REGS>();
    if (tid != 128 * CONSUMERS) return;
    const uint64_t keep = l2_policy_evict_last();
    if (RESIDENT) {  // a K step's B after another (Cp a multiple of 64)
      const int k_steps = g.kh * g.kw * g.full;
      mbar_expect_tx(weight_bar, k_steps * L::B_BYTES);
      for (int t = 0; t < k_steps; ++t)
        tma_load_2d(weight + t * L::B_BYTES, &map_w, t * BK, 0, weight_bar,
                    keep);
    }
    Ring r = stages;
    for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
      const int nt = tile % g.n_tiles;
      const int mt = tile / g.n_tiles;
      int b[CONSUMERS], y0[CONSUMERS], x0[CONSUMERS];
#pragma unroll
      for (int i = 0; i < CONSUMERS; ++i)
        patch_origin<STRIP>(g, CONSUMERS * mt + i, b[i], y0[i], x0[i]);
      if constexpr (STRIP) {  // a stage a window row ky: kw taps
        const uint32_t bytes = (STRIP_W + g.kw - 1) * ROW;
        for (int ky = 0; ky < g.kh; ++ky) {
          // a fresh barrier passes the wait on the phase before its first
          mbar_wait(r.empty(), r.phase ^ 1);
          const uint32_t st = ring + r.stage * L::STAGE;
          mbar_expect_tx(r.full(), CONSUMERS * bytes);
#pragma unroll
          for (int i = 0; i < CONSUMERS; ++i)
            tma_load_4d(st + i * L::PATCH, &map_x, 0, x0[i] - g.kw / 2,
                        y0[i] + ky - g.kh / 2, b[i], r.full());
          r.next();
        }
        continue;
      }
      for (int tap = 0; tap < g.kh * g.kw; ++tap) {
        const int ky = tap / g.kw;
        const int dx = tap - ky * g.kw - g.kw / 2;
        const int dy = ky - g.kh / 2;
        for (int j = 0; j < g.steps; ++j) {
          const bool half = j == g.full;  // the tap's last 32 channels
          mbar_wait(r.empty(), r.phase ^ 1);
          const uint32_t st = ring + r.stage * L::STAGE;
          mbar_expect_tx(r.full(), half ? L::STAGE / 2 : L::STAGE);
          const CUtensorMap* mx = half ? &map_x32 : &map_x;
#pragma unroll
          for (int i = 0; i < CONSUMERS; ++i)
            tma_load_4d(st + i * L::PATCH, mx, BK * j, x0[i] + dx, y0[i] + dy,
                        b[i], r.full());
          if (!RESIDENT)
            tma_load_2d(st + L::A_BYTES, half ? &map_w32 : &map_w,
                        tap * g.c + BK * j, nt * BN, r.full(), keep);
          r.next();
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg computes patch wg of the tile, its warp wi
  // the patch's image row wi
  regs_inc<CONSUMER_REGS>();
  const int wg = warp / 4;
  const int wi = warp % 4;
  const int quad = lane % 4;
  const int g8 = lane / 4;
  const uint32_t stg = staging + warp * 16 * L::SROW;
  if (RESIDENT) mbar_wait(weight_bar, 0);
  Ring r = stages;
  float acc[ACC];
  for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
    const int nt = tile % g.n_tiles;
    const int mt = tile / g.n_tiles;
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
    int j = 0;  // the step within its tap
    for (int t = 0; t < g.stages; ++t) {
      mbar_wait(r.full(), r.phase);
      const uint32_t st = ring + r.stage * L::STAGE;
      conv_igemm::wgmma_fence();
      if constexpr (STRIP) {
        // tap (t, kx) reads the window from row kx on: 8-row groups 1,024
        // bytes apart, started kx rows later
        for (int kx = 0; kx < g.kw; ++kx) {
          const uint64_t da = desc<ROW>(st + wg * L::PATCH + kx * ROW);
          const uint64_t db = desc<ROW>(weight + (t * g.kw + kx) * L::B_BYTES);
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)  // 16 bf16: 2 units
            conv_igemm::Mma<BN>::run(acc, da + 2 * kk, db + 2 * kk);
        }
      } else if (j == g.full) {  // 32 channels in the 64-byte swizzle
        const uint64_t da = desc<64>(st + wg * L::PATCH);
        const uint64_t db = desc<64>(st + L::A_BYTES);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          conv_igemm::Mma<BN>::run(acc, da + 2 * kk, db + 2 * kk);
      } else {
        const uint64_t da = desc<ROW>(st + wg * L::PATCH);
        const uint64_t db =
            desc<ROW>(RESIDENT ? weight + t * L::B_BYTES : st + L::A_BYTES);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          conv_igemm::Mma<BN>::run(acc, da + 2 * kk, db + 2 * kk);
      }
      conv_igemm::wgmma_commit();
      conv_igemm::wgmma_wait<1>();
      if (t > 0 && lane == 0) mbar_arrive(r.empty_before());
      r.next();
      if (++j == g.steps) j = 0;
    }
    conv_igemm::wgmma_wait<0>();
    if (lane == 0) mbar_arrive(r.empty_before());
#pragma unroll
    for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(acc[i])::"memory");

    // epilogue: accumulator 4 j + {0, 1} is row g8 of the warp's 16 (pixel
    // x0 + g8), channels 8 j + 2 quad + {0, 1}; 4 j + {2, 3} the same
    // channels of pixel x0 + g8 + 8
    const int n_base = nt * BN;
    __syncwarp();  // the last tile's reads of the staging are done
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      const int col = n_base + 8 * jj + 2 * quad;
      const float b0 = col < g.o ? __ldg(bias + col) : 0.f;
      const float b1 = col + 1 < g.o ? __ldg(bias + col + 1) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = acc[4 * jj + 2 * h] + b0;
        float v1 = acc[4 * jj + 2 * h + 1] + b1;
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        const __nv_bfloat162 pair = __floats2bfloat162_rn(v0, v1);
        sts32(stg + (g8 + 8 * h) * L::SROW + 16 * jj + 4 * quad,
              *reinterpret_cast<const uint32_t*>(&pair));
      }
    }
    __syncwarp();
    const int p = CONSUMERS * mt + wg;
    int b, y, x0;
    patch_origin<STRIP>(g, p, b, y, x0);
    if (STRIP)
      x0 += 16 * wi;  // the strip's 16 pixels from 16 wi on
    else
      y += wi;        // the patch's row wi
    if (p < g.patches && y < g.h) {
      __nv_bfloat16* row =
          out + (((int64_t)b * g.h + y) * g.w + x0) * g.o + n_base;
      const int pixels = min(PATCH_W, g.w - x0);
      const int cols = min(BN, g.o - n_base);
      switch (g.vw) {
        case 8:
          store_row<8, BN>(row, g.o, stg, pixels, cols, lane);
          break;
        case 4:
          store_row<4, BN>(row, g.o, stg, pixels, cols, lane);
          break;
        case 2:
          store_row<2, BN>(row, g.o, stg, pixels, cols, lane);
          break;
        default:
          store_row<1, BN>(row, g.o, stg, pixels, cols, lane);
      }
    }
  }
}

template <int BN, bool RESIDENT, bool STRIP>
int launch_variant(const void* x, const void* w, const void* bias, void* out,
                   Geometry g, int relu, cudaStream_t stream) {
  using L = Layout<BN, RESIDENT, STRIP>;
  auto kern = conv_igemm_kernel<1, BN, RESIDENT, STRIP, L::STAGES>;
  const int smem =
      L::BASE + (RESIDENT ? g.kh * g.kw * g.full * L::B_BYTES : 0);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  static int configured_device = -1;  // the attribute is per device
  static int sms = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device != configured_device) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return (int)err;
    configured_device = device;
  }
  if (STRIP) {
    g.px = g.w / STRIP_W;
    g.py = g.h;
    g.patches = g.n * g.px * g.py;
    g.tiles = (g.patches + CONSUMERS - 1) / CONSUMERS;
    g.stages = g.kh;
  }
  const uint64_t c = g.c;
  const uint64_t x_dims[4] = {c, (uint64_t)g.w, (uint64_t)g.h,
                              (uint64_t)g.n};
  const uint64_t x_strides[3] = {2 * c, 2 * c * g.w, 2 * c * g.w * g.h};
  const uint32_t x_box[4] = {
      BK, STRIP ? (uint32_t)(STRIP_W + g.kw - 1) : (uint32_t)PATCH_W,
      STRIP ? 1u : (uint32_t)PATCH_H, 1};
  const uint32_t x_box32[4] = {BK / 2, PATCH_W, PATCH_H, 1};
  const uint64_t k = (uint64_t)g.kh * g.kw * c;
  const uint64_t w_dims[2] = {k, (uint64_t)g.o};
  const uint64_t w_strides[1] = {2 * k};
  const uint32_t w_box[2] = {BK, BN};
  const uint32_t w_box32[2] = {BK / 2, BN};
  CUtensorMap map_x, map_w, map_x32, map_w32;
  if (!make_map(&map_x, x, 4, x_dims, x_strides, x_box,
                CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B) ||
      !make_map(&map_w, w, 2, w_dims, w_strides, w_box,
                CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B) ||
      !make_map(&map_x32, x, 4, x_dims, x_strides, x_box32,
                CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B) ||
      !make_map(&map_w32, w, 2, w_dims, w_strides, w_box32,
                CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B))
    return (int)cudaErrorInvalidValue;
  // as few rounds of tiles as the SMs allow, and as few blocks as give
  // that: every block takes the same number of tiles, or one fewer
  const int rounds = (g.tiles + sms - 1) / sms;
  const int grid = (g.tiles + rounds - 1) / rounds;
  kern<<<grid, THREADS, smem, stream>>>(map_x, map_w, map_x32, map_w32,
                                        (const float*)bias,
                                        (__nv_bfloat16*)out, g, relu);
  return (int)cudaGetLastError();
}

// x (n, h, w, cp) bf16 with cp a multiple of 32, w (o, kh, kw, cp) bf16,
// bias (o,) f32, out (n, h, w, o) bf16, all dense channels-last and
// 16-byte aligned; bn output channels a tile (64, 96 or 128). Returns a
// cudaError_t: a shape the loop does not take is cudaErrorInvalidValue, a
// refused launch its error.
inline int launch(const void* x, const void* w, const void* bias, void* out,
                  int n, int cp, int h, int wd, int o, int kh, int kw,
                  int relu, int bn, void* stream) {
  if (kh % 2 == 0 || kw % 2 == 0 || kh < 1 || kw < 1 || cp % 32 != 0 ||
      cp < 32 || o < 0 || n < 0 || h < 0 || wd < 0 ||
      (bn != 64 && bn != 96 && bn != 128) || (uintptr_t)x % 16 != 0 ||
      (uintptr_t)w % 16 != 0 || (uintptr_t)out % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if ((int64_t)n * h * wd == 0 || o == 0) return (int)cudaSuccess;
  Geometry g{};
  g.n = n;
  g.h = h;
  g.w = wd;
  g.c = cp;
  g.o = o;
  g.kh = kh;
  g.kw = kw;
  g.px = (wd + PATCH_W - 1) / PATCH_W;
  g.py = (h + PATCH_H - 1) / PATCH_H;
  const int64_t patches = (int64_t)n * g.px * g.py;
  g.n_tiles = (o + bn - 1) / bn;
  const int64_t tiles = (patches + CONSUMERS - 1) / CONSUMERS * g.n_tiles;
  if (tiles >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  g.patches = (int)patches;
  g.tiles = (int)tiles;
  g.full = cp / BK;
  g.steps = (cp + BK - 1) / BK;
  g.stages = kh * kw * g.steps;
  g.vw = o % 8 == 0 ? 8 : o % 4 == 0 ? 4 : o % 2 == 0 ? 2 : 1;
  cudaStream_t st = (cudaStream_t)stream;
  // the whole weight beside the ring: O <= 64, Cp a multiple of 64
  using Res = Layout<64, true, false>;
  using Strip = Layout<64, true, true>;
  const int b_bytes = kh * kw * g.full * Res::B_BYTES;
  const bool resident = bn == 64 && o <= 64 && cp % BK == 0;
  if (resident && cp == BK && wd % STRIP_W == 0 &&
      (STRIP_W + kw - 1) * ROW <= STRIP_BYTES &&
      Strip::BASE + b_bytes <= SMEM_LIMIT)
    return launch_variant<64, true, true>(x, w, bias, out, g, relu, st);
  if (resident && Res::BASE + b_bytes <= SMEM_LIMIT)
    return launch_variant<64, true, false>(x, w, bias, out, g, relu, st);
  switch (bn) {
    case 64:
      return launch_variant<64, false, false>(x, w, bias, out, g, relu, st);
    case 96:
      return launch_variant<96, false, false>(x, w, bias, out, g, relu, st);
    default:
      return launch_variant<128, false, false>(x, w, bias, out, g, relu, st);
  }
}

}  // namespace conv_pipe
