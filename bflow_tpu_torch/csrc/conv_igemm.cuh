// Odd-window SAME convolution plus bias as an implicit GEMM on the tensor
// cores, for Hopper (sm_90a). Shared by conv3x3.cu (stride 1) and
// stem_conv.cu (stride 2).
//
// The function: out[b, o, y, x] = bf16( sum_{ky, kx, c} bf16 x[b, S*y -
// kh/2 + ky, S*x - kw/2 + kx, c] * bf16 w[o, ky, kx, c] (f32 sums, zero
// outside the image) + f32 bias[o] ), optionally through a ReLU before the
// one rounding. Layouts: x (N, H, W, Cp) channels-last and the weight
// (O, kh, kw, Cp), bf16, with the channels zero-padded to Cp, a multiple
// of 8 (the wrapper makes both from the port's NCHW / OIHW tensors: one
// pass over x); the bias (O,) f32; out (N, O, Ho, Wo) NCHW bf16, the
// port's layout. All contiguous.
//
// As a matrix product: M = N * Ho * Wo output pixels, N_ = O output
// channels, K = kh * kw * Cp, ordered (ky, kx, c) so that the weight is
// the (K x O) B matrix as it lies in memory. A is never materialised:
// each block gathers its (BM x BK) slice of the im2col patch from x, 8
// channels of one tap (16 bytes) per copy, zero-filled where the tap
// falls outside the image.
//
// What bounds it on this card: at the flagship shapes K is 196 to 2,304
// and O is 64 to 384, so the product does 60 to 1,500 flops per byte of
// x, w and out: most of these convs sit above the H100's ~295 flop/byte
// bf16 ridge (operation-bound), the thin ones (O = 64 at 240x320, the
// 7x7 over 4 Bezier planes) below it. The full rate needs wgmma fed by
// TMA; this version is the simple design: 64x64 output tiles, a K loop in
// steps of 32 with two shared-memory stages filled by cp.async (16-byte
// copies, the next stage in flight while the tensor cores work on the
// current one), four warps each running 2x2 wmma 16x16x16 bf16 fragments
// with f32 accumulators. The epilogue stages the accumulators in shared
// memory and writes each output channel's pixels contiguously (NCHW).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace conv_igemm {

using namespace nvcuda;

constexpr int BM = 64;        // output pixels per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 32;        // K step
constexpr int THREADS = 128;  // four warps, each a 32x32 quarter
constexpr int VEC = 8;        // bf16 per 16-byte copy
constexpr int LD = BK + 8;    // A[m][k] at m*LD + k, B[k][n] at n*LD + k
constexpr int C_LD = BM + 4;  // f32 result tile: C[m][n] at n*C_LD + m
constexpr int ROWS_PER_PASS = THREADS / (BK / VEC);  // 32

struct Shape {
  int n, c, h, w;   // input, c = Cp (a multiple of 8)
  int o, ho, wo;    // output channels and size
  int kh, kw;       // window (odd), padding kh/2, kw/2
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  const int src_bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

// KH = KW = 0: the window is read from the shape at run time
template <int S, int KH, int KW>
__global__ void __launch_bounds__(THREADS)
conv_igemm_kernel(const uint16_t* __restrict__ x,
                  const uint16_t* __restrict__ wt,
                  const float* __restrict__ bias,
                  __nv_bfloat16* __restrict__ out, Shape s, int relu) {
  const int kw = KW ? KW : s.kw;
  const int taps = (KH ? KH : s.kh) * kw;
  const int K = taps * s.c;
  const int64_t hw_out = (int64_t)s.ho * s.wo;
  const int64_t M = (int64_t)s.n * hw_out;
  const int64_t m_base = (int64_t)blockIdx.x * BM;
  const int n_base = blockIdx.y * BN;
  const int tid = threadIdx.x;

  __shared__ __align__(128) uint16_t As[2][BM * LD];
  __shared__ __align__(128) uint16_t Bs[2][BN * LD];
  __shared__ __align__(128) float Cs[BN * C_LD];

  // copies of this thread: the 8 channels at K offset kv*8 of the tile,
  // for rows r and r + 32 of A (pixels) and of B (output channels)
  const int kv = tid % (BK / VEC);
  const int r0 = tid / (BK / VEC);
  bool m_ok[2];
  int iy0[2], ix0[2];
  const uint16_t* xb[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int64_t gm = m_base + r0 + ROWS_PER_PASS * j;
    m_ok[j] = gm < M;
    const int64_t b = m_ok[j] ? gm / hw_out : 0;
    const int p = m_ok[j] ? (int)(gm - b * hw_out) : 0;
    const int oy = p / s.wo;
    const int ox = p - oy * s.wo;
    iy0[j] = oy * S - (KH ? KH : s.kh) / 2;
    ix0[j] = ox * S - kw / 2;
    xb[j] = x + b * (int64_t)s.h * s.w * s.c;
  }

  auto load_stage = [&](int stage, int k0) {
    const int k = k0 + kv * VEC;
    const bool k_ok = k < K;  // K is a multiple of 8: all 8 in or out
    const int t = k / s.c;
    const int c = k - t * s.c;
    const int ky = t / kw;
    const int kx = t - ky * kw;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = r0 + ROWS_PER_PASS * j;
      const int iy = iy0[j] + ky;
      const int ix = ix0[j] + kx;
      const bool ok = k_ok && m_ok[j] && iy >= 0 && iy < s.h && ix >= 0 &&
                      ix < s.w;
      const uint16_t* src =
          ok ? xb[j] + ((int64_t)iy * s.w + ix) * s.c + c : x;
      cp_async16(&As[stage][row * LD + kv * VEC], src, ok);
      const int n = n_base + row;
      const bool w_ok = k_ok && n < s.o;
      cp_async16(&Bs[stage][row * LD + kv * VEC],
                 w_ok ? wt + (int64_t)n * K + k : wt, w_ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  const int warp = tid / 32;
  const int wm = (warp % 2) * 32;
  const int wn = (warp / 2) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int k_tiles = (K + BK - 1) / BK;
  load_stage(0, 0);
  for (int t = 0; t < k_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < k_tiles) {
      load_stage(stage ^ 1, (t + 1) * BK);  // in flight during the MMAs
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(
            fa[i],
            reinterpret_cast<const __nv_bfloat16*>(
                &As[stage][(wm + 16 * i) * LD + kk]),
            LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(
            fb[j],
            reinterpret_cast<const __nv_bfloat16*>(
                &Bs[stage][(wn + 16 * j) * LD + kk]),
            LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // the stage is refilled in the next iteration
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wn + 16 * j) * C_LD + wm + 16 * i,
                              acc[i][j], C_LD, wmma::mem_col_major);
  __syncthreads();

  // epilogue: f32 bias, ReLU, one rounding; consecutive threads write
  // consecutive pixels of one output channel
  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int nn = idx / BM;
    const int mm = idx - nn * BM;
    const int64_t m = m_base + mm;
    const int o = n_base + nn;
    if (m >= M || o >= s.o) continue;
    float v = Cs[nn * C_LD + mm] + __ldg(bias + o);
    if (relu) v = fmaxf(v, 0.f);
    const int64_t b = m / hw_out;
    const int64_t p = m - b * hw_out;
    out[(b * s.o + o) * hw_out + p] = __float2bfloat16(v);
  }
}

using KernelFn = void (*)(const uint16_t*, const uint16_t*, const float*,
                          __nv_bfloat16*, Shape, int);

template <int S>
KernelFn pick(int kh, int kw) {
  if (kh == 3 && kw == 3) return conv_igemm_kernel<S, 3, 3>;
  if (kh == 7 && kw == 7) return conv_igemm_kernel<S, 7, 7>;
  if (kh == 1 && kw == 5) return conv_igemm_kernel<S, 1, 5>;
  if (kh == 5 && kw == 1) return conv_igemm_kernel<S, 5, 1>;
  return conv_igemm_kernel<S, 0, 0>;
}

// x (n, h, w, cp) bf16 with cp a multiple of 8, w (o, kh, kw, cp) bf16,
// bias (o,) f32, out (n, o, ho, wo) bf16 with ho = (h - 1) / S + 1,
// wo = (w - 1) / S + 1 (SAME padding kh/2, kw/2 with odd windows).
// Returns cudaGetLastError().
template <int S>
int launch(const void* x, const void* w, const void* bias, void* out, int n,
           int cp, int h, int wd, int o, int kh, int kw, int relu,
           void* stream) {
  if (kh % 2 == 0 || kw % 2 == 0 || kh < 1 || kw < 1 || cp % VEC != 0)
    return (int)cudaErrorInvalidValue;
  Shape s{n, cp, h, wd, o, (h - 1) / S + 1, (wd - 1) / S + 1, kh, kw};
  const int64_t M = (int64_t)n * s.ho * s.wo;
  if (M == 0 || o == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((o + BN - 1) / BN));
  pick<S>(kh, kw)<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)x, (const uint16_t*)w, (const float*)bias,
      (__nv_bfloat16*)out, s, relu);
  return (int)cudaGetLastError();
}

}  // namespace conv_igemm
