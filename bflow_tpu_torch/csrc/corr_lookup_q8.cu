// Windowed bilinear correlation lookup on an int8 volume, forward only,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel bflow_tpu/ops/pallas/corr_lookup_v3.py:_fwd_kernel
// with quant=True (reached through _fwd_impl and lookup_level_slab_q8):
// the lookup of corr_lookup_fwd.cu on a symmetric int8 volume with one f32
// scale per (target, batch, query row), output bf16. The TPU kernel blends
// the integers in bf16 and the caller multiplies the packed output by the
// bf16-rounded scale; here the scale is folded into the epilogue: the f32
// blend of the integers times the f32 scale, rounded once to bf16 (a few
// bf16 ulps from the TPU's two-stage rounding; the same function).
//
// What bounds it on this card: as the bf16 lookup, a gather bound by
// memory traffic, now with half the patch bytes (int8), plus one scale per
// query row (L1-resident: a row's w1 queries share it). Design: one
// thread per output tap, the tap of corr_lookup_tap.cuh.

#include "corr_lookup_tap.cuh"

namespace {

__global__ void corr_lookup_q8_kernel(const int8_t* __restrict__ vol,
                                      const float* __restrict__ scale,
                                      const float* __restrict__ coords,
                                      __nv_bfloat16* __restrict__ out,
                                      int64_t n_out, int hl, int wl,
                                      int radius, int w1) {
  const int win = 2 * radius + 1;
  const int taps = win * win;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;  // ragged last block
  const int64_t q = i / taps;
  const int t = (int)(i - q * taps);
  const float x = __ldg(coords + 2 * q) + (float)(t % win - radius);
  const float y = __ldg(coords + 2 * q + 1) + (float)(t / win - radius);
  const float v =
      corr_tap::bilinear(vol + q * (int64_t)hl * wl, hl, wl, x, y);
  out[i] = __float2bfloat16(__fmul_rn(v, __ldg(scale + q / w1)));
}

}  // namespace

extern "C" {

// vol (Q, hl, wl) int8 contiguous, scale (Q / w1,) f32 (one per query row
// of w1 queries), coords (Q, 2) f32 contiguous (x, y), out (Q, (2r+1)^2)
// bf16 contiguous. Returns cudaGetLastError().
int corr_lookup_q8_bf16(const void* vol, const void* scale,
                        const void* coords, void* out, long long n_query,
                        int hl, int wl, int radius, int w1, void* stream) {
  const int win = 2 * radius + 1;
  const int64_t n_out = (int64_t)n_query * win * win;
  if (n_out == 0) return (int)cudaSuccess;
  if (w1 < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int64_t blocks = (n_out + threads - 1) / threads;
  corr_lookup_q8_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
      (const int8_t*)vol, (const float*)scale, (const float*)coords,
      (__nv_bfloat16*)out, n_out, hl, wl, radius, w1);
  return (int)cudaGetLastError();
}

}  // extern "C"
