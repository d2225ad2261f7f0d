// Windowed bilinear correlation lookup, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel bflow_tpu/ops/pallas/corr_lookup_v3.py:_fwd_kernel
// (reached through _fwd_impl and lookup_level_slab). Every query q owns a
// private (hl, wl) correlation map vol[q] and reads the (2r+1)^2 bilinear
// taps of that map at (x + dx, y + dy), dx, dy in [-r, r], dy-major, with
// grid_sample(align_corners=True) zero padding: a corner outside the map
// contributes zero.
//
// What bounds it on this card: it is a gather. Per query it needs at most
// the (2r+2)^2 patch around floor(x, y) (fewer bytes where the patch leaves
// the map), 8 bytes of coordinates, and it writes (2r+1)^2 outputs:
// bytes ~ Q * ((2r+2)^2 + (2r+1)^2) * itemsize, against a few flops per
// tap. So it is bound by memory traffic, and by the latency of dependent
// loads at the small pyramid levels, where Q * taps fills only a few
// waves of threads.
//
// Design (the simple first version): one thread per output tap. The 81
// threads of a query sit next to each other, so one warp touches one or two
// queries; their corner reads fall in the same few cache lines of the
// query's patch, which L1 serves after the first miss, and the output store
// is fully coalesced. The tap itself (corr_lookup_tap.cuh) blends in f32
// and rounds once to the volume's type (the TPU kernel rounds the y-blend
// to bf16 before the x-blend, so the two differ by up to a bf16 rounding).
// Staging the patch in shared memory with cp.async/TMA is left to a later
// version.

#include "corr_lookup_tap.cuh"

namespace {

__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

template <typename T>
__global__ void corr_lookup_fwd_kernel(const T* __restrict__ vol,
                                       const float* __restrict__ coords,
                                       T* __restrict__ out, int64_t n_out,
                                       int hl, int wl, int radius) {
  const int win = 2 * radius + 1;
  const int taps = win * win;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;  // ragged last block
  const int64_t q = i / taps;
  const int t = (int)(i - q * taps);
  const float x = __ldg(coords + 2 * q) + (float)(t % win - radius);
  const float y = __ldg(coords + 2 * q + 1) + (float)(t / win - radius);
  store_from_f32(out + i, corr_tap::bilinear(vol + q * (int64_t)hl * wl, hl,
                                             wl, x, y));
}

template <typename T>
int launch(const void* vol, const void* coords, void* out, int64_t n_query,
           int hl, int wl, int radius, void* stream) {
  const int win = 2 * radius + 1;
  const int64_t n_out = n_query * win * win;
  if (n_out == 0) return (int)cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (n_out + threads - 1) / threads;
  corr_lookup_fwd_kernel<T><<<(unsigned)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
      (const T*)vol, (const float*)coords, (T*)out, n_out, hl, wl, radius);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// vol (Q, hl, wl) contiguous, coords (Q, 2) f32 contiguous (x, y), out
// (Q, (2r+1)^2) contiguous in vol's type. Returns cudaGetLastError().
int corr_lookup_fwd_f32(const void* vol, const void* coords, void* out,
                        long long n_query, int hl, int wl, int radius,
                        void* stream) {
  return launch<float>(vol, coords, out, n_query, hl, wl, radius, stream);
}

int corr_lookup_fwd_bf16(const void* vol, const void* coords, void* out,
                         long long n_query, int hl, int wl, int radius,
                         void* stream) {
  return launch<__nv_bfloat16>(vol, coords, out, n_query, hl, wl, radius,
                               stream);
}

}  // extern "C"
