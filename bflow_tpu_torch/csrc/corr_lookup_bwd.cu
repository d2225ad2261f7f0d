// Windowed bilinear correlation lookup, backward (VJP), for Hopper (sm_90a).
//
// Replaces the TPU kernel bflow_tpu/ops/pallas/corr_lookup_v3.py:_bwd_kernel
// (reached through _bwd_impl and the custom VJP _lookup_cvjp). The forward
// (csrc/corr_lookup_fwd.cu) reads, for query q, the (2r+1)^2 bilinear taps
// of its own (hl, wl) map vol[q] at (x + dx, y + dy). Given the cotangent
// g (Q, (2r+1)^2) of those taps, this kernel returns
//
//   dvol[q]     each tap's cotangent spread over its four bilinear corners
//               (corners outside the map drop out), in vol's type;
//   dcoords[q]  sum over taps of g * d(tap)/d(x, y), f32, with
//               d/dx = (v01 - v00)(1 - fy) + (v11 - v10) fy and likewise
//               for y; corners and fractions come from floor, so at an
//               integer coordinate this is the right derivative (the TPU
//               kernel's _dhat).
//
// What bounds it on this card: like the forward it is a gather, a few
// flops per byte. Per query it reads 81 cotangents, 8 bytes of coords and
// the in-map part of its (2r+2)^2 patch, and writes that patch of dvol and
// 8 bytes of dcoords: bytes ~ Q * (81 + 2 * (2r+2)^2) * itemsize. The
// wrapper zeroes the whole dvol first (torch.zeros), which moves far more
// bytes than the kernel itself at the large pyramid levels; accumulating
// every refinement iteration into one buffer is a later redesign.
//
// Design (the simple first version; none of the TPU kernel's hat-matrix
// products, lane bands or diagonal packing carries over): one block of 128
// threads per query.
//   1. The query's cotangents are staged in shared memory as f32, and the
//      per-column and per-row corner positions floor(x + dx), floor(y + dy)
//      and fractions are computed once (each exactly as the forward computes
//      them per tap: an f32 add, then floor).
//   2. Each of the (2r+2)^2 patch cells around floor(x) - r *gathers* the
//      contributions of the at most 3 x 3 taps whose corners can touch it,
//      summing in f32 in a fixed order, and writes its cell of dvol once,
//      rounded once. No atomics: the result is bitwise repeatable, and since
//      queries own disjoint maps no block touches another block's map.
//      floor(x + dx) is floor(x) + dx or, when the f32 add rounds up onto an
//      integer, one more; in that case the fraction is exactly 0, so the one
//      corner that can then fall outside the patch carries weight 0.
//   3. Each tap computes its (gx, gy) from the corners the forward read
//      (loaded through L1), and the block reduces them in f32 with warp
//      shuffles and a fixed-order sum over warps.
// Validity is decided in float before any float -> int conversion, as in
// the forward, so coordinates at +-1e4 neither fault nor contribute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWin = 15;  // 2r+2 <= 16, the wrapper's limit

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
corr_lookup_bwd_kernel(const T* __restrict__ vol,
                       const float* __restrict__ coords,
                       const T* __restrict__ g, T* __restrict__ dvol,
                       float* __restrict__ dcoords, int hl, int wl,
                       int radius) {
  __shared__ float g_s[kMaxWin * kMaxWin];
  __shared__ float col_s[kMaxWin], fx_s[kMaxWin];  // floor(x+dx), fraction
  __shared__ float row_s[kMaxWin], fy_s[kMaxWin];  // floor(y+dy), fraction
  __shared__ float red_s[2][kWarps];

  const int win = 2 * radius + 1;
  const int taps = win * win;
  const int patch = win + 1;
  const int64_t q = blockIdx.x;
  const int tid = threadIdx.x;
  const float x = __ldg(coords + 2 * q);
  const float y = __ldg(coords + 2 * q + 1);

  for (int t = tid; t < taps; t += kThreads)
    g_s[t] = load_f32(g + q * taps + t);
  if (tid < win) {
    const float p = x + (float)(tid - radius);
    const float c = floorf(p);
    col_s[tid] = c;
    fx_s[tid] = p - c;
  } else if (tid < 2 * win) {
    const int k = tid - win;
    const float p = y + (float)(k - radius);
    const float c = floorf(p);
    row_s[k] = c;
    fy_s[k] = p - c;
  }
  __syncthreads();

  const float wmax = (float)(wl - 1), hmax = (float)(hl - 1);
  const T* m = vol + q * (int64_t)hl * wl;

  // dvol: every in-map patch cell gathers from the taps touching it
  if (dvol != nullptr) {
    const float x0 = floorf(x) - (float)radius;  // patch origin, exact
    const float y0 = floorf(y) - (float)radius;
    T* dm = dvol + q * (int64_t)hl * wl;
    for (int c = tid; c < patch * patch; c += kThreads) {
      const int a = c / patch, b = c % patch;
      const float cy = y0 + (float)a, cx = x0 + (float)b;
      if (!(cy >= 0.f && cy <= hmax && cx >= 0.f && cx <= wmax)) continue;
      float acc = 0.f;
      for (int i = max(a - 2, 0); i <= min(a, win - 1); ++i) {
        float wy;
        if (row_s[i] == cy) wy = 1.f - fy_s[i];
        else if (row_s[i] + 1.f == cy) wy = fy_s[i];
        else continue;
        for (int j = max(b - 2, 0); j <= min(b, win - 1); ++j) {
          float wx;
          if (col_s[j] == cx) wx = 1.f - fx_s[j];
          else if (col_s[j] + 1.f == cx) wx = fx_s[j];
          else continue;
          acc += (g_s[i * win + j] * wy) * wx;
        }
      }
      // in the map, so cy and cx are exact small integers
      store_from_f32(dm + (int64_t)cy * wl + (int)cx, acc);
    }
  }

  if (dcoords == nullptr) return;
  // dcoords: per-tap derivative from the corners the forward read
  float gx = 0.f, gy = 0.f;
  for (int t = tid; t < taps; t += kThreads) {
    const int i = t / win, j = t % win;
    const float cx = col_s[j], cy = row_s[i];
    const float fx = fx_s[j], fy = fy_s[i];
    const bool vx0 = cx >= 0.f && cx <= wmax;
    const bool vx1 = cx >= -1.f && cx <= wmax - 1.f;
    const bool vy0 = cy >= 0.f && cy <= hmax;
    const bool vy1 = cy >= -1.f && cy <= hmax - 1.f;
    float v00 = 0.f, v01 = 0.f, v10 = 0.f, v11 = 0.f;
    if ((vx0 || vx1) && (vy0 || vy1)) {
      const int ix = (int)cx, iy = (int)cy;  // both in [-1, w-1]: exact
      if (vy0) {
        const T* r0 = m + (int64_t)iy * wl;
        if (vx0) v00 = load_f32(r0 + ix);
        if (vx1) v01 = load_f32(r0 + ix + 1);
      }
      if (vy1) {
        const T* r1 = m + (int64_t)(iy + 1) * wl;
        if (vx0) v10 = load_f32(r1 + ix);
        if (vx1) v11 = load_f32(r1 + ix + 1);
      }
    }
    const float gt = g_s[t];
    gx += gt * ((v01 - v00) * (1.f - fy) + (v11 - v10) * fy);
    gy += gt * ((v10 - v00) * (1.f - fx) + (v11 - v01) * fx);
  }
  gx = warp_sum(gx);
  gy = warp_sum(gy);
  const int warp = tid / 32, lane = tid % 32;
  if (lane == 0) {
    red_s[0][warp] = gx;
    red_s[1][warp] = gy;
  }
  __syncthreads();
  if (tid == 0) {
    float sx = 0.f, sy = 0.f;
    for (int w = 0; w < kWarps; ++w) {  // fixed order: repeatable bits
      sx += red_s[0][w];
      sy += red_s[1][w];
    }
    dcoords[2 * q] = sx;
    dcoords[2 * q + 1] = sy;
  }
}

template <typename T>
int launch(const void* vol, const void* coords, const void* g, void* dvol,
           void* dcoords, int64_t n_query, int hl, int wl, int radius,
           void* stream) {
  if (n_query == 0) return (int)cudaSuccess;
  if (2 * radius + 1 > kMaxWin || radius < 1)
    return (int)cudaErrorInvalidValue;
  corr_lookup_bwd_kernel<T><<<(unsigned)n_query, kThreads, 0,
                              (cudaStream_t)stream>>>(
      (const T*)vol, (const float*)coords, (const T*)g, (T*)dvol,
      (float*)dcoords, hl, wl, radius);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// vol (Q, hl, wl) contiguous, coords (Q, 2) f32 contiguous (x, y), g
// (Q, (2r+1)^2) contiguous in vol's type. dvol (Q, hl, wl) in vol's type,
// zeroed by the caller (only each query's in-map patch is written), or
// NULL; dcoords (Q, 2) f32, or NULL. Returns cudaGetLastError().
int corr_lookup_bwd_f32(const void* vol, const void* coords, const void* g,
                        void* dvol, void* dcoords, long long n_query, int hl,
                        int wl, int radius, void* stream) {
  return launch<float>(vol, coords, g, dvol, dcoords, n_query, hl, wl,
                       radius, stream);
}

int corr_lookup_bwd_bf16(const void* vol, const void* coords, const void* g,
                         void* dvol, void* dcoords, long long n_query,
                         int hl, int wl, int radius, void* stream) {
  return launch<__nv_bfloat16>(vol, coords, g, dvol, dcoords, n_query, hl,
                               wl, radius, stream);
}

}  // extern "C"
