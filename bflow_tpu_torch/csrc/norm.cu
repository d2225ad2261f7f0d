// Instance norm and eval-mode BatchNorm over bf16 activations, with an
// optional fused ReLU and an optional residual epilogue, for Hopper (sm_90a):
// the norms of the encoders in the bf16 fast mode.
//
// Replaces no TPU kernel. The JAX package leaves its norm
// (bflow_tpu/models/extractor.py:Norm) to XLA, which fuses the f32 cast, the
// two means and the normalise into about two passes over the bf16
// activation. PyTorch runs the same chain eagerly: a cast copy to f32, two
// mean reductions, a square, a clamp, a subtract, a multiply, a cast back and
// a separate ReLU, each writing and reading an f32 intermediate, some 48
// bytes of traffic an element. This kernel gives the port what XLA gave the
// TPU.
//
// Bound: bytes. A norm does a few operations an element, so only traffic
// counts: the instance norm reads the bf16 input twice (statistics, then
// normalise) and writes the bf16 output once, 6 bytes an element; the
// BatchNorm takes the running statistics, so it reads once and writes once,
// 4 bytes an element. With a residual, 2 bytes more for its read: the
// epilogue saves the bf16 add and the ReLU that followed the norm, 10 bytes
// an element.
//
// Design:
// - Pass 1, statistics (instance norm only): a grid over (unit, chunk),
//   where a unit is a sample in the channels-last layout and a (sample,
//   channel) plane in NCHW. Each thread loads 16 bytes (8 bf16) at a time,
//   kUnroll loads in flight, and keeps f32 sums of x and x^2 in registers;
//   the block reduces them in a fixed order and writes one partial per chunk
//   to the scratch buffer partial (n, chunks, 2, c) f32. No atomics: the
//   sums, and so the output, repeat bit for bit from one run to the next.
// - Pass 2, normalise: each block sums its sample's partials in chunk order,
//   takes m1 = E[x], var = max(E[x^2] - m1^2, 0) (the JAX fast mode's single
//   pass) and rstd = 1 / sqrt(var + 1e-5) per channel, then streams its
//   chunk: bf16 in, (x - m1) * rstd in f32, the ReLU, one rounding, bf16 out.
//   BatchNorm: (x - mean) * (w * rsqrt(var + eps)) + b from the running
//   statistics, in f32. Every step is a rounded f32 operation (no
//   contraction into an fma), as PyTorch's f32 ops take them one by one.
// - The residual epilogue (a residual block's relu(x + norm(z)), the norm's
//   ReLU included): the normalised value is rounded to bf16 as without it,
//   then x (bf16, in z's layout) is added in f32 and the sum rounded once
//   more, then the ReLU: bf16(f32(x) + f32(y)) is PyTorch's bf16 add, and the
//   ReLU commutes with the rounding, so the output is the eager chain's bit
//   for bit.
// - Pass 2 runs its blocks in the reverse order of pass 1's, so the first
//   ones read what pass 1 read last while it is still in the 50 MB L2.
// - Two layouts, the output in the input's: channels-last (n, h*w, c), where
//   a thread's 8 channels stay fixed while it walks down the rows (the rows
//   of a chunk are one contiguous span, so a block's loads are too); NCHW
//   (n, c, h*w), a contiguous plane per channel, 16-byte loads when h*w is a
//   multiple of 8 and bf16 ones otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kVec = 8;      // bf16 per 16-byte access
constexpr int kUnroll = 4;   // 16-byte loads in flight per thread
constexpr int kMaxC = 1024;  // channels a block keeps coefficients for
constexpr float kInstanceEps = 1e-5f;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// V bf16 in, as f32; V f32 out, rounded to bf16 (round to nearest even)
template <int V>
__device__ __forceinline__ void load(const bf16* p, float* f) {
  if constexpr (V == kVec) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = __bfloat162float(p[i]);
  }
}

template <int V>
__device__ __forceinline__ void store(bf16* p, const float* f) {
  if constexpr (V == kVec) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = __float2bfloat16_rn(f[i]);
  }
}

// A channel's normalisation: y = (x - mean) * scale (+ shift for BatchNorm)
struct Coef {
  float mean, scale, shift;
};

// m1, rstd of channel ch of sample n from the chunks' partial sums, taken in
// chunk order
__device__ __forceinline__ Coef instance_coef(const float* partial, int64_t n,
                                              int ch, int c, int chunks,
                                              int count) {
  const float* p = partial + n * chunks * 2 * c + ch;
  float s = 0.f, q = 0.f;
  for (int k = 0; k < chunks; ++k) {
    s = __fadd_rn(s, p[(2 * k) * c]);
    q = __fadd_rn(q, p[(2 * k + 1) * c]);
  }
  const float m1 = __fdiv_rn(s, (float)count);
  const float m2 = __fdiv_rn(q, (float)count);
  const float var = fmaxf(__fsub_rn(m2, __fmul_rn(m1, m1)), 0.f);
  return {m1, __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, kInstanceEps))), 0.f};
}

__device__ __forceinline__ Coef batch_coef(const float* mean, const float* var,
                                           const float* weight,
                                           const float* bias, float eps,
                                           int ch) {
  const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var[ch], eps)));
  return {mean[ch], __fmul_rn(weight[ch], rstd), bias[ch]};
}

template <bool kBatch>
__device__ __forceinline__ float normalise(float x, float mean, float scale,
                                           float shift, bool relu) {
  float y = __fmul_rn(__fsub_rn(x, mean), scale);
  if (kBatch) y = __fadd_rn(y, shift);
  return (relu && y < 0.f) ? 0.f : y;
}

// relu(bf16(y) + r) in f32, before its rounding: y rounded as the norm's
// output, then PyTorch's bf16 add (f32 sum, one rounding at the store) and
// its ReLU (clamp_min: NaN passes)
__device__ __forceinline__ float residual_relu(float y, float r) {
  const float s = __fadd_rn(__bfloat162float(__float2bfloat16_rn(y)), r);
  return s != s ? s : fmaxf(s, 0.f);
}

// ---------------------------------------------------------------------------
// channels-last: x (n, rows, c) dense, c a multiple of 8. The block has
// blockDim.x = groups * step threads: thread t reads channels
// [8 * (t % groups), +8) of row t / groups, and the block steps down `step`
// rows at a time over its chunk [chunk * rpc, min(rows, (chunk + 1) * rpc)).

__global__ void __launch_bounds__(kThreads)
    norm_stats_rows_kernel(const bf16* __restrict__ x,
                           float* __restrict__ partial, int rows, int c,
                           int rpc, int chunks) {
  __shared__ float red[2 * kThreads * kVec];  // [2][step][c]
  const int groups = c / kVec, step = blockDim.x / groups;
  const int g = threadIdx.x % groups, r = threadIdx.x / groups;
  const int chunk = blockIdx.x % chunks;
  const int64_t n = blockIdx.x / chunks;
  const int64_t r1 = min64(rows, (int64_t)(chunk + 1) * rpc);
  const bf16* xs = x + n * rows * c + g * kVec;
  float s[kVec], q[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) s[i] = q[i] = 0.f;
  int64_t row = (int64_t)chunk * rpc + r;
  for (; row + (kUnroll - 1) * step < r1; row += kUnroll * step) {
    float f[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load<kVec>(xs + (row + u * step) * c, f[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        s[i] += f[u][i];
        q[i] = fmaf(f[u][i], f[u][i], q[i]);
      }
  }
  for (; row < r1; row += step) {
    float f[kVec];
    load<kVec>(xs + row * c, f);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      s[i] += f[i];
      q[i] = fmaf(f[i], f[i], q[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    red[r * c + g * kVec + i] = s[i];
    red[(step + r) * c + g * kVec + i] = q[i];
  }
  __syncthreads();
  float* out = partial + (n * chunks + chunk) * 2 * c;
  for (int i = threadIdx.x; i < 2 * c; i += blockDim.x) {
    const float* p = red + (i / c) * step * c + i % c;
    float acc = 0.f;
    for (int j = 0; j < step; ++j) acc += p[j * c];
    out[i] = acc;
  }
}

template <bool kBatch, bool kRes>
__global__ void __launch_bounds__(kThreads)
    norm_apply_rows_kernel(const bf16* __restrict__ x, bf16* __restrict__ y,
                           const bf16* __restrict__ res,
                           const float* __restrict__ partial,
                           const float* __restrict__ mean,
                           const float* __restrict__ var,
                           const float* __restrict__ weight,
                           const float* __restrict__ bias, float eps, int rows,
                           int c, int rpc, int chunks, int relu) {
  __shared__ float sm_mean[kMaxC], sm_scale[kMaxC], sm_shift[kMaxC];
  const int64_t blk = (int64_t)gridDim.x - 1 - blockIdx.x;  // pass 1 reversed
  const int chunk = blk % chunks;
  const int64_t n = blk / chunks;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    const Coef k = kBatch ? batch_coef(mean, var, weight, bias, eps, ch)
                          : instance_coef(partial, n, ch, c, chunks, rows);
    sm_mean[ch] = k.mean;
    sm_scale[ch] = k.scale;
    sm_shift[ch] = k.shift;
  }
  __syncthreads();
  const int groups = c / kVec, step = blockDim.x / groups;
  const int g = threadIdx.x % groups, r = threadIdx.x / groups;
  float m[kVec], sc[kVec], sh[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    m[i] = sm_mean[g * kVec + i];
    sc[i] = sm_scale[g * kVec + i];
    sh[i] = sm_shift[g * kVec + i];
  }
  const int64_t r1 = min64(rows, (int64_t)(chunk + 1) * rpc);
  const int64_t base = n * rows * c + g * kVec;
  const bf16* xs = x + base;
  const bf16* rs = kRes ? res + base : nullptr;
  bf16* ys = y + base;
  int64_t row = (int64_t)chunk * rpc + r;
  for (; row + (kUnroll - 1) * step < r1; row += kUnroll * step) {
    float f[kUnroll][kVec], q[kRes ? kUnroll : 1][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      load<kVec>(xs + (row + u * step) * c, f[u]);
      if (kRes) load<kVec>(rs + (row + u * step) * c, q[kRes ? u : 0]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        f[u][i] = normalise<kBatch>(f[u][i], m[i], sc[i], sh[i], relu);
        if (kRes) f[u][i] = residual_relu(f[u][i], q[kRes ? u : 0][i]);
      }
      store<kVec>(ys + (row + u * step) * c, f[u]);
    }
  }
  for (; row < r1; row += step) {
    float f[kVec], q[kVec];
    load<kVec>(xs + row * c, f);
    if (kRes) load<kVec>(rs + row * c, q);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      f[i] = normalise<kBatch>(f[i], m[i], sc[i], sh[i], relu);
      if (kRes) f[i] = residual_relu(f[i], q[i]);
    }
    store<kVec>(ys + row * c, f);
  }
}

// ---------------------------------------------------------------------------
// NCHW: x (n * c planes, hw) dense. Block (plane, chunk) covers
// [chunk * len, min(hw, (chunk + 1) * len)) of its plane, len a multiple of
// V; thread t takes V elements at a time, blockDim.x * V apart.

// (sum of s, sum of q) over the block, in a fixed order: a butterfly within
// each warp, then the warps in order; the result in thread 0
__device__ __forceinline__ float2 block_sum2(float s, float q) {
  __shared__ float2 warp_sums[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    q += __shfl_xor_sync(0xffffffffu, q, o);
  }
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = make_float2(s, q);
  __syncthreads();
  float2 t = make_float2(0.f, 0.f);
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x / 32); ++w) {
      t.x += warp_sums[w].x;
      t.y += warp_sums[w].y;
    }
  return t;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    norm_stats_planes_kernel(const bf16* __restrict__ x,
                             float* __restrict__ partial, int c, int hw,
                             int len, int chunks) {
  const int chunk = blockIdx.x % chunks;
  const int64_t plane = blockIdx.x / chunks;
  const int64_t e = min64(hw, (int64_t)(chunk + 1) * len);
  const bf16* xp = x + plane * hw;
  const int stride = blockDim.x * V;
  float s = 0.f, q = 0.f;
  int64_t i = (int64_t)chunk * len + threadIdx.x * V;
  for (; i + (kUnroll - 1) * stride < e; i += kUnroll * stride) {
    float f[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load<V>(xp + i + u * stride, f[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s += f[u][j];
        q = fmaf(f[u][j], f[u][j], q);
      }
  }
  for (; i < e; i += stride) {
    float f[V];
    load<V>(xp + i, f);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s += f[j];
      q = fmaf(f[j], f[j], q);
    }
  }
  const float2 t = block_sum2(s, q);
  if (threadIdx.x == 0) {
    const int64_t n = plane / c;
    float* out = partial + (n * chunks + chunk) * 2 * c + plane % c;
    out[0] = t.x;
    out[c] = t.y;
  }
}

template <int V, bool kBatch, bool kRes>
__global__ void __launch_bounds__(kThreads)
    norm_apply_planes_kernel(const bf16* __restrict__ x, bf16* __restrict__ y,
                             const bf16* __restrict__ res,
                             const float* __restrict__ partial,
                             const float* __restrict__ mean,
                             const float* __restrict__ var,
                             const float* __restrict__ weight,
                             const float* __restrict__ bias, float eps, int c,
                             int hw, int len, int chunks, int relu) {
  __shared__ Coef coef;
  const int64_t blk = (int64_t)gridDim.x - 1 - blockIdx.x;  // pass 1 reversed
  const int chunk = blk % chunks;
  const int64_t plane = blk / chunks;
  const int ch = plane % c;
  if (threadIdx.x == 0)
    coef = kBatch ? batch_coef(mean, var, weight, bias, eps, ch)
                  : instance_coef(partial, plane / c, ch, c, chunks, hw);
  __syncthreads();
  const Coef k = coef;
  const int64_t e = min64(hw, (int64_t)(chunk + 1) * len);
  const bf16* xp = x + plane * hw;
  const bf16* rp = kRes ? res + plane * hw : nullptr;
  bf16* yp = y + plane * hw;
  const int stride = blockDim.x * V;
  int64_t i = (int64_t)chunk * len + threadIdx.x * V;
  for (; i + (kUnroll - 1) * stride < e; i += kUnroll * stride) {
    float f[kUnroll][V], q[kRes ? kUnroll : 1][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      load<V>(xp + i + u * stride, f[u]);
      if (kRes) load<V>(rp + i + u * stride, q[kRes ? u : 0]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        f[u][j] = normalise<kBatch>(f[u][j], k.mean, k.scale, k.shift, relu);
        if (kRes) f[u][j] = residual_relu(f[u][j], q[kRes ? u : 0][j]);
      }
      store<V>(yp + i + u * stride, f[u]);
    }
  }
  for (; i < e; i += stride) {
    float f[V], q[V];
    load<V>(xp + i, f);
    if (kRes) load<V>(rp + i, q);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      f[j] = normalise<kBatch>(f[j], k.mean, k.scale, k.shift, relu);
      if (kRes) f[j] = residual_relu(f[j], q[j]);
    }
    store<V>(yp + i, f);
  }
}

// ---------------------------------------------------------------------------
// the launch: pass 1 where the statistics are the sample's own, then pass 2

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// pass 2 over the blocks, with the residual where res is not null
template <bool kBatch, bool kRes>
cudaError_t apply(const bf16* x, bf16* y, const bf16* res,
                  const float* part, const float* mean, const float* var,
                  const float* weight, const float* bias, float eps, int c,
                  int hw, int channels_last, int blocks, int threads,
                  int span, int chunks, bool vec, int relu,
                  cudaStream_t stream) {
  if (channels_last)
    norm_apply_rows_kernel<kBatch, kRes><<<blocks, threads, 0, stream>>>(
        x, y, res, part, mean, var, weight, bias, eps, hw, c, span, chunks,
        relu);
  else if (vec)
    norm_apply_planes_kernel<kVec, kBatch, kRes><<<blocks, kThreads, 0,
                                                   stream>>>(
        x, y, res, part, mean, var, weight, bias, eps, c, hw, span, chunks,
        relu);
  else
    norm_apply_planes_kernel<1, kBatch, kRes><<<blocks, kThreads, 0, stream>>>(
        x, y, res, part, mean, var, weight, bias, eps, c, hw, span, chunks,
        relu);
  return cudaGetLastError();
}

template <bool kBatch>
int launch(const void* x, void* y, const void* res, void* partial,
           const float* mean, const float* var, const float* weight,
           const float* bias, float eps, int n, int c, int hw,
           int channels_last, int chunks, int relu, cudaStream_t stream) {
  if (n < 0 || hw < 0 || c < kVec || c > kMaxC || c % kVec || chunks < 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || hw == 0) return (int)cudaSuccess;
  const int64_t units = channels_last ? (int64_t)n : (int64_t)n * c;
  if (units * chunks > INT_MAX) return (int)cudaErrorInvalidValue;
  const int blocks = (int)(units * chunks);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* rb = static_cast<const bf16*>(res);
  bf16* yb = static_cast<bf16*>(y);
  float* part = static_cast<float*>(partial);
  int threads = kThreads, span;
  bool vec = false;
  if (channels_last) {
    if (!aligned16(x) || !aligned16(y) || (res && !aligned16(res)))
      return (int)cudaErrorMisalignedAddress;
    const int groups = c / kVec;
    threads = groups * (kThreads / groups);
    span = (int)(((int64_t)hw + chunks - 1) / chunks);  // rows a chunk
    if (!kBatch)
      norm_stats_rows_kernel<<<blocks, threads, 0, stream>>>(xb, part, hw, c,
                                                              span, chunks);
  } else {
    vec = hw % kVec == 0 && aligned16(x) && aligned16(y) &&
          (!res || aligned16(res));
    const int v = vec ? kVec : 1;
    span = (int)(((int64_t)hw + (int64_t)chunks * v - 1) /
                 ((int64_t)chunks * v) * v);  // elements a chunk
    if (!kBatch) {
      if (vec)
        norm_stats_planes_kernel<kVec><<<blocks, kThreads, 0, stream>>>(
            xb, part, c, hw, span, chunks);
      else
        norm_stats_planes_kernel<1><<<blocks, kThreads, 0, stream>>>(
            xb, part, c, hw, span, chunks);
    }
  }
  if (!kBatch) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)(res ? apply<kBatch, true>(xb, yb, rb, part, mean, var, weight,
                                          bias, eps, c, hw, channels_last,
                                          blocks, threads, span, chunks, vec,
                                          relu, stream)
                   : apply<kBatch, false>(xb, yb, nullptr, part, mean, var,
                                          weight, bias, eps, c, hw,
                                          channels_last, blocks, threads,
                                          span, chunks, vec, relu, stream));
}

}  // namespace

extern "C" {

// x, y: n samples of c channels over hw = h * w pixels, bf16, dense in one
// layout: channels-last ((n, hw, c), channels_last = 1, 16-byte aligned) or
// NCHW ((n, c, hw), channels_last = 0); y is written in x's layout. c is a
// multiple of 8 up to 1,024. res: null, or a bf16 tensor of x's shape and
// layout (16-byte aligned channels-last): then y = relu(bf16(norm) + res),
// rounded once more. partial: (n, chunks, 2, c) f32 scratch; chunks splits
// each unit (a sample channels-last, a plane in NCHW) over that many blocks.
// relu: clamp at 0 before the rounding. Returns a cudaError_t.
int norm_instance_bf16(const void* x, void* y, const void* res, void* partial,
                       int n, int c, int hw, int channels_last, int chunks,
                       int relu, void* stream) {
  return launch<false>(x, y, res, partial, nullptr, nullptr, nullptr, nullptr,
                       0.f, n, c, hw, channels_last, chunks, relu,
                       static_cast<cudaStream_t>(stream));
}

// The same with BatchNorm's running statistics: mean, var, weight, bias (c,)
// f32 and eps; no scratch, one pass.
int norm_batch_bf16(const void* x, void* y, const void* res, const void* mean,
                    const void* var, const void* weight, const void* bias,
                    float eps, int n, int c, int hw, int channels_last,
                    int chunks, int relu, void* stream) {
  return launch<true>(x, y, res, nullptr, static_cast<const float*>(mean),
                      static_cast<const float*>(var),
                      static_cast<const float*>(weight),
                      static_cast<const float*>(bias), eps, n, c, hw,
                      channels_last, chunks, relu,
                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
