// Instance norm and eval-mode BatchNorm over bf16 or f32 activations, with an
// optional fused ReLU and an optional residual epilogue, for Hopper (sm_90a):
// the norms of the encoders in inference, in the bf16 fast mode and at f32.
//
// Replaces no TPU kernel. The JAX package leaves its norm
// (bflow_tpu/models/extractor.py:Norm) to XLA, which fuses the f32 cast, the
// means and the normalise into about two passes over the activation. PyTorch
// runs the same chain eagerly, each step writing and reading a whole f32
// intermediate: in bf16 a cast copy to f32, two mean reductions, a square, a
// clamp, a subtract, a multiply, a cast back and a separate ReLU, some 48
// bytes of traffic an element; in f32 the two-pass chain (a mean, a
// subtract, a square, a second mean, the subtract again, a multiply by the
// rsqrt) and the ReLU, ~40-48 bytes, 68 with the residual add. This kernel
// gives the port what XLA gave the TPU.
//
// Bound: bytes. A norm does a few operations an element, so only traffic
// counts: the instance norm reads its input twice (statistics, then
// normalise) and writes its output once, 6 bytes an element in bf16 and 12
// in f32; the BatchNorm takes the running statistics, so it reads once and
// writes once, 4 and 8 bytes. With a residual, one read more (2 or 4 bytes):
// the epilogue saves the add and the ReLU that followed the norm.
//
// Design:
// - Pass 1, statistics (instance norm only): a grid over (unit, chunk),
//   where a unit is a sample in the channels-last layout and a (sample,
//   channel) plane in NCHW. Each thread loads 16 bytes (8 bf16, 4 f32) at a
//   time, kUnroll loads in flight, and keeps its statistics in registers;
//   the block reduces them in a fixed order and writes one partial per chunk
//   to the scratch buffer partial (n, chunks, 2, c) f32. No atomics: the
//   statistics, and so the output, repeat bit for bit from one run to the
//   next.
//   - bf16 (the JAX fast mode's single pass): f32 sums of x and x^2.
//   - f32 (the port's f32 function, the JAX parity mode's two-pass
//     variance var = E[(x - m1)^2], not E[x^2] - m1^2): the count, mean and
//     sum of squared deviations (M2) of the values read. Each group of
//     values a thread loads at once gets its own mean and M2 from
//     registers, two passes over the group, and joins the thread's running
//     moments by Chan, Golub and LeVeque's pairwise update; threads, warps,
//     chunks join the same way in a fixed order. Exact in real arithmetic,
//     as stable as two passes, and x is read once.
// - Pass 2, normalise: each block joins its sample's partials in chunk
//   order and takes m1 and rstd = 1 / sqrt(var + 1e-5) per channel (bf16:
//   m1 = E[x], var = max(E[x^2] - m1^2, 0); f32: the moments' mean and
//   M2 / count), then streams its chunk: (x - m1) * rstd in f32, the ReLU,
//   the output in x's type (bf16: one rounding). BatchNorm: (x - mean) *
//   (w * rsqrt(var + eps)) + b from the running statistics, in f32. Every
//   step is a rounded f32 operation (no contraction into an fma), as
//   PyTorch's f32 ops take them one by one.
// - The residual epilogue (a residual block's relu(x + norm(z)), the norm's
//   ReLU included): x, in z's type and layout, is added to the normalised
//   value in f32, then the ReLU. In bf16 the normalised value is rounded to
//   bf16 first, as without the epilogue, and the sum rounded once more:
//   bf16(f32(x) + f32(y)) is PyTorch's bf16 add, and the ReLU commutes with
//   the rounding, so the output is the eager chain's bit for bit given the
//   same norm. In f32 it is PyTorch's f32 add and ReLU.
// - Pass 2 runs its blocks in the reverse order of pass 1's, so the first
//   ones read what pass 1 read last while it is still in the 50 MB L2.
// - Two layouts, the output in the input's: channels-last (n, h*w, c), where
//   a thread's 8 (bf16) or 4 (f32) channels stay fixed while it walks down
//   the rows (the rows of a chunk are one contiguous span, so a block's loads
//   are too); NCHW (n, c, h*w), a contiguous plane per channel, 16-byte
//   loads when h*w is a multiple of the vector and scalar ones otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kUnroll = 4;   // 16-byte loads in flight per thread
constexpr int kMaxC = 1024;  // channels a block keeps coefficients for
constexpr float kInstanceEps = 1e-5f;

// elements of T in one 16-byte access
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

template <typename T>
constexpr bool kF32 = std::is_same<T, float>::value;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// V values in, as f32; V f32 out, in the tensor's type (bf16: round to
// nearest even)
template <int V>
__device__ __forceinline__ void load(const bf16* p, float* f) {
  if constexpr (V == kVec<bf16>) {
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
__device__ __forceinline__ void load(const float* p, float* f) {
  if constexpr (V == kVec<float>) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = u.x;
    f[1] = u.y;
    f[2] = u.z;
    f[3] = u.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = p[i];
  }
}

template <int V>
__device__ __forceinline__ void store(bf16* p, const float* f) {
  if constexpr (V == kVec<bf16>) {
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

template <int V>
__device__ __forceinline__ void store(float* p, const float* f) {
  if constexpr (V == kVec<float>) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = f[i];
  }
}

// A channel's normalisation: y = (x - mean) * scale (+ shift for BatchNorm)
struct Coef {
  float mean, scale, shift;
};

// The count, mean and sum of squared deviations from the mean (M2) of a set
// of values
struct Moments {
  float n, mean, m2;
};

// a absorbs b (Chan, Golub and LeVeque): with d = b.mean - a.mean, the mean
// moves by d * b.n / n and M2 gains b.m2 + d^2 * a.n * b.n / n; w = b.n / n
// is the caller's, who may share it between channels of one count
__device__ __forceinline__ void absorb(Moments& a, const Moments& b, float w) {
  const float d = b.mean - a.mean;
  a.mean = fmaf(d, w, a.mean);
  a.m2 = a.m2 + b.m2 + d * d * a.n * w;
  a.n += b.n;
}

// the same where b may hold no values (an empty chunk, a thread past the
// end), which leave a as it is
__device__ __forceinline__ void merge(Moments& a, const Moments& b) {
  if (b.n > 0.f) absorb(a, b, b.n / (a.n + b.n));
}

// the moments of G values, two passes over them; G is a power of two, so
// the mean's division is exact
template <int G>
__device__ __forceinline__ Moments moments(const float* f) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < G; ++i) s += f[i];
  const float mean = s * (1.f / G);
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const float d = f[i] - mean;
    q = fmaf(d, d, q);
  }
  return {(float)G, mean, q};
}

__device__ __forceinline__ Coef rstd_coef(float mean, float var) {
  return {mean, __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, kInstanceEps))), 0.f};
}

// bf16: m1, rstd of channel ch of sample n from the chunks' partial sums of
// x and x^2, taken in chunk order
__device__ __forceinline__ Coef sums_coef(const float* partial, int64_t n,
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
  return rstd_coef(m1, fmaxf(__fsub_rn(m2, __fmul_rn(m1, m1)), 0.f));
}

// f32: m1, rstd of channel ch of sample n from the chunks' (mean, M2)
// partials, joined in chunk order; chunk k held the values
// [k * span, min(total, (k + 1) * span)) of the channel's total
__device__ __forceinline__ Coef moments_coef(const float* partial, int64_t n,
                                             int ch, int c, int chunks,
                                             int total, int span) {
  const float* p = partial + n * chunks * 2 * c + ch;
  Moments t = {0.f, 0.f, 0.f};
  for (int k = 0; k < chunks; ++k) {
    const int64_t lo = (int64_t)k * span;
    const float count = (float)(min64(total, lo + span) - min64(total, lo));
    merge(t, {count, p[(2 * k) * c], p[(2 * k + 1) * c]});
  }
  return rstd_coef(t.mean, __fdiv_rn(t.m2, t.n));
}

template <typename T>
__device__ __forceinline__ Coef instance_coef(const float* partial, int64_t n,
                                              int ch, int c, int chunks,
                                              int total, int span) {
  if constexpr (kF32<T>)
    return moments_coef(partial, n, ch, c, chunks, total, span);
  else
    return sums_coef(partial, n, ch, c, chunks, total);
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

// relu(y + r) in f32 as PyTorch's add and ReLU (clamp_min: NaN passes) take
// it in T: for bf16, y rounded as the norm's output, then the f32 sum, which
// the store rounds once
template <typename T>
__device__ __forceinline__ float residual_relu(float y, float r) {
  if constexpr (!kF32<T>) y = __bfloat162float(__float2bfloat16_rn(y));
  const float s = __fadd_rn(y, r);
  return s != s ? s : fmaxf(s, 0.f);
}

// ---------------------------------------------------------------------------
// channels-last: x (n, rows, c) dense, c a multiple of 8. The block has
// blockDim.x = groups * step threads: thread t reads channels
// [V * (t % groups), +V) of row t / groups (V = kVec<T>), and the block steps
// down `step` rows at a time over its chunk [chunk * rpc, min(rows,
// (chunk + 1) * rpc)).

// bf16: per chunk and channel, the sums of x and x^2
__global__ void __launch_bounds__(kThreads)
    norm_stats_rows_kernel(const bf16* __restrict__ x,
                           float* __restrict__ partial, int rows, int c,
                           int rpc, int chunks) {
  constexpr int V = kVec<bf16>;
  __shared__ float red[2 * kThreads * V];  // [2][step][c]
  const int groups = c / V, step = blockDim.x / groups;
  const int g = threadIdx.x % groups, r = threadIdx.x / groups;
  const int chunk = blockIdx.x % chunks;
  const int64_t n = blockIdx.x / chunks;
  const int64_t r1 = min64(rows, (int64_t)(chunk + 1) * rpc);
  const bf16* xs = x + n * rows * c + g * V;
  float s[V], q[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = q[i] = 0.f;
  int64_t row = (int64_t)chunk * rpc + r;
  for (; row + (kUnroll - 1) * step < r1; row += kUnroll * step) {
    float f[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load<V>(xs + (row + u * step) * c, f[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s[i] += f[u][i];
        q[i] = fmaf(f[u][i], f[u][i], q[i]);
      }
  }
  for (; row < r1; row += step) {
    float f[V];
    load<V>(xs + row * c, f);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      s[i] += f[i];
      q[i] = fmaf(f[i], f[i], q[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    red[r * c + g * V + i] = s[i];
    red[(step + r) * c + g * V + i] = q[i];
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

// f32: per chunk and channel, the mean and M2 (the count follows from rpc)
__global__ void __launch_bounds__(kThreads)
    norm_moments_rows_kernel(const float* __restrict__ x,
                             float* __restrict__ partial, int rows, int c,
                             int rpc, int chunks) {
  constexpr int V = kVec<float>;
  __shared__ float red_mean[kThreads * V], red_m2[kThreads * V];  // [step][c]
  __shared__ float red_n[kThreads];                                // [step]
  const int groups = c / V, step = blockDim.x / groups;
  const int g = threadIdx.x % groups, r = threadIdx.x / groups;
  const int chunk = blockIdx.x % chunks;
  const int64_t n = blockIdx.x / chunks;
  const int64_t r1 = min64(rows, (int64_t)(chunk + 1) * rpc);
  const float* xs = x + n * rows * c + g * V;
  Moments m[V];
#pragma unroll
  for (int i = 0; i < V; ++i) m[i] = {0.f, 0.f, 0.f};
  int64_t row = (int64_t)chunk * rpc + r;
  for (; row + (kUnroll - 1) * step < r1; row += kUnroll * step) {
    float f[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load<V>(xs + (row + u * step) * c, f[u]);
    const float w = (float)kUnroll / (m[0].n + (float)kUnroll);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = f[u][i];
      absorb(m[i], moments<kUnroll>(v), w);
    }
  }
  for (; row < r1; row += step) {
    float f[V];
    load<V>(xs + row * c, f);
    const float w = 1.f / (m[0].n + 1.f);
#pragma unroll
    for (int i = 0; i < V; ++i) absorb(m[i], {1.f, f[i], 0.f}, w);
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    red_mean[r * c + g * V + i] = m[i].mean;
    red_m2[r * c + g * V + i] = m[i].m2;
  }
  if (g == 0) red_n[r] = m[0].n;
  __syncthreads();
  float* out = partial + (n * chunks + chunk) * 2 * c;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    Moments t = {0.f, 0.f, 0.f};
    for (int j = 0; j < step; ++j)
      merge(t, {red_n[j], red_mean[j * c + ch], red_m2[j * c + ch]});
    out[ch] = t.mean;
    out[c + ch] = t.m2;
  }
}

template <typename T, bool kBatch, bool kRes>
__global__ void __launch_bounds__(kThreads)
    norm_apply_rows_kernel(const T* __restrict__ x, T* __restrict__ y,
                           const T* __restrict__ res,
                           const float* __restrict__ partial,
                           const float* __restrict__ mean,
                           const float* __restrict__ var,
                           const float* __restrict__ weight,
                           const float* __restrict__ bias, float eps, int rows,
                           int c, int rpc, int chunks, int relu) {
  constexpr int V = kVec<T>;
  __shared__ float sm_mean[kMaxC], sm_scale[kMaxC], sm_shift[kMaxC];
  const int64_t blk = (int64_t)gridDim.x - 1 - blockIdx.x;  // pass 1 reversed
  const int chunk = blk % chunks;
  const int64_t n = blk / chunks;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    const Coef k = kBatch ? batch_coef(mean, var, weight, bias, eps, ch)
                          : instance_coef<T>(partial, n, ch, c, chunks, rows,
                                             rpc);
    sm_mean[ch] = k.mean;
    sm_scale[ch] = k.scale;
    sm_shift[ch] = k.shift;
  }
  __syncthreads();
  const int groups = c / V, step = blockDim.x / groups;
  const int g = threadIdx.x % groups, r = threadIdx.x / groups;
  float m[V], sc[V], sh[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    m[i] = sm_mean[g * V + i];
    sc[i] = sm_scale[g * V + i];
    sh[i] = sm_shift[g * V + i];
  }
  const int64_t r1 = min64(rows, (int64_t)(chunk + 1) * rpc);
  const int64_t base = n * rows * c + g * V;
  const T* xs = x + base;
  const T* rs = kRes ? res + base : nullptr;
  T* ys = y + base;
  int64_t row = (int64_t)chunk * rpc + r;
  for (; row + (kUnroll - 1) * step < r1; row += kUnroll * step) {
    float f[kUnroll][V], q[kRes ? kUnroll : 1][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      load<V>(xs + (row + u * step) * c, f[u]);
      if (kRes) load<V>(rs + (row + u * step) * c, q[kRes ? u : 0]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        f[u][i] = normalise<kBatch>(f[u][i], m[i], sc[i], sh[i], relu);
        if (kRes) f[u][i] = residual_relu<T>(f[u][i], q[kRes ? u : 0][i]);
      }
      store<V>(ys + (row + u * step) * c, f[u]);
    }
  }
  for (; row < r1; row += step) {
    float f[V], q[V];
    load<V>(xs + row * c, f);
    if (kRes) load<V>(rs + row * c, q);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      f[i] = normalise<kBatch>(f[i], m[i], sc[i], sh[i], relu);
      if (kRes) f[i] = residual_relu<T>(f[i], q[i]);
    }
    store<V>(ys + row * c, f);
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

// the block's moments, joined in a fixed order: a tree within each warp
// (lane i absorbs lane i + o), then the warps in order; the result in
// thread 0
__device__ __forceinline__ Moments block_moments(Moments m) {
  __shared__ Moments warp_moments[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const Moments b = {__shfl_down_sync(0xffffffffu, m.n, o),
                       __shfl_down_sync(0xffffffffu, m.mean, o),
                       __shfl_down_sync(0xffffffffu, m.m2, o)};
    merge(m, b);
  }
  if (threadIdx.x % 32 == 0) warp_moments[threadIdx.x / 32] = m;
  __syncthreads();
  Moments t = {0.f, 0.f, 0.f};
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x / 32); ++w) merge(t, warp_moments[w]);
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

template <int V>
__global__ void __launch_bounds__(kThreads)
    norm_moments_planes_kernel(const float* __restrict__ x,
                               float* __restrict__ partial, int c, int hw,
                               int len, int chunks) {
  const int chunk = blockIdx.x % chunks;
  const int64_t plane = blockIdx.x / chunks;
  const int64_t e = min64(hw, (int64_t)(chunk + 1) * len);
  const float* xp = x + plane * hw;
  const int stride = blockDim.x * V;
  Moments m = {0.f, 0.f, 0.f};
  int64_t i = (int64_t)chunk * len + threadIdx.x * V;
  for (; i + (kUnroll - 1) * stride < e; i += kUnroll * stride) {
    float f[kUnroll * V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load<V>(xp + i + u * stride, f + u * V);
    merge(m, moments<kUnroll * V>(f));
  }
  for (; i < e; i += stride) {
    float f[V];
    load<V>(xp + i, f);
    merge(m, moments<V>(f));
  }
  const Moments t = block_moments(m);
  if (threadIdx.x == 0) {
    const int64_t n = plane / c;
    float* out = partial + (n * chunks + chunk) * 2 * c + plane % c;
    out[0] = t.mean;
    out[c] = t.m2;
  }
}

template <int V, typename T, bool kBatch, bool kRes>
__global__ void __launch_bounds__(kThreads)
    norm_apply_planes_kernel(const T* __restrict__ x, T* __restrict__ y,
                             const T* __restrict__ res,
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
                  : instance_coef<T>(partial, plane / c, ch, c, chunks, hw,
                                     len);
  __syncthreads();
  const Coef k = coef;
  const int64_t e = min64(hw, (int64_t)(chunk + 1) * len);
  const T* xp = x + plane * hw;
  const T* rp = kRes ? res + plane * hw : nullptr;
  T* yp = y + plane * hw;
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
        if (kRes) f[u][j] = residual_relu<T>(f[u][j], q[kRes ? u : 0][j]);
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
      if (kRes) f[j] = residual_relu<T>(f[j], q[j]);
    }
    store<V>(yp + i, f);
  }
}

// ---------------------------------------------------------------------------
// the launch: pass 1 where the statistics are the sample's own, then pass 2

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// pass 1 over the blocks
template <typename T>
void stats(const T* x, float* part, int c, int hw, int channels_last,
           int blocks, int threads, int span, int chunks, bool vec,
           cudaStream_t stream) {
  constexpr int V = kVec<T>;
  if constexpr (kF32<T>) {
    if (channels_last)
      norm_moments_rows_kernel<<<blocks, threads, 0, stream>>>(x, part, hw, c,
                                                                span, chunks);
    else if (vec)
      norm_moments_planes_kernel<V><<<blocks, kThreads, 0, stream>>>(
          x, part, c, hw, span, chunks);
    else
      norm_moments_planes_kernel<1><<<blocks, kThreads, 0, stream>>>(
          x, part, c, hw, span, chunks);
  } else {
    if (channels_last)
      norm_stats_rows_kernel<<<blocks, threads, 0, stream>>>(x, part, hw, c,
                                                              span, chunks);
    else if (vec)
      norm_stats_planes_kernel<V><<<blocks, kThreads, 0, stream>>>(
          x, part, c, hw, span, chunks);
    else
      norm_stats_planes_kernel<1><<<blocks, kThreads, 0, stream>>>(
          x, part, c, hw, span, chunks);
  }
}

// pass 2 over the blocks, with the residual where res is not null
template <typename T, bool kBatch, bool kRes>
cudaError_t apply(const T* x, T* y, const T* res, const float* part,
                  const float* mean, const float* var, const float* weight,
                  const float* bias, float eps, int c, int hw,
                  int channels_last, int blocks, int threads, int span,
                  int chunks, bool vec, int relu, cudaStream_t stream) {
  constexpr int V = kVec<T>;
  if (channels_last)
    norm_apply_rows_kernel<T, kBatch, kRes><<<blocks, threads, 0, stream>>>(
        x, y, res, part, mean, var, weight, bias, eps, hw, c, span, chunks,
        relu);
  else if (vec)
    norm_apply_planes_kernel<V, T, kBatch, kRes><<<blocks, kThreads, 0,
                                                   stream>>>(
        x, y, res, part, mean, var, weight, bias, eps, c, hw, span, chunks,
        relu);
  else
    norm_apply_planes_kernel<1, T, kBatch, kRes><<<blocks, kThreads, 0,
                                                   stream>>>(
        x, y, res, part, mean, var, weight, bias, eps, c, hw, span, chunks,
        relu);
  return cudaGetLastError();
}

template <typename T, bool kBatch>
int launch(const void* x, void* y, const void* res, void* partial,
           const float* mean, const float* var, const float* weight,
           const float* bias, float eps, int n, int c, int hw,
           int channels_last, int chunks, int relu, cudaStream_t stream) {
  constexpr int V = kVec<T>;
  // channels in steps of 8 (a bf16 vector; two f32 ones)
  if (n < 0 || hw < 0 || c < kVec<bf16> || c > kMaxC || c % kVec<bf16> ||
      chunks < 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || hw == 0) return (int)cudaSuccess;
  const int64_t units = channels_last ? (int64_t)n : (int64_t)n * c;
  if (units * chunks > INT_MAX) return (int)cudaErrorInvalidValue;
  const int blocks = (int)(units * chunks);
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(res);
  T* yt = static_cast<T*>(y);
  float* part = static_cast<float*>(partial);
  int threads = kThreads, span;
  bool vec = false;
  if (channels_last) {
    if (!aligned16(x) || !aligned16(y) || (res && !aligned16(res)))
      return (int)cudaErrorMisalignedAddress;
    const int groups = c / V;
    threads = groups * (kThreads / groups);
    span = (int)(((int64_t)hw + chunks - 1) / chunks);  // rows a chunk
  } else {
    vec = hw % V == 0 && aligned16(x) && aligned16(y) &&
          (!res || aligned16(res));
    const int v = vec ? V : 1;
    span = (int)(((int64_t)hw + (int64_t)chunks * v - 1) /
                 ((int64_t)chunks * v) * v);  // elements a chunk
  }
  if (!kBatch) {
    stats<T>(xt, part, c, hw, channels_last, blocks, threads, span, chunks,
             vec, stream);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)(res ? apply<T, kBatch, true>(xt, yt, rt, part, mean, var,
                                             weight, bias, eps, c, hw,
                                             channels_last, blocks, threads,
                                             span, chunks, vec, relu, stream)
                   : apply<T, kBatch, false>(xt, yt, nullptr, part, mean, var,
                                             weight, bias, eps, c, hw,
                                             channels_last, blocks, threads,
                                             span, chunks, vec, relu,
                                             stream));
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
  return launch<bf16, false>(x, y, res, partial, nullptr, nullptr, nullptr,
                             nullptr, 0.f, n, c, hw, channels_last, chunks,
                             relu, static_cast<cudaStream_t>(stream));
}

// The same with BatchNorm's running statistics: mean, var, weight, bias (c,)
// f32 and eps; no scratch, one pass.
int norm_batch_bf16(const void* x, void* y, const void* res, const void* mean,
                    const void* var, const void* weight, const void* bias,
                    float eps, int n, int c, int hw, int channels_last,
                    int chunks, int relu, void* stream) {
  return launch<bf16, true>(x, y, res, nullptr, static_cast<const float*>(mean),
                            static_cast<const float*>(var),
                            static_cast<const float*>(weight),
                            static_cast<const float*>(bias), eps, n, c, hw,
                            channels_last, chunks, relu,
                            static_cast<cudaStream_t>(stream));
}

// norm_instance_bf16 over f32 x, y and res: the two-pass variance
// E[(x - m1)^2] (per-chunk moments joined by Chan's update), the output and
// the residual epilogue y = relu(norm + res) in f32.
int norm_instance_f32(const void* x, void* y, const void* res, void* partial,
                      int n, int c, int hw, int channels_last, int chunks,
                      int relu, void* stream) {
  return launch<float, false>(x, y, res, partial, nullptr, nullptr, nullptr,
                              nullptr, 0.f, n, c, hw, channels_last, chunks,
                              relu, static_cast<cudaStream_t>(stream));
}

// norm_batch_bf16 over f32 x, y and res.
int norm_batch_f32(const void* x, void* y, const void* res, const void* mean,
                   const void* var, const void* weight, const void* bias,
                   float eps, int n, int c, int hw, int channels_last,
                   int chunks, int relu, void* stream) {
  return launch<float, true>(x, y, res, nullptr,
                             static_cast<const float*>(mean),
                             static_cast<const float*>(var),
                             static_cast<const float*>(weight),
                             static_cast<const float*>(bias), eps, n, c, hw,
                             channels_last, chunks, relu,
                             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
