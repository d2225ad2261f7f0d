// Windowed bilinear correlation lookup, backward (VJP), every pyramid level
// of a level table in one launch, accumulating dVol, for Hopper (sm_90a).
//
// Replaces the TPU kernel bflow_tpu/ops/pallas/corr_lookup_v3.py:_bwd_kernel
// (reached through _bwd_impl and the custom VJP _lookup_cvjp), together
// with the backward of the index and divide around it. The forward
// (csrc/corr_lookup_fwd.cu) reads, for query position m, target t and
// level l, the (2r+1)^2 bilinear taps of the map vol_l[k, m] at
// (x + dx, y + dy), (x, y) = base coords[t, m] * 2^-l. Given the
// cotangent g (M rows of C channels at row stride ld, the layout of the
// forward's output), this kernel
//
//   adds to dvol_l[k, m]  each tap's cotangent spread over its four
//                         bilinear corners (corners outside the map drop
//                         out), per map cell rounded once to the volume's
//                         type and added to the level's f32 accumulator,
//                         which the caller zeroed once for the whole
//                         backward pass: every refinement iteration adds
//                         into the same buffer, iterations in the order
//                         the backward pass runs them;
//   writes dcoords[t, m]  sum over the target's levels, in level order, of
//                         2^-l * sum over taps of g * d(tap)/d(x, y), f32,
//                         d/dx = (v01 - v00)(1 - fy) + (v11 - v10) fy and
//                         likewise for y; corners and fractions come from
//                         floor, so at an integer coordinate this is the
//                         right derivative (the TPU kernel's _dhat).
//
// Queries own disjoint maps, so no two warps touch one accumulator cell in
// a launch, and launches are ordered by the stream: plain loads and
// stores, no atomics, bitwise repeatable.
//
// What bounds it on this card: a gather, a few flops per byte. Per
// (query, level, target) it reads 81 cotangents and the in-map part of its
// (2r+2)^2 patch from vol, and reads and writes that patch of the f32
// accumulator; per (query, target) it reads 8 bytes of base coords and
// writes 8 of dcoords, once whatever the number of its levels: bytes ~ sum
// over levels of Q * (81 itemsize + (2r+2)^2 (itemsize + 8)) + 16 T M. The
// probe variants (corr_lookup_table.cuh: Probe) take the patch, the
// accumulator's read or the cotangents out to see where the time goes.
//
// Design: one block per query position m, one warp per slot (level,
// target) of the table, so every item of the query runs at once; the
// loads of a level are issued together (fixed, unrolled counts per radius)
// and the warp makes one round trip to device memory before it computes.
// Per slot the warp
//   1. stages the query's (2r+3)^2 volume patch (for dcoords; see
//      corr_lookup_table.cuh), its 81 cotangents (one contiguous run) and
//      the accumulator cells of its (2r+2)^2 patch, and computes per tap
//      column and row the corner position floor(x + dx) and fraction,
//      exactly as the forward computes them, and from them the weight of
//      each of the 3 tap columns (rows) that can touch a patch column
//      (row): 1 - f, f or 0;
//   2. per in-map cell of that patch (origin floor(x) - r), sums the 3 x 3
//      taps' g * wy * wx in f32, rows then columns ascending (the plain
//      VJP's order; a tap that does not touch the cell adds a zero), and
//      stores the staged accumulator value plus the sum, rounded to the
//      volume's type. floor(x + dx) is floor(x) + dx or, where the f32 add
//      rounds up onto an integer, one more; then the fraction is exactly
//      0, so the corner that falls outside the patch carries weight 0;
//   3. each lane sums its taps' (gx, gy) from the staged patch, and a warp
//      shuffle tree reduces them in a fixed order; after one barrier, one
//      thread per base target adds its slots' sums, times 2^-l, in slot
//      (= level) order and writes dcoords.

#include "corr_lookup_table.cuh"

namespace {

using namespace corr_table;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <int R>
struct WarpScratch {
  static constexpr int kWin = 2 * R + 1, kPatch = kWin + 1;
  float patch[Patch<R>::kCells];
  float g[kWin * kWin];
  Axes<R> axes;
  // weight of tap row a - 2 + q onto patch row a (0: it does not touch
  // it), and likewise for columns
  float wy[kPatch][3], wx[kPatch][3];
};

// the weight of tap column i of a query at x (patch origin x0) onto patch
// column a: the plain version's 1 - f or f, or 0 where neither of its
// corners is there; rows alike
template <int R>
__device__ __forceinline__ float tap_weight(float x, float x0, int i, int a) {
  if (i < 0 || i > 2 * R) return 0.f;
  const Axis ax = axis(x, i - R);
  const float rel = ax.c - x0;  // exact when live
  if (rel == (float)a) return __fsub_rn(1.f, ax.f);
  if (__fadd_rn(rel, 1.f) == (float)a) return ax.f;
  return 0.f;
}

template <int R>
constexpr size_t smem_bytes(int slots) {
  return (size_t)slots * (sizeof(WarpScratch<R>) + 2 * sizeof(float));
}

template <typename T, int R, int kProbe>
__global__ void __launch_bounds__(kMaxSlots * 32)
corr_lookup_bwd_kernel(const __grid_constant__ LookupTable tab,
                       const float* __restrict__ coords,
                       const T* __restrict__ g,
                       float* __restrict__ dcoords) {
  constexpr int kWin = 2 * R + 1, kTaps = kWin * kWin;
  constexpr int kPatch = kWin + 1, kCells = kPatch * kPatch;
  constexpr int kCellRounds = (kCells + 31) / 32;
  constexpr int kTapRounds = (kTaps + 31) / 32;
  extern __shared__ float smem[];
  const int S = tab.n_slots;
  WarpScratch<R>* scratch = reinterpret_cast<WarpScratch<R>*>(smem);
  float* dc_s = reinterpret_cast<float*>(scratch + S);  // (S, 2)

  const int s = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long M = tab.queries;
  const long long m = blockIdx.x;
  const LevelDesc& L = tab.level[tab.slot_level[s]];
  const int t = tab.slot_target[s];
  WarpScratch<R>& w = scratch[s];
  const long long map_off = ((long long)tab.slot_k[s] * M + m) * L.hl * L.wl;
  const T* map = static_cast<const T*>(L.vol) + map_off;
  const float* c = coords + 2 * ((long long)t * M + m);
  const Patch<R> p = make_patch<R>(__fmul_rn(__ldg(c), L.scale),
                                   __fmul_rn(__ldg(c + 1), L.scale), L.hl,
                                   L.wl);
  const bool need_dc = dcoords != nullptr;
  float* dm = L.dvol == nullptr ? nullptr : L.dvol + map_off;

  // 1. every load of this slot in flight at once
  if (need_dc)
    stage_patch<R, !(kProbe & kProbeNoPatch)>(p, map, L.hl, L.wl, w.patch,
                                               lane);
  const T* gq = g + m * tab.ld + (long long)s * kTaps;
  float gv[kTapRounds];
#pragma unroll
  for (int k = 0; k < kTapRounds; ++k)
    gv[k] = lane + 32 * k >= kTaps              ? 0.f
            : (kProbe & kProbeNoCotangent) ? L.scale
                                           : load_f32(gq + lane + 32 * k);
  float av[kCellRounds];
  int aidx[kCellRounds];  // the cell's offset in the map, -1: not in it
#pragma unroll
  for (int k = 0; k < kCellRounds; ++k) {
    const int cc = lane + 32 * k;
    const int a = cc / kPatch, b = cc - a * kPatch;
    const int row = p.iy0 + a, col = p.ix0 + b;
    aidx[k] = -1;
    av[k] = 0.f;
    if (dm != nullptr && p.live && cc < kCells && row >= 0 && row < L.hl &&
        col >= 0 && col < L.wl) {
      aidx[k] = row * L.wl + col;
      av[k] = (kProbe & kProbeNoAccRead) ? 0.f : dm[aidx[k]];
    }
  }
  make_axes<R>(p, w.axes, lane);
#pragma unroll
  for (int k = 0; k < (6 * kPatch + 31) / 32; ++k) {
    const int e = lane + 32 * k;  // (axis, patch index, q)
    if (e >= 6 * kPatch) break;
    const int ax = e / (3 * kPatch), a = (e / 3) % kPatch, q = e % 3;
    if (ax == 0) w.wy[a][q] = tap_weight<R>(p.y, p.y0, a - 2 + q, a);
    else w.wx[a][q] = tap_weight<R>(p.x, p.x0, a - 2 + q, a);
  }
#pragma unroll
  for (int k = 0; k < kTapRounds; ++k)
    if (lane + 32 * k < kTaps) w.g[lane + 32 * k] = gv[k];
  __syncwarp();

  // 2. dvol: every in-map patch cell gathers from the 3 x 3 taps whose
  // corners can touch it, tap rows then columns ascending (the weight of
  // one that does not touch it is 0)
#pragma unroll
  for (int k = 0; k < kCellRounds; ++k) {
    if (aidx[k] < 0) continue;
    const int cc = lane + 32 * k;
    const int a = cc / kPatch, b = cc - a * kPatch;
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float wy = w.wy[a][q];
      const float* gr = w.g + min(max(a - 2 + q, 0), kWin - 1) * kWin;
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        const float gt = gr[min(max(b - 2 + u, 0), kWin - 1)];
        acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(gt, wy), w.wx[b][u]));
      }
    }
    dm[aidx[k]] = __fadd_rn(av[k], round_to(acc, map));
  }

  // 3. dcoords: per-tap derivative from the staged patch
  if (!need_dc) return;
  float gx = 0.f, gy = 0.f;
#pragma unroll
  for (int k = 0; k < kTapRounds; ++k) {
    const int tp = lane + 32 * k;
    if (tp >= kTaps) break;
    const int i = tp / kWin, j = tp - i * kWin;
    float v00, v01, v10, v11;
    corners<R>(p, w.patch, w.axes, i, j, v00, v01, v10, v11);
    const float gt = w.g[tp], fx = w.axes.fx[j], fy = w.axes.fy[i];
    gx += gt * ((v01 - v00) * (1.f - fy) + (v11 - v10) * fy);
    gy += gt * ((v10 - v00) * (1.f - fx) + (v11 - v01) * fx);
  }
  gx = warp_sum(gx);
  gy = warp_sum(gy);
  if (lane == 0) {
    dc_s[2 * s] = __fmul_rn(gx, L.scale);
    dc_s[2 * s + 1] = __fmul_rn(gy, L.scale);
  }
  __syncthreads();
  const int nt = tab.n_targets;
  for (int tt = threadIdx.x; tt < nt; tt += blockDim.x) {
    float sx = 0.f, sy = 0.f;
    for (int ss = 0; ss < S; ++ss) {  // level order: repeatable bits
      if (tab.slot_target[ss] != tt) continue;
      sx = __fadd_rn(sx, dc_s[2 * ss]);
      sy = __fadd_rn(sy, dc_s[2 * ss + 1]);
    }
    dcoords[2 * ((long long)tt * M + m)] = sx;
    dcoords[2 * ((long long)tt * M + m) + 1] = sy;
  }
}

template <typename T, int R, int kProbe = 0>
int launch_r(const LookupTable* tab, const void* coords, const void* g,
             void* dcoords, void* stream) {
  if (tab->queries == 0) return (int)cudaSuccess;
  const size_t smem = smem_bytes<R>(tab->n_slots);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        corr_lookup_bwd_kernel<T, R, kProbe>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  corr_lookup_bwd_kernel<T, R, kProbe><<<(unsigned)tab->queries,
                                         32 * tab->n_slots, smem,
                                         (cudaStream_t)stream>>>(
      *tab, (const float*)coords, (const T*)g, (float*)dcoords);
  return (int)cudaGetLastError();
}

// every level of type T: the int8 lookup has no backward
template <typename T>
bool valid(const LookupTable* tab) {
  return tab->n_slots >= 1 && tab->n_slots <= kMaxSlots &&
         tab->queries <= 0x7fffffffLL &&
         levels_valid(tab, level_type_of<T>(), false);
}

template <typename T>
int launch(const LookupTable* tab, const void* coords, const void* g,
           void* dcoords, void* stream) {
  if (!valid<T>(tab)) return (int)cudaErrorInvalidValue;
  switch (tab->radius) {  // one instantiation per radius: unrolled loops
    case 1: return launch_r<T, 1>(tab, coords, g, dcoords, stream);
    case 2: return launch_r<T, 2>(tab, coords, g, dcoords, stream);
    case 3: return launch_r<T, 3>(tab, coords, g, dcoords, stream);
    case 4: return launch_r<T, 4>(tab, coords, g, dcoords, stream);
    case 5: return launch_r<T, 5>(tab, coords, g, dcoords, stream);
    case 6: return launch_r<T, 6>(tab, coords, g, dcoords, stream);
    case 7: return launch_r<T, 7>(tab, coords, g, dcoords, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// tab: the level table (every level of the kernel's type: a table with an
// int8 level returns cudaErrorInvalidValue), each level's dvol an f32
// accumulator of its volume's shape (added into) or NULL; coords (T, M, 2)
// f32 contiguous; g (M, ld) in the volumes' type, slot s's window at
// channels (2r+1)^2 s ..; dcoords (T, M, 2) f32, every element written, or
// NULL. Returns cudaGetLastError().
int corr_lookup_bwd_f32(const LookupTable* tab, const void* coords,
                        const void* g, void* dcoords, void* stream) {
  return launch<float>(tab, coords, g, dcoords, stream);
}

int corr_lookup_bwd_bf16(const LookupTable* tab, const void* coords,
                         const void* g, void* dcoords, void* stream) {
  return launch<__nv_bfloat16>(tab, coords, g, dcoords, stream);
}

// The probe variants of the bf16 kernel at r = 4 (the flagship's), for
// measurement only: probe is 0, one of kProbeNoPatch, kProbeNoAccRead,
// kProbeNoCotangent, or all three.
int corr_lookup_bwd_probe_bf16(const LookupTable* tab, const void* coords,
                               const void* g, void* dcoords, int probe,
                               void* stream) {
  using T = __nv_bfloat16;
  constexpr int kAll = kProbeNoPatch | kProbeNoAccRead | kProbeNoCotangent;
  if (!valid<T>(tab) || tab->radius != 4) return (int)cudaErrorInvalidValue;
  switch (probe) {
    case 0: return launch_r<T, 4, 0>(tab, coords, g, dcoords, stream);
    case kProbeNoPatch:
      return launch_r<T, 4, kProbeNoPatch>(tab, coords, g, dcoords, stream);
    case kProbeNoAccRead:
      return launch_r<T, 4, kProbeNoAccRead>(tab, coords, g, dcoords, stream);
    case kProbeNoCotangent:
      return launch_r<T, 4, kProbeNoCotangent>(tab, coords, g, dcoords,
                                               stream);
    case kAll: return launch_r<T, 4, kAll>(tab, coords, g, dcoords, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
