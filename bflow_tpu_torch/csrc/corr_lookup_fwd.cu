// Windowed bilinear correlation lookup, forward, every pyramid level of a
// level table in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel bflow_tpu/ops/pallas/corr_lookup_v3.py:_fwd_kernel
// (reached through _fwd_impl and lookup_level_slab), together with the
// index, divide and concatenation that the JAX package's corr_lookup runs
// around it per level. Every query q owns a private (hl, wl) correlation
// map per (level, target) and reads the (2r+1)^2 bilinear taps of that map
// at (x + dx, y + dy), dx, dy in [-r, r], dy-major, where (x, y) is the
// query's base coordinate of its target times 2^-l, with
// grid_sample(align_corners=True) zero padding. Output row m (one per
// query position) holds every slot's window in (level, target) order.
//
// What bounds it on this card: it is a gather. Per (query, level, target)
// it needs at most the (2r+2)^2 patch around floor(x, y) (fewer bytes where
// the patch leaves the map) and writes (2r+1)^2 outputs; per (query,
// target) it reads 8 bytes of base coordinates once, whatever the number
// of its levels: bytes ~ sum over levels of Q * ((2r+2)^2 + (2r+1)^2) *
// itemsize + 8 T M, against a few flops per tap. So its bound is memory
// traffic; what holds it back is the latency of the dependent loads
// (coords, then patch) and the instructions per tap: 52,800 (query, level,
// target) items per iteration at the flagship shapes, each patch rows of
// 20-22 bytes at 160-byte strides, which the memory system moves in 32- to
// 64-byte pieces. The probe variants (corr_lookup_table.cuh: Probe) take
// the patch loads or the stores out to measure that.
//
// Design: one warp per item, items ordered (query position, slot), so
// neighbouring warps write neighbouring channel blocks of one output row
// and read the same query's coords. The warp stages the query's
// (2r+3)^2 patch into shared memory as f32 (all of a lane's loads in
// flight at once; cells outside the map zero) and, per tap column and
// row, the first corner's patch index and the fraction, each computed as
// the plain version computes them per tap; then each lane blends its taps
// from the patch (at most three per lane for r = 4) with corr_tap::blend,
// the plain version's rounding order (x-blend per row, then y, no FMA),
// rounds once to the volume's type, and the 81 outputs go out as one
// contiguous run. Queries whose patch misses the map (far coordinates)
// load nothing. The scale 2^-l is a power of two, so x * 2^-l equals the
// plain version's coords / 2^l bit for bit, and the kernel equals its plain
// twin (kernels/corr_lookup.py: corr_lookup_pyramid_plain) exactly. The
// radius is a template parameter, so every per-lane loop is unrolled.

#include "corr_lookup_table.cuh"

namespace {

using namespace corr_table;

constexpr int kWarps = 8;  // warps per block, one (query, slot) item each

template <typename T, int R, int kProbe>
__global__ void __launch_bounds__(kWarps * 32)
corr_lookup_fwd_kernel(const __grid_constant__ LookupTable tab,
                       const float* __restrict__ coords,
                       T* __restrict__ out) {
  constexpr int kWin = Patch<R>::kWin, kTaps = kWin * kWin;
  __shared__ float patch_s[kWarps][Patch<R>::kCells];
  __shared__ Axes<R> axes_s[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned M = (unsigned)tab.queries, S = (unsigned)tab.n_slots;
  const unsigned item = blockIdx.x * kWarps + warp;
  if (item >= M * S) return;  // ragged last block (whole warps)
  const unsigned m = item / S, s = item - m * S;  // < 2^31: checked
  const LevelDesc& L = tab.level[tab.slot_level[s]];

  const float* c = coords + 2 * ((size_t)tab.slot_target[s] * M + m);
  const Patch<R> p = make_patch<R>(__fmul_rn(__ldg(c), L.scale),
                                   __fmul_rn(__ldg(c + 1), L.scale), L.hl,
                                   L.wl);
  const T* map = static_cast<const T*>(L.vol) +
                 ((size_t)tab.slot_k[s] * M + m) * (size_t)(L.hl * L.wl);
  float* ps = patch_s[warp];
  Axes<R>& ax = axes_s[warp];
  stage_patch<R, !(kProbe & kProbeNoPatch)>(p, map, L.hl, L.wl, ps, lane);
  make_axes<R>(p, ax, lane);
  __syncwarp();

  T* o = out + (size_t)m * tab.ld + s * kTaps;
#pragma unroll
  for (int k = 0; k < (kTaps + 31) / 32; ++k) {
    const int tp = lane + 32 * k;
    if (tp >= kTaps) break;
    const int i = tp / kWin, j = tp - i * kWin;
    float v00, v01, v10, v11;
    corners<R>(p, ps, ax, i, j, v00, v01, v10, v11);
    const float v = corr_tap::blend(v00, v01, v10, v11, ax.fx[j], ax.fy[i]);
    if (!(kProbe & kProbeNoStore) || probe_keeps(v)) store_from_f32(o + tp, v);
  }
}

template <typename T, int R, int kProbe = 0>
int launch_r(const LookupTable* tab, const void* coords, void* out,
             void* stream) {
  const long long items = tab->queries * tab->n_slots;
  if (items == 0) return (int)cudaSuccess;
  const long long blocks = (items + kWarps - 1) / kWarps;
  corr_lookup_fwd_kernel<T, R, kProbe><<<(unsigned)blocks, kWarps * 32, 0,
                                         (cudaStream_t)stream>>>(
      *tab, (const float*)coords, (T*)out);
  return (int)cudaGetLastError();
}

bool valid(const LookupTable* tab) {
  return tab->n_slots >= 1 && tab->n_slots <= kMaxSlots &&
         tab->queries * tab->n_slots < (1LL << 31);
}

template <typename T>
int launch(const LookupTable* tab, const void* coords, void* out,
           void* stream) {
  if (!valid(tab)) return (int)cudaErrorInvalidValue;
  switch (tab->radius) {  // one instantiation per radius: unrolled loops
    case 1: return launch_r<T, 1>(tab, coords, out, stream);
    case 2: return launch_r<T, 2>(tab, coords, out, stream);
    case 3: return launch_r<T, 3>(tab, coords, out, stream);
    case 4: return launch_r<T, 4>(tab, coords, out, stream);
    case 5: return launch_r<T, 5>(tab, coords, out, stream);
    case 6: return launch_r<T, 6>(tab, coords, out, stream);
    case 7: return launch_r<T, 7>(tab, coords, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// tab: the level table (volumes contiguous, all in the kernel's type);
// coords (T, M, 2) f32 contiguous; out (M, ld) with ld >= (2r+1)^2 n_slots,
// in the volumes' type. Returns cudaGetLastError().
int corr_lookup_fwd_f32(const LookupTable* tab, const void* coords,
                        void* out, void* stream) {
  return launch<float>(tab, coords, out, stream);
}

int corr_lookup_fwd_bf16(const LookupTable* tab, const void* coords,
                         void* out, void* stream) {
  return launch<__nv_bfloat16>(tab, coords, out, stream);
}

// The probe variants of the bf16 kernel at r = 4 (the flagship's), for
// measurement only: probe is 0 or an or of kProbeNoPatch, kProbeNoStore.
int corr_lookup_fwd_probe_bf16(const LookupTable* tab, const void* coords,
                               void* out, int probe, void* stream) {
  using T = __nv_bfloat16;
  if (!valid(tab) || tab->radius != 4) return (int)cudaErrorInvalidValue;
  switch (probe) {
    case 0: return launch_r<T, 4, 0>(tab, coords, out, stream);
    case kProbeNoPatch:
      return launch_r<T, 4, kProbeNoPatch>(tab, coords, out, stream);
    case kProbeNoStore:
      return launch_r<T, 4, kProbeNoStore>(tab, coords, out, stream);
    case kProbeNoPatch | kProbeNoStore:
      return launch_r<T, 4, kProbeNoPatch | kProbeNoStore>(tab, coords, out,
                                                           stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
