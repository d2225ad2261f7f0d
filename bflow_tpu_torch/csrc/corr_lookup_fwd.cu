// Windowed bilinear correlation lookup, forward, every pyramid level of a
// level table in one launch, for Hopper (sm_90a); levels f32, bf16, or
// int8 with one f32 scale per query row.
//
// Replaces the TPU kernel bflow_tpu/ops/pallas/corr_lookup_v3.py:_fwd_kernel
// (reached through _fwd_impl and lookup_level_slab), also with quant=True
// (lookup_level_slab_q8: int8 levels), together with the index, divide and
// concatenation that the JAX package's corr_lookup runs around it per
// level. Every query q owns a private (hl, wl) correlation map per (level,
// target) and reads the (2r+1)^2 bilinear taps of that map at
// (x + dx, y + dy), dx, dy in [-r, r], dy-major, where (x, y) is the
// query's base coordinate of its target times 2^-l, with
// grid_sample(align_corners=True) zero padding. Output row m (one per
// query position) holds every slot's window in (level, target) order.
//
// Types: the output type T is the unquantized levels' type (they share
// one), or bf16 for a table of int8 levels only: the type torch.cat gives
// the per-level lookups. An int8 tap is the f32 blend of the integers,
// times the query row's f32 scale, rounded once to bf16 (the TPU kernel
// blends in bf16 and its caller multiplies by the bf16-rounded scale: a
// few bf16 ulps apart, the same function), then stored as T (widening to
// f32 is exact). A table with an int8 level runs the kQ8 instantiation,
// whose warps branch on their level's type (uniform in a warp: one warp
// is one item); any other table runs code with no such branch.
//
// What bounds it on this card: it is a gather. Per (query, level, target)
// it needs at most the (2r+2)^2 patch around floor(x, y) (fewer bytes where
// the patch leaves the map; one byte a cell for int8) and writes (2r+1)^2
// outputs; per (query, target) it reads 8 bytes of base coordinates once,
// whatever the number of its levels, and per int8 query row one f32
// scale: bytes ~ sum over levels of Q * ((2r+2)^2 itemsize_l + (2r+1)^2
// itemsize_T) + 8 T M, against a few flops per tap. So its bound is memory
// traffic; what holds it back is the latency of the dependent loads
// (coords, then patch) and the instructions per tap: 52,800 (query, level,
// target) items per iteration at the flagship shapes, each patch rows of
// 11-22 bytes at 80- to 160-byte strides, which the memory system moves in
// 32- to 64-byte pieces. The probe variants (corr_lookup_table.cuh: Probe)
// take the patch loads or the stores out to measure that.
//
// Design: one warp per item, items ordered (query position, slot), so
// neighbouring warps write neighbouring channel blocks of one output row
// and read the same query's coords. The warp stages the query's
// (2r+3)^2 patch into shared memory as f32 (all of a lane's loads in
// flight at once; cells outside the map zero; int8 cells as exact
// integers) and, per tap column and row, the first corner's patch index
// and the fraction, each computed as the plain version computes them per
// tap; then each lane blends its taps from the patch (at most three per
// lane for r = 4) with blend(), the plain version's rounding order
// (x-blend per row, then y, no FMA), applies an int8 level's row scale and
// bf16 rounding, rounds once to T, and the 81 outputs go out as one
// contiguous run. Queries whose patch misses the map (far coordinates)
// load nothing. The scale 2^-l is a power of two, so x * 2^-l equals the
// plain version's coords / 2^l bit for bit, and the kernel equals its plain
// twin (kernels/corr_lookup.py: corr_lookup_pyramid_plain) exactly. The
// radius is a template parameter, so every per-lane loop is unrolled.

#include "corr_lookup_table.cuh"

namespace {

using namespace corr_table;

constexpr int kWarps = 8;  // warps per block, one (query, slot) item each

template <typename T, int R, bool kQ8, int kProbe>
__global__ void __launch_bounds__(kWarps * 32)
corr_lookup_fwd_kernel(const __grid_constant__ LookupTable tab,
                       const float* __restrict__ coords,
                       T* __restrict__ out) {
  constexpr int kWin = Patch<R>::kWin, kTaps = kWin * kWin;
  constexpr bool kLoad = !(kProbe & kProbeNoPatch);
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
  const size_t map_off =
      ((size_t)tab.slot_k[s] * M + m) * (size_t)(L.hl * L.wl);
  float* ps = patch_s[warp];
  Axes<R>& ax = axes_s[warp];
  // an int8 level (uniform in the warp): its query row's scale (map
  // k M + m over w1 is row k (M / w1) + m / w1, as w1 divides M) and its
  // patch; code the other instantiation does not have
  const bool q8 = kQ8 && L.type == kLevelInt8;
  float row_scale = 1.f;
  if (q8) {
    row_scale = __ldg(L.row_scale + (tab.slot_k[s] * M + m) / tab.w1);
    stage_patch<R, kLoad>(p, static_cast<const int8_t*>(L.vol) + map_off,
                          L.hl, L.wl, ps, lane);
  } else {
    stage_patch<R, kLoad>(p, static_cast<const T*>(L.vol) + map_off, L.hl,
                          L.wl, ps, lane);
  }
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
    float v = blend(v00, v01, v10, v11, ax.fx[j], ax.fy[i]);
    if (q8)  // times the row's scale, rounded once to bf16
      v = __bfloat162float(__float2bfloat16(__fmul_rn(v, row_scale)));
    if (!(kProbe & kProbeNoStore) || probe_keeps(v)) store_from_f32(o + tp, v);
  }
}

template <typename T, int R, int kProbe = 0>
int launch_r(const LookupTable* tab, const void* coords, void* out,
             void* stream) {
  const long long items = tab->queries * tab->n_slots;
  if (items == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((items + kWarps - 1) / kWarps);
  const cudaStream_t st = (cudaStream_t)stream;
  if (has_int8(tab))
    corr_lookup_fwd_kernel<T, R, true, kProbe>
        <<<blocks, kWarps * 32, 0, st>>>(*tab, (const float*)coords,
                                         (T*)out);
  else
    corr_lookup_fwd_kernel<T, R, false, kProbe>
        <<<blocks, kWarps * 32, 0, st>>>(*tab, (const float*)coords,
                                         (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
bool valid(const LookupTable* tab) {
  return tab->n_slots >= 1 && tab->n_slots <= kMaxSlots &&
         tab->queries * tab->n_slots < (1LL << 31) &&
         levels_valid(tab, level_type_of<T>(), true);
}

template <typename T>
int launch(const LookupTable* tab, const void* coords, void* out,
           void* stream) {
  if (!valid<T>(tab)) return (int)cudaErrorInvalidValue;
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

// tab: the level table (volumes contiguous; each level of the output's
// type, or int8 with its row scales); coords (T, M, 2) f32 contiguous; out
// (M, ld) with ld >= (2r+1)^2 n_slots, in the output type: the unquantized
// levels' type, bf16 for int8 levels only. Returns cudaGetLastError().
int corr_lookup_fwd_f32(const LookupTable* tab, const void* coords,
                        void* out, void* stream) {
  return launch<float>(tab, coords, out, stream);
}

int corr_lookup_fwd_bf16(const LookupTable* tab, const void* coords,
                         void* out, void* stream) {
  return launch<__nv_bfloat16>(tab, coords, out, stream);
}

// The probe variants of the bf16-output kernel at r = 4 (the flagship's),
// for measurement only, of the instantiation the table runs (the kQ8 one
// for a table with an int8 level): probe is 0 or an or of kProbeNoPatch,
// kProbeNoStore.
int corr_lookup_fwd_probe_bf16(const LookupTable* tab, const void* coords,
                               void* out, int probe, void* stream) {
  using T = __nv_bfloat16;
  if (!valid<T>(tab) || tab->radius != 4) return (int)cudaErrorInvalidValue;
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
