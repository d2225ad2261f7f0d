// The level table of the all-level correlation lookup kernels
// (corr_lookup_fwd.cu, corr_lookup_bwd.cu), the per-query patch they both
// stage, and the bilinear blend of a tap.
//
// A table lists up to kMaxLevels pyramid levels. Level i holds one (hl, wl)
// map per (target slot k, query m), laid out (n_targets, M, hl, wl), in
// the level's type (f32, bf16, or int8 with one f32 scale per query row),
// and scales the base coords by `scale` = 2^-l (exact). A slot s is one
// (level, target) pair; slots are numbered level-major, so channel block s
// of an output row (81 channels for r = 4) is slot s's window: the
// (level, target, window) order of the JAX package's corr_lookup. Base
// coords are (n_targets, M, 2) f32, (x, y). The wrapper
// (kernels/corr_lookup.py: _LookupTable) mirrors this struct field for
// field (the static_asserts below hold the layout a CPU test reads) and
// checks every bound before a launch.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace corr_table {

constexpr int kMaxLevels = 8;
constexpr int kMaxSlots = 32;  // also the backward's warps per block

// the type of a level's volume (kernels/corr_lookup.py: _LEVEL_TYPES)
enum LevelType : int { kLevelF32 = 0, kLevelBF16 = 1, kLevelInt8 = 2 };

struct LevelDesc {
  const void* vol;  // (n_targets, M, hl, wl) of the level's type
  float* dvol;      // f32 accumulator of vol's shape, or null (backward)
  // int8 levels: (n_targets, M / w1) f32, the scale of query row
  // m / w1 of slot k at k * (M / w1) + m / w1 (quantize_volume's
  // (Tl, N, h1)); null otherwise
  const float* row_scale;
  int hl, wl;
  int n_targets;
  float scale;  // 2^-level
  int type;     // LevelType
  int pad;
};

struct LookupTable {
  LevelDesc level[kMaxLevels];
  unsigned char slot_level[kMaxSlots];   // level of slot s
  unsigned char slot_k[kMaxSlots];       // target slot within its level
  unsigned char slot_target[kMaxSlots];  // base target of slot s
  int n_slots;
  int n_targets;  // base targets T
  int radius;
  int w1;             // queries per row (M = N * h1 * w1)
  long long queries;  // M
  long long ld;       // row stride, in elements, of the output / cotangent
};

// The layout the ctypes mirror must have (tests/test_torch_corr_q8.py
// reads these lines); passed by value as a __grid_constant__ parameter,
// far below its 4 KB limit.
static_assert(sizeof(LevelDesc) == 48, "LevelDesc layout");
static_assert(offsetof(LevelDesc, vol) == 0, "LevelDesc layout");
static_assert(offsetof(LevelDesc, dvol) == 8, "LevelDesc layout");
static_assert(offsetof(LevelDesc, row_scale) == 16, "LevelDesc layout");
static_assert(offsetof(LevelDesc, hl) == 24, "LevelDesc layout");
static_assert(offsetof(LevelDesc, wl) == 28, "LevelDesc layout");
static_assert(offsetof(LevelDesc, n_targets) == 32, "LevelDesc layout");
static_assert(offsetof(LevelDesc, scale) == 36, "LevelDesc layout");
static_assert(offsetof(LevelDesc, type) == 40, "LevelDesc layout");
static_assert(sizeof(LookupTable) == 512, "LookupTable layout");
static_assert(offsetof(LookupTable, slot_level) == 384, "LookupTable layout");
static_assert(offsetof(LookupTable, slot_k) == 416, "LookupTable layout");
static_assert(offsetof(LookupTable, slot_target) == 448,
              "LookupTable layout");
static_assert(offsetof(LookupTable, n_slots) == 480, "LookupTable layout");
static_assert(offsetof(LookupTable, n_targets) == 484, "LookupTable layout");
static_assert(offsetof(LookupTable, radius) == 488, "LookupTable layout");
static_assert(offsetof(LookupTable, w1) == 492, "LookupTable layout");
static_assert(offsetof(LookupTable, queries) == 496, "LookupTable layout");
static_assert(offsetof(LookupTable, ld) == 504, "LookupTable layout");

// true when every slot's level is of type `tag`, or int8 where `int8_ok`
// (then with its row scales and a row length that divides M), and every
// slot names a level of the table's range
inline bool levels_valid(const LookupTable* tab, int tag, bool int8_ok) {
  for (int s = 0; s < tab->n_slots; ++s) {
    if (tab->slot_level[s] >= kMaxLevels) return false;
    const LevelDesc& L = tab->level[tab->slot_level[s]];
    if (L.type == kLevelInt8) {
      if (!int8_ok || L.row_scale == nullptr || tab->w1 < 1 ||
          tab->queries % tab->w1 != 0)
        return false;
    } else if (L.type != tag) {
      return false;
    }
  }
  return true;
}

// true when some slot's level is int8
inline bool has_int8(const LookupTable* tab) {
  for (int s = 0; s < tab->n_slots; ++s)
    if (tab->level[tab->slot_level[s]].type == kLevelInt8) return true;
  return false;
}

// Probe variants of the two kernels (chip_smoke.py --lookup-probe): the
// same code with parts of its memory traffic taken out, to show where the
// time goes. Their results are wrong by design; the wrappers never launch
// them. A probe is an or of these bits; 0 is the kernel itself.
enum Probe : int {
  kProbeNoPatch = 1,      // stage zeros instead of the volume patch
  kProbeNoStore = 2,      // forward: blend every tap, store none
  kProbeNoAccRead = 4,    // backward: add to 0, not to the accumulator
  kProbeNoCotangent = 8,  // backward: one value, not the 81 cotangents
};
// true for no value a tap takes: a no-store probe stores under it, so the
// compiler keeps the work whose result it drops
__device__ __forceinline__ bool probe_keeps(float v) {
  return __float_as_uint(v) == 0x7fc00001u;
}

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
// an int8 cell as an exact f32 integer
__device__ __forceinline__ float load_f32(const int8_t* p) {
  return (float)__ldg(reinterpret_cast<const signed char*>(p));
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}
// a value rounded once to the type T, back in f32
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}
template <typename T>
constexpr int level_type_of();
template <>
constexpr int level_type_of<float>() { return kLevelF32; }
template <>
constexpr int level_type_of<__nv_bfloat16>() { return kLevelBF16; }

// One query's patch: the (2r+3)^2 map cells from (floor(x) - r,
// floor(y) - r), rows y-major. Every corner any tap reads lies inside it:
// floor(x + dx) is floor(x) + dx or, where the f32 add rounds up onto an
// integer, one more (the fraction then 0), so a tap's corner columns are
// patch columns dx + r .. dx + r + 2, and likewise for rows. Cells outside
// the map hold 0, which is the zero padding. `live` is false when no
// patch cell lies in the map (then every tap reads zeros and nothing is
// loaded); the test is made in float before any float -> int conversion,
// so coordinates at +-1e4 (or NaN) neither fault nor convert out of range.
template <int R>
struct Patch {
  static constexpr int kWin = 2 * R + 1;
  static constexpr int kSide = 2 * R + 3;
  static constexpr int kCells = kSide * kSide;
  float x, y;    // this level's query position
  float x0, y0;  // patch origin, floor(x) - r, floor(y) - r (exact if live)
  int ix0, iy0;  // the same as ints (valid if live)
  bool live;
};

template <int R>
__device__ __forceinline__ Patch<R> make_patch(float x, float y, int hl,
                                               int wl) {
  Patch<R> p;
  p.x = x;
  p.y = y;
  p.x0 = floorf(x) - (float)R;
  p.y0 = floorf(y) - (float)R;
  const float far = (float)(1 << 22);  // any map is far smaller
  const float last = (float)(Patch<R>::kSide - 1);
  p.live = fabsf(x) < far && fabsf(y) < far && p.x0 + last >= 0.f &&
           p.x0 <= (float)(wl - 1) && p.y0 + last >= 0.f &&
           p.y0 <= (float)(hl - 1);
  p.ix0 = p.live ? (int)p.x0 : 0;
  p.iy0 = p.live ? (int)p.y0 : 0;
  return p;
}

// the patch of map m, one warp: every lane's loads are issued before any
// is used (a fixed, unrolled count), then stored to s (kCells floats; an
// int8 map's cells as exact integers); zeros without kLoad
// (kProbeNoPatch)
template <int R, bool kLoad = true, typename T>
__device__ __forceinline__ void stage_patch(const Patch<R>& p,
                                            const T* __restrict__ m, int hl,
                                            int wl, float* s, int lane) {
  constexpr int kSide = Patch<R>::kSide, kCells = Patch<R>::kCells;
  constexpr int kRounds = (kCells + 31) / 32;
  float v[kRounds];
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const int c = lane + 32 * k;
    const int a = c / kSide, b = c - a * kSide;
    const int row = p.iy0 + a, col = p.ix0 + b;
    v[k] = 0.f;
    if (kLoad && p.live && c < kCells && row >= 0 && row < hl && col >= 0 &&
        col < wl)
      v[k] = load_f32(m + (int64_t)row * wl + col);
  }
#pragma unroll
  for (int k = 0; k < kRounds; ++k)
    if (lane + 32 * k < kCells) s[lane + 32 * k] = v[k];
}

// tap (i, j)'s corner position and fraction along one axis: the plain
// version's f32 add, floor and subtract
struct Axis {
  float c, f;  // floor(x + d), x + d - floor(x + d)
};
__device__ __forceinline__ Axis axis(float x, int d) {
  const float px = __fadd_rn(x, (float)d);
  const float c = floorf(px);
  return {c, __fsub_rn(px, c)};
}

// Per tap column j (row i): the patch column (row) of its first corner,
// floor(x + dx) - (floor(x) - r), in [j, j + 1], and its fraction; made
// once per (query, slot) by 2(2r+1) lanes, read by every tap
template <int R>
struct Axes {
  static constexpr int kWin = 2 * R + 1;
  int bx[kWin], by[kWin];
  float fx[kWin], fy[kWin];
};

template <int R>
__device__ __forceinline__ void make_axes(const Patch<R>& p, Axes<R>& a,
                                          int lane) {
  constexpr int kWin = Axes<R>::kWin, kSide = Patch<R>::kSide;
  if (lane < kWin) {
    const Axis ax = axis(p.x, lane - R);
    a.fx[lane] = ax.f;
    // exact small integers when live; clamped for memory safety
    a.bx[lane] = p.live ? min(max((int)(ax.c - p.x0), 0), kSide - 2) : 0;
  } else if (lane < 2 * kWin) {
    const int i = lane - kWin;
    const Axis ay = axis(p.y, i - R);
    a.fy[i] = ay.f;
    a.by[i] = p.live ? min(max((int)(ay.c - p.y0), 0), kSide - 2) : 0;
  }
}

// The four corners (row y0: v00, v01; row y0+1: v10, v11) blended at the
// fractions (fx, fy): grid_sample(align_corners=True) with zero padding
// (a corner outside the map is a zero cell of the patch), in f32 in the
// plain version's operation order (x-blend per row, then y), each
// operation rounded on its own: no fused multiply-add, so the kernels and
// their plain versions agree bit for bit.
__device__ __forceinline__ float blend(float v00, float v01, float v10,
                                       float v11, float fx, float fy) {
  const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
  const float top = __fadd_rn(__fmul_rn(v00, gx), __fmul_rn(v01, fx));
  const float bot = __fadd_rn(__fmul_rn(v10, gx), __fmul_rn(v11, fx));
  return __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, fy));
}

// the four corners of tap (i, j) from the staged patch (zeros when not
// live)
template <int R>
__device__ __forceinline__ void corners(const Patch<R>& p, const float* s,
                                        const Axes<R>& a, int i, int j,
                                        float& v00, float& v01, float& v10,
                                        float& v11) {
  constexpr int kSide = Patch<R>::kSide;
  v00 = v01 = v10 = v11 = 0.f;
  if (!p.live) return;
  const float* q = s + a.by[i] * kSide + a.bx[j];
  v00 = q[0];
  v01 = q[1];
  v10 = q[kSide];
  v11 = q[kSide + 1];
}

}  // namespace corr_table
