// Hopper's asynchronous building blocks (sm_90a), shared by the kernels
// that feed wgmma from TMA: mbarriers and a ring of them, register
// reallocation between warpgroups, TMA tiled loads of 2-D and 4-D boxes,
// shared-memory loads and stores by address, and the host's tensor maps.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// spins until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

template <int REGS>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

__device__ __forceinline__ uint64_t l2_policy_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

// one box of a 2-D tensor map into shared memory, counted on bar; c0 (the
// column) must be a multiple of 8 bf16
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// the same with an L2 eviction policy
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar,
                                            uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar),
      "l"(policy)
      : "memory");
}

// one box of a 4-D tensor map; coordinates outside the tensor, negative
// ones included, read as zeros (the box's bytes are counted all the same)
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ uint2 lds64(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ uint16_t lds16(uint32_t addr) {
  uint16_t v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr) : "memory");
  return v;
}

// a ring of stages and its two barriers a stage, full (the bytes have
// landed) and empty (every consumer warp is done with them), in shared
// memory from base: full[0..n), empty[0..n); with the stage this thread is
// at and the phase of its barriers
struct Ring {
  uint32_t base;
  int n;
  int stage = 0;
  uint32_t phase = 0;
  __device__ uint32_t full() const { return base + 8u * stage; }
  __device__ uint32_t empty() const { return base + 8u * (n + stage); }
  __device__ uint32_t empty_before() const {  // the previous stage's
    return base + 8u * (n + (stage == 0 ? n - 1 : stage - 1));
  }
  __device__ void next() {
    if (++stage == n) {
      stage = 0;
      phase ^= 1;
    }
  }
  __device__ void init(uint32_t consumers) const {
    for (int s = 0; s < n; ++s) {
      mbar_init(base + 8u * s, 1);
      mbar_init(base + 8u * (n + s), consumers);
    }
  }
};

// cuTensorMapEncodeTiled from the driver, found through the runtime so the
// library links against nothing but cudart
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 tensor of `rank` dimensions, innermost first (dims[0] dense, the
// byte strides of dims[1..] in strides[0..rank-2]), read in boxes of `box`;
// outside the tensor a box reads zeros
inline bool make_map(CUtensorMap* map, const void* base, uint32_t rank,
                     const uint64_t* dims, const uint64_t* strides,
                     const uint32_t* box, CUtensorMapSwizzle swizzle,
                     CUtensorMapL2promotion promotion) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr || rank < 1 || rank > 5) return false;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], elem[5];
  for (uint32_t i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    elem[i] = 1;
    if (i + 1 < rank) s[i] = strides[i];
  }
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                const_cast<void*>(base), d, s, b, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, promotion,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a (rows, cols) bf16 matrix of row pitch cols, read in (box_rows,
// box_cols) boxes
inline bool make_map(CUtensorMap* map, const void* base, uint64_t rows,
                     uint64_t cols, uint32_t box_rows, uint32_t box_cols,
                     CUtensorMapSwizzle swizzle,
                     CUtensorMapL2promotion promotion) {
  const uint64_t dims[2] = {cols, rows};
  const uint64_t strides[1] = {cols * 2};
  const uint32_t box[2] = {box_cols, box_rows};
  return make_map(map, base, 2, dims, strides, box, swizzle, promotion);
}

}  // namespace sm90
