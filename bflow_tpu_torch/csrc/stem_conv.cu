// Odd-window stride-2 SAME convolution plus f32 bias, bf16 operands and f32
// accumulation, for Hopper (sm_90a).
//
// Replaces the TPU kernel bflow_tpu/ops/pallas/stem_conv.py:_stem_kernel
// (reached through _stem_fwd and stem_conv_pallas): the encoders' 7x7/s2
// stems and the 3x3/s2 convs that open residual stages 2 and 3. The TPU
// kernel regroups the strided taps over a 2x2 space-to-depth view so that
// the MXU sees a deep contraction; on the tensor cores the strided gather
// needs no regrouping, so this is the stride-2 instance of the implicit
// GEMM in conv_igemm.cuh (which says what bounds each shape class and how
// it is laid out), channels-last in and out. The stems' channel counts (3,
// 15, 18) are padded to 8, 16, 24 by the wrapper, so K is 392 to 1,176: 7
// to 19 steps of 64, the last one zero-filled past K.

#include "conv_igemm.cuh"

extern "C" {

// x (n, h, w, cp) bf16 with cp a multiple of 8, w (o, kh, kw, cp) bf16,
// bias (o,) f32, out (n, (h-1)/2+1, (w-1)/2+1, o) bf16, all dense
// channels-last and 16-byte aligned; (bm, bn, split) is the tile variant
// of conv_igemm::launch. Returns a cudaError_t.
int stem_conv_bf16(const void* x, const void* w, const void* bias, void* out,
                   int n, int cp, int h, int wd, int o, int kh, int kw,
                   int relu, int bm, int bn, int split, void* stream) {
  return conv_igemm::launch<2>(x, w, bias, out, n, cp, h, wd, o, kh, kw, relu,
                               bm, bn, split, stream);
}

}  // extern "C"
