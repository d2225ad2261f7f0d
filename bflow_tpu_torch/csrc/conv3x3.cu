// Odd-window stride-1 SAME convolution plus f32 bias, with an optional
// fused ReLU, bf16 operands and f32 accumulation, for Hopper (sm_90a).
//
// Replaces the TPU kernel bflow_tpu/ops/pallas/conv3x3.py:_kernel (reached
// through _fwd and conv2d_pallas): the encoders' residual 3x3s, the update
// block's 3x3s, the 7x7 convf1 over the Bezier planes and the 1x5 / 5x1
// GRU gate convolutions. The TPU kernel builds each row group's
// K = kh*kw*C im2col patch in VMEM and runs one MXU dot; here the same
// product is an implicit GEMM on wgmma (conv_igemm.cuh, which says what
// bounds each shape class and how it is laid out), channels-last in and
// out.

#include "conv_igemm.cuh"

extern "C" {

// x (n, h, w, cp) bf16 with cp a multiple of 8, w (o, kh, kw, cp) bf16,
// bias (o,) f32, out (n, h, w, o) bf16, all dense channels-last and
// 16-byte aligned; (bm, bn, split) is the tile variant of
// conv_igemm::launch. Returns a cudaError_t.
int conv3x3_bf16(const void* x, const void* w, const void* bias, void* out,
                 int n, int cp, int h, int wd, int o, int kh, int kw, int relu,
                 int bm, int bn, int split, void* stream) {
  return conv_igemm::launch<1>(x, w, bias, out, n, cp, h, wd, o, kh, kw, relu,
                               bm, bn, split, stream);
}

}  // extern "C"
