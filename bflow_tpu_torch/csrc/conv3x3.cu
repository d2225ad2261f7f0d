// Odd-window stride-1 SAME convolution plus f32 bias, with an optional
// fused ReLU, bf16 operands and f32 accumulation, for Hopper (sm_90a).
//
// Replaces the TPU kernel bflow_tpu/ops/pallas/conv3x3.py:_kernel (reached
// through _fwd and conv2d_pallas): the encoders' residual 3x3s, the update
// block's 3x3s, the 7x7 convf1 over the Bezier planes and the 1x5 / 5x1
// GRU gate convolutions. The TPU kernel builds each row group's
// K = kh*kw*C im2col patch in VMEM and runs one MXU dot; here the same
// product is an implicit GEMM on wgmma, channels-last in and out, by one of
// two main loops: launches of many 128-pixel tiles take conv_pipe.cuh's
// TMA-fed persistent pipeline, the others conv_igemm.cuh's loop (each
// header says what bounds its shapes and how it is laid out). The host's
// tile plan picks the loop from the shape (kernels/conv_common.py:
// launch_plan); both give the same bits.

#include "conv_igemm.cuh"
#include "conv_pipe.cuh"

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

// the same through conv_pipe.cuh's loop, cp a multiple of 32 and bn output
// channels a tile (64, 96 or 128)
int conv3x3_bf16_pipelined(const void* x, const void* w, const void* bias,
                           void* out, int n, int cp, int h, int wd, int o,
                           int kh, int kw, int relu, int bn, void* stream) {
  return conv_pipe::launch(x, w, bias, out, n, cp, h, wd, o, kh, kw, relu, bn,
                           stream);
}

}  // extern "C"
