"""Full-f32 arithmetic on the GPU for the span of a call.

The JAX package pins the f32 work that must be f32 to
``Precision.HIGHEST`` (the encoders' convs, bflow_tpu/models/extractor.py:
conv_precision; the f32 correlation volume; the convex upsampling; the
Bezier evaluation). PyTorch's counterpart is a pair of process-wide flags:
cuDNN runs f32 convolutions in TF32 (a 10-bit mantissa) unless
``torch.backends.cudnn.allow_tf32`` is False, and cuBLAS may run f32
matmuls in TF32 while ``torch.backends.cuda.matmul.allow_tf32`` is True.
``full_f32`` turns both off for the block inside it and gives the caller's
settings back when it ends, so the model's forward, the train step's
forward and backward and the eval step are f32 whatever the caller set,
and leave the caller's flags as they were. TF32 never touches a bf16
operand, so the bf16 paths are unchanged under it.

The flags are the process's, not the thread's: two threads that run
forwards at once under different settings see each other's.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch


@contextmanager
def full_f32():
    """TF32 off for cuDNN convolutions and CUDA matmuls inside the block;
    cuDNN's enabled, benchmark and deterministic switches pass through
    unchanged. Nests: inside another ``full_f32`` (or where the caller
    already turned TF32 off) it changes nothing."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    if not (cudnn.allow_tf32 or matmul.allow_tf32):
        yield
        return
    prior = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         benchmark_limit=cudnn.benchmark_limit,
                         deterministic=cudnn.deterministic,
                         allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = prior
