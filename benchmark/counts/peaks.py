"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at 700 W).

The f32 cells run full f32 (the port turns TF32 off for them), so their
peak is the f32 rate outside the tensor cores.
"""

FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
