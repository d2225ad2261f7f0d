from bflow_tpu_torch.ops.bezier import BezierCurves, bezier_coefficients
from bflow_tpu_torch.ops.sampler import bilinear_sample, coords_grid
from bflow_tpu_torch.ops.upsample import convex_upsample

__all__ = ["BezierCurves", "bezier_coefficients", "bilinear_sample",
           "convex_upsample", "coords_grid"]
