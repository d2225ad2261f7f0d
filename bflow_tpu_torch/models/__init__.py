from bflow_tpu_torch.models.config import RaftSplineConfig, flagship_config
from bflow_tpu_torch.models.raft_spline import RAFTSpline

__all__ = ["RAFTSpline", "RaftSplineConfig", "flagship_config"]
