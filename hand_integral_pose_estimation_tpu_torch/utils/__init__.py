"""Runner utilities (port of hand_integral_pose_estimation_tpu/utils)."""

from hand_integral_pose_estimation_tpu_torch.utils.metrics_writer import (  # noqa: F401
    MetricsWriter,
)
