"""Runner utilities (port of hand_integral_pose_estimation_tpu/utils)."""

from hand_integral_pose_estimation_tpu_torch.utils.logger import color_logger  # noqa: F401
from hand_integral_pose_estimation_tpu_torch.utils.metrics_writer import (  # noqa: F401
    MetricsWriter,
)
from hand_integral_pose_estimation_tpu_torch.utils.timers import Timer  # noqa: F401
from hand_integral_pose_estimation_tpu_torch.utils.visualize import (  # noqa: F401
    hand_traces_3d,
    plot_hand,
)
