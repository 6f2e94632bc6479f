"""Serving-side runtime: the eval step and the Tester."""

from hand_integral_pose_estimation_tpu_torch.training.train_step import (  # noqa: F401
    make_eval_fn,
    make_eval_step,
)
from hand_integral_pose_estimation_tpu_torch.training.trainer import (  # noqa: F401
    Tester,
)
