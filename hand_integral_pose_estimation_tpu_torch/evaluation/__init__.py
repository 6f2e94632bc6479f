"""Evaluation: PA-MPJPE / MPJPE pipeline, test-split artifacts and the
FreiHAND-challenge dump."""

from hand_integral_pose_estimation_tpu_torch.evaluation.metrics import (  # noqa: F401
    EvalResult,
    backproject_to_camera,
    evaluate_coords,
    scale_by_ref_bone,
)
from hand_integral_pose_estimation_tpu_torch.evaluation.evaluator import (  # noqa: F401
    evaluate_challenge,
    evaluate_test_split,
)
