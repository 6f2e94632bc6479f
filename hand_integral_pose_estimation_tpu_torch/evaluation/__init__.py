"""Evaluation: the PA-MPJPE / MPJPE pipeline, PCK / AUC, test-split
artifacts, the FreiHAND-challenge dump and the offline scorer."""

from hand_integral_pose_estimation_tpu_torch.evaluation.metrics import (  # noqa: F401
    EvalResult,
    PCKResult,
    aligned_pck_auc,
    backproject_to_camera,
    estimate_absolute_depth,
    evaluate_coords,
    pck_auc,
    scale_by_ref_bone,
    scale_by_root_depth,
)
from hand_integral_pose_estimation_tpu_torch.evaluation.evaluator import (  # noqa: F401
    evaluate_challenge,
    evaluate_test_split,
    score_predictions,
)
