"""Teacher-label distillation: the rotation-variance filter and its exact
early-reject cascade."""

from hand_integral_pose_estimation_tpu_torch.distill.cascade import (  # noqa: F401
    CascadeRunner,
    pass1_rotation_indices,
)
from hand_integral_pose_estimation_tpu_torch.distill.teacher_labels import (  # noqa: F401
    FilteredLabels,
    filter_precision_curve,
    generate_filtered_labels,
    rotation_sweep_camera,
    sweep_patches,
    teacher_error_vs_variance,
)
