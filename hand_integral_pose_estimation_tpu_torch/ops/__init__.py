"""Device ops: the soft-argmax decode and the fused head, forward and
backward, the batched warps, NMS and ROIAlign (CUDA kernels with plain
PyTorch versions beside them)."""

from hand_integral_pose_estimation_tpu_torch.ops.fused_head import (  # noqa: F401
    head_projection_integral,
    head_projection_integral_reference,
)
from hand_integral_pose_estimation_tpu_torch.ops.integral import (  # noqa: F401
    heatmap_entropy,
    softmax_integral,
    softmax_integral_reference,
    softmax_probs,
)
