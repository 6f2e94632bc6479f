"""Device ops: soft-argmax decode and fused head (CUDA kernels with plain
PyTorch versions beside them) and the eval-crop warp."""

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
