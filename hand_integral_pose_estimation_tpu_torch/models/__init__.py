"""Pose network: ResNet backbone + deconv head."""

from hand_integral_pose_estimation_tpu_torch.models.pose_net import (  # noqa: F401
    DeconvHead,
    ResPoseNet,
    get_pose_net,
)
from hand_integral_pose_estimation_tpu_torch.models.resnet import (  # noqa: F401
    RESNET_SPECS,
    ResNetBackbone,
)
