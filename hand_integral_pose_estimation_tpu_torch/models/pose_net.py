"""Integral pose network: ResNet backbone + deconv head -> 3D heatmaps.

Port of hand_integral_pose_estimation_tpu/models/pose_net.py (reference
main/model.py:5-78): three (4x4 stride-2 transposed conv -> BN -> ReLU)
layers, then a 1x1 conv to `num_joints * depth_dim` channels. Parameter
names are the reference's (`head.deconv_layers.{0,3,6}.weight`,
`{1,4,7}.*`, `head.final_layer.{weight,bias}`), so a reference
`snapshot_*.pth` loads with `load_state_dict`.

The public layout is the JAX package's: images NHWC (B, H, W, 3) in,
heatmap NHWC (B, h, w, J*D) out with channel = j*D + d. Inside, the NHWC
tensor's `permute(0, 3, 1, 2)` is an NCHW channels_last view, so the convs
run channels_last with no copy and the head's output permutes back to a
contiguous NHWC tensor. `ModelConfig.compute_dtype` is honoured: params
stay float32 and the conv stack runs under autocast in that dtype.

The JAX package's `_PhaseDeconv` lowering is not ported: it is a measured
negative with the same parameters.
"""

from __future__ import annotations

import torch
from torch import nn

from hand_integral_pose_estimation_tpu_torch.config import ModelConfig
from hand_integral_pose_estimation_tpu_torch.models.resnet import (
    ResNetBackbone,
    reset_batchnorm,
)
from hand_integral_pose_estimation_tpu_torch.ops.integral import (
    softmax_integral,
)


class DeconvHead(nn.Module):
    """3-layer transposed-conv upsampler + 1x1 heatmap projection
    (main/model.py:22-44), NCHW in and out."""

    def __init__(self, in_channels: int, num_joints: int = 21,
                 depth_dim: int = 56, channels: int = 256,
                 num_layers: int = 3):
        super().__init__()
        layers = []
        for _ in range(num_layers):
            # k=4, s=2, p=1: an exact 2x upsample (flax "SAME" in the JAX head)
            layers += [nn.ConvTranspose2d(in_channels, channels, 4, 2, 1,
                                          bias=False),
                       nn.BatchNorm2d(channels), nn.ReLU(inplace=True)]
            in_channels = channels
        self.deconv_layers = nn.Sequential(*layers)
        self.final_layer = nn.Conv2d(channels, num_joints * depth_dim, 1)

    def forward(self, x, return_features: bool = False):
        x = self.deconv_layers(x)
        if return_features:
            # pre-projection activations for the fused projection + decode
            return x
        return self.final_layer(x)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """The reference head init (main/model.py:46-56): deconv and final
        weights N(0, 0.001), final bias 0, unit BatchNorm."""
        for m in self.modules():
            if isinstance(m, (nn.ConvTranspose2d, nn.Conv2d)):
                m.weight.normal_(0.0, 0.001, generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm2d):
                reset_batchnorm(m)


class ResPoseNet(nn.Module):
    """backbone . head (main/model.py:58-67)."""

    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.backbone = ResNetBackbone(cfg.resnet_type)
        self.head = DeconvHead(self.backbone.out_channels, cfg.num_joints,
                               cfg.depth_dim, cfg.deconv_channels,
                               cfg.num_deconv_layers)

    def forward(self, images: torch.Tensor,
                return_features: bool = False) -> torch.Tensor:
        """(B, H, W, 3) images -> NHWC heatmap logits (B, h, w, J*D), or the
        head's (B, h, w, F) features with `return_features`, in the compute
        dtype."""
        x = images.permute(0, 3, 1, 2)
        with torch.autocast(images.device.type, dtype=self.compute_dtype,
                            enabled=self.compute_dtype != torch.float32):
            y = self.head(self.backbone(x), return_features=return_features)
        return y.permute(0, 2, 3, 1)

    def final_projection(self):
        """(weight (J*D, F), bias (J*D,)) of the heatmap projection, the
        operands of ops.fused_head.head_projection_integral."""
        w = self.head.final_layer.weight
        return w.view(w.shape[0], w.shape[1]), self.head.final_layer.bias

    def decode(self, heatmap: torch.Tensor) -> torch.Tensor:
        """NHWC heatmap -> (B, J, 3) normalised coords (soft-argmax)."""
        return softmax_integral(heatmap, self.cfg.num_joints,
                                self.cfg.depth_dim)

    def reset_parameters(self, generator: torch.Generator | None = None):
        self.backbone.reset_parameters(generator)
        self.head.reset_parameters(generator)


def get_pose_net(cfg: ModelConfig | None = None,
                 generator: torch.Generator | None = None) -> ResPoseNet:
    """Factory mirroring the reference's `get_pose_net` (main/model.py:69):
    the JAX package's init drawn from `generator` (torch's default
    generator when None), parameters in channels_last."""
    net = ResPoseNet(cfg or ModelConfig())
    net.reset_parameters(generator)
    return net.to(memory_format=torch.channels_last)
