"""ResNet backbones (18/34/50/101/152) with torchvision blocks.

Port of hand_integral_pose_estimation_tpu/models/resnet.py for the pose
backbone (reference common/nets/resnet.py:8-76): stride-32 feature map, no
avgpool/fc, 2048 channels for R50 and deeper. Module and parameter names
are torchvision's (`conv1`, `bn1`, `layerS.I.convK`, `layerS.I.downsample.
{0,1}`), so the reference's state dicts load with `load_state_dict`.

BatchNorm is eps 1e-5 and follows the module's train/eval mode; the serving
path runs it in eval mode on the running statistics. (a) In train mode
torch's BatchNorm2d, as the upstream PyTorch model, updates the running
variance with the unbiased batch variance, where flax's uses the biased
one; momentum 0.1 here is flax's 0.9. The train-step parity test rescales
the JAX update by n/(n-1). The stem max-pool is
(3, 2, pad 1) with -inf padding, as `nn.max_pool` pads in the JAX package
(resnet.py:177-179). GroupNorm, the caffe block style and `ResNetStage4`
belong to the detector and wait for its port.
"""

from __future__ import annotations

import math

import torch
from torch import nn

RESNET_SPECS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def _downsample(cin: int, cout: int, stride: int):
    if stride == 1 and cin == cout:
        return None
    return nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                         nn.BatchNorm2d(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = _downsample(cin, planes, stride)

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + r)


class Bottleneck(nn.Module):
    """torchvision bottleneck: the stage stride sits on the 3x3 conv."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = _downsample(cin, planes * 4, stride)

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return torch.relu(y + r)


class ResNetBackbone(nn.Module):
    """Stride-32 feature extractor, NCHW in and out: (B, 3, H, W) ->
    (B, C_out, H/32, W/32). Give it a channels_last tensor to keep the
    NHWC memory layout end to end."""

    def __init__(self, resnet_type: int = 50):
        super().__init__()
        block_name, layers = RESNET_SPECS[resnet_type]
        block = BasicBlock if block_name == "basic" else Bottleneck
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        cin = 64
        for stage, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
            blocks = []
            for i in range(n):
                blocks.append(block(cin, planes, (1, 2, 2, 2)[stage]
                                    if i == 0 else 1))
                cin = planes * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.out_channels = cin

    def forward(self, x):
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        for stage in range(1, 5):
            x = getattr(self, f"layer{stage}")(x)
        return x

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """He fan-out normal convs and unit BatchNorm, the JAX package's
        from-scratch init (resnet.py:34-41; the reference's N(0, 0.001) is
        always overwritten by ImageNet weights)."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_out),
                                 generator=generator)
            elif isinstance(m, nn.BatchNorm2d):
                reset_batchnorm(m)


def reset_batchnorm(m: nn.BatchNorm2d) -> None:
    nn.init.ones_(m.weight)
    nn.init.zeros_(m.bias)
    m.reset_running_stats()
