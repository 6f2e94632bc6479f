"""ResNet backbones (18/34/50/101/152) with torchvision blocks.

Port of hand_integral_pose_estimation_tpu/models/resnet.py: the pose
backbone (reference common/nets/resnet.py:8-76: stride-32 feature map, no
avgpool/fc, 2048 channels for R50 and deeper) and the detector's C4 split
(lib/model_rcnn/faster_rcnn/resnet.py:229-288): `num_stages=3` gives the
stride-16 base and `ResNetStage4` its layer4 head-to-tail. Module and
parameter names are torchvision's (`conv1`, `bn1`, `layerS.I.convK`,
`layerS.I.downsample.{0,1}`), so the reference's state dicts load with
`load_state_dict`.

`style="caffe"` is the detector's variant, which its faster_rcnn_*.pth
weights were trained with: a bottleneck's stride sits on its first 1x1
conv, and the stem max-pool pads one -inf row and column at the bottom and
right before a 3/2 pool (the JAX package's nn.max_pool padding, equal to
the reference's ceil-mode pool). "torchvision" puts the stride on the 3x3
conv and pads the pool by one on every side.

`norm="batch"` is BatchNorm, eps 1e-5, following the module's train/eval
mode (the serving paths run it on the running statistics). In train mode
torch's BatchNorm2d, as the upstream PyTorch model, updates the running
variance with the unbiased batch variance, where flax's uses the biased
one; momentum 0.1 here is flax's 0.9. The train-step parity test rescales
the JAX update by n/(n-1). `norm="group"` is GroupNorm with min(32, C)
groups and eps 1e-5, the from-scratch detector recipe
(`DetectorConfig.native`); its module keeps the BatchNorm's name.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

RESNET_SPECS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def make_norm(channels: int, norm: str = "batch") -> nn.Module:
    """BatchNorm or GroupNorm(min(32, C)) over `channels`, eps 1e-5."""
    if norm == "batch":
        return nn.BatchNorm2d(channels)
    if norm == "group":
        return nn.GroupNorm(min(32, channels), channels, eps=1e-5)
    raise ValueError(f"unknown norm {norm!r}")


def _downsample(cin: int, cout: int, stride: int, norm: str):
    if stride == 1 and cin == cout:
        return None
    return nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                         make_norm(cout, norm))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 norm: str = "batch", style: str = "torchvision"):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = make_norm(planes, norm)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = make_norm(planes, norm)
        self.downsample = _downsample(cin, planes, stride, norm)

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + r)


class Bottleneck(nn.Module):
    """Bottleneck block: the stage stride sits on the 3x3 conv
    (torchvision) or on the first 1x1 conv (caffe)."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 norm: str = "batch", style: str = "torchvision"):
        super().__init__()
        s1, s3 = (stride, 1) if style == "caffe" else (1, stride)
        self.conv1 = nn.Conv2d(cin, planes, 1, s1, bias=False)
        self.bn1 = make_norm(planes, norm)
        self.conv2 = nn.Conv2d(planes, planes, 3, s3, 1, bias=False)
        self.bn2 = make_norm(planes, norm)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = make_norm(planes * 4, norm)
        self.downsample = _downsample(cin, planes * 4, stride, norm)

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return torch.relu(y + r)


class CaffeMaxPool(nn.Module):
    """The caffe-style stem pool: pad one -inf row at the bottom and one
    -inf column at the right, then a 3/2 max-pool (resnet.py:177-179 of
    the JAX package)."""

    def forward(self, x):
        x = F.pad(x, (0, 1, 0, 1), value=-math.inf)
        return F.max_pool2d(x, 3, 2)


def _stage(block, cin: int, planes: int, n: int, stride: int, norm: str,
           style: str) -> nn.Sequential:
    return nn.Sequential(*[
        block(cin if i == 0 else planes * block.expansion, planes,
              stride if i == 0 else 1, norm, style) for i in range(n)])


class ResNetBackbone(nn.Module):
    """Feature extractor, NCHW in and out: (B, 3, H, W) -> (B, C_out,
    H/32, W/32), or H/16 with `num_stages=3` (the detector's base). Give it
    a channels_last tensor to keep the NHWC memory layout end to end."""

    def __init__(self, resnet_type: int = 50, num_stages: int = 4,
                 norm: str = "batch", style: str = "torchvision"):
        super().__init__()
        block_name, layers = RESNET_SPECS[resnet_type]
        block = BasicBlock if block_name == "basic" else Bottleneck
        self.num_stages = num_stages
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = make_norm(64, norm)
        self.maxpool = (CaffeMaxPool() if style == "caffe"
                        else nn.MaxPool2d(3, 2, 1))
        cin = 64
        for stage in range(num_stages):
            planes = (64, 128, 256, 512)[stage]
            setattr(self, f"layer{stage + 1}",
                    _stage(block, cin, planes, layers[stage],
                           (1, 2, 2, 2)[stage], norm, style))
            cin = planes * block.expansion
        self.out_channels = cin

    def forward(self, x):
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        for stage in range(1, self.num_stages + 1):
            x = getattr(self, f"layer{stage}")(x)
        return x

    def reset_parameters(self, generator: torch.Generator | None = None):
        reset_resnet(self, generator)


class ResNetStage4(nn.Sequential):
    """Stage 4 ("layer4") alone, NCHW in and out: the detector's
    `_head_to_tail` (lib/model_rcnn/faster_rcnn/resnet.py:285-288). Its
    blocks are indexed 0..n-1, as in torchvision's `layer4`."""

    def __init__(self, resnet_type: int = 101, stride: int = 2,
                 norm: str = "batch", style: str = "torchvision"):
        block_name, layers = RESNET_SPECS[resnet_type]
        block = BasicBlock if block_name == "basic" else Bottleneck
        super().__init__(*_stage(block, 256 * block.expansion, 512,
                                 layers[3], stride, norm, style))
        self.out_channels = 512 * block.expansion

    def reset_parameters(self, generator: torch.Generator | None = None):
        reset_resnet(self, generator)


@torch.no_grad()
def reset_resnet(module: nn.Module,
                 generator: torch.Generator | None = None) -> None:
    """He fan-out normal convs and unit norms, the JAX package's
    from-scratch init (resnet.py:34-41; the reference's N(0, 0.001) is
    always overwritten by ImageNet weights)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
            m.weight.normal_(0.0, math.sqrt(2.0 / fan_out),
                             generator=generator)
        elif isinstance(m, (nn.BatchNorm2d, nn.GroupNorm)):
            reset_batchnorm(m)


def reset_batchnorm(m: nn.Module) -> None:
    nn.init.ones_(m.weight)
    nn.init.zeros_(m.bias)
    if isinstance(m, nn.BatchNorm2d):
        m.reset_running_stats()
