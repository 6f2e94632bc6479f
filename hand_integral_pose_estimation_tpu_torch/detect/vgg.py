"""VGG16 detector backbone (reference: lib/model_rcnn/faster_rcnn/vgg16.py).

Port of hand_integral_pose_estimation_tpu/detect/vgg.py: the reference's
alternative Faster R-CNN backbone, conv1_1..conv5_3 (the last max-pool
dropped) as the base, the 4096-wide fc stack as the head-to-tail. Kept for
backbone parity and, as in the JAX package, not wired into `FasterRCNN`:
the hand pipeline uses the ResNet-101 C4 model.

NHWC at the public methods. The base's layers sit where torchvision's
`vgg16.features` has them (the reference's RCNN_base is that list without
its last pool); the tail flattens each pooled RoI in torch's (C, H, W)
order, as the reference's classifier does, and has no dropout, as the JAX
package's has none.
"""

from __future__ import annotations

import torch
from torch import nn

_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
        512, 512, 512, "M", 512, 512, 512)


class VGG16Base(nn.Module):
    """(B, H, W, 3) -> (B, H/16, W/16, 512) conv features (stride 16)."""

    def __init__(self):
        super().__init__()
        layers: list[nn.Module] = []
        cin = 3
        for v in _CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, v, 3, padding=1),
                           nn.ReLU(inplace=True)]
                cin = v
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.features(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class VGG16Tail(nn.Module):
    """(N, P, P, C) pooled RoI features -> (N, 4096): fc6 and fc7, each
    followed by a ReLU (vgg16.py classifier)."""

    def __init__(self, pooled: int = 7, channels: int = 512):
        super().__init__()
        self.fc6 = nn.Linear(channels * pooled * pooled, 4096)
        self.fc7 = nn.Linear(4096, 4096)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).flatten(1)
        return torch.relu(self.fc7(torch.relu(self.fc6(x))))
