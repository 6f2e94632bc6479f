"""The integral pose network, its training step and its evaluation crop,
in plain PyTorch.

The network is the reference repository's ResPoseNet (main/model.py:5-78):
a torchvision-layout ResNet trunk (common/nets/resnet.py), three 4x4
stride-2 transposed convolutions with BatchNorm and ReLU, a 1x1
projection to J x D heatmap channels (channel j * D + d), and the
soft-argmax over each joint's D x H x W volume. Parameter names are the
reference's, so one state dict loads into this module and into the port's.
Every convolution takes its operands through a `Precision`; BatchNorm,
the softmax and the loss stay in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import Precision
from benchmark.reference import geometry as geo

RESNET_LAYERS = {18: ("basic", (2, 2, 2, 2)), 34: ("basic", (3, 4, 6, 3)),
                 50: ("bottleneck", (3, 4, 6, 3)),
                 101: ("bottleneck", (3, 4, 23, 3)),
                 152: ("bottleneck", (3, 8, 36, 3))}
PIXEL_MEAN = (0.4559, 0.5142, 0.5148)


def conv(m: nn.Conv2d, x, q: Precision):
    return q.out(F.conv2d(q(x), q(m.weight), m.bias, m.stride, m.padding))


class Block(nn.Module):
    """A basic or bottleneck residual block; `caffe` puts a bottleneck's
    stride on its first 1x1 convolution, torchvision on the 3x3."""

    def __init__(self, kind: str, cin: int, planes: int, stride: int,
                 caffe: bool = False):
        super().__init__()
        self.kind = kind
        out = planes * (4 if kind == "bottleneck" else 1)
        if kind == "basic":
            self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(planes)
            self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
            self.bn2 = nn.BatchNorm2d(planes)
        else:
            s1, s3 = (stride, 1) if caffe else (1, stride)
            self.conv1 = nn.Conv2d(cin, planes, 1, s1, bias=False)
            self.bn1 = nn.BatchNorm2d(planes)
            self.conv2 = nn.Conv2d(planes, planes, 3, s3, 1, bias=False)
            self.bn2 = nn.BatchNorm2d(planes)
            self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
            self.bn3 = nn.BatchNorm2d(out)
        self.downsample = (nn.Sequential(
            nn.Conv2d(cin, out, 1, stride, bias=False), nn.BatchNorm2d(out))
            if stride != 1 or cin != out else None)

    def last_norm(self) -> nn.BatchNorm2d:
        """The norm that closes the residual branch."""
        return self.bn3 if self.kind == "bottleneck" else self.bn2

    def run(self, x, q: Precision):
        r = x if self.downsample is None else self.downsample[1](
            conv(self.downsample[0], x, q))
        y = torch.relu(self.bn1(conv(self.conv1, x, q)))
        if self.kind == "basic":
            y = self.bn2(conv(self.conv2, y, q))
        else:
            y = torch.relu(self.bn2(conv(self.conv2, y, q)))
            y = self.bn3(conv(self.conv3, y, q))
        return torch.relu(y + r)


class ResNet(nn.Module):
    """The trunk, NCHW: `num_stages` 4 is the pose backbone (stride 32),
    3 the detector's base (stride 16). `caffe` also pads the stem pool
    with one -inf row and column at the bottom and right (ceil mode)."""

    def __init__(self, resnet_type: int, num_stages: int = 4,
                 caffe: bool = False):
        super().__init__()
        kind, layers = RESNET_LAYERS[resnet_type]
        self.caffe = caffe
        self.num_stages = num_stages
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
        for s in range(num_stages):
            blocks = []
            for i in range(layers[s]):
                blocks.append(Block(kind, cin, (64, 128, 256, 512)[s],
                                    (1, 2, 2, 2)[s] if i == 0 else 1, caffe))
                cin = blocks[-1].bn2.num_features * (
                    4 if kind == "bottleneck" else 1)
            setattr(self, f"layer{s + 1}", nn.Sequential(*blocks))
        self.out_channels = cin

    def stem(self, x, q: Precision):
        x = torch.relu(self.bn1(conv(self.conv1, x, q)))
        if self.caffe:
            return F.max_pool2d(x, 3, 2, 0, ceil_mode=True)
        return F.max_pool2d(x, 3, 2, 1)

    def run(self, x, q: Precision, stages=None):
        x = self.stem(x, q)
        for s in range(stages or self.num_stages):
            for block in getattr(self, f"layer{s + 1}"):
                x = block.run(x, q)
        return x


class PoseNet(nn.Module):
    """backbone . head (main/model.py:58-67)."""

    def __init__(self, resnet_type: int = 50, num_joints: int = 21,
                 depth_dim: int = 56, deconv_channels: int = 256,
                 num_deconv_layers: int = 3):
        super().__init__()
        self.num_joints, self.depth_dim = num_joints, depth_dim
        self.backbone = ResNet(resnet_type)
        head = nn.Module()
        layers, cin = [], self.backbone.out_channels
        for _ in range(num_deconv_layers):
            layers += [nn.ConvTranspose2d(cin, deconv_channels, 4, 2, 1,
                                          bias=False),
                       nn.BatchNorm2d(deconv_channels), nn.ReLU()]
            cin = deconv_channels
        head.deconv_layers = nn.Sequential(*layers)
        head.final_layer = nn.Conv2d(cin, num_joints * depth_dim, 1)
        self.head = head

    def features(self, images_nhwc, q: Precision):
        """(B, H, W, 3) patches -> the head's (B, F, h, w) features."""
        x = self.backbone.run(images_nhwc.permute(0, 3, 1, 2), q)
        mods = list(self.head.deconv_layers)
        for deconv, bn in zip(mods[0::3], mods[1::3]):
            x = torch.relu(bn(q.out(F.conv_transpose2d(
                q(x), q(deconv.weight), None, 2, 1))))
        return x

    def forward(self, images_nhwc, q: Precision = Precision()):
        """(B, H, W, 3) patches -> (B, J, 3) label-space coords."""
        logits = conv(self.head.final_layer, self.features(images_nhwc, q), q)
        return integral(logits, self.num_joints, self.depth_dim)


def integral(logits, num_joints: int, depth: int):
    """Soft-argmax of (B, J*D, H, W) logits over each joint's D x H x W
    volume: (B, J, 3) expectations x/W - 0.5, y/H - 0.5, z/D - 0.5."""
    B, _, H, W = logits.shape
    p = torch.softmax(logits.float().reshape(B, num_joints, -1), -1).reshape(
        B, num_joints, depth, H, W)
    dev = logits.device

    def expect(marginal, n):
        return (marginal * torch.arange(n, dtype=torch.float32,
                                        device=dev)).sum(-1) / n - 0.5

    return torch.stack([expect(p.sum((2, 3)), W), expect(p.sum((2, 4)), H),
                        expect(p.sum((3, 4)), depth)], -1)


# ---------------------------------------------------------------- inputs
def eval_batch(images, joint_cam, K, bbox=None, size=224):
    """The evaluation crop (dataset.py:115, R = I, no colour jitter):
    (normalised patches (B, size, size, 3), Labels). `bbox` None crops the
    box of the projected joints."""
    eye = torch.eye(3, device=K.device).expand(K.shape)
    if bbox is None:
        uv, _ = geo.project_points(joint_cam, eye, K)
        bbox = geo.bbox_from_keypoints(uv)
    lab = geo.patch_labels(joint_cam, eye, K, bbox, size)
    patch = geo.warp_axis_aligned(images, lab.trans, (size, size))
    return geo.normalise(patch, 1.0, PIXEL_MEAN), lab


def train_batch(images, joint_cam, K, R, colour, size=224):
    """The augmented training batch (dataset.py:117-175): box of the
    rotated joints, labels under R, one composed homography crop . K R K^-1
    resampled by the two-pass warp, colour scale, mean."""
    uv, _ = geo.project_points(joint_cam, R, K)
    bbox = geo.bbox_from_keypoints(uv)
    lab = geo.patch_labels(joint_cam, R, K, bbox, size)
    H = lab.trans @ (K @ R @ torch.linalg.inv(K))
    patch = geo.warp_twopass(images, H, size)
    return geo.normalise(patch, colour[:, None, None, :], PIXEL_MEAN), lab


# ---------------------------------------------------------------- training
def combined_loss(coords, label, labelled):
    """sum |out - GT| over labelled rows, over the batch size (loss.py:99-203
    without the teacher's and the PANet terms)."""
    lab = labelled.float()[:, None, None]
    return (torch.abs(coords - label) * lab).sum() / coords.shape[0]


class Adam:
    """torch.optim.Adam's update with L2 weight decay, written out."""

    def __init__(self, params: dict, lr: float, weight_decay: float,
                 betas=(0.9, 0.999), eps=1e-8):
        self.params, self.lr, self.wd = params, lr, weight_decay
        self.b1, self.b2 = betas
        self.eps = eps
        self.t = 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self) -> dict:
        """One update; returns each leaf's gradient as Adam takes it
        (with the decay term)."""
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        taken = {}
        for k, p in self.params.items():
            g = p.grad + self.wd * p
            taken[k] = g
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = self.v[k].sqrt() / c2 ** 0.5 + self.eps
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)
        return taken


def train_steps(net: PoseNet, steps, lr: float, weight_decay: float,
                q: Precision = Precision(), size: int = 224):
    """Train `net` (train mode) over `steps`, each a dict of device tensors
    image, joint_cam, K, labelled, R, colour. Returns (the loss of each
    step, the first step's gradient of each leaf as Adam takes it, each
    leaf's change over all the steps, the norms' running statistics after
    the first step)."""
    params = dict(net.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    opt = Adam(params, lr, weight_decay)
    net.train()
    losses, first, stats = [], None, None
    for s in steps:
        with q:
            patch, lab = train_batch(s["image"], s["joint_cam"], s["K"],
                                     s["R"], s["colour"], size)
            loss = combined_loss(net(patch, q), lab.label, s["labelled"])
        net.zero_grad(set_to_none=True)
        loss.backward()
        taken = opt.step()
        if first is None:
            first, stats = taken, running_stats(net)
        losses.append(float(loss.detach()))
    change = {k: (p.detach() - start[k]) for k, p in params.items()}
    return losses, first, change, stats


def running_stats(net: nn.Module) -> dict:
    """A copy of every norm's running mean and variance, by name."""
    return {k: v.detach().clone() for k, v in net.named_buffers()
            if k.endswith(("running_mean", "running_var"))}
