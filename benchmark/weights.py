"""Weights drawn from the seed on the device, in a few large calls.

The benchmark makes the weights and hands the same state dict to the port
and to the reference. Convolutions take the port's from-scratch init (He
fan-out normal, models/resnet.py), transposed convolutions the reference's
N(0, 0.001) (main/model.py:46-56), layers with a bias (the projection, the
detector's heads) N(0, 0.01) with a zero bias before their rescale, norms
unit scale and zero shift. Then, as the port's chip_smoke.py does for its
checks, the BatchNorm running statistics are set to each layer's own input
statistics on a batch of the cell's frames (a trained network's frozen
statistics play this part), and the projection is scaled so that the
logits spread by the configuration's `projection_logit_std`: the reference
init leaves every softmax flat and every decode near 0, where a broken
kernel would still pass.

The last norm of each residual branch starts at the configuration's
`residual_gamma` (Goyal et al. 2017 start it at 0; torchvision's
`zero_init_residual`). At 1, a random ResNet with its norms is chaotic:
bf16 rounding grows by about 1.3x a block, and a ResNet-50's features end
37% away from float32's, so that no comparison could tell bf16 from a
lower precision.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def draw(net: nn.Module, seed: int, residual_gamma: float = 1.0) -> None:
    """Fill `net`'s parameters from `seed` with one normal draw over every
    weight, scaled leaf by leaf in one product; norms get (1, 0) and
    running statistics (0, 1), except the last norm of each residual
    branch, whose scale is `residual_gamma`."""
    weights, stds = [], []
    for m in net.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
            continue
        if not isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            continue
        weights.append(m.weight)
        if isinstance(m, nn.ConvTranspose2d):
            stds.append(0.001)
        elif m.bias is None:
            # a trunk convolution
            fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
            stds.append(math.sqrt(2.0 / fan_out))
        else:
            # a head layer, rescaled to its spread after calibration
            stds.append(0.01)
            nn.init.zeros_(m.bias)
    dev = weights[0].device
    counts = torch.tensor([w.numel() for w in weights], device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    flat = torch.randn(int(counts.sum()), generator=g, device=dev)
    flat *= torch.repeat_interleave(torch.tensor(stds, device=dev), counts)
    with torch.no_grad():
        for w, part in zip(weights, flat.split(counts.tolist())):
            w.copy_(part.view_as(w))
        for m in net.modules():
            if hasattr(m, "last_norm"):
                m.last_norm().weight.fill_(residual_gamma)


@torch.no_grad()
def calibrate_batchnorm(run, net: nn.Module) -> None:
    """Set each BatchNorm's running statistics to those of its own input in
    one eval-mode call of `run()`: a hook sets them just before the layer
    normalises, so each later layer sees normalised inputs."""
    def hook(m, args):
        x = args[0].float()
        m.running_mean.copy_(x.mean(dim=(0, 2, 3)))
        m.running_var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    handles = [m.register_forward_pre_hook(hook) for m in net.modules()
               if isinstance(m, nn.BatchNorm2d)]
    net.eval()
    try:
        run()
    finally:
        for h in handles:
            h.remove()


@torch.no_grad()
def scale_projection(layer: nn.Conv2d, feats: torch.Tensor,
                     logit_std: float) -> None:
    """Scale `layer` (a 1x1 projection of NCHW `feats`) so that its logits
    spread by `logit_std` on `feats`, and zero its bias."""
    rms = float(feats.float().pow(2).sum(1).mean().sqrt())
    w = layer.weight
    w.mul_(logit_std / rms / float(w.std()))
    layer.bias.zero_()


def state(net: nn.Module) -> dict:
    """A copy of `net`'s state dict."""
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def pose_state(config: dict, frames, seed: int, device,
               calibration_rows: int = 32) -> dict:
    """The pose net's state dict from `seed`: drawn, its BatchNorms
    calibrated on the evaluation crops of the first frames, its projection
    scaled on their features."""
    from benchmark.reference import Precision
    from benchmark.reference.pose import PoseNet, eval_batch

    model, init = config["model"], config["init"]
    net = PoseNet(model["resnet_type"], model["num_joints"],
                  model["depth_dim"], model["deconv_channels"],
                  model["num_deconv_layers"]).to(device)
    draw(net, seed, init["residual_gamma"])
    n = min(calibration_rows, len(frames))

    def rows(a):
        return torch.from_numpy(a[:n]).to(device)

    q = Precision()
    with torch.no_grad(), q:
        patches, _ = eval_batch(rows(frames.images), rows(frames.joint_cam),
                                rows(frames.K), size=model["input_shape"][0])
        calibrate_batchnorm(lambda: net.features(patches, q), net)
        feats = net.features(patches, q)
    scale_projection(net.head.final_layer, feats,
                     init["projection_logit_std"])
    return state(net)


def detector_state(config: dict, frames, seed: int, device,
                   calibration_rows: int = 4) -> dict:
    """The detector's state dict from `seed`: drawn, its BatchNorms
    calibrated on the first frames, and, as chip_smoke.py's
    scale_detector_heads does, its class and box layers scaled to a
    trained detector's spread (the RPN's logits 1 and deltas 0.2, the
    head's 1 and 1): random weights saturate both softmaxes and give
    deltas that clip every proposal to a sliver."""
    from benchmark.reference import Precision
    from benchmark.reference.detector import (
        Detector,
        blob,
        detect,
        pool,
        proposals,
    )

    det = config["detector"]
    net = Detector(det).to(device)
    draw(net, seed, config["init"]["residual_gamma"])
    images = torch.from_numpy(frames.images[:calibration_rows]).to(device)
    q = Precision()
    with torch.no_grad(), q:
        calibrate_batchnorm(lambda: detect(net, images, q), net)
        x, _ = blob(images, det)
        rpn = net.RCNN_rpn
        t = torch.relu(rpn.RPN_Conv(net.base(x, q)))
        _spread(rpn.RPN_cls_score, rpn.RPN_cls_score(t), 1.0)
        _spread(rpn.RPN_bbox_pred, rpn.RPN_bbox_pred(t), 0.2)
        feats, props = proposals(net, x, q)
        h = torch.cat([net.tail(pool(net, feats[i], rois), q)
                       for i, (rois, _) in enumerate(props)])
        _spread(net.RCNN_cls_score, net.RCNN_cls_score(h), 1.0)
        _spread(net.RCNN_bbox_pred, net.RCNN_bbox_pred(h), 1.0)
    return state(net)


def _spread(layer: nn.Module, out: torch.Tensor, want: float) -> None:
    """Scale `layer`'s weight and bias so that `out`, its output, would
    spread by `want`."""
    k = want / float(out.std())
    layer.weight.mul_(k)
    layer.bias.mul_(k)
