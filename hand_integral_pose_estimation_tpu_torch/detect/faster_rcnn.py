"""Faster R-CNN hand detector (ResNet-C4), inference.

Port of hand_integral_pose_estimation_tpu/detect/faster_rcnn.py (the
reference's lib/model_rcnn/faster_rcnn/faster_rcnn.py:40-104 with
faster_rcnn/resnet.py:229-288): conv1..layer3 base -> RPN -> fixed-size
proposals (ops/nms.py, kernel 7 on the card) -> ROIAlign (ops/roi_align.py,
kernel 6) -> layer4 -> spatial mean -> class scores and box deltas.

Attribute names are the reference's, so its `faster_rcnn_*.pth`
(`checkpoint["model"]`) loads with a strict `load_state_dict`:
`RCNN_base` = Sequential(conv1, bn1, relu, maxpool, layer1, layer2,
layer3), `RCNN_top` = Sequential(layer4), `RCNN_rpn.{RPN_Conv,
RPN_cls_score, RPN_bbox_pred}`, `RCNN_cls_score`, `RCNN_bbox_pred`. The RPN
class scores keep the reference's [bg x A, fg x A] channel order.

Images and features are NHWC at the public methods; inside, the convs run
on channels_last NCHW views. `cfg.compute_dtype` runs the conv stacks and
the heads under autocast over float32 parameters; the proposal decode, NMS,
ROIAlign's input and the score softmax are always float32
(faster_rcnn.py:141-144 of the JAX package). `cfg.freeze_bn` keeps every
BatchNorm on its running statistics, even under `.train()`
(resnet.py:261-284 of the reference). Detector training (anchor and
proposal targets, the losses) comes with a later port.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from hand_integral_pose_estimation_tpu_torch.config import DetectorConfig
from hand_integral_pose_estimation_tpu_torch.detect import box_ops
from hand_integral_pose_estimation_tpu_torch.detect.rpn import proposal_layer
from hand_integral_pose_estimation_tpu_torch.models.resnet import (
    ResNetBackbone,
    ResNetStage4,
    reset_resnet,
)
from hand_integral_pose_estimation_tpu_torch.ops.roi_align import (
    roi_align_batched,
)


class DetectionOutputs(NamedTuple):
    rois: torch.Tensor         # (B, R, 4)
    roi_valid: torch.Tensor    # (B, R) bool
    cls_scores: torch.Tensor   # (B, R, num_classes) softmax probabilities
    bbox_deltas: torch.Tensor  # (B, R, 4 * num_classes)
    losses: Optional[dict]


class RPN(nn.Module):
    """3x3 conv trunk + 1x1 class (2A) and box (4A) heads (rpn.py:21-43)."""

    def __init__(self, in_channels: int, num_anchors: int):
        super().__init__()
        self.RPN_Conv = nn.Conv2d(in_channels, 512, 3, 1, 1)
        self.RPN_cls_score = nn.Conv2d(512, 2 * num_anchors, 1)
        self.RPN_bbox_pred = nn.Conv2d(512, 4 * num_anchors, 1)

    def forward(self, feats):
        t = torch.relu(self.RPN_Conv(feats))
        return self.RPN_cls_score(t), self.RPN_bbox_pred(t)


class FasterRCNN(nn.Module):

    def __init__(self, cfg: DetectorConfig = DetectorConfig()):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        base = ResNetBackbone(cfg.resnet_type, num_stages=3, norm=cfg.norm,
                              style=cfg.resnet_style)
        self.RCNN_base = nn.Sequential(
            base.conv1, base.bn1, nn.ReLU(inplace=True), base.maxpool,
            base.layer1, base.layer2, base.layer3)
        top = ResNetStage4(cfg.resnet_type, norm=cfg.norm,
                           style=cfg.resnet_style)
        self.RCNN_top = nn.Sequential(top)
        self.num_anchors = len(cfg.anchor_scales) * len(cfg.anchor_ratios)
        self.RCNN_rpn = RPN(base.out_channels, self.num_anchors)
        num_classes = len(cfg.classes)
        self.RCNN_cls_score = nn.Linear(top.out_channels, num_classes)
        self.RCNN_bbox_pred = nn.Linear(top.out_channels, 4 * num_classes)
        self._anchors: dict = {}

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """He fan-out convs and unit norms in the base and tail (the JAX
        package's from-scratch init), and the reference's normal inits of
        the heads (faster_rcnn.py `_init_weights`: std 0.01, the box
        regressor 0.001, zero biases)."""
        reset_resnet(self.RCNN_base, generator)
        reset_resnet(self.RCNN_top, generator)
        for m, std in ((self.RCNN_rpn.RPN_Conv, 0.01),
                       (self.RCNN_rpn.RPN_cls_score, 0.01),
                       (self.RCNN_rpn.RPN_bbox_pred, 0.01),
                       (self.RCNN_cls_score, 0.01),
                       (self.RCNN_bbox_pred, 0.001)):
            m.weight.normal_(0.0, std, generator=generator)
            nn.init.zeros_(m.bias)

    def train(self, mode: bool = True):
        super().train(mode)
        if self.cfg.freeze_bn:
            for m in self.modules():
                if isinstance(m, nn.BatchNorm2d):
                    m.eval()
        return self

    def _autocast(self, device: torch.device):
        return torch.autocast(device.type, dtype=self.compute_dtype,
                              enabled=self.compute_dtype != torch.float32)

    def anchors(self, feat_hw, device: torch.device) -> torch.Tensor:
        """(H*W*A, 4) float32 anchors of a feature grid, made once per grid
        and device (a host-to-device copy waits for the stream)."""
        key = (tuple(feat_hw), str(device))
        if key not in self._anchors:
            c = self.cfg
            self._anchors[key] = box_ops.grid_anchors(
                feat_hw, c.feat_stride,
                box_ops.generate_base_anchors(c.feat_stride, c.anchor_ratios,
                                              c.anchor_scales), device)
        return self._anchors[key]

    def upstream(self, images: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(B, H, W, 3) BGR blob, pixel means subtracted -> (feats
        (B, H/16, W/16, C) in the compute dtype, rois (B, R, 4), roi_valid
        (B, R)): the base, the RPN and the test-time proposal layer."""
        c = self.cfg
        B, H, W, _ = images.shape
        with self._autocast(images.device):
            f = self.RCNN_base(images.permute(0, 3, 1, 2))
            cls, reg = self.RCNN_rpn(f)
        feats = f.permute(0, 2, 3, 1)
        anchors = self.anchors(feats.shape[1:3], images.device)
        props = proposal_layer(
            cls.permute(0, 2, 3, 1), reg.permute(0, 2, 3, 1), anchors, (H, W),
            c.rpn_pre_nms_top_n_test, c.rpn_post_nms_top_n_test,
            c.rpn_nms_thresh, c.rpn_min_size)
        return feats, props.rois, props.valid

    def downstream(self, feats: torch.Tensor, rois: torch.Tensor,
                   roi_valid: torch.Tensor) -> DetectionOutputs:
        """`upstream`'s outputs -> DetectionOutputs (losses None): ROIAlign
        on float32 features, layer4, the spatial mean and the heads."""
        c = self.cfg
        B, R = rois.shape[0], rois.shape[1]
        P = c.pooling_size
        pooled = roi_align_batched(feats.float().contiguous(), rois, P,
                                   c.spatial_scale, c.sampling_ratio)
        x = pooled.reshape(B * R, P, P, -1).permute(0, 3, 1, 2)
        with self._autocast(feats.device):
            h = self.RCNN_top(x).mean(dim=(2, 3))
            cls_logits = self.RCNN_cls_score(h)
            bbox_pred = self.RCNN_bbox_pred(h)
        probs = torch.softmax(cls_logits.float().reshape(B, R, -1), dim=-1)
        return DetectionOutputs(rois=rois, roi_valid=roi_valid,
                                cls_scores=probs,
                                bbox_deltas=bbox_pred.float().reshape(B, R, -1),
                                losses=None)

    def forward(self, images: torch.Tensor) -> DetectionOutputs:
        """Inference: (B, H, W, 3) blob -> DetectionOutputs."""
        return self.downstream(*self.upstream(images))
