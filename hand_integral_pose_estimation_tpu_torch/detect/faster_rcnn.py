"""Faster R-CNN hand detector (ResNet-C4): inference and training.

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
(resnet.py:261-284 of the reference).

Training (`forward` with gt boxes) adds the anchor and proposal targets
(detect/rpn.py, detect/targets.py) and the four losses, at the train-time
proposal sizes. The proposal layer runs on detached RPN outputs, under
no_grad (kernel 7 on the card): the RoIs are constants to the head and to
the targets, the reference's approximate joint training (it passes
`rpn_cls_prob.data, rpn_bbox_pred.data`). The JAX package differentiates
through the proposal boxes instead, which its documentation does not
state; the port follows the reference. ROIAlign then back-propagates into
the features only (kernel 6 and its backward kernel on the card).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from hand_integral_pose_estimation_tpu_torch.config import DetectorConfig
from hand_integral_pose_estimation_tpu_torch.detect import box_ops
from hand_integral_pose_estimation_tpu_torch.detect.rpn import (
    anchor_target_layer,
    draw_priorities,
    proposal_layer,
    rpn_losses,
)
from hand_integral_pose_estimation_tpu_torch.detect.targets import (
    detection_head_losses,
    proposal_target_layer,
)
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


class SamplingPriorities(NamedTuple):
    """The uniform draws of one training forward's subsampling: the anchor
    targets' (B, H*W*A) foreground and background priorities, then the
    proposal targets' (B, R + G) ones."""
    anchor_fg: torch.Tensor
    anchor_bg: torch.Tensor
    roi_fg: torch.Tensor
    roi_bg: torch.Tensor


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
                              enabled=self.compute_dtype in (torch.float16,
                                                             torch.bfloat16))

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

    def _rpn(self, images: torch.Tensor):
        """The base and the RPN convs: (feats (B, H/16, W/16, C) in the
        compute dtype, class logits (B, h, w, 2A), deltas (B, h, w, 4A),
        anchors)."""
        with self._autocast(images.device):
            f = self.RCNN_base(images.permute(0, 3, 1, 2))
            cls, reg = self.RCNN_rpn(f)
        feats = f.permute(0, 2, 3, 1)
        anchors = self.anchors(feats.shape[1:3], images.device)
        return (feats, cls.permute(0, 2, 3, 1), reg.permute(0, 2, 3, 1),
                anchors)

    def upstream(self, images: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(B, H, W, 3) BGR blob, pixel means subtracted -> (feats
        (B, H/16, W/16, C) in the compute dtype, rois (B, R, 4), roi_valid
        (B, R)): the base, the RPN and the test-time proposal layer."""
        c = self.cfg
        B, H, W, _ = images.shape
        feats, cls, reg, anchors = self._rpn(images)
        props = proposal_layer(
            cls, reg, anchors, (H, W), c.rpn_pre_nms_top_n_test,
            c.rpn_post_nms_top_n_test, c.rpn_nms_thresh, c.rpn_min_size)
        return feats, props.rois, props.valid

    def _head(self, feats: torch.Tensor, rois: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """ROIAlign on float32 features -> layer4 -> spatial mean -> (class
        logits (B, R, K), box deltas (B, R, 4K)), in the compute dtype."""
        c = self.cfg
        B, R = rois.shape[0], rois.shape[1]
        P = c.pooling_size
        pooled = roi_align_batched(feats.float().contiguous(), rois, P,
                                   c.spatial_scale, c.sampling_ratio)
        x = pooled.reshape(B * R, P, P, -1).permute(0, 3, 1, 2).to(
            self.RCNN_cls_score.weight.dtype)
        with self._autocast(feats.device):
            h = self.RCNN_top(x).mean(dim=(2, 3))
            cls_logits = self.RCNN_cls_score(h)
            bbox_pred = self.RCNN_bbox_pred(h)
        return cls_logits.reshape(B, R, -1), bbox_pred.reshape(B, R, -1)

    def downstream(self, feats: torch.Tensor, rois: torch.Tensor,
                   roi_valid: torch.Tensor) -> DetectionOutputs:
        """`upstream`'s outputs -> DetectionOutputs (losses None): ROIAlign
        on float32 features, layer4, the spatial mean and the heads."""
        cls_logits, bbox_pred = self._head(feats, rois)
        return DetectionOutputs(
            rois=rois, roi_valid=roi_valid,
            cls_scores=torch.softmax(cls_logits.float(), dim=-1),
            bbox_deltas=bbox_pred.float(), losses=None)

    def draw_priorities(self, generator: Optional[torch.Generator], batch: int,
                        feat_hw, num_gt: int,
                        device) -> SamplingPriorities:
        """A training forward's subsampling draws from `generator`: the
        anchor targets' two, then the proposal targets' two."""
        c = self.cfg
        n_anchors = feat_hw[0] * feat_hw[1] * self.num_anchors
        n_cand = c.rpn_post_nms_top_n_train + num_gt
        return SamplingPriorities(
            *draw_priorities(generator, (batch, n_anchors), device),
            *draw_priorities(generator, (batch, n_cand), device))

    def forward(self, images: torch.Tensor,
                gt_boxes: Optional[torch.Tensor] = None,
                gt_classes: Optional[torch.Tensor] = None,
                gt_valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                priorities: Optional[SamplingPriorities] = None
                ) -> DetectionOutputs:
        """(B, H, W, 3) blob -> DetectionOutputs. Without gt boxes,
        inference. With them (gt_boxes (B, G, 4) zero-padded, gt_classes
        (B, G), gt_valid (B, G)), training: the train-time proposals, the
        anchor and proposal targets, the head on the sampled RoIs, and
        `losses` {rpn_cls, rpn_reg, det_cls, det_reg}, each the mean over
        the images. The subsampling's priorities come from `generator`
        unless given."""
        if gt_boxes is None:
            return self.downstream(*self.upstream(images))
        c = self.cfg
        B, H, W, _ = images.shape
        feats, cls, reg, anchors = self._rpn(images)
        if priorities is None:
            priorities = self.draw_priorities(
                generator, B, feats.shape[1:3], gt_boxes.shape[1],
                images.device)
        with torch.no_grad():
            props = proposal_layer(
                cls.detach(), reg.detach(), anchors, (H, W),
                c.rpn_pre_nms_top_n_train, c.rpn_post_nms_top_n_train,
                c.rpn_nms_thresh, c.rpn_min_size)
            atargets = anchor_target_layer(
                anchors, gt_boxes, gt_valid, (H, W), c,
                (priorities.anchor_fg, priorities.anchor_bg))
            ptargets = proposal_target_layer(
                props.rois, props.valid, gt_boxes, gt_classes, gt_valid, c,
                (priorities.roi_fg, priorities.roi_bg))
        rpn_cls, rpn_reg = rpn_losses(cls, reg, atargets, 3.0)

        cls_logits, bbox_pred = self._head(feats, ptargets.rois)
        R = ptargets.rois.shape[1]
        # class-specific regression: each RoI's target-class deltas
        # (faster_rcnn.py:88-94)
        sel = torch.gather(
            bbox_pred.reshape(B, R, -1, 4), 2,
            ptargets.labels[:, :, None, None].expand(B, R, 1, 4))[:, :, 0]
        det_cls, det_reg = detection_head_losses(cls_logits, sel, ptargets)
        losses = {"rpn_cls": rpn_cls.mean(), "rpn_reg": rpn_reg.mean(),
                  "det_cls": det_cls.mean(), "det_reg": det_reg.mean()}
        return DetectionOutputs(
            rois=ptargets.rois, roi_valid=ptargets.valid,
            cls_scores=torch.softmax(cls_logits.float(), dim=-1),
            bbox_deltas=bbox_pred.float(), losses=losses)
