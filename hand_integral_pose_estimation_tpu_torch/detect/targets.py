"""Proposal-target sampling and the detection head's losses.

Port of hand_integral_pose_estimation_tpu/detect/targets.py (the
reference's rpn/proposal_target_layer_cascade.py:33-213 and
faster_rcnn.py:96-104), batched over a leading image axis where the JAX
package vmaps: the gt boxes join the proposals, `roi_batch_size` RoIs are
sampled with `roi_fg_fraction` foreground (IoU >= roi_fg_thresh) and
background in [roi_bg_thresh_lo, roi_bg_thresh_hi), compacted foreground
first into fixed slots (the rest zero-padded and masked out), and the
regression targets are normalised by the configured means and stds
(config_rcnn.py:76-119).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from hand_integral_pose_estimation_tpu_torch.config import DetectorConfig
from hand_integral_pose_estimation_tpu_torch.detect import box_ops
from hand_integral_pose_estimation_tpu_torch.detect.rpn import (
    _subsample,
    smooth_l1,
)
from hand_integral_pose_estimation_tpu_torch.ops.nms import box_iou


class ProposalTargets(NamedTuple):
    rois: torch.Tensor          # (B, roi_batch_size, 4)
    labels: torch.Tensor        # (B, roi_batch_size) int64 class (0 = bg)
    bbox_targets: torch.Tensor  # (B, roi_batch_size, 4) normalised deltas
    fg_mask: torch.Tensor       # (B, roi_batch_size) bool
    valid: torch.Tensor         # (B, roi_batch_size) bool: sampled slots


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) gathered along axis 1 at idx (B, K)."""
    return torch.gather(x, 1, idx.reshape(*idx.shape, *(1,) * (x.dim() - 2))
                        .expand(*idx.shape, *x.shape[2:]))


def proposal_target_layer(rois: torch.Tensor, roi_valid: torch.Tensor,
                          gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                          gt_valid: torch.Tensor, cfg: DetectorConfig,
                          priorities: Tuple[torch.Tensor, torch.Tensor]
                          ) -> ProposalTargets:
    """Sample the detection head's training RoIs.

    Args:
        rois: (B, R, 4) proposals, zero-padded; roi_valid: (B, R).
        gt_boxes: (B, G, 4); gt_classes: (B, G) int; gt_valid: (B, G).
        priorities: (fg, bg) uniform draws, each (B, R + G).
    """
    cand = torch.cat([rois, gt_boxes], dim=1)
    cand_valid = torch.cat([roi_valid, gt_valid], dim=1)
    N = cand.shape[1]

    iou = box_iou(cand, gt_boxes)                               # (B, N, G)
    iou = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    max_iou = torch.where(cand_valid, iou.amax(dim=2),
                          torch.full_like(iou[..., 0], -1.0))
    argmax_gt = iou.argmax(dim=2)

    fg = max_iou >= cfg.roi_fg_thresh
    bg = (max_iou < cfg.roi_bg_thresh_hi) & (max_iou >= cfg.roi_bg_thresh_lo)
    num_fg = int(cfg.roi_fg_fraction * cfg.roi_batch_size)
    fg_sel = _subsample(fg, num_fg, priorities[0])
    bg_sel = _subsample(bg, cfg.roi_batch_size - num_fg, priorities[1])
    sel = fg_sel | bg_sel

    # compact the selected candidates into the fixed slots, fg first; the
    # ranks are distinct, so the order is the JAX package's
    rank = (torch.where(fg_sel, 0, torch.where(bg_sel, 1, 2)) * N
            + torch.arange(N, device=cand.device))
    order = torch.argsort(rank, dim=1)[:, :cfg.roi_batch_size]
    out_rois = _take(cand, order)
    out_fg = torch.gather(fg_sel, 1, order)
    out_valid = torch.gather(sel, 1, order)
    matched = torch.gather(argmax_gt, 1, order)

    labels = torch.where(out_fg, torch.gather(gt_classes.long(), 1, matched),
                         torch.zeros_like(matched))
    targets = box_ops.encode_boxes(out_rois, _take(gt_boxes, matched))
    means = torch.tensor(cfg.bbox_normalize_means, dtype=targets.dtype,
                         device=targets.device)
    stds = torch.tensor(cfg.bbox_normalize_stds, dtype=targets.dtype,
                        device=targets.device)
    targets = (targets - means) / stds
    targets = torch.where(out_fg[..., None], targets,
                          torch.zeros_like(targets))
    return ProposalTargets(rois=out_rois, labels=labels,
                           bbox_targets=targets, fg_mask=out_fg,
                           valid=out_valid)


def detection_head_losses(cls_logits: torch.Tensor, bbox_pred: torch.Tensor,
                          targets: ProposalTargets, sigma: float = 1.0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The detection head's cross-entropy and smooth-L1 per image
    (faster_rcnn.py:96-104), both divided by the image's sampled RoIs.
    cls_logits (B, R, K), bbox_pred (B, R, 4) the deltas of each RoI's
    target class -> ((B,), (B,)) float32."""
    n = torch.clamp(targets.valid.sum(-1), min=1)
    ce = -torch.gather(torch.log_softmax(cls_logits.float(), dim=-1), 2,
                       targets.labels[..., None])[..., 0]
    cls_loss = torch.where(targets.valid, ce, torch.zeros_like(ce)).sum(-1) \
        / n
    l1 = smooth_l1(bbox_pred.float() - targets.bbox_targets, sigma).sum(-1)
    reg_loss = torch.where(targets.fg_mask, l1, torch.zeros_like(l1)).sum(-1) \
        / n
    return cls_loss, reg_loss
