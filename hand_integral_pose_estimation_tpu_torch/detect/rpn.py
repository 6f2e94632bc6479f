"""Region proposal layer, anchor targets and the RPN losses.

Port of hand_integral_pose_estimation_tpu/detect/rpn.py (the reference's
rpn/proposal_layer.py:77-160, rpn/anchor_target_layer.py:48-194 and
rpn.py:84-108), batched over a leading image axis where the JAX package
vmaps. The RPN scores keep the reference's channel order, [bg x A,
fg x A] (rpn.py:63-76), so the foreground probability is the softmax over
each (bg, fg) pair taken at channels (a, A + a), and the classification
loss pairs the same channels.

The fixed-count subsampling draws one uniform priority per candidate and
keeps the `num` lowest-priority candidates of a mask (the JAX package's
`lax.top_k` of the negated priorities: ties keep the lower index, so a
stable sort). The priorities come from a `torch.Generator`, or are given
as tensors, so that a test can feed the draws of the JAX package's keys.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from hand_integral_pose_estimation_tpu_torch.config import DetectorConfig
from hand_integral_pose_estimation_tpu_torch.detect import box_ops
from hand_integral_pose_estimation_tpu_torch.ops.nms import box_iou, nms


class Proposals(NamedTuple):
    rois: torch.Tensor     # (B, post_nms_top_n, 4)
    scores: torch.Tensor   # (B, post_nms_top_n)
    valid: torch.Tensor    # (B, post_nms_top_n) bool


def rpn_pair_logits(cls_logits: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 2A) RPN logits, channels [bg x A, fg x A] -> (B, H*W*A, 2)
    float32 (bg, fg) pairs, row-major over (y, x, a) as the anchors."""
    B, H, W, C = cls_logits.shape
    A = C // 2
    return (cls_logits.float().reshape(B, H, W, 2, A).transpose(3, 4)
            .reshape(B, H * W * A, 2))


def fg_scores(cls_logits: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 2A) RPN logits, channels [bg x A, fg x A] -> (B, H*W*A)
    float32 foreground probabilities, row-major over (y, x, a)."""
    return torch.softmax(rpn_pair_logits(cls_logits), dim=-1)[..., 1]


def proposal_layer(cls_logits: torch.Tensor, deltas: torch.Tensor,
                   anchors: torch.Tensor, im_hw, pre_nms_top_n: int,
                   post_nms_top_n: int, nms_thresh: float = 0.7,
                   min_size: float = 8.0) -> Proposals:
    """Anchors + RPN outputs -> fixed-size proposals per image: the fg
    softmax, decode, clip, the min-size filter (scores of boxes narrower or
    shorter than `min_size` set to -1), the pre-NMS top-k by a stable
    descending sort (ties keep the lower index, as `lax.top_k`), and NMS
    with score threshold 0, which drops the filtered boxes.

    Args:
        cls_logits: (B, H, W, 2A), channels [bg x A, fg x A].
        deltas: (B, H, W, 4A), channels a * 4 + k.
        anchors: (H*W*A, 4) from box_ops.grid_anchors, the same (y, x, a)
            order.
        im_hw: the blob's (height, width), for clipping.
    """
    B = cls_logits.shape[0]
    N = anchors.shape[0]
    scores = fg_scores(cls_logits)
    boxes = box_ops.decode_boxes(anchors, deltas.float().reshape(B, N, 4))
    boxes = box_ops.clip_boxes(boxes, im_hw)
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    scores = torch.where((w >= min_size) & (h >= min_size), scores,
                         torch.full_like(scores, -1.0))
    k = min(pre_nms_top_n, N)
    top_scores, top_idx = torch.sort(scores, dim=1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(B, k, 4))
    rois, roi_scores, valid = nms(top_boxes, top_scores, nms_thresh,
                                  post_nms_top_n, score_threshold=0.0)
    return Proposals(rois=rois, scores=roi_scores, valid=valid)


class AnchorTargets(NamedTuple):
    labels: torch.Tensor        # (B, N) int64: 1 fg, 0 bg, -1 ignored
    bbox_targets: torch.Tensor  # (B, N, 4), zero off the foreground
    fg_mask: torch.Tensor       # (B, N) bool: the sampled positives
    sample_mask: torch.Tensor   # (B, N) bool: sampled for the class loss


def draw_priorities(generator: Optional[torch.Generator], shape,
                    device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two (shape) float32 tensors of uniform priorities, the foreground's
    then the background's, from `generator` (the device's default
    generator when None)."""
    return tuple(torch.rand(shape, generator=generator, device=device)
                 for _ in range(2))


def _subsample(mask: torch.Tensor, num: int,
               priorities: torch.Tensor) -> torch.Tensor:
    """Keep at most `num` True entries of each row of `mask`, those of the
    lowest priority (uniform draws, so a uniform choice; the fixed-shape
    analogue of npr.choice, anchor_target_layer.py:124-138)."""
    N = mask.shape[-1]
    pri = priorities + (~mask).to(priorities.dtype) * 10.0
    k = min(num, N)
    idx = torch.sort(pri, dim=-1, stable=True).indices[..., :k]
    sel = torch.zeros_like(mask).scatter(-1, idx, True)
    return sel & mask


def anchor_target_layer(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                        gt_valid: torch.Tensor, im_hw, cfg: DetectorConfig,
                        priorities: Tuple[torch.Tensor, torch.Tensor],
                        allowed_border: float = 0.0) -> AnchorTargets:
    """RPN training targets (anchor_target_layer.py:48-194): anchors inside
    the image only; positives are each gt box's best anchors (ties
    included) and anchors of IoU >= rpn_positive_overlap, negatives those
    below rpn_negative_overlap; `rpn_batch_size` are sampled with
    `rpn_fg_fraction` positives; the positives regress to their best gt
    box.

    Args:
        anchors: (N, 4). gt_boxes: (B, G, 4) zero-padded; gt_valid: (B, G).
        priorities: (fg, bg) uniform draws, each (B, N).
    """
    h, w = im_hw
    inside = ((anchors[:, 0] >= -allowed_border)
              & (anchors[:, 1] >= -allowed_border)
              & (anchors[:, 2] < w + allowed_border)
              & (anchors[:, 3] < h + allowed_border))
    iou = box_iou(anchors, gt_boxes)                            # (B, N, G)
    iou = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    max_iou = iou.amax(dim=2)
    argmax_gt = iou.argmax(dim=2)
    gt_best = torch.where(gt_valid, iou.amax(dim=1),
                          torch.full_like(iou[:, 0], 2.0))      # (B, G)
    is_gt_best = ((iou >= gt_best[:, None, :] - 1e-9).any(dim=2)
                  & (max_iou > 0))
    pos = inside & (is_gt_best | (max_iou >= cfg.rpn_positive_overlap))
    neg = inside & (max_iou < cfg.rpn_negative_overlap) & ~pos

    num_fg = int(cfg.rpn_fg_fraction * cfg.rpn_batch_size)
    fg_sel = _subsample(pos, num_fg, priorities[0])
    bg_sel = _subsample(neg, cfg.rpn_batch_size - num_fg, priorities[1])
    labels = torch.full_like(argmax_gt, -1)
    labels = torch.where(bg_sel, torch.zeros_like(labels), labels)
    labels = torch.where(fg_sel, torch.ones_like(labels), labels)

    matched = torch.gather(gt_boxes, 1,
                           argmax_gt[..., None].expand(*argmax_gt.shape, 4))
    targets = box_ops.encode_boxes(anchors, matched)
    targets = torch.where(fg_sel[..., None], targets,
                          torch.zeros_like(targets))
    return AnchorTargets(labels=labels, bbox_targets=targets, fg_mask=fg_sel,
                         sample_mask=fg_sel | bg_sel)


def smooth_l1(diff: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """Smooth-L1 with the reference's sigma parametrisation
    (utils/net_utils.py:71-85): quadratic inside |d| < 1 / sigma^2."""
    s2 = sigma * sigma
    ad = torch.abs(diff)
    return torch.where(ad < 1.0 / s2, 0.5 * s2 * diff * diff, ad - 0.5 / s2)


def rpn_losses(cls_logits: torch.Tensor, deltas: torch.Tensor,
               targets: AnchorTargets, sigma: float = 3.0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RPN cross-entropy and smooth-L1 per image (rpn.py:84-108), both
    divided by the image's sampled anchors. cls_logits (B, H, W, 2A) in the
    [bg x A, fg x A] order, deltas (B, H, W, 4A) -> ((B,), (B,)) float32."""
    B = cls_logits.shape[0]
    pairs = rpn_pair_logits(cls_logits)
    sample = targets.sample_mask
    n_sample = torch.clamp(sample.sum(-1), min=1)
    labels = torch.clamp(targets.labels, min=0)
    ce = -torch.gather(torch.log_softmax(pairs, dim=-1), 2,
                       labels[..., None])[..., 0]
    cls_loss = torch.where(sample, ce, torch.zeros_like(ce)).sum(-1) \
        / n_sample
    reg = deltas.float().reshape(B, -1, 4)
    l1 = smooth_l1(reg - targets.bbox_targets, sigma).sum(-1)
    reg_loss = torch.where(targets.fg_mask, l1, torch.zeros_like(l1)).sum(-1) \
        / n_sample
    return cls_loss, reg_loss
