"""Region proposal layer: RPN outputs -> a fixed-size proposal set.

Port of `Proposals` and `proposal_layer` in
hand_integral_pose_estimation_tpu/detect/rpn.py (the reference's
rpn/proposal_layer.py:77-160), batched over a leading image axis where the
JAX package vmaps. The RPN scores keep the reference's channel order,
[bg x A, fg x A] (rpn.py:63-76), so the foreground probability is the
softmax over each (bg, fg) pair taken at channel A + a. Anchor targets and
the RPN losses belong to detector training and come with its port.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hand_integral_pose_estimation_tpu_torch.detect import box_ops
from hand_integral_pose_estimation_tpu_torch.ops.nms import nms


class Proposals(NamedTuple):
    rois: torch.Tensor     # (B, post_nms_top_n, 4)
    scores: torch.Tensor   # (B, post_nms_top_n)
    valid: torch.Tensor    # (B, post_nms_top_n) bool


def fg_scores(cls_logits: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 2A) RPN logits, channels [bg x A, fg x A] -> (B, H*W*A)
    float32 foreground probabilities, row-major over (y, x, a)."""
    B, H, W, C = cls_logits.shape
    A = C // 2
    pairs = cls_logits.float().reshape(B, H, W, 2, A)
    return torch.softmax(pairs, dim=3)[:, :, :, 1].reshape(B, H * W * A)


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
