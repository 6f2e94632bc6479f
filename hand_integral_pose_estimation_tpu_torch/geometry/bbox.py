"""Keypoint- and detector-driven crop boxes, (cx, cy, w, h).

Port of hand_integral_pose_estimation_tpu/geometry/bbox.py (reference
common/augment.py:282-356).
"""

from __future__ import annotations

import torch

_MAX_COORD = 10000.0


def kpt_bound(uv: torch.Tensor, vis: torch.Tensor):
    """Extent of the visible keypoints (augment.py:282-298
    `calc_kpt_bound`): (top, bottom, left, right).

    Args:
        uv: (..., N, 2) pixel coordinates.
        vis: (..., N) visibility, 0 = skip.
    """
    visible = vis > 0
    x, y = uv[..., 0], uv[..., 1]
    big = torch.full_like(x, _MAX_COORD)
    neg = torch.full_like(x, -1.0)
    u = torch.where(visible, y, big).amin(dim=-1)
    d = torch.where(visible, y, neg).amax(dim=-1)
    l = torch.where(visible, x, big).amin(dim=-1)
    r = torch.where(visible, x, neg).amax(dim=-1)
    return u, d, l, r


def scale_bbox(bbox: torch.Tensor, aspect_ratio: float = 1.0,
               pad_factor: float = 1.75) -> torch.Tensor:
    """Square the box to `aspect_ratio`, then pad (augment.py:344-356)."""
    cx, cy, w, h = bbox.unbind(-1)
    h_new = torch.where(w > aspect_ratio * h, w / aspect_ratio, h)
    w_new = torch.where(w < aspect_ratio * h, h * aspect_ratio, w)
    return torch.stack([cx, cy, w_new * pad_factor, h_new * pad_factor], dim=-1)


def bbox_from_keypoints(uv: torch.Tensor, vis: torch.Tensor,
                        aspect_ratio: float = 1.0,
                        pad_factor: float = 1.75) -> torch.Tensor:
    """GT crop box from projected joints (augment.py:300-315 `find_bb`)."""
    u, d, l, r = kpt_bound(uv, vis)
    bbox = torch.stack([(l + r) * 0.5, (u + d) * 0.5, r - l, d - u], dim=-1)
    return scale_bbox(bbox, aspect_ratio=aspect_ratio, pad_factor=pad_factor)


def bbox_from_detection(boxes_xyxy_score: torch.Tensor,
                        aspect_ratio: float = 1.0,
                        pad_factor: float = 1.75) -> torch.Tensor:
    """Crop box from detector output (augment.py:317-342
    `find_bb_hand_detector`): the highest-scoring (x1, y1, x2, y2, score)
    box of (..., K, 5), centre by floor division, squared and padded."""
    best = boxes_xyxy_score[..., 4].argmax(dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 5))
    box = torch.gather(boxes_xyxy_score, -2, idx)[..., 0, :]
    x1, y1, x2, y2 = box[..., 0], box[..., 1], box[..., 2], box[..., 3]
    bbox = torch.stack([torch.floor((x1 + x2) / 2.0),
                        torch.floor((y1 + y2) / 2.0), x2 - x1, y2 - y1], dim=-1)
    return scale_bbox(bbox, aspect_ratio=aspect_ratio, pad_factor=pad_factor)


def tprime_from_bbox(bbox: torch.Tensor, K: torch.Tensor,
                     scaling_constant: float = 100.0) -> torch.Tensor:
    """Canonical-depth scale tprime = c * f / L with L the larger box side,
    fx when the width is the larger side, else fy (augment.py:387-394)."""
    w, h = bbox[..., 2], bbox[..., 3]
    L = torch.maximum(w, h)
    f = torch.where(L == w, K[..., 0, 0], K[..., 1, 1])
    return scaling_constant * f / L
