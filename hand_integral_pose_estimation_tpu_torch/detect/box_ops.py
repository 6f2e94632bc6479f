"""Bounding-box math: delta encode / decode, clipping, anchor generation.

Port of hand_integral_pose_estimation_tpu/detect/box_ops.py (the
reference's rpn/bbox_transform.py:15-230 and rpn/generate_anchors.py:
44-55), with the legacy +1 width / height convention of that stack. Boxes
are (..., 4) xyxy tensors; the anchor enumeration is numpy.
"""

from __future__ import annotations

import numpy as np
import torch


def encode_boxes(anchors: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Box -> regression deltas (bbox_transform.py `bbox_transform`)."""
    aw = anchors[..., 2] - anchors[..., 0] + 1.0
    ah = anchors[..., 3] - anchors[..., 1] + 1.0
    ax = anchors[..., 0] + 0.5 * aw
    ay = anchors[..., 1] + 0.5 * ah
    gw = gt[..., 2] - gt[..., 0] + 1.0
    gh = gt[..., 3] - gt[..., 1] + 1.0
    gx = gt[..., 0] + 0.5 * gw
    gy = gt[..., 1] + 0.5 * gh
    return torch.stack([(gx - ax) / aw, (gy - ay) / ah,
                        torch.log(gw / aw), torch.log(gh / ah)], dim=-1)


#: max log-scale delta: exp(4.135) = 62.5x growth (torchvision's
#: log(1000/16) clamp); keeps untrained or huge regression outputs finite
_MAX_SCALE_DELTA = 4.135166556742356


def decode_boxes(anchors: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Deltas -> boxes (bbox_transform.py `bbox_transform_inv`)."""
    aw = anchors[..., 2] - anchors[..., 0] + 1.0
    ah = anchors[..., 3] - anchors[..., 1] + 1.0
    ax = anchors[..., 0] + 0.5 * aw
    ay = anchors[..., 1] + 0.5 * ah
    cx = deltas[..., 0] * aw + ax
    cy = deltas[..., 1] * ah + ay
    w = torch.exp(torch.clamp(deltas[..., 2], max=_MAX_SCALE_DELTA)) * aw
    h = torch.exp(torch.clamp(deltas[..., 3], max=_MAX_SCALE_DELTA)) * ah
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h,
                        cx + 0.5 * w - 1.0, cy + 0.5 * h - 1.0], dim=-1)


def clip_boxes(boxes: torch.Tensor, im_hw) -> torch.Tensor:
    """Clip to the image extent (bbox_transform.py `clip_boxes`)."""
    h, w = im_hw
    return torch.stack([boxes[..., 0].clamp(0.0, w - 1.0),
                        boxes[..., 1].clamp(0.0, h - 1.0),
                        boxes[..., 2].clamp(0.0, w - 1.0),
                        boxes[..., 3].clamp(0.0, h - 1.0)], dim=-1)


def generate_base_anchors(base_size: int = 16,
                          ratios=(0.5, 1.0, 2.0),
                          scales=(8, 16, 32)) -> np.ndarray:
    """(A, 4) float64 anchors around a base_size box at the origin
    (generate_anchors.py:44-55: ratio enumeration with rounded integer
    widths, then the scales innermost per ratio)."""
    base = np.array([0, 0, base_size - 1, base_size - 1], np.float64)
    w = base[2] - base[0] + 1
    h = base[3] - base[1] + 1
    cx = base[0] + 0.5 * (w - 1)
    cy = base[1] + 0.5 * (h - 1)
    out = []
    size = w * h
    for r in ratios:
        ws = np.round(np.sqrt(size / r))
        hs = np.round(ws * r)
        for s in scales:
            wss, hss = ws * s, hs * s
            out.append([cx - 0.5 * (wss - 1), cy - 0.5 * (hss - 1),
                        cx + 0.5 * (wss - 1), cy + 0.5 * (hss - 1)])
    return np.asarray(out, np.float64)


def grid_anchors(feat_hw, feat_stride: int = 16,
                 base_anchors: np.ndarray | None = None,
                 device: torch.device | str = "cpu") -> torch.Tensor:
    """All anchors over a feature grid, (H*W*A, 4) float32 on `device`,
    row-major over (y, x, a) (proposal_layer.py:85-100 shift
    enumeration)."""
    if base_anchors is None:
        base_anchors = generate_base_anchors()
    H, W = feat_hw
    X, Y = np.meshgrid(np.arange(W) * feat_stride, np.arange(H) * feat_stride)
    shifts = np.stack([X.ravel(), Y.ravel(), X.ravel(), Y.ravel()], axis=1)
    anchors = (base_anchors[None, :, :] + shifts[:, None, :]).reshape(-1, 4)
    return torch.from_numpy(anchors.astype(np.float32)).to(device)
