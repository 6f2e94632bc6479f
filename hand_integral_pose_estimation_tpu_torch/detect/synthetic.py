"""Synthetic box datasets for detector convergence studies.

A copy of hand_integral_pose_estimation_tpu/detect/synthetic.py (numpy
only), so the port imports nothing of the JAX package. Its clustered
scenes are also the detector's benchmark images: the proposal-NMS cost
depends on how clustered the near-duplicate proposals are, and random
pixels underestimate it.

The reference trains its hand detector in the upstream faster-rcnn codebase
on FreiHAND GT boxes (lib/datasets/freihand.py:53-64 reads
`freihand_bbox_gt_{split}.npy`, the tight box around the projected
keypoints) and ships only the trained checkpoint (common/hand_detector.py:
117-118). To prove the native training path actually *converges* — not just
that losses decrease over a few steps — we train on a synthetic dataset with
the same structure: one "hand" per image (a skin-toned textured blob with
finger-like strokes) over a cluttered background with non-hand distractor
shapes, and a tight GT box. VOC AP on a held-out split is the convergence
metric (lib/datasets/freihand_eval.py protocol).
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np

#: mean skin tone of the synthetic hand blob (RGB)
_SKIN = np.array([198.0, 146.0, 116.0])


class SyntheticBoxes(NamedTuple):
    images: np.ndarray            #: (N, H, W, 3) uint8 RGB
    gt_boxes: List[np.ndarray]    #: per image (G, 4) xyxy


def _paint_ellipse(img, cy, cx, ry, rx, color, rng, noise=18.0,
                   fingers=False):
    H, W = img.shape[:2]
    yy, xx = np.mgrid[:H, :W]
    mask = ((yy - cy) / max(ry, 1.0)) ** 2 + ((xx - cx) / max(rx, 1.0)) ** 2 <= 1.0
    if fingers:
        # finger-like strokes: narrow ellipses fanning off the top edge
        n_fingers = rng.randint(3, 6)
        for i in range(n_fingers):
            ang = (-0.6 + 1.2 * i / max(n_fingers - 1, 1)
                   + rng.uniform(-0.1, 0.1))
            fl = ry * rng.uniform(0.5, 0.9)
            fcy = cy - ry * 0.7 - fl * 0.5 * np.cos(ang)
            fcx = cx + (ry * 0.7 + fl * 0.5) * np.sin(ang)
            fr = max(rx * 0.18, 2.0)
            fmask = (((yy - fcy) * np.cos(ang) - (xx - fcx) * np.sin(ang))
                     / max(fl * 0.5, 1.0)) ** 2 + \
                    (((yy - fcy) * np.sin(ang) + (xx - fcx) * np.cos(ang))
                     / fr) ** 2 <= 1.0
            mask |= fmask
    tex = color + rng.normal(0, noise, (H, W, 3))
    img[mask] = tex[mask]
    return mask


def make_synthetic_box_dataset(n: int, hw: Tuple[int, int] = (224, 224),
                               min_size: int = 56, max_size: int = 150,
                               distractors: bool = True,
                               seed: int = 0) -> SyntheticBoxes:
    """N images, each with exactly one synthetic hand (GT box = tight mask
    bbox) plus 0-2 distractor shapes the detector must reject."""
    rng = np.random.RandomState(seed)
    H, W = hw
    images = np.zeros((n, H, W, 3), np.uint8)
    gt: List[np.ndarray] = []
    for i in range(n):
        base = rng.uniform(40, 160, 3)
        img = base + rng.normal(0, 20, (H, W, 3))

        if distractors:
            for _ in range(rng.randint(0, 3)):
                dc = rng.uniform(0, 255, 3)
                # keep distractors chromatically away from skin
                while np.abs(dc - _SKIN).sum() < 150:
                    dc = rng.uniform(0, 255, 3)
                dr = rng.uniform(10, 40)
                _paint_ellipse(img, rng.uniform(dr, H - dr),
                               rng.uniform(dr, W - dr), dr,
                               dr * rng.uniform(0.5, 1.6), dc, rng)

        size = rng.uniform(min_size, max_size)
        ry, rx = size / 2.0, size / 2.0 * rng.uniform(0.6, 1.0)
        cy = rng.uniform(size * 0.7, H - size * 0.4)
        cx = rng.uniform(size * 0.6, W - size * 0.6)
        mask = _paint_ellipse(img, cy, cx, ry, rx, _SKIN, rng, fingers=True)

        ys, xs = np.nonzero(mask)
        box = np.array([[max(xs.min(), 0), max(ys.min(), 0),
                         min(xs.max(), W - 1), min(ys.max(), H - 1)]],
                       np.float32)
        images[i] = np.clip(img, 0, 255).astype(np.uint8)
        gt.append(box)
    return SyntheticBoxes(images=images, gt_boxes=gt)


def flip_batch(images: np.ndarray, gt_boxes: np.ndarray,
               flip_mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Horizontal-flip augmentation, the roi_data_layer equivalent
    (lib/roi_data_layer/roidb.py append_flipped_images: the roidb is doubled
    with x1' = W - x2 - 1, x2' = W - x1 - 1). Fixed-shape per-sample variant:
    `flip_mask` (B,) selects which samples flip this batch."""
    W = images.shape[2]
    flipped = images[:, :, ::-1]
    images = np.where(flip_mask[:, None, None, None], flipped, images)
    fb = gt_boxes.copy()
    fb[..., 0] = W - gt_boxes[..., 2] - 1
    fb[..., 2] = W - gt_boxes[..., 0] - 1
    gt_boxes = np.where(flip_mask[:, None, None], fb, gt_boxes)
    return images, gt_boxes
