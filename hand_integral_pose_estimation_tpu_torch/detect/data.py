"""Detector training data + VOC-style AP evaluation.

A copy of hand_integral_pose_estimation_tpu/detect/data.py (numpy only),
so the port imports nothing of the JAX package. Capability equivalent of
the reference's detector data infrastructure:
`lib/datasets/freihand.py:53-64` (the `freihand` imdb reading the GT-bbox db
derived from projected keypoints), `lib/roi_data_layer/**` (roidb/minibatch
assembly — here a fixed-shape batch builder since blobs are built on
the device; horizontal flipping via `flip_rng`) and
`lib/datasets/freihand_eval.py:109-209` (VOC-protocol AP).

For general (non-FreiHAND) variable-size image sets the roi_data_layer's
aspect-ratio grouping pipeline is provided too: `rank_aspect_ratios` /
`aspect_ratio_batches` (`lib/roi_data_layer/roidb.py:49-74`,
`roibatchLoader.py:37-54`) group ratio-similar images per batch, and
`crop_pad_to_ratio` (`roibatchLoader.py:85-177`) trims outliers around
their GT extent and zero-pads each group to one static shape — which is
exactly what a fixed-shape batch wants. FreiHAND itself is square
224x224, so the flagship pipeline never needs this path.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np


def gt_bbox_from_keypoints(uv: np.ndarray, margin: float = 0.0
                           ) -> np.ndarray:
    """Tight xyxy GT box around projected keypoints — how the reference built
    its `freihand_bbox_gt_{split}.npy` detector ground truth."""
    x1 = uv[..., 0].min(axis=-1) - margin
    y1 = uv[..., 1].min(axis=-1) - margin
    x2 = uv[..., 0].max(axis=-1) + margin
    y2 = uv[..., 1].max(axis=-1) + margin
    return np.stack([x1, y1, x2, y2], axis=-1)


class DetectorBatch(NamedTuple):
    images: np.ndarray      # (B, H, W, 3) RGB uint8
    gt_boxes: np.ndarray    # (B, G, 4) xyxy, zero-padded
    gt_classes: np.ndarray  # (B, G) int (1 = hand)
    gt_valid: np.ndarray    # (B, G) bool


def build_detector_batch(dataset, indices: Sequence[int],
                         max_gt: int = 1,
                         flip_rng: "np.random.RandomState | None" = None
                         ) -> DetectorBatch:
    """Host batch for detector training: images + GT hand boxes projected
    from the pose annotations (one hand per FreiHAND image).

    `flip_rng` enables the roi_data_layer horizontal-flip augmentation
    (lib/roi_data_layer/roidb.py append_flipped_images — the reference
    doubles the roidb with flipped copies; here each sample flips with
    p=0.5 per batch, the same marginal distribution without doubling
    host memory)."""
    host = dataset.host_batch(np.asarray(indices))
    imgs = host["image"]
    B = imgs.shape[0]
    jc = host["joint_cam"]
    K = host["K"]
    uv = np.einsum("bij,bnj->bni", K, jc)
    uv = uv[..., :2] / uv[..., 2:3]
    boxes = gt_bbox_from_keypoints(uv)[:, None, :]   # (B, 1, 4)

    gt_boxes = np.zeros((B, max_gt, 4), np.float32)
    gt_boxes[:, :1] = boxes
    gt_classes = np.zeros((B, max_gt), np.int32)
    gt_classes[:, 0] = 1
    gt_valid = np.zeros((B, max_gt), bool)
    gt_valid[:, 0] = True
    if flip_rng is not None:
        from hand_integral_pose_estimation_tpu_torch.detect.synthetic import (
            flip_batch,
        )
        imgs, gt_boxes = flip_batch(imgs, gt_boxes, flip_rng.rand(B) < 0.5)
    return DetectorBatch(images=imgs, gt_boxes=gt_boxes,
                         gt_classes=gt_classes, gt_valid=gt_valid)


def rank_aspect_ratios(widths: Sequence[int], heights: Sequence[int],
                       ratio_lo: float = 0.5, ratio_hi: float = 2.0
                       ) -> tuple:
    """Rank images by aspect ratio for grouped batching
    (`lib/roi_data_layer/roidb.py:49-74` rank_roidb_ratio): ratios are
    clamped to [ratio_lo, ratio_hi] and images outside that band are marked
    `need_crop`. Returns (ratio_list, ratio_index, need_crop) with
    ratio_list sorted ascending and ratio_index the argsort order."""
    w = np.asarray(widths, np.float64)
    h = np.asarray(heights, np.float64)
    ratio = w / h
    need_crop = (ratio < ratio_lo) | (ratio > ratio_hi)
    ratio = np.clip(ratio, ratio_lo, ratio_hi)
    order = np.argsort(ratio, kind="stable")
    return ratio[order], order, need_crop[order]


def aspect_ratio_batches(ratio_list: np.ndarray, ratio_index: np.ndarray,
                         batch_size: int) -> list:
    """Split ratio-ranked images into batches sharing one target ratio
    (`roibatchLoader.py:37-54`): a batch entirely below ratio 1 adopts its
    leftmost (most extreme) ratio, entirely above 1 its rightmost, and a
    batch crossing 1 targets exactly 1. Returns [(indices, target_ratio)]
    covering every image (the last batch may be short)."""
    out = []
    n = len(ratio_list)
    for left in range(0, n, batch_size):
        right = min(left + batch_size, n) - 1
        if ratio_list[right] < 1:
            target = float(ratio_list[left])
        elif ratio_list[left] > 1:
            target = float(ratio_list[right])
        else:
            target = 1.0
        out.append((np.asarray(ratio_index[left:right + 1]), target))
    return out


def crop_pad_to_ratio(image: np.ndarray, gt_boxes: np.ndarray,
                      target_ratio: float, need_crop: bool,
                      rng: "np.random.RandomState | None" = None) -> tuple:
    """Bring one (H, W, C) image to `target_ratio` the roibatchLoader way
    (`roibatchLoader.py:85-177`): if it needs cropping, trim the long axis
    to the target ratio with the window placed to keep the GT-box extent
    (uniformly jittered inside the feasible range when `rng` is given,
    centred otherwise — the reference always jitters), shifting and
    clamping the boxes; then zero-pad the short axis out to the ratio.
    Returns (padded_image, boxes, (valid_h, valid_w))."""
    img = np.asarray(image)
    boxes = np.array(gt_boxes, np.float32, copy=True)
    H, W = img.shape[:2]

    def _window(lo_edge: float, hi_edge: float, extent: int, trim: int
                ) -> int:
        # feasible crop start keeping [lo_edge, hi_edge] visible
        region = hi_edge - lo_edge + 1
        if region < trim:
            s_min = int(max(hi_edge - trim, 0))
            s_max = int(min(lo_edge, extent - trim))
            if s_min > s_max:           # degenerate boxes: clamp
                return int(np.clip(lo_edge, 0, extent - trim))
            if rng is not None:
                return int(rng.randint(s_min, s_max + 1))
            return (s_min + s_max) // 2
        # box region larger than the window: centre on it (:109-113,:144-148)
        add = int((region - trim) / 2)
        return int(np.clip(lo_edge + add, 0, extent - trim))

    if need_crop:
        if target_ratio < 1:            # W << H: crop height (:89-124)
            trim = min(int(np.floor(W / target_ratio)), H)
            y_s = _window(boxes[:, 1].min(), boxes[:, 3].max(), H, trim)
            img = img[y_s:y_s + trim]
            boxes[:, [1, 3]] = np.clip(boxes[:, [1, 3]] - y_s, 0, trim - 1)
            H = trim
        elif target_ratio > 1:          # W >> H: crop width (:125-160)
            trim = min(int(np.ceil(H * target_ratio)), W)
            x_s = _window(boxes[:, 0].min(), boxes[:, 2].max(), W, trim)
            img = img[:, x_s:x_s + trim]
            boxes[:, [0, 2]] = np.clip(boxes[:, [0, 2]] - x_s, 0, trim - 1)
            W = trim

    # pad the short axis out to the ratio (:162-177)
    if target_ratio < 1:
        out_h, out_w = int(np.ceil(W / target_ratio)), W
    elif target_ratio > 1:
        out_h, out_w = H, int(np.ceil(H * target_ratio))
    else:
        side = max(H, W)
        out_h = out_w = side
    out_h, out_w = max(out_h, H), max(out_w, W)
    padded = np.zeros((out_h, out_w) + img.shape[2:], img.dtype)
    padded[:H, :W] = img
    return padded, boxes, (H, W)


def build_grouped_batches(images: Sequence[np.ndarray],
                          gt_boxes: Sequence[np.ndarray],
                          batch_size: int,
                          rng: "np.random.RandomState | None" = None,
                          ratio_lo: float = 0.5, ratio_hi: float = 2.0
                          ) -> list:
    """Assemble variable-size images into aspect-grouped, fixed-shape
    detector batches — the whole roibatchLoader pipeline in one call. Each
    batch's images are cropped/padded to the group ratio and then padded to
    the group's max extents so the batch is one dense (B, H, W, C) array
    (what the reference's DataLoader collation required and a fixed-shape batch
    requires anyway). Returns [(indices, batch_images, batch_boxes,
    im_info)] with im_info (B, 2) = valid (h, w) per image."""
    heights = [im.shape[0] for im in images]
    widths = [im.shape[1] for im in images]
    ratio_list, ratio_index, need_crop = rank_aspect_ratios(
        widths, heights, ratio_lo, ratio_hi)
    batches = []
    for pos, (idx, target) in enumerate(
            aspect_ratio_batches(ratio_list, ratio_index, batch_size)):
        base = pos * batch_size
        shaped = [
            crop_pad_to_ratio(images[i], gt_boxes[i], target,
                              bool(need_crop[base + k]), rng=rng)
            for k, i in enumerate(idx)]
        max_h = max(s[0].shape[0] for s in shaped)
        max_w = max(s[0].shape[1] for s in shaped)
        imgs = np.zeros((len(idx), max_h, max_w) + images[0].shape[2:],
                        shaped[0][0].dtype)
        info = np.zeros((len(idx), 2), np.int32)
        boxes = []
        for k, (im, bx, (vh, vw)) in enumerate(shaped):
            imgs[k, :im.shape[0], :im.shape[1]] = im
            info[k] = (vh, vw)
            boxes.append(bx)
        batches.append((idx, imgs, boxes, info))
    return batches


def voc_ap(recall: np.ndarray, precision: np.ndarray,
           use_07_metric: bool = False) -> float:
    """VOC AP from a recall/precision curve (freihand_eval.py /
    the standard VOC protocol): 11-point interpolation or the exact
    area-under-envelope form."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = precision[recall >= t].max() if (recall >= t).any() else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]).sum())


def evaluate_detections(det_boxes: Sequence[np.ndarray],
                        det_scores: Sequence[np.ndarray],
                        gt_boxes: Sequence[np.ndarray],
                        iou_threshold: float = 0.5,
                        use_07_metric: bool = False) -> dict:
    """VOC-protocol detection evaluation for the single `hand` class
    (freihand_eval.py:109-209): greedy matching of score-ranked detections
    to unclaimed GT boxes at the IoU threshold; returns AP, precision and
    recall arrays.

    Args:
        det_boxes[i]: (Di, 4) detections of image i; det_scores[i]: (Di,).
        gt_boxes[i]: (Gi, 4).
    """
    records = []
    npos = 0
    for i, (db, ds) in enumerate(zip(det_boxes, det_scores)):
        npos += len(gt_boxes[i])
        for b, s in zip(db, ds):
            records.append((float(s), i, b))
    records.sort(key=lambda r: -r[0])

    claimed = {i: np.zeros(len(g), bool) for i, g in enumerate(gt_boxes)}
    tp = np.zeros(len(records))
    fp = np.zeros(len(records))
    for k, (s, i, b) in enumerate(records):
        gts = gt_boxes[i]
        if len(gts) == 0:
            fp[k] = 1
            continue
        ix1 = np.maximum(gts[:, 0], b[0])
        iy1 = np.maximum(gts[:, 1], b[1])
        ix2 = np.minimum(gts[:, 2], b[2])
        iy2 = np.minimum(gts[:, 3], b[3])
        iw = np.maximum(ix2 - ix1 + 1, 0)
        ih = np.maximum(iy2 - iy1 + 1, 0)
        inter = iw * ih
        union = ((b[2] - b[0] + 1) * (b[3] - b[1] + 1)
                 + (gts[:, 2] - gts[:, 0] + 1) * (gts[:, 3] - gts[:, 1] + 1)
                 - inter)
        ious = inter / np.maximum(union, 1e-12)
        j = int(ious.argmax())
        if ious[j] > iou_threshold and not claimed[i][j]:
            tp[k] = 1
            claimed[i][j] = True
        else:
            fp[k] = 1

    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    recall = tp_cum / max(npos, 1)
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
    ap = voc_ap(recall, precision, use_07_metric)
    return {"ap": ap, "recall": recall, "precision": precision,
            "num_gt": npos, "num_det": len(records)}
