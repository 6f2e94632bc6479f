"""Hand-detector facade: RGB images -> fixed-size hand boxes and crop boxes.

Port of hand_integral_pose_estimation_tpu/detect/hand_detector.py (the
reference's common/hand_detector.py:47-246): blob preparation (BGR, pixel
means, single-scale resize to a short side of 600 and a long side of at
most 1000), the Faster R-CNN forward, the std-denormalised class-1 delta
decode and clip, score threshold 0.001, class NMS at 0.3 into
`max_detections` slots, and `detect_hand_crop_bbox`, the caller's
best-box -> square -> pad x1.75 crop box (augment.py:317-342).

Every function takes a batch and runs on the device of its images; the
outputs are fixed-size with a validity mask instead of the reference's
variable-length `cls_dets`. `detect_split` runs the detector's `upstream`
and `downstream` halves as two calls, for API parity with the JAX package,
where the split avoids an XLA composition loss; eagerly the two are the
same work.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from hand_integral_pose_estimation_tpu_torch.config import DetectorConfig
from hand_integral_pose_estimation_tpu_torch.data.pipeline import (
    channel_constant,
)
from hand_integral_pose_estimation_tpu_torch.detect import box_ops
from hand_integral_pose_estimation_tpu_torch.detect.faster_rcnn import (
    DetectionOutputs,
    FasterRCNN,
)
from hand_integral_pose_estimation_tpu_torch.geometry import bbox as bbox_mod
from hand_integral_pose_estimation_tpu_torch.ops.nms import nms
from hand_integral_pose_estimation_tpu_torch.ops.warp import (
    warp_axis_aligned_batch,
)


class Detections(NamedTuple):
    boxes: torch.Tensor    # (B, max_detections, 4) xyxy, image coordinates
    scores: torch.Tensor   # (B, max_detections)
    valid: torch.Tensor    # (B, max_detections) bool


def _blob_scale(im_hw, target: int, max_size: int) -> float:
    h, w = im_hw
    scale = target / min(h, w)
    if scale * max(h, w) > max_size:
        scale = max_size / max(h, w)
    return scale


def prepare_blob(images_rgb: torch.Tensor, cfg: DetectorConfig):
    """(B, H, W, 3) RGB images, uint8 or float -> (float32 BGR blob with
    the pixel means subtracted, resized to the test scale; scale)
    (hand_detector.py:78-109, utils/blob.py:20-49). The resize is a pure
    scale, so it takes the axis-aligned two-matmul warp; at scale 1 it is
    skipped."""
    B, H, W, _ = images_rgb.shape
    scale = _blob_scale((H, W), cfg.test_scale, cfg.test_max_size)
    oh, ow = int(round(H * scale)), int(round(W * scale))
    bgr = images_rgb.flip(-1).float()
    bgr = bgr - channel_constant(cfg.pixel_means, bgr)
    if (oh, ow) == (H, W):
        return bgr, scale
    Hm = torch.eye(3, dtype=torch.float32, device=bgr.device)
    Hm[0, 0] = scale
    Hm[1, 1] = scale
    blob = warp_axis_aligned_batch(bgr, Hm.expand(B, 3, 3), (oh, ow))
    return blob, scale


def _postprocess(out: DetectionOutputs, cfg: DetectorConfig, blob_hw,
                 scale: float) -> Detections:
    """Decode the class-1 ("hand") deltas -> clip to the blob -> rescale to
    the original image -> threshold -> class NMS -> fixed top-K
    (hand_detector.py:200-246)."""
    B, R = out.rois.shape[0], out.rois.shape[1]
    stds = channel_constant(cfg.bbox_normalize_stds, out.bbox_deltas)
    means = channel_constant(cfg.bbox_normalize_means, out.bbox_deltas)
    deltas = out.bbox_deltas.reshape(B, R, len(cfg.classes), 4)[:, :, 1]
    deltas = deltas * stds + means
    boxes = box_ops.decode_boxes(out.rois, deltas)
    boxes = box_ops.clip_boxes(boxes, blob_hw) / scale
    scores = out.cls_scores[..., 1]
    scores = torch.where(out.roi_valid, scores, torch.zeros_like(scores))
    b, s, v = nms(boxes, scores, cfg.det_nms_thresh, cfg.max_detections,
                  score_threshold=cfg.det_score_thresh)
    return Detections(boxes=b, scores=s, valid=v)


@torch.inference_mode()
def detect(model: FasterRCNN, images_rgb: torch.Tensor,
           cfg: Optional[DetectorConfig] = None) -> Detections:
    """Full two-stage detection (hand_detector.py:160-246): blob ->
    forward -> decode -> clip -> rescale -> threshold -> class NMS. Runs on
    the device of `images_rgb`, where the model must live."""
    cfg = cfg or model.cfg
    blob, scale = prepare_blob(images_rgb, cfg)
    out = model(blob)
    return _postprocess(out, cfg, blob.shape[1:3], scale)


@torch.inference_mode()
def detect_split(model: FasterRCNN, images_rgb: torch.Tensor,
                 cfg: Optional[DetectorConfig] = None) -> Detections:
    """`detect` as two calls, `upstream` (blob -> base -> RPN -> proposals)
    then `downstream` (ROIAlign -> tail -> heads) and the class NMS: the
    same outputs as `detect`."""
    cfg = cfg or model.cfg
    blob, scale = prepare_blob(images_rgb, cfg)
    feats, rois, valid = model.upstream(blob)
    out = model.downstream(feats, rois, valid)
    return _postprocess(out, cfg, blob.shape[1:3], scale)


def _crop_from_detections(det: Detections, orig_hw,
                          pad_factor: float) -> torch.Tensor:
    """Best-score detection -> square + padded crop box (cx, cy, w, h)
    (augment.py:317-342 `find_bb_hand_detector`). Without a valid detection
    (or with a degenerate best box) the square full-image crop stands in,
    so the crop and back-projection downstream stay finite."""
    packed = torch.cat([det.boxes, det.scores[..., None]], dim=-1)
    crop = bbox_mod.bbox_from_detection(packed, pad_factor=pad_factor)
    H, W = orig_hw
    full = bbox_mod.scale_bbox(
        channel_constant((W / 2.0, H / 2.0, float(W), float(H)), crop),
        pad_factor=1.0)
    ok = ((det.scores.amax(dim=-1) > 0.0)
          & (crop[:, 2] > 0.0) & (crop[:, 3] > 0.0))
    return torch.where(ok[:, None], crop, full[None, :])


def detect_hand_crop_bbox(model: FasterRCNN, images_rgb: torch.Tensor,
                          cfg: Optional[DetectorConfig] = None,
                          pad_factor: float = 1.75,
                          split: bool = False) -> torch.Tensor:
    """(B, H, W, 3) RGB images -> (B, 4) square + padded crop boxes
    (cx, cy, w, h), the boxes the pose stage crops with (augment.py:317-342).
    `split=True` runs the detector as `detect_split`."""
    H, W = int(images_rgb.shape[1]), int(images_rgb.shape[2])
    det = (detect_split if split else detect)(model, images_rgb, cfg)
    return _crop_from_detections(det, (H, W), pad_factor)
