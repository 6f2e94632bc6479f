"""Detector-produced crop-box db for the label-free split and the
use_hand_detector training mode.

Port of hand_integral_pose_estimation_tpu/data/detector_db.py. The
reference computes a detector crop box per image when it loads the
evaluation split (`load_evaluation_data`, FreiHand.py:286-341, through
`find_bb_hand_detector`, augment.py:317-342) and caches per-image detector
boxes in the training db when `use_hand_detector` is on
(FreiHand.py:382-409, 468-470). Here one batched sweep of
`detect_hand_crop_bbox` fills an npz cache keyed by image name.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from hand_integral_pose_estimation_tpu_torch.config import DetectorConfig
from hand_integral_pose_estimation_tpu_torch.data.freihand import (
    padded_batches,
)
from hand_integral_pose_estimation_tpu_torch.detect.hand_detector import (
    detect_hand_crop_bbox,
)


def generate_detector_bboxes(dataset, detector,
                             det_cfg: Optional[DetectorConfig] = None,
                             pad_factor: float = 1.75,
                             batch_size: int = 16) -> np.ndarray:
    """Run the detector over every record of `dataset` (in record order) on
    the detector's device and return (N, 4) float32 square + padded crop
    boxes (cx, cy, w, h). The tail batch is padded by repeating its last
    sample and the padding rows dropped."""
    device = next(detector.parameters()).device
    n = len(dataset)
    out = []
    for idx in padded_batches(n, batch_size):
        images = torch.from_numpy(np.ascontiguousarray(
            dataset.host_batch(idx)["image"])).to(device)
        out.append(detect_hand_crop_bbox(detector, images, det_cfg,
                                         pad_factor=pad_factor).cpu().numpy())
    return np.concatenate(out)[:n].astype(np.float32)


def _record_names(dataset) -> np.ndarray:
    if hasattr(dataset, "records"):
        return np.asarray([os.path.basename(r.img_path)
                           for r in dataset.records])
    if hasattr(dataset, "record_names"):
        return np.asarray(dataset.record_names())
    return np.asarray([str(i) for i in range(len(dataset))])


def save_bbox_db(path: str, dataset, bboxes: np.ndarray) -> str:
    """Persist the per-image crop boxes (the npz analogue of the reference's
    detector-box pickle cache, FreiHand.py:382-409): boxes in record order
    and the record names, checked when the db is attached."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, bbox=np.asarray(bboxes, np.float32),
             name=_record_names(dataset))
    return path


def load_bbox_db(path: str) -> tuple[np.ndarray, np.ndarray]:
    """-> (names, bboxes)."""
    db = np.load(path)
    return db["name"], db["bbox"]


def attach_detector_bboxes(dataset, bboxes: np.ndarray,
                           names: Optional[np.ndarray] = None):
    """Give every record its detector crop box (record order): `host_batch`
    then emits `bbox_detector`, and the eval crop uses it instead of the
    box of the projected GT joints (FreiHand.py:468-470). A db made for
    another record set or order raises."""
    bboxes = np.asarray(bboxes, np.float32)
    if len(bboxes) != len(dataset):
        raise ValueError(f"{len(bboxes)} crop boxes for {len(dataset)} "
                         f"records")
    if names is not None and not np.array_equal(np.asarray(names),
                                                _record_names(dataset)):
        raise ValueError(
            "bbox db was generated for a different record set/order")
    if hasattr(dataset, "records"):
        for r, bb in zip(dataset.records, bboxes):
            r.detector_bbox = bb
    else:
        dataset.detector_bbox = bboxes
    return dataset


def ensure_detector_bboxes(dataset, detector,
                           cache_path: Optional[str] = None,
                           det_cfg: Optional[DetectorConfig] = None,
                           pad_factor: float = 1.75,
                           batch_size: int = 16):
    """Attach detector crop boxes, reusing `cache_path` when it matches the
    dataset and sweeping the detector (then saving the cache) otherwise:
    the load-or-rebuild behaviour of the reference's pickle caches
    (FreiHand.py:286-293, 382-388). A missing or stale cache without a
    detector raises."""
    if cache_path and os.path.exists(cache_path):
        names, bboxes = load_bbox_db(cache_path)
        try:
            return attach_detector_bboxes(dataset, bboxes, names)
        except ValueError:
            pass   # made for another record set: regenerate below
    if detector is None:
        raise ValueError(
            f"bbox cache {cache_path!r} is missing or stale and no detector "
            f"was provided to regenerate it")
    bboxes = generate_detector_bboxes(dataset, detector, det_cfg, pad_factor,
                                      batch_size)
    if cache_path:
        save_bbox_db(cache_path, dataset, bboxes)
    return attach_detector_bboxes(dataset, bboxes)
