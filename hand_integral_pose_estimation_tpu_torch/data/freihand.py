"""Host-side dataset plumbing: the synthetic FreiHAND stand-in, the padded
sweep helper and host-batch stacking.

Numpy-only code copied from hand_integral_pose_estimation_tpu/data/
freihand.py, because that package's `data/__init__.py` imports jax. The
file-backed `FreiHandDataset` (annotation loading, JPEG decode) waits for
the input-path port.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class SampleRecord:
    """One annotated sample (the fields `stack_host_batch` reads)."""

    img_path: str
    K: np.ndarray                 # (3, 3)
    joint_cam: np.ndarray         # (21, 3)
    ref_bone_len: float
    labelled: bool
    version: str
    idx: int
    detector_bbox: Optional[np.ndarray] = None       # (4,) cx, cy, w, h
    teacher_cam_normalized: Optional[np.ndarray] = None


def stack_host_batch(recs: list[SampleRecord],
                     images: list[np.ndarray]) -> dict:
    """Fixed-shape numpy arrays of one batch, ready for the device."""
    has_det = all(r.detector_bbox is not None for r in recs)
    has_teacher = all(r.teacher_cam_normalized is not None for r in recs)
    return {
        "image": np.stack(images).astype(np.uint8),
        "joint_cam": np.stack([r.joint_cam for r in recs]).astype(np.float32),
        "K": np.stack([r.K for r in recs]).astype(np.float32),
        "ref_bone_len": np.asarray([r.ref_bone_len for r in recs],
                                   np.float32),
        "labelled": np.asarray([r.labelled for r in recs], bool),
        "bbox_detector": (np.stack([r.detector_bbox for r in recs])
                          .astype(np.float32) if has_det else None),
        "teacher_cam_normalized": (
            np.stack([r.teacher_cam_normalized for r in recs])
            .astype(np.float32) if has_teacher else None),
    }


class SyntheticFreiHand:
    """Synthetic stand-in with the host-batch contract of the real dataset:
    random images, FreiHAND-like intrinsics and hand-sized joint clouds in
    front of the camera, all from `seed`. `render_joints` paints a blob at
    each joint's projection (depth in its brightness) so the images carry
    the joints' structure."""

    def __init__(self, n: int = 256, image_hw=(224, 224), seed: int = 0,
                 labelled_fraction: float = 0.5,
                 render_joints: bool = False, num_joints: int = 21):
        rng = np.random.RandomState(seed)
        self.n = n
        H, W = image_hw
        self.images = rng.randint(0, 255, (n, H, W, 3)).astype(np.uint8)
        self.K = np.tile(
            np.array([[531.9, 0, W / 2], [0, 532.2, H / 2], [0, 0, 1.0]],
                     np.float32), (n, 1, 1))
        center = np.array([0.0, 0.0, 0.45])
        self.joint_cam = (center
                          + rng.uniform(-0.035, 0.035, (n, num_joints, 3))
                          ).astype(np.float32)
        if render_joints:
            self.images //= 4
            for i in range(n):
                uvw = self.joint_cam[i] @ self.K[i].T
                uv = uvw[:, :2] / uvw[:, 2:3]
                zrel = self.joint_cam[i, :, 2]
                zn = (zrel - zrel.min()) / max(float(np.ptp(zrel)), 1e-6)
                for j in range(num_joints):
                    x, y = int(round(uv[j, 0])), int(round(uv[j, 1]))
                    if 1 <= x < W - 1 and 1 <= y < H - 1:
                        col = np.array([
                            255 * (j % 3 == 0), 255 * (j % 3 == 1),
                            255 * (j % 3 == 2)]) * (0.4 + 0.6 * zn[j])
                        self.images[i, y-1:y+2, x-1:x+2] = col.astype(np.uint8)
        self.ref_bone_len = np.linalg.norm(
            self.joint_cam[:, 9] - self.joint_cam[:, 10], axis=-1)
        self.labelled = rng.random_sample(n) < labelled_fraction
        self.num_labelled = int(self.labelled.sum())
        self.num_unlabelled = n - self.num_labelled
        #: optional (n, 4) detector crop boxes
        self.detector_bbox = None

    def __len__(self):
        return self.n

    def sample_indices(self, rng: np.random.RandomState, batch_size: int,
                       labelled_prob: Optional[float] = None) -> np.ndarray:
        """Training batch indices, uniform with replacement."""
        return rng.randint(0, self.n, batch_size)

    def host_batch(self, indices: np.ndarray) -> dict:
        i = np.asarray(indices)
        return {
            "image": self.images[i],
            "joint_cam": self.joint_cam[i],
            "K": self.K[i],
            "ref_bone_len": self.ref_bone_len[i],
            "labelled": self.labelled[i],
            "bbox_detector": (None if self.detector_bbox is None
                              else self.detector_bbox[i]),
            "teacher_cam_normalized": None,
        }


def padded_batches(n: int, batch_size: int) -> Iterator[np.ndarray]:
    """Index arrays covering [0, n) in fixed-size batches; the tail batch is
    padded by repeating its last index, and callers trim results to n (the
    reference DataLoader's drop_last=False)."""
    for start in range(0, n, batch_size):
        idx = np.arange(start, min(start + batch_size, n))
        if len(idx) < batch_size:
            idx = np.concatenate(
                [idx, np.full(batch_size - len(idx), idx[-1], idx.dtype)])
        yield idx
