"""FreiHAND dataset model: annotations, versions, splits, host batches.

Port of hand_integral_pose_estimation_tpu/data/freihand.py (the
reference's data/FreiHand/FreiHand.py:16-485): numpy-only host code, since
that package's `data/__init__.py` imports jax. The host decodes JPEGs
(`data/native_loader.py`) and stacks fixed-shape numpy batches; the
geometry runs on the device (`data/pipeline.py`).

Split contract kept exactly, quirks included:
  * 4 image versions gs/hom/sample/auto x 32 560 unique samples
    (FreiHand.py:16-19,376);
  * train = idx [0, training_size); test = idx [training_size + 1,
    training_size + testing_size) (the reference's off-by-one start and
    span, FreiHand.py:417-419);
  * labelled = idx < labelled_data_range, all versions (config.py:51-56);
  * biased sampling: labelled with probability 0.5 (dataset.py:89-105).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterator, Optional

import numpy as np

from hand_integral_pose_estimation_tpu_torch.config import (
    Config,
    FreiHandJoints,
)
from hand_integral_pose_estimation_tpu_torch.data.native_loader import (
    decode_jpeg,
)

VERSIONS = ("gs", "hom", "sample", "auto")
DB_SIZE = 32560  # unique training samples (FreiHand.py:173)


def version_map_id(idx: int, version: str) -> int:
    """Sample index -> image file id (FreiHand.py:164-166)."""
    return idx + DB_SIZE * VERSIONS.index(version)


@dataclasses.dataclass
class SampleRecord:
    """One annotated sample."""

    img_path: str
    K: np.ndarray                 # (3, 3)
    joint_cam: np.ndarray         # (21, 3)
    ref_bone_len: float
    labelled: bool
    version: str
    idx: int
    detector_bbox: Optional[np.ndarray] = None       # (4,) cx, cy, w, h
    teacher_cam_normalized: Optional[np.ndarray] = None
    teacher_tprime: Optional[float] = None
    #: (1, 61) MANO pose, shape and translation, stored and not read, as the
    #: reference stores it (FreiHand.py:196-211)
    mano: Optional[np.ndarray] = None


class FreiHandDataset:
    """Annotation-backed dataset over a FreiHAND download (or a directory
    of its layout): `training_{K,xyz,scale}.json` (and `training_mano.json`
    when present) with `training/rgb/{id:08d}.jpg`, or for the
    `"evaluation"` split `evaluation_{K,scale}.json` with
    `evaluation/rgb/{idx:08d}.jpg`. `data_split` is "training", "testing"
    or "evaluation"."""

    def __init__(self, data_dir: str, data_split: str = "training",
                 cfg: Config = Config()):
        self.data_dir = data_dir
        self.data_split = data_split
        self.cfg = cfg
        self.joint_num = FreiHandJoints.num_joints
        self.records: list[SampleRecord] = []
        self._load()

    def _json(self, name: str):
        with open(os.path.join(self.data_dir, name)) as f:
            return json.load(f)

    def _load_annotations(self):
        """FreiHand.py:214-239; the MANO rows are checked for length and
        stored, as the reference does (FreiHand.py:196-211)."""
        K_list = self._json("training_K.json")
        xyz_list = self._json("training_xyz.json")
        scale_list = self._json("training_scale.json")
        if not len(K_list) == len(xyz_list) == len(scale_list):
            raise ValueError(f"annotation lengths differ in {self.data_dir}")
        mano_list = None
        if os.path.exists(os.path.join(self.data_dir, "training_mano.json")):
            mano_list = self._json("training_mano.json")
            if len(mano_list) != len(K_list):
                raise ValueError("training_mano.json: size mismatch")
        return K_list, xyz_list, scale_list, mano_list

    def _split_range(self):
        t = self.cfg.train
        if self.data_split == "training":
            return 0, t.training_size
        if self.data_split == "testing":
            start = t.training_size + 1
            return start, start + t.testing_size - 1
        raise ValueError(f"unknown split {self.data_split!r}")

    def _load_evaluation(self):
        """The label-free challenge split (FreiHand.py:286-341): no joints
        (a zeros placeholder), every record unlabelled."""
        K_list = self._json("evaluation_K.json")
        scale_list = self._json("evaluation_scale.json")
        for idx in range(len(K_list)):
            self.records.append(SampleRecord(
                img_path=os.path.join(self.data_dir, "evaluation", "rgb",
                                      f"{idx:08d}.jpg"),
                K=np.asarray(K_list[idx], np.float64),
                joint_cam=np.zeros((self.joint_num, 3)),
                ref_bone_len=float(scale_list[idx]),
                labelled=False, version="gs", idx=idx))
        self.num_labelled = 0
        self.num_unlabelled = len(self.records)

    def _load(self):
        if self.data_split == "evaluation":
            return self._load_evaluation()
        K_list, xyz_list, scale_list, mano_list = self._load_annotations()
        start, end = self._split_range()
        lab_range = self.cfg.train.labelled_data_range
        for version in VERSIONS:
            for idx in range(start, end):
                file_id = version_map_id(idx, version)
                self.records.append(SampleRecord(
                    img_path=os.path.join(self.data_dir, "training", "rgb",
                                          f"{file_id:08d}.jpg"),
                    K=np.asarray(K_list[idx], np.float64),
                    joint_cam=np.asarray(xyz_list[idx], np.float64),
                    ref_bone_len=float(scale_list[idx]),
                    labelled=idx < lab_range, version=version, idx=idx,
                    mano=(None if mano_list is None
                          else np.asarray(mano_list[idx], np.float64))))
        # labelled records first, in a stable order (FreiHand.py:472)
        self.records.sort(key=lambda r: r.labelled, reverse=True)
        self.num_labelled = sum(r.labelled for r in self.records)
        self.num_unlabelled = len(self.records) - self.num_labelled

    def __len__(self):
        return len(self.records)

    def read_image(self, rec: SampleRecord) -> np.ndarray:
        """RGB (224, 224, 3) uint8 through the native decoder."""
        return decode_jpeg(rec.img_path)

    def sample_indices(self, rng: np.random.RandomState, batch_size: int,
                       labelled_prob: Optional[float] = None) -> np.ndarray:
        """Biased batch sampling (dataset.py:89-105): each row is labelled
        with probability `labelled_prob` (default
        cfg.train.labelled_selection_prob), then uniform within its pool;
        a dataset with one empty pool samples from the other."""
        p = (self.cfg.train.labelled_selection_prob
             if labelled_prob is None else labelled_prob)
        pick_lab = rng.random_sample(batch_size) < p
        if self.num_unlabelled == 0:
            pick_lab[:] = True
        elif self.num_labelled == 0:
            pick_lab[:] = False
        return np.where(
            pick_lab,
            rng.randint(0, max(self.num_labelled, 1), batch_size),
            self.num_labelled + rng.randint(
                0, max(self.num_unlabelled, 1), batch_size))

    def host_batch(self, indices: np.ndarray) -> dict:
        recs = [self.records[i] for i in indices]
        return stack_host_batch(recs, [self.read_image(r) for r in recs])


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

    def as_records(self, cfg: Config = Config()) -> "InMemoryFreiHand":
        """The same samples as a record-backed training split: labelled
        records first, biased sampling and `apply_filtered_labels`, as
        `FreiHandDataset` has them, with the images kept in memory."""
        return InMemoryFreiHand(self, cfg)

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


class InMemoryFreiHand(FreiHandDataset):
    """`FreiHandDataset`'s training split over a `SyntheticFreiHand`'s
    samples: record `i` is sample `i`, named `synthetic/{i:08d}.jpg`, and
    `read_image` returns its image from memory instead of decoding a
    JPEG."""

    def __init__(self, synthetic: SyntheticFreiHand, cfg: Config = Config()):
        self.synthetic = synthetic
        super().__init__("synthetic", "training", cfg)

    def _load(self):
        s = self.synthetic
        self.records = [SampleRecord(
            img_path=os.path.join(self.data_dir, f"{i:08d}.jpg"),
            K=np.asarray(s.K[i], np.float64),
            joint_cam=np.asarray(s.joint_cam[i], np.float64),
            ref_bone_len=float(s.ref_bone_len[i]),
            labelled=bool(s.labelled[i]), version="gs", idx=i)
            for i in range(len(s))]
        self.records.sort(key=lambda r: r.labelled, reverse=True)
        self.num_labelled = sum(r.labelled for r in self.records)
        self.num_unlabelled = len(self.records) - self.num_labelled

    def read_image(self, rec: SampleRecord) -> np.ndarray:
        return self.synthetic.images[rec.idx]


def batch_iterator(dataset, batch_size: int, steps: int,
                   seed: int = 0) -> Iterator[dict]:
    """`steps` host batches drawn with `dataset.sample_indices`."""
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        yield dataset.host_batch(dataset.sample_indices(rng, batch_size))


def apply_filtered_labels(dataset: FreiHandDataset,
                          npz_path: str) -> FreiHandDataset:
    """Attach a filtered pseudo-label db (`cli.generate_teacher_labels`)
    to a record-backed dataset and drop the rejected records, as
    FreiHand.load_filtered_data does (FreiHand.py:343-371). Kept records
    gain `teacher_cam_normalized` and `teacher_tprime`, in record order.
    Rows are positional: a db whose `name` rows differ from the dataset's
    record names (`data/detector_db.py:_record_names`), for example one
    made with another `--training-size`, raises."""
    from hand_integral_pose_estimation_tpu_torch.data.detector_db import (
        _record_names,
    )

    db = np.load(npz_path)
    keep = db["keep"]
    jcn = db["joint_cam_normalized"]
    tprime = db["tprime"]
    if "name" in db:
        names = _record_names(dataset)
        db_names = np.asarray(db["name"])
        if len(names) != len(db_names) or not (names == db_names).all():
            raise ValueError(
                f"filtered db {npz_path} was generated for a different "
                f"record set ({len(db_names)} rows vs {len(names)} records);"
                " regenerate with matching --training-size")
    kept = []
    for i in range(min(len(keep), len(dataset.records))):
        if keep[i]:
            r = dataset.records[i]
            r.teacher_cam_normalized = jcn[i]
            r.teacher_tprime = float(tprime[i])
            kept.append(r)
    dataset.records = kept
    dataset.num_labelled = sum(r.labelled for r in kept)
    dataset.num_unlabelled = len(kept) - dataset.num_labelled
    return dataset


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
