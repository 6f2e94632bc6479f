"""The test-split runner.

Port of `Tester` in hand_integral_pose_estimation_tpu/training/trainer.py
(the reference's main/test.py:67-143) for one device: the host feeds raw
batches, the device crops, normalises, runs the net and decodes. The
device mesh, the native JPEG prefetch and the YUV transport of the JAX
Tester wait for later ports, as does the Trainer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from hand_integral_pose_estimation_tpu_torch.config import Config
from hand_integral_pose_estimation_tpu_torch.data import pipeline
from hand_integral_pose_estimation_tpu_torch.data.freihand import (
    padded_batches,
)
from hand_integral_pose_estimation_tpu_torch.training.train_step import (
    make_eval_step,
)


@dataclasses.dataclass
class Tester:
    """No-grad sweep over a dataset collecting integral coords; the results
    feed `evaluation.evaluate_test_split`.

    `model` is a ResPoseNet; it is moved to `device` and put in eval mode.
    `fuse_head` picks the fused projection + decode (the default) or the
    heatmap + decode arm."""

    cfg: Config
    dataset: object
    model: nn.Module
    device: str | torch.device = "cuda"
    fuse_head: bool = True

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.model = self.model.to(self.device).eval()
        self.eval_step = make_eval_step(self.model, self.cfg, self.fuse_head)

    def preprocess(self, host: dict) -> pipeline.Batch:
        """Host batch dict (numpy) -> device Batch (make_eval_batch)."""
        def dev(key):
            v = host[key]
            return None if v is None else torch.from_numpy(
                np.ascontiguousarray(v)).to(self.device)

        return pipeline.make_eval_batch(
            dev("image"), dev("joint_cam"), dev("K"), dev("bbox_detector"),
            dev("ref_bone_len"), self.cfg.augment, self.cfg.model.input_shape)

    def run(self, batch_size: Optional[int] = None):
        """Sweep every sample exactly once. The last partial batch is padded
        by repeating its final sample, and padding rows are dropped on the
        host (the reference evaluates the smaller tail batch too,
        main/test.py:68-143). Only what evaluation needs is kept: the image
        patches are dropped per batch (`merged.image is None`).

        Returns (coords (N, J, 3) numpy, merged Batch of numpy arrays)."""
        bs = batch_size or self.cfg.train.test_batch_size
        n = len(self.dataset)
        coords_all, batches = [], []
        for idx in padded_batches(n, bs):
            batch = self.preprocess(self.dataset.host_batch(idx))
            coords, _ = self.eval_step(batch)
            coords_all.append(coords.cpu().numpy())
            batches.append(batch._replace(image=None))
        coords = np.concatenate(coords_all)[:n]
        merged = pipeline.Batch(*[
            None if field[0] is None else np.concatenate(
                [f.cpu().numpy() for f in field])[:n]
            for field in zip(*batches)])
        return coords, merged

    def mean_loss(self, batch_size: Optional[int] = None) -> float:
        """Per-sample JointLocationLoss averaged over the whole split (the
        epoch-end 'Average loss on test set', main/train.py:140-163)."""
        coords, merged = self.run(batch_size)
        err = np.abs(coords - merged.label) * merged.label_weight
        return float(err.sum(axis=(1, 2)).mean())
