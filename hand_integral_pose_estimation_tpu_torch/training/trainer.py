"""The training and test-split runners.

Port of `Trainer` and `Tester` in
hand_integral_pose_estimation_tpu/training/trainer.py (the reference's
common/base.py:90-177 with main/train.py:34-163, and main/test.py:67-143)
for one device: the host samples raw batches, the device augments or crops,
normalises, runs the net, decodes and, in training, takes the optimizer
step. The device mesh, `scan_steps`, the native JPEG prefetch, the YUV
transport, the profiler and metrics writers and the ImageNet init of the
JAX runners wait for later ports.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Optional

import numpy as np
import torch
from torch import nn

from hand_integral_pose_estimation_tpu_torch.config import Config
from hand_integral_pose_estimation_tpu_torch.data import pipeline
from hand_integral_pose_estimation_tpu_torch.data.freihand import (
    padded_batches,
)
from hand_integral_pose_estimation_tpu_torch.models import get_pose_net
from hand_integral_pose_estimation_tpu_torch.training import (
    checkpoint as ckpt,
)
from hand_integral_pose_estimation_tpu_torch.training.state import (
    make_optimizer,
    multistep_schedule,
    optimizer_steps,
)
from hand_integral_pose_estimation_tpu_torch.training.train_step import (
    make_eval_step,
    make_train_step,
)

logger = logging.getLogger(__name__)


def _to_device(host: dict, device: torch.device) -> dict:
    """Host numpy batch -> device tensors (None stays None). Toward a card
    each array goes through pinned memory with a non-blocking copy, so the
    host does not wait for the stream to drain."""
    out = {}
    for key, v in host.items():
        if v is None:
            out[key] = None
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[key] = t
    return out


@dataclasses.dataclass
class Trainer:
    """End-to-end training runner (reference Trainer, common/base.py:90-177).

    Builds the pose net from `cfg.model` with weights drawn from `seed`,
    Adam with the step-wise schedule, resumes from the latest snapshot in
    `model_dir` when `continue_train`, and runs the per-step loop:
    sample a host batch, copy it to `device`, `make_train_batch`, the train
    step. `fuse_head` picks the fused projection + decode arm (the default)
    or the heatmap + decode arm. `test_dataset`, when given, gets the
    epoch-end average-loss sweep (main/train.py:140-163)."""

    cfg: Config
    dataset: object
    model_dir: str = "output/model_dump"
    log_dir: Optional[str] = None
    continue_train: bool = False
    seed: int = 0
    test_dataset: Optional[object] = None
    device: str | torch.device = "cuda"
    fuse_head: bool = True

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            path = os.path.abspath(os.path.join(self.log_dir,
                                                "train_logs.txt"))
            if not any(getattr(h, "baseFilename", None) == path
                       for h in logger.handlers):
                logger.addHandler(logging.FileHandler(path))
        tcfg = self.cfg.train
        self.batch_size = tcfg.batch_size
        self.steps_per_epoch = max(1, len(self.dataset) // self.batch_size)
        self.model = get_pose_net(
            self.cfg.model,
            generator=torch.Generator().manual_seed(self.seed)).to(
                self.device)
        self.optimizer = make_optimizer(self.model.parameters(), tcfg)
        self.start_epoch = 0
        if self.continue_train:
            try:
                epoch = ckpt.load_checkpoint(self.model_dir, self.model,
                                             self.optimizer)
                self.start_epoch = epoch + 1
                logger.info("resumed from snapshot_%d", epoch)
            except FileNotFoundError:
                logger.info("no snapshot found; training from scratch")
        # the schedule rides in the optimizer's step count
        self.scheduler = multistep_schedule(
            self.optimizer, self.steps_per_epoch, tcfg.lr_dec_epoch,
            tcfg.lr_dec_factor, step=optimizer_steps(self.optimizer))
        self.train_step = make_train_step(self.model, self.optimizer,
                                          self.scheduler, self.cfg,
                                          fuse_head=self.fuse_head)

    def preprocess(self, generator: torch.Generator,
                   host: dict) -> pipeline.Batch:
        """Host batch dict (numpy) -> augmented device Batch."""
        d = _to_device(host, self.device)
        return pipeline.make_train_batch(
            generator, d["image"], d["joint_cam"], d["K"],
            d["bbox_detector"], d["labelled"], d["teacher_cam_normalized"],
            d["ref_bone_len"], self.cfg.augment, self.cfg.model.input_shape)

    def run_epoch(self, epoch: int, num_steps: Optional[int] = None,
                  log_every: int = 20) -> dict:
        """`num_steps` train steps (default: one pass worth of batches).
        Host sampling and the device's augmentation noise are seeded from
        (seed, epoch). Returns the last step's metrics as floats."""
        num_steps = num_steps or self.steps_per_epoch
        rng = np.random.RandomState(self.seed * 100003 + epoch)
        generator = torch.Generator(device=self.device).manual_seed(
            self.seed * 131 + epoch)
        read_s = step_s = 0.0
        last = {}
        for itr in range(num_steps):
            t0 = time.perf_counter()
            host = self.dataset.host_batch(
                self.dataset.sample_indices(rng, self.batch_size))
            t1 = time.perf_counter()
            metrics = self.train_step(self.preprocess(generator, host))
            # the one synchronisation of the step, where the JAX Trainer
            # blocks on the loss (trainer.py:357): all metrics come to the
            # host together
            values = torch.stack(list(metrics.values())).cpu().tolist()
            last = dict(zip(metrics, values))
            t2 = time.perf_counter()
            read_s += t1 - t0
            step_s += t2 - t1
            if itr % log_every == 0:
                n = itr + 1
                logger.info(
                    "epoch %d itr %d/%d loss %.5f (sup %.4f unsup %.4f) "
                    "s_mpjpe %.4f t_mpjpe %.4f lr %.2e | %.3fs/itr "
                    "(read %.3f step %.3f)", epoch, itr, num_steps,
                    last["loss"], last["loss_supervised"],
                    last["loss_unsupervised"], last["student_mpjpe"],
                    last["teacher_mpjpe"],
                    self.optimizer.param_groups[0]["lr"],
                    (read_s + step_s) / n, read_s / n, step_s / n)
        return last

    def fit(self, end_epoch: Optional[int] = None,
            steps_per_epoch: Optional[int] = None,
            save_every: int = 1) -> nn.Module:
        """Epochs start_epoch .. end_epoch - 1, a snapshot after every
        `save_every`-th and the last, and the test-split sweep after each
        when `test_dataset` is set. Returns the model."""
        end_epoch = end_epoch or self.cfg.train.end_epoch
        tester = None
        for epoch in range(self.start_epoch, end_epoch):
            self.run_epoch(epoch, steps_per_epoch)
            if (epoch + 1) % save_every == 0 or epoch == end_epoch - 1:
                path = ckpt.save_checkpoint(self.model_dir, self.model,
                                            self.optimizer, epoch)
                logger.info("saved %s", path)
            if self.test_dataset is not None:
                if tester is None:
                    tester = Tester(self.cfg, self.test_dataset, self.model,
                                    device=self.device,
                                    fuse_head=self.fuse_head)
                logger.info("epoch %d/%d average loss on test set %.4f",
                            epoch, end_epoch, tester.mean_loss())
        return self.model


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
        d = _to_device(host, self.device)
        return pipeline.make_eval_batch(
            d["image"], d["joint_cam"], d["K"], d["bbox_detector"],
            d["ref_bone_len"], self.cfg.augment, self.cfg.model.input_shape)

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
