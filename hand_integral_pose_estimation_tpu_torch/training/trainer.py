"""The training, test-split and evaluation-split runners.

Port of `Trainer`, `Tester` and `Evaluator` in
hand_integral_pose_estimation_tpu/training/trainer.py (the reference's
common/base.py:90-284 with main/train.py:34-163, and main/test.py:67-143)
for one device: the host samples raw batches, the device augments or crops,
normalises, runs the net, decodes and, in training, takes the optimizer
step. On the card each chunk of `scan_steps` train steps, and each eval
batch, is one replay of a captured CUDA graph (`training.graphs`), the
counterpart of the JAX runners' jitted `lax.scan` and eval programs; on
the CPU the same chunks run as eager steps.

File-backed splits (`data.freihand.reads_jpeg_files`) are decoded by the
native batch prefetcher (`native_prefetch`, on by default, as in the JAX
runners): the next batch decodes on a C++ thread pool while the device
runs the current one, and each batch is decoded once. `yuv_transport`
ships the JPEGs' own 4:2:0 planes (1.5 bytes a pixel instead of 3) and
finishes the decode on the device (`ops.yuv`, bitwise the host decode),
inside the captured chunk. The device mesh and the profiler of the JAX
runners wait for later ports.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import os
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from hand_integral_pose_estimation_tpu_torch.config import Config
from hand_integral_pose_estimation_tpu_torch.data import pipeline
from hand_integral_pose_estimation_tpu_torch.data.freihand import (
    FRAME_HW,
    padded_batches,
    reads_jpeg_files,
    stack_host_batch,
)
from hand_integral_pose_estimation_tpu_torch.data.native_loader import (
    NativeLoader,
)
from hand_integral_pose_estimation_tpu_torch.models import get_pose_net
from hand_integral_pose_estimation_tpu_torch.ops.yuv import yuv420_to_rgb
from hand_integral_pose_estimation_tpu_torch.training import (
    checkpoint as ckpt,
)
from hand_integral_pose_estimation_tpu_torch.training.graphs import (
    CapturedStep,
)
from hand_integral_pose_estimation_tpu_torch.training.state import (
    make_optimizer,
    multistep_factor,
    multistep_schedule,
    optimizer_steps,
)
from hand_integral_pose_estimation_tpu_torch.training.train_step import (
    make_eval_step,
    make_train_step,
)
from hand_integral_pose_estimation_tpu_torch.utils.metrics_writer import (
    MetricsWriter,
)

logger = logging.getLogger(__name__)

#: the train step's metrics, in the order a chunk returns them
METRICS = ("loss", "loss_supervised", "loss_unsupervised", "student_mpjpe",
           "teacher_mpjpe")
#: the host batch fields the eval step reads
EVAL_FIELDS = ("image", "joint_cam", "K", "bbox_detector", "ref_bone_len")


def _to_device(host: dict, device: torch.device) -> dict:
    """Host numpy batch -> device tensors (None stays None). Toward a card
    each array goes through a fresh pinned buffer with a non-blocking copy,
    so the host does not wait for the stream to drain."""
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


def _uses_loader(dataset, native_prefetch: bool,
                 yuv_transport: bool) -> bool:
    """Whether a runner over `dataset` reads it through the batch
    prefetcher: prefetch is on and the dataset's frames are JPEG files
    read at `FRAME_HW`. Otherwise the host reads batches itself
    (`dataset.host_batch`). The YUV transport needs the prefetcher and
    raises without it."""
    if yuv_transport and not native_prefetch:
        raise ValueError("yuv_transport needs native_prefetch")
    if not reads_jpeg_files(dataset):
        if yuv_transport:
            raise ValueError(
                f"yuv_transport needs a file-backed dataset whose records "
                f"name JPEG files (a FreiHandDataset), not "
                f"{type(dataset).__name__}")
        return False
    return native_prefetch


def _loader(batch_size: int, yuv_transport: bool) -> NativeLoader:
    return NativeLoader(batch_size, *FRAME_HW,
                        layout="yuv420" if yuv_transport else "rgb")


def _prefetched(loader: NativeLoader, records, index_batches):
    """Host batches of `index_batches` (an iterator of index arrays) with
    submit-ahead double buffering: batch i+1 is drawn and submitted only
    after batch i is collected, so the draws happen in the order a plain
    loop makes them, and nothing is left in flight at the end (or when the
    consumer stops early)."""
    try:
        idx = next(index_batches, None)
        if idx is None:
            return
        loader.submit([records[i].img_path for i in idx])
        while idx is not None:
            images = loader.wait()
            nxt = next(index_batches, None)
            if nxt is not None:
                loader.submit([records[i].img_path for i in nxt])
            yield stack_host_batch([records[i] for i in idx], list(images))
            idx = nxt
    finally:
        loader.discard()


@dataclasses.dataclass
class Trainer:
    """End-to-end training runner (reference Trainer, common/base.py:90-177).

    Builds the pose net from `cfg.model` with weights drawn from `seed`,
    Adam with the step-wise schedule, resumes from the latest snapshot in
    `model_dir` when `continue_train`, and runs the loop in chunks of
    `scan_steps` steps, as the JAX Trainer does: sample that many host
    batches, stack them (k, B, ...), copy them to `device`, and run
    `make_train_batch` and the train step on each. On the card a chunk is
    one replay of a captured CUDA graph (the first chunk of each length
    runs eagerly, as the warm-up); on the CPU it is k eager steps. The
    host waits on the device once per chunk, for the last step's metrics.
    Host batches of a file-backed split come from the batch prefetcher
    (`native_prefetch`, `host_batches`); with `yuv_transport` their image
    field is the packed 4:2:0 planes, decoded in the chunk before
    `make_train_batch`. `fuse_head` picks the fused
    projection + decode arm (the default) or the heatmap + decode arm.
    `test_dataset`, when given, gets the epoch-end average-loss sweep
    (main/train.py:140-163). `metrics_dir`, when given, receives
    `events.jsonl` (and TensorBoard events when tensorboardX imports):
    train/* and train/lr after each chunk, test/loss after each sweep.

    The semi-supervised terms: `teacher_apply`, a frozen teacher
    (`training.teacher`) whose predictions on each augmented batch replace
    the batch's cached pseudo-labels, and `panet_apply`, the PANet
    reconstruction (`models.panet.panet_reconstruction_fn` of a PANet whose
    parameters take no gradient) for the cfg.train.lam term. Both run
    inside the step, so on the card they are part of each captured
    chunk."""

    cfg: Config
    dataset: object
    model_dir: str = "output/model_dump"
    log_dir: Optional[str] = None
    continue_train: bool = False
    seed: int = 0
    #: train steps per chunk: one graph replay on the card (JAX lax.scan)
    scan_steps: int = 1
    metrics_dir: Optional[str] = None
    test_dataset: Optional[object] = None
    device: str | torch.device = "cuda"
    fuse_head: bool = True
    teacher_apply: Optional[Callable] = None
    panet_apply: Optional[Callable] = None
    #: decode file-backed batches with the native prefetcher, the next
    #: batch while the device runs this one
    native_prefetch: bool = True
    #: ship the JPEGs' 4:2:0 planes and finish the decode on the device
    #: (bitwise the host decode); needs native_prefetch and 4:2:0 JPEGs of
    #: `FRAME_HW`
    yuv_transport: bool = False

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.loader = (_loader(self.cfg.train.batch_size, self.yuv_transport)
                       if _uses_loader(self.dataset, self.native_prefetch,
                                       self.yuv_transport) else None)
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
        self.global_step = optimizer_steps(self.optimizer)
        self.scheduler = multistep_schedule(
            self.optimizer, self.steps_per_epoch, tcfg.lr_dec_epoch,
            tcfg.lr_dec_factor)
        self._lr_factor = multistep_factor(
            self.steps_per_epoch, tcfg.lr_dec_epoch, tcfg.lr_dec_factor)
        self.train_step = make_train_step(
            self.model, self.optimizer, self.scheduler, self.cfg,
            teacher_apply=self.teacher_apply, panet_apply=self.panet_apply,
            fuse_head=self.fuse_head)
        # one generator for the run, seeded per epoch: a graph replays the
        # draws of the generator object it was captured with
        self.generator = torch.Generator(device=self.device)
        self.graphs = (CapturedStep(self.train_chunk, self.device,
                                    generators=(self.generator,))
                       if self.device.type == "cuda" else None)
        self.metrics = (MetricsWriter(self.metrics_dir)
                        if self.metrics_dir else None)

    def lr_at(self, step: int) -> float:
        """The learning rate of step `step` (from 0)."""
        return self.cfg.train.lr * self._lr_factor(step)

    def preprocess(self, generator: torch.Generator,
                   host: dict) -> pipeline.Batch:
        """Host batch dict (numpy) -> augmented device Batch."""
        return self._augment(generator, _to_device(host, self.device))

    def _augment(self, generator: torch.Generator,
                 d: dict) -> pipeline.Batch:
        image = d["image"]
        if self.yuv_transport:
            image = yuv420_to_rgb(image, *FRAME_HW)
        return pipeline.make_train_batch(
            generator, image, d["joint_cam"], d["K"],
            d["bbox_detector"], d["labelled"], d["teacher_cam_normalized"],
            d["ref_bone_len"], self.cfg.augment, self.cfg.model.input_shape)

    def train_chunk(self, chunk: dict) -> torch.Tensor:
        """Train steps over a stacked chunk of host fields on the device,
        each (k, B, ...) or None: augment and step on each of the k
        batches in order. Returns the last step's metrics stacked in
        `METRICS` order (JAX `_make_scan_train`'s `v[-1]`)."""
        for i in range(chunk["image"].shape[0]):
            metrics = self.train_step(self._augment(self.generator, {
                k: None if v is None else v[i] for k, v in chunk.items()}))
        return torch.stack([metrics[k] for k in METRICS])

    def host_batches(self, rng: np.random.RandomState, num_steps: int):
        """The host batches of `num_steps` steps, each drawn with the
        dataset's sampler from `rng`: through the prefetcher where there is
        one (each batch decoded once, the next while this one trains),
        else `dataset.host_batch`. Both draw the same indices in the same
        order, and no batch is drawn past the last step (the JAX Trainer
        keeps one in flight into the next epoch)."""
        draws = (self.dataset.sample_indices(rng, self.batch_size)
                 for _ in range(num_steps))
        if self.loader is None:
            return map(self.dataset.host_batch, draws)
        return _prefetched(self.loader, self.dataset.records, draws)

    def run_epoch(self, epoch: int, num_steps: Optional[int] = None,
                  log_every: int = 20) -> dict:
        """`num_steps` train steps (default: one pass worth of batches) in
        chunks of `scan_steps`. Host sampling and the device's augmentation
        noise are seeded from (seed, epoch), so the steps do not depend on
        the chunking. Returns the last step's metrics as floats."""
        num_steps = num_steps or self.steps_per_epoch
        rng = np.random.RandomState(self.seed * 100003 + epoch)
        self.generator.manual_seed(self.seed * 131 + epoch)
        k = max(1, self.scan_steps)
        read_s = step_s = 0.0
        last = {}
        batches = self.host_batches(rng, num_steps)
        for itr in range(0, num_steps, k):
            t0 = time.perf_counter()
            hosts = list(itertools.islice(batches, min(k, num_steps - itr)))
            chunk = {key: None if hosts[0][key] is None
                     else np.stack([h[key] for h in hosts])
                     for key in hosts[0]}
            t1 = time.perf_counter()
            if self.graphs is not None:
                out = self.graphs(chunk)
            else:
                out = self.train_chunk(_to_device(chunk, self.device))
            # the one synchronisation of the chunk, where the JAX Trainer
            # blocks on the loss (trainer.py:357)
            last = dict(zip(METRICS, out.cpu().tolist()))
            t2 = time.perf_counter()
            self.global_step += len(hosts)
            read_s += t1 - t0
            step_s += t2 - t1
            if self.metrics is not None:
                self.metrics.write(self.global_step, {
                    **last, "lr": self.lr_at(self.global_step)},
                    prefix="train")
            if itr % log_every == 0:
                n = itr + len(hosts)
                logger.info(
                    "epoch %d itr %d/%d loss %.5f (sup %.4f unsup %.4f) "
                    "s_mpjpe %.4f t_mpjpe %.4f lr %.2e | %.3fs/itr "
                    "(read %.3f step %.3f)", epoch, itr, num_steps,
                    last["loss"], last["loss_supervised"],
                    last["loss_unsupervised"], last["student_mpjpe"],
                    last["teacher_mpjpe"], self.lr_at(self.global_step),
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
                test_loss = tester.mean_loss()
                logger.info("epoch %d/%d average loss on test set %.4f",
                            epoch, end_epoch, test_loss)
                if self.metrics is not None:
                    self.metrics.write(self.global_step, {"loss": test_loss},
                                       prefix="test")
        return self.model


@dataclasses.dataclass
class Tester:
    """No-grad sweep over a dataset collecting integral coords; the results
    feed `evaluation.evaluate_test_split`.

    `model` is a ResPoseNet; it is moved to `device` and put in eval mode.
    `fuse_head` picks the fused projection + decode (the default) or the
    heatmap + decode arm. On the card each batch (crop, net, decode, loss)
    is one replay of a CUDA graph captured at the batch size (the first
    batch of a size runs eagerly, as the warm-up)."""

    cfg: Config
    dataset: object
    model: nn.Module
    device: str | torch.device = "cuda"
    fuse_head: bool = True
    #: as the Trainer's: decode file-backed batches with the prefetcher
    native_prefetch: bool = True
    #: as the Trainer's: 4:2:0 planes, decoded on the device
    yuv_transport: bool = False

    def __post_init__(self):
        self.device = torch.device(self.device)
        # a prefetcher per sweep, at the sweep's batch size
        self._prefetch = _uses_loader(self.dataset, self.native_prefetch,
                                      self.yuv_transport)
        self.model = self.model.to(self.device).eval()
        self.eval_step = make_eval_step(self.model, self.cfg, self.fuse_head)
        self.graphs = (CapturedStep(self.eval_batch, self.device)
                       if self.device.type == "cuda" else None)

    def preprocess(self, host: dict) -> pipeline.Batch:
        """Host batch dict (numpy) -> device Batch (make_eval_batch)."""
        return self._crop(_to_device(host, self.device))

    def _crop(self, d: dict) -> pipeline.Batch:
        image = d["image"]
        if self.yuv_transport:
            image = yuv420_to_rgb(image, *FRAME_HW)
        return pipeline.make_eval_batch(
            image, d["joint_cam"], d["K"], d["bbox_detector"],
            d["ref_bone_len"], self.cfg.augment, self.cfg.model.input_shape)

    def eval_batch(self, d: dict):
        """Device fields (`EVAL_FIELDS`) of one batch -> (coords (B, J, 3),
        its Batch without the image patches): `make_eval_batch` and the
        eval step."""
        batch = self._crop(d)
        coords, _ = self.eval_step(batch)
        return coords, batch._replace(image=None)

    def run(self, batch_size: Optional[int] = None):
        """Sweep every sample exactly once. The last partial batch is padded
        by repeating its final sample, and padding rows are dropped on the
        host (the reference evaluates the smaller tail batch too,
        main/test.py:68-143), so every batch has one shape and one graph
        serves the sweep. Only what evaluation needs is kept: the image
        patches are dropped per batch (`merged.image is None`); the results
        come to the host once, after the last batch.

        Returns (coords (N, J, 3) numpy, merged Batch of numpy arrays)."""
        bs = batch_size or self.cfg.train.test_batch_size
        n = len(self.dataset)
        outs = []
        for host in self.host_batches(bs):
            host = {k: host[k] for k in EVAL_FIELDS}
            if self.graphs is not None:
                outs.append(self.graphs(host))
            else:
                outs.append(self.eval_batch(_to_device(host, self.device)))
        coords = torch.cat([c for c, _ in outs]).cpu().numpy()[:n]
        merged = pipeline.Batch(*[
            None if field[0] is None else
            torch.cat(field).cpu().numpy()[:n]
            for field in zip(*[b for _, b in outs])])
        return coords, merged

    def host_batches(self, batch_size: int):
        """The sweep's host batches (`padded_batches` of the split): through
        a prefetcher made for the sweep, with submit-ahead double
        buffering (batch i+1 decodes while the device evaluates batch i),
        where the dataset is read through one; else `dataset.host_batch`.
        An empty split yields nothing."""
        idxs = padded_batches(len(self.dataset), batch_size)
        if not self._prefetch:
            yield from map(self.dataset.host_batch, idxs)
            return
        with _loader(batch_size, self.yuv_transport) as loader:
            yield from _prefetched(loader, self.dataset.records, idxs)

    def mean_loss(self, batch_size: Optional[int] = None) -> float:
        """Per-sample JointLocationLoss averaged over the whole split (the
        epoch-end 'Average loss on test set', main/train.py:140-163)."""
        coords, merged = self.run(batch_size)
        err = np.abs(coords - merged.label) * merged.label_weight
        return float(err.sum(axis=(1, 2)).mean())


@dataclasses.dataclass
class Evaluator(Tester):
    """Evaluation-split runner (common/base.py:244-284; JAX
    training/trainer.py:590): the Tester's sweep over the label-free
    challenge split, whose batches carry detector-derived boxes and dummy
    joints; `evaluation.evaluate_challenge` takes the collected coords."""
