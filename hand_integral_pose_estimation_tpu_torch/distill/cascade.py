"""Exact early-reject cascade for the rotation-variance teacher filter.

Port of hand_integral_pose_estimation_tpu/distill/cascade.py. The
single-pass filter runs the teacher under all T rotations for every
sample; the cascade rejects most samples the filter would reject after a
subset of them, with the same keep set. For any subset S of n of the T
per-rotation predictions x_t,

    T Var_T = sum_T ||x_t - mu_T||^2 >= sum_S ||x_t - mu_T||^2
            >= sum_S ||x_t - mu_S||^2 = n Var_S,

so Var_T >= (n / T) Var_S, per (joint, dim) and so for the summed total.
Pass 1 runs `pass1_rotations` evenly spaced angles, endpoints included; an
unlabelled sample whose bound (n / T) Var_S exceeds threshold * (1 +
safety) cannot pass the full filter and is rejected there. Survivors get
the other rotations in pass 2, in fixed-size batches, and their exact
variance and mean come from both passes in float64 on the host. Each
rotation's crop is the same in either pass as in the single pass, because
the factored base is sized for the full sweep. Labelled rows finish in
pass 1 with their GT normalisation.

With `mesh`, both passes' sweeps split their batches over the mesh's data
axis (`rotation_sweep_camera(mesh=...)`); the host-side bound test, the
queue and the float64 combine are unchanged, and every rank holds the
whole result. Each batch and `pass2_batch` must divide by the data axis.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from hand_integral_pose_estimation_tpu_torch.config import AugmentConfig
from hand_integral_pose_estimation_tpu_torch.distill.teacher_labels import (
    gt_normalized,
    rotation_sweep_camera,
    sweep_thetas,
)


def pass1_rotation_indices(num_rotations: int, num_pass1: int) -> np.ndarray:
    """Evenly spaced rotation indices including both endpoints."""
    if not 1 <= num_pass1 <= num_rotations:
        raise ValueError(f"pass1_rotations must be in [1, {num_rotations}], "
                         f"got {num_pass1}")
    idx = np.round(np.linspace(0, num_rotations - 1, num_pass1))
    return np.unique(idx.astype(np.int64))


class CascadeRunner:
    """Host orchestrator of the two-pass filter over a stream of batches.

    Feed fixed-shape batches with `add_batch` (row indices say where each
    record lands in the output db); `finalize(n)` returns the assembled
    arrays. Pass 1 runs at once for each batch; pass-2 survivors wait in a
    queue (as tensors on `device`) and run in batches of `pass2_batch`,
    the last one padded by repeating a row."""

    def __init__(
        self,
        teacher_apply: Callable,
        acfg: AugmentConfig = AugmentConfig(),
        *,
        num_rotations: int = 21,
        rotation_range: float = 0.52,
        variance_threshold: float = 1e-4,
        patch_hw=(224, 224),
        rotation_mode: str = "factored",
        pass1_rotations: int = 5,
        pass2_batch: int = 8,
        safety: float = 1e-3,
        device: str | torch.device = "cuda",
        mesh=None,
    ):
        self.num_rotations = num_rotations
        self.variance_threshold = variance_threshold
        self.safety = safety
        self.pass2_batch = pass2_batch
        if mesh is not None and pass2_batch % mesh.shape["data"]:
            raise ValueError(
                f"pass2_batch {pass2_batch} must divide by the mesh "
                f"'data'-axis size {mesh.shape['data']}")
        self.device = torch.device(device)
        thetas = sweep_thetas(num_rotations, rotation_range)
        self.idx1 = pass1_rotation_indices(num_rotations, pass1_rotations)
        self.idx2 = np.setdiff1d(np.arange(num_rotations), self.idx1)
        self.n1 = len(self.idx1)
        self.has_pass2 = len(self.idx2) > 0

        def sweep(th):
            def run(images, K, bbox):
                return rotation_sweep_camera(
                    teacher_apply, images, K, bbox, acfg, th,
                    rotation_range, patch_hw, rotation_mode, mesh=mesh)
            return run

        self._sweep1 = sweep(thetas[self.idx1])
        self._sweep2 = sweep(thetas[self.idx2])
        self.reset()

    def reset(self) -> None:
        """Clear the rows, the queue and the counts."""
        self._rows: dict[int, dict] = {}
        self._queue: list[dict] = []
        self.stats = {"total": 0, "labelled": 0, "early_rejected": 0,
                      "pass2": 0, "kept": 0}

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device)

    def add_batch(self, images, K, bbox, labelled, joint_cam, rows) -> None:
        """One batch (numpy arrays or tensors); `rows` gives each record's
        output index (negative: a padding row, dropped)."""
        images, K, bbox, joint_cam = (self._tensor(x) for x in
                                      (images, K, bbox, joint_cam))
        with torch.no_grad():
            cam1, tprime = self._sweep1(images, K, bbox)
            gt_norm = gt_normalized(joint_cam.to(K.dtype), K, tprime)
        cam1 = cam1.cpu().numpy().astype(np.float64)
        tprime = tprime.cpu().numpy().astype(np.float64)
        gt_norm = gt_norm.cpu().numpy().astype(np.float64)
        labelled = np.asarray(torch.as_tensor(labelled).cpu(), bool)

        var1 = np.var(cam1, axis=1).sum(axis=(-2, -1))
        bound = var1 * (self.n1 / self.num_rotations)
        cutoff = self.variance_threshold * (1.0 + self.safety)
        for b, row in enumerate(np.asarray(rows, np.int64)):
            if row < 0:
                continue
            self.stats["total"] += 1
            if labelled[b]:
                self.stats["labelled"] += 1
                self.stats["kept"] += 1
                self._rows[int(row)] = dict(
                    joint_cam_normalized=gt_norm[b], tprime=tprime[b],
                    variance=0.0, keep=True, labelled=True,
                    early_rejected=False, pass1_bound=0.0)
            elif bound[b] > cutoff or not self.has_pass2:
                # without a pass 2 (pass1_rotations == num_rotations) the
                # bound is the exact variance and decides exactly
                keep = (not self.has_pass2
                        and var1[b] < self.variance_threshold)
                self.stats["early_rejected"] += not keep
                self.stats["kept"] += keep
                self._rows[int(row)] = dict(
                    joint_cam_normalized=cam1[b].mean(axis=0),
                    tprime=tprime[b],
                    variance=bound[b] if self.has_pass2 else var1[b],
                    keep=keep, labelled=False,
                    early_rejected=self.has_pass2, pass1_bound=bound[b])
            else:
                self._queue.append(dict(
                    row=int(row), image=images[b], K=K[b], bbox=bbox[b],
                    cam1=cam1[b], tprime=tprime[b], pass1_bound=bound[b]))
                while len(self._queue) >= self.pass2_batch:
                    self._flush(self.pass2_batch)

    def _flush(self, n: int) -> None:
        batch, self._queue = self._queue[:n], self._queue[n:]
        pad = self.pass2_batch - len(batch)
        stacked = {k: torch.stack([q[k] for q in batch] + [batch[-1][k]] * pad)
                   for k in ("image", "K", "bbox")}
        with torch.no_grad():
            cam2, _ = self._sweep2(stacked["image"], stacked["K"],
                                   stacked["bbox"])
        cam2 = cam2.cpu().numpy().astype(np.float64)
        for b, q in enumerate(batch):
            cam = np.empty((self.num_rotations,) + q["cam1"].shape[1:])
            cam[self.idx1] = q["cam1"]
            cam[self.idx2] = cam2[b]
            variance = np.var(cam, axis=0).sum()
            keep = bool(variance < self.variance_threshold)
            self.stats["pass2"] += 1
            self.stats["kept"] += keep
            self._rows[q["row"]] = dict(
                joint_cam_normalized=cam.mean(axis=0), tprime=q["tprime"],
                variance=variance, keep=keep, labelled=False,
                early_rejected=False, pass1_bound=q["pass1_bound"])

    def finalize(self, n: int) -> dict:
        """Flush the queue and assemble length-`n` arrays: the npz schema of
        `cli.generate_teacher_labels` plus `early_rejected` and
        `pass1_bound`, the (n / T)-scaled pass-1 bound (0 for labelled
        rows), from which pass-1 survival at any threshold t reads as
        bound <= t (1 + safety)."""
        while self._queue:
            self._flush(self.pass2_batch)
        missing = set(range(n)) - set(self._rows)
        if missing:
            raise ValueError(
                f"rows never fed to add_batch: {sorted(missing)[:8]}")
        rows = [self._rows[i] for i in range(n)]

        def col(key, dtype):
            return np.asarray([r[key] for r in rows], dtype)

        return {
            "joint_cam_normalized": np.stack(
                [r["joint_cam_normalized"] for r in rows]).astype(np.float32),
            "tprime": col("tprime", np.float32),
            "variance": col("variance", np.float32),
            "keep": col("keep", bool),
            "labelled": col("labelled", bool),
            "early_rejected": col("early_rejected", bool),
            "pass1_bound": col("pass1_bound", np.float32),
        }
