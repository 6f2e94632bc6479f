"""The train step and the eval step.

Port of hand_integral_pose_estimation_tpu/training/train_step.py. The train
step is the reference's hot loop body (main/train.py:50-130): forward in
train mode -> soft-argmax decode -> combined loss -> backward -> Adam ->
schedule. The eval step is the body of main/test.py:68-143. PyTorch runs
eagerly, so `make_eval_fn` and `make_eval_step` are the same function here.

Both head arms: `fuse_head=True` runs the fused projection + soft-argmax
(kernels 3 and 4 on the card) on the head's features, so the heatmap and
its gradient never reach device memory; `fuse_head=False` runs the whole
net to the heatmap and decodes it (kernels 1 and 2).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from hand_integral_pose_estimation_tpu_torch import losses
from hand_integral_pose_estimation_tpu_torch.config import Config
from hand_integral_pose_estimation_tpu_torch.data.pipeline import Batch
from hand_integral_pose_estimation_tpu_torch.ops.fused_head import (
    head_projection_integral,
)
from hand_integral_pose_estimation_tpu_torch.ops.integral import (
    softmax_integral,
)


def make_train_step(model, optimizer: torch.optim.Optimizer,
                    scheduler,
                    cfg: Config,
                    teacher_apply: Optional[Callable] = None,
                    panet_apply: Optional[Callable] = None,
                    fuse_head: bool = True):
    """`train_step(batch) -> metrics` for a ResPoseNet whose parameters
    `optimizer` holds; `scheduler` is `state.multistep_schedule`'s.

    One step: forward in train mode (BatchNorm on batch statistics, running
    statistics updated), decode, `losses.combined_loss`, gradients set to
    None, backward, `optimizer.step()`, `scheduler.step()`. Returns the
    five metrics of the JAX step (loss, loss_supervised,
    loss_unsupervised, student_mpjpe, teacher_mpjpe) as device tensors.
    (d) Nothing in the step waits for the device: no `.item()`, no
    `torch.linalg.inv` (the augmentation uses `inv_ex`), no tensor built
    on the host, so the caller decides where to synchronise. The step's
    gradients stay in the parameters' `.grad` until the next step.

    On the card the step can be captured in a CUDA graph, one or several
    in a row (`training.graphs`): Adam is capturable, the scheduler writes
    the next step's rate from Adam's device step count, and the gradients
    are set to None before each backward, so each captured backward
    writes fresh gradients from the graph's memory pool instead of adding
    to the last step's (the whole-network capture of torch.cuda.graph's
    documentation).

    teacher_apply: optional frozen teacher `(images) -> (B, J, 3)`
    label-space coords, used instead of the batch's cached pseudo-labels.
    panet_apply: optional NRSfM forward for the PANet term (cfg.train.lam).
    """
    J = cfg.model.num_joints
    D = cfg.model.depth_dim
    ph, pw = cfg.model.input_shape

    def train_step(batch: Batch) -> dict:
        model.train()
        if fuse_head:
            # (c) the fused head runs outside the model's autocast region:
            # bf16 features, float32 projection
            feats = model(batch.image, return_features=True)
            weight, bias = model.final_projection()
            coord_out = head_projection_integral(feats, weight, bias, J, D)
        else:
            coord_out = softmax_integral(model(batch.image), J, D)
        if teacher_apply is not None:
            with torch.no_grad():
                coord_teacher = teacher_apply(batch.image)
        else:
            coord_teacher = batch.label_teacher
        out = losses.combined_loss(
            coord_out, coord_teacher, batch.label, batch.label_weight,
            batch.labelled, batch.trans_inv, batch.tprime, batch.K,
            panet_apply=panet_apply, lam=cfg.train.lam, patch_width=pw,
            patch_height=ph)
        optimizer.zero_grad(set_to_none=True)
        out.loss.backward()
        optimizer.step()
        scheduler.step()
        return {
            "loss": out.loss.detach(),
            "loss_supervised": out.loss_supervised.detach(),
            "loss_unsupervised": out.loss_unsupervised.detach(),
            "student_mpjpe": out.student_mpjpe,
            "teacher_mpjpe": out.teacher_mpjpe,
        }

    return train_step


def make_eval_fn(model, cfg: Config, fuse_head: bool = True):
    """`eval_step(batch) -> (coords (B, J, 3), loss)` for a
    ResPoseNet in eval mode.

    fuse_head=True runs the fused projection + soft-argmax on the head's
    features, so the heatmap is never materialised; False runs the whole
    net to the heatmap and decodes it."""
    J = cfg.model.num_joints
    D = cfg.model.depth_dim

    @torch.inference_mode()
    def eval_step(batch: Batch):
        model.eval()
        if fuse_head:
            feats = model(batch.image, return_features=True)
            weight, bias = model.final_projection()
            coords = head_projection_integral(feats, weight, bias, J, D)
        else:
            coords = softmax_integral(model(batch.image), J, D)
        loss = losses.joint_location_loss(coords, batch.label,
                                          batch.label_weight)
        return coords, loss

    return eval_step


make_eval_step = make_eval_fn
