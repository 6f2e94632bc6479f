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

Under a device mesh (`parallel.Mesh`, JAX `make_train_step(mesh=...)`)
each rank steps on its rows of the global batch: the model's BatchNorms
are sync-BN (`parallel.convert_sync_batchnorm`), the decode goes through
`parallel.sharded_head_projection_integral` / `sharded_softmax_integral`
(the final projection split over `model` where the joints divide it),
and after the backward one flat all-reduce averages the gradients over
`data`, inside the step, so a captured chunk holds it. The metrics are
those of the global batch.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from hand_integral_pose_estimation_tpu_torch import losses
from hand_integral_pose_estimation_tpu_torch.config import Config
from hand_integral_pose_estimation_tpu_torch.data.pipeline import Batch
from hand_integral_pose_estimation_tpu_torch.parallel import (
    all_reduce_gradients,
    sharded_head_projection_integral,
    sharded_softmax_integral,
)

#: the train step's metrics: (name, summed over the global batch, where
#: the others are means)
_METRICS = (("loss", False), ("loss_supervised", True),
            ("loss_unsupervised", True), ("student_mpjpe", False),
            ("teacher_mpjpe", False))


def make_train_step(model, optimizer: torch.optim.Optimizer,
                    scheduler,
                    cfg: Config,
                    teacher_apply: Optional[Callable] = None,
                    panet_apply: Optional[Callable] = None,
                    fuse_head: bool = True,
                    mesh=None):
    """`train_step(batch) -> metrics` for a ResPoseNet whose parameters
    `optimizer` holds; `scheduler` is `state.multistep_schedule`'s.
    `mesh`: a `parallel.Mesh` the model was laid out on
    (`parallel.place_state`, after `convert_sync_batchnorm`); `batch` is
    then this rank's rows.

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
    ph, pw = cfg.model.input_shape
    decode = _decoder(model, cfg, fuse_head, mesh)

    def train_step(batch: Batch) -> dict:
        model.train()
        coord_out = decode(batch.image)
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
        if mesh is not None:
            all_reduce_gradients(model.parameters(), mesh)
        optimizer.step()
        scheduler.step()
        if mesh is None:
            values = torch.stack([getattr(out, k).detach()
                                  for k, _ in _METRICS])
        else:
            # the global batch's: sums add, means of equal slices average
            n = mesh.shape["data"]
            values = torch.stack([getattr(out, k).detach()
                                  * (1.0 if summed else 1.0 / n)
                                  for k, summed in _METRICS])
            dist.all_reduce(values, group=mesh.data_group)
        return {k: v for (k, _), v in zip(_METRICS, values.unbind())}

    return train_step


def _decoder(model, cfg: Config, fuse_head: bool, mesh):
    """images -> (B, J, 3) coords on either head arm, under `mesh` or not.

    fuse_head=True runs the fused projection + soft-argmax on the head's
    features (c: outside the model's autocast region, so bf16 features
    meet the float32 projection), and the heatmap is never materialised;
    False runs the whole net to the heatmap and decodes it."""
    J = cfg.model.num_joints
    D = cfg.model.depth_dim

    def decode(images: torch.Tensor) -> torch.Tensor:
        if fuse_head:
            feats = model(images, return_features=True)
            weight, bias = model.final_projection()
            return sharded_head_projection_integral(feats, weight, bias, J,
                                                    D, mesh)
        return sharded_softmax_integral(model(images), J, D, mesh)

    return decode


def make_eval_fn(model, cfg: Config, fuse_head: bool = True, mesh=None):
    """`eval_step(batch) -> (coords (B, J, 3), loss)` for a
    ResPoseNet in eval mode, on either head arm (`_decoder`); under
    `mesh`, of this rank's rows."""
    decode = _decoder(model, cfg, fuse_head, mesh)

    @torch.inference_mode()
    def eval_step(batch: Batch):
        model.eval()
        coords = decode(batch.image)
        loss = losses.joint_location_loss(coords, batch.label,
                                          batch.label_weight)
        return coords, loss

    return eval_step


make_eval_step = make_eval_fn
