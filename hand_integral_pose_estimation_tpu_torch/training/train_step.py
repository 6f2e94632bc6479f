"""The eval step: forward + decode + loss, no gradients.

Port of `make_eval_fn` / `make_eval_step` in
hand_integral_pose_estimation_tpu/training/train_step.py (the body of the
reference's main/test.py:68-143). PyTorch runs eagerly, so the two are the
same function here. The train step waits for the training slice.
"""

from __future__ import annotations

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
