"""The frozen teacher (reference: `load_regressor_teacher`,
common/base.py:117-128, with cfg.teacher_checkpoint, config.py:79).

Port of hand_integral_pose_estimation_tpu/training/teacher.py. The teacher
is a pose-net snapshot in eval mode with its parameters frozen; its
label-space predictions feed the combined loss's teacher term when the
batch carries no cached pseudo-labels (main/train.py:83-99), and they are
the sweep's predictions in `distill.generate_filtered_labels`. It decodes
with the fused projection + soft-argmax (kernel 3 on the card).
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import torch
from torch import nn

from hand_integral_pose_estimation_tpu_torch.config import Config
from hand_integral_pose_estimation_tpu_torch.interop.snapshot import (
    load_pose_snapshot,
)
from hand_integral_pose_estimation_tpu_torch.models import get_pose_net
from hand_integral_pose_estimation_tpu_torch.ops.fused_head import (
    head_projection_integral,
)
from hand_integral_pose_estimation_tpu_torch.training import (
    checkpoint as ckpt,
)


def frozen_teacher(model: nn.Module,
                   cfg: Config) -> Callable[[torch.Tensor], torch.Tensor]:
    """Freeze `model` (eval mode, no parameter takes a gradient) and return
    `teacher_apply`: (B, H, W, 3) normalised patches -> (B, J, 3)
    label-space coords, computed under no_grad. Each call puts the model
    back in eval mode, so its BatchNorm uses the running statistics and
    never updates them, whatever mode a caller left it in."""
    model.eval().requires_grad_(False)
    J, D = cfg.model.num_joints, cfg.model.depth_dim

    @torch.no_grad()
    def teacher_apply(patches: torch.Tensor) -> torch.Tensor:
        model.train(False)
        feats = model(patches, return_features=True)
        weight, bias = model.final_projection()
        return head_projection_integral(feats, weight, bias, J, D)

    return teacher_apply


def make_frozen_teacher(cfg: Config, model_dir: str,
                        epoch: Optional[int] = None,
                        device: str | torch.device = "cuda"
                        ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The frozen teacher on `device` from `model_dir`: a directory of
    `cli.train`'s `snapshot_{epoch}.pth.tar` (the highest epoch unless
    `epoch` names one), or a reference `snapshot_*.pth` file
    (`interop.snapshot`). Returns `frozen_teacher`'s closure."""
    model = get_pose_net(cfg.model)
    if os.path.isfile(model_dir):
        load_pose_snapshot(model, model_dir)
    else:
        ckpt.load_checkpoint(model_dir, model, epoch=epoch)
    return frozen_teacher(model.to(torch.device(device)), cfg)
