"""Losses. Port of hand_integral_pose_estimation_tpu/losses.py; the eval
step needs only `joint_location_loss`, the rest waits for the training
slice."""

from __future__ import annotations

import torch


def joint_location_loss(coord_out: torch.Tensor, gt_coord: torch.Tensor,
                        gt_vis: torch.Tensor) -> torch.Tensor:
    """Visibility-masked L1 in label space, summed over joints and averaged
    over the batch (reference loss.py:69-91 `JointLocationLoss`).

    Args:
        coord_out, gt_coord, gt_vis: (B, J, 3).
    """
    return (torch.abs(coord_out - gt_coord) * gt_vis).sum() / coord_out.shape[0]
