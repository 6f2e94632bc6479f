"""Metric pipeline: patch -> camera back-projection, reference-bone rescale,
Procrustes alignment, PA-MPJPE / MPJPE.

Port of the test-split part of
hand_integral_pose_estimation_tpu/evaluation/metrics.py (the reference's
per-sample loop, data/FreiHand/FreiHand.py:670-835, as batched ops). The
PCK/AUC scorer and the absolute-depth estimate wait for a later port.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hand_integral_pose_estimation_tpu_torch.config import FreiHandJoints
from hand_integral_pose_estimation_tpu_torch.geometry import (
    labels as lbl,
    procrustes,
)


def backproject_to_camera(coords_label: torch.Tensor,
                          trans_inv: torch.Tensor, tprime: torch.Tensor,
                          K: torch.Tensor, R: torch.Tensor,
                          patch_width: int = 224,
                          patch_height: int = 224) -> torch.Tensor:
    """Label-space coords -> tprime-normalised camera frame, de-rotated
    (FreiHand.py:686-725)."""
    return lbl.patch_label_to_camera(coords_label, trans_inv, tprime, K, R,
                                     patch_width, patch_height, derotate=True)


def scale_by_ref_bone(kpt: torch.Tensor, ref_bone_len: torch.Tensor,
                      bone=FreiHandJoints.ref_bone) -> torch.Tensor:
    """Rescale so that |kpt[a] - kpt[b]| == ref_bone_len
    (FreiHand.py:632-668 `scale_result`, method='scale')."""
    a, b = bone
    pred_len = torch.linalg.norm(kpt[..., a, :] - kpt[..., b, :], dim=-1)
    return kpt * (ref_bone_len / pred_len)[..., None, None]


class EvalResult(NamedTuple):
    pa_mpjpe: torch.Tensor          # scalar, protocol #1 (FreiHand.py:806)
    mpjpe: torch.Tensor             # scalar, protocol #2 (FreiHand.py:807)
    per_sample_pa: torch.Tensor     # (B,)
    per_sample_raw: torch.Tensor    # (B,)
    pred_cam: torch.Tensor          # (B, J, 3) bone-rescaled predictions
    pred_cam_aligned: torch.Tensor  # (B, J, 3) Procrustes-aligned


def evaluate_coords(coords_label: torch.Tensor, gt_joint_cam: torch.Tensor,
                    trans_inv: torch.Tensor, tprime: torch.Tensor,
                    K: torch.Tensor, R: torch.Tensor,
                    ref_bone_len: torch.Tensor, patch_width: int = 224,
                    patch_height: int = 224) -> EvalResult:
    """Back-project, rescale to the reference bone, then MPJPE on the raw
    and PA-MPJPE on the Procrustes-aligned (optimal scale) predictions:
    the mean over samples and joints of the per-joint euclidean distance
    (FreiHand.py:670-810)."""
    pred_cam = backproject_to_camera(coords_label, trans_inv, tprime, K, R,
                                     patch_width, patch_height)
    pred_cam = scale_by_ref_bone(pred_cam, ref_bone_len)
    aligned = procrustes.procrustes_align(gt_joint_cam, pred_cam)
    e_pa = torch.linalg.norm(aligned - gt_joint_cam, dim=-1)
    e_raw = torch.linalg.norm(pred_cam - gt_joint_cam, dim=-1)
    return EvalResult(
        pa_mpjpe=e_pa.mean(),
        mpjpe=e_raw.mean(),
        per_sample_pa=e_pa.mean(-1),
        per_sample_raw=e_raw.mean(-1),
        pred_cam=pred_cam,
        pred_cam_aligned=aligned,
    )
