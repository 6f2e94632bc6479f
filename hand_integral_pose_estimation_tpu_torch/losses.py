"""Training losses: integral L1, the semi-supervised combined loss, MPJPE.

Port of hand_integral_pose_estimation_tpu/losses.py (the reference's
common/nets/loss.py:69-277). The labelled / unlabelled split is a
per-sample mask over a fixed-shape batch, as in the JAX package, instead
of the reference's boolean indexing. Every function is pure tensor math on
(B, J, 3) inputs.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from hand_integral_pose_estimation_tpu_torch.geometry import (
    camera,
    labels as lbl,
)
from hand_integral_pose_estimation_tpu_torch.ops.integral import (
    softmax_integral,
)


def compute_mpjpe(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean per-joint position error in label space (loss.py:93-96)."""
    return torch.linalg.vector_norm(pred - gt, dim=-1).mean()


def joint_location_loss(coord_out: torch.Tensor, gt_coord: torch.Tensor,
                        gt_vis: torch.Tensor) -> torch.Tensor:
    """Visibility-masked L1 in label space, summed over joints and averaged
    over the batch (reference loss.py:69-91 `JointLocationLoss`).

    Args:
        coord_out, gt_coord, gt_vis: (B, J, 3).
    """
    return (torch.abs(coord_out - gt_coord) * gt_vis).sum() / coord_out.shape[0]


def heatmap_joint_loss(heatmap: torch.Tensor, gt_coord: torch.Tensor,
                       gt_vis: torch.Tensor, num_joints: int,
                       depth: int) -> torch.Tensor:
    """JointLocationLoss straight from NHWC heatmap logits."""
    return joint_location_loss(softmax_integral(heatmap, num_joints, depth),
                               gt_coord, gt_vis)


def prepare_panet_input(coord_label: torch.Tensor, trans_inv: torch.Tensor,
                        tprime: torch.Tensor, K: torch.Tensor,
                        patch_width: int = 224,
                        patch_height: int = 224) -> torch.Tensor:
    """Label-space coords -> mean-centred camera-frame points for PANet
    (augment.py:556-574): decode, patch -> image, back-project with K. The
    reference's tprime subtraction from z is a per-sample constant that the
    centring removes, so it is left out; no derotation, as in the
    reference."""
    coords = lbl.decode_labels(coord_label, patch_width, patch_height)
    img = lbl.patch_to_image_3d(coords, trans_inv, tprime)
    cam = camera.pixel2cam(img, K)
    return cam - cam.mean(dim=-2, keepdim=True)


class CombinedLossOutput(NamedTuple):
    loss: torch.Tensor
    student_mpjpe: torch.Tensor
    teacher_mpjpe: torch.Tensor
    loss_supervised: torch.Tensor
    loss_unsupervised: torch.Tensor


def combined_loss(coord_out: torch.Tensor, coord_teacher: torch.Tensor,
                  gt_coord: torch.Tensor, gt_vis: torch.Tensor,
                  labelled: torch.Tensor, trans_inv: torch.Tensor,
                  tprime: torch.Tensor, K: torch.Tensor,
                  panet_apply: Optional[Callable[[torch.Tensor],
                                                 torch.Tensor]] = None,
                  lam: float = 0.0, patch_width: int = 224,
                  patch_height: int = 224) -> CombinedLossOutput:
    """Semi-supervised loss (loss.py:99-203 `CombinedLoss`):

      * labelled samples: L1(student, GT label) * vis;
      * unlabelled samples: L1(student, teacher label) * vis
        + lam * L1(camera-frame student, PANet(camera-frame student)) * vis;
      * total = sum / batch.

    The PANet term runs on the whole batch and is masked to the unlabelled
    rows; it is skipped when `panet_apply` is None or `lam` is 0.
    """
    B = coord_out.shape[0]
    lab = labelled.to(coord_out.dtype)[:, None, None]
    # diagnostics only (the reference computes them under no_grad,
    # loss.py:134-136)
    with torch.no_grad():
        student_mpjpe = compute_mpjpe(coord_out, gt_coord)
        teacher_mpjpe = compute_mpjpe(coord_teacher, gt_coord)
    loss_sup = (torch.abs(coord_out - gt_coord) * gt_vis * lab).sum()
    l_teacher = (torch.abs(coord_out - coord_teacher) * gt_vis
                 * (1 - lab)).sum()
    if panet_apply is not None and lam != 0.0:
        pin = prepare_panet_input(coord_out, trans_inv, tprime, K,
                                  patch_width, patch_height)
        recon = panet_apply(pin)
        l_panet = (lam * torch.abs(pin - recon) * gt_vis * (1 - lab)).sum()
        loss_unsup = l_teacher + l_panet
    else:
        loss_unsup = l_teacher
    return CombinedLossOutput(
        loss=(loss_sup + loss_unsup) / B,
        student_mpjpe=student_mpjpe,
        teacher_mpjpe=teacher_mpjpe,
        loss_supervised=loss_sup,
        loss_unsupervised=loss_unsup,
    )


@torch.no_grad()
def camera_space_diagnostic(coord_out: torch.Tensor, gt_label: torch.Tensor,
                            joint_cam_normalized: torch.Tensor,
                            trans_inv: torch.Tensor, tprime: torch.Tensor,
                            K: torch.Tensor, R: torch.Tensor,
                            patch_width: int = 224, patch_height: int = 224):
    """Camera-space error diagnostic (loss.py:207-277 `JointLocationLoss2`):
    both the prediction and the GT label go patch -> image -> camera.
    Returns (the summed squared error in the normalised camera frame, the
    max |GT-label round trip - joint_cam_normalized|, the quantity the
    reference asserts to 1e-6 at loss.py:259-262), outside the gradient."""
    pred_cam = lbl.patch_label_to_camera(coord_out, trans_inv, tprime, K, R,
                                         patch_width, patch_height)
    gt_cam = lbl.patch_label_to_camera(gt_label, trans_inv, tprime, K, R,
                                       patch_width, patch_height)
    consistency = torch.abs(gt_cam - joint_cam_normalized).max()
    sq = torch.sum((joint_cam_normalized - pred_cam) ** 2, dim=-1)
    return sq.sum(), consistency
