"""Batched on-device preprocessing: augment, crop, normalise, label.

Port of hand_integral_pose_estimation_tpu/data/pipeline.py (the
reference's per-sample `DatasetLoader.__getitem__`, data/dataset.py:
83-245, with `generate_patch_image`, common/augment.py:358-413). The JAX
package vmaps a per-sample function; here the same math runs on a leading
batch dimension. One composed homography (crop after rotation) resamples
each training image once, through the two-pass warp (kernel 5 on the card).

Normalisation quirk kept for parity: the reference feeds ~[0, 255]-scale
pixels to the network (dataset.py:153-154, base.py:137), and so does this.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from hand_integral_pose_estimation_tpu_torch.config import AugmentConfig
from hand_integral_pose_estimation_tpu_torch.geometry import (
    bbox as bbox_mod,
    camera,
    labels as lbl,
    rotation,
    transforms,
)
from hand_integral_pose_estimation_tpu_torch.ops.warp import (
    warp_perspective_batch,
)


class Batch(NamedTuple):
    """What the eval step and the evaluator consume (the reference's
    `params` dict, dataset.py:177-240, as fixed-shape tensors)."""

    image: Optional[torch.Tensor]      # (B, 224, 224, 3) normalised patch
    label: torch.Tensor                # (B, J, 3) encoded GT label
    label_weight: torch.Tensor         # (B, J, 3)
    label_teacher: torch.Tensor        # (B, J, 3) pseudo-label (or zeros)
    labelled: torch.Tensor             # (B,) bool
    R: torch.Tensor                    # (B, 3, 3) augmentation rotation
    K: torch.Tensor                    # (B, 3, 3)
    joint_cam: torch.Tensor            # (B, J, 3)
    joint_cam_normalized: torch.Tensor  # (B, J, 3)
    tprime: torch.Tensor               # (B,)
    trans: torch.Tensor                # (B, 3, 3) image -> patch
    trans_inv: torch.Tensor            # (B, 3, 3) patch -> image
    bbox: torch.Tensor                 # (B, 4)
    ref_bone_len: torch.Tensor         # (B,)


def channel_constant(values, like: torch.Tensor) -> torch.Tensor:
    """(C,) tensor of `values` on `like`'s device, written by fill kernels:
    a blocking host-to-device copy would wait for the stream to drain."""
    return torch.stack([torch.full((), float(v), dtype=like.dtype,
                                   device=like.device) for v in values])


def _normalise(patch: torch.Tensor, color_scale: torch.Tensor,
               acfg: AugmentConfig) -> torch.Tensor:
    mean = channel_constant(acfg.pixel_mean, patch)
    std = channel_constant(acfg.pixel_std, patch)
    return torch.clamp((patch - mean) / std * color_scale, 0.0, 255.0)


def _resolve_bbox(joint_cam, R, K, bbox_detector, pad_factor):
    """The detector box if given, else the box of the projected (rotated)
    joints (augment.py:376-382)."""
    if bbox_detector is not None:
        return bbox_detector
    uv, _, _ = camera.project_points(joint_cam, R, K)
    return bbox_mod.bbox_from_keypoints(uv, torch.ones_like(uv[..., 0]),
                                        pad_factor=pad_factor)


def _labels_one(jc, K, bb_det, teacher_jcn, R, acfg: AugmentConfig,
                patch_hw):
    """Label and geometry pass for a batch (the JAX package vmaps it per
    sample): patch labels, the teacher label under the same augmentation,
    the crop box and the one composed homography image -> rotated image ->
    patch."""
    ph, pw = patch_hw
    bb = _resolve_bbox(jc, R, K, bb_det, acfg.pad_factor)
    out = lbl.compute_patch_labels(
        jc, R, K, bb, patch_width=pw, patch_height=ph, scale=acfg.scale,
        scaling_constant=acfg.scaling_constant)
    H_total = out.trans @ transforms.rotation_homography(K, R)
    if teacher_jcn is None:
        label_teacher = torch.zeros_like(out.label)
    else:
        label_teacher = lbl.compute_patch_labels_from_normalized(
            teacher_jcn, out.tprime, R, K, bb, patch_width=pw,
            patch_height=ph, scale=acfg.scale)
    return out, label_teacher, bb, H_total


def make_train_batch(generator: torch.Generator, images: torch.Tensor,
                     joint_cam: torch.Tensor, K: torch.Tensor,
                     bbox_detector: Optional[torch.Tensor],
                     labelled: torch.Tensor,
                     teacher_cam_normalized: Optional[torch.Tensor],
                     ref_bone_len: torch.Tensor,
                     acfg: AugmentConfig = AugmentConfig(),
                     patch_hw=(224, 224)) -> Batch:
    """Augmented training batch on the device (dataset.py:117-175 in
    filtered-teacher mode): the GT label and the teacher label are made
    under the SAME rotation, box and colour jitter.

    `generator` lives on the compute device and draws every sample's
    rotation (augment.py:252-280) and colour scale (augment.py:246-248);
    the tensors are as `make_train_batch_with` takes them."""
    B = images.shape[0]
    R = rotation.sample_rotation_matrix(
        generator, B, acfg.rot_prob, acfg.z_rot_range,
        acfg.arbitrary_rot_range, dtype=K.dtype)
    color = rotation.sample_color_scale(generator, B, acfg.color_factor)
    return make_train_batch_with(R, color, images, joint_cam, K,
                                 bbox_detector, labelled,
                                 teacher_cam_normalized, ref_bone_len, acfg,
                                 patch_hw)


def make_train_batch_with(R: torch.Tensor, color: torch.Tensor,
                          images: torch.Tensor, joint_cam: torch.Tensor,
                          K: torch.Tensor,
                          bbox_detector: Optional[torch.Tensor],
                          labelled: torch.Tensor,
                          teacher_cam_normalized: Optional[torch.Tensor],
                          ref_bone_len: torch.Tensor,
                          acfg: AugmentConfig = AugmentConfig(),
                          patch_hw=(224, 224)) -> Batch:
    """`make_train_batch` with the augmentation given: R (B, 3, 3) and the
    colour scale (B, 3).

    images (B, H, W, 3) uint8 or float; joint_cam (B, J, 3) camera-frame GT;
    K (B, 3, 3); bbox_detector (B, 4) squared, padded detector boxes or None
    to box the projected rotated joints; labelled (B,) bool;
    teacher_cam_normalized (B, J, 3) cached pseudo-GT or None; ref_bone_len
    (B,). All on one device; geometry follows K's dtype, the patch is
    float32. The warp is the two-pass kernel on the card and its plain
    version on the CPU (`warp_perspective_batch`'s "auto")."""
    B, J = joint_cam.shape[0], joint_cam.shape[1]
    out, label_teacher, bb, H_total = _labels_one(
        joint_cam, K, bbox_detector, teacher_cam_normalized, R, acfg,
        patch_hw)
    patch = warp_perspective_batch(images.float(), H_total, patch_hw)
    patch = _normalise(patch, color.to(patch.dtype)[:, None, None, :], acfg)
    return Batch(
        image=patch,
        label=out.label,
        label_weight=torch.ones(B, J, 3, dtype=patch.dtype,
                                device=patch.device),
        label_teacher=label_teacher,
        labelled=labelled,
        R=R,
        K=K,
        joint_cam=joint_cam,
        joint_cam_normalized=out.joint_cam_normalized,
        tprime=out.tprime,
        trans=out.trans,
        trans_inv=out.trans_inv,
        bbox=bb,
        ref_bone_len=ref_bone_len,
    )


def make_eval_batch(images: torch.Tensor, joint_cam: torch.Tensor,
                    K: torch.Tensor, bbox_detector: Optional[torch.Tensor],
                    ref_bone_len: torch.Tensor,
                    acfg: AugmentConfig = AugmentConfig(),
                    patch_hw=(224, 224)) -> Batch:
    """Deterministic test batch: R = I and no colour jitter (dataset.py:115).

    images (B, H, W, 3) uint8 or float on the compute device; joint_cam
    (B, J, 3), K (B, 3, 3), bbox_detector (B, 4) or None, ref_bone_len (B,)
    on the same device. Geometry follows K's dtype; the patch is float32.
    """
    B, J = joint_cam.shape[0], joint_cam.shape[1]
    eye = torch.eye(3, dtype=K.dtype, device=K.device).expand(B, 3, 3)
    out, _, bb, _ = _labels_one(joint_cam, K, bbox_detector, None, eye, acfg,
                                patch_hw)
    # R == I makes the rotation homography the identity, so the whole map is
    # the axis-aligned crop affine `trans`: two matmuls suffice
    patch = warp_perspective_batch(images.float(), out.trans, patch_hw,
                                   method="affine")
    patch = _normalise(patch, torch.ones(3, dtype=patch.dtype,
                                         device=patch.device), acfg)
    return Batch(
        image=patch,
        label=out.label,
        label_weight=torch.ones(B, J, 3, dtype=patch.dtype,
                                device=patch.device),
        label_teacher=torch.zeros(B, J, 3, dtype=patch.dtype,
                                  device=patch.device),
        labelled=torch.ones(B, dtype=torch.bool, device=patch.device),
        R=eye.clone(),
        K=K,
        joint_cam=joint_cam,
        joint_cam_normalized=out.joint_cam_normalized,
        tprime=out.tprime,
        trans=out.trans,
        trans_inv=out.trans_inv,
        bbox=bb,
        ref_bone_len=ref_bone_len,
    )
