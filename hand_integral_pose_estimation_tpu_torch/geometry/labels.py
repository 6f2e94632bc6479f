"""Label-space geometry: tprime normalisation, patch labels, encode/decode.

Port of hand_integral_pose_estimation_tpu/geometry/labels.py. Batched over
any leading shape; every function follows its inputs' dtype, so float64
works on the CPU.

Reference unit quirks kept for parity:
  * the label z divisor is the patch *width* (augment.py:154);
  * depth rides in millimetres through pixel space (augment.py:87, :100);
  * patch z is root-relative, z_mm - tprime (augment.py:402), undone at
    decode (augment.py:216).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hand_integral_pose_estimation_tpu_torch.config import FreiHandJoints
from hand_integral_pose_estimation_tpu_torch.geometry import (
    bbox as bbox_mod,
    camera,
    transforms,
)


def encode_labels(joints_patch: torch.Tensor, patch_width: float,
                  patch_height: float) -> torch.Tensor:
    """Patch joints -> network label x/W - 0.5, y/H - 0.5, z/W
    (augment.py:148-158)."""
    return torch.stack([joints_patch[..., 0] / patch_width - 0.5,
                        joints_patch[..., 1] / patch_height - 0.5,
                        joints_patch[..., 2] / patch_width], dim=-1)


def decode_labels(label: torch.Tensor, patch_width: float,
                  patch_height: float) -> torch.Tensor:
    """Inverse of :func:`encode_labels` (augment.py:186-194)."""
    return torch.stack([(label[..., 0] + 0.5) * patch_width,
                        (label[..., 1] + 0.5) * patch_height,
                        label[..., 2] * patch_width], dim=-1)


def patch_to_image_3d(coords_patch: torch.Tensor, trans_inv: torch.Tensor,
                      tprime: torch.Tensor) -> torch.Tensor:
    """Patch (x, y, z_rel) -> image (u, v, z_mm) (augment.py:196-217).

    Args:
        coords_patch: (..., N, 3); trans_inv: (..., 3, 3); tprime: (...,).
    """
    uv = transforms.transform_points_2d(coords_patch[..., :2], trans_inv)
    z = coords_patch[..., 2] + tprime[..., None]
    return torch.cat([uv, z[..., None]], dim=-1)


class PatchLabels(NamedTuple):
    """The non-pixel outputs of `generate_patch_image` (augment.py:358-413)."""

    joint_img: torch.Tensor             # (..., N, 3) (u, v, z_mm - tprime)
    joint_img_orig: torch.Tensor        # (..., N, 3) unrotated, root-relative z
    joint_cam_normalized: torch.Tensor  # (..., N, 3) tprime-normalised GT
    joint_patch: torch.Tensor           # (..., N, 3) after the crop
    label: torch.Tensor                 # (..., N, 3) encoded label
    tprime: torch.Tensor                # (...,)
    trans: torch.Tensor                 # (..., 3, 3) image -> patch
    trans_inv: torch.Tensor             # (..., 3, 3) patch -> image
    bbox: torch.Tensor                  # (..., 4) (cx, cy, w, h)


def compute_patch_labels(joint_cam: torch.Tensor, R: torch.Tensor,
                         K: torch.Tensor, bbox: torch.Tensor,
                         patch_width: int = 224, patch_height: int = 224,
                         scale: float = 1.0,
                         scaling_constant: float = 100.0,
                         root_idx: int = FreiHandJoints.root_idx
                         ) -> PatchLabels:
    """The label half of `generate_patch_image` (augment.py:358-413): tprime,
    the tprime-normalised camera GT, the patch joints and the label, for
    camera-frame joints (..., N, 3), rotation R, intrinsics K and crop box
    bbox (..., 4)."""
    eye = torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)
    uv_orig, z_orig, _ = camera.project_points(joint_cam, eye, K)
    z_rel = z_orig - z_orig[..., root_idx][..., None]
    joint_img_orig = torch.cat([uv_orig, z_rel[..., None]], dim=-1)

    _, z, _ = camera.project_points(joint_cam, R, K)
    tprime = bbox_mod.tprime_from_bbox(bbox, K, scaling_constant)
    joint_cam_normalized = joint_cam * (tprime / z[..., root_idx])[..., None,
                                                                   None]
    uv_s, z_s, _ = camera.project_points(joint_cam_normalized, R, K)
    joint_img = torch.cat([uv_s, (z_s - tprime[..., None])[..., None]], dim=-1)

    box = bbox.unbind(-1)
    trans = transforms.trans_from_patch(*box, patch_width, patch_height,
                                        scale=scale, inv=False)
    trans_inv = transforms.trans_from_patch(*box, patch_width, patch_height,
                                            scale=scale, inv=True)
    uv_patch = transforms.transform_points_2d(joint_img[..., :2], trans)
    joint_patch = torch.cat([uv_patch, joint_img[..., 2:3]], dim=-1)
    return PatchLabels(
        joint_img=joint_img,
        joint_img_orig=joint_img_orig,
        joint_cam_normalized=joint_cam_normalized,
        joint_patch=joint_patch,
        label=encode_labels(joint_patch, patch_width, patch_height),
        tprime=tprime,
        trans=trans,
        trans_inv=trans_inv,
        bbox=bbox,
    )


def compute_patch_labels_from_normalized(
        joint_cam_normalized: torch.Tensor, tprime: torch.Tensor,
        R: torch.Tensor, K: torch.Tensor, bbox: torch.Tensor,
        patch_width: int = 224, patch_height: int = 224,
        scale: float = 1.0) -> torch.Tensor:
    """Encoded label of cached normalised-camera joints under a new
    augmentation (augment.py:415-446
    `generate_patch_image_from_normalized`)."""
    uv_s, z_s, _ = camera.project_points(joint_cam_normalized, R, K)
    trans = transforms.trans_from_patch(*bbox.unbind(-1), patch_width,
                                        patch_height, scale=scale, inv=False)
    uv_patch = transforms.transform_points_2d(uv_s, trans)
    joint_patch = torch.cat([uv_patch, (z_s - tprime[..., None])[..., None]],
                            dim=-1)
    return encode_labels(joint_patch, patch_width, patch_height)


def patch_label_to_camera(label: torch.Tensor, trans_inv: torch.Tensor,
                          tprime: torch.Tensor, K: torch.Tensor,
                          R: torch.Tensor | None = None,
                          patch_width: int = 224, patch_height: int = 224,
                          derotate: bool = True) -> torch.Tensor:
    """Network label -> tprime-normalised camera-frame joints
    (FreiHand.py:686-725): decode, patch -> image, pixel2cam with K, and
    undo the augmentation rotation with R^T when `derotate`."""
    coords = decode_labels(label, patch_width, patch_height)
    cam = camera.pixel2cam(patch_to_image_3d(coords, trans_inv, tprime), K)
    if derotate and R is not None:
        cam = torch.einsum("...ji,...nj->...ni", R, cam)  # R^T @ cam
    return cam
