"""Teacher pseudo-labels with the rotation-variance filter.

Port of hand_integral_pose_estimation_tpu/distill/teacher_labels.py (the
reference's main/generate_filtered_teacher_labels.py:403-509): every image
goes through the frozen teacher under 21 evenly spaced z-rotations, each
prediction is back-projected to the normalised camera frame, a sample is
kept if the total variance of its predictions over the rotations is below
the threshold, and its pseudo-label is their mean. All B x T rotated crops
of a batch come from one warp launch and go through one teacher forward.

On the card the rotated crops are kernel 5 (`ops/warp.py:
warp_normalise_batch`) with its normalising epilogue: the sweep's
clip(patch - mean, 0, 255) is the training `_normalise` at std 1 and a
colour scale of 1, exactly. The teacher decodes through kernel 3
(`training.teacher`). The JAX package's sweep off the TPU warps with the
single-pass bilinear filter; this one always takes the two-pass filter of
the TPU kernel (ROADMAP Queue 3 item 4). `quantized_teacher_apply` gives
an int8 teacher, calibrated on the sweep's own patches. With `mesh` (a
`parallel.Mesh`) the sweep of a batch is split over its data axis
(`parallel.over_data`): each rank warps, forwards and back-projects its
rows, with no collective but the gather of the results.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from hand_integral_pose_estimation_tpu_torch.config import AugmentConfig
from hand_integral_pose_estimation_tpu_torch.geometry import (
    bbox as bbox_mod,
    camera,
    labels as lbl,
    rotation,
    transforms,
)
from hand_integral_pose_estimation_tpu_torch.ops.fused_head import (
    head_projection_integral,
)
from hand_integral_pose_estimation_tpu_torch.ops.warp import (
    warp_axis_aligned_batch,
    warp_normalise_batch,
)
from hand_integral_pose_estimation_tpu_torch.parallel import over_data
from hand_integral_pose_estimation_tpu_torch.quantize import (
    calibrate,
    quantize_params,
    quantized_calls,
)

#: side of the factored sweep's shared base crop
BASE_SIDE = 320


class FilteredLabels(NamedTuple):
    joint_cam_normalized: torch.Tensor  # (B, J, 3) pseudo-GT (mean over T)
    tprime: torch.Tensor                # (B,)
    variance: torch.Tensor              # (B,) total variance over rotations
    keep: torch.Tensor                  # (B,) labelled or variance < thr
    per_rotation: torch.Tensor          # (B, T, J, 3) back-projections


def sweep_thetas(num_rotations: int, rotation_range: float) -> np.ndarray:
    """The sweep's angles: `num_rotations` evenly spaced over
    [-rotation_range, rotation_range] (the reference's np.arange(-0.52,
    0.53, 0.05), :467), float64."""
    return np.linspace(-rotation_range, rotation_range, num_rotations)


def sweep_patches(images: torch.Tensor, K: torch.Tensor, bbox: torch.Tensor,
                  acfg: AugmentConfig, thetas, cover_range: float,
                  patch_hw=(224, 224), rotation_mode: str = "factored",
                  method: str = "auto") -> torch.Tensor:
    """The (B * T, ph, pw, 3) normalised crops of a sweep, ordered (b, t):
    sample b's box rotated by thetas[t] about the principal point.

    "composed" warps the stored frame once per (sample, rotation) by
    trans @ K R K^-1. "factored" (the default) first crops each frame
    axis-aligned onto a `BASE_SIDE`² float32 base covering every rotated
    crop of the full sweep (`cover_range`, so a rotation's crop is the same
    in any subset of the sweep), with two products
    (`warp_axis_aligned_batch`), then warps each base by
    trans @ K R K^-1 @ transS^-1. `method` goes to `warp_normalise_batch`:
    "auto" launches kernel 5 for CUDA tensors, "twopass" is its plain
    version."""
    B = images.shape[0]
    ph, pw = patch_hw
    dt = K.dtype
    thetas = torch.as_tensor(np.asarray(thetas), dtype=dt, device=K.device)
    T = thetas.shape[0]
    Rz = rotation.rotation_z(thetas)                          # (T, 3, 3)
    cx, cy, bw, bh = bbox.unbind(-1)
    trans = transforms.trans_from_patch(cx, cy, bw, bh, pw, ph,
                                        scale=acfg.scale)     # (B, 3, 3)
    rot_h = transforms.rotation_homography(K[:, None], Rz[None])
    if rotation_mode == "composed":
        src = images.repeat_interleave(T, dim=0)
        H = trans[:, None] @ rot_h
    elif rotation_mode == "factored":
        # the base covers every rotated crop: rotation is about the
        # principal point (K R K^-1), so a crop square of side L centred at
        # c needs its own rotated extent plus 2 sin(range / 2) |c - pp|, the
        # arc its centre sweeps; the extent of a w x h rect rotated by up to
        # the range peaks at min(range, atan(h / w)) per axis
        sweep = 2.0 * math.sin(cover_range / 2.0)
        d = torch.linalg.vector_norm(bbox[:, 0:2] - K[:, 0:2, 2], dim=-1)
        margin = sweep * d + 4.0
        w_sc, h_sc = bw * acfg.scale, bh * acfg.scale
        th_w = torch.clamp(torch.atan2(h_sc, w_sc), max=cover_range)
        th_h = torch.clamp(torch.atan2(w_sc, h_sc), max=cover_range)
        wS = w_sc * torch.cos(th_w) + h_sc * torch.sin(th_w) + 2.0 * margin
        hS = h_sc * torch.cos(th_h) + w_sc * torch.sin(th_h) + 2.0 * margin
        S = BASE_SIDE
        transS = transforms.trans_from_patch(cx, cy, wS, hS, S, S)
        transS_inv = transforms.trans_from_patch(cx, cy, wS, hS, S, S,
                                                 inv=True)
        base = warp_axis_aligned_batch(images.to(torch.float32), transS,
                                       (S, S))
        src = base.repeat_interleave(T, dim=0)
        H = trans[:, None] @ rot_h @ transS_inv[:, None]
    else:
        raise ValueError(f"unknown rotation_mode {rotation_mode!r}")
    C = images.shape[-1]
    ones = torch.ones(B * T, C, dtype=torch.float32, device=images.device)
    return warp_normalise_batch(src.contiguous(), H.reshape(B * T, 3, 3),
                                patch_hw, ones, acfg.pixel_mean, (1.0,) * C,
                                method=method)


def rotation_sweep_camera(
    teacher_apply: Callable[[torch.Tensor], torch.Tensor],
    images: torch.Tensor,
    K: torch.Tensor,
    bbox: torch.Tensor,
    acfg: AugmentConfig,
    thetas,
    cover_range: float,
    patch_hw=(224, 224),
    rotation_mode: str = "factored",
    method: str = "auto",
    mesh=None,
):
    """Per-rotation camera-frame teacher predictions for one batch, the
    core of the filter (single pass and cascade): the sweep's crops
    (`sweep_patches`), the teacher, and each prediction back-projected to
    the normalised camera frame with its rotation undone
    (generate_filtered_teacher_labels.py:467-489, convert_to_cam_coord
    :124-131). Returns (cam (B, T, J, 3), tprime (B,)). `mesh` splits the
    batch over its data axis; every rank returns the whole batch's."""
    if mesh is not None:
        return over_data(
            lambda im, Ki, bb: rotation_sweep_camera(
                teacher_apply, im, Ki, bb, acfg, thetas, cover_range,
                patch_hw, rotation_mode, method),
            mesh, images, K, bbox)
    B = images.shape[0]
    ph, pw = patch_hw
    T = len(thetas)
    patches = sweep_patches(images, K, bbox, acfg, thetas, cover_range,
                            patch_hw, rotation_mode, method)
    coords = teacher_apply(patches)                         # (B*T, J, 3)
    coords = coords.reshape(B, T, coords.shape[-2], 3).to(K.dtype)
    cx, cy, bw, bh = bbox.unbind(-1)
    trans_inv = transforms.trans_from_patch(cx, cy, bw, bh, pw, ph,
                                            scale=acfg.scale, inv=True)
    tprime = bbox_mod.tprime_from_bbox(bbox, K, acfg.scaling_constant)
    Rz = rotation.rotation_z(torch.as_tensor(np.asarray(thetas), dtype=K.dtype,
                                             device=K.device))
    cam = lbl.patch_label_to_camera(
        coords, trans_inv[:, None], tprime[:, None], K[:, None],
        Rz[None].expand(B, T, 3, 3), pw, ph)
    return cam, tprime


def quantized_teacher_apply(
    model: torch.nn.Module,
    images: torch.Tensor,
    K: torch.Tensor,
    bbox: torch.Tensor,
    acfg: AugmentConfig,
    num_joints: int,
    depth_dim: int,
    num_rotations: int = 21,
    rotation_range: float = 0.52,
    patch_hw=(224, 224),
    rotation_mode: str = "factored",
    calib_rotations: int = 5,
    forward: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    method: str = "auto",
):
    """An int8 teacher for the variance filter (JAX
    distill/teacher_labels.py:272-350).

    Calibration taps the teacher's conv inputs during one float sweep over
    `images` (a representative batch, with K and bbox), so the scales come
    from the filter's own warped, normalised patches, on
    `calib_rotations` angles of the sweep spread evenly over it, endpoints
    included. The heatmap projection (`head.final_layer`) stays in float.
    `forward` is the float teacher body, patches -> (N, J, 3): by default
    the pose net's features and the fused projection + decode (kernel 3 on
    the card), which reads the projection's weights directly. `model` is
    put in eval mode.

    Returns `(teacher_apply, Quantized)`: patches -> (N, J, 3) with the
    int8 convs, and the bundle."""
    model.eval()
    if forward is None:
        @torch.no_grad()
        def forward(patches):
            feats = model(patches, return_features=True)
            weight, bias = model.final_projection()
            return head_projection_integral(feats, weight, bias, num_joints,
                                            depth_dim)

    full = sweep_thetas(num_rotations, rotation_range)
    idx = np.unique(np.round(np.linspace(
        0, num_rotations - 1, min(calib_rotations, num_rotations))
    ).astype(int))

    def calib_fn(im):
        return rotation_sweep_camera(forward, im, K, bbox, acfg, full[idx],
                                     rotation_range, patch_hw, rotation_mode,
                                     method)[0]

    amax = calibrate(calib_fn, images, model=model)
    q = dataclasses.replace(
        quantize_params(model, amax, skip=("head.final_layer",)),
        root_type=type(model))
    calls = quantized_calls(q, model)

    def teacher_apply(patches: torch.Tensor) -> torch.Tensor:
        with calls:
            return forward(patches)

    return teacher_apply, q


def camera_project(joint_cam: torch.Tensor, K: torch.Tensor):
    """camera.project_points with no rotation: (uv, z_mm, xyz)."""
    eye = torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)
    return camera.project_points(joint_cam, eye, K)


def gt_normalized(joint_cam: torch.Tensor, K: torch.Tensor,
                  tprime: torch.Tensor) -> torch.Tensor:
    """Labelled rows' pseudo-label: the GT joints normalised at theta = 0
    (:455-465), joint_cam * tprime / z_root."""
    _, z, _ = camera_project(joint_cam, K)
    return joint_cam * (tprime / z[..., 9])[:, None, None]


def generate_filtered_labels(
    teacher_apply: Callable[[torch.Tensor], torch.Tensor],
    images: torch.Tensor,
    K: torch.Tensor,
    bbox: torch.Tensor,
    labelled: torch.Tensor,
    joint_cam: torch.Tensor,
    acfg: AugmentConfig = AugmentConfig(),
    num_rotations: int = 21,
    rotation_range: float = 0.52,
    variance_threshold: float = 1e-4,
    patch_hw=(224, 224),
    rotation_mode: str = "factored",
    method: str = "auto",
    mesh=None,
) -> FilteredLabels:
    """Variance-filtered pseudo-labels for one batch.

    teacher_apply: (N, ph, pw, 3) normalised patches -> (N, J, 3)
    label-space coords. images (B, H, W, 3) uint8 or float RGB, K (B, 3,
    3), bbox (B, 4) crop boxes (fixed across rotations, like the
    reference's faster_rcnn_bbox), labelled (B,) bool, joint_cam (B, J, 3)
    GT joints (read for labelled rows only), all on one device. Labelled
    rows keep their GT normalisation and are always kept. `rotation_mode`
    and `method` as in `sweep_patches`; `mesh` as in
    `rotation_sweep_camera`."""
    cam, tprime = rotation_sweep_camera(
        teacher_apply, images, K, bbox, acfg,
        sweep_thetas(num_rotations, rotation_range), rotation_range,
        patch_hw, rotation_mode, method, mesh)
    variance = cam.var(dim=1, unbiased=False).sum(dim=(-2, -1))   # (B,)
    mean_pred = cam.mean(dim=1)
    gt_norm = gt_normalized(joint_cam.to(K.dtype), K, tprime)
    lab = labelled.to(torch.bool)
    return FilteredLabels(
        joint_cam_normalized=torch.where(lab[:, None, None], gt_norm,
                                         mean_pred),
        tprime=tprime,
        variance=torch.where(lab, torch.zeros_like(variance), variance),
        keep=lab | (variance < variance_threshold),
        per_rotation=cam,
    )


def teacher_error_vs_variance(per_rotation: torch.Tensor,
                              joint_cam_normalized_gt: torch.Tensor):
    """Per-sample (variance, MPJPE against GT), the statistic behind the
    reference's variance-threshold study (:193-401
    `get_variance_measure`)."""
    mean_pred = per_rotation.mean(dim=1)
    variance = per_rotation.var(dim=1, unbiased=False).sum(dim=(-2, -1))
    mpjpe = torch.linalg.vector_norm(mean_pred - joint_cam_normalized_gt,
                                     dim=-1).mean(-1)
    return variance, mpjpe


def filter_precision_curve(variance: torch.Tensor, mpjpe: torch.Tensor,
                           thresholds: torch.Tensor,
                           mpjpe_threshold: float = 0.005):
    """Percent kept and percent of the kept with MPJPE < `mpjpe_threshold`
    at each variance threshold, the curves of `_plot` (:145-191)."""
    kept = variance[None, :] < thresholds[:, None]            # (T, B)
    good = kept & (mpjpe[None, :] < mpjpe_threshold)
    kept_n = kept.sum(-1).clamp_min(1)
    return (kept.to(variance.dtype).mean(-1) * 100.0,
            100.0 * good.sum(-1).to(variance.dtype) / kept_n)
