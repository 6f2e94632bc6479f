"""Metric pipeline: patch -> camera back-projection, reference-bone rescale,
Procrustes alignment, PA-MPJPE / MPJPE, PCK / AUC.

Port of hand_integral_pose_estimation_tpu/evaluation/metrics.py: the
reference's per-sample loop (data/FreiHand/FreiHand.py:670-835) and the
FreiHAND-official EvalUtil (main/eval.py:15-106) as batched ops, and the
absolute root depth from a known bone (FreiHand.py:86-139).
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


def scale_by_root_depth(kpt: torch.Tensor, root_depth: torch.Tensor,
                        tprime: torch.Tensor) -> torch.Tensor:
    """Undo the tprime normalisation with the true root depth,
    kpt * root_depth / tprime (FreiHand.py:661-666 `scale_result`,
    method='normalize')."""
    return kpt * (root_depth / tprime)[..., None, None]


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


class PCKResult(NamedTuple):
    epe_mean: torch.Tensor     # scalar: mean over joints of per-joint mean
    epe_median: torch.Tensor   # scalar: mean over joints of per-joint median
    auc: torch.Tensor          # scalar
    pck_curve: torch.Tensor    # (steps,) mean over joints
    thresholds: torch.Tensor   # (steps,)


def _trapezoid(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Trapezoid rule over dim 0, as `jnp.trapezoid(y, x, axis=0)` forms
    it: 0.5 * sum(dx * (y[1:] + y[:-1]))."""
    dx = (x[1:] - x[:-1]).reshape(-1, *([1] * (y.dim() - 1)))
    return 0.5 * (dx * (y[1:] + y[:-1])).sum(0)


def pck_auc(pred: torch.Tensor, gt: torch.Tensor, val_min: float = 0.0,
            val_max: float = 0.05, steps: int = 100,
            vis: torch.Tensor | None = None) -> PCKResult:
    """FreiHAND-official EvalUtil measures (main/eval.py:15-106): per-joint
    euclidean distances, PCK over `steps` thresholds, the trapezoid AUC
    normalised by the range.

    pred, gt: (B, J, 3). vis: optional (B, J) visibility; invisible joints
    are left out of every statistic, and joints never visible are skipped
    (EvalUtil.feed and eval.py:81-85)."""
    d = torch.linalg.norm(gt - pred, dim=-1)                   # (B, J)
    vis = torch.ones_like(d) if vis is None else vis.to(d.dtype)
    count = vis.sum(0)                                         # (J,)
    has_data = count > 0
    safe_count = count.clamp_min(1.0)

    epe_mean_j = (d * vis).sum(0) / safe_count
    # the median over the visible entries: invisible ones sort last (+inf)
    d_sorted = torch.sort(torch.where(vis > 0, d, torch.inf), dim=0).values
    lo = ((safe_count - 1) // 2).clamp_min(0).long()
    hi = (safe_count // 2).long()
    epe_median_j = 0.5 * (d_sorted.gather(0, lo[None])[0]
                          + d_sorted.gather(0, hi[None])[0])

    thresholds = torch.linspace(val_min, val_max, steps, dtype=d.dtype,
                                device=d.device)
    ok = (d[None] <= thresholds[:, None, None]).to(d.dtype)
    pck_tj = (ok * vis[None]).sum(1) / safe_count[None]        # (steps, J)
    norm = _trapezoid(torch.ones_like(thresholds), thresholds)
    auc_j = _trapezoid(pck_tj, thresholds) / norm              # (J,)

    w = has_data.to(d.dtype)
    n_joints = w.sum().clamp_min(1.0)

    def jmean(x):
        return (x * w).sum() / n_joints

    return PCKResult(
        epe_mean=jmean(epe_mean_j),
        epe_median=jmean(torch.where(has_data, epe_median_j, 0.0)),
        auc=jmean(auc_j),
        pck_curve=(pck_tj * w[None]).sum(-1) / n_joints,
        thresholds=thresholds,
    )


def aligned_pck_auc(pred: torch.Tensor, gt: torch.Tensor, **kw) -> PCKResult:
    """Scores after `align_w_scale`, the official scorer's ALIGNED track
    (main/eval.py:184-206)."""
    return pck_auc(procrustes.align_w_scale(gt, pred), gt, **kw)


def estimate_absolute_depth(bone_length: torch.Tensor, K: torch.Tensor,
                            pre_2d_kpt: torch.Tensor,
                            bone=FreiHandJoints.ref_bone):
    """Absolute root depth from a known bone length (FreiHand.py:86-139
    `estimate_depth`). With joints n, m of the bone at pixel coords (U, V)
    and root-relative depths Z, the global depth offset t solves
    r_A t^2 + r_B t + r_C = 0, from |X_n - X_m|^2 = bone_length^2. Returns
    (depth, was_complex): the larger root, or the magnitude sqrt(C / A) of
    the complex pair when the discriminant is negative (the reference's
    np.roots branch)."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    U0, V0 = K[..., 0, 2], K[..., 1, 2]
    n, m = bone
    Un, Vn, Zn = (pre_2d_kpt[..., n, i] for i in range(3))
    Um, Vm, Zm = (pre_2d_kpt[..., m, i] for i in range(3))

    Unm = (Un - Um) / fx
    Un0 = (Un - U0) / fx
    Um0 = (Um - U0) / fx
    Vnm = (Vn - Vm) / fy
    Vn0 = (Vn - V0) / fy
    Vm0 = (Vm - V0) / fy

    r_A = Unm ** 2 + Vnm ** 2
    r_B = 2.0 * (Unm * (Un0 * Zn - Um0 * Zm) + Vnm * (Vn0 * Zn - Vm0 * Zm))
    r_C = ((Un0 * Zn - Um0 * Zm) ** 2 + (Vn0 * Zn - Vm0 * Zm) ** 2
           + (Zn - Zm) ** 2 - bone_length ** 2)

    disc = r_B ** 2 - 4.0 * r_A * r_C
    was_complex = disc < 0
    sqrt_disc = torch.sqrt(disc.abs())
    root_hi = (-r_B + sqrt_disc) / (2.0 * r_A)
    root_lo = (-r_B - sqrt_disc) / (2.0 * r_A)
    real_depth = torch.maximum(root_hi, root_lo)
    complex_mag = torch.sqrt((r_C / r_A).abs())
    return torch.where(was_complex, complex_mag, real_depth), was_complex
