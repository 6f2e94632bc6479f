"""Test-split evaluation, the FreiHAND-challenge dump and their artifacts.

Port of `evaluate_test_split` and `evaluate_challenge` in
hand_integral_pose_estimation_tpu/evaluation/evaluator.py (the reference's
`FreiHand.evaluate`, FreiHand.py:670-835, and `evaluate_evaluations`,
FreiHand.py:853-917), and the offline scorer `score_predictions`
(main/eval.py:167-219). The math runs on the CPU in the dtype of the
collected arrays.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from hand_integral_pose_estimation_tpu_torch.evaluation import metrics
from hand_integral_pose_estimation_tpu_torch.geometry import (
    bbox as bbox_mod,
    labels as lbl,
    transforms,
)


def evaluate_test_split(coords_label: np.ndarray, batch,
                        result_dir: Optional[str] = None,
                        patch_hw=(224, 224)) -> dict:
    """Protocol #1 / #2 evaluation of collected test-split predictions.

    Args:
        coords_label: (N, J, 3) integral outputs in label space.
        batch: merged Batch of numpy arrays (from `Tester.run`) with
            trans_inv / tprime / K / R / joint_cam / ref_bone_len.
        result_dir: when set, writes the reference's artifacts
            (ground_truth_test.npy, pred.npy, pred_procr.npy,
            FreiHand.py:800-803, and eval_result.txt, FreiHand.py:831-835).
    """
    t = torch.as_tensor
    res = metrics.evaluate_coords(
        t(coords_label), t(batch.joint_cam), t(batch.trans_inv),
        t(batch.tprime), t(batch.K), t(batch.R), t(batch.ref_bone_len),
        patch_hw[1], patch_hw[0])
    p1 = float(res.pa_mpjpe)
    p2 = float(res.mpjpe)
    summary = {
        "pa_mpjpe": p1,
        "mpjpe": p2,
        "p1_summary": f"Protocol #1 error (PA MPJPE) >> {p1:.8f}",
        "p2_summary": f"Protocol #2 error (MPJPE) >> {p2:.8f}",
    }
    if result_dir:
        os.makedirs(result_dir, exist_ok=True)
        np.save(os.path.join(result_dir, "ground_truth_test.npy"),
                np.asarray(batch.joint_cam))
        np.save(os.path.join(result_dir, "pred.npy"), res.pred_cam.numpy())
        np.save(os.path.join(result_dir, "pred_procr.npy"),
                res.pred_cam_aligned.numpy())
        with open(os.path.join(result_dir, "eval_result.txt"), "w") as f:
            f.write(summary["p1_summary"] + "\n")
            f.write(summary["p2_summary"] + "\n")
    return summary


def evaluate_challenge(coords_label: np.ndarray, bbox: np.ndarray,
                       K: np.ndarray, ref_bone_len: np.ndarray,
                       result_dir: str = ".",
                       pred_name: str = "pred.json",
                       scaling_constant: float = 100.0,
                       patch_hw=(224, 224),
                       num_verts: int = 778) -> np.ndarray:
    """Challenge prediction dump (FreiHand.py:853-917): patch -> image ->
    camera back-projection with the box-derived tprime (no rotation at
    evaluation), the bone-(9, 10) rescale to the given scale, and a
    [xyz_list, verts_list] pred.json with zero vertices, beside
    evaluation_predictions.npy. Returns the (N, J, 3) predictions."""
    t = torch.as_tensor
    bbox = t(bbox)
    K = t(K)
    trans_inv = transforms.trans_from_patch(
        bbox[:, 0], bbox[:, 1], bbox[:, 2], bbox[:, 3], patch_hw[1],
        patch_hw[0], scale=1.0, inv=True)
    tprime = bbox_mod.tprime_from_bbox(bbox, K, scaling_constant)
    cam = lbl.patch_label_to_camera(t(coords_label), trans_inv, tprime, K,
                                    R=None, patch_width=patch_hw[1],
                                    patch_height=patch_hw[0], derotate=False)
    preds = metrics.scale_by_ref_bone(cam, t(ref_bone_len)).numpy()

    os.makedirs(result_dir, exist_ok=True)
    np.save(os.path.join(result_dir, "evaluation_predictions.npy"), preds)
    verts = [np.zeros((num_verts, 3)).tolist()] * preds.shape[0]
    with open(os.path.join(result_dir, pred_name), "w") as f:
        json.dump([[p.tolist() for p in preds], verts], f)
    return preds


def score_predictions(pred: np.ndarray, gt: np.ndarray,
                      output_dir: Optional[str] = None) -> dict:
    """Offline scorer (main/eval.py:167-219): the unaligned and aligned
    EvalUtil measures over metric 3D keypoints (N, J, 3); writes
    scores.txt, in the JAX package's format, when `output_dir` is set."""
    pred, gt = torch.as_tensor(pred), torch.as_tensor(gt)
    raw = metrics.pck_auc(pred, gt)
    al = metrics.aligned_pck_auc(pred, gt)
    out = {
        "xyz_mean3d_cm": float(raw.epe_mean) * 100.0,
        "xyz_auc3d": float(raw.auc),
        "xyz_al_mean3d_cm": float(al.epe_mean) * 100.0,
        "xyz_al_auc3d": float(al.auc),
    }
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "scores.txt"), "w") as f:
            f.write(f"xyz_mean3d: {out['xyz_mean3d_cm']:f}\n")
            f.write(f"xyz_auc3d: {out['xyz_auc3d']:f}\n")
            f.write(f"xyz_al_mean3d: {out['xyz_al_mean3d_cm']:f}\n")
            f.write(f"xyz_al_auc3d: {out['xyz_al_auc3d']:f}\n")
    return out
