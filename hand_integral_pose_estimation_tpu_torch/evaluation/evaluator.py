"""Test-split evaluation and its artifacts.

Port of `evaluate_test_split` in
hand_integral_pose_estimation_tpu/evaluation/evaluator.py (the reference's
`FreiHand.evaluate`, FreiHand.py:670-835). The metric math runs on the CPU
in the dtype of the collected arrays. The challenge dump and the offline
scorer wait for a later port.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from hand_integral_pose_estimation_tpu_torch.evaluation import metrics


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
