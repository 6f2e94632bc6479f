"""Offline FreiHAND-official scorer (reference: main/eval.py:167-219).

Scores a prediction file (pred.npy, evaluation_predictions.npy or
pred.json) against ground truth (ground_truth_test.npy) with the unaligned
and aligned EvalUtil measures (EPE mean, PCK curve, AUC), and writes
scores.txt under --output-dir. Port of
hand_integral_pose_estimation_tpu/cli/score.py; the same printout.

    python -m hand_integral_pose_estimation_tpu_torch.cli.score \
        --pred output/result/pred.npy \
        --gt output/result/ground_truth_test.npy
"""

from __future__ import annotations

import argparse
import json


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--pred", required=True,
                   help=".npy or pred.json prediction file")
    p.add_argument("--gt", required=True, help="ground-truth .npy")
    p.add_argument("--output-dir", default="output/result")
    return p


def load_predictions(path: str):
    """(N, J, 3) keypoints from a .npy or from the xyz list of a
    [xyz_list, verts_list] pred.json."""
    import numpy as np
    if path.endswith(".json"):
        with open(path) as f:
            xyz_list, _ = json.load(f)
        return np.asarray(xyz_list)
    return np.load(path)


def main(argv=None):
    args = build_argparser().parse_args(argv)
    import numpy as np

    from hand_integral_pose_estimation_tpu_torch.evaluation import (
        score_predictions,
    )

    pred = load_predictions(args.pred)
    gt = np.load(args.gt)
    out = score_predictions(pred, gt, output_dir=args.output_dir)
    print("Evaluation 3D KP results:")
    print(f"auc={out['xyz_auc3d']:.10f}, "
          f"mean_kp3d_avg={out['xyz_mean3d_cm']:.10f} cm")
    print("Evaluation 3D KP ALIGNED results:")
    print(f"auc={out['xyz_al_auc3d']:.10f}, "
          f"mean_kp3d_avg={out['xyz_al_mean3d_cm']:.10f} cm")
    return out


if __name__ == "__main__":
    main()
