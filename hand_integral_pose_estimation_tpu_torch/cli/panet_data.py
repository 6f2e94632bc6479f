"""PANet training data (reference: procrustes_encoding/processing/
PANet_data_generation.py:89-120, processing/norm_lite.py,
data_splitting.py:19-27).

    python -m hand_integral_pose_estimation_tpu_torch.cli.panet_data \
        --data-dir /path/to/FreiHAND --out-dir output/panet_data

Port of hand_integral_pose_estimation_tpu/cli/panet_data.py. Writes
hand_train.npy and hand_test.npy: the GT joints of every record in the
tprime-normalised camera frame (the normalisation of the crop pipeline,
with the keypoint box at theta = 0), the last `--test-fraction` split off
as the test set.
"""

from __future__ import annotations

import argparse


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic-size", type=int, default=512)
    p.add_argument("--training-size", type=int, default=None,
                   help="override cfg.train.training_size")
    p.add_argument("--out-dir", default="output/panet_data")
    p.add_argument("--test-fraction", type=float, default=0.1,
                   help="fixed last-fraction test split (data_splitting.py)")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--max-samples", type=int, default=0, help="0 = all")
    p.add_argument("--device", default="cuda")
    return p


def normalized_joints(joint_cam, K, acfg):
    """GT joints (B, J, 3) -> joint_cam * tprime / z_root, with tprime from
    the padded box of the projected joints (norm_lite.py:54-59 and
    generate_joint_cam_normalized)."""
    import torch

    from hand_integral_pose_estimation_tpu_torch.distill.teacher_labels \
        import camera_project, gt_normalized
    from hand_integral_pose_estimation_tpu_torch.geometry import bbox as bb

    uv, _, _ = camera_project(joint_cam, K)
    box = bb.bbox_from_keypoints(uv, torch.ones_like(uv[..., 0]),
                                 pad_factor=acfg.pad_factor)
    return gt_normalized(joint_cam, K, bb.tprime_from_bbox(
        box, K, acfg.scaling_constant))


def main(argv=None):
    args = build_argparser().parse_args(argv)
    import os

    import numpy as np
    import torch

    from hand_integral_pose_estimation_tpu_torch.cli.train import load_split
    from hand_integral_pose_estimation_tpu_torch.config import Config

    cfg = Config()
    if args.training_size:
        cfg = cfg.with_training_size(args.training_size)
    dataset = load_split(args, cfg, "training")
    n = len(dataset)
    if args.max_samples:
        n = min(n, args.max_samples)
    outs = []
    for start in range(0, n, args.batch_size):
        recs = np.arange(start, min(start + args.batch_size, n))
        if hasattr(dataset, "records"):     # annotations only, no decode
            jc = np.stack([dataset.records[i].joint_cam for i in recs])
            K = np.stack([dataset.records[i].K for i in recs])
        else:
            host = dataset.host_batch(recs)
            jc, K = host["joint_cam"], host["K"]
        jc, K = (torch.from_numpy(np.asarray(a, np.float32)).to(args.device)
                 for a in (jc, K))
        outs.append(normalized_joints(jc, K, cfg.augment).cpu().numpy())
    pts = np.concatenate(outs)

    os.makedirs(args.out_dir, exist_ok=True)
    n_test = int(len(pts) * args.test_fraction)
    train, test = pts[:len(pts) - n_test], pts[len(pts) - n_test:]
    np.save(os.path.join(args.out_dir, "hand_train.npy"), train)
    np.save(os.path.join(args.out_dir, "hand_test.npy"), test)
    print(f"wrote {len(train)} train / {len(test)} test -> {args.out_dir}")
    return train, test


if __name__ == "__main__":
    main()
