"""Detector visual smoke test (reference: main/eval_eval.py:232-257): draws
the detected hand boxes, their scores and the padded crop box over images.

    python -m hand_integral_pose_estimation_tpu_torch.cli.visualize_detections \
        --synthetic --num-images 4 --out-dir output/vis --device cuda \
        [--detector-ckpt faster_rcnn_final.pth]
    python -m hand_integral_pose_estimation_tpu_torch.cli.visualize_detections \
        --synthetic --num-images 2 --detector-resnet 18 --detector-scale 64 \
        --device cpu
    python -m hand_integral_pose_estimation_tpu_torch.cli.visualize_detections \
        --data-dir /path/to/FreiHAND --num-images 4 --device cuda

Port of hand_integral_pose_estimation_tpu/cli/visualize_detections.py.
`--data-dir` draws on the first images of the FreiHAND tree's evaluation
split (the frames the reference's main/eval_eval.py detects on) instead of
SyntheticFreiHand; the JAX CLI accepts the flag and never reads it.
matplotlib is imported when the CLI runs, not with the module.
"""

from __future__ import annotations

import argparse


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--data-dir", default=None,
                   help="FreiHAND root: draw on its evaluation split's "
                        "images instead of SyntheticFreiHand's")
    p.add_argument("--synthetic", action="store_true",
                   help="draw on SyntheticFreiHand images (the default "
                        "without --data-dir)")
    p.add_argument("--out-dir", default="output/vis")
    p.add_argument("--num-images", type=int, default=4)
    p.add_argument("--detector-ckpt", default=None,
                   help="a reference faster_rcnn_*.pth or a "
                        "cli.train_detector snapshot (random weights from "
                        "--seed if absent)")
    p.add_argument("--detector-style", choices=("torchvision", "caffe"),
                   default=None,
                   help="ResNet block variant; default: caffe for .pth "
                        "checkpoints, else torchvision")
    p.add_argument("--detector-norm", choices=("batch", "group"),
                   default="batch")
    p.add_argument("--detector-resnet", type=int, default=None)
    p.add_argument("--detector-scale", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    import dataclasses
    import os

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.patches as patches
    import matplotlib.pyplot as plt
    import numpy as np
    import torch

    from hand_integral_pose_estimation_tpu_torch.config import DetectorConfig
    from hand_integral_pose_estimation_tpu_torch.data import (
        FreiHandDataset,
        SyntheticFreiHand,
    )
    from hand_integral_pose_estimation_tpu_torch.detect import (
        build_detector,
        default_resnet_style,
        detect,
    )
    from hand_integral_pose_estimation_tpu_torch.detect.hand_detector import (
        _crop_from_detections,
    )

    base = DetectorConfig()
    scale = args.detector_scale or base.test_scale
    cfg = dataclasses.replace(
        base, resnet_type=args.detector_resnet or base.resnet_type,
        norm=args.detector_norm, freeze_bn=args.detector_norm == "batch",
        resnet_style=args.detector_style or default_resnet_style(
            args.detector_ckpt),
        test_scale=scale, test_max_size=(base.test_max_size
                                         if scale == base.test_scale
                                         else scale))
    model = build_detector(cfg, args.detector_ckpt,
                           generator=torch.Generator().manual_seed(args.seed)
                           ).to(args.device)
    if args.data_dir and not args.synthetic:
        ds = FreiHandDataset(args.data_dir, "evaluation")
    else:
        ds = SyntheticFreiHand(n=args.num_images)
    num_images = min(args.num_images, len(ds))
    host = ds.host_batch(np.arange(num_images))
    imgs = torch.from_numpy(np.ascontiguousarray(host["image"])).to(
        args.device)
    det = detect(model, imgs, cfg)
    crop = _crop_from_detections(det, imgs.shape[1:3], 1.75).cpu().numpy()
    boxes, scores = det.boxes.cpu().numpy(), det.scores.cpu().numpy()
    valid = det.valid.cpu().numpy()

    os.makedirs(args.out_dir, exist_ok=True)
    for i in range(num_images):
        fig, ax = plt.subplots()
        ax.imshow(host["image"][i])
        for b, s, v in zip(boxes[i], scores[i], valid[i]):
            if not v:
                continue
            ax.add_patch(patches.Rectangle(
                (b[0], b[1]), b[2] - b[0], b[3] - b[1],
                fill=False, edgecolor="lime"))
            ax.text(b[0], b[1] - 2, f"{s:.2f}", color="lime", fontsize=7)
        cb = crop[i]
        ax.add_patch(patches.Rectangle(
            (cb[0] - cb[2] / 2, cb[1] - cb[3] / 2), cb[2], cb[3],
            fill=False, edgecolor="red", linestyle="--"))
        ax.axis("off")
        fig.savefig(os.path.join(args.out_dir, f"det_{i}.jpg"),
                    bbox_inches="tight", dpi=110)
        plt.close(fig)
    print(f"wrote {num_images} visualisations -> {args.out_dir}")


if __name__ == "__main__":
    main()
