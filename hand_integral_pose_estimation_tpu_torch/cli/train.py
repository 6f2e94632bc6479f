"""Training entry point (reference: main/train.py).

    python -m hand_integral_pose_estimation_tpu_torch.cli.train --synthetic \
        --epochs 2 --steps-per-epoch 10 --device cuda
    python -m hand_integral_pose_estimation_tpu_torch.cli.train --synthetic \
        --epochs 1 --steps-per-epoch 2 --pose-resnet 18 --pose-input 64 \
        --batch-size 4 --device cpu

Port of hand_integral_pose_estimation_tpu/cli/train.py for the synthetic
split on one device. Snapshots go to `--model-dir` as
`snapshot_{epoch}.pth.tar`; `cli.test --model-dir` evaluates them. The
file-backed FreiHAND split, the detector boxes, the filtered pseudo-label
db, the live teacher, PANet, the ImageNet init, the device mesh and the YUV
transport come with later ports.
"""

from __future__ import annotations

import argparse


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--synthetic", action="store_true",
                   help="train on SyntheticFreiHand (required: the "
                        "file-backed split is not ported yet)")
    p.add_argument("--synthetic-size", type=int, default=256)
    p.add_argument("--model-dir", default="output/model_dump")
    p.add_argument("--epochs", type=int, default=None,
                   help="end epoch (default: cfg.train.end_epoch)")
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--continue", dest="continue_train", action="store_true",
                   help="resume from the latest snapshot (base.py:62-71)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--test-sweep", action="store_true",
                   help="epoch-end average-loss sweep over a synthetic test "
                        "split (main/train.py:140-163)")
    p.add_argument("--pose-resnet", type=int, default=None)
    p.add_argument("--pose-input", type=int, default=None,
                   help="square input size; the heatmap is input/4 wide "
                        "and input/4 deep")
    p.add_argument("--device", default="cuda")
    p.add_argument("--unfused-head", action="store_true",
                   help="decode the materialised heatmap (kernels 1 and 2) "
                        "instead of the fused projection + decode (kernels "
                        "3 and 4)")
    return p


def sized_config(pose_resnet=None, pose_input=None, batch_size=None):
    """Config() with the sizing flags applied as the JAX CLI applies them:
    the ResNet depth, a square input with an input/4 heatmap of input/4
    depth slots, and the training batch."""
    import dataclasses

    from hand_integral_pose_estimation_tpu_torch.config import Config

    cfg = Config()
    if batch_size:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, batch_size=batch_size))
    if pose_resnet or pose_input:
        hw = pose_input or cfg.model.input_shape[0]
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, resnet_type=pose_resnet or cfg.model.resnet_type,
            input_shape=(hw, hw), output_shape=(hw // 4, hw // 4),
            depth_dim=hw // 4))
    return cfg


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if not args.synthetic:
        raise SystemExit("only --synthetic is supported: the file-backed "
                         "FreiHAND split is not ported yet")

    import logging

    from hand_integral_pose_estimation_tpu_torch.data import SyntheticFreiHand
    from hand_integral_pose_estimation_tpu_torch.training import Trainer

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    cfg = sized_config(args.pose_resnet, args.pose_input, args.batch_size)
    dataset = SyntheticFreiHand(n=args.synthetic_size)
    test_dataset = (SyntheticFreiHand(n=32, seed=1)
                    if args.test_sweep else None)
    trainer = Trainer(cfg=cfg, dataset=dataset, model_dir=args.model_dir,
                      continue_train=args.continue_train, seed=args.seed,
                      test_dataset=test_dataset, device=args.device,
                      fuse_head=not args.unfused_head)
    trainer.fit(end_epoch=args.epochs, steps_per_epoch=args.steps_per_epoch)
    return trainer


if __name__ == "__main__":
    main()
