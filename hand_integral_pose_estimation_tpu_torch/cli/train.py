"""Training entry point (reference: main/train.py).

    python -m hand_integral_pose_estimation_tpu_torch.cli.train --synthetic \
        --epochs 2 --steps-per-epoch 10 --device cuda
    python -m hand_integral_pose_estimation_tpu_torch.cli.train --synthetic \
        --epochs 1 --steps-per-epoch 2 --pose-resnet 18 --pose-input 64 \
        --batch-size 4 --device cpu

    python -m hand_integral_pose_estimation_tpu_torch.cli.train \
        --data-dir /path/to/FreiHAND --teacher-ckpt output/teacher \
        --panet-ckpt output/panet/model_best.pth --lam 0.1 --device cuda

Port of hand_integral_pose_estimation_tpu/cli/train.py on one device, on
the synthetic split or a FreiHAND download (`--data-dir`, with
`--training-size` for a partial one). Snapshots go to `--model-dir` as
`snapshot_{epoch}.pth.tar`; `cli.test --model-dir` evaluates them.

The semi-supervised recipe (main/train.py:83-99): `--filtered-db` attaches
the pseudo-labels of `cli.generate_teacher_labels` to a file-backed split
and keeps only the accepted records; `--teacher-ckpt` runs a frozen
teacher on every batch instead; given both, the cached pseudo-labels win,
as in the reference. `--panet-ckpt` adds the PANet prior term, weighted by
`--lam`.

`--use-hand-detector` crops the training patches from detector boxes
instead of the boxes of the projected gt joints (the use_hand_detector
mode, FreiHand.py:468-470): they come from the `--bbox-db` cache, swept by
the detector of `--detector-ckpt` (random weights from `--seed` without
one) and saved there when it is missing or stale.

A file-backed split is decoded by the native batch prefetcher, the next
batch while the device trains on this one; `--yuv-transport` ships the
JPEGs' 4:2:0 planes (half the bytes) and finishes the decode on the
device, bitwise the host decode.

`--mesh` (default `auto`, as in the JAX CLI) lays the training out over
the ranks of a `torchrun` launch, one GPU each, or CPU ranks over gloo:

    torchrun --nproc_per_node 2 -m \
        hand_integral_pose_estimation_tpu_torch.cli.train --synthetic \
        --mesh data=2 --device cpu --pose-resnet 18 --pose-input 64 \
        --batch-size 4 --epochs 1 --steps-per-epoch 2

`auto` is a data-parallel mesh over every rank (none in a single process,
which trains exactly as without the flag); `data=N[,model=M]` an explicit
layout (`model` splits the final projection); `none` no mesh. Rank 0
writes the snapshots and the log, `--log-dir/train_logs.txt`.

`--imagenet-init resnet50.pth` initialises the pose backbone from a
torchvision ImageNet ResNet state dict (the reference's model-zoo init,
common/nets/resnet.py:70-76) before training; `--continue` wins over it.
"""

from __future__ import annotations

import argparse


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--data-dir", default=None,
                   help="FreiHAND root (training_K.json etc.)")
    p.add_argument("--synthetic", action="store_true",
                   help="train on SyntheticFreiHand instead of --data-dir")
    p.add_argument("--synthetic-size", type=int, default=256)
    p.add_argument("--training-size", type=int, default=None,
                   help="override cfg.train.training_size (partial "
                        "downloads, mini fixtures)")
    p.add_argument("--model-dir", default="output/model_dump")
    p.add_argument("--log-dir", default="output/log",
                   help="directory of train_logs.txt")
    p.add_argument("--epochs", type=int, default=None,
                   help="end epoch (default: cfg.train.end_epoch)")
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--mesh", default="auto",
                   help="device mesh for sharded training: 'auto' "
                        "(data-parallel over every rank of a torchrun "
                        "launch), 'none', or 'data=N[,model=M]'")
    p.add_argument("--continue", dest="continue_train", action="store_true",
                   help="resume from the latest snapshot (base.py:62-71)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--test-sweep", action="store_true",
                   help="epoch-end average-loss sweep over the testing "
                        "split (main/train.py:140-163)")
    p.add_argument("--pose-resnet", type=int, default=None)
    p.add_argument("--pose-input", type=int, default=None,
                   help="square input size; the heatmap is input/4 wide "
                        "and input/4 deep")
    p.add_argument("--filtered-db", default=None,
                   help="npz pseudo-label db from cli.generate_teacher_labels"
                        " (FreiHand.load_filtered_data, FreiHand.py:343-371);"
                        " needs --data-dir")
    p.add_argument("--teacher-ckpt", default=None,
                   help="model dir of cli.train snapshots, or a reference "
                        "snapshot_*.pth, for the frozen live teacher "
                        "(load_regressor_teacher, base.py:117-128)")
    p.add_argument("--teacher-epoch", type=int, default=None)
    p.add_argument("--panet-ckpt", default=None,
                   help="PANet weights (.pth) for the NRSfM prior term "
                        "(load_nrsfm_tester, base.py:111)")
    p.add_argument("--lam", type=float, default=None,
                   help="PANet loss weight (cfg._lambda, config.py:50)")
    p.add_argument("--use-hand-detector", action="store_true",
                   help="crop training patches from detector boxes instead "
                        "of GT-projected ones (use_hand_detector mode, "
                        "FreiHand.py:468-470); boxes come from --bbox-db, "
                        "swept with --detector-ckpt when missing")
    p.add_argument("--bbox-db", default=None,
                   help="npz cache of per-image detector crop boxes (the "
                        "reference's keypoint_bbox_db pickle, "
                        "FreiHand.py:382-409)")
    p.add_argument("--detector-ckpt", default=None,
                   help="a reference faster_rcnn_*.pth or a "
                        "cli.train_detector snapshot")
    p.add_argument("--detector-style", choices=("torchvision", "caffe"),
                   default=None,
                   help="ResNet block variant; default: caffe when "
                        "--detector-ckpt is a .pth (the reference's weights "
                        "need it), else torchvision")
    p.add_argument("--detector-norm", choices=("batch", "group"),
                   default="batch",
                   help="must match the checkpoint: 'batch' (reference "
                        "parity) or 'group' (cli.train_detector's default)")
    p.add_argument("--detector-resnet", type=int, default=None)
    p.add_argument("--imagenet-init", default=None,
                   help="torchvision ImageNet ResNet .pth to initialise "
                        "the pose backbone from (common/nets/"
                        "resnet.py:70-76 model-zoo init)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--unfused-head", action="store_true",
                   help="decode the materialised heatmap (kernels 1 and 2) "
                        "instead of the fused projection + decode (kernels "
                        "3 and 4)")
    p.add_argument("--yuv-transport", action="store_true",
                   help="ship batches to the device as the JPEGs' own 4:2:0 "
                        "planes (half the bytes) and finish the decode on "
                        "the device, bitwise the host decode (ops/yuv.py); "
                        "needs --data-dir with 4:2:0 JPEGs of 224x224")
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


def load_split(args, cfg, split: str, synthetic_seed: int = 0,
               synthetic_size=None):
    """The dataset the CLI flags name: SyntheticFreiHand with
    `--synthetic`, else the `split` of the FreiHAND tree at `--data-dir`."""
    from hand_integral_pose_estimation_tpu_torch.data import (
        FreiHandDataset,
        SyntheticFreiHand,
    )

    if args.synthetic:
        return SyntheticFreiHand(n=synthetic_size or args.synthetic_size,
                                 seed=synthetic_seed)
    if not args.data_dir:
        raise SystemExit("give --data-dir (a FreiHAND tree) or --synthetic")
    return FreiHandDataset(args.data_dir, split, cfg)


def main(argv=None):
    args = build_argparser().parse_args(argv)

    import dataclasses
    import logging

    from hand_integral_pose_estimation_tpu_torch.cli.mesh_arg import (
        join_launcher,
        parse_explicit_mesh,
    )
    from hand_integral_pose_estimation_tpu_torch.training import Trainer

    # the other modules' loggers; the Trainer's own logger
    # (utils.color_logger) does not propagate, so its lines print once
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args.device = join_launcher(args.device)
    mesh, model_par, auto_mesh = None, 1, False
    if args.mesh == "auto":
        auto_mesh = True
    elif args.mesh not in ("none", "1"):
        # explicit layout over the first N*M ranks
        mesh, model_par = parse_explicit_mesh(args.mesh)
    cfg = sized_config(args.pose_resnet, args.pose_input, args.batch_size)
    if args.lam is not None:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, lam=args.lam))
    if args.training_size:
        cfg = cfg.with_training_size(args.training_size)
    dataset = load_split(args, cfg, "training")
    test_dataset = (load_split(args, cfg, "testing", synthetic_seed=1,
                               synthetic_size=32)
                    if args.test_sweep else None)

    if args.use_hand_detector:
        import os

        import torch

        from hand_integral_pose_estimation_tpu_torch.data import detector_db
        from hand_integral_pose_estimation_tpu_torch.detect.load import (
            build_detector,
            default_resnet_style,
        )

        det_style = args.detector_style or default_resnet_style(
            args.detector_ckpt, fallback=cfg.detector.resnet_style)
        cfg = cfg.replace(detector=dataclasses.replace(
            cfg.detector, norm=args.detector_norm,
            freeze_bn=args.detector_norm == "batch",
            resnet_type=args.detector_resnet or cfg.detector.resnet_type,
            resnet_style=det_style))
        detector = None
        if not (args.bbox_db and os.path.exists(args.bbox_db)):
            detector = build_detector(
                cfg.detector, args.detector_ckpt,
                generator=torch.Generator().manual_seed(args.seed)
            ).to(args.device)
        detector_db.ensure_detector_bboxes(
            dataset, detector, cache_path=args.bbox_db, det_cfg=cfg.detector,
            pad_factor=cfg.augment.pad_factor)

    if args.filtered_db:
        if not hasattr(dataset, "records"):
            raise SystemExit("--filtered-db needs a record-backed dataset "
                             "(--data-dir), not --synthetic")
        from hand_integral_pose_estimation_tpu_torch.data import (
            apply_filtered_labels,
        )
        apply_filtered_labels(dataset, args.filtered_db)
        print(f"filtered db: {len(dataset)} kept samples "
              f"({dataset.num_labelled} labelled)")

    teacher_apply = None
    if args.teacher_ckpt and args.filtered_db:
        print("--filtered-db provides cached pseudo-labels; ignoring "
              "--teacher-ckpt for the teacher loss term")
    elif args.teacher_ckpt:
        from hand_integral_pose_estimation_tpu_torch.training.teacher import (
            make_frozen_teacher,
        )
        teacher_apply = make_frozen_teacher(cfg, args.teacher_ckpt,
                                            args.teacher_epoch, args.device)
        print(f"frozen teacher loaded from {args.teacher_ckpt}")

    panet_apply = None
    if args.panet_ckpt:
        from hand_integral_pose_estimation_tpu_torch.models.panet import (
            load_panet,
            panet_reconstruction_fn,
        )
        panet = load_panet(args.panet_ckpt).to(args.device)
        panet_apply = panet_reconstruction_fn(panet.requires_grad_(False))
        print(f"PANet prior loaded from {args.panet_ckpt} "
              f"(lambda = {cfg.train.lam})")

    trainer = Trainer(cfg=cfg, dataset=dataset, model_dir=args.model_dir,
                      log_dir=args.log_dir, imagenet_init=args.imagenet_init,
                      continue_train=args.continue_train, seed=args.seed,
                      test_dataset=test_dataset, device=args.device,
                      fuse_head=not args.unfused_head,
                      teacher_apply=teacher_apply, panet_apply=panet_apply,
                      yuv_transport=args.yuv_transport, mesh=mesh,
                      model_parallelism=model_par, auto_mesh=auto_mesh)
    trainer.fit(end_epoch=args.epochs, steps_per_epoch=args.steps_per_epoch)
    return trainer


if __name__ == "__main__":
    main()
