"""Test-split metric evaluation (reference: main/test.py).

Sweeps the test split with a pose net, collects integral coords and runs
the protocol #1 / #2 pipeline (PA-MPJPE / MPJPE) with its artifact dumps.
Port of hand_integral_pose_estimation_tpu/cli/test.py, on the synthetic
split or the testing split of a FreiHAND tree (`--data-dir`, with
`--training-size` for a partial download: the testing split starts after
the training split).

    python -m hand_integral_pose_estimation_tpu_torch.cli.test --synthetic \
        --torch-snapshot snapshot_24.pth --device cuda
    python -m hand_integral_pose_estimation_tpu_torch.cli.test --synthetic \
        --model-dir output/model_dump [--epoch 3] --device cuda

`--model-dir` evaluates a snapshot that `cli.train` wrote (the latest one
unless `--epoch` names another); give it the `--pose-resnet` and
`--pose-input` the model was trained with.
"""

from __future__ import annotations

import argparse


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--data-dir", default=None,
                   help="FreiHAND root (training_K.json etc.)")
    p.add_argument("--synthetic", action="store_true",
                   help="evaluate on SyntheticFreiHand instead of --data-dir")
    p.add_argument("--synthetic-size", type=int, default=64)
    p.add_argument("--training-size", type=int, default=None,
                   help="override cfg.train.training_size")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--result-dir", default="output/result")
    p.add_argument("--torch-snapshot", default=None,
                   help="a reference ResPoseNet snapshot .pth (main/model.py "
                        "state_dict; {'network': ...} envelope and "
                        "DataParallel 'module.' prefix ok)")
    p.add_argument("--model-dir", default=None,
                   help="directory of cli.train's snapshot_{epoch}.pth.tar")
    p.add_argument("--epoch", type=int, default=None,
                   help="snapshot epoch under --model-dir (default: latest)")
    p.add_argument("--pose-resnet", type=int, default=None)
    p.add_argument("--pose-input", type=int, default=None)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the fresh model's init when no snapshot "
                        "is given")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)

    import torch

    from hand_integral_pose_estimation_tpu_torch.cli.train import (
        load_split,
        sized_config,
    )
    from hand_integral_pose_estimation_tpu_torch.evaluation import (
        evaluate_test_split,
    )
    from hand_integral_pose_estimation_tpu_torch.interop import (
        load_pose_snapshot,
    )
    from hand_integral_pose_estimation_tpu_torch.models import get_pose_net
    from hand_integral_pose_estimation_tpu_torch.training import (
        Tester,
        load_checkpoint,
    )

    cfg = sized_config(args.pose_resnet, args.pose_input)
    if args.training_size:
        cfg = cfg.with_training_size(args.training_size)
    dataset = load_split(args, cfg, "testing")
    model = get_pose_net(cfg.model,
                         generator=torch.Generator().manual_seed(args.seed))
    if args.torch_snapshot:
        load_pose_snapshot(model, args.torch_snapshot)
        print(f"loaded reference snapshot {args.torch_snapshot}")
    elif args.model_dir:
        epoch = load_checkpoint(args.model_dir, model, epoch=args.epoch)
        print(f"loaded snapshot_{epoch} from {args.model_dir}")
    else:
        print(f"no snapshot given: evaluating a fresh model (seed "
              f"{args.seed})")
    tester = Tester(cfg=cfg, dataset=dataset, model=model, device=args.device)
    coords, batch = tester.run(batch_size=args.batch_size)
    summary = evaluate_test_split(coords, batch, result_dir=args.result_dir)
    print(summary["p1_summary"])
    print(summary["p2_summary"])
    return summary


if __name__ == "__main__":
    main()
