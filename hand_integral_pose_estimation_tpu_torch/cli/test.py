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

`--model-dir` (default output/model_dump, as in the JAX CLI) evaluates a
snapshot that `cli.train` wrote (the latest one unless `--epoch`, or the
JAX CLI's `--test-epoch`, names another); give it the `--pose-resnet` and
`--pose-input` the model was trained with. Where there is no snapshot, a
fresh model from `--seed` is evaluated, with a note.

`--mesh` (default `auto`) splits the sweep's batches over the ranks of a
`torchrun` launch (`auto`: the largest rank prefix that divides
`--batch-size`; none in a single process); rank 0 writes the results.
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
    p.add_argument("--model-dir", default="output/model_dump",
                   help="directory of cli.train's snapshot_{epoch}.pth.tar")
    p.add_argument("--epoch", "--test-epoch", dest="epoch", type=int,
                   default=None,
                   help="snapshot epoch under --model-dir (default: latest)")
    p.add_argument("--pose-resnet", type=int, default=None)
    p.add_argument("--pose-input", type=int, default=None)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the fresh model's init when no snapshot "
                        "is given")
    p.add_argument("--device", default="cuda")
    p.add_argument("--mesh", default="auto",
                   help="device mesh for the sharded test sweep: 'auto' "
                        "(largest rank prefix dividing --batch-size), "
                        "'none', or 'data=N[,model=M]'")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)

    import torch

    from hand_integral_pose_estimation_tpu_torch.cli.mesh_arg import (
        join_launcher,
        resolve_eval_mesh,
    )
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
    from hand_integral_pose_estimation_tpu_torch.parallel import is_writer
    from hand_integral_pose_estimation_tpu_torch.training import (
        Tester,
        load_checkpoint,
    )

    args.device = join_launcher(args.device)
    mesh = resolve_eval_mesh(args.mesh, args.batch_size)
    cfg = sized_config(args.pose_resnet, args.pose_input)
    if args.training_size:
        cfg = cfg.with_training_size(args.training_size)
    dataset = load_split(args, cfg, "testing")
    model = get_pose_net(cfg.model,
                         generator=torch.Generator().manual_seed(args.seed))
    if args.torch_snapshot:
        load_pose_snapshot(model, args.torch_snapshot)
        print(f"loaded reference snapshot {args.torch_snapshot}")
    else:
        try:
            epoch = load_checkpoint(args.model_dir, model, epoch=args.epoch)
            print(f"loaded snapshot_{epoch} from {args.model_dir}")
        except FileNotFoundError:
            print(f"no snapshot found in {args.model_dir}: evaluating a "
                  f"fresh model (seed {args.seed})")
    tester = Tester(cfg=cfg, dataset=dataset, model=model, device=args.device,
                    mesh=mesh)
    coords, batch = tester.run(batch_size=args.batch_size)
    if not is_writer():
        return None
    summary = evaluate_test_split(coords, batch, result_dir=args.result_dir)
    print(summary["p1_summary"])
    print(summary["p2_summary"])
    return summary


if __name__ == "__main__":
    main()
