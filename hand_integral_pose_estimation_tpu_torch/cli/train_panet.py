"""PANet (NRSfM) training entry point (reference: procrustes_encoding/
train.py with the test_scripts/train.sh hyperparameters).

    python -m hand_integral_pose_estimation_tpu_torch.cli.train_panet \
        --train-npy hand_train.npy --test-npy hand_test.npy --device cuda
    python -m hand_integral_pose_estimation_tpu_torch.cli.train_panet \
        --synthetic --steps 10 --batch-size 16 --device cpu

Port of hand_integral_pose_estimation_tpu/cli/train_panet.py. Writes
`model_best.pth` (the best validation loss) and `model_cur.pth` (the last
step) under `--out`, and `model_comp_{i:02d}.pth` with `--composite`: PANet
state dicts with the reference's names, which `cli.train --panet-ckpt` and
`cli.panet_test --ckpt` read. The JAX package writes orbax directories
instead; the port neither reads nor writes those.
"""

from __future__ import annotations

import argparse


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--train-npy", default=None)
    p.add_argument("--test-npy", default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="train on 512 random clouds instead of --train-npy")
    p.add_argument("--steps", type=int, default=500000)
    p.add_argument("--batch-size", type=int, default=500)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--sparsity-weight", type=float, default=1e-4)
    p.add_argument("--augment-rotation", action="store_true")
    p.add_argument("--encode-with-relu", type=int, default=1,
                   help="1 = relu threshold, 0 = block soft threshold "
                        "(nrsfm_modules.py:92-95)")
    p.add_argument("--composite", type=int, default=0, metavar="COMP_NUM",
                   help="after the base run, boost COMP_NUM-1 extra "
                        "components on worst-decile samples "
                        "(train_kernel.py:440-488)")
    p.add_argument("--out", default="output/panet")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    import os

    import numpy as np
    import torch

    from hand_integral_pose_estimation_tpu_torch.config import PANetConfig
    from hand_integral_pose_estimation_tpu_torch.models.panet import PANet
    from hand_integral_pose_estimation_tpu_torch.training.panet_trainer \
        import train_composite_panet, train_panet

    pcfg = PANetConfig(encode_with_relu=bool(args.encode_with_relu))
    if args.synthetic:
        rng = np.random.RandomState(0)
        pts = rng.randn(512, pcfg.pts_num, 3).astype(np.float32) * 0.05
        train_pts, test_pts = pts[:448], pts[448:]
    elif args.train_npy and args.test_npy:
        train_pts = np.load(args.train_npy).astype(np.float32)
        test_pts = np.load(args.test_npy).astype(np.float32)
    else:
        raise SystemExit("give --train-npy and --test-npy, or --synthetic")
    # centring as in train.py:121
    train_pts = train_pts - train_pts.mean(1, keepdims=True)
    test_pts = test_pts - test_pts.mean(1, keepdims=True)

    model = PANet(pcfg.pts_num, pcfg.dict_sizes, pcfg.encode_with_relu,
                  generator=torch.Generator().manual_seed(args.seed + 1)
                  ).to(args.device)
    res = train_panet(model, train_pts, test_pts, num_steps=args.steps,
                      batch_size=args.batch_size, lr=args.lr,
                      sparsity_weight=args.sparsity_weight,
                      augment_rotation=args.augment_rotation,
                      seed=args.seed)
    os.makedirs(args.out, exist_ok=True)
    torch.save(res.best_state, os.path.join(args.out, "model_best.pth"))
    torch.save(model.state_dict(), os.path.join(args.out, "model_cur.pth"))
    print(f"best val loss {res.best_val_loss:.6f} -> {args.out}")

    if args.composite > 1:
        comp = train_composite_panet(
            model, res.best_state, train_pts, comp_num=args.composite,
            num_steps=args.steps, batch_size=args.batch_size, lr=args.lr,
            sparsity_weight=args.sparsity_weight,
            augment_rotation=args.augment_rotation, seed=args.seed)
        for i, state in enumerate(comp.components):
            torch.save(state, os.path.join(args.out,
                                           f"model_comp_{i:02d}.pth"))
        print(f"composite: mean per-sample loss "
              f"{float(comp.loss_before.mean()):.6f} -> "
              f"{float(comp.loss_after.mean()):.6f}")
    return res


if __name__ == "__main__":
    main()
