"""Dataset pixel-statistics pass (reference: main/find_mean_std.py:29-40):
the per-channel mean and std that feed cfg.pixel_mean / pixel_std.

    python -m hand_integral_pose_estimation_tpu_torch.cli.find_mean_std \\
        --synthetic --device cuda
    python -m hand_integral_pose_estimation_tpu_torch.cli.find_mean_std \\
        --data-dir /path/to/FreiHAND --max-samples 5000 --device cuda

Port of hand_integral_pose_estimation_tpu/cli/find_mean_std.py: the same
samples (`SyntheticFreiHand(n=min(max_samples, 256))` with `--synthetic` or
without `--data-dir`, else the training split of the FreiHAND tree), the
same two printed lines. The sums of x/255 and (x/255)^2 per channel are
taken in float64 on `--device`, batch by batch.
"""

from __future__ import annotations

import argparse


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--max-samples", type=int, default=5000)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None):
    """Prints and returns (mean, std), float64 numpy arrays of 3."""
    args = build_argparser().parse_args(argv)
    import numpy as np
    import torch

    from hand_integral_pose_estimation_tpu_torch.config import Config
    from hand_integral_pose_estimation_tpu_torch.data import (
        FreiHandDataset,
        SyntheticFreiHand,
    )

    device = torch.device(args.device)
    if args.synthetic or not args.data_dir:
        dataset = SyntheticFreiHand(n=min(args.max_samples, 256))
    else:
        dataset = FreiHandDataset(args.data_dir, "training", Config())

    n = min(len(dataset), args.max_samples)
    s = torch.zeros(3, dtype=torch.float64, device=device)
    s2 = torch.zeros(3, dtype=torch.float64, device=device)
    count = 0
    for start in range(0, n, args.batch_size):
        idx = np.arange(start, min(start + args.batch_size, n))
        host = np.ascontiguousarray(dataset.host_batch(idx)["image"])
        imgs = torch.from_numpy(host).to(device).to(torch.float64) / 255.0
        s += imgs.sum(dim=(0, 1, 2))
        s2 += (imgs ** 2).sum(dim=(0, 1, 2))
        count += imgs.shape[0] * imgs.shape[1] * imgs.shape[2]
    mean = s / count
    std = torch.sqrt(s2 / count - mean ** 2)
    mean, std = mean.cpu().numpy(), std.cpu().numpy()
    print(f"pixel_mean = ({mean[0]:.4f}, {mean[1]:.4f}, {mean[2]:.4f})")
    print(f"pixel_std  = ({std[0]:.4f}, {std[1]:.4f}, {std[2]:.4f})")
    return mean, std


if __name__ == "__main__":
    main()
