"""PANet reconstruction test (reference: procrustes_encoding
test_scripts/PANet_test.sh with PANet_reconstruction.py:101-113): load
trained weights, reconstruct a point file, print the MPJPE.

    python -m hand_integral_pose_estimation_tpu_torch.cli.panet_test \
        --ckpt output/panet/model_best.pth --pts-npy hand_test.npy

Port of hand_integral_pose_estimation_tpu/cli/panet_test.py. `--ckpt` is a
PANet `.pth`: the reference's model_best.pth or one from
`cli.train_panet` (the JAX package's orbax directories are not read).
"""

from __future__ import annotations

import argparse


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--ckpt", required=True, help="PANet .pth checkpoint")
    p.add_argument("--pts-npy", required=True,
                   help="(N, 21, 3) point file, e.g. hand_test.npy")
    p.add_argument("--batch-size", type=int, default=500)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)

    import numpy as np
    import torch

    from hand_integral_pose_estimation_tpu_torch.models.panet import (
        load_panet,
    )

    model = load_panet(args.ckpt).to(args.device)
    pts = np.load(args.pts_npy).astype(np.float32)
    pts = pts - pts.mean(1, keepdims=True)   # train.py:121 centring
    errs = []
    with torch.no_grad():
        for start in range(0, len(pts), args.batch_size):
            chunk = torch.from_numpy(pts[start:start + args.batch_size]).to(
                args.device)
            recon = model(chunk)[0]
            errs.append(torch.linalg.vector_norm(recon - chunk, dim=-1)
                        .mean(-1).cpu().numpy())
    mpjpe = float(np.concatenate(errs).mean())
    print(f"PANet reconstruction MPJPE over {len(pts)} samples: {mpjpe:.6f}")
    return mpjpe


if __name__ == "__main__":
    main()
