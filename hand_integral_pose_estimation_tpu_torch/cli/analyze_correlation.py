"""Teacher-error / PANet-error / heatmap-entropy correlation analysis
(reference: main/generate_correlation_graph.py:96-160), the statistical
case for the variance and entropy pseudo-label filters.

    python -m hand_integral_pose_estimation_tpu_torch.cli.analyze_correlation \
        --synthetic --model-dir output/teacher_model --device cuda \
        [--panet-ckpt model_best.pth] [--plot]
    python -m hand_integral_pose_estimation_tpu_torch.cli.analyze_correlation \
        --synthetic --max-samples 8 --batch-size 4 --pose-resnet 18 \
        --pose-input 64 --device cpu

Port of hand_integral_pose_estimation_tpu/cli/analyze_correlation.py: the
teacher (the latest snapshot under `--model-dir`, a fresh model when there
is none) decodes each eval crop's heatmap with the soft-argmax (kernel 1 on
the card), and the CLI writes a per-sample CSV (teacher MPJPE in label
space, PANet reconstruction error, mean heatmap entropy) and prints the
Pearson correlations. `--plot` draws them with matplotlib, imported only
then.
"""

from __future__ import annotations

import argparse
import csv


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--model-dir", default="output/teacher_model")
    p.add_argument("--panet-ckpt", default=None,
                   help="PANet .pth (random weights from --seed + 1 if "
                        "absent)")
    p.add_argument("--out", default="output/correlation.csv")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--max-samples", type=int, default=256)
    p.add_argument("--plot", action="store_true")
    p.add_argument("--pose-resnet", type=int, default=None)
    p.add_argument("--pose-input", type=int, default=None)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the fresh teacher when no snapshot exists")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    import os

    import numpy as np
    import torch

    from hand_integral_pose_estimation_tpu_torch import losses
    from hand_integral_pose_estimation_tpu_torch.cli.train import sized_config
    from hand_integral_pose_estimation_tpu_torch.data import (
        FreiHandDataset,
        SyntheticFreiHand,
        make_eval_batch,
    )
    from hand_integral_pose_estimation_tpu_torch.models import get_pose_net
    from hand_integral_pose_estimation_tpu_torch.models.panet import (
        PANet,
        load_panet,
    )
    from hand_integral_pose_estimation_tpu_torch.ops.integral import (
        heatmap_entropy,
        softmax_integral,
    )
    from hand_integral_pose_estimation_tpu_torch.training import (
        load_checkpoint,
    )

    cfg = sized_config(args.pose_resnet, args.pose_input)
    if args.synthetic or not args.data_dir:
        dataset = SyntheticFreiHand(n=args.max_samples)
    else:
        dataset = FreiHandDataset(args.data_dir, "training", cfg)
    device = torch.device(args.device)

    model = get_pose_net(cfg.model, torch.Generator().manual_seed(args.seed))
    try:
        load_checkpoint(args.model_dir, model)
    except FileNotFoundError:
        print("no teacher snapshot — fresh model (smoke mode)")
    model = model.to(device).eval()

    if args.panet_ckpt and os.path.exists(args.panet_ckpt):
        panet = load_panet(args.panet_ckpt, cfg.panet.encode_with_relu)
    else:
        panet = PANet(cfg.panet.pts_num, cfg.panet.dict_sizes,
                      cfg.panet.encode_with_relu,
                      generator=torch.Generator().manual_seed(args.seed + 1))
    panet = panet.to(device).eval()

    J, D = cfg.model.num_joints, cfg.model.depth_dim
    ph, pw = cfg.model.input_shape

    @torch.no_grad()
    def analyze(host):
        t = {k: torch.from_numpy(np.ascontiguousarray(host[k])).to(device)
             for k in ("image", "joint_cam", "K", "ref_bone_len")}
        batch = make_eval_batch(t["image"], t["joint_cam"], t["K"], None,
                                t["ref_bone_len"], cfg.augment, (ph, pw))
        hm = model(batch.image)
        coords = softmax_integral(hm, J, D)
        teacher_err = torch.linalg.vector_norm(coords - batch.label,
                                               dim=-1).mean(-1)
        entropy = heatmap_entropy(hm, J, D).mean(-1)
        pin = losses.prepare_panet_input(coords, batch.trans_inv,
                                         batch.tprime, batch.K, pw, ph)
        recon = panet(pin.float())[0]
        panet_err = torch.linalg.vector_norm(recon - pin, dim=-1).mean(-1)
        return [x.double().cpu().numpy()
                for x in (teacher_err, panet_err, entropy)]

    rows = []
    n = min(len(dataset), args.max_samples)
    bs = args.batch_size
    for start in range(0, n - bs + 1, bs):
        rows.extend(zip(*analyze(dataset.host_batch(
            np.arange(start, start + bs)))))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["teacher_mpjpe", "panet_error", "heatmap_entropy"])
        w.writerows(rows)

    arr = np.asarray(rows)
    if len(arr) > 2:
        c_tp = np.corrcoef(arr[:, 0], arr[:, 1])[0, 1]
        c_te = np.corrcoef(arr[:, 0], arr[:, 2])[0, 1]
        print(f"corr(teacher_err, panet_err) = {c_tp:.4f}")
        print(f"corr(teacher_err, entropy)   = {c_te:.4f}")
    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(1, 2, figsize=(10, 4))
        axes[0].scatter(arr[:, 1], arr[:, 0], s=2)
        axes[0].set_xlabel("panet error")
        axes[0].set_ylabel("teacher mpjpe")
        axes[1].scatter(arr[:, 2], arr[:, 0], s=2)
        axes[1].set_xlabel("entropy")
        axes[1].set_ylabel("teacher mpjpe")
        fig.savefig(args.out.replace(".csv", ".png"), dpi=120)
        plt.close(fig)
    print(f"wrote {len(rows)} rows -> {args.out}")
    return arr


if __name__ == "__main__":
    main()
