"""Train the Faster R-CNN hand detector on FreiHAND-contract datasets.

    python -m hand_integral_pose_estimation_tpu_torch.cli.train_detector \
        --synthetic --steps 500 --eval-every 100 --device cuda
    python -m hand_integral_pose_estimation_tpu_torch.cli.train_detector \
        --data-dir /data/FreiHAND --steps 50000 --model-dir output/detector
    python -m hand_integral_pose_estimation_tpu_torch.cli.train_detector \
        --synthetic --n 16 --steps 2 --batch 2 --eval-every 2 --resnet 18 \
        --scale 112 --max-size 112 --rpn-pre-nms 128 --rpn-post-nms 32 \
        --roi-batch 16 --device cpu

Port of hand_integral_pose_estimation_tpu/cli/train_detector.py. The
reference trains its detector out of tree (lib/datasets/freihand.py:53-64
reads `freihand_bbox_gt_{split}.npy`; common/hand_detector.py:117-118 only
loads the result); here gt boxes come from the projected pose annotations
(detect/data.py:gt_bbox_from_keypoints), training runs the four-loss SGD
step (training/detector_trainer.py), held-out VOC AP is tracked with the
kernel-backed `detect`, and the final weights are written as
`faster_rcnn_final.pth` in `--model-dir` (the reference's
`{"model": state_dict}` envelope), which `detect.build_detector` restores.

Blobs come from `prepare_blob`, the serving path's resize (the axis-aligned
warp), as the reference uses one `cv2.resize` for both; the JAX CLI
resizes its training blobs with `jax.image.resize`, which antialiases when
it downscales.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from hand_integral_pose_estimation_tpu_torch.config import DetectorConfig


def detector_cfg_from_args(args) -> DetectorConfig:
    return DetectorConfig(
        resnet_type=args.resnet,
        norm=args.norm,
        freeze_bn=not args.no_freeze_bn if args.norm == "batch" else True,
        test_scale=args.scale, test_max_size=args.max_size,
        rpn_pre_nms_top_n_train=args.rpn_pre_nms,
        rpn_post_nms_top_n_train=args.rpn_post_nms,
        rpn_pre_nms_top_n_test=args.rpn_pre_nms,
        rpn_post_nms_top_n_test=max(args.rpn_post_nms // 4, 16),
        roi_batch_size=args.roi_batch,
        max_detections=16,
        roi_bg_thresh_lo=0.0 if args.from_scratch else 0.1,
    )


def detection_ap(model, images, gt_boxes, cfg: DetectorConfig) -> float:
    """VOC AP of the kernel-backed `detect` on (N, H, W, 3) device images
    against per-image (G, 4) gt boxes; the model is put in eval mode for
    the sweep and back in train mode after."""
    from hand_integral_pose_estimation_tpu_torch.detect import detect
    from hand_integral_pose_estimation_tpu_torch.detect.data import (
        evaluate_detections,
    )

    model.eval()
    dets = detect(model, images, cfg)
    model.train()
    boxes, scores = dets.boxes.cpu().numpy(), dets.scores.cpu().numpy()
    valid = dets.valid.cpu().numpy()
    return evaluate_detections([b[v] for b, v in zip(boxes, valid)],
                               [s[v] for s, v in zip(scores, valid)],
                               gt_boxes)["ap"]


def train_detector(dataset, cfg: DetectorConfig, steps: int = 1000,
                   batch: int = 4, lr: float = 1e-3, seed: int = 0,
                   eval_every: int = 200, eval_n: int = 32,
                   flip: bool = True, model_dir: str | None = None,
                   device: str = "cuda", log=print) -> dict:
    """Train on `dataset` (the FreiHandDataset / SyntheticFreiHand host-batch
    contract) on `device`; the last `eval_n` samples are held out for AP.
    Returns {"history", "final_ap", "model"}."""
    import torch

    from hand_integral_pose_estimation_tpu_torch.detect import (
        build_detector,
        prepare_blob,
    )
    from hand_integral_pose_estimation_tpu_torch.detect.data import (
        build_detector_batch,
        gt_bbox_from_keypoints,
    )
    from hand_integral_pose_estimation_tpu_torch.detect.load import (
        save_detector,
    )
    from hand_integral_pose_estimation_tpu_torch.training.detector_trainer import (
        make_detector_optimizer,
        make_detector_train_step,
    )

    n = len(dataset)
    eval_n = min(eval_n, max(n // 4, 1))
    train_idx = np.arange(0, n - eval_n)
    val_idx = np.arange(n - eval_n, n)

    model = build_detector(cfg, generator=torch.Generator().manual_seed(seed),
                           log=log).to(device)
    optimizer, scheduler = make_detector_optimizer(
        model.parameters(), lr=lr, decay_step=max(steps // 2, 1),
        decay_factor=0.3)
    train_step = make_detector_train_step(model, optimizer, scheduler)
    sampling = torch.Generator(device=device).manual_seed(seed)

    vh = dataset.host_batch(val_idx)
    val_images = torch.from_numpy(np.ascontiguousarray(vh["image"])).to(device)
    uv = np.einsum("bij,bnj->bni", vh["K"], vh["joint_cam"])
    uv = uv[..., :2] / uv[..., 2:3]
    val_gt = [b[None, :] for b in gt_bbox_from_keypoints(uv)]

    rng = np.random.RandomState(seed + 1)
    history = []
    for step in range(1, steps + 1):
        idx = train_idx[rng.randint(0, len(train_idx), batch)]
        db = build_detector_batch(dataset, idx,
                                  flip_rng=rng if flip else None)
        images = torch.from_numpy(np.ascontiguousarray(db.images)).to(device)
        blob, scale = prepare_blob(images, cfg)
        metrics = train_step(
            blob, torch.from_numpy(db.gt_boxes * np.float32(scale)).to(device),
            torch.from_numpy(db.gt_classes).to(device),
            torch.from_numpy(db.gt_valid).to(device), generator=sampling)
        if step % eval_every == 0 or step == steps:
            rec = {"step": step,
                   "ap": round(float(detection_ap(model, val_images, val_gt,
                                                  cfg)), 4),
                   "loss": round(float(metrics["loss"]), 4)}
            history.append(rec)
            log(json.dumps(rec))

    model.eval()
    if model_dir:
        path = save_detector(model, os.path.join(model_dir,
                                                 "faster_rcnn_final.pth"))
        log(f"saved {path}")
    return {"history": history, "final_ap": history[-1]["ap"],
            "model": model}


def build_argparser():
    from hand_integral_pose_estimation_tpu_torch.detect.config_compat import (
        add_override_flags,
    )

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--data-dir", default=None,
                   help="FreiHAND root; omit for --synthetic")
    p.add_argument("--training-size", type=int, default=None,
                   help="override cfg.train.training_size (partial "
                        "downloads, mini fixtures)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--n", type=int, default=256,
                   help="synthetic dataset size")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--eval-every", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-flip", action="store_true")
    p.add_argument("--model-dir", default=None)
    p.add_argument("--device", default="cuda")
    # architecture / recipe
    p.add_argument("--resnet", type=int, default=101)
    p.add_argument("--norm", choices=("batch", "group"), default="group")
    p.add_argument("--no-freeze-bn", action="store_true",
                   help="with --norm batch: run BN live (from-scratch)")
    p.add_argument("--reference-sampling", dest="from_scratch",
                   action="store_false", default=True,
                   help="keep the reference's roi_bg_thresh_lo=0.1 instead "
                        "of the from-scratch recipe's 0.0")
    p.add_argument("--scale", type=int, default=600)
    p.add_argument("--max-size", type=int, default=1000)
    p.add_argument("--rpn-pre-nms", type=int, default=6000)
    p.add_argument("--rpn-post-nms", type=int, default=512)
    p.add_argument("--roi-batch", type=int, default=128)
    add_override_flags(p)
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    from hand_integral_pose_estimation_tpu_torch.config import Config
    from hand_integral_pose_estimation_tpu_torch.data import (
        FreiHandDataset,
        SyntheticFreiHand,
    )
    from hand_integral_pose_estimation_tpu_torch.detect.config_compat import (
        overrides_from_args,
    )

    if args.data_dir:
        dcfg = Config()
        if args.training_size:
            dcfg = dcfg.with_training_size(args.training_size)
        dataset = FreiHandDataset(args.data_dir, "training", dcfg)
    else:
        dataset = SyntheticFreiHand(n=args.n, render_joints=True,
                                    seed=args.seed)
    cfg = overrides_from_args(detector_cfg_from_args(args), args)
    result = train_detector(
        dataset, cfg, steps=args.steps, batch=args.batch, lr=args.lr,
        seed=args.seed, eval_every=args.eval_every,
        flip=not args.no_flip, model_dir=args.model_dir, device=args.device)
    print(json.dumps({"final_ap": result["final_ap"]}))
    return result


if __name__ == "__main__":
    main()
