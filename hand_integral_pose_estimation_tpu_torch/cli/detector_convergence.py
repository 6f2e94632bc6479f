"""Detector convergence study: train Faster R-CNN on synthetic boxes to AP.

    python -m hand_integral_pose_estimation_tpu_torch.cli.detector_convergence \
        --steps 600 --eval-every 100 --device cuda
    python -m hand_integral_pose_estimation_tpu_torch.cli.detector_convergence \
        --train-n 8 --val-n 4 --size 64 --steps 2 --batch 2 --eval-every 2 \
        --device cpu

Port of hand_integral_pose_estimation_tpu/cli/detector_convergence.py. The
reference never trains its detector in tree (it loads an externally
trained checkpoint, common/hand_detector.py:117-118), so the training step
needs a convergence proof beyond falling losses: this study trains from
scratch (GroupNorm, `freeze_bn=False`: the `DetectorConfig.native` preset)
on the synthetic hand / distractor scenes (detect/synthetic.py) and tracks
VOC AP on a held-out split. Prints one JSON line per evaluation and a final
summary line; `--proposal-sweep` and `--dtype-sweep` re-evaluate the same
weights at other test-time proposal counts and compute dtypes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np

from hand_integral_pose_estimation_tpu_torch.config import DetectorConfig


def study_config(hw, resnet_type: int = 18) -> DetectorConfig:
    """Small-image study config: stride-16 anchors sized for 56-150 px
    synthetic hands, no blob resize (test_scale is the image size), the
    from-scratch recipe of `DetectorConfig.native`."""
    return DetectorConfig.native(min(hw), resnet_type, max_size=max(hw))


def run_study(train_n: int = 128, val_n: int = 32, hw=(224, 224),
              steps: int = 600, batch: int = 8, eval_every: int = 100,
              lr: float = 2e-3, resnet_type: int = 18, seed: int = 0,
              flip: bool = True, proposal_sweep=(), dtype_sweep=(),
              device: str = "cuda", log=print) -> dict:
    import torch

    from hand_integral_pose_estimation_tpu_torch.cli.train_detector import (
        detection_ap,
    )
    from hand_integral_pose_estimation_tpu_torch.detect import (
        FasterRCNN,
        build_detector,
        flip_batch,
        make_synthetic_box_dataset,
        prepare_blob,
    )
    from hand_integral_pose_estimation_tpu_torch.training.detector_trainer import (
        make_detector_optimizer,
        make_detector_train_step,
    )

    cfg = study_config(hw, resnet_type)
    train = make_synthetic_box_dataset(train_n, hw, seed=seed)
    val = make_synthetic_box_dataset(val_n, hw, seed=seed + 10_000)

    model = build_detector(cfg, generator=torch.Generator().manual_seed(seed),
                           log=log).to(device)
    optimizer, scheduler = make_detector_optimizer(
        model.parameters(), lr=lr, decay_step=max(steps // 2, 1),
        decay_factor=0.3)
    train_step = make_detector_train_step(model, optimizer, scheduler)
    sampling = torch.Generator(device=device).manual_seed(seed)

    train_boxes = np.concatenate(train.gt_boxes)[:, None, :]   # (N, 1, 4)
    gt_classes = torch.ones(batch, 1, dtype=torch.long, device=device)
    gt_valid = torch.ones(batch, 1, dtype=torch.bool, device=device)
    val_images = torch.from_numpy(val.images).to(device)

    rng = np.random.RandomState(seed + 1)
    history = []
    t0 = time.perf_counter()
    for step in range(1, steps + 1):
        idx = rng.randint(0, train_n, batch)
        imgs, boxes = train.images[idx], train_boxes[idx]
        if flip:
            imgs, boxes = flip_batch(imgs, boxes, rng.rand(batch) < 0.5)
        blob, _ = prepare_blob(
            torch.from_numpy(np.ascontiguousarray(imgs)).to(device), cfg)
        metrics = train_step(blob, torch.from_numpy(boxes).to(device),
                             gt_classes, gt_valid, generator=sampling)
        if step % eval_every == 0 or step == steps:
            ap = detection_ap(model, val_images, val.gt_boxes, cfg)
            rec = {"step": step, "ap": round(float(ap), 4),
                   "loss": round(float(metrics["loss"]), 4),
                   "rpn_cls": round(float(metrics["rpn_cls"]), 4),
                   "det_cls": round(float(metrics["det_cls"]), 4),
                   "elapsed_s": round(time.perf_counter() - t0, 1)}
            history.append(rec)
            log(json.dumps(rec))
    model.eval()
    result = {"history": history, "final_ap": history[-1]["ap"],
              "best_ap": max(h["ap"] for h in history), "model": model}

    def sweep_ap(vcfg):
        # the same weights under a test-time config variant
        variant = FasterRCNN(vcfg).to(device)
        variant.load_state_dict(model.state_dict())
        return round(float(detection_ap(variant, val_images, val.gt_boxes,
                                        vcfg)), 4)

    if dtype_sweep:
        # the inference compute dtype only: box decode, NMS and the score
        # softmax stay float32
        result["dtype_sweep"] = {}
        for dt in dtype_sweep:
            result["dtype_sweep"][dt] = sweep_ap(
                dataclasses.replace(cfg, compute_dtype=dt))
            log(json.dumps({"dtype_sweep": dt,
                            "ap": result["dtype_sweep"][dt]}))
    if proposal_sweep:
        # the test-time post-NMS proposal count only
        result["proposal_sweep"] = {}
        for n_prop in proposal_sweep:
            result["proposal_sweep"][n_prop] = sweep_ap(
                dataclasses.replace(cfg, rpn_post_nms_top_n_test=n_prop))
            log(json.dumps({"proposal_sweep": n_prop,
                            "ap": result["proposal_sweep"][n_prop]}))
    return result


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--train-n", type=int, default=128)
    p.add_argument("--val-n", type=int, default=32)
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--eval-every", type=int, default=100)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--resnet", type=int, default=18)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-flip", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--proposal-sweep", type=int, nargs="*", default=(),
                   help="after training, re-evaluate AP of the same weights "
                        "at these post-NMS proposal counts")
    p.add_argument("--dtype-sweep", nargs="*", default=(),
                   help="after training, re-evaluate AP of the same weights "
                        "at these inference compute dtypes")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    result = run_study(train_n=args.train_n, val_n=args.val_n,
                       hw=(args.size, args.size), steps=args.steps,
                       batch=args.batch, eval_every=args.eval_every,
                       lr=args.lr, resnet_type=args.resnet, seed=args.seed,
                       flip=not args.no_flip,
                       proposal_sweep=tuple(args.proposal_sweep),
                       dtype_sweep=tuple(args.dtype_sweep),
                       device=args.device)
    out = {"final_ap": result["final_ap"], "best_ap": result["best_ap"]}
    for k in ("proposal_sweep", "dtype_sweep"):
        if k in result:
            out[k] = result[k]
    print(json.dumps(out))
    return result


if __name__ == "__main__":
    main()
