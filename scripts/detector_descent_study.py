"""How far the detector's loss falls over SGD steps on one batch, and how
much of that float32 rounding decides: the PyTorch port on one CUDA card.

`chip_smoke.py` (phase 9c) trains the R101 detector at 600^2 x 4 on
synthetic scenes, with the frozen BatchNorm statistics set from the scenes
and the heads scaled, taking SGD steps at the detector's rate with the
same anchor and RoI draws each step, and holds that the loss falls (the
last below the first, the mean of the last three below that of the first
three). The proposals move with the weights, so the objective changes
from step to step, and a change at the level of float32 rounding can turn
a trajectory. This script takes the same steps from the same state in runs
that differ only in that rounding:

- the ROIAlign backward kernel (kernel 6b), as the port runs;
- its plain VJP in float32, and in float64 rounded once to float32;
- every detector op plain (NMS, ROIAlign and its backward);
- the plain VJP, and the kernel, times (1 + eps N(0, 1)) for eps 1e-7
  and 1e-6, a few draws each.

It prints each run's losses, the kernel's and the float32 plain VJP's
largest error against the float64 VJP at each step of the kernel's run
(of the largest entry), and in how many runs the loss falls within each
horizon. Run from the repo root on a machine with a CUDA card:

    python3 scripts/detector_descent_study.py [--steps 30]
"""

import argparse
import contextlib
import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from hand_integral_pose_estimation_tpu_torch.config import (  # noqa: E402
    DetectorConfig,
)
from hand_integral_pose_estimation_tpu_torch.detect import (  # noqa: E402
    build_detector,
    make_synthetic_box_dataset,
    prepare_blob,
)
from hand_integral_pose_estimation_tpu_torch.ops import kernels  # noqa: E402
from hand_integral_pose_estimation_tpu_torch.ops import (  # noqa: E402
    roi_align as ra,
)
from hand_integral_pose_estimation_tpu_torch.training.detector_trainer import (  # noqa: E402,E501
    make_detector_optimizer,
    make_detector_train_step,
)


def falls(losses):
    return losses[-1] < losses[0] and sum(losses[-3:]) < sum(losses[:3])


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--draws", type=int, default=4)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("this study needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda", 0)
    kernels.build()
    print(f"[study] {cs.card_line()}", flush=True)

    # phase 9c's model, scenes and frozen statistics
    det_cfg = dataclasses.replace(DetectorConfig(), resnet_style="caffe")
    model = build_detector(det_cfg, generator=torch.Generator().manual_seed(
        cs.SEED)).to(dev)
    scenes = make_synthetic_box_dataset(
        cs.DET_BATCH, hw=(cs.DET_SIZE, cs.DET_SIZE),
        min_size=int(cs.DET_SIZE * 0.25), max_size=int(cs.DET_SIZE * 0.62),
        seed=cs.SEED + 1)
    blob, scale = prepare_blob(torch.from_numpy(scenes.images).to(dev),
                               det_cfg)
    cs.scale_detector_heads(model, blob)
    gt = torch.from_numpy(np.stack(scenes.gt_boxes) * np.float32(scale)).to(
        dev)
    gc = torch.ones(cs.DET_BATCH, 1, dtype=torch.long, device=dev)
    gv = torch.ones(cs.DET_BATCH, 1, dtype=torch.bool, device=dev)
    cs.calibrate_frozen_batchnorm(model, blob)
    cs.scale_detector_heads(model, blob)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    sampling = torch.Generator(device=dev)
    kernel_bwd = ra.roi_align_bwd_cuda

    @contextlib.contextmanager
    def backward(fn):
        ra.roi_align_bwd_cuda = fn
        try:
            yield
        finally:
            ra.roi_align_bwd_cuda = kernel_bwd

    def float64_vjp(g, rois, hw, *rest):
        return ra.roi_align_bwd_plain(g.double(), rois.double(), hw,
                                      *rest).float()

    def noisy(base, eps, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)

        def fn(g, rois, hw, *rest):
            out = base(g, rois, hw, *rest)
            return out * (1 + eps * torch.randn(out.shape, device=dev,
                                                generator=gen))
        return fn

    errors = []

    def measured(g, rois, hw, *rest):
        got = kernel_bwd(g, rois, hw, *rest)
        p32 = ra.roi_align_bwd_plain(g, rois, hw, *rest)
        p64 = ra.roi_align_bwd_plain(g.double(), rois.double(), hw, *rest)
        top = float(p64.abs().max())
        errors.append((float((got.double() - p64).abs().max()) / top,
                       float((p32.double() - p64).abs().max()) / top))
        return got

    def run(ops):
        model.load_state_dict(start)
        optimizer, scheduler = make_detector_optimizer(model.parameters(),
                                                       lr=cs.DET_LR)
        step = make_detector_train_step(model, optimizer, scheduler)
        losses = []
        with ops:
            for _ in range(args.steps):
                sampling.manual_seed(cs.SEED + 2)
                losses.append(step(blob, gt, gc, gv,
                                   generator=sampling)["loss"])
        return torch.stack(losses).tolist()

    runs = {"kernel 6b": backward(measured),
            "plain VJP": backward(ra.roi_align_bwd_plain),
            "float64 VJP": backward(float64_vjp),
            "every detector op plain": cs.plain_detector_ops()}
    for eps in (1e-7, 1e-6):
        for s in range(args.draws):
            runs[f"plain VJP x (1 + {eps:g} N), draw {s}"] = backward(
                noisy(ra.roi_align_bwd_plain, eps, s))
    for s in range(args.draws):
        runs[f"kernel 6b x (1 + 1e-07 N), draw {s}"] = backward(
            noisy(kernel_bwd, 1e-7, s))
    trajectories = {}
    for name, ops in runs.items():
        trajectories[name] = run(ops)
        print(f"[study] {name}: {[round(v, 4) for v in trajectories[name]]}",
              flush=True)
        if name == "kernel 6b":
            print("[study] kernel 6b's run, each step's backward against the "
                  "float64 VJP (max|d| / max): kernel "
                  f"{[f'{k:.2e}' for k, _ in errors]}, float32 plain VJP "
                  f"{[f'{p:.2e}' for _, p in errors]}", flush=True)
    for n in range(10, args.steps + 1, 5):
        fell = [name for name, t in trajectories.items() if falls(t[:n])]
        print(f"[study] over {n} steps the loss falls in {len(fell)} of "
              f"{len(trajectories)} runs; not in: "
              f"{sorted(set(trajectories) - set(fell))}", flush=True)


if __name__ == "__main__":
    main()
