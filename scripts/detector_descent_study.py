"""How far the detector's loss falls over SGD steps on one batch, and how
much of that float32 rounding decides: the PyTorch port on one CUDA card.

`chip_smoke.py` (phase 9c) trains the R101 detector at 600^2 x 4 on
synthetic scenes, with the frozen BatchNorm statistics set from the scenes
and the heads scaled, taking SGD steps at `chip_smoke.DET_LR` with the
same anchor and RoI draws each step, and holds that the loss falls (the
last below the first, the mean of the last three below that of the first
three). Left to move with the weights ("moving"), the proposals change
the objective from step to step, and a change at the level of float32
rounding can turn a trajectory; with the first step's proposals fed back
each step ("frozen", `chip_smoke.frozen_proposals`, what phase 9c runs)
the steps descend one fixed objective, and at a rate too large for the
net's curvature rounding still parts the runs. This script takes the
same steps from the same state, in either mode and at each rate given,
in runs that differ only in that rounding:

- the ROIAlign backward kernel (kernel 6b), as the port runs;
- its plain VJP in float32, and in float64 rounded once to float32;
- every detector op plain (NMS, ROIAlign and its backward);
- the plain VJP, and the kernel, times (1 + eps N(0, 1)) for eps 1e-7
  and 1e-6, a few draws each.

It prints each run's losses, the kernel's and the float32 plain VJP's
largest error against the float64 VJP at each step of the kernel's run
(of the largest entry), and in how many runs the loss falls within each
horizon; on the frozen proposals also each run's margin
(`chip_smoke.descent_margin` over phase 9c's steps), the smallest, their
spread (largest less smallest) and the smallest over the spread, which
must be at least 10. With `--faults`, on the frozen proposals it then
takes the same steps with a fault planted, to show what the check can
still see: kernel 6b's gradient negated or zeroed, the RPN's or the
detection head's (stage 4 and the two Linear heads) parameter gradients
zeroed, or every gradient negated; each fault's margin is printed beside
the sound runs' spread, and phase 9c's check catches it where the margin
is not above 0. Run from the repo root on a machine with a CUDA card:

    python3 scripts/detector_descent_study.py [--steps 30]
        [--proposals moving|frozen|both] [--lr 1e-3 3e-7 ...] [--faults]
"""

import argparse
import contextlib
import dataclasses
import itertools
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
    return cs.descent_margin(losses) > 0


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--draws", type=int, default=4)
    parser.add_argument("--proposals", choices=("moving", "frozen", "both"),
                        default="both")
    parser.add_argument("--lr", type=float, nargs="+", default=[cs.DET_LR],
                        help="SGD rates to study, each in turn")
    parser.add_argument("--faults", action="store_true",
                        help="also take the steps with planted faults, on "
                             "the frozen proposals")
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

    def scaled_grads(prefixes, factor):
        """An optimizer pre-step hook that scales the (clipped) gradients
        of the parameters whose names start with one of `prefixes`."""
        def hook(*_):
            for name, p in model.named_parameters():
                if p.grad is not None and name.startswith(prefixes):
                    p.grad.mul_(factor)
        return hook

    def run(ops, proposals, lr, fault=None):
        model.load_state_dict(start)
        optimizer, scheduler = make_detector_optimizer(model.parameters(),
                                                       lr=lr)
        if fault is not None:
            optimizer.register_step_pre_hook(fault)
        step = make_detector_train_step(model, optimizer, scheduler)
        losses = []
        held = (cs.frozen_proposals() if proposals == "frozen"
                else contextlib.nullcontext())
        with ops, held:
            for _ in range(args.steps):
                sampling.manual_seed(cs.SEED + 2)
                losses.append(step(blob, gt, gc, gv,
                                   generator=sampling)["loss"])
        return torch.stack(losses).tolist()

    def runs():
        """Fresh contexts for the 16 runs (a context is used once)."""
        out = {"kernel 6b": backward(measured),
               "plain VJP": backward(ra.roi_align_bwd_plain),
               "float64 VJP": backward(float64_vjp),
               "every detector op plain": cs.plain_detector_ops()}
        for eps in (1e-7, 1e-6):
            for s in range(args.draws):
                out[f"plain VJP x (1 + {eps:g} N), draw {s}"] = backward(
                    noisy(ra.roi_align_bwd_plain, eps, s))
        for s in range(args.draws):
            out[f"kernel 6b x (1 + 1e-07 N), draw {s}"] = backward(
                noisy(kernel_bwd, 1e-7, s))
        return out

    def faults():
        """Fresh (ops context, optimizer hook) pairs for the planted
        faults."""
        head = ("RCNN_top.", "RCNN_cls_score.", "RCNN_bbox_pred.")
        return {
            "kernel 6b x -1": (backward(lambda *a: -kernel_bwd(*a)), None),
            "kernel 6b x 0": (backward(
                lambda *a: torch.zeros_like(kernel_bwd(*a))), None),
            "the RPN's gradient zeroed": (
                contextlib.nullcontext(), scaled_grads(("RCNN_rpn.",), 0.0)),
            "the detection head's gradient zeroed": (
                contextlib.nullcontext(), scaled_grads(head, 0.0)),
            "every gradient x -1": (
                contextlib.nullcontext(), scaled_grads(("",), -1.0)),
        }

    modes = (("moving", "frozen") if args.proposals == "both"
             else (args.proposals,))
    for lr, proposals in itertools.product(args.lr, modes):
        mode = f"{proposals} proposals at lr {lr:g}"
        trajectories = {}
        for name, ops in runs().items():
            errors.clear()
            trajectories[name] = run(ops, proposals, lr)
            print(f"[study] {mode}, {name}: "
                  f"{[round(v, 6) for v in trajectories[name]]}", flush=True)
            if name == "kernel 6b":
                print("[study] kernel 6b's run, each step's backward against "
                      "the float64 VJP (max|d| / max): kernel "
                      f"{[f'{k:.2e}' for k, _ in errors]}, float32 plain VJP "
                      f"{[f'{p:.2e}' for _, p in errors]}", flush=True)
        for n in range(10, args.steps + 1, 5):
            fell = [name for name, t in trajectories.items()
                    if falls(t[:n])]
            print(f"[study] {mode}: over {n} steps the loss falls "
                  f"in {len(fell)} of {len(trajectories)} runs; not in: "
                  f"{sorted(set(trajectories) - set(fell))}", flush=True)
        n = min(cs.DET_TRAIN_STEPS, args.steps)
        margins = {name: cs.descent_margin(t[:n])
                   for name, t in trajectories.items()}
        least = min(margins.values())
        spread = max(margins.values()) - least
        finals = [t[n - 1] for t in trajectories.values()]
        steps = np.array(list(trajectories.values()))
        print(f"[study] {mode}: spread between the runs at each step "
              f"{[f'{v:.2e}' for v in steps.max(0) - steps.min(0)]}",
              flush=True)
        print(f"[study] {mode} over {n} steps (phase 9c's): "
              f"margins {[f'{v:.6g}' for v in margins.values()]}; the least "
              f"{least:.6g}, spread {spread:.3e} (final losses' spread "
              f"{max(finals) - min(finals):.3e}); least / spread "
              f"{least / spread if spread > 0 else float('inf'):.4g} "
              f"(phase 9c needs > 0 and at least 10)", flush=True)
        if not args.faults or proposals != "frozen":
            continue
        for name, (ops, hook) in faults().items():
            t = run(ops, proposals, lr, hook)[:n]
            margin = cs.descent_margin(t)
            print(f"[study] {mode}, planted fault {name}: "
                  f"{[round(v, 6) for v in t]}; margin {margin:.6g}, "
                  f"{(margin - least) / spread:.4g} spreads from the sound "
                  f"runs' least; phase 9c's check "
                  f"{'passes' if margin > 0 else 'catches it'}", flush=True)


if __name__ == "__main__":
    main()
