"""Detector training: one SGD step over the four Faster R-CNN losses.

Port of hand_integral_pose_estimation_tpu/training/detector_trainer.py: RPN
cross-entropy + smooth-L1 and detection-head cross-entropy + smooth-L1
(faster_rcnn.py:96-104, rpn.py:84-108) under the config_rcnn.py TRAIN
defaults, as the JAX package's optax chain: the gradient clipped by its
global norm (10), weight decay 5e-4 added, then SGD with momentum 0.9 at a
step-decayed rate. Every parameter trains, BatchNorm's affine parameters
included, as every leaf of the JAX parameter tree does.

The step runs eagerly; on the card its kernels are NMS (kernel 7) in the
proposal layer and ROIAlign (kernel 6) with its backward kernel.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from hand_integral_pose_estimation_tpu_torch.detect.faster_rcnn import (
    FasterRCNN,
    SamplingPriorities,
)


def make_detector_optimizer(params, lr: float = 1e-3, momentum: float = 0.9,
                            weight_decay: float = 5e-4,
                            decay_step: int = 50000,
                            decay_factor: float = 0.1):
    """SGD with momentum and weight decay, and its schedule: the rate is
    lr * decay_factor ** (step // decay_step), the decayed factor applying
    from the step equal to `decay_step` (optax's exponential_decay with
    staircase=True; the scheduler steps once per optimizer step). Returns
    (optimizer, scheduler). Clip the gradient with `clip_by_global_norm_`
    before `optimizer.step()`: torch's SGD adds the decay, then the
    momentum, as the optax chain does after its clip."""
    params = list(params)
    optimizer = torch.optim.SGD(params, lr=lr, momentum=momentum,
                                weight_decay=weight_decay)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: decay_factor ** (step // decay_step))
    return optimizer, scheduler


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """Clip `grads` in place as optax.clip_by_global_norm does: unchanged
    when their global norm is below `max_norm`, else each becomes
    (g / norm) * max_norm (no epsilon, unlike `clip_grad_norm_`). The
    choice is made on the device, with no host synchronisation. Returns the
    global norm."""
    grads = list(grads)
    norm = torch.sqrt(torch.stack([g.square().sum() for g in grads]).sum())
    under = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(under, one, norm))
    torch._foreach_mul_(grads, torch.where(under, one, one * max_norm))
    return norm


def make_detector_train_step(model: FasterRCNN, optimizer, scheduler=None,
                             loss_weights=(1.0, 1.0, 1.0, 1.0),
                             clip_norm: float = 10.0) -> Callable:
    """step(images, gt_boxes, gt_classes, gt_valid, generator=None,
    priorities=None) -> metrics: one training forward (`FasterRCNN.forward`
    with gt boxes) on the (B, H, W, 3) blob, loss = sum of the weighted
    four losses (faster_rcnn.py:106), its gradient for every parameter, the
    clip, the optimizer and scheduler steps. Metrics are the four losses
    and "loss", detached device scalars."""
    params = list(model.parameters())

    def step(images: torch.Tensor, gt_boxes: torch.Tensor,
             gt_classes: torch.Tensor, gt_valid: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             priorities: Optional[SamplingPriorities] = None) -> dict:
        model.train()
        optimizer.zero_grad()
        out = model(images, gt_boxes, gt_classes, gt_valid,
                    generator=generator, priorities=priorities)
        parts = out.losses
        loss = (loss_weights[0] * parts["rpn_cls"]
                + loss_weights[1] * parts["rpn_reg"]
                + loss_weights[2] * parts["det_cls"]
                + loss_weights[3] * parts["det_reg"])
        loss.backward()
        clip_by_global_norm_([p.grad for p in params], clip_norm)
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        metrics = {k: v.detach() for k, v in parts.items()}
        metrics["loss"] = loss.detach()
        return metrics

    return step
