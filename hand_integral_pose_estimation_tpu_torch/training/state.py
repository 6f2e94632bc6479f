"""Optimiser and learning-rate schedule.

Port of hand_integral_pose_estimation_tpu/training/state.py (the
reference's common/base.py:98-109, main/config.py:29-42): Adam at lr 1e-4
with L2 weight decay 1e-5 added to the gradient before the moments, which
is `torch.optim.Adam`'s own `weight_decay` (the JAX package builds the same
math as an optax chain), and a step-wise schedule that multiplies the rate
by 0.1 at epochs 30 and 60.
"""

from __future__ import annotations

from typing import Callable, Iterable, Mapping, Sequence

import torch

from hand_integral_pose_estimation_tpu_torch.config import TrainConfig


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   tcfg: TrainConfig) -> torch.optim.Adam:
    """Adam(lr, betas (0.9, 0.999), eps 1e-8, weight_decay): the optax
    chain add_decayed_weights -> scale_by_adam -> scale_by_learning_rate
    of the JAX package (state.py:45-50)."""
    return torch.optim.Adam(params, lr=tcfg.lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=tcfg.weight_decay)


def multistep_factor(steps_per_epoch: int, dec_epochs: Sequence[int],
                     dec_factor: float) -> Callable[[int], float]:
    """step -> lr multiplier of the JAX package's `multistep_schedule`:
    optax's piecewise-constant schedule with boundaries at
    epoch * steps_per_epoch (clamped to int32), which applies a factor from
    the step equal to its boundary on. Duplicate boundaries collapse, as
    in the JAX package's dict."""
    boundaries = sorted({min(int(e * steps_per_epoch), 2**31 - 2): dec_factor
                         for e in dec_epochs}.items())

    def factor(step: int) -> float:
        f = 1.0
        for boundary, scale in boundaries:
            if step >= boundary:
                f *= scale
        return f

    return factor


def multistep_schedule(optimizer: torch.optim.Optimizer,
                       steps_per_epoch: int, dec_epochs: Sequence[int],
                       dec_factor: float, step: int = 0
                       ) -> torch.optim.lr_scheduler.LambdaLR:
    """A per-step `LambdaLR` equal to the JAX schedule at every step: the
    k-th optimizer step (k from 0) runs at lr * factor(k), so
    `scheduler.step()` follows every `optimizer.step()`. `step` resumes the
    schedule after that many steps (the optimizer's param groups must then
    come from a checkpoint, which holds their "initial_lr")."""
    return torch.optim.lr_scheduler.LambdaLR(
        optimizer, multistep_factor(steps_per_epoch, dec_epochs, dec_factor),
        last_epoch=step - 1)


def optimizer_steps(optimizer: torch.optim.Optimizer) -> int:
    """Steps the optimizer has taken: Adam's per-parameter step count,
    which it keeps on the host (0 before the first step)."""
    for state in optimizer.state.values():
        if "step" in state:
            return int(state["step"])
    return 0


def compare_state_dicts(a: Mapping[str, torch.Tensor],
                        b: Mapping[str, torch.Tensor]) -> float:
    """Max absolute difference between two state dicts (the teacher-vs-
    student weight check, common/base.py:73-86 `compare_models`); +inf
    when their keys or shapes differ."""
    if a.keys() != b.keys():
        return float("inf")
    diff = 0.0
    for k in a:
        x, y = a[k], b[k]
        if x.shape != y.shape:
            return float("inf")
        if x.numel():
            diff = max(diff, float((x.double() - y.to(x.device).double())
                                   .abs().max()))
    return diff
