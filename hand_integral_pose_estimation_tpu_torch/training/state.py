"""Optimiser and learning-rate schedule.

Port of hand_integral_pose_estimation_tpu/training/state.py (the
reference's common/base.py:98-109, main/config.py:29-42): Adam at lr 1e-4
with L2 weight decay 1e-5 added to the gradient before the moments, which
is `torch.optim.Adam`'s own `weight_decay` (the JAX package builds the same
math as an optax chain), and a step-wise schedule that multiplies the rate
by 0.1 at epochs 30 and 60.

The learning rate is a one-element tensor that `DeviceSchedule` writes
from Adam's step count inside each step, on the optimizer's device. On the
card Adam is capturable and fused (its step counts live on the card too),
so a step captured in a CUDA graph follows the schedule on every replay,
as optax's schedule runs inside the JAX Trainer's `lax.scan`.
"""

from __future__ import annotations

from typing import Callable, Iterable, Mapping, Sequence

import torch

from hand_integral_pose_estimation_tpu_torch.config import TrainConfig


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   tcfg: TrainConfig) -> torch.optim.Adam:
    """Adam(lr, betas (0.9, 0.999), eps 1e-8, weight_decay): the optax
    chain add_decayed_weights -> scale_by_adam -> scale_by_learning_rate
    of the JAX package (state.py:45-50), with the learning rate a float32
    tensor on the parameters' device. For CUDA parameters it is capturable
    (its step counts on the card), so the step can be captured in a CUDA
    graph, and fused: one multi-tensor kernel updates every parameter,
    where the capturable foreach path forms the bias corrections tensor
    by tensor."""
    params = list(params)
    device = params[0].device
    on_card = device.type == "cuda"
    return torch.optim.Adam(
        params, lr=torch.tensor(tcfg.lr, dtype=torch.float32, device=device),
        betas=(0.9, 0.999), eps=1e-8, weight_decay=tcfg.weight_decay,
        capturable=on_card, fused=on_card or None)


def _boundaries(steps_per_epoch: int, dec_epochs: Sequence[int],
                dec_factor: float) -> list[tuple[int, float]]:
    return sorted({min(int(e * steps_per_epoch), 2**31 - 2): dec_factor
                   for e in dec_epochs}.items())


def multistep_factor(steps_per_epoch: int, dec_epochs: Sequence[int],
                     dec_factor: float) -> Callable[[int], float]:
    """step -> lr multiplier of the JAX package's `multistep_schedule`:
    optax's piecewise-constant schedule with boundaries at
    epoch * steps_per_epoch (clamped to int32), which applies a factor from
    the step equal to its boundary on. Duplicate boundaries collapse, as
    in the JAX package's dict."""
    boundaries = _boundaries(steps_per_epoch, dec_epochs, dec_factor)

    def factor(step: int) -> float:
        f = 1.0
        for boundary, scale in boundaries:
            if step >= boundary:
                f *= scale
        return f

    return factor


class DeviceSchedule:
    """The JAX package's multistep schedule computed on the optimizer's
    device, for an optimizer whose learning rate is a one-element tensor.

    `step()` follows every `optimizer.step()`: it writes the rate of the
    next step into the param groups' lr tensors from Adam's step count k,
    lr * prod(where(k >= boundary, factor, 1)) with the boundaries of
    `multistep_factor`, so the k-th step (k from 0) runs at
    lr * factor(k). Nothing is read back to the host, so it can be
    captured in a CUDA graph with the step, and construction after a
    resume continues at the snapshot's step. The base rate is kept in the
    groups' "initial_lr"."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 steps_per_epoch: int, dec_epochs: Sequence[int],
                 dec_factor: float):
        self.optimizer = optimizer
        group = optimizer.param_groups[0]
        lr = group["lr"]
        if not isinstance(lr, torch.Tensor):
            raise TypeError("the schedule writes a tensor learning rate; "
                            "make the optimizer with make_optimizer")
        for g in optimizer.param_groups:
            g.setdefault("initial_lr", float(g["lr"]))
        self._param = group["params"][0]
        f64 = dict(dtype=torch.float64, device=lr.device)
        pairs = _boundaries(steps_per_epoch, dec_epochs, dec_factor)
        self._bounds = torch.tensor([b for b, _ in pairs], **f64)
        self._factors = torch.tensor([f for _, f in pairs], **f64)
        self._base = [torch.tensor(g["initial_lr"], **f64)
                      for g in optimizer.param_groups]
        self._zero = torch.zeros((), **f64)
        self.step()

    def step(self) -> None:
        state = self.optimizer.state.get(self._param, {})
        count = state["step"] if "step" in state else self._zero
        factor = torch.where(count.to(torch.float64) >= self._bounds,
                             self._factors, 1.0).prod()
        for g, base in zip(self.optimizer.param_groups, self._base):
            g["lr"].copy_(base * factor)


def multistep_schedule(optimizer: torch.optim.Optimizer,
                       steps_per_epoch: int, dec_epochs: Sequence[int],
                       dec_factor: float) -> DeviceSchedule:
    """The schedule equal to the JAX one at every step (`DeviceSchedule`),
    for an optimizer from `make_optimizer`, fresh or resumed."""
    return DeviceSchedule(optimizer, steps_per_epoch, dec_epochs, dec_factor)


def optimizer_steps(optimizer: torch.optim.Optimizer) -> int:
    """Steps the optimizer has taken: Adam's per-parameter step count, a
    host tensor, or a device one under capturable Adam (read back here);
    0 before the first step."""
    for state in optimizer.state.values():
        if "step" in state:
            return int(state["step"])
    return 0


_IMPL_FLAGS = ("capturable", "fused", "foreach")


def load_optimizer_state(optimizer: torch.optim.Optimizer,
                         state_dict: dict) -> None:
    """Load a snapshot's optimizer state into `optimizer` in its own form:
    a snapshot of the card's capturable, fused Adam (device step counts)
    resumes in the CPU's and the other way round, and one with a float
    learning rate in an optimizer with a tensor one. Each group keeps its
    implementation flags (`capturable`, `fused`, `foreach`) and its lr
    tensor, into which the snapshot's rate is copied (the schedule then
    sets it from the step count); step counts move to the parameters'
    device when capturable, to the host otherwise."""
    own = [({k: g[k] for k in _IMPL_FLAGS}, g["lr"])
           for g in optimizer.param_groups]
    optimizer.load_state_dict(state_dict)
    for g, (flags, lr) in zip(optimizer.param_groups, own):
        g.update(flags)
        if isinstance(lr, torch.Tensor):
            lr.copy_(torch.as_tensor(g["lr"]))
            g["lr"] = lr
        else:
            g["lr"] = float(g["lr"])
        for p in g["params"]:
            state = optimizer.state.get(p, {})
            if "step" in state:
                state["step"] = state["step"].to(
                    p.device if flags["capturable"] else "cpu",
                    torch.float32)


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
