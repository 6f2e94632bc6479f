"""PANet (NRSfM) trainer: device-resident data, random minibatches.

Port of hand_integral_pose_estimation_tpu/training/panet_trainer.py (the
reference's procrustes_encoding/train_pytorch/train_kernel.py): the whole
point set on the device, random minibatch indices, optional per-sample
axis-angle rotation augmentation, Adam with the staircase exponential
decay, best-by-validation weights and a NaN guard. The JAX package scans a
chunk of `eval_every` steps as one program; here the steps run eagerly,
the host reads each step's loss for the NaN guard and each chunk's
validation loss.

The NaN guard checks before the update takes effect (the reference checks
after backward(), train_kernel.py:304-308, a fault not copied): a step
whose loss is not finite leaves the parameters, Adam's moments, its step
count and the schedule as they were. Adam with a StepLR is optax's
`adam(exponential_decay(lr, every, decay, staircase=True))`.
"""

from __future__ import annotations

import copy
from typing import NamedTuple

import numpy as np
import torch

from hand_integral_pose_estimation_tpu_torch.geometry import rotation
from hand_integral_pose_estimation_tpu_torch.models.panet import (
    PANet,
    panet_loss,
    panet_loss_per_sample,
)

class PANetTrainResult(NamedTuple):
    model: PANet                # the last step's weights
    best_state: dict            # state dict with the best validation loss
    best_val_loss: float
    train_losses: np.ndarray    # (chunks,) mean train loss of each chunk
    val_losses: np.ndarray      # (chunks,)


def _augment_rotation(generator: torch.Generator, pts: torch.Tensor,
                      aug_rotate_val: float = 0.15) -> torch.Tensor:
    """Per-sample axis-angle rotation (train_kernel.py:406-414): each
    sample draws a (3,) axis-angle vector with components ~ Normal(val,
    2 val) from `generator`, and pts <- pts @ Rodrigues(angles)."""
    angles = (torch.randn(pts.shape[0], 3, generator=generator,
                          dtype=pts.dtype, device=pts.device)
              * (aug_rotate_val + aug_rotate_val) + aug_rotate_val)
    return torch.einsum("bpj,bjk->bpk", pts, rotation.rodrigues(angles))


def train_panet(model: PANet, train_pts, val_pts, num_steps: int = 2000,
                batch_size: int = 500, lr: float = 1e-3,
                lr_decay_every: int = 100000, lr_decay: float = 0.5,
                sparsity_weight: float = 1e-4,
                augment_rotation: bool = False, seed: int = 0,
                eval_every: int = 200) -> PANetTrainResult:
    """Train `model` in place on its device from its current weights.

    train_pts / val_pts: (N, P, 3) arrays or tensors, already mean-centred
    (train.py:121). Steps run in chunks of `eval_every`; after each, the
    validation loss over all of `val_pts` decides the best weights. Batch
    indices and the rotations come from one generator seeded with
    `seed`."""
    params = list(model.parameters())
    dev = params[0].device
    dt = params[0].dtype
    train_pts = torch.as_tensor(train_pts).to(dev, dt)
    val_pts = torch.as_tensor(val_pts).to(dev, dt)
    generator = torch.Generator(device=dev).manual_seed(seed)
    opt = torch.optim.Adam(params, lr=lr)
    sched = torch.optim.lr_scheduler.StepLR(opt, lr_decay_every, lr_decay)

    best_state = copy.deepcopy(model.state_dict())
    best_val = float("inf")
    train_hist, val_hist = [], []
    done = 0
    while done < num_steps:
        n = min(eval_every, num_steps - done)
        losses = []
        for _ in range(n):
            batch = train_pts[torch.randint(
                0, train_pts.shape[0], (batch_size,), generator=generator,
                device=dev)]
            if augment_rotation:
                batch = _augment_rotation(generator, batch)
            loss, _ = panet_loss(model, batch, sparsity_weight)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            if torch.isfinite(loss):
                opt.step()
                sched.step()
            losses.append(loss.detach())
        with torch.no_grad():
            val_loss = float(panet_loss(model, val_pts, sparsity_weight)[0])
        train_hist.append(float(torch.stack(losses).mean()))
        val_hist.append(val_loss)
        if val_loss < best_val:
            best_val = val_loss
            best_state = copy.deepcopy(model.state_dict())
        done += n
    opt.zero_grad(set_to_none=True)
    return PANetTrainResult(model=model, best_state=best_state,
                            best_val_loss=best_val,
                            train_losses=np.asarray(train_hist),
                            val_losses=np.asarray(val_hist))


class CompositePANetResult(NamedTuple):
    #: one state dict per component; component 0 is the pretrained base
    components: list
    #: (N,) per-sample composite loss before and after boosting
    loss_before: np.ndarray
    loss_after: np.ndarray


@torch.no_grad()
def composite_loss_per_sample(model: PANet, components: list,
                              pts: torch.Tensor) -> torch.Tensor:
    """Each sample scored by its best-fitting component (the mixture
    semantics of train_composite_model, train_kernel.py:440-488): the
    minimum over the components' per-sample losses. `model` gives the
    architecture (a copy loads each component's state dict)."""
    scratch = copy.deepcopy(model)
    losses = []
    for state in components:
        scratch.load_state_dict(state)
        losses.append(panet_loss_per_sample(scratch, pts))
    return torch.stack(losses).min(dim=0).values


def train_composite_panet(model: PANet, base_state: dict, train_pts,
                          comp_num: int = 3, hard_fraction: float = 0.1,
                          num_steps: int = 2000, batch_size: int = 500,
                          lr: float = 1e-3, sparsity_weight: float = 1e-4,
                          augment_rotation: bool = False, seed: int = 0,
                          eval_every: int = 200) -> CompositePANetResult:
    """Hard-example boosting (train_kernel.py:440-488): from the
    pretrained component 0, repeatedly score every training sample with
    the current composite, take the worst `hard_fraction`, train a new
    component on them (from the previous component's weights; the hard
    set is both its training and its validation set, as the reference has
    it at :488) and append its best weights. `model` is trained in place
    and ends with the last component's final weights."""
    dev = next(model.parameters()).device
    pts = torch.as_tensor(train_pts).to(dev, torch.float32)
    hard_num = max(1, int(pts.shape[0] * hard_fraction))
    components = [base_state]
    loss_before = composite_loss_per_sample(model, components, pts)
    for comp_id in range(1, comp_num):
        loss_ps = composite_loss_per_sample(model, components, pts)
        hard = pts[torch.argsort(-loss_ps)[:hard_num]]
        model.load_state_dict(components[-1])
        result = train_panet(
            model, hard, hard, num_steps=num_steps,
            batch_size=min(batch_size, hard_num), lr=lr,
            sparsity_weight=sparsity_weight,
            augment_rotation=augment_rotation, seed=seed + comp_id,
            eval_every=eval_every)
        components.append(result.best_state)
    loss_after = composite_loss_per_sample(model, components, pts)
    return CompositePANetResult(components=components,
                                loss_before=loss_before.cpu().numpy(),
                                loss_after=loss_after.cpu().numpy())
