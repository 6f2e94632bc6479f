"""Checkpoint / resume.

The reference's artifact contract (common/base.py:57-71): one snapshot per
epoch, `snapshot_{epoch}.pth.tar`, holding `{"epoch", "network",
"optimizer"}`, and resume from the highest-numbered one. The learning-rate
schedule rides in the optimizer's step count, as it rides in the JAX
package's TrainState.step; under capturable Adam (on the card) the count is
a device tensor, and a snapshot resumes in either form of the optimizer
(`state.load_optimizer_state`). Files are written to a temporary name and
renamed, so a reader never sees half a snapshot.

Under a device mesh the snapshot is the whole model whatever the layout
(JAX checkpoint.py:64-68): the final projection that `parallel.place_state`
split over `model`, and its Adam moments, are gathered before rank 0
writes, and a restore cuts them to the target's blocks. So a model-split
snapshot restores onto one device and the other way round.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch
from torch import nn

from hand_integral_pose_estimation_tpu_torch.parallel import (
    gather_model,
    is_writer,
    split_params,
)
from hand_integral_pose_estimation_tpu_torch.parallel.mesh import model_slice
from hand_integral_pose_estimation_tpu_torch.training.state import (
    load_optimizer_state,
)

_SNAP_RE = re.compile(r"snapshot_(\d+)\.pth\.tar$")


def snapshot_path(ckpt_dir: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir),
                        f"snapshot_{epoch}.pth.tar")


def _relayout(model: nn.Module, network: dict, optimizer: Optional[dict],
              cut) -> tuple[dict, Optional[dict]]:
    """Copies of a state_dict and an optimizer state_dict with `cut(t)` in
    place of each split parameter and of its Adam moments."""
    split = split_params(model)
    if not split:
        return network, optimizer
    network = dict(network)
    names = [n for n, _ in model.named_parameters()]
    if optimizer is not None:
        optimizer = {**optimizer, "state": dict(optimizer["state"])}
    for name in split:
        network[name] = cut(network[name])
        i = names.index(name)
        if optimizer is not None and i in optimizer["state"]:
            optimizer["state"][i] = {
                k: cut(v) if k in ("exp_avg", "exp_avg_sq") else v
                for k, v in optimizer["state"][i].items()}
    return network, optimizer


def whole_state(model: nn.Module, optimizer=None, mesh=None
                ) -> tuple[dict, Optional[dict]]:
    """(model state_dict, optimizer state_dict or None) of the whole
    model: split blocks gathered over the model row (a collective, on
    every rank of the mesh)."""
    return _relayout(
        model, model.state_dict(),
        None if optimizer is None else optimizer.state_dict(),
        lambda t: gather_model(t.detach(), mesh, 0))


def save_checkpoint(ckpt_dir: str, model: nn.Module,
                    optimizer: torch.optim.Optimizer, epoch: int,
                    mesh=None) -> str:
    """Write `snapshot_{epoch}.pth.tar` atomically; returns its path.
    Under `mesh` every rank calls it (the gather is a collective) and
    rank 0 writes."""
    network, opt_state = whole_state(model, optimizer, mesh)
    path = snapshot_path(ckpt_dir, epoch)
    if not is_writer():
        return path
    os.makedirs(ckpt_dir, exist_ok=True)
    # a name of this process's own, so a concurrent writer never shares it;
    # created with open() so the file gets the umask's permissions
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            torch.save({"epoch": epoch, "network": network,
                        "optimizer": opt_state}, f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def latest_epoch(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    epochs = [int(m.group(1)) for name in os.listdir(ckpt_dir)
              if (m := _SNAP_RE.match(name))]
    return max(epochs) if epochs else None


def load_checkpoint(ckpt_dir: str, model: nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    epoch: Optional[int] = None, mesh=None) -> int:
    """Load a snapshot into `model` (and `optimizer` when given) in place;
    `epoch=None` takes the highest one (base.py:62-71). A model laid out
    on `mesh` gets its blocks of the split parameters. Returns the
    snapshot's epoch."""
    if epoch is None:
        epoch = latest_epoch(ckpt_dir)
        if epoch is None:
            raise FileNotFoundError(f"no snapshots under {ckpt_dir}")
    # weights_only: the envelope holds only tensors and primitives
    ckpt = torch.load(snapshot_path(ckpt_dir, epoch), map_location="cpu",
                      weights_only=True)
    network, opt_state = _relayout(
        model, ckpt["network"], ckpt["optimizer"] if optimizer else None,
        lambda t: t[model_slice(mesh, t.shape[0])])
    model.load_state_dict(network)
    if optimizer is not None:
        load_optimizer_state(optimizer, opt_state)
    return int(ckpt["epoch"])
