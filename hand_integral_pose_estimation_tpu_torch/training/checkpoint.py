"""Checkpoint / resume.

The reference's artifact contract (common/base.py:57-71): one snapshot per
epoch, `snapshot_{epoch}.pth.tar`, holding `{"epoch", "network",
"optimizer"}`, and resume from the highest-numbered one. The learning-rate
schedule rides in the optimizer's step count, as it rides in the JAX
package's TrainState.step; under capturable Adam (on the card) the count is
a device tensor, and a snapshot resumes in either form of the optimizer
(`state.load_optimizer_state`). Files are written to a temporary name and
renamed, so a reader never sees half a snapshot.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch
from torch import nn

from hand_integral_pose_estimation_tpu_torch.training.state import (
    load_optimizer_state,
)

_SNAP_RE = re.compile(r"snapshot_(\d+)\.pth\.tar$")


def snapshot_path(ckpt_dir: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir),
                        f"snapshot_{epoch}.pth.tar")


def save_checkpoint(ckpt_dir: str, model: nn.Module,
                    optimizer: torch.optim.Optimizer, epoch: int) -> str:
    """Write `snapshot_{epoch}.pth.tar` atomically; returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = snapshot_path(ckpt_dir, epoch)
    # a name of this process's own, so a concurrent writer never shares it;
    # created with open() so the file gets the umask's permissions
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            torch.save({"epoch": epoch, "network": model.state_dict(),
                        "optimizer": optimizer.state_dict()}, f)
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
                    epoch: Optional[int] = None) -> int:
    """Load a snapshot into `model` (and `optimizer` when given) in place;
    `epoch=None` takes the highest one (base.py:62-71). Returns the
    snapshot's epoch."""
    if epoch is None:
        epoch = latest_epoch(ckpt_dir)
        if epoch is None:
            raise FileNotFoundError(f"no snapshots under {ckpt_dir}")
    # weights_only: the envelope holds only tensors and primitives
    ckpt = torch.load(snapshot_path(ckpt_dir, epoch), map_location="cpu",
                      weights_only=True)
    model.load_state_dict(ckpt["network"])
    if optimizer is not None:
        load_optimizer_state(optimizer, ckpt["optimizer"])
    return int(ckpt["epoch"])
