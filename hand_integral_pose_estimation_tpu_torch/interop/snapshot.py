"""Load a reference pose snapshot (`snapshot_*.pth`) natively.

The reference trains `ResPoseNet(backbone, head)` (main/model.py:58-66) and
saves `{"epoch", "network", "optimizer"}` (common/base.py:57-67), the
network's `state_dict()` under DataParallel's `module.` prefix. Its keys are
this package's parameter names, so the snapshot loads with
`load_state_dict`. Envelope handling as in `load_torch_state_dict`
(hand_integral_pose_estimation_tpu/interop/torch_weights.py:270).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn


def load_state_dict_file(path: str) -> Dict[str, Any]:
    """torch.load a .pth on the CPU, unwrap a `{"model": ...}` or
    `{"network": ...}` envelope and strip the `module.` prefix."""
    # weights_only: snapshots come from outside and full unpickling would
    # run arbitrary code; the envelopes hold only tensors and primitives
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model", "network"):
        if isinstance(ckpt, dict) and isinstance(ckpt.get(key), dict):
            ckpt = ckpt[key]
            break
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in ckpt.items()}


def load_pose_snapshot(model: nn.Module, path: str) -> nn.Module:
    """Load a reference pose snapshot into `model` (strict: a snapshot of
    another architecture fails by key or shape)."""
    model.load_state_dict(load_state_dict_file(path))
    return model
