"""Load a reference pose snapshot (`snapshot_*.pth`) natively, and
initialise a pose net's backbone from a torchvision ImageNet ResNet.

The reference trains `ResPoseNet(backbone, head)` (main/model.py:58-66) and
saves `{"epoch", "network", "optimizer"}` (common/base.py:57-67), the
network's `state_dict()` under DataParallel's `module.` prefix. Its keys are
this package's parameter names, so the snapshot loads with
`load_state_dict`. Envelope handling as in `load_torch_state_dict`
(hand_integral_pose_estimation_tpu/interop/torch_weights.py:270).

The ImageNet init (`imagenet_init_backbone`) is the counterpart of
`imagenet_init_pose_variables` (torch_weights.py:127-146, 337-363), the
reference's `ResNetBackbone.init_weights` (common/nets/resnet.py:70-76):
the backbone's parameter names are torchvision's, so the model-zoo dict
loads into `model.backbone` as it is.
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


def imagenet_init_backbone(model: nn.Module, state_dict: Dict[str, Any],
                           resnet_type: int) -> nn.Module:
    """Overwrite `model.backbone` with a torchvision ImageNet ResNet state
    dict; the head keeps its weights. `fc.*` and `avgpool.*` are dropped,
    and the backbone keeps its own `num_batches_tracked` (the JAX package
    has no such counter). A missing or extra key, or a shape that differs,
    raises ValueError naming `resnet{resnet_type}`. Returns `model`."""
    own = model.backbone.state_dict()
    counters = {k for k in own if k.endswith("num_batches_tracked")}
    given = {k: v for k, v in state_dict.items()
             if not k.startswith(("fc.", "avgpool."))
             and not k.endswith("num_batches_tracked")}
    missing = sorted(own.keys() - counters - given.keys())
    extra = sorted(given.keys() - own.keys())
    shapes = sorted(k for k in given.keys() & own.keys()
                    if tuple(given[k].shape) != tuple(own[k].shape))
    if missing or extra or shapes:
        raise ValueError(
            f"the ImageNet state dict does not match the model's backbone "
            f"(resnet_type mismatch? model expects resnet{resnet_type}): "
            f"{len(missing)} missing {missing[:3]}, {len(extra)} unexpected "
            f"{extra[:3]}, {len(shapes)} of another shape {shapes[:3]}")
    model.backbone.load_state_dict({**given, **{k: own[k] for k in counters}})
    return model
