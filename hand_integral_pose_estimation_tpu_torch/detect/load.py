"""Build the Faster R-CNN hand detector, restore and save its weights.

Port of hand_integral_pose_estimation_tpu/detect/load.py, the runner-side
analogue of the reference's `load_faster_rcnn_detector`
(common/hand_detector.py:111-158), which loads externally trained
`faster_rcnn_*.pth` files. Those load natively here: the port's parameter
names are the reference's. Snapshots of `cli.train_detector`
(`save_detector`) use the same `{"model": state_dict}` envelope and record
the architecture they were trained with, which a restore must match.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from hand_integral_pose_estimation_tpu_torch.config import DetectorConfig
from hand_integral_pose_estimation_tpu_torch.detect.faster_rcnn import (
    FasterRCNN,
)
from hand_integral_pose_estimation_tpu_torch.interop.snapshot import (
    load_state_dict_file,
)


def default_resnet_style(ckpt_path: Optional[str],
                         fallback: str = "torchvision") -> str:
    """Block variant for a detector checkpoint path: a torch `.pth` / `.pt`
    is the reference's layout, whose weights need "caffe" blocks (stride on
    the first 1x1 conv, faster_rcnn/resnet.py:67-80); anything else keeps
    `fallback`. `--detector-style` overrides it."""
    return ("caffe" if (ckpt_path or "").endswith((".pth", ".pt"))
            else fallback)


#: the DetectorConfig fields a snapshot's weights depend on beyond their
#: shapes (the block variant moves strides, the norm swaps layers)
ARCHITECTURE_FIELDS = ("resnet_type", "norm", "resnet_style")


def save_detector(model: FasterRCNN, path: str) -> str:
    """Write `{"model": state_dict, "architecture": {...}}` (the
    reference's envelope, tensors on the CPU, and the configuration fields
    of ARCHITECTURE_FIELDS) to `path`; `build_detector` restores it."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"model": {k: v.detach().cpu()
                          for k, v in model.state_dict().items()},
                "architecture": {f: getattr(model.cfg, f)
                                 for f in ARCHITECTURE_FIELDS}}, path)
    return path


def _check_architecture(det_cfg: DetectorConfig, ckpt_path: str) -> None:
    """A snapshot of `save_detector` must match `det_cfg` in its recorded
    architecture; a file without that record is the reference's, whose
    weights need caffe-style blocks and BatchNorm."""
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    arch = ckpt.get("architecture") if isinstance(ckpt, dict) else None
    if arch is None:
        if det_cfg.resnet_style != "caffe" or det_cfg.norm != "batch":
            raise ValueError(
                "reference faster_rcnn_*.pth weights need caffe-style blocks "
                "and BatchNorm (DetectorConfig.resnet_style='caffe', "
                "norm='batch'); got "
                f"{det_cfg.resnet_style!r} and {det_cfg.norm!r}")
        return
    wrong = {k: (v, getattr(det_cfg, k)) for k, v in arch.items()
             if getattr(det_cfg, k) != v}
    if wrong:
        raise ValueError(f"detector snapshot {ckpt_path!r} was trained with "
                         + ", ".join(f"{k}={v!r} (configured {c!r})"
                                     for k, (v, c) in wrong.items()))


def build_detector(det_cfg: DetectorConfig,
                   ckpt_path: Optional[str] = None,
                   generator: Optional[torch.Generator] = None,
                   log=print) -> FasterRCNN:
    """A FasterRCNN in eval mode on the CPU, channels_last, with weights
    drawn from `generator` (torch's default generator when None) or loaded
    from a reference `.pth` / `.pt` or a `save_detector` snapshot (a
    `{"model": state_dict}` envelope is unwrapped) with a strict
    `load_state_dict`.

    An explicitly given `ckpt_path` that does not exist raises: a mistyped
    path must not fall through to random weights. Orbax checkpoint
    directories, the JAX package's format, are refused."""
    if ckpt_path and not os.path.exists(ckpt_path):
        raise FileNotFoundError(
            f"detector checkpoint {ckpt_path!r} does not exist "
            "(omit --detector-ckpt to run with random weights)")
    if ckpt_path and not ckpt_path.endswith((".pth", ".pt")):
        raise ValueError(
            f"detector checkpoint {ckpt_path!r} is not a torch .pth/.pt "
            "file: orbax checkpoint directories are the JAX package's "
            "format and do not load here")
    model = FasterRCNN(det_cfg)
    model.reset_parameters(generator)
    if ckpt_path:
        _check_architecture(det_cfg, ckpt_path)
        model.load_state_dict(load_state_dict_file(ckpt_path))
        log(f"loaded torch detector checkpoint from {ckpt_path}")
    return model.to(memory_format=torch.channels_last).eval()
