"""Build the Faster R-CNN hand detector and restore its weights.

Port of hand_integral_pose_estimation_tpu/detect/load.py, the runner-side
analogue of the reference's `load_faster_rcnn_detector`
(common/hand_detector.py:111-158), which loads externally trained
`faster_rcnn_*.pth` files. Those load natively here: the port's parameter
names are the reference's.
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


def build_detector(det_cfg: DetectorConfig,
                   ckpt_path: Optional[str] = None,
                   generator: Optional[torch.Generator] = None,
                   log=print) -> FasterRCNN:
    """A FasterRCNN in eval mode on the CPU, channels_last, with weights
    drawn from `generator` (torch's default generator when None) or loaded
    from a reference `.pth` / `.pt` (a `{"model": state_dict}` envelope is
    unwrapped) with a strict `load_state_dict`.

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
        if det_cfg.resnet_style != "caffe" or det_cfg.norm != "batch":
            raise ValueError(
                "reference faster_rcnn_*.pth weights need caffe-style blocks "
                "and BatchNorm (DetectorConfig.resnet_style='caffe', "
                "norm='batch'); got "
                f"{det_cfg.resnet_style!r} and {det_cfg.norm!r}")
        model.load_state_dict(load_state_dict_file(ckpt_path))
        log(f"loaded torch detector checkpoint from {ckpt_path}")
    return model.to(memory_format=torch.channels_last).eval()
