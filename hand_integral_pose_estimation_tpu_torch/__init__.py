"""hand_integral_pose_estimation_tpu_torch — the PyTorch / CUDA port.

A second package beside the JAX reference `hand_integral_pose_estimation_tpu`,
written in PyTorch for one NVIDIA Hopper GPU. It ports the pose-serving path:
the eval crop (`data/pipeline.py`), the ResNet + deconv pose net
(`models/`), the fused projection + soft-argmax decode and the plain
soft-argmax decode (`ops/`, with hand-written CUDA kernels in `csrc/`), and
the PA-MPJPE / MPJPE evaluation (`evaluation/`), driven by
`training.Tester` and `cli/test.py`.

Public layouts follow the JAX package so the two compare like with like:
images NHWC (B, H, W, 3), features (B, H, W, F), heatmap channel
= j*depth + d, coords (B, J, 3) in [-0.5, 0.5].

The port imports torch and numpy, never jax; from the JAX package it shares
only the pure-dataclass `config` module.
"""

__version__ = "0.1.0"

from hand_integral_pose_estimation_tpu_torch.config import (  # noqa: F401
    AugmentConfig,
    Config,
    FreiHandJoints,
    ModelConfig,
)
