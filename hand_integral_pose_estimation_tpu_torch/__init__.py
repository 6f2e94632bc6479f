"""hand_integral_pose_estimation_tpu_torch — the PyTorch / CUDA port.

A second package beside the JAX reference `hand_integral_pose_estimation_tpu`,
written in PyTorch for one NVIDIA Hopper GPU. It ports the pose-serving,
pose-training, two-stage serving, semi-supervised and detector-training
paths: the synthetic and the file-backed FreiHAND splits with the native
JPEG decoder and its batch prefetcher, the YUV 4:2:0 transport (`data/`,
`ops/yuv.py`), the eval crop and the training augmentation (`data/`,
`geometry/`), the ResNet + deconv pose net and PANet (`models/`), the
fused projection + soft-argmax decode, the plain soft-argmax decode, their
backwards, the two-pass warp, NMS and ROIAlign (`ops/`, with hand-written
CUDA kernels in `csrc/`), the Faster R-CNN hand detector (`detect/`) and
the detector -> crop -> pose pipeline (`inference.py`), int8
post-training quantization (`quantize/`), the losses, Adam with the step
schedule, checkpoints, CUDA-graph replay of the train chunks and eval
batches, the frozen teacher and the PANet trainer (`losses.py`,
`training/`), the rotation-variance teacher labels and their cascade
(`distill/`), the PA-MPJPE / MPJPE evaluation, the challenge dump and the
offline PCK / AUC scorer (`evaluation/`) and the metrics writer
(`utils/`), driven by `training.Trainer`, `training.Tester`,
`training.Evaluator`, `inference.TwoStagePipeline` and `cli/`.

Public layouts follow the JAX package so the two compare like with like:
images NHWC (B, H, W, 3), features (B, H, W, F), heatmap channel
= j*depth + d, coords (B, J, 3) in [-0.5, 0.5].

The port imports torch and numpy, never jax and nothing of the JAX
package (`config.py`, `detect/config_compat.py` and `detect/synthetic.py`
are copies).
"""

__version__ = "0.1.0"

from hand_integral_pose_estimation_tpu_torch.config import (  # noqa: F401
    AugmentConfig,
    Config,
    FreiHandJoints,
    ModelConfig,
    TrainConfig,
)
