"""hand_integral_pose_estimation_tpu_torch — the PyTorch / CUDA port.

A second package beside the JAX reference `hand_integral_pose_estimation_tpu`,
written in PyTorch for one NVIDIA Hopper GPU. It ports the pose-serving,
pose-training and two-stage serving paths: the eval crop and the training
augmentation (`data/pipeline.py`, `geometry/`), the ResNet + deconv pose
net (`models/`), the fused projection + soft-argmax decode, the plain
soft-argmax decode, their backwards, the two-pass warp, NMS and ROIAlign
(`ops/`, with hand-written CUDA kernels in `csrc/`), the Faster R-CNN hand
detector (`detect/`) and the detector -> crop -> pose pipeline
(`inference.py`), the losses, Adam with the step schedule, checkpoints
and CUDA-graph replay of the train chunks and eval batches (`losses.py`,
`training/`), the PA-MPJPE / MPJPE evaluation, the challenge dump and the
offline PCK / AUC scorer (`evaluation/`) and the metrics writer
(`utils/`), driven by `training.Trainer`, `training.Tester`,
`training.Evaluator`, `inference.TwoStagePipeline` and `cli/{train,test,
evaluate,score}.py`.

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
