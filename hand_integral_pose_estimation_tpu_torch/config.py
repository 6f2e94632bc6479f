"""Typed configuration tree (no import-time side effects).

A copy of hand_integral_pose_estimation_tpu/config.py, so that the port
imports nothing of the JAX package: frozen dataclasses whose values mirror
the reference's defaults (main/config.py, procrustes_encoding/
config_panet.py, lib/model_rcnn/utils/config_rcnn.py). The test suite holds
every field and default of the copy equal to the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


class FreiHandJoints:
    """FreiHAND 21-joint schema (reference: data/FreiHand/FreiHand_config.py:56-61)."""

    num_joints: int = 21
    #: middle-finger MCP; used as the depth-normalisation root
    root_idx: int = 9
    #: 20-bone skeleton (parent, child)
    bones: Tuple[Tuple[int, int], ...] = (
        (0, 1), (1, 2), (2, 3), (3, 4),
        (0, 5), (5, 6), (6, 7), (7, 8),
        (0, 9), (9, 10), (10, 11), (11, 12),
        (0, 13), (13, 14), (14, 15), (15, 16),
        (0, 17), (17, 18), (18, 19), (19, 20),
    )
    #: bone used for scale normalisation at eval time (FreiHand.py:622-630)
    ref_bone: Tuple[int, int] = (9, 10)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Pose network (reference: main/model.py, main/config.py:23-47)."""

    resnet_type: int = 50            # 18 | 34 | 50 | 101 | 152
    input_shape: Tuple[int, int] = (224, 224)   # (H, W)
    #: heatmap spatial resolution = input/4 (config.py:24)
    output_shape: Tuple[int, int] = (56, 56)
    depth_dim: int = 56              # config.py:25
    num_deconv_layers: int = 3       # model.py:13
    deconv_channels: int = 256       # model.py:9
    num_joints: int = FreiHandJoints.num_joints
    #: compute dtype for the conv stack; params stay float32
    compute_dtype: str = "bfloat16"
    #: deconv lowering of the JAX package ("transpose" or "phase"); the
    #: port always runs torch's ConvTranspose2d
    deconv_impl: str = "auto"

    @property
    def heatmap_channels(self) -> int:
        # model.py:16 — joint_num * depth_dim output channels of the 1x1 conv
        return self.num_joints * self.depth_dim


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Geometric/photometric augmentation (reference: common/augment.py:235-280)."""

    scale: float = 1.0               # fixed; augment.py:241
    color_factor: float = 0.2        # ±20% per channel; augment.py:238
    #: probability of applying a rotation at all (augment.py:257 — random()<=0.6 is identity)
    rot_prob: float = 0.4
    z_rot_range: float = 0.52        # radians; augment.py:259
    arbitrary_rot_range: float = 0.05  # radians; augment.py:271
    pad_factor: float = 1.75         # bbox padding; config.py:47
    #: tprime scaling constant (config.py:67) — canonical hand depth scale
    scaling_constant: float = 100.0
    pixel_mean: Tuple[float, float, float] = (0.4559, 0.5142, 0.5148)  # config.py:65
    pixel_std: Tuple[float, float, float] = (1.0, 1.0, 1.0)            # config.py:66


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimisation schedule (reference: main/config.py:29-42, common/base.py:98-109)."""

    lr: float = 1e-4
    lr_dec_epoch: Tuple[int, ...] = (30, 60)
    lr_dec_factor: float = 0.1
    end_epoch: int = 400
    weight_decay: float = 1e-5
    batch_size: int = 32             # per data-parallel shard (config.py:39)
    test_batch_size: int = 16
    eval_batch_size: int = 32
    #: semi-supervised knobs (config.py:49-62)
    loss: str = "L_combined"
    lam: float = 0.0                 # cfg._lambda — PANet loss weight
    labelled_data_range: int = 3256
    training_size: int = 26050
    testing_size: int = 3255
    labelled_selection_prob: float = 0.5
    use_filtered_data: bool = True
    #: pseudo-label variance threshold (generate_filtered_teacher_labels.py:490-495)
    teacher_variance_threshold: float = 1e-4
    #: number of evenly spaced rotations for the teacher variance filter (:467-489)
    teacher_num_rotations: int = 21
    teacher_rotation_range: float = 0.52
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Faster R-CNN hand detector (reference: common/hand_detector.py,
    lib/model_rcnn/utils/config_rcnn.py)."""

    resnet_type: int = 101
    classes: Tuple[str, ...] = ("__background__", "hand")
    #: freeze BatchNorm in the backbone/tail (resnet.py:261-284 — correct
    #: when fine-tuning from ImageNet stats, the reference's only mode).
    #: MUST be False when training from scratch: identity-BN lets residual
    #: activations grow ~100x by layer3, which stalls RPN optimisation
    #: (measured in the detector convergence study, PERFORMANCE.md).
    freeze_bn: bool = True
    #: backbone/tail normalisation: "batch" (reference parity) or "group"
    #: (GroupNorm-32 — the from-scratch recipe; batch-size independent and
    #: train=eval consistent, see models/resnet.py:_Norm)
    norm: str = "batch"
    #: ResNet variant: "torchvision" (stride on the 3x3 bottleneck conv) or
    #: "caffe" — the reference detector's blocks put the stride on the first
    #: 1x1 conv and use a ceil-mode stem pool (faster_rcnn/resnet.py:67-80,
    #: 115); its shipped faster_rcnn_*.pth weights require "caffe".
    resnet_style: str = "torchvision"
    #: compute dtype of the conv stacks (params stay float32; the proposal
    #: decode, NMS and score softmax always run float32). "float32" is
    #: reference parity
    compute_dtype: str = "float32"
    anchor_scales: Tuple[int, ...] = (4, 8, 16, 32)   # hand_detector.py:120
    anchor_ratios: Tuple[float, float, float] = (0.5, 1.0, 2.0)
    feat_stride: int = 16
    #: test-time image pyramid (config_rcnn.py:168-171)
    test_scale: int = 600
    test_max_size: int = 1000
    #: RPN proposal filtering (config_rcnn.py / proposal_layer.py:77-160)
    rpn_pre_nms_top_n_train: int = 12000
    rpn_post_nms_top_n_train: int = 2000
    rpn_pre_nms_top_n_test: int = 6000
    rpn_post_nms_top_n_test: int = 300
    rpn_nms_thresh: float = 0.7
    rpn_min_size: int = 8
    #: detection head filtering (hand_detector.py:228-246)
    det_score_thresh: float = 0.001
    det_nms_thresh: float = 0.3
    max_detections: int = 100
    #: ROIAlign (faster_rcnn.py:40-41)
    pooling_size: int = 7
    spatial_scale: float = 1.0 / 16.0
    sampling_ratio: int = 2
    #: bbox regression normalisation (config_rcnn.py:76-119)
    bbox_normalize_means: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    bbox_normalize_stds: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)
    #: BGR pixel means subtracted from the blob (blob.py:20-49)
    pixel_means: Tuple[float, float, float] = (102.9801, 115.9465, 122.7717)
    #: RPN training targets (anchor_target_layer.py:48-194)
    rpn_batch_size: int = 256
    rpn_fg_fraction: float = 0.5
    rpn_positive_overlap: float = 0.7
    rpn_negative_overlap: float = 0.3
    #: proposal-target sampling (proposal_target_layer_cascade.py:33-57)
    roi_batch_size: int = 128
    roi_fg_fraction: float = 0.25
    roi_fg_thresh: float = 0.5
    roi_bg_thresh_hi: float = 0.5
    roi_bg_thresh_lo: float = 0.1

    def serving(self, proposals: int = 64,
                dtype: str | None = None) -> "DetectorConfig":
        """The single-hand serving setting: post-NMS top-`proposals`
        instead of the reference's 300, and optionally another conv-stack
        dtype (None keeps float32)."""
        return dataclasses.replace(
            self, rpn_post_nms_top_n_test=proposals,
            **({"compute_dtype": dtype} if dtype is not None else {}))

    @classmethod
    def native(cls, size: int = 224, resnet_type: int = 18,
               max_size: int | None = None) -> "DetectorConfig":
        """Native-resolution recipe: detect at the input's own resolution
        instead of the reference's short-side-600 blob upscale, with a
        GroupNorm backbone trainable from scratch, stride-16 anchors sized
        for 56-150 px hands and top-64 post-NMS proposals."""
        hi = max(size, max_size if max_size is not None else size)
        return cls(
            resnet_type=resnet_type,
            freeze_bn=False, norm="group",
            anchor_scales=(2, 4, 8, 12),
            test_scale=size, test_max_size=hi,
            rpn_pre_nms_top_n_train=2000, rpn_post_nms_top_n_train=256,
            rpn_pre_nms_top_n_test=1000, rpn_post_nms_top_n_test=64,
            roi_batch_size=64, max_detections=8, rpn_min_size=4,
            roi_bg_thresh_lo=0.0)


@dataclasses.dataclass(frozen=True)
class PANetConfig:
    """PANet NRSfM autoencoder (reference: procrustes_encoding/config_panet.py,
    PANet_reconstruction.py:30)."""

    pts_num: int = 21
    dict_sizes: Tuple[int, ...] = (512, 256, 128, 64, 32, 16, 8)
    encode_with_relu: bool = True
    batch_size: int = 500
    lr: float = 1e-3
    sparsity_weight: float = 1e-4


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout: a `data` axis (the reference's data parallelism,
    common/nets/balanced_parallel.py) and a `model` axis for sharding the
    wide final heatmap projection (1176 output channels)."""

    data_axis: str = "data"
    model_axis: str = "model"
    #: number of devices along the model axis (1 = pure DP)
    model_parallelism: int = 1


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    augment: AugmentConfig = dataclasses.field(default_factory=AugmentConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    detector: DetectorConfig = dataclasses.field(default_factory=DetectorConfig)
    panet: PANetConfig = dataclasses.field(default_factory=PANetConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)

    def with_training_size(self, n: int) -> "Config":
        """Shrink the split sizes for partial downloads / mini fixtures.

        The SINGLE implementation of the --training-size override: the
        CLIs that must agree on record ordering (train,
        generate_teacher_labels, train_detector) all route through here —
        filtered-db row alignment depends on identical sizing.
        """
        return self.replace(train=dataclasses.replace(
            self.train, training_size=n,
            labelled_data_range=min(n, self.train.labelled_data_range)))


def default_config() -> Config:
    return Config()
