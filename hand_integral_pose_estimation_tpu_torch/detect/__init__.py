"""Faster R-CNN hand detector: box math, the proposal layer, the training
targets and losses, the model, the detection facade, the weights loader,
detector training data and the VGG16 backbone."""

from hand_integral_pose_estimation_tpu_torch.detect.box_ops import (  # noqa: F401
    clip_boxes,
    decode_boxes,
    encode_boxes,
    generate_base_anchors,
    grid_anchors,
)
from hand_integral_pose_estimation_tpu_torch.detect.config_compat import (  # noqa: F401
    apply_rcnn_overrides,
    cfg_from_file,
    cfg_from_list,
)
from hand_integral_pose_estimation_tpu_torch.detect.data import (  # noqa: F401
    aspect_ratio_batches,
    build_grouped_batches,
    crop_pad_to_ratio,
    rank_aspect_ratios,
)
from hand_integral_pose_estimation_tpu_torch.detect.faster_rcnn import (  # noqa: F401
    DetectionOutputs,
    FasterRCNN,
    SamplingPriorities,
)
from hand_integral_pose_estimation_tpu_torch.detect.hand_detector import (  # noqa: F401
    Detections,
    detect,
    detect_hand_crop_bbox,
    detect_split,
    prepare_blob,
)
from hand_integral_pose_estimation_tpu_torch.detect.load import (  # noqa: F401
    build_detector,
    default_resnet_style,
)
from hand_integral_pose_estimation_tpu_torch.detect.rpn import (  # noqa: F401
    AnchorTargets,
    Proposals,
    anchor_target_layer,
    proposal_layer,
    rpn_losses,
    smooth_l1,
)
from hand_integral_pose_estimation_tpu_torch.detect.synthetic import (  # noqa: F401
    SyntheticBoxes,
    flip_batch,
    make_synthetic_box_dataset,
)
from hand_integral_pose_estimation_tpu_torch.detect.targets import (  # noqa: F401
    ProposalTargets,
    detection_head_losses,
    proposal_target_layer,
)
from hand_integral_pose_estimation_tpu_torch.detect.vgg import (  # noqa: F401
    VGG16Base,
    VGG16Tail,
)
