"""Faster R-CNN hand detector (serving): box math, the proposal layer, the
model, the detection facade and the weights loader."""

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
from hand_integral_pose_estimation_tpu_torch.detect.faster_rcnn import (  # noqa: F401
    DetectionOutputs,
    FasterRCNN,
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
    Proposals,
    proposal_layer,
)
from hand_integral_pose_estimation_tpu_torch.detect.synthetic import (  # noqa: F401
    SyntheticBoxes,
    make_synthetic_box_dataset,
)
