"""Batched projective geometry for data prep and eval (port of
hand_integral_pose_estimation_tpu/geometry)."""

from hand_integral_pose_estimation_tpu_torch.geometry.camera import (  # noqa: F401
    cam2pixel,
    pixel2cam,
    project_points,
)
from hand_integral_pose_estimation_tpu_torch.geometry.transforms import (  # noqa: F401
    get_perspective_transform,
    patch_corner_points,
    rotation_homography,
    trans_from_patch,
    transform_points_2d,
)
from hand_integral_pose_estimation_tpu_torch.geometry.bbox import (  # noqa: F401
    bbox_from_detection,
    bbox_from_keypoints,
    kpt_bound,
    scale_bbox,
    tprime_from_bbox,
)
from hand_integral_pose_estimation_tpu_torch.geometry.procrustes import (  # noqa: F401
    SimilarityTransform,
    align_w_scale,
    compute_similarity_transform,
    procrustes_align,
)
from hand_integral_pose_estimation_tpu_torch.geometry.labels import (  # noqa: F401
    PatchLabels,
    compute_patch_labels,
    compute_patch_labels_from_normalized,
    decode_labels,
    encode_labels,
    patch_label_to_camera,
    patch_to_image_3d,
)
from hand_integral_pose_estimation_tpu_torch.geometry.rotation import (  # noqa: F401
    rodrigues,
    rotation_z,
    sample_color_scale,
    sample_rotation_matrix,
)
