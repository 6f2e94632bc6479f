"""On-device preprocessing (eval and training) and host-side dataset
plumbing."""

from hand_integral_pose_estimation_tpu_torch.data.freihand import (  # noqa: F401
    FreiHandDataset,
    SampleRecord,
    SyntheticFreiHand,
    apply_filtered_labels,
    batch_iterator,
    padded_batches,
    stack_host_batch,
    version_map_id,
)
from hand_integral_pose_estimation_tpu_torch.data.pipeline import (  # noqa: F401
    Batch,
    make_eval_batch,
    make_train_batch,
    make_train_batch_with,
)
