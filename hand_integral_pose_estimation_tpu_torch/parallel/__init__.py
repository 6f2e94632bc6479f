"""The device mesh over torch.distributed: layout, collectives and the
kernels' calls under it (port of hand_integral_pose_estimation_tpu/
parallel)."""

from hand_integral_pose_estimation_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    free_port,
    init_distributed,
    is_writer,
    make_mesh,
    make_multihost_mesh,
    param_sharding_rules,
    place_state,
    process_batch_size,
    shard_host_batch,
    spawn_ranks,
    split_params,
    world_size,
)
from hand_integral_pose_estimation_tpu_torch.parallel.collectives import (  # noqa: F401
    SyncBatchNorm,
    all_reduce_gradients,
    convert_sync_batchnorm,
    copy_to_model,
    gather_data,
    gather_model,
    over_data,
)
from hand_integral_pose_estimation_tpu_torch.parallel.shard_ops import (  # noqa: F401
    head_model_split,
    sharded_head_projection_integral,
    sharded_softmax_integral,
    sharded_warp_perspective_batch,
)
