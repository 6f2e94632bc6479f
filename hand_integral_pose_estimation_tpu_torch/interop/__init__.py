"""Weight bridges: JAX variables -> state_dict, and reference .pth loading."""

from hand_integral_pose_estimation_tpu_torch.interop.jax_params import (  # noqa: F401
    detector_state_dict_from_jax,
    panet_state_dict_from_jax,
    pose_state_dict_from_jax,
)
from hand_integral_pose_estimation_tpu_torch.interop.snapshot import (  # noqa: F401
    load_pose_snapshot,
    load_state_dict_file,
)
