"""Configuration, shared with the JAX package.

`hand_integral_pose_estimation_tpu.config` is pure frozen dataclasses with no
import-time side effects, and the JAX package's top-level `__init__` imports
nothing else, so the port re-exports it rather than keeping a copy that
could drift.
"""

from hand_integral_pose_estimation_tpu.config import (  # noqa: F401
    AugmentConfig,
    Config,
    FreiHandJoints,
    ModelConfig,
)
