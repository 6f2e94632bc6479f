"""Training runtime: optimiser and schedule, the train and eval steps,
checkpointing, CUDA-graph replay, and the Trainer / Tester / Evaluator
runners."""

from hand_integral_pose_estimation_tpu_torch.training.state import (  # noqa: F401
    compare_state_dicts,
    make_optimizer,
    multistep_schedule,
)
from hand_integral_pose_estimation_tpu_torch.training.train_step import (  # noqa: F401
    make_eval_fn,
    make_eval_step,
    make_train_step,
)
from hand_integral_pose_estimation_tpu_torch.training.checkpoint import (  # noqa: F401
    latest_epoch,
    load_checkpoint,
    save_checkpoint,
)
from hand_integral_pose_estimation_tpu_torch.training.trainer import (  # noqa: F401
    Evaluator,
    Tester,
    Trainer,
)
