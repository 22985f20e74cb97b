from tpu3dssf_torch.train.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from tpu3dssf_torch.train.loop import (
    MetricAccumulator,
    evaluate_model,
    make_eval_step,
    make_image_encode_fn,
    make_train_step,
    train_model,
)
from tpu3dssf_torch.train.state import (
    TrainState,
    create_optimizer,
    create_schedule,
)

__all__ = [
    "MetricAccumulator",
    "TrainState",
    "create_optimizer",
    "create_schedule",
    "evaluate_model",
    "latest_checkpoint",
    "make_eval_step",
    "make_image_encode_fn",
    "make_train_step",
    "restore_checkpoint",
    "save_checkpoint",
    "train_model",
]
