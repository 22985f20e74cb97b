"""The training loop, its state and checkpoints, and the CUDA-graph
wrapper of the steps (:mod:`tpu3dssf_torch.train.graph`).

The names below are imported when first asked for, so that importing
``tpu3dssf_torch.train.graph`` (which a loaded export artifact uses, see
:mod:`tpu3dssf_torch.export`) brings in no model code.
"""

import importlib

_NAMES = {
    "latest_checkpoint": "checkpoint",
    "restore_checkpoint": "checkpoint",
    "save_checkpoint": "checkpoint",
    "MetricAccumulator": "loop",
    "evaluate_model": "loop",
    "make_eval_step": "loop",
    "make_image_encode_fn": "loop",
    "make_train_step": "loop",
    "train_model": "loop",
    "TrainState": "state",
    "create_optimizer": "state",
    "create_schedule": "state",
}

__all__ = sorted(_NAMES)


def __getattr__(name):
    if name in _NAMES:
        module = importlib.import_module(
            f"tpu3dssf_torch.train.{_NAMES[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
