"""Faults planted in the program underneath a run, to show that ``correct``
falls for each fault a cell can have: a train step that leaves its state
unchanged, half of the batch left out (the mean taken over the rest), an
answer altered where it is produced (the first sample's class scores
shifted by one class). Used by the tests and by ``calibrate.py``'s
fault readings; never by a measuring run."""

from __future__ import annotations

import contextlib
from unittest import mock

FAULTS = ("unchanged", "half", "alter")


def _rolled(forward):
    def broken(self, *args, **kw):
        out = forward(self, *args, **kw).clone()
        out[0] = out[0].roll(1, dims=-1)
        return out
    return broken


def _train_update(change):
    import tpu3dssf_torch.train.loop as loop
    make = loop.make_train_step

    def made(*args, **kw):
        step = make(*args, **kw)
        update = step.update

        def broken(state, batch, tokens, keep=None):
            return change(update, state, batch, tokens, keep)
        step.update = broken
        return step
    return mock.patch.object(loop, "make_train_step", made)


def _frozen(update, state, batch, tokens, keep):
    step = state.optimizer.step
    state.optimizer.step = lambda value=None: None
    try:
        return update(state, batch, tokens, keep)
    finally:
        state.optimizer.step = step


def _halved_update(update, state, batch, tokens, keep):
    n = batch["points"].shape[0] // 2
    return update(state, {k: v[:n] for k, v in batch.items()}, tokens[:n],
                  keep)


def _halved_eval():
    import tpu3dssf_torch.train.loop as loop
    make = loop.make_eval_step

    def made(loss_fn, num_classes, mesh=None):
        step = make(loss_fn, num_classes, mesh)

        def eval_step(model, batch, tokens):
            n = batch["points"].shape[0] // 2
            return step(model, {k: v[:n] for k, v in batch.items()},
                        tokens[:n])
        return eval_step
    return mock.patch.object(loop, "make_eval_step", made)


@contextlib.contextmanager
def plant(fault: str, loop: str):
    """Plant ``fault`` in the program for a cell of ``loop`` while the
    context is open."""
    from tpu3dssf_torch.models.fusion import SegmentationPipeline
    from tpu3dssf_torch.models.lidar_only import LidarSegmentationModel
    if fault == "unchanged" and loop == "train":
        patch = _train_update(_frozen)
    elif fault == "half" and loop == "train":
        patch = _train_update(_halved_update)
    elif fault == "half" and loop == "eval":
        patch = _halved_eval()
    elif fault == "alter":
        patch = contextlib.ExitStack()
        for cls in (SegmentationPipeline, LidarSegmentationModel):
            patch.enter_context(mock.patch.object(cls, "forward",
                                                  _rolled(cls.forward)))
    else:
        raise ValueError(f"a {loop} cell cannot have the fault {fault!r}")
    with patch:
        yield
