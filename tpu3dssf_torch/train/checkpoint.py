"""Checkpoints of the full train state, with ``torch.save``.

Port of ``tpu3dssf.train.checkpoint`` (Orbax there; its format is not
reproduced): model, optimizer and schedule state, the update count and a
small ``extra`` dict (``best_acc``, ``epoch``) go to
``<directory>/<step>/state.pt``; the latest 3 steps are kept. Restoring
raises ``FileNotFoundError`` when the directory holds no checkpoint or one
that does not fit the given state, as the JAX version does.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

import torch

_EXTRA_DEFAULTS: Dict[str, Any] = {"best_acc": 0.0, "epoch": 0}
_FILE = "state.pt"


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory)
                  if d.isdigit()
                  and os.path.isfile(os.path.join(directory, d, _FILE)))


def save_checkpoint(directory: str, step: int, state,
                    extra: Optional[Dict[str, Any]] = None,
                    max_to_keep: int = 3):
    """Save ``state`` (a :class:`~tpu3dssf_torch.train.state.TrainState`)
    and ``extra`` as step ``step`` under ``directory``."""
    path = os.path.join(os.path.abspath(directory), str(int(step)))
    os.makedirs(path, exist_ok=True)
    payload = {"state": state.state_dict(),
               "extra": {**_EXTRA_DEFAULTS, **(extra or {})}}
    tmp = os.path.join(path, f".{_FILE}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, _FILE))  # a reader never sees half
    for old in _steps(directory)[:-max_to_keep]:
        shutil.rmtree(os.path.join(directory, str(old)))


def latest_checkpoint(directory: str) -> Optional[int]:
    steps = _steps(os.path.abspath(directory))
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, step: Optional[int], state):
    """Load step ``step`` (the latest when None) into ``state`` in place.

    Returns ``(state, extra, step)``. Raises ``FileNotFoundError`` when
    there is no checkpoint, or when it does not match ``state`` (e.g. one
    from another model configuration).
    """
    directory = os.path.abspath(directory)
    if step is None:
        step = latest_checkpoint(directory)
    path = os.path.join(directory, str(step), _FILE)
    if step is None or not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint found in {directory}")
    device = next(state.model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=False)
    try:
        # check the model's tree first: load_state_dict copies what matches
        # before it reports what does not
        want = {k: tuple(v.shape) for k, v in state.model.state_dict().items()}
        got = {k: tuple(v.shape) for k, v in payload["state"]["model"].items()}
        if want != got:
            raise ValueError(f"model parameters differ: "
                             f"{sorted(set(want.items()) ^ set(got.items()))[:4]}")
        state.load_state_dict(payload["state"])
    except (KeyError, RuntimeError, ValueError) as e:
        raise FileNotFoundError(
            f"checkpoint at {directory} step {step} does not match the "
            f"current model structure: {e}") from e
    return state, {**_EXTRA_DEFAULTS, **payload.get("extra", {})}, step
