"""Metric logging + stdout tee.

The port's own copy of ``tpu3dssf/utils/logging.py``
(host code: the port imports nothing of the JAX package).

Rebuilds the reference's observability surface: wandb per-step/per-epoch
logging (utils/train.py:17-24,110-116,139-148 — entity/project hardcoded
upstream, configurable here) and the ``Logger`` stdout tee
(utils/logger.py:4-17, wired-but-disabled upstream — enabled here via
``tee_stdout``). wandb is optional: absent (this image has no network
egress anyway), logging degrades to JSONL on disk.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional


class MetricLogger:
    def log(self, metrics: Dict) -> None:
        raise NotImplementedError

    def finish(self) -> None:
        pass


class NullLogger(MetricLogger):
    def log(self, metrics: Dict) -> None:
        pass


class JsonlLogger(MetricLogger):
    """Append-only JSONL metric log (offline-safe wandb substitute)."""

    def __init__(self, directory: str, filename: str = "metrics.jsonl"):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, filename)
        self._f = open(self.path, "a")

    def log(self, metrics: Dict) -> None:
        rec = {"_time": time.time()}
        rec.update({k: float(v) if hasattr(v, "__float__") else v
                    for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def finish(self) -> None:
        self._f.close()


class WandbLogger(MetricLogger):
    def __init__(self, entity: Optional[str], project: str, config=None):
        import wandb  # optional dependency
        self._run = wandb.init(entity=entity, project=project,
                               config=config)
        self._wandb = wandb

    def log(self, metrics: Dict) -> None:
        self._wandb.log(metrics)

    def finish(self) -> None:
        self._run.finish()


def create_logger(checkpoint_dir: str, config=None,
                  wandb_project: Optional[str] = None,
                  wandb_entity: Optional[str] = None) -> MetricLogger:
    if wandb_project:
        try:
            return WandbLogger(wandb_entity, wandb_project, config)
        except Exception as e:  # no wandb / no network → JSONL fallback
            print(f"[logging] wandb unavailable ({e}); using JSONL")
    return JsonlLogger(checkpoint_dir)


class Tee:
    """stdout/stderr tee to a log file (reference utils/logger.py:4-17)."""

    def __init__(self, directory: str, filename: str):
        os.makedirs(directory, exist_ok=True)
        self.terminal = sys.stdout
        self.file = open(os.path.join(directory, filename), "a")

    def write(self, message):
        self.terminal.write(message)
        self.file.write(message)

    def flush(self):
        self.terminal.flush()
        self.file.flush()


def tee_stdout(directory: str, filename: str = "train.log"):
    tee = Tee(directory, filename)
    sys.stdout = tee
    sys.stderr = tee
    return tee
