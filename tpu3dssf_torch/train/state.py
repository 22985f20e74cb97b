"""Train state, optimizer and LR-schedule factory, in PyTorch.

Port of ``tpu3dssf.train.state``, which builds an optax chain:
clip_by_global_norm → AdamW | Adam (L2 into the gradient) | SGD (momentum,
nesterov), with an optax schedule, ``apply_if_finite`` (``skip_nonfinite``)
and a finite-value ``reduce_on_plateau``. The port keeps optax's semantics
where torch's stock pieces differ:

* schedules are optax's closed forms in a ``LambdaLR``, stepped once per
  applied update, so update ``k`` (from 0) uses the schedule at ``k``, as
  optax's count does; a skipped update does not advance it;
* the global-norm clip is optax's ``g · max_norm / norm`` when
  ``norm ≥ max_norm`` (``clip_grad_norm_`` adds 1e-6 to the norm);
* ``skip_nonfinite`` skips up to 100 consecutive updates whose gradients
  hold a NaN or Inf (``optax.apply_if_finite``);
* the plateau is ``optax.contrib.reduce_on_plateau`` (factor 0.1, patience
  10, rtol 1e-4, accumulation over one epoch of per-batch losses) made
  blind to non-finite values, written out here: torch's
  ``ReduceLROnPlateau`` decides per call and compares otherwise. Its scale
  multiplies the update, i.e. the learning rate of that update.

AdamW, Adam and SGD themselves are ``torch.optim``'s, which compute
optax's updates in exact arithmetic. Adam's β1, β2 are passed as their f32
values, which is what optax computes with (0.999 is 0.99900001 in f32, so
1 − β2 differs by 1.3e-5 relative); on the CPU, optax's f32 bias
corrections still differ from torch's float64 ones by up to ~7e-6 relative
over the first steps.

On a CUDA device AdamW and Adam run ``capturable=True`` with the learning
rate as a 0-d f32 tensor on the card, so that a CUDA graph of the train
step (:mod:`tpu3dssf_torch.train.graph`) reads the rate the schedule
``fill_``s between replays instead of one baked in at capture; the eager
step on the card takes the same construction, so both run the same
arithmetic. Their bias corrections are then f32 on the device, as optax's.

An update has a device half, :meth:`Optimizer.update` (what a graph
captures), and a host half, :meth:`Optimizer.advance` (the schedule's
count, which runs after every replay); :meth:`Optimizer.step` is both.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from tpu3dssf_torch.train.graph import drop_graphs

MAX_CONSECUTIVE_NONFINITE = 100
# optax.adam's defaults, as the f32 values optax computes with
ADAM_BETAS = (float(np.float32(0.9)), float(np.float32(0.999)))


def _cosine(count, decay_steps):
    """optax.cosine_decay_schedule's multiplier (alpha 0, exponent 1)."""
    count = min(count, decay_steps)
    return 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))


def create_schedule(name: str, steps_per_epoch: int, num_epochs: int,
                    step_size: int = 10, gamma: float = 0.1, t0: int = 10,
                    t_mult: int = 2):
    """optax's schedule for the reference's ``lr_scheduler`` names, as the
    multiplier of the base learning rate at update count ``c`` (what a
    ``LambdaLR`` takes). ReduceLROnPlateau is constant here: its scale is
    applied by :class:`Optimizer`."""
    total = max(1, steps_per_epoch * num_epochs)
    if name in ("none", None, "", "ReduceLROnPlateau"):
        return lambda c: 1.0
    if name == "StepLR":
        # optax.exponential_decay(staircase=True)
        period = step_size * steps_per_epoch
        if period <= 0:
            return lambda c: 1.0
        return lambda c: gamma ** (c // period)
    if name == "CosineAnnealingLR":
        return lambda c: _cosine(c, total)
    if name == "CosineAnnealingWarmRestarts":
        # optax.sgdr_schedule over 4 cosine periods of t0·t_mult^i epochs
        periods = [t0 * steps_per_epoch * t_mult ** i for i in range(4)]

        def sgdr(c):
            start = 0
            for i, p in enumerate(periods):
                if c < start + p or i == len(periods) - 1:
                    return _cosine(c - start, p)
                start += p
        return sgdr
    raise ValueError(f"unknown lr_scheduler: {name}")


class Plateau:
    """``optax.contrib.reduce_on_plateau`` (cooldown 0, min_scale 0) that
    ignores non-finite values, as ``_finite_value_plateau`` does: a NaN/Inf
    batch leaves the state untouched, so an epoch's decision sees exactly
    its finite batches. Arithmetic in float32, as optax's state."""

    def __init__(self, factor=0.1, patience=10, rtol=1e-4, atol=0.0,
                 accumulation_size=1):
        self.factor, self.patience = factor, patience
        self.rtol, self.atol = rtol, atol
        self.accumulation_size = accumulation_size
        self.scale = np.float32(1.0)
        self.best_value = np.float32(np.inf)
        self.plateau_count = 0
        self.count = 0
        self.avg_value = np.float32(0.0)

    def update(self, value) -> float:
        """Fold one per-batch value in; returns the scale of this update."""
        value = np.float32(value)
        if not np.isfinite(value):
            return float(self.scale)
        new_count = self.count + 1
        self.avg_value = ((np.float32(self.count) * self.avg_value + value)
                          / np.float32(new_count))
        self.count = new_count
        if new_count == self.accumulation_size:
            improved = self.avg_value < (
                (np.float32(1.0) - np.float32(self.rtol)) * self.best_value
                - np.float32(self.atol))
            if improved:
                self.best_value = self.avg_value
            count = 0 if improved else self.plateau_count + 1
            if count == self.patience:
                self.scale = np.float32(self.scale * np.float32(self.factor))
                count = 0
            self.plateau_count = count
            self.count, self.avg_value = 0, np.float32(0.0)
        return float(self.scale)

    def state_dict(self):
        return {k: (float(v) if isinstance(v, np.floating) else v)
                for k, v in vars(self).items()}

    def load_state_dict(self, state):
        for k, v in state.items():
            cur = getattr(self, k)
            setattr(self, k, np.float32(v) if isinstance(cur, np.floating)
                    else v)


class Optimizer:
    """The port of the optax chain that ``create_optimizer`` returns.

    ``step(value)`` applies one update from the parameters' ``.grad``:
    the plateau (if any) folds in ``value``, non-finite gradients are
    skipped (if ``skip_nonfinite``), the global norm is clipped (if
    ``grad_clip``), then the torch optimizer steps at the scheduled
    learning rate times the plateau scale, and the schedule advances.
    """

    def __init__(self, inner, schedule, grad_clip=None, skip_nonfinite=False,
                 plateau: Optional[Plateau] = None):
        self.inner = inner
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(inner, schedule)
        self.grad_clip = grad_clip
        self.skip_nonfinite = skip_nonfinite
        self.plateau = plateau
        self.notfinite_count = 0
        self.skipped = False   # the last update was skipped (non-finite)

    @property
    def params(self):
        return [p for g in self.inner.param_groups for p in g["params"]]

    def zero_grad(self):
        self.inner.zero_grad(set_to_none=True)

    def _grads(self):
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in self.params]

    def step(self, value=None):
        """One update: :meth:`update`, then :meth:`advance`."""
        self.update(value)
        self.advance()

    @torch.no_grad()
    def update(self, value=None):
        """The device half of an update: the plateau folds in ``value``,
        non-finite gradients are skipped, the norm is clipped and the
        torch optimizer steps. With neither plateau nor ``skip_nonfinite``
        it makes no host decision and no host copy, so a CUDA graph can
        capture it."""
        scale = 1.0
        if self.plateau is not None:
            if value is None:
                raise ValueError("ReduceLROnPlateau needs the batch loss "
                                 "(step(value=...))")
            scale = self.plateau.update(float(value))
        grads = self._grads()
        self.skipped = False
        if self.skip_nonfinite:
            finite = bool(torch.stack([torch.isfinite(g).all()
                                       for g in grads]).all())
            self.notfinite_count = 0 if finite else self.notfinite_count + 1
            if (not finite and self.notfinite_count
                    <= MAX_CONSECUTIVE_NONFINITE):
                self.skipped = True
                return  # optax.apply_if_finite: a zero update
        if self.grad_clip:
            norm = torch.stack([g.float().square().sum()
                                for g in grads]).sum().sqrt()
            factor = torch.where(norm < self.grad_clip, 1.0,
                                 self.grad_clip / norm)
            torch._foreach_mul_(grads, factor)
        for p, g in zip(self.params, grads):
            p.grad = g
        lrs = [g["lr"] for g in self.inner.param_groups]
        if scale != 1.0:
            # a new value, never in place: a tensor rate stays the same
            for g in self.inner.param_groups:
                g["lr"] = g["lr"] * scale
        self.inner.step()
        for g, lr in zip(self.inner.param_groups, lrs):
            g["lr"] = lr

    def advance(self):
        """The host half: the schedule advances, unless the last update
        was skipped."""
        if not self.skipped:
            self.scheduler.step()

    def state_dict(self):
        return {"inner": self.inner.state_dict(),
                "scheduler": self.scheduler.state_dict(),
                "plateau": (None if self.plateau is None
                            else self.plateau.state_dict()),
                "notfinite_count": self.notfinite_count}

    def load_state_dict(self, state):
        lrs = [g["lr"] for g in self.inner.param_groups]
        self.inner.load_state_dict(state["inner"])
        for g, lr in zip(self.inner.param_groups, lrs):
            if isinstance(lr, torch.Tensor):   # keep the rate a tensor
                lr.fill_(float(g["lr"]))
                g["lr"] = lr
        self.scheduler.load_state_dict(state["scheduler"])
        if (state["plateau"] is None) != (self.plateau is None):
            raise ValueError("optimizer state: plateau mismatch")
        if self.plateau is not None:
            self.plateau.load_state_dict(state["plateau"])
        self.notfinite_count = state["notfinite_count"]


def create_optimizer(params, name: str, learning_rate: float,
                     weight_decay: float = 0.0, momentum: float = 0.9,
                     nesterov: bool = False, lr_scheduler: str = "none",
                     steps_per_epoch: int = 1, num_epochs: int = 1,
                     grad_clip: Optional[float] = None,
                     skip_nonfinite: bool = False) -> Optimizer:
    """The optimizer over ``params`` for the reference's names (port of
    ``tpu3dssf.train.state.create_optimizer``; same arguments plus the
    parameters, which optax takes at ``init``)."""
    schedule = create_schedule(lr_scheduler, steps_per_epoch, num_epochs)
    params = list(params)
    device = params[0].device if params else torch.device("cpu")
    # on the card: the rate a tensor there and the update capturable (the
    # module docstring says why)
    adam_kw = (dict(lr=torch.tensor(learning_rate, dtype=torch.float32,
                                    device=device), capturable=True)
               if device.type == "cuda" else dict(lr=learning_rate))
    if name == "AdamW":
        inner = torch.optim.AdamW(params, betas=ADAM_BETAS,
                                  weight_decay=weight_decay, **adam_kw)
    elif name == "Adam":
        # torch Adam applies weight_decay as L2 into the gradient, like
        # optax.chain(add_decayed_weights, adam)
        inner = torch.optim.Adam(params, betas=ADAM_BETAS,
                                 weight_decay=weight_decay, **adam_kw)
    elif name == "SGD":
        # optax's trace with decay 0 is plain SGD (torch refuses nesterov
        # without momentum)
        inner = torch.optim.SGD(params, lr=learning_rate, momentum=momentum,
                                nesterov=nesterov and momentum > 0)
    else:
        raise ValueError(f"unknown optimizer: {name}")
    if device.type == "cuda" and name != "SGD":
        # the schedule's base rate a float, so that it fills the tensor
        # rate without reading it back from the card
        for g in inner.param_groups:
            g["initial_lr"] = learning_rate
        # the eager step on the card runs capturable by design
        inner._warned_capturable_if_run_uncaptured = True
    plateau = (Plateau(accumulation_size=max(1, steps_per_epoch))
               if lr_scheduler == "ReduceLROnPlateau" else None)
    return Optimizer(inner, schedule, grad_clip=grad_clip,
                     skip_nonfinite=skip_nonfinite, plateau=plateau)


class TrainState:
    """Model + optimizer + update count (flax ``TrainState``'s role).

    ``step`` counts calls of :meth:`apply_gradients`, skipped updates
    included, as flax's ``step`` does.
    """

    def __init__(self, model: torch.nn.Module, optimizer: Optimizer,
                 step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.step = step

    def apply_gradients(self, value=None):
        self.optimizer.update(value)
        self.advance()

    def advance(self):
        """The host half of an update (:meth:`Optimizer.advance`) and the
        update count: what a graphed train step runs after each replay."""
        self.optimizer.advance()
        self.step += 1

    def state_dict(self):
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.step}

    def load_state_dict(self, state):
        """Restore in place. The optimizer's state tensors are replaced, so
        the CUDA graphs captured over this state are dropped."""
        drop_graphs(self)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
