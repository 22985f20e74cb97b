"""Train state, optimizer and LR-schedule factory, in PyTorch.

Port of ``tpu3dssf.train.state``, which builds an optax chain:
clip_by_global_norm → AdamW | Adam (L2 into the gradient) | SGD (momentum,
nesterov), with an optax schedule, ``apply_if_finite`` (``skip_nonfinite``)
and a finite-value ``reduce_on_plateau``. JAX compiles that chain into the
train step, its state and every decision on the device; the port keeps
them on the device too, as tensors, so that an update reads nothing on
the host and a CUDA graph (:mod:`tpu3dssf_torch.train.graph`) can replay
it under every configuration:

* the schedule is a table: entry ``c`` is the f32 rate of an update at
  count ``c``, ``base × create_schedule(...)(c)`` computed on the host
  once, for every count a run reaches (counts past the table read its last
  entry). An int32 count of *applied* updates on the device indexes it, so
  update ``k`` (from 0) uses the schedule at ``k``, as optax's count does;
  a skipped update does not advance it;
* the plateau is ``optax.contrib.reduce_on_plateau`` (factor 0.1, patience
  10, rtol 1e-4, accumulation over one epoch of per-batch losses) made
  blind to non-finite values, as ``_finite_value_plateau``:
  :class:`DevicePlateau` folds each value with ``torch.where`` into f32 and
  int32 tensors, and its scale multiplies the rate of the update;
* ``skip_nonfinite`` is ``optax.apply_if_finite(max_consecutive_errors=
  100)``: an update whose gradients hold a NaN or Inf is skipped unless it
  is past the 100th in a row. The check and the consecutive count run on
  the device; the decision reaches the fused optimizer as its
  ``found_inf``, which leaves the parameters, the moments and Adam's step
  unchanged where it is 1 (the step's increment is undone), as
  ``apply_if_finite`` keeps the inner state;
* the global-norm clip is optax's ``g · max_norm / norm`` when
  ``norm ≥ max_norm`` (``clip_grad_norm_`` adds 1e-6 to the norm).

AdamW, Adam and SGD are ``torch.optim``'s fused updates (one multi-tensor
kernel a step on the card) with the rate a 0-d f32 tensor on the
parameters' device, which every update writes before it steps. Adam's β1,
β2 are passed as their f32 values, which is what optax computes with
(0.999 is 0.99900001 in f32, so 1 − β2 differs by 1.3e-5 relative); the
fused kernels compute the bias corrections in f32, as optax does. SGD's
momentum buffers start at zero, which is optax's first trace
(``t = g + μ·0``), so torch's first-step branch never runs.
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


def _sgdr_periods(steps_per_epoch, t0=10, t_mult=2):
    """optax.sgdr_schedule's 4 cosine periods of t0·t_mult^i epochs."""
    return [t0 * steps_per_epoch * t_mult ** i for i in range(4)]


def create_schedule(name: str, steps_per_epoch: int, num_epochs: int,
                    step_size: int = 10, gamma: float = 0.1, t0: int = 10,
                    t_mult: int = 2):
    """optax's schedule for the reference's ``lr_scheduler`` names, as the
    multiplier of the base learning rate at update count ``c``.
    ReduceLROnPlateau is constant here: its scale is applied by
    :class:`Optimizer`."""
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
        periods = _sgdr_periods(steps_per_epoch, t0, t_mult)

        def sgdr(c):
            start = 0
            for i, p in enumerate(periods):
                if c < start + p or i == len(periods) - 1:
                    return _cosine(c - start, p)
                start += p
        return sgdr
    raise ValueError(f"unknown lr_scheduler: {name}")


def schedule_table(name: str, learning_rate: float, steps_per_epoch: int,
                   num_epochs: int, device="cpu") -> torch.Tensor:
    """The f32 rate of every update count a run reaches: entry ``c`` is
    ``learning_rate × create_schedule(...)(c)`` rounded to f32 (what a
    ``LambdaLR`` fills into a tensor rate). It covers the run's
    ``steps_per_epoch × num_epochs`` updates and, for the warm restarts,
    all four periods; every schedule is constant past its last entry but
    StepLR, whose later counts a run never reaches."""
    schedule = create_schedule(name, steps_per_epoch, num_epochs)
    n = max(1, steps_per_epoch * num_epochs)
    if name == "CosineAnnealingWarmRestarts":
        n = max(n, sum(_sgdr_periods(steps_per_epoch)))
    return torch.tensor([learning_rate * schedule(c) for c in range(n + 1)],
                        dtype=torch.float32, device=device)


class DevicePlateau:
    """``optax.contrib.reduce_on_plateau`` (cooldown 0, min_scale 0) that
    ignores non-finite values, as ``_finite_value_plateau`` does, kept in
    device tensors: ``scale``, ``best_value`` and ``avg_value`` f32,
    ``plateau_count`` and ``count`` int32. A NaN/Inf value leaves the state
    untouched and the update takes the current scale, so an epoch's
    decision sees exactly its finite values. Every fold is ``torch.where``
    over f32 arithmetic in optax's order: no value is read on the host."""

    NAMES = ("scale", "best_value", "plateau_count", "count", "avg_value")

    def __init__(self, factor=0.1, patience=10, rtol=1e-4, atol=0.0,
                 accumulation_size=1, device="cpu"):
        self.patience = patience
        self.accumulation_size = accumulation_size
        # the f32 constants optax multiplies with, as exact Python floats
        self.factor = float(np.float32(factor))
        self.keep = float(np.float32(1.0) - np.float32(rtol))
        self.atol = float(np.float32(atol))

        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        def i32(v):
            return torch.tensor(v, dtype=torch.int32, device=device)

        self.scale, self.best_value = f32(1.0), f32(float("inf"))
        self.plateau_count, self.count = i32(0), i32(0)
        self.avg_value = f32(0.0)

    def tensors(self):
        return {k: getattr(self, k) for k in self.NAMES}

    def update(self, value: torch.Tensor) -> torch.Tensor:
        """Fold one per-batch value (a 0-d tensor on the state's device)
        in place; returns the scale of this update (the state's tensor)."""
        v = value.detach().to(torch.float32)
        finite = torch.isfinite(v)
        new_count = self.count + 1
        avg = (self.count.to(torch.float32) * self.avg_value + v) \
            / new_count.to(torch.float32)
        decide = new_count == self.accumulation_size
        improved = avg < self.best_value * self.keep - self.atol
        plateau = torch.where(improved, 0, self.plateau_count + 1)
        hit = plateau == self.patience
        fold = {
            "best_value": torch.where(improved, avg, self.best_value),
            "plateau_count": torch.where(hit, 0, plateau),
            "scale": torch.where(hit, self.scale * self.factor, self.scale),
            "count": torch.zeros_like(new_count),
            "avg_value": torch.zeros_like(avg)}
        kept = {"best_value": self.best_value,
                "plateau_count": self.plateau_count, "scale": self.scale,
                "count": new_count, "avg_value": avg}
        new = {k: torch.where(finite & decide, fold[k],
                              torch.where(finite, kept[k], getattr(self, k)))
               for k in self.NAMES}
        for k, x in new.items():
            getattr(self, k).copy_(x)
        return self.scale

    def state_dict(self):
        return {k: x.detach().clone() for k, x in self.tensors().items()}

    def load_state_dict(self, state):
        for k, x in self.tensors().items():
            x.copy_(torch.as_tensor(state[k]))


class Optimizer:
    """The port of the optax chain that ``create_optimizer`` returns.

    ``step(value)`` applies one update from the parameters' ``.grad``: the
    plateau (if any) folds in ``value``, non-finite gradients are marked
    for a skip (if ``skip_nonfinite``), the global norm is clipped (if
    ``grad_clip``), then the fused torch optimizer steps at
    ``table[count] × scale``, and the count advances where the update
    applied. Every piece of it is a device operation (the module
    docstring); the rate of the last update is the group's ``lr``.
    """

    def __init__(self, inner, table, grad_clip=None, skip_nonfinite=False,
                 plateau: Optional[DevicePlateau] = None):
        self.inner = inner
        self.table = table
        self.grad_clip = grad_clip
        self.skip_nonfinite = skip_nonfinite
        self.plateau = plateau
        device = table.device
        self.lr = inner.param_groups[0]["lr"]
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        self.notfinite_count = torch.zeros((), dtype=torch.int32,
                                           device=device)
        # 1.0 where the last update was skipped: the fused step's found_inf
        self.skipped = torch.zeros((), dtype=torch.float32, device=device)
        self._found = torch.zeros((), dtype=torch.float32, device=device)
        self._one = torch.ones((), dtype=torch.float32, device=device)
        if skip_nonfinite:
            inner.found_inf = self.skipped

    @property
    def params(self):
        return [p for g in self.inner.param_groups for p in g["params"]]

    def zero_grad(self):
        self.inner.zero_grad(set_to_none=True)

    def _grads(self):
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in self.params]

    def rate(self) -> torch.Tensor:
        """The rate the next update takes before its plateau fold:
        ``table[count] × scale``, on the device."""
        lr = torch.take(self.table,
                        self.count.clamp(max=self.table.numel() - 1).long())
        return lr if self.plateau is None else lr * self.plateau.scale

    @torch.no_grad()
    def step(self, value=None):
        """One update (see the class docstring). Makes no host decision
        and no host copy, so a CUDA graph can capture it."""
        if self.plateau is not None:
            if value is None:
                raise ValueError("ReduceLROnPlateau needs the batch loss "
                                 "(step(value=...))")
            self.plateau.update(value)
        grads = self._grads()
        if self.skip_nonfinite:
            # found := any non-finite gradient (each multiplied by 1.0,
            # which keeps its bits)
            self._found.zero_()
            torch._amp_foreach_non_finite_check_and_unscale_(
                grads, self._found, self._one)
            finite = self._found == 0
            self.notfinite_count.copy_(torch.where(
                finite, 0, self.notfinite_count + 1))
            self.skipped.copy_(~finite & (self.notfinite_count
                                          <= MAX_CONSECUTIVE_NONFINITE))
        if self.grad_clip:
            norm = torch.stack([g.float().square().sum()
                                for g in grads]).sum().sqrt()
            factor = torch.where(norm < self.grad_clip, 1.0,
                                 self.grad_clip / norm)
            torch._foreach_mul_(grads, factor)
        for p, g in zip(self.params, grads):
            p.grad = g
        self.lr.copy_(self.rate())
        self.inner.step()
        self.count.add_(1 - self.skipped.to(torch.int32))

    def device_state(self):
        """Every tensor of the chain's own state besides the torch
        optimizer's: the rate, the counts and the plateau."""
        out = {"lr": self.lr, "count": self.count,
               "notfinite_count": self.notfinite_count,
               "skipped": self.skipped}
        if self.plateau is not None:
            out.update({f"plateau.{k}": x
                        for k, x in self.plateau.tensors().items()})
        return out

    def state_dict(self):
        return {"inner": self.inner.state_dict(),
                "count": self.count.detach().clone(),
                "notfinite_count": self.notfinite_count.detach().clone(),
                "skipped": self.skipped.detach().clone(),
                "plateau": (None if self.plateau is None
                            else self.plateau.state_dict())}

    def load_state_dict(self, state):
        missing = [k for k in ("inner", "count", "notfinite_count",
                               "skipped", "plateau") if k not in state]
        if missing:   # before anything loads: e.g. a LambdaLR-era state
            raise KeyError(f"optimizer state lacks {missing}")
        self.inner.load_state_dict(state["inner"])
        for g in self.inner.param_groups:   # the rate stays this tensor
            g["lr"] = self.lr
        if (state["plateau"] is None) != (self.plateau is None):
            raise ValueError("optimizer state: plateau mismatch")
        if self.plateau is not None:
            self.plateau.load_state_dict(state["plateau"])
        for k in ("count", "notfinite_count", "skipped"):
            getattr(self, k).copy_(torch.as_tensor(state[k]))
        self.lr.copy_(self.rate())


def create_optimizer(params, name: str, learning_rate: float,
                     weight_decay: float = 0.0, momentum: float = 0.9,
                     nesterov: bool = False, lr_scheduler: str = "none",
                     steps_per_epoch: int = 1, num_epochs: int = 1,
                     grad_clip: Optional[float] = None,
                     skip_nonfinite: bool = False) -> Optimizer:
    """The optimizer over ``params`` for the reference's names (port of
    ``tpu3dssf.train.state.create_optimizer``; same arguments plus the
    parameters, which optax takes at ``init``)."""
    params = list(params)
    device = params[0].device if params else torch.device("cpu")
    table = schedule_table(lr_scheduler, learning_rate, steps_per_epoch,
                           num_epochs, device)
    lr = table[0].clone()
    # torch's Adam refuses a graph capture unless it is marked capturable
    # (the fused update itself is capturable either way)
    adam_kw = dict(lr=lr, betas=ADAM_BETAS, weight_decay=weight_decay,
                   fused=True, capturable=device.type == "cuda")
    if name == "AdamW":
        inner = torch.optim.AdamW(params, **adam_kw)
    elif name == "Adam":
        # torch Adam applies weight_decay as L2 into the gradient, like
        # optax.chain(add_decayed_weights, adam)
        inner = torch.optim.Adam(params, **adam_kw)
    elif name == "SGD":
        # optax's trace with decay 0 is plain SGD (torch refuses nesterov
        # without momentum)
        inner = torch.optim.SGD(params, lr=lr, momentum=momentum,
                                nesterov=nesterov and momentum > 0,
                                fused=True)
        if momentum > 0:
            for p in params:
                inner.state[p]["momentum_buffer"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
    else:
        raise ValueError(f"unknown optimizer: {name}")
    # the eager step on the card runs capturable by design
    inner._warned_capturable_if_run_uncaptured = True
    plateau = (DevicePlateau(accumulation_size=max(1, steps_per_epoch),
                             device=device)
               if lr_scheduler == "ReduceLROnPlateau" else None)
    return Optimizer(inner, table, grad_clip=grad_clip,
                     skip_nonfinite=skip_nonfinite, plateau=plateau)


class TrainState:
    """Model + optimizer + update count (flax ``TrainState``'s role).

    ``step`` counts calls of :meth:`apply_gradients`, skipped updates
    included, as flax's ``step`` does. It is the one host-side count (the
    DropPath masks of an update are drawn from it before the update).
    """

    def __init__(self, model: torch.nn.Module, optimizer: Optimizer,
                 step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.step = step

    def apply_gradients(self, value=None):
        self.optimizer.step(value)
        self.advance()

    def advance(self):
        """The host half of an update, the update count: what a graphed
        train step runs after each replay."""
        self.step += 1

    def state_dict(self):
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.step}

    def load_state_dict(self, state):
        """Restore in place. The optimizer's state tensors are replaced, so
        the CUDA graphs captured over this state are dropped."""
        drop_graphs(self)
        self.optimizer.load_state_dict(state["optimizer"])   # checks first
        self.model.load_state_dict(state["model"])
        self.step = int(state["step"])
