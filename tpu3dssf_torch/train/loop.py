"""Train and eval loops: image encode, train/eval steps, metric sums, the
epoch loop.

Port of ``tpu3dssf.train.loop``. One step per batch (forward, loss,
backward, optimizer update) on the model's device; the frozen ViT encodes
all views of a batch as one forward under ``torch.inference_mode``; eval
metrics are confusion matrices summed on the device; checkpoints keep the
best-by-val-accuracy state and, every epoch, the full train state under
``last/``. ``make_*`` return the eager steps, as JAX's return the functions
it jits; :func:`train_model` runs its train and eval steps through
:mod:`tpu3dssf_torch.train.graph` (on the card, one CUDA graph replay per
step, the counterpart of ``jax.jit``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from tpu3dssf_torch.losses import CELSLoss
from tpu3dssf_torch.metrics import (confusion_matrix, evaluate_from_confusion,
                                    format_metrics)
from tpu3dssf_torch.models.vit import preprocess_images
from tpu3dssf_torch.parallel.mesh import all_reduce_grads, gather_batch
from tpu3dssf_torch.train.checkpoint import save_checkpoint
from tpu3dssf_torch.train.graph import graph_train_step, graphed
from tpu3dssf_torch.utils.logging import MetricLogger, NullLogger
from tpu3dssf_torch.utils.timing import peak_hbm_mb


def make_image_encode_fn(vit_model, encoder_hw, compute_dtype=torch.float32):
    """Encode fn: raw images (B, N_cam, H, W, 3) uint8 → patch tokens
    (B, N_cam, M, D). The ViT is frozen, so all views run as one batch.

    The tokens are inference tensors: autograd cannot save them, so the
    model must gather them before any learnable op touches them (the
    fusion head does).
    """

    @torch.inference_mode()
    def encode(images):
        B, n_cam = images.shape[:2]
        x = preprocess_images(images, encoder_hw, dtype=compute_dtype)
        x = x.reshape((B * n_cam,) + tuple(x.shape[2:]))
        tokens = vit_model(x)["patch_features"]
        return tokens.reshape(B, n_cam, tokens.shape[1], tokens.shape[2])

    return encode


def _fold_seed(seed: int, i: int) -> int:
    """A generator seed per (base seed, counter), JAX's ``fold_in`` role
    (the bits differ from JAX's)."""
    return (seed * 0x9E3779B97F4A7C15 + i) % (2 ** 63)


def drop_path_masks(model, dropout_seed: Optional[int], step: int,
                    grad_accum: int, rows: int, device, mesh=None):
    """The DropPath keep masks of update ``step``: (grad_accum, 2 · blocks,
    rows) bool on ``device``, or None (no seed, or no DropPath drops).

    Microbatch ``i`` draws from a CPU generator seeded from (seed,
    step·grad_accum + i), as JAX folds its key, one ``torch.rand((rows,))``
    per DropPath in forward order (``PointTransformerV3.draw_keep``).
    Under a ``mesh`` (:mod:`tpu3dssf_torch.parallel`) ``rows`` is this
    rank's share of a microbatch: every rank draws the whole microbatch's
    masks from the one generator and keeps its own rows, as JAX's sharded
    mask would be.
    """
    if dropout_seed is None:
        return None
    ranks = 1 if mesh is None else mesh.shape["data"]
    lo = 0 if mesh is None else mesh.coords["data"] * rows
    masks = []
    for i in range(grad_accum):
        gen = torch.Generator().manual_seed(
            _fold_seed(dropout_seed, step * grad_accum + i))
        keep = model.ptv3.draw_keep(rows * ranks, gen)
        if keep is None:
            return None
        masks.append(keep[:, lo:lo + rows])
    return torch.stack(masks).to(device)


def make_train_step(loss_fn: CELSLoss, dropout_seed: Optional[int] = None,
                    grad_accum: int = 1, mesh=None):
    """``train_step(state, batch, patch_tokens)`` → metrics dict; updates
    ``state`` (a :class:`~tpu3dssf_torch.train.state.TrainState`) in place.

    ``dropout_seed`` enables DropPath (:func:`drop_path_masks`); None is
    deterministic. ``grad_accum > 1`` splits the batch's leading dim into
    that many sequential microbatches and applies the mean of their
    gradients in one update; the metrics are the mean loss and the summed
    counts, as in the JAX step. Metrics stay on the device.

    The step is three parts: ``train_step.draw(state, batch,
    patch_tokens)`` on the host (the update's DropPath masks, from
    ``state.step``; returns the arguments of the next half),
    ``train_step.update(state, batch, patch_tokens, keep)`` on the device
    (forward, backward and the optimizer's update, every decision in it a
    device operation: what a CUDA graph captures) and
    ``train_step.advance(state, ...)`` on the host (``state.step``).

    With a ``mesh`` (:mod:`tpu3dssf_torch.parallel`) it is the data-parallel
    step with JAX's mesh semantics, the whole batch's loss: each rank runs
    the forward on its rows (``shard_batch(batch, mesh,
    microbatches=grad_accum)``: its 1/S of every microbatch), gathers the
    logits, labels and mask over the ``data`` axis (:func:`~tpu3dssf_torch.
    parallel.mesh.gather_batch`, whose backward keeps this rank's slice:
    every rank computes the same loss), computes the loss of the gathered
    microbatch (its CE denominator and Lovász class presence are the whole
    microbatch's), runs the backward, sums the gradients over the axis and
    makes one update, the same on every rank. The state must start the
    same on every rank (:func:`~tpu3dssf_torch.parallel.replicate`). The
    gloo collectives cannot be captured in a CUDA graph, so a mesh step
    runs eagerly: it is never passed to :func:`~tpu3dssf_torch.train.graph.
    graph_train_step` (``main_train`` ignores the mesh, as JAX's does).
    """

    def split(x):
        if x.shape[0] % grad_accum:
            raise ValueError(f"batch dim {x.shape[0]} not divisible by "
                             f"grad_accum={grad_accum}")
        return x.chunk(grad_accum, dim=0)

    def draw(state, batch, patch_tokens):
        points = batch["points"]
        keep = drop_path_masks(state.model, dropout_seed, state.step,
                               grad_accum, points.shape[0] // grad_accum,
                               points.device, mesh)
        return state, batch, patch_tokens, keep

    def update(state, batch, patch_tokens, keep=None):
        model = state.model
        micro = {k: split(v) for k, v in batch.items()}
        tokens = (split(patch_tokens) if patch_tokens is not None
                  else (None,) * grad_accum)
        state.optimizer.zero_grad()
        sums = None
        for i in range(grad_accum):
            b = {k: v[i] for k, v in micro.items()}
            logits = model(b["points"], b["point_valid"], tokens[i],
                           b["cam_intrinsics"], b["lidar2cam"],
                           keep=None if keep is None else keep[i])
            labels, mask = b["labels"], b["mask"]
            if mesh is not None:
                logits, labels, mask = (gather_batch(x, mesh)
                                        for x in (logits, labels, mask))
            out = loss_fn(logits, labels, mask)
            out.total.backward()  # accumulates the sum into .grad
            m = {"loss": out.total.detach(), "ce": out.ce.detach(),
                 "lovasz": out.lovasz.detach(), "correct": out.num_correct,
                 "valid": out.num_valid}
            sums = m if sums is None else {k: sums[k] + m[k] for k in m}
        if mesh is not None:
            all_reduce_grads(model.parameters(), mesh)
        if grad_accum > 1:
            inv = 1.0 / grad_accum
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.mul_(inv)
            for k in ("loss", "ce", "lovasz"):
                sums[k] = sums[k] * inv
        state.optimizer.step(value=sums["loss"])
        return sums

    def advance(state, *_):
        state.advance()

    def train_step(state, batch, patch_tokens):
        sums = update(*draw(state, batch, patch_tokens))
        advance(state)
        return sums

    train_step.draw, train_step.update = draw, update
    train_step.advance = advance
    return train_step


def make_eval_step(loss_fn: CELSLoss, num_classes: int, mesh=None):
    """``eval_step(model, batch, patch_tokens)`` → the JAX eval step's
    metrics dict (loss, ce, lovasz, correct, valid, confusion); ``batch``
    holds tensors on the model's device. Without a mesh the step is eager
    (callers graph it with :func:`~tpu3dssf_torch.train.graph.graphed`).

    With a ``mesh`` the batch is this rank's rows of the global batch
    (``shard_batch(batch, mesh)``), as under JAX's mesh, and the step is
    the whole batch's: the forward on this rank's rows, then the logits,
    labels and mask gathered over the ``data`` axis, then the loss of the
    whole batch, the same on every rank, and the counts (correct, valid,
    confusion) of this rank's rows, which :class:`MetricAccumulator` sums
    over the axis. The forward and the loss are each graphed (``graphed``
    runs CPU tensors eagerly); the gather runs between them, since a CUDA
    graph cannot capture gloo.
    """

    def forward(model, batch, patch_tokens):
        return model(batch["points"], batch["point_valid"], patch_tokens,
                     batch["cam_intrinsics"], batch["lidar2cam"])

    def metrics(logits, labels, mask, rows=None):
        out = loss_fn(logits, labels, mask)
        preds, valid = out.predictions, out.valid
        correct, n_valid = out.num_correct, out.num_valid
        if rows is not None:   # this rank's rows of the gathered batch
            preds, labels, valid = (x[rows] for x in (preds, labels, valid))
            correct = ((preds == labels.to(torch.int32)) & valid).sum(
                dtype=torch.int32)
            n_valid = valid.sum(dtype=torch.int32)
        return {
            "loss": out.total,
            "ce": out.ce,
            "lovasz": out.lovasz,
            "correct": correct,
            "valid": n_valid,
            "confusion": confusion_matrix(preds, labels, num_classes, valid),
        }

    if mesh is None:
        @torch.inference_mode()
        def eval_step(model, batch, patch_tokens):
            return metrics(forward(model, batch, patch_tokens),
                           batch["labels"], batch["mask"])

        return eval_step

    local = graphed(torch.inference_mode()(forward), "eval_forward")

    @torch.inference_mode()
    def global_metrics(logits, labels, mask):
        n = logits.shape[0] // mesh.shape["data"]
        lo = mesh.coords["data"] * n
        return metrics(logits, labels, mask, slice(lo, lo + n))

    fold = graphed(global_metrics, "eval_loss")

    @torch.inference_mode()
    def eval_step(model, batch, patch_tokens):
        logits = local(model, batch, patch_tokens)
        return fold(*(gather_batch(x, mesh) for x in (
            logits, batch["labels"], batch["mask"])))

    return eval_step


class MetricAccumulator:
    """Eval-metric sums kept on the device, folded to host int64/float every
    ``fold_every`` batches (one sync per window, not per batch).

    With a ``mesh`` each rank sums the counts of its own rows (a mesh eval
    step's ``correct``, ``valid`` and ``confusion``), and :meth:`metrics`
    sums them over the ``data`` axis (one gloo ``all_reduce`` of the int64
    counts) before it derives the metrics: the global sums JAX's eval under
    a mesh computes. The loss sums are not reduced: a mesh eval step's loss is
    already the whole batch's, the same on every rank.
    """

    def __init__(self, num_classes: int, fold_every: int = 256, mesh=None):
        self.mesh = mesh
        self.fold_every = fold_every
        self.it = 0
        self._cm_h = np.zeros((num_classes, num_classes), np.int64)
        self._loss_h, self._correct_h, self._valid_h = 0.0, 0, 0
        self._cm = self._loss = self._correct = self._valid = None

    def add(self, m: Dict):
        # copies: a caller may overwrite its tensors after this returns
        loss = m["loss"].to(torch.float64, copy=True)
        cor = m["correct"].to(torch.int64, copy=True)
        val = m["valid"].to(torch.int64, copy=True)
        if self._cm is None:
            self._cm = m["confusion"].to(torch.int64, copy=True)
            self._loss, self._correct, self._valid = loss, cor, val
        else:
            self._cm = self._cm + m["confusion"]
            self._loss = self._loss + loss
            self._correct = self._correct + cor
            self._valid = self._valid + val
        self.it += 1
        if self.it % self.fold_every == 0:
            self._fold()

    def _fold(self):
        if self._cm is not None:
            self._cm_h = self._cm_h + self._cm.cpu().numpy()
            self._loss_h += float(self._loss)
            self._correct_h += int(self._correct)
            self._valid_h += int(self._valid)
            self._cm = self._loss = self._correct = self._valid = None

    def local_sums(self) -> Dict:
        """This rank's host sums: ``confusion`` (int64), ``loss``,
        ``correct``, ``valid`` (folds pending device sums)."""
        self._fold()
        return {"confusion": self._cm_h.copy(), "loss": self._loss_h,
                "correct": self._correct_h, "valid": self._valid_h}

    def sums(self) -> Dict:
        """:meth:`local_sums`, the counts summed over the mesh axis."""
        sums = self.local_sums()
        if self.mesh is not None:
            import torch.distributed as dist
            cm = sums["confusion"]
            flat = torch.from_numpy(np.concatenate(
                [cm.reshape(-1), [sums["correct"], sums["valid"]]]))
            dist.all_reduce(flat, group=self.mesh.group("data"))
            flat = flat.numpy()
            sums.update(confusion=flat[:cm.size].reshape(cm.shape),
                        correct=int(flat[-2]), valid=int(flat[-1]))
        return sums

    def metrics(self) -> Dict:
        """The reference ``evaluate`` dict as host numpy (syncs; under a
        mesh every rank calls it)."""
        sums = self.sums()
        out = evaluate_from_confusion(
            torch.from_numpy(sums["confusion"].astype(np.float32)),
            sums["loss"], float(sums["correct"]), float(sums["valid"]),
            max(self.it, 1))
        return {k: v.numpy() for k, v in out.items()}


def _device_batch(batch, encode_fn, zero_tokens_fn, device):
    """Host batch → (model inputs on ``device``, patch tokens)."""
    images = batch.pop("images", None)
    out = {k: torch.as_tensor(np.asarray(v)).to(device)
           for k, v in batch.items()}
    if encode_fn is not None and images is not None:
        tokens = encode_fn(torch.as_tensor(images).to(device))
    elif zero_tokens_fn is not None:
        tokens = zero_tokens_fn(out)
    else:
        tokens = None
    return out, tokens


def evaluate_model(model, pipeline_iter, eval_step, encode_fn,
                   num_classes: int, zero_tokens_fn=None,
                   logger: Optional[MetricLogger] = None,
                   verbose: bool = True):
    """Full-split evaluation → the reference ``evaluate`` metrics dict."""
    device = next(model.parameters()).device
    acc = MetricAccumulator(num_classes)
    for batch in pipeline_iter:
        batch, tokens = _device_batch(batch, encode_fn, zero_tokens_fn,
                                      device)
        acc.add(eval_step(model, batch, tokens))
    metrics = acc.metrics()
    if verbose:
        print(format_metrics(metrics))
    if logger is not None and not isinstance(logger, NullLogger):
        logger.log({f"eval/{k}": v for k, v in metrics.items()
                    if np.ndim(v) == 0})
    return metrics


def train_model(state, dataloaders: Dict, loss_fn: CELSLoss, encode_fn,
                num_classes: int, num_epochs: int,
                save_dir: Optional[str] = None,
                logger: Optional[MetricLogger] = None,
                zero_tokens_fn: Optional[Callable] = None,
                log_every: int = 10,
                profile_dir: Optional[str] = None,
                profile_steps: tuple = (10, 13),
                start_epoch: int = 0,
                best_acc: float = -1.0,
                dropout_seed: Optional[int] = None,
                grad_accum: int = 1):
    """Epoch loop with best-val-acc checkpointing (port of JAX's).

    Returns (train_acc_history, val_acc_history) and leaves ``state``
    holding the final weights. Per-step metrics stay on the device and are
    read at ``log_every`` boundaries. ``profile_dir`` captures a
    ``torch.profiler`` trace of the steps in ``profile_steps`` (from, to)
    into ``<profile_dir>/train_trace.json``. The train and eval steps are
    graphed (:mod:`tpu3dssf_torch.train.graph`), under every
    configuration.
    """
    logger = logger or NullLogger()
    device = next(state.model.parameters()).device
    train_step = graph_train_step(
        make_train_step(loss_fn, dropout_seed, grad_accum))
    eval_step = graphed(make_eval_step(loss_fn, num_classes), "eval_step")

    tr_hist, val_hist, history = [], [], []
    global_step = 0
    prof = None
    for epoch in range(start_epoch, num_epochs):
        print(f"Epoch {epoch}/{num_epochs - 1}\n" + "-" * 20)
        run_loss, run_correct, run_valid, it = 0.0, 0, 0, 0
        win = None
        t0 = time.perf_counter()

        def fold_window():
            nonlocal run_loss, run_correct, run_valid, win
            if win is not None:
                run_loss += float(win["loss"])
                run_correct += int(win["correct"])
                run_valid += int(win["valid"])
                win = None

        for batch in dataloaders["train"]:
            if profile_dir and global_step == profile_steps[0]:
                from torch.profiler import ProfilerActivity, profile
                acts = [ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if device.type == "cuda" else [])
                prof = profile(activities=acts)
                prof.__enter__()
            if prof is not None and global_step == profile_steps[1]:
                prof.__exit__(None, None, None)
                os.makedirs(profile_dir, exist_ok=True)
                path = os.path.join(profile_dir, "train_trace.json")
                prof.export_chrome_trace(path)
                prof = None
                print(f"[profiler] trace written to {path}")
            batch, tokens = _device_batch(batch, encode_fn, zero_tokens_fn,
                                          device)
            m = train_step(state, batch, tokens)
            m = {"loss": m["loss"].to(torch.float32, copy=True),
                 "correct": m["correct"].to(torch.int64, copy=True),
                 "valid": m["valid"].to(torch.int64, copy=True)}
            win = m if win is None else {k: win[k] + m[k] for k in m}
            it += 1
            global_step += 1
            if it % log_every == 0:
                fold_window()
                dt = (time.perf_counter() - t0) / it
                print(f"  [train {it}] loss={run_loss/it:.4f} "
                      f"acc={run_correct/max(run_valid,1):.4f} "
                      f"({dt*1000:.0f} ms/step)")
                logger.log({"train/loss": run_loss / it,
                            "train/acc": run_correct / max(run_valid, 1),
                            "step": global_step})
        fold_window()
        if prof is not None:  # the epoch ended inside the profiled window
            prof.__exit__(None, None, None)
            prof = None
        tr_acc = run_correct / max(run_valid, 1)
        tr_hist.append(tr_acc)

        metrics = evaluate_model(state.model, dataloaders["val"], eval_step,
                                 encode_fn, num_classes,
                                 zero_tokens_fn=zero_tokens_fn)
        val_acc = float(metrics["overall_acc"])
        val_hist.append(val_acc)
        # peak allocated device memory since the last reset (0.0 off CUDA)
        mem_mb = peak_hbm_mb(device)
        if mem_mb:
            print(f"  peak device memory: {mem_mb:,.0f} MiB")
        history.append({
            "epoch": epoch,
            "train_loss": run_loss / max(it, 1),
            "train_acc": tr_acc,
            "peak_hbm_mb": mem_mb,
            **{k: (v.tolist() if np.ndim(v) else float(v))
               for k, v in metrics.items()},
        })
        logger.log({
            "val/loss": float(metrics["loss"]),
            "val/acc": val_acc,
            "val/mean_IoU": float(metrics["mean_iou"]),
            "val/mean_per_class_acc": float(metrics["mean_per_class_acc"]),
            "val/precision": float(metrics["precision"]),
            "val/recall": float(metrics["recall"]),
            "val/f1": float(metrics["f1"]),
            "epoch": epoch,
            "peak_hbm_mb": mem_mb,
        })
        extra = {"best_acc": max(best_acc, val_acc), "epoch": epoch}
        if val_acc > best_acc:
            best_acc = val_acc
            if save_dir:
                save_checkpoint(save_dir, epoch, state, extra=extra)
        if save_dir:
            # the full train state every epoch, for --resume
            save_checkpoint(os.path.join(save_dir, "last"), epoch, state,
                            extra=extra)

    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, "training_history.json"), "w") as f:
            json.dump({"best_val_acc": float(best_acc), "epochs": history},
                      f, indent=1)
    print(f"Best val Acc: {best_acc:.4f}")
    return tr_hist, val_hist
