"""How ``correct`` is decided: what the timed path produced on a seeded
sample of its frames, against the plain float32 reference on the same
inputs and weights, run after the window once the program is freed.

* ``stream`` (per-point labels reach the host): ``label_gap``, the widest
  gap over the sample's valid points by which the reference's logit of the
  program's label lies below the reference's best logit, in units of the
  standard deviation of that frame's reference logits. Valid for argmax
  labels: a label that a rounding flipped between two near-equal logits
  has a gap near 0.
* ``eval`` (per-batch loss and counts reach the host):
  ``confusion_excess``, the share of a batch's valid points by which the
  program's confusion matrix departs from the reference's (half the L1
  distance of the two matrices over the valid points), less the same
  share for the reference itself run in bfloat16 (operands and stored
  activations rounded): the labels that rounding flips between near-tied
  logits, beyond what the configuration's own precision flips on that
  seed's weights, whose near-ties vary sixfold from seed to seed;
  ``valid_gap``, the largest difference of a batch's count of valid
  points (exact). The batch's mean loss is not compared: it averages the
  rounding of a batch's points away (at batch 4 the float8 control's loss
  came within twice the program's), so no limit separates the two.
* ``train`` (the set-up's first three steps, through the window's own
  call, on three batches of distinct sweeps; the reference follows them
  from the same weights): ``grad_gap``, over the parameter leaves, the
  largest difference between the norm of the first gradient as AdamW took
  it (its first moment over 1 − β₁) and the reference's, over the
  reference's norm of that leaf or of the median leaf, whichever is
  larger; ``update_gap``, the same for each leaf's change over the three
  steps, leaving out the entries whose first reference gradient is under
  a thousandth of the median leaf's root mean square (they move by
  round-off alone under Adam); ``grad_diff``, the median over the leaves
  of the first gradient's distance from the reference's over the
  reference's norm: norms and means average the entries' rounding away,
  so that the float8 control reads within 3x of the program on the two
  gaps and on the steps' losses, which are logged and not compared.

The control, the reference on float8 operands
(:func:`benchmark.reference.nn.lower_precision`) in the program's place,
is read by :func:`control_numbers` for the limits' calibration and the
tests, never in a measuring run.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import sys
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import weights as W
from benchmark.reference import nn as rnn
from benchmark.reference import widths
from benchmark.reference.models import Segmentation, loss_and_counts
from benchmark.reference.ptv3 import round_up
from benchmark.reference.vit import ViT, preprocess


@dataclasses.dataclass
class TrainRun:
    """Three steps of training: each step's loss, the first update's
    gradient, the parameters after the third, the pool batches in order."""

    losses: List[float]
    g1: Dict[str, torch.Tensor]
    p3: Dict[str, torch.Tensor]
    order: List[int]


class Reference:
    """The reference's models of a configuration, on ``device``."""

    def __init__(self, cfg, w_pipe, w_vit, device, steps_per_epoch=1):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg, self.device = cfg, device
        self.w_pipe, self.steps_per_epoch = w_pipe, steps_per_epoch
        self.widths = widths.of(cfg)
        self.vit = (W.load(ViT(self.widths.vit).to(device), w_vit)
                    if self.widths.fusion else None)
        self.seg = self._model()

    def _model(self):
        cfg, w = self.cfg, self.cfg.tpu.window_size
        return W.load(Segmentation(
            self.widths, cfg.voxel_size, round_up(cfg.tpu.voxel_capacity, w),
            cfg.tpu.intensity_mode, cfg.tpu.devoxelize_mode).to(
                self.device), self.w_pipe)

    @torch.no_grad()
    def tokens(self, b):
        if self.vit is None:
            return None
        size = self.vit.cfg.image_size
        return torch.stack([self.vit(preprocess(im, size))
                            for im in b["images"]])

    def logits(self, host, model=None):
        """(B, P, C) f32 logits of one pool batch (host tensors); with a
        gradient where ``model`` (a copy in training) is given."""
        b = {k: v.to(self.device) for k, v in host.items()}
        with torch.set_grad_enabled(model is not None):
            return (model or self.seg)(
                b["points"], b["point_valid"], self.tokens(b),
                b.get("cam_intrinsics"), b.get("lidar2cam"))

    def rate(self, t):
        """The configuration's learning rate at update ``t``: cosine
        annealing to 0 over the run's updates, or constant."""
        cfg = self.cfg
        if cfg.lr_scheduler == "CosineAnnealingLR":
            n = self.steps_per_epoch * cfg.max_num_epochs
            return cfg.learning_rate * 0.5 * (1.0 + math.cos(
                math.pi * min(t, n) / n))
        if cfg.lr_scheduler == "none":
            return cfg.learning_rate
        raise NotImplementedError(f"schedule {cfg.lr_scheduler}")

    def train(self, pool, order) -> TrainRun:
        """The configuration's AdamW over ``order``'s batches from the
        benchmark's weights."""
        cfg = self.cfg
        if cfg.optimizer != "AdamW" or cfg.grad_clip:
            raise NotImplementedError("the reference trains AdamW, unclipped")
        model = self._model()
        opt = torch.optim.AdamW(model.parameters(), lr=self.rate(0),
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=cfg.weight_decay,
                                foreach=False)
        losses, g1 = [], None
        for t, i in enumerate(order):
            for group in opt.param_groups:
                group["lr"] = self.rate(t)
            opt.zero_grad()
            loss = self.loss(self.logits(pool[i], model), pool[i])[0]
            loss.backward()
            losses.append(float(loss.detach()))
            if t == 0:
                g1 = {n: p.grad.clone() for n, p in model.named_parameters()}
            opt.step()
        p3 = {n: p.detach().clone() for n, p in model.named_parameters()}
        return TrainRun(losses, g1, p3, list(order))

    def loss(self, logits, host):
        cfg = self.cfg
        weights = (cfg.class_weights if cfg.class_weights
                   else [1.0] * cfg.mlp_class)
        return loss_and_counts(logits, host["labels"].to(self.device),
                               host["mask"].to(self.device), weights,
                               cfg.lambda_lovasz, cfg.mlp_class)


def label_gap(ref_logits, labels, point_valid):
    """Widest gap (in standard deviations of the frame's logits) of the
    program's labels (B, P) below the reference's best."""
    z = ref_logits.float()
    labels = torch.as_tensor(labels, device=z.device).long()
    valid = torch.as_tensor(point_valid, device=z.device)
    worst = 0.0
    for b in range(z.shape[0]):
        zb, lb = z[b][valid[b]], labels[b][valid[b]]
        gap = zb.max(-1).values - zb.gather(-1, lb[:, None])[:, 0]
        worst = max(worst, float(gap.max() / zb.std().clamp_min(1e-12)))
    return worst


def eval_gaps(prog, ref):
    """(confusion_gap, valid_gap) of one batch: ``prog`` the program's
    (valid, confusion), ``ref`` the reference's."""
    (vp, cp), (vr, cr) = prog, ref
    cp = torch.as_tensor(cp).cpu().long()
    cr = torch.as_tensor(cr).cpu().long()
    return (float((cp - cr).abs().sum()) / (2.0 * max(int(vr), 1)),
            abs(int(vp) - int(vr)))


def worst_leaves(prog, ref, leaves, top=3):
    """The worst of ``leaves`` by |‖prog‖ − ‖ref‖| over the reference's
    norm of that leaf or of the median leaf, whichever is larger: (name,
    gap, ‖prog‖, ‖ref‖), worst first."""
    norms = {n: float(ref[n].norm()) for n in leaves}
    median = statistics.median(norms.values())
    rows = [(n, abs(float(prog[n].norm()) - norms[n])
             / max(norms[n], median, 1e-30), float(prog[n].norm()), norms[n])
            for n in leaves]
    return sorted(rows, key=lambda r: -r[1])[:top]


def leaf_gap(prog, ref, leaves):
    return worst_leaves(prog, ref, leaves, 1)[0][1]


def median_leaf_diff(prog, ref, leaves):
    """The median over ``leaves`` of ‖prog − ref‖ / ‖ref‖: how far each
    entry lies from the reference's, where a norm averages the entries'
    rounding away."""
    return statistics.median(
        float((prog[n].float() - ref[n].float()).norm())
        / max(float(ref[n].norm()), 1e-30) for n in leaves)


def train_numbers(prog: TrainRun, ref: TrainRun, w0, log=None):
    steps = [abs(a - b) / max(abs(b), 1e-12)
             for a, b in zip(prog.losses, ref.losses)]
    leaves = sorted(ref.g1)
    grad = leaf_gap(prog.g1, ref.g1, leaves)
    # the update leaves out the entries whose first reference gradient is
    # under a thousandth of the median leaf's root mean square: nought to
    # rounding (a key's bias under softmax), they move under Adam by
    # round-off alone
    rms = [float(ref.g1[n].norm()) / math.sqrt(ref.g1[n].numel())
           for n in leaves]
    floor = 1e-3 * statistics.median(rms)
    keep = {n: ref.g1[n].abs() >= floor for n in leaves}
    moved = [n for n in leaves if bool(keep[n].any())]
    dp = {n: (prog.p3[n] - w0[n])[keep[n]] for n in moved}
    dr = {n: (ref.p3[n] - w0[n])[keep[n]] for n in moved}
    if log is not None:
        out = {n: int((~keep[n]).sum()) for n in leaves
               if not bool(keep[n].all())}
        log(f"losses {prog.losses} against {ref.losses}, loss gaps by "
            f"step {steps} (not compared); entries left out "
            f"of the update (of {sum(k.numel() for k in keep.values())}): "
            f"{sum(out.values())} in {len(out)} leaves, "
            f"{sorted(out.items(), key=lambda x: -x[1])[:6]}")
        log(f"worst gradient leaves {worst_leaves(prog.g1, ref.g1, leaves)}")
        log(f"worst update leaves {worst_leaves(dp, dr, moved)}")
    return {"grad_gap": grad, "update_gap": leaf_gap(dp, dr, moved),
            "grad_diff": median_leaf_diff(prog.g1, ref.g1, leaves)}


def log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def numbers(loop, ref: Reference, pool, sample):
    """The compared numbers of ``sample``: a list of (pool index, the
    program's output) pairs, or a :class:`TrainRun`."""
    if loop == "train":
        return train_numbers(sample, ref.train(pool, sample.order),
                             ref.w_pipe, log)
    if loop == "stream":
        gap = 0.0
        for i, labels in sample:
            gap = max(gap, label_gap(ref.logits(pool[i]), labels,
                                     pool[i]["point_valid"]))
        return {"label_gap": gap}
    worst = [0.0, 0]
    for i, m in sample:
        _, valid, cm = ref.loss(ref.logits(pool[i]), pool[i])
        with rnn.stated_precision():
            _, _, cm16 = ref.loss(ref.logits(pool[i]), pool[i])
        gap, vgap = eval_gaps((m["valid"], m["confusion"]), (valid, cm))
        base = eval_gaps((valid, cm16), (valid, cm))[0]
        log(f"batch {i}: confusion gap {gap} against the bfloat16 "
            f"reference's {base}")
        worst = [max(worst[0], gap - base), max(worst[1], vgap)]
    return dict(zip(("confusion_excess", "valid_gap"), worst))


def control_outputs(loop, ref: Reference, pool, sample):
    """What the control (the reference on float8 operands) produces for
    the pool batches of ``sample``, in the program's output form."""
    if loop == "train":
        with rnn.lower_precision():
            return ref.train(pool, sample.order)
    out = []
    with rnn.lower_precision():
        for i, _ in sample:
            z = ref.logits(pool[i])
            if loop == "stream":
                out.append((i, z.argmax(-1).to(torch.uint8).cpu().numpy()))
            else:
                loss, valid, cm = ref.loss(z, pool[i])
                out.append((i, {"loss": loss, "valid": valid,
                                "confusion": cm}))
    return out


def control_numbers(loop, ref: Reference, pool, sample):
    return numbers(loop, ref, pool, control_outputs(loop, ref, pool,
                                                    sample))


def sample(seed, frames, k):
    """``k`` of the window's ``frames`` (pool index, output), drawn from
    the seed."""
    rng = np.random.default_rng([seed, 3])
    picks = rng.choice(len(frames), size=min(k, len(frames)), replace=False)
    return [frames[j] for j in sorted(picks)]
