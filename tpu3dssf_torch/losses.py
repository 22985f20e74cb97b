"""Weighted cross-entropy + Lovász-Softmax, masked (forward only).

Port of the forward of ``tpu3dssf.losses``: the reference ``CELSLoss``
semantics — valid = mask ∧ (label != ignore_index), CE on labels shifted
to [0, C-1] with per-class weights, Lovász-Softmax over the valid points
averaged over the classes present, total = ce + λ·lovász, predictions
argmax+1 (0 where invalid). The Lovász sort is an exact stable descending
sort of the errors (the JAX default quantises the sort key to 13 bits).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class LossOutput(NamedTuple):
    total: torch.Tensor        # () scalar
    ce: torch.Tensor           # ()
    lovasz: torch.Tensor       # ()
    predictions: torch.Tensor  # (B, P) int32 in [1, C]; 0 where invalid
    valid: torch.Tensor        # (B, P) bool
    num_valid: torch.Tensor    # () int32
    num_correct: torch.Tensor  # () int32


def weighted_cross_entropy(logits, labels0, valid, class_weights=None):
    """sum(w_y · nll) / sum(w_y) over valid entries; labels0 in [0, C-1]."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels0[..., None].long())[..., 0]
    if class_weights is not None:
        w = class_weights.to(nll.device, torch.float32)[labels0.long()]
    else:
        w = torch.ones_like(nll)
    w = w * valid.to(torch.float32)
    return (w * nll).sum() / w.sum().clamp_min(1e-12)


def lovasz_softmax(probs, labels0, valid):
    """Masked Lovász-Softmax over flattened points, mean over present
    classes. probs (N, C); labels0 (N,) in [0, C-1]; valid (N,) bool.
    Invalid entries have error 0 and fg 0, so they add nothing."""
    probs = probs.float()
    N, C = probs.shape
    classes = torch.arange(C, device=probs.device)[:, None]
    fg = (valid[None, :] & (labels0[None, :] == classes)).to(torch.float32)
    errors = torch.where(valid[None, :], (fg - probs.T).abs(), 0.0)
    errors_s, order = torch.sort(errors, dim=1, descending=True, stable=True)
    fg_s = torch.gather(fg, 1, order)
    gts = fg_s.sum(dim=1, keepdim=True)
    cfg = torch.cumsum(fg_s, dim=1)
    inter = gts - cfg
    union = gts + torch.arange(1, N + 1, dtype=torch.float32,
                               device=probs.device)[None, :] - cfg
    jaccard = 1.0 - inter / union.clamp_min(1e-12)
    grad = torch.cat([jaccard[:, :1], jaccard[:, 1:] - jaccard[:, :-1]],
                     dim=1)
    losses = (errors_s * grad).sum(dim=1)
    present = (gts[:, 0] > 0).to(torch.float32)
    return (losses * present).sum() / present.sum().clamp_min(1.0)


class CELSLoss:
    """CE + λ·Lovász: ``loss(pred_scores (B, P, C), gt_labels (B, P) in
    [0, C], mask (B, P) bool)``."""

    def __init__(self, weight=None, ignore_index: int = 0,
                 lamda_lovasz: float = 1.0):
        self.weight = (None if weight is None
                       else torch.as_tensor(weight, dtype=torch.float32))
        self._weights = {}   # device -> the weights there, copied once
        self.ignore_index = ignore_index
        self.lamda_lovasz = lamda_lovasz

    def _weight_on(self, device):
        """The class weights on ``device``, copied there once: a step holds
        no host-to-device copy, which a CUDA graph could not replay."""
        if self.weight is None:
            return None
        if device not in self._weights:
            with torch.inference_mode(False):
                self._weights[device] = self.weight.to(device)
        return self._weights[device]

    def __call__(self, pred_scores, gt_labels,
                 mask: Optional[torch.Tensor] = None) -> LossOutput:
        B, P, C = pred_scores.shape
        labels = gt_labels.to(torch.int32)
        valid = labels != self.ignore_index
        if mask is not None:
            valid = valid & mask
        labels0 = (labels - 1).clamp(0, C - 1)
        ce = weighted_cross_entropy(pred_scores, labels0, valid,
                                    self._weight_on(pred_scores.device))
        probs = torch.softmax(pred_scores.float(), dim=-1)
        lov = lovasz_softmax(probs.reshape(-1, C), labels0.reshape(-1),
                             valid.reshape(-1))
        total = ce + self.lamda_lovasz * lov
        preds = pred_scores.argmax(dim=-1).to(torch.int32) + 1
        preds = torch.where(valid, preds, 0)
        num_valid = valid.sum(dtype=torch.int32)
        num_correct = ((preds == labels) & valid).sum(dtype=torch.int32)
        return LossOutput(total, ce, lov, preds, valid, num_valid,
                          num_correct)
