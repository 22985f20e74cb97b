"""Confusion-matrix segmentation metrics on tensors.

Port of ``tpu3dssf.metrics``: one (C, C) confusion matrix (rows = ground
truth, columns = prediction, labels in [1, C]) from which IoU, accuracy,
precision, recall and F1 follow with the reference's clamps.
"""

from __future__ import annotations

from typing import Dict

import torch


def confusion_matrix(preds, labels, num_classes, valid=None):
    """(C, C) int64 counts of the entries ``valid`` keeps."""
    p = preds.reshape(-1).long() - 1
    l = labels.reshape(-1).long() - 1  # noqa: E741
    idx = (num_classes * l.clamp(0, num_classes - 1)
           + p.clamp(0, num_classes - 1))
    w = (torch.ones_like(idx) if valid is None
         else valid.reshape(-1).long())
    cm = torch.zeros(num_classes ** 2, dtype=torch.int64,
                     device=idx.device).index_add_(0, idx, w)
    return cm.reshape(num_classes, num_classes)


def _f32(cm):
    return torch.as_tensor(cm).to(torch.float32)


def iou_from_confusion(cm):
    """Per-class IoU and its mean (union clamped to ≥ 1)."""
    cm = _f32(cm)
    inter = torch.diagonal(cm)
    iou = inter / (cm.sum(1) + cm.sum(0) - inter).clamp_min(1.0)
    return iou, iou.mean()


def per_class_accuracy(cm):
    cm = _f32(cm)
    acc = torch.diagonal(cm) / cm.sum(1).clamp_min(1.0)
    return acc, acc.mean()


def overall_accuracy(cm):
    """Correct over all counted entries (total clamped to ≥ 1)."""
    cm = _f32(cm)
    return torch.diagonal(cm).sum() / cm.sum().clamp_min(1.0)


def precision_recall_f1(cm):
    """Macro P/R/F1 with the reference's clamps (per-class denominators
    ≥ 1 before the mean, F1's ≥ 1e-6)."""
    cm = _f32(cm)
    tp = torch.diagonal(cm)
    precision = (tp / cm.sum(0).clamp_min(1.0)).mean()
    recall = (tp / cm.sum(1).clamp_min(1.0)).mean()
    f1 = 2 * precision * recall / (precision + recall).clamp_min(1e-6)
    return precision, recall, f1


def evaluate_from_confusion(cm, total_loss, total_correct, total_points,
                            iterations) -> Dict[str, torch.Tensor]:
    """The reference ``evaluate`` dict."""
    iou, miou = iou_from_confusion(cm)
    acc_pc, mean_acc = per_class_accuracy(cm)
    precision, recall, f1 = precision_recall_f1(cm)
    f = lambda x: torch.as_tensor(x, dtype=torch.float32)  # noqa: E731
    return {
        "loss": f(total_loss) / max(iterations, 1),
        "overall_acc": f(total_correct) / f(total_points).clamp_min(1.0),
        "iou_per_class": iou,
        "mean_iou": miou,
        "per_class_acc": acc_pc,
        "mean_per_class_acc": mean_acc,
        "precision": precision,
        "recall": recall,
        "f1": f1,
    }


def format_metrics(metrics: Dict) -> str:
    """Console block matching the reference's report."""
    iou = [f"{float(v):.4f}" for v in metrics["iou_per_class"]]
    acc = [f"{float(v):.4f}" for v in metrics["per_class_acc"]]
    return (
        "\n====== EVALUATION METRICS ======\n"
        f"Loss: {float(metrics['loss']):.4f}, "
        f"Overall Acc: {float(metrics['overall_acc']):.4f}\n"
        f"Per-Class Acc: {acc}, "
        f"Mean Per-Class Acc: {float(metrics['mean_per_class_acc']):.4f}\n"
        f"Per-Class IoU: {iou}, Mean IoU: {float(metrics['mean_iou']):.4f}\n"
        f"Precision: {float(metrics['precision']):.4f}, "
        f"Recall: {float(metrics['recall']):.4f}, "
        f"F1: {float(metrics['f1']):.4f}\n"
        "=================================\n"
    )
