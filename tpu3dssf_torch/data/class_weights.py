"""Class-weight computation from label frequencies.

The port's own copy of ``tpu3dssf/data/class_weights.py``
(host code: the port imports nothing of the JAX package).

Rebuilds reference ``calculate_class_weights`` (utils/dataloader.py:
244-270): accumulate per-class counts over the train split and derive
``sqrt(max_count / count)`` weights. The reference also bakes two
alternative compressions into its configs (nuscenesTestConfig22.yaml:
14-31); all three schemes are provided.
"""

from __future__ import annotations

import numpy as np


def accumulate_class_counts(dataloader, num_classes: int,
                            print_every: int = 0) -> np.ndarray:
    """Count valid (mask=True) labels over an epoch of batches."""
    counts = np.zeros(num_classes + 1, dtype=np.int64)  # incl. noise 0
    for i, batch in enumerate(dataloader):
        labels = np.asarray(batch["labels"])
        mask = np.asarray(batch["mask"])
        counts += np.bincount(labels[mask].reshape(-1),
                              minlength=num_classes + 1)
        if print_every and (i + 1) % print_every == 0:
            w = sqrt_inverse_weights(counts[1:])
            print(f"[batch {i + 1}] current class weights: {w}")
    return counts[1:]  # drop noise class


def sqrt_inverse_weights(counts) -> np.ndarray:
    """sqrt(max/count) — the reference's raw scheme (dataloader.py:261-265)."""
    counts = np.asarray(counts, dtype=np.float64)
    return np.sqrt(counts.max() / (counts + 1e-6)).astype(np.float32)


def soft_compressed_weights(counts, power: float = 0.5,
                            cap: float = 16.0) -> np.ndarray:
    """Capped power-compressed inverse-frequency (the configs' 'soft'
    scheme shape, nuscenesTestConfig22.yaml:22-25)."""
    w = sqrt_inverse_weights(counts) ** power
    w = np.minimum(w * (w.max() ** (1 - power)), cap)
    return (w / w.min()).astype(np.float32)


def log_compressed_weights(counts) -> np.ndarray:
    """1 + ln(sqrt-scheme) — matches the 'soft log compressed' scheme the
    reference ships in its best config (nuscenesTestConfig22.yaml:27-31)."""
    w = sqrt_inverse_weights(counts)
    return (1.0 + np.log(w / w.min())).astype(np.float32)


def calculate_class_weights(dataloader, num_classes: int,
                            scheme: str = "sqrt",
                            print_every: int = 0) -> np.ndarray:
    counts = accumulate_class_counts(dataloader, num_classes, print_every)
    if scheme == "sqrt":
        w = sqrt_inverse_weights(counts)
    elif scheme == "log":
        w = log_compressed_weights(counts)
    elif scheme == "soft":
        w = soft_compressed_weights(counts)
    else:
        raise ValueError(f"unknown scheme: {scheme}")
    print("\n=== FINAL CLASS WEIGHTS ===")
    print(w)
    return w
