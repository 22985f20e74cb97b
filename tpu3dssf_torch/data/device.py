"""The host batch's copy to the device, in the program's
``batch_to_device`` span (:mod:`tpu3dssf_torch.utils.timing`)."""

from __future__ import annotations

import numpy as np
import torch

from tpu3dssf_torch.utils import timing


def batch_to_device(batch, device):
    """Host numpy batch → tensors on ``device`` (images stay on the host
    side of the caller), in the host range ``batch_to_device``, which
    counts the tensors and bytes copied (``batch_to_device.tensors``,
    ``.bytes``) while spans are on."""
    with timing.span("batch_to_device"):
        out = {k: torch.as_tensor(np.asarray(v)).to(device)
               for k, v in batch.items()}
    if timing.spans_enabled():
        timing.count("batch_to_device.tensors", len(out))
        timing.count("batch_to_device.bytes",
                     sum(x.numel() * x.element_size() for x in out.values()))
    return out
