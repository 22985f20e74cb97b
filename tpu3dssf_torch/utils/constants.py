"""Device constants made once per device and argument.

A step that makes a constant tensor from host values on every call holds a
host-to-device copy, which a CUDA graph cannot replay
(:mod:`tpu3dssf_torch.train.graph`). :func:`device_constants` caches such
a function's result instead, as ``functools.lru_cache`` does. Under a
tracer (``torch.export``, whose fake mode makes every new tensor a fake)
the constants are made, or taken from the cache, with the tracer's modes
off: the cache holds only real tensors, and the tracer records them as
constants on their device, not the host values and a copy to the card.
"""

from __future__ import annotations

import functools

import torch
import torch._guards
from torch.utils._python_dispatch import _disable_current_modes


def device_constants(fn):
    """``fn(*hashable args)``, cached."""
    cached = functools.lru_cache(maxsize=None)(fn)

    @functools.wraps(fn)
    def wrapper(*args):
        if torch._guards.detect_fake_mode() is None:
            return cached(*args)
        with _disable_current_modes():
            return cached(*args)

    wrapper.cache_clear = cached.cache_clear
    return wrapper
