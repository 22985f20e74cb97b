"""The kernel modules of :mod:`tpu3dssf_torch.kernels`, by name.

The package exports the functions ``flash_attention`` and
``window_attention``, as ``tpu3dssf.kernels`` does, and those names shadow
the submodules they come from: ``from tpu3dssf_torch.kernels import
flash_attention`` and ``import tpu3dssf_torch.kernels.flash_attention as
fa`` both give the function. Reach a module (its launch counters) through this
one::

    from tpu3dssf_torch.kernels.modules import flash_attention as fa
    fa.LAUNCHES

Each name is looked up when it is first asked for, so the kernel modules
may use this one too.

:data:`COUNTERS` is the one list of the launch counters, by the kernel
each counts, with the name each kernel module gives its counter: the nine
TPU kernels (K1–K9; ``fa.LAUNCHES`` reads K1), then the port's LayerNorm,
which replaces no TPU kernel (LN, read as ``layer_norm.LAUNCHES``, and its
gradient LNB, ``layer_norm.BWD_LAUNCHES``). The counts live in the CUDA
library (``csrc/ops_cuda.cpp``, in this order), whose ops' CUDA kernels add
a launch where they launch, wherever that library is loaded (``ops`` loads
it at import where a card is present); elsewhere, where nothing launches,
they are Python integers here. :func:`launch_counts` reads them,
:func:`set_launch_counts` writes them (the CUDA-graph wrapper of
:mod:`tpu3dssf_torch.train.graph` puts them back after a capture and adds a
capture's counts on every replay).
"""

from __future__ import annotations

import importlib

import torch

_MODULES = ("flash_attention", "window_attention", "knn", "layer_norm")
__all__ = list(_MODULES)

# kernel -> (module, name of its launch counter)
COUNTERS = {
    "K1": ("flash_attention", "LAUNCHES"),
    "K2": ("flash_attention", "LSE_LAUNCHES"),
    "K3": ("flash_attention", "BWD_LAUNCHES"),
    "K4": ("window_attention", "LSE_LAUNCHES"),
    "K5": ("window_attention", "BWD_LAUNCHES"),
    "K6": ("window_attention", "LAUNCHES"),
    "K7": ("knn", "LAUNCHES"),
    "K8": ("flash_attention", "FLASH_LAUNCHES"),
    "K9": ("flash_attention", "FLASH_BWD_LAUNCHES"),
    "LN": ("layer_norm", "LAUNCHES"),
    "LNB": ("layer_norm", "BWD_LAUNCHES"),
}


def __getattr__(name):
    if name in _MODULES:
        return importlib.import_module(f"tpu3dssf_torch.kernels.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# the counts where the CUDA library is not loaded
_COUNTS = dict.fromkeys(COUNTERS, 0)


def _in_cuda_library() -> bool:
    from tpu3dssf_torch.kernels import _build
    return _build.cuda_library_loaded()


def launch_counts() -> dict:
    """{"K1": launches, ..., "K9": launches, "LN": ..., "LNB": ...} made in
    this process."""
    if _in_cuda_library():
        return dict(zip(COUNTERS, torch.ops.tpu3dssf_cuda.launch_counts()))
    return dict(_COUNTS)


def set_launch_counts(counts: dict):
    """Set the counters named in ``counts`` ({"K1": n, ..., "LN": n})."""
    now = launch_counts()
    for k, n in counts.items():
        if k not in COUNTERS:
            raise KeyError(k)
        now[k] = int(n)
    if _in_cuda_library():
        torch.ops.tpu3dssf_cuda.set_launch_counts([now[k] for k in COUNTERS])
    else:
        _COUNTS.update(now)


def counter(module: str, name: str) -> int:
    """The count that kernel module ``module`` calls ``name`` (its
    ``__getattr__``: ``fa.LAUNCHES`` is K1's)."""
    for k, where in COUNTERS.items():
        if where == (module, name):
            return launch_counts()[k]
    raise AttributeError(f"module 'tpu3dssf_torch.kernels.{module}' has no "
                         f"attribute {name!r}")


def counter_names(module: str) -> list:
    """The counters' names in kernel module ``module``."""
    return [name for m, name in COUNTERS.values() if m == module]
