"""The kernel modules of :mod:`tpu3dssf_torch.kernels`, by name.

The package exports the functions ``flash_attention`` and
``window_attention``, as ``tpu3dssf.kernels`` does, and those names shadow
the submodules they come from: ``from tpu3dssf_torch.kernels import
flash_attention`` and ``import tpu3dssf_torch.kernels.flash_attention as
fa`` both give the function. Reach a module (its launch counters, its
launchers) through this one::

    from tpu3dssf_torch.kernels.modules import flash_attention as fa
    fa.LAUNCHES

Each name is looked up when it is first asked for, so the kernel modules
may use this one too.

:data:`COUNTERS` is the one list of the launch counters, by the TPU kernel
each counts (K1–K9): :func:`count` adds a launch (the ops of
:mod:`tpu3dssf_torch.kernels.ops` call it), :func:`launch_counts` reads
them and :func:`set_launch_counts` writes them (the CUDA-graph wrapper of
:mod:`tpu3dssf_torch.train.graph` puts them back after a capture and adds a
capture's counts on every replay).
"""

from __future__ import annotations

import importlib

_MODULES = ("flash_attention", "window_attention", "knn")
__all__ = list(_MODULES)

# TPU kernel -> (module, name of its launch counter)
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
}


def __getattr__(name):
    if name in _MODULES:
        return importlib.import_module(f"tpu3dssf_torch.kernels.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def launch_counts() -> dict:
    """{"K1": launches, ..., "K9": launches} made in this process."""
    return {k: getattr(__getattr__(m), name)
            for k, (m, name) in COUNTERS.items()}


def count(kernel: str):
    """Add one launch to the counter of ``kernel`` ("K1" ... "K9"): the
    ops of :mod:`tpu3dssf_torch.kernels.ops` call it where their CUDA
    kernels launch."""
    m, name = COUNTERS[kernel]
    module = __getattr__(m)
    setattr(module, name, getattr(module, name) + 1)


def set_launch_counts(counts: dict):
    """Set the counters named in ``counts`` ({"K1": n, ...})."""
    for k, n in counts.items():
        m, name = COUNTERS[k]
        setattr(__getattr__(m), name, n)
