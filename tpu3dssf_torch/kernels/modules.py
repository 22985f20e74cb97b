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
"""

from __future__ import annotations

import importlib

_MODULES = ("flash_attention", "window_attention", "knn")
__all__ = list(_MODULES)


def __getattr__(name):
    if name in _MODULES:
        return importlib.import_module(f"tpu3dssf_torch.kernels.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
