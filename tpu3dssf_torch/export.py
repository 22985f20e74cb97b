"""Deployment export: the inference step as a ``torch.export`` artifact.

Port of ``tpu3dssf.export``. A serving stack wants the model as one
self-contained artifact: weights inside, no Python model code at load
time. JAX serializes its jitted step to StableHLO; the port's counterpart
is ``torch.export``: the forward traced once (not strictly: plain Python
runs, the tensors are fakes) into a graph of ATen ops and the kernels'
``tpu3dssf::*`` custom ops (:mod:`tpu3dssf_torch.kernels.ops`), saved with
its weights as one ``.pt2`` archive.

    blob = export_infer_bytes(model, example_args)   # weights inside
    f = load_exported(blob)          # callable on the same shapes
    logits = f(*example_args)

The artifact runs where its example arguments lay: exported from CUDA
tensors it launches the Hopper kernels (the ops' CUDA kernels) and needs a
card; from CPU tensors it runs their plain versions. There is no
cross-export, so JAX's ``platforms`` argument has no counterpart.

Loading needs ``torch`` and :mod:`tpu3dssf_torch.kernels`, which registers
the ops (their CUDA kernels build the libraries from ``csrc/`` with nvcc
at first use); it needs no model code (no ``tpu3dssf_torch.models``,
``.voxel`` or ``.serialization``).

CLI: ``python -m tpu3dssf_torch.cli.export_model --config <yaml> --out
model.pt2``.
"""

from __future__ import annotations

import io
from typing import Callable, Sequence

import torch

import tpu3dssf_torch.kernels  # noqa: F401  (registers the tpu3dssf ops)


class _Apply(torch.nn.Module):
    """A function as the module ``torch.export`` takes; the tensors it
    closes over (a model's weights) travel as the program's constants."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_infer_bytes(apply_fn: Callable, example_args: Sequence) -> bytes:
    """``apply_fn(*example_args)`` under ``torch.no_grad()``, exported
    and serialized to bytes.

    ``apply_fn`` is an ``nn.Module`` (its parameters and buffers go into
    the artifact) or a function over one, such as the encode of
    :func:`tpu3dssf_torch.train.loop.make_image_encode_fn` (the tensors it
    closes over go in as constants). Shapes are static: the artifact
    takes arguments of the example's shapes, dtypes and device. The device
    of ``example_args`` is the artifact's platform (see the module
    docstring).
    """
    module = (apply_fn if isinstance(apply_fn, torch.nn.Module)
              else _Apply(apply_fn))
    with torch.no_grad():
        program = torch.export.export(module, tuple(example_args),
                                      strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_exported(blob: bytes) -> Callable:
    """Deserialize an artifact of :func:`export_infer_bytes`; returns a
    callable that runs it under ``torch.no_grad()`` on arguments of the
    example's shapes.

    On a CUDA artifact the callable is
    :func:`tpu3dssf_torch.train.graph.graphed`: its first call of a shape
    runs eagerly, every later one replays one CUDA graph, as JAX's
    ``exported.call`` runs one compiled program. A CPU artifact runs
    eagerly.
    """
    program = torch.export.load(io.BytesIO(blob))
    module = program.module()

    def call(*args):
        with torch.no_grad():
            return module(*args)

    if "cuda" not in {n.meta["val"].device.type
                      for n in program.graph.nodes if n.op == "placeholder"
                      and isinstance(n.meta.get("val"), torch.Tensor)}:
        return call
    from tpu3dssf_torch.train.graph import graphed
    return graphed(call, "exported")
