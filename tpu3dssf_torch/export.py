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

Loading needs ``torch`` and :mod:`tpu3dssf_torch.kernels`, which loads the
ops' C++ libraries (built from ``csrc/`` at first use: the schemas with the
host compiler, and where a card is present the CUDA kernels with nvcc); it
needs no model code (no ``tpu3dssf_torch.models``, ``.voxel`` or
``.serialization``).

JAX's artifact is also served from C++ through the PJRT C API. The port's
counterpart is an AOTInductor package of the same program
(:func:`compile_infer_package`): Inductor compiles the ATen part of the
graph into kernels and a C++ wrapper, and keeps every ``tpu3dssf::`` op as
a call through the dispatcher to its C++ kernel. Python loads one with
:func:`load_package`; a process without Python loads it with
``torch::inductor::AOTIModelPackageLoader`` (``csrc/aoti_runner.cpp``,
which reads inputs written by :func:`write_raw` and writes outputs that
:func:`read_raw` reads), after it has loaded the op libraries
(``kernels._build.loaded_libraries()``).

CLI: ``python -m tpu3dssf_torch.cli.export_model --config <yaml> --out
model.pt2 [--package]``.
"""

from __future__ import annotations

import contextlib
import inspect
import io
from pathlib import Path
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


def export_program(apply_fn: Callable,
                   example_args: Sequence) -> torch.export.ExportedProgram:
    """``apply_fn(*example_args)`` under ``torch.no_grad()``, exported (see
    :func:`export_infer_bytes`)."""
    module = (apply_fn if isinstance(apply_fn, torch.nn.Module)
              else _Apply(apply_fn))
    with torch.no_grad():
        return torch.export.export(module, tuple(example_args), strict=False)


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
    buf = io.BytesIO()
    torch.export.save(export_program(apply_fn, example_args), buf)
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


def compile_infer_package(apply_fn, example_args: Sequence, path) -> str:
    """The program that :func:`export_infer_bytes` saves, compiled by
    AOTInductor into a package at ``path`` (weights inside); returns its
    path. ``apply_fn`` is what :func:`export_infer_bytes` takes, or an
    ``ExportedProgram`` (such as ``torch.export.load`` of an artifact),
    which is compiled as it is. The package runs on the example's device
    and shapes: on CUDA tensors its ``tpu3dssf::`` ops launch the Hopper
    kernels, and Inductor's own kernels are Triton's. The host compiler is
    ``kernels._build.find_cxx()``'s, one that links OpenMP."""
    from tpu3dssf_torch.kernels import _build
    program = (apply_fn if isinstance(apply_fn, torch.export.ExportedProgram)
               else export_program(apply_fn, example_args))
    with torch.no_grad(), _triton_block_shape_fixed():
        return torch._inductor.aoti_compile_and_package(
            program, package_path=str(path),
            inductor_configs={"cpp.cxx": (_build.find_cxx(),)})


# the first torch whose Inductor has the fix of _triton_block_shape_fixed
_BLOCK_SHAPE_FIXED_IN = "2.13"


@contextlib.contextmanager
def _triton_block_shape_fixed():
    """While it is entered, give Inductor's Triton code generator the fix
    that torch 2.13 made to ``TritonSymbols.get_block_shape``: a range tree
    without a tensor dimension gives a scalar shape. Without it (torch
    2.11) the PTv3 programs fail to compile, on an index of such a tree
    ("list indices must be integers or slices, not NoneType"). Applied
    only where torch is older than 2.13, and the original is put back on
    leaving, so no other compile in the process runs the patched code."""
    from torch.torch_version import TorchVersion
    try:
        from torch._inductor.codegen import triton as tr
    except ImportError:      # no Triton: no Triton code generator to fix
        tr = None
    if tr is None or TorchVersion(torch.__version__) >= _BLOCK_SHAPE_FIXED_IN:
        yield
        return
    original = inspect.getattr_static(tr.TritonSymbols, "get_block_shape")
    g = original.__func__.__globals__
    V, SymT, is_type = g["V"], g["SymT"], g["symbol_is_type"]
    scalar_types = (SymT.UNBACKED_INT, SymT.SIZE, SymT.PRECOMPUTED_SIZE,
                    SymT.INDEX, SymT.FLOAT, SymT.UNBACKED_FLOAT)

    def get_block_shape(cls, expr):
        shape = ()
        for var in expr.free_symbols:
            if is_type(var, SymT.TMP):
                var_shape = V.kernel.cse.varname_map[var.name].shape
            elif is_type(var, scalar_types):
                var_shape = ()
            else:
                [sym] = [t for t in cls.block_types if is_type(var, t)]
                [tree] = [t for t in V.kernel.active_range_trees()
                          if g["prefix_str"][sym] == t.prefix]
                if tree.tensor_dim is None:     # the fix
                    var_shape = ()
                else:
                    dims = ["1"] * V.kernel.triton_tensor_ndim()
                    dims[tree.tensor_dim] = str(cls.get_block_size(tree))
                    var_shape = tuple(dims)
            shape = g["get_broadcasted_shape"](shape, var_shape)
        return shape

    tr.TritonSymbols.get_block_shape = classmethod(get_block_shape)
    try:
        yield
    finally:
        tr.TritonSymbols.get_block_shape = original


def load_package(path) -> Callable:
    """Load a package of :func:`compile_infer_package`; returns a callable
    on arguments of the example's shapes (no CUDA graph: the package is one
    compiled program, as a loaded JAX artifact is). Needs ``torch`` and
    :mod:`tpu3dssf_torch.kernels`, no model code."""
    runner = torch._inductor.aoti_load_package(str(path))

    def call(*args):
        with torch.no_grad():
            return runner(*args)

    return call


def package_ops(path) -> list:
    """The ops that a package of :func:`compile_infer_package` calls
    through the dispatcher (the extern nodes Inductor kept), in order:
    every ``tpu3dssf::`` op of the program is one."""
    import json
    import zipfile
    with zipfile.ZipFile(path) as z:
        name = next(n for n in z.namelist() if n.endswith("wrapper.json"))
        return [n["node"]["target"] for n in json.loads(z.read(name))["nodes"]]


# ---- raw tensor files, which aoti_runner reads and writes -----------------
# One tensor a file: a text line "tpu3dssf-raw <dtype> <ndim> <sizes...>",
# then the contiguous data in the machine's byte order.
RAW_MAGIC = "tpu3dssf-raw"
RAW_DTYPES = {"float32": torch.float32, "float64": torch.float64,
              "float16": torch.float16, "bfloat16": torch.bfloat16,
              "int64": torch.int64, "int32": torch.int32,
              "int16": torch.int16, "int8": torch.int8,
              "uint8": torch.uint8, "bool": torch.bool}


def write_raw(path, x: torch.Tensor):
    """Write ``x`` (any device) as a raw tensor file."""
    name = next(k for k, v in RAW_DTYPES.items() if v == x.dtype)
    x = x.detach().cpu().contiguous()
    header = " ".join([RAW_MAGIC, name, str(x.dim()), *map(str, x.shape)])
    with open(path, "wb") as f:
        f.write(header.encode() + b"\n")
        f.write(x.reshape(-1).view(torch.uint8).numpy().tobytes())


def read_raw(path) -> torch.Tensor:
    """A raw tensor file as a CPU tensor."""
    data = Path(path).read_bytes()
    line, body = data.split(b"\n", 1)
    magic, name, ndim, *sizes = line.decode().split()
    if magic != RAW_MAGIC or len(sizes) != int(ndim):
        raise ValueError(f"{path}: not a raw tensor file ({line[:80]!r})")
    flat = (torch.frombuffer(bytearray(body), dtype=torch.uint8) if body
            else torch.empty(0, dtype=torch.uint8))
    return flat.view(RAW_DTYPES[name]).reshape([int(n) for n in sizes])


def write_inputs(directory, args: Sequence):
    """``args`` as ``input_<i>.raw`` files under ``directory``, the inputs
    of ``aoti_runner``."""
    Path(directory).mkdir(parents=True, exist_ok=True)
    for i, x in enumerate(args):
        write_raw(Path(directory) / f"input_{i}.raw", x)


def read_outputs(directory) -> list:
    """The ``output_<i>.raw`` files that ``aoti_runner`` wrote, in order."""
    out, i = [], 0
    while (Path(directory) / f"output_{i}.raw").exists():
        out.append(read_raw(Path(directory) / f"output_{i}.raw"))
        i += 1
    return out
