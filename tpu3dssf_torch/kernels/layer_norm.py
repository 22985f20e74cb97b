"""LayerNorm over the last dimension as one kernel: the port's own, LN.

No TPU kernel stands behind it: the JAX package leaves flax's LayerNorm to
XLA, which fuses the statistics and the casts around them. The port ran it
as three kernels (the cast to f32, torch's LayerNorm, the cast back); the
op ``tpu3dssf::layer_norm`` (``csrc/layer_norm.cu``, launched by its C++
kernel in ``csrc/ops_cuda.cpp``) reads x in its own type and writes y in
it, with the statistics and the affine map in f32 and one rounding. Its
gradient is the op ``tpu3dssf::layer_norm_bwd``, whose dweight and dbias
are summed in an order fixed by the shape, without atomics.

Both take (rows, C) tensors: ``x`` contiguous, bf16 or f32; ``weight``,
``bias``, ``mean`` and ``rstd`` f32. On a CUDA tensor C is a multiple of 8
from 16 to 1024 and the data 16-byte aligned; anything else raises. A CPU
tensor takes the plain versions (:func:`layer_norm_reference`,
:func:`layer_norm_bwd_reference`), the arithmetic the port's LayerNorm ran
before the kernel, bit for bit. The launches read as ``LAUNCHES`` (LN) and
``BWD_LAUNCHES`` (LNB) here (:mod:`tpu3dssf_torch.kernels.modules`).
"""

from __future__ import annotations

import torch

from tpu3dssf_torch.kernels import modules

MIN_C = 16     # csrc/layer_norm.cu: 2 lanes x 8 elements
MAX_C = 1024   # csrc/layer_norm.cu: 32 lanes x 4 runs x 8 elements
DTYPES = (torch.bfloat16, torch.float32)


def __getattr__(name):
    """The launch counters of LN and LNB, by name."""
    return modules.counter("layer_norm", name)


def __dir__():
    return sorted([*globals(), *modules.counter_names("layer_norm")])


def layer_norm_reference(x, weight, bias, eps):
    """(y in x's dtype, mean (rows,) f32, rstd (rows,) f32) of a (rows, C)
    ``x``: ``F.layer_norm(x.float(), ...)`` rounded to x's dtype, the
    statistics those of the same f32 call."""
    y, mean, rstd = torch.native_layer_norm(x.float(), (x.shape[-1],),
                                            weight, bias, eps)
    return y.to(x.dtype), mean.reshape(-1), rstd.reshape(-1)


def layer_norm_bwd_reference(dy, x, weight, mean, rstd):
    """(dx in x's dtype, dweight f32, dbias f32): what autograd computes
    through :func:`layer_norm_reference` (dy to f32, torch's LayerNorm
    gradient, dx rounded to x's dtype)."""
    rows, C = x.shape
    dx, dw, db = torch.ops.aten.native_layer_norm_backward(
        dy.float(), x.float(), [C], mean.reshape(rows, 1),
        rstd.reshape(rows, 1), weight, torch.empty_like(weight),
        [True, True, True])
    return dx.to(x.dtype), dw, db


def check_layout(x, vectors):
    """The CUDA kernel's contract on shapes, dtypes, devices and layout of
    a CUDA ``x`` (not on alignment, which needs data), as
    ``csrc/ops_cuda.cpp`` words it: ``vectors`` are (name, tensor) pairs
    of the (C,) f32 inputs."""
    if x.dtype not in DTYPES:
        raise RuntimeError(f"layer_norm: x must be bfloat16 or float32, got "
                           f"{_dtype(x)}")
    if x.dim() != 2 or x.shape[1] % 8 or not MIN_C <= x.shape[1] <= MAX_C:
        raise RuntimeError(f"layer_norm: x must be (rows, C) with C a "
                           f"multiple of 8 from {MIN_C} to {MAX_C}, got "
                           f"{_shape(x.shape)}")
    if not x.is_contiguous():
        raise RuntimeError("layer_norm: x must be contiguous")
    C = x.shape[1]
    for name, v in vectors:
        if (v.device != x.device or v.dtype != torch.float32
                or tuple(v.shape) != (C,) or not v.is_contiguous()):
            raise RuntimeError(
                f"layer_norm: {name} must be a contiguous float32 "
                f"{_shape((C,))} tensor on {x.device}, got {_dtype(v)} "
                f"{_shape(v.shape)} on {v.device}")


def check_stats(dy, x, mean, rstd):
    """The backward's contract on dy, mean and rstd."""
    if (dy.device != x.device or dy.dtype != x.dtype
            or dy.shape != x.shape or not dy.is_contiguous()):
        raise RuntimeError(
            f"layer_norm backward: dy must be a contiguous {_dtype(x)} "
            f"{_shape(x.shape)} tensor on {x.device}, got {_dtype(dy)} "
            f"{_shape(dy.shape)} on {dy.device}")
    rows = x.shape[0]
    for name, v in (("mean", mean), ("rstd", rstd)):
        if (v.device != x.device or v.dtype != torch.float32
                or tuple(v.shape) != (rows,) or not v.is_contiguous()):
            raise RuntimeError(
                f"layer_norm backward: {name} must be a contiguous float32 "
                f"{_shape((rows,))} tensor on {x.device}, got {_dtype(v)} "
                f"{_shape(v.shape)} on {v.device}")


def _shape(s):
    """A shape as ``csrc/ops_cuda.cpp``'s ``shape`` prints it."""
    s = tuple(s)
    return "(" + ", ".join(map(str, s)) + ("," if len(s) == 1 else "") + ")"


def _dtype(x):
    """A dtype as c10 prints it (``BFloat16``, ``Float``)."""
    return {torch.bfloat16: "BFloat16", torch.float32: "Float",
            torch.float16: "Half", torch.float64: "Double"}.get(
                x.dtype, str(x.dtype))


def layer_norm(x, weight, bias, eps):
    """LayerNorm of a contiguous (rows, C) ``x`` over C → (rows, C) in x's
    dtype. When autograd needs a gradient this is
    :class:`LayerNormFunction`; otherwise the op ``tpu3dssf::layer_norm``
    (LN on a CUDA tensor, the plain version on a CPU tensor)."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return LayerNormFunction.apply(x, weight, bias, eps)
    return torch.ops.tpu3dssf.layer_norm(x, weight, bias, eps)[0]


class LayerNormFunction(torch.autograd.Function):
    """The training rule of :func:`layer_norm`: the forward saves x in its
    own dtype with the f32 mean and rstd, the backward runs
    ``tpu3dssf::layer_norm_bwd`` (LNB on a CUDA tensor)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        y, mean, rstd = torch.ops.tpu3dssf.layer_norm(x, weight, bias, eps)
        ctx.save_for_backward(x, weight, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, rstd = ctx.saved_tensors
        dx, dw, db = torch.ops.tpu3dssf.layer_norm_bwd(
            dy.to(x.dtype).contiguous(), x, weight, mean, rstd)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dw if need[1] else None,
                db if need[2] else None, None)
