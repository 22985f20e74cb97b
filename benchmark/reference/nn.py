"""The reference's layers: float32 products with no TF32, the lower
precision that serves as the benchmark's control, and the configurations'
own precision.

Every product of the reference goes through :func:`matmul_inputs`, which
returns its operands unchanged, or rounded: inside
:func:`lower_precision` to float8 e4m3 with one scale per row (the nearest
precision below the configurations' bfloat16), inside
:func:`stated_precision` to bfloat16. There :func:`stored` also rounds
what a dense layer, a LayerNorm and an attention give, where the program
stores its activations in bfloat16. Each rounding is also one in the
backward: the gradient that flows back through it is rounded the same way
(float8 with scales of its own, a row each, as a float8 training step
casts its gradients). The reference is plain PyTorch: it imports nothing
of the program.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

_E4M3_MAX = 448.0


class _Precision:
    """How the reference rounds its operands and stored activations: not
    at all (None), or by one of the functions below (one setting per
    process: the reference runs after the program's window)."""

    round = None


def _round_rows(x):
    """``x`` rounded to float8 e4m3 with one scale per row of the last
    dimension, returned in float32."""
    x = x.float()
    scale = x.abs().amax(-1, keepdim=True).clamp_min(1e-30) / _E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _round_bf16(x):
    """``x`` rounded to bfloat16, returned in float32."""
    return x.float().to(torch.bfloat16).float()


class _Rounded(torch.autograd.Function):
    """A rounding forward, and the same rounding of the incoming gradient
    backward (float8: with the gradient's own scales)."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.fn(grad), None


def _rounded(x):
    return _Rounded.apply(x, _Precision.round)


def matmul_inputs(*xs):
    """The operands of one product, as the current precision takes them."""
    if _Precision.round is not None:
        return tuple(_rounded(x) for x in xs)
    return tuple(x.float() for x in xs)


def stored(x):
    """An activation as the current precision stores it."""
    return _rounded(x) if _Precision.round is not None else x


@contextlib.contextmanager
def _precision(fn):
    _Precision.round = fn
    try:
        yield
    finally:
        _Precision.round = None


def lower_precision():
    """Run the reference's products on float8 e4m3 operands (the control
    that has to come out as not correct)."""
    return _precision(_round_rows)


def stated_precision():
    """Run the reference's products on bfloat16 operands, its activations
    stored in bfloat16: the configurations' own precision, whose rounding
    alone sets how far a sound program may depart from the float32
    reference."""
    return _precision(_round_bf16)


class Dense(nn.Linear):
    """``nn.Linear`` in float32 (or the control's precision)."""

    def forward(self, x):
        x, w = matmul_inputs(x, self.weight)
        return stored(F.linear(x, w, self.bias.float()))


class LayerNorm(nn.Module):
    def __init__(self, features, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return stored(F.layer_norm(x.float(), self.weight.shape,
                                   self.weight, self.bias, self.eps))


def attention(q, k, v, key_mask=None, scale=None):
    """softmax(q kᵀ · scale) v over (..., N, D) operands, keys where
    ``key_mask`` (..., N) is False left out; a row with no key gives 0."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    q, k = matmul_inputs(q * scale, k)
    s = q @ k.transpose(-1, -2)
    if key_mask is not None:
        s = s.masked_fill(~key_mask[..., None, :], float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)
    p, v = matmul_inputs(p, v.transpose(-1, -2))
    return stored(p @ v.transpose(-1, -2))


def gather_rows(x, idx):
    """``x[b, idx[b, i]]`` for x (B, N, C) and idx (B, M)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def argsort_lex(hi, lo, valid=None):
    """Stable argsort by the signed int32 pair (hi, lo); invalid entries
    last."""
    key = (hi.to(torch.int64) << 32) + (lo.to(torch.int64) + 2 ** 31)
    if valid is not None:
        key = torch.where(valid, key, torch.iinfo(torch.int64).max)
    return torch.sort(key, dim=-1, stable=True).indices


def inverse_permutation(perm):
    ar = torch.arange(perm.shape[-1], device=perm.device).expand_as(perm)
    return torch.empty_like(perm).scatter_(-1, perm, ar)


def segment_sum(values, seg, num_segments: int):
    """Per-segment sums of (B, N, C) values whose (B, N) segment ids are
    nondecreasing; ids ≥ ``num_segments`` are left out. Each sum runs in
    the order of N, so the voxel centroids are the same bits as any other
    in-order f32 sum."""
    B = seg.shape[0]
    bounds = torch.arange(num_segments + 1, dtype=seg.dtype,
                          device=seg.device).expand(B, -1).contiguous()
    offsets = torch.searchsorted(seg.contiguous(), bounds)
    return torch.segment_reduce(values.contiguous(), "sum", offsets=offsets,
                                axis=1, unsafe=True, initial=0)
