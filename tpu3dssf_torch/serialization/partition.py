"""Sorting / permutation helpers for serialized point sets.

Port of ``tpu3dssf.serialization.partition``. The JAX package sorts two
signed int32 keys with ``lax.sort(num_keys=2)``; here both go into one
int64 key, ``(hi << 32) + (lo + 2^31)``, whose order is exactly the signed
lexicographic order of (hi, lo), and ``torch.sort(stable=True)`` sorts it.
Permutations are int64 (torch's index dtype).

Sums over the rows that share an index are taken in a fixed order, so a
step gives the same bits every run, as XLA's scatter-add does on the TPU:
:func:`segment_sum` adds each run of a sorted segment index in position
order (``torch.segment_reduce``: one thread per output element, no
atomics), and :func:`gather_rows`, a many-to-one gather, scatters its
gradient back through it (where ``torch.gather``'s backward adds with
atomics on the card, in an order that changes from run to run).
"""

from __future__ import annotations

import torch

_INT32_MAX = 2 ** 31 - 1
# _lex_key of the invalid sentinel (INT32_MAX, INT32_MAX): 2^63 - 1
_INVALID_KEY = (_INT32_MAX << 32) + _INT32_MAX + 2 ** 31


def _lex_key(hi, lo):
    """One int64 key ordering like the signed int32 pair (hi, lo)."""
    return (hi.to(torch.int64) << 32) + (lo.to(torch.int64) + 2 ** 31)


def argsort_lex(hi, lo, valid=None):
    """Stable argsort along the last axis by the int32 key ``(hi, lo)``.

    Invalid entries (``valid`` False) get the key (INT32_MAX, INT32_MAX),
    the largest there is, and sort to the end. Returns ``perm`` (int64)
    such that ``x[..., perm]`` is sorted.
    """
    key = _lex_key(hi, lo)
    if valid is not None:
        key = torch.where(valid, key, _INVALID_KEY)
    return torch.sort(key, dim=-1, stable=True).indices


def inverse_permutation(perm):
    """Inverse along the last axis: inv[..., perm[..., i]] = i."""
    ar = torch.arange(perm.shape[-1], device=perm.device).expand_as(perm)
    return torch.empty_like(perm).scatter_(-1, perm, ar)


def _gather_rows(x, idx):
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


class _PermutationGather(torch.autograd.Function):
    """Gather by a permutation whose backward gathers by its inverse (the
    JAX custom VJP): no scatter-add."""

    @staticmethod
    def forward(ctx, x, perm, inv):
        ctx.save_for_backward(inv)
        return _gather_rows(x, perm)

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        return _gather_rows(g, inv), None, None


def permutation_gather(x, perm, inv):
    """``x[b, perm[b, t]]`` for x (B, N, C) and perm (B, N).

    ``inv`` (B, N) must be the inverse of ``perm``: a permutation's
    transpose is the inverse gather, so the backward gathers the incoming
    gradient with ``inv`` instead of scatter-adding it (port of the JAX
    custom VJP). Without a gradient this is one gather.
    """
    if torch.is_grad_enabled() and x.requires_grad:
        return _PermutationGather.apply(x, perm, inv)
    return _gather_rows(x, perm)


def segment_sum(values, seg, num_segments: int):
    """``out[b, s] = sum(values[b, i] for i with seg[b, i] == s)``, each sum
    in the order of ``i``.

    values (B, N, C); seg (B, N) int32 or int64, nondecreasing along N, so
    that each segment is one run; rows with ``seg >= num_segments`` are
    left out.
    Returns (B, num_segments, C) in ``values.dtype`` (0 for an empty
    segment). No atomics and no host value: the same bits on every run,
    and a CUDA graph can capture it.
    """
    B = seg.shape[0]
    bounds = torch.arange(num_segments + 1, dtype=seg.dtype,
                          device=seg.device).expand(B, -1).contiguous()
    offsets = torch.searchsorted(seg.contiguous(), bounds)
    return torch.segment_reduce(values.contiguous(), "sum", offsets=offsets,
                                axis=1, unsafe=True, initial=0)


class _GatherRows(torch.autograd.Function):
    """``x[b, idx[b, i]]``, many rows of the output from one of ``x``; the
    backward sums each row's gradients in f32, in the order of ``i``
    (a stable sort of ``idx``, then :func:`segment_sum`), leaving out the
    ``i`` whose ``valid`` is False."""

    @staticmethod
    def forward(ctx, x, idx, valid):
        ctx.save_for_backward(idx, valid)
        ctx.rows, ctx.dtype = x.shape[1], x.dtype
        return _gather_rows(x, idx)

    @staticmethod
    def backward(ctx, g):
        idx, valid = ctx.saved_tensors
        # the left-out rows go to segment `rows`, past the sum; int32 keys
        # take half the radix passes of int64
        keys = torch.where(valid, idx, ctx.rows).to(torch.int32)
        keys, order = torch.sort(keys, dim=1, stable=True)
        g = _gather_rows(g.float(), order)
        return segment_sum(g, keys, ctx.rows).to(ctx.dtype), None, None


def gather_rows(x, idx, valid):
    """``x[b, idx[b, i]]`` for x (B, N, C) and idx (B, M) int64, where many
    ``i`` may share a row: the unpooling's parents, a point's voxel. The
    gradient of a row is the sum of its gathers' gradients taken in a fixed
    order (:class:`_GatherRows`). ``valid`` (B, M) marks the ``i`` whose
    gradient may be nonzero: the caller zeroes the others (padding points,
    empty cells, which all read one clamped row), and the backward leaves
    them out, so that no one row sums a run as long as the padding.
    Without a gradient this is one gather."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherRows.apply(x, idx, valid)
    return _gather_rows(x, idx)
