"""Sorting / permutation helpers for serialized point sets.

Port of ``tpu3dssf.serialization.partition``. The JAX package sorts two
signed int32 keys with ``lax.sort(num_keys=2)``; here both go into one
int64 key, ``(hi << 32) + (lo + 2^31)``, whose order is exactly the signed
lexicographic order of (hi, lo), and ``torch.sort(stable=True)`` sorts it.
Permutations are int64 (torch's index dtype).
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
