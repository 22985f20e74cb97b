"""Serialized-window attention for PTv3.

Port of ``tpu3dssf.kernels.window_attention``: ``window_attention`` on
(W, K, H, D) windows, whose custom VJP is the (B, N, H, D) rule
:class:`~tpu3dssf_torch.kernels.flash_attention.FlashAttention` with a
query mask; ``window_attention_packed`` on the (W, K, 3C) projection with
its custom VJP (:class:`WindowAttentionPacked`, the training rule of the
C ∈ {32, 64} stages at a window that is a multiple of 128); and the plain
``window_attention_reference``. Windows are batch rows of a full MHA, so
both launch the strided attention kernels of
:mod:`tpu3dssf_torch.kernels.flash_attention` through the ops of
:mod:`tpu3dssf_torch.kernels.ops`, counted here as the TPU kernels they
replace:

* K6 ``_attn_kernel``, the inference forward of :func:`window_attention`
  (:data:`LAUNCHES`);
* K4 ``_attn_kernel_lse``, the training forward of both rules
  (:data:`LSE_LAUNCHES`);
* K5 ``_attn_bwd_kernel``, the backward of both rules
  (:data:`BWD_LAUNCHES`).

The inference forward of :func:`window_attention_packed` is K1, as in JAX.
The (W, K, H, D) route takes q, k, v as the strided views PTv3 cuts from
its projection: nothing is transposed or copied before the kernels. Its
backward returns dq, dk and dv as three tensors, which autograd scatters
into the projection's gradient (a zero fill and copy of the (W, K, 3C)
buffer per block; the packed rule writes dqkv in place).
"""

from __future__ import annotations

import torch

from tpu3dssf_torch.kernels import modules
from tpu3dssf_torch.kernels.modules import flash_attention as fa

_NEG = -1e9


def __getattr__(name):
    """The launch counters: ``LAUNCHES`` (K6, by window_attention),
    ``LSE_LAUNCHES`` and ``BWD_LAUNCHES`` (K4 and K5, by the training rules
    of both window routes)."""
    return modules.counter("window_attention", name)


def __dir__():
    return sorted([*globals(), *modules.counter_names("window_attention")])


def window_attention_reference(q, k, v, key_mask):
    """Plain within-window MHA: the plain version of K6.

    Args:
      q, k, v: (W, K, H, D) — windows, window size, heads, head dim.
      key_mask: (W, K) bool — True for live (non-padding) slots.

    Returns:
      (W, K, H, D) in q.dtype; outputs at masked query slots are zero.
    """
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("wqhd,wkhd->whqk", q.float(), k.float()) * scale
    bias = torch.where(key_mask, 0.0, _NEG)[:, None, None, :]
    probs = torch.softmax(s + bias, dim=-1)
    out = torch.einsum("whqk,wkhd->wqhd", probs, v.float())
    out = out * key_mask[:, :, None, None]
    return out.to(q.dtype)


def key_bias(key_mask):
    """(W, K) bool → the kernels' (W, 1, K) f32 additive key bias."""
    return torch.where(key_mask, 0.0, _NEG).to(torch.float32)[:, None, :] \
        .contiguous()


def _query_mask(key_mask, x):
    """``key_mask`` broadcast over x's trailing dims, in x's dtype."""
    return key_mask.reshape(key_mask.shape + (1,) * (x.dim() - 2)).to(x.dtype)


def window_attention(q, k, v, key_mask):
    """Windowed MHA on (W, K, H, D) windows → (W, K, H, D).

    Port of JAX's ``window_attention`` with ``use_pallas=True``: the route
    PTv3 takes when its window is not a multiple of 128, or when a stage
    with more than 8 heads has no 128-aligned head group. ``key_mask``
    (W, K) bool masks padding keys with a −1e9 bias; masked query rows come
    back zeroed (the contract of :func:`window_attention_reference`).

    When autograd needs a gradient of q, k or v this is
    :class:`~tpu3dssf_torch.kernels.flash_attention.FlashAttention` with the
    query mask, counted as K4 forward and K5 backward; otherwise the op
    ``tpu3dssf::attention`` as K6: the kernel on a CUDA tensor (then the
    query mask) and the plain version on a CPU tensor. On a CUDA tensor q,
    k and v follow :func:`flash_attention`'s contract (bf16, D in {16, 64},
    strided views allowed); anything else raises.
    """
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return fa.FlashAttention.apply(q, k, v, key_bias(key_mask),
                                       _query_mask(key_mask, q), ("K4", "K5"))
    return torch.ops.tpu3dssf.attention(q, k, v, key_bias(key_mask),
                                        key_mask, "K6")


def window_attention_packed(qkv, key_mask, heads):
    """Windowed MHA in the packed layout: (W, K, 3C) → (W, K, C).

    ``key_mask`` (W, K) bool masks padding keys with a −1e9 bias; masked
    query rows come back zeroed (same contract as
    :func:`window_attention_reference`). When autograd needs a gradient of
    ``qkv`` this is :class:`WindowAttentionPacked`; otherwise K1.
    """
    if torch.is_grad_enabled() and qkv.requires_grad:
        return WindowAttentionPacked.apply(qkv, key_mask, heads)
    D = (qkv.shape[-1] // 3) // heads
    out = fa.flash_attention_packed(qkv, key_bias(key_mask), heads,
                                    1.0 / (D ** 0.5))
    return out * _query_mask(key_mask, out)


class WindowAttentionPacked(torch.autograd.Function):
    """The training rule of :func:`window_attention_packed` (port of
    ``_wap_fwd``/``_wap_bwd``).

    Forward: the LSE kernel (the op ``tpu3dssf::packed_attention_lse`` as
    K4), then the masked query rows are zeroed; (qkv, bias, mask, lse,
    zeroed out) are saved. Backward: the incoming gradient is masked on the
    query side, delta = rowsum(g·out) per head is taken in plain torch, and
    the backward kernel (``tpu3dssf::packed_attention_bwd`` as K5) returns
    dqkv.
    """

    @staticmethod
    def forward(ctx, qkv, key_mask, heads):
        D = (qkv.shape[-1] // 3) // heads
        scale = 1.0 / (D ** 0.5)
        bias = key_bias(key_mask)
        out, lse = torch.ops.tpu3dssf.packed_attention_lse(
            qkv, bias, heads, scale, None, None, "K4")
        out = out * _query_mask(key_mask, out)
        ctx.save_for_backward(qkv, bias, key_mask, lse, out)
        ctx.heads, ctx.scale = heads, scale
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, bias, key_mask, lse, out = ctx.saved_tensors
        g = g * _query_mask(key_mask, g)
        delta = fa.row_delta(g, out, ctx.heads)
        dqkv = torch.ops.tpu3dssf.packed_attention_bwd(
            qkv, bias, g, lse, delta, ctx.heads, ctx.scale, "K5")
        return dqkv, None, None
