"""Serialized-window attention for PTv3.

Port of ``tpu3dssf.kernels.window_attention``: ``window_attention_packed``
with its custom VJP (:class:`WindowAttentionPacked`, the training rule of
the C ∈ {32, 64} stages) and the plain ``window_attention_reference``.
Windows are batch rows of a full MHA, so the packed attention kernels serve
every PTv3 stage, whatever its (C, heads): the inference forward is K1, and
the training rule launches the forward-with-LSE and backward kernels of
:mod:`tpu3dssf_torch.kernels.flash_attention`, counted here as the TPU
kernels they replace, K4 ``_attn_kernel_lse`` (:data:`LSE_LAUNCHES`) and
K5 ``_attn_bwd_kernel`` (:data:`BWD_LAUNCHES`). The TPU version's separate
(W, K, H, D) window kernels and its whole-3C and head-group layouts were
Mosaic block rules.
"""

from __future__ import annotations

import torch

from tpu3dssf_torch.kernels import flash_attention as fa

_NEG = -1e9

# kernel launches made by WindowAttentionPacked in this process: K4 and K5
LSE_LAUNCHES = 0
BWD_LAUNCHES = 0


def window_attention_reference(q, k, v, key_mask):
    """Plain within-window MHA.

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
    return out * key_mask[..., None].to(out.dtype)


class WindowAttentionPacked(torch.autograd.Function):
    """The training rule of :func:`window_attention_packed` (port of
    ``_wap_fwd``/``_wap_bwd``).

    Forward: the LSE kernel (K4), then the masked query rows are zeroed;
    (qkv, bias, mask, lse, zeroed out) are saved. Backward: the incoming
    gradient is masked on the query side, delta = rowsum(g·out) per head is
    taken in plain torch, and the backward kernel (K5) returns dqkv.
    """

    @staticmethod
    def forward(ctx, qkv, key_mask, heads):
        global LSE_LAUNCHES
        D = (qkv.shape[-1] // 3) // heads
        scale = 1.0 / (D ** 0.5)
        bias = key_bias(key_mask)
        if qkv.device.type == "cpu":
            out, lse = fa.flash_attention_packed_lse_reference(
                qkv, bias, heads, scale)
        else:
            out, lse = fa._launch_lse(qkv, bias, heads, scale)
            LSE_LAUNCHES += 1
        out = out * key_mask[..., None].to(out.dtype)
        ctx.save_for_backward(qkv, bias, key_mask, lse, out)
        ctx.heads, ctx.scale = heads, scale
        return out

    @staticmethod
    def backward(ctx, g):
        global BWD_LAUNCHES
        qkv, bias, key_mask, lse, out = ctx.saved_tensors
        g = g * key_mask[..., None].to(g.dtype)
        delta = fa.row_delta(g, out, ctx.heads)
        if qkv.device.type == "cpu":
            dqkv = fa.flash_attention_packed_bwd_reference(
                qkv, bias, g, lse, delta, ctx.heads, ctx.scale)
        else:
            dqkv = fa._launch_bwd(qkv, bias, g, lse, delta, ctx.heads,
                                  ctx.scale)
            BWD_LAUNCHES += 1
        return dqkv, None, None
