"""The port's CUDA kernels as ``torch.library`` custom ops: ``tpu3dssf::*``.

Seven ops carry the nine TPU kernels (K1–K9). Where two TPU kernels share
a launcher, the op takes the one it counts as its ``kernel`` argument
(op: launcher, TPU kernels):

* ``tpu3dssf::packed_attention``: ``flash_attention._launch``, K1;
* ``tpu3dssf::packed_attention_lse``: ``_launch_lse``, K1 (its RoPE
  branch), K2 or K4;
* ``tpu3dssf::packed_attention_bwd``: ``_launch_bwd``, K3 or K5;
* ``tpu3dssf::attention``: ``_launch_flash``, K6 or K8;
* ``tpu3dssf::attention_lse``: ``_launch_flash(with_lse=True)``, K4 or K8;
* ``tpu3dssf::attention_bwd``: ``_launch_flash_bwd``, K5 or K9;
* ``tpu3dssf::knn``: ``knn._launch``, K7.

Each op has three kernels, and the dispatcher picks one by the device of
its tensors:

* CUDA: the launcher (a ctypes call into the library that nvcc builds from
  ``csrc/`` at first use), then one step to the launch counter of the TPU
  kernel it serves (:func:`tpu3dssf_torch.kernels.modules.count`). The
  count is made here, so a program that ``torch.export`` saved and
  :func:`tpu3dssf_torch.export.load_exported` loaded counts its launches
  as eager code does. The launchers check the kernels' contract, data
  pointers' alignment included, and raise on a breach or a failed build or
  launch; nothing falls back to the plain version.
* CPU: the plain PyTorch version (the wrappers' CPU results are its
  results bit for bit); outputs are made contiguous, the layout the CUDA
  kernels give.
* fake (``register_fake``): shapes, dtypes and devices only, for tracers.
  On a CUDA tensor it raises what the launcher's data-free checks raise
  (dtype, shapes, strides, D ∈ {16, 64}, tables at D = 64 only).

Outputs never alias inputs. Importing :mod:`tpu3dssf_torch.kernels`
registers every op; that, and ``torch``, is all a loaded artifact needs.
The autograd rules (``FlashAttentionPacked``, ``FlashAttention``,
``WindowAttentionPacked``) stay ``torch.autograd.Function`` s around the
ops.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from tpu3dssf_torch.kernels import modules
from tpu3dssf_torch.kernels.modules import flash_attention as fa
from tpu3dssf_torch.kernels.modules import knn as knn_module
from tpu3dssf_torch.kernels.modules import window_attention as wa

# op -> the TPU kernels it may count as
KERNELS = {
    "packed_attention": ("K1",),
    "packed_attention_lse": ("K1", "K2", "K4"),
    "packed_attention_bwd": ("K3", "K5"),
    "attention": ("K6", "K8"),
    "attention_lse": ("K4", "K8"),
    "attention_bwd": ("K5", "K9"),
    "knn": ("K7",),
}
# the wrapper each (B, N, H, D) kernel serves, as the launchers name it in
# their errors
_CALLER = {"K4": "window_attention", "K5": "window_attention",
           "K6": "window_attention", "K8": "flash_attention",
           "K9": "flash_attention"}
_PACKED = "flash_attention_packed"


def _kernel(op, kernel):
    if kernel not in KERNELS[op]:
        raise ValueError(f"tpu3dssf::{op}: kernel must be one of "
                         f"{KERNELS[op]}, got {kernel!r}")


def _on_cuda(x):
    return x.device.type == "cuda"


def _contiguous(x):
    """A contiguous stand-in for ``x`` in a fake kernel, which checks the
    layout the launcher hands the kernel after its ``.contiguous()``."""
    return x.new_empty(x.shape)


def _heads_last(qkv, heads):
    B, N, C3 = qkv.shape
    return B, N, C3 // 3, heads


# --- K1: the packed inference forward -------------------------------------

@torch.library.custom_op("tpu3dssf::packed_attention", mutates_args=(),
                         device_types="cpu")
def packed_attention(qkv: Tensor, key_bias: Tensor, heads: int,
                     q_scale: Optional[float], rope_cos: Optional[Tensor],
                     rope_sin: Optional[Tensor]) -> Tensor:
    """MHA off the (B, N, 3C) projection → (B, N, C) in qkv's dtype: K1
    (with tables its RoPE branch); see
    :func:`~tpu3dssf_torch.kernels.flash_attention.flash_attention_packed`.
    """
    return fa.flash_attention_packed_reference(
        qkv, key_bias, heads, q_scale, rope_cos, rope_sin).contiguous()


@packed_attention.register_kernel("cuda")
def _(qkv, key_bias, heads, q_scale, rope_cos, rope_sin):
    out = fa._launch(qkv, key_bias, heads, q_scale, rope_cos, rope_sin)
    modules.count("K1")
    return out


def _packed_fake_check(qkv, key_bias, heads, rope_cos, rope_sin):
    if not _on_cuda(qkv):
        fa.check_packed(qkv, heads)
        return
    fa._check(qkv, heads)
    views = fa._split_heads(qkv, heads)
    fa.check_layout(_PACKED, views, key_bias)
    rope = fa.rope_pair(rope_cos, rope_sin)
    if rope is not None:
        fa.check_rope(_PACKED, views[0], rope)


@packed_attention.register_fake
def _(qkv, key_bias, heads, q_scale, rope_cos, rope_sin):
    _packed_fake_check(qkv, key_bias, heads, rope_cos, rope_sin)
    B, N, C, _ = _heads_last(qkv, heads)
    return qkv.new_empty((B, N, C))


# --- K2, K4 (and K1's RoPE branch): the packed forward with its LSE -------

def _lse_kernel(kernel, rope_cos):
    _kernel("packed_attention_lse", kernel)
    if (kernel == "K1") != (rope_cos is not None):
        raise ValueError("tpu3dssf::packed_attention_lse: K1 is the RoPE "
                         "branch (tables given); K2 and K4 take no tables")


@torch.library.custom_op("tpu3dssf::packed_attention_lse", mutates_args=(),
                         device_types="cpu")
def packed_attention_lse(qkv: Tensor, key_bias: Tensor, heads: int,
                         q_scale: Optional[float],
                         rope_cos: Optional[Tensor],
                         rope_sin: Optional[Tensor],
                         kernel: str) -> tuple[Tensor, Tensor]:
    """:func:`packed_attention` with its LSE: (out (B, N, C), lse (B, H, N)
    f32), the training forward; ``kernel`` K2 (C ≥ 128), K4 (the window
    route's C ∈ {32, 64}) or, with tables, K1."""
    _lse_kernel(kernel, rope_cos)
    out, lse = fa.flash_attention_packed_lse_reference(
        qkv, key_bias, heads, q_scale, rope_cos, rope_sin)
    return out.contiguous(), lse.contiguous()


@packed_attention_lse.register_kernel("cuda")
def _(qkv, key_bias, heads, q_scale, rope_cos, rope_sin, kernel):
    _lse_kernel(kernel, rope_cos)
    out, lse = fa._launch_lse(qkv, key_bias, heads, q_scale, rope_cos,
                              rope_sin)
    modules.count(kernel)
    return out, lse


@packed_attention_lse.register_fake
def _(qkv, key_bias, heads, q_scale, rope_cos, rope_sin, kernel):
    _lse_kernel(kernel, rope_cos)
    _packed_fake_check(qkv, key_bias, heads, rope_cos, rope_sin)
    B, N, C, H = _heads_last(qkv, heads)
    return (qkv.new_empty((B, N, C)),
            qkv.new_empty((B, H, N), dtype=torch.float32))


# --- K3, K5: the packed backward -------------------------------------------

@torch.library.custom_op("tpu3dssf::packed_attention_bwd", mutates_args=(),
                         device_types="cpu")
def packed_attention_bwd(qkv: Tensor, key_bias: Tensor, dout: Tensor,
                         lse: Tensor, delta: Tensor, heads: int,
                         q_scale: Optional[float], kernel: str) -> Tensor:
    """The stats-fed backward on the packed layout: dout (B, N, C), the
    forward's lse and delta = rowsum(dout·out) (B, H, N) f32 → dqkv
    (B, N, 3C) in qkv's dtype; ``kernel`` K3 or K5."""
    _kernel("packed_attention_bwd", kernel)
    return fa.flash_attention_packed_bwd_reference(
        qkv, key_bias, dout, lse, delta, heads, q_scale).contiguous()


@packed_attention_bwd.register_kernel("cuda")
def _(qkv, key_bias, dout, lse, delta, heads, q_scale, kernel):
    _kernel("packed_attention_bwd", kernel)
    dqkv = fa._launch_bwd(qkv, key_bias, dout, lse, delta, heads, q_scale)
    modules.count(kernel)
    return dqkv


@packed_attention_bwd.register_fake
def _(qkv, key_bias, dout, lse, delta, heads, q_scale, kernel):
    _kernel("packed_attention_bwd", kernel)
    if _on_cuda(qkv):
        fa._check(qkv, heads)
        views = fa._split_heads(qkv, heads)
        fa.check_layout(_PACKED, views + (
            _contiguous(dout).unflatten(-1, (heads, -1)),), key_bias)
        fa.check_stats(_PACKED, views[0], lse, delta)
    else:
        fa.check_packed(qkv, heads)
    return qkv.new_empty(qkv.shape)


# --- K6, K8: the (B, N, H, D) inference forward ----------------------------

def _attention_kernel(kernel, key_mask):
    _kernel("attention", kernel)
    if (kernel == "K6") != (key_mask is not None):
        raise ValueError("tpu3dssf::attention: K6 (the window route) takes "
                         "the key mask, K8 none")


@torch.library.custom_op("tpu3dssf::attention", mutates_args=(),
                         device_types="cpu")
def attention(q: Tensor, k: Tensor, v: Tensor, key_bias: Tensor,
              key_mask: Optional[Tensor], kernel: str) -> Tensor:
    """MHA on (B, N, H, D) q, k, v with the additive (B, 1, N) ``key_bias``
    and softmax scale 1/√D → (B, N, H, D) in q's dtype. ``kernel`` K8
    (:func:`~tpu3dssf_torch.kernels.flash_attention.flash_attention`), or
    K6 (:func:`~tpu3dssf_torch.kernels.window_attention.window_attention`),
    whose (W, K) bool ``key_mask`` is the bias's mask and zeroes the
    masked query rows of the output."""
    _attention_kernel(kernel, key_mask)
    if key_mask is None:
        out = fa.mha_reference(q, k, v, key_bias)
    else:
        out = wa.window_attention_reference(q, k, v, key_mask)
    return out.contiguous()


@attention.register_kernel("cuda")
def _(q, k, v, key_bias, key_mask, kernel):
    _attention_kernel(kernel, key_mask)
    out = fa._launch_flash(q, k, v, key_bias, fa._softmax_scale(q),
                           name=_CALLER[kernel])
    modules.count(kernel)
    if key_mask is not None:
        out = out * wa._query_mask(key_mask, out)
    return out


@attention.register_fake
def _(q, k, v, key_bias, key_mask, kernel):
    _attention_kernel(kernel, key_mask)
    if _on_cuda(q):
        fa.check_layout(_CALLER[kernel], (q, k, v), key_bias)
    return q.new_empty(q.shape)


# --- K4, K8: the (B, N, H, D) forward with its LSE (training) --------------

@torch.library.custom_op("tpu3dssf::attention_lse", mutates_args=(),
                         device_types="cpu")
def attention_lse(q: Tensor, k: Tensor, v: Tensor, key_bias: Tensor,
                  q_scale: float, kernel: str) -> tuple[Tensor, Tensor]:
    """The training forward on (B, N, H, D): (out in q's dtype, lse
    (B, H, N) f32), q scaled by ``q_scale``; ``kernel`` K8 or K4."""
    _kernel("attention_lse", kernel)
    out, lse = fa.flash_attention_lse_reference(q, k, v, key_bias, q_scale)
    return out.contiguous(), lse.contiguous()


@attention_lse.register_kernel("cuda")
def _(q, k, v, key_bias, q_scale, kernel):
    _kernel("attention_lse", kernel)
    out, lse = fa._launch_flash(q, k, v, key_bias, q_scale, with_lse=True,
                                name=_CALLER[kernel])
    modules.count(kernel)
    return out, lse


@attention_lse.register_fake
def _(q, k, v, key_bias, q_scale, kernel):
    _kernel("attention_lse", kernel)
    if _on_cuda(q):
        fa.check_layout(_CALLER[kernel], (q, k, v), key_bias)
    B, N, H, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((B, H, N), dtype=torch.float32)


# --- K5, K9: the (B, N, H, D) backward -------------------------------------

@torch.library.custom_op("tpu3dssf::attention_bwd", mutates_args=(),
                         device_types="cpu")
def attention_bwd(q: Tensor, k: Tensor, v: Tensor, key_bias: Tensor,
                  dout: Tensor, lse: Tensor, delta: Tensor, q_scale: float,
                  kernel: str) -> tuple[Tensor, Tensor, Tensor]:
    """The stats-fed backward on (B, N, H, D): (dq, dk, dv) in q's dtype;
    ``kernel`` K9 or K5."""
    _kernel("attention_bwd", kernel)
    return tuple(g.contiguous() for g in fa.flash_attention_bwd_reference(
        q, k, v, key_bias, dout, lse, delta, q_scale))


@attention_bwd.register_kernel("cuda")
def _(q, k, v, key_bias, dout, lse, delta, q_scale, kernel):
    _kernel("attention_bwd", kernel)
    grads = fa._launch_flash_bwd(q, k, v, key_bias, dout.contiguous(), lse,
                                 delta, q_scale, name=_CALLER[kernel])
    modules.count(kernel)
    return tuple(grads)


@attention_bwd.register_fake
def _(q, k, v, key_bias, dout, lse, delta, q_scale, kernel):
    _kernel("attention_bwd", kernel)
    if _on_cuda(q):
        name = _CALLER[kernel]
        fa.check_layout(name, (q, k, v, _contiguous(dout)), key_bias)
        fa.check_stats(name, q, lse, delta)
    return tuple(q.new_empty(q.shape) for _ in range(3))


# --- K7: k nearest neighbours ----------------------------------------------

@torch.library.custom_op("tpu3dssf::knn", mutates_args=(),
                         device_types="cpu")
def knn(queries: Tensor, refs: Tensor, ref_mask: Tensor,
        k: int) -> tuple[Tensor, Tensor]:
    """The k nearest valid refs of each query: (distances (B, Q, k) f32,
    indices (B, Q, k) int32); see
    :func:`~tpu3dssf_torch.kernels.knn.knn`."""
    dist, idx = knn_module.topk_neighbors_reference(queries, refs, ref_mask,
                                                    k)
    return dist.contiguous(), idx.contiguous()


@knn.register_kernel("cuda")
def _(queries, refs, ref_mask, k):
    out = knn_module._launch(queries, refs, ref_mask, k)
    modules.count("K7")
    return out


@knn.register_fake
def _(queries, refs, ref_mask, k):
    if _on_cuda(queries):
        knn_module.check_layout(queries, refs, ref_mask, k)
    B, Q, _ = queries.shape
    return (queries.new_empty((B, Q, k), dtype=torch.float32),
            queries.new_empty((B, Q, k), dtype=torch.int32))
