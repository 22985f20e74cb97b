"""The port's CUDA kernels as PyTorch operators: ``tpu3dssf::*``.

Seven operators carry the nine TPU kernels (K1–K9), and two the port's own
LayerNorm kernels, which replace no TPU kernel. Where two TPU kernels share
an operator, it takes the one it counts as its ``kernel`` argument
(operator: kernels):

* ``tpu3dssf::packed_attention``: K1 (with tables its RoPE branch);
* ``tpu3dssf::packed_attention_lse``: K1 (its RoPE branch), K2 or K4;
* ``tpu3dssf::packed_attention_bwd``: K3 or K5;
* ``tpu3dssf::attention``: K6 or K8;
* ``tpu3dssf::attention_lse``: K4 or K8;
* ``tpu3dssf::attention_bwd``: K5 or K9;
* ``tpu3dssf::knn``: K7;
* ``tpu3dssf::layer_norm``: LN (:mod:`tpu3dssf_torch.kernels.layer_norm`);
* ``tpu3dssf::layer_norm_bwd``: LNB, its gradient.

They are defined once, in C++ (``csrc/ops_schema.cpp``, built with the host
compiler and loaded here before anything is registered on them). Each has
three kernels, and the dispatcher picks one by the device of its tensors:

* CUDA: C++ (``csrc/ops_cuda.cpp``, ``TORCH_LIBRARY_IMPL(tpu3dssf, CUDA,
  ...)``, in the library that nvcc and the host compiler build with the
  Hopper kernels; loaded here at import where a card is present). It
  checks the kernel's contract, data pointers' alignment included, and
  raises a ``RuntimeError`` on a breach; it takes outputs and scratch from
  PyTorch's allocator, launches on PyTorch's current stream, raises where
  the launch fails, and then adds one to the C++ counter of the kernel it
  served (:mod:`tpu3dssf_torch.kernels.modules` reads them). So a
  program that ``torch.export`` saved, or an AOTInductor package, counts
  its launches as eager code does, in a Python process or in one without
  Python (``csrc/aoti_runner.cpp``). Where the CUDA library fails to build,
  every CUDA kernel raises that failure: nothing falls back to the plain
  version.
* CPU (registered here): the plain PyTorch version (the wrappers' CPU
  results are its results bit for bit); outputs are made contiguous, the
  layout the CUDA kernels give.
* fake (``register_fake``, here): shapes, dtypes and devices only, for
  tracers. On a CUDA tensor it raises what the C++ kernel's data-free
  checks raise (dtype, shapes, strides, D ∈ {16, 64}, tables at D = 64
  only), as the wrappers' Python checks word them.

Outputs never alias inputs. Importing :mod:`tpu3dssf_torch.kernels`
registers every op; that, and ``torch``, is all a loaded artifact needs.
The autograd rules (``FlashAttentionPacked``, ``FlashAttention``,
``WindowAttentionPacked``, ``LayerNormFunction``) stay
``torch.autograd.Function`` s around the ops.
"""

from __future__ import annotations

import torch

from tpu3dssf_torch.kernels import _build
from tpu3dssf_torch.kernels.modules import flash_attention as fa
from tpu3dssf_torch.kernels.modules import knn as knn_module
from tpu3dssf_torch.kernels.modules import layer_norm as ln
from tpu3dssf_torch.kernels.modules import window_attention as wa

_build.load_schema_library()   # the ops' schemas, before any kernel

# op -> the kernels it may count as
KERNELS = {
    "packed_attention": ("K1",),
    "packed_attention_lse": ("K1", "K2", "K4"),
    "packed_attention_bwd": ("K3", "K5"),
    "attention": ("K6", "K8"),
    "attention_lse": ("K4", "K8"),
    "attention_bwd": ("K5", "K9"),
    "knn": ("K7",),
    "layer_norm": ("LN",),
    "layer_norm_bwd": ("LNB",),
}
# the wrapper each (B, N, H, D) kernel serves, as the checks name it in
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
    layout the C++ kernel hands the kernel after its ``.contiguous()``."""
    return x.new_empty(x.shape)


def _heads_last(qkv, heads):
    B, N, C3 = qkv.shape
    return B, N, C3 // 3, heads


# --- K1: the packed inference forward -------------------------------------

@torch.library.impl("tpu3dssf::packed_attention", "cpu")
def packed_attention(qkv, key_bias, heads, q_scale, rope_cos, rope_sin):
    """MHA off the (B, N, 3C) projection → (B, N, C) in qkv's dtype: K1
    (with tables its RoPE branch); see
    :func:`~tpu3dssf_torch.kernels.flash_attention.flash_attention_packed`.
    """
    return fa.flash_attention_packed_reference(
        qkv, key_bias, heads, q_scale, rope_cos, rope_sin).contiguous()


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


@torch.library.register_fake("tpu3dssf::packed_attention")
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


@torch.library.impl("tpu3dssf::packed_attention_lse", "cpu")
def packed_attention_lse(qkv, key_bias, heads, q_scale, rope_cos, rope_sin,
                         kernel):
    """:func:`packed_attention` with its LSE: (out (B, N, C), lse (B, H, N)
    f32), the training forward; ``kernel`` K2 (C ≥ 128), K4 (the window
    route's C ∈ {32, 64}) or, with tables, K1."""
    _lse_kernel(kernel, rope_cos)
    out, lse = fa.flash_attention_packed_lse_reference(
        qkv, key_bias, heads, q_scale, rope_cos, rope_sin)
    return out.contiguous(), lse.contiguous()


@torch.library.register_fake("tpu3dssf::packed_attention_lse")
def _(qkv, key_bias, heads, q_scale, rope_cos, rope_sin, kernel):
    _lse_kernel(kernel, rope_cos)
    _packed_fake_check(qkv, key_bias, heads, rope_cos, rope_sin)
    B, N, C, H = _heads_last(qkv, heads)
    return (qkv.new_empty((B, N, C)),
            qkv.new_empty((B, H, N), dtype=torch.float32))


# --- K3, K5: the packed backward -------------------------------------------

@torch.library.impl("tpu3dssf::packed_attention_bwd", "cpu")
def packed_attention_bwd(qkv, key_bias, dout, lse, delta, heads, q_scale,
                         kernel):
    """The stats-fed backward on the packed layout: dout (B, N, C), the
    forward's lse and delta = rowsum(dout·out) (B, H, N) f32 → dqkv
    (B, N, 3C) in qkv's dtype; ``kernel`` K3 or K5."""
    _kernel("packed_attention_bwd", kernel)
    return fa.flash_attention_packed_bwd_reference(
        qkv, key_bias, dout, lse, delta, heads, q_scale).contiguous()


@torch.library.register_fake("tpu3dssf::packed_attention_bwd")
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


@torch.library.impl("tpu3dssf::attention", "cpu")
def attention(q, k, v, key_bias, key_mask, kernel):
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


@torch.library.register_fake("tpu3dssf::attention")
def _(q, k, v, key_bias, key_mask, kernel):
    _attention_kernel(kernel, key_mask)
    if _on_cuda(q):
        fa.check_layout(_CALLER[kernel], (q, k, v), key_bias)
    return q.new_empty(q.shape)


# --- K4, K8: the (B, N, H, D) forward with its LSE (training) --------------

@torch.library.impl("tpu3dssf::attention_lse", "cpu")
def attention_lse(q, k, v, key_bias, q_scale, kernel):
    """The training forward on (B, N, H, D): (out in q's dtype, lse
    (B, H, N) f32), q scaled by ``q_scale``; ``kernel`` K8 or K4."""
    _kernel("attention_lse", kernel)
    out, lse = fa.flash_attention_lse_reference(q, k, v, key_bias, q_scale)
    return out.contiguous(), lse.contiguous()


@torch.library.register_fake("tpu3dssf::attention_lse")
def _(q, k, v, key_bias, q_scale, kernel):
    _kernel("attention_lse", kernel)
    if _on_cuda(q):
        fa.check_layout(_CALLER[kernel], (q, k, v), key_bias)
    B, N, H, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((B, H, N), dtype=torch.float32)


# --- K5, K9: the (B, N, H, D) backward -------------------------------------

@torch.library.impl("tpu3dssf::attention_bwd", "cpu")
def attention_bwd(q, k, v, key_bias, dout, lse, delta, q_scale, kernel):
    """The stats-fed backward on (B, N, H, D): (dq, dk, dv) in q's dtype;
    ``kernel`` K9 or K5."""
    _kernel("attention_bwd", kernel)
    return tuple(g.contiguous() for g in fa.flash_attention_bwd_reference(
        q, k, v, key_bias, dout, lse, delta, q_scale))


@torch.library.register_fake("tpu3dssf::attention_bwd")
def _(q, k, v, key_bias, dout, lse, delta, q_scale, kernel):
    _kernel("attention_bwd", kernel)
    if _on_cuda(q):
        name = _CALLER[kernel]
        fa.check_layout(name, (q, k, v, _contiguous(dout)), key_bias)
        fa.check_stats(name, q, lse, delta)
    return tuple(q.new_empty(q.shape) for _ in range(3))


# --- K7: k nearest neighbours ----------------------------------------------

@torch.library.impl("tpu3dssf::knn", "cpu")
def knn(queries, refs, ref_mask, k):
    """The k nearest valid refs of each query: (distances (B, Q, k) f32,
    indices (B, Q, k) int32); see
    :func:`~tpu3dssf_torch.kernels.knn.knn`."""
    dist, idx = knn_module.topk_neighbors_reference(queries, refs, ref_mask,
                                                    k)
    return dist.contiguous(), idx.contiguous()


@torch.library.register_fake("tpu3dssf::knn")
def _(queries, refs, ref_mask, k):
    if _on_cuda(queries):
        knn_module.check_layout(queries, refs, ref_mask, k)
    B, Q, _ = queries.shape
    return (queries.new_empty((B, Q, k), dtype=torch.float32),
            queries.new_empty((B, Q, k), dtype=torch.int32))


# --- LN, LNB: LayerNorm and its gradient ------------------------------------

@torch.library.impl("tpu3dssf::layer_norm", "cpu")
def layer_norm(x, weight, bias, eps):
    """LayerNorm of a (rows, C) ``x`` over C with f32 ``weight`` and
    ``bias``: (y in x's dtype, mean (rows,) f32, rstd (rows,) f32); see
    :func:`~tpu3dssf_torch.kernels.layer_norm.layer_norm`."""
    y, mean, rstd = ln.layer_norm_reference(x, weight, bias, eps)
    return y.contiguous(), mean.contiguous(), rstd.contiguous()


@torch.library.register_fake("tpu3dssf::layer_norm")
def _(x, weight, bias, eps):
    if _on_cuda(x):
        ln.check_layout(x, (("weight", weight), ("bias", bias)))
    rows = x.shape[:-1].numel()
    return (x.new_empty(x.shape), x.new_empty((rows,), dtype=torch.float32),
            x.new_empty((rows,), dtype=torch.float32))


@torch.library.impl("tpu3dssf::layer_norm_bwd", "cpu")
def layer_norm_bwd(dy, x, weight, mean, rstd):
    """The gradient of :func:`layer_norm` from its mean and rstd: (dx in
    x's dtype, dweight f32, dbias f32)."""
    return tuple(g.contiguous() for g in ln.layer_norm_bwd_reference(
        dy, x, weight, mean, rstd))


@torch.library.register_fake("tpu3dssf::layer_norm_bwd")
def _(dy, x, weight, mean, rstd):
    if _on_cuda(x):
        ln.check_layout(x, (("weight", weight),))
        ln.check_stats(dy, x, mean, rstd)
    return (x.new_empty(x.shape), weight.new_empty(weight.shape),
            weight.new_empty(weight.shape))


def _cuda_library():
    """Where a card is present: build (once per machine) and load the CUDA
    library, whose ``TORCH_LIBRARY_IMPL`` registers the CUDA kernels. If
    that fails, each op's CUDA kernel raises the failure."""
    if not torch.cuda.is_available():
        return
    try:
        _build.load_cuda_library()
    except Exception as e:  # noqa: BLE001  (raised by every CUDA call)
        cause = e

        def failed(*args):
            raise RuntimeError(f"the tpu3dssf CUDA library did not build "
                               f"or load: {cause}") from cause

        for name in KERNELS:
            torch.library.impl(f"tpu3dssf::{name}", "cuda")(failed)


_cuda_library()
