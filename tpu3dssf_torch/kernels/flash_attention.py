"""Multi-head attention: the CUDA kernels and their plain versions.

Port of ``tpu3dssf.kernels.flash_attention``: ``flash_attention_packed``
(MHA straight off the (B, N, 3C) qkv projection) and ``flash_attention``
(MHA on (B, N, H, D) tensors), each with its custom VJP. Five TPU kernels
have a Hopper counterpart here, each with its own launch counter:

* K1, the packed inference forward ``_packed_kernel`` (``with_lse=False``),
  counted in :data:`LAUNCHES`. It serves each ViT layer of the packed route
  and every PTv3 block of the packed routes when nothing needs a gradient.
  Its RoPE branch (``use_rope``: q and k rotated by axial-RoPE cos/sin
  tables inside the kernel) serves the DINOv3 ViT, and counts as K1 in its
  training forward too, as JAX runs K1 there.
* K2, the packed training forward ``_packed_kernel`` with ``with_lse=True``
  (``_fap_fwd``), counted in :data:`LSE_LAUNCHES`.
* K3, the stats-fed packed backward ``_packed_bwd_kernel`` (``_fap_bwd``),
  counted in :data:`BWD_LAUNCHES`.
* K8, the (B, H, N, D) forward ``_flash_kernel``, counted in
  :data:`FLASH_LAUNCHES`: :func:`flash_attention` without a gradient, and
  the forward of :class:`FlashAttention` (which also writes the LSE).
* K9, its backward ``_flash_bwd_kernel``, counted in
  :data:`FLASH_BWD_LAUNCHES`: the backward of :class:`FlashAttention`.

Two C entry points carry all five, each dispatching on the head dimension:
``fa_forward_bf16`` in ``csrc/flash_attention_packed.cu`` (with a
compile-time LSE flag; ``fap_fwd_kernel`` at D = 16, the wgmma/TMA
``fap_fwd_kernel_d64`` at D = 64) and ``fa_backward_bf16`` in
``csrc/flash_attention_packed_bwd.cu`` (the two-pass ``fap_bwd_*_kernel``
at D = 16, the one-pass ``fap_bwd_d64_kernel`` and its dq cast at D = 64).
Each takes q, k, v (and do, dq, dk, dv) as separate pointers with their own
(batch, token, head) strides, so the packed layout is one stride set and
(B, N, H, D) another; the launchers here pass views and never repack. The
window routes of :mod:`tpu3dssf_torch.kernels.window_attention` launch the
same two kernels and count them as K4, K5 and K6; the (W, K, H, D) one
trains through :class:`FlashAttention` with a query mask and its own
counters.

Dispatch is by device and nothing else: a CUDA tensor launches the
hand-written Hopper kernels or raises; a CPU tensor takes the plain
versions. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from tpu3dssf_torch.kernels import _build

_SOURCE = "flash_attention_packed.cu"
_BWD_SOURCE = "flash_attention_packed_bwd.cu"
SUPPORTED_HEAD_DIMS = (16, 64)

# kernel launches made in this process: K1, K2, K3, K8 and K9
LAUNCHES = 0
LSE_LAUNCHES = 0
BWD_LAUNCHES = 0
FLASH_LAUNCHES = 0
FLASH_BWD_LAUNCHES = 0


def pick_head_group(heads: int, channels: int):
    """The head-group size JAX's packed kernel would use, or None.

    Port of ``tpu3dssf.kernels.flash_attention.pick_head_group``: the
    largest group in (8, 4, 2) that divides ``heads`` with a 128-aligned
    group width ``channels // (heads // group)``. It is a Mosaic rule, and
    the port's kernels need no head groups; the models ask it only to take
    the route JAX takes, so that the same TPU kernel's counterpart runs.
    """
    return next((g for g in (8, 4, 2)
                 if heads % g == 0 and (channels // (heads // g)) % 128 == 0),
                None)


def _split_heads(qkv, heads):
    """(B, N, 3C) → q, k, v as (B, N, H, D) views."""
    C = qkv.shape[-1] // 3
    return tuple(x.unflatten(-1, (heads, C // heads))
                 for x in qkv.split(C, dim=-1))


def mha_reference(q, k, v, bias=None):
    """Plain MHA, the port of JAX's oracle and the plain version of K8.

    q, k, v (B, N, H, D); ``bias`` (B, 1|H, N) additive on the keys. Scores
    in f32 scaled by 1/√D, softmax, PV in f32; the output in q.dtype.
    """
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()[:, :, None, :]
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def flash_attention_lse_reference(q, k, v, key_bias, q_scale=None):
    """Plain PyTorch version of the forward with LSE on (B, N, H, D): f32
    softmax and matmuls. Returns (out (B, N, H, D) in q.dtype, lse (B, H, N)
    f32).

    Same math as the kernels: q is scaled by ``q_scale`` in the input
    dtype, scores get the additive key bias (B, 1, N), the output is
    normalised after the PV product by ``max(denominator, 1e-20)``, and the
    LSE is ``max + log(max(denominator, 1e-20))`` in natural-log units.
    """
    if q_scale is not None:
        q = q * torch.tensor(q_scale, dtype=q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s + key_bias.float()[:, :, None, :]
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    denom = e.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    out = torch.einsum("bhqk,bkhd->bqhd", e, v.float())
    out = out / denom.permute(0, 2, 1, 3)
    lse = (m + torch.log(denom))[..., 0]
    return out.to(q.dtype), lse


def flash_attention_bwd_reference(q, k, v, key_bias, dout, lse, delta,
                                  q_scale=None):
    """Plain PyTorch version of the stats-fed backward on (B, N, H, D), in
    f32: the plain version of K3, K5 and K9.

    From the forward's ``lse`` and ``delta = rowsum(dout·out)`` (both
    (B, H, N) f32): p = exp(s − lse), dv = pᵀ·do, dp = do·vᵀ,
    ds = p·(dp − delta), dq = ds·k·q_scale, dk = dsᵀ·q_s with q_s the
    forward's scaled q. Returns (dq, dk, dv) in q.dtype.
    """
    scale = 1.0 if q_scale is None else q_scale
    qs = (q * torch.tensor(scale, dtype=q.dtype)).float()
    k, v, do = k.float(), v.float(), dout.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qs, k)
    s = s + key_bias.float()[:, :, None, :]
    p = torch.exp(s - lse.float()[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    ds = p * (dp - delta.float()[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs)
    return tuple(x.to(q.dtype) for x in (dq, dk, dv))


def rope_rotate(x, rope_cos, rope_sin, scale=None, inverse=False):
    """Axial RoPE on (B, N, H, D) ``x`` as the TPU kernel's ``use_rope``
    branch rotates q and k: in f32, x times the f32 ``scale`` (None: 1),
    then the halves [0, D/2) and [D/2, D) rotated by token n's row of the
    (N, D/2) f32 tables, ``(x1·cos − x2·sin, x1·sin + x2·cos)`` (with
    ``inverse`` by −sin: the transpose, for gradients), rounded to x.dtype
    once. Every head and batch row uses the same tables; identity rows
    (cos 1, sin 0) leave a token as it is."""
    D2 = x.shape[-1] // 2
    xf = x.float()
    if scale is not None:
        xf = xf * torch.tensor(scale, dtype=torch.float32)
    cos = rope_cos.float()[:, None, :]
    sin = rope_sin.float()[:, None, :]
    if inverse:
        sin = -sin
    x1, x2 = xf[..., :D2], xf[..., D2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _rope_views(qkv, heads, q_scale, rope_cos, rope_sin):
    """q, k, v (B, N, H, D) of the packed projection and the q_scale the
    plain attention then takes: with tables, q rotated with its f32 scale
    and k rotated, each rounded once (scale 1 after that); without, the
    views and ``q_scale``."""
    q, k, v = _split_heads(qkv, heads)
    if rope_cos is None:
        return q, k, v, q_scale
    return (rope_rotate(q, rope_cos, rope_sin, q_scale),
            rope_rotate(k, rope_cos, rope_sin), v, None)


def flash_attention_packed_lse_reference(qkv, key_bias, heads, q_scale=None,
                                         rope_cos=None, rope_sin=None):
    """:func:`flash_attention_lse_reference` on the packed layout: (out
    (B, N, C) in qkv.dtype, lse (B, H, N) f32). With the (N, D/2) f32
    tables ``rope_cos``/``rope_sin``, q and k are first rotated by
    :func:`rope_rotate`, q with its f32 ``q_scale`` (the RoPE-free branch
    multiplies by q_scale rounded to qkv.dtype): any D."""
    *views, scale = _rope_views(qkv, heads, q_scale, rope_cos, rope_sin)
    out, lse = flash_attention_lse_reference(*views, key_bias, scale)
    return out.flatten(2), lse


def flash_attention_packed_reference(qkv, key_bias, heads, q_scale=None,
                                     rope_cos=None, rope_sin=None):
    """Plain PyTorch version of K1 (with or without its RoPE branch): the
    output of :func:`flash_attention_packed_lse_reference`."""
    return flash_attention_packed_lse_reference(qkv, key_bias, heads,
                                                q_scale, rope_cos,
                                                rope_sin)[0]


def flash_attention_packed_bwd_reference(qkv, key_bias, dout, lse, delta,
                                         heads, q_scale=None):
    """:func:`flash_attention_bwd_reference` on the packed layout: dout
    (B, N, C) → dqkv (B, N, 3C) in qkv.dtype."""
    grads = flash_attention_bwd_reference(
        *_split_heads(qkv, heads), key_bias,
        dout.unflatten(-1, (heads, -1)), lse, delta, q_scale)
    return torch.cat([g.flatten(2) for g in grads], dim=-1)


def row_delta(dout, out, heads=None):
    """delta = rowsum(dout·out) per head → (B, H, N) f32: the softmax-VJP
    row term, computed outside the kernel as JAX does. Takes (B, N, C)
    tensors with ``heads``, or (B, N, H, D) ones without."""
    prod = dout.float() * out.float()
    if heads is not None:
        prod = prod.unflatten(-1, (heads, -1))
    return prod.sum(-1).transpose(1, 2).contiguous()


def flash_attention_packed(qkv, key_bias, heads, q_scale=None, rope_cos=None,
                           rope_sin=None):
    """MHA straight off the qkv projection: (B, N, 3C) → (B, N, C).

    Args:
      qkv: (B, N, 3C) — q at channels [0, C), k at [C, 2C), v at [2C, 3C);
        head h is the D = C/heads wide slice at offset h·D of each.
      key_bias: (B, 1, N) additive on the keys (−1e9 masks a key).
      heads: number of heads.
      q_scale: scale applied to q; ``None`` means q arrives pre-scaled.
      rope_cos, rope_sin: (N, D/2) f32 axial-RoPE tables (both or
        neither), the TPU kernel's ``use_rope`` branch: q·q_scale (the f32
        value) and k are rotated by token n's row (:func:`rope_rotate`) and
        rounded to bf16 once before the softmax. Every head and batch row
        uses the same tables; prefix and padded tokens carry identity rows
        (cos 1, sin 0). The tables get no gradient.

    When autograd needs a gradient of ``qkv`` this is
    :class:`FlashAttentionPacked` (K2 forward and K3 backward on a CUDA
    tensor; with tables K1's forward with its LSE and K9); otherwise it
    launches K1. The TPU version's ``block_q``, ``head_group`` and its
    scratch option are gone: the first two are Mosaic tiling rules (N a
    q-block multiple, 128-lane head groups), and the scratch buffer only
    bounded VMEM. The kernels mask ragged N themselves.

    On a CUDA tensor: bf16 only, D = C/heads in :data:`SUPPORTED_HEAD_DIMS`
    (64 with tables), contiguous 16-byte-aligned qkv, a contiguous f32 bias
    and contiguous f32 tables on the same card. Anything else raises.
    """
    if torch.is_grad_enabled() and qkv.requires_grad:
        return FlashAttentionPacked.apply(qkv, key_bias, heads, q_scale,
                                          rope_cos, rope_sin)
    if qkv.device.type == "cpu":
        return flash_attention_packed_reference(qkv, key_bias, heads,
                                                q_scale, rope_cos, rope_sin)
    return _launch(qkv, key_bias, heads, q_scale, rope_cos, rope_sin)


class FlashAttentionPacked(torch.autograd.Function):
    """The training rule of :func:`flash_attention_packed` (port of
    ``_fap_fwd``/``_fap_bwd``).

    RoPE-free: the forward launches K2 and saves (qkv, key_bias, lse, out);
    the backward computes delta = rowsum(g·out) per head in plain torch, as
    JAX does outside Pallas, and launches K3.

    With tables: the forward launches K1's RoPE branch with its LSE,
    counted as K1 (JAX runs K1 there). The backward follows JAX's RoPE
    half in plain torch around K9: qs = rot(q)·q_scale and kr = rot(k),
    rounded as the forward rounded them, K9 on their (B, N, H, D) views
    with q_scale 1, the forward's LSE and delta, then dq = q_scale·rotᵀ(dqs)
    and dk = rotᵀ(dkr); dv as K9 gives it. ``key_bias`` and the tables get
    no gradient (JAX returns zeros for them).
    """

    @staticmethod
    def forward(ctx, qkv, key_bias, heads, q_scale, rope_cos, rope_sin):
        global LAUNCHES, LSE_LAUNCHES
        if qkv.device.type == "cpu":
            out, lse = flash_attention_packed_lse_reference(
                qkv, key_bias, heads, q_scale, rope_cos, rope_sin)
        else:
            out, lse = _launch_lse(qkv, key_bias, heads, q_scale, rope_cos,
                                   rope_sin)
            if rope_cos is None:
                LSE_LAUNCHES += 1
            else:
                LAUNCHES += 1
        ctx.save_for_backward(qkv, key_bias, lse, out, rope_cos, rope_sin)
        ctx.heads, ctx.q_scale = heads, q_scale
        return out

    @staticmethod
    def backward(ctx, g):
        global BWD_LAUNCHES
        qkv, key_bias, lse, out, rope_cos, rope_sin = ctx.saved_tensors
        delta = row_delta(g, out, ctx.heads)
        if rope_cos is not None:
            dqkv = _rope_bwd(qkv, key_bias, g, lse, delta, ctx.heads,
                             ctx.q_scale, rope_cos, rope_sin)
        elif qkv.device.type == "cpu":
            dqkv = flash_attention_packed_bwd_reference(
                qkv, key_bias, g, lse, delta, ctx.heads, ctx.q_scale)
        else:
            dqkv = _launch_bwd(qkv, key_bias, g, lse, delta, ctx.heads,
                               ctx.q_scale)
            BWD_LAUNCHES += 1
        return dqkv, None, None, None, None, None


def _rope_bwd(qkv, key_bias, g, lse, delta, heads, q_scale, rope_cos,
              rope_sin):
    """dqkv of the RoPE branch (see :class:`FlashAttentionPacked`): K9 on a
    CUDA tensor, counted in :data:`FLASH_BWD_LAUNCHES`, its plain version
    on a CPU tensor."""
    global FLASH_BWD_LAUNCHES
    qs, kr, v, _ = _rope_views(qkv, heads, q_scale, rope_cos, rope_sin)
    dout = g.contiguous().unflatten(-1, (heads, -1))
    if qkv.device.type == "cpu":
        dqs, dkr, dv = flash_attention_bwd_reference(qs, kr, v, key_bias,
                                                     dout, lse, delta)
    else:
        dqs, dkr, dv = _launch_flash_bwd(qs, kr, v, key_bias, dout, lse,
                                         delta, 1.0,
                                         name="flash_attention_packed")
        FLASH_BWD_LAUNCHES += 1
    dq = rope_rotate(dqs, rope_cos, rope_sin, q_scale, inverse=True)
    dk = rope_rotate(dkr, rope_cos, rope_sin, inverse=True)
    return torch.cat([dq.flatten(2), dk.flatten(2), dv.flatten(2)], dim=-1)


def flash_attention(q, k, v, key_bias=None):
    """Full MHA, q/k/v (B, N, H, D) → (B, N, H, D): the port of JAX's
    ``flash_attention`` (K8, and K9 for its gradient).

    q is scaled by 1/√D in q's dtype, as JAX's wrapper does; ``key_bias``
    (B, 1, N) is additive on the keys (None: no bias). JAX's ``block_q`` and
    its padding are gone: the kernel masks ragged N itself, where JAX's
    −1e9 pad keys got zero weight, so the result is the same.

    When autograd needs a gradient of q, k or v this is
    :class:`FlashAttention`, counted as K8 and K9; otherwise K8 on a CUDA
    tensor and :func:`mha_reference` on a CPU tensor. On a CUDA tensor:
    bf16, D in :data:`SUPPORTED_HEAD_DIMS`, each of q, k, v with a
    contiguous head dim, 16-byte-aligned rows and strides that are
    multiples of 8 (views of a packed projection qualify); anything else
    raises.
    """
    global FLASH_LAUNCHES
    B, N = q.shape[:2]
    if key_bias is None:
        key_bias = torch.zeros((B, 1, N), dtype=torch.float32,
                               device=q.device)
    key_bias = key_bias.to(torch.float32).contiguous()
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttention.apply(q, k, v, key_bias, None, _K8_K9,
                                    "flash_attention")
    if q.device.type == "cpu":
        return mha_reference(q, k, v, key_bias)
    out = _launch_flash(q, k, v, key_bias, _softmax_scale(q))
    FLASH_LAUNCHES += 1
    return out


def _count(counter):
    """Add one to a launch counter given as (module, name of its global)."""
    module, name = counter
    setattr(module, name, getattr(module, name) + 1)


_K8_K9 = ((sys.modules[__name__], "FLASH_LAUNCHES"),
          (sys.modules[__name__], "FLASH_BWD_LAUNCHES"))


class FlashAttention(torch.autograd.Function):
    """The training rule on (B, N, H, D) tensors: the port of
    ``_fa_fwd``/``_fa_bwd`` for :func:`flash_attention` and of
    ``_wa_fwd``/``_wa_bwd`` for
    :func:`tpu3dssf_torch.kernels.window_attention.window_attention`.

    ``apply(q, k, v, key_bias, query_mask, counters, name)``. The forward
    launches the forward kernel with its LSE, zeroes the query rows that
    ``query_mask`` (broadcastable to the output, in its dtype; None keeps
    every row) drops, and saves (q, k, v, key_bias, query_mask, lse, out).
    The backward masks the incoming gradient the same way, takes delta =
    rowsum(g·out) per head in plain torch and launches the backward kernel,
    which the TPU kernel fed from a full-row recompute instead (the same
    gradient). ``counters`` are the (forward, backward) launch counters as
    :func:`_count` takes them: K8/K9 for :func:`flash_attention`, K4/K5 for
    the window route. ``name`` names the caller in errors. ``key_bias``
    gets no gradient (JAX returns zeros for it).
    """

    @staticmethod
    def forward(ctx, q, k, v, key_bias, query_mask, counters, name):
        scale = _softmax_scale(q)
        if q.device.type == "cpu":
            out, lse = flash_attention_lse_reference(q, k, v, key_bias,
                                                     scale)
        else:
            out, lse = _launch_flash(q, k, v, key_bias, scale, with_lse=True,
                                     name=name)
            _count(counters[0])
        if query_mask is not None:
            out = out * query_mask
        ctx.save_for_backward(q, k, v, key_bias, query_mask, lse, out)
        ctx.counter, ctx.name = counters[1], name
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_bias, query_mask, lse, out = ctx.saved_tensors
        if query_mask is not None:
            g = g * query_mask
        delta = row_delta(g, out)
        scale = _softmax_scale(q)
        if q.device.type == "cpu":
            grads = flash_attention_bwd_reference(q, k, v, key_bias, g, lse,
                                                  delta, scale)
        else:
            grads = _launch_flash_bwd(q, k, v, key_bias, g.contiguous(), lse,
                                      delta, scale, name=ctx.name)
            _count(ctx.counter)
        return (*grads, None, None, None, None)


def _softmax_scale(q):
    return 1.0 / (q.shape[-1] ** 0.5)


def _check(qkv, heads):
    """The packed layout's contract; :func:`_check_views` checks the rest on
    the q, k, v views."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"flash_attention_packed: qkv must be (B, N, 3C), "
                         f"got {tuple(qkv.shape)}")
    C = qkv.shape[-1] // 3
    if C % heads:
        raise ValueError(f"flash_attention_packed: head dim C/heads = "
                         f"{C}/{heads} is not an integer")
    if not qkv.is_contiguous():
        raise ValueError("flash_attention_packed: qkv must be contiguous")


def _check_views(name, views, key_bias):
    """The kernels' contract on (B, N, H, D) views; raises on the first
    breach."""
    q = views[0]
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    for x in views:
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the CUDA kernel takes bfloat16 "
                            f"tensors, got {x.dtype}")
        if x.dim() != 4 or x.shape != q.shape or x.device != q.device:
            raise ValueError(f"{name}: every tensor must be (B, N, H, D) = "
                             f"{tuple(q.shape)} on {q.device}, got "
                             f"{tuple(x.shape)} on {x.device}")
        if (x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:3])
                or x.data_ptr() % 16):
            raise ValueError(f"{name}: each head's D channels must be "
                             f"contiguous, with 16-byte-aligned rows and "
                             f"strides a multiple of 8, got strides "
                             f"{x.stride()}")
    B, N, H, D = q.shape
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} must be one of "
                         f"{SUPPORTED_HEAD_DIMS}")
    if (key_bias.device != q.device or key_bias.dtype != torch.float32
            or tuple(key_bias.shape) != (B, 1, N)
            or not key_bias.is_contiguous()):
        raise ValueError(f"{name}: key_bias must be a contiguous float32 "
                         f"(B, 1, N) = {(B, 1, N)} tensor on {q.device}, got "
                         f"{key_bias.dtype} {tuple(key_bias.shape)} on "
                         f"{key_bias.device}")


def _check_rope(name, q, rope):
    """The RoPE branch's contract: D = 64 (the D = 16 kernel has no RoPE
    branch) and contiguous 16-byte-aligned (N, D/2) f32 tables on q's
    card."""
    B, N, H, D = q.shape
    if D != 64:
        raise ValueError(f"{name}: RoPE in the kernel is built for head dim "
                         f"64 only, got {D} (the plain version takes any D)")
    for x in rope:
        if (x.device != q.device or x.dtype != torch.float32
                or tuple(x.shape) != (N, D // 2) or not x.is_contiguous()
                or x.data_ptr() % 16):
            raise ValueError(f"{name}: rope_cos/rope_sin must be contiguous "
                             f"float32 {(N, D // 2)} tables on {q.device}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def _check_stats(name, q, lse, delta):
    B, N, H, _ = q.shape
    for what, x in (("lse", lse), ("delta", delta)):
        if (x.device != q.device or x.dtype != torch.float32
                or tuple(x.shape) != (B, H, N) or not x.is_contiguous()):
            raise ValueError(
                f"{name} backward: {what} must be a contiguous float32 "
                f"{(B, H, N)} tensor on {q.device}, got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")


_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)


def _bind(source, name, argtypes):
    fn = getattr(_build.load_library(source), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _lib_fwd():
    return _bind(_SOURCE, "fa_forward_bf16",
                 [_PTR] * 9 + [_STRIDES] + [_INT] * 4 + [_FLOAT, _PTR])


def _lib_bwd():
    return _bind(_BWD_SOURCE, "fa_backward_bf16",
                 [_PTR] * 11 + [_STRIDES] + [_INT] * 4 + [_FLOAT, _PTR])


def _strides(*views):
    """(batch, token, head) strides of each view, as the C entry points'
    int64 array."""
    flat = [s for x in views for s in x.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _raise_if_failed(err, name, what, q):
    if err != 0:
        B, N, H, D = q.shape
        raise RuntimeError(f"{name}: {what} kernel launch failed with "
                           f"cudaError_t {err} (B={B}, N={N}, H={H}, D={D})")


def _launch_flash(q, k, v, key_bias, q_scale, with_lse=False,
                  name="flash_attention", rope=None):
    """Launch the forward kernel on (B, N, H, D) views of q, k, v: out
    (B, N, H, D) bf16, and with ``with_lse`` also lse (B, H, N) f32. It
    serves K8, the window routes' K6 and K4, and the packed K1/K2; the
    caller counts it. ``rope`` (cos, sin), D = 64 only: the RoPE branch,
    q·q_scale rotated in the kernel's Q pass and k rotated once by a
    pre-kernel into a (B, N, H, D) bf16 scratch taken here, which the
    attention kernel then reads in place of k (two device kernels)."""
    _check_views(name, (q, k, v), key_bias)
    B, N, H, D = q.shape
    if rope is not None:
        _check_rope(name, q, rope)
    out = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, N), dtype=torch.float32, device=q.device)
           if with_lse else None)
    k_rot = torch.empty_like(out) if rope is not None else None
    fn = _lib_fwd()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 key_bias.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 *((None,) * 3 if rope is None else
                   (rope[0].data_ptr(), rope[1].data_ptr(), k_rot.data_ptr())),
                 _strides(q, k, v, out), B, N, H, D, float(q_scale), stream)
    _raise_if_failed(err, name, "forward-with-LSE" if with_lse else "forward",
                     q)
    return (out, lse) if with_lse else out


def _launch_flash_bwd(q, k, v, key_bias, dout, lse, delta, q_scale,
                      out=None, name="flash_attention"):
    """Launch the backward kernel on (B, N, H, D) views: (dq, dk, dv),
    written into ``out`` (three views) when given, else into new (B, N, H,
    D) tensors. It serves K9, the window route's K5 and the packed K3; the
    caller counts it. At D = 64 the kernel sums dq over its key tiles in a
    zeroed f32 (B, H, N rounded up to 64, 64) scratch taken here."""
    _check_views(name, (q, k, v, dout), key_bias)
    _check_stats(name, q, lse, delta)
    if out is None:
        out = tuple(torch.empty_like(q, memory_format=torch.contiguous_format)
                    for _ in range(3))
    _check_views(name, out, key_bias)
    B, N, H, D = q.shape
    scratch = (torch.zeros((B, H, -(-N // 64) * 64, 64), dtype=torch.float32,
                           device=q.device) if D == 64 else None)
    fn = _lib_bwd()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                 key_bias.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 *(x.data_ptr() for x in out),
                 None if scratch is None else scratch.data_ptr(),
                 _strides(q, k, v, dout, *out), B, N, H, D, float(q_scale),
                 stream)
    _raise_if_failed(err, name, "backward", q)
    return out


def _scale(q_scale):
    return 1.0 if q_scale is None else float(q_scale)


def _rope(rope_cos, rope_sin):
    if (rope_cos is None) != (rope_sin is None):
        raise ValueError("flash_attention_packed: pass both rope_cos and "
                         "rope_sin, or neither")
    return None if rope_cos is None else (rope_cos, rope_sin)


def _launch(qkv, key_bias, heads, q_scale, rope_cos=None, rope_sin=None):
    """Launch K1 (with tables: its RoPE branch) on the packed layout and
    count it."""
    global LAUNCHES
    _check(qkv, heads)
    out = _launch_flash(*_split_heads(qkv, heads), key_bias, _scale(q_scale),
                        name="flash_attention_packed",
                        rope=_rope(rope_cos, rope_sin))
    LAUNCHES += 1
    return out.flatten(2)


def _launch_lse(qkv, key_bias, heads, q_scale, rope_cos=None, rope_sin=None):
    """Launch the forward-with-LSE kernel on the packed layout: K2/K4, or
    with tables K1's RoPE branch; the caller counts it."""
    _check(qkv, heads)
    out, lse = _launch_flash(*_split_heads(qkv, heads), key_bias,
                             _scale(q_scale), with_lse=True,
                             name="flash_attention_packed",
                             rope=_rope(rope_cos, rope_sin))
    return out.flatten(2), lse


def _launch_bwd(qkv, key_bias, dout, lse, delta, heads, q_scale):
    """Launch the backward kernel (K3/K5) on the packed layout, into one
    packed dqkv (B, N, 3C); the caller counts it."""
    _check(qkv, heads)
    dqkv = torch.empty_like(qkv)
    _launch_flash_bwd(*_split_heads(qkv, heads), key_bias,
                      dout.contiguous().unflatten(-1, (heads, -1)), lse,
                      delta, _scale(q_scale), out=_split_heads(dqkv, heads),
                      name="flash_attention_packed")
    return dqkv
