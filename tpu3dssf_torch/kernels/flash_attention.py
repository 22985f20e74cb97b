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
compile-time LSE flag; the ``mma.sync`` kernels ``fap_fwd_d16_*`` at
D = 16, the wgmma/TMA ``fap_fwd_kernel_d64`` at D = 64) and
``fa_backward_bf16`` in ``csrc/flash_attention_packed_bwd.cu`` (one pass
at both: ``fap_bwd_d16_*`` with dq summed in a fixed order at D = 16,
``fap_bwd_d64_kernel`` and its dq cast at D = 64).
Each takes q, k, v (and do, dq, dk, dv) as separate pointers with their own
(batch, token, head) strides, so the packed layout is one stride set and
(B, N, H, D) another; the ops pass views and never repack. The
window routes of :mod:`tpu3dssf_torch.kernels.window_attention` launch the
same two kernels and count them as K4, K5 and K6; the (W, K, H, D) one
trains through :class:`FlashAttention` with a query mask and its own
counters.

The wrappers and training rules here call the kernels as ``torch.library``
custom ops (:mod:`tpu3dssf_torch.kernels.ops`: ``tpu3dssf::packed_attention``
and the rest), so a tracer (``torch.export``) sees each launch as one node.
The dispatcher picks an op's kernel by device and nothing else: a CUDA
tensor runs its C++ kernel (``csrc/ops_cuda.cpp``), which checks the
contract, launches and adds one to the counter of the TPU kernel it
serves, or raises; a CPU tensor takes the plain version. There is no
fallback from one to the other. The counters read as :data:`LAUNCHES`
(K1), ``LSE_LAUNCHES`` (K2), ``BWD_LAUNCHES`` (K3), ``FLASH_LAUNCHES``
(K8) and ``FLASH_BWD_LAUNCHES`` (K9) here
(:mod:`tpu3dssf_torch.kernels.modules`).
"""

from __future__ import annotations

import torch

from tpu3dssf_torch.kernels import modules

_BWD_SOURCE = "flash_attention_packed_bwd.cu"
SUPPORTED_HEAD_DIMS = (16, 64)


def __getattr__(name):
    """The launch counters of K1, K2, K3, K8 and K9, by name."""
    return modules.counter("flash_attention", name)


def __dir__():
    return sorted([*globals(), *modules.counter_names("flash_attention")])


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
    tensor; with tables K1's forward with its LSE and K9); otherwise the op
    ``tpu3dssf::packed_attention``: K1 on a CUDA tensor, the plain version
    on a CPU tensor. The TPU version's ``block_q``, ``head_group`` and its
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
    return torch.ops.tpu3dssf.packed_attention(qkv, key_bias, heads,
                                               q_scale, rope_cos, rope_sin)


class FlashAttentionPacked(torch.autograd.Function):
    """The training rule of :func:`flash_attention_packed` (port of
    ``_fap_fwd``/``_fap_bwd``).

    RoPE-free: the forward runs the op ``tpu3dssf::packed_attention_lse``
    as K2 and saves (qkv, key_bias, lse, out); the backward computes delta
    = rowsum(g·out) per head in plain torch, as JAX does outside Pallas,
    and runs ``tpu3dssf::packed_attention_bwd`` as K3.

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
        out, lse = torch.ops.tpu3dssf.packed_attention_lse(
            qkv, key_bias, heads, q_scale, rope_cos, rope_sin,
            "K2" if rope_cos is None else "K1")
        ctx.save_for_backward(qkv, key_bias, lse, out, rope_cos, rope_sin)
        ctx.heads, ctx.q_scale = heads, q_scale
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, key_bias, lse, out, rope_cos, rope_sin = ctx.saved_tensors
        delta = row_delta(g, out, ctx.heads)
        if rope_cos is not None:
            dqkv = _rope_bwd(qkv, key_bias, g, lse, delta, ctx.heads,
                             ctx.q_scale, rope_cos, rope_sin)
        else:
            dqkv = torch.ops.tpu3dssf.packed_attention_bwd(
                qkv, key_bias, g, lse, delta, ctx.heads, ctx.q_scale, "K3")
        return dqkv, None, None, None, None, None


def _rope_bwd(qkv, key_bias, g, lse, delta, heads, q_scale, rope_cos,
              rope_sin):
    """dqkv of the RoPE branch (see :class:`FlashAttentionPacked`): the
    op ``tpu3dssf::attention_bwd`` as K9 (its plain version on a CPU
    tensor) on the rotated q and k with q_scale 1."""
    qs, kr, v, _ = _rope_views(qkv, heads, q_scale, rope_cos, rope_sin)
    dout = g.contiguous().unflatten(-1, (heads, -1))
    dqs, dkr, dv = torch.ops.tpu3dssf.attention_bwd(
        qs, kr, v, key_bias, dout, lse, delta, 1.0, "K9")
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
    :class:`FlashAttention`, counted as K8 and K9; otherwise the op
    ``tpu3dssf::attention`` as K8: the kernel on a CUDA tensor and
    :func:`mha_reference` on a CPU tensor. On a CUDA tensor:
    bf16, D in :data:`SUPPORTED_HEAD_DIMS`, each of q, k, v with a
    contiguous head dim, 16-byte-aligned rows and strides that are
    multiples of 8 (views of a packed projection qualify); anything else
    raises.
    """
    B, N = q.shape[:2]
    if key_bias is None:
        key_bias = torch.zeros((B, 1, N), dtype=torch.float32,
                               device=q.device)
    key_bias = key_bias.to(torch.float32).contiguous()
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttention.apply(q, k, v, key_bias, None, ("K8", "K9"))
    return torch.ops.tpu3dssf.attention(q, k, v, key_bias, None, "K8")


class FlashAttention(torch.autograd.Function):
    """The training rule on (B, N, H, D) tensors: the port of
    ``_fa_fwd``/``_fa_bwd`` for :func:`flash_attention` and of
    ``_wa_fwd``/``_wa_bwd`` for
    :func:`tpu3dssf_torch.kernels.window_attention.window_attention`.

    ``apply(q, k, v, key_bias, query_mask, kernels)``. The forward runs
    the op ``tpu3dssf::attention_lse`` (the forward kernel with its LSE),
    zeroes the query rows that ``query_mask`` (broadcastable to the output,
    in its dtype; None keeps every row) drops, and saves (q, k, v,
    key_bias, query_mask, lse, out). The backward masks the incoming
    gradient the same way, takes delta = rowsum(g·out) per head in plain
    torch and runs ``tpu3dssf::attention_bwd`` (the backward kernel, which
    the TPU kernel fed from a full-row recompute instead: the same
    gradient). ``kernels`` names the TPU kernels the two ops count as:
    ("K8", "K9") for :func:`flash_attention`, ("K4", "K5") for the window
    route. ``key_bias`` gets no gradient (JAX returns zeros for it).
    """

    @staticmethod
    def forward(ctx, q, k, v, key_bias, query_mask, kernels):
        out, lse = torch.ops.tpu3dssf.attention_lse(
            q, k, v, key_bias, _softmax_scale(q), kernels[0])
        if query_mask is not None:
            out = out * query_mask
        ctx.save_for_backward(q, k, v, key_bias, query_mask, lse, out)
        ctx.kernel = kernels[1]
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_bias, query_mask, lse, out = ctx.saved_tensors
        if query_mask is not None:
            g = g * query_mask
        delta = row_delta(g, out)
        grads = torch.ops.tpu3dssf.attention_bwd(
            q, k, v, key_bias, g, lse, delta, _softmax_scale(q), ctx.kernel)
        return (*grads, None, None, None)


def _softmax_scale(q):
    return 1.0 / (q.shape[-1] ** 0.5)


def check_packed(qkv, heads):
    """The packed layout's shape, which every device needs."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"flash_attention_packed: qkv must be (B, N, 3C), "
                         f"got {tuple(qkv.shape)}")
    C = qkv.shape[-1] // 3
    if C % heads:
        raise ValueError(f"flash_attention_packed: head dim C/heads = "
                         f"{C}/{heads} is not an integer")


def _check(qkv, heads):
    """The packed layout's contract; :func:`check_layout` checks the rest
    on the q, k, v views."""
    check_packed(qkv, heads)
    if not qkv.is_contiguous():
        raise ValueError("flash_attention_packed: qkv must be contiguous")


def _layout_error(name, x):
    return (f"{name}: each head's D channels must be contiguous, with "
            f"16-byte-aligned rows and strides a multiple of 8, got strides "
            f"{x.stride()}")


def check_layout(name, views, key_bias):
    """The kernels' contract on (B, N, H, D) views that needs no data
    (dtypes, shapes, strides, devices, D), which the ops' fake kernels
    check; their CUDA kernels check it too, with the data pointers'
    16-byte alignment."""
    q = views[0]
    for x in views:
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the CUDA kernel takes bfloat16 "
                            f"tensors, got {x.dtype}")
        if x.dim() != 4 or x.shape != q.shape or x.device != q.device:
            raise ValueError(f"{name}: every tensor must be (B, N, H, D) = "
                             f"{tuple(q.shape)} on {q.device}, got "
                             f"{tuple(x.shape)} on {x.device}")
        if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:3]):
            raise ValueError(_layout_error(name, x))
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


def check_rope(name, q, rope):
    """The RoPE branch's contract but for the tables' 16-byte alignment
    (which the CUDA kernel adds): D = 64 (the D = 16 kernel has no RoPE
    branch) and contiguous (N, D/2) f32 tables on q's card."""
    B, N, H, D = q.shape
    if D != 64:
        raise ValueError(f"{name}: RoPE in the kernel is built for head dim "
                         f"64 only, got {D} (the plain version takes any D)")
    for x in rope:
        if (x.device != q.device or x.dtype != torch.float32
                or tuple(x.shape) != (N, D // 2) or not x.is_contiguous()):
            raise ValueError(_rope_error(name, q, x))


def _rope_error(name, q, x):
    N, D = q.shape[1], q.shape[3]
    return (f"{name}: rope_cos/rope_sin must be contiguous float32 "
            f"{(N, D // 2)} tables on {q.device}, got {x.dtype} "
            f"{tuple(x.shape)} on {x.device}")


def check_stats(name, q, lse, delta):
    B, N, H, _ = q.shape
    for what, x in (("lse", lse), ("delta", delta)):
        if (x.device != q.device or x.dtype != torch.float32
                or tuple(x.shape) != (B, H, N) or not x.is_contiguous()):
            raise ValueError(
                f"{name} backward: {what} must be a contiguous float32 "
                f"{(B, H, N)} tensor on {q.device}, got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")


# keys per CTA of the D = 16 one-pass backward (``kBlockKeys`` in
# csrc/flash_attention_packed_bwd.cu, ``fa_backward_d16_block_keys()``) and
# the largest N that its one-warp-per-(row, head) kernel takes
D16_BWD_KEYS = 256
D16_SMALL_N = 64


def d16_key_blocks(N):
    """Key blocks of the D = 16 backward at N: CTAs along the keys, each
    summing its share of dq; 1 up to 256 keys (and in the one-warp kernel
    at N <= 64), where dq is written directly."""
    return -(-N // D16_BWD_KEYS) if N > D16_SMALL_N else 1


def rope_pair(rope_cos, rope_sin):
    if (rope_cos is None) != (rope_sin is None):
        raise ValueError("flash_attention_packed: pass both rope_cos and "
                         "rope_sin, or neither")
    return None if rope_cos is None else (rope_cos, rope_sin)
