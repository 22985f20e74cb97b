"""Packed-layout multi-head attention: the CUDA kernels and their plain
versions.

Port of ``tpu3dssf.kernels.flash_attention.flash_attention_packed`` and its
custom VJP. Three TPU kernels have a Hopper counterpart here, each with its
own launch counter:

* K1, the inference forward ``_packed_kernel`` (``with_lse=False``):
  ``fap_forward_bf16`` in ``csrc/flash_attention_packed.cu``, counted in
  :data:`LAUNCHES`. It serves each ViT layer and every PTv3 block when
  nothing needs a gradient.
* K2, the training forward ``_packed_kernel`` with ``with_lse=True``
  (``_fap_fwd``): ``fap_forward_lse_bf16`` in the same source, counted in
  :data:`LSE_LAUNCHES`.
* K3, the stats-fed backward ``_packed_bwd_kernel`` (``_fap_bwd``):
  ``fap_backward_bf16`` in ``csrc/flash_attention_packed_bwd.cu``, counted
  in :data:`BWD_LAUNCHES`.

K2 and K3 run through :class:`FlashAttentionPacked`, the training rule
that the PTv3 stages with C % 128 == 0 take. The C ∈ {32, 64} stages reach
the same two kernels through
:class:`tpu3dssf_torch.kernels.window_attention.WindowAttentionPacked`,
which counts them as K4 and K5.

Dispatch is by device and nothing else: a CUDA tensor launches the
hand-written Hopper kernels or raises; a CPU tensor takes the plain
versions. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from tpu3dssf_torch.kernels import _build

_SOURCE = "flash_attention_packed.cu"
_BWD_SOURCE = "flash_attention_packed_bwd.cu"
SUPPORTED_HEAD_DIMS = (16, 64)
SUPPORTED_BWD_HEAD_DIMS = (16,)

# kernel launches made in this process: K1, K2 and K3
LAUNCHES = 0
LSE_LAUNCHES = 0
BWD_LAUNCHES = 0


def _split_heads(qkv, heads):
    B, N, C3 = qkv.shape
    C = C3 // 3
    return (x.reshape(B, N, heads, C // heads) for x in qkv.split(C, dim=-1))


def flash_attention_packed_lse_reference(qkv, key_bias, heads, q_scale=None):
    """Plain PyTorch version of the forward with LSE: f32 softmax and
    matmuls. Returns (out (B, N, C) in qkv.dtype, lse (B, H, N) f32).

    Same math as the kernels: q is scaled by ``q_scale`` in the input
    dtype, scores get the additive key bias, the output is normalised after
    the PV product by ``max(denominator, 1e-20)``, and the LSE is
    ``max + log(max(denominator, 1e-20))`` in natural-log units.
    """
    B, N, C3 = qkv.shape
    q, k, v = _split_heads(qkv, heads)
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
    return out.reshape(B, N, C3 // 3).to(qkv.dtype), lse


def flash_attention_packed_reference(qkv, key_bias, heads, q_scale=None):
    """Plain PyTorch version of K1: the output of
    :func:`flash_attention_packed_lse_reference`."""
    return flash_attention_packed_lse_reference(qkv, key_bias, heads,
                                                q_scale)[0]


def flash_attention_packed_bwd_reference(qkv, key_bias, dout, lse, delta,
                                         heads, q_scale=None):
    """Plain PyTorch version of the stats-fed backward, in f32.

    From the forward's ``lse`` and ``delta = rowsum(dout·out)`` (both
    (B, H, N) f32): p = exp(s − lse), dv = pᵀ·do, dp = do·vᵀ,
    ds = p·(dp − delta), dq = ds·k·q_scale, dk = dsᵀ·q_s with q_s the
    forward's scaled q. Returns dqkv (B, N, 3C) in qkv.dtype.
    """
    B, N, C3 = qkv.shape
    q, k, v = _split_heads(qkv, heads)
    scale = 1.0 if q_scale is None else q_scale
    qs = (q * torch.tensor(scale, dtype=q.dtype)).float()
    k, v = k.float(), v.float()
    do = dout.reshape(q.shape).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qs, k)
    s = s + key_bias.float()[:, :, None, :]
    p = torch.exp(s - lse.float()[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    ds = p * (dp - delta.float()[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs)
    return torch.cat([x.reshape(B, N, C3 // 3) for x in (dq, dk, dv)],
                     dim=-1).to(qkv.dtype)


def row_delta(dout, out, heads):
    """delta = rowsum(dout·out) per head, (B, N, C) → (B, H, N) f32: the
    softmax-VJP row term, computed outside the kernel as JAX does."""
    B, N, C = out.shape
    prod = dout.float() * out.float()
    return prod.reshape(B, N, heads, C // heads).sum(-1).transpose(1, 2) \
        .contiguous()


def flash_attention_packed(qkv, key_bias, heads, q_scale=None):
    """MHA straight off the qkv projection: (B, N, 3C) → (B, N, C).

    Args:
      qkv: (B, N, 3C) — q at channels [0, C), k at [C, 2C), v at [2C, 3C);
        head h is the D = C/heads wide slice at offset h·D of each.
      key_bias: (B, 1, N) additive on the keys (−1e9 masks a key).
      heads: number of heads.
      q_scale: scale applied to q; ``None`` means q arrives pre-scaled.

    When autograd needs a gradient of ``qkv`` this is
    :class:`FlashAttentionPacked` (K2 forward, K3 backward on a CUDA
    tensor); otherwise it launches K1. The TPU version's ``block_q``,
    ``head_group``, ``rope_cos``/``rope_sin`` and its scratch option are
    gone: the first three are Mosaic tiling rules (N a q-block multiple,
    128-lane head groups), RoPE in the kernel was a branch no model path
    takes, and the scratch buffer only bounded VMEM. The kernels mask
    ragged N themselves.

    On a CUDA tensor: bf16 only, D = C/heads in
    :data:`SUPPORTED_HEAD_DIMS` (:data:`SUPPORTED_BWD_HEAD_DIMS` for a
    gradient), contiguous 16-byte-aligned qkv and a contiguous f32 bias.
    Anything else raises.
    """
    if torch.is_grad_enabled() and qkv.requires_grad:
        return FlashAttentionPacked.apply(qkv, key_bias, heads, q_scale)
    if qkv.device.type == "cpu":
        return flash_attention_packed_reference(qkv, key_bias, heads,
                                                q_scale)
    return _launch(qkv, key_bias, heads, q_scale)


class FlashAttentionPacked(torch.autograd.Function):
    """The training rule of :func:`flash_attention_packed` (port of
    ``_fap_fwd``/``_fap_bwd``, RoPE-free branch).

    The forward launches K2 and saves (qkv, key_bias, lse, out); the
    backward computes delta = rowsum(g·out) per head in plain torch, as
    JAX does outside Pallas, and launches K3. ``key_bias`` gets no
    gradient (JAX returns zeros for it).
    """

    @staticmethod
    def forward(ctx, qkv, key_bias, heads, q_scale):
        global LSE_LAUNCHES
        if qkv.device.type == "cpu":
            out, lse = flash_attention_packed_lse_reference(
                qkv, key_bias, heads, q_scale)
        else:
            out, lse = _launch_lse(qkv, key_bias, heads, q_scale)
            LSE_LAUNCHES += 1
        ctx.save_for_backward(qkv, key_bias, lse, out)
        ctx.heads, ctx.q_scale = heads, q_scale
        return out

    @staticmethod
    def backward(ctx, g):
        global BWD_LAUNCHES
        qkv, key_bias, lse, out = ctx.saved_tensors
        delta = row_delta(g, out, ctx.heads)
        if qkv.device.type == "cpu":
            dqkv = flash_attention_packed_bwd_reference(
                qkv, key_bias, g, lse, delta, ctx.heads, ctx.q_scale)
        else:
            dqkv = _launch_bwd(qkv, key_bias, g, lse, delta, ctx.heads,
                               ctx.q_scale)
            BWD_LAUNCHES += 1
        return dqkv, None, None, None


def _check(qkv, key_bias, heads, head_dims=SUPPORTED_HEAD_DIMS):
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_attention_packed: no kernel for device "
                         f"{qkv.device}")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention_packed: the CUDA kernel takes "
                        f"bfloat16 qkv, got {qkv.dtype}")
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"flash_attention_packed: qkv must be (B, N, 3C), "
                         f"got {tuple(qkv.shape)}")
    B, N, C3 = qkv.shape
    C = C3 // 3
    if C % heads or C // heads not in head_dims:
        raise ValueError(f"flash_attention_packed: head dim C/heads = "
                         f"{C}/{heads} must be one of {head_dims}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("flash_attention_packed: qkv must be contiguous "
                         "and 16-byte aligned")
    if (key_bias.device != qkv.device or key_bias.dtype != torch.float32
            or tuple(key_bias.shape) != (B, 1, N)
            or not key_bias.is_contiguous()):
        raise ValueError(f"flash_attention_packed: key_bias must be a "
                         f"contiguous float32 (B, 1, N) = {(B, 1, N)} tensor "
                         f"on {qkv.device}, got {key_bias.dtype} "
                         f"{tuple(key_bias.shape)} on {key_bias.device}")


def _check_stats(qkv, dout, lse, delta, heads):
    B, N, C3 = qkv.shape
    for name, x, shape, dtype in (
            ("dout", dout, (B, N, C3 // 3), torch.bfloat16),
            ("lse", lse, (B, heads, N), torch.float32),
            ("delta", delta, (B, heads, N), torch.float32)):
        if (x.device != qkv.device or x.dtype != dtype
                or tuple(x.shape) != shape or not x.is_contiguous()
                or x.data_ptr() % 16):
            raise ValueError(
                f"flash_attention_packed backward: {name} must be a "
                f"contiguous 16-byte-aligned {dtype} {shape} tensor on "
                f"{qkv.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")


_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _bind(source, name, argtypes):
    fn = getattr(_build.load_library(source), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _lib():
    return _bind(_SOURCE, "fap_forward_bf16",
                 [_PTR] * 3 + [_INT] * 4 + [_FLOAT, _PTR])


def _lib_lse():
    return _bind(_SOURCE, "fap_forward_lse_bf16",
                 [_PTR] * 4 + [_INT] * 4 + [_FLOAT, _PTR])


def _lib_bwd():
    return _bind(_BWD_SOURCE, "fap_backward_bf16",
                 [_PTR] * 6 + [_INT] * 4 + [_FLOAT, _PTR])


def _raise_if_failed(err, what, qkv, heads):
    if err != 0:
        B, N, C3 = qkv.shape
        raise RuntimeError(f"flash_attention_packed: {what} kernel launch "
                           f"failed with cudaError_t {err} (B={B}, N={N}, "
                           f"C={C3 // 3}, heads={heads})")


def _scale(q_scale):
    return 1.0 if q_scale is None else float(q_scale)


def _launch(qkv, key_bias, heads, q_scale):
    global LAUNCHES
    _check(qkv, key_bias, heads)
    B, N, C3 = qkv.shape
    fn = _lib()
    out = torch.empty((B, N, C3 // 3), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(qkv.data_ptr(), key_bias.data_ptr(), out.data_ptr(), B, N,
                 C3 // 3, heads, _scale(q_scale), stream)
    _raise_if_failed(err, "forward", qkv, heads)
    LAUNCHES += 1
    return out


def _launch_lse(qkv, key_bias, heads, q_scale):
    """Launch the forward-with-LSE kernel (K2/K4); the caller counts it."""
    _check(qkv, key_bias, heads)
    B, N, C3 = qkv.shape
    fn = _lib_lse()
    out = torch.empty((B, N, C3 // 3), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((B, heads, N), dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(qkv.data_ptr(), key_bias.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), B, N, C3 // 3, heads, _scale(q_scale),
                 stream)
    _raise_if_failed(err, "forward-with-LSE", qkv, heads)
    return out, lse


def _launch_bwd(qkv, key_bias, dout, lse, delta, heads, q_scale):
    """Launch the backward kernel (K3/K5); the caller counts it."""
    _check(qkv, key_bias, heads, SUPPORTED_BWD_HEAD_DIMS)
    dout = dout.contiguous()
    _check_stats(qkv, dout, lse, delta, heads)
    B, N, C3 = qkv.shape
    fn = _lib_bwd()
    dqkv = torch.empty_like(qkv)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(qkv.data_ptr(), key_bias.data_ptr(), dout.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dqkv.data_ptr(), B, N,
                 C3 // 3, heads, _scale(q_scale), stream)
    _raise_if_failed(err, "backward", qkv, heads)
    return dqkv
