"""Vision Transformer (DINOv2 / DINOv3 style) in PyTorch, for inference.

Port of ``tpu3dssf.models.vit``: a ViT that maps camera images (B, H, W, 3)
to per-patch tokens plus a global token, with the same presets, axial 2D
RoPE, register tokens and reference token-slice quirk
(``register_slice_compat``). Submodule names follow the flax names with
the layers under ``blocks.N`` (``blocks.0.norm1``, ``blocks.0.qkv``), the
layout of the JAX CLI's stacked ``blocks`` tree.

Attention routes as JAX's flash path (``ViTBlock``), from axial-RoPE cos/sin
tables built once per forward (:func:`rope_tables`, identity rows for the
prefix tokens):
* with at most 8 heads, or a 128-aligned head group and
  ``ViTConfig.packed_head_groups`` (ViT-S, and ViT-L by default), the
  projection's own qkv goes to
  :func:`tpu3dssf_torch.kernels.flash_attention_packed` (K1) with q_scale
  1/√D and the tables, so q and k are rotated inside the kernel (its
  ``use_rope`` branch). JAX's ViT rotates outside the kernel and pre-scales
  q instead, for a TPU reason (Mosaic lane relayouts made its in-kernel
  rotation slower); the function is the same up to where q·1/√D is rounded;
* otherwise (ViT-L with ``packed_head_groups=False``) q and k are rotated
  outside, as JAX does, and q, k, v go as (B, N, H, D) tensors to
  :func:`tpu3dssf_torch.kernels.flash_attention`, which scales q itself
  (K8, and K9 for a gradient).
Each is the Hopper kernel on a CUDA tensor and the plain version on a CPU
tensor. No sequence padding: the kernels mask ragged N themselves.
``ViTConfig.use_flash`` is kept for config compatibility and selects
nothing: the port has no einsum route, so JAX's refusal of
``prepare_tp_params`` with ``use_flash=False`` has no counterpart here.

Tensor parallelism (Megatron, head-parallel), JAX's ``tp_axis`` /
``tp_mesh``: :func:`prepare_tp_params` permutes each qkv projection's output
rows into the per-shard [q_s|k_s|v_s] layout and stamps the mesh into the
config, then :func:`tpu3dssf_torch.parallel.vit_tp_shardings` cuts every
block to this rank's shard. A block then projects its local qkv (contiguous,
as K1 takes it), runs attention on its Hl = H/S heads, routed by the local
Hl and Cl as JAX's ``run_flash`` routes them (ViT-L at S = 2: Hl = 8, Cl =
512, the packed K1 with its RoPE branch), and sums the partial outputs of
``proj`` and ``mlp_out`` over the axis, adding their bias once after the
sum. Norms, embeddings, LayerScale and the RoPE tables stay whole; any other
mesh axis is a batch axis.

W8A8 inference (JAX's ``quant_int8``): :func:`quantize_vit` folds
LayerScale and replaces each block's ``qkv``, ``proj``, ``mlp_in`` and
``mlp_out`` with a :class:`QuantDense` (int8 weights with per-output-channel
scales, int8 activations with per-token scales, an int32 product by
``torch._int_mm``, a float dequantize); attention and the patch embedding
stay in the compute dtype. Under tensor parallelism a row-parallel
``QuantDense`` quantizes its shard of a row by the whole row's max (an
all-reduce of the max) and sums the int32 partial products over the axis
before the dequantize, so the sharded block computes exactly the
one-process block. Not ported: ``make_looped_encode`` (a TPU compiler
workaround; the CLI config's ``vit_looped`` is accepted and has no effect).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu3dssf_torch.kernels.flash_attention import (flash_attention,
                                                    flash_attention_packed,
                                                    pick_head_group,
                                                    rope_rotate)
from tpu3dssf_torch.models.layers import Dense, LayerNorm
from tpu3dssf_torch.parallel.mesh import (all_reduce_max, all_reduce_sum,
                                          copy_to_axis)
from tpu3dssf_torch.utils.constants import device_constants

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    patch_size: int = 16
    image_size: Tuple[int, int] = (640, 1138)  # (H, W)
    hidden_size: int = 384
    num_layers: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    num_register_tokens: int = 0
    layerscale_init: Optional[float] = 1e-5
    use_rope: bool = False
    use_flash: bool = False  # kept for config compatibility; no effect
    dtype: torch.dtype = torch.float32
    ln_eps: float = 1e-6
    rope_theta: float = 100.0
    # many-head route (H > 8): True → the packed kernel (K1) when a
    # 128-aligned head group exists; False → the (B, N, H, D) kernel (K8)
    packed_head_groups: bool = True
    # head-parallel tensor parallelism over ``tp_axis`` of ``tp_mesh`` (a
    # tpu3dssf_torch.parallel.Mesh), set by prepare_tp_params
    tp_axis: Optional[str] = None
    tp_mesh: Optional[object] = None
    # W8A8 inference: the block Dense layers are QuantDense (int8 x int8 ->
    # int32 products); weights from quantize_vit, per output channel,
    # activations per token, both symmetric. Attention and the patch
    # embedding stay in ``dtype``.
    quant_int8: bool = False

    @property
    def grid_size(self) -> Tuple[int, int]:
        return (self.image_size[0] // self.patch_size,
                self.image_size[1] // self.patch_size)

    @property
    def num_patches(self) -> int:
        gh, gw = self.grid_size
        return gh * gw

    @property
    def num_prefix_tokens(self) -> int:
        return 1 + self.num_register_tokens  # CLS + registers


def dinov2_small() -> ViTConfig:
    return ViTConfig(patch_size=14, image_size=(224, 224),
                     num_register_tokens=0, use_rope=False)


def dinov3_small() -> ViTConfig:
    return ViTConfig(patch_size=16, image_size=(640, 1138),
                     num_register_tokens=4, use_rope=True, ln_eps=1e-5)


def dinov3_large() -> ViTConfig:
    return ViTConfig(patch_size=16, image_size=(640, 1138),
                     hidden_size=1024, num_layers=24, num_heads=16,
                     num_register_tokens=4, use_rope=True, ln_eps=1e-5)


def _rope_angles(gh, gw, head_dim, theta=100.0, device=None):
    """Axial 2D RoPE angles (num_patches, head_dim/2), HF DINOv3 semantics:
    patch-center coords in (-1, 1), inv_freq theta^(-4i/head_dim), laid
    out [y-freqs | x-freqs] per patch."""
    quarter = head_dim // 4
    ar = lambda n: torch.arange(n, dtype=torch.float32, device=device)  # noqa: E731
    freqs = theta ** (-ar(quarter) * 4.0 / head_dim)
    ys = ((ar(gh) + 0.5) / gh) * 2.0 - 1.0
    xs = ((ar(gw) + 0.5) / gw) * 2.0 - 1.0
    ang_y = (2.0 * math.pi * ys[:, None] * freqs[None, :])[:, None, :]
    ang_x = (2.0 * math.pi * xs[:, None] * freqs[None, :])[None, :, :]
    ang = torch.cat([ang_y.expand(gh, gw, quarter),
                     ang_x.expand(gh, gw, quarter)], dim=-1)
    return ang.reshape(gh * gw, 2 * quarter)


def rope_tables(cfg: ViTConfig, device=None):
    """(cos, sin) of every token, each (num_prefix + num_patches, D/2) f32:
    the patches' rows from :func:`_rope_angles`, identity rows (cos 1, sin
    0) for the prefix tokens, which RoPE passes through."""
    gh, gw = cfg.grid_size
    angles = _rope_angles(gh, gw, cfg.hidden_size // cfg.num_heads,
                          cfg.rope_theta, device=device)
    prefix = torch.zeros((cfg.num_prefix_tokens, angles.shape[1]),
                         device=device)
    return (torch.cat([prefix + 1.0, torch.cos(angles)]),
            torch.cat([prefix, torch.sin(angles)]))


class QuantDense(nn.Module):
    """W8A8 Dense (JAX's ``QuantDense``): int8 weights with per-output-
    channel symmetric scales times int8 activations with per-token dynamic
    symmetric scales, an int32 product, a f32 dequantize, the result in
    ``dtype``. Buffers, as :func:`quantize_vit` fills them: ``kernel_q``
    int8 (out, in), contiguous, so that its transpose is the column-major
    operand ``torch._int_mm`` takes; ``scale`` and ``bias`` f32 (out,)."""

    def __init__(self, in_features, out_features, dtype=torch.float32):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.dtype = dtype
        self.register_buffer("kernel_q", torch.zeros(
            (out_features, in_features), dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_features))
        self.register_buffer("bias", torch.zeros(out_features))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """flax's placeholders: zero weights, unit scales, zero bias."""
        self.kernel_q.zero_()
        self.scale.fill_(1.0)
        self.bias.zero_()

    @staticmethod
    def quantize(x, amax=None):
        """(x_q, a): ``x`` in f32 rounded (half to even) to int8 on the grid
        ``a = max(amax / 127, 1e-8)``, ``amax`` the max |x| of each row
        (given where the row is sharded)."""
        xf = x.float()
        if amax is None:
            amax = xf.abs().amax(-1, keepdim=True)
        a = (amax / 127.0).clamp_min(1e-8)
        return torch.round(xf / a).to(torch.int8), a

    def product(self, x_q):
        """The int32 product ``x_q @ kernel_q.T``."""
        lead = x_q.shape[:-1]
        acc = torch._int_mm(x_q.reshape(-1, x_q.shape[-1]),
                            self.kernel_q.t())
        return acc.reshape(lead + (self.out_features,))

    def dequantize(self, acc, a):
        return (acc.float() * (a * self.scale) + self.bias).to(self.dtype)

    def forward(self, x):
        x_q, a = self.quantize(x)
        return self.dequantize(self.product(x_q), a)


class LayerScale(nn.Module):
    def __init__(self, dim, init):
        super().__init__()
        self.init = init
        self.gamma = nn.Parameter(torch.full((dim,), float(init)))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.gamma.fill_(self.init)

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        C, dt = cfg.hidden_size, cfg.dtype
        self.cfg = cfg
        dense = QuantDense if cfg.quant_int8 else Dense
        self.norm1 = LayerNorm(C, cfg.ln_eps, dt)
        self.qkv = dense(C, 3 * C, dt)
        self.proj = dense(C, C, dt)
        self.norm2 = LayerNorm(C, cfg.ln_eps, dt)
        self.mlp_in = dense(C, int(C * cfg.mlp_ratio), dt)
        self.mlp_out = dense(int(C * cfg.mlp_ratio), C, dt)
        if cfg.layerscale_init is not None:
            self.ls1 = LayerScale(C, cfg.layerscale_init)
            self.ls2 = LayerScale(C, cfg.layerscale_init)

    def forward(self, x, rope, key_bias):
        """``rope``: the (cos, sin) tables of :func:`rope_tables`, or None
        without RoPE. Under tensor parallelism the qkv, ``mlp_in``, ``proj``
        and ``mlp_out`` weights are this rank's shard (the module
        docstring)."""
        cfg = self.cfg
        B, N, C = x.shape
        D = C // cfg.num_heads
        cos, sin = (None, None) if rope is None else rope
        if cfg.tp_mesh is not None and (self.qkv.out_features * cfg.tp_mesh
                                        .shape[cfg.tp_axis] != 3 * C):
            raise ValueError("a ViT block prepared for tensor parallelism "
                             "runs on its shard: apply "
                             "tpu3dssf_torch.parallel.vit_tp_shardings")
        qkv = self.qkv(self._to_shards(self.norm1(x)))
        # the widths of this rank's shard, which route the attention
        Cl = qkv.shape[-1] // 3
        Hl = Cl // D
        if Hl > 8 and (pick_head_group(Hl, Cl) is None
                       or not cfg.packed_head_groups):
            q, k, v = (t.reshape(B, N, Hl, D)
                       for t in qkv.split(Cl, dim=-1))
            if rope is not None:
                q, k = rope_rotate(q, cos, sin), rope_rotate(k, cos, sin)
            out = flash_attention(q, k, v, key_bias).reshape(B, N, Cl)
        else:
            out = flash_attention_packed(qkv, key_bias, Hl,
                                         1.0 / math.sqrt(D), cos, sin)
        out = self._row_parallel(self.proj, out)
        if cfg.layerscale_init is not None:
            out = self.ls1(out)
        x = x + out.to(x.dtype)
        h = self._to_shards(self.norm2(x))
        h = F.gelu(self.mlp_in(h))  # exact (erf) GELU, as HF
        h = self._row_parallel(self.mlp_out, h)
        if cfg.layerscale_init is not None:
            h = self.ls2(h)
        return x + h.to(x.dtype)

    def _to_shards(self, h):
        """The replicated input of a column-parallel layer (its gradient is
        the sum of the shards')."""
        cfg = self.cfg
        if cfg.tp_mesh is None:
            return h
        return copy_to_axis(h, cfg.tp_mesh, cfg.tp_axis)

    def _row_parallel(self, dense, h):
        """``dense(h)``; under tensor parallelism the sum over the axis of
        the shards' partial products, then the whole bias, once. A
        :class:`QuantDense` shard quantizes by the whole row's max and sums
        its int32 partial products before the dequantize."""
        cfg = self.cfg
        if cfg.tp_mesh is None:
            return dense(h)
        mesh, axis = cfg.tp_mesh, cfg.tp_axis
        if isinstance(dense, QuantDense):
            amax = all_reduce_max(h.float().abs().amax(-1, keepdim=True),
                                  mesh, axis)
            x_q, a = dense.quantize(h, amax)
            acc = all_reduce_sum(dense.product(x_q), mesh, axis)
            return dense.dequantize(acc, a)
        dt = dense.dtype
        y = F.linear(h.to(dt), dense.weight.to(dt))
        y = all_reduce_sum(y, mesh, axis)
        return y + dense.bias.to(dt)


class VisionTransformer(nn.Module):
    """DINO-style ViT: images (B, H, W, 3) → patch + global tokens."""

    def __init__(self, config: ViTConfig, register_slice_compat=False):
        super().__init__()
        cfg = self.config = config
        self.register_slice_compat = register_slice_compat
        C, P = cfg.hidden_size, cfg.patch_size
        # patchify as one matmul: pixels flattened row-major (kh, kw, cin)
        self.patch_embed = Dense(P * P * 3, C, cfg.dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, C))
        if cfg.num_register_tokens:
            self.register_tokens = nn.Parameter(
                torch.zeros(1, cfg.num_register_tokens, C))
        if not cfg.use_rope:
            self.pos_embed = nn.Parameter(torch.zeros(
                1, cfg.num_prefix_tokens + cfg.num_patches, C))
        self.blocks = nn.ModuleList(ViTBlock(cfg)
                                    for _ in range(cfg.num_layers))
        self.norm = LayerNorm(C, cfg.ln_eps, cfg.dtype)

    @torch.no_grad()
    def reset_parameters(self, generator):
        """flax init of the ViT's own parameters (zeros, pos N(0, 0.02))."""
        self.cls_token.zero_()
        if self.config.num_register_tokens:
            self.register_tokens.zero_()
        if not self.config.use_rope:
            self.pos_embed.copy_(0.02 * torch.randn(
                self.pos_embed.shape, generator=generator))

    def forward(self, images):
        cfg = self.config
        B = images.shape[0]
        C, P = cfg.hidden_size, cfg.patch_size
        gh, gw = cfg.grid_size
        dt = cfg.dtype
        x = images[:, :gh * P, :gw * P, :].to(dt)
        x = x.reshape(B, gh, P, gw, P, 3).permute(0, 1, 3, 2, 4, 5)
        x = self.patch_embed(x.reshape(B, gh * gw, P * P * 3))
        tokens = [self.cls_token.to(dt).expand(B, 1, C)]
        if cfg.num_register_tokens:
            tokens.append(self.register_tokens.to(dt).expand(
                B, cfg.num_register_tokens, C))
        x = torch.cat(tokens + [x], dim=1)
        if not cfg.use_rope:
            x = x + self.pos_embed.to(dt)
        rope = rope_tables(cfg, x.device) if cfg.use_rope else None
        key_bias = torch.zeros((B, 1, x.shape[1]), dtype=torch.float32,
                               device=x.device)
        for block in self.blocks:
            x = block(x, rope, key_bias)
        x = self.norm(x)
        if self.register_slice_compat:
            patch_tokens = x[:, 1:-4]  # reference camera.py:57-58 quirk
        else:
            patch_tokens = x[:, cfg.num_prefix_tokens:]
        return {"patch_features": patch_tokens, "global_features": x[:, 0]}


@torch.no_grad()
def fold_layerscale(model: VisionTransformer) -> VisionTransformer:
    """Fold LayerScale gammas into the adjacent Dense weights, in place:
    ``LS(Dense(x)) = x @ (W * gamma) + b * gamma``. Returns the model with
    ``config.layerscale_init=None`` and no ls1/ls2 submodules."""
    if model.config.layerscale_init is None:
        return model
    for blk in model.blocks:
        for ls, dense in (("ls1", "proj"), ("ls2", "mlp_out")):
            gamma = getattr(blk, ls).gamma
            d = getattr(blk, dense)
            d.weight.mul_(gamma[:, None])
            d.bias.mul_(gamma)
            delattr(blk, ls)
    cfg = dataclasses.replace(model.config, layerscale_init=None)
    model.config = cfg
    for blk in model.blocks:
        blk.cfg = cfg
    return model


QUANT_LAYERS = ("qkv", "proj", "mlp_in", "mlp_out")


@torch.no_grad()
def quantize_vit(model: VisionTransformer) -> VisionTransformer:
    """The W8A8 inference layout, in place (JAX's ``quantize_vit``): fold
    LayerScale (:func:`fold_layerscale`), then replace each block's
    ``qkv``, ``proj``, ``mlp_in`` and ``mlp_out`` by a :class:`QuantDense`
    with per-output-channel symmetric scales, ``scale = max(max |W[o]| /
    127, 1e-12)`` and ``kernel_q = round(W / scale)``. Returns the model,
    its config with ``quant_int8=True``."""
    fold_layerscale(model)
    cfg = dataclasses.replace(model.config, quant_int8=True)
    for blk in model.blocks:
        for name in QUANT_LAYERS:
            d = getattr(blk, name)
            w = d.weight.float()
            scale = (w.abs().amax(1) / 127.0).clamp_min(1e-12)
            q = QuantDense(d.in_features, d.out_features, cfg.dtype).to(
                w.device)
            q.kernel_q.copy_(torch.round(w / scale[:, None]).to(torch.int8))
            q.scale.copy_(scale)
            q.bias.copy_(d.bias.float())
            setattr(blk, name, q)
    model.config = cfg
    for blk in model.blocks:
        blk.cfg = cfg
    return model


def qkv_tp_permutation(hidden_size: int, num_heads: int,
                       num_shards: int) -> np.ndarray:
    """Permutation of the qkv projection's 3C outputs from [q|k|v] (each
    H heads of D channels) to [q_0|k_0|v_0 | q_1|k_1|v_1 | ...], block s
    holding shard s's heads, so that a contiguous split of the outputs over
    ``num_shards`` hands each shard its packed qkv (a numpy copy of
    ``tpu3dssf.models.vit.qkv_tp_permutation``, index for index)."""
    C, H, S = hidden_size, num_heads, num_shards
    if H % S:
        raise ValueError(f"num_heads={H} not divisible by shards={S}")
    D = C // H
    Hl = H // S
    idx = np.arange(3 * C).reshape(3, H, D)
    blocks = [idx[t, s * Hl:(s + 1) * Hl].reshape(-1)
              for s in range(S) for t in range(3)]
    return np.concatenate(blocks)


@torch.no_grad()
def prepare_tp_params(model: VisionTransformer, config: ViTConfig, mesh,
                      axis: str = "model"):
    """Permute every block's qkv output rows (a torch weight is (out, in);
    a W8A8 one's ``kernel_q`` and ``scale`` alike) and bias into the
    tensor-parallel layout of :func:`qkv_tp_permutation` and stamp
    ``(tp_axis, tp_mesh)`` into the config, in place; then cut the blocks
    to this rank's shard with
    :func:`tpu3dssf_torch.parallel.vit_tp_shardings`. The permutation is
    the identity when the axis has size 1. Returns (model, config)."""
    perm = torch.from_numpy(qkv_tp_permutation(
        config.hidden_size, config.num_heads, mesh.shape[axis]))
    for blk in model.blocks:
        qkv = blk.qkv
        names = (("kernel_q", "scale", "bias") if isinstance(qkv, QuantDense)
                 else ("weight", "bias"))
        for name in names:
            x = getattr(qkv, name)
            x.copy_(x[perm.to(x.device)])
    cfg = dataclasses.replace(config, tp_axis=axis, tp_mesh=mesh)
    model.config = cfg
    for blk in model.blocks:
        blk.cfg = cfg
    return model, cfg


def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 M with M @ x == jax.image.resize(x, method=
    "bilinear") along one axis: jax's scale_and_translate triangle kernel,
    antialiased (widened by the scale) when downsampling, rebuilt in
    float32 numpy step by step (no JAX)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))  # jax: Python-float scale
    kernel_scale = max(inv_scale, f32(1.0))
    # (o + 0.5) * inv_scale - 0.5 as one fused multiply-add, as XLA
    # compiles it: the f32 product is exact in float64, one rounding
    centers = (np.arange(n_out, dtype=f32) + f32(0.5)).astype(np.float64)
    sample_f = (centers * np.float64(inv_scale) - 0.5).astype(f32)
    x = (np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None])
         / kernel_scale)
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = np.sum(weights, axis=0, keepdims=True)
    weights = np.where(np.abs(total) > f32(1000.0 * np.finfo(f32).eps),
                       weights / np.where(total != 0, total, f32(1.0)),
                       f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= f32(n_in - 0.5))
    return np.where(inside[None, :], weights, f32(0.0)).T.astype(f32)


@device_constants
def _device_constants(H, W, Ho, Wo, mm, device):
    """The two resize matrices (in ``mm`` and back to f32) and the ImageNet
    mean and std on ``device``, made once: a step holds no host-to-device
    copy, which a CUDA graph could not replay."""
    with torch.inference_mode(False):
        wh, ww = (torch.from_numpy(_resize_matrix(n, m)).to(device).to(mm)
                  .float() for n, m in ((H, Ho), (W, Wo)))
        return (wh, ww, torch.tensor(IMAGENET_MEAN, device=device),
                torch.tensor(IMAGENET_STD, device=device))


def preprocess_images(images, target_hw, dtype=torch.float32):
    """Resize + ImageNet-normalise a batch of images.

    Accepts (..., H, W, 3) uint8 [0, 255] or float [0, 1]; returns
    (..., H', W', 3) in ``dtype``. The separable resize is two matmuls with
    the :func:`_resize_matrix` weights; for a bf16 ``dtype`` their inputs
    are rounded to bf16 first, and both accumulate in f32 (the JAX
    version's ``preferred_element_type=float32``).
    """
    x = torch.as_tensor(images)
    if x.dtype == torch.uint8:
        x = x.to(torch.float32) / 255.0
    x = x.to(torch.float32)
    lead = x.shape[:-3]
    H, W = x.shape[-3], x.shape[-2]
    Ho, Wo = target_hw
    mm = torch.bfloat16 if dtype == torch.bfloat16 else torch.float32

    def rounded(t):
        return t.to(mm).float()

    wh, ww, mean, std = _device_constants(H, W, Ho, Wo, mm, x.device)
    y = torch.einsum("oh,bhwc->bowc", wh, rounded(x.reshape((-1, H, W, 3))))
    y = torch.einsum("pw,bowc->bopc", ww, rounded(y))
    y = (y - mean) / std
    return y.reshape(lead + (Ho, Wo, 3)).to(dtype)
