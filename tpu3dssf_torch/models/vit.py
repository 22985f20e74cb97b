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
nothing. Not ported: W8A8 (``QuantDense``, ``quantize_vit``), tensor
parallelism and ``make_looped_encode`` (a TPU compiler workaround; the
CLI config's ``vit_looped`` is accepted and has no effect).
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
        self.norm1 = LayerNorm(C, cfg.ln_eps, dt)
        self.qkv = Dense(C, 3 * C, dt)
        self.proj = Dense(C, C, dt)
        self.norm2 = LayerNorm(C, cfg.ln_eps, dt)
        self.mlp_in = Dense(C, int(C * cfg.mlp_ratio), dt)
        self.mlp_out = Dense(int(C * cfg.mlp_ratio), C, dt)
        if cfg.layerscale_init is not None:
            self.ls1 = LayerScale(C, cfg.layerscale_init)
            self.ls2 = LayerScale(C, cfg.layerscale_init)

    def forward(self, x, rope, key_bias):
        """``rope``: the (cos, sin) tables of :func:`rope_tables`, or None
        without RoPE."""
        cfg = self.cfg
        B, N, C = x.shape
        H = cfg.num_heads
        D = C // H
        cos, sin = (None, None) if rope is None else rope
        qkv = self.qkv(self.norm1(x))
        if H > 8 and (pick_head_group(H, C) is None
                      or not cfg.packed_head_groups):
            q, k, v = (t.reshape(B, N, H, D) for t in qkv.split(C, dim=-1))
            if rope is not None:
                q, k = rope_rotate(q, cos, sin), rope_rotate(k, cos, sin)
            out = flash_attention(q, k, v, key_bias).reshape(B, N, C)
        else:
            out = flash_attention_packed(qkv, key_bias, H, 1.0 / math.sqrt(D),
                                         cos, sin)
        out = self.proj(out)
        if cfg.layerscale_init is not None:
            out = self.ls1(out)
        x = x + out.to(x.dtype)
        h = F.gelu(self.mlp_in(self.norm2(x)))  # exact (erf) GELU, as HF
        h = self.mlp_out(h)
        if cfg.layerscale_init is not None:
            h = self.ls2(h)
        return x + h.to(x.dtype)


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

    wh = rounded(torch.from_numpy(_resize_matrix(H, Ho)).to(x.device))
    ww = rounded(torch.from_numpy(_resize_matrix(W, Wo)).to(x.device))
    y = torch.einsum("oh,bhwc->bowc", wh, rounded(x.reshape((-1, H, W, 3))))
    y = torch.einsum("pw,bowc->bopc", ww, rounded(y))
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    y = (y - mean) / std
    return y.reshape(lead + (Ho, Wo, 3)).to(dtype)
