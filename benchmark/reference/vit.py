"""DINOv3's ViT (Siméoni et al., 2025) in plain float32 PyTorch, frozen,
and the image preprocessing of the configurations, at the widths of a
:class:`ViTConfig` (ViT-S/16 by default; a configuration's come from
:mod:`benchmark.reference.widths`).

Images (N, H, W, 3) uint8 are scaled to [0, 1], resized to the encoder's
input (640, 1138) by the separable antialiased bilinear resize of
``jax.image.resize`` (its weights rebuilt in numpy) and
ImageNet-normalised; the ViT takes its patches as one dense product,
prepends a CLS and its register tokens, runs its pre-norm blocks (axial
2-D RoPE on the patches' q and k, LayerScale on both residual branches,
exact GELU) and a final LayerNorm, and returns the patch tokens.
Parameter names are the program's unfolded ones.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.nn import Dense, LayerNorm, attention, matmul_inputs

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    patch_size: int = 16
    image_size: tuple = (640, 1138)
    hidden_size: int = 384
    num_layers: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    num_register_tokens: int = 4
    ln_eps: float = 1e-5
    rope_theta: float = 100.0

    @property
    def grid_size(self):
        return (self.image_size[0] // self.patch_size,
                self.image_size[1] // self.patch_size)

    @property
    def num_prefix_tokens(self):
        return 1 + self.num_register_tokens


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) f32 M with M @ x the antialiased bilinear resize of
    ``jax.image.resize`` along one axis (a triangle kernel widened by the
    scale when downsampling)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
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


def preprocess(images, target_hw):
    """(N, H, W, 3) uint8 → (N, H', W', 3) f32, resized and normalised."""
    x = images.float() / 255.0
    H, W = x.shape[-3], x.shape[-2]
    wh, ww = (torch.from_numpy(resize_matrix(n, m)).to(x.device)
              for n, m in ((H, target_hw[0]), (W, target_hw[1])))
    wh, x = matmul_inputs(wh, x.permute(0, 3, 2, 1))     # x: (N, 3, W, H)
    y = (x @ wh.T).permute(0, 1, 3, 2)                   # (N, 3, Ho, W)
    ww, y = matmul_inputs(ww, y)
    y = (y @ ww.T).permute(0, 2, 3, 1)                   # (N, Ho, Wo, 3)
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return (y - mean) / std


def rope_tables(cfg: ViTConfig, device):
    """(cos, sin), each (tokens, D/2): patch-centre coordinates in (-1, 1),
    frequencies theta^(-4i/D), [y | x] halves; identity rows for the
    prefix tokens."""
    gh, gw = cfg.grid_size
    D = cfg.hidden_size // cfg.num_heads
    quarter = D // 4

    def ar(n):
        return torch.arange(n, dtype=torch.float32, device=device)

    freqs = cfg.rope_theta ** (-ar(quarter) * 4.0 / D)
    ys = ((ar(gh) + 0.5) / gh) * 2.0 - 1.0
    xs = ((ar(gw) + 0.5) / gw) * 2.0 - 1.0
    ang_y = (2.0 * math.pi * ys[:, None] * freqs[None, :])[:, None, :]
    ang_x = (2.0 * math.pi * xs[:, None] * freqs[None, :])[None, :, :]
    ang = torch.cat([ang_y.expand(gh, gw, quarter),
                     ang_x.expand(gh, gw, quarter)], -1).reshape(gh * gw, -1)
    prefix = torch.zeros((cfg.num_prefix_tokens, ang.shape[1]), device=device)
    return (torch.cat([prefix + 1.0, torch.cos(ang)]),
            torch.cat([prefix, torch.sin(ang)]))


def rotate(x, cos, sin):
    """(B, H, N, D) x with its halves rotated by each token's angles."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


class LayerScale(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.gamma


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        C = cfg.hidden_size
        hidden = int(C * cfg.mlp_ratio)
        self.heads = cfg.num_heads
        self.norm1 = LayerNorm(C, cfg.ln_eps)
        self.qkv = Dense(C, 3 * C)
        self.proj = Dense(C, C)
        self.norm2 = LayerNorm(C, cfg.ln_eps)
        self.mlp_in = Dense(C, hidden)
        self.mlp_out = Dense(hidden, C)
        self.ls1 = LayerScale(C)
        self.ls2 = LayerScale(C)

    def forward(self, x, cos, sin):
        B, N, C = x.shape
        H = self.heads
        q, k, v = self.qkv(self.norm1(x)).reshape(B, N, 3, H, C // H).permute(
            2, 0, 3, 1, 4)
        out = attention(rotate(q, cos, sin), rotate(k, cos, sin), v)
        x = x + self.ls1(self.proj(out.transpose(1, 2).reshape(B, N, C)))
        h = F.gelu(self.mlp_in(self.norm2(x)))
        return x + self.ls2(self.mlp_out(h))


class ViT(nn.Module):
    def __init__(self, cfg: ViTConfig = ViTConfig()):
        super().__init__()
        self.cfg = cfg
        C, P = cfg.hidden_size, cfg.patch_size
        self.patch_embed = Dense(P * P * 3, C)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, C))
        self.register_tokens = nn.Parameter(
            torch.zeros(1, cfg.num_register_tokens, C))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.num_layers))
        self.norm = LayerNorm(C, cfg.ln_eps)

    def forward(self, x):
        """(N, H, W, 3) preprocessed images → (N, patches, C) tokens."""
        cfg = self.cfg
        B = x.shape[0]
        C, P = cfg.hidden_size, cfg.patch_size
        gh, gw = cfg.grid_size
        x = x[:, :gh * P, :gw * P, :].reshape(B, gh, P, gw, P, 3)
        x = self.patch_embed(x.permute(0, 1, 3, 2, 4, 5).reshape(
            B, gh * gw, P * P * 3))
        x = torch.cat([self.cls_token.expand(B, 1, C),
                       self.register_tokens.expand(B, -1, C), x], 1)
        cos, sin = rope_tables(cfg, x.device)
        for block in self.blocks:
            x = block(x, cos, sin)
        return self.norm(x)[:, cfg.num_prefix_tokens:]
