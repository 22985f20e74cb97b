"""Point Transformer V3 (Wu et al., CVPR 2024) in plain float32 PyTorch.

The configurations' PTv3 over fixed-capacity masked voxel sets, at the
widths of a :class:`benchmark.reference.widths.PTv3Widths` (the base
model: five stages): an embedding, encoder stages of pre-norm blocks (a depthwise kernel-3
positional convolution along the CPE order, windowed multi-head attention
over one of four serialization orders in turn, an MLP), grid pooling by 2
between stages (a dense projection, the max over each coarser cell, LN,
GELU), and decoder stages that unpool (the coarse feature broadcast
to its children plus the projected skip). Windows are consecutive runs of
``window`` tokens of the sorted sequence, empty slots last and masked as
keys. Parameter names are the program's, so one state dict loads into
both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from benchmark.reference.codes import SERIALIZATION_ORDERS, serialization_keys
from benchmark.reference.nn import (Dense, LayerNorm, argsort_lex, attention,
                                    gather_rows, inverse_permutation)
from benchmark.reference.widths import PTv3Widths


def round_up(x, m):
    return ((x + m - 1) // m) * m


def capacities(n, windows, pool_ratio=2):
    caps = [n]
    for w in windows[1:]:
        caps.append(round_up(max(w, caps[-1] // pool_ratio), w))
    return caps


def serialize(grid, mask, order):
    """(perm, inv) of one serialization order, empty slots last."""
    hi, lo = serialization_keys(grid, order)
    perm = argsort_lex(hi, lo, mask)
    return perm, inverse_permutation(perm)


def pool_structure(grid, mask, out_cap):
    """The 2x-coarser cells of a sequence in its CPE order, where each cell
    is one run: (grid_out (B, out_cap, 3), mask_out, seg (B, N) slot of each
    token, out_cap where dropped, parent (B, N) clamped slot, ok (B, N))."""
    B, n, _ = grid.shape
    coarse = grid >> 1
    new = torch.ones((B, n), dtype=torch.int32, device=grid.device)
    new[:, 1:] = (coarse[:, 1:] != coarse[:, :-1]).any(-1).int()
    new = torch.where(mask, new, 0)
    vid = torch.cumsum(new, dim=1) - 1
    ok = mask & (vid >= 0) & (vid < out_cap)
    seg = torch.where(ok, vid, out_cap).long()
    mask_out = (torch.arange(out_cap, device=grid.device)[None]
                < new.sum(1).clamp_max(out_cap)[:, None])
    grid_out = torch.zeros((B, out_cap + 1, 3), dtype=grid.dtype,
                           device=grid.device)
    grid_out.scatter_(1, seg[..., None].expand(-1, -1, 3), coarse)
    grid_out = torch.where(mask_out[..., None], grid_out[:, :out_cap], 0)
    return grid_out, mask_out, seg, vid.clamp(0, out_cap - 1).long(), ok


class DepthwiseConv3(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(3, 1, channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, xs):
        k = self.kernel
        left = F.pad(xs[:, :-1], (0, 0, 1, 0))
        right = F.pad(xs[:, 1:], (0, 0, 0, 1))
        return left * k[0, 0] + xs * k[1, 0] + right * k[2, 0] + self.bias


class CPE(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.depthwise = DepthwiseConv3(channels)
        self.pointwise = Dense(channels, channels)

    def forward(self, x, mask):
        y = self.pointwise(self.depthwise(x * mask[..., None]))
        return x + y * mask[..., None]


class WindowAttention(nn.Module):
    def __init__(self, channels, heads, window):
        super().__init__()
        self.heads, self.window = heads, window
        self.qkv = Dense(channels, 3 * channels)
        self.proj = Dense(channels, channels)

    def forward(self, x, perm, mask):
        """``perm``: the order to attend along, relative to the sequence's
        (None: the sequence's own)."""
        B, N, C = x.shape
        H, K = self.heads, min(self.window, N)
        qkv = self.qkv(x)
        if perm is not None:
            qkv, mask = gather_rows(qkv, perm), torch.gather(mask, 1, perm)
        q, k, v = qkv.reshape(B * (N // K), K, 3, H, C // H).permute(
            2, 0, 3, 1, 4)
        keys = mask.reshape(B * (N // K), 1, K)
        out = attention(q, k, v, keys) * keys[..., None]
        out = out.transpose(1, 2).reshape(B, N, C)
        if perm is not None:
            out = gather_rows(out, inverse_permutation(perm))
        return self.proj(out)


class Block(nn.Module):
    def __init__(self, channels, heads, window, mlp_ratio=4.0):
        super().__init__()
        hidden = int(channels * mlp_ratio)
        self.cpe = CPE(channels)
        self.norm1 = LayerNorm(channels)
        self.attn = WindowAttention(channels, heads, window)
        self.norm2 = LayerNorm(channels)
        self.mlp_in = Dense(channels, hidden)
        self.mlp_out = Dense(hidden, channels)

    def forward(self, x, perm, mask):
        x = self.cpe(x, mask)
        x = x + self.attn(self.norm1(x), perm, mask)
        h = F.gelu(self.mlp_in(self.norm2(x)), approximate="tanh")
        x = x + self.mlp_out(h)
        return x * mask[..., None]


class Pooling(nn.Module):
    def __init__(self, in_channels, channels):
        super().__init__()
        self.proj = Dense(in_channels, channels)
        self.norm = LayerNorm(channels)

    def forward(self, x, grid, mask, out_cap):
        """``x`` in its CPE order: each coarse cell is one run of it."""
        grid_out, mask_out, seg, parent, ok = pool_structure(grid, mask,
                                                             out_cap)
        h = self.proj(x)
        pooled = torch.full((h.shape[0], out_cap + 1, h.shape[-1]), -1.0e9,
                            device=h.device)
        pooled.scatter_reduce_(1, seg[..., None].expand_as(h), h, "amax")
        pooled = torch.where(mask_out[..., None], pooled[:, :out_cap], 0.0)
        pooled = F.gelu(self.norm(pooled), approximate="tanh")
        return pooled * mask_out[..., None], grid_out, mask_out, parent, ok


class Unpooling(nn.Module):
    def __init__(self, coarse_channels, skip_channels, channels):
        super().__init__()
        self.proj = Dense(coarse_channels, channels)
        self.norm = LayerNorm(channels)
        self.proj_skip = Dense(skip_channels, channels)
        self.norm_skip = LayerNorm(channels)

    def forward(self, x, skip, parent, parent_ok, mask):
        up = gather_rows(self.norm(self.proj(x)), parent)
        up = torch.where(parent_ok[..., None], up, 0.0)
        out = F.gelu(up + self.norm_skip(self.proj_skip(skip)),
                     approximate="tanh")
        return out * mask[..., None]


class PTv3(nn.Module):
    def __init__(self, w: PTv3Widths, orders=SERIALIZATION_ORDERS):
        super().__init__()
        self.window, self.orders = w.window, orders
        self.enc_depths, self.dec_depths = w.enc_depths, w.dec_depths
        enc_c, dec_c = w.enc_channels, w.dec_channels
        self.embed = Dense(w.in_channels, enc_c[0])
        self.embed_norm = LayerNorm(enc_c[0])
        S = w.stages
        for s in range(S):
            if s > 0:
                self.add_module(f"pool{s}", Pooling(enc_c[s - 1], enc_c[s]))
            for b in range(w.enc_depths[s]):
                self.add_module(f"enc{s}_blk{b}", Block(
                    enc_c[s], w.enc_heads[s], w.window, w.mlp_ratio))
        for d in reversed(range(S - 1)):
            coarse = enc_c[-1] if d == S - 2 else dec_c[d + 1]
            self.add_module(f"unpool{d}", Unpooling(coarse, enc_c[d],
                                                    dec_c[d]))
            for b in range(w.dec_depths[d]):
                self.add_module(f"dec{d}_blk{b}", Block(
                    dec_c[d], w.dec_heads[d], w.window, w.mlp_ratio))

    def _blocks(self, x, grid, mask, depth, name):
        """The blocks of one stage on a sequence in its CPE order (the
        first order's); block b attends along order b mod 4. With a
        gradient each block is recomputed in the backward, so that the
        float32 windows' scores fit at batch 12."""
        for b in range(depth):
            order = self.orders[b % len(self.orders)]
            perm = (None if order == self.orders[0]
                    else serialize(grid, mask, order)[0])
            block = getattr(self, f"{name}_blk{b}")
            if torch.is_grad_enabled():
                x = checkpoint(block, x, perm, mask, use_reentrant=False)
            else:
                x = block(x, perm, mask)
        return x

    def forward(self, feat, grid, mask):
        S = len(self.enc_depths)
        caps = capacities(feat.shape[1], (self.window,) * S)
        x = self.embed_norm(self.embed(feat)) * mask[..., None]
        perm0, inv0 = serialize(grid, mask, self.orders[0])
        x, grid = gather_rows(x, perm0), gather_rows(grid, perm0)
        mask = torch.gather(mask, 1, perm0)
        skips, parents = [], []
        for s in range(S):
            if s > 0:
                x, grid, mask, parent, ok = getattr(self, f"pool{s}")(
                    x, grid, mask, caps[s])
                parents.append((parent, ok))
                # the pooled cells come in the coarse grid's CPE order
            x = self._blocks(x, grid, mask, self.enc_depths[s], f"enc{s}")
            skips.append((x, grid, mask))
        for d in reversed(range(S - 1)):
            skip_x, grid, mask = skips[d]
            parent, ok = parents[d]
            x = getattr(self, f"unpool{d}")(x, skip_x, parent, ok, mask)
            x = self._blocks(x, grid, mask, self.dec_depths[d], f"dec{d}")
        return gather_rows(x, inv0)
