"""PointTransformerV3 over fixed-capacity masked point sets, in PyTorch.

Port of ``tpu3dssf.models.ptv3``. Same architecture, the same
serialization, pooling and windowing rules, and submodule names that
follow the flax names (``enc0_blk0.attn.qkv``, ``pool1.norm``,
``unpool0.proj_skip``), so :mod:`tpu3dssf_torch.convert` maps a flax
parameter tree mechanically. Batched helpers take the batch dimension
written out where the JAX package vmaps.

Every block's windowed attention takes the route JAX's takes
(:func:`attention_route`), so the counterpart of the same TPU kernel runs:
with a window K that is a multiple of 128, stages with C % 128 == 0 (and at
most 8 heads, or a 128-aligned head group) take
:func:`tpu3dssf_torch.kernels.flash_attention_packed` (K1; K2/K3 in
training) and the other stages with at most 8 heads
:func:`tpu3dssf_torch.kernels.window_attention_packed` (K1; K4/K5); every
other stage takes :func:`tpu3dssf_torch.kernels.window_attention` on
(W, K, H, D) views of the projection (K6; K4/K5). ``PTv3Config.use_pallas``
is kept for config compatibility and selects nothing: a CPU tensor takes
the plain versions and a CUDA tensor the kernels. DropPath's keep masks
are an input of the forward (``keep``, one row per DropPath in forward
order, drawn on the host by :meth:`PointTransformerV3.draw_keep` from an
explicit ``torch.Generator``, so that a CUDA graph of the train step
takes them as an argument); None, like JAX's ``deterministic=True``,
disables it.

``remat`` and ``remat_attention`` are JAX's ``nn.remat(PTv3Block)`` and
``nn.remat(SerializedAttention)``: ``torch.utils.checkpoint`` (non-
reentrant) around each block, or around each block's attention branch, so
the backward recomputes their activations instead of keeping them. A block
takes its DropPath masks from the forward's input, outside the
checkpointed region, and passes them in: remat changes no bit of the
forward or the gradients. The recompute runs with a gradient pending, so
it launches the training forward kernel (K2 or K4) once more
per block it recomputes. Under no gradient (eval) nothing is
checkpointed. A block made with ``sp_axis`` runs on one rank's span of
the sequence (:func:`tpu3dssf_torch.parallel.sp_block_apply`, JAX's
sequence parallelism): its CPE takes one-row halos from the neighbouring
spans. Not ported here: ``scan_blocks`` (a TPU compile workaround;
the unrolled model computes the same function) and ``_pool_structure``,
the pooling by a fresh sort that ``PointTransformerV3`` never takes.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpu3dssf_torch.kernels.flash_attention import (flash_attention_packed,
                                                    pick_head_group)
from tpu3dssf_torch.kernels.window_attention import (key_bias,
                                                     window_attention,
                                                     window_attention_packed)
from tpu3dssf_torch.models.layers import Dense, LayerNorm, lecun_normal
from tpu3dssf_torch.parallel.mesh import current_mesh
from tpu3dssf_torch.parallel.sp import halo_rows
from tpu3dssf_torch.serialization import (
    SERIALIZATION_ORDERS,
    argsort_lex,
    gather_rows,
    inverse_permutation,
    permutation_gather,
    serialization_keys,
)
from tpu3dssf_torch.utils.timing import span


@dataclasses.dataclass(frozen=True)
class PTv3Config:
    """Mirrors ``tpu3dssf.models.ptv3.PTv3Config`` (same defaults) minus
    the TPU-compile field ``scan_blocks``. ``use_pallas`` is kept for
    config compatibility and selects nothing."""

    in_channels: int = 4
    orders: Tuple[str, ...] = SERIALIZATION_ORDERS
    enc_depths: Tuple[int, ...] = (2, 2, 2, 6, 2)
    enc_channels: Tuple[int, ...] = (32, 64, 128, 256, 512)
    enc_heads: Tuple[int, ...] = (2, 4, 8, 16, 32)
    enc_window: Tuple[int, ...] = (1024, 1024, 1024, 1024, 1024)
    dec_depths: Tuple[int, ...] = (2, 2, 2, 2)
    dec_channels: Tuple[int, ...] = (64, 64, 128, 256)
    dec_heads: Tuple[int, ...] = (4, 4, 8, 16)
    dec_window: Tuple[int, ...] = (1024, 1024, 1024, 1024)
    mlp_ratio: float = 4.0
    pool_ratio: int = 2
    unique_cells: bool = True
    collapse_pooled_orders: bool = True
    drop_path: float = 0.0
    use_pallas: bool = True
    remat: bool = False
    remat_attention: bool = False
    dtype: torch.dtype = torch.float32

    @property
    def num_stages(self) -> int:
        return len(self.enc_depths)

    @property
    def out_channels(self) -> int:
        return self.dec_channels[0]

    def capacities(self, n: int) -> Tuple[int, ...]:
        caps = [n]
        for s in range(1, self.num_stages):
            w = self.enc_window[s]
            c = max(w, caps[-1] // self.pool_ratio)
            caps.append(_round_up(c, w))
        return tuple(caps)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _serialize_perms(grid, mask, orders):
    """Per-order (perm, inv) for a batched point set; each (B, N).

    All orders are folded into the batch dimension: one sort per level.
    """
    B = mask.shape[0]
    keys = [serialization_keys(grid, order) for order in orders]
    hi = torch.cat([k[0] for k in keys], dim=0)          # (O*B, N)
    lo = torch.cat([k[1] for k in keys], dim=0)
    perm = argsort_lex(hi, lo, mask.repeat(len(orders), 1))
    inv = inverse_permutation(perm)
    return {order: (perm[i * B:(i + 1) * B], inv[i * B:(i + 1) * B])
            for i, order in enumerate(orders)}


def _compose_perm(a, b):
    """Batched permutation composition: out[., t] = a[., b[., t]]."""
    return torch.gather(a, 1, b)


def _rows(x, idx):
    """x[b, idx[b, i]] for x (B, N, C) and idx (B, M): integer rows (no
    gradient)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _pool_structure_sorted(grid, mask, out_cap):
    """Pooling structure for inputs ALREADY in serialized order.

    A coarse cell's points are one contiguous run of the sorted stream.
    Returns (seg, grid_out, mask_out, parent, parent_ok, end_pos):
    seg (B, N) coarse slot per point (out_cap for dropped), grid_out
    (B, out_cap, 3), mask_out (B, out_cap), parent (B, N) slot per point
    (0-clamped), parent_ok (B, N), end_pos (B, out_cap) index of each
    cell's last member (0-clamped on empty slots).
    """
    B, n, _ = grid.shape
    dev = grid.device
    coarse = grid >> 1
    new = torch.ones((B, n), dtype=torch.int32, device=dev)
    new[:, 1:] = (coarse[:, 1:] != coarse[:, :-1]).any(-1).to(torch.int32)
    new = torch.where(mask, new, 0)
    vid = torch.cumsum(new, dim=1, dtype=torch.int32) - 1
    ok = mask & (vid >= 0) & (vid < out_cap)
    seg = torch.where(ok, vid, out_cap).to(torch.int64)
    num_cells = new.sum(dim=1)
    mask_out = (torch.arange(out_cap, device=dev)[None, :]
                < num_cells.clamp_max(out_cap)[:, None])
    idx = torch.arange(n, dtype=torch.int64, device=dev).expand(B, n)
    end_pos = torch.full((B, out_cap + 1), -1, dtype=torch.int64,
                         device=dev)
    end_pos.scatter_reduce_(1, seg, torch.where(ok, idx, -1), "amax",
                            include_self=True)
    end_pos = end_pos[:, :out_cap].clamp(0, n - 1)
    grid_out = torch.where(mask_out[..., None], _rows(coarse, end_pos), 0)
    parent = vid.clamp(0, out_cap - 1).to(torch.int64)
    return seg, grid_out, mask_out, parent, ok, end_pos


def _run_max_sorted(h, seg, end_pos, mask_out, max_run=8):
    """Per-cell max for SORTED features whose cells are contiguous runs of
    ≤ ``max_run`` elements: log2(max_run) shifted maxima carry each run's
    max to its last element, read out at ``end_pos``.

    INVARIANT: runs longer than ``max_run`` are silently truncated, so
    every input slot must be a DISTINCT grid cell.
    h: (B, N, C); seg: (B, N); end_pos: (B, V); mask_out (B, V), the
    live cells, a prefix, whose outputs alone may carry a gradient (the
    read-out's fixed-order backward, :func:`~tpu3dssf_torch.serialization.
    gather_rows`). Returns (B, V, C).
    """
    y = h
    shift = 1
    while shift < max_run:
        same = (seg[:, shift:] == seg[:, :-shift])[..., None]
        y = torch.cat([y[:, :shift],
                       torch.where(same, torch.maximum(y[:, shift:],
                                                       y[:, :-shift]),
                                   y[:, shift:])], dim=1)
        shift *= 2
    # empty slots read row 0 and are zeroed by the caller: the backward
    # leaves them out
    return gather_rows(y, end_pos, mask_out)


def _segment_max(values, seg, out_cap):
    """(B, N, C) values → (B, out_cap, C) per-segment max; segments ≥
    out_cap are dropped, empty segments hold -1e9."""
    B, N, C = values.shape
    out = torch.full((B, out_cap + 1, C), -1.0e9, dtype=values.dtype,
                     device=values.device)
    out.scatter_reduce_(1, seg[..., None].expand(-1, -1, C), values,
                        "amax", include_self=True)
    return out[:, :out_cap]


class _DepthwiseConv3(nn.Module):
    """Kernel-3 depthwise conv along the sequence as three shifted
    multiply-adds; parameters keep the flax layout (kernel (3, 1, C)).

    Sequence parallelism: with ``sp_axis`` set, the input is this rank's
    span of the sequence over that axis of the current mesh
    (:func:`tpu3dssf_torch.parallel.mesh.current_mesh`, entered by
    :func:`tpu3dssf_torch.parallel.sp_block_apply`), and the two shifted
    taps take their one-row halos from the neighbouring spans
    (:func:`tpu3dssf_torch.parallel.sp.halo_rows`); the end spans take
    zeros, the global zero padding, as JAX's ``ppermute`` gives them.
    """

    def __init__(self, channels, dtype=torch.float32, sp_axis=None):
        super().__init__()
        self.dtype = dtype
        self.sp_axis = sp_axis
        self.kernel = nn.Parameter(torch.zeros(3, 1, channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    @torch.no_grad()
    def reset_parameters(self, generator):
        self.kernel.copy_(lecun_normal(self.kernel.shape, 3, generator))
        self.bias.zero_()

    def forward(self, xs):
        k = self.kernel.to(self.dtype)
        b = self.bias.to(self.dtype)
        if self.sp_axis is not None:
            mesh = current_mesh()
            if mesh is None:
                raise ValueError("a sequence-parallel CPE runs inside a "
                                 "mesh (tpu3dssf_torch.parallel."
                                 "sp_block_apply)")
            halo_l, halo_r = halo_rows(xs, mesh, self.sp_axis)
            left = torch.cat([halo_l, xs[:, :-1]], dim=1)
            right = torch.cat([xs[:, 1:], halo_r], dim=1)
        else:
            left = F.pad(xs[:, :-1], (0, 0, 1, 0))
            right = F.pad(xs[:, 1:], (0, 0, 0, 1))
        return left * k[0, 0] + xs * k[1, 0] + right * k[2, 0] + b


class SerializedCPE(nn.Module):
    """Conditional positional encoding: depthwise conv along the serialized
    order + pointwise dense, residual."""

    def __init__(self, channels, dtype=torch.float32, sp_axis=None):
        super().__init__()
        self.sp_axis = sp_axis
        self.depthwise = _DepthwiseConv3(channels, dtype, sp_axis)
        self.pointwise = Dense(channels, channels, dtype)

    def forward(self, x, perm, inv, mask):
        if self.sp_axis is not None and perm is not None:
            raise ValueError("sequence-parallel CPE requires the CPE "
                             "order itself (perm=None): cross-order "
                             "permutations are global gathers")
        xs = x * mask[..., None]
        if perm is not None:
            xs = permutation_gather(xs, perm, inv)
        y = self.pointwise(self.depthwise(xs))
        if inv is not None:
            y = permutation_gather(y, inv, perm)
        return x + y * mask[..., None]


def attention_route(channels, heads, window):
    """The attention route of JAX's ``SerializedAttention``
    (``tpu3dssf/models/ptv3.py:394-422``) for a stage of ``channels`` and
    ``heads`` at window ``window``: "packed" (K1, or K2/K3 in training),
    "window_packed" (K1, or K4/K5) or "window" (K6, or K4/K5). JAX's rules
    are Mosaic's (128-lane blocks, at most 8 heads unrolled per body); the
    port follows them so that the same TPU kernel's counterpart runs."""
    group = pick_head_group(heads, channels) if heads > 8 else None
    if (window % 128 == 0 and channels % 128 == 0
            and (heads <= 8 or group is not None)):
        return "packed"
    if window % 128 == 0 and heads <= 8:
        return "window_packed"
    return "window"


def windowed_attention(qkvw, key_mask, heads):
    """Attention within each window of the (W, K, 3C) projection ``qkvw``
    under the (W, K) ``key_mask``, on the route of :func:`attention_route`
    (its kernel on a CUDA tensor), the masked query rows zeroed: (W, K,
    C)."""
    W, K, C3 = qkvw.shape
    C = C3 // 3
    route = attention_route(C, heads, K)
    if route == "packed":
        out = flash_attention_packed(qkvw, key_bias(key_mask), heads,
                                     1.0 / ((C // heads) ** 0.5))
        return out * key_mask[..., None].to(out.dtype)
    if route == "window_packed":
        return window_attention_packed(qkvw, key_mask, heads)
    # strided (W, K, H, D) views of the projection: no copy
    q, k, v = qkvw.unflatten(-1, (3, heads, C // heads)).unbind(2)
    return window_attention(q, k, v, key_mask).reshape(W, K, C)


class SerializedAttention(nn.Module):
    """Windowed MHA over one serialization order."""

    def __init__(self, channels, heads, window, dtype=torch.float32):
        super().__init__()
        self.channels, self.heads, self.window = channels, heads, window
        self.qkv = Dense(channels, 3 * channels, dtype)
        self.proj = Dense(channels, channels, dtype)

    def forward(self, x, perm, inv, mask):
        B, N, C = x.shape
        K = min(self.window, N)
        qkv = self.qkv(x)
        if perm is not None:
            qkv = permutation_gather(qkv, perm, inv)
            mask_s = torch.gather(mask, 1, perm)
        else:
            mask_s = mask
        W = N // K
        out = windowed_attention(qkv.reshape(B * W, K, 3 * C),
                                 mask_s.reshape(B * W, K), self.heads)
        out = out.reshape(B, N, C)
        if inv is not None:
            out = permutation_gather(out, inv, perm)
        return self.proj(out)


class DropPath(nn.Module):
    """Per-sample stochastic depth on a residual branch.

    One Bernoulli(1 − rate) draw per sample (leading dim) from
    ``generator``; kept samples are scaled by 1/keep. With rate 0 or no
    generator it is the identity (JAX's ``deterministic=True``). The masks
    are drawn on the generator's device and moved to ``x``'s.
    :meth:`draw` and :meth:`apply` are the two halves of the forward, for a
    caller that draws before a checkpointed region.
    """

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def draw(self, n, device, generator=None):
        """The (n,) keep mask on ``device``, or None for the identity."""
        if self.rate == 0.0 or generator is None:
            return None
        u = torch.rand((n,), generator=generator, device=generator.device)
        return (u < 1.0 - self.rate).to(device)

    def apply(self, x, keep_mask):
        if keep_mask is None:
            return x
        mask = keep_mask.reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(mask, x / (1.0 - self.rate), 0.0)

    def forward(self, x, generator=None):
        return self.apply(x, self.draw(x.shape[0], x.device, generator))


class PTv3Block(nn.Module):
    """CPE → pre-norm windowed attention → pre-norm MLP (all residual).

    The residual stream is in the CPE curve's sorted space; ``perm``/``inv``
    are the attention order's RELATIVE permutations, None when the block
    attends along the CPE order itself. ``keep1``/``keep2`` are the (B,)
    keep masks of the two DropPaths (None: the identity).
    ``remat`` checkpoints the whole block, ``remat_attention`` its
    attention branch (see the module docstring). ``sp_axis``: the block
    runs on one rank's span of the sequence over that mesh axis
    (:func:`tpu3dssf_torch.parallel.sp_block_apply`) and attends along the
    CPE order only.
    """

    def __init__(self, channels, heads, window, mlp_ratio, drop_path=0.0,
                 dtype=torch.float32, remat=False, remat_attention=False,
                 sp_axis=None):
        super().__init__()
        self.remat, self.remat_attention = remat, remat_attention
        self.window, self.sp_axis = window, sp_axis
        hidden = int(channels * mlp_ratio)
        self.cpe = SerializedCPE(channels, dtype, sp_axis)
        self.norm1 = LayerNorm(channels, dtype=dtype)
        self.attn = SerializedAttention(channels, heads, window, dtype)
        self.dp1 = DropPath(drop_path)
        self.norm2 = LayerNorm(channels, dtype=dtype)
        self.mlp_in = Dense(channels, hidden, dtype)
        self.mlp_out = Dense(hidden, channels, dtype)
        self.dp2 = DropPath(drop_path)

    def forward(self, x, perm, inv, mask, keep1=None, keep2=None):
        if self.sp_axis is not None and perm is not None:
            raise ValueError("sequence-parallel blocks must attend "
                             "along the CPE order (perm=None); see "
                             "tpu3dssf_torch.parallel.sp")
        return _remat(self.remat, self._body, x, perm, inv, mask, keep1,
                      keep2)

    def _body(self, x, perm, inv, mask, keep1, keep2):
        x = self.cpe(x, None, None, mask)
        h = _remat(self.remat_attention, self.attn, self.norm1(x), perm, inv,
                   mask)
        x = x + self.dp1.apply(h, keep1)
        h = F.gelu(self.mlp_in(self.norm2(x)), approximate="tanh")
        x = x + self.dp2.apply(self.mlp_out(h), keep2)
        return x * mask[..., None]


def _remat(on, fn, *args):
    """``fn(*args)``, checkpointed (non-reentrant) when ``on`` and a
    gradient is pending. Nothing inside draws random numbers, so no RNG
    state is stashed."""
    if on and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


class SerializedPooling(nn.Module):
    """Grid pooling of a stream already in serialized order: dense proj →
    max over 2x-coarser cells → LN → GELU."""

    def __init__(self, in_channels, channels, unique_cells=True,
                 dtype=torch.float32):
        super().__init__()
        self.unique_cells = unique_cells
        self.dtype = dtype
        self.proj = Dense(in_channels, channels, dtype)
        self.norm = LayerNorm(channels, dtype=dtype)

    def forward(self, x, grid, mask, out_cap):
        seg, grid_out, mask_out, parent, parent_ok, end_pos = \
            _pool_structure_sorted(grid, mask, out_cap)
        h = self.proj(x).float()
        if self.unique_cells:
            pooled = _run_max_sorted(h, seg, end_pos, mask_out)
        else:
            # duplicate cells: runs can exceed 8, so an exact segment max
            # ("empty" sentinel -1e9, far from f32 overflow)
            pooled = _segment_max(
                torch.where((seg < out_cap)[..., None], h, -1.0e9),
                seg, out_cap)
        pooled = torch.where(mask_out[..., None], pooled, 0.0).to(self.dtype)
        pooled = F.gelu(self.norm(pooled), approximate="tanh")
        pooled = pooled * mask_out[..., None]
        return pooled, grid_out, mask_out, parent, parent_ok


class SerializedUnpooling(nn.Module):
    """Broadcast coarse features to their children + project the skip."""

    def __init__(self, coarse_channels, skip_channels, channels,
                 dtype=torch.float32):
        super().__init__()
        self.proj = Dense(coarse_channels, channels, dtype)
        self.norm = LayerNorm(channels, dtype=dtype)
        self.proj_skip = Dense(skip_channels, channels, dtype)
        self.norm_skip = LayerNorm(channels, dtype=dtype)

    def forward(self, x_coarse, skip, parent, parent_ok, mask_fine):
        """Each parent's gradient is summed over its children in a fixed
        order (:func:`~tpu3dssf_torch.serialization.gather_rows`)."""
        up = gather_rows(self.norm(self.proj(x_coarse)), parent, parent_ok)
        up = torch.where(parent_ok[..., None], up, 0.0)
        sk = self.norm_skip(self.proj_skip(skip))
        out = F.gelu(up + sk, approximate="tanh")
        return out * mask_fine[..., None]


class PointTransformerV3(nn.Module):
    """Batched PTv3 over fixed-capacity masked point sets.

    Input:  feat (B, N, in_channels), grid_coord (B, N, 3) int, mask
            (B, N) bool; N a multiple of enc_window[0].
    Output: (feat (B, N, dec_channels[0]), mask).

    With ``config.unique_cells`` every valid grid_coord row must be a
    DISTINCT cell (what :func:`tpu3dssf_torch.voxel.voxelize` emits).
    """

    def __init__(self, config: PTv3Config):
        super().__init__()
        cfg = self.config = config
        remat = dict(remat=cfg.remat, remat_attention=cfg.remat_attention)
        dt = cfg.dtype
        self.embed = Dense(cfg.in_channels, cfg.enc_channels[0], dt)
        self.embed_norm = LayerNorm(cfg.enc_channels[0], dtype=dt)
        for s in range(cfg.num_stages):
            if s > 0:
                self.add_module(f"pool{s}", SerializedPooling(
                    cfg.enc_channels[s - 1], cfg.enc_channels[s],
                    unique_cells=(cfg.unique_cells or s > 1),
                    dtype=dt))
            for b in range(cfg.enc_depths[s]):
                self.add_module(f"enc{s}_blk{b}", PTv3Block(
                    cfg.enc_channels[s], cfg.enc_heads[s],
                    cfg.enc_window[s], cfg.mlp_ratio, cfg.drop_path, dt,
                    **remat))
        for d in reversed(range(cfg.num_stages - 1)):
            coarse = (cfg.enc_channels[-1] if d == cfg.num_stages - 2
                      else cfg.dec_channels[d + 1])
            self.add_module(f"unpool{d}", SerializedUnpooling(
                coarse, cfg.enc_channels[d], cfg.dec_channels[d], dt))
            for b in range(cfg.dec_depths[d]):
                self.add_module(f"dec{d}_blk{b}", PTv3Block(
                    cfg.dec_channels[d], cfg.dec_heads[d],
                    cfg.dec_window[d], cfg.mlp_ratio, cfg.drop_path, dt,
                    **remat))

    def blocks(self):
        """The blocks in the order the forward runs them."""
        cfg = self.config
        names = [f"enc{s}_blk{b}" for s in range(cfg.num_stages)
                 for b in range(cfg.enc_depths[s])]
        names += [f"dec{d}_blk{b}"
                  for d in reversed(range(cfg.num_stages - 1))
                  for b in range(cfg.dec_depths[d])]
        return [getattr(self, n) for n in names]

    def draw_keep(self, rows, generator):
        """The keep masks of every DropPath for a batch of ``rows``:
        (2 · blocks, rows) bool on the generator's device, one
        ``torch.rand((rows,))`` draw per DropPath in forward order (each
        block's attention branch, then its MLP); None where no DropPath
        drops (rate 0)."""
        keep = [dp.draw(rows, generator.device, generator)
                for blk in self.blocks() for dp in (blk.dp1, blk.dp2)]
        if any(k is None for k in keep):
            return None
        return torch.stack(keep)

    def _run_blocks(self, x, perms, msk, depth, name, keep):
        orders = self.config.orders
        for b in range(depth):
            perm, inv = perms[orders[b % len(orders)]]
            pair = ((None, None) if keep is None
                    else (next(keep), next(keep)))
            x = getattr(self, f"{name}_blk{b}")(x, perm, inv, msk, *pair)
        return x

    def forward(self, feat, grid_coord, mask, keep=None):
        """``keep``: the DropPath masks of :meth:`draw_keep` on the
        features' device, or None (no DropPath)."""
        cfg = self.config
        keep = None if keep is None else iter(keep)
        caps = cfg.capacities(feat.shape[1])
        orders = cfg.orders
        cpe_order = orders[0]

        def used_orders(depth):
            used = {orders[b % len(orders)] for b in range(depth)}
            used.add(cpe_order)
            return tuple(o for o in orders if o in used)

        def sorted_space(perms_orig):
            perm_c, inv_c = perms_orig[cpe_order]
            rel = {o: ((None, None) if o == cpe_order else
                       (_compose_perm(inv_c, p), _compose_perm(i, perm_c)))
                   for o, (p, i) in perms_orig.items()}
            return perm_c, inv_c, rel

        x = self.embed_norm(self.embed(feat)) * mask[..., None]
        grid, msk = grid_coord, mask
        skips, pools, cpe_sorts = [], [], []

        # ---- encoder ----
        for s in range(cfg.num_stages):
            if s > 0:
                with span("ptv3.pool", feat):
                    x, grid, msk, parent, parent_ok = getattr(
                        self, f"pool{s}")(x, grid, msk, caps[s])
                pools.append((parent, parent_ok))
            if s > 0 and cfg.collapse_pooled_orders:
                # hierarchical curve: the pooled stream is already in this
                # stage's CPE order; other orders' fresh perms are relative
                need = tuple(o for o in used_orders(cfg.enc_depths[s])
                             if o != cpe_order)
                perms = {cpe_order: (None, None)}
                if need:
                    with span("ptv3.serialize", feat):
                        perms.update(_serialize_perms(grid, msk, need))
                cpe_sorts.append(None)
            else:
                with span("ptv3.serialize", feat):
                    perms_orig = _serialize_perms(
                        grid, msk, used_orders(cfg.enc_depths[s]))
                    perm_c, inv_c, perms = sorted_space(perms_orig)
                    x = permutation_gather(x, perm_c, inv_c)
                    grid = _rows(grid, perm_c)
                    msk = torch.gather(msk, 1, perm_c)
                cpe_sorts.append((perm_c, inv_c))
            with span("ptv3.blocks", feat):
                x = self._run_blocks(x, perms, msk, cfg.enc_depths[s],
                                     f"enc{s}", keep)
            skips.append((x, grid, msk, perms))

        # ---- decoder ----
        for d in reversed(range(cfg.num_stages - 1)):
            skip_x, skip_grid, skip_mask, skip_perms = skips[d]
            parent, parent_ok = pools[d]
            with span("ptv3.unpool", feat):
                if cpe_sorts[d + 1] is not None:
                    parent = _compose_perm(cpe_sorts[d + 1][1], parent)
                x = getattr(self, f"unpool{d}")(x, skip_x, parent, parent_ok,
                                                skip_mask)
            grid, msk = skip_grid, skip_mask
            need = used_orders(cfg.dec_depths[d])
            missing = tuple(o for o in need if o not in skip_perms)
            perms = dict(skip_perms)
            if missing:
                with span("ptv3.serialize", feat):
                    perms.update(_serialize_perms(grid, msk, missing))
            with span("ptv3.blocks", feat):
                x = self._run_blocks(x, perms, msk, cfg.dec_depths[d],
                                     f"dec{d}", keep)

        perm0, inv0 = cpe_sorts[0]
        with span("ptv3.serialize", feat):
            return permutation_gather(x, inv0, perm0), mask
