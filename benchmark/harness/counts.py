"""The yardstick's arithmetic: valid tokens, model FLOPs and the least time
of the attention and k-NN problems of a batch, from its shapes and its
own voxelization, against the H100 SXM's published peaks.

Roofline bound of a problem: the larger of its tensor-core products at the
bf16 peak and its bytes at the HBM rate (each input byte read once, each
output byte written once); the k-NN's operations are f32 at the f32 peak.
Only valid (occupied) tokens, points and voxels count, so a kernel that
skips padding still reads at most 100%. The attention bound leaves out
the exponentials, which the card can also compute on its FMA pipes:
``Work.attn_exp_s`` gives that term for the record. The arithmetic
is that of the program's checker, restated here; the widths are the
configuration's (:mod:`benchmark.reference.widths`).
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference import widths
from benchmark.reference.vit import ViTConfig
from benchmark.reference.widths import PTv3Widths

# NVIDIA H100 SXM data sheet: dense bf16 tensor cores, f32 outside them,
# HBM3; and the exponential rate of 16 a clock on each of 132 SMs at the
# 1,980 MHz maximum clock
BF16_FLOPS, F32_FLOPS, HBM_BYTES = 989e12, 67e12, 3.35e12
EXP_RATE = 16 * 132 * 1980e6
KNN_OPS_PER_PAIR = 9      # 8 f32 operations of the distance, 1 compare


@dataclasses.dataclass
class Work:
    """One batch's counts: model FLOPs (forward), the attention problems'
    least seconds and exponential seconds, the k-NN problems' least
    seconds."""

    flops: float = 0.0
    attn_s: float = 0.0
    attn_exp_s: float = 0.0
    knn_s: float = 0.0

    def __add__(self, other):
        return Work(*(a + b for a, b in zip(dataclasses.astuple(self),
                                            dataclasses.astuple(other))))


def bound_s(flops, nbytes, peak=BF16_FLOPS):
    return max(flops / peak, nbytes / HBM_BYTES)


def windows(n: int, window: int):
    """The valid tokens of each window of a stage with ``n`` valid tokens:
    full windows, then the remainder (empty slots sort last)."""
    full, rest = divmod(n, window)
    return [window] * full + ([rest] if rest else [])


def attention_work(sizes, width: int, heads: int, train=False) -> Work:
    """Attention of one block over windows of ``sizes`` valid tokens at
    ``width`` channels. Forward: QKᵀ and PV, 4·w²·C FLOPs a window; bytes:
    q, k, v and the output in bf16 and a 4-byte key bias a token (with
    ``train``, and an f32 log-sum-exp a head). With ``train`` also the
    backward: QKᵀ again and dV, dP, dQ, dK, 10·w²·C; bytes: q, k, v, the
    output's gradient, the bias, the statistics (8 bytes a head) and dq,
    dk, dv. Exponentials: one a score a pass."""
    sq = sum(w * w for w in sizes)
    tokens = sum(sizes)
    C, H = width, heads
    fwd = 4.0 * sq * C
    w = Work(flops=fwd,
             attn_s=bound_s(fwd, tokens * (8 * C + 4 + (4 * H if train
                                                          else 0))),
             attn_exp_s=H * sq / EXP_RATE)
    if train:
        bwd = 10.0 * sq * C
        w = w + Work(flops=bwd,
                     attn_s=bound_s(bwd, tokens * (14 * C + 4 + 8 * H)),
                     attn_exp_s=H * sq / EXP_RATE)
    return w


def vit_work(images: int, v: ViTConfig) -> Work:
    """The frozen ViT's forward over ``images`` images (the resize before
    it is preprocessing and not counted): the patch embedding, then each
    block's attention over all tokens and its dense layers (qkv,
    projection, MLP)."""
    C, P = v.hidden_size, v.patch_size
    patches = v.grid_size[0] * v.grid_size[1]
    N = v.num_prefix_tokens + patches
    dense = 2.0 * N * (4 + 2 * v.mlp_ratio) * C * C
    w = Work(flops=2.0 * patches * P * P * 3 * C)
    for _ in range(v.num_layers):
        w = w + attention_work([N], C, v.num_heads) + Work(flops=dense)
    return Work(*(images * x for x in dataclasses.astuple(w)))


def block_work(n: int, C: int, heads: int, s: PTv3Widths,
               train=False) -> Work:
    """One PTv3 block on ``n`` valid tokens: the CPE's pointwise dense,
    qkv, the projection and the MLP (13·C² MACs a token at ratio 4; with
    ``train`` three times, forward and backward), and the windowed
    attention."""
    dense = 2.0 * n * (1 + 3 + 1 + 2 * s.mlp_ratio) * C * C
    return (attention_work(windows(n, s.window), C, heads, train)
            + Work(flops=dense * (3 if train else 1)))


def ptv3_work(stage_tokens, s: PTv3Widths, train=False) -> Work:
    """PTv3's forward (with ``train`` and its backward: the dense layers
    three times) on one sample whose stages hold ``stage_tokens`` valid
    tokens: embedding, blocks, pooling projections (on the finer tokens),
    unpooling projections (coarse and skip)."""
    blocks = ptv3_blocks(stage_tokens, s, train)
    return Work(flops=ptv3_dense_flops(stage_tokens, s)
                * (3 if train else 1)) + blocks


def ptv3_blocks(n, s: PTv3Widths, train=False) -> Work:
    S = s.stages
    w = Work()
    for st in range(S):
        for _ in range(s.enc_depths[st]):
            w = w + block_work(n[st], s.enc_channels[st], s.enc_heads[st], s,
                               train)
    for d in reversed(range(S - 1)):
        for _ in range(s.dec_depths[d]):
            w = w + block_work(n[d], s.dec_channels[d], s.dec_heads[d], s,
                               train)
    return w


def ptv3_dense_flops(stage_tokens, s: PTv3Widths) -> float:
    """The forward FLOPs of PTv3's layers outside its blocks."""
    n = stage_tokens
    S = s.stages
    flops = 2.0 * n[0] * s.in_channels * s.enc_channels[0]
    for st in range(1, S):
        flops += 2.0 * n[st - 1] * s.enc_channels[st - 1] * s.enc_channels[st]
    for d in reversed(range(S - 1)):
        coarse = s.enc_channels[-1] if d == S - 2 else s.dec_channels[d + 1]
        flops += 2.0 * (n[d + 1] * coarse + n[d] * s.enc_channels[d]) \
            * s.dec_channels[d]
    return flops


def head_work(voxels: int, dims) -> Work:
    """The head's dense layers over ``dims``' widths per voxel (the fusion
    MLP 448→256→64→16, or the LiDAR head 64→16)."""
    macs = sum(a * b for a, b in zip(dims, dims[1:]))
    return Work(flops=2.0 * voxels * macs)


def knn_work(queries: int, refs: int, k: int) -> Work:
    """One k-NN problem of ``queries`` valid queries against ``refs`` valid
    refs: 9 f32 operations a pair; queries and refs (xyz f32, refs with a
    mask byte) read once, k (distance, index) pairs written a query."""
    ops = KNN_OPS_PER_PAIR * queries * refs
    nbytes = queries * 12 + refs * 13 + queries * k * 8
    return Work(knn_s=bound_s(ops, nbytes, F32_FLOPS))


def stage_tokens(points, point_valid, voxel_size, capacity, window=1024,
                 stages=5):
    """Valid tokens of each PTv3 stage of each sample, (B, stages) ints:
    the benchmark's own voxelization of the inputs (at most ``capacity``
    voxels), then each 2x-coarser grid's cells in the stage's capacity."""
    from benchmark.reference.ptv3 import capacities, pool_structure, serialize
    from benchmark.reference.voxel import voxelize

    with torch.no_grad():
        vox = voxelize(points, point_valid, voxel_size, capacity, "mean")
        caps = capacities(capacity, (window,) * stages)
        perm, _ = serialize(vox.coords, vox.mask, "z")
        grid = torch.gather(vox.coords, 1, perm[..., None].expand(-1, -1, 3))
        mask = torch.gather(vox.mask, 1, perm)
        counts = [mask.sum(1)]
        for s in range(1, stages):
            grid, mask = pool_structure(grid, mask, caps[s])[:2]
            counts.append(mask.sum(1))
    return torch.stack(counts, 1).tolist()


def batch_work(batch, cfg, train=False) -> Work:
    """All counted work of one batch of the pool (a dict of host tensors)
    under config ``cfg`` (the program's Config), at the widths of
    :func:`benchmark.reference.widths.of`: the frozen ViT's forward over
    every camera of each sample, the model's forward and, with ``train``,
    its backward (three times a dense layer's forward FLOPs; the attention's
    own backward count)."""
    table = widths.of(cfg)
    B = batch["points"].shape[0]
    tokens = stage_tokens(batch["points"], batch["point_valid"],
                          cfg.voxel_size, cfg.tpu.voxel_capacity,
                          table.ptv3.window, table.ptv3.stages)
    cameras = B * batch["cam_intrinsics"].shape[1]
    w = vit_work(cameras, table.vit) if table.fusion else Work()
    valid_points = batch["point_valid"].sum(1).tolist()
    for n, p in zip(tokens, valid_points):
        head = head_work(n[0], table.head)
        w = w + ptv3_work(n, table.ptv3, train) + Work(
            flops=head.flops * (3 if train else 1))
        if cfg.tpu.intensity_mode == "knn5":
            w = w + knn_work(n[0], p, 5)
        if cfg.tpu.devoxelize_mode == "nearest":
            w = w + knn_work(p, n[0], 1)
    return w
