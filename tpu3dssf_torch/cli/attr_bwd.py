"""Attribute the train step, piece by piece, on the card: the port of
``scripts/attr_bwd.py``.

    python3 tpu3dssf_torch/cli/attr_bwd.py [--r 10] [--out FILE]
    python -m tpu3dssf_torch.cli.attr_bwd --device cpu --tiny   # tests

Isolated pieces at the exact train shapes (B = 2, 25,600 voxels,
``PTv3Config().capacities(25600)``, window 1024, bf16), each forward and
forward + backward (the gradients of parameters and inputs), each timed as
a CUDA graph of ``--r`` repeats (:mod:`tpu3dssf_torch.cli.pieces`):

* a ``PTv3Block`` at every stage (enc0–4, dec0–3) on random permutations,
  one row per stage, and the depth-weighted sums;
* its sub-blocks at every distinct stage shape: ``SerializedAttention``
  along another order (``attn(perm)``) and along its own (``attn(none)``),
  ``SerializedCPE``, and the MLP (norm2, mlp_in, GELU, mlp_out and the
  residual) — the block's own modules;
* the permutation gather's VJP three ways: ``permutation_gather`` (the
  backward gathers by the inverse), ``gather_rows`` (the backward sorts
  and segment-sums) and a plain gather whose VJP is ``index_add_``; with
  the forward gather alone;
* ``SerializedPooling`` s-1 → s and ``SerializedUnpooling`` d+1 → d at
  every level (the JAX script times level 1);
* the devoxelizing own-voxel gather (34,816 points from 25,600 voxels of
  16 scores), ``devoxelize_own_voxel``;
* CE + Lovász (``CELSLoss``, unit class weights) on (2, 34,816, 16);
* the fused AdamW update (:mod:`tpu3dssf_torch.train.state`) over the
  LiDAR-only model's parameters.

Then the sum of parts (the depth-weighted block forward + backward,
pooling, unpooling, devoxelize, loss and AdamW) beside the graphed train
step it attributes: the LiDAR-only step at B = 2 that
``cli/bench_train.py`` builds, and the fusion step beside it; the
remainder is what the pieces leave out (voxelize, serialization, embed,
head, the fusion head). DropPath is off (rate 0), as in the JAX script.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

B, N0, WINDOW = 2, 25600, 1024
GATHERS = ((25600, 96), (25600, 32), (13312, 192), (4096, 768))
P, V, K = 34816, 25600, 16
# --tiny: two stages, narrow widths (CPU tests)
TINY = dict(n0=128, window=32, gathers=((128, 24), (64, 48)), points=192,
            voxels=128, tokens=(6, 4, 16))


def tiny_config():
    from tpu3dssf_torch.models.ptv3 import PTv3Config
    return PTv3Config(orders=("z", "z-trans"), enc_depths=(1, 2),
                      enc_channels=(16, 32), enc_heads=(1, 2),
                      enc_window=(32, 32), dec_depths=(1,),
                      dec_channels=(16,), dec_heads=(1,), dec_window=(32,))


def stages(cfg, n0):
    """(name, N, C, H, window, depth) of every stage, encoder then
    decoder."""
    caps = cfg.capacities(n0)
    out = [(f"enc{s}", caps[s], cfg.enc_channels[s], cfg.enc_heads[s],
            cfg.enc_window[s], cfg.enc_depths[s])
           for s in range(cfg.num_stages)]
    return out + [(f"dec{d}", caps[d], cfg.dec_channels[d], cfg.dec_heads[d],
                   cfg.dec_window[d], cfg.dec_depths[d])
                  for d in range(cfg.num_stages - 1)]


def perms(p, rng, batch, n):
    """(perm, inv) of ``batch`` random permutations of n, int64 on the
    device."""
    perm = np.stack([rng.permutation(n) for _ in range(batch)])
    inv = np.argsort(perm, axis=1)
    return p.tensor(perm), p.tensor(inv)


def block_fwd_bwd(blk, x, perm, inv, mask):
    """A block's forward and the gradients of its f32 output sum with
    respect to its parameters and ``x``: (sum, gradients)."""
    from tpu3dssf_torch.cli.pieces import fwd_bwd
    return fwd_bwd(lambda xx: blk(xx, perm, inv, mask), blk.parameters(),
                   [x])


def mlp(blk):
    """The MLP half of a block, with its residual (its own modules)."""
    import torch.nn.functional as F
    return lambda x: x + blk.mlp_out(F.gelu(blk.mlp_in(blk.norm2(x)),
                                            approximate="tanh"))


def mlp_parameters(blk):
    return [p for m in (blk.norm2, blk.mlp_in, blk.mlp_out)
            for p in m.parameters()]


def run_blocks(p, cfg, n0, batch, rng):
    """Per-stage blocks, then the sub-blocks at each distinct stage
    shape."""
    from tpu3dssf_torch.cli.pieces import (attention_launches, fwd_bwd,
                                           layer_norm_launches, no_grad, plus)
    from tpu3dssf_torch.models.ptv3 import PTv3Block
    done = set()
    for name, n, C, H, W, depth in stages(cfg, n0):
        x = p.tensor(rng.normal(size=(batch, n, C)) * 0.1)
        mask = torch.ones((batch, n), dtype=torch.bool, device=p.device)
        perm, inv = perms(p, rng, batch, n)
        w = min(W, n)
        blk = p.module(PTv3Block(C, H, w, cfg.mlp_ratio, dtype=p.dtype))
        shape = dict(stage=name, N=n, C=C, H=H)
        p.time(f"{name} block fwd", no_grad(
            lambda xx: blk(xx, perm, inv, mask)), x, depth=depth,
            launches=plus(attention_launches(C, H, w, False),
                          layer_norm_launches(2, False)),
            kind="block_fwd", **shape)
        p.time(f"{name} block fwd+bwd",
               lambda xx: block_fwd_bwd(blk, xx, perm, inv, mask), x,
               depth=depth, launches=plus(attention_launches(C, H, w, True),
                                          layer_norm_launches(2, True)),
               kind="block_fwd_bwd", **shape)
        if (n, C, H) in done:
            continue
        done.add((n, C, H))
        # label, piece, its parameters, its attention, its LayerNorms
        for label, fn, params, attn, norms in (
                ("attn(perm)", lambda xx: blk.attn(xx, perm, inv, mask),
                 blk.attn.parameters, True, 0),
                ("attn(none)", lambda xx: blk.attn(xx, None, None, mask),
                 blk.attn.parameters, True, 0),
                ("cpe", lambda xx: blk.cpe(xx, None, None, mask),
                 blk.cpe.parameters, False, 0),
                ("mlp", mlp(blk), lambda: mlp_parameters(blk), False, 1)):
            for grad in (False, True):
                kind = "fwd+bwd" if grad else "fwd"
                run = ((lambda xx, fn=fn, params=params:
                        fwd_bwd(fn, params(), [xx])) if grad
                       else no_grad(fn))
                p.time(f"{name} {label} {kind}", run, x,
                       launches=plus(
                           attention_launches(C, H, w, grad) if attn else {},
                           layer_norm_launches(norms, grad)),
                       kind=f"sub_{'fwd_bwd' if grad else 'fwd'}",
                       sub=label, **shape)


def run_gathers(p, gathers, batch, rng):
    """The permutation gather's VJP three ways, and the forward alone."""
    from tpu3dssf_torch.serialization import gather_rows, permutation_gather
    from tpu3dssf_torch.serialization.partition import _gather_rows

    def vjp(f, x):
        xx = x.detach().requires_grad_(True)
        out = f(xx)
        return torch.autograd.grad(out, xx, out)

    for n, C in gathers:
        x = p.tensor(rng.normal(size=(batch, n, C)))
        perm, inv = perms(p, rng, batch, n)
        ok = torch.ones((batch, n), dtype=torch.bool, device=p.device)
        flat = (perm + n * torch.arange(batch, device=p.device)[:, None]
                ).reshape(-1)

        def index_add(xx, perm=perm, flat=flat, n=n, C=C):
            out = _gather_rows(xx, perm)
            return torch.zeros((batch * n, C), dtype=xx.dtype,
                               device=xx.device).index_add_(
                0, flat, out.reshape(-1, C))

        shape = dict(N=n, C=C, kind="gather")
        p.time(f"gather (N={n}, C={C}) fwd alone",
               lambda xx, perm=perm: _gather_rows(xx, perm), x, **shape)
        p.time(f"gather (N={n}, C={C}) permutation_gather fwd+bwd",
               lambda xx, perm=perm, inv=inv: vjp(
                   lambda y: permutation_gather(y, perm, inv), xx), x,
               **shape)
        p.time(f"gather (N={n}, C={C}) gather_rows fwd+bwd",
               lambda xx, perm=perm, ok=ok: vjp(
                   lambda y: gather_rows(y, perm, ok), xx), x, **shape)
        p.time(f"gather (N={n}, C={C}) index_add_ fwd+bwd", index_add, x,
               **shape)


def pool_inputs(p, rng, batch, n):
    """A sorted stream of distinct cells (strictly increasing rows), as the
    JAX script makes it, and its all-valid mask."""
    g = np.sort(rng.permutation(2 ** 21)[:batch * n].reshape(batch, n),
                axis=1)
    grid = np.stack([g % 1024, (g // 1024) % 1024, g // (1024 * 1024)], -1)
    return (p.tensor(grid.astype(np.int32)),
            torch.ones((batch, n), dtype=torch.bool, device=p.device))


def run_pooling(p, cfg, n0, batch, rng):
    """Pooling s-1 → s and unpooling d+1 → d at every level."""
    from tpu3dssf_torch.cli.pieces import fwd_bwd, layer_norm_launches, no_grad
    from tpu3dssf_torch.models.ptv3 import (SerializedPooling,
                                            SerializedUnpooling)
    caps = cfg.capacities(n0)
    for s in range(1, cfg.num_stages):
        n, out_cap = caps[s - 1], caps[s]
        cin, cout = cfg.enc_channels[s - 1], cfg.enc_channels[s]
        x = p.tensor(rng.normal(size=(batch, n, cin)) * 0.1)
        grid, mask = pool_inputs(p, rng, batch, n)
        pool = p.module(SerializedPooling(cin, cout, dtype=p.dtype))

        def pooled(xx, pool=pool, grid=grid, mask=mask, out_cap=out_cap):
            return pool(xx, grid, mask, out_cap)[0]

        info = dict(kind="pool", N=n, out=out_cap, C=cout)
        p.time(f"pool{s} ({n}->{out_cap}) fwd", no_grad(pooled), x,
               launches=layer_norm_launches(1, False), **info)
        p.time(f"pool{s} ({n}->{out_cap}) fwd+bwd",
               lambda xx, pooled=pooled, pool=pool: fwd_bwd(
                   pooled, pool.parameters(), [xx]), x,
               launches=layer_norm_launches(1, True),
               **dict(info, kind="pool_fwd_bwd"))
    for d in range(cfg.num_stages - 1):
        nf, nc = caps[d], caps[d + 1]
        cc = (cfg.enc_channels[-1] if d == cfg.num_stages - 2
              else cfg.dec_channels[d + 1])
        cs, cd = cfg.enc_channels[d], cfg.dec_channels[d]
        xc = p.tensor(rng.normal(size=(batch, nc, cc)) * 0.1)
        skip = p.tensor(rng.normal(size=(batch, nf, cs)) * 0.1)
        parent = p.tensor(np.sort(rng.integers(0, nc, (batch, nf)), axis=1))
        ok = torch.ones((batch, nf), dtype=torch.bool, device=p.device)
        unpool = p.module(SerializedUnpooling(cc, cs, cd, dtype=p.dtype))

        def up(a, b, unpool=unpool, parent=parent, ok=ok):
            return unpool(a, b, parent, ok, ok)

        info = dict(kind="unpool", N=nf, coarse=nc, C=cd)
        p.time(f"unpool{d} ({nc}->{nf}) fwd", no_grad(up), xc, skip,
               launches=layer_norm_launches(2, False), **info)
        p.time(f"unpool{d} ({nc}->{nf}) fwd+bwd",
               lambda a, b, up=up, unpool=unpool: fwd_bwd(
                   up, unpool.parameters(), [a, b]), xc, skip,
               launches=layer_norm_launches(2, True),
               **dict(info, kind="unpool_fwd_bwd"))


def loss_fwd_bwd(loss, logits, labels, mask):
    """CE + Lovász and its gradient with respect to ``logits``."""
    lg = logits.detach().requires_grad_(True)
    total = loss(lg, labels, mask).total
    return total, torch.autograd.grad(total, lg)


def run_head(p, points, voxels, batch, rng):
    """The devoxelizing gather and the loss."""
    from tpu3dssf_torch.cli.bench_train import loss_fn
    from tpu3dssf_torch.cli.pieces import no_grad
    from tpu3dssf_torch.voxel import devoxelize_own_voxel

    pv = p.tensor(rng.integers(0, voxels, (batch, points)))
    ok = torch.ones((batch, points), dtype=torch.bool, device=p.device)
    vv = p.tensor(rng.normal(size=(batch, voxels, K)))

    def devox(v):
        return devoxelize_own_voxel(pv, ok, v)[0]

    def devox_vjp(v):
        vr = v.detach().requires_grad_(True)
        out = devox(vr)
        return torch.autograd.grad(out, vr, out)

    name = f"devox gather ({points} pts -> {voxels} vox, {K})"
    p.time(f"{name} fwd", no_grad(devox), vv, kind="devox")
    p.time(f"{name} fwd+bwd", devox_vjp, vv, kind="devox_fwd_bwd")

    loss = loss_fn()
    logits = p.tensor(rng.normal(size=(batch, points, K)), torch.float32)
    labels = p.tensor(rng.integers(0, 17, (batch, points)).astype(np.int32))
    mask = torch.ones((batch, points), dtype=torch.bool, device=p.device)
    name = f"CE+Lovasz loss ({batch * points} pts)"
    p.time(f"{name} fwd", no_grad(lambda lg: loss(lg, labels, mask).total),
           logits, kind="loss")
    p.time(f"{name} fwd+bwd",
           lambda lg: loss_fwd_bwd(loss, lg, labels, mask), logits,
           kind="loss_fwd_bwd")


def lidar_model(p, cfg, voxels):
    from tpu3dssf_torch.cli.bench_train import row_config
    from tpu3dssf_torch.models.lidar_only import LidarSegmentationModel
    return p.module(LidarSegmentationModel(row_config(
        1, p.dtype, voxels, cfg)))


def run_adamw(p, cfg, voxels):
    """The fused AdamW update over the LiDAR-only model's parameters (its
    gradients seeded random)."""
    from tpu3dssf_torch.cli.bench_train import train_state
    model = lidar_model(p, cfg, voxels)
    state = train_state(model)
    gen = torch.Generator().manual_seed(0)
    for q in model.parameters():
        q.grad = torch.randn(q.shape, generator=gen).to(q.device) * 1e-3
    count = sum(q.numel() for q in model.parameters())
    # the update reads its state through the closure; the graph takes one
    # tensor argument, which puts it on the device
    anchor = torch.zeros((1,), device=p.device)
    p.time(f"AdamW ({count:,} params)", lambda _: state.optimizer.step(),
           anchor, kind="adamw", params=count)
    del state, model


def ptv3_norms(cfg):
    """The LayerNorms of one PTv3 forward: two a block, the embedding's,
    one a pooling and two an unpooling."""
    return (2 * (sum(cfg.enc_depths) + sum(cfg.dec_depths)) + 1
            + 3 * (cfg.num_stages - 1))


def step_launches(cfg, n0, grad=True):
    """The launches of one PTv3 forward at ``n0`` points (with ``grad``: a
    train step's, each forward with LSE and its backward): every block's
    attention (:func:`~tpu3dssf_torch.cli.pieces.attention_launches`) and
    every LayerNorm (:func:`ptv3_norms`)."""
    from tpu3dssf_torch.cli.pieces import (attention_launches,
                                           layer_norm_launches)
    out = layer_norm_launches(ptv3_norms(cfg), grad)
    for _, n, C, H, W, depth in stages(cfg, n0):
        for k, v in attention_launches(C, H, min(W, n), grad).items():
            out[k] = out.get(k, 0) + v * depth
    return out


def whole_steps(p, cfg, points, voxels, batch, tokens_shape):
    """The graphed train steps the pieces attribute, each from
    ``cli/bench_train.py``: LiDAR-only and fusion at ``batch``, wall ms
    (CUDA events), the profiler's device ms of one step and its launches,
    held to :func:`step_launches` on the card."""
    from tpu3dssf_torch.cli.bench_train import (loss_fn, row_config,
                                                time_graph, train_batch,
                                                train_state)
    from tpu3dssf_torch.models.fusion import SegmentationPipeline
    from tpu3dssf_torch.train.graph import graph_train_step
    from tpu3dssf_torch.train.loop import make_train_step

    rng = np.random.default_rng(0)
    batch_d = train_batch(rng, batch, points, p.device)
    out = {}
    for name in ("lidar-only", "fusion"):
        if name == "lidar-only":
            model = lidar_model(p, cfg, voxels)
            tokens = torch.zeros((batch, 1, 1, 1), device=p.device)
        else:
            model = p.module(SegmentationPipeline(row_config(
                tokens_shape[-1], p.dtype, voxels, cfg)))
            tokens = p.tensor(rng.normal(size=(batch,) + tokens_shape)
                              * 0.02)
        state = train_state(model)
        step = graph_train_step(make_train_step(loss_fn()))

        def call():
            return step(state, batch_d, tokens)

        row = time_graph(call, p.device, p.replays)
        device_ms = None
        if p.cuda:
            from tpu3dssf_torch.utils import profile_kernels
            _, kernels, _ = profile_kernels(call, reps=1)
            device_ms = sum(us for us, _ in kernels.values()) / 1e3
        want = step_launches(cfg, voxels)
        if p.cuda and row["launches"] != want:
            raise AssertionError(f"{name} train step: launches "
                                 f"{row['launches']}, expected {want}")
        out[name] = dict(ms=row["ms"], device_ms=device_ms,
                         launches=row["launches"])
        dev = "not measured" if device_ms is None else f"{device_ms:.3f} ms"
        print(f"whole {name} train step (B={batch}): {row['ms']:.3f} ms "
              f"(device {dev}) launches {row['launches']}", flush=True)
        del model, state, step
    return out


def summarize(p, wholes):
    """The depth-weighted block sums and the sum of parts beside each
    whole step, with the remainder."""
    blocks = {k: p.weighted(lambda r, k=k: r.get("kind") == k)
              for k in ("block_fwd", "block_fwd_bwd")}
    parts = {
        "blocks_fwd_bwd": blocks["block_fwd_bwd"],
        "pooling_fwd_bwd": p.weighted(
            lambda r: r.get("kind") == "pool_fwd_bwd"),
        "unpooling_fwd_bwd": p.weighted(
            lambda r: r.get("kind") == "unpool_fwd_bwd"),
        "devoxelize_fwd_bwd": p.weighted(
            lambda r: r.get("kind") == "devox_fwd_bwd"),
        "loss_fwd_bwd": p.weighted(lambda r: r.get("kind") == "loss_fwd_bwd"),
        "adamw": p.weighted(lambda r: r.get("kind") == "adamw"),
    }
    total = sum(parts.values())
    sums = dict(block_fwd_depth_weighted=blocks["block_fwd"],
                block_fwd_bwd_depth_weighted=blocks["block_fwd_bwd"],
                block_bwd_depth_weighted=(blocks["block_fwd_bwd"]
                                          - blocks["block_fwd"]),
                parts=parts, sum_of_parts=total,
                wholes={k: dict(w, remainder_ms=w["ms"] - total)
                        for k, w in wholes.items()})
    print(f"depth-weighted blocks: fwd {blocks['block_fwd']:.3f} ms, "
          f"fwd+bwd {blocks['block_fwd_bwd']:.3f} ms, bwd "
          f"{sums['block_bwd_depth_weighted']:.3f} ms")
    for k, w in sums["wholes"].items():
        print(f"sum of parts {total:.3f} ms vs the graphed {k} train step "
              f"{w['ms']:.3f} ms: remainder {w['remainder_ms']:.3f} ms "
              f"{json.dumps(parts)}", flush=True)
    return sums


def main(argv=None):
    from tpu3dssf_torch.cli.bench_train import TOKENS
    from tpu3dssf_torch.cli.pieces import Pieces, arguments
    from tpu3dssf_torch.models.ptv3 import PTv3Config

    args = arguments(__doc__.splitlines()[0], r=10).parse_args(argv)
    p = Pieces("attr_bwd", args)
    if args.tiny:
        cfg, n0 = tiny_config(), TINY["n0"]
        gathers, points, voxels = (TINY["gathers"], TINY["points"],
                                   TINY["voxels"])
        tokens = TINY["tokens"]
    else:
        cfg = PTv3Config(enc_window=(WINDOW,) * 5, dec_window=(WINDOW,) * 4)
        n0, gathers, points, voxels, tokens = N0, GATHERS, P, V, TOKENS
    rng = np.random.default_rng(0)
    run_blocks(p, cfg, n0, B, rng)
    run_gathers(p, gathers, B, rng)
    run_pooling(p, cfg, n0, B, rng)
    run_head(p, points, voxels, B, rng)
    run_adamw(p, cfg, voxels)
    wholes = whole_steps(p, cfg, points, voxels, B, tuple(tokens))
    return p.record(config=dict(batch=B, n0=n0, points=points,
                                voxels=voxels, window=cfg.enc_window[0]),
                    sums=summarize(p, wholes))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    main()
