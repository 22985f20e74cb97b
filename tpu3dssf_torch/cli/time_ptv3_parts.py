"""PTv3's forward, piece by piece at each pyramid level, on the card: the
port of ``scripts/time_ptv3_parts.py``.

    python3 tpu3dssf_torch/cli/time_ptv3_parts.py [--batch 1] [--out FILE]
    python -m tpu3dssf_torch.cli.time_ptv3_parts --device cpu --tiny

Forward only, at batch ``--batch`` (the script's ``PTV3_B``, default 1),
at ``PTv3Config().capacities(25600)`` with window 1024 in bf16, each piece
timed as a CUDA graph of ``--r`` repeats (:mod:`tpu3dssf_torch.cli.
pieces`):

* at each encoder stage: the window attention alone (the stage's route,
  ``ptv3.windowed_attention``, on a random (B·W, K, 3C) projection), the whole ``PTv3Block`` (CPE, attention, MLP) on the
  z-trans order of a random grid, and the serialization sort of the four
  orders; the depth-weighted sums of the first two; the block at each
  decoder stage too (the JAX script times the encoder's);
* pooling s → s+1 and unpooling d+1 → d;
* the block glue at stages 0 and 3: the CPE (depthwise conv and dense)
  and the MLP's first dense;
* the full ``PointTransformerV3`` forward, as a cross-check: the
  depth-weighted block forwards of every stage are set against it (the sum
  of parts), with the remainder (embedding, serialization, pooling,
  unpooling).
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

N0, WINDOW = 25600, 1024


def main(argv=None):
    from tpu3dssf_torch.cli.attr_bwd import stages, step_launches, tiny_config
    from tpu3dssf_torch.cli.pieces import (Pieces, arguments,
                                           attention_launches,
                                           layer_norm_launches, no_grad, plus)
    from tpu3dssf_torch.models.ptv3 import (SERIALIZATION_ORDERS, PTv3Block,
                                            PTv3Config, PointTransformerV3,
                                            SerializedCPE, SerializedPooling,
                                            SerializedUnpooling,
                                            _serialize_perms,
                                            windowed_attention)
    from tpu3dssf_torch.models.layers import Dense

    ap = arguments(__doc__.splitlines()[0], r=10)
    ap.add_argument("--batch", type=int, default=1,
                    help="batch size (the script's PTV3_B)")
    args = ap.parse_args(argv)
    p = Pieces("time_ptv3_parts", args)
    if args.tiny:
        cfg, n0 = tiny_config(), 128
    else:
        cfg, n0 = PTv3Config(enc_window=(WINDOW,) * 5,
                             dec_window=(WINDOW,) * 4), N0
    B = args.batch
    rng = np.random.default_rng(0)
    caps = cfg.capacities(n0)
    print(f"caps: {caps} B: {B}", flush=True)

    def ones(n):
        return torch.ones((B, n), dtype=torch.bool, device=p.device)

    for name, N, C, H, window, depth in stages(cfg, n0):
        x = p.tensor(rng.normal(size=(B, N, C)) * 0.1)
        grid = p.tensor(rng.integers(0, 512, (B, N, 3)).astype(np.int32))
        mask = ones(N)
        K = min(window, N)
        one = attention_launches(C, H, K, False)
        shape = dict(stage=name, N=N, C=C, H=H)
        encoder = name.startswith("enc")
        if encoder:
            W = N // K
            q = p.tensor(rng.normal(size=(B * W, K, 3 * C)))
            km = torch.ones((B * W, K), dtype=torch.bool, device=p.device)
            p.time(f"{name} window_attn N={N} C={C} h={H}", no_grad(
                lambda qq, km=km, H=H: windowed_attention(qq, km, H)), q,
                depth=depth, launches=one, kind="attention", **shape)
        perm, inv = _serialize_perms(grid, mask, ("z", "z-trans"))["z-trans"]
        blk = p.module(PTv3Block(C, H, window, cfg.mlp_ratio, dtype=p.dtype))
        p.time(f"{name} full block N={N} C={C}", no_grad(
            lambda xx, blk=blk, perm=perm, inv=inv, mask=mask:
            blk(xx, perm, inv, mask)), x, depth=depth,
            launches=plus(one, layer_norm_launches(2, False)),
            kind="block" if encoder else "decoder_block", **shape)
        if encoder:
            p.time(f"{name} serialize 4 orders N={N}", lambda g, mask=mask:
                   _serialize_perms(g, mask, SERIALIZATION_ORDERS), grid,
                   kind="serialize", **shape)

    for s in range(1, cfg.num_stages):
        n_in, c_in = caps[s - 1], cfg.enc_channels[s - 1]
        n_out, c_out = caps[s], cfg.enc_channels[s]
        x = p.tensor(rng.normal(size=(B, n_in, c_in)) * 0.1)
        grid = p.tensor(np.sort(rng.integers(0, 512, (B, n_in, 3)),
                                axis=1).astype(np.int32))
        pool = p.module(SerializedPooling(c_in, c_out, dtype=p.dtype))
        p.time(f"pool{s} {n_in}->{n_out} C={c_out}", no_grad(
            lambda a, g, pool=pool, m=ones(n_in), o=n_out: pool(a, g, m, o)),
            x, grid, launches=layer_norm_launches(1, False), kind="pool",
            N=n_in, out=n_out, C=c_out)

    for d in range(cfg.num_stages - 1):
        n_f, c_f, n_c = caps[d], cfg.dec_channels[d], caps[d + 1]
        c_c = (cfg.enc_channels[d + 1] if d == cfg.num_stages - 2
               else cfg.dec_channels[d + 1])
        c_s = cfg.enc_channels[d]
        xc = p.tensor(rng.normal(size=(B, n_c, c_c)) * 0.1)
        sk = p.tensor(rng.normal(size=(B, n_f, c_s)) * 0.1)
        parent = p.tensor(rng.integers(0, n_c, (B, n_f)))
        up = p.module(SerializedUnpooling(c_c, c_s, c_f, dtype=p.dtype))
        p.time(f"unpool{d} {n_c}->{n_f} C={c_f}", no_grad(
            lambda a, b, up=up, parent=parent, m=ones(n_f):
            up(a, b, parent, m, m)), xc, sk,
            launches=layer_norm_launches(2, False), kind="unpool", N=n_f,
            coarse=n_c, C=c_f)

    for s in sorted({0, min(3, cfg.num_stages - 1)}):
        N, C = caps[s], cfg.enc_channels[s]
        x = p.tensor(rng.normal(size=(B, N, C)) * 0.1)
        cpe = p.module(SerializedCPE(C, dtype=p.dtype))
        p.time(f"s{s} CPE (dwconv+dense) N={N} C={C}", no_grad(
            lambda a, cpe=cpe, m=ones(N): cpe(a, None, None, m)), x,
            kind="glue", stage=s, N=N, C=C)
        mlp_in = p.module(Dense(C, int(C * cfg.mlp_ratio), p.dtype))
        p.time(f"s{s} MLP denses N={N} C={C}", no_grad(mlp_in), x,
               kind="glue", stage=s, N=N, C=C)

    model = p.module(PointTransformerV3(dataclasses.replace(
        cfg, dtype=p.dtype)))
    feat = p.tensor(rng.normal(size=(B, caps[0], 4)))
    grid = p.tensor(rng.integers(0, 512, (B, caps[0], 3)).astype(np.int32))
    p.time(f"FULL PTv3 ({caps[0]})", no_grad(
        lambda f, g, m=ones(caps[0]): model(f, g, m)[0]), feat, grid,
        launches=step_launches(cfg, n0, grad=False), kind="full")

    attn = p.weighted(lambda r: r.get("kind") == "attention")
    enc = p.weighted(lambda r: r.get("kind") == "block")
    dec = p.weighted(lambda r: r.get("kind") == "decoder_block")
    full = p.value(f"FULL PTv3 ({caps[0]})")
    print(f"encoder attn sum (depth-weighted)  {attn:.3f} ms")
    print(f"encoder block sum (depth-weighted) {enc:.3f} ms")
    print(f"decoder block sum (depth-weighted) {dec:.3f} ms")
    print(f"sum of parts {enc + dec:.3f} ms (every block, depth-weighted) vs "
          f"the full forward {full:.3f} ms: remainder "
          f"{full - enc - dec:.3f} ms", flush=True)
    return p.record(config=dict(batch=B, n0=n0, caps=list(caps)),
                    sums=dict(attention_depth_weighted=attn,
                              block_depth_weighted=enc,
                              decoder_block_depth_weighted=dec,
                              sum_of_parts=enc + dec, full=full,
                              remainder=full - enc - dec))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    main()
