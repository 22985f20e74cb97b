"""The sub-ops of a PTv3 block's glue, each alone, on the card: the port of
``scripts/time_block_glue.py``.

    python3 tpu3dssf_torch/cli/time_block_glue.py [--batch 1] [--out FILE]
    python -m tpu3dssf_torch.cli.time_block_glue --device cpu --tiny

At every stage's (N, C) = (25600, 32), (13312, 64), (7168, 128),
(4096, 256), (2048, 512) and batch ``--batch`` (the script's ``GLUE_B``,
default 1), bf16, each sub-op timed as a CUDA graph of ``--r`` repeats
(:mod:`tpu3dssf_torch.cli.pieces`), in µs: the block's ``LayerNorm`` (one
kernel, LN: :mod:`tpu3dssf_torch.kernels.layer_norm`); the qkv
``Dense`` (C → 3C, with its per-call weight cast); the serialization
gather (``permutation_gather``) of the 3C projection and of a C row; the
proj ``Dense`` with its residual; the GELU MLP; the residual add with the
mask; LayerNorm then qkv chained; and the whole glue chained as a block
runs it, with the attention stubbed as the JAX script stubs it (the first
C channels of the gathered projection stand for its output). Weights are
seeded random (``init_weights``), inputs seeded numpy, forward only.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

SHAPES = ((25600, 32), (13312, 64), (7168, 128), (4096, 256), (2048, 512))


def glue(ln, qkv, proj, mlp_in, mlp_out, x, perm, inv, mask):
    """A block's glue with its attention stubbed (the JAX script's
    ``glue``)."""
    import torch.nn.functional as F
    from tpu3dssf_torch.serialization import permutation_gather
    C = x.shape[-1]
    q = permutation_gather(qkv(ln(x)), perm, inv)
    o = permutation_gather(q[..., :C], inv, perm)
    a = x + proj(o)
    h = F.gelu(mlp_in(ln(a)), approximate="tanh")
    a = a + mlp_out(h)
    return a * mask[..., None]


def main(argv=None):
    import torch.nn.functional as F
    from tpu3dssf_torch.cli.pieces import (Pieces, arguments,
                                           layer_norm_launches, no_grad)
    from tpu3dssf_torch.models.layers import Dense, LayerNorm
    from tpu3dssf_torch.serialization import permutation_gather

    ap = arguments(__doc__.splitlines()[0], r=50)
    ap.add_argument("--batch", type=int, default=1,
                    help="batch size (the script's GLUE_B)")
    args = ap.parse_args(argv)
    p = Pieces("time_block_glue", args, unit="us")
    B = args.batch
    shapes = ((128, 16), (64, 32)) if args.tiny else SHAPES
    rng = np.random.default_rng(0)
    for N, C in shapes:
        print(f"---- N={N} C={C} ----", flush=True)
        x = p.tensor(rng.normal(size=(B, N, C)) * 0.1)
        mask = torch.ones((B, N), dtype=torch.bool, device=p.device)
        perm_np = np.stack([rng.permutation(N) for _ in range(B)])
        perm = p.tensor(perm_np)
        inv = p.tensor(np.argsort(perm_np, axis=1))
        ln = p.module(LayerNorm(C, dtype=p.dtype))
        qkv = p.module(Dense(C, 3 * C, p.dtype), seed=1)
        proj = p.module(Dense(C, C, p.dtype), seed=2)
        mlp_in = p.module(Dense(C, 4 * C, p.dtype), seed=3)
        mlp_out = p.module(Dense(4 * C, C, p.dtype), seed=4)
        with torch.no_grad():
            q3 = qkv(x)
        info = dict(N=N, C=C)
        # name, sub-op, its arguments, its LayerNorms
        for name, fn, args_, norms in (
                ("LayerNorm", ln, (x,), 1),
                ("qkv dense (C->3C)", qkv, (x,), 0),
                ("row gather 3C", lambda q: permutation_gather(q, perm, inv),
                 (q3,), 0),
                ("row gather C", lambda a: permutation_gather(a, perm, inv),
                 (x,), 0),
                ("proj dense + residual", lambda a: a + proj(a), (x,), 0),
                ("mlp in+gelu+out", lambda a: mlp_out(F.gelu(
                    mlp_in(a), approximate="tanh")), (x,), 0),
                ("residual+mask", lambda a, c: (a + c) * mask[..., None],
                 (x, x), 0),
                ("LN+qkv chained", lambda a: qkv(ln(a)), (x,), 1),
                ("ALL glue chained", lambda a: glue(
                    ln, qkv, proj, mlp_in, mlp_out, a, perm, inv, mask),
                 (x,), 2)):
            p.time(f"N={N} C={C} {name}", no_grad(fn), *args_,
                   launches=layer_norm_launches(norms, False), op=name,
                   **info)
    return p.record(config=dict(batch=B, shapes=[list(s) for s in shapes]))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    main()
