"""The ViT-L/16 encoder on one card: the port of ``scripts/bench_vitl.py``.

    python -m tpu3dssf_torch.cli.bench_vitl [--mode encode|block]

``encode`` (default): one graphed encode of six (640, 1138) images by
DINOv3 ViT-L/16 (24 layers, C = 1024, 16 heads, RoPE, LayerScale folded,
bf16, seeded weights) on N(0, 1) pixels, in ms per frame and tokens/s.
``block``: one ViT-L block (LayerScale kept) on six sequences of 2,944
tokens, the 2,845 real ones (CLS, 4 registers, 40 × 71 patches) and 99
padding keys masked by a −1e9 key bias with identity RoPE rows, as the
script pads them; its ms, and × 24 per frame. Each is the CUDA-event
median of 10 graph replays after warm-up (the script's
``time_device``). Not ported: the script's ``einsum`` mode (its XLA
attention against Pallas; the port has no second attention route on the
card, and chip_smoke.py times every kernel beside its plain version and
``scaled_dot_product_attention``) and ``loop`` mode (a TPU compiler
workaround). ``--device cpu`` runs the plain versions (tiny sizes only,
through the functions below).
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from tpu3dssf_torch.cli.bench_train import REPS, time_graph

N_IMAGES = 6
BLOCK_TOKENS = 2944     # 2845 rounded up to a multiple of 128


def vitl_config(dtype, cfg=None):
    from tpu3dssf_torch.models.vit import dinov3_large
    return dataclasses.replace(cfg or dinov3_large(), dtype=dtype)


def encode_row(cfg, device, reps=REPS, images=N_IMAGES, seed=0):
    """The graphed encode of ``images`` N(0, 1) images at ``cfg``'s size:
    its :func:`~tpu3dssf_torch.cli.bench_train.time_graph` record with
    ``tokens_per_s`` and the last call's ``out``."""
    from tpu3dssf_torch.models.layers import init_weights
    from tpu3dssf_torch.models.vit import VisionTransformer, fold_layerscale
    from tpu3dssf_torch.train.graph import graphed

    vit = fold_layerscale(init_weights(VisionTransformer(cfg), seed))
    vit = vit.to(device).eval()
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(images,) + tuple(cfg.image_size)
                                   + (3,)), dtype=cfg.dtype).to(device)
    f = graphed(torch.inference_mode()(
        lambda im: vit(im)["patch_features"]), "vitl_encode")
    row = time_graph(lambda: f(x), device, reps)
    row["tokens_per_s"] = images * cfg.num_patches / (row["ms"] / 1e3)
    return dict(row, out=f(x))


def block_row(cfg, device, reps=REPS, tokens=BLOCK_TOKENS, images=N_IMAGES,
              seed=0):
    """One graphed ViT block on ``images`` sequences of ``tokens`` (the real
    ones and masked padding): its :func:`~tpu3dssf_torch.cli.bench_train.
    time_graph` record with ``frame_ms`` (× num_layers) and the last
    call's ``out``."""
    from tpu3dssf_torch.models.layers import init_weights
    from tpu3dssf_torch.models.vit import ViTBlock, rope_tables
    from tpu3dssf_torch.train.graph import graphed

    real = cfg.num_prefix_tokens + cfg.num_patches
    if tokens < real:
        raise ValueError(f"{tokens} tokens hold fewer than the {real} real "
                         "ones")
    blk = init_weights(ViTBlock(cfg), seed).to(device).eval()
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(images, tokens, cfg.hidden_size))
                        * 0.1, dtype=cfg.dtype).to(device)
    bias = torch.zeros((images, 1, tokens), device=device)
    bias[:, :, real:] = -1e9
    rope = None
    if cfg.use_rope:
        cos, sin = rope_tables(cfg, device)
        pad = tokens - real    # identity rotation on the padding slots
        rope = (torch.cat([cos, cos.new_ones((pad, cos.shape[1]))]),
                torch.cat([sin, sin.new_zeros((pad, sin.shape[1]))]))
    f = graphed(torch.inference_mode()(lambda xx: blk(xx, rope, bias)),
                "vitl_block")
    row = time_graph(lambda: f(x), device, reps)
    return dict(row, frame_ms=row["ms"] * cfg.num_layers, out=f(x))


def main(argv=None):
    from tpu3dssf_torch.cli.common import card_line, resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("encode", "block"), default="encode",
                    help="BENCH_VITL_MODE")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print(card_line())
    print(f"device: {device}, dtype {str(dtype).split('.')[-1]}", flush=True)
    cfg = vitl_config(dtype)
    if args.mode == "block":
        row = block_row(cfg, device)
        print(f"ViT-L one block ({N_IMAGES} imgs): {row['ms']:.2f} ms "
              f"-> x{cfg.num_layers} = {row['frame_ms']:.1f} ms/frame "
              f"[first call {row['first_call_s']:.0f}s] launches "
              f"{row['launches']}", flush=True)
    else:
        row = encode_row(cfg, device)
        print(f"ViT-L encode {N_IMAGES} imgs (encode): {row['ms']:.1f} "
              f"ms/frame ({row['tokens_per_s']:,.0f} tok/s) [first call "
              f"{row['first_call_s']:.0f}s] launches {row['launches']}",
              flush=True)
    if not torch.isfinite(row.pop("out").float()).all():
        raise RuntimeError("non-finite ViT-L output")
    return row


if __name__ == "__main__":
    main()
