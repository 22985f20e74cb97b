"""Per-call times of the D = 64 attention kernels at the ViT encoders' shapes.

    python3 tpu3dssf_torch/cli/time_attention.py [--root DIR]

Times the attention kernels of the ``tpu3dssf_torch`` package under
``--root`` (default: the checkout holding this file) with CUDA events
(median of 20 after 3): K1 on the packed (B, N, 3C) projection of ViT-S/16
(B = 12 images of 640 x 1138, N = 2845 tokens, H = 6, q pre-scaled), and
K8, K8 with its LSE and K9 on the (B, N, H, D) views of ViT-L/16 (H = 16,
q_scale 1/8), each beside ``scaled_dot_product_attention`` on the same
inputs (its autograd backward for K9) and with its largest error against
the package's plain version. Then the ViT's K1 route with DINOv3's RoPE at
both widths (q_scale 1/8): rotating q and k outside the kernel, repacking
with ``torch.cat`` and K1 (:func:`rope_outside`, the route before K1's
RoPE branch), and, where the package has the branch, K1 rotating them
itself. Inputs are seeded bf16 normals, every key live.

Pointing ``--root`` at an unpacked older commit times that commit's
kernels (each checkout builds its own sources into its own ``build/``), so
two versions can be compared on one card within one run: parent, change,
change, parent. Run it by path, not with ``-m``, so that the package is
imported from ``--root``. Prints the card line and one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def rope_outside(fa, qkv, bias, H, angles, n_prefix, q_scale):
    """The ViT's K1 route before K1's RoPE branch, on a packed (B, N, 3C)
    projection: q and k of the patch tokens rotated outside the kernel in
    f32 by the (N − n_prefix, D/2) ``angles`` (cos and sin taken on every
    call), q pre-scaled in bf16, q, k and v packed back with ``torch.cat``,
    then K1 without tables through the kernel module ``fa``."""
    import torch
    B, N, C3 = qkv.shape
    C = C3 // 3
    D = C // H

    def rope(x):
        prefix, patches = x[:, :n_prefix], x[:, n_prefix:]
        cos = torch.cos(angles)[None, :, None, :]
        sin = torch.sin(angles)[None, :, None, :]
        p1, p2 = patches[..., :D // 2], patches[..., D // 2:]
        rotated = torch.cat([p1 * cos - p2 * sin, p1 * sin + p2 * cos], -1)
        return torch.cat([prefix, rotated.to(x.dtype)], dim=1)

    q = rope(qkv[..., :C].reshape(B, N, H, D))
    k = rope(qkv[..., C:2 * C].reshape(B, N, H, D))
    q = q * torch.tensor(q_scale, dtype=q.dtype)
    packed = torch.cat([q.reshape(B, N, C), k.reshape(B, N, C),
                        qkv[..., 2 * C:]], dim=-1)
    return fa._launch(packed, bias, H, None)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose tpu3dssf_torch is timed")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F
    from tpu3dssf_torch.kernels.modules import flash_attention as fa
    from tpu3dssf_torch.utils import cuda_ms

    if not os.path.abspath(fa.__file__).startswith(root + os.sep):
        raise SystemExit(f"imported {fa.__file__}, not the package under "
                         f"{root}: run this file by path")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    gen = torch.Generator().manual_seed(0)

    def normal(*shape):
        return torch.randn(*shape, generator=gen).to("cuda", torch.bfloat16)

    def err(got, want):
        if isinstance(want, (tuple, list)):
            return max(err(a, b) for a, b in zip(got, want))
        return (got.float() - want.float()).abs().max().item()

    B, N = 12, 2845
    result = {"root": root, "card": card}

    # K1 at ViT-S: C = 384, H = 6, q pre-scaled (q_scale None)
    qkv = normal(B, N, 3 * 384)
    bias = torch.zeros(B, 1, N, device="cuda")
    qt, kt, vt = (x.transpose(1, 2) for x in fa._split_heads(qkv, 6))
    result["K1_vits"] = dict(
        ms=cuda_ms(lambda: fa._launch(qkv, bias, 6, None)),
        sdpa_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, scale=1.0)),
        max_abs_err=err(fa._launch(qkv, bias, 6, None),
                        fa.flash_attention_packed_reference(qkv, bias, 6)))
    del qkv, qt, kt, vt
    torch.cuda.empty_cache()

    # K8 and K9 at ViT-L: C = 1024, H = 16, q_scale 1/8
    q, k, v = normal(B, N, 3, 16, 64).unbind(2)
    bias = torch.zeros(B, 1, N, device="cuda")
    scale = 0.125
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    qt, kt, vt = (x.transpose(1, 2) for x in leaves)
    result["K8_vitl"] = dict(
        ms=cuda_ms(lambda: fa._launch_flash(q, k, v, bias, scale)),
        sdpa_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qt.detach(), kt.detach(), vt.detach(), scale=scale)),
        max_abs_err=err(fa._launch_flash(q, k, v, bias, scale),
                        fa.mha_reference(q, k, v, bias)))
    out, lse = fa._launch_flash(q, k, v, bias, scale, with_lse=True)
    result["K8_lse_vitl"] = dict(
        ms=cuda_ms(lambda: fa._launch_flash(q, k, v, bias, scale,
                                            with_lse=True)),
        sdpa_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, scale=scale)),
        max_abs_err=err(out, fa.flash_attention_lse_reference(
            q, k, v, bias, scale)[0]))
    dout = normal(B, N, 16, 64)
    delta = fa.row_delta(dout, out)
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
    result["K9_vitl"] = dict(
        ms=cuda_ms(lambda: fa._launch_flash_bwd(q, k, v, bias, dout, lse,
                                                delta, scale)),
        sdpa_ms=cuda_ms(lambda: torch.autograd.grad(
            sdpa_out, leaves, dout.transpose(1, 2), retain_graph=True)),
        max_abs_err=err(
            fa._launch_flash_bwd(q, k, v, bias, dout, lse, delta, scale),
            fa.flash_attention_bwd_reference(q, k, v, bias, dout, lse, delta,
                                             scale)))
    del q, k, v, leaves, qt, kt, vt, out, lse, dout, delta, sdpa_out
    torch.cuda.empty_cache()

    # the ViT's K1 route with DINOv3's RoPE (grid 40 x 71, 5 prefix tokens)
    from tpu3dssf_torch.models import vit
    cfg = vit.dinov3_small()
    angles = vit._rope_angles(*cfg.grid_size, 64, cfg.rope_theta).cuda()
    branch = hasattr(fa, "rope_rotate")
    if branch:
        cos, sin = (x.cuda() for x in vit.rope_tables(cfg))
    for name, H in (("vits", 6), ("vitl", 16)):
        qkv = normal(B, N, 3 * 64 * H)
        row = dict(outside_ms=cuda_ms(lambda: rope_outside(
            fa, qkv, bias, H, angles, cfg.num_prefix_tokens, scale)))
        if branch:
            row["ms"] = cuda_ms(lambda: fa._launch(qkv, bias, H, scale, cos,
                                                   sin))
            row["max_abs_err"] = err(
                fa._launch(qkv, bias, H, scale, cos, sin),
                fa.flash_attention_packed_reference(qkv, bias, H, scale, cos,
                                                    sin))
        result[f"K1_rope_{name}"] = row
        del qkv
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
