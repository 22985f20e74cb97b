"""Per-call times of the attention kernels at every shape the paths give them.

    python3 tpu3dssf_torch/cli/time_attention.py [--root DIR] [--out FILE]

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

Then every D = 16 call shape (PTv3), through ``chip_smoke.check_attention``
of this checkout (so both versions see the same cases, checks and bounds):
K1 at the fusion and the parity configs' inference shapes, K2/K3 and K4/K5
at the fusion config's train-step shapes, and K6 with the window route's
K4/K5 at window 48 (the LiDAR config, capacity 726 x 48), each with 30%
padding keys and an all-padding last window. Every row has the kernel's
profiler device time (``device_ms``: at most D = 16 shapes the host takes
longer to launch a call than the card to run it, so the CUDA-event median
``ms`` is the host's) and event median, its bound (``attention_bound``, at
the card's maximum SM clock),
SDPA on the same inputs (its backward for K3/K5), its plain version's time
and its error against it; ``d16_per_path`` sums calls per batch or step x
per-call time for each kernel and path.

Pointing ``--root`` at an unpacked older commit times that commit's
kernels (each checkout builds its own sources into its own ``build/``), so
two versions can be compared on one card within one run: parent, change,
change, parent. Run it by path, not with ``-m``, so that the package is
imported from ``--root``. Prints the card line and one JSON object, which
``--out`` also writes to a file.
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
    return torch.ops.tpu3dssf.packed_attention(packed, bias, H, None, None,
                                               None)


def load_chip_smoke():
    """chip_smoke.py of this checkout (not of ``--root``) as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def d16_cases(cs):
    """{path: cases of ``cs.check_flash_shape``} of every D = 16 call shape:
    K1 per fusion and per parity batch, K2-K5 per train step, K6 per
    window-48 batch and K4/K5 per window-48 train step."""
    import shutil
    import tempfile
    from tpu3dssf_torch.cli.common import load_config

    def ptv3(cfg):
        return [s for s in cs.slice_attention_shapes(cfg) if s[0] != "vit"]

    fusion = load_config(os.path.join(HERE, cs.CONFIG))
    tmp = tempfile.mkdtemp(prefix="time_attention_")
    try:
        window = load_config(cs.config_copy(
            os.path.join(HERE, cs.LIDAR_CONFIG), tmp, "w48.yaml", tpu=dict(
                window_size=cs.WINDOW, voxel_capacity=cs.WINDOW_CAPACITY))[0])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {
        "fusion_batch": cs.inference_cases(ptv3(fusion)),
        "parity_batch": cs.inference_cases(ptv3(load_config(
            os.path.join(HERE, cs.PARITY_CONFIG)))),
        "train_step": cs.train_cases(cs.train_attention_shapes(fusion)),
        "window48": cs.window_cases(ptv3(window)),
    }


def time_d16(cs):
    """(per-shape rows, per-path sums) of the D = 16 kernels: for each path
    and kernel, Σ calls × per-call ms of the kernel, its bound and SDPA,
    and the kernel's share of its bound."""
    rows, per_path = {}, {}
    for path, cases in d16_cases(cs).items():
        for (tag, _), found in cs.check_attention(cases, seed=0).items():
            rows.setdefault(path, {})[tag] = found
            count = next(k for k in ("launches_per_batch", "launches_per_step",
                                     "calls_per_path") if k in found[0])
            sums = {key: cs.per_path(found, key, count)
                    for key in ("ms", "bound_ms", "library_ms")}
            # None where the profiler recorded none of a shape's calls
            recorded = all(r["device_ms"] is not None for r in found)
            sums["device_ms"] = (cs.per_path(found, "device_ms", count)
                                 if recorded else None)
            sums["bound_share"] = (sums["bound_ms"] / sums["device_ms"]
                                   if recorded else None)
            sums["max_abs_err"] = max(r["max_abs_err"] for r in found)
            per_path.setdefault(path, {})[tag] = sums
    return rows, per_path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose tpu3dssf_torch is timed")
    ap.add_argument("--out", help="also write the JSON object here")
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

    ops = torch.ops.tpu3dssf     # the ops the checkout registers
    B, N = 12, 2845
    result = {"root": root, "card": card}

    # K1 at ViT-S: C = 384, H = 6, q pre-scaled (q_scale None)
    qkv = normal(B, N, 3 * 384)
    bias = torch.zeros(B, 1, N, device="cuda")
    qt, kt, vt = (x.transpose(1, 2) for x in fa._split_heads(qkv, 6))
    result["K1_vits"] = dict(
        ms=cuda_ms(lambda: ops.packed_attention(qkv, bias, 6, None, None,
                                                None)),
        sdpa_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, scale=1.0)),
        max_abs_err=err(ops.packed_attention(qkv, bias, 6, None, None, None),
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
        ms=cuda_ms(lambda: ops.attention(q, k, v, bias, None, "K8")),
        sdpa_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qt.detach(), kt.detach(), vt.detach(), scale=scale)),
        max_abs_err=err(ops.attention(q, k, v, bias, None, "K8"),
                        fa.mha_reference(q, k, v, bias)))
    out, lse = ops.attention_lse(q, k, v, bias, scale, "K8")
    result["K8_lse_vitl"] = dict(
        ms=cuda_ms(lambda: ops.attention_lse(q, k, v, bias, scale, "K8")),
        sdpa_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, scale=scale)),
        max_abs_err=err(out, fa.flash_attention_lse_reference(
            q, k, v, bias, scale)[0]))
    dout = normal(B, N, 16, 64)
    delta = fa.row_delta(dout, out)
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
    result["K9_vitl"] = dict(
        ms=cuda_ms(lambda: ops.attention_bwd(q, k, v, bias, dout, lse, delta,
                                             scale, "K9")),
        sdpa_ms=cuda_ms(lambda: torch.autograd.grad(
            sdpa_out, leaves, dout.transpose(1, 2), retain_graph=True)),
        max_abs_err=err(
            ops.attention_bwd(q, k, v, bias, dout, lse, delta, scale, "K9"),
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
            row["ms"] = cuda_ms(lambda: ops.packed_attention(
                qkv, bias, H, scale, cos, sin))
            row["max_abs_err"] = err(
                ops.packed_attention(qkv, bias, H, scale, cos, sin),
                fa.flash_attention_packed_reference(qkv, bias, H, scale, cos,
                                                    sin))
        result[f"K1_rope_{name}"] = row
        del qkv
        torch.cuda.empty_cache()

    # every D = 16 call shape of the paths
    cs = load_chip_smoke()
    cs.EXP_RATE = cs.exp_rate(cs.sm_clock_mhz())
    cs.D16_NAMES = root == HERE   # an older checkout has other kernels
    result["d16"], result["d16_per_path"] = time_d16(cs)
    print("d16_per_path " + json.dumps(result["d16_per_path"]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
