"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two paths over ``configs/synthetic_convergence_fusion_r3.
yaml`` at full width (DINOv3 ViT-S/16 over 6 cameras → voxelize → PTv3 →
fusion head → devoxelize, seeded random weights, bf16): streaming fused
inference (``tpu3dssf_torch.cli.main_infer``) and training
(``tpu3dssf_torch.cli.main_train``). It checks, in order (any failure
raises, exit code ≠ 0):

1. a CUDA device is present; prints the card's name and power limit;
2. the attention kernel builds from ``tpu3dssf_torch/csrc`` with nvcc;
3. the kernel agrees with its plain PyTorch version (max abs error < 0.05,
   bf16) at every attention shape of the slice, and both are timed with
   CUDA events (median of 20 after warm-up);
4. the slice runs through the CLI's own entry point with the kernel's
   launch count up by exactly 34 per batch (12 ViT layers + 22 PTv3
   blocks) and finite metrics; then one batch is timed end to end, and
   the kernel inside that batch: its device time from the profiler, and
   the plain version's time and the kernel's error on the very inputs
   the batch gave the kernel;
5. a small model gives the same logits on the card (bf16, kernels) as on
   the CPU (f32, plain versions), within 5% of the logit scale;
6. the backward kernel builds (nvcc time, ptxas registers and spills);
7. the training kernels agree with their plain versions at every training
   shape (random bf16, 30% padding keys, one all-padding window): the
   forward-with-LSE (K2 at C ≥ 128, K4 at C ∈ {32, 64}) within 0.05 and its
   LSE within 1e-3 on rows with a valid key; the backward (K3, K5) within
   0.05 · max(1, max |plain|), and exactly 0 in the all-padding window;
   kernel and plain version timed with CUDA events;
8. one epoch of training through the CLI's own entry point (24 steps, 6
   val batches) on a temporary copy of the config with exact launch counts
   (per step K1 12, K2 14, K3 14, K4 8, K5 8; K1 34 per val batch), finite
   metrics and a checkpoint; then ``--resume`` to a second epoch, which
   must start at epoch 1 with the optimizer state restored;
9. one train step (encode + forward + loss + backward + update) timed with
   CUDA events, its peak memory, K2–K5's device time inside it from the
   profiler, and their plain versions' time and the kernels' error on the
   inputs that step gave them (within 0.05 · max(1, max |plain|), LSE
   within 1e-3);
10. 10 steps on one fixed batch lower its loss;
11. the small model's loss and gradient on the card (bf16, kernels) agree
    with the CPU's (f32, plain versions): loss within 5%, cosine of the
    whole gradient ≥ 0.98.

The last two lines are a JSON record of the kernels and the device line.
In the kernel records, K1's ``launches`` are those of the inference run
(step 4, 6 batches) and its ``ms`` and ``plain_ms`` per inference batch;
K2–K5's ``launches`` are those of the one-epoch training run (step 8, 24
steps) and their ``ms`` and ``plain_ms`` per train step (step 9);
``max_abs_err`` is the largest error of the kernel's checks.
Needs the repository checkout around it; JAX is never imported.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = "configs/synthetic_convergence_fusion_r3.yaml"
KERNEL_TOL = 0.05            # bf16 kernel vs plain (check_tpu_kernels.py)
LSE_TOL = 1e-3               # f32 LSE, kernel vs plain, rows with a key
SMALL_MODEL_TOL = 0.05       # bf16 card vs f32 CPU, relative to max |logit|
GRAD_COSINE = 0.98           # bf16 card vs f32 CPU, the whole gradient
LAUNCHES_PER_BATCH = 12 + 22
# per train step: K1 (frozen ViT), K2/K3 (14 blocks at C >= 128), K4/K5
# (8 blocks at C in {32, 64})
TRAIN_LAUNCHES = {"K1": 12, "K2": 14, "K3": 14, "K4": 8, "K5": 8}
KERNELS = {  # name, source, the TPU kernel it replaces
    "K1": ("flash_attention_packed", "flash_attention_packed.cu",
           "tpu3dssf/kernels/flash_attention.py:230"),
    "K2": ("flash_attention_packed_lse", "flash_attention_packed.cu",
           "tpu3dssf/kernels/flash_attention.py:630"),
    "K3": ("flash_attention_packed_bwd", "flash_attention_packed_bwd.cu",
           "tpu3dssf/kernels/flash_attention.py:463"),
    "K4": ("window_attention_lse", "flash_attention_packed.cu",
           "tpu3dssf/kernels/window_attention.py:89"),
    "K5": ("window_attention_bwd", "flash_attention_packed_bwd.cu",
           "tpu3dssf/kernels/window_attention.py:155"),
}


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def slice_attention_shapes(cfg):
    """(name, B, N, C, H, q_scale, masked, launches per batch) of every
    attention call of one batch of the slice."""
    from tpu3dssf_torch.models.ptv3 import PTv3Config, _round_up
    from tpu3dssf_torch.models.vit import dinov3_small

    vit = dinov3_small()
    batch = cfg.test_loader.batch_size
    n_tok = vit.num_prefix_tokens + vit.num_patches
    shapes = [("vit", 6 * batch, n_tok, vit.hidden_size, vit.num_heads,
               None, False, vit.num_layers)]
    w = cfg.tpu.window_size
    p = PTv3Config(enc_window=(w,) * 5, dec_window=(w,) * 4)
    caps = p.capacities(_round_up(cfg.tpu.voxel_capacity, w))
    calls = {}
    stages = [(s, p.enc_channels[s], p.enc_heads[s], p.enc_depths[s])
              for s in range(p.num_stages)]
    stages += [(d, p.dec_channels[d], p.dec_heads[d], p.dec_depths[d])
               for d in range(p.num_stages - 1)]
    for s, C, H, depth in stages:
        key = (batch * caps[s] // w, C, H)
        calls[key] = calls.get(key, 0) + depth
    for (W, C, H), n in sorted(calls.items(), key=lambda kv: kv[0][1]):
        shapes.append((f"ptv3_c{C}_h{H}_w{W}", W, w, C, H, (C // H) ** -0.5,
                       True, n))
    return shapes


def check_kernel(shapes):
    import torch
    from tpu3dssf_torch.kernels import flash_attention as fa
    from tpu3dssf_torch.utils import cuda_ms

    gen = torch.Generator().manual_seed(0)
    rows = []
    for name, B, N, C, H, q_scale, masked, n in shapes:
        qkv = torch.randn(B, N, 3 * C, generator=gen).to("cuda",
                                                         torch.bfloat16)
        if masked:   # random padding keys and one all-padding window
            keep = torch.rand(B, N, generator=gen) > 0.3
            keep[-1] = False
            bias = torch.where(keep, 0.0, -1e9)[:, None, :]
        else:
            bias = torch.zeros(B, 1, N)
        bias = bias.to("cuda", torch.float32).contiguous()
        out = fa.flash_attention_packed(qkv, bias, H, q_scale)
        torch.cuda.synchronize()
        ref = fa.flash_attention_packed_reference(qkv, bias, H, q_scale)
        if not torch.isfinite(out.float()).all():
            raise AssertionError(f"{name}: kernel output is not finite")
        err = (out.float() - ref.float()).abs().max().item()
        ms = cuda_ms(lambda: fa.flash_attention_packed(qkv, bias, H,
                                                       q_scale))
        plain_ms = cuda_ms(lambda: fa.flash_attention_packed_reference(
            qkv, bias, H, q_scale))
        row = dict(shape=name, B=B, N=N, C=C, H=H, launches_per_batch=n,
                   max_abs_err=err, ms=ms, plain_ms=plain_ms)
        print("kernel " + json.dumps(row), flush=True)
        if not err < KERNEL_TOL:
            raise AssertionError(f"{name}: max abs error {err} ≥ "
                                 f"{KERNEL_TOL}")
        rows.append(row)
        del qkv, bias, out, ref
        torch.cuda.empty_cache()
    return rows


def run_slice(card):
    import numpy as np
    import torch
    from tpu3dssf_torch.cli import common, main_infer
    from tpu3dssf_torch.kernels import flash_attention as fa
    from tpu3dssf_torch.train.loop import make_eval_step
    from tpu3dssf_torch.utils import cuda_ms

    fa.LAUNCHES = 0
    metrics = main_infer.main(["--config", CONFIG, "--split", "test"])
    launches = fa.LAUNCHES
    cfg = common.load_config(CONFIG)
    n_batches = len(common.build_dataloaders(cfg)["test"])
    print(f"slice: {launches} kernel launches over {n_batches} batches")
    if launches != LAUNCHES_PER_BATCH * n_batches:
        raise AssertionError(f"kernel launched {launches} times, expected "
                             f"{LAUNCHES_PER_BATCH} x {n_batches}")
    for k, v in metrics.items():
        if not np.isfinite(v).all():
            raise AssertionError(f"metric {k} is not finite: {v}")

    # one batch end to end on the card: preprocess + ViT + pipeline + loss
    device = torch.device("cuda")
    encode, vit_cfg = common.build_image_encoder(cfg, device)
    model, _ = common.build_pipeline(cfg, vit_cfg, device)
    step = make_eval_step(common.build_loss(cfg), cfg.mlp_class)
    batches = iter(common.build_dataloaders(cfg)["test"])
    host = next(batches)
    batches.close()  # stop the prefetch thread: it would share the host
    points = int(host["point_valid"].sum())
    images = torch.as_tensor(host.pop("images")).to(device)
    batch = common.batch_to_device(host, device)

    def frame():
        return step(model, batch, encode(images))

    with torch.inference_mode():
        logits = model(batch["points"], batch["point_valid"],
                       encode(images), batch["cam_intrinsics"],
                       batch["lidar2cam"])
    want = tuple(batch["points"].shape[:2]) + (cfg.mlp_class,)
    if tuple(logits.shape) != want or not torch.isfinite(
            logits.float()).all():
        raise AssertionError(f"slice logits: shape {tuple(logits.shape)} "
                             f"(want {want}), finite "
                             f"{bool(torch.isfinite(logits.float()).all())}")
    torch.cuda.reset_peak_memory_stats()
    frame_ms = cuda_ms(frame, reps=10, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    print(f"slice frame ({batch['points'].shape[0]} scenes, {points:,} "
          f"valid points): {frame_ms:.3f} ms -> "
          f"{points / frame_ms * 1e3:,.0f} points/s; peak allocated "
          f"{peak / 2**30:.3f} GiB [{card}]")
    k1 = time_kernel_in_path(frame)
    return launches, k1, dict(frame_ms=frame_ms, points=points,
                              points_per_s=points / frame_ms * 1e3,
                              peak_bytes=peak)


def time_kernel_in_path(frame):
    """The attention kernel inside one batch of the main path: its device
    time per batch from the profiler (3 batches), then the plain version's
    time per batch (Σ of CUDA-event medians) and the kernel's max abs
    error, both on the inputs that batch gave the kernel."""
    from tpu3dssf_torch.kernels import flash_attention as fa
    from tpu3dssf_torch.utils import cuda_ms, profile_kernels

    _, kernels = profile_kernels(frame, reps=3)
    k1 = [v for k, v in kernels.items() if "fap_fwd_kernel" in k]
    ms = sum(us for us, _ in k1) / 1e3
    n = sum(c for _, c in k1)
    print(f"profiler: attention kernel {ms:.3f} ms of "
          f"{sum(us for us, _ in kernels.values()) / 1e3:.3f} ms device "
          f"kernel time per batch, {n:g} of "
          f"{sum(c for _, c in kernels.values()):g} kernel launches")
    if not (ms > 0 and n == LAUNCHES_PER_BATCH):
        raise AssertionError(f"profiler saw {n} attention launches and "
                             f"{ms} ms per batch, expected "
                             f"{LAUNCHES_PER_BATCH} and > 0")

    launch, calls = fa._launch, []

    def capture(qkv, key_bias, heads, q_scale):
        out = launch(qkv, key_bias, heads, q_scale)
        calls.append((qkv.clone(), key_bias.clone(), heads, q_scale,
                      out.clone()))
        return out

    fa._launch = capture
    try:
        frame()
    finally:
        fa._launch = launch
    plain_ms, err = 0.0, 0.0
    for qkv, bias, heads, q_scale, out in calls:
        def plain(qkv=qkv, bias=bias, heads=heads, q_scale=q_scale):
            return fa.flash_attention_packed_reference(qkv, bias, heads,
                                                       q_scale)
        err = max(err, (out.float() - plain().float()).abs().max().item())
        plain_ms += cuda_ms(plain, reps=5, warmup=1)
    print(f"main-path inputs: plain version {plain_ms:.3f} ms per batch; "
          f"kernel max abs error {err:.4g} over {len(calls)} calls")
    if not err < KERNEL_TOL:
        raise AssertionError(f"kernel on main-path inputs: max abs error "
                             f"{err} ≥ {KERNEL_TOL}")
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err)


def small_model(device, dtype):
    """A small fusion model with seeded weights, on ``device`` in ``dtype``:
    (encode_fn, model, host batch, images). Its PTv3 has stages at C = 32,
    64 and 128, so it reaches every attention kernel."""
    import torch
    from tpu3dssf_torch.cli.common import HostDataPipeline, SyntheticNuScenes
    from tpu3dssf_torch.models import fusion, ptv3, vit
    from tpu3dssf_torch.models.layers import init_weights
    from tpu3dssf_torch.train.loop import make_image_encode_fn

    vcfg = vit.ViTConfig(patch_size=8, image_size=(48, 80), hidden_size=128,
                         num_layers=2, num_heads=2, num_register_tokens=4,
                         use_rope=True, ln_eps=1e-5, dtype=dtype)
    pcfg = fusion.PipelineConfig(
        fusion=fusion.FusionConfig(point_feat_dim=32, patch_tok_dim=128,
                                   patch_size=8, encoder_size=(48, 80),
                                   dtype=dtype),
        ptv3=ptv3.PTv3Config(
            enc_depths=(1, 2, 1), enc_channels=(32, 64, 128),
            enc_heads=(2, 4, 8), enc_window=(64, 64, 64),
            dec_depths=(1, 1), dec_channels=(32, 64), dec_heads=(2, 4),
            dec_window=(64, 64), dtype=dtype),
        voxel_size=0.4, voxel_capacity=1024)
    data = SyntheticNuScenes(num_samples=2, num_points=3000,
                             image_hw=(90, 160), seed=3,
                             render_semantics=True)
    host = next(iter(HostDataPipeline(data, batch_size=2,
                                      point_capacity=3072)))
    images = torch.as_tensor(host.pop("images"))
    enc = vit.fold_layerscale(init_weights(vit.VisionTransformer(vcfg), 5))
    model = init_weights(fusion.SegmentationPipeline(pcfg), 6)
    enc, model = enc.to(device).eval(), model.to(device)
    return (make_image_encode_fn(enc, vcfg.image_size, dtype), model, host,
            images)


def check_small_model():
    """Same small model, same weights: the card in bf16 through the kernel
    vs the CPU in f32 through the plain versions."""
    import torch
    from tpu3dssf_torch.cli.common import batch_to_device

    out = {}
    for device, dtype in (("cpu", torch.float32), ("cuda", torch.bfloat16)):
        encode, model, host, images = small_model(device, dtype)
        b = batch_to_device(host, device)
        with torch.inference_mode():
            out[device] = model(b["points"], b["point_valid"],
                                encode(images.to(device)),
                                b["cam_intrinsics"], b["lidar2cam"]).float()
    ref, got = out["cpu"], out["cuda"].cpu()
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    valid = torch.as_tensor(host["point_valid"])
    agree = (got.argmax(-1) == ref.argmax(-1))[valid].float().mean().item()
    print(f"small model: card bf16 vs CPU f32 logits, max abs error / max "
          f"|logit| = {rel:.4g} (limit {SMALL_MODEL_TOL}); argmax "
          f"agreement {agree:.4f}")
    if not (torch.isfinite(got).all() and rel < SMALL_MODEL_TOL):
        raise AssertionError(f"small model disagrees: {rel}")


def print_build(what, info, seconds):
    print(f"build {what}: {seconds:.2f} s (nvcc {info['seconds']:.2f} s)")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:" + line.split(":", 1)[-1])


def train_attention_shapes(cfg):
    """(TPU kernel pair, name, W, K, C, H, blocks per train step) of every
    PTv3 attention call of one train step."""
    from tpu3dssf_torch.models.ptv3 import PTv3Config, _round_up

    batch = cfg.train_loader.batch_size
    w = cfg.tpu.window_size
    p = PTv3Config(enc_window=(w,) * 5, dec_window=(w,) * 4)
    caps = p.capacities(_round_up(cfg.tpu.voxel_capacity, w))
    stages = [(s, p.enc_channels[s], p.enc_heads[s], p.enc_depths[s])
              for s in range(p.num_stages)]
    stages += [(d, p.dec_channels[d], p.dec_heads[d], p.dec_depths[d])
               for d in range(p.num_stages - 1)]
    calls = {}
    for s, C, H, depth in stages:
        key = (batch * caps[s] // w, C, H)
        calls[key] = calls.get(key, 0) + depth
    return [(("K2", "K3") if C % 128 == 0 else ("K4", "K5"),
             f"ptv3_c{C}_h{H}_w{W}", W, w, C, H, n)
            for (W, C, H), n in sorted(calls.items(),
                                       key=lambda kv: kv[0][1])]


def masked_inputs(gen, W, K, C):
    """Random bf16 qkv, 30% padding keys and an all-padding last window."""
    import torch
    qkv = torch.randn(W, K, 3 * C, generator=gen).to("cuda", torch.bfloat16)
    keep = torch.rand(W, K, generator=gen) > 0.3
    keep[-1] = False
    bias = torch.where(keep, 0.0, -1e9)[:, None, :].to("cuda").contiguous()
    return qkv, bias, keep.to("cuda")


def grad_error(got, ref):
    """(max abs error, the limit 0.05 · max(1, max |plain|))."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, KERNEL_TOL * max(1.0, ref.float().abs().max().item())


def check_train_kernels(shapes):
    """Phase 7: K2/K4 and K3/K5 vs their plain versions at every training
    shape; returns {TPU kernel: [row, ...]}."""
    import torch
    from tpu3dssf_torch.kernels import flash_attention as fa
    from tpu3dssf_torch.utils import cuda_ms

    gen = torch.Generator().manual_seed(1)
    rows = {k: [] for k in ("K2", "K3", "K4", "K5")}
    for (kf, kb), name, W, K, C, H, n in shapes:
        scale = (C // H) ** -0.5
        qkv, bias, keep = masked_inputs(gen, W, K, C)
        out, lse = fa._launch_lse(qkv, bias, H, scale)
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_attention_packed_lse_reference(qkv, bias, H,
                                                               scale)
        err = (out.float() - ref.float()).abs().max().item()
        live = keep.any(-1)                  # windows with a valid key
        lse_err = (lse - ref_lse)[live].abs().max().item()
        fwd = dict(shape=name, W=W, K=K, C=C, H=H, launches_per_step=n,
                   max_abs_err=err, lse_err=lse_err,
                   ms=cuda_ms(lambda: fa._launch_lse(qkv, bias, H, scale)),
                   plain_ms=cuda_ms(
                       lambda: fa.flash_attention_packed_lse_reference(
                           qkv, bias, H, scale), reps=5, warmup=1))
        print(f"kernel {kf} " + json.dumps(fwd), flush=True)
        if not (torch.isfinite(out.float()).all() and err < KERNEL_TOL
                and lse_err < LSE_TOL):
            raise AssertionError(f"{kf} {name}: output error {err}, LSE "
                                 f"error {lse_err}")
        rows[kf].append(fwd)

        dout = torch.randn(W, K, C, generator=gen).to("cuda")
        dout = (dout * keep[..., None]).to(torch.bfloat16)
        out = out * keep[..., None].to(out.dtype)
        delta = fa.row_delta(dout, out, H)
        got = fa._launch_bwd(qkv, bias, dout, lse, delta, H, scale)
        torch.cuda.synchronize()
        ref = fa.flash_attention_packed_bwd_reference(qkv, bias, dout, lse,
                                                      delta, H, scale)
        err, limit = grad_error(got, ref)
        padded = got[-1].abs().max().item()
        bwd = dict(shape=name, W=W, K=K, C=C, H=H, launches_per_step=n,
                   max_abs_err=err, limit=limit, all_padding_max=padded,
                   ms=cuda_ms(lambda: fa._launch_bwd(qkv, bias, dout, lse,
                                                     delta, H, scale)),
                   plain_ms=cuda_ms(
                       lambda: fa.flash_attention_packed_bwd_reference(
                           qkv, bias, dout, lse, delta, H, scale),
                       reps=5, warmup=1))
        print(f"kernel {kb} " + json.dumps(bwd), flush=True)
        if not (torch.isfinite(got.float()).all() and err < limit
                and padded == 0.0):
            raise AssertionError(f"{kb} {name}: dqkv error {err} (limit "
                                 f"{limit}), all-padding window max "
                                 f"{padded}")
        rows[kb].append(bwd)
        del qkv, bias, out, ref, dout, got, lse, ref_lse, delta
        torch.cuda.empty_cache()
    return rows


def counters():
    from tpu3dssf_torch.kernels import flash_attention as fa
    from tpu3dssf_torch.kernels import window_attention as wa
    return {"K1": fa.LAUNCHES, "K2": fa.LSE_LAUNCHES, "K3": fa.BWD_LAUNCHES,
            "K4": wa.LSE_LAUNCHES, "K5": wa.BWD_LAUNCHES}


def reset_counters():
    from tpu3dssf_torch.kernels import flash_attention as fa
    from tpu3dssf_torch.kernels import window_attention as wa
    fa.LAUNCHES = fa.LSE_LAUNCHES = fa.BWD_LAUNCHES = 0
    wa.LSE_LAUNCHES = wa.BWD_LAUNCHES = 0


def run_training(tmp):
    """Phase 8: one epoch through ``main_train.main`` on a copy of the
    config (checkpoints under ``tmp``), then ``--resume`` to epoch 2.
    Returns the launches of the first run."""
    import numpy as np
    import yaml
    from tpu3dssf_torch.cli import common, main_train
    from tpu3dssf_torch.train import loop
    from tpu3dssf_torch.train.checkpoint import latest_checkpoint

    with open(CONFIG) as f:
        raw = yaml.safe_load(f)
    ckpt = os.path.join(tmp, "ckpt")
    raw["train_params"].update(max_num_epochs=1, checkpoint_path=ckpt,
                               best_model_path=ckpt)
    path = os.path.join(tmp, "train.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    cfg = common.load_config(path)
    loaders = common.build_dataloaders(cfg)
    steps, val_batches = len(loaders["train"]), len(loaders["val"])

    evaluate, val_k1 = loop.evaluate_model, []

    def counted_evaluate(*a, **kw):   # K1 launches of the val pass alone
        before = counters()["K1"]
        out = evaluate(*a, **kw)
        val_k1.append(counters()["K1"] - before)
        return out

    loop.evaluate_model = counted_evaluate
    try:
        reset_counters()
        t0 = time.perf_counter()
        state, tr_hist, val_hist = main_train.main(["--config", path])
        seconds = time.perf_counter() - t0
        launches = counters()
    finally:
        loop.evaluate_model = evaluate
    want = {k: n * steps for k, n in TRAIN_LAUNCHES.items()}
    want["K1"] += LAUNCHES_PER_BATCH * val_batches
    print(f"training: {steps} steps + {val_batches} val batches in "
          f"{seconds:.1f} s; launches {launches} (expected {want}); val "
          f"pass K1 {val_k1}")
    if launches != want or val_k1 != [LAUNCHES_PER_BATCH * val_batches]:
        raise AssertionError(f"training launched {launches}, val K1 "
                             f"{val_k1}; expected {want}")
    with open(os.path.join(ckpt, "training_history.json")) as f:
        epoch = json.load(f)["epochs"][0]
    bad = {k: v for k, v in epoch.items() if not np.isfinite(v).all()}
    if bad or not np.isfinite(tr_hist + val_hist).all():
        raise AssertionError(f"non-finite training metrics: {bad}")
    if latest_checkpoint(os.path.join(ckpt, "last")) != 0:
        raise AssertionError("no checkpoint under last/ after epoch 0")
    print(f"epoch 0: train loss {epoch['train_loss']:.4f}, train acc "
          f"{epoch['train_acc']:.4f}, val loss {epoch['loss']:.4f}, val acc "
          f"{epoch['overall_acc']:.4f}, peak {epoch['peak_hbm_mb']:,.0f} MiB")

    raw["train_params"]["max_num_epochs"] = 2
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    state, tr_hist, val_hist = main_train.main(["--config", path,
                                                "--resume"])
    adam_steps = {int(v["step"]) for v in
                  state.optimizer.inner.state_dict()["state"].values()}
    print(f"resumed: {len(tr_hist)} epoch run, update count {state.step}, "
          f"schedule count {state.optimizer.scheduler.last_epoch}, Adam "
          f"steps {sorted(adam_steps)}")
    if not (len(tr_hist) == 1 and state.step == 2 * steps
            and state.optimizer.scheduler.last_epoch == 2 * steps
            and adam_steps == {2 * steps}
            and latest_checkpoint(os.path.join(ckpt, "last")) == 1):
        raise AssertionError("resume did not continue from epoch 1 with "
                             "the optimizer state restored")
    return launches, steps


class Capture:
    """Wrap the LSE and backward launchers: record each call's inputs and
    outputs, and name it in the profiler by the TPU kernel it serves (C %
    128 == 0: K2/K3, else K4/K5)."""

    def __init__(self, record):
        from tpu3dssf_torch.kernels import flash_attention as fa
        self.fa, self.record = fa, record
        self.calls = {k: [] for k in ("K2", "K3", "K4", "K5")}
        self.lse, self.bwd = fa._launch_lse, fa._launch_bwd

    def __enter__(self):
        import torch
        fa = self.fa

        def lse(qkv, bias, heads, q_scale):
            k = "K2" if (qkv.shape[-1] // 3) % 128 == 0 else "K4"
            with torch.profiler.record_function(f"smoke::{k}"):
                out = self.lse(qkv, bias, heads, q_scale)
            if self.record:
                self.calls[k].append(((qkv.clone(), bias.clone(), heads,
                                       q_scale),
                                      tuple(o.clone() for o in out)))
            return out

        def bwd(qkv, bias, dout, lse_, delta, heads, q_scale):
            k = "K3" if (qkv.shape[-1] // 3) % 128 == 0 else "K5"
            with torch.profiler.record_function(f"smoke::{k}"):
                out = self.bwd(qkv, bias, dout, lse_, delta, heads, q_scale)
            if self.record:
                self.calls[k].append(((qkv.clone(), bias.clone(),
                                       dout.contiguous().clone(),
                                       lse_.clone(), delta.clone(), heads,
                                       q_scale), out.clone()))
            return out

        fa._launch_lse, fa._launch_bwd = lse, bwd
        return self

    def __exit__(self, *exc):
        self.fa._launch_lse, self.fa._launch_bwd = self.lse, self.bwd


def time_train_step(card):
    """Phase 9: one train step at full width: its time, peak memory, and
    K2–K5 inside it (device time from the profiler; plain time and error on
    the step's own inputs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tpu3dssf_torch.cli import common
    from tpu3dssf_torch.kernels import flash_attention as fa
    from tpu3dssf_torch.train.loop import make_train_step
    from tpu3dssf_torch.utils import cuda_ms

    cfg = common.load_config(CONFIG)
    device = torch.device("cuda")
    encode, vit_cfg = common.build_image_encoder(cfg, device)
    model, _ = common.build_pipeline(cfg, vit_cfg, device)
    state = common.init_state(cfg, model, steps_per_epoch=24)
    step = make_train_step(common.build_loss(cfg))
    batches = iter(common.build_dataloaders(cfg)["train"])
    host = next(batches)
    batches.close()
    points = int(host["point_valid"].sum())
    images = torch.as_tensor(host.pop("images")).to(device)
    batch = common.batch_to_device(host, device)

    def train_step():
        return step(state, batch, encode(images))

    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(train_step, reps=10, warmup=3)
    peak = torch.cuda.max_memory_allocated()
    print(f"train step ({batch['points'].shape[0]} scenes, {points:,} valid "
          f"points): {step_ms:.3f} ms -> {points / step_ms * 1e3:,.0f} "
          f"points/s; peak allocated {peak / 2**30:.3f} GiB [{card}]")

    reps = 3
    train_step()
    torch.cuda.synchronize()
    with Capture(record=False), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            train_step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    device_ms = {e.key[len("smoke::"):]: e.device_time_total / reps / 1e3
                 for e in events if e.key.startswith("smoke::")}
    counts = {e.key[len("smoke::"):]: e.count / reps
              for e in events if e.key.startswith("smoke::")}
    # kernels only: user annotations (record_function ranges, the
    # optimizer's step) also appear on the device timeline
    cuda_events = [e for e in events if e.device_type.name == "CUDA"
                   and not e.is_user_annotation]
    by_name = {}
    for e in cuda_events:
        for k, pat in (("lse", r"fap_fwd_kernel<\d+, ?true>"),
                       ("bwd", r"fap_bwd_(dkdv|dq)_kernel")):
            if re.search(pat, e.key):
                by_name[k] = by_name.get(k, 0.0) + \
                    e.self_device_time_total / reps / 1e3
    total = sum(e.self_device_time_total for e in cuda_events) / reps / 1e3
    n_kernels = sum(e.count for e in cuda_events) / reps
    print(f"profiler, per train step: {json.dumps(device_ms)} ms, launches "
          f"{json.dumps(counts)}; by kernel name {json.dumps(by_name)} ms; "
          f"device kernel time {total:.3f} ms over {n_kernels:g} kernels")
    top = sorted(cuda_events, key=lambda e: -e.self_device_time_total)[:12]
    for e in top:
        print(f"  {e.self_device_time_total / reps / 1e3:8.3f} ms "
              f"{e.count / reps:6g}x  {e.key[:100]}")
    for k, n in TRAIN_LAUNCHES.items():
        if k != "K1" and not (counts.get(k) == n and device_ms.get(k, 0) > 0):
            raise AssertionError(f"profiler: {k} {counts.get(k)} launches, "
                                 f"{device_ms.get(k)} ms per step")
    for k, pair in (("lse", ("K2", "K4")), ("bwd", ("K3", "K5"))):
        both = device_ms[pair[0]] + device_ms[pair[1]]
        if not abs(both - by_name.get(k, 0.0)) <= 0.1 * both:
            raise AssertionError(f"profiler: {pair} {both} ms vs kernel "
                                 f"names {by_name.get(k)} ms")

    with Capture(record=True) as cap:
        train_step()
        torch.cuda.synchronize()
    # on the step's own inputs: bf16 outputs reach |out| ≥ 4, where one
    # bf16 ulp is 0.03, so both directions take the scaled rule
    # 0.05 · max(1, max |plain|); rel_err is the error over max |plain|
    inside = {}
    for k, calls in cap.calls.items():
        plain_ms, err, rel, lse_err = 0.0, 0.0, 0.0, 0.0
        for args, out in calls:
            if k in ("K2", "K4"):
                def plain(args=args):
                    return fa.flash_attention_packed_lse_reference(*args)
                ref = plain()
                e, limit = grad_error(out[0], ref[0])
                live = (args[1][:, 0] == 0).any(-1)
                lse_err = max(lse_err, (out[1] - ref[1])[live].abs()
                              .max().item())
                scale = ref[0].float().abs().max().item()
            else:
                def plain(args=args):
                    return fa.flash_attention_packed_bwd_reference(*args)
                ref = plain()
                e, limit = grad_error(out, ref)
                scale = ref.float().abs().max().item()
            err, rel = max(err, e), max(rel, e / max(scale, 1e-30))
            if not (e < limit and lse_err < LSE_TOL):
                raise AssertionError(f"{k} on the train step's inputs: "
                                     f"error {e} (limit {limit}), LSE "
                                     f"error {lse_err}")
            plain_ms += cuda_ms(plain, reps=5, warmup=1)
        inside[k] = dict(ms=device_ms[k], plain_ms=plain_ms,
                         max_abs_err=err, rel_err=rel, calls=len(calls))
        if k in ("K2", "K4"):
            inside[k]["lse_err"] = lse_err
        print(f"{k} inside the step: {json.dumps(inside[k])}")
        if len(calls) != TRAIN_LAUNCHES[k]:
            raise AssertionError(f"{k}: {len(calls)} calls in one step")
    del cap
    torch.cuda.empty_cache()
    return inside, dict(step_ms=step_ms, points=points,
                        points_per_s=points / step_ms * 1e3,
                        peak_bytes=peak, device_kernel_ms=total,
                        kernels_per_step=n_kernels)


def overfit_one_batch():
    """Phase 10: 10 steps on one fixed batch must lower its loss."""
    import torch
    from tpu3dssf_torch.cli import common
    from tpu3dssf_torch.train.loop import make_train_step

    cfg = common.load_config(CONFIG)
    device = torch.device("cuda")
    encode, vit_cfg = common.build_image_encoder(cfg, device)
    model, _ = common.build_pipeline(cfg, vit_cfg, device)
    state = common.init_state(cfg, model, steps_per_epoch=24)
    step = make_train_step(common.build_loss(cfg))
    batches = iter(common.build_dataloaders(cfg)["train"])
    host = next(batches)
    batches.close()
    images = torch.as_tensor(host.pop("images")).to(device)
    batch = common.batch_to_device(host, device)
    tokens = encode(images)
    losses = [float(step(state, batch, tokens)["loss"]) for _ in range(10)]
    print("overfit one batch, loss per step: "
          + " ".join(f"{x:.4f}" for x in losses))
    if not (all(map(lambda x: x == x, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"10 steps on one batch: {losses}")


def check_small_model_grad():
    """Phase 11: the small model's loss and gradient, card bf16 through the
    kernels vs CPU f32 through the plain versions."""
    import torch
    from tpu3dssf_torch.cli.common import batch_to_device
    from tpu3dssf_torch.losses import CELSLoss

    loss_fn = CELSLoss(weight=[1.0] * 16)
    loss, grads = {}, {}
    for device, dtype in (("cpu", torch.float32), ("cuda", torch.bfloat16)):
        encode, model, host, images = small_model(device, dtype)
        b = batch_to_device(host, device)
        before = counters()
        out = loss_fn(model(b["points"], b["point_valid"],
                            encode(images.to(device)), b["cam_intrinsics"],
                            b["lidar2cam"]), b["labels"], b["mask"])
        out.total.backward()
        used = {k: counters()[k] - before[k] for k in before}
        loss[device] = float(out.total.detach())
        grads[device] = {k: p.grad.detach().float().cpu().flatten()
                         for k, p in model.named_parameters()}
    if not all(used[k] > 0 for k in ("K2", "K3", "K4", "K5")):
        raise AssertionError(f"small model on the card launched {used}")
    cpu, card = grads["cpu"], grads["cuda"]
    a = torch.cat([cpu[k] for k in cpu])
    b = torch.cat([card[k] for k in cpu])
    cos = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
    per = {k: torch.nn.functional.cosine_similarity(
        cpu[k], card[k], dim=0, eps=1e-30).item() for k in cpu}
    low = min(per, key=per.get)
    rel = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
    print(f"small model gradient: loss card {loss['cuda']:.5f} vs CPU "
          f"{loss['cpu']:.5f} ({rel:.4%}); cosine of the whole gradient "
          f"{cos:.5f} (limit {GRAD_COSINE}); lowest per tensor "
          f"{per[low]:.4f} ({low}); launches on the card {used}")
    if not (rel < SMALL_MODEL_TOL and cos >= GRAD_COSINE):
        raise AssertionError(f"small model gradient: loss {rel}, cosine "
                             f"{cos}")


def main():
    if not os.path.isdir(os.path.join(ROOT, "tpu3dssf_torch")):
        sys.exit("chip_smoke.py: run it from a checkout of the repository "
                 "(tpu3dssf_torch/ is not beside it)")
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device is available")
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tpu3dssf_torch.cli.common import load_config
    from tpu3dssf_torch.kernels import flash_attention as fa

    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    print_build("forward kernels", fa.build(), time.perf_counter() - t0)

    cfg = load_config(CONFIG)
    rows = check_kernel(slice_attention_shapes(cfg))
    reset_counters()
    launches, k1, frame = run_slice(card)
    check_small_model()

    t0 = time.perf_counter()
    print_build("backward kernel", fa.build_backward(),
                time.perf_counter() - t0)
    train_rows = check_train_kernels(train_attention_shapes(cfg))
    tmp = tempfile.mkdtemp(prefix="tpu3dssf_smoke_")
    try:
        train_launches, steps = run_training(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    inside, step = time_train_step(card)
    overfit_one_batch()
    check_small_model_grad()

    records = [{
        "name": KERNELS["K1"][0], "route": "cuda",
        "source": "tpu3dssf_torch/csrc/" + KERNELS["K1"][1],
        "replaces": KERNELS["K1"][2],
        "launches": launches,
        "max_abs_err": max([k1["max_abs_err"]]
                           + [r["max_abs_err"] for r in rows]),
        # per batch of the inference path, on that batch's own inputs
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "per": "inference batch", "train_launches": train_launches["K1"],
    }]
    for k in ("K2", "K3", "K4", "K5"):
        name, source, replaces = KERNELS[k]
        records.append({
            "name": name, "route": "cuda",
            "source": "tpu3dssf_torch/csrc/" + source, "replaces": replaces,
            "launches": train_launches[k],
            "max_abs_err": max([inside[k]["max_abs_err"]]
                               + [r["max_abs_err"] for r in train_rows[k]]),
            # per train step, on that step's own inputs
            "ms": inside[k]["ms"], "plain_ms": inside[k]["plain_ms"],
            "per": f"train step ({steps} steps in the run)",
        })
    print("slice " + json.dumps(dict(frame, card=card)))
    print("train_step " + json.dumps(dict(step, card=card)))
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
