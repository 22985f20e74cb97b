"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths at full width with seeded random weights:
streaming fused inference (``tpu3dssf_torch.cli.main_infer``) and training
(``tpu3dssf_torch.cli.main_train``) over ``configs/synthetic_convergence_
fusion_r3.yaml`` (DINOv3 ViT-S/16 over 6 cameras → voxelize → PTv3 →
fusion head → devoxelize, bf16, batch 2), and the LiDAR-only reference-
parity path (``main_infer``, ``main_test``, ``main_sample``) over
``configs/synthetic_convergence_lidar_parity.yaml`` (knn5 voxelize → PTv3
→ linear head → nearest devoxelize, bf16, batch 4); then the fusion frame
with the ViT-L/16 encoder on both of its attention routes, that encoder's
gradient, and ``configs/synthetic_convergence_lidar.yaml`` at window 48,
where every PTv3 block takes the (W, K, H, D) window route. It checks, in
order (any failure raises, exit code ≠ 0):

1. a CUDA device is present; prints the card's name and power limit, and
   its maximum SM clock, which sets the exp's rate in the bounds;
2. (with 6 and 12) every kernel source builds from ``tpu3dssf_torch/csrc``,
   all three nvcc processes started together (one thread each); build
   times and ptxas registers, shared memory and spills;
3. the isolated attention checker (``check_attention``, one case of
   ``check_flash_shape`` per shape and route): K1 at every inference shape
   of the slice (max abs error < 0.05, bf16); at D = 64 beside the ViT-S
   one, K8 (with its LSE) and K9 at the ViT-L/16 encoder's shape (B = 12
   images, N = 2845 tokens, H = 16) and K8, K9 and K1 at ragged N = 1, 77,
   130 with the trailing keys masked; K1's RoPE branch at q_scale 1/8 at
   the ViT-S and ViT-L shapes with DINOv3's own tables (grid 40 x 71, 5
   identity prefix rows) and at ragged N = 1, 77, 130 with random tables
   (identity prefix rows, trailing keys masked), each also timed beside
   the route before the branch (rotation outside, ``torch.cat``, K1) and
   SDPA on q and k rotated beforehand; K6 and the window route's K4/K5 at
   every window-48 shape of the LiDAR config; K2/K4 and K3/K5 at every
   training shape (see 7). Every row: kernel, plain version and the
   library call computing the same function (``scaled_dot_product_
   attention``, with a gradient pending or its backward) timed with CUDA
   events (median of 20 after warm-up), beside the bound of that call;
   every row is also held within 2% of its max |plain| (``REL_TOL``);
4. the slice runs through the CLI's own entry point with the kernel's
   launch count up by exactly 34 per batch (12 ViT layers + 22 PTv3
   blocks), no k-NN launch and finite metrics; then one batch is timed end
   to end, and the kernel inside that batch: its device time and exactly
   34 launches per batch from the profiler (46 device kernels: each of the
   12 ViT layers takes the RoPE branch, whose k rotation is a kernel of its
   own), and the plain version's time and the kernel's error on the very
   inputs the batch gave the kernel, RoPE tables included (within 0.05 and
   within 2% of each call's max |plain|);
5. a small model gives the same logits on the card (bf16, kernels) as on
   the CPU (f32, plain versions), within 5% of the logit scale;
6. (the backward kernel's build, in 2);
7. (in 3) the training kernels against their plain versions at every
   training shape (random bf16, 30% padding keys, one all-padding window):
   the forward-with-LSE (K2 at C ≥ 128, K4 at C ∈ {32, 64}) within 0.05 and
   its LSE within 1e-3 on rows with a valid key; the backward (K3, K5)
   within 0.05 · max(1, max |plain|), and exactly 0 in the all-padding
   window; both also within 2% of their max |plain|, as every row of 3;
8. one epoch of training through the CLI's own entry point (24 steps, 6
   val batches) on a temporary copy of the config with exact launch counts
   (per step K1 12, K2 14, K3 14, K4 8, K5 8; K1 34 per val batch; no
   K7), finite metrics and a checkpoint; then ``--resume`` to a second
   epoch, which must start at epoch 1 with the optimizer state restored;
9. one train step (encode + forward + loss + backward + update) timed with
   CUDA events, its peak memory, K2–K5's device time inside it from the
   profiler, and their plain versions' time and the kernels' error on the
   inputs that step gave them (within 0.05 · max(1, max |plain|) and 2% of
   max |plain|, LSE within 1e-3);
10. 10 steps on one fixed batch lower its loss;
11. the small model's loss and gradient on the card (bf16, kernels) agree
    with the CPU's (f32, plain versions): loss within 5%, cosine of the
    whole gradient ≥ 0.98;
12. (the k-NN kernel's build, in 2);
13. K1 against its plain version at every attention shape of the parity
    config (22 PTv3 blocks at batch 4), by the checker of 3; then the k-NN kernel K7
    is bit-identical to its plain version (distances
    and indices) on both calls of a parity batch at full size (B = 4,
    Q = R = 34,816; knn5 k = 5, nearest k = 1), a ragged case (k = 8) and
    a case with fewer than k valid refs (slots (1e30, 0)); at full size
    K7 (median of 20 after 3), the plain version (5 after 1) and
    ``torch.cdist(q, r).topk(k, largest=False)`` (5 after 1, TF32 off)
    are timed, beside the bound;
14. ``main_infer``, ``main_test`` and ``main_sample`` run the parity
    config through their own entry points on a temporary copy (its
    checkpoint directory in a temporary directory, never the committed
    one), with the counts set to 0 before each: exactly 22 K1 and 2 K7
    launches per batch (3 test batches; main_sample 1) and no other
    kernel, finite metrics, the chart and the 3D view written;
15. one parity batch timed end to end with CUDA events and its peak
    memory; K1 and K7 inside it as K1 in 4: device time and exactly 22 and
    2 launches per batch from the profiler, and on the inputs that batch
    gave them the plain versions' time and the kernels' error (K1 within
    0.05, K7 bit for bit), for K7 also cdist + topk's time and the bound;
16. (in 3) the (B, N, H, D) kernels against their plain versions: K8
    (and its training forward with LSE) and K9 at the ViT-L/16 shape and
    ragged N; K6 and the window route's K4/K5 at every window-48 shape
    (random padding keys, one all-padding window). Outputs within 0.05,
    LSE within 1e-3, gradients within 0.05 · max(1, max |plain|) and
    exactly 0 in the all-padding window; besides, every output within 2%
    of its max |plain|, and dq, dk, dv within 2% of their largest |plain|
    value (``REL_TOL``);
17. ``main_infer`` over the fusion config with ``image_encoder:
    dinov3_large`` (ViT-L/16, a temporary copy): exactly 46 K1 launches per
    batch (24 ViT layers + 22 PTv3 blocks) and no other kernel over its 6
    test batches (2 scenes, 12 images at 640 x 1138 each), finite metrics;
    one batch timed end to end with its peak memory, and K1 inside it as in
    4 (46 launches, 70 device kernels per batch);
18. the same encoder, weights and images with ``packed_head_groups=False``:
    exactly 24 K8 launches and no K1 per encode, its patch tokens (q and k
    rotated outside the kernel) within 1% of the largest token of the K1
    route's (rotated inside), and K8 inside the encode as
    K1 in 4 (device time, then the plain version, SDPA and the bound on
    each call's own inputs; each call within 0.05 and within 2% of its max
    |plain|);
19. the gradient of a fixed random projection of that encoder's patch
    tokens with respect to every parameter, one sample of 6 images:
    exactly 24 K8 and 24 K9 launches; card kernels vs the plain versions on
    the card, per-parameter cosine ≥ 0.98; K9 inside the backward (two
    device kernels per call: the one-pass ``fap_bwd_d64_kernel`` and
    ``fap_bwd_d64_dq_kernel``, which scales and casts its f32 dq) as K8 in
    18, within 0.05 · max(1, max |plain|)
    and within 2% of the call's largest |plain| gradient value;
20. ``main_infer`` over the LiDAR-only config at window 48 (a temporary
    copy, voxel capacity 726 x 48): exactly 22 K6 launches per batch and no
    other kernel, finite metrics; one batch timed end to end with K6 inside
    it as K8 in 18; one train step: exactly 22 K4 and 22 K5, a finite loss;
21. the gradient of 19 on the K1 route, through the training rule of K1's
    RoPE branch (its forward with LSE, then K9 on the rotated q and k):
    exactly 24 K1 and 24 K9 launches and no other kernel, per-parameter
    cosine ≥ 0.98 against the plain versions on the card.

The last two lines are a JSON record of the kernels and the device line.
Every kernel record has ``launches`` (from its path's run), ``max_abs_err``
(the largest error of its checks), ``ms`` (device time inside the path),
``plain_ms``, ``bound_ms`` and ``bound_by`` (the least time the card could
take: bytes at 3.35 TB/s or operations at 989 TFLOP/s bf16 / 67 TFLOP/s
f32 / one exp per score at 16 per clock per SM, at the card's
maximum SM clock; ``bound_term`` says which, "exp" counting as operations
in ``bound_by``) and ``library_ms`` (the PyTorch call named in ``library``). K1's
numbers are per inference batch (step 4, 6 batches; ``parity`` holds its
time per parity batch, step 15, ``vitl`` per ViT-L batch, step 17, and
``rope`` the RoPE branch per call at the ViT-S and ViT-L shapes, step 3,
with the launches of step 21); K2–K5's per train step (step 9; launches
from the one-epoch run of step 8); K7's per parity batch (step 15;
launches from step 14's main_infer run); K6's per window-48 batch (step
20), K8's per ViT-L encode (step 18) and K9's per ViT-L backward (step
19), with the bound and SDPA's time summed over that run's own calls.
Every ``ms`` is device time from the profiler.
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
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = "configs/synthetic_convergence_fusion_r3.yaml"
KERNEL_TOL = 0.05            # bf16 kernel vs plain (check_tpu_kernels.py)
LSE_TOL = 1e-3               # f32 LSE, kernel vs plain, rows with a key
SMALL_MODEL_TOL = 0.05       # bf16 card vs f32 CPU, relative to max |logit|
GRAD_COSINE = 0.98           # bf16 card vs f32 CPU, the whole gradient
LAUNCHES_PER_BATCH = 12 + 22
PARITY_CONFIG = "configs/synthetic_convergence_lidar_parity.yaml"
# per batch of the LiDAR-only parity model: 22 PTv3 blocks (K1), the knn5
# intensity transfer and the nearest devoxelization (K7)
PARITY_LAUNCHES = {"K1": 22, "K7": 2}
# H100 SXM peaks from NVIDIA's datasheet: bf16 tensor cores, f32
# outside the tensor cores, HBM
BF16_FLOPS, F32_FLOPS, HBM_BYTES = 989e12, 67e12, 3.35e12
# the exp's rate (see exp_rate) at the H100 SXM's maximum SM clock of
# 1980 MHz; main() sets it from the card's own clocks.max.sm
H100_SMS = 132
EXP_RATE = 16 * H100_SMS * 1980e6
# per train step: K1 (frozen ViT), K2/K3 (14 blocks at C >= 128), K4/K5
# (8 blocks at C in {32, 64})
TRAIN_LAUNCHES = {"K1": 12, "K2": 14, "K3": 14, "K4": 8, "K5": 8}
# the ViT-L/16 fusion frame: K1 per batch (24 ViT layers + 22 PTv3 blocks),
# and K8 per encode (24 layers) on the (B, N, H, D) route
VITL_LAUNCHES, VITL_LAYERS = 24 + 22, 24
# the LiDAR-only config at PTv3's upstream constructor window of 48: every
# block on the (W, K, H, D) route, K6 per batch and K4 + K5 per train step
LIDAR_CONFIG = "configs/synthetic_convergence_lidar.yaml"
WINDOW, WINDOW_CAPACITY, WINDOW_LAUNCHES = 48, 726 * 48, 22
# every kernel comparison also holds each compared output to
# max |kernel - plain| <= REL_TOL * max |plain| (see rel_err): the absolute
# limits above are as large as a typical value over a long key row (|out|
# ~ sqrt(e / N) ~ 0.05 at N = 1024 for unit-variance scores), so a lost or
# mis-rescaled key tile would pass them, and far above the gradients that
# reach K9 in the ViT-L backward; one bf16 ulp is at most 2**-7 of a value
REL_TOL = 0.02
# K8 route vs K1 route patch tokens, max abs error over max |token|: the K1
# route rotates q·(1/8) and k inside its kernel, the K8 route rotates them
# outside in plain torch and scales q in its kernel; both round once, the
# attention runs the same kernel body, so they differ by rounding at most
VITL_ROUTE_TOL = 0.01
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
    "K6": ("window_attention", "flash_attention_packed.cu",
           "tpu3dssf/kernels/window_attention.py:70"),
    "K7": ("knn", "knn.cu", "tpu3dssf/kernels/knn.py:40"),
    "K8": ("flash_attention", "flash_attention_packed.cu",
           "tpu3dssf/kernels/flash_attention.py:51"),
    "K9": ("flash_attention_bwd", "flash_attention_packed_bwd.cu",
           "tpu3dssf/kernels/flash_attention.py:126"),
}
SOURCES = sorted({source for _, source, _ in KERNELS.values()})


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def sm_clock_mhz():
    """The SM clock's maximum, as ``nvidia-smi --query-gpu=clocks.max.sm``
    reports it (MHz)."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])


def exp_rate(clock_mhz):
    """exps per second on the special-function units: 16 ``ex2`` per clock
    on each of the 132 SMs of an H100 SXM."""
    return 16 * H100_SMS * clock_mhz * 1e6


def bound(flops, f32_ops, nbytes, exps=0):
    """(least ms, "operations", "exp" or "bytes"): bf16 tensor-core FLOPs,
    f32 operations and exps (on the special-function units, at
    :data:`EXP_RATE`) each at its peak, and bytes at the HBM rate; the
    longest of them sets the bound and names it ("exp" where the exps
    take longer than the rest)."""
    times = {"operations": max(flops / BF16_FLOPS, f32_ops / F32_FLOPS),
             "exp": exps / EXP_RATE, "bytes": nbytes / HBM_BYTES}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def attention_bound(B, N, C, H, kind, rope=False):
    """Bound of one packed-attention call on (B, N, 3C) bf16 qkv. kind
    "fwd" (K1, K6, K8), "lse" (K2/K4, K8 with its LSE) or "bwd" (K3/K5,
    K9). Operations: the products (QKᵀ and PV, 4·N²·C per row block; the
    backward recomputes QKᵀ and takes four more, 10·N²·C) and 4 f32
    operations per score (max, subtract, exp, sum; backward: exp(s − lse),
    subtract, multiply, scale). Exps: one per score in every kind; the
    backward's p = exp(s − lse) needs no more (the two-pass D = 16 backward
    spends a second, which the bound does not count). Bytes: each input read
    once, each output written once. With ``rope`` (K1's RoPE branch, a
    forward): rotating q and each key once, 6 f32 operations per channel
    pair (4 products, 2 sums) and 2 more for q's scale, so 7·C per token;
    the two (N, C/H/2) f32 tables read once, 4·N·C/H bytes."""
    rows = B * N
    scores = B * H * N * N
    mm = (10 if kind == "bwd" else 4) * B * N * N * C
    if kind == "bwd":   # qkv, bias, dout, lse, delta → dqkv
        nbytes = rows * (6 * C + 4 + 2 * C + 8 * H + 6 * C)
    else:               # qkv, bias → out (+ lse)
        nbytes = rows * (6 * C + 4 + 2 * C + (4 * H if kind == "lse" else 0))
    f32_ops = 4 * scores
    if rope:
        f32_ops += 7 * rows * C
        nbytes += 4 * N * (C // H)
    return bound(mm, f32_ops, nbytes, scores)


def bound_term(rows):
    """The term ("operations", "exp" or "bytes") that sets most of the
    summed bound of ``rows`` (each with ``bound_ms`` and ``bound_by``)."""
    ms = {}
    for r in rows:
        ms[r["bound_by"]] = ms.get(r["bound_by"], 0.0) + r["bound_ms"]
    return max(ms, key=ms.get)


def record_bound_by(term):
    """The kernels line's ``bound_by``: the exp runs on the SM's special-
    function units, so an exp bound is one of operations there."""
    return "bytes" if term == "bytes" else "operations"




def slice_attention_shapes(cfg):
    """(name, B, N, C, H, q_scale, masked, launches per batch) of every
    attention call of one test batch of ``cfg`` (the ViT's only where it
    has one)."""
    from tpu3dssf_torch.models.ptv3 import PTv3Config, _round_up
    from tpu3dssf_torch.models.vit import dinov3_small

    vit = dinov3_small()
    batch = cfg.test_loader.batch_size
    n_tok = vit.num_prefix_tokens + vit.num_patches
    shapes = [] if cfg.image_encoder == "none" else [
        ("vit", 6 * batch, n_tok, vit.hidden_size, vit.num_heads, None,
         False, vit.num_layers)]
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




def run_slice(card):
    import numpy as np
    import torch
    from tpu3dssf_torch.cli import common, main_infer
    from tpu3dssf_torch.kernels.modules import flash_attention as fa
    from tpu3dssf_torch.train.loop import make_eval_step
    from tpu3dssf_torch.utils import cuda_ms

    reset_counters()
    metrics = main_infer.main(["--config", CONFIG, "--split", "test"])
    launches = fa.LAUNCHES
    if counters()["K7"]:
        raise AssertionError("the fusion config's modes launched K7")
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
    inside, total = time_kernels_in_path(frame, {"K1": k1_spec(
        LAUNCHES_PER_BATCH, rope=vit_cfg.num_layers)})
    return launches, inside["K1"], dict(frame_ms=frame_ms, points=points,
                                        points_per_s=points / frame_ms * 1e3,
                                        peak_bytes=peak,
                                        device_kernel_ms=total)


def k1_spec(launches, rope=0):
    """K1 inside a batch: its launcher, its plain version (on each call's
    own inputs, RoPE tables included) and its tolerance (see
    :func:`time_kernels_in_path`). ``rope`` of the ``launches`` take the
    RoPE branch (the ViT's layers), each two device kernels: k's rotation
    (``fap_fwd_kernel_rope_k``) and the attention."""
    from tpu3dssf_torch.kernels.modules import flash_attention as fa
    return dict(pattern="fap_fwd_kernel", module=fa, attr="_launch",
                plain=fa.flash_attention_packed_reference,
                error=lambda got, want: (got.float() - want.float()).abs()
                .max().item(),
                ok=lambda err: err < KERNEL_TOL, relative=True,
                launches=launches, device_kernels=launches + rope)


def k7_spec():
    """K7 inside a parity batch: bit-identical to its plain version, timed
    beside cdist + topk and its bound."""
    from tpu3dssf_torch.kernels import knn

    def error(got, want):
        d, mismatches = knn_mismatch(got, want)
        return d if mismatches == 0 else float("inf")

    return dict(pattern="knn_kernel", module=knn, attr="knn", plain=knn_plain,
                error=error, ok=lambda err: err == 0.0,
                launches=PARITY_LAUNCHES["K7"], library=cdist_topk,
                bound=knn_bound)


def capture_calls(module, attr, frame):
    """Run ``frame()`` once with ``module.<attr>`` wrapped; returns the
    (inputs, outputs) of each of its calls, cloned."""
    import torch
    launch, calls = getattr(module, attr), []

    def clone(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        return tuple(map(clone, x)) if isinstance(x, tuple) else x

    def wrapped(*args, **kwargs):
        out = launch(*args, **kwargs)
        calls.append((clone(args), clone(out)))
        return out

    setattr(module, attr, wrapped)
    try:
        frame()
        torch.cuda.synchronize()
    finally:
        setattr(module, attr, launch)
    return calls


def profiled_counts(kernels, specs):
    """{tag: (device ms, device kernels) per batch} of each spec's kernel in
    a :func:`profile_kernels` table."""
    out = {}
    for tag, spec in specs.items():
        hits = [v for k, v in kernels.items() if spec["pattern"] in k]
        out[tag] = (sum(us for us, _ in hits) / 1e3, sum(c for _, c in hits))
    return out


def time_kernels_in_path(frame, specs):
    """Kernels inside one batch of a path. From the profiler (3 batches):
    each kernel's device time and launches per batch, which must be exactly
    its expected count (the profiler now and then drops a device record, so
    a short count is profiled once more; a real miscount repeats). Then, on
    the inputs that batch gave it: its error
    against the plain version, the plain version's time per batch (Σ of
    CUDA-event medians) and, where the spec has them, the library call's
    time and the bound, both summed over the batch's calls.

    ``specs``: {tag: dict(pattern (in the kernel's name), module and attr
    (its launcher), plain, error(got, want), ok(error), launches per batch,
    optional device_kernels (device kernels the pattern matches per batch,
    default one a launch), library(*inputs) -> callable, bound(*inputs) ->
    (ms, by) and relative (also hold each call to :func:`rel_err` <=
    REL_TOL))}. Each row also splits its device time by kernel name
    (``by_name``). Returns ({tag: row}, the batch's device kernel time in
    ms)."""
    import functools
    import torch
    from tpu3dssf_torch.utils import cuda_ms, profile_kernels

    def short(counts):
        return [tag for tag, (ms, n) in counts.items() if not (
            ms > 0 and n == specs[tag].get("device_kernels",
                                           specs[tag]["launches"]))]

    _, kernels, _ = profile_kernels(frame, reps=3)
    if short(profiled_counts(kernels, specs)):
        print(f"profiler: counts {profiled_counts(kernels, specs)} off "
              f"their expected values; profiling once more")
        _, kernels, _ = profile_kernels(frame, reps=3)
    counts = profiled_counts(kernels, specs)
    total = sum(us for us, _ in kernels.values()) / 1e3
    print(f"profiler, per batch: device kernel time {total:.3f} ms over "
          f"{sum(c for _, c in kernels.values()):g} kernels")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (us, c) in top:
        print(f"  {us / 1e3:8.3f} ms {c:6g}x  {name[:100]}")
    rows = {}
    for tag, spec in specs.items():
        ms, n = counts[tag]
        if tag in short(counts):
            raise AssertionError(
                f"profiler saw {n:g} {tag} device kernels and {ms} ms per "
                f"batch, expected {spec.get('device_kernels')} device kernels "
                f"for {spec['launches']} launches and > 0")
        calls = capture_calls(spec["module"], spec["attr"], frame)
        if len(calls) != spec["launches"]:
            raise AssertionError(f"{tag}: {len(calls)} calls in one batch")
        row = dict(ms=ms, launches=len(calls), device_kernels=n, by_name={
            name[:90]: us / 1e3 for name, (us, _) in kernels.items()
            if spec["pattern"] in name}, plain_ms=0.0, max_abs_err=0.0)
        library, bound = spec.get("library"), spec.get("bound")
        by = []
        for args, got in calls:
            plain = functools.partial(spec["plain"], *args)
            want = plain()
            row["max_abs_err"] = max(row["max_abs_err"],
                                     spec["error"](got, want))
            if spec.get("relative"):
                row["rel_err"] = max(row.get("rel_err", 0.0),
                                     rel_err(got, want))
            del want
            row["plain_ms"] += cuda_ms(plain, reps=5, warmup=1)
            if library:
                row["library_ms"] = row.get("library_ms", 0.0) + cuda_ms(
                    library(*args), reps=5, warmup=1)
            if bound:
                b_ms, b_by = bound(*args)
                row["bound_ms"] = row.get("bound_ms", 0.0) + b_ms
                by.append(dict(bound_ms=b_ms, bound_by=b_by))
            torch.cuda.empty_cache()
        if by:
            row["bound_by"] = bound_term(by)
        del calls
        torch.cuda.empty_cache()
        print(f"{tag} inside the batch, on its own inputs: "
              f"{json.dumps(row)}", flush=True)
        if (not spec["ok"](row["max_abs_err"])
                or row.get("rel_err", 0.0) > REL_TOL):
            raise AssertionError(f"{tag} on the batch's own inputs: error "
                                 f"{row['max_abs_err']} (relative "
                                 f"{row.get('rel_err')}) against its plain "
                                 "version")
        rows[tag] = row
    return rows, total


def small_model(device, dtype):
    """A small fusion model with seeded weights, on ``device`` in ``dtype``:
    (encode_fn, model, host batch, images). Its PTv3 has stages at C = 32,
    64 and 128 at window 128, so it reaches K1–K5."""
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
            enc_heads=(2, 4, 8), enc_window=(128, 128, 128),
            dec_depths=(1, 1), dec_channels=(32, 64), dec_heads=(2, 4),
            dec_window=(128, 128), dtype=dtype),
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


def print_build(what, info):
    print(f"build {what}: nvcc {info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling",
                                   "warning")):
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




def grad_error(got, ref):
    """(max abs error, the limit 0.05 · max(1, max |plain|))."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, KERNEL_TOL * max(1.0, ref.float().abs().max().item())




def counters():
    from tpu3dssf_torch.kernels.modules import flash_attention as fa
    from tpu3dssf_torch.kernels.modules import window_attention as wa
    from tpu3dssf_torch.kernels.modules import knn
    return {"K1": fa.LAUNCHES, "K2": fa.LSE_LAUNCHES, "K3": fa.BWD_LAUNCHES,
            "K4": wa.LSE_LAUNCHES, "K5": wa.BWD_LAUNCHES, "K6": wa.LAUNCHES,
            "K7": knn.LAUNCHES, "K8": fa.FLASH_LAUNCHES,
            "K9": fa.FLASH_BWD_LAUNCHES}


def reset_counters():
    from tpu3dssf_torch.kernels.modules import flash_attention as fa
    from tpu3dssf_torch.kernels.modules import knn
    from tpu3dssf_torch.kernels.modules import window_attention as wa
    fa.LAUNCHES = fa.LSE_LAUNCHES = fa.BWD_LAUNCHES = 0
    fa.FLASH_LAUNCHES = fa.FLASH_BWD_LAUNCHES = 0
    wa.LAUNCHES = wa.LSE_LAUNCHES = wa.BWD_LAUNCHES = 0
    knn.LAUNCHES = 0


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
    want = {k: TRAIN_LAUNCHES.get(k, 0) * steps for k in launches}
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
        from tpu3dssf_torch.kernels.modules import flash_attention as fa
        self.fa, self.record = fa, record
        self.calls = {k: [] for k in ("K2", "K3", "K4", "K5")}
        self.lse, self.bwd = fa._launch_lse, fa._launch_bwd

    def __enter__(self):
        import torch
        fa = self.fa

        def lse(qkv, bias, heads, q_scale, *rope):
            k = "K2" if (qkv.shape[-1] // 3) % 128 == 0 else "K4"
            with torch.profiler.record_function(f"smoke::{k}"):
                out = self.lse(qkv, bias, heads, q_scale, *rope)
            if self.record:
                self.calls[k].append(((qkv.clone(), bias.clone(), heads,
                                       q_scale, *rope),
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
    from tpu3dssf_torch.cli import common
    from tpu3dssf_torch.kernels.modules import flash_attention as fa
    from tpu3dssf_torch.train.loop import make_train_step
    from tpu3dssf_torch.utils import cuda_ms, profile_kernels

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

    with Capture(record=False):
        _, kernels, spans = profile_kernels(train_step, reps=3)
    device_ms = {k[len("smoke::"):]: us / 1e3 for k, (us, _) in spans.items()
                 if k.startswith("smoke::")}
    counts = {k[len("smoke::"):]: c for k, (_, c) in spans.items()
              if k.startswith("smoke::")}
    by_name = {}
    for name, (us, _) in kernels.items():
        for k, pat in (("lse", r"fap_fwd_kernel<\d+, ?true>"),
                       ("bwd", r"fap_bwd_(dkdv|dq)_kernel")):
            if re.search(pat, name):
                by_name[k] = by_name.get(k, 0.0) + us / 1e3
    total = sum(us for us, _ in kernels.values()) / 1e3
    n_kernels = sum(c for _, c in kernels.values())
    print(f"profiler, per train step: {json.dumps(device_ms)} ms, launches "
          f"{json.dumps(counts)}; by kernel name {json.dumps(by_name)} ms; "
          f"device kernel time {total:.3f} ms over {n_kernels:g} kernels")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (us, c) in top:
        print(f"  {us / 1e3:8.3f} ms {c:6g}x  {name[:100]}")
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
    # 0.05 · max(1, max |plain|); rel_err, the error over max |plain|, is
    # held to REL_TOL
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
            if not (e < limit and rel <= REL_TOL and lse_err < LSE_TOL):
                raise AssertionError(f"{k} on the train step's inputs: "
                                     f"error {e} (limit {limit}, relative "
                                     f"{rel}), LSE error {lse_err}")
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


def knn_bound(queries, refs, ref_mask, k):
    """Bound of one k-NN call: 8 f32 operations for each squared distance
    and one compare, for every query against every valid ref (this run's
    data); bytes: queries, refs and mask read once, (B, Q, k) distances
    and indices written once."""
    B, Q, _ = queries.shape
    R = refs.shape[1]
    pairs = Q * int(ref_mask.sum())
    return bound(0, 9 * pairs, B * Q * 12 + B * R * 13 + B * Q * k * 8)


def knn_plain(queries, refs, ref_mask, k):
    from tpu3dssf_torch.voxel.voxelize import topk_neighbors_reference
    return topk_neighbors_reference(queries, refs, ref_mask, k)


def knn_mismatch(got, want):
    """(max |Δ distance|, index mismatches) of two k-NN results; both 0
    when they are bit-identical."""
    d = (got[0] - want[0]).abs().max().item()
    return d, int((got[1] != want[1]).sum())


def cdist_topk(queries, refs, ref_mask, k):
    """The library call: ``torch.cdist(q, r).topk(k, largest=False)``, with
    the masked refs moved 1e6 m away beforehand (not timed)."""
    import torch
    far = torch.where(ref_mask[..., None], refs, 1e6)
    return lambda: torch.cdist(queries, far).topk(k, dim=-1, largest=False)


def parity_batch_inputs():
    """The first test batch of the parity config on the card and the K7
    inputs its two calls see: (points (B, P, 3), point mask, centroids
    (B, V, 3), voxel mask)."""
    import torch
    from tpu3dssf_torch.cli import common
    from tpu3dssf_torch.voxel import voxelize

    cfg = common.load_config(PARITY_CONFIG)
    batches = iter(common.build_dataloaders(cfg)["test"])
    host = next(batches)
    batches.close()
    host.pop("images", None)
    b = common.batch_to_device(host, torch.device("cuda"))
    w = cfg.tpu.window_size
    cap = -(-cfg.tpu.voxel_capacity // w) * w
    vox = voxelize(b["points"], b["point_valid"], cfg.voxel_size, cap,
                   intensity_mode="none")
    return (b["points"][..., :3].contiguous(), b["point_valid"],
            vox.voxel_raw[..., :3].contiguous(), vox.voxel_mask)


def check_knn(card):
    """Phase 13: K7 vs its plain version on the card, bit for bit: both
    calls of a parity batch at full size (knn5: centroids → points, k = 5;
    nearest: points → centroids, k = 1), a ragged case and a case with
    fewer than k valid refs. K7 timed as the median of 20 after 3 warm-ups,
    the plain version 5 after 1, cdist + topk 5 after 1."""
    import torch
    from tpu3dssf_torch.kernels import knn
    from tpu3dssf_torch.utils import cuda_ms

    pts, pmask, cents, vmask = parity_batch_inputs()
    gen = torch.Generator().manual_seed(7)
    # ragged: 60 m scenes as the synthetic data spans, 20% masked refs
    rq = (torch.rand(3, 1000, 3, generator=gen) * 120 - 60).cuda()
    rr = (torch.rand(3, 2501, 3, generator=gen) * 120 - 60).cuda()
    rm = (torch.rand(3, 2501, generator=gen) > 0.2).cuda()
    fm = torch.zeros(2, 40, dtype=torch.bool)
    fm[1, [3, 17, 29]] = True       # sample 0: no valid ref at all
    cases = [("knn5 (centroids -> points)", cents, pts, pmask, 5),
             ("nearest (points -> centroids)", pts, cents, vmask, 1),
             ("ragged Q=1000 R=2501", rq, rr, rm, 8),
             ("fewer than k valid refs", rq[:2, :300], rr[:2, :40],
              fm.cuda(), 5)]
    rows = []
    for name, q, r, m, k in cases:
        got = knn.knn(q, r, m, k)
        torch.cuda.synchronize()
        want = knn_plain(q, r, m, k)
        d_err, i_err = knn_mismatch(got, want)
        full = k in (1, 5) and q.shape[1] > 30000
        row = dict(case=name, B=q.shape[0], Q=q.shape[1], R=r.shape[1], k=k,
                   max_abs_err=d_err, index_mismatches=i_err)
        if full:
            row["ms"] = cuda_ms(lambda: knn.knn(q, r, m, k))
            row["plain_ms"] = cuda_ms(lambda: knn_plain(q, r, m, k),
                                      reps=5, warmup=1)
            row["cdist_topk_ms"] = cuda_ms(cdist_topk(q, r, m, k), reps=5,
                                           warmup=1)
            row["bound_ms"], row["bound_by"] = knn_bound(q, r, m, k)
            torch.cuda.empty_cache()
        if name.startswith("fewer"):   # slots left over: (1e30, 0)
            unfilled = (got[0][0], got[1][0], got[0][1, :, 3:],
                        got[1][1, :, 3:])
            row["unfilled_ok"] = all(bool((x == v).all()) for x, v in zip(
                unfilled, (knn.BAD_DIST, 0, knn.BAD_DIST, 0)))
        print("kernel K7 " + json.dumps(row), flush=True)
        if d_err != 0.0 or i_err or row.get("unfilled_ok") is False:
            raise AssertionError(f"K7 {name}: not bit-identical to its plain "
                                 f"version (max |Δd| {d_err}, {i_err} index "
                                 f"mismatches) or wrong unfilled slots")
        rows.append(row)
    return rows


def config_copy(src, tmp, name, train=None, tpu=None):
    """A copy of config ``src`` under ``tmp`` with its checkpoints there too
    (the stock ones point at committed TPU records), ``train`` and ``tpu``
    updating its train_params and tpu_params. Returns (path, ckpt dir)."""
    import yaml
    with open(src) as f:
        raw = yaml.safe_load(f)
    ckpt = os.path.join(tmp, "ckpt")
    raw["train_params"].update(checkpoint_path=ckpt, best_model_path=ckpt,
                               **(train or {}))
    raw["test_params"]["checkpoint_path"] = ckpt
    raw["tpu_params"].update(tpu or {})
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path, ckpt


def run_parity_clis(tmp):
    """Phase 14: main_infer, main_test and main_sample through their own
    entry points on a copy of the parity config, counts set to 0 just
    before each and read just after: exactly 22 K1 and 2 K7 launches per
    batch and no other kernel; finite metrics; the artifacts in the
    temporary checkpoint directory. Returns {cli: (launches, batches)}."""
    import numpy as np
    from tpu3dssf_torch.cli import common, main_infer, main_sample, main_test

    path, ckpt = config_copy(PARITY_CONFIG, tmp, "parity.yaml")
    n_test = len(common.build_dataloaders(common.load_config(path))["test"])
    runs = {}
    for name, cli, argv, n in (
            ("main_infer", main_infer, ["--split", "test"], n_test),
            ("main_test", main_test, [], n_test),
            ("main_sample", main_sample, [], 1)):
        reset_counters()
        t0 = time.perf_counter()
        metrics = cli.main(["--config", path] + argv)
        seconds = time.perf_counter() - t0
        launches = counters()
        want = {k: PARITY_LAUNCHES.get(k, 0) * n for k in launches}
        bad = {k: v for k, v in metrics.items() if not np.isfinite(v).all()}
        print(f"parity {name}: {n} batches in {seconds:.1f} s, launches "
              f"{launches} (expected {want}), overall acc "
              f"{float(metrics['overall_acc']):.4f}")
        if launches != want or bad:
            raise AssertionError(f"parity {name}: launches {launches} "
                                 f"(expected {want}), non-finite {bad}")
        runs[name] = (launches, n)
    import importlib.util
    written = ["segmentation_result.html"]
    if importlib.util.find_spec("matplotlib") is not None:
        written.append("per_class_iou.png")    # else main_test says so
    for f in written:
        if not os.path.exists(os.path.join(ckpt, f)):
            raise AssertionError(f"parity CLIs wrote no {f} under {ckpt}")
    return runs


def time_parity_batch(card, tmp):
    """Phase 15: one parity batch end to end (LiDAR-only model + loss) with
    CUDA events and its peak memory; K1 and K7 inside it (device time and
    launches from the profiler; on the inputs that batch gave them, the
    plain versions' time and the kernels' error: K1 within 0.05, K7 bit for
    bit; for K7 also cdist + topk's time and the bound)."""
    import torch
    from tpu3dssf_torch.cli import common
    from tpu3dssf_torch.train.loop import make_eval_step
    from tpu3dssf_torch.utils import cuda_ms

    path, _ = config_copy(PARITY_CONFIG, tmp, "parity.yaml")
    cfg = common.load_config(path)
    device = torch.device("cuda")
    model, _ = common.build_pipeline(cfg, None, device)
    step = make_eval_step(common.build_loss(cfg), cfg.mlp_class)
    batches = iter(common.build_dataloaders(cfg)["test"])
    host = next(batches)
    batches.close()
    host.pop("images", None)
    points = int(host["point_valid"].sum())
    batch = common.batch_to_device(host, device)
    tokens = common.zero_tokens(cfg, None, batch["points"].shape[0], device)

    def frame():
        return step(model, batch, tokens)

    torch.cuda.reset_peak_memory_stats()
    frame_ms = cuda_ms(frame, reps=10, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    print(f"parity batch ({batch['points'].shape[0]} scenes, {points:,} "
          f"valid points): {frame_ms:.3f} ms -> "
          f"{points / frame_ms * 1e3:,.0f} points/s; peak allocated "
          f"{peak / 2**30:.3f} GiB [{card}]")

    inside, total = time_kernels_in_path(
        frame, {"K1": k1_spec(PARITY_LAUNCHES["K1"]), "K7": k7_spec()})
    return inside, dict(frame_ms=frame_ms, points=points,
                        points_per_s=points / frame_ms * 1e3,
                        peak_bytes=peak, device_kernel_ms=total)


def sdpa_views(q, k, v, bias, grad=False):
    """(leaves, (q, k, v) as (B, H, N, D) views, attn_mask) for
    ``scaled_dot_product_attention`` from (B, N, H, D) tensors: detached
    copies that require grad when ``grad``; the additive bias in the
    inputs' dtype where it masks a key, else None."""
    leaves = [x.detach().requires_grad_(grad) for x in (q, k, v)]
    mask = bias[:, None].to(q.dtype) if bool((bias != 0).any()) else None
    return leaves, [x.transpose(1, 2) for x in leaves], mask


def flash_library(q, k, v, bias, q_scale, *_):
    """The library call of one forward call (K6, K8): SDPA on its inputs."""
    import torch.nn.functional as F
    _, (qt, kt, vt), mask = sdpa_views(q, k, v, bias)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  scale=q_scale)


def flash_bwd_library(q, k, v, bias, dout, lse, delta, q_scale, *_):
    """The library call of one backward call (K5, K9): the autograd
    backward of SDPA's forward on its inputs (run once, not timed)."""
    import torch
    import torch.nn.functional as F
    leaves, (qt, kt, vt), mask = sdpa_views(q, k, v, bias, grad=True)
    out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                         scale=q_scale)
    g = dout.transpose(1, 2)
    return lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)


def flash_bound(kind):
    """:func:`attention_bound` of one (B, N, H, D) call from its inputs."""
    def bound_of(q, *_):
        B, N, H, D = q.shape
        return attention_bound(B, N, H * D, H, kind)
    return bound_of


def mha_plain(q, k, v, bias, *_):
    """The plain version of K6 and K8 on a forward call's inputs."""
    from tpu3dssf_torch.kernels.modules import flash_attention as fa
    return fa.mha_reference(q, k, v, bias)


def bwd_plain(q, k, v, bias, dout, lse, delta, q_scale, *_):
    """The plain version of K5 and K9 on a backward call's inputs."""
    from tpu3dssf_torch.kernels.modules import flash_attention as fa
    return fa.flash_attention_bwd_reference(q, k, v, bias, dout, lse, delta,
                                            q_scale)


def max_err(got, want):
    return (got.float() - want.float()).abs().max().item()


def peak(x):
    return x.float().abs().max().item()


def rel_err(got, want):
    """max |got - want| / max |want| (0 where both are 0). For the tuple
    (dq, dk, dv) both maxima run over all three: dq and dk alone can be 0
    up to rounding (at N = 1 they are), so they have no scale of their
    own."""
    if isinstance(want, (tuple, list)):
        err = max(max_err(a, b) for a, b in zip(got, want))
        top = max(peak(b) for b in want)
    else:
        err, top = max_err(got, want), peak(want)
    return err / top if top else (0.0 if err == 0.0 else float("inf"))


def grads_err(got, want):
    """Max abs error over (dq, dk, dv); inf when one of them is not within
    0.05 · max(1, max |plain|)."""
    errs = [grad_error(a, b) for a, b in zip(got, want)]
    return (max(e for e, _ in errs) if all(e < lim for e, lim in errs)
            else float("inf"))


def rope_inputs(gen, N):
    """(angles (N − n_prefix, 32), n_prefix, cos, sin) of the RoPE rows: at
    N = 2845 DINOv3's own, the 40 x 71 patch grid of 640 x 1138 images at
    D = 64 behind 5 prefix tokens; at any other N random angles in (−3, 3)
    behind min(5, N) prefix rows. cos and sin are the (N, 32) f32 tables on
    the card, identity (1, 0) on the prefix rows."""
    import torch
    from tpu3dssf_torch.models import vit
    if N == 2845:
        cfg = vit.dinov3_small()
        angles = vit._rope_angles(*cfg.grid_size, 64, cfg.rope_theta)
        cos, sin = vit.rope_tables(cfg)
        return angles.cuda(), cfg.num_prefix_tokens, cos.cuda(), sin.cuda()
    n_prefix = min(5, N)
    angles = torch.rand(N - n_prefix, 32, generator=gen) * 6 - 3
    ones = torch.ones(n_prefix, 32)
    cos = torch.cat([ones, torch.cos(angles)])
    sin = torch.cat([ones * 0, torch.sin(angles)])
    return angles.cuda(), n_prefix, cos.cuda(), sin.cuda()


def check_flash_shape(gen, name, B, N, H, D, keys, route, tags, n, q_scale):
    """One case of the isolated attention checker (:func:`check_attention`)
    on one random bf16 (B, N, 3C) projection and its (B, N, H, D) views.

    ``keys``: "all" live, "trailing" (the last 5 keys masked) or "windows"
    (30% padding keys, an all-padding last window). ``route``: "packed"
    (K1 through ``flash_attention_packed``, q scaled by ``q_scale``, None:
    pre-scaled), "packed_rope" (K1's RoPE branch with the tables of
    :func:`rope_inputs`, also timed beside the route before the branch,
    ``time_attention.rope_outside``, and SDPA on the pre-rotated q and k),
    "packed_train" (the forward with LSE and
    the backward
    through the packed launchers: K2/K3, or K4/K5 at C < 128), "bhnd" (K8
    through ``flash_attention``, its forward with LSE, K9) or "window" (K6
    through ``window_attention``, K4, K5). ``tags``: the (forward, forward
    with LSE, backward) kernels of the case, None where it has none; K8's
    forward with LSE is its row's ``lse_forward``. ``n``: calls per path
    run. Outputs are held within KERNEL_TOL, the LSE within LSE_TOL on rows
    with a live key, gradients within 0.05 · max(1, max |plain|) (one limit
    over dqkv on the packed route) and to exactly 0 in an all-padding
    window; each output and gradient (dqkv, or dq, dk, dv together) also
    within REL_TOL of its max |plain| (:func:`rel_err`). Every row is
    timed beside its plain version, the library call computing the same
    function (SDPA; with a gradient pending for a forward with LSE; its
    autograd backward for a backward) and the bound of that call. Returns
    {tag: row}."""
    import torch
    import torch.nn.functional as F
    from tpu3dssf_torch.cli.time_attention import rope_outside
    from tpu3dssf_torch.utils import cuda_ms
    from tpu3dssf_torch.kernels.modules import flash_attention as fa
    from tpu3dssf_torch.kernels.modules import window_attention as wa

    C = H * D
    qkv = torch.randn(B, N, 3 * C, generator=gen).to("cuda", torch.bfloat16)
    q, k, v = qkv.unflatten(-1, (3, H, D)).unbind(2)
    keep = torch.ones(B, N, dtype=torch.bool)
    if keys == "trailing":
        keep[:, -5:] = N <= 5
    elif keys == "windows":
        keep = torch.rand(B, N, generator=gen) > 0.3
        keep[-1] = False
    keep = keep.to("cuda")
    bias = wa.key_bias(keep)
    scale = 1.0 if q_scale is None else q_scale
    packed = route.startswith("packed")
    # the window route zeroes masked query rows and their gradient, and the
    # packed training rule's callers their incoming gradient; K1 and K8
    # have no query mask
    qmask = (keep if route in ("window", "packed_train")
             else torch.ones_like(keep))[..., None, None]
    dout = torch.randn(B, N, H, D, generator=gen).to("cuda")
    dout = (dout * qmask).to(torch.bfloat16)
    count = {"packed": "launches_per_batch", "packed_rope":
             "launches_per_batch", "packed_train": "launches_per_step"}.get(
                 route, "calls_per_path")
    common = {"shape": name, "route": route, "B": B, "N": N, "C": C, "H": H,
              "D": D, count: n}
    rope = route == "packed_rope"
    if rope:   # SDPA takes q and k rotated beforehand (not timed)
        angles, n_prefix, cos, sin = rope_inputs(gen, N)
        _, (qt, kt, vt), mask = sdpa_views(fa.rope_rotate(q, cos, sin),
                                           fa.rope_rotate(k, cos, sin), v,
                                           bias)
        common["q_scale"] = q_scale
    else:
        _, (qt, kt, vt), mask = sdpa_views(q, k, v, bias)
    fwd_tag, lse_tag, bwd_tag = tags
    rows, checks = {}, {}

    def held(row, got):
        return (bool(torch.isfinite(got.float()).all())
                and row["max_abs_err"] < KERNEL_TOL
                and row["rel_err"] <= REL_TOL)

    if fwd_tag:
        if route == "packed":
            def run():
                return fa.flash_attention_packed(qkv, bias, H, q_scale)

            def plain():
                return fa.flash_attention_packed_reference(qkv, bias, H,
                                                           q_scale)
            got = run()
        elif rope:
            def run():
                return fa.flash_attention_packed(qkv, bias, H, q_scale, cos,
                                                 sin)

            def plain():
                return fa.flash_attention_packed_reference(qkv, bias, H,
                                                           q_scale, cos, sin)

            def outside():
                return rope_outside(fa, qkv, bias, H, angles, n_prefix,
                                    q_scale)
            got = run()
        else:
            def run():
                return fa._launch_flash(q, k, v, bias, scale)

            def plain():
                return mha_plain(q, k, v, bias)
            got = (fa.flash_attention(q, k, v, bias) if route == "bhnd"
                   else wa.window_attention(q, k, v, keep))
        torch.cuda.synchronize()
        want = (wa.window_attention_reference(q, k, v, keep)
                if route == "window" else plain())
        row = dict(common, max_abs_err=max_err(got, want),
                   rel_err=rel_err(got, want), max_abs_plain=peak(want),
                   ms=cuda_ms(run), plain_ms=cuda_ms(plain, reps=5, warmup=1),
                   library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, attn_mask=mask, scale=scale)))
        row["bound_ms"], row["bound_by"] = attention_bound(B, N, C, H, "fwd",
                                                           rope=rope)
        if rope:
            row["outside_route_ms"] = cuda_ms(outside)
            row["outside_route_max_abs_err"] = max_err(outside(), want)
        rows[fwd_tag] = row
        checks[fwd_tag] = held(row, got)
        del got, want

    if lse_tag:
        if packed:
            def run():
                return fa._launch_lse(qkv, bias, H, scale)

            def plain():
                return fa.flash_attention_packed_lse_reference(qkv, bias, H,
                                                               scale)
        else:
            def run():
                return fa._launch_flash(q, k, v, bias, scale, with_lse=True)

            def plain():
                return fa.flash_attention_lse_reference(q, k, v, bias, scale)
        out, lse = run()
        torch.cuda.synchronize()
        ref, ref_lse = plain()
        live = keep.any(-1)
        leaves, (ql, kl, vl), _ = sdpa_views(q, k, v, bias, grad=True)
        row = dict(common, max_abs_err=max_err(out, ref),
                   rel_err=rel_err(out, ref), max_abs_plain=peak(ref),
                   lse_err=(lse - ref_lse)[live].abs().max().item(),
                   ms=cuda_ms(run), plain_ms=cuda_ms(plain, reps=5, warmup=1),
                   library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                       ql, kl, vl, attn_mask=mask, scale=scale)))
        row["bound_ms"], row["bound_by"] = attention_bound(B, N, C, H, "lse")
        if lse_tag == fwd_tag:
            rows[fwd_tag]["lse_forward"] = row
        else:
            rows[lse_tag] = row
        checks["forward with LSE"] = held(row, out)
        checks["LSE"] = row["lse_err"] < LSE_TOL
        del leaves, ql, kl, vl, ref, ref_lse

    if bwd_tag:
        out = (out.unflatten(-1, (H, D)) if packed else out) * qmask.to(
            out.dtype)
        delta = fa.row_delta(dout, out)
        if packed:
            dflat = dout.flatten(2)

            def run():
                return fa._launch_bwd(qkv, bias, dflat, lse, delta, H, scale)

            def plain():
                return fa.flash_attention_packed_bwd_reference(
                    qkv, bias, dflat, lse, delta, H, scale)
            got, want = run(), plain()
            errs = [grad_error(got, want)]
            got, want = fa._split_heads(got, H), fa._split_heads(want, H)
        else:
            def run():
                return fa._launch_flash_bwd(q, k, v, bias, dout, lse, delta,
                                            scale)

            def plain():
                return bwd_plain(q, k, v, bias, dout, lse, delta, scale)
            got, want = run(), plain()
            errs = [grad_error(a, b) for a, b in zip(got, want)]
        torch.cuda.synchronize()
        padded = (max(g[-1].abs().max().item() for g in got)
                  if keys == "windows" else 0.0)
        row = dict(common, max_abs_err=max(e for e, _ in errs),
                   limit=min(lim for _, lim in errs),
                   rel_err=rel_err(got, want),
                   max_abs_plain=[peak(x) for x in want],
                   all_padding_max=padded, ms=cuda_ms(run),
                   plain_ms=cuda_ms(plain, reps=5, warmup=1),
                   library_ms=cuda_ms(flash_bwd_library(
                       q, k, v, bias, dout, lse, delta, scale)))
        row["bound_ms"], row["bound_by"] = attention_bound(B, N, C, H, "bwd")
        rows[bwd_tag] = row
        checks[bwd_tag] = (all(torch.isfinite(g.float()).all() for g in got)
                           and all(e < lim for e, lim in errs)
                           and row["rel_err"] <= REL_TOL)
        checks["all-padding window"] = padded == 0.0
        del got, want, delta
    for tag, row in rows.items():
        print(f"kernel {tag} " + json.dumps(row), flush=True)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"{name} ({route}): {bad} out of tolerance: "
                             f"{json.dumps(rows)}")
    return rows


def inference_cases(shapes):
    """Cases of :func:`check_flash_shape` for K1 at every inference shape
    (:func:`slice_attention_shapes`)."""
    return [(name, B, N, H, C // H, "windows" if masked else "all", "packed",
             ("K1", None, None), n, q_scale)
            for name, B, N, C, H, q_scale, masked, n in shapes]


def train_cases(shapes):
    """Cases for K2/K3 (C ≥ 128) and K4/K5 at every training shape
    (:func:`train_attention_shapes`) on the packed launchers."""
    return [(name, W, K, H, C // H, "windows", "packed_train", (None, kf, kb),
             n, (C // H) ** -0.5)
            for (kf, kb), name, W, K, C, H, n in shapes]


def flash_cases(window_shapes):
    """Cases at D = 64 beside the ViT-S one of :func:`inference_cases`: K8
    (with its LSE) and K9 at the ViT-L/16 encoder's shape (B = 12 images,
    N = 2845, H = 16) and at ragged N = 1, 77, 130 with the trailing keys
    masked, and K1 at those ragged N (ViT-S heads); then K6 and the window
    route's K4/K5 at every window-48 shape (``window_shapes``)."""
    cases = [("vitl", 12, 2845, 16, 64, "all", "bhnd", ("K8", "K8", "K9"),
              VITL_LAYERS, 0.125)]
    cases += [(f"ragged_n{n}", 2, n, 16, 64, "trailing", "bhnd",
               ("K8", "K8", "K9"), 0, 0.125) for n in (1, 77, 130)]
    cases += [(f"ragged_n{n}_packed", 2, n, 6, 64, "trailing", "packed",
               ("K1", None, None), 0, None) for n in (1, 77, 130)]
    cases += rope_cases()
    cases += [(name, W, K, H, C // H, "windows", "window", ("K6", "K4", "K5"),
               n, (C // H) ** -0.5)
              for name, W, K, C, H, _, _, n in window_shapes]
    return cases


def rope_cases():
    """K1's RoPE branch at q_scale 1/8: the ViT-S/16 (H = 6, 12 per fusion
    batch) and ViT-L/16 (H = 16, 24 per ViT-L batch) encoders' shape with
    DINOv3's own tables, and ragged N = 1, 77, 130 with random tables and
    the trailing keys masked."""
    cases = [(f"vit{size}_rope", 12, 2845, H, 64, "all", "packed_rope",
              ("K1", None, None), layers, 0.125)
             for size, H, layers in (("s", 6, 12), ("l", 16, VITL_LAYERS))]
    return cases + [(f"ragged_n{n}_rope", 2, n, 6, 64, "trailing",
                     "packed_rope", ("K1", None, None), 0, 0.125)
                    for n in (1, 77, 130)]


def check_attention(cases, seed):
    """The isolated attention checker (phases 3 and 13): every case of
    :func:`check_flash_shape` on seeded inputs; returns {(tag, route):
    [row, ...]}."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    rows = {}
    for case in cases:
        for tag, row in check_flash_shape(gen, *case).items():
            rows.setdefault((tag, case[6]), []).append(row)
        torch.cuda.empty_cache()
    return rows


def vitl_encoder(cfg, device):
    """The ViT-L encoder exactly as ``common.build_image_encoder`` builds it
    (seed 0, LayerScale folded), with the module kept: (vit, vit_cfg,
    encode)."""
    import dataclasses
    from tpu3dssf_torch.cli import common
    from tpu3dssf_torch.models.layers import init_weights
    from tpu3dssf_torch.models.vit import (VisionTransformer, dinov3_large,
                                           fold_layerscale)
    from tpu3dssf_torch.train.loop import make_image_encode_fn

    vit_cfg = dataclasses.replace(dinov3_large(),
                                  dtype=common.compute_dtype(cfg))
    vit = init_weights(VisionTransformer(vit_cfg), 0)
    vit = fold_layerscale(vit).to(device).eval()
    return vit, vit_cfg, make_image_encode_fn(vit, vit_cfg.image_size,
                                              vit_cfg.dtype)


def set_vit_route(vit, packed_head_groups):
    """Switch every block of ``vit`` between the packed (K1) and the
    (B, N, H, D) (K8) route; the weights stay."""
    import dataclasses
    cfg = dataclasses.replace(vit.config,
                              packed_head_groups=packed_head_groups)
    vit.config = cfg
    for blk in vit.blocks:
        blk.cfg = cfg


def first_batch(cfg, split, device):
    """The first ``split`` batch of ``cfg`` on ``device``: (batch, images on
    the device or None, valid points)."""
    import torch
    from tpu3dssf_torch.cli import common
    batches = iter(common.build_dataloaders(cfg)[split])
    host = next(batches)
    batches.close()  # stop the prefetch thread: it would share the host
    points = int(host["point_valid"].sum())
    images = host.pop("images", None)
    if images is not None and cfg.image_encoder != "none":
        images = torch.as_tensor(images).to(device)
    else:
        images = None
    return common.batch_to_device(host, device), images, points


def run_vitl_frame(card, tmp):
    """Phase 17: ``main_infer`` over the fusion config with the ViT-L/16
    encoder (its 6 test batches of 2 scenes, 12 images at 640 x 1138), with
    exactly 46 K1 launches per batch (24 ViT layers + 22 PTv3 blocks) and no
    other kernel; then one batch timed end to end with its peak memory, and
    K1 inside it (device time from the profiler; its error and the plain
    version's time on its own inputs). Returns (K1 launches, frame record,
    (vit, vit_cfg, encode, images))."""
    import numpy as np
    import torch
    from tpu3dssf_torch.cli import common, main_infer
    from tpu3dssf_torch.train.loop import make_eval_step
    from tpu3dssf_torch.utils import cuda_ms

    path, _ = config_copy(CONFIG, tmp, "vitl.yaml",
                          train=dict(image_encoder="dinov3_large"))
    cfg = common.load_config(path)
    n = len(common.build_dataloaders(cfg)["test"])
    reset_counters()
    t0 = time.perf_counter()
    metrics = main_infer.main(["--config", path, "--split", "test"])
    seconds = time.perf_counter() - t0
    launches = counters()
    want = {k: VITL_LAUNCHES * n if k == "K1" else 0 for k in launches}
    bad = {k: v for k, v in metrics.items() if not np.isfinite(v).all()}
    print(f"ViT-L main_infer: {n} batches in {seconds:.1f} s, launches "
          f"{launches} (expected {want})")
    if launches != want or bad:
        raise AssertionError(f"ViT-L main_infer: launches {launches} "
                             f"(expected {want}), non-finite {bad}")

    device = torch.device("cuda")
    vit, vit_cfg, encode = vitl_encoder(cfg, device)
    model, _ = common.build_pipeline(cfg, vit_cfg, device)
    step = make_eval_step(common.build_loss(cfg), cfg.mlp_class)
    batch, images, points = first_batch(cfg, "test", device)

    def frame():
        return step(model, batch, encode(images))

    torch.cuda.reset_peak_memory_stats()
    frame_ms = cuda_ms(frame, reps=10, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    print(f"ViT-L frame ({batch['points'].shape[0]} scenes, "
          f"{images.shape[0] * images.shape[1]} images, {points:,} valid "
          f"points): {frame_ms:.3f} ms -> {points / frame_ms * 1e3:,.0f} "
          f"points/s; peak allocated {peak / 2**30:.3f} GiB [{card}]")
    inside, total = time_kernels_in_path(frame, {"K1": k1_spec(
        VITL_LAUNCHES, rope=VITL_LAYERS)})
    del model
    torch.cuda.empty_cache()
    return launches["K1"], dict(
        frame_ms=frame_ms, points=points, points_per_s=points / frame_ms * 1e3,
        peak_bytes=peak, batches=n, main_infer_s=seconds,
        device_kernel_ms=total, k1=inside["K1"]), (
        vit, vit_cfg, encode, images)


def run_vitl_k8(vit, encode, images):
    """Phase 18: the same encoder, weights and images on the (B, N, H, D)
    route (``packed_head_groups=False``): exactly 24 K8 launches and no K1
    in the encode, its patch tokens against the K1 route's (max abs error
    over max |token| < VITL_ROUTE_TOL), and K8 inside the encode (device
    time from the profiler; on its own inputs the plain version's time, its
    error, SDPA's time and the bound). Returns (launches, row, route
    agreement)."""
    import torch
    from tpu3dssf_torch.kernels.modules import flash_attention as fa

    set_vit_route(vit, True)
    reset_counters()
    packed = encode(images)
    k1 = counters()
    set_vit_route(vit, False)
    reset_counters()
    tokens = encode(images)
    torch.cuda.synchronize()
    launches = counters()
    want = {k: VITL_LAYERS if k == "K8" else 0 for k in launches}
    err = (tokens.float() - packed.float()).abs().max().item()
    scale = packed.float().abs().max().item()
    agree = dict(max_abs_err=err, max_abs_token=scale, rel_err=err / scale)
    print(f"ViT-L on the K8 route: launches {launches} (K1 route: {k1}); "
          f"tokens vs the K1 route {json.dumps(agree)}")
    if (launches != want or k1["K1"] != VITL_LAYERS
            or not torch.isfinite(tokens.float()).all()
            or not err / scale < VITL_ROUTE_TOL):
        raise AssertionError(f"ViT-L K8 route: launches {launches}, tokens "
                             f"{agree}")
    del packed, tokens
    inside, _ = time_kernels_in_path(lambda: encode(images), {"K8": dict(
        pattern="fap_fwd_kernel", module=fa, attr="_launch_flash",
        plain=mha_plain, error=max_err, ok=lambda e: e < KERNEL_TOL,
        relative=True, launches=VITL_LAYERS, library=flash_library,
        bound=flash_bound("fwd"))})
    return launches["K8"], inside["K8"], agree


def vitl_gradient(vit, vit_cfg, images, packed):
    """The gradient, with respect to every ViT-L parameter, of a fixed
    random projection of its patch tokens for one sample of 6 images at full
    width, on the K1 route (``packed``: K1's RoPE branch with its LSE
    forward, K9) or the K8 route (K8 with LSE, K9): exactly 24 launches of
    each of the two kernels and no other; the card's kernels against the
    plain versions on the card (the forward and backward launchers swapped
    for them), per-parameter cosine ≥ GRAD_COSINE. Returns (launches,
    cosine summary, grads), ``grads`` the function that takes the
    gradient."""
    import torch
    import torch.nn.functional as F
    from tpu3dssf_torch.models.vit import preprocess_images
    from tpu3dssf_torch.kernels.modules import flash_attention as fa

    set_vit_route(vit, packed)
    with torch.no_grad():
        x = preprocess_images(images[:1], vit_cfg.image_size,
                              dtype=vit_cfg.dtype).flatten(0, 1)
    names, params = zip(*vit.named_parameters())
    gen = torch.Generator().manual_seed(3)
    proj = torch.randn((x.shape[0], vit_cfg.num_patches,
                        vit_cfg.hidden_size), generator=gen).to("cuda")

    def grads():
        with torch.enable_grad():
            tokens = vit(x)["patch_features"]
            return torch.autograd.grad((tokens.float() * proj).sum(), params)

    route = "K1" if packed else "K8"
    reset_counters()
    got = grads()
    torch.cuda.synchronize()
    launches = counters()
    want = {k: VITL_LAYERS if k in (route, "K9") else 0 for k in launches}

    def plain_fwd(q, k, v, bias, scale, with_lse=False, name=None):
        out, lse = fa.flash_attention_lse_reference(q, k, v, bias, scale)
        return (out, lse) if with_lse else out

    def plain_lse(qkv, bias, heads, q_scale, cos=None, sin=None):
        return fa.flash_attention_packed_lse_reference(qkv, bias, heads,
                                                       q_scale, cos, sin)

    def plain_bwd(q, k, v, bias, dout, lse, delta, scale, out=None,
                  name=None):
        return bwd_plain(q, k, v, bias, dout, lse, delta, scale)

    forward = "_launch_lse" if packed else "_launch_flash"
    kernels = getattr(fa, forward), fa._launch_flash_bwd
    setattr(fa, forward, plain_lse if packed else plain_fwd)
    fa._launch_flash_bwd = plain_bwd
    try:
        ref = grads()
        torch.cuda.synchronize()
    finally:
        setattr(fa, forward, kernels[0])
        fa._launch_flash_bwd = kernels[1]
    cos = {n: F.cosine_similarity(a.flatten().double(), b.flatten().double(),
                                  dim=0, eps=1e-30).item()
           for n, a, b in zip(names, got, ref)}
    low = min(cos, key=cos.get)
    whole = F.cosine_similarity(torch.cat([a.flatten() for a in got]),
                                torch.cat([b.flatten() for b in ref]),
                                dim=0).item()
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    summary = dict(min_cosine=cos[low], min_cosine_param=low,
                   whole_cosine=whole, params=len(cos))
    print(f"ViT-L gradient on the {route}/K9 route: launches {launches} "
          f"(expected {want}); card kernels vs plain versions on the card "
          f"{json.dumps(summary)}")
    if launches != want or not finite or cos[low] < GRAD_COSINE:
        raise AssertionError(f"ViT-L gradient ({route} route): launches "
                             f"{launches}, finite {finite}, {summary}")
    del got, ref
    torch.cuda.empty_cache()
    return launches, summary, grads


def run_vitl_grad(vit, vit_cfg, images):
    """Phase 19: :func:`vitl_gradient` on the K8 route (24 K8 + 24 K9),
    then K9 inside the backward (device time, and on each call's own inputs
    the plain version's error and time, SDPA's backward and the bound).
    Returns (launches, K9 row, cosines)."""
    from tpu3dssf_torch.kernels.modules import flash_attention as fa

    launches, summary, grads = vitl_gradient(vit, vit_cfg, images, False)
    inside, _ = time_kernels_in_path(grads, {"K9": dict(
        pattern="fap_bwd_", device_kernels=2 * VITL_LAYERS, module=fa,
        attr="_launch_flash_bwd", plain=bwd_plain, error=grads_err,
        ok=lambda e: e < float("inf"), relative=True, launches=VITL_LAYERS,
        library=flash_bwd_library, bound=flash_bound("bwd"))})
    set_vit_route(vit, True)
    return launches, inside["K9"], summary


def run_window_path(card, tmp):
    """Phase 20: the LiDAR-only config at window 48 (voxel capacity 726 x
    48) through ``main_infer``'s own entry point: exactly 22 K6 launches per
    batch and no other kernel, finite metrics; one batch timed end to end
    with K6 inside it as K8 in 18; one train step (``make_train_step``):
    exactly 22 K4 and 22 K5 launches, a finite loss. Returns (K6 launches,
    K6 row, batch record, step launches)."""
    import numpy as np
    import torch
    from tpu3dssf_torch.cli import common, main_infer
    from tpu3dssf_torch.train.loop import make_eval_step, make_train_step
    from tpu3dssf_torch.utils import cuda_ms
    from tpu3dssf_torch.kernels.modules import flash_attention as fa

    path, _ = config_copy(LIDAR_CONFIG, tmp, "window48.yaml", tpu=dict(
        window_size=WINDOW, voxel_capacity=WINDOW_CAPACITY))
    cfg = common.load_config(path)
    n = len(common.build_dataloaders(cfg)["test"])
    reset_counters()
    t0 = time.perf_counter()
    metrics = main_infer.main(["--config", path, "--split", "test"])
    seconds = time.perf_counter() - t0
    launches = counters()
    want = {k: WINDOW_LAUNCHES * n if k == "K6" else 0 for k in launches}
    bad = {k: v for k, v in metrics.items() if not np.isfinite(v).all()}
    print(f"window-48 main_infer: {n} batches in {seconds:.1f} s, launches "
          f"{launches} (expected {want}), overall acc "
          f"{float(metrics['overall_acc']):.4f}")
    if launches != want or bad:
        raise AssertionError(f"window-48 main_infer: launches {launches} "
                             f"(expected {want}), non-finite {bad}")

    device = torch.device("cuda")
    model, _ = common.build_pipeline(cfg, None, device)
    step = make_eval_step(common.build_loss(cfg), cfg.mlp_class)
    batch, _, points = first_batch(cfg, "test", device)
    tokens = common.zero_tokens(cfg, None, batch["points"].shape[0], device)

    def frame():
        return step(model, batch, tokens)

    torch.cuda.reset_peak_memory_stats()
    frame_ms = cuda_ms(frame, reps=10, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    print(f"window-48 batch ({batch['points'].shape[0]} scenes, {points:,} "
          f"valid points): {frame_ms:.3f} ms -> "
          f"{points / frame_ms * 1e3:,.0f} points/s; peak allocated "
          f"{peak / 2**30:.3f} GiB [{card}]")
    inside, total = time_kernels_in_path(frame, {"K6": dict(
        pattern="fap_fwd_kernel", module=fa, attr="_launch_flash",
        plain=mha_plain, error=max_err, ok=lambda e: e < KERNEL_TOL,
        relative=True, launches=WINDOW_LAUNCHES, library=flash_library,
        bound=flash_bound("fwd"))})

    state = common.init_state(cfg, model, steps_per_epoch=1)
    train_step = make_train_step(common.build_loss(cfg))
    batch, _, _ = first_batch(cfg, "train", device)
    tokens = common.zero_tokens(cfg, None, batch["points"].shape[0], device)
    reset_counters()
    loss = float(train_step(state, batch, tokens)["loss"])
    torch.cuda.synchronize()
    step_launches = counters()
    want = {k: WINDOW_LAUNCHES if k in ("K4", "K5") else 0
            for k in step_launches}
    print(f"window-48 train step: loss {loss:.4f}, launches {step_launches} "
          f"(expected {want})")
    if step_launches != want or not np.isfinite(loss):
        raise AssertionError(f"window-48 train step: loss {loss}, launches "
                             f"{step_launches} (expected {want})")
    return launches["K6"], inside["K6"], dict(
        frame_ms=frame_ms, points=points, points_per_s=points / frame_ms * 1e3,
        peak_bytes=peak, device_kernel_ms=total, batches=n,
        main_infer_s=seconds, train_step_loss=loss), step_launches


def per_path(rows, key, count):
    """Σ over a kernel's shapes of (calls per batch or step × per call)."""
    return sum(r[count] * r[key] for r in rows)


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
    from tpu3dssf_torch.kernels import _build

    global EXP_RATE
    card = card_line()
    print(card)
    clock = sm_clock_mhz()
    EXP_RATE = exp_rate(clock)
    print(f"SM clock max {clock:g} MHz (nvidia-smi clocks.max.sm): exp bound "
          f"at 16 per clock per SM x {H100_SMS} SMs = {EXP_RATE:.4g}/s")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"{torch.cuda.device_count()} device(s)")

    # phases 2, 6 and 12: every source at once, one nvcc each
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        list(pool.map(_build.load_library, SOURCES))
    print(f"build: {len(SOURCES)} sources in {time.perf_counter() - t0:.2f} "
          "s wall, one nvcc each, all started together")
    for source in SOURCES:
        print_build(source, _build.BUILD_INFO[source])
    for source, fn in (
            ("flash_attention_packed.cu", "fa_forward_d64_smem_bytes"),
            ("flash_attention_packed_bwd.cu", "fa_backward_d64_smem_bytes")):
        print(f"  {source}: the D = 64 kernel takes "
              f"{getattr(_build.load_library(source), fn)()} bytes of "
              "dynamic shared memory")

    # phase 3: the isolated attention checker (K1 at the fusion config's
    # inference shapes, D = 64 beside them, K2-K5 at its training shapes,
    # K6/K4/K5 at the window-48 shapes)
    cfg = load_config(CONFIG)
    tmp = tempfile.mkdtemp(prefix="tpu3dssf_smoke_")
    try:
        window_cfg = load_config(config_copy(
            LIDAR_CONFIG, tmp, "w48.yaml", tpu=dict(
                window_size=WINDOW, voxel_capacity=WINDOW_CAPACITY))[0])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    iso = check_attention(
        inference_cases(slice_attention_shapes(cfg))
        + flash_cases(slice_attention_shapes(window_cfg))
        + train_cases(train_attention_shapes(cfg)), seed=0)
    rows = iso[("K1", "packed")]
    rope_rows = {r["shape"]: r for r in iso[("K1", "packed_rope")]}
    train_rows = {k: iso[(k, "packed_train")] for k in ("K2", "K3", "K4",
                                                         "K5")}
    flash_rows = {k: iso[(k, route)] for k, route in (
        ("K4", "window"), ("K5", "window"), ("K6", "window"), ("K8", "bhnd"),
        ("K9", "bhnd"))}
    launches, k1, frame = run_slice(card)
    check_small_model()

    tmp = tempfile.mkdtemp(prefix="tpu3dssf_smoke_")
    try:
        train_launches, steps = run_training(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    inside, step = time_train_step(card)
    overfit_one_batch()
    check_small_model_grad()

    parity_rows = check_attention(inference_cases(slice_attention_shapes(
        load_config(PARITY_CONFIG))), seed=13)[("K1", "packed")]
    knn_rows = check_knn(card)
    tmp = tempfile.mkdtemp(prefix="tpu3dssf_smoke_")
    try:
        parity = run_parity_clis(tmp)
        in_parity, parity_frame = time_parity_batch(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    tmp = tempfile.mkdtemp(prefix="tpu3dssf_smoke_")
    try:
        vitl_k1, vitl_frame, (vit, vit_cfg, encode, images) = \
            run_vitl_frame(card, tmp)
        k8_launches, k8, route = run_vitl_k8(vit, encode, images)
        grad_launches, k9, grad = run_vitl_grad(vit, vit_cfg, images)
        # phase 21: the same gradient on the K1 route (24 K1 + 24 K9)
        # (its gradient function is dropped: it holds the encoder)
        k1_grad_launches, k1_grad = vitl_gradient(vit, vit_cfg, images,
                                                  True)[:2]
        del vit, encode, images
        torch.cuda.empty_cache()
        k6_launches, k6, window_frame, step_launches = run_window_path(card,
                                                                       tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    records = [{
        "name": KERNELS["K1"][0], "route": "cuda",
        "source": "tpu3dssf_torch/csrc/" + KERNELS["K1"][1],
        "replaces": KERNELS["K1"][2],
        "launches": launches,
        "max_abs_err": max([k1["max_abs_err"], in_parity["K1"]["max_abs_err"],
                            vitl_frame["k1"]["max_abs_err"]]
                           + [r["max_abs_err"] for r in rows + parity_rows
                              + list(rope_rows.values())]),
        # per batch of the inference path, on that batch's own inputs;
        # bound and library call summed over its 34 calls
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": per_path(rows, "bound_ms", "launches_per_batch"),
        "bound_by": record_bound_by(bound_term(rows)),
        "bound_term": bound_term(rows),
        "library_ms": per_path(rows, "library_ms", "launches_per_batch"),
        "library": "scaled_dot_product_attention",
        "per": "inference batch", "train_launches": train_launches["K1"],
        "parity_launches": parity["main_infer"][0]["K1"],
        "vitl_launches": vitl_k1,
        # per ViT-L fusion batch (phase 17), on that batch's own inputs
        "vitl": dict(ms=vitl_frame["k1"]["ms"],
                     plain_ms=vitl_frame["k1"]["plain_ms"]),
        # the RoPE branch (tpu3dssf/kernels/flash_attention.py:251-278), per
        # call at the ViT-S and ViT-L shapes (phase 3, q_scale 1/8, DINOv3's
        # tables): beside its bound, its plain version, the route before
        # the branch (rotation outside, torch.cat, K1) and SDPA on q and k
        # rotated beforehand
        "rope": {
            "replaces": "tpu3dssf/kernels/flash_attention.py:251",
            "gradient_launches": k1_grad_launches["K1"],
            **{f"vit{size}": {key: rope_rows[f"vit{size}_rope"][key]
                              for key in (
                "ms", "bound_ms", "bound_by", "plain_ms", "outside_route_ms",
                "library_ms", "max_abs_err", "rel_err")}
               for size in ("s", "l")}},
        # per parity batch, likewise
        "parity": dict(
            ms=in_parity["K1"]["ms"], plain_ms=in_parity["K1"]["plain_ms"],
            bound_ms=per_path(parity_rows, "bound_ms", "launches_per_batch"),
            library_ms=per_path(parity_rows, "library_ms",
                                "launches_per_batch")),
    }]
    for k in ("K2", "K3", "K4", "K5"):
        name, source, replaces = KERNELS[k]
        record = {
            "name": name, "route": "cuda",
            "source": "tpu3dssf_torch/csrc/" + source, "replaces": replaces,
            "launches": train_launches[k],
            "max_abs_err": max([inside[k]["max_abs_err"]]
                               + [r["max_abs_err"] for r in train_rows[k]]
                               + [r["max_abs_err"] for r in
                                  flash_rows.get(k, [])]),
            # per train step, on that step's own inputs; bound and library
            # call summed over the step's calls at the isolated shapes
            "ms": inside[k]["ms"], "plain_ms": inside[k]["plain_ms"],
            "bound_ms": per_path(train_rows[k], "bound_ms",
                                 "launches_per_step"),
            "bound_by": record_bound_by(bound_term(train_rows[k])),
            "bound_term": bound_term(train_rows[k]),
            "library_ms": per_path(train_rows[k], "library_ms",
                                   "launches_per_step"),
            "library": ("scaled_dot_product_attention"
                        + (" backward" if k in ("K3", "K5") else
                           " (gradient pending)")),
            "per": f"train step ({steps} steps in the run)",
        }
        if k in ("K4", "K5"):
            # the (W, K, H, D) route: launches per window-48 train step, and
            # the isolated calls (phase 3) summed over that step's calls
            record["window_route"] = dict(
                launches=step_launches[k],
                **{key: per_path(flash_rows[k], key, "calls_per_path")
                   for key in ("ms", "plain_ms", "bound_ms", "library_ms")})
        records.append(record)
    name, source, replaces = KERNELS["K7"]
    k7 = in_parity["K7"]
    records.append({
        "name": name, "route": "cuda",
        "source": "tpu3dssf_torch/csrc/" + source, "replaces": replaces,
        "launches": parity["main_infer"][0]["K7"],
        "max_abs_err": max([k7["max_abs_err"]]
                           + [r["max_abs_err"] for r in knn_rows]),
        # per parity batch (a knn5 and a nearest call), on that batch's own
        # inputs
        "ms": k7["ms"], "plain_ms": k7["plain_ms"],
        "bound_ms": k7["bound_ms"], "bound_by": record_bound_by(
            k7["bound_by"]), "bound_term": k7["bound_by"],
        "library_ms": k7["library_ms"], "library": "cdist + topk",
        "cdist_topk_ms": k7["library_ms"], "per": "parity batch",
        "parity_launches": {n: (c["K7"], b) for n, (c, b) in parity.items()},
    })
    for k, launches_k, row, library, per in (
            ("K6", k6_launches, k6, "scaled_dot_product_attention",
             "window-48 LiDAR batch"),
            ("K8", k8_launches, k8, "scaled_dot_product_attention",
             "ViT-L encode (12 images)"),
            ("K9", grad_launches["K9"], k9,
             "scaled_dot_product_attention backward",
             "ViT-L backward (6 images)")):
        name, source, replaces = KERNELS[k]
        # per path run, on that run's own inputs; bound and library call
        # summed over the run's calls
        records.append({
            "name": name, "route": "cuda",
            "source": "tpu3dssf_torch/csrc/" + source, "replaces": replaces,
            "launches": launches_k,
            "max_abs_err": max([row["max_abs_err"]]
                               + [r["max_abs_err"] for r in flash_rows[k]]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": record_bound_by(row["bound_by"]),
            "bound_term": row["bound_by"], "library_ms": row["library_ms"],
            "library": library, "per": per,
        })
    records.sort(key=lambda r: next(k for k, v in KERNELS.items()
                                    if v[2] == r["replaces"]))
    print("slice " + json.dumps(dict(frame, card=card)))
    print("vitl_frame " + json.dumps(dict(
        vitl_frame, card=card, k8_route=route, gradient=grad,
        k1_route_gradient=dict(k1_grad, launches=k1_grad_launches))))
    print("window48_batch " + json.dumps(dict(window_frame, card=card)))
    print("train_step " + json.dumps(dict(step, card=card)))
    print("parity_batch " + json.dumps(dict(parity_frame, card=card)))
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
