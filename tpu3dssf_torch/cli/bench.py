"""The reference's fused inference frame on one card: the port of the root
``bench.py``.

    python -m tpu3dssf_torch.cli.bench [--batch N] [--backbone vits|vitl]
                                       [--int8] [--device cuda|cpu]

The frame is ``bench.py``'s ``fused_infer``: a uint8 batch of six (900,
1600) camera images per sample from ``SyntheticNuScenes``, preprocessed to
(640, 1138) and encoded by DINOv3 ViT-S/16 with LayerScale folded (ViT-L/16
with ``--backbone vitl``, BASELINE config 5), then ``SegmentationPipeline``
(voxel size 0.1, capacity 25,600, PTv3 at window 1024 in all 9 stages,
the fusion head, devoxelize) on 34,816 points per sample, at batch 1
(``--batch`` replaces ``BENCH_BATCH``). Encode and pipeline run as one
step, captured as one CUDA graph (:func:`tpu3dssf_torch.train.graph.
graphed`), as JAX jits them as one program; weights are seeded random.
``--int8`` quantizes the ViT to W8A8 (:func:`tpu3dssf_torch.models.vit.
quantize_vit`) on the card only, as ``bench.py`` does on the TPU only.

Timing: the CUDA-event median of 20 graphed replays after warm-up
(the port's ``time_device``). Earlier lines (stderr) give the profiler's
device time of a frame, its kernels by device time, the wall/device ratio
and the card's name and power limit; the last line of stdout is
``bench.py``'s JSON: ``metric`` (``fused_points_per_sec_per_chip``,
``..._vitl`` with ViT-L), ``value`` (points/s per card), ``unit``,
``vs_baseline`` (against the reference's
estimated 100,000 points/s, ``bench.py``'s docstring) and ``peak_hbm_mb``
(``torch.cuda.max_memory_allocated``) with ``peak_hbm_source:
"runtime"``. ``--device cpu`` runs the plain versions on the CPU (tiny
sizes only: the functions below take the sizes and configs as
arguments) and times with the host clock; without it the frame needs a
card. Not ported: ``BENCH_SQUEEZE`` (``hbm_squeeze``, a TPU runtime
workaround) and the ViT-L looped encode (a TPU compiler workaround).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

BASELINE_POINTS_PER_SEC = 100_000.0
POINT_CAP = 34816       # about one nuScenes sweep, a multiple of 1024
VOXEL_CAP = 25600       # about 34k points at 0.1 m voxels, a window multiple
WINDOW = 1024
REPS = 20               # graphed replays timed
RAW_HW = (900, 1600)    # the nuScenes camera images


def log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def frame_configs(backbone="vits", dtype=torch.bfloat16,
                  voxel_capacity=VOXEL_CAP, vit_cfg=None, ptv3_cfg=None):
    """(ViTConfig, PipelineConfig) of ``bench.py``'s frame: DINOv3 ViT-S/16
    (ViT-L/16 for ``backbone="vitl"``) or the given ``vit_cfg``; PTv3 at
    window 1024 in every stage (or the given ``ptv3_cfg``, windows as they
    are); everything in ``dtype``."""
    import dataclasses

    from tpu3dssf_torch.models.fusion import FusionConfig, PipelineConfig
    from tpu3dssf_torch.models.ptv3 import PTv3Config
    from tpu3dssf_torch.models.vit import dinov3_large, dinov3_small

    if vit_cfg is None:
        vit_cfg = {"vits": dinov3_small, "vitl": dinov3_large}[backbone]()
    vit_cfg = dataclasses.replace(vit_cfg, dtype=dtype)
    if ptv3_cfg is None:
        ptv3_cfg = PTv3Config(enc_window=(WINDOW,) * 5,
                              dec_window=(WINDOW,) * 4)
    pipe_cfg = PipelineConfig(
        fusion=FusionConfig(point_feat_dim=ptv3_cfg.out_channels,
                            patch_tok_dim=vit_cfg.hidden_size,
                            patch_size=vit_cfg.patch_size,
                            encoder_size=vit_cfg.image_size, dtype=dtype),
        ptv3=dataclasses.replace(ptv3_cfg, dtype=dtype),
        voxel_size=0.1, voxel_capacity=voxel_capacity)
    return vit_cfg, pipe_cfg


def build_models(vit_cfg, pipe_cfg, device, int8=False, seed=0):
    """The frame's frozen ViT (LayerScale folded, or W8A8 with ``int8``)
    and pipeline at the seeded init, on ``device``, in eval mode."""
    from tpu3dssf_torch.models.fusion import SegmentationPipeline
    from tpu3dssf_torch.models.layers import init_weights
    from tpu3dssf_torch.models.vit import (VisionTransformer,
                                           fold_layerscale, quantize_vit)

    vit = init_weights(VisionTransformer(vit_cfg), seed).to(device)
    vit = quantize_vit(vit) if int8 else fold_layerscale(vit)
    model = init_weights(SegmentationPipeline(pipe_cfg), seed)
    return vit.eval(), model.to(device).eval()


def frame_inputs(batch=1, num_points=POINT_CAP, image_hw=RAW_HW,
                 device="cpu"):
    """``bench.py``'s inputs: ``batch`` synthetic sweeps (``SyntheticNuScenes``
    at its default seed), every point valid: a dict of images (uint8),
    points, point_valid, cam_intrinsics, lidar2cam on ``device``."""
    from tpu3dssf_torch.data import SyntheticNuScenes

    ds = SyntheticNuScenes(num_samples=batch, num_points=num_points,
                           image_hw=image_hw)
    samples = [ds[i] for i in range(batch)]

    def stacked(key, dtype=None):
        x = torch.from_numpy(np.stack([s[key] for s in samples]))
        return (x if dtype is None else x.to(dtype)).to(device)

    return {"images": stacked("images"),
            "points": stacked("points", torch.float32),
            "point_valid": torch.ones((batch, num_points), dtype=torch.bool,
                                      device=device),
            "cam_intrinsics": stacked("cam_intrinsics"),
            "lidar2cam": stacked("lidar2cam")}


def make_fused_infer(vit, model):
    """``bench.py``'s ``fused_infer``: images → ViT patch tokens →
    pipeline logits, one eager step (``graphed`` captures it whole)."""
    from tpu3dssf_torch.train.loop import make_image_encode_fn

    cfg = vit.config
    encode = make_image_encode_fn(vit, cfg.image_size, cfg.dtype)

    @torch.inference_mode()
    def fused_infer(images, points, point_valid, cam_intrinsics, lidar2cam):
        tokens = encode(images)
        return model(points, point_valid, tokens, cam_intrinsics, lidar2cam)

    return fused_infer


def wall_ms(fn, device, reps, warmup=2):
    """Median ms of ``reps`` calls of ``fn`` after ``warmup``: CUDA events
    on a card, the host clock on the CPU."""
    from tpu3dssf_torch.utils import cuda_ms
    if device.type == "cuda":
        return cuda_ms(fn, reps=reps, warmup=warmup)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_ms(fn, top=8):
    """The profiler's device time of one call of ``fn``: (ms, CUDA kernels
    per call, the ``top`` kernels by device time as [name, ms, launches]
    per call)."""
    from tpu3dssf_torch.utils import profile_kernels
    _, kernels, _ = profile_kernels(fn, reps=3)
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]
    return (sum(us for us, _ in kernels.values()) / 1e3,
            sum(n for _, n in kernels.values()),
            [[name[:120], us / 1e3, n] for name, (us, n) in ranked])


def record(metric, points_per_sec, peak_mb):
    """``bench.py``'s JSON record."""
    return {
        "metric": metric,
        "value": round(points_per_sec, 1),
        "unit": "points/s",
        "vs_baseline": round(points_per_sec / BASELINE_POINTS_PER_SEC, 3),
        "peak_hbm_mb": round(peak_mb, 1),
        "peak_hbm_source": "runtime",
    }


def run(vit, model, inputs, metric="fused_points_per_sec_per_chip",
        reps=REPS):
    """Time the graphed frame on ``inputs``: returns (the JSON record, a
    dict of what the earlier lines print: ms, device ms, kernels, the
    first call's seconds, the logits of the last call)."""
    from tpu3dssf_torch.train.graph import graphed
    from tpu3dssf_torch.utils import peak_hbm_mb

    device = inputs["points"].device
    fused = graphed(make_fused_infer(vit, model), "fused_infer")
    args = tuple(inputs[k] for k in ("images", "points", "point_valid",
                                     "cam_intrinsics", "lidar2cam"))
    t0 = time.perf_counter()
    logits = fused(*args)          # on the card: the eager call + capture
    if device.type == "cuda":
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    ms = wall_ms(lambda: fused(*args), device, reps)
    points = int(inputs["point_valid"].sum())
    info = dict(ms=ms, first_call_s=first_s, points=points,
                batch=int(inputs["points"].shape[0]))
    if device.type == "cuda":
        (info["device_ms"], info["kernels"],
         info["top_kernels"]) = device_ms(lambda: fused(*args))
        info["wall_over_device"] = ms / info["device_ms"]
    info["logits"] = fused(*args)
    return record(metric, points / (ms / 1e3), peak_hbm_mb(device)), info


def main(argv=None):
    from tpu3dssf_torch.cli.common import card_line, resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1,
                    help="samples per frame (bench.py's BENCH_BATCH)")
    ap.add_argument("--backbone", choices=("vits", "vitl"), default="vits",
                    help="DINOv3 ViT-S/16 or ViT-L/16 (BENCH_BACKBONE)")
    ap.add_argument("--int8", action="store_true",
                    help="W8A8 ViT on the card (BENCH_INT8=1)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    dtype = torch.bfloat16 if on_card else torch.float32
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        log(card_line())
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    log(f"device={device} ({name}), dtype={str(dtype).split('.')[-1]}, batch "
        f"{args.batch}, backbone {args.backbone}, int8 "
        f"{args.int8 and on_card}")
    vit_cfg, pipe_cfg = frame_configs(args.backbone, dtype)
    t0 = time.perf_counter()
    vit, model = build_models(vit_cfg, pipe_cfg, device,
                              int8=args.int8 and on_card)
    log(f"init {time.perf_counter() - t0:.1f}s")
    inputs = frame_inputs(args.batch, device=device)
    metric = "fused_points_per_sec_per_chip" + (
        "_vitl" if args.backbone == "vitl" else "")
    result, info = run(vit, model, inputs, metric)
    log(f"first call (eager + capture) {info['first_call_s']:.1f}s")
    log(f"e2e {info['ms']:.3f} ms/batch-of-{args.batch} "
        f"({result['value']:,.0f} points/s), median of {REPS} "
        f"{'graphed replays (CUDA events)' if on_card else 'calls (host)'}")
    if "device_ms" in info:
        log(f"device time {info['device_ms']:.3f} ms in "
            f"{info['kernels']:g} kernels per frame (profiler); "
            f"wall/device {info['wall_over_device']:.4f}")
        for name, kms, n in info["top_kernels"]:
            log(f"  {kms:8.3f} ms in {n:5g} x {name}")
    if not torch.isfinite(info["logits"].float()).all():
        raise RuntimeError("the frame gave non-finite logits")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
