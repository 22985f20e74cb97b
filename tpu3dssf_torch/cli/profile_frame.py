"""Where one batch of the main path spends its time, on one GPU.

    python -m tpu3dssf_torch.cli.profile_frame [--config <yaml>]
        [--split test] [--trace FILE]

Builds what ``main_infer`` builds (same config, same seeded weights), takes
the first batch of the split and prints, beside the card's name and power
limit:

- ``segments_ms``: CUDA-event medians (10 after 3 warm-ups) of each stage
  of the batch (encode = preprocess + ViT, voxelize, ptv3, fusion head,
  devoxelize, loss) and their sum; ``preprocess_ms`` is the part of
  encode that resizes and normalises the images;
- ``batch_ms``: the eval step on the batch (encode + pipeline + loss) with
  the loader's prefetch thread closed, then live, then closed again;
- a ``torch.profiler`` table over 3 batches; the device kernel time and
  the kernel count per batch; the device time and launches of the
  attention kernels (``fap_fwd_d16_*`` at PTv3, ``fap_fwd_kernel_d64`` and
  its RoPE pre-kernel at the ViT) per batch.

``--trace`` writes the profiler's Chrome trace there.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess

import torch

from tpu3dssf_torch.cli import common
from tpu3dssf_torch.models.vit import preprocess_images
from tpu3dssf_torch.train.loop import make_eval_step
from tpu3dssf_torch.utils import cuda_ms, profile_kernels
from tpu3dssf_torch.voxel import devoxelize_own_voxel, voxelize

# K1's device kernels: D = 16 (PTv3), D = 64 and its k-rotation (the ViT)
K1_NAME = re.compile(r"fap_fwd_(d16|kernel_d64|kernel_rope_k)")


def segments(encode, model, loss_fn, images, b):
    """CUDA-event milliseconds of each stage of one batch."""
    pipe = model.config
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    with torch.inference_mode():
        mark("start")
        tokens = encode(images)
        mark("encode")
        vox = voxelize(b["points"], b["point_valid"], pipe.voxel_size,
                       pipe.voxel_capacity,
                       intensity_mode=pipe.intensity_mode)
        mark("voxelize")
        feats, mask = model.ptv3(vox.voxel_raw, vox.voxel_coords,
                                 vox.voxel_mask)
        mark("ptv3")
        scores = model.fusion(tokens, feats, vox.voxel_raw, mask,
                              b["cam_intrinsics"], b["lidar2cam"])
        mark("fusion")
        logits, _ = devoxelize_own_voxel(vox.point_voxel, vox.point_ok,
                                         scores)
        mark("devoxelize")
        loss_fn(logits, b["labels"], b["mask"])
        mark("loss")
    torch.cuda.synchronize()
    return {name: marks[i - 1][1].elapsed_time(ev)
            for i, (name, ev) in enumerate(marks) if i}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str,
                        default="configs/synthetic_convergence_fusion_r3.yaml")
    parser.add_argument("--split", type=str, default="test",
                        choices=("train", "val", "test"))
    parser.add_argument("--trace", type=str, default=None)
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        raise RuntimeError("profile_frame: no CUDA device is available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    device = torch.device("cuda")
    cfg = common.load_config(args.config)
    # eager, stage by stage (chip_smoke.py phase 22 times the graphed batch)
    encode, vit_cfg = common.build_image_encoder(cfg, device, graph=False)
    model, _ = common.build_pipeline(cfg, vit_cfg, device)
    loss_fn = common.build_loss(cfg)
    step = make_eval_step(loss_fn, cfg.mlp_class)
    batches = iter(common.build_dataloaders(cfg)[args.split])
    host = next(batches)
    batches.close()  # stop the prefetch thread
    images = torch.as_tensor(host.pop("images")).to(device)
    b = common.batch_to_device(host, device)

    for _ in range(3):
        segments(encode, model, loss_fn, images, b)
    rows = [segments(encode, model, loss_fn, images, b)
            for _ in range(10)]
    med = {k: sorted(r[k] for r in rows)[len(rows) // 2] for k in rows[0]}
    pre_ms = cuda_ms(lambda: preprocess_images(images, vit_cfg.image_size,
                                               vit_cfg.dtype), reps=10)
    print(f"segments_ms {json.dumps(med)} total {sum(med.values())} "
          f"preprocess_ms {pre_ms} [{card}]")

    def frame():
        return step(model, b, encode(images))

    closed = cuda_ms(frame, reps=10, warmup=2)
    live = iter(common.build_dataloaders(cfg)[args.split])
    next(live)
    prefetch_live = cuda_ms(frame, reps=10, warmup=2)
    live.close()
    closed_again = cuda_ms(frame, reps=10, warmup=2)
    print(f"batch_ms prefetch_closed {closed} prefetch_live {prefetch_live} "
          f"closed_again {closed_again} [{card}]")

    prof, kernels, _ = profile_kernels(frame, reps=3)
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=30,
                                    max_name_column_width=60))
    if args.trace:
        prof.export_chrome_trace(args.trace)
    k1 = [v for k, v in kernels.items() if K1_NAME.search(k)]
    print(f"device_kernel_ms_per_batch "
          f"{sum(us for us, _ in kernels.values()) / 1e3} "
          f"kernels_per_batch {sum(n for _, n in kernels.values())} "
          f"k1_ms_per_batch {sum(us for us, _ in k1) / 1e3} "
          f"k1_launches_per_batch {sum(n for _, n in k1)} [{card}]")


if __name__ == "__main__":
    main()
