"""Streaming multi-scene inference on one GPU (the port's main path).

Port of ``tpu3dssf.cli.main_infer`` for a single device: restores the
latest checkpoint under ``test_params.checkpoint_path`` (else
``checkpoint_path``) with ``train.checkpoint.restore_checkpoint``, streams
a split through the frozen ViT and the fusion pipeline and prints the
metric block and the throughput line of the JAX CLI. Without a checkpoint
it evaluates the seeded random init and says so.

    python -m tpu3dssf_torch.cli.main_infer --config <yaml> [--split test]

``--device`` defaults to ``cuda``; without a CUDA device the CLI raises
(it never drops to the CPU). ``--device cpu`` runs the plain versions of
the kernels, for tests.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str,
                        default="configs/nuscenes_default.yaml")
    parser.add_argument("--split", type=str, default="test",
                        choices=("train", "val", "test"))
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from tpu3dssf_torch.cli import common
    from tpu3dssf_torch.metrics import format_metrics
    from tpu3dssf_torch.train.checkpoint import restore_checkpoint
    from tpu3dssf_torch.train.loop import MetricAccumulator, make_eval_step

    cfg = common.load_config(args.config)
    device = common.resolve_device(args.device)
    if int(np.prod(cfg.tpu.mesh_shape)) > 1:
        raise NotImplementedError(
            "data-parallel meshes are not ported yet (ROADMAP.md, H100 "
            "port); use mesh_shape: [1]")

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {device} ({name})  mesh: single-device")
    datasets = common.build_datasets(cfg)
    loaders = common.build_dataloaders(cfg, datasets)
    encode_fn, vit_cfg = common.build_image_encoder(cfg, device)
    model, _ = common.build_pipeline(cfg, vit_cfg, device)
    state = common.init_state(cfg, model)
    ckpt = cfg.test_checkpoint_path or cfg.checkpoint_path
    try:
        state, _, step = restore_checkpoint(ckpt, None, state)
        print(f"loaded checkpoint step {step} from {ckpt}")
    except FileNotFoundError:
        print(f"[warn] no checkpoint in {ckpt}; random init")
    model = state.model
    loss_fn = common.build_loss(cfg)
    eval_step = make_eval_step(loss_fn, cfg.mlp_class)

    acc = MetricAccumulator(cfg.mlp_class)
    total_points = 0
    t0 = time.perf_counter()
    for batch in loaders[args.split]:
        total_points += int(np.asarray(batch["point_valid"]).sum())
        images = batch.pop("images", None)
        batch = common.batch_to_device(batch, device)
        if encode_fn is not None and images is not None:
            tokens = encode_fn(torch.as_tensor(images).to(device))
        else:
            tokens = common.zero_tokens(cfg, vit_cfg,
                                        batch["points"].shape[0], device)
        acc.add(eval_step(model, batch, tokens))
    metrics = acc.metrics()  # folds the device sums: synchronises
    dt = time.perf_counter() - t0

    print(format_metrics(metrics))
    print(f"streamed {acc.it} batches, {total_points:,} valid points in "
          f"{dt:.1f}s  ->  {total_points/dt:,.0f} points/s "
          f"({total_points/dt:,.0f} per chip)")
    return metrics


if __name__ == "__main__":
    main()
