"""Streaming multi-scene inference on one GPU or data-parallel over ranks
(the port's main path).

Port of ``tpu3dssf.cli.main_infer``: restores the latest checkpoint under
``test_params.checkpoint_path`` (else ``checkpoint_path``) with
``train.checkpoint.restore_checkpoint``, streams a split through the frozen
ViT and the fusion pipeline and prints the metric block and the throughput
line of the JAX CLI. Without a checkpoint it evaluates the seeded random
init and says so. On the card the encode and eval steps each replay one
CUDA graph per batch shape (:mod:`tpu3dssf_torch.train.graph`); the first
batch of a shape runs eagerly, then its graph is captured.

    python -m tpu3dssf_torch.cli.main_infer --config <yaml> [--split test]

With ``tpu_params.mesh_shape`` larger than one, the scenes of each batch
are split over a ``data`` mesh axis of that many ranks, one process each:

    torchrun --nproc_per_node 2 -m tpu3dssf_torch.cli.main_infer \
        --config <yaml with mesh_shape: [2]>

Every rank streams the same split; a partial last batch is padded to the
mesh-divisible size with masked duplicate rows (:func:`pad_to`), each rank
takes its rows of the batch and of the images (``parallel.shard_batch``),
encodes its own images and runs its own graphed forward; the loss is the
whole batch's and the counts are summed over the ranks
(``train.loop.make_eval_step`` and ``MetricAccumulator`` with the mesh).
Rank 0 prints the metrics and the throughput, total and per chip. Rank r
runs on ``cuda:(LOCAL_RANK % device count)``, so ranks may share a card;
the ranks talk over gloo.

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


def pad_to(batch, target):
    """Pad a partial host batch to ``target`` rows with masked duplicates
    of its last row (``mask`` and ``point_valid`` zeroed, so they add
    nothing to the loss, the metrics or the point count); a copy of the
    JAX CLI's closure of that name."""
    b = batch["points"].shape[0]
    if b == target:
        return batch
    padn = target - b
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        pad = np.repeat(v[-1:], padn, axis=0)
        if k in ("mask", "point_valid"):
            pad = np.zeros_like(pad)
        out[k] = np.concatenate([v, pad], axis=0)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str,
                        default="configs/nuscenes_default.yaml")
    parser.add_argument("--split", type=str, default="test",
                        choices=("train", "val", "test"))
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from tpu3dssf_torch.cli import common
    from tpu3dssf_torch.parallel import create_mesh

    cfg = common.load_config(args.config)
    mesh_size = int(np.prod(cfg.tpu.mesh_shape))
    if mesh_size > 1:
        mesh = create_mesh((mesh_size,), ("data",), device=args.device)
        device = mesh.device
    else:
        mesh, device = None, common.resolve_device(args.device)
    try:
        return _stream(args.split, cfg, device, mesh)
    finally:
        if mesh is not None:
            mesh.close()


def _stream(split, cfg, device, mesh):
    """Stream ``split`` on ``device`` (this rank's rows under ``mesh``);
    returns the metrics."""
    from tpu3dssf_torch.cli import common
    from tpu3dssf_torch.metrics import format_metrics
    from tpu3dssf_torch.parallel import shard_batch
    from tpu3dssf_torch.train.checkpoint import restore_checkpoint
    from tpu3dssf_torch.train.graph import graphed
    from tpu3dssf_torch.train.loop import MetricAccumulator, make_eval_step

    lead = mesh is None or mesh.rank == 0
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    if lead:
        print(f"device: {device} ({name})  mesh: "
              + (f"{mesh.shape} over {mesh.size} ranks" if mesh
                 else "single-device"))
    datasets = common.build_datasets(cfg)
    loaders = common.build_dataloaders(cfg, datasets)
    encode_fn, vit_cfg = common.build_image_encoder(cfg, device)
    model, _ = common.build_pipeline(cfg, vit_cfg, device)
    state = common.init_state(cfg, model)
    ckpt = cfg.test_checkpoint_path or cfg.checkpoint_path
    try:
        state, _, step = restore_checkpoint(ckpt, None, state)
        if lead:
            print(f"loaded checkpoint step {step} from {ckpt}")
    except FileNotFoundError:
        if lead:
            print(f"[warn] no checkpoint in {ckpt}; random init")
    model = state.model
    loss_fn = common.build_loss(cfg)
    eval_step = make_eval_step(loss_fn, cfg.mlp_class, mesh)
    if mesh is None:
        eval_step = graphed(eval_step, "eval_step")

    acc = MetricAccumulator(cfg.mlp_class, mesh=mesh)
    total_points = 0
    batch_target = loaders[split].batch_size
    if mesh is not None:
        batch_target = -(-batch_target // mesh.size) * mesh.size
    t0 = time.perf_counter()
    for batch in loaders[split]:
        if mesh is not None:
            batch = pad_to(batch, batch_target)
        # valid points only: pad_to zeroes point_valid of its rows
        total_points += int(np.asarray(batch["point_valid"]).sum())
        images = batch.pop("images", None)
        if mesh is not None:
            batch = shard_batch(batch, mesh)
            images = None if images is None else shard_batch(images, mesh)
        batch = common.batch_to_device(batch, device)
        if encode_fn is not None and images is not None:
            tokens = encode_fn(torch.as_tensor(images).to(device))
        else:
            tokens = common.zero_tokens(cfg, vit_cfg,
                                        batch["points"].shape[0], device)
        acc.add(eval_step(model, batch, tokens))
    metrics = acc.metrics()  # folds the device sums: synchronises
    dt = time.perf_counter() - t0

    if lead:
        n_dev = mesh.size if mesh is not None else 1
        print(format_metrics(metrics))
        print(f"streamed {acc.it} batches, {total_points:,} valid points in "
              f"{dt:.1f}s  ->  {total_points/dt:,.0f} points/s "
              f"({total_points/dt/n_dev:,.0f} per chip)")
    return metrics


if __name__ == "__main__":
    main()
